"""One rank of a data-parallel run of dpfx_torch on the CPU (gloo), for
tests/test_torch_parallel.py. JAX-free: the test process imports it too and
runs ``run_all(None, ...)`` for the one-process reference.

Each form trains the tiny tanh model of ``tiny`` and records what its train
steps feed the ELBO (the jittered x and eps of each step, on this rank),
the logged records and the final parameters:

  * ``hostfed``: ``Trainer.fit`` on ``iterate_batches(batch_shard=...)``, then
    ``Trainer.evaluate`` on a validation stream whose batches leave a ragged
    tail at D=2, and the checkpoints each rank left;
  * ``replicated`` / ``sharded``: ``Trainer.fit_resident`` with
    ``parallel.resident_sharding`` so (sharded: each rank loads its padded
    block alone);
  * ``resume``: a resident run resumed from a one-process checkpoint at step
    3 and trained to 6;
  * ``supplied``: three ``make_train_step`` steps on given x, eps and xnoise
    (the rank's rows of global arrays), for the comparison with ``dpfx``.

Then the row-sharded CD and EMD matrices, the suite on them, and the
rank-sharded sampler's clouds. Everything goes to ``<outdir>/rank<r>.pt``.

Usage: python _torch_dp_worker.py <rank> <world> <port> <outdir> <resume_dir>
"""

import os
import sys
import warnings

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.data import build_dataset, iterate_batches, preload_clouds  # noqa: E402
from dpfx_torch.metrics.generation import compute_all_metrics, pairwise_matrix  # noqa: E402
from dpfx_torch.parallel import process_local_rows, rank_slice, world_rank  # noqa: E402
from dpfx_torch.train import trainer as trainer_mod  # noqa: E402

STEPS, S = 6, 13            # 13 clouds: a pad row in each block at D=2


def tiny(ckpt_dir: str, **over) -> dict:
    """tests/_torch_train_cases.py's tanh model under the annealed jitter
    and the clipped, warmed-up schedule, N=64, B=4."""
    raw = {"experiment": "gen", "name": "dp", "model": {
        "dz": 16,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "scale_cap": 3.0},
        "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}},
        "data": {"dataset": "synthetic", "n_points": 64, "n_points_eval": 64,
                 "synthetic_size": S},
        "train": {"batch_size": 4, "steps": STEPS, "steps_per_call": 3, "lr": 3e-3,
                  "grad_clip": 1.0, "lr_warmup_steps": 1, "augment_noise": 0.05,
                  "augment_noise_final": 0.01, "augment_noise_anneal_steps": 4,
                  "log_every": 3, "ckpt_every": 3, "eval_every": 1000, "ckpt_keep": 0,
                  "flat_optimizer": False, "ckpt_dir": ckpt_dir},
        "eval": {"batch_size": 5}}
    for part in ("point_flow", "latent_flow", "encoder"):
        raw["model"][part]["activation"] = "tanh"
    for key, v in over.items():
        section, name = key.split("__")
        raw.setdefault(section, {})[name] = v
    return raw


def spied(fn):
    """fn() with every ELBO call of the train step recorded: [(x, eps)]."""
    calls, orig = [], trainer_mod.elbo_loss

    def spy(model, x, eps, **kw):
        calls.append((x.detach().clone(), eps.detach().clone()))
        return orig(model, x, eps, **kw)

    trainer_mod.elbo_loss = spy
    try:
        fn()
    finally:
        trainer_mod.elbo_loss = orig
    return calls


def train_form(form: str, group, outdir: str, resume_dir: str) -> dict:
    world, rank = world_rank(group)
    if form == "resume":
        raw = tiny(resume_dir, data__device_resident=True)
    else:
        raw = tiny(os.path.join(outdir, form),
                   data__device_resident=form != "hostfed",
                   parallel__resident_sharding="sharded" if form == "sharded" else "replicated")
    cfg = config_from_dict(raw)
    tr = trainer_mod.Trainer(cfg, device="cpu", log_fn=lambda *a, **k: None, group=group)
    ds = build_dataset(cfg.data, "train")
    out = {"saves": []}
    save = tr.ckpt.save
    tr.ckpt.save = lambda step, *a: (out["saves"].append(step), save(step, *a))
    if form == "hostfed":
        shard = None if group is None else process_local_rows(4, world, rank)
        out["calls"] = spied(lambda: tr.fit(iterate_batches(ds, 4, 64, seed=cfg.train.seed,
                                                            batch_shard=shard)))
        val = build_dataset(cfg.data, "val")
        out["val"] = tr.evaluate(iterate_batches(val, 5, 64, seed=0, shuffle=False, epochs=1,
                                                 drop_last=False))
    elif form == "sharded" and group is not None:
        start, stop = process_local_rows(S, world, rank)
        block = preload_clouds(ds, indices=[g % S for g in range(start, stop)])
        out["calls"] = spied(lambda: tr.fit_resident(block, clouds_are_local_shard=True,
                                                     logical_rows=S))
    else:
        if form == "resume":
            out["resumed_from"] = tr.maybe_resume()
        out["calls"] = spied(lambda: tr.fit_resident(preload_clouds(ds)))
    out["history"] = [(h["step"], h["loss"], h["grad_norm"]) for h in tr.history]
    out["params"] = tr.state.params.clone()
    return out


def prepare_resume(resume_dir: str) -> None:
    """The one-process resident run's first 3 steps and their checkpoint,
    which the ``resume`` form continues at D ranks."""
    cfg = config_from_dict(tiny(resume_dir, data__device_resident=True))
    tr = trainer_mod.Trainer(cfg, device="cpu", log_fn=lambda *a, **k: None)
    tr.fit_resident(preload_clouds(build_dataset(cfg.data, "train")), steps=3)


def supplied_steps(group) -> dict:
    """Three steps of make_train_step on the rank's rows of global x, eps
    and xnoise from a numpy seed."""
    cfg = config_from_dict(tiny("unused"))
    model = trainer_mod.init_params_(trainer_mod.DPF(cfg), cfg.train.seed)
    tx = trainer_mod.make_optimizer(cfg.train)
    state = trainer_mod.init_state(model, tx)
    step = trainer_mod.make_train_step(model, tx, cfg, group)
    rng = np.random.default_rng(7)
    out = []
    for _ in range(3):
        batch = {"x": rng.normal(size=(4, 64, 3)), "eps": rng.normal(size=(4, 16)),
                 "xnoise": rng.normal(size=(4, 64, 3))}
        batch = {k: rank_slice(torch.from_numpy(v.astype(np.float32)), group)
                 for k, v in batch.items()}
        state, m = step(state, batch)
        out.append((float(m["loss"]), float(m["grad_norm"])))
    return {"metrics": out, "params": state.params.clone()}


def suite(group) -> dict:
    rng = np.random.default_rng(3)
    gen = torch.from_numpy(rng.normal(size=(7, 64, 3)).astype(np.float32))
    ref = torch.from_numpy(rng.normal(size=(5, 64, 3)).astype(np.float32))
    out = {m: pairwise_matrix(gen, ref, m, row_chunk=3, group=group) for m in ("cd", "emd")}
    with warnings.catch_warnings():      # a few points past the JSD grid's sphere
        warnings.simplefilter("ignore")
        out["metrics"] = compute_all_metrics(gen, ref, metrics=("cd", "emd"), jsd_resolution=8,
                                             group=group)
    return out


def sampled(group) -> torch.Tensor:
    from dpfx_torch.compat import randomize_
    from dpfx_torch.sampling import make_sampler

    cfg = config_from_dict(tiny("unused"))
    model = randomize_(trainer_mod.init_params_(trainer_mod.DPF(cfg), 0), 1, 0.05)
    return make_sampler(model, 4, 32, group=group)(5)


def refusals(group) -> dict:
    """What a gloo group refuses: MultiStep's capture on the card, clouds
    that do not divide over the ranks, a batch that does not."""
    from dpfx_torch.sampling import make_sampler

    cfg = config_from_dict(tiny("unused"))
    model = trainer_mod.init_params_(trainer_mod.DPF(cfg), 0)
    ms = trainer_mod.MultiStep(model, trainer_mod.make_optimizer(cfg.train), cfg, group)
    odd = config_from_dict(tiny("unused", train__batch_size=3))
    out = {}
    for name, fn in (("capture", ms._check_capturable),
                     ("sampler", lambda: make_sampler(model, 3, 32, group=group)),
                     ("batch", lambda: trainer_mod.Trainer(odd, device="cpu", group=group))):
        try:
            fn()
            out[name] = ""
        except ValueError as e:
            out[name] = str(e)
    return out


def run_all(group, outdir: str, resume_dir: str) -> dict:
    out = {form: train_form(form, group, outdir, resume_dir)
           for form in ("hostfed", "replicated", "sharded")}
    if group is not None:
        out["resume"] = train_form("resume", group, outdir, resume_dir)
        out["refusals"] = refusals(group)
    out["supplied"] = supplied_steps(group)
    out["suite"] = suite(group)
    out["sampled"] = sampled(group)
    return out


if __name__ == "__main__":
    rank, world, port = (int(a) for a in sys.argv[1:4])
    outdir, resume_dir = sys.argv[4], sys.argv[5]
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=world,
                            rank=rank)
    result = run_all(dist.group.WORLD, outdir, resume_dir)
    torch.save(result, os.path.join(outdir, f"rank{rank}.pt"))
    dist.destroy_process_group()
