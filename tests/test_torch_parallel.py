"""Data parallel in dpfx_torch (``dpfx_torch.parallel``, the trainer under a
process group, the rank-sharded sampler and the row-sharded suite) on the
CPU: two gloo ranks (tests/_torch_dp_worker.py, spawned as
tests/test_multiprocess.py spawns mp_worker.py) against the one-process run
of the same code, and against ``dpfx`` on a 2-device mesh; the row helpers
against ``dpfx.parallel`` and ``dpfx.data``; the CLIs at two ranks."""

import json
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import _torch_dp_worker as worker  # noqa: E402
from dpfx import data as jdata  # noqa: E402
from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.models import DPF as JaxDPF  # noqa: E402
from dpfx.parallel import create_mesh  # noqa: E402
from dpfx.parallel import distributed as jdist  # noqa: E402
from dpfx.train import trainer as jtrainer  # noqa: E402
from dpfx_torch import data as tdata  # noqa: E402
from dpfx_torch.compat import params_to_flax  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.parallel import free_port, padded_rows, process_local_rows, rank_seed  # noqa: E402
from dpfx_torch.sampling import make_sampler  # noqa: E402
from dpfx_torch.train import init_params_  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_dp_worker.py")
FORMS = ["hostfed", "replicated", "sharded"]


def _env():
    return {k: v for k, v in os.environ.items()
            if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two gloo ranks of the worker, and the one-process run of the same
    code in this process meanwhile: {"ranks": [rank 0, rank 1], "one": ...}."""
    out = tmp_path_factory.mktemp("dp")
    resume = str(out / "resume")
    worker.prepare_resume(resume)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), "2", str(port), str(out), resume],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=_env(), cwd=REPO) for r in range(2)]
    try:
        one = worker.run_all(None, str(out / "one"), resume)
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, f"rank failed:\n{err[-4000:]}"
    finally:
        for p in procs:
            p.kill()
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(2)]
    return {"ranks": ranks, "one": one, "dir": out}


# ---------------------------------------------------------------- the row helpers

def _fake_mesh(world: int):
    devices = np.array([types.SimpleNamespace(process_index=i) for i in range(world)])
    return types.SimpleNamespace(devices=devices)


@pytest.mark.parametrize("n,world", [(13, 2), (12, 4), (5, 3), (64, 1), (2, 4)])
def test_rows_match_dpfx(n, world, monkeypatch):
    """padded_rows and each rank's process_local_rows equal dpfx.parallel's
    for one process per device of a 1-D mesh."""
    assert padded_rows(n, world) == jdist.padded_rows(n, world)
    for rank in range(world):
        monkeypatch.setattr(jax, "process_index", lambda r=rank: r)
        assert process_local_rows(n, world, rank) == jdist.process_local_rows(n, _fake_mesh(world))


@pytest.mark.parametrize("world", [2, 4])
def test_batch_shard_matches_dpfx(world):
    """Each rank's batch_shard rows equal dpfx.data's over two epochs (per
    item subsample keyed by its global slot), and the ranks' rows
    concatenate to the one-process batch bit for bit."""
    ds, jds = (m.SyntheticDataset(size=13, n_stored=96, split="train") for m in (tdata, jdata))
    full = list(tdata.iterate_batches(ds, 4, 64, seed=3, epochs=2))
    parts = []
    for rank in range(world):
        shard = process_local_rows(4, world, rank)
        mine = list(tdata.iterate_batches(ds, 4, 64, seed=3, epochs=2, batch_shard=shard))
        theirs = jdata.iterate_batches(jds, 4, 64, seed=3, epochs=2, batch_shard=shard)
        for a, b in zip(mine, theirs, strict=True):
            np.testing.assert_array_equal(a["x"], b["x"])
        parts.append(mine)
    for i, batch in enumerate(full):
        np.testing.assert_array_equal(np.concatenate([p[i]["x"] for p in parts]), batch["x"])


def test_batch_shard_refusals():
    ds = tdata.SyntheticDataset(size=8, n_stored=96, split="train")
    with pytest.raises(ValueError, match="drop_last"):
        next(tdata.iterate_batches(ds, 4, 64, drop_last=False, batch_shard=(0, 2)))
    with pytest.raises(RuntimeError, match="empty"):
        next(tdata.iterate_batches(ds, 4, 64, batch_shard=(4, 6)))


# ---------------------------------------------------------------- training at two ranks

@pytest.mark.parametrize("form", FORMS)
def test_rank_inputs_concatenate_to_one_process(runs, form):
    """Every train step's ELBO inputs (the jittered clouds and eps) of the
    two ranks concatenate to the one-process step's, bit for bit."""
    one, (r0, r1) = runs["one"][form], (r[form] for r in runs["ranks"])
    assert len(one["calls"]) == len(r0["calls"]) == len(r1["calls"]) == worker.STEPS
    for (x, eps), (x0, e0), (x1, e1) in zip(one["calls"], r0["calls"], r1["calls"]):
        assert x0.shape[0] == x.shape[0] // 2
        assert torch.equal(torch.cat([x0, x1]), x) and torch.equal(torch.cat([e0, e1]), eps)


@pytest.mark.parametrize("rank", [0, 1])
def test_sharded_gather_equals_replicated(runs, rank):
    """The sharded stack's gather (each rank holds 7 of 13 rows, a pad row
    included) gives each rank the replicated gather's rows, bit for bit."""
    sh, rep = runs["ranks"][rank]["sharded"]["calls"], runs["ranks"][rank]["replicated"]["calls"]
    for (xs, es), (xr, er) in zip(sh, rep, strict=True):
        assert torch.equal(xs, xr) and torch.equal(es, er)


@pytest.mark.parametrize("form", FORMS)
def test_losses_match_one_process(runs, form):
    """6 steps at D=2 (calls of 3 eager steps, the all-reduce in each): the
    logged loss and grad norm within rtol 1e-5 of D=1, the same on both
    ranks, and the parameters within 1e-5."""
    one = runs["one"][form]
    for r in runs["ranks"]:
        got = r[form]
        assert [h[0] for h in got["history"]] == [h[0] for h in one["history"]] == [3, 6]
        np.testing.assert_allclose([h[1:] for h in got["history"]],
                                   [h[1:] for h in one["history"]], rtol=1e-5)
        torch.testing.assert_close(got["params"], one["params"], rtol=0, atol=1e-5)
    assert runs["ranks"][0][form]["history"] == runs["ranks"][1][form]["history"]
    assert torch.equal(runs["ranks"][0][form]["params"], runs["ranks"][1][form]["params"])


def test_supplied_steps_match_one_process_and_dpfx_mesh(runs):
    """Three steps on the same weights and the same x, eps and xnoise: the
    two ranks' all-reduced loss and grad norm within rtol 1e-5 of the
    one-process steps and of dpfx's make_train_step on a 2-device mesh."""
    raw = worker.tiny("unused")
    cfg, jcfg = config_from_dict(raw), jax_config_from_dict(raw)
    model = init_params_(DPF(cfg), cfg.train.seed)
    jp = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    jtx = jtrainer.make_optimizer(jcfg.train)
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                                 opt_state=jtx.init(jp))
    jstep = jtrainer.make_train_step(JaxDPF(jcfg), jtx, jcfg, mesh=create_mesh(n_devices=2))
    rng = np.random.default_rng(7)
    jax_metrics = []
    for _ in range(3):
        batch = {"x": rng.normal(size=(4, 64, 3)), "eps": rng.normal(size=(4, 16)),
                 "xnoise": rng.normal(size=(4, 64, 3))}
        jstate, jm = jstep(jstate, {k: jnp.asarray(v, jnp.float32) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        jax_metrics.append((float(jm["loss"]), float(jm["grad_norm"])))
    one = runs["one"]["supplied"]["metrics"]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r["supplied"]["metrics"], one, rtol=1e-5)
        np.testing.assert_allclose(r["supplied"]["metrics"], jax_metrics, rtol=1e-5)


def test_evaluate_ragged_tail_matches_one_process(runs):
    """Trainer.evaluate on 8 validation clouds in batches of 5 and 3 (a
    ragged row in each at D=2): every metric and median within rtol 1e-6 of
    D=1, the same on both ranks, but kl and kl_median. kl is a difference
    of two f32 terms of magnitude |logp_z| (~22 here), and D=2 evaluates
    the same rows in other batch compositions, so BLAS blocking gives its
    terms other f32 bits: a difference of a fraction of one ulp of the
    terms (np.spacing(np.float32(|logp_z|)), ~1.9e-6 at 22) is a relative
    difference of kl itself of ~1e-6 and more (seen: 1.10e-6). So kl and
    kl_median are held to an absolute 4 ulps of their terms, from the same
    run's |logp_z| (~7.6e-6); logp_z, one of those terms, stays at rtol 1e-6."""
    one = runs["one"]["hostfed"]["val"]
    kl_atol = 4 * float(np.spacing(np.float32(max(abs(one["logp_z"]),
                                                  abs(one["logp_z_median"])))))
    for r in runs["ranks"]:
        got = r["hostfed"]["val"]
        assert got.keys() == one.keys()
        for k in one:
            if k in ("kl", "kl_median"):
                np.testing.assert_allclose(got[k], one[k], rtol=0, atol=kl_atol, err_msg=k)
            else:
                np.testing.assert_allclose(got[k], one[k], rtol=1e-6, err_msg=k)


def test_checkpoints_written_by_rank0_only(runs):
    """Rank 0 saves at each ckpt_every crossing; rank 1 saves nothing and
    writes only its own metrics.jsonl under proc1/, without TensorBoard."""
    for form in FORMS:
        assert runs["ranks"][0][form]["saves"] == [3, 6]
        assert runs["ranks"][1][form]["saves"] == []
        d = runs["dir"] / form / "dp"
        assert sorted(p.name for p in d.iterdir() if p.is_file()) == [
            "metrics.jsonl", "params_00000003.pt", "params_00000006.pt", "state_00000003.ckpt",
            "state_00000006.ckpt"]
        assert [p.name for p in (d / "proc1").iterdir()] == ["metrics.jsonl"]


def test_resume_at_two_ranks_continues_one_process_run(runs):
    """A one-process checkpoint at step 3, resumed at D=2 (rank 0 restores,
    the state is broadcast), trains steps 4-6 as the one-process run did."""
    one = runs["one"]["replicated"]["history"][-1]
    for r in runs["ranks"]:
        assert r["resume"]["resumed_from"] == 3
        (step, loss, gnorm), = r["resume"]["history"]
        assert step == 6
        np.testing.assert_allclose([loss, gnorm], one[1:], rtol=1e-5)
        torch.testing.assert_close(r["resume"]["params"], runs["one"]["replicated"]["params"],
                                   rtol=0, atol=1e-5)


@pytest.mark.parametrize("what,needs", [("capture", "train.steps_per_call=1"),
                                       ("sampler", "multiple of the 2 ranks"),
                                       ("batch", "does not divide over 2 ranks")])
def test_group_refusals(runs, what, needs):
    """A gloo group's collectives cannot be captured on the card (MultiStep
    names train.steps_per_call=1); 3 clouds or a batch of 3 do not divide
    over two ranks. Nothing falls back in silence."""
    for r in runs["ranks"]:
        assert needs in r["refusals"][what]


# ---------------------------------------------------------------- evaluation at two ranks

@pytest.mark.parametrize("metric", ["cd", "emd"])
def test_row_sharded_matrix_bit_for_bit(runs, metric):
    """7 x 5 clouds in row chunks of 3: rank 0 computes rows 0-3, rank 1
    rows 4-6; the gathered matrix equals the one-process matrix bit for bit
    on both ranks."""
    one = runs["one"]["suite"][metric]
    assert one.shape == (7, 5)
    for r in runs["ranks"]:
        assert torch.equal(r["suite"][metric], one)


def test_suite_metrics_equal_one_process(runs):
    one = runs["one"]["suite"]["metrics"]
    for r in runs["ranks"]:
        assert r["suite"]["metrics"] == one


def test_rank_sharded_sampler(runs):
    """Rank r's clouds are make_sampler(n / D) on the seed keyed by
    (seed, r); every rank returns all of them."""
    cfg = config_from_dict(worker.tiny("unused"))
    from dpfx_torch.compat import randomize_

    model = randomize_(init_params_(DPF(cfg), 0), 1, 0.05)
    want = torch.cat([make_sampler(model, 2, 32)(rank_seed(5, r)) for r in range(2)])
    for r in runs["ranks"]:
        assert torch.equal(r["sampled"], want)
    assert not torch.equal(want[:2], want[2:])


# ---------------------------------------------------------------- the CLIs at two ranks

@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    """``python -m dpfx_torch.train ... parallel.data_axis=2 --device cpu``:
    the lone process spawns two gloo ranks."""
    import yaml

    d = tmp_path_factory.mktemp("dpcli")
    raw = worker.tiny(str(d / "ck"), train__steps=4, train__steps_per_call=2,
                      train__log_every=2, train__ckpt_every=4, data__device_resident=True,
                      parallel__resident_sharding="sharded")
    raw["eval"]["metrics"] = ["cd"]
    cfg = d / "c.yaml"
    cfg.write_text(yaml.safe_dump(raw))
    proc = subprocess.run([sys.executable, "-m", "dpfx_torch.train", str(cfg),
                           "parallel.data_axis=2", "--device", "cpu"], capture_output=True,
                          text=True, env=_env(), cwd=REPO, timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return {"cfg": cfg, "out": proc.stdout, "run": d / "ck" / "dp"}


def test_cli_spawns_two_ranks_and_trains(cli_run):
    out = cli_run["out"]
    assert "2 ranks, sharded" in out and "rows [0, 7) of 13" in out
    assert out.count("step 4/4") == 1          # rank 0 alone prints
    run = cli_run["run"]
    recs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert [(r["kind"], r["step"]) for r in recs] == [("train", 2), ("train", 4), ("val", 4)]
    assert all(np.isfinite(v) for r in recs for k, v in r.items() if k != "kind")
    assert sorted(p.name for p in run.glob("*.pt")) == ["params_00000004.pt"]
    rank1 = [json.loads(line) for line in (run / "proc1" / "metrics.jsonl").read_text()
             .splitlines()]
    assert [{k: v for k, v in r.items() if k != "points_per_sec"} for r in rank1] == \
        [{k: v for k, v in r.items() if k != "points_per_sec"} for r in recs]


def _ranks(args, world=2, coordinator=False):
    """``python -m <args>`` as ``world`` ranks: with torchrun's environment,
    or with ``parallel.coordinator``, ``num_processes`` and ``process_id``."""
    port = free_port()

    def launch(r):
        if coordinator:
            argv = [*args, f"parallel.coordinator=127.0.0.1:{port}",
                    f"parallel.num_processes={world}", f"parallel.process_id={r}"]
            env = _env()
        else:
            argv = args
            env = dict(_env(), RANK=str(r), WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                       MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        return subprocess.Popen([sys.executable, "-m", *argv], stdout=subprocess.PIPE,
                                stderr=subprocess.PIPE, text=True, cwd=REPO, env=env)

    procs = [launch(r) for r in range(world)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, err[-4000:]
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
    return outs


def test_evaluate_and_generate_cli_at_two_ranks(cli_run, tmp_path):
    """The checkpoint evaluated by two torchrun-style ranks (the suite's
    sampling and matrices sharded; rank r samples from its own seeds, so
    the values differ from one process's) gives the one-process keys,
    finite, and rank 0 alone writes --out; generate at two ranks joined
    through parallel.coordinator writes the clouds once, rank r's the
    one-process sampler's on its seed."""
    from dpfx_torch import evaluate

    cfg = str(cli_run["cfg"])
    out2, out1 = tmp_path / "two.jsonl", tmp_path / "one.jsonl"
    outs = _ranks(["dpfx_torch.evaluate", cfg, "--limit", "6", "--out", str(out2),
                   "--device", "cpu"])
    assert outs[1] == "" and "evaluating gen @ step 4" in outs[0]
    assert evaluate.main([cfg, "--limit", "6", "--out", str(out1), "--device", "cpu"]) == 0
    (two,), (one,) = (p.read_text().splitlines() for p in (out2, out1))
    two, one = json.loads(two), json.loads(one)
    assert two.keys() == one.keys() and two["n_test"] == 6
    assert all(np.isfinite(v) for k, v in two.items() if k != "jsd_frame")
    npy, weights = tmp_path / "s.npy", str(cli_run["run"] / "params_00000004.pt")
    outs = _ranks(["dpfx_torch.generate", cfg, "--weights", weights, "--n-clouds", "4",
                   "--n-points", "32", "--seed", "3", "--out", str(npy), "--device", "cpu"],
                  coordinator=True)
    clouds = np.load(npy)
    assert clouds.shape == (4, 32, 3) and np.isfinite(clouds).all() and outs[1] == ""
    from dpfx_torch.checkpoint import restore_for_eval
    from dpfx_torch.config import load_config

    model = restore_for_eval(load_config(cfg), weights, "cpu")
    want = torch.cat([make_sampler(model, 2, 32)(rank_seed(3, r)) for r in range(2)])
    np.testing.assert_array_equal(clouds, want.numpy())
