"""Port parity for training: dpfx_torch.train (ELBO loss, schedules,
optimizer, train step) against dpfx.train on the same numpy-seeded weights,
batches and noise; dpfx_torch.data against dpfx.data; and the training CLI
end to end on the CPU."""

import json
import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402

from dpfx import data as jdata  # noqa: E402
from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.models import DPF as JaxDPF  # noqa: E402
from dpfx.train import loss as jloss  # noqa: E402
from dpfx.train import trainer as jtrainer  # noqa: E402
from dpfx_torch import data as tdata  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.train import (  # noqa: E402
    TrainDivergedError,
    Trainer,
    elbo_loss,
    init_params_,
    init_state,
    make_optimizer,
    make_schedule,
    make_train_step,
)
from dpfx_torch.train import __main__ as train_cli  # noqa: E402


def tiny(**train):
    return {"experiment": "gen", "name": "t", "model": {
        "dz": 16,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "scale_cap": 3.0},
        "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}},
        "data": {"dataset": "synthetic", "n_points": 64, "synthetic_size": 32},
        "train": {"batch_size": 4, "steps": 5, "lr": 1e-3, "flat_optimizer": False, **train}}


def _jparams(model):
    return jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))


def _named(flat_tensor, model):
    """A flat vector laid out like the model's parameters -> state-dict names."""
    out, o = {}, 0
    for k, p in model.named_parameters():
        out[k] = flat_tensor[o:o + p.numel()].view_as(p)
        o += p.numel()
    return out


@pytest.mark.parametrize("fused,reduction", [(False, "sum_points"), (True, "sum_points"),
                                              (True, "mean_points")])
def test_elbo_loss_matches_jax(fused, reduction):
    raw = tiny()
    torch.manual_seed(0)            # the modules' own init
    model = randomize_(DPF(config_from_dict(raw)), 0, 0.1)
    jmodel = JaxDPF(jax_config_from_dict(raw))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 130, 3)).astype(np.float32)
    eps = rng.normal(size=(3, 16)).astype(np.float32)
    kw = dict(kl_weight=0.7, recon_reduction=reduction, fused_point_flow=fused,
              fused_encoder=fused)
    lt, mt = elbo_loss(model, torch.from_numpy(x), torch.from_numpy(eps), **kw)
    lj, mj = jloss.elbo_loss(jmodel, _jparams(model), jnp.asarray(x), jax.random.PRNGKey(0),
                             eps=jnp.asarray(eps), **kw)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert mt.keys() == mj.keys()
    for k in mj:
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]), rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("fused_pf,dz", [(False, 32), (True, 32), (True, 16)])
def test_elbo_loss_fused_latent_matches_jax(fused_pf, dz, monkeypatch):
    """train.fused_latent_flow, alone and with the fused point flow, against
    dpfx's own dispatch. At dz=16 both packages warn and use the module
    path (the fused latent flow needs dz > 16)."""
    from dpfx_torch.train import loss as tloss

    raw = tiny()
    raw["model"]["dz"] = dz
    torch.manual_seed(0)            # the modules' own init
    model = randomize_(DPF(config_from_dict(raw)), 0, 0.1)
    jmodel = JaxDPF(jax_config_from_dict(raw))
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3, 130, 3)).astype(np.float32)
    eps = rng.normal(size=(3, dz)).astype(np.float32)
    kw = dict(kl_weight=0.7, fused_point_flow=fused_pf, fused_encoder=fused_pf,
              fused_latent_flow=True)
    monkeypatch.setattr(tloss, "_warned", set())
    with warnings.catch_warnings(record=True) as seen:
        warnings.simplefilter("always")
        lt, mt = elbo_loss(model, torch.from_numpy(x), torch.from_numpy(eps), **kw)
    assert any("fused_latent_flow" in str(w.message) for w in seen) == (dz == 16)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lj, mj = jloss.elbo_loss(jmodel, _jparams(model), jnp.asarray(x), jax.random.PRNGKey(0),
                                 eps=jnp.asarray(eps), **kw)
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert mt.keys() == mj.keys()
    for k in mj:
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]), rtol=1e-5, atol=1e-5, err_msg=k)
    if dz == 16:
        module, _ = elbo_loss(model, torch.from_numpy(x), torch.from_numpy(eps),
                              **{**kw, "fused_latent_flow": False})
        assert float(module.detach()) == float(lt.detach())


def test_fused_latent_train_step_grads_match_module_path():
    """A train step's gradients with the fused latent flow (f32) equal the
    module path's: the same ELBO, with the latent gradients from the
    kernels' backward instead of autograd through the modules."""
    raw = tiny()
    raw["model"]["dz"] = 32
    torch.manual_seed(2)            # the modules' own init
    model = randomize_(DPF(config_from_dict(raw)), 2, 0.1)
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(size=(4, 64, 3)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(4, 32)).astype(np.float32))
    grads = []
    for fused in (True, False):
        loss, _ = elbo_loss(model, x, eps, fused_latent_flow=fused)
        grads.append(torch.autograd.grad(loss, list(model.parameters()), allow_unused=True))
    for (name, p), a, b in zip(model.named_parameters(), *grads):
        if b is None:
            assert a is None or not a.any(), name
            continue
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5, msg=name)


SCHEDULES = [
    dict(lr_schedule="cosine", lr_warmup_steps=3, steps=20),
    dict(lr_schedule="cosine", lr_decay_steps=12, steps=20, lr_min_ratio=0.1),
    dict(lr_schedule="step", lr_warmup_steps=2, steps=22),
    dict(lr_schedule="step", steps=3),
    dict(lr_schedule="constant", lr_warmup_steps=4, steps=10),
]


@pytest.mark.parametrize("over", SCHEDULES)
def test_schedule_matches_optax(over):
    tcfg = config_from_dict(tiny(**over)).train
    jsched = jtrainer.make_schedule(jax_config_from_dict(tiny(**over)).train)
    sched = make_schedule(tcfg)
    for count in range(tcfg.steps + 5):
        np.testing.assert_allclose(sched(count), float(jsched(count)), rtol=1e-6, atol=1e-12,
                                   err_msg=f"count {count}")


@pytest.mark.parametrize("over", [dict(grad_clip=0.5, lr_warmup_steps=2),
                                  dict(grad_clip=0.0, weight_decay=0.01),
                                  dict(grad_clip=100.0, lr_schedule="step", weight_decay=0.1)])
def test_optimizer_matches_optax(over):
    """clip -> adam/adamw -> schedule from the first update on: the lr of
    update 0 is lr(0) (0 under warmup)."""
    tx = make_optimizer(config_from_dict(tiny(**over)).train)
    jtx = jtrainer.make_optimizer(jax_config_from_dict(tiny(**over)).train)
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=50).astype(np.float32)
    params, jparams = torch.from_numpy(p0.copy()), jnp.asarray(p0)
    state, jstate = tx.init(params), jtx.init(jparams)
    for _ in range(6):
        g = rng.normal(size=50).astype(np.float32) * 3
        gt = torch.from_numpy(g)
        state = tx.apply_(params, gt, torch.linalg.vector_norm(gt), state)
        upd, jstate = jtx.update(jnp.asarray(g), jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        np.testing.assert_allclose(params.numpy(), np.asarray(jparams), rtol=1e-5, atol=1e-7)


def test_trajectory_matches_jax_make_train_step():
    """Five steps with supplied eps and xnoise under an annealed jitter and
    a clipped, warmed-up cosine schedule; step 2's batch holds an inf. The
    skipped step keeps params, moments and the optimizer's count, while
    state.step (which drives the anneal) advances.

    The flows and the encoder use tanh: with relu, a hidden pre-activation
    that sits within rounding of 0 at some point opens its gate in one
    package and not the other (a multi-threaded CPU sum can flip its sign
    from run to run), and the gradient of that unit's input weights jumps by
    one point's share, past the 1e-3 limit (seen once in 40 repeats: the
    in_x/in_z rows of one point-flow unit at step 3). tanh has no gate; the
    optimizer, schedule, jitter and skip logic under test are the same."""
    raw = tiny(grad_clip=1.0, lr_warmup_steps=1, lr=3e-3, augment_noise=0.05,
               augment_noise_final=0.01, augment_noise_anneal_steps=4)
    for part in ("point_flow", "latent_flow", "encoder"):
        raw["model"][part]["activation"] = "tanh"
    cfg, jcfg = config_from_dict(raw), jax_config_from_dict(raw)
    torch.manual_seed(1)            # the modules' own init
    model = randomize_(DPF(cfg), 1, 0.05)
    tx = make_optimizer(cfg.train)
    state = init_state(model, tx)
    step = make_train_step(model, tx, cfg)

    jmodel = JaxDPF(jcfg)
    jtx = jtrainer.make_optimizer(jcfg.train)
    jp = _jparams(model)
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=jp,
                                 opt_state=jtx.init(jp))
    jstep = jtrainer.make_train_step(jmodel, jtx, jcfg)

    rng = np.random.default_rng(0)
    for i in range(5):
        x = rng.normal(size=(4, 64, 3)).astype(np.float32)
        if i == 2:
            x[1, 5, 0] = np.inf
        batch = {"x": x, "eps": rng.normal(size=(4, 16)).astype(np.float32),
                 "xnoise": rng.normal(size=(4, 64, 3)).astype(np.float32)}
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        assert float(m["nonfinite_skipped"]) == float(jm["nonfinite_skipped"]) == float(i == 2)
        assert state.step == int(jstate.step) == i + 1
        adam = jstate.opt_state[1][0]
        assert state.opt_state.count == int(adam.count) == (i if i > 2 else min(i + 1, 2))
        if i != 2:
            np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-4)
            np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]), rtol=1e-4)
        got = params_to_flax({k: v for k, v in model.named_parameters()})
        for name, tree in (("params", (got, jstate.params)),
                           ("mu", (params_to_flax(_named(state.opt_state.mu, model)),
                                   {"params": adam.mu["params"]})),
                           ("nu", (params_to_flax(_named(state.opt_state.nu, model)),
                                   {"params": adam.nu["params"]}))):
            a, b = (jax.tree.leaves(t) for t in tree)
            for u, v in zip(a, b):
                np.testing.assert_allclose(np.asarray(u), np.asarray(v), rtol=1e-3, atol=1e-6,
                                           err_msg=f"step {i} {name}")


def test_init_is_flax_like():
    model = init_params_(DPF(config_from_dict(tiny())), 0)
    out = model.point_flow.coupling(0).cond_net.out
    assert not out.weight.any() and not out.bias.any()
    w = model.encoder.point_1.weight
    assert abs(float(w.detach().std()) * np.sqrt(w.shape[1]) - 1.0) < 0.1
    assert float(w.detach().abs().max()) <= 2 / 0.8796 / np.sqrt(w.shape[1]) + 1e-6
    assert not model.encoder.point_1.bias.any()


@pytest.mark.parametrize("family", ["v1", "v3"])
def test_batches_match_dpfx_data(family):
    ds, jds = (m.SyntheticDataset(size=12, split="train", family=family)
               for m in (tdata, jdata))
    a = tdata.iterate_batches(ds, 5, 300, seed=3, epochs=2)
    b = jdata.iterate_batches(jds, 5, 300, seed=3, epochs=2)
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x["x"], y["x"])
    tail = list(tdata.iterate_batches(ds, 5, 300, seed=3, epochs=1, drop_last=False))
    assert [t["x"].shape[0] for t in tail] == [5, 5, 2]


def test_build_dataset_only_synthetic():
    cfg = config_from_dict(tiny()).data
    assert len(tdata.build_dataset(cfg, "train")) == 32
    cfg.dataset = "shapenet_h5"
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tdata.build_dataset(cfg, "train")


def _yaml(tmp_path, **train):
    import yaml

    raw = tiny(ckpt_dir=str(tmp_path / "ck"), log_every=2, ckpt_every=3, **train)
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_train_cli_then_generate(tmp_path, capsys):
    from dpfx_torch import generate

    cfg = _yaml(tmp_path, steps_per_call=4)
    assert train_cli.main([cfg, "train.steps=4", "data.device_resident=true", "--device",
                           "cpu"]) == 0
    out = capsys.readouterr().out
    assert "accepted and ignored" in out and "step 4/4" in out
    d = tmp_path / "ck" / "t"
    assert sorted(p.name for p in d.glob("*.pt")) == ["params_00000003.pt", "params_00000004.pt"]
    recs = [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]
    assert [r["step"] for r in recs] == [2, 4]
    assert all(np.isfinite(r["loss"]) and r["points_per_sec"] > 0 for r in recs)
    samples = tmp_path / "s.npy"
    assert generate.main([cfg, "--weights", str(d / "params_00000004.pt"), "--device", "cpu",
                          "--n-clouds", "2", "--n-points", "32", "--out", str(samples)]) == 0
    assert np.isfinite(np.load(samples)).all()


def test_train_defaults_to_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_cli.main([_yaml(tmp_path)])


def test_fit_aborts_after_skipped_windows(tmp_path):
    import yaml

    cfg = config_from_dict(yaml.safe_load(open(_yaml(tmp_path, abort_after_skipped_windows=2))))
    trainer = Trainer(cfg, device="cpu", log_fn=lambda s: None)
    bad = {"x": np.full((4, 64, 3), np.inf, np.float32)}
    with pytest.raises(TrainDivergedError):
        trainer.fit(iter([bad] * 10), steps=10)
    assert trainer.state.step == 4 and trainer.state.opt_state.count == 0
    assert not list((tmp_path / "ck" / "t").glob("*.pt"))
