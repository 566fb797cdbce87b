"""Single-view reconstruction (SVR) in the port against dpfx: the conv and
mixer image encoders on one weight tree, the weight bridge for conv
kernels and norm scales, the SVR ELBO and train step, the resident step
with the render stack gathered by the clouds' ids, the SVR reconstruction
evaluation, and the training and evaluation CLIs on an SVR config."""

import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.models import DPF as JaxDPF  # noqa: E402
from dpfx.models import encoders as jenc  # noqa: E402
from dpfx.train import loss as jloss  # noqa: E402
from dpfx.train import trainer as jtrainer  # noqa: E402
from dpfx_torch import evaluate  # noqa: E402
from dpfx_torch.compat import params_from_flax, params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF, ConvImageEncoder, MixerImageEncoder  # noqa: E402
from dpfx_torch.train import (  # noqa: E402
    elbo_loss,
    gather_resident,
    init_params_,
    init_state,
    make_eval_step,
    make_optimizer,
    make_resident_multi_step,
    make_train_step,
    resident_draw,
)
from dpfx_torch.train import __main__ as train_cli  # noqa: E402
from test_torch_multi_step import assert_state_close  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / "configs" / "smoke_svr_synthetic.yaml")
SIZE, DZ = 16, 16
CPU = torch.device("cpu")
ENCODERS = {"conv": dict(widths=(8, 16), blocks_per_stage=2),
            "mixer": dict(patch=4, width=32, depth=2)}


def svr_tiny(arch, act="tanh", **train):
    """A small SVR model: flows of 4 layers at H=32, the image encoder at
    16 px (tanh flows: no relu gate for the two packages to open apart).
    The conv encoder takes widths (16, 32) here: at width 8, GroupNorm(8)
    has one channel a group, which cancels the preceding conv bias, and
    Adam turns that bias's gradient, rounding in both packages, into
    steps of the learning rate's size in random directions."""
    ie = {"arch": arch, "image_size": SIZE, **{k: list(v) if isinstance(v, tuple) else v
                                               for k, v in ENCODERS[arch].items()}}
    if arch == "conv":
        ie["widths"] = [16, 32]
    return {"experiment": "svr", "name": "svr", "model": {
        "dz": DZ,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "scale_cap": 3.0,
                       "activation": act},
        "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "activation": act},
        "image_encoder": ie},
        "data": {"dataset": "synthetic_svr", "n_points": 64, "synthetic_size": 16},
        "train": {"batch_size": 4, "steps": 5, "lr": 1e-3, "flat_optimizer": False, **train}}


def _tree(module, seed, *args, scale=0.1):
    """A flax params tree of ``module`` for inputs ``args``, from numpy: the
    shapes by jax.eval_shape (no compile), kernels N(0, 1/fan_in), norm
    scales 1 and biases 0 each moved by scale * N(0, 1)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0), *args)

    def leaf(path, a):
        name = jax.tree_util.keystr(path).split("'")[-2]
        base = (rng.normal(size=a.shape) / np.sqrt(np.prod(a.shape[:-1])) if name == "kernel"
                else np.ones(a.shape) if name == "scale" else np.zeros(a.shape))
        return (base + scale * rng.normal(size=a.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


def _images(seed, b=3):
    return np.random.default_rng(seed).uniform(size=(b, SIZE, SIZE, 3)).astype(np.float32)


def _encoder_pair(arch):
    if arch == "conv":
        return (jenc.ConvImageEncoder(dz=DZ, **ENCODERS[arch]),
                ConvImageEncoder(DZ, **ENCODERS[arch]))
    return (jenc.MixerImageEncoder(dz=DZ, **ENCODERS[arch]),
            MixerImageEncoder(DZ, image_size=SIZE, **ENCODERS[arch]))


@pytest.mark.parametrize("arch", ["conv", "mixer"])
def test_image_encoder_matches_flax(arch):
    """(mu, logvar) within 1e-5 on one perturbed weight tree, and the
    gradient of a random linear function of them within 1e-4 relative for
    every image-encoder leaf. The relative error's denominator is the
    leaf's norm, floored at 1e-3 of the whole gradient's: a conv bias
    right before a GroupNorm of one channel per group (s0_b*/Conv_0 at
    width 8) has a gradient that is zero by the algebra, and both packages
    read rounding there (~1e-6 against a whole gradient of ~80)."""
    jmod, tmod = _encoder_pair(arch)
    img = _images(0)
    params = _tree(jmod, 1, jnp.asarray(img))
    tmod.load_state_dict(params_from_flax(params), strict=True)
    wm, wl = np.random.default_rng(2).normal(size=(2, img.shape[0], DZ)).astype(np.float32)

    def jloss_fn(p):
        mu, logvar = jmod.apply(p, jnp.asarray(img))
        return jnp.sum(mu * wm) + jnp.sum(logvar * wl), (mu, logvar)

    (_, (mu_j, lv_j)), gj = jax.jit(jax.value_and_grad(jloss_fn, has_aux=True))(
        jax.tree.map(jnp.asarray, params))
    mu_t, lv_t = tmod(torch.from_numpy(img))
    np.testing.assert_allclose(mu_t.detach().numpy(), np.asarray(mu_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lv_t.detach().numpy(), np.asarray(lv_j), rtol=1e-5, atol=1e-5)
    loss = (mu_t * torch.from_numpy(wm)).sum() + (lv_t * torch.from_numpy(wl)).sum()
    names = [k for k, _ in tmod.named_parameters()]
    grads = torch.autograd.grad(loss, list(tmod.parameters()))
    gt = params_to_flax(dict(zip(names, grads)))
    flat_t = dict(jax.tree_util.tree_flatten_with_path(gt)[0])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(jax.tree.map(np.asarray, gj))[0])
    assert flat_t.keys() == flat_j.keys() and len(flat_j) == len(names)
    floor = 1e-3 * np.sqrt(sum(float((g ** 2).sum()) for g in flat_j.values()))
    for path, g in flat_j.items():
        assert flat_t[path].shape == g.shape, path
        err = np.linalg.norm(flat_t[path] - g) / max(np.linalg.norm(g), floor)
        assert err <= 1e-4, (jax.tree_util.keystr(path), err)


@pytest.mark.parametrize("arch", ["conv", "mixer"])
def test_bridge_round_trips_an_svr_tree(arch):
    """params_to_flax(params_from_flax(tree)) == tree exactly for a whole
    SVR model's tree (conv kernels, GroupNorm and LayerNorm scales), and
    the port's model takes it strictly."""
    jcfg = jax_config_from_dict(svr_tiny(arch))
    rng = jax.random.PRNGKey(0)
    tree = _tree(JaxDPF(jcfg), 3, jnp.zeros((2, 16, 3)), rng, jnp.zeros((2, SIZE, SIZE, 3)))
    sd = params_from_flax(tree)
    DPF(config_from_dict(svr_tiny(arch))).load_state_dict(sd, strict=True)
    back = params_to_flax(sd)
    a = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    b = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert a.keys() == b.keys()
    for path, v in b.items():
        assert a[path].dtype == v.dtype and np.array_equal(a[path], v), path
    kinds = {jax.tree_util.keystr(p).split("'")[-2] for p in b}
    assert {"kernel", "bias", "scale"} <= kinds


def test_bridge_keeps_kh_and_kw_apart():
    """A 3x3 kernel that differs under a swap of kh and kw: the bridged
    Conv2d equals flax's Conv, and a plain transpose (shape-compatible at
    3x3) would not."""
    import flax.linen as fnn

    conv = fnn.Conv(5, (3, 3))
    img = _images(4, b=2)
    params = _tree(conv, 5, jnp.asarray(img), scale=0.3)
    kern = params["params"]["kernel"]
    assert kern.shape == (3, 3, 3, 5) and np.abs(kern - kern.transpose(1, 0, 2, 3)).max() > 0.1
    want = np.asarray(conv.apply(params, jnp.asarray(img)))
    tconv = torch.nn.Conv2d(3, 5, 3, padding=1)

    def run(sd):
        tconv.load_state_dict(sd)
        with torch.no_grad():
            return tconv(torch.from_numpy(img).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()

    np.testing.assert_allclose(run(params_from_flax(params)), want, rtol=1e-5, atol=1e-5)
    naive = {"weight": torch.from_numpy(np.ascontiguousarray(kern.T)),
             "bias": torch.from_numpy(params["params"]["bias"])}
    assert np.abs(run(naive) - want).max() > 1e-2
    assert np.array_equal(params_to_flax(params_from_flax(params))["params"]["kernel"], kern)


def test_mixer_refuses_an_image_size_its_patch_does_not_divide():
    with pytest.raises(ValueError, match="not divisible by patch"):
        MixerImageEncoder(DZ, patch=5, width=32, depth=1, image_size=SIZE)


def test_init_covers_convs_and_norms():
    model = init_params_(DPF(config_from_dict(svr_tiny("conv"))), 0)
    ie = model.image_encoder
    w = ie.s1_b0.Conv_0.weight                   # [32, 16, 3, 3]: fan-in 144
    fan_in = w[0].numel()
    assert fan_in == 144
    assert abs(float(w.detach().std()) * np.sqrt(fan_in) - 1.0) < 0.1
    assert float(w.detach().abs().max()) <= 2 / 0.8796 / np.sqrt(fan_in) + 1e-6
    assert not ie.s1_b0.Conv_0.bias.any()
    gn = ie.s1_b0.GroupNorm_1
    assert bool((gn.weight == 1).all()) and not gn.bias.any()
    ln = init_params_(DPF(config_from_dict(svr_tiny("mixer"))), 0).image_encoder.ln_t_0
    assert bool((ln.weight == 1).all()) and not ln.bias.any()
    assert not hasattr(model, "encoder")         # an SVR model has no PointNet parameters


def _pair(raw, seed=1):
    """The port's SVR model, optimizer and state, and dpfx's on the same
    weights (perturbed off the identity)."""
    cfg, jcfg = config_from_dict(raw), jax_config_from_dict(raw)
    torch.manual_seed(seed)
    model = randomize_(DPF(cfg), seed, 0.05)
    tx = make_optimizer(cfg.train)
    state = init_state(model, tx)
    jtx = jtrainer.make_optimizer(jcfg.train)
    jp = jax.tree.map(lambda a: jnp.asarray(np.array(a)), params_to_flax(model.state_dict()))
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=jtx.init(jp))
    return cfg, jcfg, model, tx, state, JaxDPF(jcfg), jtx, jstate


@pytest.mark.parametrize("arch,fused", [("conv", False), ("mixer", False), ("mixer", True)])
def test_svr_elbo_matches_jax(arch, fused):
    """elbo_terms and elbo_loss with an image on supplied eps; with the
    fused flags on, the point flow takes its kernels and the fused encoder
    does not apply (the image posterior replaces it), in both packages."""
    raw = svr_tiny(arch, act="relu")
    cfg, jcfg, model, *_ = _pair(raw)
    jmodel = JaxDPF(jcfg)
    jp = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 70, 3)).astype(np.float32)
    eps = rng.normal(size=(3, DZ)).astype(np.float32)
    img = _images(6)
    t = model.elbo_terms(torch.from_numpy(x), torch.from_numpy(eps), image=torch.from_numpy(img))
    j = jax.jit(lambda p, *a: jmodel.apply(p, *a, method=jmodel.elbo_terms))(
        jp, jnp.asarray(x), jax.random.PRNGKey(0), jnp.asarray(img), jnp.asarray(eps))
    for k in ("recon_ll", "logp_z", "logq", "z"):
        np.testing.assert_allclose(t[k].detach().numpy(), np.asarray(j[k]), rtol=1e-5, atol=1e-4,
                                   err_msg=k)
    kw = dict(kl_weight=0.7, fused_point_flow=fused, fused_encoder=fused)
    lt, mt = elbo_loss(model, torch.from_numpy(x), torch.from_numpy(eps),
                       image=torch.from_numpy(img), **kw)
    lj, mj = jax.jit(lambda p, x_, i_, e_: jloss.elbo_loss(
        jmodel, p, x_, jax.random.PRNGKey(0), image=i_, eps=e_, **kw))(
        jp, jnp.asarray(x), jnp.asarray(img), jnp.asarray(eps))
    np.testing.assert_allclose(float(lt.detach()), float(lj), rtol=1e-5)
    assert mt.keys() == mj.keys()
    for k in mj:
        np.testing.assert_allclose(float(mt[k].detach()), float(mj[k]), rtol=1e-5, atol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("arch", ["conv", "mixer"])
def test_svr_train_steps_match_jax(arch):
    """Three SVR train steps under the clipped, warmed-up schedule and the
    annealed jitter, batches with images and supplied eps and xnoise,
    against dpfx's make_train_step: loss and grad norm at 1e-4, params and
    moments at the trajectory test's limits; the validation step too."""
    raw = svr_tiny(arch, grad_clip=1.0, lr_warmup_steps=1, lr=3e-3, augment_noise=0.05,
                   augment_noise_final=0.01, augment_noise_anneal_steps=4)
    cfg, jcfg, model, tx, state, jmodel, jtx, jstate = _pair(raw)
    step = make_train_step(model, tx, cfg)
    jstep = jtrainer.make_train_step(jmodel, jtx, jcfg)
    rng = np.random.default_rng(1)
    for i in range(3):
        batch = {"x": rng.normal(size=(4, 64, 3)).astype(np.float32),
                 "image": rng.uniform(size=(4, SIZE, SIZE, 3)).astype(np.float32),
                 "eps": rng.normal(size=(4, DZ)).astype(np.float32),
                 "xnoise": rng.normal(size=(4, 64, 3)).astype(np.float32)}
        state, m = step(state, {k: torch.from_numpy(v) for k, v in batch.items()})
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
                           jax.random.PRNGKey(0))
        for key in ("loss", "grad_norm", "kl"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    adam = assert_state_close(model, state, jstate, arch)
    assert state.step == int(jstate.step) == 3 and state.opt_state.count == int(adam.count) == 3
    batch = {"x": rng.normal(size=(4, 64, 3)).astype(np.float32),
             "image": rng.uniform(size=(4, SIZE, SIZE, 3)).astype(np.float32),
             "eps": rng.normal(size=(4, DZ)).astype(np.float32)}
    mt = make_eval_step(model, cfg)({k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    mj = jtrainer.make_eval_step(jmodel, jcfg)(
        jax.tree.map(lambda a: jnp.asarray(np.array(a)), params_to_flax(model.state_dict())),
        {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    for k in mj:
        np.testing.assert_allclose(float(mt[k]), float(mj[k]), rtol=1e-4, err_msg=k)


def test_resident_svr_step_gathers_images_with_the_clouds_ids():
    """A resident call on dpfx's draws with the render stack resident
    against dpfx's make_resident_multi_step(with_images=True) (the same
    index gathers cloud and render); and the port's own resident call equal
    bit for bit to eager steps on the clouds and images its draw chose."""
    raw = svr_tiny("mixer")
    s, p, k, b, n = 10, 100, 2, 4, 64
    rng = np.random.default_rng(7)
    data = rng.normal(size=(s, p, 3)).astype(np.float32)
    images = rng.uniform(size=(s, SIZE, SIZE, 3)).astype(np.float32)
    cfg, jcfg, model, tx, state, jmodel, jtx, jstate = _pair(raw)
    key = jax.random.PRNGKey(3)
    ci, pi, eps, _ = jtrainer._resident_draw(key, jnp.zeros((), jnp.int32), k, b, s, p, n, DZ,
                                             draw=jcfg.data.resident_draw)
    draws = (torch.from_numpy(np.array(ci)).long(), torch.from_numpy(np.array(pi)).long(),
             torch.from_numpy(np.array(eps)), None)
    state, m = make_resident_multi_step(model, tx, cfg)(
        state, torch.from_numpy(data), draws=draws, images=torch.from_numpy(images))
    jstate, jm = jtrainer.make_resident_multi_step(jmodel, jtx, jcfg, None, k, with_images=True)(
        jstate, jnp.asarray(data), jnp.asarray(images), key)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-4)
    assert_state_close(model, state, jstate, "resident svr")

    out = []
    for resident in (True, False):
        cfg, _, model, tx, state, *_ = _pair(raw, seed=2)
        dt, it = torch.from_numpy(data), torch.from_numpy(images)
        if resident:
            state, _ = make_resident_multi_step(model, tx, cfg)(state, dt, k, images=it)
        else:
            ci, pi, eps, xn = resident_draw(cfg, 0, k, s, p, CPU)
            x = gather_resident(dt, ci, pi)
            step = make_train_step(model, tx, cfg)
            for i in range(k):
                state, _ = step(state, {"x": x[i], "image": it[ci[i]], "eps": eps[i]})
        out.append((state.params.clone(), state.opt_state.mu.clone(), state.opt_state.nu.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_svr_reconstruction_eval_matches_jax(monkeypatch):
    """evaluate_reconstruction with images against dpfx's on the same
    weights, clouds and images, each decoder given the same point noise:
    recon-cd, recon-emd and the per-category table."""
    import dpfx.sampling as jsampling
    from dpfx.metrics import evaluate_reconstruction as jeval

    from dpfx_torch.metrics import protocol

    raw = svr_tiny("conv", act="relu")
    raw["eval"] = {"metrics": ["cd", "emd"], "batch_size": 8}
    cfg, jcfg, model, *_ = _pair(raw, seed=4)
    jmodel = JaxDPF(jcfg)
    jp = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    rng = np.random.default_rng(8)
    clouds = (rng.normal(size=(6, 48, 3)) * 0.5).astype(np.float32)
    images = _images(9, b=6)
    labels = np.array([0, 1, 2, 0, 1, 2])
    names = {0: "a", 1: "b", 2: "c"}
    u = rng.normal(size=(6, 48, 3)).astype(np.float32)
    monkeypatch.setattr(protocol, "make_decoder", lambda m, npts: (
        lambda z, seed: m.decode(z, npts, u=torch.from_numpy(u))))
    monkeypatch.setattr(jsampling, "make_decoder", lambda m, p, npts: (
        lambda z, key: m.apply(p, jnp.asarray(u), z,
                               method=lambda mm, uu, zz: mm.point_flow.inverse(uu, zz)[0])))
    got = protocol.evaluate_reconstruction(model, clouds, cfg, impl="plain", labels=labels,
                                           label_names=names, images=images)
    want = jeval(jmodel, jp, clouds, jcfg, jax.random.PRNGKey(0), images=jnp.asarray(images),
                 impl="jnp", labels=labels, label_names=names)
    assert got.keys() == want.keys() == {"recon-cd", "recon-emd", "per_category"}
    assert got["per_category"].keys() == want["per_category"].keys() == {"a", "b", "c"}
    np.testing.assert_allclose(got["recon-cd"], want["recon-cd"], rtol=1e-4)
    np.testing.assert_allclose(got["recon-emd"], want["recon-emd"], rtol=1e-4)
    for c, row in want["per_category"].items():
        for key, v in row.items():
            np.testing.assert_allclose(got["per_category"][c][key], v, rtol=1e-4,
                                       err_msg=f"{c} {key}")
    # the posterior is the image's: other images, other reconstructions
    other = protocol.evaluate_reconstruction(model, clouds, cfg, impl="plain",
                                             images=images[::-1].copy())
    assert other["recon-cd"] != got["recon-cd"]


def test_svr_train_resume_and_evaluate_clis(tmp_path, capsys):
    """python -m dpfx_torch.train on the SVR smoke config (host batches with
    images), --resume on to more steps, a resident run of calls of 2, then
    python -m dpfx_torch.evaluate on the checkpoint: the keys dpfx's
    evaluate.py prints for svr, finite."""
    ck = f"train.ckpt_dir={tmp_path}"
    assert train_cli.main([SMOKE, "train.steps=2", "train.log_every=1", ck, "--device",
                           "cpu"]) == 0
    out = capsys.readouterr().out
    assert "experiment=svr" in out and "images=32px" in out and "step 2/2" in out
    assert train_cli.main([SMOKE, "train.steps=3", "train.log_every=1", ck, "--resume",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step 3/3" in out
    run_dir = tmp_path / "smoke_svr_synthetic"
    records = [json.loads(ln) for ln in (run_dir / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [1, 2, 3]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in train)
    assert train_cli.main([SMOKE, "train.steps=2", "train.log_every=2", "train.steps_per_call=2",
                           "data.device_resident=true", f"train.ckpt_dir={tmp_path}/res",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "+ renders 32x32x3 (1 MB)" in out and "step 2/2" in out
    assert evaluate.main([SMOKE, ck, "--device", "cpu", "--limit", "8"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    res = json.loads(lines[-1])
    assert lines[0].startswith("[dpfx_torch] evaluating svr @ step 3 on cpu")
    assert set(res) == {"step", "n_test", "recon-cd"} and res["n_test"] == 8
    assert np.isfinite(res["recon-cd"])
