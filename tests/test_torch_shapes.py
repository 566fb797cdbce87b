"""The kernels' widths off the grid they are built for: the port pads the
point flow's conditioner width H up to 32, 64, 128 or 256, the latent
flow's dz and hidden and the encoder's point widths up to multiples of 16.
On numpy-seeded weights and inputs, the port's plain paths at such widths
against the JAX package's fused functions (their Pallas kernels in
interpret mode on the CPU); the padded plain paths against the unpadded
ones; and, over random shapes, the wrappers' shape checks on every shape
that a predicate accepts, where a Python mirror of the kernels' shared
memory exists."""

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from hypothesis import given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.ops import fused_encoder as jfe  # noqa: E402
from dpfx.ops import fused_latent as jfl  # noqa: E402
from dpfx.ops import fused_sampler as jfs  # noqa: E402
from dpfx.ops import fused_train as jft  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.ops import fused_encoder as tfe  # noqa: E402
from dpfx_torch.ops import fused_latent as tfl  # noqa: E402
from dpfx_torch.ops import fused_sampler as tfs  # noqa: E402
from dpfx_torch.ops import fused_train as tft  # noqa: E402
from _torch_cluster_plan import cluster_domain, cluster_plan  # noqa: E402
from _torch_f32_plan import f32_bwd_plan, f32_fwd_smem  # noqa: E402


def tiny(hidden=48, n_hidden=3, dz=24, lat_hidden=40, point_widths=(24, 40),
         dtype="float32"):
    return {"experiment": "gen", "model": {
        "dz": dz,
        "point_flow": {"n_layers": 3, "hidden": hidden, "n_hidden": n_hidden,
                       "compute_dtype": dtype, "scale_cap": 3.0},
        "latent_flow": {"n_layers": 3, "hidden": lat_hidden, "n_hidden": 2,
                        "compute_dtype": dtype, "scale_cap": 3.0},
        "encoder": {"point_widths": list(point_widths), "head_widths": [32],
                    "compute_dtype": dtype}}}


def _setup(seed=0, scale=0.1, **over):
    raw = tiny(**over)
    # the modules' own init draws from torch's global generator: seed it, so
    # every run tests the same weights
    torch.manual_seed(seed)
    model = randomize_(DPF(config_from_dict(raw)), seed, scale)
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    return model, params, jax_config_from_dict(raw).model


def _normal(seed, *shape):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _leaves(tree, module):
    flat = jax.tree_util.tree_flatten_with_path(tree["params"][module])[0]
    return {"/".join(str(getattr(q, "key", q)) for q in path): np.asarray(v) for path, v in flat}


def _torch_grads(model, module):
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return _leaves(params_to_flax(grads), module)


# ---------------------------------------------------------------- against dpfx

def test_point_flow_off_grid_matches_jax():
    """H=48 (padded to 64) with n_hidden 3: the log-likelihood through the
    fused training path and every gradient, against dpfx's
    fused_point_flow_recon_ll at the f32 limits of test_torch_fused_train
    (both sum in f32, in other orders)."""
    model, params, mcfg = _setup()
    x, z = _normal(1, 2, 130, 3), _normal(2, 2, 24)
    f = lambda p, xx, zz: jft.fused_point_flow_recon_ll(p, xx, zz, mcfg.point_flow)
    ll_j = np.asarray(f(params, x, z))
    gp, gx, gz = jax.grad(lambda p, xx, zz: f(p, xx, zz).sum(), argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(z))
    xt, zt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(z).requires_grad_(True)
    assert tfs.stack_point_flow_params(model.point_flow).wx.shape[1] == 64
    ll_t = tft.fused_point_flow_recon_ll(model, xt, zt, model.config.model.point_flow)
    ll_t.sum().backward()
    np.testing.assert_allclose(ll_t.detach().numpy(), ll_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz), rtol=1e-4, atol=1e-4)
    lj, lt = _leaves(gp, "point_flow"), _torch_grads(model, "point_flow")
    assert lj.keys() == lt.keys()
    for name in lj:
        np.testing.assert_allclose(lt[name], lj[name], rtol=1e-4, atol=1e-4, err_msg=name)


def test_sampler_inverse_off_grid_matches_jax():
    """The sampler's inverse given the noise, on the stacks padded to 64,
    against dpfx's fused_point_flow_inverse (its Pallas kernel at H=48) at
    the 1e-5 of test_torch_fused_sampler's f32 case."""
    model, params, _ = _setup()
    u, z = _normal(3, 2, 128, 3), _normal(4, 2, 24)
    with torch.no_grad():
        sp = tfs.stack_point_flow_params(model.point_flow)
    x = tfs.fused_point_flow_inverse(sp, torch.from_numpy(u), torch.from_numpy(z),
                                     dtype=torch.float32)
    jp = jfs.stack_point_flow_params(params, 3.0)
    ref = jfs.fused_point_flow_inverse(jp, jnp.asarray(u), jnp.asarray(z), tile=128,
                                       dtype=jnp.float32, activation="relu")
    np.testing.assert_allclose(x.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)


def test_latent_flow_dz24_matches_jax():
    """dz=24 (padded to 32) with hidden 40 (padded to 48) through the fused
    log-prob at dpfx's own limits for this shape (tests/test_fused_latent.py
    holds its kernels to flax at rtol 2e-4, atol 5e-5), every gradient at
    test_torch_fused_latent's 5e-4 / 5e-5, and the inverse."""
    model, params, mcfg = _setup(scale=0.05)
    lcfg = model.config.model.latent_flow
    z = _normal(5, 6, 24)
    w = np.linspace(0.5, 1.5, 6).astype(np.float32)
    f = lambda p, zz: jnp.sum(jfl.fused_latent_log_prob(p, zz, mcfg.latent_flow) * w)
    ref = np.asarray(jfl.fused_latent_log_prob(params, jnp.asarray(z), mcfg.latent_flow))
    gp, gz = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    got = tfl.fused_latent_log_prob(model, zt, lcfg)
    (got * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), ref, rtol=2e-4, atol=5e-5)
    np.testing.assert_allclose(zt.grad.numpy(), np.asarray(gz), rtol=5e-4, atol=5e-5)
    lj, lt = _leaves(gp, "latent_flow"), _torch_grads(model, "latent_flow")
    assert lj.keys() == lt.keys()
    for name in lj:
        np.testing.assert_allclose(lt[name], lj[name], rtol=5e-4, atol=5e-5, err_msg=name)
    inv = tfl.fused_latent_inverse(tfl.stack_latent_params(model.latent_flow),
                                   torch.from_numpy(z), lcfg)
    ref = jfl.fused_latent_inverse(params, jnp.asarray(z), mcfg.latent_flow)
    assert inv.shape == (6, 24)
    np.testing.assert_allclose(inv.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def test_encoder_widths_24_40_match_jax():
    """Point widths (24, 40), padded to (32, 48): the posterior and every
    gradient against dpfx's fused_pointnet_posterior at the 1e-5 of
    test_torch_fused_encoder's f32 case; cloud 0 holds every point twice
    (max-pool ties)."""
    model, params, mcfg = _setup()
    x = _normal(6, 2, 150, 3)
    x[0, 75:] = x[0, :75]
    f = lambda p, xx: jfe.fused_pointnet_posterior(p, xx, mcfg.encoder, mcfg.dz)
    mu_j, lv_j = f(params, x)
    gp, gx = jax.grad(lambda p, xx: sum(jnp.sum(t * s) for t, s in zip(f(p, xx), (1.0, 0.5))),
                      argnums=(0, 1))(params, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    mu, lv = tfe.fused_pointnet_posterior(model.encoder, xt)
    (mu.sum() + 0.5 * lv.sum()).backward()
    np.testing.assert_allclose(mu.detach().numpy(), np.asarray(mu_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lv.detach().numpy(), np.asarray(lv_j), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gx), rtol=1e-5, atol=1e-5)
    lj, lt = _leaves(gp, "encoder"), _torch_grads(model, "encoder")
    for name in lj:
        np.testing.assert_allclose(lt[name], lj[name], rtol=1e-5, atol=1e-5, err_msg=name)


# ---------------------------------------------------------------- padded == unpadded

def _unpad_point(sp, h):
    return sp._replace(wx=sp.wx[:, :h], wz=sp.wz[..., :h], bx=sp.bx[:, :h],
                       wh=sp.wh[:, :, :h, :h], bh=sp.bh[..., :h], wout=sp.wout[..., :h])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_point_flow_padding_is_exact(dtype):
    """The plain forward, backward and inverse on stacks padded 48 -> 64
    equal the same on the unpadded stacks to 1e-6, and every gradient of a
    padded entry is 0."""
    model, _, _ = _setup()
    with torch.no_grad():
        sp = tfs.stack_point_flow_params(model.point_flow)
    un = _unpad_point(sp, 48)
    xt = torch.from_numpy(_normal(7, 2, 3, 100))
    z = torch.from_numpy(_normal(8, 2, 24))
    hz, hz_u = tfs.z_projection(sp, z), tfs.z_projection(un, z)
    assert not hz[..., 48:].any()
    wts = lambda s: (s.wx, s.wh, s.bh, s.wout, s.bout, s.masks, s.scale_cap)
    u, ld = tft.fused_forward_plain(*wts(sp), xt, hz, dtype)
    u_u, ld_u = tft.fused_forward_plain(*wts(un), xt, hz_u, dtype)
    torch.testing.assert_close(u, u_u, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ld, ld_u, rtol=1e-6, atol=1e-6)
    du, dld = torch.from_numpy(_normal(9, *u.shape)), torch.from_numpy(_normal(10, 2))
    got = tft.fused_backward_plain(*wts(sp), u, hz, du, dld, dtype)
    ref = tft.fused_backward_plain(*wts(un), u_u, hz_u, du, dld, dtype)
    dx, dhz, dwx, dwh, dbh, dwout, dbout = got
    for name, a, r in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"],
                          [dx, dhz[..., :48], dwx[:, :48], dwh[:, :, :48, :48], dbh[..., :48],
                           dwout[..., :48], dbout], ref):
        torch.testing.assert_close(a, r, rtol=1e-6, atol=1e-6, msg=name)
    assert not dhz[..., 48:].any() and not dwx[:, 48:].any() and not dbh[..., 48:].any()
    assert not dwh[:, :, 48:].any() and not dwh[..., 48:].any() and not dwout[..., 48:].any()
    inv = tfs.fused_inverse_transposed_plain(sp, xt, hz, dtype)
    inv_u = tfs.fused_inverse_transposed_plain(un, xt, hz_u, dtype)
    torch.testing.assert_close(inv, inv_u, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_latent_padding_is_exact(dtype):
    """dz 24 -> 32 and hidden 40 -> 48: the plain forward (u, log-det),
    inverse and backward (dz and every weight gradient) on the padded stacks
    with the padded masks equal the unpadded ones to 1e-6; the padded
    features pass through as 0 and every padded entry's gradient is 0."""
    model, _, _ = _setup(scale=0.05)
    with torch.no_grad():
        w = tfl.stack_latent_params(model.latent_flow)
    wp = tfl.pad_latent_params(w)
    assert wp["win"].shape[1:] == (48, 32) and tfl.pad_latent_params(wp) is wp
    m, mp = tfl.latent_masks(3, 24, torch.device("cpu")), tfl.latent_masks(
        3, 24, torch.device("cpu"), 32)
    assert torch.equal(mp[:, :24], m) and bool((mp[:, 24:] == 1).all())
    z = torch.from_numpy(_normal(11, 5, 24))
    zp = torch.nn.functional.pad(z, (0, 8))
    u, ld = tfl.latent_forward_plain(wp, mp, 3.0, zp, dtype)
    u_u, ld_u = tfl.latent_forward_plain(w, m, 3.0, z, dtype)
    assert not u[:, 24:].any()
    torch.testing.assert_close(u[:, :24], u_u, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(ld, ld_u, rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(tfl.latent_inverse_plain(wp, mp, 3.0, zp, dtype)[:, :24],
                               tfl.latent_inverse_plain(w, m, 3.0, z, dtype), rtol=1e-6, atol=1e-6)
    du, dld = torch.from_numpy(_normal(12, 5, 24)), torch.from_numpy(_normal(13, 5))
    dz, g = tfl.latent_backward_plain(wp, mp, 3.0, u, torch.nn.functional.pad(du, (0, 8)), dld,
                                      dtype)
    dz_u, g_u = tfl.latent_backward_plain(w, m, 3.0, u_u, du, dld, dtype)
    torch.testing.assert_close(dz[:, :24], dz_u, rtol=1e-6, atol=1e-6)
    assert not dz[:, 24:].any()
    for k in tfl.KEYS:
        sl = tuple(slice(0, n) for n in g_u[k].shape)
        torch.testing.assert_close(g[k][sl], g_u[k], rtol=1e-6, atol=1e-6, msg=k)
        rest = g[k].clone()
        rest[sl] = 0.0
        assert not rest.any(), k


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_padding_is_exact(dtype):
    """Point widths (24, 40) -> (32, 48): the plain pool forward and
    backward on the padded layers equal the unpadded ones to 1e-6 on the
    real channels; the padded channels pool to 0 and every padded entry's
    gradient is 0."""
    model, _, _ = _setup()
    ws, bs = tfe.encoder_point_weights(model.encoder)
    ws, bs = [w.detach() for w in ws], [b.detach() for b in bs]
    pws, pbs = tfe.pad_point_layers(ws, bs)
    assert [tuple(w.shape) for w in pws] == [(32, 3), (48, 32)]
    x = torch.from_numpy(_normal(14, 2, 90, 3))
    x[0, 45:] = x[0, :45]
    g, cnt = tfe.pool_forward_plain(pws, pbs, x, dtype)
    g_u, cnt_u = tfe.pool_forward_plain(ws, bs, x, dtype)
    assert not g[:, 40:].any()
    torch.testing.assert_close(g[:, :40], g_u, rtol=1e-6, atol=1e-6)
    assert torch.equal(cnt[:, :40], cnt_u)
    dg = torch.from_numpy(_normal(15, 2, 40))
    dx, dws, dbs = tfe.pool_backward_plain(pws, pbs, x, g, cnt,
                                           torch.nn.functional.pad(dg, (0, 8)), dtype)
    dx_u, dws_u, dbs_u = tfe.pool_backward_plain(ws, bs, x, g_u, cnt_u, dg, dtype)
    torch.testing.assert_close(dx, dx_u, rtol=1e-6, atol=1e-6)
    for a, r in zip(dws + dbs, dws_u + dbs_u):
        sl = tuple(slice(0, n) for n in r.shape)
        torch.testing.assert_close(a[sl], r, rtol=1e-6, atol=1e-6)
        rest = a.clone()
        rest[sl] = 0.0
        assert not rest.any()


# ---------------------------------------------------------------- the predicates' domain

class _Cfg:
    def __init__(self, **kw):
        self.__dict__.update(activation="relu", use_actnorm=False, **kw)


DTYPES = st.sampled_from(["float32", "bfloat16"])


@settings(max_examples=60, deadline=None)
@given(hidden=st.integers(1, 320), n_hidden=st.integers(1, 18), dtype=DTYPES)
def test_point_flow_domain_passes_the_shape_checks(hidden, n_hidden, dtype):
    """The training predicate accepts exactly 1 <= H <= 256 with n_hidden
    1-4, and deeper conditioners up to the depths the mma and block-wide
    layouts hold (9, 4, 2, 1 in bf16 and 17, 5, 2, 0 in f32 at H = 32, 64,
    128, 256); on every accepted shape the padded width is one the kernels
    are built for, the sampler's shared memory (its mirror) fits in every
    mode, and at n_hidden 1-4 at 128 and 256 the layout the wrappers take
    past the mma and block-wide ones fits: in bf16 the cluster layout's
    plan (its mirror), which takes every shape the mma layout does not
    hold, in f32 the f32 layout's plan (its mirror)."""
    cfg = _Cfg(hidden=hidden, n_hidden=n_hidden, compute_dtype=dtype)
    ok = tft.fused_train_supported(cfg)
    deepest = dict(zip(tfs.KERNEL_HIDDEN, (9, 4, 2, 1) if dtype == "bfloat16" else (17, 5, 2, 0)))
    assert ok == (hidden <= 256 and n_hidden <= max(4, deepest[tfs.kernel_hidden(hidden)]))
    if not ok:
        return
    h, nh1, dt = tfs.kernel_hidden(hidden), n_hidden - 1, getattr(torch, dtype)
    assert h in tfs.KERNEL_HIDDEN and h >= hidden
    for int8 in (False, True):
        assert tfs.smem_bytes(h, dt, nh1, int8) <= tfs.SMEM_LIMIT
    if h in tft.WIDE_HIDDEN and n_hidden <= 4:
        for backward in (False, True):
            if dtype == "float32":
                t, need = f32_bwd_plan(h, nh1) if backward else (128, f32_fwd_smem(h))
                assert need <= tfs.SMEM_LIMIT and t in (32, 64, 128)
            elif n_hidden > tft.LAYOUT_N_HIDDEN[dtype][h]:
                assert cluster_domain(h, nh1, dt)
                t, _, need = cluster_plan(h, nh1, backward)
                assert need <= tfs.SMEM_LIMIT and t in (64, 128)


@settings(max_examples=60, deadline=None)
@given(dz=st.integers(2, 80).map(lambda q: 8 * q), hidden=st.integers(1, 1100),
       n_hidden=st.integers(1, 3), dtype=DTYPES)
def test_latent_domain_passes_the_shape_checks(dz, hidden, n_hidden, dtype):
    """On every (dz, hidden) that the latent predicate accepts, the padded
    widths are multiples of 16 and take a cluster plan (bf16) or fit a
    block (f32, the mirror) for the forward and the backward at B = 1, 64
    and 130."""
    cfg = _Cfg(hidden=hidden, n_hidden=n_hidden, compute_dtype=dtype)
    if not tfl.fused_latent_supported(cfg, dz):
        return
    d, h = tfl.padded_widths(dz, hidden)
    assert d % 16 == 0 and h % 16 == 0 and d - dz < 16 and h - hidden < 16
    for backward in (False, True):
        if dtype == "float32":
            assert tfl.f32_smem_bytes(d, h, n_hidden - 1, backward) <= tfs.SMEM_LIMIT
        else:
            for b in (1, 64, 130):
                assert tfl.cluster_plan(b, d, h, n_hidden - 1, backward).smem <= tfs.SMEM_LIMIT


def test_latent_domain_covers_the_flagships():
    """dpfx's predicate, and the latent flows of the flagship (dz=128, 14 x
    256) and latcap (28 x 512) configurations, in bf16; dz=24 hidden 40."""
    for dz, hidden, nh in ((128, 256, 2), (128, 512, 2), (24, 40, 2), (24, 40, 3)):
        for dtype in ("bfloat16", "float32"):
            assert tfl.fused_latent_supported(_Cfg(hidden=hidden, n_hidden=nh,
                                                   compute_dtype=dtype), dz)
    for dz in (16, 20, 12):
        assert not tfl.fused_latent_supported(_Cfg(hidden=64, n_hidden=2,
                                                   compute_dtype="bfloat16"), dz)


@settings(max_examples=40, deadline=None)
@given(widths=st.lists(st.integers(1, 300), min_size=1, max_size=4), dtype=DTYPES)
def test_encoder_domain_passes_the_shape_checks(widths, dtype):
    """On every list of point widths the encoder predicate accepts, the
    padded widths are multiples of 16 and their shared memory (the mirror)
    fits; the flagship's widths are accepted in both dtypes."""
    cfg = _Cfg(point_widths=widths, compute_dtype=dtype)
    if tfe.fused_encoder_supported(cfg):
        padded = [3] + [tfe.padded(w) for w in widths]
        assert all(w % 16 == 0 for w in padded[1:])
        assert tfe.smem_mirror(padded, getattr(torch, dtype)) <= tfs.SMEM_LIMIT
    for d in ("float32", "bfloat16"):
        assert tfe.fused_encoder_supported(_Cfg(point_widths=(128, 128, 256, 512),
                                                compute_dtype=d))


@pytest.mark.parametrize("hidden,n_hidden", [(320, 2), (64, 5)])
def test_outside_the_domain_training_warns_and_sampler_raises(hidden, n_hidden):
    """Past the domain (H > 256; in bf16 n_hidden > 4 at H=64, which the
    mma layouts do not hold) training warns once and takes the module path,
    as for an activation the kernels lack; the sampler's kernel checks
    refuse H > 256 naming the ROADMAP queue."""
    import warnings

    from dpfx_torch.train import loss as tloss

    raw = tiny(hidden=hidden, n_hidden=n_hidden, dtype="bfloat16")
    raw["model"]["point_flow"]["n_layers"] = 2
    torch.manual_seed(0)
    model = randomize_(DPF(config_from_dict(raw)), 0, 0.05)
    assert not tft.fused_train_supported(model.config.model.point_flow)
    x, eps = torch.from_numpy(_normal(20, 2, 48, 3)), torch.from_numpy(_normal(21, 2, 24))
    tloss._warned.clear()
    with pytest.warns(UserWarning, match=f"hidden={hidden}, n_hidden={n_hidden}"):
        a, _ = tloss.elbo_loss(model, x, eps, fused_point_flow=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tloss.elbo_loss(model, x, eps, fused_point_flow=True)
    b, _ = tloss.elbo_loss(model, x, eps, fused_point_flow=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    if hidden > 256:
        with torch.no_grad():
            sp = tfs.stack_point_flow_params(model.point_flow)
        assert sp.wx.shape[1] == hidden
        with pytest.raises(ValueError, match="ROADMAP"):
            tfs._check_kernel_args(sp, torch.zeros(1, 2, hidden), torch.bfloat16, "relu")
