"""Port parity: dpfx_torch.ops.fused_encoder (its plain forward and
backward, through the autograd Function) against the JAX package's
fused_pointnet_posterior, whose Pallas kernels run in interpret mode on the
CPU, on the same numpy-seeded weights and clouds. The clouds hold
duplicated points (max-pool ties) and one feature is dead (its pooled max
is 0)."""

import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.ops import fused_encoder as jfe  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.ops import fused_encoder as tfe  # noqa: E402


def tiny(point_widths, head_widths, dtype="float32", activation="relu"):
    return {"experiment": "ae", "model": {
        "dz": 16,
        "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": list(point_widths), "head_widths": list(head_widths),
                    "compute_dtype": dtype, "activation": activation}}}


def _setup(point_widths, head_widths, n, dtype="float32", b=3, seed=0):
    cfg = tiny(point_widths, head_widths, dtype)
    # the modules' own init draws from torch's global generator: seed it, so
    # every run tests the same weights
    torch.manual_seed(seed)
    model = randomize_(DPF(config_from_dict(cfg)), seed, 0.1)
    last = getattr(model.encoder, f"point_{len(point_widths) - 1}")
    with torch.no_grad():
        last.bias[3] = -100.0                      # a dead feature: pooled max 0
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    x[0, n // 2:] = x[0, : n - n // 2]             # every point of cloud 0 twice: ties
    return model, jax_config_from_dict(cfg).model, x


def _jax(model, mcfg, x):
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    f = lambda p, xx: jfe.fused_pointnet_posterior(p, xx, mcfg.encoder, mcfg.dz)
    mu, lv = f(params, x)
    gp, gx = jax.grad(lambda p, xx: sum(jnp.sum(t * w) for t, w in zip(f(p, xx), (1.0, 0.5))),
                      argnums=(0, 1))(params, jnp.asarray(x))
    leaves = jax.tree_util.tree_flatten_with_path(gp["params"]["encoder"])[0]
    named = {"/".join(str(getattr(q, "key", q)) for q in path): np.asarray(v)
             for path, v in leaves}
    return np.asarray(mu), np.asarray(lv), named, np.asarray(gx)


def _torch(model, x):
    xt = torch.from_numpy(x).requires_grad_(True)
    model.zero_grad()
    mu, lv = tfe.fused_pointnet_posterior(model.encoder, xt)
    (mu.sum() + 0.5 * lv.sum()).backward()
    grads = {k: p.grad for k, p in model.named_parameters() if k.startswith("encoder.")}
    leaves = params_to_flax(grads)["params"]["encoder"]
    named = {f"{m}/{k}": v for m, d in leaves.items() for k, v in d.items()}
    return mu.detach().numpy(), lv.detach().numpy(), named, xt.grad.numpy()


@pytest.mark.parametrize("point_widths,head_widths,n", [
    ((32, 64), (32,), 200), ((32, 32, 64, 128), (64, 32), 256), ((16, 128), (32,), 130)])
def test_posterior_and_grads_match_jax_f32(point_widths, head_widths, n):
    model, mcfg, x = _setup(point_widths, head_widths, n)
    mu_j, lv_j, g_j, gx_j = _jax(model, mcfg, x)
    mu_t, lv_t, g_t, gx_t = _torch(model, x)
    np.testing.assert_allclose(mu_t, mu_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(lv_t, lv_j, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gx_t, gx_j, rtol=1e-4, atol=1e-5)
    assert g_j.keys() == g_t.keys()
    for name in g_j:
        np.testing.assert_allclose(g_t[name], g_j[name], rtol=1e-4, atol=1e-5, err_msg=name)
    dead = f"point_{len(point_widths) - 1}/bias"
    assert g_t[dead][3] == 0.0


def test_posterior_close_to_jax_bf16():
    """bf16: a product sum that lands on the other side of a bf16 boundary
    moves one activation by an ulp, which can move the argmax of a
    feature. mu/logvar agree to 2e-2; each gradient tensor to 5% of its
    norm (the bracket tests/test_fused_train.py uses for bf16)."""
    model, mcfg, x = _setup((32, 64), (32,), 256, dtype="bfloat16")
    mu_j, lv_j, g_j, gx_j = _jax(model, mcfg, x)
    mu_t, lv_t, g_t, gx_t = _torch(model, x)
    np.testing.assert_allclose(mu_t, mu_j, rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(lv_t, lv_j, rtol=2e-2, atol=2e-2)
    for name, a, b in [("x", gx_j, gx_t)] + [(k, g_j[k], g_t[k]) for k in g_j]:
        assert np.linalg.norm(b - a) <= 5e-2 * np.linalg.norm(a) + 1e-6, name


def test_ties_split_the_cotangent_evenly():
    """A feature whose max is reached by two copies of a point sends half
    of its cotangent to each; the count covers the whole cloud."""
    model, _, x = _setup((32, 64), (32,), 100, b=1)
    ws, bs = tfe.encoder_point_weights(model.encoder)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        g, cnt = tfe.pool_forward_plain(ws, bs, xt, torch.float32)
    live = g > 0
    assert bool((cnt[live] == 2).all()) and float(g[0, 3]) == 0.0
    dg = torch.ones_like(g)
    dx, _, _ = tfe.pool_backward_plain([w.detach() for w in ws], [b.detach() for b in bs],
                                       xt, g, cnt, dg, torch.float32)
    torch.testing.assert_close(dx[0, :50], dx[0, 50:], rtol=0, atol=0)


def test_unsupported_config_warns_once():
    from dpfx_torch.train import loss as tloss

    cfg = config_from_dict(tiny((32, 64), (32,), activation="gelu"))
    torch.manual_seed(0)            # the modules' own init
    model = randomize_(DPF(cfg), 0, 0.1)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 64, 3)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32))
    tloss._warned.clear()
    with pytest.warns(UserWarning, match="fused_encoder"):
        a, _ = tloss.elbo_loss(model, x, eps, fused_encoder=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tloss.elbo_loss(model, x, eps, fused_encoder=True)
    b, _ = tloss.elbo_loss(model, x, eps)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
