"""Port parity: dpfx_torch.ops.fused_train (its plain forward and backward,
through the autograd Function) against the JAX package's
fused_point_flow_recon_ll, whose Pallas kernels run in interpret mode on
the CPU, on the same numpy-seeded weights, clouds and latents."""

import warnings

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.ops import fused_train as jft  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.ops import fused_train as tft  # noqa: E402
from dpfx_torch.ops.fused_sampler import stack_point_flow_params, z_projection  # noqa: E402


def tiny(n_layers=5, n_hidden=2, dtype="float32", activation="relu", actnorm=False):
    return {"experiment": "ae", "model": {
        "dz": 16,
        "point_flow": {"n_layers": n_layers, "hidden": 32, "n_hidden": n_hidden,
                       "compute_dtype": dtype, "activation": activation,
                       "use_actnorm": actnorm, "scale_cap": 3.0},
        "latent_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}


def _setup(n_layers, n_hidden, n, dtype="float32", b=3, seed=0):
    cfg = tiny(n_layers, n_hidden, dtype)
    # the modules' own init draws from torch's global generator, whose state
    # depends on the process and on the tests it ran before: seed it, so
    # every run tests the same weights
    torch.manual_seed(seed)
    model = randomize_(DPF(config_from_dict(cfg)), seed, 0.1)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    z = rng.normal(size=(b, 16)).astype(np.float32)
    return model, jax_config_from_dict(cfg).model.point_flow, x, z


def _jax_value_and_grads(model, jcfg, x, z):
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    f = lambda p, xx, zz: jft.fused_point_flow_recon_ll(p, xx, zz, jcfg)
    ll = f(params, x, z)
    gp, gx, gz = jax.grad(lambda p, xx, zz: f(p, xx, zz).sum(), argnums=(0, 1, 2))(
        params, jnp.asarray(x), jnp.asarray(z))
    return np.asarray(ll), gp, np.asarray(gx), np.asarray(gz)


def _torch_value_and_grads(model, x, z):
    xt = torch.from_numpy(x).requires_grad_(True)
    zt = torch.from_numpy(z).requires_grad_(True)
    model.zero_grad()
    ll = tft.fused_point_flow_recon_ll(model, xt, zt, model.config.model.point_flow)
    ll.sum().backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in model.named_parameters()}
    return ll.detach().numpy(), params_to_flax(grads), xt.grad.numpy(), zt.grad.numpy()


def _point_flow_leaves(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree["params"]["point_flow"])[0]
    return {"/".join(str(getattr(q, "key", q)) for q in path): np.asarray(v) for path, v in flat}


@pytest.mark.parametrize("n_layers,n_hidden,n", [(5, 2, 200), (4, 1, 256), (6, 3, 130)])
def test_values_and_grads_match_jax_f32(n_layers, n_hidden, n):
    model, jcfg, x, z = _setup(n_layers, n_hidden, n)
    ll_j, gp_j, gx_j, gz_j = _jax_value_and_grads(model, jcfg, x, z)
    ll_t, gp_t, gx_t, gz_t = _torch_value_and_grads(model, x, z)
    # both sum in f32, in other orders, over K layers and N points
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gx_t, gx_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gz_t, gz_j, rtol=1e-4, atol=1e-4)
    lj, lt = _point_flow_leaves(gp_j), _point_flow_leaves(gp_t)
    assert lj.keys() == lt.keys()
    for name in lj:
        np.testing.assert_allclose(lt[name], lj[name], rtol=1e-4, atol=1e-4, err_msg=name)


def test_values_and_grads_close_to_jax_bf16():
    """bf16 conditioners: the operands round identically, but a sum that
    lands on the other side of a bf16 boundary flips one hidden unit by an
    ulp and the layers carry it on. The log-likelihood agrees to 1e-3
    relative; each gradient tensor to 2% of its norm."""
    model, jcfg, x, z = _setup(6, 2, 256, dtype="bfloat16")
    ll_j, gp_j, gx_j, gz_j = _jax_value_and_grads(model, jcfg, x, z)
    ll_t, gp_t, gx_t, gz_t = _torch_value_and_grads(model, x, z)
    np.testing.assert_allclose(ll_t, ll_j, rtol=1e-3)
    lj, lt = _point_flow_leaves(gp_j), _point_flow_leaves(gp_t)
    for name, a, b in [("x", gx_j, gx_t), ("z", gz_j, gz_t)] + [(k, lj[k], lt[k]) for k in lj]:
        assert np.linalg.norm(b - a) <= 2e-2 * np.linalg.norm(a) + 1e-6, name


@pytest.mark.parametrize("n_hidden", [1, 2, 3])
def test_plain_backward_is_autograd_of_plain_forward(n_hidden):
    """The hand-written reverse walk (inputs rebuilt from outputs, no stored
    chain) equals autograd through the plain forward in f32."""
    model, _, x, z = _setup(5, n_hidden, 150)
    sp = stack_point_flow_params(model.point_flow)
    w = [t.detach().clone().requires_grad_(True) for t in (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout)]
    xt = torch.from_numpy(x).transpose(1, 2).contiguous().requires_grad_(True)
    hz = z_projection(sp, torch.from_numpy(z)).detach().requires_grad_(True)
    u, ld = tft.fused_forward_plain(*w, sp.masks, sp.scale_cap, xt, hz, torch.float32)
    g = torch.Generator().manual_seed(0)
    du = torch.randn(u.shape, generator=g)
    dld = torch.randn(ld.shape, generator=g)
    inputs = [xt, hz] + w
    ref = torch.autograd.grad((u * du).sum() + (ld * dld).sum(), inputs, allow_unused=True)
    ref = [torch.zeros_like(t) if r is None else r for r, t in zip(ref, inputs)]
    got = tft.fused_backward_plain(*[t.detach() for t in w], sp.masks, sp.scale_cap,
                                   u.detach(), hz.detach(), du, dld, torch.float32)
    for name, a, b in zip(["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"], ref, got):
        torch.testing.assert_close(b, a, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("activation,actnorm", [("gelu", False), ("relu", True)])
def test_unsupported_config_warns_once_and_uses_module_path(activation, actnorm):
    from dpfx_torch.train import loss as tloss

    cfg = config_from_dict(tiny(activation=activation, actnorm=actnorm))
    model = randomize_(DPF(cfg), 0, 0.1)
    assert not tft.fused_train_supported(cfg.model.point_flow)
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(2, 64, 3)).astype(np.float32))
    eps = torch.from_numpy(rng.normal(size=(2, 16)).astype(np.float32))
    tloss._warned.clear()
    tft.reset_launch_counts()
    with pytest.warns(UserWarning, match="fused_point_flow"):
        a, _ = tloss.elbo_loss(model, x, eps, fused_point_flow=True)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        tloss.elbo_loss(model, x, eps, fused_point_flow=True)
    b, _ = tloss.elbo_loss(model, x, eps, fused_point_flow=False)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
