"""Port parity: dpfx_torch.ops.fused_latent (the stacker, the plain forward,
backward and inverse, and the autograd Function) against the JAX package's
fused latent flow, whose Pallas kernels run in interpret mode on the CPU,
and against the port's own CouplingFlow, on the same numpy-seeded weights
and latents. Also the sampler's DPFX_SAMPLE_FUSED_LATENT switch."""

import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.ops import fused_latent as jfl  # noqa: E402
from dpfx_torch import sampling  # noqa: E402
from dpfx_torch.compat import params_to_flax  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.ops import fused_latent as tfl  # noqa: E402


def tiny(dz=32, n_layers=5, hidden=48, n_hidden=2, dtype="float32", activation="relu",
         actnorm=False):
    return {"experiment": "gen", "name": "t", "model": {
        "dz": dz,
        "point_flow": {"n_layers": 2, "hidden": 32, "n_hidden": 2, "scale_cap": 3.0},
        "latent_flow": {"n_layers": n_layers, "hidden": hidden, "n_hidden": n_hidden,
                        "compute_dtype": dtype, "activation": activation,
                        "use_actnorm": actnorm, "scale_cap": 3.0},
        "encoder": {"point_widths": [32, 64], "head_widths": [32]}}}


def _setup(seed=0, scale=0.1, **over):
    """A port model whose weights are the module init plus numpy-seeded
    noise (every coupling off the identity), and the same tree for JAX."""
    raw = tiny(**over)
    model = DPF(config_from_dict(raw))
    rng = np.random.default_rng(seed)
    model.load_state_dict({k: v + torch.from_numpy(scale * rng.normal(size=tuple(v.shape))
                                                    .astype(np.float32))
                           for k, v in model.state_dict().items()})
    params = jax.tree.map(jnp.asarray, params_to_flax(model.state_dict()))
    return model, params, jax_config_from_dict(raw).model.latent_flow


def _latents(b, dz, seed):
    return np.random.default_rng(seed).normal(size=(b, dz)).astype(np.float32)


def _jax_logp(params, z, jcfg):
    return np.asarray(jfl.fused_latent_log_prob(params, jnp.asarray(z), jcfg))


def _flat(tree):
    flat = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {"/".join(str(getattr(q, "key", q)) for q in path): np.asarray(v) for path, v in flat}


FLOWS = [dict(n_layers=5, hidden=48, n_hidden=2), dict(n_layers=4, hidden=32, n_hidden=1),
         dict(n_layers=3, hidden=40, n_hidden=3), dict(n_layers=6, hidden=32, n_hidden=2, dz=48)]


@pytest.mark.parametrize("over", FLOWS)
def test_stacker_matches_jax(over):
    model, params, jcfg = _setup(**over)
    ref = jfl.stack_latent_params_jnp(params, jcfg.n_layers, model.config.model.dz)
    got = tfl.stack_latent_params(model.latent_flow)
    assert set(got) == set(ref)
    for k in ref:
        assert tuple(got[k].shape) == ref[k].shape, k
        np.testing.assert_array_equal(got[k].detach().numpy(), np.asarray(ref[k]), err_msg=k)


@pytest.mark.parametrize("over", FLOWS)
def test_log_prob_matches_jax_and_module(over):
    model, params, jcfg = _setup(**over)
    z = _latents(5, model.config.model.dz, 1)
    got = tfl.fused_latent_log_prob(model, torch.from_numpy(z), model.config.model.latent_flow)
    got = got.detach().numpy()
    # both sum in f32, in other orders
    np.testing.assert_allclose(got, _jax_logp(params, z, jcfg), rtol=2e-5, atol=2e-5)
    ref = model.latent_flow.log_prob(torch.from_numpy(z)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("b", [1, 5, 130, 200])
def test_batch_sizes_match_jax(b):
    """Any B, no padding in the port; the JAX package pads B to 128 lanes
    and, beyond 128, accumulates the weight gradients over grid steps."""
    model, params, jcfg = _setup(n_layers=3, hidden=32, n_hidden=2)
    z = _latents(b, 32, b)
    got = tfl.fused_latent_log_prob(model, torch.from_numpy(z), model.config.model.latent_flow)
    np.testing.assert_allclose(got.detach().numpy(), _jax_logp(params, z, jcfg), rtol=2e-5,
                               atol=2e-5)
    inv = tfl.fused_latent_inverse(tfl.stack_latent_params(model.latent_flow),
                                   torch.from_numpy(z), model.config.model.latent_flow)
    ref = jfl.fused_latent_inverse(params, jnp.asarray(z), jcfg)
    np.testing.assert_allclose(inv.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)


def _torch_grads(model, z, weights):
    zt = torch.from_numpy(z).requires_grad_(True)
    model.zero_grad()
    lp = tfl.fused_latent_log_prob(model, zt, model.config.model.latent_flow)
    (lp * torch.from_numpy(weights)).sum().backward()
    grads = {k: p.grad for k, p in model.named_parameters()
             if k.startswith("latent_flow.") and p.grad is not None}
    return zt.grad.numpy(), _flat(params_to_flax(grads)["params"]["latent_flow"])


def _jax_grads(params, z, weights, jcfg):
    f = lambda p, zz: jnp.sum(jfl.fused_latent_log_prob(p, zz, jcfg) * jnp.asarray(weights))
    gp, gz = jax.grad(f, argnums=(0, 1))(params, jnp.asarray(z))
    return np.asarray(gz), _flat(gp["params"]["latent_flow"])


@pytest.mark.parametrize("over,b", [(FLOWS[0], 4), (FLOWS[1], 7), (FLOWS[2], 3),
                                    (dict(n_layers=3, hidden=32, n_hidden=2), 200)])
def test_grads_match_jax(over, b):
    """Every gradient through _LatentForward (z and each latent-flow
    parameter, through the stacker's mask fold and out split) against
    jax.grad through the Pallas custom VJP: rtol 5e-4, atol 5e-5, as
    tests/test_fused_latent.py holds the Pallas kernels to flax."""
    model, params, jcfg = _setup(**over)
    z = _latents(b, model.config.model.dz, 2)
    w = np.arange(1.0, b + 1.0, dtype=np.float32) / b
    gz_t, gp_t = _torch_grads(model, z, w)
    gz_j, gp_j = _jax_grads(params, z, w, jcfg)
    np.testing.assert_allclose(gz_t, gz_j, rtol=5e-4, atol=5e-5)
    assert gp_t.keys() == gp_j.keys() and gp_j
    for name in gp_j:
        np.testing.assert_allclose(gp_t[name], gp_j[name], rtol=5e-4, atol=5e-5, err_msg=name)


@pytest.mark.parametrize("over", FLOWS[:3])
def test_inverse_matches_jax_and_module(over):
    model, params, jcfg = _setup(**over)
    eps = _latents(7, model.config.model.dz, 4)
    got = tfl.fused_latent_inverse(tfl.stack_latent_params(model.latent_flow),
                                   torch.from_numpy(eps), model.config.model.latent_flow)
    ref = jfl.fused_latent_inverse(params, jnp.asarray(eps), jcfg)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref), rtol=2e-5, atol=2e-5)
    mod, _ = model.latent_flow.inverse(torch.from_numpy(eps))
    np.testing.assert_allclose(got.detach().numpy(), mod.detach().numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("over", FLOWS[:3])
def test_round_trip(over):
    """The forward undoes the inverse in f32: u = eps, and the log-det of
    the forward is minus that of the module's inverse."""
    model, _, _ = _setup(**over)
    w = tfl.stack_latent_params(model.latent_flow)
    lf = model.config.model.latent_flow
    masks = tfl.latent_masks(lf.n_layers, model.config.model.dz, torch.device("cpu"))
    eps = torch.from_numpy(_latents(6, model.config.model.dz, 5))
    with torch.no_grad():
        z = tfl.latent_inverse_plain(w, masks, 3.0, eps, torch.float32)
        u, ld = tfl.latent_forward_plain(w, masks, 3.0, z, torch.float32)
        _, inv_ld = model.latent_flow.inverse(eps)
    torch.testing.assert_close(u, eps, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(ld, -inv_ld, rtol=1e-5, atol=1e-5)


def test_bf16_close_to_jax():
    """bf16 conditioners: the operands round identically, but an f32 sum
    that lands on the other side of a bf16 rounding boundary flips one
    hidden unit by an ulp and the layers carry it on. log p(z) and the
    inverse agree to 1e-3 relative; each gradient tensor to 2% of its norm
    (the bracket of tests/test_torch_fused_train.py)."""
    model, params, jcfg = _setup(dtype="bfloat16", n_layers=5, hidden=48, n_hidden=2)
    lf = model.config.model.latent_flow
    z = _latents(9, 32, 6)
    got = tfl.fused_latent_log_prob(model, torch.from_numpy(z), lf).detach().numpy()
    np.testing.assert_allclose(got, _jax_logp(params, z, jcfg), rtol=1e-3, atol=1e-3)
    inv = tfl.fused_latent_inverse(tfl.stack_latent_params(model.latent_flow),
                                   torch.from_numpy(z), lf).detach().numpy()
    ref = np.asarray(jfl.fused_latent_inverse(params, jnp.asarray(z), jcfg))
    np.testing.assert_allclose(inv, ref, rtol=1e-3, atol=1e-3)
    w = np.linspace(0.5, 1.5, 9, dtype=np.float32)
    gz_t, gp_t = _torch_grads(model, z, w)
    gz_j, gp_j = _jax_grads(params, z, w, jcfg)
    for name, a, b in [("z", gz_j, gz_t)] + [(k, gp_j[k], gp_t[k]) for k in gp_j]:
        assert np.linalg.norm(b - a) <= 2e-2 * np.linalg.norm(a) + 1e-6, name


@pytest.mark.parametrize("n_hidden", [1, 2, 3])
def test_plain_backward_is_autograd_of_plain_forward(n_hidden):
    """The hand-written reverse walk (inputs rebuilt from outputs, no stored
    chain) equals autograd through the plain forward in f32."""
    model, _, _ = _setup(n_layers=4, hidden=32, n_hidden=n_hidden)
    w = {k: v.detach().clone().requires_grad_(True)
         for k, v in tfl.stack_latent_params(model.latent_flow).items()}
    masks = tfl.latent_masks(4, 32, torch.device("cpu"))
    z = torch.from_numpy(_latents(6, 32, 7)).requires_grad_(True)
    u, ld = tfl.latent_forward_plain(w, masks, 3.0, z, torch.float32)
    g = torch.Generator().manual_seed(0)
    du, dld = torch.randn(u.shape, generator=g), torch.randn(ld.shape, generator=g)
    inputs = [z] + [w[k] for k in tfl.KEYS]
    ref = torch.autograd.grad((u * du).sum() + (ld * dld).sum(), inputs, allow_unused=True)
    got_z, got_w = tfl.latent_backward_plain({k: v.detach() for k, v in w.items()}, masks, 3.0,
                                             u.detach(), du, dld, torch.float32)
    for name, a, b in zip(("z",) + tfl.KEYS, ref, [got_z] + [got_w[k] for k in tfl.KEYS]):
        a = torch.zeros_like(b) if a is None else a
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-5, msg=name)


@pytest.mark.parametrize("dz,activation,actnorm", [(32, "relu", False), (24, "relu", False),
                                                   (16, "relu", False), (20, "relu", False),
                                                   (32, "gelu", False), (32, "relu", True)])
def test_supported_matches_jax(dz, activation, actnorm):
    raw = tiny(dz=dz, activation=activation, actnorm=actnorm)
    ours = tfl.fused_latent_supported(config_from_dict(raw).model.latent_flow, dz)
    assert ours == jfl.fused_latent_supported(jax_config_from_dict(raw).model.latent_flow, dz)


@pytest.mark.parametrize("env", ["1", "0"])
def test_sampler_latent_switch(env, monkeypatch):
    """make_sampler takes the fused latent inverse under
    DPFX_SAMPLE_FUSED_LATENT=1 (weights stacked once), the module otherwise;
    in f32 both give the same clouds."""
    model, _, _ = _setup(n_layers=4, hidden=32, n_hidden=2)
    calls = []
    real = sampling.fused_latent_inverse
    monkeypatch.setattr(sampling, "fused_latent_inverse",
                        lambda stacked, eps, cfg: calls.append(eps.shape) or real(stacked, eps, cfg))
    monkeypatch.setenv("DPFX_SAMPLE_FUSED_LATENT", env)
    got = sampling.make_sampler(model, 3, 40)(11)
    assert calls == ([(3, 32)] if env == "1" else [])
    monkeypatch.setenv("DPFX_SAMPLE_FUSED_LATENT", "0")
    ref = sampling.make_sampler(model, 3, 40)(11)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4)
    assert bool(torch.isfinite(got).all()) and math.isfinite(float(got.std()))
