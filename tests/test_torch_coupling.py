"""Port parity: dpfx_torch.models.coupling against dpfx.models.coupling on
the same numpy-seeded weights and inputs (f32 at 1e-5)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from dpfx.models import coupling as jc  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.models import coupling as tc  # noqa: E402


@pytest.mark.parametrize("dim", [3, 4, 16])
@pytest.mark.parametrize("n_layers", [1, 6, 9])
def test_make_masks_match(dim, n_layers):
    np.testing.assert_array_equal(tc.make_masks(dim, n_layers), jc.make_masks(dim, n_layers))


def _pair(dim, cond_dim, activation, actnorm, dtype="float32", n_layers=4, hidden=16):
    flow = tc.CouplingFlow(dim, n_layers, hidden, 2, cond_dim=cond_dim, use_actnorm=actnorm,
                           scale_cap=3.0, dtype=getattr(torch, dtype), activation=activation)
    randomize_(flow, seed=dim + 7 * n_layers, scale=0.15)
    jflow = jc.CouplingFlow(dim=dim, n_layers=n_layers, hidden=hidden, n_hidden=2,
                            use_actnorm=actnorm, scale_cap=3.0, dtype=jnp.dtype(dtype),
                            activation=activation)
    params = {"params": {k: v for k, v in params_to_flax(flow.state_dict())["params"].items()}}
    return flow, jflow, params


def _inputs(dim, cond_dim, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(2, 24, dim) if dim == 3 else (5, dim)).astype(np.float32)
    z = rng.normal(size=(2, cond_dim)).astype(np.float32) if cond_dim else None
    return x, z


def _compare(flow, jflow, params, x, z, atol, rtol):
    tx = torch.from_numpy(x)
    tz = None if z is None else torch.from_numpy(z)
    jz = None if z is None else jnp.asarray(z)
    with torch.no_grad():
        y_t, ld_t = flow(tx, tz)
        xi_t, ldi_t = flow.inverse(tx, tz)
        lp_t = flow.log_prob(tx, tz)
    y_j, ld_j = jflow.apply(params, jnp.asarray(x), jz, method=jflow.forward)
    xi_j, ldi_j = jflow.apply(params, jnp.asarray(x), jz, method=jflow.inverse)
    lp_j = jflow.apply(params, jnp.asarray(x), jz, method=jflow.log_prob)
    for a, b in ((y_t, y_j), (ld_t, ld_j), (xi_t, xi_j), (ldi_t, ldi_j), (lp_t, lp_j)):
        np.testing.assert_allclose(a.float().numpy(), np.asarray(b, np.float32),
                                   atol=atol, rtol=rtol)


@pytest.mark.parametrize("actnorm", [False, True])
@pytest.mark.parametrize("activation", ["relu", "gelu", "tanh", "leaky_relu"])
def test_point_flow_parity(activation, actnorm):
    """dim 3, conditioned on z (flax computes it channel-first)."""
    flow, jflow, params = _pair(3, 8, activation, actnorm)
    x, z = _inputs(3, 8)
    _compare(flow, jflow, params, x, z, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dim,activation,actnorm", [
    (16, "relu", False), (16, "gelu", True), (32, "tanh", False), (32, "leaky_relu", True)])
def test_latent_flow_parity(dim, activation, actnorm):
    """Unconditioned latent flow: dz=16 is channel-first in flax, dz=32 not."""
    flow, jflow, params = _pair(dim, None, activation, actnorm)
    x, _ = _inputs(dim, None, seed=1)
    _compare(flow, jflow, params, x, None, atol=1e-5, rtol=1e-5)


def test_identity_at_init():
    """Zero-init out layers: every coupling starts as the identity."""
    flow = tc.CouplingFlow(3, 4, 16, 2, cond_dim=8)
    x, z = _inputs(3, 8)
    with torch.no_grad():
        y, ld = flow(torch.from_numpy(x), torch.from_numpy(z))
    np.testing.assert_array_equal(y.numpy(), x)
    assert float(ld.abs().max()) == 0.0


def test_inverse_roundtrip():
    flow = randomize_(tc.CouplingFlow(3, 6, 16, 2, cond_dim=8, use_actnorm=True), 3, 0.15)
    x, z = _inputs(3, 8, seed=4)
    with torch.no_grad():
        y, ld = flow(torch.from_numpy(x), torch.from_numpy(z))
        xr, ldi = flow.inverse(y, torch.from_numpy(z))
    np.testing.assert_allclose(xr.numpy(), x, atol=1e-5)
    np.testing.assert_allclose((ld + ldi).numpy(), 0.0, atol=1e-5)


@pytest.mark.parametrize("dim,cond_dim", [(3, 8), (32, None)])
def test_bf16_close(dim, cond_dim):
    """bf16 conditioners: both frameworks round at each Dense output, but
    their activations and sums round in different places. Tolerance 0.05
    absolute / 0.05 relative on O(1) values (bf16 keeps ~3 digits, and a
    rounding flip moves s and t by ~1e-2 through 4 layers)."""
    flow, jflow, params = _pair(dim, cond_dim, "relu", False, dtype="bfloat16")
    x, z = _inputs(dim, cond_dim, seed=2)
    _compare(flow, jflow, params, x, z, atol=5e-2, rtol=5e-2)
