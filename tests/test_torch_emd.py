"""The port's approxmatch EMD (dpfx_torch.ops.emd) against dpfx.ops.emd on
the CPU, where the wrappers take their plain versions: the same numpy clouds
go through both. Exact mode against dpfx's jnp oracle and its exact Pallas
kernels (interpret mode on the CPU) at rtol 1e-4, atol 1e-5, the limit of
dpfx's own kernel-vs-oracle test. The plain fast version against dpfx's fast
Pallas kernel at rtol 2e-3, atol 1e-5: both round to bf16 at the same
places, but their sums run in other orders and a sum that lands on the
other side of a bf16 rounding moves that row's scale by 2^-8 (seen: 3.3e-4)."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dpfx_torch.ops import emd as te  # noqa: E402

je = importlib.import_module("dpfx.ops.emd")

TOL = dict(rtol=1e-4, atol=1e-5)
TOL_FAST = dict(rtol=2e-3, atol=1e-5)


def clouds(seed, s1, s2, n, m):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(s1, n, 3)).astype(np.float32) * 0.5,
            rng.normal(size=(s2, m, 3)).astype(np.float32) * 0.5)


@pytest.mark.parametrize("n_iters", [10, 6, 1])
def test_match_levels(n_iters):
    assert te.match_levels(n_iters) == je.match_levels(n_iters)


def test_approx_match_and_cost():
    x, y = clouds(0, 2, 2, 48, 64)
    match = te.approx_match_plain(torch.from_numpy(x), torch.from_numpy(y))
    match_j = je.approx_match_jnp(jnp.asarray(x), jnp.asarray(y))
    # single entries of the plan move by up to ~1e-4 of mass between two f32
    # runs that sum in other orders (each row carries 64/48 in all); the cost
    # below is held to the package limit
    np.testing.assert_allclose(match.numpy(), np.asarray(match_j), rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(
        te.match_cost_plain(torch.from_numpy(x), torch.from_numpy(y), match).numpy(),
        np.asarray(je.match_cost_jnp(jnp.asarray(x), jnp.asarray(y), match_j)), **TOL)
    # every mass placed after the level-0 iteration: rows sum to factorl
    np.testing.assert_allclose(match.sum(-1).numpy(), 64 / 48, rtol=1e-3)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("n,m", [(64, 64), (48, 80)])
def test_emd_nograd(impl, n, m):
    x, y = clouds(1, 2, 2, n, m)
    got = te.emd_nograd(torch.from_numpy(x), torch.from_numpy(y))
    np.testing.assert_allclose(got.numpy(),
                               np.asarray(je.emd_nograd(jnp.asarray(x), jnp.asarray(y), impl)), **TOL)


def test_emd_near_zero_on_identical():
    x, _ = clouds(2, 2, 1, 64, 8)
    assert float(te.emd_nograd(torch.from_numpy(x), torch.from_numpy(x)).max()) < 1e-3


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_emd_pairwise_exact(impl):
    xs, ys = clouds(3, 3, 2, 40, 56)
    got = te.emd_pairwise(torch.from_numpy(xs), torch.from_numpy(ys), precision="exact")
    assert got.shape == (3, 2)
    ref = je.emd_pairwise(jnp.asarray(xs), jnp.asarray(ys), impl, precision="exact")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n,m", [(40, 40), (36, 64)])
def test_emd_pairwise_fast(n, m):
    xs, ys = clouds(4, 3, 2, n, m)
    got = te.emd_pairwise(torch.from_numpy(xs), torch.from_numpy(ys))      # fast: the default
    ref = je.emd_pairwise(jnp.asarray(xs), jnp.asarray(ys), "pallas", precision="fast")
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL_FAST)
    # and within dpfx's fast-against-exact budget (tests/test_emd.py)
    exact = te.emd_pairwise(torch.from_numpy(xs), torch.from_numpy(ys), precision="exact")
    np.testing.assert_allclose(got.numpy(), exact.numpy(), rtol=2e-2, atol=1e-3)


def test_plain_reference_dtypes():
    x, y = (torch.from_numpy(c) for c in clouds(5, 2, 2, 32, 40))
    e32 = te.emd_plain(x, y)
    e64 = te.emd_plain(x.double(), y.double())
    assert e32.dtype == torch.float32 and e64.dtype == torch.float64
    np.testing.assert_allclose(e32.numpy(), e64.numpy(), **TOL)


def test_wrappers_refuse_gradients_and_bad_modes():
    """emd is differentiable, as in dpfx; emd_nograd and emd_pairwise have
    no gradient there and refuse one here, pointing at emd."""
    x, y = (torch.from_numpy(c) for c in clouds(6, 2, 2, 16, 16))
    y.requires_grad_(True)
    for fn in (te.emd_nograd, te.emd_pairwise):
        with pytest.raises(NotImplementedError, match="use emd for gradients"):
            fn(x, y)
    te.emd(x, y).sum().backward()
    assert y.grad.shape == y.shape and bool(y.grad.abs().sum() > 0)
    with torch.no_grad():
        assert te.emd_nograd(x, y).shape == (2,)
    with pytest.raises(ValueError, match="precision"):
        te.emd_pairwise(x, y.detach(), precision="bf16")
    with pytest.raises(ValueError, match="equal batches"):
        te.emd_nograd(x, y.detach()[:1])
