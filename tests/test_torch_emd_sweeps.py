"""``emd_sweeps_plain``, the plain version of the EMD kernel's sweep order
(two sweeps per level: level k's remainl update fused with level k+1's row
sums, level k's exp taken as the fourth power of level k+1's, level 0
without an exp, the last remainl update only with gradients), on the CPU.

In f64 the order is the same algorithm as ``emd_plain``'s to rounding
(limit 1e-10); in f32 the two part as two f32 runs of approxmatch do, so
they are held by the median pair (1e-4) and the largest (5e-3), the limits
chip_smoke.py holds the kernel to; against ``dpfx.ops.emd`` (its jnp oracle
and its Pallas kernel in interpret mode) at dpfx's own limit, rtol 1e-4,
atol 1e-5. Fast mode rounds to bf16 where ``_emd_fast_plain`` does and is
held to it and to dpfx's fast Pallas kernel at test_torch_emd.py's fast
limit (rtol 2e-3). The gradients against ``emd_grads_plain``."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dpfx_torch.ops import emd as te  # noqa: E402

je = importlib.import_module("dpfx.ops.emd")

TOL = dict(rtol=1e-4, atol=1e-5)
TOL_FAST = dict(rtol=2e-3, atol=1e-5)
TOL_F64 = dict(rtol=1e-10, atol=1e-12)
SIZES = [(48, 64), (37, 101), (64, 40)]


def clouds(seed, b, n, m):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, n, 3)).astype(np.float32) * 0.5,
            rng.normal(size=(b, m, 3)).astype(np.float32) * 0.5)


def held(a, b):
    e = (a.double() - b.double()).abs() / b.double().abs().clamp_min(1e-5)
    return float(e.median()) <= 1e-4 and float(e.max()) <= 5e-3


@pytest.mark.parametrize("n_iters", [1, 2, 4, 10])
@pytest.mark.parametrize("n,m", SIZES)
def test_sweeps_equal_plain_in_f64(n, m, n_iters):
    x, y = (torch.from_numpy(c).double() for c in clouds(0, 3, n, m))
    got = te.emd_sweeps_plain(x, y, n_iters)
    assert got.dtype == torch.float64
    torch.testing.assert_close(got, te.emd_plain(x, y, n_iters), **TOL_F64)


@pytest.mark.parametrize("n_iters", [4, 10])
@pytest.mark.parametrize("n,m", SIZES)
def test_sweeps_within_limits_of_plain_in_f32(n, m, n_iters):
    x, y = (torch.from_numpy(c) for c in clouds(1, 6, n, m))
    got = te.emd_sweeps_plain(x, y, n_iters)
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    assert held(got, te.emd_plain(x, y, n_iters))
    assert held(got, te.emd_plain(x.double(), y.double(), n_iters))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("n,m", [(64, 64), (48, 80)])
def test_sweeps_against_dpfx(impl, n, m):
    """test_torch_emd.py's test_emd_nograd case, its clouds (seed 1) and
    limit. On other clouds every f32 version, the plain one too, parts from
    an f64 run by up to ~5e-4 on a pair (seed 2 at 48 x 80: the plain
    version 4.6e-4, this order 1.8e-4, dpfx's jnp 5.9e-5), beyond this
    limit; the median and maximum rule above covers those."""
    x, y = clouds(1, 2, n, m)
    got = te.emd_sweeps_plain(torch.from_numpy(x), torch.from_numpy(y))
    ref = je.emd_nograd(jnp.asarray(x), jnp.asarray(y), impl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("n_iters", [4, 10])
@pytest.mark.parametrize("n,m", [(40, 40), (36, 64)])
def test_sweeps_fast_mode(n, m, n_iters):
    x, y = clouds(3, 3, n, m)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    got = te.emd_sweeps_plain(tx, ty, n_iters, precision="fast")
    np.testing.assert_allclose(got.numpy(), te._emd_fast_plain(tx, ty, n_iters).numpy(), **TOL_FAST)
    ref = je.emd_pairwise(jnp.asarray(x), jnp.asarray(y), "pallas", n_iters, precision="fast")
    np.testing.assert_allclose(got.numpy(), np.diagonal(np.asarray(ref)), **TOL_FAST)
    # and within dpfx's fast-against-exact budget (tests/test_emd.py)
    np.testing.assert_allclose(got.numpy(), te.emd_sweeps_plain(tx, ty, n_iters).numpy(),
                               rtol=2e-2, atol=1e-3)


@pytest.mark.parametrize("n_iters", [1, 4, 10])
@pytest.mark.parametrize("n,m", SIZES)
def test_sweeps_gradients(n, m, n_iters):
    """With grad, the sweeps' sums give dpfx's plan-constant gradients: the
    last level's remainl sweep runs only for them (equal to emd_grads_plain
    in f64; the cost is the no-gradient run's, bit for bit)."""
    x, y = (torch.from_numpy(c).double() for c in clouds(4, 3, n, m))
    cost, gx, gy = te.emd_sweeps_plain(x, y, n_iters, grad=True)
    pc, px, py = te.emd_grads_plain(x, y, n_iters)
    assert torch.equal(cost, te.emd_sweeps_plain(x, y, n_iters))
    torch.testing.assert_close(cost, pc, **TOL_F64)
    torch.testing.assert_close(gx, px, **TOL_F64)
    torch.testing.assert_close(gy, py, **TOL_F64)
    c32, gx32, _ = te.emd_sweeps_plain(x.float(), y.float(), n_iters, grad=True)
    assert c32.dtype == gx32.dtype == torch.float32 and bool(torch.isfinite(gx32).all())


def test_sweeps_conditions():
    x, y = (torch.from_numpy(c) for c in clouds(5, 2, 16, 16))
    with pytest.raises(ValueError, match="precision"):
        te.emd_sweeps_plain(x, y, precision="bf16")
    with pytest.raises(ValueError, match="equal batches"):
        te.emd_sweeps_plain(x, y[:1])
