"""CD and EMD above 4096 points a cloud, on the CPU, where the wrappers take
their plain versions.

The port's plain nn_distances (and its backward), chamfer,
chamfer_pairwise, emd, emd_nograd, emd_with_grads and emd_pairwise against
dpfx's jnp references on a ragged pair of 4608 against 4200 points (seeded
numpy clouds through both packages) at rtol 1e-4, atol 1e-5, the limit of
tests/test_torch_emd.py. dpfx's jnp references have no fast mode: the
plain fast versions are held to the exact references by the fast modes'
own drift at this density (seen: CD 2.0%, EMD 1.6% below exact; the
coordinates' bf16 rounding moves the small nearest distances of 4608
points), and to the kernels' fast arithmetic by tests/test_torch_chamfer.py
and tests/test_torch_emd.py. The plain versions of the large-cloud layout's
schedule (``large_plain``, ``large_bwd_plain``, ``emd_large_plain``) at
small N with small tiles and owners: the minima and the backward bit for
bit with the whole-pair ones, EMD within chip_smoke.py's phase 2c limits.
The layouts' plan (tests/_torch_distance_plan.py): every cloud up to 4096
points on the whole-pair layout, which fits, every larger one up to the
cap on the large layout, whose packed counts hold; the wrappers' check
raises just above the cap."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import _torch_bwd_cases as cases  # noqa: E402
import _torch_distance_plan as plan  # noqa: E402
from dpfx_torch.ops import chamfer as tc  # noqa: E402
from dpfx_torch.ops import emd as te  # noqa: E402

jc = importlib.import_module("dpfx.ops.chamfer")
je = importlib.import_module("dpfx.ops.emd")

TOL = dict(rtol=1e-4, atol=1e-5)
# fast modes against the exact references: the coordinates go to bf16 for
# x.y and each distance is rounded to bf16, which at 4608 points a cloud
# moves a pair's CD by 2.0% and its EMD by 1.6% (seen)
TOL_FAST = dict(rtol=3e-2, atol=1e-5)
# chip_smoke.py's phase 2c limits on a pair's EMD (relative, median and max)
EMD_MEDIAN, EMD_MAX, EMD_FLOOR = 1e-4, 5e-3, 1e-5
N, M = 4608, 4200


@pytest.fixture(scope="module")
def ragged():
    rng = np.random.default_rng(27)
    x = (0.5 * rng.normal(size=(2, N, 3))).astype(np.float32)
    y = (0.5 * rng.normal(size=(2, M, 3))).astype(np.float32)
    return x, y


def close(a, b, tol=TOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


def test_nn_distances_chamfer_and_backward_above_4096(ragged):
    x, y = ragged
    xt, yt = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(y).requires_grad_(True)
    dl, dr = tc.nn_distances(xt, yt)
    dl_j, _, dr_j, _ = jc.nn_distances_jnp(jnp.asarray(x), jnp.asarray(y))
    close(dl.detach(), dl_j)
    close(dr.detach(), dr_j)
    cd = tc.chamfer(xt, yt)
    close(cd.detach(), jc.chamfer(jnp.asarray(x), jnp.asarray(y), "jnp"))
    close(torch.stack(tc.chamfer_parts(xt, yt)).detach(),
          jnp.stack(jc.chamfer_parts(jnp.asarray(x), jnp.asarray(y), "jnp")))
    # random clouds have no ties: the even split and dpfx's argmin agree
    w = np.linspace(0.5, 1.5, 2).astype(np.float32)
    gx, gy = torch.autograd.grad((cd * torch.from_numpy(w)).sum(), (xt, yt))
    gx_j, gy_j = jax.grad(lambda a, b: (jc.chamfer(a, b, "jnp") * w).sum(), argnums=(0, 1))(
        jnp.asarray(x), jnp.asarray(y))
    close(gx, gx_j)
    close(gy, gy_j)
    # the large layout's plain versions: its minima and backward bit for bit
    ldl, ldr, lcd = tc.large_plain(xt.detach(), yt.detach())
    assert torch.equal(ldl, dl.detach()) and torch.equal(ldr, dr.detach())
    assert torch.equal(lcd, tc.onepass_plain(xt.detach(), yt.detach())[2])


def test_chamfer_pairwise_above_4096(ragged):
    x, y = ragged
    ref = jc.chamfer_pairwise(jnp.asarray(x), jnp.asarray(y), "jnp")
    close(tc.chamfer_pairwise(torch.from_numpy(x), torch.from_numpy(y)), ref)
    close(tc.chamfer_pairwise(torch.from_numpy(x), torch.from_numpy(y), "fast"), ref, TOL_FAST)


def test_emd_above_4096(ragged):
    x, y = ragged
    x1, y1 = x[:1], y[:1]
    cost_j, gx_j, gy_j = je.emd_grads_jnp(jnp.asarray(x1), jnp.asarray(y1))
    xt, yt = torch.from_numpy(x1).requires_grad_(True), torch.from_numpy(y1).requires_grad_(True)
    cost = te.emd(xt, yt)
    gx, gy = torch.autograd.grad(cost.sum(), (xt, yt))
    close(cost.detach(), cost_j)
    close(gx, gx_j)
    close(gy, gy_j)
    # emd's forward is emd_with_grads; emd_nograd and exact emd_pairwise
    # are emd_plain, whose cost emd_with_grads returns
    xs, ys = torch.from_numpy(x1), torch.from_numpy(y1)
    nograd = te.emd_nograd(xs, ys)
    assert torch.equal(nograd, cost.detach())
    close(te.emd_pairwise(xs, ys, precision="exact").flatten(), cost_j)
    close(te.emd_pairwise(xs, ys, precision="fast").flatten(), cost_j, TOL_FAST)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("rows,cols,n,m", [(32, 32, 100, 77), (64, 16, 70, 130), (256, 256, 300, 40)])
def test_large_plain_tiles(fast, rows, cols, n, m):
    """Several row groups and column tiles: the minima of the large
    layout's schedule are the whole-pair ones, bit for bit, and its CD."""
    g = torch.Generator().manual_seed(n + m)
    x, y = torch.randn(3, n, 3, generator=g), torch.randn(3, m, 3, generator=g)
    y[1, :5] = x[1, 3]                         # ties
    dl, dr, cd = tc.large_plain(x, y, fast, rows, cols)
    odl, odr, ocd = tc.onepass_plain(x, y, fast)
    assert torch.equal(dl, odl) and torch.equal(dr, odr) and torch.equal(cd, ocd)
    if not fast:
        pdl, _, pdr, _ = tc.nn_distances_plain(x, y)
        assert torch.equal(dl, pdl) and torch.equal(dr, pdr)


def _bwd_inputs(kind: str):
    if kind == "hubs":
        x, y = cases.hub_clouds(2, 300)
    elif kind == "copies":
        x, y = cases.copies_clouds(2, 400)
    elif kind == "duplicated":
        rng = np.random.default_rng(5)
        x = rng.normal(size=(2, 150, 3)).astype(np.float32)
        y = np.concatenate([x, x[:, :90]], 1)
    else:
        rng = np.random.default_rng(6)
        x = rng.normal(size=(3, 130, 3)).astype(np.float32)
        y = rng.normal(size=(3, 170, 3)).astype(np.float32)
        y[1, 7] = y[1, 9] = x[1, 4]            # one tie: the fix-up
    return torch.from_numpy(x), torch.from_numpy(y)


@pytest.mark.parametrize("kind", ["ragged", "hubs", "copies", "duplicated"])
def test_large_bwd_plain_equals_the_three_passes(kind):
    """Every path (lists of any length, the fix-up with its marks, three
    passes on every point) through the large layout's schedule: the three
    passes' gradients and paths bit for bit."""
    x, y = _bwd_inputs(kind)
    g = torch.Generator().manual_seed(1)
    dl, _, dr, _ = tc.nn_distances_plain(x, y)
    gl, gr = torch.randn(dl.shape, generator=g), torch.randn(dr.shape, generator=g)
    got = tc.large_bwd_plain(x, y, dl, dr, gl, gr)
    ref = tc.onepass_bwd_plain(x, y, dl, dr, gl, gr)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
    want = {"ragged": {0, 1}, "hubs": {0}, "copies": {1}, "duplicated": {2}}[kind]
    assert set(got[2].tolist()) == want


@pytest.mark.parametrize("own", [16, 32, 256])
def test_emd_large_plain_owners(own):
    """The large layout's order of sums (owners in CTAs of ``own``, their
    groups' parts in order) against the kernel's sweep order, exact, with
    the gradients, and fast: phase 2c's limits."""
    g = torch.Generator().manual_seed(own)
    x, y = 0.5 * torch.randn(3, 70, 3, generator=g), 0.5 * torch.randn(3, 45, 3, generator=g)
    for prec in ("exact", "fast"):
        got, ref = te.emd_large_plain(x, y, precision=prec, own=own), te.emd_sweeps_plain(x, y, precision=prec)
        rel = (got - ref).abs() / ref.abs().clamp_min(EMD_FLOOR)
        assert float(rel.median()) <= EMD_MEDIAN and float(rel.max()) <= EMD_MAX
    got, ref = te.emd_large_plain(x, y, grad=True, own=own), te.emd_sweeps_plain(x, y, grad=True)
    for a, b in zip(got[1:], ref[1:]):
        rel = (a - b).flatten(1).norm(dim=1) / b.flatten(1).norm(dim=1)
        assert float(rel.max()) <= 1e-4


def test_plan_routes_and_fits():
    """Up to PAIR_POINTS every pair takes the whole-pair layout, whose
    shared memory fits; above it, up to the cap, the large layout, whose
    packed counts stay below the mark and whose scratch is bounded."""
    assert (plan.PAIR_POINTS, plan.MAX_POINTS) == (tc.PAIR_POINTS, tc.MAX_POINTS)
    assert (plan.HIT_LARGE, plan.FIX_MAX) == (tc.HIT_LARGE, tc.FIX_MAX)
    sizes = [1, 2, 31, 255, 256, 257, 2000, 2048, 3001, 4095, 4096]
    for n in sizes:
        for m in sizes:
            assert plan.route(n, m) == "pair" and not tc.large_layout(n, m)
            assert max(plan.cd_smem(n, m), plan.bwd_smem(n, m), plan.emd_smem(n, m)) <= plan.SMEM_LIMIT
    for n, m in ((4097, 1), (1, 4097), (4097, 4096), (8193, 8193), (15000, 4500), (16384, 16384)):
        assert plan.route(n, m) == "large" and tc.large_layout(n, m)
    # where the whole-pair layouts stop fitting: just past 4096 a cloud
    assert plan.bwd_smem(4097, 4097) > plan.SMEM_LIMIT and plan.emd_smem(4320, 4320) > plan.SMEM_LIMIT
    # packed counts: a hit's weight above every index and count, the
    # largest word below the mark; the whole-pair layout's hit above its cap
    assert plan.HIT_LARGE > plan.MAX_POINTS and plan.largest_word(plan.MAX_POINTS, plan.MAX_POINTS) < plan.AFF
    assert plan.HIT_PAIR > plan.PAIR_POINTS
    # the large layout's work and scratch at the smoke's shapes
    assert plan.large_ctas(15000) == 59 and plan.bwd_large_grids(32, 15000, 15000)[0] == 32 * 59
    assert plan.cd_large_scratch_floats(64, 15000, 15000) == 64 * 30000
    assert plan.cd_large_chunk(10**6, 16384, 16384) == (1 << 26) // 32768
    assert plan.emd_own(32, 15000, 15000, False) == 1024 and plan.emd_own(8, 15000, 15000, False) == 256
    assert plan.emd_own(400, 15000, 15000, True) == 2048
    for fast in (False, True):
        state = plan.emd_state_bytes(16384, 16384, fast)
        assert plan.emd_chunk(10**6, 16384, 16384, fast) * state <= plan.LARGE_STATE_BYTES
    # the own points depend on P, N and M alone: the same for both modes of a launch's pairs
    assert plan.emd_own(64, 4097, 9000, False) == plan.emd_own(64, 4097, 9000, False)


def test_check_clouds_raises_just_above_the_cap():
    cap = tc.MAX_POINTS
    small = torch.zeros(1, 8, 3)
    for n, m in ((cap + 1, 8), (8, cap + 1)):
        with pytest.raises(ValueError, match=r"points per cloud.*Queue 2a"):
            tc.check_clouds(torch.zeros(1, n, 3), torch.zeros(1, m, 3), 0)
    # at the cap the size passes: a CPU tensor then fails only the device
    with pytest.raises(ValueError, match="CUDA"):
        tc.check_clouds(torch.zeros(1, cap, 3), small, 0)
