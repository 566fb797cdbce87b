"""The one-sweep Chamfer backward's algebra on the CPU
(dpfx_torch.ops.chamfer.onepass_bwd_plain and hit_counts): the hits of
each row and column counted on the unclamped distances, each pair's path
(the lists where every count is 1, the fix-up for a few ties, three passes
for many), the sums over the nearest-neighbour relations in index order.

  * Against dpfx's Pallas backward (``_nnd_bwd_pallas`` in interpret mode,
    through ``jax.grad`` of ``chamfer(impl="pallas")``) and against
    ``nn_distances_backward_plain``: rtol 1e-5, atol 1e-6 (the sums differ
    only in their order).
  * Equal bit for bit to the three passes' order of sums (written out
    below as ``three_pass_reference``: every term, the zeros included, in
    index order), on every path: what lets the kernel equal the three-pass
    kernel bit for bit.
  * The cluster split (ctas = 2, 4) equal to one CTA bit for bit.
  * The unclamped mask test equal to the clamped one.
  * The card tests' inputs for the kernel's rarer branches
    (tests/_torch_bwd_cases.py) reach them: inverse lists of 9 to 32
    members and of more than 32, and more than 256 points for the fix-up.
"""

import importlib
from fractions import Fraction

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from _torch_bwd_cases import copies_clouds, hub_clouds  # noqa: E402
from dpfx_torch.ops import chamfer as tc  # noqa: E402

jc = importlib.import_module("dpfx.ops.chamfer")

TOL = dict(rtol=1e-5, atol=1e-6)
HIT = 8192          # chamfer.cu's weight of a hit in a packed count


def clouds(seed, b, n, m, case="generic"):
    """b pairs of clouds. "dup": y = x with every point twice (each count
    2); "ydup": y's points twice and x (n = m) a perturbed copy of y (each
    x's neighbour a tie of two copies; the perturbation, 0.02, keeps the
    neighbours apart by more than the distances' rounding, which two
    implementations round differently); "mixed": the last pair's y
    duplicated; "few": in the last pair three points of y copied (three
    ties)."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32) * 0.5
    y = rng.normal(size=(b, m, 3)).astype(np.float32) * 0.5
    if case == "dup":
        x[:, n // 2:] = x[:, : n - n // 2]
        y = x.copy()
    elif case == "ydup":
        y[:, m // 2:] = y[:, : m - m // 2]
        x = (y + rng.normal(size=y.shape).astype(np.float32) * 0.02).astype(np.float32)
    elif case == "mixed":
        y[-1, m // 2:] = y[-1, : m - m // 2]
    elif case == "few":
        y[-1, -3:] = y[-1, :3]
    return x, y, rng.uniform(0.5, 2.0, size=b).astype(np.float32)


def backward_inputs(x, y, w):
    """The forward's minima and chamfer's cotangents for loss sum(w * CD)."""
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    dl, _, dr, _ = tc.nn_distances_plain(xt, yt)
    wt = torch.from_numpy(w)[:, None]
    gl = (wt / x.shape[1]).expand(dl.shape).contiguous()
    gr = (wt / y.shape[1]).expand(dr.shape).contiguous()
    return xt, yt, dl, dr, gl, gr


def jax_pallas_grads(x, y, w):
    loss = lambda a, b: jnp.sum(jc.chamfer(a, b, "pallas") * w)
    gx, gy = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    return np.asarray(gx), np.asarray(gy)


def three_pass_reference(x, y, dl, dr, gl, gr):
    """The three passes of chamfer.cu's three_pass, written out: (A) the
    row counts and weights, (B) per column every row in order (fmaf of the
    masks, adds of the row weights), (C) per row every column in order,
    then the finishing arithmetic one rounding per operation."""
    d = tc.sqdist_matrix(x, y)
    ml, mr = (d <= dl[:, :, None]).float(), (d <= dr[:, None, :]).float()
    wl = gl / torch.clamp_min(ml.sum(-1), 1.0)
    z = lambda *s: torch.zeros(s, dtype=torch.float32)
    b, n, m = d.shape
    cnt, swl, sx, swx = z(b, m), z(b, m), z(b, m, 3), z(b, m, 3)
    for i in range(n):
        mri, wli = mr[:, i], torch.where(d[:, i] <= dl[:, i, None], wl[:, i, None], 0.0)
        xi = x[:, i, None].expand(b, m, 3)
        cnt = cnt + mri
        sx = tc.fma32(mri[..., None].expand(b, m, 3), xi, sx)
        swl = swl + wli
        swx = tc.fma32(wli[..., None].expand(b, m, 3), xi, swx)
    wr = gr / torch.clamp_min(cnt, 1.0)
    c = 2.0 * (gr + swl)
    gy = (c[..., None] * y - 2.0 * swx) - (2.0 * wr)[..., None] * sx
    swr, sy, swy = z(b, n), z(b, n, 3), z(b, n, 3)
    for j in range(m):
        mlj, wrj = ml[:, :, j], torch.where(d[:, :, j] <= dr[:, j, None], wr[:, j, None], 0.0)
        yj = y[:, j, None].expand(b, n, 3)
        sy = tc.fma32(mlj[..., None].expand(b, n, 3), yj, sy)
        swr = swr + wrj
        swy = tc.fma32(wrj[..., None].expand(b, n, 3), yj, swy)
    c = 2.0 * (gl + swr)
    gx = (c[..., None] * x - (2.0 * wl)[..., None] * sy) - 2.0 * swy
    return gx, gy


def _round_f32(q: Fraction) -> np.float32:
    """q rounded to the nearest f32, ties to even."""
    f = np.float32(float(q))
    cands = [np.nextafter(f, np.float32(-np.inf)), f, np.nextafter(f, np.float32(np.inf))]
    best = min(abs(Fraction(float(c)) - q) for c in cands)
    near = [c for c in cands if abs(Fraction(float(c)) - q) == best]
    return min(near, key=lambda c: int(np.array(c).view(np.int32)) & 1)


def test_fma32_rounds_once():
    """fma32 against exact rational arithmetic rounded to f32 once, on
    products that nearly cancel the addend (where two roundings part)."""
    rng = np.random.default_rng(0)
    a = rng.normal(size=1500).astype(np.float32)
    b = rng.normal(size=1500).astype(np.float32)
    c = (-(a.astype(np.float64) * b) * (1 + rng.normal(size=1500) * 1e-7)).astype(np.float32)
    c[:500] = rng.normal(size=500).astype(np.float32) * 2.0 ** rng.integers(-30, 30, size=500)
    got = tc.fma32(*(torch.from_numpy(v) for v in (a, b, c))).numpy()
    want = np.array([_round_f32(Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r)))
                     for p, q, r in zip(a, b, c)], dtype=np.float32)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    # a case where rounding the f64 sum to f32 rounds twice: p + c lies just
    # above a half-way point of f32 by less than an f64 ulp
    p, q, r = np.float32(1.0), np.float32(1.0 + 2.0 ** -23), np.float32(2.0 ** -24)
    assert tc.fma32(*(torch.tensor([v]) for v in (p, q, r))).item() == float(
        _round_f32(Fraction(float(p)) * Fraction(float(q)) + Fraction(float(r))))


L, F, T = tc.PATH_LISTS, tc.PATH_FIX, tc.PATH_THREE
# the paths: generic clouds the lists; 40 x's each tied between two copies
# (40 points whose count is not 1) and three ties the fix-up; 144
# duplicated points (more than FIX_MAX) the three passes
CASES = [(40, 40, "generic", [L] * 3), (48, 20, "generic", [L] * 3), (20, 52, "generic", [L] * 3),
         (72, 72, "dup", [T] * 3), (40, 40, "ydup", [F] * 3), (30, 40, "few", [L, L, F])]


@pytest.mark.parametrize("n,m,case,paths", CASES)
def test_matches_the_pallas_backward(n, m, case, paths):
    x, y, w = clouds(n + 3 * m, 3, n, m, case)
    gx, gy, got = tc.onepass_bwd_plain(*backward_inputs(x, y, w))
    assert got.tolist() == paths
    jx, jy = jax_pallas_grads(x, y, w)
    np.testing.assert_allclose(gx.numpy(), jx, **TOL)
    np.testing.assert_allclose(gy.numpy(), jy, **TOL)
    px, py = tc.nn_distances_backward_plain(*backward_inputs(x, y, w))
    np.testing.assert_allclose(gx.numpy(), px.numpy(), **TOL)
    np.testing.assert_allclose(gy.numpy(), py.numpy(), **TOL)


@pytest.mark.parametrize("n,m,case,last", [(40, 40, "generic", L), (33, 57, "generic", L),
                                           (57, 33, "generic", L), (36, 30, "few", F),
                                           (36, 30, "mixed", F), (80, 72, "mixed", T)])
def test_every_path_equals_the_three_passes_bit_for_bit(n, m, case, last):
    """Random cotangents; the sums over the hit relations in index order
    are the three passes' sums with their zeros left out, on every path
    (the last pair's is ``last``)."""
    x, y, _ = clouds(7 * n + m, 3, n, m, case)
    rng = np.random.default_rng(n * m)
    xt, yt, dl, dr, _, _ = backward_inputs(x, y, np.ones(3, np.float32))
    gl = torch.from_numpy(rng.normal(size=dl.shape).astype(np.float32))
    gr = torch.from_numpy(rng.normal(size=dr.shape).astype(np.float32))
    gx, gy, paths = tc.onepass_bwd_plain(xt, yt, dl, dr, gl, gr)
    rx, ry = three_pass_reference(xt, yt, dl, dr, gl, gr)
    assert paths.tolist() == [L, L, last]
    assert torch.equal(gx, rx) and torch.equal(gy, ry)


@pytest.mark.parametrize("n,m", [(300, 517), (600, 260), (40, 40)])
@pytest.mark.parametrize("ctas", [2, 4])
def test_cluster_split_is_exact(n, m, ctas):
    """Counts summed over the CTAs' shares of the tiles: equal to one CTA
    bit for bit."""
    x, y, w = clouds(n + m, 2, n, m)
    args = backward_inputs(x, y, w)
    one = tc.onepass_bwd_plain(*args)
    split = tc.onepass_bwd_plain(*args, ctas=ctas)
    assert one[2].tolist() == [L, L]
    for a, b in zip(one, split):
        assert torch.equal(a, b)
    for a, b in zip(tc.hit_counts(*args[:4]), tc.hit_counts(*args[:4], ctas=ctas)):
        assert torch.equal(a, b)


def test_counts_and_first_indices():
    """hit_counts against the clamped masks: the counts. (The kernel keeps
    a point's one hit's index in its packed count, which
    test_packed_count_holds_one_hit_exactly pins; hit_counts returns no
    index, since no plain path needs one.)"""
    x, y, w = clouds(5, 2, 70, 90, "mixed")
    xt, yt, dl, dr, _, _ = backward_inputs(x, y, w)
    rc, cc = tc.hit_counts(xt, yt, dl, dr, ctas=2)
    d = tc.sqdist_matrix(xt, yt)
    ml, mr = d <= dl[:, :, None], d <= dr[:, None, :]
    assert torch.equal(rc, ml.sum(-1)) and torch.equal(cc, mr.sum(-2))
    assert int(rc[1].max()) == 2 and int(rc[0].max()) == 1    # the copies tie in a row


def test_unclamped_mask_equals_clamped():
    """The sweep tests raw <= sweep_bound(dmin) on the unclamped distance:
    the forward's minima are clamped (>= 0), and for those max(raw, 0) <=
    dmin holds exactly when raw <= dmin; a bound below 0 or NaN, which no
    clamped distance meets, is tested as -inf. Near-identical clouds give
    negative raw distances (cancellation), which the test must contain."""
    rng = np.random.default_rng(3)
    y = rng.normal(size=(2, 64, 3)).astype(np.float32) * 3.0
    x = (y + rng.normal(size=y.shape).astype(np.float32) * 1e-6).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    x2, y2 = tc._norm2(xt), tc._norm2(yt)
    xy = (xt[:, :, None, 0] * yt[:, None, :, 0] + xt[:, :, None, 1] * yt[:, None, :, 1]
          + xt[:, :, None, 2] * yt[:, None, :, 2])
    raw = (x2[:, :, None] + y2[:, None, :]) - 2.0 * xy
    clamped = tc.sqdist_matrix(xt, yt)
    assert torch.equal(torch.clamp_min(raw, 0.0), clamped)
    assert int((raw < 0).sum()) > 0
    dl, _, dr, _ = tc.nn_distances_plain(xt, yt)
    assert int((dl == 0).sum()) > 0
    for dmin, ax in ((dl[:, :, None], -1), (dr[:, None, :], -2)):
        assert torch.equal(raw <= tc.sweep_bound(dmin), clamped <= dmin)
    odd = torch.tensor([-1e-3, -0.0, 0.0, float("nan"), 1e-7, float("inf")])
    r = torch.tensor([-2e-3, -1e-3, -1e-9, 0.0, 1e-7, 2e-7, float("inf")])
    assert torch.equal(r[:, None] <= tc.sweep_bound(odd)[None, :],
                       torch.clamp_min(r, 0.0)[:, None] <= odd[None, :])


@pytest.mark.parametrize("n", [1, 2, 4096])
def test_packed_count_holds_one_hit_exactly(n):
    """chamfer.cu packs a point's hits into one u32: HIT + k per hit at k.
    The word is in [HIT, 2 HIT) exactly when there is one hit (then at
    k = word - HIT); none gives 0, two or more at least 2 HIT, and no sum
    over up to 4096 hits wraps."""
    rng = np.random.default_rng(n)
    for count in (0, 1, 2, 3, n):
        for _ in range(20):
            ks = rng.choice(n, size=min(count, n), replace=False)
            word = int(sum(HIT + int(k) for k in ks))
            assert word < 2**32
            single = word - HIT if 0 <= word - HIT < HIT else -1
            assert (single >= 0) == (len(ks) == 1)
            if len(ks) == 1:
                assert single == ks[0]
    assert HIT > tc.MAX_POINTS


def kernel_plan(x, y):
    """Per pair, what nnd_bwd_kernel does with it: (path, each owner's
    inverse list's length [B, N + M], the points the fix-up takes [B]).
    Owners (rows, then columns) whose count is 1 list the points of the
    other cloud whose count is 1 and whose one hit they are. The fix-up
    takes the points whose count is not 1, on PATH_FIX the points they hit,
    and the owners of lists of more than 32."""
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    dl, _, dr, _ = tc.nn_distances_plain(xt, yt)
    rc, cc = tc.hit_counts(xt, yt, dl, dr)
    d = tc.sqdist_matrix(xt, yt)
    ml, mr = d <= dl[:, :, None], d <= dr[:, None, :]
    oddr, oddc = rc != 1, cc != 1
    odd = oddr.sum(1) + oddc.sum(1)
    paths = torch.where(odd == 0, L, torch.where(odd <= tc.FIX_MAX, F, T))
    lists = torch.cat([torch.where(oddr, 0, (mr & ~oddc[:, None, :]).sum(-1)),
                       torch.where(oddc, 0, (ml & ~oddr[:, :, None]).sum(-2))], 1)
    fixed = torch.cat([oddr | (mr & oddc[:, None, :]).any(-1),
                       oddc | (ml & oddr[:, :, None]).any(-2)], 1)
    fixed = torch.where((paths == F)[:, None], fixed, torch.cat([oddr, oddc], 1))
    return paths, lists, (fixed | (lists > 32)).sum(1)


@pytest.mark.parametrize("case", ["hubs", "copies"])
def test_card_inputs_reach_the_rare_branches(case):
    """The card tests' inputs (B=64 x 2048; two pairs here): hubs make
    lists of 9 to 32 members (a warp's sort) and of more than 32 (the
    fix-up), and the copies more than 256 points for the fix-up (more
    than one turn of each warp). At 512 points the same inputs' plain
    backward equals the three passes' order of sums bit for bit."""
    make = hub_clouds if case == "hubs" else copies_clouds
    x, y = make(64, 2048)
    paths, lists, fixed = kernel_plan(x[:2], y[:2])
    mid = ((lists > 8) & (lists <= 32)).sum(1)
    if case == "hubs":
        assert paths.tolist() == [L, L]
        assert bool((mid > 0).all()) and bool(((lists > 32).sum(1) > 0).all())
    else:
        assert paths.tolist() == [F, F]
        assert bool((fixed > 256).all())
    x, y = make(1, 512)
    xt, yt, dl, dr, _, _ = backward_inputs(x, y, np.ones(1, np.float32))
    rng = np.random.default_rng(4)
    gl = torch.from_numpy(rng.normal(size=dl.shape).astype(np.float32))
    gr = torch.from_numpy(rng.normal(size=dr.shape).astype(np.float32))
    gx, gy, got = tc.onepass_bwd_plain(xt, yt, dl, dr, gl, gr)
    assert got.tolist() == kernel_plan(x, y)[0].tolist() == paths[:1].tolist()
    rx, ry = three_pass_reference(xt, yt, dl, dr, gl, gr)
    assert torch.equal(gx, rx) and torch.equal(gy, ry)
