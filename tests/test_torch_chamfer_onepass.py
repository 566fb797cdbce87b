"""The one-pass Chamfer forward's algebra on the CPU
(dpfx_torch.ops.chamfer.onepass_plain): raw distances, minima per tile of
256 x 256, the clamp at 0 and fast mode's bf16 rounding after each minimum,
the tiles' and a cluster's CTAs' minima combined in the kernel's order, and
the kernel's fixed order of sums. Its minima must equal nn_distances_plain's
(and fast mode's, the minima of the rounded distance matrix) bit for bit,
its CD chamfer_pairwise_plain's within 1e-5 (dpfx's own limit), CD(X, Y)
must equal CD(Y, X) bit for bit (the triangle mode's mirror), and the
whole agrees with dpfx.ops.chamfer (impl="jnp") at tests/test_torch_chamfer.py's
limit."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dpfx_torch.ops import chamfer as tc  # noqa: E402

jc = importlib.import_module("dpfx.ops.chamfer")

TOL = dict(rtol=1e-5, atol=1e-5)
# ragged N != M across tile edges (256 rows, 32- and 256-column chunks), one
# pair of identical clouds where N == M
SIZES = [(64, 64), (100, 60), (33, 300), (300, 517), (256, 256)]


def clouds(seed, b, n, m, identical=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32) * 0.5
    y = rng.normal(size=(b, m, 3)).astype(np.float32) * 0.5
    if identical:
        y[0] = x[0]
    return x, y


def rel(a, b, floor=1e-7):
    return float(((a.double() - b.double()).abs() / b.double().abs().clamp_min(floor)).max())


@pytest.mark.parametrize("n,m", SIZES)
@pytest.mark.parametrize("ctas", [1, 2, 4])
def test_exact_minima_equal_the_plain_version(n, m, ctas):
    x, y = map(torch.from_numpy, clouds(0, 3, n, m, identical=n == m))
    dl, dr, cd = tc.onepass_plain(x, y, ctas=ctas)
    pdl, _, pdr, _ = tc.nn_distances_plain(x, y)
    assert torch.equal(dl, pdl) and torch.equal(dr, pdr)
    ref = tc.chamfer_pairwise_plain(x, y).diagonal()
    assert rel(cd, ref) <= 1e-5
    if n == m:
        assert float(cd[0]) == 0.0          # a cloud against itself


@pytest.mark.parametrize("n,m", SIZES)
def test_fast_minima_equal_the_rounded_matrix(n, m):
    x, y = map(torch.from_numpy, clouds(1, 3, n, m, identical=n == m))
    dl, dr, cd = tc.onepass_plain(x, y, fast=True)
    d = tc.sqdist_matrix(x, y, fast=True)
    assert torch.equal(dl, d.min(-1)[0]) and torch.equal(dr, d.min(-2)[0])
    assert rel(cd, tc.chamfer_pairwise_plain(x, y, "fast").diagonal()) <= 1e-5
    # every minimum is a bf16 value
    assert torch.equal(dl, dl.bfloat16().float()) and torch.equal(dr, dr.bfloat16().float())


@pytest.mark.parametrize("n,m", SIZES)
@pytest.mark.parametrize("fast", [False, True])
def test_mirror_and_cluster_split_are_bit_exact(n, m, fast):
    """CD(X, Y) == CD(Y, X) and every cluster size gives the one-CTA result."""
    x, y = map(torch.from_numpy, clouds(2, 2, n, m))
    _, _, cd = tc.onepass_plain(x, y, fast=fast)
    _, _, cd_t = tc.onepass_plain(y, x, fast=fast)
    assert torch.equal(cd, cd_t)
    for ctas in (2, 4):
        assert all(torch.equal(a, b) for a, b in zip(tc.onepass_plain(x, y, fast, ctas),
                                                     tc.onepass_plain(x, y, fast)))


def test_clamp_after_the_minimum_is_needed_only_once():
    """Near-identical points give raw distances below 0 (cancellation in
    |x|^2 + |y|^2 - 2 x.y): the clamped minimum is 0, as the plain version's."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 300, 3)).astype(np.float32) * 40.0
    y = (x + rng.normal(size=x.shape).astype(np.float32) * 1e-6).astype(np.float32)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    x2, y2 = tc._norm2(xt), tc._norm2(yt)
    raw = (x2[..., :, None] + y2[..., None, :]) - 2.0 * torch.einsum("bnc,bmc->bnm", xt, yt)
    assert float(raw.min()) < 0.0           # the case the clamp is for
    dl, dr, _ = tc.onepass_plain(xt, yt)
    pdl, _, pdr, _ = tc.nn_distances_plain(xt, yt)
    assert torch.equal(dl, pdl) and torch.equal(dr, pdr)
    assert float(dl.min()) >= 0.0


@pytest.mark.parametrize("n", [1, 255, 256, 257, 2048, 3000])
def test_block_order_sum(n):
    """The kernel's fixed order of sums: within f32 rounding of the f64 sum,
    and the same value for a vector and for itself padded with zeros."""
    v = torch.from_numpy(np.random.default_rng(n).random((4, n)).astype(np.float32))
    s = tc.block_order_sum(v)
    torch.testing.assert_close(s.double(), v.double().sum(-1), rtol=1e-6, atol=0)
    pad = torch.nn.functional.pad(v, (0, 300))
    assert torch.equal(tc.block_order_sum(pad), s)


@pytest.mark.parametrize("n,m", SIZES)
def test_matches_dpfx_jnp(n, m):
    """The same numpy clouds through dpfx's jnp oracle on the CPU."""
    x, y = clouds(4, 3, n, m, identical=n == m)
    dl, dr, cd = tc.onepass_plain(torch.from_numpy(x), torch.from_numpy(y))
    dl_j, dr_j = jc.nn_distances(jnp.asarray(x), jnp.asarray(y), "jnp")
    np.testing.assert_allclose(dl.numpy(), np.asarray(dl_j), **TOL)
    np.testing.assert_allclose(dr.numpy(), np.asarray(dr_j), **TOL)
    cd_j = jc.chamfer_pairwise(jnp.asarray(x), jnp.asarray(y), impl="jnp")
    np.testing.assert_allclose(cd.numpy(), np.diagonal(np.asarray(cd_j)), **TOL)
