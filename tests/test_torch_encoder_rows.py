"""The fused encoder's plain backward walks only the critical rows (the
points that reach some live feature's maximum): dpfx_torch.ops.fused_encoder's
pool_backward_plain against the dense arithmetic over every point (the
backward as the Pallas kernel computes it, kept here as the oracle), at tiny
widths: every row critical, no row critical, one point winning every
feature, ragged N, f32 and bf16."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from dpfx_torch.ops import fused_encoder as fe  # noqa: E402


def dense_backward(ws, bs, x, g, cnt, dg, dtype):
    """Recompute every point, the tie mask, and the reverse walk over all
    of them, every cotangent rounded to ``dtype`` before a product."""
    rnd = lambda a: a.to(dtype).float()
    hs = fe._chain(ws, bs, x, dtype)
    h_last = hs[-1].float()
    tie = (h_last == g[:, None]).float()
    dh = dg[:, None] * tie / cnt.clamp_min(1.0)[:, None] * (h_last > 0)
    dws, dbs = [None] * len(ws), [None] * len(ws)
    for i in reversed(range(len(ws))):
        dws[i] = torch.einsum("bno,bni->oi", rnd(dh), rnd(hs[i]))
        dbs[i] = dh.sum((0, 1))
        dh = rnd(dh) @ rnd(ws[i])
        if i > 0:
            dh = dh * (hs[i].float() > 0)
    return dh, dws, dbs


def _weights(widths, seed, positive=False):
    rng = np.random.default_rng(seed)
    ws, bs = [], []
    for a, b in zip((3,) + tuple(widths), widths):
        w = rng.normal(size=(b, a)) / np.sqrt(a)
        ws.append(torch.from_numpy(np.abs(w) if positive else w).float())
        bs.append(torch.from_numpy(0.1 * rng.normal(size=b) * (not positive)).float())
    return ws, bs


def _cloud(kind, b, n, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32)
    if kind == "identical":          # every point of cloud 0 the same: every row critical
        x[0] = x[0, :1]
    elif kind == "winner":           # point 5 of every cloud beyond all others
        x = np.abs(x)
        x[:, 5] = 10.0
    return torch.from_numpy(x)


def _run(widths, kind, b, n, dtype, seed=0):
    ws, bs = _weights(widths, seed, positive=kind == "winner")
    if kind == "dead":               # every feature dead: no row critical
        bs[-1] = torch.full_like(bs[-1], -100.0)
    x = _cloud(kind, b, n, seed)
    g, cnt = fe.pool_forward_plain(ws, bs, x, dtype)
    dg = torch.from_numpy(np.random.default_rng(seed + 1).normal(size=g.shape)).float()
    got = fe.pool_backward_plain(ws, bs, x, g, cnt, dg, dtype)
    ref = dense_backward(ws, bs, x, g, cnt, dg, dtype)
    crit = ((fe._chain(ws, bs, x, dtype)[-1].float() == g[:, None]) & (g[:, None] > 0)).any(-1)
    return got, ref, crit


def _flat(r):
    return [r[0]] + list(r[1]) + list(r[2])


def _rel(a, b):
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


@pytest.mark.parametrize("kind", ["random", "identical", "dead", "winner"])
@pytest.mark.parametrize("widths,n", [((32, 64), 77), ((16, 32, 48), 200)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rows_walk_equals_dense_walk(kind, widths, n, dtype):
    got, ref, crit = _run(widths, kind, 3, n, dtype)
    tol = 1e-6 if dtype == torch.float32 else 2e-2
    for i, (a, b) in enumerate(zip(_flat(got), _flat(ref))):
        assert a.shape == b.shape and a.dtype == torch.float32, i
        if float(b.norm()) == 0.0:
            assert float(a.abs().max()) == 0.0, i
        else:
            assert _rel(a, b) <= tol, (i, _rel(a, b))
    # dx is exactly 0 on every row that reaches no live feature's max
    assert float(got[0][~crit].abs().max()) == 0.0
    if kind == "identical":
        assert bool(crit[0].all())
    if kind == "dead":
        assert not bool(crit.any()) and all(float(t.abs().max()) == 0.0 for t in _flat(got))
    if kind == "winner":
        assert crit.sum(1).tolist() == [1, 1, 1] and bool(crit[:, 5].all())


def test_rows_walk_skips_a_nonfinite_row_that_reaches_no_max():
    """A NaN on a row that is not critical no longer reaches dW (the dense
    walk carries 0 * NaN into it); g stays finite here, since the NaN row
    never wins the max."""
    ws, bs = _weights((16, 32), 0, positive=True)
    x = _cloud("winner", 2, 50, 0)
    g, cnt = fe.pool_forward_plain(ws, bs, x, torch.float32)
    x[1, 7] = float("nan")
    dg = torch.ones_like(g)
    dx, dws, dbs = fe.pool_backward_plain(ws, bs, x, g, cnt, dg, torch.float32)
    assert all(bool(torch.isfinite(t).all()) for t in [dx] + dws + dbs)
    _, ref_dws, _ = dense_backward(ws, bs, x, g, cnt, dg, torch.float32)
    assert not all(bool(torch.isfinite(t).all()) for t in ref_dws)
