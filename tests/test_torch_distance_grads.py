"""The gradients of the port's differentiable distances (dpfx_torch.ops.chamfer
``nn_distances``/``chamfer``/``chamfer_parts``, dpfx_torch.ops.emd ``emd``)
against ``jax.grad`` of dpfx's on the CPU, where the wrappers take their
plain versions: the same numpy clouds and the same per-pair loss weights go
through both.

Tolerances:
  * CD against dpfx's Pallas backward (interpret mode): rtol 1e-5, atol 1e-6.
    Both test d <= dmin on distances of the same expression and split a
    tie evenly, so they differ only by the order of f32 sums (seen: 5e-8).
  * CD against dpfx's ``impl="jnp"`` (argmin-gather) backward on generic
    clouds, where there are no ties: the same limit.
  * EMD against ``jax.grad`` of dpfx's ``emd``: dpfx's own bracket between
    its two implementations (tests/test_emd.py:97-100: rtol 0.15, atol
    3e-3), and the relative norm of each gradient within 5e-2. approxmatch
    amplifies the order of f32 sums through its saturation recursion: on
    18 cases of 24-40 x 40-64 points the port read up to 6.3e-3 (max abs)
    and 1.6e-2 (relative norm) against both of dpfx's implementations,
    which read the same against each other there, while the f64 plain
    version parts from the f32 one by 3.5e-4 on one pair.
  * ``emd_grads_plain`` against ``emd_grads_jnp`` (one arithmetic, eager on
    both sides): the gradients as above; the cost within 5e-3 relative of
    it and of an f64 run, chip_smoke.py's limit for the largest pair. The
    same drift shows there: 7e-6 on the gradients of one pair of clouds,
    2.0e-3 on those of the test's, whose cost parts by 1.2e-3 from dpfx's
    with the f64 cost between the two.
  * EMD on near-coincident clouds against dpfx's ``impl="jnp"``: rtol 1e-5,
    atol 1e-6, relative norm 1e-5; there the plan is a matching and
    nothing chaotic is left (seen: 3e-8). dpfx's Pallas gradient must be at
    least 100 times larger in norm there (the deviation is deliberate).
"""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dpfx_torch.ops import chamfer as tc  # noqa: E402
from dpfx_torch.ops import emd as te  # noqa: E402

jc = importlib.import_module("dpfx.ops.chamfer")
je = importlib.import_module("dpfx.ops.emd")

TOL_CD = dict(rtol=1e-5, atol=1e-6)
TOL_EMD = dict(rtol=0.15, atol=3e-3)
TOL_EMD_NORM = 5e-2
TOL_EMD_COST = dict(rtol=5e-3, atol=0)


def clouds(seed, b, n, m, dup=False):
    """Two stacks of clouds; ``dup`` duplicates every point of y, so each
    nearest neighbour in y is a tie of two."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(b, n, 3)).astype(np.float32) * 0.5
    y = rng.normal(size=(b, m, 3)).astype(np.float32) * 0.5
    if dup:
        y[:, m // 2:] = y[:, : m - m // 2]
    return x, y, rng.uniform(0.5, 2.0, size=b).astype(np.float32)


def jax_grads(fn, x, y, w):
    loss = lambda x, y: jnp.sum(fn(x, y) * w)
    gx, gy = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x), jnp.asarray(y))
    return np.asarray(gx), np.asarray(gy)


def torch_grads(fn, x, y, w):
    xt = torch.from_numpy(x).requires_grad_(True)
    yt = torch.from_numpy(y).requires_grad_(True)
    (fn(xt, yt) * torch.from_numpy(w)).sum().backward()
    return xt.grad.numpy(), yt.grad.numpy()


@pytest.mark.parametrize("n,m,dup", [(32, 32, False), (40, 24, False), (64, 48, True),
                                     (24, 40, True)])
def test_chamfer_grads_match_pallas(n, m, dup):
    x, y, w = clouds(n + m, 3, n, m, dup)
    got = torch_grads(tc.chamfer, x, y, w)
    ref = jax_grads(lambda a, b: jc.chamfer(a, b, "pallas"), x, y, w)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **TOL_CD)
    if dup:
        # the two copies of each y point share its gradient evenly, where
        # the argmin backward of impl="jnp" gives it to one copy
        gy = got[1]
        half = m // 2
        np.testing.assert_allclose(gy[:, half:], gy[:, : m - half], **TOL_CD)
        jgy = jax_grads(lambda a, b: jc.chamfer(a, b, "jnp"), x, y, w)[1]
        assert np.abs(jgy - gy).max() > 1e-3


@pytest.mark.parametrize("n,m", [(32, 32), (48, 20)])
def test_chamfer_grads_match_jnp_generic(n, m):
    x, y, w = clouds(7 * n + m, 2, n, m)
    got = torch_grads(tc.chamfer, x, y, w)
    ref = jax_grads(lambda a, b: jc.chamfer(a, b, "jnp"), x, y, w)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **TOL_CD)


@pytest.mark.parametrize("part", [0, 1])
def test_chamfer_parts_one_part(part):
    """Only one directional mean reaches the loss: the other's cotangent is
    None in autograd and zero in the JAX VJP."""
    x, y, w = clouds(11 + part, 2, 36, 28)
    got = torch_grads(lambda a, b: tc.chamfer_parts(a, b)[part], x, y, w)
    ref = jax_grads(lambda a, b: jc.chamfer_parts(a, b, "pallas")[part], x, y, w)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **TOL_CD)


def test_nn_distances_backward_plain_gradcheck_f64():
    """The plain backward in f64 against finite differences of the plain
    forward, away from ties (generic clouds; both outputs, random
    cotangents)."""
    x, y, _ = clouds(3, 2, 12, 9)
    xt = torch.from_numpy(x).double().requires_grad_(True)
    yt = torch.from_numpy(y).double().requires_grad_(True)
    assert torch.autograd.gradcheck(tc.nn_distances, (xt, yt), eps=1e-6, atol=1e-7, rtol=1e-5)
    assert torch.autograd.gradcheck(tc.chamfer, (xt, yt), eps=1e-6, atol=1e-7, rtol=1e-5)


def test_nn_distances_backward_plain_is_the_masked_formula():
    """nn_distances_backward_plain against the gradient written per point:
    2 gl_i (x_i - y_nn) + sum over the points whose neighbour x_i is."""
    x, y, _ = clouds(4, 1, 10, 7)
    xt, yt = torch.from_numpy(x).double(), torch.from_numpy(y).double()
    dl, il, dr, ir = tc.nn_distances_plain(xt, yt)
    rng = np.random.default_rng(5)
    gl = torch.from_numpy(rng.normal(size=(1, 10)))
    gr = torch.from_numpy(rng.normal(size=(1, 7)))
    gx, gy = tc.nn_distances_backward_plain(xt, yt, dl, dr, gl, gr)
    ex, ey = torch.zeros_like(xt), torch.zeros_like(yt)
    for i in range(10):
        j = int(il[0, i])
        d = 2 * gl[0, i] * (xt[0, i] - yt[0, j])
        ex[0, i] += d
        ey[0, j] -= d
    for j in range(7):
        i = int(ir[0, j])
        d = 2 * gr[0, j] * (yt[0, j] - xt[0, i])
        ey[0, j] += d
        ex[0, i] -= d
    torch.testing.assert_close(gx, ex, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(gy, ey, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("n,m", [(32, 48), (40, 40)])
def test_emd_grads_match_dpfx(impl, n, m):
    x, y, w = clouds(n * m, 2, n, m)
    got = torch_grads(te.emd, x, y, w)
    ref = jax_grads(lambda a, b: je.emd(a, b, impl), x, y, w)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a, b, **TOL_EMD)
        assert np.linalg.norm(a - b) <= TOL_EMD_NORM * np.linalg.norm(b)


def test_emd_grads_plain_matches_emd_grads_jnp():
    x, y, _ = clouds(21, 2, 32, 48)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    cost, gx, gy = te.emd_grads_plain(xt, yt)
    jcost, jgx, jgy = je.emd_grads_jnp(jnp.asarray(x), jnp.asarray(y))
    for a, b in ((gx, jgx), (gy, jgy)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL_EMD)
        assert np.linalg.norm(a.numpy() - b) <= TOL_EMD_NORM * np.linalg.norm(b)
    c64 = te.emd_grads_plain(xt.double(), yt.double())[0].numpy()
    for ref in (np.asarray(jcost), c64):
        np.testing.assert_allclose(cost.numpy(), ref, **TOL_EMD_COST)
    # the cost under grad (dist from the coordinate difference) against the
    # no-grad path (sqrt of the expanded form), on one plan
    np.testing.assert_allclose(cost.numpy(), te.emd_plain(xt, yt).numpy(), rtol=1e-5, atol=1e-6)


def test_emd_primal_skips_the_gradient_mode():
    """Without an input that requires grad, emd is emd_nograd (dpfx's
    primal); with one, it carries the gradients."""
    x, y, _ = clouds(22, 2, 20, 20)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    torch.testing.assert_close(te.emd(xt, yt), te.emd_nograd(xt, yt), rtol=0, atol=0)
    xg = xt.clone().requires_grad_(True)
    cost = te.emd(xg, yt)
    assert cost.requires_grad
    torch.testing.assert_close(cost.detach(), te.emd_nograd(xt, yt), rtol=0, atol=0)
    with torch.no_grad():
        torch.testing.assert_close(te.emd(xg, yt), te.emd_nograd(xt, yt), rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 1])
def test_emd_grads_near_coincident_follow_jnp_not_pallas(seed):
    """x within ~1e-4 of y, where the expanded squared distance cancels to
    ~0: the port weighs each pair by 1/max(|x - y|, eps) from the
    coordinates, as dpfx's impl="jnp" does, and matches it (seen: relative
    norm 3e-8); dpfx's Pallas body weighs by 1/max(sqrt(expanded d), eps),
    up to 1/eps, and its gradient is orders of magnitude larger (seen:
    1e5 times the norm). The port keeps to the first on purpose."""
    rng = np.random.default_rng(seed)
    y = (rng.normal(size=(2, 32, 3)) * 0.5).astype(np.float32)
    x = (y + 1e-4 * rng.normal(size=y.shape)).astype(np.float32)
    w = np.array([1.0, 2.0], np.float32)
    got = torch_grads(te.emd, x, y, w)
    ref = jax_grads(lambda a, b: je.emd(a, b, "jnp"), x, y, w)
    pal = jax_grads(lambda a, b: je.emd(a, b, "pallas"), x, y, w)
    for a, b, p in zip(got, ref, pal):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)
        assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b)
        assert np.linalg.norm(p) >= 100 * np.linalg.norm(a)


def test_descent_lowers_chamfer_and_emd():
    """20 steps of plain gradient descent on chamfer + emd, from a perturbed
    copy of a cloud towards it, lower both (chip_smoke.py does the same at
    2048 points on the card)."""
    rng = np.random.default_rng(8)
    target = torch.from_numpy(rng.normal(size=(2, 48, 3)).astype(np.float32) * 0.5)
    x = (target + 0.1 * torch.from_numpy(rng.normal(size=(2, 48, 3)).astype(np.float32)))
    with torch.no_grad():
        cd0, emd0 = tc.chamfer(x, target), te.emd_nograd(x, target)
    for _ in range(20):
        x = x.detach().requires_grad_(True)
        (tc.chamfer(x, target) + te.emd(x, target)).sum().backward()
        x = x - 0.5 * x.grad
    with torch.no_grad():
        cd1, emd1 = tc.chamfer(x, target), te.emd_nograd(x, target)
    assert bool((cd1 < 0.5 * cd0).all()) and bool((emd1 < 0.8 * emd0).all()), (cd0, cd1, emd0, emd1)


def test_cpu_grads_launch_no_kernel():
    x, y, w = clouds(30, 2, 16, 16)
    tc.reset_launch_counts()
    te.reset_launch_counts()
    torch_grads(lambda a, b: tc.chamfer(a, b) + te.emd(a, b), x, y, w)
    assert sum(tc.launches.values()) == 0 and sum(te.launches.values()) == 0
    assert set(tc.launches) == {"nnd_fwd", "nnd_bwd", "cd_pairwise"}
    assert set(te.launches) == {"emd_batched", "emd_batched_grad", "emd_pairwise"}
