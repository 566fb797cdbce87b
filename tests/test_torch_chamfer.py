"""The port's Chamfer distance (dpfx_torch.ops.chamfer) against
dpfx.ops.chamfer on the CPU, where the wrappers take their plain versions:
the same numpy clouds go through both, with dpfx run through its jnp oracle
and through its Pallas kernels (interpret mode on the CPU). Limit: rtol
1e-5, atol 1e-5, the limit of dpfx's own kernel-vs-oracle tests."""

import importlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from dpfx_torch.ops import chamfer as tc  # noqa: E402

jc = importlib.import_module("dpfx.ops.chamfer")

TOL = dict(rtol=1e-5, atol=1e-5)
SIZES = [(64, 64), (100, 60), (33, 128)]


def clouds(seed, s1, s2, n, m):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(s1, n, 3)).astype(np.float32) * 0.5,
            rng.normal(size=(s2, m, 3)).astype(np.float32) * 0.5)


def close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), **TOL)


@pytest.mark.parametrize("n,m", SIZES)
def test_sqdist_matrix(n, m):
    x, y = clouds(0, 2, 2, n, m)
    close(tc.sqdist_matrix(torch.from_numpy(x), torch.from_numpy(y)), jc.sqdist_matrix(x, y))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
@pytest.mark.parametrize("n,m", SIZES)
def test_nn_distances(impl, n, m):
    x, y = clouds(1, 3, 3, n, m)
    dl, dr = tc.nn_distances(torch.from_numpy(x), torch.from_numpy(y))
    dl_j, dr_j = jc.nn_distances(jnp.asarray(x), jnp.asarray(y), impl)
    close(dl, dl_j)
    close(dr, dr_j)


def test_nn_distances_plain_argmin():
    x, y = clouds(2, 2, 2, 50, 70)
    dl, il, dr, ir = tc.nn_distances_plain(torch.from_numpy(x), torch.from_numpy(y))
    dl_j, il_j, dr_j, ir_j = jc.nn_distances_jnp(jnp.asarray(x), jnp.asarray(y))
    close(dl, dl_j)
    close(dr, dr_j)
    np.testing.assert_array_equal(il.numpy(), np.asarray(il_j))
    np.testing.assert_array_equal(ir.numpy(), np.asarray(ir_j))


@pytest.mark.parametrize("impl", ["jnp", "pallas"])
def test_chamfer_and_parts(impl):
    x, y = clouds(3, 3, 3, 64, 96)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    close(tc.chamfer(xt, yt), jc.chamfer(jnp.asarray(x), jnp.asarray(y), impl))
    for a, b in zip(tc.chamfer_parts(xt, yt), jc.chamfer_parts(jnp.asarray(x), jnp.asarray(y), impl)):
        close(a, b)
    close(tc.chamfer_plain(xt, yt), tc.chamfer(xt, yt))


def test_chamfer_zero_on_identical():
    x, _ = clouds(4, 2, 1, 64, 8)
    assert float(tc.chamfer(torch.from_numpy(x), torch.from_numpy(x)).abs().max()) <= 1e-5


@pytest.mark.parametrize("precision", ["exact", "fast"])
@pytest.mark.parametrize("n,m", [(64, 64), (50, 70)])
def test_chamfer_pairwise(precision, n, m):
    xs, ys = clouds(5, 4, 3, n, m)
    got = tc.chamfer_pairwise(torch.from_numpy(xs), torch.from_numpy(ys), precision)
    assert got.shape == (4, 3)
    close(got, jc.chamfer_pairwise(jnp.asarray(xs), jnp.asarray(ys), "pallas", precision=precision))
    if precision == "exact":
        close(got, jc.chamfer_pairwise(jnp.asarray(xs), jnp.asarray(ys), "jnp"))


def test_chamfer_pairwise_symmetric():
    xs, _ = clouds(6, 4, 1, 96, 8)
    xt = torch.from_numpy(xs)
    tri = tc.chamfer_pairwise(xt, xt, symmetric=True)
    close(tri, jc.chamfer_pairwise(jnp.asarray(xs), jnp.asarray(xs), symmetric=True))
    torch.testing.assert_close(tri, tri.T, rtol=0, atol=0)
    torch.testing.assert_close(tri, tc.chamfer_pairwise(xt, xt), rtol=0, atol=0)
    with pytest.raises(ValueError, match="self-comparison"):
        tc.chamfer_pairwise(xt, xt[:3], symmetric=True)


def test_wrappers_refuse_gradients_and_bad_modes():
    x, y = (torch.from_numpy(c) for c in clouds(7, 2, 2, 16, 16))
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="Queue 2 #8"):
        tc.nn_distances(x, y)
    with pytest.raises(NotImplementedError, match="Queue 2 #8"):
        tc.chamfer_pairwise(x, y)
    with torch.no_grad():
        assert tc.chamfer(x, y).shape == (2,)
    with pytest.raises(ValueError, match="precision"):
        tc.chamfer_pairwise(x.detach(), y, "bf16")


def test_pair_list_and_kernel_conditions():
    assert tc.pair_list(3, 3, "diag", "cpu").tolist() == [[0, 0], [1, 1], [2, 2]]
    assert tc.pair_list(2, 3, "full", "cpu").tolist() == [[0, 0], [0, 1], [0, 2], [1, 0], [1, 1],
                                                           [1, 2]]
    assert tc.pair_list(3, 3, "upper", "cpu").tolist() == [[0, 0], [0, 1], [0, 2], [1, 1], [1, 2],
                                                            [2, 2]]
    # the kernel path takes CUDA tensors only: a CPU tensor never reaches it
    with pytest.raises(ValueError, match="CUDA"):
        tc.check_clouds(torch.zeros(1, 8, 3), torch.zeros(1, 8, 3), 0)
