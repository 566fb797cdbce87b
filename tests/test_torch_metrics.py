"""The port's generation metrics (dpfx_torch.metrics) against dpfx.metrics
on the CPU: the same numpy sets and matrices go through both. Distances
match to 1e-5 (CD) and 1e-4 (EMD), the limits of the ops' parity tests;
COV and 1-NNA are equal exactly (they are argmins and comparisons of those
distances, on sets far from ties); JSD matches to 1e-6 (the same grid and
counts, entropies summed in float64 by both)."""

import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import dpfx.metrics as jm  # noqa: E402
from dpfx_torch import metrics as tm  # noqa: E402

CD_TOL = dict(rtol=1e-5, atol=1e-5)
EMD_TOL = dict(rtol=1e-4, atol=1e-5)
FAST_EMD_TOL = dict(rtol=2e-3, atol=1e-5)     # the fast-mode limit of tests/test_torch_emd.py


def sets(seed=0, s=5, n=48):
    """A reference set of blobs at varied scales and a generated set drawn
    around it, so the matrices have clear minima."""
    rng = np.random.default_rng(seed)
    scale = rng.uniform(0.2, 0.6, size=(s, 1, 1))
    ref = (rng.normal(size=(s, n, 3)) * scale).astype(np.float32)
    gen = (ref[rng.permutation(s)] * 1.1 + 0.05 * rng.normal(size=(s, n, 3))).astype(np.float32)
    return gen, ref


def test_mmd_cov_one_nna_per_category_on_one_matrix():
    rng = np.random.default_rng(1)
    m_gr, m_gg, m_rr = (rng.uniform(size=(7, 7)).astype(np.float32) for _ in range(3))
    labels = np.array([0, 1, 2, 0, 1, 2, 0])
    assert tm.mmd_cov(m_gr) == jm.mmd_cov(m_gr)
    assert tm.mmd_cov(torch.from_numpy(m_gr)) == jm.mmd_cov(m_gr)
    assert tm.one_nna(m_gg, m_gr, m_rr) == jm.one_nna(m_gg, m_gr, m_rr)
    assert tm.per_category_mmd_cov(m_gr, labels) == jm.per_category_mmd_cov(m_gr, labels)


@pytest.mark.parametrize("metric,precision", [("cd", "exact"), ("cd", "fast"), ("emd", "exact"),
                                              ("emd", "fast")])
def test_pairwise_matrix(metric, precision):
    gen, ref = sets(2, s=3, n=40)
    got = tm.pairwise_matrix(gen, ref, metric, precision=precision)
    want = jm.pairwise_matrix(jnp.asarray(gen), jnp.asarray(ref), metric, "pallas",
                              precision=precision)
    tol = {"cd": CD_TOL, "emd": EMD_TOL if precision == "exact" else FAST_EMD_TOL}[metric]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    sym = tm.pairwise_matrix(gen, gen, metric, precision=precision, symmetric=True)
    full = tm.pairwise_matrix(torch.from_numpy(gen), torch.from_numpy(gen), metric,
                              precision=precision, row_chunk=2)
    torch.testing.assert_close(sym, full, rtol=0, atol=0)
    torch.testing.assert_close(tm.pairwise_matrix(gen, ref, metric, "plain", precision=precision),
                               got, rtol=0, atol=0)


@pytest.mark.parametrize("frame", ["fit", "raw"])
def test_jsd_between_sets(frame):
    rng = np.random.default_rng(3)
    a = np.tanh(rng.normal(size=(6, 64, 3))).astype(np.float32)          # reaches past 0.5
    b = (np.tanh(rng.normal(size=(6, 64, 3)) + 0.3) * 0.45).astype(np.float32)
    for gen, ref in ((a, b), (b, a), (b * 0.8, b)):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")        # both packages warn alike on spill
            got = tm.jsd_between_sets(gen, ref, frame=frame)
            want = jm.jsd_between_sets(gen, ref, frame=frame)
        assert abs(got - want) <= 1e-6, (got, want)
    with pytest.warns(UserWarning, match="radius" if frame == "raw" else "outside"):
        tm.jsd_between_sets(a, b, frame=frame)
    assert tm.jsd_between_sets(b, b, frame=frame) < 1e-12
    with pytest.raises(ValueError, match="frame"):
        tm.jsd_between_sets(a, b, frame="box")


def test_compute_all_metrics_exact():
    gen, ref = sets(4)
    labels = np.array([0, 1, 0, 1, 2])
    names = {0: "a", 1: "b", 2: "c"}
    got = tm.compute_all_metrics(gen, ref, ("cd", "emd"), ref_labels=labels, label_names=names,
                                 precision="exact")
    want = jm.compute_all_metrics(jnp.asarray(gen), jnp.asarray(ref), ("cd", "emd"), impl="jnp",
                                  ref_labels=labels, label_names=names)
    assert set(got) == set(want)
    for k in ("cov-cd", "1-nna-cd", "cov-emd", "1-nna-emd", "jsd_frame",
              "per_category_convention"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["mmd-cd"], want["mmd-cd"], **CD_TOL)
    np.testing.assert_allclose(got["mmd-emd"], want["mmd-emd"], **EMD_TOL)
    for k in ("jsd", "jsd_fit", "jsd_raw"):
        assert abs(got[k] - want[k]) <= 1e-6, k
    assert got["per_category"].keys() == want["per_category"].keys()
    for name, vals in want["per_category"].items():
        assert got["per_category"][name]["cov-cd"] == vals["cov-cd"]
        assert got["per_category"][name]["cov-emd"] == vals["cov-emd"]
        np.testing.assert_allclose(got["per_category"][name]["mmd-cd"], vals["mmd-cd"], **CD_TOL)
        np.testing.assert_allclose(got["per_category"][name]["mmd-emd"], vals["mmd-emd"], **EMD_TOL)


def test_compute_all_metrics_default_modes():
    """Each package's defaults (CD exact, EMD fast) on the same sets, dpfx
    through its Pallas kernels; timings name every matrix."""
    gen, ref = sets(5, s=4, n=40)
    timings = {}
    got = tm.compute_all_metrics(gen, ref, ("cd", "emd"), timings=timings)
    want = jm.compute_all_metrics(jnp.asarray(gen), jnp.asarray(ref), ("cd", "emd"))
    assert set(got) == set(want) == {"mmd-cd", "cov-cd", "1-nna-cd", "mmd-emd", "cov-emd",
                                     "1-nna-emd", "jsd", "jsd_fit", "jsd_raw", "jsd_frame"}
    for k in ("cov-cd", "1-nna-cd", "cov-emd", "1-nna-emd"):
        assert got[k] == want[k], k
    np.testing.assert_allclose(got["mmd-cd"], want["mmd-cd"], **CD_TOL)
    np.testing.assert_allclose(got["mmd-emd"], want["mmd-emd"], **FAST_EMD_TOL)
    assert set(timings) == {f"{m}_{p}" for m in ("cd", "emd") for p in ("gr", "gg", "rr")} | {"jsd"}
