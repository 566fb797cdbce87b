"""PointFlow-protocol generation metrics (counterpart of
``dpfx/metrics/generation.py``).

Set-level metrics from pairwise CD/EMD matrices between a generated set and
a reference set:

  * MMD  (gen -> ref): mean over ref clouds of the min distance to any gen
    cloud;
  * COV  (gen -> ref): fraction of ref clouds that are the nearest neighbour
    of at least one gen cloud;
  * 1-NNA: leave-one-out 1-NN two-sample accuracy on the union (0.5 =
    indistinguishable);
  * JSD: Jensen-Shannon divergence between the two sets' point marginals on
    a sphere-clipped 28^3 grid.

The matrices come from the CUDA kernels (``dpfx_torch.ops.chamfer_pairwise``
/ ``emd_pairwise``) for tensors on the card, from their plain versions on
the CPU or with ``impl="plain"``; MMD/COV/1-NNA and the JSD entropies run
on the host in numpy, the JSD grid search on the clouds' device. The
multi-device (row-sharded) matrix is not ported (ROADMAP Queue 1 #10).
"""

from __future__ import annotations

import contextlib
import warnings
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from dpfx_torch.ops import chamfer as cd_ops
from dpfx_torch.ops import emd as emd_ops

Tensor = torch.Tensor


def _as_tensor(x) -> Tensor:
    return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x, np.float32))


# ---------------------------------------------------------------- pairwise matrices

def pairwise_matrix(xs, ys, metric: str = "cd", impl: str = "auto", row_chunk: int = 64,
                    precision: Optional[str] = None, symmetric: bool = False) -> Tensor:
    """[S1,N,3] x [S2,M,3] -> [S1,S2] distance matrix on the clouds' device.

    ``impl``: "auto" (the kernels for CUDA tensors, the plain versions on
    the CPU) or "plain" (the plain versions anywhere). ``precision``: "exact"
    | "fast" | None (each kernel's default: CD exact, EMD fast). Rows go in
    chunks of ``row_chunk``. ``symmetric=True`` (a self-comparison) lets CD
    compute only the upper triangle, in one call; approxmatch EMD is not
    argument-symmetric, so EMD ignores it and computes the full matrix."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"impl must be 'auto' or 'plain', got {impl!r}")
    xs, ys = _as_tensor(xs), _as_tensor(ys)
    plain = impl == "plain"
    if metric == "cd":
        prec = precision or "exact"
        if plain:
            fn = lambda a, b: cd_ops.chamfer_pairwise_plain(a, b, prec)
        else:
            if symmetric:
                return cd_ops.chamfer_pairwise(xs, ys, prec, symmetric=True)
            fn = lambda a, b: cd_ops.chamfer_pairwise(a, b, prec)
    elif metric == "emd":
        prec = precision or "fast"
        fn = ((lambda a, b: emd_ops.emd_pairwise_plain(a, b, precision=prec)) if plain
              else (lambda a, b: emd_ops.emd_pairwise(a, b, precision=prec)))
    else:
        raise ValueError(f"unknown metric {metric!r} (cd | emd)")
    with torch.no_grad():
        return torch.cat([fn(xs[s:s + row_chunk], ys) for s in range(0, xs.shape[0], row_chunk)])


# ---------------------------------------------------------------- set-level metrics

def _np(m) -> np.ndarray:
    return m.detach().cpu().numpy() if isinstance(m, torch.Tensor) else np.asarray(m)


def mmd_cov(m_gr) -> Dict[str, float]:
    """m_gr: [S_gen, S_ref] distances gen x ref. MMD = mean_r min_g;
    COV = |{argmin_r of each gen}| / S_ref."""
    m = _np(m_gr)
    mmd = float(m.min(axis=0).mean())
    cov = float(len(np.unique(m.argmin(axis=1))) / m.shape[1])
    return {"mmd": mmd, "cov": cov}


def per_category_mmd_cov(m_gr, ref_labels: np.ndarray) -> Dict[int, Dict[str, float]]:
    """Per-class MMD/COV for unconditional all-category generation: MMD_c =
    mean over class-c refs of the min distance to any gen cloud; COV_c =
    fraction of class-c refs that are the nearest ref (over all refs) of at
    least one gen cloud (gen clouds carry no labels)."""
    m = _np(m_gr)
    labels = np.asarray(ref_labels)
    covered = set(np.unique(m.argmin(axis=1)).tolist())
    out: Dict[int, Dict[str, float]] = {}
    for c in np.unique(labels):
        cols = np.nonzero(labels == c)[0]
        mmd_c = float(m[:, cols].min(axis=0).mean())
        cov_c = float(sum(1 for r in cols if int(r) in covered) / len(cols))
        out[int(c)] = {"mmd": mmd_c, "cov": cov_c}
    return out


def one_nna(m_gg, m_gr, m_rr) -> float:
    """Leave-one-out 1-NN accuracy on gen U ref (0.5 = perfect generator);
    m_gg and m_rr get +inf diagonals (a sample is not its own neighbour)."""
    m_gg = _np(m_gg).copy()
    m_rr = _np(m_rr).copy()
    m_gr = _np(m_gr)
    np.fill_diagonal(m_gg, np.inf)
    np.fill_diagonal(m_rr, np.inf)
    gen_correct = (m_gg.min(axis=1) < m_gr.min(axis=1)).sum()
    ref_correct = (m_rr.min(axis=1) < m_gr.min(axis=0)).sum()
    return float((gen_correct + ref_correct) / (m_gg.shape[0] + m_rr.shape[0]))


# ---------------------------------------------------------------- JSD

def _sphere_grid(resolution: int) -> np.ndarray:
    """resolution^3 nodes spanning [-0.5, 0.5] per axis, keeping the nodes
    inside the radius-0.5 sphere (the lineage's clipped unit-cube grid)."""
    lin = np.linspace(-0.5, 0.5, resolution)
    g = np.stack(np.meshgrid(lin, lin, lin, indexing="ij"), axis=-1).reshape(-1, 3)
    return g[np.linalg.norm(g, axis=1) <= 0.5].astype(np.float32)


@contextlib.contextmanager
def _ieee_matmul():
    """Full f32 products for torch.matmul on the card, whatever the
    process-wide TF32 flag says."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _grid_counters(clouds: np.ndarray, grid: np.ndarray, device=None,
                   chunk: int = 4096) -> np.ndarray:
    """Per-point nearest-grid-node counts over all clouds: each point
    increments its nearest node (points outside the sphere fall to the
    nearest in-sphere node). One matmul + argmin per chunk on ``device``:
    argmin_g |g|^2 - 2 p.g (|p|^2 is constant per row)."""
    pts = torch.from_numpy(np.asarray(clouds, np.float32).reshape(-1, 3)).to(device)
    gj = torch.from_numpy(grid).to(device)
    g2 = (gj * gj).sum(1)
    counters = torch.zeros(grid.shape[0], dtype=torch.int64, device=device)
    with torch.no_grad(), _ieee_matmul():
        for s in range(0, pts.shape[0], chunk):
            idx = torch.argmin(g2[None, :] - 2.0 * (pts[s:s + chunk] @ gj.T), dim=1)
            counters += torch.bincount(idx, minlength=grid.shape[0])
    return counters.cpu().numpy()


def _jensen_shannon_base2(p_counts: np.ndarray, q_counts: np.ndarray) -> float:
    """JSD in bits via H(M) - (H(P) + H(Q)) / 2."""
    p = p_counts / max(p_counts.sum(), 1)
    q = q_counts / max(q_counts.sum(), 1)
    m = 0.5 * (p + q)

    def ent(a):
        nz = a > 0
        return -float(np.sum(a[nz] * np.log2(a[nz])))

    return ent(m) - 0.5 * (ent(p) + ent(q))


def jsd_between_sets(gen, ref, resolution: int = 28, frame: str = "fit") -> float:
    """JSD between the two sets' point marginals on the sphere-clipped grid.

    ``frame`` handles clouds past the grid's radius 0.5: "fit" shrinks both
    sets by 0.5 / (the reference's max radius), when that exceeds 0.5, and
    warns when more than 0.1% of generated points still fall outside; "raw"
    snaps out-of-sphere points to their nearest in-sphere node, with a
    warning. The grid search runs on ``gen``'s device (the CPU for numpy
    input)."""
    device = gen.device if isinstance(gen, torch.Tensor) else None
    gen, ref = _np(gen), _np(ref)
    bound = 0.5 + 1e-4
    if frame == "fit":
        ref_r = float(np.linalg.norm(ref.reshape(-1, 3), axis=1).max())
        if ref_r > bound:
            scale = 0.5 / ref_r
            gen = gen * scale
            ref = ref * scale
        gen_r = np.linalg.norm(gen.reshape(-1, 3), axis=1)
        spill = float(np.mean(gen_r > bound))
        if spill > 1e-3:
            warnings.warn(
                f"dpfx_torch.metrics: {spill:.1%} of generated points fall outside the "
                f"reference-anchored JSD grid sphere and snap to edge nodes (gen max radius "
                f"{gen_r.max():.3f} vs grid 0.5)", stacklevel=2)
    elif frame == "raw":
        max_r = max(float(np.linalg.norm(gen.reshape(-1, 3), axis=1).max()),
                    float(np.linalg.norm(ref.reshape(-1, 3), axis=1).max()))
        if max_r > bound:
            warnings.warn(
                f"dpfx_torch.metrics: clouds extend to radius {max_r:.3f} > 0.5; the JSD grid "
                f"covers the unit sphere (diameter 1) and points outside snap to edge nodes",
                stacklevel=2)
    else:
        raise ValueError(f"unknown jsd frame {frame!r} (fit | raw)")
    grid = _sphere_grid(resolution)
    return _jensen_shannon_base2(_grid_counters(gen, grid, device),
                                 _grid_counters(ref, grid, device))


# ---------------------------------------------------------------- the suite

PER_CATEGORY_CONVENTION = (
    "mmd_c: mean over class-c refs of min distance to ANY gen; "
    "cov_c: fraction of class-c refs that are the global argmin ref "
    "of >=1 gen cloud (gen clouds are unlabeled)"
)


def compute_all_metrics(gen, ref, metrics: Sequence[str] = ("cd",), impl: str = "auto",
                        jsd_resolution: int = 28, ref_labels: Optional[np.ndarray] = None,
                        label_names: Optional[Dict[int, str]] = None,
                        precision: Optional[str] = None, jsd_frame: str = "fit",
                        timings: Optional[Dict[str, float]] = None) -> Dict[str, float]:
    """The full generation suite: for each base metric, MMD / COV / 1-NNA
    from the three pairwise matrices, plus JSD in both frames.

    gen: [S_g, N, 3]; ref: [S_r, M, 3] (tensors on one device, or numpy on
    the CPU). With ``ref_labels``, a ``per_category`` table of per-class
    MMD/COV. ``timings``, when given, receives the wall seconds of each
    pairwise matrix (``"<metric>_<gr|gg|rr>"``, synchronised on the card)
    and of the two JSDs (``"jsd"``)."""
    import time

    gen, ref = _as_tensor(gen), _as_tensor(ref)
    sync = torch.cuda.synchronize if gen.is_cuda else (lambda: None)

    def matrix(name, a, b, symmetric=False):
        t0 = time.perf_counter()
        m = pairwise_matrix(a, b, metric, impl, precision=precision, symmetric=symmetric)
        sync()
        if timings is not None:
            timings[f"{metric}_{name}"] = time.perf_counter() - t0
        return m

    out: Dict[str, object] = {}
    per_cat: Dict[str, Dict[str, float]] = {}
    for metric in metrics:
        m_gr = matrix("gr", gen, ref)
        m_gg = matrix("gg", gen, gen, symmetric=True)
        m_rr = matrix("rr", ref, ref, symmetric=True)
        mc = mmd_cov(m_gr)
        out[f"mmd-{metric}"] = mc["mmd"]
        out[f"cov-{metric}"] = mc["cov"]
        out[f"1-nna-{metric}"] = one_nna(m_gg, m_gr, m_rr)
        if ref_labels is not None and len(np.unique(ref_labels)) > 1:
            for c, vals in per_category_mmd_cov(m_gr, ref_labels).items():
                name = (label_names or {}).get(c, f"cat{c}")
                per_cat.setdefault(name, {})[f"mmd-{metric}"] = vals["mmd"]
                per_cat[name][f"cov-{metric}"] = vals["cov"]
    # both frames every time, and which one "jsd" is
    t0 = time.perf_counter()
    out["jsd"] = jsd_between_sets(gen, ref, jsd_resolution, frame=jsd_frame)
    other = "raw" if jsd_frame == "fit" else "fit"
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        out[f"jsd_{other}"] = jsd_between_sets(gen, ref, jsd_resolution, frame=other)
    out[f"jsd_{jsd_frame}"] = out["jsd"]
    if timings is not None:
        timings["jsd"] = time.perf_counter() - t0
    out["jsd_frame"] = jsd_frame
    if per_cat:
        out["per_category"] = per_cat
        out["per_category_convention"] = PER_CATEGORY_CONVENTION
    return out
