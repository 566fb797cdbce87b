"""Is the generator's deficit on the v3 ``chain`` kind a part-count
coverage mismatch? (The counterpart of the JAX package's
``tools/part_count_pin.py``; the same arguments, replay and report.)

The v3 ``chain`` kind (``dpfx_torch/data/synthetic.py``: ``_v3_chain``)
strings k ~ Uniform{3..7} ellipsoid shells along a random Bezier curve.
Estimating k from a cloud is ill-posed (the shells overlap), but every test
item is deterministic in (split seed, index), so the true k, scale and
curve length of each reference chain are recovered exactly by replaying
the generator's draws.

1. Load the test clouds (the evaluation CLI's frame and subset,
   ``eval_subset``) and a generated dump (``python -m dpfx_torch.generate
   ... --out gen.npy``).
2. The CD matrix of generated against test clouds (``pairwise_matrix``, the
   suite's kernel); each generated cloud's nearest reference is the COV
   assignment.
3. For the chain references: the true k, scale and curve length of covered
   against uncovered ones, and the histogram of the true k of the
   references the generated clouds pick.
4. Per k: the mean minimum distance (each reference's MMD term).

Two repairs against the JAX tool: where ``eval_subset`` returns no indices
(the prefix subset: ``--limit`` at or past the split's size, or a
single-class split) the replay takes the prefix rows, where the JAX tool
raises; and a mean over an empty slice (no covered or no uncovered chain,
a k the subset does not hold) is ``null``, where the JAX tool writes NaN.

    python -m dpfx_torch.generate CONFIG --n-clouds 400 --out gen.npy [--step N]
    python -m dpfx_torch.tools.part_count_pin CONFIG gen.npy [--limit 400]
        [--impl auto|plain] [--out report.jsonl] [--device cuda|cpu]

The report is printed as indented JSON (and appended to ``--out`` as one
line), then the kernel launches.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

import numpy as np

CHAIN_KIND = 2  # v3 kind order: scaffold, table, chain, winged, frame


def chain_covariates(ds, idx: int) -> dict:
    """Replay the dataset's per-item draws (``SyntheticDataset.__getitem__``
    for v3, then ``_v3_chain``'s order) to recover the true parameters."""
    rng = np.random.default_rng(ds.base + idx)
    scale = 0.6 + 0.4 * rng.uniform()
    k = int(rng.integers(3, 8))
    p0, p1, p2 = rng.uniform(-1, 1, size=(3, 3))
    t = np.linspace(0, 1, 64)[:, None]
    curve = (1 - t) ** 2 * p0 + 2 * (1 - t) * t * p1 + t**2 * p2
    length = float(np.linalg.norm(np.diff(curve, axis=0), axis=1).sum())
    return {"k": k, "scale": float(scale), "curve_len": length}


def _mean(a: np.ndarray) -> Optional[float]:
    return float(a.mean()) if a.size else None


def report(m_gr: np.ndarray, labels: np.ndarray, rows: np.ndarray, test_ds) -> dict:
    """The pin's report from the [gen, ref] CD matrix, the references'
    labels and their rows in ``test_ds``."""
    nearest = m_gr.argmin(axis=1)              # each generated cloud's reference (COV rule)
    min_dist = m_gr.min(axis=0)                # each reference's MMD term
    chain_rows = np.where(labels == CHAIN_KIND)[0]
    cov = {int(r): int((nearest == r).sum()) for r in chain_rows}
    covar = {int(r): chain_covariates(test_ds, int(rows[r])) for r in chain_rows}
    ks = np.array([covar[int(r)]["k"] for r in chain_rows], np.int64)
    hits = np.array([cov[int(r)] for r in chain_rows], np.int64)
    covered = hits > 0
    # over generated clouds whose nearest reference is a chain: that
    # reference's true k, once per such cloud
    gen_k = (np.concatenate([np.full(cov[int(r)], covar[int(r)]["k"]) for r in chain_rows])
             if hits.sum() else np.array([], np.int64))

    def khist(a):
        return {int(k): int((a == k).sum()) for k in range(3, 8)}

    per_k = {}
    for k in range(3, 8):
        sel = ks == k
        per_k[k] = {
            "n_refs": int(sel.sum()),
            "covered_frac": _mean(covered[sel]),
            "mean_min_cd": _mean(min_dist[chain_rows][sel]),
            "gen_hits": int(hits[sel].sum()),
        }

    def stats(key):
        vals = np.array([covar[int(r)][key] for r in chain_rows])
        return {"covered_mean": _mean(vals[covered]), "uncovered_mean": _mean(vals[~covered])}

    return {
        "n_chain_refs": int(chain_rows.size),
        "chain_cov": _mean(covered),
        "gen_clouds_attributed_to_chain": int(hits.sum()),
        "ref_true_k_hist": khist(ks),
        "covered_ref_k_hist": khist(ks[covered]),
        "uncovered_ref_k_hist": khist(ks[~covered]),
        "gen_nearest_ref_k_hist": khist(gen_k),
        "per_k": per_k,
        "scale": stats("scale"),
        "curve_len": stats("curve_len"),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("config")
    ap.add_argument("gen_npy")
    ap.add_argument("--limit", type=int, default=400)
    ap.add_argument("--impl", default="auto", choices=["auto", "plain"])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    import torch

    from dpfx_torch.config import load_config
    from dpfx_torch.data import build_dataset, eval_subset, load_all
    from dpfx_torch.device import resolve_device
    from dpfx_torch.metrics.generation import pairwise_matrix
    from dpfx_torch.tools._common import launches_line, reset_launch_counts

    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    if cfg.data.dataset != "synthetic" or cfg.data.synthetic_family != "v3":
        raise SystemExit("covariate replay only defined for the v3 synthetic family")
    test_ds = build_dataset(cfg.data, "test", cfg.model.image_encoder.image_size)
    indices, labels = eval_subset(test_ds, args.limit)
    labels = np.asarray(labels)
    rows = np.asarray(indices) if indices is not None else np.arange(labels.shape[0])
    refs = load_all(test_ds, cfg.data.n_points_eval, limit=args.limit, indices=indices)
    gen = np.load(args.gen_npy).astype(np.float32)
    print(f"[pin] refs {refs.shape}, gen {gen.shape}")
    reset_launch_counts()
    m_gr = pairwise_matrix(torch.from_numpy(gen).to(dev), torch.from_numpy(refs).to(dev),
                           metric="cd", impl=args.impl).cpu().numpy()
    result = report(m_gr, labels, rows, test_ds)
    print(json.dumps(result, indent=2))
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(result) + "\n")
    print(launches_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
