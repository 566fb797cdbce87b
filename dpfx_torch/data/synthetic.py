"""Synthetic point-cloud dataset, a copy of ``dpfx/data/synthetic.py``
(numpy only; the port imports nothing of the JAX package). Deterministic
parametric shapes: the v1 (sphere/box/blobs), v2 (rotated surfaces) and v3
(compositional multi-part) families, item i reproducible from (seed, i).
"""

from __future__ import annotations

import numpy as np


def _sphere(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    r = 1.0 + 0.05 * rng.normal(size=(n, 1))
    return scale * v * r


def _box(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    face = rng.integers(0, 6, size=n)
    uv = rng.uniform(-1, 1, size=(n, 2))
    pts = np.empty((n, 3))
    axis = face % 3
    sign = np.where(face < 3, 1.0, -1.0)
    for i in range(3):
        m = axis == i
        pts[m, i] = sign[m]
        others = [j for j in range(3) if j != i]
        pts[np.ix_(m, others)] = uv[m]
    return scale * pts + 0.02 * rng.normal(size=(n, 3))


def _blobs(rng: np.random.Generator, n: int, scale: float, k: int) -> np.ndarray:
    centers = rng.normal(size=(k, 3)) * scale
    assign = rng.integers(0, k, size=n)
    return centers[assign] + 0.15 * scale * rng.normal(size=(n, 3))


# ---------------------------------------------------------------------------
# "v2" family: continuously-parameterized, randomly-oriented surfaces. The
# v1 family (sphere/box/blobs) has almost no intra-class variation beyond
# a global scale, so a generative model can win by memorizing three shapes;
# v2 items carry per-item continuous shape parameters + a random rotation,
# making MMD/COV/1-NNA against a held-out split a real generalization
# measurement (round-3 quality run). v1 streams are untouched: golden
# fixtures keep their hashes.
# ---------------------------------------------------------------------------


def _rotation(rng: np.random.Generator) -> np.ndarray:
    q, r = np.linalg.qr(rng.normal(size=(3, 3)))
    q = q * np.sign(np.diag(r))
    if np.linalg.det(q) < 0:
        q[:, 0] = -q[:, 0]
    return q


def _ellipsoid(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    axes = rng.uniform(0.3, 1.0, size=3)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    pts = (v * axes) @ _rotation(rng).T
    return scale * pts + 0.02 * scale * rng.normal(size=(n, 3))


def _torus(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    big_r = rng.uniform(0.6, 1.0)
    small_r = rng.uniform(0.15, 0.35) * big_r
    u = rng.uniform(0, 2 * np.pi, size=n)
    # area-correct minor angle via iterated rejection: accept v with prob
    # ∝ (R + r cos v)/(R + r). 8 rounds leave <= 0.26^8 ≈ 1e-5 of points
    # with a plain-uniform v — negligible (a single-round resample kept a
    # measurable inner-ring bias; review finding)
    v = rng.uniform(0, 2 * np.pi, size=n)
    pending = rng.uniform(size=n) >= (big_r + small_r * np.cos(v)) / (big_r + small_r)
    for _ in range(8):
        if not pending.any():
            break
        k = int(pending.sum())
        v[pending] = rng.uniform(0, 2 * np.pi, size=k)
        accept = rng.uniform(size=k) < (
            (big_r + small_r * np.cos(v[pending])) / (big_r + small_r))
        idx = np.flatnonzero(pending)
        pending[idx[accept]] = False
    x = (big_r + small_r * np.cos(v)) * np.cos(u)
    y = (big_r + small_r * np.cos(v)) * np.sin(u)
    z = small_r * np.sin(v)
    pts = np.stack([x, y, z], axis=1) @ _rotation(rng).T
    return scale * pts + 0.02 * scale * rng.normal(size=(n, 3))


def _cylinder(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    radius = rng.uniform(0.3, 0.8)
    half_h = rng.uniform(0.4, 1.0)
    lateral_area = 2 * np.pi * radius * 2 * half_h
    cap_area = 2 * np.pi * radius**2
    on_side = rng.uniform(size=n) < lateral_area / (lateral_area + cap_area)
    theta = rng.uniform(0, 2 * np.pi, size=n)
    # side points at radius; cap points at sqrt-uniform radius, z = ±h
    r_cap = radius * np.sqrt(rng.uniform(size=n))
    r = np.where(on_side, radius, r_cap)
    z = np.where(on_side, rng.uniform(-half_h, half_h, size=n),
                 np.where(rng.uniform(size=n) < 0.5, half_h, -half_h))
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)
    pts = pts @ _rotation(rng).T
    return scale * pts + 0.02 * scale * rng.normal(size=(n, 3))


def _pball(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    # surface of a unit p-norm ball, p ∈ [1.2, 8]: continuously interpolates
    # octahedron → sphere → box; anisotropic semi-axes + rotation
    p = rng.uniform(1.2, 8.0)
    axes = rng.uniform(0.5, 1.0, size=3)
    v = rng.normal(size=(n, 3))
    norm_p = np.sum(np.abs(v) ** p, axis=1, keepdims=True) ** (1.0 / p)
    pts = (v / (norm_p + 1e-9) * axes) @ _rotation(rng).T
    return scale * pts + 0.02 * scale * rng.normal(size=(n, 3))


# ---------------------------------------------------------------------------
# "v3" family: COMPOSITIONAL shapes — multiple thin parts with variable part
# count and pose. The v2 family is saturated (round-3: DPF sits at the
# perfect-generator oracle bracket on all three tasks), so quality progress
# needs a family where the ideal-vs-broken bracket is wide and the model
# lands measurably below ideal: part-count variation breaks pure surface
# memorization, and thin structures (rods of radius ~0.03) punish blurry
# decoders in CD/EMD much harder than fat surfaces do.
# ---------------------------------------------------------------------------


def _rod(rng: np.random.Generator, n: int, radius: float, half_len: float,
         rot: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Thin capped cylinder along local z, posed by (rot, center)."""
    lateral = 2 * np.pi * radius * 2 * half_len
    caps = 2 * np.pi * radius**2
    on_side = rng.uniform(size=n) < lateral / (lateral + caps)
    theta = rng.uniform(0, 2 * np.pi, size=n)
    r_cap = radius * np.sqrt(rng.uniform(size=n))
    r = np.where(on_side, radius, r_cap)
    z = np.where(on_side, rng.uniform(-half_len, half_len, size=n),
                 np.where(rng.uniform(size=n) < 0.5, half_len, -half_len))
    pts = np.stack([r * np.cos(theta), r * np.sin(theta), z], axis=1)
    return pts @ rot.T + center


def _slab(rng: np.random.Generator, n: int, half_dims: np.ndarray,
          rot: np.ndarray, center: np.ndarray) -> np.ndarray:
    """Thin box (surface-area-weighted faces), posed by (rot, center)."""
    a, b, c = half_dims
    face_areas = np.array([b * c, a * c, a * b]) * 4  # per axis-pair, x2 faces
    probs = np.repeat(face_areas, 2)
    probs = probs / probs.sum()
    face = rng.choice(6, size=n, p=probs)
    uv = rng.uniform(-1, 1, size=(n, 2))
    pts = np.empty((n, 3))
    axis = face // 2
    sign = np.where(face % 2 == 0, 1.0, -1.0)
    for i in range(3):
        m = axis == i
        pts[m, i] = sign[m] * half_dims[i]
        others = [j for j in range(3) if j != i]
        pts[np.ix_(m, others)] = uv[m] * half_dims[others]
    return pts @ rot.T + center


def _split_counts(rng: np.random.Generator, n: int, weights) -> np.ndarray:
    w = np.asarray(weights, np.float64)
    return rng.multinomial(n, w / w.sum())


def _v3_scaffold(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    """2-6 thin rods with random poses passing near the origin."""
    k = int(rng.integers(2, 7))
    counts = _split_counts(rng, n, np.ones(k))
    parts = []
    for c in counts:
        rot = _rotation(rng)
        center = rng.uniform(-0.25, 0.25, size=3)
        parts.append(_rod(rng, int(c), rng.uniform(0.02, 0.05),
                          rng.uniform(0.5, 1.0), rot, center))
    return scale * np.concatenate(parts)


def _v3_table(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    """Thin slab top + 3-6 thin legs; leg height/placement varies."""
    n_legs = int(rng.integers(3, 7))
    top_half = np.array([rng.uniform(0.6, 1.0), rng.uniform(0.4, 1.0),
                         rng.uniform(0.02, 0.05)])
    leg_h = rng.uniform(0.35, 0.8)
    leg_r = rng.uniform(0.02, 0.06)
    top_area = top_half[0] * top_half[1]
    leg_area = leg_r * leg_h * n_legs * 2
    counts = _split_counts(
        rng, n, [top_area] + [leg_area / n_legs] * n_legs)
    eye = np.eye(3)
    parts = [_slab(rng, int(counts[0]), top_half, eye,
                   np.array([0.0, 0.0, leg_h]))]
    for c in counts[1:]:
        pos = np.array([
            rng.uniform(-0.9, 0.9) * top_half[0],
            rng.uniform(-0.9, 0.9) * top_half[1],
            leg_h / 2,
        ])
        parts.append(_rod(rng, int(c), leg_r, leg_h / 2, eye, pos))
    return scale * (np.concatenate(parts) @ _rotation(rng).T)


def _v3_chain(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    """3-7 small ellipsoids strung along a random smooth 3-D curve."""
    k = int(rng.integers(3, 8))
    # quadratic Bezier through 3 random control points
    p0, p1, p2 = rng.uniform(-1, 1, size=(3, 3))
    t = np.linspace(0, 1, k)
    centers = ((1 - t)[:, None] ** 2 * p0 + 2 * ((1 - t) * t)[:, None] * p1
               + (t**2)[:, None] * p2)
    counts = _split_counts(rng, n, np.ones(k))
    axes_base = rng.uniform(0.08, 0.2, size=3)
    parts = []
    for c, ctr in zip(counts, centers):
        v = rng.normal(size=(int(c), 3))
        v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
        axes = axes_base * rng.uniform(0.8, 1.25, size=3)
        parts.append((v * axes) @ _rotation(rng).T + ctr)
    return scale * np.concatenate(parts)


def _v3_winged(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    """Fuselage (elongated ellipsoid) + two thin wings + tail fin —
    airplane-like compositionality with continuous geometry variation."""
    body_len = rng.uniform(0.8, 1.2)
    body_r = rng.uniform(0.08, 0.16)
    span = rng.uniform(0.6, 1.1)
    chord = rng.uniform(0.15, 0.3)
    sweep = rng.uniform(-0.3, 0.3)
    fin_h = rng.uniform(0.15, 0.35)
    body_area = body_len * body_r * 4
    wing_area = span * chord * 2
    fin_area = fin_h * chord
    counts = _split_counts(rng, n, [body_area, wing_area, wing_area, fin_area])
    v = rng.normal(size=(int(counts[0]), 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True) + 1e-9
    body = v * np.array([body_len, body_r, body_r])
    eye = np.eye(3)
    wing_dims = np.array([chord, span / 2, 0.015])
    left = _slab(rng, int(counts[1]), wing_dims, eye,
                 np.array([sweep, span / 2, 0.0]))
    right = _slab(rng, int(counts[2]), wing_dims, eye,
                  np.array([sweep, -span / 2, 0.0]))
    fin = _slab(rng, int(counts[3]), np.array([chord * 0.6, 0.012, fin_h]),
                eye, np.array([-body_len * 0.85, 0.0, fin_h]))
    pts = np.concatenate([body, left, right, fin])
    return scale * (pts @ _rotation(rng).T)


def _v3_frame(rng: np.random.Generator, n: int, scale: float) -> np.ndarray:
    """Wireframe box: 12 thin rods along the edges of an anisotropic box —
    nothing but thin structure."""
    half = rng.uniform(0.4, 1.0, size=3)
    r = rng.uniform(0.015, 0.04)
    edges = []
    lens = []
    for axis in range(3):
        o1, o2 = [j for j in range(3) if j != axis]
        for s1 in (-1, 1):
            for s2 in (-1, 1):
                center = np.zeros(3)
                center[o1] = s1 * half[o1]
                center[o2] = s2 * half[o2]
                edges.append((axis, center))
                lens.append(half[axis])
    counts = _split_counts(rng, n, lens)
    parts = []
    for (axis, center), c, hl in zip(edges, counts, lens):
        rot = np.eye(3)[:, [(axis + 1) % 3, (axis + 2) % 3, axis]]
        parts.append(_rod(rng, int(c), r, hl, rot, center))
    return scale * (np.concatenate(parts) @ _rotation(rng).T)


_V1_KINDS = ("sphere", "box", "blobs")
_V2_KINDS = ("ellipsoid", "torus", "cylinder", "pball", "blobs")
_V3_KINDS = ("scaffold", "table", "chain", "winged", "frame")
_V3_FNS = (_v3_scaffold, _v3_table, _v3_chain, _v3_winged, _v3_frame)


class SyntheticDataset:
    """Deterministic synthetic clouds: item i is reproducible from (seed, i).

    Stored cloud size ``n_stored`` is larger than the training cloud so the
    loader exercises the same random-subsample path as ShapeNet
    (SURVEY.md §2 C2: reference stores more points than the N=2048 sampled
    per item).
    """

    def __init__(
        self,
        size: int = 256,
        n_stored: int = 4096,
        modes: int = 4,
        seed: int = 0,
        split: str = "train",
        cache: bool = True,
        family: str = "v1",
    ):
        if family not in ("v1", "v2", "v3"):
            raise ValueError(f"unknown synthetic family {family!r}")
        self.size = size
        self.n_stored = n_stored
        self.modes = modes
        self.family = family
        # dict(id -> name): the per-category eval-table convention
        # (dpfx/data/shapenet.py label_names)
        self.label_names = dict(enumerate(
            {"v1": _V1_KINDS, "v2": _V2_KINDS, "v3": _V3_KINDS}[family]))
        # distinct item streams per split
        self.base = {"train": 0, "val": 1_000_000, "test": 2_000_000}[split] + seed * 10_000_000
        # items are deterministic in (seed, idx), so memoize: regenerating a
        # 4096-point cloud per fetch made long synthetic runs host-bound
        # (~1.5M pts/s wall vs 10.8M device in the round-3 endurance run);
        # a full 512-cloud set is only ~25 MB
        self._cache: dict | None = {} if cache else None

    def __len__(self) -> int:
        return self.size

    def label(self, idx: int) -> int:
        """Shape-kind id (aligned with ``label_names``) for per-category
        eval tables (SURVEY.md §6)."""
        return idx % len(self.label_names)

    def __getitem__(self, idx: int) -> np.ndarray:
        if self._cache is not None and idx in self._cache:
            return self._cache[idx]
        rng = np.random.default_rng(self.base + idx)
        if self.family == "v3":
            kind = idx % 5
            scale = 0.6 + 0.4 * rng.uniform()
            # global 0.01-sigma sensor noise AFTER composition: thin parts
            # must stay thin (each part already carries its surface noise)
            pts = _V3_FNS[kind](rng, self.n_stored, scale)
            pts = pts + 0.01 * scale * rng.normal(size=pts.shape)
            out = pts.astype(np.float32)
            if self._cache is not None:
                self._cache[idx] = out
            return out
        if self.family == "v2":
            kind = idx % 5
            scale = 0.5 + 0.5 * rng.uniform()
            fn = (_ellipsoid, _torus, _cylinder, _pball)
            if kind < 4:
                pts = fn[kind](rng, self.n_stored, scale)
            else:
                pts = _blobs(rng, self.n_stored, scale, self.modes)
            out = pts.astype(np.float32)
            if self._cache is not None:
                self._cache[idx] = out
            return out
        kind = idx % 3
        scale = 0.5 + 0.5 * rng.uniform()
        if kind == 0:
            pts = _sphere(rng, self.n_stored, scale)
        elif kind == 1:
            pts = _box(rng, self.n_stored, scale)
        else:
            pts = _blobs(rng, self.n_stored, scale, self.modes)
        out = pts.astype(np.float32)
        if self._cache is not None:
            self._cache[idx] = out
        return out
