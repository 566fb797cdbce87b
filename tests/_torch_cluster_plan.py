"""A Python copy of the fused_train cluster layout's shared-memory plan
(``ClusterPlan``, ``cluster_carve`` and ``cluster_plan`` in
``dpfx_torch/ops/csrc/flow_cluster.cuh``), so that the CPU tests can show
the layout fits every bf16 shape it takes; the card tests hold it to the
library's ``dpfx_fused_train_cluster_smem_bytes`` and
``dpfx_fused_train_cluster_tile_points`` (and ``cluster_part_row`` to
``dpfx_fused_train_cluster_part_row``), and ``cluster_domain`` to
``fused_train.uses_cluster``. The sampler's cluster inverse (``inv_cluster``)
runs on the forward's plan; ``inverse_carve`` is the carve it would have on
its own (no log-det row, no per-warp log-det sums), which the tests show
gives no routed shape another tile or stage count. No JAX: the card tests
import it."""

from typing import Tuple

import torch

from dpfx_torch.ops import fused_train as ft
from dpfx_torch.ops._build import SMEM_LIMIT

HC = 64          # hidden columns a rank owns
LDO = HC + 8     # row stride of an own-columns tile
WARPS = 8
G = 4            # forward: tiles between two (s, t) exchanges


def _r(n: int) -> int:
    return (n + 127) // 128 * 128


def cluster_carve(hidden: int, n_hidden_m1: int, backward: bool, t: int, nst: int,
                  ring: bool = False, g: int = G) -> int:
    """Bytes of one CTA at tile t with nst weight stages (the forward: g
    tiles a group); with ``ring`` the stages hold Wx^T and Wout alone and
    the Wh slabs stream through two buffers of the larger slab."""
    h, nh1 = hidden, n_hidden_m1
    ldh, ldt = h + 8, t + 8
    rows, cols = _r(HC * ldh * 2), _r(h * LDO * 2)
    stage = 0 if ring else nh1 * rows + (nh1 * cols if backward else 0)
    stage += _r(8 * ldh * 2) + _r(8 * LDO * 2)
    tx, to, c = _r(t * ldh * 2), _r(t * LDO * 2), h // HC
    o = (min(nh1, 2) if backward else (2 if nh1 > 1 else 0)) * tx
    if backward:
        o += (nh1 + 2) * to + 2 * _r(8 * ldt * 2) + c * _r(t * 6 * 4) + _r(WARPS * HC * 4)
    else:
        o += (to if t < 128 else 0) + 2 * g * c * _r(t * 6 * 4) + 128 + _r(g * 4 * t * 4)
    o += nst * stage
    return o + (2 * max(rows, cols) if ring else 0)


def _plan(hidden: int, n_hidden_m1: int, backward: bool) -> Tuple[int, int, int, bool, int]:
    """(T, G, stages, ring, bytes): the largest T of 128, 64, 32, then
    whole-layer stages (the forward: the most tiles a group, G down to 2;
    two stages before one), then (the backward) the ring (two small stages
    before one), that fits; past that T = 32 with one whole stage, which
    does not fit."""
    for t in (128, 64, 32):
        for g in range(G, 1 if not backward else G - 1, -1):
            for nst in (2, 1):
                need = cluster_carve(hidden, n_hidden_m1, backward, t, nst, False, g)
                if need <= SMEM_LIMIT:
                    return t, g, nst, False, need
        for nst in (2, 1) if backward else ():
            need = cluster_carve(hidden, n_hidden_m1, backward, t, nst, True)
            if need <= SMEM_LIMIT:
                return t, G, nst, True, need
    return 32, G, 1, False, cluster_carve(hidden, n_hidden_m1, backward, 32, 1)


def cluster_plan(hidden: int, n_hidden_m1: int, backward: bool) -> Tuple[int, int, int]:
    """(points per tile T, weight stages, bytes) of one CTA (``_plan``)."""
    t, _, nst, _, need = _plan(hidden, n_hidden_m1, backward)
    return t, nst, need


def cluster_group(hidden: int, n_hidden_m1: int) -> int:
    """Tiles a group of the forward's plan (one (s, t) exchange a group)."""
    return _plan(hidden, n_hidden_m1, False)[1]


def cluster_ring(hidden: int, n_hidden_m1: int, backward: bool) -> bool:
    """Whether the plan streams the Wh slabs through the ring (backward
    only; the matrices past the registers' then add into the slice tile by
    tile, ``Cl::SPILL``)."""
    return _plan(hidden, n_hidden_m1, backward)[3]


def cluster_part_row(hidden: int, n_hidden_m1: int) -> int:
    """Floats of a cluster's partial of one layer in the backward: [dWx |
    dWh | dbh | dWout | dbout], padded to a multiple of 4 on the ring."""
    h, nh1 = hidden, n_hidden_m1
    n = 3 * h + nh1 * h * h + nh1 * h + 6 * h + 6
    return (n + 3) // 4 * 4 if cluster_ring(h, nh1, True) else n


def cluster_domain(hidden: int, n_hidden_m1: int, dtype: torch.dtype) -> bool:
    """``fused_train.uses_cluster`` by this plan: bf16 at H = 128 and 256
    with n_hidden <= MAX_N_HIDDEN, deeper than the mma layout holds
    (``LAYOUT_N_HIDDEN``), whose plan fits forward and backward."""
    return (dtype == torch.bfloat16 and hidden in ft.WIDE_HIDDEN
            and n_hidden_m1 < ft.MAX_N_HIDDEN
            and n_hidden_m1 + 1 > ft.LAYOUT_N_HIDDEN["bfloat16"][hidden]
            and all(cluster_plan(hidden, n_hidden_m1, bwd)[2] <= SMEM_LIMIT
                    for bwd in (False, True)))


def inverse_carve(hidden: int, n_hidden_m1: int, t: int, nst: int, g: int = G) -> int:
    """Bytes of one CTA of the inverse with a carve of its own (g tiles a
    group): the forward's without the per-warp log-det sums (128 B) and
    with x alone ([g][3][T] floats) where the forward keeps x and the
    log-det ([g][4][T])."""
    return (cluster_carve(hidden, n_hidden_m1, False, t, nst, False, g) - 128
            - _r(g * 4 * t * 4) + _r(g * 3 * t * 4))


def inverse_plan(hidden: int, n_hidden_m1: int) -> Tuple[int, int, int, int]:
    """(T, G, stages, bytes) of the inverse's own carve, chosen as
    ``cluster_plan`` chooses the forward's: the largest T, then the most
    tiles a group (G down to 2), then two stages before one."""
    for t in (128, 64, 32):
        for g in range(G, 1, -1):
            for nst in (2, 1):
                need = inverse_carve(hidden, n_hidden_m1, t, nst, g)
                if need <= SMEM_LIMIT:
                    return t, g, nst, need
    return 32, G, 1, inverse_carve(hidden, n_hidden_m1, 32, 1)
