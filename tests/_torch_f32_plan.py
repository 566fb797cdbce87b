"""A Python copy of the f32 layout's shared-memory carve-ups
(``F32Smem(H, logdet)`` and ``F32BwdSmem`` in
``dpfx_torch/ops/csrc/flow_f32.cuh``) and of the wrapper's choice of that
layout, so that the CPU tests can show the layout fits every f32 shape it
takes; the card tests hold it to the library's
``dpfx_fused_train_f32_smem_bytes`` / ``_tile_points`` / ``_part_row`` and to
``fused_train.uses_f32``. No JAX: the card tests import it."""

from typing import Tuple

from dpfx_torch.ops._build import SMEM_LIMIT

F32_T = 128        # points per forward block (the sampler's)
BWD_KC = 32        # Wh rows or columns per staged chunk of the backward
F32_WIDTHS = (128, 256)
MAX_N_HIDDEN = 4


def _r(n: int) -> int:
    return (n + 127) // 128 * 128


def f32_fwd_smem(hidden: int, logdet: bool = True) -> int:
    """Bytes of a block of the 128-point walk (the sampler's f32 inverse
    with ``logdet`` False, the training forward with it True)."""
    h = hidden
    kc = h if h <= 128 else 32
    nbuf = 2 if h >= 128 else 1
    o = _r(F32_T * (h + 1) * 4) + _r(3 * F32_T * 4) + _r(6 * F32_T * 4)
    o += nbuf * (_r(h * (kc + 1) * 4) + _r(h * 4))
    o += nbuf * (_r(3 * h * 4) + _r(h * 4) + _r(6 * h * 4) + _r(8 * 4))
    return o + (_r(F32_T * 4) if logdet else 0)


def f32_bwd_carve(hidden: int, n_hidden_m1: int, t: int) -> int:
    """Bytes of a backward block at t points a tile: every level of the
    tile in rows of H + 4, two chunk buffers [H][33] where there is a
    hidden product, the tile's coordinates, cotangents and (s, t), the
    layer's small weights and the block's sums of their gradients."""
    h, nh1 = hidden, n_hidden_m1
    nb = max(nh1, 1)
    o = (nh1 + 1) * _r(t * (h + 4) * 4)
    o += 2 * _r(h * (BWD_KC + 1) * 4) if nh1 > 0 else 0
    o += 4 * _r(3 * t * 4) + _r(8 * t * 4)
    o += _r(3 * h * 4) + _r(6 * h * 4) + _r(32) + _r(h * 4) + _r(nb * h * 4)
    o += _r(3 * h * 4) + _r(6 * h * 4) + _r(32) + _r(h * 4) + _r(nb * h * 4)
    return o


def f32_bwd_plan(hidden: int, n_hidden_m1: int) -> Tuple[int, int]:
    """(points per tile T, bytes) of a backward block: the largest T of 128
    (64 at H=256), 64, 32 whose carve-up fits."""
    t = 64 if hidden >= 256 else 128
    while True:
        need = f32_bwd_carve(hidden, n_hidden_m1, t)
        if need <= SMEM_LIMIT or t == 32:
            return t, need
        t //= 2


def f32_part_row(hidden: int, n_hidden_m1: int) -> int:
    """Floats of a backward block's partial of one layer, padded to 4."""
    h, nh1 = hidden, n_hidden_m1
    return (3 * h + nh1 * h * h + nh1 * h + 6 * h + 6 + 3) // 4 * 4


def f32_domain(hidden: int, n_hidden_m1: int) -> bool:
    """``fused_train.uses_f32`` for f32 at the kernel widths."""
    return hidden in F32_WIDTHS and n_hidden_m1 < MAX_N_HIDDEN
