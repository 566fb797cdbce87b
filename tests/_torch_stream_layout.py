"""A Python copy of the fused_train stream layout's choice of point tile,
weight chunk and shared memory (``StreamSmem`` in
``dpfx_torch/ops/csrc/fused_train.cu``), so that the CPU tests can show the
layout fits every shape of the training kernels' domain; the card tests
hold it to the library's ``dpfx_fused_train_stream_smem_bytes`` and
``dpfx_fused_train_stream_tile_points``. No JAX: the card tests import it."""

from typing import Tuple

from dpfx_torch.ops._build import SMEM_LIMIT


def stream_smem(hidden: int, n_hidden_m1: int, bf16: bool, backward: bool
                ) -> Tuple[int, int, int]:
    """(points per tile T, Wh columns per staged chunk NC, bytes) of a block
    of the stream layout: the largest T in 128 .. 16, then the widest NC in
    min(H, 128) .. 32 that divides H, whose carve-up fits."""
    r = lambda n: (n + 127) // 128 * 128  # noqa: E731
    es, pad = (2, 8) if bf16 else (4, 1)
    h, nb = hidden, max(n_hidden_m1, 1)
    ld = h + pad

    def carve(t, nc):
        lw = nc + pad
        o = (n_hidden_m1 + 1 if backward else 2) * r(t * ld * es)
        o += r((h * lw if backward and h * lw > nc * ld else nc * ld) * es)
        o += r(8 * 256 * 4) if bf16 else 0
        o += r(t // 16 * nc * 4) if bf16 and backward else 0
        o += r(3 * t * 4) + r(8 * t * 4) + (3 * r(3 * t * 4) if backward else r(t * 4))
        o += r(3 * h * 4) + r(6 * h * 4) + r(32) + r(h * 4) + r(nb * h * 4)
        if backward:
            o += r(3 * h * 4) + r(6 * h * 4) + r(32) + r(h * 4) + r(nb * h * 4)
        return o

    out = None
    for t in (128, 64, 32, 16):
        nc = min(h, 128)
        while nc >= 32 or nc == h:
            if h % nc == 0:
                out = (t, nc, carve(t, nc))
                if out[2] <= SMEM_LIMIT:
                    return out
            nc //= 2
    return out
