"""The decomposition probe's forms without CUDA: the Python form check
(``bench_fused_bwd.check_form``) accepts exactly the forms the kernel
library is built for (``BUILT``, ``ILV_BUILT``, ``ILV_TILE``) and raises
ValueError for every other; each built form's shared memory, by the
Python mirror of the kernels' carve-up, fits a block; the launch grid of
each form; the CLI on the CPU prints the backward's split."""

import itertools

import pytest

torch = pytest.importorskip("torch")

from dpfx_torch.ops._build import SMEM_LIMIT  # noqa: E402
from dpfx_torch.tools import bench_fused_bwd as bfb  # noqa: E402

BF, F32 = torch.bfloat16, torch.float32
DTYPES = {"bfloat16": BF, "float32": F32}

# (dtype, tile, mode, rolled, stripes) of every built form
_BUILT = ([(d, t, m, r, 1) for d in DTYPES for (t, m, r) in sorted(bfb.BUILT[DTYPES[d]])]
          + [(d, bfb.ILV_TILE[DTYPES[d]], "full", r, s) for d in DTYPES
             for (s, r) in sorted(bfb.ILV_BUILT[DTYPES[d]])])


def _built(dtype, tile, mode, rolled, stripes):
    if stripes == 1:
        return (tile, mode, rolled) in bfb.BUILT[dtype]
    return mode == "full" and (stripes, rolled) in bfb.ILV_BUILT[dtype] and \
        tile == bfb.ILV_TILE[dtype]


@pytest.mark.parametrize("dtype,tile,mode,rolled,stripes", _BUILT)
def test_built_form_is_accepted_and_fits(dtype, tile, mode, rolled, stripes):
    dt = DTYPES[dtype]
    bfb.check_form(dt, mode, rolled, tile, stripes, n=2048)
    assert 0 < bfb.smem_bytes(bfb.H, bfb.NH, dt, tile, stripes) <= SMEM_LIMIT


def test_check_form_accepts_exactly_the_built_forms():
    """Over every tile, mode, loop form and group count nearby, the check
    passes exactly where BUILT / ILV_BUILT / ILV_TILE list the form."""
    accepted = set()
    for dtype, tile, mode, rolled, stripes in itertools.product(
            (BF, F32), (16, 32, 64, 128, 256), bfb.MODES, (False, True), (1, 2, 3, 4, 8)):
        try:
            bfb.check_form(dtype, mode, rolled, tile, stripes, n=2048)
        except ValueError:
            assert not _built(dtype, tile, mode, rolled, stripes)
            continue
        assert _built(dtype, tile, mode, rolled, stripes)
        accepted.add((dtype, tile, mode, rolled, stripes))
    assert len(accepted) == len(_BUILT)


@pytest.mark.parametrize("case,match", [
    (dict(dtype=BF, mode="full", rolled=False, tile=64), "built for"),      # the first design's tile
    (dict(dtype=BF, mode="walk", rolled=True, tile=32), "built for"),
    (dict(dtype=F32, mode="nowg", rolled=True, tile=32), "built for"),
    (dict(dtype=F32, mode="full", rolled=False, tile=128), "built for"),
    (dict(dtype=BF, mode="full", rolled=False, tile=128, stripes=3), "stripes"),
    (dict(dtype=BF, mode="nowg", rolled=False, tile=128, stripes=2), "stripes"),
    (dict(dtype=BF, mode="full", rolled=False, tile=32, stripes=2), "built for"),
    (dict(dtype=F32, mode="full", rolled=True, tile=16, stripes=2), "built for"),
    (dict(dtype=F32, mode="full", rolled=False, tile=16, stripes=4, n=254), "stripes"),
    (dict(dtype=BF, mode="full", rolled=False, tile=128, n_hidden_m1=2), "shared"),
    (dict(dtype=torch.float16, mode="full", rolled=False, tile=128), "dtype"),
    (dict(dtype=BF, mode="half", rolled=False, tile=128), "mode"),
])
def test_check_form_rejects(case, match):
    with pytest.raises(ValueError, match=match):
        bfb.check_form(**case)


def test_interleaved_bf16_takes_any_n():
    """The bf16 groups need no N that the group count divides (f32's
    stripes do)."""
    bfb.check_form(BF, "full", False, 128, 4, n=254)


@pytest.mark.parametrize("stripes,b,n,want", [
    (1, 64, 2048, (132, 132, 16)),    # one block per SM, as fused_backward_kernel
    (1, 2, 300, (6, 6, 3)),
    (2, 64, 2048, (132, 264, 32)),    # two slices a block, tiles of 64 points
    (4, 3, 300, (8, 32, 10)),         # tiles of 32 points, a partial last one
])
def test_grid_bf16(stripes, b, n, want):
    assert bfb.grid(BF, 128, stripes, b, n, 132) == want


def test_grid_f32():
    assert bfb.grid(F32, 32, 1, 2, 300, 132) == (20, 20, 10)
    assert bfb.grid(F32, 16, 4, 3, 256, 132) == (3, 3, 0)


def test_split_line():
    line = bfb.split_line({"lib": 2.0, "full": 2.5, "nowg": 2.0, "walk": 1.0})
    assert line == ("split of full: weight gradients (full - nowg) 20.0%, cotangent chain "
                    "(nowg - walk) 40.0%, recompute and inverse (walk) 40.0%; full / lib 1.250")
    assert bfb.split_line({"full": 2.5, "nowg": 2.0, "walk": 1.0}).endswith("not measured")
    assert bfb.split_line({"full": 2.5, "walk": 1.0}) is None


@pytest.mark.parametrize("stripes", bfb.ILV_STRIPES)
def test_ilv_slice_bytes(stripes):
    """Each group tile of 128 / S points reads and writes the f32 dWh of
    every hidden layer once: 128 KiB at the flagship width, S times as many
    group tiles as full has tiles."""
    per_tile, total = bfb.ilv_slice_bytes(stripes, 64, 2048, 32, 128, 1)
    assert per_tile == 2 * 128 * 128 * 4
    assert total == per_tile * 64 * (2048 // (128 // stripes)) * 32
    assert bfb.ilv_slice_bytes(stripes, 1, 130, 2, 128, 2)[1] == 2 * per_tile * -(-130 // (128 // stripes)) * 2


def test_cli_prints_the_split_on_the_cpu(monkeypatch, capsys):
    """--device cpu (plain versions; B=1, one rep, the flow cut to K=2,
    N=128): the default tile is 128, and the line before the launches
    splits full into its three parts and gives full / lib."""
    monkeypatch.setenv("DPFX_PROBE_B", "1")
    monkeypatch.setenv("DPFX_PROBE_REPS", "1")
    monkeypatch.delenv("DPFX_PROBE_TILES", raising=False)
    monkeypatch.setattr(bfb, "K", 2)
    monkeypatch.setattr(bfb, "N", 128)
    assert bfb.main(["--device", "cpu", "lib", "full", "nowg", "walk"]) == 0
    out = capsys.readouterr().out.splitlines()
    for v in ("full", "nowg", "walk"):
        assert any(line.startswith(f"  {v:6s} tile= 128 ") for line in out), v
    assert out[-2].startswith("split of full: weight gradients (full - nowg) ")
    assert "cotangent chain (nowg - walk)" in out[-2] and "full / lib " in out[-2]
    assert "not measured" not in out[-2]
    assert out[-1] == "launches {}"
