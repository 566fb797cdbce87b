"""dpfx_torch.tools.bwd_ab without CUDA: the kernel's disassembly picked
out of cuobjdump's, addresses, encodings and branch targets left out of
the comparison, the differing lines counted, ptxas' line read."""

import pytest

torch = pytest.importorskip("torch")

from dpfx_torch.tools import bwd_ab  # noqa: E402

KERNEL = "bwd_kernel_mmaILi128E"


def ins(addr, text):
    return f"        /*{addr:04x}*/                   {text} ;   /* 0x000fe20000000f00 */"


def dump(body, shift=0):
    other = ["\t\tFunction : _ZN18_GLOBAL__N__0_fwd_kernel_mmaILi128EEvPf", ins(0, "EXIT")]
    lines = [f"\t\tFunction : _ZN18_GLOBAL__N__0_{KERNEL}EvPfS1_", "\t\t.headerflags @\"EF_CUDA_SM90\""]
    lines += [ins(16 * i + shift, op) for i, op in enumerate(body)]
    return "\n".join(other + lines)


BODY = ["S2R R0, SR_TID.X", "HMMA.16816.F32.BF16 R4, R8, R12, R4", "@P0 BRA 0x1230",
        "BSSY B0, 0x400", "CALL.REL.NOINC 0x135e0", "STG.E.64 desc[UR4][R2.64], R4", "EXIT"]


def test_kernel_sass_picks_the_named_function():
    text = bwd_ab.kernel_sass(dump(BODY), KERNEL)
    assert KERNEL in text and "fwd_kernel" not in text and "HMMA" in text
    assert bwd_ab.kernel_sass(dump(BODY), "no_such_kernel") == ""


def test_kernel_part_names_a_kernel_apart_in_each_build():
    """--kernel PARENT=TREE: the parent's part in the parent's build, the
    tree's in the tree's (a template whose new arguments changed the
    mangled name); a plain part names both."""
    k = "inv_clusterILi256ELi1EE=inv_clusterILi256ELi1ENS_7ReluNanE13__nv_bfloat16E"
    assert bwd_ab.kernel_part(k, "parent") == "inv_clusterILi256ELi1EE"
    assert bwd_ab.kernel_part(k, "tree") == "inv_clusterILi256ELi1ENS_7ReluNanE13__nv_bfloat16E"
    assert bwd_ab.kernel_part("f32_kernelIfLi128E", "parent") == "f32_kernelIfLi128E"
    assert bwd_ab.kernel_part("f32_kernelIfLi128E", "tree") == "f32_kernelIfLi128E"


def test_normalized_leaves_out_addresses_encodings_and_branch_targets():
    got = bwd_ab.normalized(bwd_ab.kernel_sass(dump(BODY), KERNEL))
    assert got == ["S2R R0, SR_TID.X ;", "HMMA.16816.F32.BF16 R4, R8, R12, R4 ;",
                   "STG.E.64 desc[UR4][R2.64], R4 ;", "EXIT ;"]


@pytest.mark.parametrize("body, n", [
    (BODY, 0),                                        # moved code: the same instructions
    (BODY[:1] + ["IMAD R1, R2, R3, RZ"] + BODY[1:], 1),  # one instruction more
    (["S2R R1, SR_TID.X"] + BODY[1:], 2),              # one register renamed
])
def test_differing_counts_lines_removed_and_added(body, n):
    a = bwd_ab.normalized(bwd_ab.kernel_sass(dump(BODY), KERNEL))
    b = bwd_ab.normalized(bwd_ab.kernel_sass(dump(body, shift=0x30), KERNEL))
    assert bwd_ab.differing(a, b) == n


def test_ptxas_of_reads_the_kernels_line():
    log = ("ptxas info    : Compiling entry function '_ZN18_GLOBAL__N__0_fwd_kernel_mmaILi128EEvPf' "
           "for 'sm_90a'\nptxas info    : Function properties for _ZN18_GLOBAL__N__0_fwd\n"
           "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
           "ptxas info    : Used 128 registers, used 1 barriers\n"
           f"ptxas info    : Compiling entry function '_ZN18_GLOBAL__N__0_{KERNEL}EvPf' for 'sm_90a'\n"
           f"ptxas info    : Function properties for _ZN18_GLOBAL__N__0_{KERNEL}EvPf\n"
           "    24 bytes stack frame, 24 bytes spill stores, 24 bytes spill loads\n"
           "ptxas info    : Used 255 registers, used 1 barriers, 24 bytes cumulative stack size\n")
    assert bwd_ab.ptxas_of(log, KERNEL) == (24, 24, 24, 255)
    assert bwd_ab.ptxas_of(log, "no_such_kernel") is None


def test_main_without_cuda_exits_nonzero(tmp_path, monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert bwd_ab.main([str(tmp_path)]) == 1


@pytest.mark.parametrize("hidden,n_hidden,want", [
    (256, 2, "bwd_clusterILi256ELi1E"), (128, 4, "bwd_clusterILi128ELi3E"),
    (192, 3, "bwd_clusterILi256ELi2E"), (256, 4, "bwd_clusterILi256ELi3E")])
def test_width_mode_disassembles_the_cluster_backward(hidden, n_hidden, want, monkeypatch):
    """--hidden compares the SASS of the backward the tree's wrapper takes
    at that width and depth: the cluster layout's, by the mangled name
    ptxas gives it, wherever that layout holds the (padded) shape (the
    layout's domain by the plan's mirror: ``uses_cluster`` asks the
    library)."""
    from _torch_cluster_plan import cluster_domain

    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.ops.fused_sampler import kernel_hidden

    monkeypatch.setattr(ft, "uses_cluster", cluster_domain)
    assert bwd_ab._layout_kernel(ft, kernel_hidden(hidden), n_hidden - 1) == want


@pytest.mark.parametrize("backward,forward", [
    ("bwd_clusterILi256ELi3E", "fwd_clusterILi256ELi3E"),
    ("bwd_kernel_mmaILi128E", "fwd_kernel_mmaILi128E"), ("bwd_kernelILi64E", "fwd_kernelILi64E"),
    ("bwd_f32ILi256ELi64E", None)])
def test_width_mode_also_disassembles_the_forward(backward, forward):
    """The width mode compares each shape's forward beside its backward:
    the layout's forward by its mangled name (the f32 layout's backward
    names its tile, which its forward does not have: none)."""
    assert bwd_ab._forward_kernel(backward) == forward


def test_shapes_and_kernels_repeat(tmp_path):
    """--shape H:L and --kernel may be given as often as wanted; without a
    card the tool stops before building anything, a malformed shape before
    that."""
    args = [str(tmp_path), "--shape", "256:3", "--shape", "256:4", "--kernel", "a", "--kernel", "b"]
    if not torch.cuda.is_available():
        assert bwd_ab.main(args) == 1
    with pytest.raises(SystemExit):
        bwd_ab.main([str(tmp_path), "--shape", "256"])


def test_width_mode_needs_the_fused_train_library(tmp_path):
    """The width mode takes the two libraries it times (fused_train, and
    fused_sampler's sampler A/B in both dtypes) and no other name; without
    a card it stops before building anything."""
    with pytest.raises(SystemExit):
        bwd_ab.main([str(tmp_path), "--library", "fused_encoder", "--hidden", "256"])
    if not torch.cuda.is_available():
        for lib in ("fused_train", "fused_sampler"):
            assert bwd_ab.main([str(tmp_path), "--library", lib, "--hidden", "256"]) == 1


@pytest.mark.parametrize("hidden,n_hidden,want", [
    (256, 2, "bwd_f32ILi256ELi64E"), (256, 4, "bwd_f32ILi256ELi32E"),
    (128, 4, "bwd_f32ILi128ELi64E"), (96, 2, "bwd_f32ILi128ELi128E"),
    (64, 3, "bwd_kernelILi64E")])
def test_f32_width_mode_disassembles_the_f32_backward(hidden, n_hidden, want, monkeypatch):
    """--hidden with --dtype float32 compares the SASS of the f32 backward
    the tree's wrapper takes: ``bwd_f32<H, T>`` at the plan's points a tile
    (the plan's mirror stands in for the library) at H = 128 and 256, the
    block-wide ``bwd_kernel<H>`` below."""
    from _torch_f32_plan import f32_bwd_plan

    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.ops.fused_sampler import kernel_hidden

    class Lib:
        @staticmethod
        def dpfx_fused_train_f32_tile_points(h, nh1, backward):
            return f32_bwd_plan(h, nh1)[0] if backward else 128

    monkeypatch.setattr(ft, "_f32_lib", lambda: Lib)
    got = bwd_ab._layout_kernel(ft, kernel_hidden(hidden), n_hidden - 1, torch.float32)
    assert got == want


def test_f32_width_mode_arguments(tmp_path):
    """--dtype takes bfloat16 (the default) and float32 and nothing else;
    without a card the f32 width mode stops before building anything."""
    with pytest.raises(SystemExit):
        bwd_ab.main([str(tmp_path), "--hidden", "256", "--dtype", "float16"])
    if not torch.cuda.is_available():
        assert bwd_ab.main([str(tmp_path), "--hidden", "256", "--dtype", "float32"]) == 1


def test_cluster_l2_model():
    """The modelled L2 traffic of the cluster backward: whole-layer stages
    read each CTA's slabs once a layer and cluster; the ring once a tile,
    and there reads and writes the slices of the matrices the registers do
    not hold (H=256: all but one; H=128: all but two) every tile but each
    cluster's first, which only writes."""
    slab = lambda h, nh1: 2 * nh1 * 64 * h * 2  # noqa: E731
    assert bwd_ab._cluster_l2_bytes(256, 1, 64, 2048, 32, 128, 30, False) == (
        32 * 30 * 4 * slab(256, 1), 0)
    tiles = 64 * 32
    slabs, slices = bwd_ab._cluster_l2_bytes(256, 3, 64, 2048, 32, 64, 30, True)
    assert slabs == 32 * tiles * 4 * slab(256, 3)
    assert slices == 32 * 4 * 2 * 64 * 256 * 4 * (2 * tiles - 30)
    assert bwd_ab._cluster_l2_bytes(128, 2, 64, 2048, 32, 128, 60, True)[1] == 0
