"""dpfx_torch.tools.sass_loops on a small hand-written disassembly: the
innermost backward branches are the loops, their instructions are counted
by class, and loops without MUFU or HMMA (staging) are left out."""

import pytest

pytest.importorskip("torch")

from dpfx_torch.tools import sass_loops  # noqa: E402

FN = "_ZN38_GLOBAL__N__0_emd_cu_010emd_kernelILb1ELb0EEEvPKfS2_"


def ins(addr, text):
    return f"        /*{addr:04x}*/                   {text} ;"


def sass():
    lines = [f"\t\tFunction : {FN}"]
    addr = 0
    # a staging loop (no MUFU or HMMA), then an outer loop around an element loop
    lines.append(ins(addr, "LDS R1, [R2]")); addr += 16
    for _ in range(30):
        lines.append(ins(addr, "IMAD R3, R1, 0x4, R3")); addr += 16
    lines.append(ins(addr, "@P0 BRA 0x0")); addr += 16
    outer = addr
    lines.append(ins(addr, "MOV R5, R6")); addr += 16
    inner = addr
    for op in ["MUFU.EX2 R7, R8", "MUFU.SQRT R9, R8", "FFMA R1, R2, R3, R4", "FMUL R1, R2, R3",
               "F2FP.BF16.F32.PACK_AB R1, R2, R3", "HMMA.16816.F32.BF16 R4, R8, R12, R4",
               "LDS R1, [R2]", "LOP3.LUT R1, R2, 0xffff0000, RZ, 0xc0, !PT"] * 4:
        lines.append(ins(addr, op)); addr += 16
    lines.append(ins(addr, f"@P1 BRA 0x{inner:x}")); addr += 16
    lines.append(ins(addr, f"@P2 BRA 0x{outer:x}")); addr += 16
    lines.append(ins(addr, "EXIT"))
    return "\n".join(lines)


def test_parse_finds_the_kernel_and_its_instructions():
    fns = sass_loops.parse(sass())
    assert list(fns) == [FN]
    assert len(fns[FN]) == 1 + 30 + 1 + 1 + 32 + 3


@pytest.mark.parametrize("op,cls", [("MUFU.EX2", "MUFU"), ("FFMA", "FP32"), ("FMNMX", "FP32"),
                                    ("HMMA.1688.F32.BF16", "HMMA"), ("LDS.128", "SHARED"),
                                    ("F2FP.RELU.BF16.F32.PACK_AB", "CVT"), ("IMAD.U32", "INT"),
                                    ("HMUL2.BF16_V2", "OTHER")])
def test_classify(op, cls):
    assert sass_loops.classify(op) == cls


def test_report_lists_the_element_loop_only():
    lines = sass_loops.report(sass())
    assert len(lines) == 1
    assert lines[0].startswith("FAST=1 GRAD=0 loop ")
    assert "33 instructions, MUFU=8 FP32=8 HMMA=4 SHARED=4 CVT=4 INT=4 OTHER=1" in lines[0]


def test_cli_reads_a_saved_disassembly(tmp_path, capsys):
    f = tmp_path / "emd.sass"
    f.write_text(sass())
    assert sass_loops.main(["--sass", str(f)]) == 0
    assert capsys.readouterr().out.count("loop 0x") == 1


CD_FN = "_ZN43_GLOBAL__N__85a5aa37_10_chamfer_cu_f923a2d014chamfer_kernelEPKfS2_PKiiiiiPfS5_S5_"


def cd_sass():
    """A Chamfer-like kernel: a 26-instruction staging loop (no FMNMX), then an
    element loop of distances folded into minima: no MUFU, no HMMA."""
    lines = [f"\t\tFunction : {CD_FN}"]
    addr = 0
    for _ in range(25):
        lines.append(ins(addr, "IADD3 R1, R1, 0x10, RZ")); addr += 16
    lines.append(ins(addr, "@P0 BRA 0x0")); addr += 16
    top = addr
    lines.append(ins(addr, "LDS.128 R4, [R2]")); addr += 16
    for op in ["FMUL R8, R4, R12", "FMUL R9, R5, R13", "FADD R8, R8, R9", "FMUL R9, R6, R14",
               "FADD R8, R8, R9", "FADD R10, R7, R15", "FFMA R8, R8, -2, R10",
               "FMNMX R20, R20, R8, PT", "FMNMX R21, R21, R8, PT"] * 3:
        lines.append(ins(addr, op)); addr += 16
    lines.append(ins(addr, "SHFL.BFLY PT, R3, R21, 0x10, 0x1f")); addr += 16
    lines.append(ins(addr, "ATOMS.MIN RZ, [R2], R20")); addr += 16
    lines.append(ins(addr, f"@P1 BRA 0x{top:x}")); addr += 16
    lines.append(ins(addr, "EXIT"))
    return "\n".join(lines)


def test_kernel_names_from_the_mangled_length_prefix():
    assert sass_loops.demangled_args(CD_FN) == "chamfer_kernel"
    assert sass_loops.demangled_args(FN) == "FAST=1 GRAD=0"
    assert sass_loops.demangled_args("_ZN4dpfx13reduce_slicesEPKfPfiix") == \
        "_ZN4dpfx13reduce_slicesEPKfPfiix"


@pytest.mark.parametrize("fn,want", [
    ("_ZN38_GLOBAL__N__3aff3cc9_6_emd_cu_fad9d19414emd_large_rowsILb0ELb1ELi2EEEvPKiiiiiiPK6float4S5_PcxPf",
     "emd_large_rows FAST=0 GRAD=1 KIND=2"),
    ("_ZN38_GLOBAL__N__3aff3cc9_6_emd_cu_fad9d19414emd_large_colsILb1ELb0ELb1EEEvPKiiiiiiPK6float4S5_PcxPfS7_",
     "emd_large_cols FAST=1 GRAD=0 ZERO=1"),
    ("_ZN38_GLOBAL__N__1b2c3d4e_10_chamfer_cu_0a1b2c3d15cd_large_minimaILb1EEEvPKfS2_PKiiiPjS5_",
     "cd_large_minima FAST=1"),
    ("_ZN38_GLOBAL__N__1b2c3d4e_10_chamfer_cu_0a1b2c3d15nnd_large_sweepEPKfS2_iiS2_S2_Pj", "nnd_large_sweep")])
def test_large_layout_kernel_names(fn, want):
    """The large-cloud layout's kernels by name and template arguments."""
    assert sass_loops.demangled_args(fn) == want


@pytest.mark.parametrize("loops,listed", [("mufu", 0), ("fmnmx", 1), ("all", 2)])
def test_report_selects_loops(loops, listed):
    """The default lists MUFU/HMMA loops only (none here); fmnmx the element
    loop, with the FP32 class split by opcode; all also the staging loop."""
    lines = sass_loops.report(cd_sass(), loops)
    assert len(lines) == listed
    if listed:
        el = [ln for ln in lines if "FMNMX" in ln]
        assert len(el) == 1 and el[0].startswith("chamfer_kernel loop ")
        assert "31 instructions, FP32=27 SHARED=2 OTHER=2" in el[0]
        assert "(FP32: FADD=9 FFMA=3 FMNMX=6 FMUL=9)" in el[0]
    if loops == "all":
        assert any("26 instructions, INT=25 OTHER=1" in ln for ln in lines)


def test_report_rejects_an_unknown_selection():
    with pytest.raises(ValueError, match="loops must be one of"):
        sass_loops.report(cd_sass(), "fp32")


def test_cli_lists_fmnmx_loops(tmp_path, capsys):
    f = tmp_path / "chamfer.sass"
    f.write_text(cd_sass())
    assert sass_loops.main(["chamfer", "--sass", str(f), "--loops", "fmnmx"]) == 0
    out = capsys.readouterr().out
    assert out.count("loop 0x") == 1 and "FMNMX=6" in out
    assert sass_loops.main(["chamfer", "--sass", str(f)]) == 0
    assert capsys.readouterr().out == ""
