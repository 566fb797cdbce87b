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
