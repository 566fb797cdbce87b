"""The innermost loops of a kernel library's SASS and the instruction mix of
each: how many MUFU (ex2, sqrt, rsqrt), FP32 (FADD, FMUL, FFMA, FMNMX, ...),
tensor-core (HMMA), shared-memory, conversion and integer instructions one
trip of the loop issues.

    python -m dpfx_torch.tools.sass_loops [name] [--sass FILE]

Only loops with a MUFU or HMMA instruction (the element loops) are listed.
``name`` (default ``emd``) is a source in ``dpfx_torch/ops/csrc``; its built
library is disassembled with ``cuobjdump -sass`` (the CUDA toolkit's), or
``--sass`` reads a saved disassembly. A loop is a backward branch; it is
innermost when no other backward branch lies inside it. Loops of fewer than
24 instructions (the staging loops) are left out. One line per loop, the
kernel's template arguments first.
"""

from __future__ import annotations

import argparse
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path
from typing import Dict, List, Tuple

FP32 = {"FADD", "FMUL", "FFMA", "FMNMX", "FSEL", "FSETP", "FCHK", "FMUL32I", "FADD32I", "FFMA32I"}
SHARED = {"LDS", "STS", "LDSM", "LD", "ST", "LDG", "STG", "ATOMS", "LDC"}
CLASSES = ("MUFU", "FP32", "HMMA", "SHARED", "CVT", "INT", "OTHER")
MIN_LOOP = 24

_FN = re.compile(r"Function : (\S+)")
_INS = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(@!?U?P\w+\s+)?([A-Z0-9_.]+)([^;]*);")


def classify(op: str) -> str:
    base = op.split(".")[0]
    if base == "MUFU":
        return "MUFU"
    if base in FP32:
        return "FP32"
    if base == "HMMA":
        return "HMMA"
    if base in SHARED:
        return "SHARED"
    if base in ("F2FP", "F2F", "I2F", "F2I"):
        return "CVT"
    if base in ("IMAD", "IADD3", "LOP3", "SHF", "PRMT", "ISETP", "IMNMX", "LEA", "MOV", "SEL",
                "IABS", "VIADD", "VIMNMX", "LOP", "SHL", "SHR"):
        return "INT"
    return "OTHER"


def parse(text: str) -> Dict[str, List[Tuple[int, str, str]]]:
    """kernel name -> [(address, opcode, operands)] in address order."""
    out: Dict[str, List[Tuple[int, str, str]]] = {}
    cur = None
    for line in text.splitlines():
        m = _FN.search(line)
        if m:
            cur = m.group(1)
            out[cur] = []
            continue
        m = _INS.search(line)
        if m and cur is not None:
            out[cur].append((int(m.group(1), 16), m.group(3), m.group(4)))
    return out


def innermost_loops(ins: List[Tuple[int, str, str]]) -> List[Tuple[int, int]]:
    back = []
    for addr, op, args in ins:
        if op.startswith("BRA"):
            m = re.search(r"0x([0-9a-f]+)", args)
            if m and int(m.group(1), 16) <= addr:
                back.append((int(m.group(1), 16), addr))
    return [(a, b) for a, b in back
            if not any(a <= a2 and b2 <= b and (a2, b2) != (a, b) for a2, b2 in back)]


def loop_mix(ins, start: int, end: int) -> Counter:
    return Counter(classify(op) for addr, op, _ in ins if start <= addr <= end)


def demangled_args(name: str) -> str:
    m = re.search(r"emd_kernelILb(\d)ELb(\d)E", name)
    if m:
        return f"FAST={m.group(1)} GRAD={m.group(2)}"
    return name


def report(text: str) -> List[str]:
    lines = []
    for fn, ins in parse(text).items():
        for a, b in innermost_loops(ins):
            mix = loop_mix(ins, a, b)
            n = sum(mix.values())
            if n < MIN_LOOP or not (mix["MUFU"] or mix["HMMA"]):
                continue
            counts = " ".join(f"{c}={mix[c]}" for c in CLASSES if mix[c])
            lines.append(f"{demangled_args(fn)} loop 0x{a:x}-0x{b:x}: {n} instructions, {counts}")
    return lines


def disassemble(name: str) -> str:
    from dpfx_torch.ops import _build

    lib = _build.BUILD_DIR / f"lib{name}.so"
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    return subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True, check=True).stdout


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("name", nargs="?", default="emd")
    ap.add_argument("--sass", type=Path, help="a saved cuobjdump -sass output")
    a = ap.parse_args(argv)
    text = a.sass.read_text() if a.sass else disassemble(a.name)
    for line in report(text):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
