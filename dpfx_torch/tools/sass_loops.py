"""The innermost loops of a kernel library's SASS and the instruction mix of
each: how many MUFU (ex2, sqrt, rsqrt), FP32 (FADD, FMUL, FFMA, FMNMX, ...),
tensor-core (HMMA), shared-memory, conversion and integer instructions one
trip of the loop issues.

    python -m dpfx_torch.tools.sass_loops [name] [--sass FILE] [--loops mufu|fmnmx|all]

``--loops`` picks the loops listed: ``mufu`` (the default) those with a
MUFU or HMMA instruction (the EMD kernel's element loops), ``fmnmx`` those
with an FMNMX (a min or max: the Chamfer kernel's element loops), ``all``
every one. ``name`` (default ``emd``) is a source in
``dpfx_torch/ops/csrc``; its built library is disassembled with
``cuobjdump -sass`` (the CUDA toolkit's), or ``--sass`` reads a saved
disassembly. A loop is a backward branch; it is innermost when no other
backward branch lies inside it. Loops of fewer than 24 instructions (the
staging loops) are left out. One line per loop, the kernel's template
arguments first; with ``fmnmx`` and ``all`` the FP32 class is also split by
opcode (FADD, FMUL, FFMA, FMNMX, ...).
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


def fp32_ops(ins, start: int, end: int) -> Counter:
    """The loop's FP32-class instructions by opcode (FMNMX, FADD, ...)."""
    return Counter(op.split(".")[0] for addr, op, _ in ins
                   if start <= addr <= end and classify(op) == "FP32")


def demangled_args(name: str) -> str:
    m = re.search(r"emd_kernelILb(\d)ELb(\d)E", name)
    if m:
        return f"FAST={m.group(1)} GRAD={m.group(2)}"
    m = re.search(r"chamfer_kernelILb(\d)E", name)
    if m:
        return f"chamfer_kernel FAST={m.group(1)}"
    # the large-cloud layout's sweeps (KIND: emd.cu's Kind, ZERO: level 0)
    m = re.search(r"emd_large_(rows|cols)ILb(\d)ELb(\d)EL([ib])(\d)E", name)
    if m:
        last = "KIND" if m.group(4) == "i" else "ZERO"
        return f"emd_large_{m.group(1)} FAST={m.group(2)} GRAD={m.group(3)} {last}={m.group(5)}"
    m = re.search(r"cd_large_minimaILb(\d)E", name)
    if m:
        return f"cd_large_minima FAST={m.group(1)}"
    # another kernel: its name, from the mangled name's length prefix
    for m in re.finditer(r"(\d+)(?=[A-Za-z_])", name):
        ident = name[m.end():m.end() + int(m.group(1))]
        if ident.endswith("_kernel") or ident.startswith("nnd_large_"):
            return ident
    return name


LOOPS = ("mufu", "fmnmx", "all")


def report(text: str, loops: str = "mufu") -> List[str]:
    """One line per innermost loop of at least MIN_LOOP instructions that
    ``loops`` selects (see the module's docstring)."""
    if loops not in LOOPS:
        raise ValueError(f"loops must be one of {LOOPS}, got {loops!r}")
    lines = []
    for fn, ins in parse(text).items():
        for a, b in innermost_loops(ins):
            mix = loop_mix(ins, a, b)
            n = sum(mix.values())
            ops = fp32_ops(ins, a, b)
            if n < MIN_LOOP or (loops == "mufu" and not (mix["MUFU"] or mix["HMMA"])) \
                    or (loops == "fmnmx" and not ops["FMNMX"]):
                continue
            counts = " ".join(f"{c}={mix[c]}" for c in CLASSES if mix[c])
            if loops != "mufu" and ops:
                counts += " (FP32: " + " ".join(f"{k}={v}" for k, v in sorted(ops.items())) + ")"
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
    ap.add_argument("--loops", choices=LOOPS, default="mufu",
                    help="loops with MUFU or HMMA (default), with FMNMX, or all")
    a = ap.parse_args(argv)
    text = a.sass.read_text() if a.sass else disassemble(a.name)
    for line in report(text, a.loops):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
