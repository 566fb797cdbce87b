"""The training backward of this tree against another checkout's, on the
card: the SASS of one kernel of ``csrc/fused_train.cu`` (by default
``bwd_kernel_mma<128>``) from both builds compared line by line, and
``fused_backward_kernel`` timed in turns.

    python -m dpfx_torch.tools.bwd_ab PARENT [--kernel NAME] [--turns 8] [--out DIR]

PARENT is the root of another checkout (``git archive <commit> | tar -x -C
<dir>``). Both ``fused_train.cu`` are built with the flags of
``dpfx_torch/ops/_build.py`` into ``build/bwd_ab/``, all at once, and
disassembled with ``cuobjdump -sass``; the count of differing lines leaves
out addresses, encodings and the lines that name a branch target, which
move whenever code above them does. Then ``fused_backward_kernel`` runs at
B=64, N=2048, K=32, H=128 in bf16 (random weights from a seed) on each
library in turn, the order reversed every other turn; both must give the
same bits. The last line gives each build's times (CUDA events, 10 calls a
turn) and their medians. ``--out`` keeps both disassemblies of the kernel.
"""

from __future__ import annotations

import argparse
import ctypes
import difflib
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path
from typing import List, Optional, Tuple

_ADDR = re.compile(r"/\*[0-9a-f]{4,}\*/|/\* 0x[0-9a-f]+ \*/")
_TARGET = re.compile(r"\b(BRA|BRX|BSSY|CALL|JMP|RET)\b")


def kernel_sass(text: str, kernel: str) -> str:
    """The disassembly of the first function whose mangled name contains
    ``kernel`` ("" when none does)."""
    for part in re.split(r"\n(?=\s*Function : )", text):
        m = re.search(r"Function : (\S+)", part)
        if m and kernel in m.group(1):
            return part
    return ""


def normalized(sass: str) -> List[str]:
    """A function's instructions without addresses, encodings or the lines
    that name a branch target."""
    out = []
    for line in sass.splitlines():
        line = _ADDR.sub("", line).strip()
        if not line or line.startswith(("Function", ".", "/*")) or _TARGET.search(line):
            continue
        out.append(" ".join(line.split()))
    return out


def differing(a: List[str], b: List[str]) -> int:
    """Lines removed plus lines added from a to b."""
    return sum(1 for ln in difflib.unified_diff(a, b, lineterm="", n=0)
               if ln[:1] in "+-" and not ln.startswith(("+++", "---")))


def ptxas_of(log: str, kernel: str) -> Optional[Tuple[int, int, int, int]]:
    """(stack frame, spill stores, spill loads, registers) of the kernel
    from ``-Xptxas -v``'s log."""
    m = re.search(re.escape(kernel) + r"[^\n]*\n[^\n]*\n\s*(\d+) bytes stack frame, (\d+) bytes "
                  r"spill stores, (\d+) bytes spill loads\n[^\n]*Used (\d+) registers", log)
    return tuple(int(v) for v in m.groups()) if m else None


def _build_both(parent: Path, kernel: str):
    from dpfx_torch.ops import _build

    here = Path(__file__).resolve().parents[1] / "ops" / "csrc"
    root = _build.BUILD_DIR.parent / "bwd_ab"
    tool = shutil.which("cuobjdump") or str(Path(_build._nvcc()).parent / "cuobjdump")
    procs = {}
    for name, src in (("parent", parent / "dpfx_torch" / "ops" / "csrc"), ("tree", here)):
        d = root / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-o", str(d / "libfused_train.so"), str(d / "fused_train.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, sass = {}, {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the {name}'s fused_train.cu:\n{log[-3000:]}")
        so = root / name / "libfused_train.so"
        print(f"{name} {kernel} ptxas (stack, spill stores, spill loads, registers): "
              f"{ptxas_of(log, kernel)}", flush=True)
        sass[name] = kernel_sass(subprocess.run([tool, "-sass", str(so)], capture_output=True,
                                                text=True, check=True).stdout, kernel)
        if not sass[name]:
            raise RuntimeError(f"no function matching {kernel!r} in the {name}'s build")
        libs[name] = ctypes.CDLL(str(so))
    return libs, sass


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="the root of the checkout to compare with")
    ap.add_argument("--kernel", default="bwd_kernel_mmaILi128E",
                    help="a part of the mangled kernel name (default bwd_kernel_mma<128>)")
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--out", type=Path, help="a directory for both disassemblies")
    a = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("bwd_ab needs a CUDA device", file=sys.stderr)
        return 1
    from dpfx_torch.models.coupling import make_masks
    from dpfx_torch.ops import _build
    from dpfx_torch.ops import fused_train as ft

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs, sass = _build_both(a.parent, a.kernel)
    if a.out:
        a.out.mkdir(parents=True, exist_ok=True)
        for name, text in sass.items():
            (a.out / f"{name}.sass").write_text(text)
    pn, tn = normalized(sass["parent"]), normalized(sass["tree"])
    print(f"{a.kernel}: {len(pn)} and {len(tn)} instructions (branch targets aside), "
          f"{differing(pn, tn)} lines differ", flush=True)

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    k, h = 32, 128
    m3 = torch.from_numpy(make_masks(3, k)).float().to(dev)
    w = (rn(k, h, 3) * 0.5 * (1 - m3)[:, None, :], rn(k, 1, h, h) / h ** 0.5, 0.1 * rn(k, 1, h),
         0.02 * rn(k, 6, h), 0.01 * rn(k, 6), m3.contiguous(), 3.0)
    u, hz, du, dld = rn(64, 3, 2048), 0.1 * rn(64, k, h), rn(64, 3, 2048), rn(64)
    run = lambda: ft.fused_backward_kernel(*w, u, hz, du, dld, bf)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ref, times = None, {n: [] for n in libs}
    order = list(libs)
    for turn in range(a.turns):
        for name in order if turn % 2 == 0 else order[::-1]:
            ft._lib.cache_clear()
            _build._loaded["fused_train"] = libs[name]
            out = run()
            if ref is None:
                ref = [t.clone() for t in out]
            if not all(torch.equal(x, y) for x, y in zip(out, ref)):
                print(f"the {name}'s backward differs from the other's", file=sys.stderr)
                return 1
            for _ in range(2):
                run()
            torch.cuda.synchronize()
            start.record()
            for _ in range(10):
                run()
            end.record()
            torch.cuda.synchronize()
            times[name].append(round(start.elapsed_time(end) / 10, 4))
    ft._lib.cache_clear()
    _build._loaded.pop("fused_train", None)
    medians = {n: round(statistics.median(t), 4) for n, t in times.items()}
    print(f"fused_backward_kernel B=64 N=2048 K={k} H={h} bf16 ms in turns ({card}): "
          f"{json.dumps(times)}; medians {json.dumps(medians)}; same bits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
