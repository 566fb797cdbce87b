"""The training backward (or the f32 sampler) of this tree against another
checkout's, on the card: the SASS of one kernel from both builds compared
line by line, and the kernel's wrapper timed in turns.

    python -m dpfx_torch.tools.bwd_ab PARENT [--library fused_train|fused_sampler]
        [--kernel NAME] [--turns 8] [--out DIR]

PARENT is the root of another checkout (``git archive <commit> | tar -x -C
<dir>``). Both ``csrc/<library>.cu`` are built with the flags of
``dpfx_torch/ops/_build.py`` into ``build/bwd_ab/``, all at once, and
disassembled with ``cuobjdump -sass``; the count of differing lines leaves
out addresses, encodings and the lines that name a branch target, which
move whenever code above them does. Then the wrapper runs on each library
in turn, the order reversed every other turn, and both must give the same
bits: for ``fused_train`` (kernel by default ``bwd_kernel_mma<128>``)
``fused_backward_kernel`` at B=64, N=2048, K=32, H=128 in bf16, for
``fused_sampler`` (by default ``f32_kernel<float, 128>``)
``fused_sample_points`` at the same shape in f32 (random weights from a
seed). The last line gives each build's times (CUDA events, 10 calls a
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

# the kernel each library's A/B disassembles by default
KERNELS = {"fused_train": "bwd_kernel_mmaILi128E", "fused_sampler": "f32_kernelIfLi128E"}
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


def _build_both(parent: Path, kernel: str, library: str):
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
             "-fPIC", "-Xptxas", "-v", "-o", str(d / f"lib{library}.so"), str(d / f"{library}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs, sass = {}, {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for the {name}'s {library}.cu:\n{log[-3000:]}")
        so = root / name / f"lib{library}.so"
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
    ap.add_argument("--library", choices=sorted(KERNELS), default="fused_train")
    ap.add_argument("--kernel", help="a part of the mangled kernel name (default: the "
                                     "library's in KERNELS)")
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--out", type=Path, help="a directory for both disassemblies")
    a = ap.parse_args(argv)
    kernel = a.kernel or KERNELS[a.library]

    import torch

    if not torch.cuda.is_available():
        print("bwd_ab needs a CUDA device", file=sys.stderr)
        return 1
    from dpfx_torch.compat import randomize_
    from dpfx_torch.models.coupling import CouplingFlow, make_masks
    from dpfx_torch.ops import _build
    from dpfx_torch.ops import fused_sampler as fs
    from dpfx_torch.ops import fused_train as ft

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(card, flush=True)
    libs, sass = _build_both(a.parent, kernel, a.library)
    if a.out:
        a.out.mkdir(parents=True, exist_ok=True)
        for name, text in sass.items():
            (a.out / f"{name}.sass").write_text(text)
    pn, tn = normalized(sass["parent"]), normalized(sass["tree"])
    print(f"{kernel}: {len(pn)} and {len(tn)} instructions (branch targets aside), "
          f"{differing(pn, tn)} lines differ", flush=True)

    dev, bf = torch.device("cuda"), torch.bfloat16
    g = torch.Generator(device=dev).manual_seed(3)
    rn = lambda *s: torch.randn(s, generator=g, device=dev)
    k, h = 32, 128
    if a.library == "fused_train":
        m3 = torch.from_numpy(make_masks(3, k)).float().to(dev)
        w = (rn(k, h, 3) * 0.5 * (1 - m3)[:, None, :], rn(k, 1, h, h) / h ** 0.5,
             0.1 * rn(k, 1, h), 0.02 * rn(k, 6, h), 0.01 * rn(k, 6), m3.contiguous(), 3.0)
        u, hz, du, dld = rn(64, 3, 2048), 0.1 * rn(64, k, h), rn(64, 3, 2048), rn(64)
        mod, what = ft, f"fused_backward_kernel B=64 N=2048 K={k} H={h} bf16"
        run = lambda: ft.fused_backward_kernel(*w, u, hz, du, dld, bf)
    else:
        flow = randomize_(CouplingFlow(3, k, h, 2, cond_dim=128, scale_cap=3.0), 3, 0.02)
        with torch.no_grad():
            sp = fs.stack_point_flow_params(flow.to(dev))
        z = rn(64, 128)
        mod, what = fs, f"fused_sample_points B=64 N=2048 K={k} H={h} f32"
        run = lambda: (fs.fused_sample_points(sp, z, 5, 2048, dtype=torch.float32),)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    ref, times = None, {n: [] for n in libs}
    order = list(libs)
    for turn in range(a.turns):
        for name in order if turn % 2 == 0 else order[::-1]:
            mod._lib.cache_clear()
            _build._loaded[a.library] = libs[name]
            out = run()
            if ref is None:
                ref = [t.clone() for t in out]
                if not all(bool(torch.isfinite(t).all()) for t in ref):
                    print(f"the {name}'s output is not finite", file=sys.stderr)
                    return 1
            if not all(torch.equal(x, y) for x, y in zip(out, ref)):
                print(f"the {name}'s output differs from the other's", file=sys.stderr)
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
    mod._lib.cache_clear()
    _build._loaded.pop(a.library, None)
    medians = {n: round(statistics.median(t), 4) for n, t in times.items()}
    print(f"{what} ms in turns ({card}): {json.dumps(times)}; medians {json.dumps(medians)}; "
          "same bits")
    return 0


if __name__ == "__main__":
    sys.exit(main())
