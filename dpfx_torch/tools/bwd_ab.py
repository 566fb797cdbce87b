"""The training backward (or the sampler) of this tree against another
checkout's, on the card: the SASS of one kernel from both builds compared
line by line, and the kernel's wrapper timed in turns.

    python -m dpfx_torch.tools.bwd_ab PARENT [--library fused_train|fused_sampler]
        [--kernel NAME ...] [--turns 8] [--out DIR] [--hidden H [--n-hidden L]
        [--dtype bfloat16|float32]] [--shape H:L ...]

PARENT is the root of another checkout (``git archive <commit> | tar -x -C
<dir>``). Both ``csrc/<library>.cu`` are built with the flags of
``dpfx_torch/ops/_build.py`` into ``build/bwd_ab/``, all at once, and
disassembled with ``cuobjdump -sass``; for each kernel named (``--kernel``
as often as wanted; ``PARENT_PART=TREE_PART`` where a template's
arguments changed its mangled name) ptxas' registers and spills of both builds and the
count of differing SASS lines, which leaves out addresses, encodings and
the lines that name a branch target (they move whenever code above them
does). Then the wrapper runs on each library
in turn, the order reversed every other turn, and both must give the same
bits: for ``fused_train`` (kernel by default ``bwd_kernel_mma<128>``)
``fused_backward_kernel`` at B=64, N=2048, K=32, H=128 in bf16, for
``fused_sampler`` (by default ``f32_kernel<float, 128>``)
``fused_sample_points`` at the same shape in f32 (random weights from a
seed). The last line gives each build's times (CUDA events, 10 calls a
turn) and their medians. ``--out`` keeps both disassemblies of the kernel.

With ``--hidden H`` (``fused_train``; ``--n-hidden``, default 2) both
``fused_forward_kernel`` and ``fused_backward_kernel`` run at B=64, N=2048,
K=32 on a point flow of that width (seeded random weights, scaled by
sqrt(128 / H)), each build on the layout this tree's wrapper takes with
it where the build holds the shape there, else on the layout that build's
wrapper took: the stream layout (a build that has it) wherever a block
overflows and the build's cluster or f32 layout does not take the shape;
this tool calls such a build's stream entry points itself. ``--shape H:L``
(as often as wanted, in place of ``--hidden`` and ``--n-hidden``) runs the
same at each (H, n_hidden) on the one pair of builds.
Each build's outputs are held to the plain versions at the bf16 limits of
chip_smoke.py's phase 2 (u: max 5e-2 and p99.9 2e-3 absolute, log-det and
gradients 2e-2 of their norms) and each must repeat its own bits from call
to call. Where the two layouts are the same, u and dx (per-point sums)
must have the same bits, the log-det too where both forwards take the
same points per tile, dhz and the weight gradients where both backwards
do, dWh only where they also sum it the same way (the same partial row:
a cluster backward on the ring pads it). The kernels disassembled are then
the tree's layouts' backward and forward at each shape, their SASS
compared only where both builds have them.

With ``--dtype float32`` the same in f32: a build without the f32 layout
runs the layout its wrapper took (the stream layout wherever the
block-wide one overflows). Every f32 layout computes each element of u as
one k-sum in order, so u must have the same bits in both builds; the
log-det must too where both forwards take the same points per block, and
every gradient where both backwards sum the same tiles in the same
design (the stream and f32 layouts at the same points per tile).
Elsewhere each build is held to an f64 run of the plain version as
chip_smoke.py's ``f64_held`` holds it (u within 1e-4 or 4x the f32 plain
version's own drift, max abs; each gradient within 1e-3 or 4x its drift,
relative norm; the log-det within 1e-5 of the plain f32 version's). Each
build's u is then inverted by this tree's f32 sampler (``f32_kernel``) on
the same hz and the round trip's median and largest error printed.

With ``--library fused_sampler --hidden H`` (``--n-hidden``, default 2)
``fused_sample_points`` runs at B=64, N=2048, K=32 on a point flow of that
width (the same seeded weights) in bf16 and in f32, each build on the
layout this tree's wrapper takes (``inverse_layout``: the cluster inverse
where the build has this tree's cluster launch, with its activation and
int8 arguments, else rows_kernel). f32 must give the same bits in
both builds; bf16 the same bits where both take the same layout, else
each build's clouds within phase 2's bf16 limits (max 5e-2, p99.9 2e-3)
of the plain inverse of its own noise; each build repeats its own bits.
The kernel disassembled is then by default the flagship's
``rows_kernel<bf16, 128, relu, two stages>``.
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
# the flagship's sampler, disassembled by --library fused_sampler --hidden
FLAGSHIP_SAMPLER = "rows_kernelI13__nv_bfloat16Li128ELb1ELb1E"
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


def kernel_part(kernel: str, build: str) -> str:
    """The part of a mangled name to look for in ``build`` ("parent" or
    "tree"): ``PARENT_PART=TREE_PART`` names a kernel apart in the two."""
    return kernel.split("=")[0 if build == "parent" else -1]


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


def _build_both(parent: Path, kernels: List[str], library: str):
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
        text = subprocess.run([tool, "-sass", str(so)], capture_output=True, text=True,
                              check=True).stdout
        for kernel in kernels:
            part = kernel_part(kernel, name)
            print(f"{name} {part} ptxas (stack, spill stores, spill loads, registers): "
                  f"{ptxas_of(log, part)}", flush=True)
            sass[name, kernel] = kernel_sass(text, part)
        libs[name] = ctypes.CDLL(str(so))
    return libs, sass


def _shape(text: str) -> Tuple[int, int]:
    """--shape's H:L as (H, n_hidden)."""
    try:
        h, nh = (int(v) for v in text.split(":"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not H:L") from None
    return h, nh


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path, help="the root of the checkout to compare with")
    ap.add_argument("--library", choices=sorted(KERNELS), default="fused_train")
    ap.add_argument("--kernel", action="append",
                    help="a part of a mangled kernel name, or PARENT_PART=TREE_PART where the "
                         "builds name it apart, as often as wanted (default: the library's in "
                         "KERNELS; with --hidden or --shape, the layouts' kernels)")
    ap.add_argument("--turns", type=int, default=8)
    ap.add_argument("--out", type=Path, help="a directory for both disassemblies")
    ap.add_argument("--hidden", type=int, help="time the forward and the backward "
                                               "(fused_sampler: the sampler in both dtypes) at "
                                               "this point-flow width")
    ap.add_argument("--n-hidden", type=int, default=2)
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16",
                    help="the compute dtype of the width mode (fused_train)")
    ap.add_argument("--shape", action="append", default=[], type=_shape,
                    help="H:L, a width and n_hidden of the width mode (as often as wanted)")
    a = ap.parse_args(argv)
    sampler = a.library == "fused_sampler"
    shapes = list(a.shape)
    if a.hidden:
        shapes.insert(0, (a.hidden, a.n_hidden))
    kernels = a.kernel or [FLAGSHIP_SAMPLER if shapes and sampler else KERNELS[a.library]]

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
    if shapes and not a.kernel and not sampler:
        kernels = []
        for h, nh in shapes:
            bwd_name = _layout_kernel(ft, fs.kernel_hidden(h), nh - 1, getattr(torch, a.dtype))
            fwd_name = _forward_kernel(bwd_name)
            kernels += [kn for kn in (bwd_name, fwd_name) if kn and kn not in kernels]
    libs, sass = _build_both(a.parent, kernels, a.library)
    for kernel in kernels:
        if a.out:
            a.out.mkdir(parents=True, exist_ok=True)
            for name in libs:
                (a.out / f"{name}_{kernel}.sass").write_text(sass[name, kernel])
        missing = [n for n in libs if not sass[n, kernel]]
        if missing and not (shapes and not sampler):
            print(f"no function matching {kernel!r} in the {' and '.join(missing)}'s build",
                  file=sys.stderr)
            return 1
        if missing:
            print(f"{kernel}: not in the {' and '.join(missing)}'s build, SASS not compared",
                  flush=True)
        else:
            pn, tn = normalized(sass["parent", kernel]), normalized(sass["tree", kernel])
            print(f"{kernel}: {len(pn)} and {len(tn)} instructions (branch targets aside), "
                  f"{differing(pn, tn)} lines differ", flush=True)
    for h, nh in shapes:
        a.hidden, a.n_hidden = h, nh
        rc = (_ab_sampler if sampler else _ab_width)(a, libs, card)
        if rc:
            return rc
    if shapes:
        return 0

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


def _layout_kernel(ft, h: int, nh1: int, dtype=None) -> str:
    """The mangled-name part of the tree's backward at (h, nh1) in
    ``dtype`` (bf16 by default)."""
    import torch

    if dtype == torch.float32:
        if ft.uses_f32(h, nh1, dtype):
            t = ft._f32_lib().dpfx_fused_train_f32_tile_points(h, nh1, 1)
            return f"bwd_f32ILi{h}ELi{t}E"
        return f"bwd_kernelILi{h}E"
    if ft.uses_cluster(h, nh1, torch.bfloat16):
        return f"bwd_clusterILi{h}ELi{nh1}E"
    return f"bwd_kernel_mmaILi{h}E"


def _forward_kernel(backward: str) -> Optional[str]:
    """The forward of the layout whose backward is ``backward`` (mangled
    name part), None for the f32 layout (``bwd_f32<H, T>``)."""
    if backward.startswith("bwd_f32"):
        return None
    return "fwd" + backward[3:]


# f32: a build may part from the f64 run of the plain version by this many
# times as far as the plain f32 version does, and always by the floor
# (chip_smoke.py's PROBE_F64_RATIO, TOL_F32 and PROBE_F64_FLOOR["full"])
F64_RATIO, F64_U_FLOOR, F64_GRAD_FLOOR, F32_LD_TOL = 4.0, 1e-4, 1e-3, 1e-5


def _ab_width(a, libs, card: str) -> int:
    """--hidden: the forward and the backward of both builds in turns."""
    import torch

    from dpfx_torch.compat import randomize_
    from dpfx_torch.models.coupling import CouplingFlow
    from dpfx_torch.ops import _build
    from dpfx_torch.ops import fused_sampler as fs
    from dpfx_torch.ops import fused_train as ft

    dev, k, b, n = torch.device("cuda"), 32, 64, 2048
    dt = getattr(torch, a.dtype)
    f32 = dt == torch.float32
    torch.backends.cuda.matmul.allow_tf32 = False
    kh = fs.kernel_hidden(a.hidden)
    torch.manual_seed(3)
    flow = randomize_(CouplingFlow(3, k, a.hidden, a.n_hidden, cond_dim=128, scale_cap=3.0), 3,
                      0.02 * (128 / kh) ** 0.5)
    with torch.no_grad():
        sp = fs.stack_point_flow_params(flow.to(dev))
    nh1 = sp.wh.shape[1]
    w = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
    g = torch.Generator(device=dev).manual_seed(3)
    xt = torch.randn((b, 3, n), generator=g, device=dev)
    z = torch.randn((b, 128), generator=g, device=dev)
    hz = fs.z_projection(sp, z)
    u_p, ld_p = ft.fused_forward_plain(*w, xt, hz, dt)
    du = torch.randn(u_p.shape, generator=g, device=dev)
    dld = torch.randn(ld_p.shape, generator=g, device=dev)
    plain = (u_p, ld_p, *ft.fused_backward_plain(*w, u_p, hz, du, dld, dt))
    if f32:
        w64 = tuple(t.double() if torch.is_tensor(t) else t for t in w)
        u64 = ft.fused_forward_plain(*w64, xt.double(), hz.double(), torch.float64)[0]
        ref64 = ft.fused_backward_plain(*w64, u_p.double(), hz.double(), du.double(),
                                        dld.double(), torch.float64)
    layout_of = ft._layout
    layouts = {"parent": None, "tree": None}
    tiles = {"parent": None, "tree": None}
    rows = {"parent": None, "tree": None}
    l2 = {}
    fwd = lambda: (_stream_forward(libs[cur[0]], w, xt, hz, dt)  # noqa: E731
                   if layouts[cur[0]] == "stream" else ft.fused_forward_kernel(*w, xt, hz, dt))
    bwd = lambda: (_stream_backward(libs[cur[0]], w, u_p, hz, du, dld, dt)  # noqa: E731
                   if layouts[cur[0]] == "stream"
                   else ft.fused_backward_kernel(*w, u_p, hz, du, dld, dt))
    cur = [None]

    def route(h, n_m1, dtype, backward):
        # a build without this tree's layout for the dtype (cluster in
        # bf16, f32 in f32), or whose cluster plan does not hold the
        # shape, took the stream layout wherever a block overflows
        lib = _build._loaded["fused_train"]
        newer = "dpfx_fused_train_f32_fwd" if dtype == torch.float32 else \
            "dpfx_fused_train_cluster_fwd"
        if not hasattr(lib, newer):
            return "stream" if ft.overflows_block(h, n_m1, dtype) else "parent"
        if (dtype == torch.bfloat16 and hasattr(lib, "dpfx_fused_train_stream_fwd")
                and ft.overflows_block(h, n_m1, dtype) and not ft.uses_cluster(h, n_m1, dtype)):
            return "stream"
        return layout_of(h, n_m1, dtype, backward)

    def use(name):
        for fn in (ft._lib, ft._cluster_lib, ft._cluster_grid, ft._f32_lib):
            fn.cache_clear()
        lib = libs[name]
        if hasattr(lib, "dpfx_fused_train_cluster_fwd") and not hasattr(
                lib, "dpfx_fused_train_cluster_part_row"):
            # a build before the walk: its partial rows are not padded
            lib.dpfx_fused_train_cluster_part_row = _unpadded_row
        _build._loaded["fused_train"] = lib
        cur[0] = name
        layouts[name] = route(kh, nh1, dt, True)
        # points a forward block and a backward tile take, the partial row
        tiles[name] = tuple(_tile_points(lib, ft, dt, bw, layouts[name], (kh, nh1))
                            for bw in (False, True))
        rows[name] = (lib.dpfx_fused_train_cluster_part_row(kh, nh1)
                      if layouts[name] == "cluster" else _unpadded_row(kh, nh1))
        if layouts[name] == "cluster":
            ring = rows[name] != _unpadded_row(kh, nh1)
            l2[name] = _cluster_l2_bytes(kh, nh1, b, n, k, tiles[name][1],
                                         ft._cluster_grid(kh, nh1, True, 0), ring)

    def rel(x, r):
        return float((x.double() - r.double()).norm() / r.double().norm().clamp_min(1e-12))

    def held(name, out) -> bool:
        """The build's first outputs against the plain versions."""
        if not all(bool(torch.isfinite(t).all()) for t in out):
            return False
        if not f32:
            e = (out[0] - u_p).abs().flatten()
            emax = float(e.max())
            e999 = float(torch.quantile(e[::max(1, e.numel() // 2**24)], 0.999))
            errs = [rel(x, r) for x, r in zip(out[1:], plain[1:]) if r.numel()]
            print(f"{name} ({layouts[name]} layout) against the plain versions: u max "
                  f"{emax:.3e} p99.9 {e999:.3e}; log-det and gradients rel "
                  + " ".join(f"{v:.2e}" for v in errs), flush=True)
            return emax <= 5e-2 and e999 <= 2e-3 and max(errs) <= 2e-2
        ku = float((out[0].double() - u64).abs().max())
        du_ = float((u_p.double() - u64).abs().max())
        ld_err = rel(out[1], ld_p)
        ok = ku <= max(F64_U_FLOOR, F64_RATIO * du_) and ld_err <= F32_LD_TOL
        parts = []
        for x, r, r64 in zip(out[2:], plain[2:], ref64):
            if not r64.numel():
                continue
            kern, drift = rel(x, r64), rel(r, r64)
            ok = ok and kern <= max(F64_GRAD_FLOOR, F64_RATIO * drift)
            parts.append(f"{kern:.2e}/{drift:.2e}")
        print(f"{name} ({layouts[name]} layout) against the f64 run: u max abs {ku:.3e} (the f32 "
              f"plain version's {du_:.3e}); log-det rel to the f32 plain version {ld_err:.2e}; "
              "gradients rel (kernel/plain f32) " + " ".join(parts), flush=True)
        return ok

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    firsts, times = {}, {nm: {"fwd": [], "bwd": []} for nm in libs}
    order = list(libs)
    try:
        for turn in range(a.turns):
            for name in order if turn % 2 == 0 else order[::-1]:
                use(name)
                out = (*fwd(), *bwd())
                torch.cuda.synchronize()
                if name not in firsts:
                    firsts[name] = [t.clone() for t in out]
                    if not held(name, out):
                        print(f"the {name}'s outputs are off the plain versions", file=sys.stderr)
                        return 1
                if not all(torch.equal(x, y) for x, y in zip(out, firsts[name])):
                    print(f"the {name}'s outputs differ from call to call", file=sys.stderr)
                    return 1
                for key, fn, calls in (("fwd", fwd, 10), ("bwd", bwd, 5)):
                    fn()
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(calls):
                        fn()
                    end.record()
                    torch.cuda.synchronize()
                    times[name][key].append(round(start.elapsed_time(end) / calls, 4))
    finally:
        for fn in (ft._lib, ft._cluster_lib, ft._cluster_grid, ft._f32_lib):
            fn.cache_clear()
        _build._loaded.pop("fused_train", None)
    medians = {nm: {kk: round(statistics.median(v), 4) for kk, v in t.items()}
               for nm, t in times.items()}
    fp, ft_ = firsts["parent"], firsts["tree"]
    if not f32:
        # on one layout: the per-point sums always, the sums over a tile's
        # points where both take the same tiles, dWh where both also sum it
        # the same way (the ring's backward pads the partial row)
        same = layouts["parent"] == layouts["tree"]
        same_fwd = same and tiles["parent"][0] == tiles["tree"][0]
        same_bwd = same and tiles["parent"][1] == tiles["tree"][1]
        names = ["u", "log-det", "dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"]
        want = dict(zip(names, [same, same_fwd, same, same_bwd, same_bwd,
                                same_bwd and rows["parent"] == rows["tree"], same_bwd, same_bwd,
                                same_bwd]))
        got = {nm: torch.equal(x, y) for nm, x, y in zip(names, fp, ft_)}
        print("the two builds' bits (same, where the arithmetic is the same): "
              + json.dumps({kk: f"{got[kk]} (required: {want[kk]})" for kk in names}),
              flush=True)
        if any(want[kk] and not got[kk] for kk in names):
            print("the two builds differ where their arithmetic is the same", file=sys.stderr)
            return 1
        verdict = ("same bits" if all(got.values()) else
                   "each within the plain versions' limits, same bits run to run, the same bits "
                   "where the arithmetic is the same")
    else:
        # the same arithmetic: u always; the log-det at the same points per
        # forward block; the gradients at the same backward tile in the
        # stream or f32 design
        design = {nm: "streamed" if lay in ("stream", "f32") else lay
                  for nm, lay in layouts.items()}
        same_ld = tiles["parent"][0] == tiles["tree"][0]
        same_bwd = tiles["parent"][1] == tiles["tree"][1] and design["parent"] == design["tree"]
        got = {"u": torch.equal(fp[0], ft_[0]), "log-det": torch.equal(fp[1], ft_[1]),
               "gradients": all(torch.equal(x, y) for x, y in zip(fp[2:], ft_[2:]))}
        want = {"u": True, "log-det": same_ld, "gradients": same_bwd}
        print("the two builds' bits (same, where the arithmetic is the same): "
              + json.dumps({kk: f"{got[kk]} (required: {want[kk]})" for kk in got})
              + f"; log-det rel between the builds {rel(ft_[1], fp[1]):.2e}", flush=True)
        if any(want[kk] and not got[kk] for kk in got):
            print("the two builds differ where their arithmetic is the same", file=sys.stderr)
            return 1
        for name in order:
            back = fs.fused_inverse_transposed(sp, firsts[name][0], z, dtype=dt)
            torch.cuda.synchronize()
            e = (back - xt).abs().flatten()
            print(f"round trip {name}'s forward ({layouts[name]} layout) -> this tree's f32 "
                  f"sampler (f32_kernel) on the same hz: median {float(e.median()):.3e} max "
                  f"{float(e.max()):.3e}", flush=True)
        verdict = "same bits where the arithmetic is the same, each held to the f64 run"
    for name, (slabs, slices) in l2.items():
        print(f"{name}'s cluster backward, modelled L2 traffic (not measured): Wh slabs read "
              f"{slabs / 1e9:.2f} GB, dWh slices read and written {slices / 1e9:.2f} GB", flush=True)
    print(f"fused_forward_kernel / fused_backward_kernel B={b} N={n} K={k} H={a.hidden}->{kh} "
          f"n_hidden={a.n_hidden} {a.dtype}, layouts {json.dumps(layouts)}, points a forward "
          f"block / backward tile {json.dumps(tiles)}, ms in turns ({card}): {json.dumps(times)}; "
          f"medians {json.dumps(medians)}; {verdict}")
    return 0


def _cluster_l2_bytes(h: int, nh1: int, b: int, n: int, k: int, t: int, clusters: int,
                      ring: bool) -> Tuple[int, int]:
    """The cluster backward's weight traffic through L2, from its design
    (not a measurement): each CTA reads its row and column slab of every
    matrix (64 x H bf16 each) once a layer on whole-layer stages, once a
    tile on the ring; on the ring it also reads and writes its slice (H x
    64 f32) of each matrix the registers do not hold (all but 256 // H)
    every tile but the first of its cluster, which only writes. Returns
    (slab bytes, slice bytes)."""
    tiles, c = b * ((n + t - 1) // t), h // 64
    slab = 2 * nh1 * 64 * h * 2
    if not ring:
        return k * clusters * c * slab, 0
    spilled = max(nh1 - 256 // h, 0) * 64 * h * 4
    return k * tiles * c * slab, k * c * spilled * (2 * tiles - clusters)


def _unpadded_row(h: int, nh1: int) -> int:
    """Floats of a layer's weight-gradient partial, unpadded."""
    return 3 * h + nh1 * h * h + nh1 * h + 6 * h + 6


def _tile_points(lib, ft, dt, backward: bool, layout: str, shape) -> int:
    """Points a forward block or a backward tile of ``layout`` takes in the
    build whose library is ``lib`` (loaded)."""
    import torch

    if layout == "stream":
        fn = lib.dpfx_fused_train_stream_tile_points
        fn.argtypes = [ctypes.c_int] * 4
        fn.restype = ctypes.c_int
        return fn(*shape, int(dt == torch.bfloat16), int(backward))
    return (1 << 20) // ft._tiles(1 << 20, dt, backward, layout, shape)


def _stream_forward(lib, w, xt, hz, dt):
    """A build's stream-layout forward (the layout that build's wrapper
    took where a block overflows), called through its C interface."""
    import torch

    wx, wh, bh, wout, bout, masks, cap = w
    k, h, _ = wx.shape
    nh1 = wh.shape[1]
    b, _, n = xt.shape
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.dpfx_fused_train_stream_fwd
    fn.argtypes = [p] * 10 + [i] * 5 + [f, i, p]
    fn.restype = ctypes.c_int
    bf = int(dt == torch.bfloat16)
    t = _tile_points(lib, None, dt, False, "stream", (h, nh1))
    u = torch.empty_like(xt)
    ld_part = torch.empty((b, (n + t - 1) // t), device=xt.device, dtype=torch.float32)
    cw = [v.to(dt).contiguous() for v in (wx, wh, wout)]
    err = fn(xt.data_ptr(), hz.data_ptr(), u.data_ptr(), ld_part.data_ptr(), cw[0].data_ptr(),
             cw[1].data_ptr() if nh1 else None, bh.data_ptr() if nh1 else None, cw[2].data_ptr(),
             bout.data_ptr(), masks.data_ptr(), b, n, k, h, nh1, float(cap), bf,
             torch.cuda.current_stream(xt.device).cuda_stream)
    if err:
        raise RuntimeError(f"the stream forward failed: cudaError {err}")
    return u, ld_part.sum(1)


def _stream_backward(lib, w, u, hz, du, dld, dt):
    """A build's stream-layout backward through its C interface: (dx, dhz,
    dwx, dwh, dbh, dwout, dbout), as ``fused_backward_kernel`` returns them."""
    import torch

    wx, wh, bh, wout, bout, masks, cap = w
    k, h, _ = wx.shape
    nh1 = wh.shape[1]
    b, _, n = u.shape
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    fn = lib.dpfx_fused_train_stream_bwd
    fn.argtypes = [p] * 15 + [i] * 5 + [f, i, i, p]
    fn.restype = ctypes.c_int
    bf = int(dt == torch.bfloat16)
    dev = u.device
    t = _tile_points(lib, None, dt, True, "stream", (h, nh1))
    nt = (n + t - 1) // t
    blocks = min(b * nt, torch.cuda.get_device_properties(dev).multi_processor_count)
    per_layer = _unpadded_row(h, nh1)
    part = torch.empty((blocks, k, per_layer), device=dev, dtype=torch.float32)
    dhz_part = torch.empty((b, nt, k, h), device=dev, dtype=torch.float32)
    wacc = torch.empty((blocks, nh1, h, h), device=dev, dtype=torch.float32)
    dw = torch.empty((k, per_layer), device=dev, dtype=torch.float32)
    dhz = torch.empty((b, k, h), device=dev, dtype=torch.float32)
    y, dx = u.clone(), du.clone()
    cw = [v.to(dt).contiguous() for v in (wx, wh, wout)]
    err = fn(y.data_ptr(), dx.data_ptr(), dld.data_ptr(), hz.data_ptr(), cw[0].data_ptr(),
             cw[1].data_ptr() if nh1 else None, bh.data_ptr() if nh1 else None, cw[2].data_ptr(),
             bout.data_ptr(), masks.data_ptr(), part.data_ptr(), dhz_part.data_ptr(),
             wacc.data_ptr() if nh1 else None, dw.data_ptr(), dhz.data_ptr(), b, n, k, h, nh1,
             float(cap), bf, blocks, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"the stream backward failed: cudaError {err}")
    sizes = [3 * h, nh1 * h * h, nh1 * h, 6 * h, 6]
    shapes = [(h, 3), (nh1, h, h), (nh1, h), (6, h), (6,)]
    parts = torch.split(dw, sizes, dim=1)
    return (dx, dhz, *(t.reshape(k, *sh) for t, sh in zip(parts, shapes)))


def _ab_sampler(a, libs, card: str) -> int:
    """--library fused_sampler --hidden: the sampler of both builds in turns,
    bf16 and f32."""
    import torch

    from dpfx_torch.compat import randomize_
    from dpfx_torch.models.coupling import CouplingFlow
    from dpfx_torch.ops import _build
    from dpfx_torch.ops import fused_sampler as fs

    dev, k, b, n = torch.device("cuda"), 32, 64, 2048
    torch.backends.cuda.matmul.allow_tf32 = False
    kh = fs.kernel_hidden(a.hidden)
    torch.manual_seed(3)
    flow = randomize_(CouplingFlow(3, k, a.hidden, a.n_hidden, cond_dim=128, scale_cap=3.0), 3,
                      0.02 * (128 / kh) ** 0.5)
    with torch.no_grad():
        sp = fs.stack_point_flow_params(flow.to(dev))
    nh1 = sp.wh.shape[1]
    z = torch.randn((b, 128), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    hz = fs.z_projection(sp, z)
    dts = {"bf16": torch.bfloat16, "f32": torch.float32}
    layout_of = fs.inverse_layout
    layouts = {nm: {} for nm in libs}

    def before_cluster(h, n_m1, dtype, activation="relu", int8=False):
        # a build without this tree's cluster launch (none, or one without
        # the activation and int8 arguments): rows_kernel for every bf16 shape
        return "f32" if dtype != torch.bfloat16 else "rows"

    def use(name):
        for fn in (fs._lib, fs._cluster_lib, fs._cluster_grid):
            fn.cache_clear()
        _build._loaded["fused_sampler"] = libs[name]
        has_cluster = hasattr(libs[name], "dpfx_fused_sampler_cluster_built")
        fs.inverse_layout = layout_of if has_cluster else before_cluster
        for key, dt in dts.items():
            layouts[name][key] = fs.inverse_layout(kh, nh1, dt)

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    firsts, times = {}, {nm: {key: [] for key in dts} for nm in libs}
    order = list(libs)
    try:
        for turn in range(a.turns):
            for name in order if turn % 2 == 0 else order[::-1]:
                use(name)
                for key, dt in dts.items():
                    run = lambda: fs.fused_sample_points(sp, z, 5, n, dtype=dt)  # noqa: E731
                    x, u = fs.fused_sample_points(sp, z, 5, n, dtype=dt, return_noise=True)
                    torch.cuda.synchronize()
                    if (name, key) not in firsts:
                        firsts[name, key] = x.clone()
                        xp = fs.fused_inverse_transposed_plain(
                            sp, u.transpose(1, 2).contiguous(), hz, dt).transpose(1, 2)
                        e = (x - xp).abs().flatten()
                        emax, e999 = float(e.max()), float(torch.quantile(e, 0.999))
                        print(f"{name} {key} ({layouts[name][key]} layout) against the plain "
                              f"inverse of its noise: max {emax:.3e} p99.9 {e999:.3e}", flush=True)
                        ok = bool(torch.isfinite(x).all()) and (
                            key == "f32" or (emax <= 5e-2 and e999 <= 2e-3))
                        if not ok:
                            print(f"the {name}'s {key} clouds are off the plain version",
                                  file=sys.stderr)
                            return 1
                    if not torch.equal(x, firsts[name, key]):
                        print(f"the {name}'s {key} clouds differ from call to call",
                              file=sys.stderr)
                        return 1
                    run()
                    torch.cuda.synchronize()
                    start.record()
                    for _ in range(5):
                        run()
                    end.record()
                    torch.cuda.synchronize()
                    times[name][key].append(round(start.elapsed_time(end) / 5, 4))
    finally:
        fs.inverse_layout = layout_of
        for fn in (fs._lib, fs._cluster_lib, fs._cluster_grid):
            fn.cache_clear()
        _build._loaded.pop("fused_sampler", None)
    for key in dts:
        same = layouts["parent"][key] == layouts["tree"][key]
        if (key == "f32" or same) and not torch.equal(firsts["parent", key], firsts["tree", key]):
            print(f"the two builds' {key} clouds differ on the same layout", file=sys.stderr)
            return 1
    medians = {nm: {kk: round(statistics.median(v), 4) for kk, v in t.items()}
               for nm, t in times.items()}
    print(f"fused_sample_points B={b} N={n} K={k} H={a.hidden}->{kh} n_hidden={a.n_hidden}, "
          f"layouts {json.dumps(layouts)}, ms in turns ({card}): {json.dumps(times)}; medians "
          f"{json.dumps(medians)}; f32 same bits; bf16 "
          + ("same bits" if layouts["parent"]["bf16"] == layouts["tree"]["bf16"]
             else "each within the plain version's limits, same bits run to run"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
