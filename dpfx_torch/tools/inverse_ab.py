"""The bf16 sampler's cluster inverse against rows_kernel, case by case, in
turns: on this tree's library and on variant builds of the same sources.

    python -m dpfx_torch.tools.inverse_ab [--variant NAME=DIR ...]
        [--shape H:L ...] [--case ACT[+int8] ...] [--b 64] [--n 2048] [--k 32]
        [--turns 2] [--reps 5] [--device cpu]

Each ``--variant NAME=DIR`` compiles ``DIR/fused_sampler.cu`` (a patched
copy of ``dpfx_torch/ops/csrc`` under ``build/``, say) with the flags of
``dpfx_torch/ops/_build.py`` into ``build/inverse_ab/NAME``, all at once.
For each shape (H, n_hidden; default 256:4) and case (an activation, with
``+int8`` for int8 weights; default relu) ``fused_sample_points`` runs at
B x N points, K layers, on seeded random weights (noise 0.02 scaled by
sqrt(128 / H)): on the cluster inverse of the tree and of each variant that
builds the case (``dpfx_fused_sampler_cluster_built``), whatever the route
takes, and on rows_kernel. Every cluster run is held to the plain inverse of
its own noise (on the dequantized stacks for int8) at phase 2's bf16 limits
(max 5e-2, p99.9 2e-3), must repeat its bits, and must have the tree's bits;
an int8 run must also equal, bit for bit, the bf16 mode on the dequantized
stacks on the same layout. Then each side is timed with CUDA events (reps
calls after 2 warm-up calls) in turns, the order reversed every other turn,
and one line a case gives the mean of each side's turns, the card's name and
its power limit. On the CPU (``--device cpu``) every side is the plain
version and the times are the host's: a check of the tool, not a
measurement. The last line is the kernels' launch counts.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path
from typing import Dict, List, Tuple


def _shape(text: str) -> Tuple[int, int]:
    try:
        h, nh = (int(v) for v in text.split(":"))
    except ValueError:
        raise argparse.ArgumentTypeError(f"{text!r} is not H:L") from None
    return h, nh


def _case(text: str) -> Tuple[str, bool]:
    act, _, mode = text.partition("+")
    if act not in ("relu", "gelu", "tanh", "leaky_relu") or mode not in ("", "int8"):
        raise argparse.ArgumentTypeError(f"{text!r} is not ACT or ACT+int8 (ACT relu, gelu, tanh "
                                         "or leaky_relu)")
    return act, mode == "int8"


def _variant(text: str) -> Tuple[str, Path]:
    name, sep, path = text.partition("=")
    if not sep or not name or name in ("tree", "rows"):
        raise argparse.ArgumentTypeError(f"{text!r} is not NAME=DIR (NAME not tree or rows)")
    return name, Path(path)


def start_variants(variants: List[Tuple[str, Path]]) -> Dict[str, subprocess.Popen]:
    """Start one nvcc a variant: its fused_sampler.cu into
    build/inverse_ab/NAME/libfused_sampler.so."""
    from dpfx_torch.ops import _build

    procs = {}
    for name, src in variants:
        d = _build.BUILD_DIR.parent / "inverse_ab" / name
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(src, d)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler",
             "-fPIC", "-Xptxas", "-v", "-o", str(d / "libfused_sampler.so"),
             str(d / "fused_sampler.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return procs


def finish_variants(procs: Dict[str, subprocess.Popen]) -> Dict[str, ctypes.CDLL]:
    """Wait for the variants' builds and load them; raises with the log of a
    failed one."""
    from dpfx_torch.ops import _build

    libs = {}
    for name, p in procs.items():
        log, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log[-3000:]}")
        libs[name] = ctypes.CDLL(str(_build.BUILD_DIR.parent / "inverse_ab" / name
                                     / "libfused_sampler.so"))
    return libs


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variant", action="append", default=[], type=_variant,
                    help="NAME=DIR: a directory whose fused_sampler.cu is built and timed too")
    ap.add_argument("--shape", action="append", default=[], type=_shape,
                    help="H:L, a point-flow width and n_hidden (default 256:4)")
    ap.add_argument("--case", action="append", default=[], type=_case,
                    help="ACT or ACT+int8 (default relu)")
    ap.add_argument("--b", type=int, default=64)
    ap.add_argument("--n", type=int, default=2048)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--turns", type=int, default=2)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    a = ap.parse_args(argv)

    import torch

    from dpfx_torch.compat import randomize_
    from dpfx_torch.device import resolve_device
    from dpfx_torch.models.coupling import CouplingFlow
    from dpfx_torch.ops import _build
    from dpfx_torch.ops import fused_sampler as fs
    from dpfx_torch.tools._common import card, launches_line
    from dpfx_torch.utils.profiling import time_fn

    dev = resolve_device(a.device)
    cuda = dev.type == "cuda"
    bf = torch.bfloat16
    torch.backends.cuda.matmul.allow_tf32 = False
    if a.variant and not cuda:
        print("variants are built for the card only", file=sys.stderr)
        return 1
    procs = start_variants(a.variant)   # beside the tree's own build, where it is stale
    libs = {"tree": _build.load("fused_sampler") if cuda else None, **finish_variants(procs)}
    route, cluster_lib = fs.inverse_layout, fs._cluster_lib
    order = list(libs)

    def use(name: str, layout: str, act: str, int8: bool) -> bool:
        """Route the case onto ``layout`` of library ``name``; False where
        that library does not build the case."""
        if cuda:
            _build._loaded["fused_sampler"] = libs[name]
            for fn in (fs._lib, fs._cluster_lib, fs._cluster_grid):
                fn.cache_clear()
        fs.inverse_layout = lambda h, nh1, dtype, activation="relu", q8=False: (
            "f32" if dtype != bf else layout)
        if layout == "cluster" and cuda:
            built = getattr(fs._cluster_lib(), "dpfx_fused_sampler_cluster_built", None)
            return built is not None and built(h_, nh1_, fs.ACT_CODES[act], int(int8)) == 1
        return True

    def errors(x, ref) -> Tuple[float, float]:
        e = (x - ref).abs().flatten().float()
        return float(e.max()), float(torch.quantile(e[:: max(1, e.numel() // 2**24)], 0.999))

    ok = True
    try:
        for hidden, n_hidden in a.shape or [(256, 4)]:
            torch.manual_seed(hidden + n_hidden)
            kh = fs.kernel_hidden(hidden)
            flow = CouplingFlow(3, a.k, hidden, n_hidden, cond_dim=128, scale_cap=3.0)
            randomize_(flow, hidden + n_hidden, 0.02 * (128 / kh) ** 0.5)
            with torch.no_grad():
                sp = fs.stack_point_flow_params(flow.to(dev))
            h_, nh1_ = sp.wx.shape[1], sp.wh.shape[1]
            q = fs.quantize_flow_params(sp)
            dq = fs.dequantize(q)
            spd = sp._replace(wx=dq.wx, wh=dq.wh, wout=dq.wout)
            z = torch.randn((a.b, 128), generator=torch.Generator(device=dev).manual_seed(5),
                            device=dev)
            hz = fs.z_projection(sp, z)
            for act, int8 in a.case or [("relu", False)]:
                qq = q if int8 else None
                tag = f"H={hidden}->{h_} n_hidden={n_hidden} {act}{' int8' if int8 else ''}"
                run = lambda: fs.fused_sample_points(  # noqa: E731
                    sp, z, 12, a.n, dtype=bf, activation=act, quantized=qq)
                sides, first = [], None
                for name in order:
                    if not use(name, "cluster", act, int8):
                        print(f"{tag}: {name} does not build the case", flush=True)
                        continue
                    x, u = fs.fused_sample_points(sp, z, 11, a.n, dtype=bf, activation=act,
                                                  quantized=qq, return_noise=True)
                    x2 = fs.fused_sample_points(sp, z, 11, a.n, dtype=bf, activation=act,
                                                quantized=qq)
                    ref = fs.fused_inverse_transposed_plain(
                        spd if int8 else sp, u.transpose(1, 2).contiguous(), hz, bf,
                        act).transpose(1, 2)
                    same8 = True
                    if int8:
                        same8 = torch.equal(x, fs.fused_sample_points(spd, z, 11, a.n, dtype=bf,
                                                                      activation=act))
                    emax, e999 = errors(x, ref)
                    first = x if first is None else first
                    good = (bool(torch.isfinite(x).all()) and emax <= 5e-2 and e999 <= 2e-3
                            and torch.equal(x, x2) and same8 and torch.equal(x, first))
                    ok &= good
                    print(f"{tag}: {name} cluster against the plain inverse of its noise: max "
                          f"{emax:.3e} p99.9 {e999:.3e}; repeats its bits {torch.equal(x, x2)}"
                          + (f"; int8 = bf16 on the dequantized stacks {same8}" if int8 else "")
                          + f"; the first side's bits {torch.equal(x, first)}", flush=True)
                    sides.append((name, "cluster"))
                sides.append((order[0], "rows"))
                ms = {f"{n} {lay}": [] for n, lay in sides}
                for turn in range(a.turns):
                    for name, lay in sides if turn % 2 == 0 else sides[::-1]:
                        use(name, lay, act, int8)
                        ms[f"{name} {lay}"].append(
                            time_fn(run, reps=a.reps, warmup=2)["mean_s"] * 1e3)
                print(f"{tag} B={a.b} N={a.n} K={a.k} bf16, ms in turns: "
                      + ", ".join(f"{k} {sum(v) / len(v):.3f}" for k, v in ms.items())
                      + f" ({card(dev)})", flush=True)
    finally:
        fs.inverse_layout, fs._cluster_lib = route, cluster_lib
        if cuda:
            _build._loaded.pop("fused_sampler", None)
            for fn in (fs._lib, fs._cluster_lib, fs._cluster_grid):
                fn.cache_clear()
    print(launches_line())
    if not ok:
        print("a cluster run is off its plain version, its own bits or the first side's",
              file=sys.stderr)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
