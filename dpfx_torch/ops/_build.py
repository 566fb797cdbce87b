"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles on its own into
``build/dpfx_torch_kernels/lib<name>.so`` at the repository root (listed in
``.gitignore``), for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas -v -o build/dpfx_torch_kernels/lib<name>.so csrc/<name>.cu

A library is rebuilt when it is missing or older than its source or any
shared ``csrc/*.cuh`` header. The build
runs at first use, never at import. ``build_all`` starts one nvcc per source,
all together, and waits for them.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dpfx_torch_kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
SMEM_LIMIT = 232448    # bytes of shared memory a block may use (sm_90); the wrappers check it

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> List[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels build only where the CUDA toolkit is installed")


def _paths(name: str):
    return CSRC / f"{name}.cu", BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    """Missing, or older than its source or any shared header in csrc/."""
    src, lib = _paths(name)
    if not lib.exists():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def _start(name: str) -> subprocess.Popen:
    src, lib = _paths(name)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           "-Xptxas", "-v", "-o", str(tmp), str(src)]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def _finish(name: str, proc: subprocess.Popen) -> str:
    log, _ = proc.communicate()
    _, lib = _paths(name)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{log}")
    os.replace(tmp, lib)   # atomic: a concurrent loader never sees half a file
    lib.with_suffix(".log").write_text(log)
    return log


def build_all(force: bool = False) -> Dict[str, float]:
    """Compile every stale source, one nvcc each, all started together, and
    wait for all of them. Returns the seconds each build took (0.0 where
    nothing was stale); raises with every failed build's log."""
    names = [n for n in sources() if force or _stale(n)]
    t0 = time.perf_counter()
    procs = {n: _start(n) for n in names}
    out = {n: 0.0 for n in sources()}
    failed = []
    for n, p in procs.items():
        try:
            _finish(n, p)
        except RuntimeError as e:
            failed.append(str(e))
        out[n] = time.perf_counter() - t0
    if failed:
        raise RuntimeError("\n\n".join(failed))
    return out


def load(name: str) -> ctypes.CDLL:
    """The ctypes handle of ``lib<name>.so``, built first if stale."""
    if name not in _loaded:
        if _stale(name):
            _finish(name, _start(name))
        _loaded[name] = ctypes.CDLL(str(_paths(name)[1]))
    return _loaded[name]


def ptxas_log(name: str) -> str:
    """What ``-Xptxas -v`` said about the last build (registers, spills)."""
    log = _paths(name)[1].with_suffix(".log")
    return log.read_text() if log.exists() else ""
