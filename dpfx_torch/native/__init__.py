"""ctypes bindings and the build of the native C++ batch loader
(``src/dpfx_loader.cpp``), the port's counterpart of ``dpfx/native``.

The library builds at first use, never at import, with

    g++ -O3 -std=c++17 -shared -fPIC -pthread src/dpfx_loader.cpp \\
        -o build/dpfx_torch_native/libdpfx_loader_<source hash>.so

at the repository root (``build/`` is listed in ``.gitignore``). The
compiler writes a temporary name that ``os.replace`` moves into place, so
processes that build at once never load half a file. A failed build
raises with the compiler's stderr: the port does not fall back to another
loader behind the caller's back.
"""

from __future__ import annotations

import ctypes
import hashlib
import json
import os
import subprocess
import threading
from pathlib import Path
from typing import Iterator, Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "src" / "dpfx_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "dpfx_torch_native"
CXX = "g++"
FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib: Optional[ctypes.CDLL] = None
_build_err: Optional[str] = None


def lib_path() -> Path:
    """Where the library of the current source lives, keyed by its hash."""
    h = hashlib.sha256(SRC.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libdpfx_loader_{h}.so"


def build_native() -> str:
    """Compile the loader unless its library exists; returns the path.
    Raises RuntimeError with the compiler's output when the build fails."""
    global _build_err
    path = lib_path()
    if path.exists():
        return str(path)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.name}.{os.getpid()}.{threading.get_ident()}.tmp")
    cmd = [CXX, *FLAGS, str(SRC), "-o", str(tmp)]
    try:
        out = subprocess.run(cmd, capture_output=True, text=True, timeout=180)
    except (OSError, subprocess.TimeoutExpired) as e:
        _build_err = f"{' '.join(cmd)}: {e}"
        raise RuntimeError(f"native loader build failed: {_build_err}") from e
    if out.returncode != 0:
        tmp.unlink(missing_ok=True)
        _build_err = out.stderr
        raise RuntimeError(f"native loader build failed (exit {out.returncode}): "
                           f"{' '.join(cmd)}\n{out.stderr}")
    os.replace(tmp, path)
    return str(path)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(build_native())
    lib.dpfx_batcher_open.restype = ctypes.c_void_p
    lib.dpfx_batcher_open.argtypes = [
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int,
        ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
    ]
    lib.dpfx_batcher_shape.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_int64)]
    lib.dpfx_batcher_next.argtypes = [ctypes.c_void_p, ctypes.POINTER(ctypes.c_float)]
    lib.dpfx_batcher_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    """Whether the loader builds and loads here (``build_error()`` says why not)."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def build_error() -> Optional[str]:
    """The last failed build's compiler output, or None."""
    return _build_err


class NativeBatcher:
    """Threaded native batch producer over a packed ``.npy`` cloud stack
    (``python -m dpfx_torch.tools.pack_dataset``). Yields ``{"x": [B,
    n_points, 3]}`` as ``dpfx_torch.data.iterate_batches`` does, with the
    batches made off the Python thread; the same batches as
    ``dpfx.native.NativeBatcher`` for the same seed at ``n_workers=1`` (with
    more workers the order in which they claim items depends on scheduling).

    ``normalize`` defaults to ``"none"``: a stack written by the pack tool
    already carries the dataset's normalization, which its sidecar
    ``<path>.meta.json`` records, and a second one requested here raises.
    The native ``per_shape`` normalizes after the subsample, unlike the
    Python datasets, which normalize the whole stored cloud."""

    def __init__(self, npy_path: str, batch_size: int, n_points: int, normalize: str = "none",
                 seed: int = 0, n_workers: int = 4):
        lib = _load()
        meta_path = npy_path + ".meta.json"
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                pre = json.load(f).get("normalize_applied", "none")
            if pre != "none" and normalize != "none":
                raise ValueError(
                    f"packed stack {npy_path} was written with normalize={pre!r} already "
                    f"applied (per its sidecar {meta_path}); requesting normalize={normalize!r} "
                    "here would double-normalize — pass normalize='none'")
        self._lib = lib
        err = ctypes.create_string_buffer(512)
        norm = {"none": 0, "per_shape": 1}[normalize]
        self._h = lib.dpfx_batcher_open(npy_path.encode(), batch_size, n_points, norm, seed,
                                        n_workers, err, 512)
        if not self._h:
            raise RuntimeError(f"dpfx_batcher_open: {err.value.decode()}")
        shape = (ctypes.c_int64 * 3)()
        lib.dpfx_batcher_shape(self._h, shape)
        self.n_items, self.n_stored, self.n_coords = map(int, shape)
        self.batch_size, self.n_points = batch_size, n_points
        self._buf = np.empty((batch_size, n_points, self.n_coords), np.float32)

    def next(self) -> np.ndarray:
        """The next batch, a copy: the loader reuses one buffer."""
        if not self._h:
            raise RuntimeError("NativeBatcher.next() after close()")
        self._lib.dpfx_batcher_next(self._h,
                                    self._buf.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
        return self._buf.copy()

    def __iter__(self) -> Iterator[dict]:
        while True:
            yield {"x": self.next()}

    def close(self) -> None:
        """Stop and join the worker threads and unmap the stack."""
        if self._h:
            self._lib.dpfx_batcher_close(self._h)
            self._h = None

    def __del__(self):  # pragma: no cover
        try:
            self.close()
        except Exception:
            pass


__all__ = ["NativeBatcher", "build_error", "build_native", "lib_path", "native_available"]
