"""Per-kernel device time from a Chrome trace that
``dpfx_torch.utils.profiling.trace`` wrote (the counterpart of the JAX
package's ``tools/parse_xplane.py``).

    python -m dpfx_torch.tools.parse_trace TRACE_DIR [n_steps] [top_k]

``TRACE_DIR`` is a directory (the newest ``*.json`` under it is read) or a
trace file. ``n_steps`` divides the totals (pass the number of identical
steps the trace holds) so that they read per step; ``top_k`` (25) bounds
the kernel table. It prints the device total in ms per step, the top-k
kernels with their ms and their count per step, and a rollup by the
largest input shape of the op that launched each kernel: a kernel event
names its launching op through its ``External id`` (or its runtime call's,
joined by the correlation id), and the op's ``Input Dims`` are recorded
with ``record_shapes=True``. Kernels that no op launched (a ctypes launch,
a CUDA graph's replay) roll up under ``(no op)``.

Device time is the device's own events: kernels, and the copies and sets
the card runs. A trace with no kernel event raises, naming the event
categories it holds; the host's ops are never reported as device time.
"""

from __future__ import annotations

import collections
import json
import math
import sys
from pathlib import Path
from typing import Dict, List, Tuple

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(path: str) -> List[dict]:
    """The events of the newest ``*.json`` under a directory, or of a file."""
    p = Path(path)
    if p.is_dir():
        found = sorted(p.rglob("*.json"), key=lambda f: f.stat().st_mtime)
        if not found:
            raise FileNotFoundError(f"no *.json trace under {path}")
        p = found[-1]
    with open(p) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def _largest_shape(dims) -> str:
    shapes = [d for d in dims or [] if isinstance(d, list) and d
              and all(isinstance(v, int) for v in d)]
    if not shapes:
        return "scalar"
    return "[" + ",".join(map(str, max(shapes, key=math.prod))) + "]"


def aggregate(events: List[dict]) -> Tuple[Dict[str, float], Dict[str, int], Dict[str, float]]:
    """(ms per device event name, count per name, ms per launching op's
    largest input shape). Raises if the events hold no kernel."""
    dev = [e for e in events if e.get("ph") == "X"
           and str(e.get("cat", "")).lower() in DEVICE_CATEGORIES]
    if not any(str(e.get("cat", "")).lower() == "kernel" for e in dev):
        cats = collections.Counter(str(e.get("cat")) for e in events if e.get("ph") == "X")
        raise RuntimeError(f"the trace holds no device kernel events (categories: "
                           f"{dict(cats) or 'none'}); it was not taken with the CUDA activity "
                           "on a card")
    ops = {e["args"]["External id"]: e for e in events
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"
           and "External id" in e.get("args", {})}
    runtime_ext = {e["args"]["correlation"]: e["args"].get("External id") for e in events
                   if e.get("ph") == "X" and e.get("cat") == "cuda_runtime"
                   and "correlation" in e.get("args", {})}
    ms: Dict[str, float] = collections.Counter()
    cnt: Dict[str, int] = collections.Counter()
    shapes: Dict[str, float] = collections.Counter()
    for e in dev:
        d = float(e.get("dur", 0.0)) / 1e3          # us -> ms
        ms[e["name"]] += d
        cnt[e["name"]] += 1
        args = e.get("args", {})
        ext = args.get("External id") or runtime_ext.get(args.get("correlation"))
        op = ops.get(ext)
        shapes["(no op)" if op is None else _largest_shape(op["args"].get("Input Dims"))] += d
    return ms, cnt, shapes


def report(events: List[dict], n_steps: int = 1, top_k: int = 25) -> List[str]:
    ms, cnt, shapes = aggregate(events)
    total = sum(ms.values()) / n_steps
    lines = [f"device total: {total:.4f} ms/step ({len(ms)} distinct device events, "
             f"{sum(cnt.values()) / n_steps:g} a step)", f"top {top_k} (ms/step, count/step):"]
    for name, v in sorted(ms.items(), key=lambda kv: -kv[1])[:top_k]:
        lines.append(f"  {v / n_steps:9.4f}  x{cnt[name] / n_steps:<7g} {name[:120]}")
    lines.append("by the launching op's largest input shape (ms/step):")
    for key, v in sorted(shapes.items(), key=lambda kv: -kv[1])[:15]:
        lines.append(f"  {v / n_steps:9.4f}  {key}")
    return lines


def device_total_ms(path: str, n_steps: int = 1) -> float:
    return sum(aggregate(load_events(path))[0].values()) / n_steps


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    n_steps = int(argv[1]) if len(argv) > 1 else 1
    top_k = int(argv[2]) if len(argv) > 2 else 25
    for line in report(load_events(argv[0]), n_steps, top_k):
        print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
