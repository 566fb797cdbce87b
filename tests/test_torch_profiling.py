"""dpfx_torch.utils.profiling on the CPU: time_fn, chain_cost_per_step (the
FLOP of one nn.Linear step, 2 B in out exactly, forward and backward),
graph_time_ms's eager path and its launch counts, trace's Chrome-trace
file, profile_sampling's four keys on a tiny config; and
dpfx_torch.tools.parse_trace on a hand-written trace (totals, the division
by steps, the top-k, the shape rollup, and a trace without kernels)."""

import json
import os

import pytest

torch = pytest.importorskip("torch")

from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.tools import parse_trace  # noqa: E402
from dpfx_torch.utils import profiling  # noqa: E402

TINY = {"experiment": "gen", "model": {
    "dz": 8, "point_flow": {"n_layers": 2, "hidden": 16, "n_hidden": 2},
    "latent_flow": {"n_layers": 2, "hidden": 16, "n_hidden": 2},
    "encoder": {"point_widths": [16, 32], "head_widths": [16]}}}


def test_time_fn_keys_and_counts():
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    t = profiling.time_fn(fn, torch.ones(3), reps=4, warmup=2, materialize=True)
    assert set(t) == {"mean_s", "per_sec"}
    assert t["mean_s"] > 0 and abs(t["per_sec"] * t["mean_s"] - 1) < 1e-9
    assert len(calls) == 6


@pytest.mark.parametrize("b,fin,fout", [(4, 8, 16), (7, 3, 5)])
def test_chain_cost_per_step_counts_a_linear_step_exactly(b, fin, fout):
    lin = torch.nn.Linear(fin, fout)
    x = torch.randn(b, fin)

    def fwd(carry, i):
        return carry, lin(x).sum()

    assert profiling.chain_cost_per_step(fwd, None) == (2 * b * fin * fout, None)

    def step(carry, i):
        loss = lin(x).sum()
        g = torch.autograd.grad(loss, list(lin.parameters()))
        return carry, loss + sum(t.sum() for t in g)

    # the backward's product for the weight gradient (no input gradient: x
    # needs none)
    assert profiling.chain_cost_per_step(step, None) == (2 * 2 * b * fin * fout, None)
    assert profiling.chain_cost_per_step(lambda c, i: (c, torch.ones(())), None) == (None, None)

    def broken(carry, i):
        raise RuntimeError("no step")

    with pytest.raises(RuntimeError, match="no step"):
        profiling.chain_cost_per_step(broken, None)


def test_chain_time_and_graph_time_on_the_cpu():
    ms = profiling.chain_time_ms(lambda c, i: (c + 1, c.float().sum()), torch.zeros(()), reps=3)
    assert ms > 0
    counter = {"k": 0}

    def fn():
        counter["k"] += 1
        return torch.ones(()) * counter["k"]

    t = profiling.graph_time_ms(fn, reps=3, counters=[counter])
    assert t["ms"] > 0 and t["closing"] == 4.0 and counter["k"] == 4
    t["call"]()
    assert counter["k"] == 5
    with pytest.raises(AssertionError, match="non-finite"):
        profiling.graph_time_ms(lambda: torch.tensor(float("nan")), reps=1)


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")) as prof:
        (torch.randn(8, 4) @ torch.randn(4, 2)).sum()
    files = list((tmp_path / "t").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("name") == "aten::mm" and e["args"]["Input Dims"] == [[8, 4], [4, 2]]
               for e in events if e.get("cat") == "cpu_op")
    assert profiling.device_busy_us(prof) == 0.0
    # the CPU trace holds no kernel: parse_trace refuses it
    with pytest.raises(RuntimeError, match="no device kernel events"):
        parse_trace.aggregate(parse_trace.load_events(str(tmp_path / "t")))


def test_profile_sampling_keys():
    out = profiling.profile_sampling(config_from_dict(TINY), n_clouds=2, n_points=16,
                                     device="cpu")
    assert set(out) == {"fused_ms", "fused_points_per_sec", "plain_ms", "plain_points_per_sec"}
    assert all(v > 0 for v in out.values())
    assert abs(out["fused_points_per_sec"] * out["fused_ms"] / 1e3 - 32) < 1e-6


def _trace(steps=2):
    """Two steps of: an mm launching gemm (by its External id) and a copy,
    an add launching a kernel found through its runtime call's correlation,
    a ctypes-launched kernel under no op, and host events that must not
    count."""
    ev = []
    for s in range(steps):
        base = 100 * s
        ev += [
            {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": base, "dur": 50,
             "args": {"External id": base + 1, "Input Dims": [[64, 32], [32, 16]]}},
            {"ph": "X", "cat": "cpu_op", "name": "aten::add", "ts": base + 60, "dur": 5,
             "args": {"External id": base + 2, "Input Dims": [[4, 2048, 3], [4, 2048, 3], []]}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": base + 61,
             "dur": 2, "args": {"correlation": base + 7, "External id": base + 2}},
            {"ph": "X", "cat": "kernel", "name": "gemm", "ts": base + 10, "dur": 400.0,
             "args": {"External id": base + 1, "correlation": base + 6}},
            {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy DtoD", "ts": base + 20, "dur": 100.0,
             "args": {"External id": base + 1, "correlation": base + 8}},
            {"ph": "X", "cat": "kernel", "name": "add_kernel", "ts": base + 62, "dur": 300.0,
             "args": {"correlation": base + 7}},
            {"ph": "X", "cat": "kernel", "name": "rows_kernel", "ts": base + 70, "dur": 1000.0,
             "args": {"External id": 0, "correlation": base + 9}},
            {"ph": "X", "cat": "python_function", "name": "step", "ts": base, "dur": 90000},
            {"ph": "i", "cat": "kernel", "name": "marker", "ts": base},
        ]
    return {"traceEvents": ev}


def test_parse_trace_totals_topk_and_shapes(tmp_path, capsys):
    d = tmp_path / "tr"
    d.mkdir()
    (d / "old.json").write_text(json.dumps({"traceEvents": []}))
    (d / "new.json").write_text(json.dumps(_trace()))
    os.utime(d / "old.json", (1, 1))
    ms, cnt, shapes = parse_trace.aggregate(parse_trace.load_events(str(d)))
    assert ms == {"gemm": 0.8, "Memcpy DtoD": 0.2, "add_kernel": 0.6, "rows_kernel": 2.0}
    assert cnt == {"gemm": 2, "Memcpy DtoD": 2, "add_kernel": 2, "rows_kernel": 2}
    assert shapes == {"[64,32]": pytest.approx(1.0), "[4,2048,3]": pytest.approx(0.6),
                      "(no op)": pytest.approx(2.0)}
    assert parse_trace.device_total_ms(str(d), 2) == pytest.approx(1.8)
    assert parse_trace.main([str(d / "new.json"), "2", "2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device total: 1.8000 ms/step (4 distinct device events, 4 a step)")
    assert out[1] == "top 2 (ms/step, count/step):"
    assert out[2].split() == ["1.0000", "x1", "rows_kernel"]
    assert out[3].split() == ["0.4000", "x1", "gemm"]
    assert out[4].startswith("by the launching op's largest input shape")
    assert [ln.split(None, 1) for ln in out[5:]] == [["1.0000", "(no op)"],
                                                     ["0.5000", "[64,32]"],
                                                     ["0.3000", "[4,2048,3]"]]


def test_parse_trace_without_kernels_raises(tmp_path):
    t = _trace(1)
    t["traceEvents"] = [e for e in t["traceEvents"] if e.get("cat") != "kernel"]
    (tmp_path / "t.json").write_text(json.dumps(t))
    with pytest.raises(RuntimeError, match="no device kernel events.*cpu_op"):
        parse_trace.device_total_ms(str(tmp_path / "t.json"))
    with pytest.raises(FileNotFoundError):
        parse_trace.load_events(str(tmp_path / "empty_dir_missing"))
