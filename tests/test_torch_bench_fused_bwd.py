"""Port parity: dpfx_torch.tools.bench_fused_bwd's plain probe backward
against the JAX tool's Pallas kernels (``tools/bench_fused_bwd.py``:
``bwd_call`` for full / nowg / walk, each also rolled, on a ragged N, and
``ilv_call`` for 2 stripes, also rolled, where it is defined: N = n_pad),
run in interpret mode on the CPU with the tool's globals cut to a small
flow, on the same numpy-seeded inputs; the probe on zero-padded
production inputs against the production backward; the CLI."""

import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import dpfx.ops.fused_train  # noqa: E402,F401  (the JAX tool's imports, from this checkout)
import dpfx.utils.profiling  # noqa: E402,F401
from dpfx_torch.ops import fused_train as ft  # noqa: E402
from dpfx_torch.tools import bench_fused_bwd as bfb  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
K, H, NH, B = 3, 32, 1, 2
N_PAD, N_RAGGED, TILE = 256, 200, 128
NAMES = ("dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout")


def _tool():
    spec = importlib.util.spec_from_file_location("jax_tools_bench_fused_bwd",
                                                  ROOT / "tools" / "bench_fused_bwd.py")
    mod = importlib.util.module_from_spec(spec)
    with pytest.MonkeyPatch.context() as mp:
        # the tool puts a path of its own first on sys.path: run it on a copy
        mp.setattr(sys, "path", list(sys.path))
        spec.loader.exec_module(mod)
    return mod


def _inputs(seed=0):
    """The JAX tool's scales at the small sizes; numpy, float32."""
    rng = np.random.default_rng(seed)
    f = lambda scale, *shape: (scale * rng.normal(size=shape)).astype(np.float32)
    w = {"wx": f(0.3, K, H, 8), "wh": f(0.1, K, NH, H, H), "bh": f(0.1, K, NH, H, 1),
         "wout": f(0.05, K, 8, H), "bout": f(0.01, K, 8, 1)}
    return w, f(1.0, B, 8, N_PAD), f(0.1, B, K, H, 1), f(1.0, B, 8, N_PAD), f(1.0, B)


def _jax_runs(dtype):
    """The tool's kernels in interpret mode: bwd_call (tile 128 over 256
    columns, the valid mask at 200) for each (mode, rolled), ilv_call
    (N = 256) for 2 stripes, rolled or not."""
    tool = _tool()
    w, u, hz, du, dld = _inputs()
    jw = {k: jnp.asarray(v) for k, v in w.items()}
    args = [jnp.asarray(a) for a in (u, hz, du, dld)]
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        for name, val in dict(K=K, H=H, NH=NH, B=B, N=N_RAGGED, DTYPE=dtype).items():
            mp.setattr(tool, name, val)
        combos = ([(m, r) for m in ("full", "nowg", "walk") for r in (False, True)]
                  if dtype == jnp.float32 else [("full", False)])
        for mode, rolled in combos:
            res = tool.bwd_call(jw, *args, tile=TILE, vmem_mb=0, mode=mode, rolled=rolled)
            out[(mode, rolled)] = [np.asarray(a) for a in res]
        mp.setattr(tool, "N", N_PAD)
        for rolled in ((False, True) if dtype == jnp.float32 else (False,)):
            res = tool.ilv_call(jw, *args, vmem_mb=0, stripes=2, rolled=rolled)
            out[("ilv2", rolled)] = [np.asarray(a) for a in res]
    return out


@pytest.fixture(scope="module")
def jax_f32():
    return _jax_runs(jnp.float32)


@pytest.fixture(scope="module")
def jax_bf16():
    return _jax_runs(jnp.bfloat16)


def _plain(mode, n_points, dtype):
    w, u, hz, du, dld = _inputs()
    t = lambda a: torch.from_numpy(a)
    return bfb.probe_bwd_plain({k: t(v) for k, v in w.items()}, t(u), t(hz), t(du), t(dld),
                               mode=mode, n_points=n_points, dtype=dtype)


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30)


@pytest.mark.parametrize("rolled", [False, True])
@pytest.mark.parametrize("mode", ["full", "nowg", "walk"])
def test_plain_matches_bwd_call_f32(jax_f32, mode, rolled):
    """f32: both sides sum in f32 in other orders (XLA's dot and torch's
    einsum) through 3 layers of dy *= exp(s) and inputs rebuilt from
    outputs: relative norm 1e-5 per output. ``rolled`` changes the Pallas
    loop, not the values, so one plain run serves both."""
    got = _plain(mode, N_RAGGED, torch.float32)
    ref = jax_f32[(mode, rolled)]
    for name, a, b in zip(NAMES, got, ref):
        assert tuple(a.shape) == b.shape, name
        if not np.any(b):
            assert not torch.any(a), f"{name} must stay zero in {mode}"
            continue
        assert _rel(a.numpy(), b) <= 1e-5, f"{mode} {name}: {_rel(a.numpy(), b)}"


@pytest.mark.parametrize("rolled", [False, True])
def test_plain_matches_ilv_call_f32(jax_f32, rolled):
    """The interleaved variant has no valid mask: the plain full at
    n_points = N = n_pad, relative norm 1e-5 per output."""
    got = _plain("full", N_PAD, torch.float32)
    for name, a, b in zip(NAMES, got, jax_f32[("ilv2", rolled)]):
        assert _rel(a.numpy(), b) <= 1e-5, f"ilv2 {name}: {_rel(a.numpy(), b)}"


@pytest.mark.parametrize("variant", ["full", "ilv2"])
def test_plain_close_to_pallas_bf16(jax_bf16, variant):
    """bf16 operands round identically on both sides, but a sum that lands
    on the other side of a bf16 boundary flips one hidden unit by an ulp
    and the layers carry it on: each output within 2% of its norm, the
    bracket of tests/test_torch_fused_train.py's bf16 test."""
    n_points = N_RAGGED if variant == "full" else N_PAD
    got = _plain("full", n_points, torch.bfloat16)
    for name, a, b in zip(NAMES, got, jax_bf16[(variant, False)]):
        assert np.linalg.norm(a.numpy() - b) <= 2e-2 * np.linalg.norm(b) + 1e-6, name


def test_nowg_is_full_without_weight_gradients():
    """nowg gives full's dx bit for bit and zeros for dhz and every weight
    gradient."""
    full = _plain("full", N_RAGGED, torch.float32)
    nowg = _plain("nowg", N_RAGGED, torch.float32)
    assert torch.equal(nowg[0], full[0])
    assert all(not torch.any(t) for t in nowg[1:])


def test_padded_probe_is_the_production_backward():
    """On inputs that are zero in wx's columns 3-7, u's and du's rows 3-7
    and wout's and bout's rows 6-7, with the mask folded into wx's columns
    0-2, the probe's full backward is the production backward
    (fused_backward_plain): f32 within 1e-6, the padded parts zero."""
    w, u, hz, du, dld = _inputs(seed=1)
    t = {k: torch.from_numpy(v) for k, v in w.items()}
    m3 = bfb.masks8(K)[:, :3, 0]
    t["wx"][:, :, :3] *= m3[:, None, :]
    t["wx"][:, :, 3:] = 0
    t["wout"][:, 6:] = 0
    t["bout"][:, 6:] = 0
    uu, dd = torch.from_numpy(u), torch.from_numpy(du)
    uu[:, 3:] = 0
    dd[:, 3:] = 0
    hzt, dldt = torch.from_numpy(hz), torch.from_numpy(dld)
    got = bfb.probe_bwd_plain(t, uu, hzt, dd, dldt, mode="full", n_points=N_PAD,
                              dtype=torch.float32)
    p = bfb.production_slice(t, uu, hzt, dd)
    ref = ft.fused_backward_plain(p["wx"], p["wh"], p["bh"], p["wout"], p["bout"], p["masks"],
                                  bfb.CAP, p["u"], p["hz"], p["du"], dldt, torch.float32)
    dx, dhz, dwx, dwh, dbh, dwout, dbout = got
    pairs = [(dx[:, :3], ref[0]), (dhz[..., 0], ref[1]), (dwx[..., :3], ref[2]), (dwh, ref[3]),
             (dbh[..., 0], ref[4]), (dwout[:, :6], ref[5]), (dbout[:, :6, 0], ref[6])]
    for name, (a, b) in zip(NAMES, pairs):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6, msg=name)
    for pad in (dx[:, 3:], dwx[..., 3:], dwout[:, 6:], dbout[:, 6:]):
        assert not torch.any(pad)


def test_kernel_wrappers_take_the_plain_version_on_the_cpu():
    w, u, hz, du, dld = _inputs()
    t = lambda a: torch.from_numpy(a)
    tw = {k: t(v) for k, v in w.items()}
    bfb.reset_launch_counts()
    for mode in ("full", "walk"):
        got = bfb.probe_bwd_kernel(tw, t(u), t(hz), t(du), t(dld), mode=mode,
                                   n_points=N_RAGGED, dtype=torch.float32, rolled=True)
        for a, b in zip(got, _plain(mode, N_RAGGED, torch.float32)):
            assert torch.equal(a, b)
    got = bfb.ilv_bwd_kernel(tw, t(u), t(hz), t(du), t(dld), stripes=4, dtype=torch.float32)
    for a, b in zip(got, _plain("full", N_PAD, torch.float32)):
        assert torch.equal(a, b)
    assert not any(bfb.launches.values())
    with pytest.raises(ValueError, match="mode"):
        bfb.probe_bwd_plain(tw, t(u), t(hz), t(du), t(dld), mode="half", n_points=1)


def test_cli_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("checks the CLI on a machine without CUDA")
    proc = subprocess.run([sys.executable, "-m", "dpfx_torch.tools.bench_fused_bwd", "full"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no" in proc.stderr and "CUDA" in proc.stderr and "--device cpu" in proc.stderr


def test_cli_on_the_cpu(monkeypatch, capsys):
    """--device cpu runs the plain versions (B=1, one rep; the flow cut to
    K=3 and N=256): each variant's line, the TPU knob reported as ignored,
    and no launches."""
    monkeypatch.setenv("DPFX_PROBE_B", "1")
    monkeypatch.setenv("DPFX_PROBE_REPS", "1")
    monkeypatch.setenv("DPFX_PROBE_VMEM", "32")
    monkeypatch.setattr(bfb, "K", 3)
    monkeypatch.setattr(bfb, "N", 256)
    assert bfb.main(["--device", "cpu", "lib", "walk", "ilv2"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("  DPFX_PROBE_VMEM") and "ignored" in out[0]
    assert out[1] == "B=1 N=256 K=3 H=128 reps=1 device=cpu"
    assert any(line.startswith("  lib ") and " ms " in line for line in out)
    assert any(line.startswith("  ilv2 ") and "us/block" in line for line in out)
    assert any(line.startswith("  walk   tile= 128") and "us/tile" in line for line in out)
    assert out[-1] == "launches {}"
