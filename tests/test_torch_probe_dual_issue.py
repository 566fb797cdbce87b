"""Port parity: dpfx_torch.tools.probe_dual_issue's plain chain against the
JAX tool's Pallas kernel (``tools/probe_dual_issue.py``'s ``_kernel``) in
modes A, B and C, run in interpret mode on the CPU through a
``pallas_call`` built here (the tool's ``build`` targets the TPU) with the
tool's globals cut to L=3, H=32, T=128, G=2, on the same numpy-seeded
inputs; the CLI."""

import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import dpfx.utils.profiling  # noqa: E402,F401  (the JAX tool's import, from this checkout)
from dpfx_torch.tools import probe_dual_issue as pdi  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
L, G, H, T = 3, 2, 32, 128


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    w = np.array(jnp.asarray(rng.normal(size=(L, H, H)) * 0.05, jnp.bfloat16).astype(jnp.float32))
    return w, rng.normal(size=(G, H, T)).astype(np.float32), rng.normal(size=(G, 8, T)).astype(
        np.float32)


@pytest.fixture(scope="module")
def jax_runs():
    spec = importlib.util.spec_from_file_location("jax_tools_probe_dual_issue",
                                                  ROOT / "tools" / "probe_dual_issue.py")
    tool = importlib.util.module_from_spec(spec)
    w, x, v = _inputs()
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        # the tool puts a path of its own first on sys.path: run it on a copy
        mp.setattr(sys, "path", list(sys.path))
        spec.loader.exec_module(tool)
        for name, val in dict(L=L, G=G, H=H, T=T).items():
            mp.setattr(tool, name, val)
        for mode, (mxu, vpu) in pdi.MODES.items():
            kernel = functools.partial(tool._kernel, do_mxu=mxu, do_vpu=vpu)
            spec3 = lambda *s: pl.BlockSpec(s, lambda b: (b, 0, 0))
            ox, ov = pl.pallas_call(
                kernel, grid=(G,),
                in_specs=[pl.BlockSpec((L, H, H), lambda b: (0, 0, 0)), spec3(1, H, T),
                          spec3(1, 8, T)],
                out_specs=[spec3(1, H, T), spec3(1, 8, T)],
                out_shape=[jax.ShapeDtypeStruct((G, H, T), jnp.float32),
                           jax.ShapeDtypeStruct((G, 8, T), jnp.float32)],
                interpret=True,
            )(jnp.asarray(w, jnp.bfloat16), jnp.asarray(x), jnp.asarray(v))
            out[mode] = (np.asarray(ox), np.asarray(ov))
    return out


@pytest.mark.parametrize("mode", ["A", "B", "C"])
def test_plain_matches_pallas(jax_runs, mode):
    """v: exp in f32 on both sides, and the chain contracts (v -> e^{v/4} - 1
    has slope 1/4 at its fixed point 0), so within 1e-6. x: bf16 operands
    round identically, but an f32 sum in another order can land on the other
    side of a bf16 boundary and move that entry by one bf16 ulp (2^-8 of
    it), which the next products carry on: every entry within 2% of the
    largest, and 99% within 0.4% of it."""
    w, x, v = _inputs()
    mxu, vpu = pdi.MODES[mode]
    ox, ov = pdi.dual_issue_plain(torch.from_numpy(w).to(torch.bfloat16), torch.from_numpy(x),
                                  torch.from_numpy(v), do_mxu=mxu, do_vpu=vpu)
    jx, jv = jax_runs[mode]
    np.testing.assert_allclose(ov.numpy(), jv, rtol=0, atol=1e-6)
    scale = np.abs(jx).max()
    err = np.abs(ox.numpy() - jx) / scale
    assert err.max() <= 2e-2 and np.quantile(err, 0.99) <= 4e-3, (err.max(), np.quantile(err, 0.99))
    if not mxu:
        np.testing.assert_array_equal(ox.numpy(), jx)       # x is only rounded to bf16
    if not vpu:
        np.testing.assert_array_equal(ov.numpy(), v)


def test_kernel_wrapper_takes_the_plain_version_on_the_cpu():
    w, x, v = (torch.from_numpy(a) for a in _inputs())
    w = w.to(torch.bfloat16)
    pdi.reset_launch_counts()
    for mxu, vpu in pdi.MODES.values():
        got = pdi.dual_issue_kernel(w, x, v, do_mxu=mxu, do_vpu=vpu)
        ref = pdi.dual_issue_plain(w, x, v, do_mxu=mxu, do_vpu=vpu)
        assert all(torch.equal(a, b) for a, b in zip(got, ref))
    assert not any(pdi.launches.values())
    with pytest.raises(ValueError, match="at least one"):
        pdi.dual_issue_plain(w, x, v, do_mxu=False, do_vpu=False)


def test_cli_without_cuda_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("checks the CLI on a machine without CUDA")
    proc = subprocess.run([sys.executable, "-m", "dpfx_torch.tools.probe_dual_issue"],
                          cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "CUDA" in proc.stderr and "--device cpu" in proc.stderr


def test_cli_on_the_cpu(monkeypatch, capsys):
    """--device cpu runs the plain chain (L=2, G=1) through the same lines."""
    monkeypatch.setenv("PROBE_L", "2")
    monkeypatch.setenv("PROBE_G", "1")
    assert pdi.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"L=2 G=1 H={pdi.H} T={pdi.T} device=cpu"
    for i, label in enumerate(("A mxu-only", "B mxu+vpu", "C vpu-only")):
        assert out[1 + i].startswith(f"{label}: ") and "us/grid-layer" in out[1 + i]
    assert out[4].startswith("t(B) - t(A) = ") and "t(C)/t(A)" in out[4]
    assert out[5] == "launches {}"
