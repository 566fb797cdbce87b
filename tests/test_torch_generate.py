"""The port's CLI and package rules: dpfx_torch.generate runs in-process on
the CPU, entry points refuse to run without CUDA unless asked for the CPU,
and nothing in dpfx_torch (or chip_smoke.py) imports JAX or dpfx."""

import ast
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from dpfx_torch import generate  # noqa: E402
from dpfx_torch.checkpoint import load_state_dict, restore_for_eval  # noqa: E402
from dpfx_torch.compat import flatten_tree, params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import load_config  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.sampling import make_sampler  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = str(ROOT / "configs" / "smoke_gen_synthetic.yaml")


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    d = tmp_path_factory.mktemp("weights")
    model = randomize_(DPF(load_config(SMOKE)), seed=1)
    npz = d / "w.npz"
    np.savez(npz, **flatten_tree(params_to_flax(model.state_dict())))
    pt = d / "w.pt"
    torch.save(model.state_dict(), pt)
    return model, str(npz), str(pt)


@pytest.mark.parametrize("fmt", ["npz", "pt"])
def test_generate_main_writes_clouds(weights, tmp_path, fmt, capsys):
    model, npz, pt = weights
    out = tmp_path / "s.npy"
    rc = generate.main([SMOKE, "eval.latent_temperature=1.1", "--device", "cpu",
                        "--weights", npz if fmt == "npz" else pt, "--n-clouds", "3",
                        "--n-points", "50", "--out", str(out), "--seed", "2"])
    assert rc == 0
    clouds = np.load(out)
    assert clouds.shape == (3, 50, 3) and np.isfinite(clouds).all()
    ref = make_sampler(model, 3, 50, latent_temperature=1.1)(2).numpy()
    np.testing.assert_allclose(clouds, ref, atol=1e-6)
    assert "sampled (3, 50, 3)" in capsys.readouterr().out


def test_generate_finds_the_runs_checkpoint(tmp_path, capsys):
    """Without --weights, generate samples the newest params_<step>.pt of
    train.ckpt_dir/name, or the one of --step, as --weights on that file."""
    run = tmp_path / "smoke_gen_synthetic"
    run.mkdir()
    for step, seed in ((2, 3), (5, 4)):
        model = randomize_(DPF(load_config(SMOKE)), seed=seed)
        torch.save(model.state_dict(), run / f"params_{step:08d}.pt")
    common = [SMOKE, f"train.ckpt_dir={tmp_path}", "--device", "cpu", "--n-clouds", "2",
              "--n-points", "20", "--seed", "1"]
    outs = {}
    for name, extra in (("newest", []), ("step2", ["--step", "2"]),
                        ("w5", ["--weights", str(run / "params_00000005.pt")]),
                        ("w2", ["--weights", str(run / "params_00000002.pt")])):
        assert generate.main([*common, *extra, "--out", str(tmp_path / f"{name}.npy")]) == 0
        outs[name] = np.load(tmp_path / f"{name}.npy")
        text = capsys.readouterr().out
        if name == "newest":
            assert "sampled (2, 20, 3) from step-5 checkpoint" in text
        if name == "step2":
            assert "from step-2 checkpoint" in text
    np.testing.assert_array_equal(outs["newest"], outs["w5"])
    np.testing.assert_array_equal(outs["step2"], outs["w2"])
    assert not np.array_equal(outs["newest"], outs["step2"])
    with pytest.raises(FileNotFoundError, match="step 3"):
        generate.main([*common, "--step", "3", "--out", str(tmp_path / "x.npy")])


def test_entry_points_default_to_cuda(weights, monkeypatch, tmp_path):
    from dpfx_torch.tools import (bench_batch_sweep, bench_kernels, bench_sample_int8,
                                  bench_serving, part_count_pin, prof_train, quality_oracle)
    from dpfx_torch.utils.profiling import profile_sampling

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_for_eval(load_config(SMOKE), weights[2])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.main([SMOKE, "--weights", weights[2], "--n-clouds", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.main([SMOKE, f"train.ckpt_dir={tmp_path}", "--n-clouds", "1"])
    # the tools that build a model
    for main, argv in ((prof_train.main, ["fwd"]), (bench_kernels.main, ["1"]),
                       (bench_serving.main, []), (bench_batch_sweep.main, ["--batches", "1"]),
                       (bench_sample_int8.main, []),
                       (quality_oracle.main, [SMOKE, "--limit", "2"]),
                       (part_count_pin.main, [SMOKE, str(tmp_path / "gen.npy")])):
        with pytest.raises(RuntimeError, match="CUDA"):
            main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        profile_sampling(n_clouds=1, n_points=8)


def test_weights_formats(weights, tmp_path):
    model, npz, pt = weights
    a, b = load_state_dict(npz), load_state_dict(pt)
    assert a.keys() == b.keys() == model.state_dict().keys()
    for k in a:
        torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    bad = tmp_path / "w.ckpt"
    bad.write_bytes(b"")
    with pytest.raises(ValueError, match=r"\.pt"):
        load_state_dict(str(bad))
    with pytest.raises(FileNotFoundError):
        load_state_dict(str(tmp_path / "missing.pt"))


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module


FORBIDDEN = ("jax", "jaxlib", "flax", "orbax", "optax", "dpfx")


@pytest.mark.parametrize("path", sorted((ROOT / "dpfx_torch").rglob("*.py"))
                         + [ROOT / "chip_smoke.py"], ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_no_jax(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{path} imports {bad}"


def test_import_scan_covers_the_tools():
    """The scan above is parametrized over every tool, the profiling module
    and the flagship config."""
    (mark,) = [m for m in test_port_imports_no_jax.pytestmark if m.name == "parametrize"]
    scanned = {str(p.relative_to(ROOT)) for p in mark.args[1]}
    for name in ("bench_kernels", "bench_serving", "bench_batch_sweep", "bench_sample_int8",
                 "prof_train", "parse_trace", "quality_oracle", "make_synthetic_shapenet",
                 "part_count_pin", "_common"):
        assert f"dpfx_torch/tools/{name}.py" in scanned
    assert {"dpfx_torch/utils/profiling.py", "dpfx_torch/config/flagship.py",
            "chip_smoke.py"} <= scanned
