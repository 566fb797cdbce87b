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


def test_entry_points_default_to_cuda(weights, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        restore_for_eval(load_config(SMOKE), weights[2])
    with pytest.raises(RuntimeError, match="CUDA"):
        generate.main([SMOKE, "--weights", weights[2], "--n-clouds", "1"])


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
