"""The port's pack tool (python -m dpfx_torch.tools.pack_dataset) against
the JAX package's tools/pack_dataset.py: the same stack and sidecar, and
the stack served by the port's native loader."""

import importlib.util
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import yaml  # noqa: E402

from dpfx_torch.native import NativeBatcher  # noqa: E402
from dpfx_torch.tools import pack_dataset  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SMOKE = ROOT / "configs" / "smoke_gen_synthetic.yaml"


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_pack_dataset",
                                                  ROOT / "tools" / "pack_dataset.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def small_config(tmp_path_factory):
    """smoke_gen_synthetic with 24 clouds (the JAX tool takes no overrides)."""
    cfg = yaml.safe_load(SMOKE.read_text())
    cfg["data"]["synthetic_size"] = 24
    path = tmp_path_factory.mktemp("cfg") / "pack.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("split,n_stored", [("train", 1024), ("train", 4096), ("val", 2048)])
def test_stack_and_sidecar_equal_the_jax_tool(small_config, tmp_path, split, n_stored, capsys):
    """1024 subsamples the 2048 stored points without replacement, 4096
    with; 2048 keeps each cloud as it is."""
    ours, ref = tmp_path / "ours.npy", tmp_path / "ref.npy"
    assert pack_dataset.main([small_config, "--split", split, "--out", str(ours),
                              "--n-stored", str(n_stored)]) == 0
    assert "packed (" in capsys.readouterr().out
    assert _jax_tool().main([small_config, "--split", split, "--out", str(ref),
                             "--n-stored", str(n_stored)]) == 0
    a, b = np.load(ours), np.load(ref)
    assert a.dtype == np.float32 and a.shape == (24 if split == "train" else 8, n_stored, 3)
    np.testing.assert_array_equal(a, b)
    meta = json.loads(Path(str(ours) + ".meta.json").read_text())
    assert meta == json.loads(Path(str(ref) + ".meta.json").read_text())
    assert meta == {"normalize_applied": "per_shape", "dataset": "synthetic",
                    "category": "airplane", "split": split, "n_stored": n_stored}


def test_overrides_and_the_loader_reads_the_stack(tmp_path):
    out = tmp_path / "packed"            # the tool adds .npy
    assert pack_dataset.main([str(SMOKE), "data.synthetic_size=16", "--out", str(out),
                              "--n-stored", "512"]) == 0
    stack = np.load(str(out) + ".npy")
    assert stack.shape == (16, 512, 3)
    nb = NativeBatcher(str(out) + ".npy", 4, 256, seed=0, n_workers=1)
    try:
        x = nb.next()
    finally:
        nb.close()
    assert x.shape == (4, 256, 3)
    flat = {tuple(p) for p in stack.reshape(-1, 3)}
    assert all(tuple(p) in flat for p in x.reshape(-1, 3))
    with pytest.raises(ValueError, match="double-normalize"):    # the sidecar says per_shape
        NativeBatcher(str(out) + ".npy", 4, 256, normalize="per_shape")
