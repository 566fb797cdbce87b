"""The port's data and quality tools against the JAX package's tools/ on the
same inputs, on the CPU: quality_oracle's two rows (--impl plain against
--impl jnp, both in exact mode, dpfx's jnp EMD being exact; the tolerances
of tests/test_torch_metrics.py for the exact suite: CD 1e-5, EMD 1e-4
relative, JSD 1e-6, COV and 1-NNA equal), make_synthetic_shapenet's
npy tree, PNG renders and HDF5 file (byte for byte), part_count_pin's
report (equal, its floats at 1e-6 relative), and the port's two repairs of
part_count_pin (the prefix rows, null for empty slices)."""

import importlib
import json
import math
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dpfx_torch.tools import make_synthetic_shapenet, part_count_pin, quality_oracle  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CD_TOL = dict(rtol=1e-5, atol=1e-5)
EMD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture
def jax_tool(monkeypatch):
    """A JAX tool from tools/ (each puts the repository on sys.path; the
    monkeypatch restores sys.path)."""
    monkeypatch.syspath_prepend(str(ROOT / "tools"))

    def load(name):
        sys.modules.pop(name, None)
        return importlib.import_module(name)
    return load


def _json_lines(text):
    return [json.loads(ln) for ln in text.splitlines() if ln.startswith("{")]


def test_quality_oracle_rows_match_the_jax_tool(jax_tool, capsys, tmp_path):
    # dpfx's jnp EMD is exact whatever the precision, so both run exact; one
    # device (dpfx on the 8-device test mesh compiles for minutes)
    cfg = [str(ROOT / "configs" / "smoke_gen_synthetic.yaml"), "eval.pairwise_precision=exact",
           "parallel.data_axis=1"]
    out = tmp_path / "rows.jsonl"
    assert quality_oracle.main([*cfg, "--limit", "16", "--impl", "plain", "--device", "cpu",
                                "--out", str(out)]) == 0
    got = _json_lines(capsys.readouterr().out)
    assert jax_tool("quality_oracle").main([*cfg, "--limit", "16", "--impl", "jnp"]) == 0
    want = _json_lines(capsys.readouterr().out)
    assert [r["oracle"] for r in got] == [r["oracle"] for r in want] == ["train_vs_test",
                                                                         "noise_vs_test"]
    assert [json.loads(ln) for ln in out.read_text().splitlines()] == got
    for g, w in zip(got, want):
        assert set(g) == set(w) and g["n"] == w["n"] == 16
        for k in ("cov-cd", "1-nna-cd", "cov-emd", "1-nna-emd", "jsd_frame"):
            assert g[k] == w[k], (g["oracle"], k)
        np.testing.assert_allclose(g["mmd-cd"], w["mmd-cd"], **CD_TOL)
        np.testing.assert_allclose(g["mmd-emd"], w["mmd-emd"], **EMD_TOL)
        for k in ("jsd", "jsd_fit", "jsd_raw"):
            assert abs(g[k] - w[k]) <= 1e-6, (g["oracle"], k)
    assert got[0]["1-nna-cd"] < got[1]["1-nna-cd"]       # the brackets are apart


def _files(root: Path):
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_make_synthetic_shapenet_tree_and_renders_byte_for_byte(jax_tool, tmp_path):
    pytest.importorskip("PIL")
    args = ["--train", "6", "--valtest", "3", "--points", "80", "--family", "v3", "--views",
            "2", "--imgsize", "40"]
    assert make_synthetic_shapenet.main([str(tmp_path / "t"), "--renders",
                                         str(tmp_path / "r"), *args]) == 0
    assert jax_tool("make_synthetic_shapenet").main([str(tmp_path / "jt"), "--renders",
                                                     str(tmp_path / "jr"), *args]) == 0
    tree, renders = _files(tmp_path / "t"), _files(tmp_path / "r")
    assert len(tree) == 12 and len(renders) == 24
    assert tree == _files(tmp_path / "jt")
    assert renders == _files(tmp_path / "jr")
    assert "02691156/test/model_test_000000.npy" in tree         # kind 0: airplane


def test_make_synthetic_shapenet_h5(jax_tool, tmp_path):
    h5py = pytest.importorskip("h5py")
    args = ["--train", "5", "--valtest", "2", "--points", "64", "--h5"]
    assert make_synthetic_shapenet.main([str(tmp_path / "a.h5"), *args]) == 0
    assert jax_tool("make_synthetic_shapenet").main([str(tmp_path / "b.h5"), *args]) == 0
    assert (tmp_path / "a.h5").read_bytes() == (tmp_path / "b.h5").read_bytes()
    with h5py.File(tmp_path / "a.h5") as f:
        assert f["train"].shape == (5, 64, 3) and list(f["val_labels"][:]) == [0, 1]


V3 = """experiment: gen
name: pin
model:
  dz: 16
  point_flow: {n_layers: 2, hidden: 16, n_hidden: 2}
  latent_flow: {n_layers: 2, hidden: 16, n_hidden: 2}
data:
  dataset: synthetic
  category: all
  synthetic_family: v3
  synthetic_size: 400
  n_points_eval: 48
"""


@pytest.fixture
def pin_inputs(tmp_path):
    """A tiny v3 config (100 test clouds) and a dump of 60 train-split clouds."""
    from dpfx_torch.config import load_config
    from dpfx_torch.data import build_dataset, load_all

    cfg_path = tmp_path / "v3.yaml"
    cfg_path.write_text(V3)
    cfg = load_config(str(cfg_path))
    gen = load_all(build_dataset(cfg.data, "train"), 48, seed=5, limit=60)
    gen_path = tmp_path / "gen.npy"
    np.save(gen_path, gen)
    return cfg, str(cfg_path), str(gen_path)


def _report(text):
    """The indented JSON report (the tools print it between "{" and "}" lines)."""
    lines = text.splitlines()
    start = lines.index("{")
    return json.loads("\n".join(lines[start:lines.index("}", start) + 1]))


def _close(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, float):
        assert math.isfinite(b) and abs(a - b) <= 1e-6 * abs(b), (path, a, b)
    else:
        assert a == b, (path, a, b)


def test_part_count_pin_matches_the_jax_tool(jax_tool, pin_inputs, capsys, tmp_path):
    cfg, cfg_path, gen_path = pin_inputs
    out = tmp_path / "pin.jsonl"
    assert part_count_pin.main([cfg_path, gen_path, "--limit", "70", "--impl", "plain",
                                "--device", "cpu", "--out", str(out)]) == 0
    got = _report(capsys.readouterr().out)
    assert json.loads(out.read_text()) == json.loads(json.dumps(got))
    assert jax_tool("part_count_pin").main([cfg_path, gen_path, "--limit", "70",
                                            "--impl", "jnp"]) == 0
    want = _report(capsys.readouterr().out)
    # inputs on which the JAX tool runs cleanly: a stratified subset, every
    # k present, covered and uncovered chains (no NaN in its report)
    assert "NaN" not in json.dumps(want) and want["n_chain_refs"] == 14
    assert 0 < want["chain_cov"] < 1
    _close(got, want)


def test_part_count_pin_takes_the_prefix_rows(jax_tool, pin_inputs, capsys):
    """--limit past the split's size: eval_subset gives no indices; the
    port replays the prefix rows, where the JAX tool raises."""
    from dpfx_torch.data import build_dataset

    cfg, cfg_path, gen_path = pin_inputs
    assert part_count_pin.main([cfg_path, gen_path, "--limit", "500", "--impl", "plain",
                                "--device", "cpu"]) == 0
    got = _report(capsys.readouterr().out)
    test_ds = build_dataset(cfg.data, "test")
    chains = [i for i in range(len(test_ds)) if test_ds.label(i) == part_count_pin.CHAIN_KIND]
    assert got["n_chain_refs"] == len(chains) == 20
    ks = [part_count_pin.chain_covariates(test_ds, i)["k"] for i in chains]
    assert got["ref_true_k_hist"] == {str(k): ks.count(k) for k in range(3, 8)}
    with pytest.raises(TypeError):
        jax_tool("part_count_pin").main([cfg_path, gen_path, "--limit", "500", "--impl", "jnp"])


def test_part_count_pin_reports_null_for_empty_slices(pin_inputs):
    """No generated cloud near a chain, and k values the subset lacks: the
    means over empty slices are None (null), never NaN."""
    from dpfx_torch.data import build_dataset

    cfg, _, _ = pin_inputs
    test_ds = build_dataset(cfg.data, "test")
    rows = np.array([2, 7, 12, 0, 1, 3])                  # three chains, three others
    labels = np.array([test_ds.label(int(r)) for r in rows])
    m_gr = np.full((4, rows.size), 5.0, np.float32)
    m_gr[:, 3:] = 1.0                                      # every gen cloud nearest a non-chain
    r = part_count_pin.report(m_gr, labels, rows, test_ds)
    json.dumps(r, allow_nan=False)
    assert r["n_chain_refs"] == 3 and r["chain_cov"] == 0.0
    assert r["scale"]["covered_mean"] is None and r["curve_len"]["covered_mean"] is None
    assert r["scale"]["uncovered_mean"] is not None
    present = {part_count_pin.chain_covariates(test_ds, int(i))["k"] for i in rows[:3]}
    for k, v in r["per_k"].items():
        if k in present:
            assert v["covered_frac"] == 0.0 and v["mean_min_cd"] == 5.0
        else:
            assert v["covered_frac"] is None and v["mean_min_cd"] is None and v["n_refs"] == 0
    assert len(present) < 5
