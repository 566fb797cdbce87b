"""python -m dpfx_torch.evaluate on the CPU, in-process, on checkpoints that
the port's own trainer wrote: it prints one JSON line whose keys are those
that dpfx's evaluate.py prints for the same config (taken here from dpfx's
protocol functions), resolves
checkpoints as the trainer names them, refuses what is not ported, and its
eval-split helpers pick the same clouds as dpfx.data's."""

import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from dpfx_torch import evaluate  # noqa: E402
from dpfx_torch.checkpoint import checkpoint_path  # noqa: E402
from dpfx_torch.config import load_config  # noqa: E402
from dpfx_torch.train import __main__ as train_cli  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
GEN = str(ROOT / "configs" / "smoke_gen_synthetic.yaml")
AE = str(ROOT / "configs" / "smoke_ae_synthetic.yaml")
AE_OVERRIDES = ["eval.metrics=[cd,emd]", "data.category=all"]


@pytest.fixture(scope="module")
def ckpt_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("ckpt")
    for cfg in (GEN, AE):
        assert train_cli.main([cfg, "train.steps=2", "train.log_every=1", "train.ckpt_every=1",
                               f"train.ckpt_dir={d}", "--device", "cpu"]) == 0
    return d


def run(argv, capsys):
    assert evaluate.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    return json.loads(lines[-1]), lines


def dpfx_keys(config, overrides, labels=None):
    """The keys dpfx's evaluate.py prints for this config: "step", "n_test"
    and those of its protocol function: evaluate_reconstruction run on a
    fresh tiny JAX model (ae), or compute_all_metrics, which is what
    evaluate_generation returns (gen)."""
    from dpfx.config import load_config as jax_config
    from dpfx.metrics import compute_all_metrics, evaluate_reconstruction
    from dpfx.models import DPF

    cfg = jax_config(config, overrides=overrides)
    rng = jax.random.PRNGKey(0)
    clouds = (np.random.default_rng(0).normal(size=(6, 16, 3)) * 0.3).astype(np.float32)
    if cfg.experiment == "ae":
        model = DPF(cfg)
        params = model.init(rng, jnp.zeros((2, 16, 3)), rng)
        out = evaluate_reconstruction(model, params, clouds, cfg, rng, impl="jnp", labels=labels)
    else:
        out = compute_all_metrics(jnp.asarray(clouds), jnp.asarray(clouds[::-1]),
                                  metrics=cfg.eval.metrics, impl="jnp", ref_labels=labels)
    return {"step", "n_test", *out}


def test_generation_cli(ckpt_dir, capsys):
    res, lines = run([GEN, f"train.ckpt_dir={ckpt_dir}", "--device", "cpu", "--limit", "8"], capsys)
    assert lines[0].startswith("[dpfx_torch] evaluating gen @ step 2 on cpu")
    assert set(res) == dpfx_keys(GEN, [])
    assert res["step"] == 2 and res["n_test"] == 8
    assert all(np.isfinite(v) for k, v in res.items() if k != "jsd_frame")
    assert 0 <= res["cov-cd"] <= 1 and 0 <= res["1-nna-emd"] <= 1
    # --impl plain is the same arithmetic on the CPU
    plain, _ = run([GEN, f"train.ckpt_dir={ckpt_dir}", "--device", "cpu", "--limit", "8",
                    "--impl", "plain"], capsys)
    assert plain == res


def test_ae_cli(ckpt_dir, tmp_path, capsys):
    out = tmp_path / "results.jsonl"
    argv = [AE, *AE_OVERRIDES, f"train.ckpt_dir={ckpt_dir}", "--step", "1", "--device", "cpu",
            "--limit", "6", "--out", str(out)]
    res, _ = run(argv, capsys)
    assert set(res) == dpfx_keys(AE, AE_OVERRIDES, labels=np.array([0, 1, 2, 0, 1, 2]))
    assert res["step"] == 1 and res["n_test"] == 6
    assert np.isfinite(res["recon-cd"]) and np.isfinite(res["recon-emd"])
    assert set(res["per_category"]) == {"sphere", "box", "blobs"}
    run(argv, capsys)
    assert [json.loads(line) for line in out.read_text().splitlines()] == [res, res]


def test_checkpoint_resolution(ckpt_dir, capsys):
    cfg = load_config(GEN, overrides=[f"train.ckpt_dir={ckpt_dir}"])
    path, step = checkpoint_path(cfg)
    assert step == 2 and path.endswith("params_00000002.pt")
    assert checkpoint_path(cfg, 1)[1] == 1
    with pytest.raises(FileNotFoundError):
        checkpoint_path(cfg, 99)
    with pytest.raises(FileNotFoundError):
        checkpoint_path(load_config(GEN, overrides=[f"train.ckpt_dir={ckpt_dir}/none"]))
    res, _ = run([GEN, "--weights", path, "--device", "cpu", "--limit", "4"], capsys)
    assert res["step"] == 2


def test_refuses_what_is_not_ported(ckpt_dir, monkeypatch):
    weights = checkpoint_path(load_config(GEN, overrides=[f"train.ckpt_dir={ckpt_dir}"]))[0]
    with pytest.raises(NotImplementedError, match="Queue 1 #9"):
        evaluate.main([GEN, "experiment=svr", "--weights", weights, "--device", "cpu"])
    with pytest.raises(NotImplementedError, match="synthetic"):
        evaluate.main([GEN, "data.dataset=shapenet_h5", "--weights", weights, "--device", "cpu"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        evaluate.main([GEN, "--weights", weights])


@pytest.mark.parametrize("limit", [None, 10, 37])
def test_eval_split_helpers_match_dpfx(limit):
    import dpfx.data as jd

    from dpfx_torch import data as td

    cfg = load_config(GEN, overrides=["data.synthetic_size=200", "data.synthetic_family=v2"])
    ds_t = td.build_dataset(cfg.data, "test")
    ds_j = jd.SyntheticDataset(size=len(ds_t), modes=cfg.data.synthetic_modes, split="test",
                               family="v2")
    idx_t, lab_t = td.eval_subset(ds_t, limit)
    idx_j, lab_j = jd.eval_subset(ds_j, limit)
    assert (idx_t is None) == (idx_j is None)
    if idx_t is not None:
        np.testing.assert_array_equal(idx_t, idx_j)
    np.testing.assert_array_equal(lab_t, lab_j)
    np.testing.assert_array_equal(td.load_all(ds_t, 64, limit=limit, indices=idx_t),
                                  jd.load_all(ds_j, 64, limit=limit, indices=idx_j))
    np.testing.assert_array_equal(td.stratified_indices(lab_t, 7, seed=3),
                                  jd.stratified_indices(lab_j, 7, seed=3))
