"""The port's measurement tools on the CPU at tiny sizes (the plain versions
of every kernel): prof_train (every piece; pf_fwd's closing sum against
dpfx's point_flow.log_prob on the same weights, f32 at 1e-5 relative),
bench_kernels, bench_serving, bench_batch_sweep and bench_sample_int8 (the
JAX tool's keys and its per-point error), each printing its kernel launches
last."""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dpfx_torch.compat import params_from_flax  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.config.flagship import FLAGSHIP, flagship_config  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.tools import (bench_batch_sweep, bench_kernels, bench_sample_int8,  # noqa: E402
                              bench_serving, prof_train)

TINY = {"experiment": "gen", "model": {
    "dz": 16, "point_flow": {"n_layers": 4, "hidden": 32, "n_hidden": 2, "scale_cap": 3.0},
    "latent_flow": {"n_layers": 2, "hidden": 32, "n_hidden": 2},
    "encoder": {"point_widths": [16, 32], "head_widths": [16]}}}


def _lines(capsys):
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1].startswith("launches {")
    assert json.loads(out[-1].split(" ", 1)[1]) == {}      # no kernel runs on the CPU
    return out[:-1]


def test_flagship_config_is_the_jax_packages():
    from __graft_entry__ import _flagship_config

    import dataclasses

    assert dataclasses.asdict(flagship_config()) == dataclasses.asdict(_flagship_config())
    assert FLAGSHIP["model"]["point_flow"]["n_layers"] == 32


def test_prof_train_every_piece(monkeypatch, capsys):
    monkeypatch.setenv("DPFX_PROF_B", "1")
    monkeypatch.setenv("DPFX_PROF_N", "16")
    monkeypatch.setenv("DPFX_PROF_REPS", "1")
    assert prof_train.main(["--device", "cpu", *prof_train.PIECES]) == 0
    out = _lines(capsys)
    assert out[0].startswith("B=1 N=16 reps=1 (ms/call, eager, host clock; cpu)")
    rows = [ln for ln in out[1:] if ln.startswith("  ")]
    assert [r.strip()[:len(prof_train.LABELS[p])] for r, p in zip(rows, prof_train.PIECES)] \
        == [prof_train.LABELS[p] for p in prof_train.PIECES]
    for r in rows:
        assert " ms " in r and "M pts/s" in r and np.isfinite(float(r.split("closing ")[1]))
    assert prof_train.selected([]) == ["full", "fwd", "fwdbwd", "nometrics", "pf_fwd",
                                       "pf_fwdbwd", "enc_fwdbwd", "lf_fwdbwd"]
    with pytest.raises(SystemExit):
        prof_train.selected(["nope"])


def test_prof_train_pf_fwd_matches_dpfx():
    import jax
    import jax.numpy as jnp

    from dpfx.config import config_from_dict as jax_config
    from dpfx.models import DPF as JaxDPF

    jmodel = JaxDPF(jax_config(TINY))
    rng = jax.random.PRNGKey(3)
    # dpfx's parameter tree, filled from a numpy seed (every leaf nonzero)
    leaves, tree = jax.tree.flatten(jax.eval_shape(jmodel.init, rng, jnp.zeros((2, 16, 3)), rng))
    noise = np.random.default_rng(0)
    params = jax.tree.unflatten(tree, [(0.15 * noise.normal(size=v.shape)).astype(np.float32)
                                       for v in leaves])
    model = DPF(config_from_dict(TINY))
    model.load_state_dict(params_from_flax(params), strict=True)
    g = np.random.default_rng(1)
    x = g.normal(size=(3, 40, 3)).astype(np.float32)
    z = g.normal(size=(3, 16)).astype(np.float32)
    eps = g.normal(size=(3, 16)).astype(np.float32)
    fns, _ = prof_train.build_pieces(model, config_from_dict(TINY), torch.from_numpy(x),
                                     torch.from_numpy(z), torch.from_numpy(eps),
                                     ["pf_fwd", "pf_fused_fwd"])
    got = float(fns["pf_fwd"]())
    want = float(jnp.sum(jmodel.apply(
        params, jnp.asarray(x), jnp.asarray(z),
        method=lambda m, x_, z_: m.point_flow.log_prob(x_, z_))))
    assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    # the fused piece's plain version computes the same sum
    assert abs(float(fns["pf_fused_fwd"]()) - want) <= 1e-5 * abs(want)


def test_bench_kernels_keys(monkeypatch, capsys):
    for k, v in (("B", "2"), ("N", "24"), ("PAIRS", "2"), ("EMD_PAIRS", "2"), ("SAMPLE_B", "2")):
        monkeypatch.setenv(f"DPFX_KB_{k}", v)
    assert bench_kernels.main(["1", "--device", "cpu"]) == 0
    out = _lines(capsys)
    res = json.loads(out[-1])
    stems = ["cd_fwd_b2", "cd_fwdbwd_b2", "cd_pairwise_2x2", "emd_fwd_b2",
             "emd_pairwise_2x2_fast", "emd_pairwise_2x2_exact", "sample_fused_b2"]
    assert set(res) == ({f"{s}_{side}_ms" for s in stems for side in ("kernel", "plain")}
                        | {"reps", "protocol", "device"})
    assert res["reps"] == 1 and res["protocol"] == "host-clock" and res["device"] == "cpu"
    assert all(v > 0 for k, v in res.items() if k.endswith("_ms"))


def test_bench_serving_table(monkeypatch, capsys):
    monkeypatch.setenv("DPFX_SERVE_BATCHES", "1,3")
    monkeypatch.setenv("DPFX_SERVE_N", "16")
    monkeypatch.setenv("DPFX_SERVE_REPS", "1")
    monkeypatch.setenv("DPFX_SERVE_XLA", "1")
    monkeypatch.setenv("DPFX_SAMPLE_FUSED_LATENT", "1")
    assert bench_serving.main(["--device", "cpu"]) == 0
    out = _lines(capsys)
    assert out[0] == ("# serving bench: N=16 reps=1 device=cpu latent inverse=fused kernels "
                      "(DPFX_SAMPLE_FUSED_LATENT=1)")
    rows = [ln.split() for ln in out[2:]]
    assert [(r[0], int(r[1])) for r in rows] == [("fused", 1), ("fused", 3), ("plain", 1),
                                                 ("plain", 3)]
    for r in rows:
        ms, clouds, pts = map(float, r[2:])
        assert ms > 0 and abs(clouds - int(r[1]) / ms * 1e3) <= 0.06 * clouds + 0.1


def test_bench_batch_sweep_rows(monkeypatch, capsys):
    monkeypatch.setenv("DPFX_SWEEP_N", "16")
    assert bench_batch_sweep.main(["--batches", "1,2", "--reps", "1", "--device", "cpu"]) == 0
    out = _lines(capsys)
    assert out[1:3] == ["| B | ms/step | pts/s | MFU |", "|---|---|---|---|"]
    rows = [ln.strip("|").split("|") for ln in out[3:5]]
    assert [int(r[0]) for r in rows] == [1, 2] and all(r[3].strip() == "-" for r in rows)
    counted = out[5].split(": ", 1)[1]
    flops = eval(counted)           # {B: FLOP}: linear in B for this model
    assert flops[2] == 2 * flops[1] > 0


def test_bench_sample_int8_keys(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("DPFX_INT8_B", "2")
    monkeypatch.setenv("DPFX_INT8_N", "16")
    monkeypatch.setenv("DPFX_INT8_REPS", "1")
    monkeypatch.setenv("DPFX_INT8_CKPT", str(tmp_path / "none.yaml"))
    assert bench_sample_int8.main(["--device", "cpu"]) == 0
    res = json.loads(_lines(capsys)[-1])
    # the JAX tool's keys (tools/bench_sample_int8.py)
    assert set(res) == {"bf16_ms", "int8_ms", "speedup", "bf16_pts_per_s", "int8_pts_per_s",
                        "quant_rms_error", "coord_rms", "rel_rms", "protocol", "shapes",
                        "weights", "device"} | {"point_err_median", "point_err_p999",
                                                "point_err_max"}
    # a fresh model's couplings are the identity: the error is vacuous
    assert res["shapes"] == [2, 16, 1] and res["weights"].startswith("fresh init")
    assert res["quant_rms_error"] == 0.0 and res["coord_rms"] > 0
    assert res["point_err_median"] == res["point_err_p999"] == res["point_err_max"] == 0.0


def test_bench_sample_int8_reads_the_runs_checkpoint(tmp_path):
    import yaml

    from dpfx_torch.config import load_config

    cfg = config_from_dict(bench_sample_int8.INT8_CONFIG)
    y = {**bench_sample_int8.INT8_CONFIG, "name": "run", "train": {"ckpt_dir": str(tmp_path)}}
    path = tmp_path / "run.yaml"
    path.write_text(yaml.safe_dump(y))
    model = DPF(load_config(str(path)))
    (tmp_path / "run").mkdir()
    torch.save(model.state_dict(), tmp_path / "run" / "params_00000007.pt")
    got, src = bench_sample_int8.load_weights(cfg, str(path), "cpu")
    assert src == "run@7"
    for k, v in model.state_dict().items():
        assert torch.equal(got.state_dict()[k], v)
    # another point flow: a fresh model
    y["model"] = {**y["model"], "point_flow": {**y["model"]["point_flow"], "n_layers": 2}}
    path.write_text(yaml.safe_dump(y))
    assert bench_sample_int8.load_weights(cfg, str(path), "cpu")[1].startswith("fresh init")


def test_bench_sample_int8_run_flow_takes_the_runs_model(monkeypatch, capsys, tmp_path):
    """``--run-flow``: the model of DPFX_INT8_CKPT's config (here a point
    flow at H=256 with n_hidden 4, which the flagship's flow is not) with
    its run's newest checkpoint; without the flag that run gives a fresh
    flagship model."""
    import yaml

    from dpfx_torch.config import load_config

    y = {**bench_sample_int8.INT8_CONFIG, "name": "deep", "train": {"ckpt_dir": str(tmp_path)}}
    y["model"] = {**y["model"], "dz": 16,
                  "point_flow": {**y["model"]["point_flow"], "n_layers": 2, "hidden": 256,
                                 "n_hidden": 4, "activation": "gelu"}}
    path = tmp_path / "deep.yaml"
    path.write_text(yaml.safe_dump(y))
    (tmp_path / "deep").mkdir()
    torch.save(DPF(load_config(str(path))).state_dict(), tmp_path / "deep" / "params_00000003.pt")
    monkeypatch.setenv("DPFX_INT8_B", "2")
    monkeypatch.setenv("DPFX_INT8_N", "16")
    monkeypatch.setenv("DPFX_INT8_REPS", "1")
    monkeypatch.setenv("DPFX_INT8_CKPT", str(path))
    assert bench_sample_int8.main(["--run-flow", "--device", "cpu"]) == 0
    res = json.loads(_lines(capsys)[-1])
    assert res["weights"] == "deep@3" and res["shapes"] == [2, 16, 1]
    assert bench_sample_int8.main(["--device", "cpu"]) == 0
    assert json.loads(_lines(capsys)[-1])["weights"].startswith("fresh init")


def test_make_plain_sampler_is_the_module_path():
    """The tools' plain sampling twin: both flows through their modules, the
    same draws as make_sampler(fused=False), whose point inverse is the
    kernel's plain version on the CPU (f32 at 1e-5)."""
    from dpfx_torch.compat import randomize_
    from dpfx_torch.sampling import make_plain_sampler, make_sampler

    model = randomize_(DPF(config_from_dict(TINY)), seed=2, scale=0.1).eval()
    got = make_plain_sampler(model, 3, 40, temperature=0.9, latent_temperature=1.1)(4)
    want = make_sampler(model, 3, 40, fused=False, temperature=0.9, latent_temperature=1.1)(4)
    assert got.shape == (3, 40, 3)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
