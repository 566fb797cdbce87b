"""The port's trainer loop (dpfx_torch.train.Trainer) against dpfx's:
Trainer.evaluate on the same weights, batches and eps (means and medians),
the train.ckpt_keep retention, fit_auto's two recovery scenarios, resume
bit for bit (host batches and the resident split), the restore in place,
atomic checkpoint writes, the CLI's --resume and final evaluation,
TensorBoard event files, and the CLI's refusal of the keys it cannot
honour. All on the CPU (the plain versions of the kernels)."""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import yaml  # noqa: E402

from _torch_train_cases import poisoned_batches, tiny  # noqa: E402
from dpfx_torch.checkpoint import checkpoint_path  # noqa: E402
from dpfx_torch.compat.params import params_from_flax  # noqa: E402
from dpfx_torch.config import config_from_dict, load_config  # noqa: E402
from dpfx_torch.data import SyntheticDataset, preload_clouds  # noqa: E402
from dpfx_torch.train import TrainDivergedError, Trainer  # noqa: E402
from dpfx_torch.train import __main__ as train_cli  # noqa: E402

QUIET = dict(device="cpu", log_fn=lambda s: None)


def _records(run_dir, kind):
    lines = (run_dir / "metrics.jsonl").read_text().splitlines()
    return [r for r in map(json.loads, lines) if r["kind"] == kind]


def _same_state(a, b):
    return all(torch.equal(u, v) for u, v in (
        (a.params, b.params), (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu),
        (a.opt_state.count, b.opt_state.count), (a.step, b.step))) and a.host_step == b.host_step


# ---------------------------------------------------------------- evaluation

@pytest.mark.parametrize("fused", ["off", "on", "latent"])
def test_evaluate_matches_dpfx(tmp_path, fused):
    """Trainer.evaluate against dpfx's on dpfx's weights moved off the
    identity and carried across with params_from_flax, on batches that carry
    eps (one ragged, one an outlier whose mean swamps the median): the
    kind: val records agree, means and medians, within 1e-5 relative, with
    the fused point flow and encoder off and on (dpfx's Pallas kernels in
    interpret mode on the CPU), and with the fused latent flow too (dz=32).
    The outlier is the clouds scaled by 2: from about 3 on, the random
    latent flow's log-density passes 1e9, relu gates sit within rounding of
    0, and two sums in other orders part by more than 1e-5."""
    from dpfx.config import config_from_dict as jax_config_from_dict
    from dpfx.parallel import create_mesh
    from dpfx.train import Trainer as JaxTrainer

    flags = {"off": {}, "on": {"fused_point_flow": True, "fused_encoder": True},
             "latent": {"fused_point_flow": True, "fused_encoder": True,
                        "fused_latent_flow": True}}[fused]
    raw, jraw = (tiny(ckpt_dir=str(tmp_path / d), **flags) for d in ("port", "jax"))
    if fused == "latent":
        raw["model"]["dz"] = jraw["model"]["dz"] = 32
    dz = raw["model"]["dz"]
    jcfg = jax_config_from_dict(jraw)
    # one device, as the port: on a mesh dpfx draws its own eps for a batch
    # that does not divide over the devices
    jtr = JaxTrainer(jcfg, mesh=create_mesh(jcfg.parallel.axis_name, n_devices=1),
                     log_fn=lambda *a: None)
    rng = np.random.default_rng(0)
    jp = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.normal(size=a.shape).astype(np.float32),
                      jtr.state.params)
    jtr.state = jtr.state.replace(params=jax.tree.map(jnp.asarray, jp))
    tr = Trainer(config_from_dict(raw), **QUIET)
    missing, unexpected = tr.model.load_state_dict(params_from_flax(jp), strict=False)
    assert not unexpected and all(k.endswith("mask") for k in missing)
    flat_at = tr.state.params.data_ptr()

    batches = []
    for i, b in enumerate((4, 4, 4, 3)):
        x = rng.normal(size=(b, 64, 3)).astype(np.float32)
        if i == 2:
            x *= 2       # an outlier batch
        batches.append({"x": x, "eps": rng.normal(size=(b, dz)).astype(np.float32)})
    agg = tr.evaluate(iter(batches))
    jagg = jtr.evaluate(iter(batches))
    rec = _records(tmp_path / "port" / "t", "val")
    jrec = [json.loads(line) for line in open(jtr.metrics_path)]
    assert len(rec) == len(jrec) == 1 and rec[0].keys() == jrec[0].keys() == {
        "kind", "step", *agg}
    assert rec[0]["step"] == jrec[0]["step"] == 0
    assert agg.keys() == jagg.keys() and any(k.endswith("_median") for k in agg)
    for k in jagg:
        np.testing.assert_allclose(agg[k], jagg[k], rtol=1e-5, err_msg=k)
        assert rec[0][k] == agg[k]
    med, mean = agg["neg_elbo_per_point_median"], agg["neg_elbo_per_point"]
    assert mean > 2 * max(abs(med), 1.0)      # the outlier moves the mean, not the median
    # evaluation leaves the parameters and their storage alone
    assert tr.state.params.data_ptr() == flat_at and tr.state.host_step == 0


def test_evaluate_draws_eps_by_batch_index_not_by_step(tmp_path):
    """Without eps in the batches, batch i's eps comes from a generator keyed
    by (train.seed, i): two passes agree, a pass after training steps draws
    the same eps (the metrics change only through the weights), and a pass
    with those eps supplied gives the same numbers."""
    from dpfx_torch.train.trainer import _EVAL_TAG, _generator

    tr = Trainer(config_from_dict(tiny(ckpt_dir=str(tmp_path))), **QUIET)
    rng = np.random.default_rng(1)
    val = [{"x": rng.normal(size=(b, 64, 3)).astype(np.float32)} for b in (4, 3)]
    a, b = tr.evaluate(iter(val)), tr.evaluate(iter(val))
    assert a == b
    eps = [torch.randn((v["x"].shape[0], 16), generator=_generator(0, i, _EVAL_TAG, tr.device))
           for i, v in enumerate(val)]
    assert tr.evaluate(iter({**v, "eps": e.numpy()} for v, e in zip(val, eps))) == a
    tr.fit(iter([{"x": rng.normal(size=(4, 64, 3)).astype(np.float32)}] * 2), steps=2)
    c = tr.evaluate(iter(val))
    assert c != a and tr.evaluate(iter({**v, "eps": e.numpy()} for v, e in zip(val, eps))) == c
    assert [r["step"] for r in _records(tmp_path / "t", "val")] == [0, 0, 0, 2, 2]


# ---------------------------------------------------------------- checkpoints

@pytest.mark.parametrize("keep,kept", [(0, [2, 4, 6]), (1, [6])])
def test_ckpt_keep_retention(tmp_path, keep, kept):
    """tests/test_round5_fixes.py::test_ckpt_keep_retention's run in the
    port: dpfx keeps steps [2, 4, 6] with ckpt_keep 0 and [6] with 1, and so
    does the port, both files of each step and nothing else."""
    raw = {"experiment": "gen", "name": "keep",
           "model": {"dz": 8,
                     "point_flow": {"n_layers": 2, "hidden": 16, "n_hidden": 1},
                     "latent_flow": {"n_layers": 2, "hidden": 16, "n_hidden": 1},
                     "encoder": {"point_widths": [16, 32], "head_widths": [16]}},
           "data": {"dataset": "synthetic", "n_points": 32, "synthetic_size": 16,
                    "device_resident": True},
           "train": {"batch_size": 8, "steps": 6, "steps_per_call": 2, "lr": 1e-3,
                     "log_every": 100, "ckpt_every": 2, "eval_every": 1000,
                     "ckpt_dir": str(tmp_path), "ckpt_keep": keep}}
    tr = Trainer(config_from_dict(raw), **QUIET)
    tr.fit_resident(preload_clouds(SyntheticDataset(size=16, n_stored=32, split="train")))
    assert tr.ckpt.all_steps() == kept
    names = sorted(p.name for p in (tmp_path / "keep").iterdir() if p.name != "metrics.jsonl")
    assert names == sorted([f"params_{s:08d}.pt" for s in kept]
                           + [f"state_{s:08d}.ckpt" for s in kept])


def test_atomic_writes_and_layout(tmp_path):
    """A half-written step (its state file whole, its params file still under
    the temporary name) is not the latest, for the trainer and for the eval
    CLIs' checkpoint_path; a checkpoint of another layout refuses to
    restore."""
    raw = tiny(ckpt_dir=str(tmp_path), ckpt_every=2, steps=2)
    tr = Trainer(config_from_dict(raw), **QUIET)
    tr.fit(iter([{"x": np.random.default_rng(2).normal(size=(4, 64, 3)).astype(np.float32)}] * 2))
    d = tmp_path / "t"
    assert not list(d.glob("*.tmp")) and tr.ckpt.all_steps() == [2]
    spath, ppath = tr.ckpt.paths(4)
    torch.save({"step": 4}, spath)
    (d / "params_00000004.pt.tmp").write_bytes(b"half")
    assert tr.ckpt.all_steps() == [2] and tr.ckpt.latest_step() == 2
    assert checkpoint_path(config_from_dict(raw)) == (str(d / "params_00000002.pt"), 2)
    assert Trainer(config_from_dict(raw), **QUIET).maybe_resume() == 2

    other = tiny(ckpt_dir=str(tmp_path))
    other["model"]["point_flow"]["hidden"] = 16
    with pytest.raises(ValueError, match="layout"):
        Trainer(config_from_dict(other), **QUIET).maybe_resume()


def test_restore_writes_into_the_state_in_place(tmp_path):
    """A restore copies into the state's tensors: the flat buffer, the
    moments and the counters keep their storage, every parameter stays a
    view of the flat buffer (a write to the buffer shows in the model), and
    the restored values are the saved ones."""
    raw = tiny(ckpt_dir=str(tmp_path), ckpt_every=3, steps=3)
    rng = np.random.default_rng(3)
    batches = [{"x": rng.normal(size=(4, 64, 3)).astype(np.float32)} for _ in range(3)]
    first = Trainer(config_from_dict(raw), **QUIET)
    first.fit(iter(batches))
    tr = Trainer(config_from_dict(raw), **QUIET)
    st = tr.state
    held = [t.data_ptr() for t in (st.params, st.opt_state.mu, st.opt_state.nu,
                                   st.opt_state.count, st.step)]
    views = [p.data_ptr() for p in tr.model.parameters()]
    assert tr.maybe_resume() == 3
    assert [t.data_ptr() for t in (st.params, st.opt_state.mu, st.opt_state.nu,
                                   st.opt_state.count, st.step)] == held
    assert [p.data_ptr() for p in tr.model.parameters()] == views
    assert _same_state(tr.state, first.state)
    o = 0
    for p in tr.model.parameters():
        assert p.untyped_storage().data_ptr() == st.params.untyped_storage().data_ptr()
        assert torch.equal(p.reshape(-1), st.params[o:o + p.numel()])
        o += p.numel()
    with torch.no_grad():
        st.params.zero_()
    assert all(not p.any() for p in tr.model.parameters())


# ---------------------------------------------------------------- resume

@pytest.mark.parametrize("spc", [1, 2])
def test_resume_on_host_batches_equals_the_uninterrupted_run(tmp_path, spc):
    """Six steps on host batches, against three, a checkpoint, then a new
    trainer that resumes and is fed the batches from the restored step on:
    params, moments, count and step equal bit for bit (the schedule keeps
    train.steps' horizon: the first run stops early through fit(steps=))."""
    rng = np.random.default_rng(4)
    batches = [{"x": rng.normal(size=(4, 64, 3)).astype(np.float32)} for _ in range(6)]

    def trainer(name):
        raw = tiny(ckpt_dir=str(tmp_path / name), steps=6, log_every=2, ckpt_every=100,
                   steps_per_call=spc, augment_noise=0.02, grad_clip=1.0)
        return Trainer(config_from_dict(raw), **QUIET)

    whole = trainer("a")
    whole.fit(iter(batches))
    part = trainer("b")
    part.fit(iter(batches), steps=3)
    assert part.ckpt.all_steps() == [3]
    resumed = trainer("b")
    assert resumed.maybe_resume() == 3
    resumed.fit(iter(batches[3:]))
    assert _same_state(resumed.state, whole.state)
    assert resumed.ckpt.all_steps() == [3, 6]


def test_resume_on_the_resident_split_equals_the_uninterrupted_run(tmp_path):
    """The resident split's draws are keyed by the absolute step, so a
    resumed resident run draws what the uninterrupted one drew: five steps
    in calls of 2, against a run stopped at 3 (calls of 2 and 1) and a
    resumed one (2) that gets no batches fed, bit for bit."""
    clouds = preload_clouds(SyntheticDataset(size=12, n_stored=80, split="train"))

    def trainer(name):
        raw = tiny(ckpt_dir=str(tmp_path / name), steps=5, log_every=2, ckpt_every=100,
                   steps_per_call=2, augment_noise=0.02)
        return Trainer(config_from_dict(raw), **QUIET)

    whole = trainer("a")
    whole.fit_resident(clouds)
    trainer("b").fit_resident(clouds, steps=3)
    resumed = trainer("b")
    assert resumed.maybe_resume() == 3
    resumed.fit_resident(clouds)
    assert _same_state(resumed.state, whole.state)


# ---------------------------------------------------------------- recovery

def _poisoned(raw, poison_after):
    """A trainer on ``raw``, a make_batches whose first stream carries an
    inf from batch ``poison_after + 1`` on, its calls and the log."""
    logs, calls = [], []
    tr = Trainer(config_from_dict(raw), device="cpu", log_fn=logs.append)
    return tr, poisoned_batches(calls, 4, 64, poison_after), calls, logs


def test_fit_auto_recovers_from_divergence(tmp_path):
    """tests/test_train.py::test_fit_auto_recovers_from_divergence in the
    port: a stream poisoned from the start, no checkpoint yet, so the state
    is re-initialised in place; one restart, the run ends at step 40, lr is
    halved. With recovery off the same stream raises."""
    raw = tiny(ckpt_dir=str(tmp_path / "a"), steps=40, log_every=2, ckpt_every=1000,
               abort_after_skipped_windows=3, recover_on_divergence=True, max_recoveries=2)
    tr, make_batches, calls, logs = _poisoned(raw, 0)
    flat_at = tr.state.params.data_ptr()
    state = tr.fit_auto(make_batches)
    assert len(calls) == 2 and state.step == state.host_step == 40
    assert tr.cfg.train.lr == pytest.approx(0.5e-3)
    assert any("restored step 0" in line for line in logs), logs
    assert state.params.data_ptr() == flat_at and bool(torch.isfinite(state.params).all())

    raw2 = tiny(ckpt_dir=str(tmp_path / "b"), steps=40, log_every=2, ckpt_every=1000,
                abort_after_skipped_windows=3)
    tr2, make_batches2, _, _ = _poisoned(raw2, 0)
    with pytest.raises(TrainDivergedError):
        tr2.fit_auto(make_batches2)


def test_fit_auto_restores_checkpoint_on_recovery(tmp_path):
    """tests/test_train.py::test_fit_auto_restores_checkpoint_on_recovery in
    the port: healthy for 20 steps, then poisoned; the checkpoint that falls
    in the fully-skipped phase (step 24) is skipped, the recovery restores
    step 20 at half the lr on a new optimizer and train steps (the old
    graph released), and the run ends at step 40 from the restarted
    stream, with steps_per_call 2 as on the card."""
    raw = tiny(ckpt_dir=str(tmp_path), steps=40, log_every=2, ckpt_every=4, steps_per_call=2,
               abort_after_skipped_windows=3, recover_on_divergence=True)
    tr, make_batches, calls, logs = _poisoned(raw, 20)
    multi, tx = tr.multi_step, tr.tx
    state = tr.fit_auto(make_batches)
    assert state.step == state.host_step == 40 and len(calls) == 2
    assert any("restored step 20" in line for line in logs), logs
    assert any("skipping checkpoint at step 24" in line for line in logs), logs
    assert tr.cfg.train.lr == pytest.approx(0.5e-3) and tr.tx.schedule(10**6) > 0
    assert tr.multi_step is not multi and tr.tx is not tx
    assert tr.ckpt.latest_step() == 40 and bool(torch.isfinite(state.params).all())


# ---------------------------------------------------------------- the CLI

def _yaml(tmp_path, **train):
    raw = tiny(ckpt_dir=str(tmp_path / "ck"), **train)
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_cli_resume_and_final_evaluation(tmp_path, capsys):
    """The CLI on the resident split: 6 steps with eval_every=2 evaluate at
    2, 4 and 6 and not once more at the end; with eval_every=4 the final
    evaluation at 6 is the CLI's own. Then step 6's files are removed (a
    crash after step 4's checkpoint), and --resume continues from step 4 to
    the same step-6 parameters bit for bit; params_<step>.pt stays readable
    by checkpoint_path."""
    cfg = _yaml(tmp_path, steps=6, log_every=2, ckpt_every=2, ckpt_keep=0, steps_per_call=2,
                eval_every=2)
    d = tmp_path / "ck" / "t"
    assert train_cli.main([cfg, "data.device_resident=true", "--device", "cpu"]) == 0
    assert [r["step"] for r in _records(d, "val")] == [2, 4, 6]
    assert all(np.isfinite(v) for r in _records(d, "val") for v in r.values()
               if not isinstance(v, str))
    whole = torch.load(d / "params_00000006.pt", weights_only=True)
    whole_state = torch.load(d / "state_00000006.ckpt", weights_only=True)
    for name in ("params_00000006.pt", "state_00000006.ckpt"):
        (d / name).unlink()
    assert train_cli.main([cfg, "data.device_resident=true", "train.eval_every=4", "--resume",
                           "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "step 6/6" in out
    assert [r["step"] for r in _records(d, "val")] == [2, 4, 6, 6]
    assert [r["step"] for r in _records(d, "train")] == [2, 4, 6, 6]
    again = torch.load(d / "params_00000006.pt", weights_only=True)
    assert all(torch.equal(again[k], v) for k, v in whole.items())
    state = torch.load(d / "state_00000006.ckpt", weights_only=True)
    assert all(torch.equal(state[k], whole_state[k]) for k in ("mu", "nu"))
    assert state["count"] == whole_state["count"] == 6
    assert checkpoint_path(load_config(cfg))[1] == 6


def test_tensorboard_events_equal_metrics_jsonl(tmp_path, monkeypatch):
    """train.tensorboard: event files under <run>/tb whose scalars, tagged
    {kind}/{key} at their step, equal metrics.jsonl's numbers."""
    import sys
    import types

    pytest.importorskip("tensorboard")
    # tensorboard's own stand-in for TensorFlow (its "notf" build): the event
    # files are the same, and importing TensorFlow would take most of the test
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf",
                        types.ModuleType("tensorboard.compat.notf"))
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    raw = tiny(ckpt_dir=str(tmp_path), steps=4, log_every=2, ckpt_every=100, eval_every=2,
               tensorboard=True)
    tr = Trainer(config_from_dict(raw), **QUIET)
    rng = np.random.default_rng(5)
    val = [{"x": rng.normal(size=(3, 64, 3)).astype(np.float32)}]
    tr.fit(iter([{"x": rng.normal(size=(4, 64, 3)).astype(np.float32)}] * 4),
           val_batches_fn=lambda: iter(val))
    tr.writer.close()
    acc = EventAccumulator(str(tmp_path / "t" / "tb"))
    acc.Reload()
    records = [json.loads(line) for line in (tmp_path / "t" / "metrics.jsonl").read_text()
               .splitlines()]
    want = {(f"{r['kind']}/{k}", r["step"]): v for r in records for k, v in r.items()
            if k not in ("kind", "step")}
    got = {(tag, e.step): e.value for tag in acc.Tags()["scalars"] for e in acc.Scalars(tag)}
    assert {r["kind"] for r in records} == {"train", "val"} and len(records) == 4
    assert got.keys() == want.keys()
    for key, v in want.items():
        assert got[key] == pytest.approx(v, rel=1e-6), key


@pytest.mark.parametrize(
    "over,needs", [("parallel.coordinator=localhost:1234", "num_processes and parallel.process_id"),
                   ("parallel.num_processes=2", "needs parallel.coordinator")],
    ids=["parallel.coordinator=localhost:1234-#8", "parallel.num_processes=2-#8"])
def test_cli_refuses_keys_it_cannot_honour(tmp_path, over, needs):
    """Data parallel is ported (tests/test_torch_parallel.py), so these keys
    are honoured; alone, neither can make this process a rank, and the CLI
    names what is missing before it starts anything."""
    with pytest.raises(ValueError, match=needs):
        train_cli.main([_yaml(tmp_path), over, "--device", "cpu"])
