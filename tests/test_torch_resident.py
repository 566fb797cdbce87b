"""The device-resident split (data.device_resident) in the port: the
resident multi-step fed dpfx's _resident_draw against dpfx's
make_resident_multi_step on the same stack; the port's own draw rules
(resident_draw: the epoch walk, iid ids, the point subsample, resume
stability); preload_clouds' validation; and the training CLI with
steps_per_call and device_resident on the CPU."""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import yaml  # noqa: E402

from _torch_train_cases import tanh_jitter, tiny  # noqa: E402
from dpfx.train import trainer as jtrainer  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.data import SyntheticDataset, preload_clouds  # noqa: E402
from dpfx_torch.train import (  # noqa: E402
    Trainer,
    gather_resident,
    make_resident_multi_step,
    make_train_step,
    resident_draw,
)
from dpfx_torch.train import __main__ as train_cli  # noqa: E402
from test_torch_multi_step import assert_state_close, pair  # noqa: E402

CPU = torch.device("cpu")


@pytest.mark.parametrize("p", [64, 100])
def test_resident_step_on_jax_draws_matches_jax(p):
    """Three resident steps fed dpfx's _resident_draw (cloud ids, point ids,
    eps and the jitter's xnoise, by dpfx's in-step recipe) against dpfx's
    make_resident_multi_step on the same [S, P, 3] stack and rng, with the
    stored size equal to n_points (no subsample) and above it (the top-N
    subsample)."""
    raw = tanh_jitter()
    cfg, jcfg, model, tx, state, jmodel, jtx, jstate = pair(raw)
    s, k, b, n, dz = 12, 3, 4, 64, 16
    data = np.random.default_rng(7).normal(size=(s, p, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    ci, pi, eps, xn = jtrainer._resident_draw(rng, jnp.zeros((), jnp.int32), k, b, s, p, n, dz,
                                              draw=jcfg.data.resident_draw, xnoise=True)
    draws = tuple(torch.from_numpy(np.array(a)) for a in (ci, pi, eps, xn))
    draws = (draws[0].long(), draws[1].long()) + draws[2:]
    state, m = make_resident_multi_step(model, tx, cfg)(state, torch.from_numpy(data),
                                                        draws=draws)
    jstate, jm = jtrainer.make_resident_multi_step(jmodel, jtx, jcfg, None, k)(
        jstate, jnp.asarray(data), rng)
    assert m["loss"].shape == (k,)
    np.testing.assert_allclose(m["loss"].numpy(), np.asarray(jm["loss"]), rtol=1e-4)
    adam = assert_state_close(model, state, jstate, f"P={p}")
    assert state.step == int(jstate.step) == state.host_step == k
    assert state.opt_state.count == int(adam.count) == k


def test_resident_call_equals_eager_steps_on_its_draws():
    """A resident call is the eager step on the batches and noise its draw
    chose: bit for bit on the CPU (the card holds the replays to the same)."""
    raw = tanh_jitter(batch_size=4)
    raw["data"]["n_points"] = 32
    data = torch.from_numpy(np.random.default_rng(8).normal(size=(10, 50, 3)).astype(np.float32))
    out = []
    for resident in (True, False):
        cfg, _, model, tx, state, *_ = pair(raw, seed=2)
        if resident:
            state, _ = make_resident_multi_step(model, tx, cfg)(state, data, 4)
        else:
            ci, pi, eps, xn = resident_draw(cfg, 0, 4, 10, 50, CPU)
            x = gather_resident(data, ci, pi)
            step = make_train_step(model, tx, cfg)
            for i in range(4):
                state, _ = step(state, {"x": x[i], "eps": eps[i], "xnoise": xn[i]})
        out.append((state.params.clone(), state.opt_state.nu.clone()))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def _cfg(**data):
    raw = tiny(batch_size=8)
    raw["data"].update(data)
    return config_from_dict(raw)


def test_epoch_draw_walks_a_permutation_per_epoch():
    """resident_draw="epoch" (the default): each epoch of s // B batches is
    a permutation of the split, reshuffled from epoch to epoch; a call that
    starts mid-epoch and spans two epochs, and one that starts at step 2
    (a resume), draw exactly the rows, points and noise of the long call."""
    cfg = _cfg()
    s, p = 24, 100                       # 3 batches of 8 an epoch
    ci, pi, eps, xn = resident_draw(cfg, 0, 6, s, p, CPU)
    assert ci.shape == (6, 8) and ci.dtype == torch.int64
    e0, e1 = ci[:3].reshape(-1), ci[3:].reshape(-1)
    assert sorted(e0.tolist()) == list(range(s)) == sorted(e1.tolist())
    assert not torch.equal(e0, e1)
    # from step 2: epoch 0's last batch, then epoch 1's first two
    ci2, pi2, eps2, xn2 = resident_draw(cfg, 2, 3, s, p, CPU)
    for a, b in ((ci2, ci[2:5]), (pi2, pi[2:5]), (eps2, eps[2:5])):
        assert torch.equal(a, b)
    assert xn is None and xn2 is None    # no jitter in this config


def test_epoch_draw_drops_the_ragged_tail_and_takes_tiny_splits():
    cfg = _cfg()
    ci, _, _, _ = resident_draw(cfg, 0, 3, 26, 64, CPU)       # 26 clouds: 3 batches, 2 left out
    assert len(set(ci.reshape(-1).tolist())) == 24
    ci, _, _, _ = resident_draw(cfg, 0, 2, 5, 64, CPU)        # B > S: one batch an epoch
    for row in ci:                      # the epoch's permutation, then its start again
        assert sorted(row[:5].tolist()) == list(range(5)) and torch.equal(row[5:], row[:3])


def test_iid_draw_bounds_and_points():
    """resident_draw="iid": uniform ids within the split, a new draw each
    step; the point subsample is without replacement (top N of uniform
    keys) when P > N, and uniform with replacement when P < N, as
    sample_cloud falls back."""
    cfg = _cfg(resident_draw="iid", n_points=32)
    ci, pi, eps, _ = resident_draw(cfg, 5, 4, 24, 100, CPU)
    assert ci.min() >= 0 and ci.max() < 24 and not torch.equal(ci[0], ci[1])
    assert pi.shape == (4, 8, 32) and pi.min() >= 0 and pi.max() < 100
    assert all(len(set(row.tolist())) == 32 for row in pi.reshape(-1, 32))
    assert eps.shape == (4, 8, 16)
    cfg = _cfg(resident_draw="iid", n_points=64)
    _, pi, _, _ = resident_draw(cfg, 0, 3, 24, 32, CPU)
    assert pi.shape == (3, 8, 64) and pi.min() >= 0 and pi.max() < 32
    _, pi, _, _ = resident_draw(cfg, 0, 3, 24, 64, CPU)
    assert pi is None
    with pytest.raises(ValueError, match="resident_draw"):
        resident_draw(_cfg(resident_draw="sorted"), 0, 1, 24, 64, CPU)


def test_gather_resident_takes_the_drawn_points():
    data = torch.arange(4 * 6 * 3, dtype=torch.float32).reshape(4, 6, 3)
    ci = torch.tensor([[2, 0]])
    pi = torch.tensor([[[5, 1], [0, 3]]])
    x = gather_resident(data, ci, pi)
    assert torch.equal(x, torch.stack([torch.stack([data[2, [5, 1]], data[0, [0, 3]]])]))
    assert torch.equal(gather_resident(data, ci, None), data[ci])


def test_preload_clouds_validates():
    ds = SyntheticDataset(size=6, n_stored=40, split="train")
    stack = preload_clouds(ds)
    assert stack.shape == (6, 40, 3) and stack.dtype == np.float32
    np.testing.assert_array_equal(stack[4], ds[4])
    np.testing.assert_array_equal(preload_clouds(ds, indices=[5, 1]), stack[[5, 1]])

    class Ragged:
        def __len__(self):
            return 3

        def __getitem__(self, i):
            return np.zeros((8 + i, 3), np.float32)

    with pytest.raises(ValueError, match="uniform cloud shapes"):
        preload_clouds(Ragged())
    with pytest.raises(ValueError, match="empty"):
        preload_clouds(ds, indices=[])


def _yaml(tmp_path, **train):
    raw = tiny(ckpt_dir=str(tmp_path / "ck"), log_every=2, ckpt_every=3, **train)
    tmp_path.mkdir(parents=True, exist_ok=True)
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_train_cli_resident_with_steps_per_call(tmp_path, capsys):
    """The CLI with steps_per_call=3 and device_resident for 7 steps: calls
    of 3, 3 and a tail of 1; a log record and a checkpoint where a call
    crosses log_every=2 or ckpt_every=3, and at the last step; no line
    saying a knob is ignored."""
    cfg = _yaml(tmp_path, steps_per_call=3)
    assert train_cli.main([cfg, "train.steps=7", "data.device_resident=true", "--device",
                           "cpu"]) == 0
    out = capsys.readouterr().out
    assert "ignored" not in out
    assert "device-resident split: 32 clouds x 4096 stored pts (2 MB -> cpu)" in out
    assert "steps_per_call=3" in out and "step 7/7" in out
    d = tmp_path / "ck" / "t"
    recs = [json.loads(line) for line in (d / "metrics.jsonl").read_text().splitlines()]
    train = [r for r in recs if r["kind"] == "train"]
    assert [r["step"] for r in train] == [3, 6, 7]
    assert all(np.isfinite(r["loss"]) and r["nonfinite_skipped"] == 0 for r in train)
    # eval_every (1000) is not crossed: the CLI evaluates once, at the end
    assert [(r["kind"], r["step"]) for r in recs if r["kind"] != "train"] == [("val", 7)]
    assert sorted(p.name for p in d.glob("*.pt")) == [f"params_{s:08d}.pt" for s in (3, 6, 7)]


def test_fit_resident_calls_equal_single_steps(tmp_path):
    """fit_resident at steps_per_call=3 (calls of 3, 3, 1) trains the same
    parameters as at steps_per_call=1 on the same split: the draws are keyed
    by the absolute step, so a call's grouping changes nothing."""
    clouds = preload_clouds(SyntheticDataset(size=12, n_stored=80, split="train"))
    params = []
    for spc in (3, 1):
        raw = yaml.safe_load(open(_yaml(tmp_path / str(spc), steps=7, steps_per_call=spc)))
        trainer = Trainer(config_from_dict(raw), device="cpu", log_fn=lambda s: None)
        trainer.fit_resident(clouds)
        assert trainer.state.host_step == 7 and trainer.state.step == 7
        params.append(trainer.state.params.clone())
    assert torch.equal(*params)


@pytest.mark.parametrize("over", ["parallel.resident_sharding=sharded", "parallel.data_axis=2"])
def test_train_cli_refuses_more_than_one_gpu(tmp_path, over, monkeypatch):
    """Data parallel is ported (tests/test_torch_parallel.py); what the CLI
    refuses is more cards than are visible: two asked for on a one-card
    machine, with the resident stack sharded or replicated, raises before
    anything touches a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="data_axis=2 cards requested but only 1 are visible"):
        train_cli.main([_yaml(tmp_path), "data.device_resident=true", over,
                        "parallel.data_axis=2"])
