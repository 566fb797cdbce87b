"""Training from a packed stack in the port: Trainer.fit over the native
loader (one worker) equals Trainer.fit over the same batches as a list,
bit for bit, in calls of steps_per_call and single steps; the training CLI
with data.packed_path finishes, writes metrics.jsonl and closes its
loaders; a divergence recovery restarts the stream from a new loader. On
the CPU (the plain versions of the kernels)."""

import json

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402
import yaml  # noqa: E402

from _torch_train_cases import tiny  # noqa: E402
from dpfx_torch import native  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.tools import pack_dataset  # noqa: E402
from dpfx_torch.train import TrainDivergedError, Trainer  # noqa: E402
from dpfx_torch.train import __main__ as train_cli  # noqa: E402

QUIET = dict(device="cpu", log_fn=lambda s: None)


def _same_state(a, b):
    return all(torch.equal(u, v) for u, v in (
        (a.params, b.params), (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu),
        (a.opt_state.count, b.opt_state.count), (a.step, b.step))) and a.host_step == b.host_step


@pytest.fixture(scope="module")
def packed(tmp_path_factory):
    d = tmp_path_factory.mktemp("packed")
    cfg = d / "c.yaml"
    cfg.write_text(yaml.safe_dump(tiny(ckpt_dir=str(d / "ck"))))
    out = d / "train.npy"
    assert pack_dataset.main([str(cfg), "--out", str(out), "--n-stored", "128"]) == 0
    return str(out)


@pytest.mark.parametrize("spc", [1, 3])
def test_fit_on_the_loader_equals_fit_on_its_batches(tmp_path, packed, spc):
    """7 steps: at steps_per_call=3 two calls of 3 stacked host batches and
    a single step."""
    cfg = config_from_dict(tiny(steps=7, steps_per_call=spc, log_every=2,
                                ckpt_every=100, ckpt_dir=str(tmp_path / "a")))
    nb = native.NativeBatcher(packed, 4, 64, seed=3, n_workers=1)
    batches = [nb.next() for _ in range(7)]
    nb.close()
    ref = Trainer(cfg, **QUIET)
    ref.fit(iter([{"x": x} for x in batches]))
    cfg.train.ckpt_dir = str(tmp_path / "b")
    ours = Trainer(cfg, **QUIET)
    nb = native.NativeBatcher(packed, 4, 64, seed=3, n_workers=1)
    try:
        ours.fit(iter(nb))
    finally:
        nb.close()
    assert ours.state.host_step == 7 and _same_state(ours.state, ref.state)


class _Tracked(native.NativeBatcher):
    opened: list = []

    def __init__(self, *a, **k):
        super().__init__(*a, **k)
        _Tracked.opened.append(self)


def _cli_yaml(tmp_path, packed, **train):
    raw = tiny(ckpt_dir=str(tmp_path / "ck"), **train)
    raw["data"]["packed_path"] = packed
    path = tmp_path / "c.yaml"
    path.write_text(yaml.safe_dump(raw))
    return str(path)


def test_cli_trains_from_the_packed_stack(tmp_path, packed, monkeypatch, capsys):
    monkeypatch.setattr(native, "NativeBatcher", _Tracked)
    _Tracked.opened = []
    cfg = _cli_yaml(tmp_path, packed, steps=7, steps_per_call=3, log_every=3, ckpt_every=7,
                    eval_every=100)
    assert train_cli.main([cfg, "--device", "cpu"]) == 0
    text = capsys.readouterr().out
    assert f"native loader: 32 clouds x 128 pts from {packed}; steps_per_call=3" in text
    assert len(_Tracked.opened) == 1 and not _Tracked.opened[0]._h     # closed at the end
    assert _Tracked.opened[0].n_points == 64 and _Tracked.opened[0].batch_size == 4
    records = [json.loads(s) for s in (tmp_path / "ck" / "t" / "metrics.jsonl").read_text()
               .splitlines()]
    train = [r for r in records if r["kind"] == "train"]
    assert [r["step"] for r in train] == [3, 6, 7]
    assert all(np.isfinite(r["loss"]) for r in train)
    assert [r["step"] for r in records if r["kind"] == "val"] == [7]
    # the resident split still comes first
    assert train_cli.main([cfg, "data.device_resident=true", "train.steps=2", "--device",
                           "cpu"]) == 0
    assert "device-resident split" in capsys.readouterr().out and len(_Tracked.opened) == 1


def test_recovery_restarts_the_stream_from_a_new_loader(tmp_path, monkeypatch, capsys):
    """A stack of clouds holding an inf: every step is skipped, the run
    diverges, the recovery opens a new loader (the old one closed) and the
    run diverges again past max_recoveries."""
    bad = np.random.default_rng(0).normal(size=(8, 128, 3)).astype(np.float32)
    bad[:, :, 0] = np.inf
    stack = tmp_path / "bad.npy"
    np.save(stack, bad)
    monkeypatch.setattr(native, "NativeBatcher", _Tracked)
    _Tracked.opened = []
    cfg = _cli_yaml(tmp_path, str(stack), steps=8, log_every=1, ckpt_every=100,
                    abort_after_skipped_windows=2, recover_on_divergence=True, max_recoveries=1)
    with pytest.raises(TrainDivergedError):
        train_cli.main([cfg, "--device", "cpu"])
    assert capsys.readouterr().out.count("native loader: 8 clouds x 128 pts") == 2
    assert len(_Tracked.opened) == 2 and not any(nb._h for nb in _Tracked.opened)
