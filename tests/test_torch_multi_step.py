"""K train steps per call (dpfx_torch.train.make_multi_step) against dpfx's
make_multi_step on the same weights, stacked batches and noise; the step's
device-side scalars (the learning rate from the optimizer's count, the
jitter sigma from the step) against optax's schedules and dpfx's
_aug_sigma; and Trainer.fit's groups of steps_per_call host batches. On the
CPU a multi-step runs the eager step K times: the CUDA graph's replays are
held to eager steps in tests/test_torch_cuda.py."""

import json

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import yaml  # noqa: E402

from _torch_train_cases import tanh_jitter, tiny  # noqa: E402
from dpfx.config import config_from_dict as jax_config_from_dict  # noqa: E402
from dpfx.models import DPF as JaxDPF  # noqa: E402
from dpfx.train import trainer as jtrainer  # noqa: E402
from dpfx_torch.compat import params_to_flax, randomize_  # noqa: E402
from dpfx_torch.config import config_from_dict  # noqa: E402
from dpfx_torch.models import DPF  # noqa: E402
from dpfx_torch.train import (  # noqa: E402
    Trainer,
    init_state,
    make_multi_step,
    make_optimizer,
    make_schedule,
    make_train_step,
)
from dpfx_torch.train import trainer as ttrainer  # noqa: E402


def _named(flat_tensor, model):
    out, o = {}, 0
    for k, p in model.named_parameters():
        out[k] = flat_tensor[o:o + p.numel()].view_as(p)
        o += p.numel()
    return out


def pair(raw, seed=1):
    """The port's model, optimizer and state, and dpfx's on the same weights."""
    cfg, jcfg = config_from_dict(raw), jax_config_from_dict(raw)
    torch.manual_seed(seed)         # the modules' own init
    model = randomize_(DPF(cfg), seed, 0.05)
    tx = make_optimizer(cfg.train)
    state = init_state(model, tx)
    jtx = jtrainer.make_optimizer(jcfg.train)
    # copies: jnp.asarray may alias the numpy views of the torch buffers, which
    # the port's steps update in place
    jp = jax.tree.map(lambda a: jnp.asarray(np.array(a)), params_to_flax(model.state_dict()))
    jstate = jtrainer.TrainState(step=jnp.zeros((), jnp.int32), params=jp, opt_state=jtx.init(jp))
    return cfg, jcfg, model, tx, state, JaxDPF(jcfg), jtx, jstate


def assert_state_close(model, state, jstate, what=""):
    """Params, mu and nu at the trajectory test's limits (rtol 1e-3, atol 1e-6)."""
    adam = jstate.opt_state[1][0]
    got = params_to_flax({k: v for k, v in model.named_parameters()})
    for name, tree in (("params", (got, jstate.params)),
                       ("mu", (params_to_flax(_named(state.opt_state.mu, model)),
                               {"params": adam.mu["params"]})),
                       ("nu", (params_to_flax(_named(state.opt_state.nu, model)),
                               {"params": adam.nu["params"]}))):
        a, b = (jax.tree.leaves(t) for t in tree)
        for u, v in zip(a, b):
            np.testing.assert_allclose(np.asarray(u), np.asarray(v), rtol=1e-3, atol=1e-6,
                                       err_msg=f"{what} {name}")
    return adam


def stacked_batches(rng, k, b=4, n=64, dz=16, bad=None):
    x = rng.normal(size=(k, b, n, 3)).astype(np.float32)
    if bad is not None:
        x[bad, 1, 5, 0] = np.inf
    return {"x": x, "eps": rng.normal(size=(k, b, dz)).astype(np.float32),
            "xnoise": rng.normal(size=(k, b, n, 3)).astype(np.float32)}


def test_multi_step_matches_jax_make_multi_step():
    """One call of K=3 steps against dpfx's scan of three steps on the same
    stacked batches, eps and xnoise, under the annealed jitter and the
    clipped, warmed-up schedule; the second step's batch holds an inf, so
    that step is skipped in both (count and moments kept, step advanced)."""
    cfg, jcfg, model, tx, state, jmodel, jtx, jstate = pair(tanh_jitter())
    batches = stacked_batches(np.random.default_rng(0), 3, bad=1)
    state, m = make_multi_step(model, tx, cfg)(
        state, {k: torch.from_numpy(v) for k, v in batches.items()})
    jstate, jm = jtrainer.make_multi_step(jmodel, jtx, jcfg, steps_per_call=3)(
        jstate, {k: jnp.asarray(v) for k, v in batches.items()}, jax.random.PRNGKey(0))
    assert set(m) == set(jm) and all(v.shape == (3,) for v in m.values())
    np.testing.assert_array_equal(m["nonfinite_skipped"].numpy(), [0.0, 1.0, 0.0])
    np.testing.assert_array_equal(np.asarray(jm["nonfinite_skipped"]), [0.0, 1.0, 0.0])
    for i in (0, 2):
        for key in ("loss", "grad_norm", "kl"):
            np.testing.assert_allclose(float(m[key][i]), float(jm[key][i]), rtol=1e-4,
                                       err_msg=f"step {i} {key}")
    adam = assert_state_close(model, state, jstate, "after K=3")
    assert state.step == int(jstate.step) == state.host_step == 3
    assert state.opt_state.count == int(adam.count) == 2


def test_multi_step_equals_eager_steps_with_drawn_noise():
    """Without supplied noise, a call of K steps draws each step's eps and
    jitter from the generators an eager step at that step uses: on the CPU
    the two runs agree bit for bit, metrics included, across two calls."""
    raw = tanh_jitter()
    runs = []
    for multi in (True, False):
        cfg = config_from_dict(raw)
        torch.manual_seed(3)
        model = randomize_(DPF(cfg), 3, 0.05)
        tx = make_optimizer(cfg.train)
        state = init_state(model, tx)
        x = torch.from_numpy(np.random.default_rng(4).normal(size=(5, 4, 64, 3)).astype(np.float32))
        if multi:
            fn = make_multi_step(model, tx, cfg)
            state, m1 = fn(state, {"x": x[:3]})
            state, m2 = fn(state, {"x": x[3:]})
            losses = torch.cat([m1["loss"], m2["loss"]])
        else:
            step = make_train_step(model, tx, cfg)
            losses = []
            for i in range(5):
                state, m = step(state, {"x": x[i]})
                losses.append(m["loss"])
            losses = torch.stack(losses)
        runs.append((state.params.clone(), state.opt_state.mu.clone(), losses, state.host_step))
    (pa, ma, la, ha), (pb, mb, lb, hb) = runs
    assert ha == hb == 5
    assert torch.equal(pa, pb) and torch.equal(ma, mb) and torch.equal(la, lb)


SCHEDULES = [
    dict(lr_schedule="cosine", lr_warmup_steps=3, steps=20),
    dict(lr_schedule="cosine", lr_decay_steps=12, steps=20, lr_min_ratio=0.1),
    dict(lr_schedule="cosine", steps=1000, lr_min_ratio=0.0),
    dict(lr_schedule="step", lr_warmup_steps=2, steps=22),
    dict(lr_schedule="step", steps=3),
    dict(lr_schedule="constant", lr_warmup_steps=4, steps=10),
    # the flagship's: 1000 warmup steps inside a 100k-step cosine horizon
    dict(lr_schedule="cosine", lr_warmup_steps=1000, steps=100000),
]


@pytest.mark.parametrize("over", SCHEDULES)
def test_device_schedule_matches_optax_over_the_horizon(over):
    """The learning rate a step computes on the device from the optimizer's
    int32 count, against optax's schedule on int32 counts (what optax's own
    count is), for every count of the horizon and past it. Both compute in
    float32 in the same order; only torch's and XLA's cosf differ, in the
    last ulp of a few percent of the counts, so the limit is 2 ulp of lr.
    Without a cosine the two agree bit for bit."""
    tcfg = config_from_dict(tiny(**over)).train
    counts = np.arange((tcfg.lr_decay_steps or tcfg.steps) + 5, dtype=np.int32)
    got = make_schedule(tcfg)(torch.from_numpy(counts))
    want = np.asarray(jtrainer.make_schedule(jax_config_from_dict(tiny(**over)).train)(
        jnp.asarray(counts)))
    assert got.dtype == torch.float32 and got.shape == counts.shape
    if over["lr_schedule"] == "cosine":
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=2 * np.spacing(np.float32(tcfg.lr)))
    else:
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("over", [
    dict(augment_noise=0.05, augment_noise_final=0.01, augment_noise_anneal_steps=4),
    dict(augment_noise=0.01, augment_noise_final=0.001, augment_noise_anneal_steps=70000,
         steps=100000),
    dict(augment_noise=0.01),
])
def test_device_jitter_sigma_matches_jax(over):
    """The jitter sigma from the device step counter against dpfx's
    _aug_sigma on int32 steps, over the whole horizon: bit for bit."""
    tcfg = config_from_dict(tiny(**over)).train
    steps = np.arange(tcfg.steps + 5)
    got = ttrainer._aug_sigma(tcfg, torch.from_numpy(steps))
    want = jtrainer._aug_sigma(jax_config_from_dict(tiny(**over)).train,
                               jnp.asarray(steps, jnp.int32))
    if tcfg.augment_noise_anneal_steps <= 0:
        assert got == want == tcfg.augment_noise
    else:
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _yaml(tmp_path, **train):
    raw = tiny(ckpt_dir=str(tmp_path / "ck"), log_every=2, ckpt_every=3, **train)
    return config_from_dict(yaml.safe_load(yaml.safe_dump(raw)))


def test_fit_groups_host_batches_and_drains_the_tail(tmp_path):
    """Trainer.fit with steps_per_call=3 over 7 steps: two calls of 3
    stacked host batches, then the last step alone; the same parameters as
    7 single steps on the same batches (bit for bit on the CPU), one log
    record and checkpoint where a call crosses log_every=2 or
    ckpt_every=3, and at the last step."""
    rng = np.random.default_rng(5)
    batches = [{"x": rng.normal(size=(4, 64, 3)).astype(np.float32)} for _ in range(9)]
    out = {}
    for spc in (3, 1):
        cfg = _yaml(tmp_path / str(spc), steps=7, steps_per_call=spc)
        trainer = Trainer(cfg, device="cpu", log_fn=lambda s: None)
        trainer.fit(iter(batches))
        d = tmp_path / str(spc) / "ck" / "t"
        recs = [json.loads(line)["step"] for line in (d / "metrics.jsonl").read_text().splitlines()]
        out[spc] = (trainer.state.params.clone(), recs, sorted(p.name for p in d.glob("*.pt")))
        assert trainer.state.host_step == 7 and trainer.state.step == 7
    assert torch.equal(out[3][0], out[1][0])
    assert out[3][1] == [3, 6, 7] and out[1][1] == [2, 4, 6, 7]
    assert out[3][2] == [f"params_{s:08d}.pt" for s in (3, 6, 7)]
    assert out[1][2] == [f"params_{s:08d}.pt" for s in (3, 6, 7)]


def test_fit_drains_a_partial_group_when_the_batches_run_out(tmp_path):
    """Five host batches for 7 steps at steps_per_call=3: one call of 3, then
    the last two batches step by step; the run ends at step 5 with its
    checkpoint."""
    rng = np.random.default_rng(6)
    batches = [{"x": rng.normal(size=(4, 64, 3)).astype(np.float32)} for _ in range(5)]
    trainer = Trainer(_yaml(tmp_path, steps=7, steps_per_call=3), device="cpu",
                      log_fn=lambda s: None)
    trainer.fit(iter(batches))
    assert trainer.state.host_step == 5 and trainer.state.step == 5
    assert (tmp_path / "ck" / "t" / "params_00000005.pt").exists()
