"""Training (counterpart of ``dpfx/train/trainer.py``): the learning-rate
schedules, clip-by-global-norm then Adam or AdamW written out over one flat
parameter vector, the train step, and ``Trainer.fit``.

The optimizer follows optax exactly: ``optax.chain(clip_by_global_norm,
adam|adamw)`` with the schedule read at the optimizer's own update count,
which starts at 0 (so with warmup the first update uses lr(0) = 0), and
the warmup inside the ``decay_steps`` horizon. The parameters live in one
flat float32 buffer (each ``nn.Parameter`` is a view of it), as
``train.flat_optimizer`` arranges in the JAX package: the update is a
handful of kernels, not a few per tensor.

A step whose raw gradient norm is not finite is skipped: the parameters,
the Adam moments and the optimizer's count keep their values, while
``TrainState.step`` (which drives the noise streams and the jitter
anneal) advances, as in the JAX package.
"""

from __future__ import annotations

import math
import os
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from dpfx_torch.config import Config
from dpfx_torch.device import DeviceLike, resolve_device
from dpfx_torch.models.coupling import Conditioner
from dpfx_torch.models.dpf import DPF
from dpfx_torch.train.loss import elbo_loss
from dpfx_torch.utils.writers import ScalarWriter

Tensor = torch.Tensor
Schedule = Callable[[int], float]


class TrainDivergedError(RuntimeError):
    """Raised when every update across train.abort_after_skipped_windows
    consecutive log windows was skipped as non-finite."""


# ---------------------------------------------------------------- schedules

def _linear(init: float, end: float, steps: int) -> Schedule:
    def f(count: int) -> float:
        frac = 1.0 - min(max(count, 0), steps) / steps
        return (init - end) * frac + end
    return f


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    def f(count: int) -> float:
        c = min(count, decay_steps)
        return init * ((1.0 - alpha) * 0.5 * (1.0 + math.cos(math.pi * c / decay_steps)) + alpha)
    return f


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    return lambda count: first(count) if count < boundary else then(count - boundary)


def make_schedule(tcfg) -> Schedule:
    """count -> learning rate, as ``dpfx.train.trainer.make_schedule``:
    ``lr_warmup_steps`` of linear ramp from 0 occupy the first part of the
    ``decay_steps`` horizon, and every schedule reaches its terminal value
    at ``decay_steps``."""
    decay_steps = tcfg.lr_decay_steps or tcfg.steps
    warmup = min(tcfg.lr_warmup_steps, max(decay_steps - 1, 0))
    span = decay_steps - warmup
    lr = tcfg.lr
    if tcfg.lr_schedule == "cosine":
        if warmup > 0:
            alpha = 0.0 if lr == 0 else lr * tcfg.lr_min_ratio / lr
            return _join(_linear(0.0, lr, warmup), _cosine(lr, decay_steps - warmup, alpha),
                         warmup)
        return _cosine(lr, decay_steps, tcfg.lr_min_ratio)
    if tcfg.lr_schedule == "constant":
        sched: Schedule = lambda count: lr
    elif tcfg.lr_schedule == "step":
        # halve at each quarter of the post-warmup span (a dict, as in the
        # JAX package: coinciding boundaries collapse into one)
        bounds = sorted({span // 4 * (i + 1): 0.5 for i in range(3)}.items())
        sched = lambda count: lr * math.prod(s for b, s in bounds if count >= b)
    else:
        raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r}")
    if warmup > 0:
        sched = _join(_linear(0.0, lr, warmup), sched, warmup)
    return sched


# ---------------------------------------------------------------- optimizer

@dataclass
class OptState:
    count: int          # updates applied (the schedule's and the bias correction's count)
    mu: Tensor          # first moment, flat
    nu: Tensor          # second moment, flat


class Optimizer:
    """clip_by_global_norm(grad_clip) (when > 0), then adam, or adamw when
    weight_decay > 0, then the scheduled learning rate: optax's chain."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, tcfg):
        self.schedule = make_schedule(tcfg)
        self.clip = tcfg.grad_clip
        self.weight_decay = tcfg.weight_decay

    def init(self, params: Tensor) -> OptState:
        return OptState(0, torch.zeros_like(params), torch.zeros_like(params))

    @torch.no_grad()
    def apply_(self, params: Tensor, grads: Tensor, gnorm: Tensor, state: OptState) -> OptState:
        """One update of the flat ``params`` in place, from ``grads`` whose
        global norm is ``gnorm``; the moments update in place."""
        g = grads
        if self.clip > 0:
            g = torch.where(gnorm < self.clip, g, g / gnorm * self.clip)
        count = state.count + 1
        state.mu.mul_(self.b1).add_(g, alpha=1.0 - self.b1)
        state.nu.mul_(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        mu_hat = state.mu / (1.0 - self.b1 ** count)
        nu_hat = state.nu / (1.0 - self.b2 ** count)
        update = mu_hat / (nu_hat.sqrt() + self.eps)
        if self.weight_decay > 0:
            update = update + self.weight_decay * params
        params.add_(update, alpha=-self.schedule(state.count))
        return OptState(count, state.mu, state.nu)


def make_optimizer(tcfg) -> Optimizer:
    return Optimizer(tcfg)


# ---------------------------------------------------------------- state

@dataclass
class TrainState:
    step: int           # steps taken, skipped ones included
    params: Tensor      # the flat buffer every model parameter is a view of
    opt_state: OptState


@torch.no_grad()
def init_params_(model: nn.Module, seed: int) -> nn.Module:
    """flax's default initialisation, seeded: every Dense kernel lecun-normal
    (truncated at two standard deviations), every bias zero, and the
    couplings' ``out`` layers zero (each coupling starts as the identity)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Linear):
            std = math.sqrt(1.0 / m.in_features) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
    for m in model.modules():
        if isinstance(m, Conditioner):
            m.out.weight.zero_()
            m.out.bias.zero_()
    return model


def flatten_params_(model: nn.Module) -> Tensor:
    """Move every parameter into one flat float32 buffer and make each a
    view of it; returns the buffer. Call after the model is on its device."""
    params = list(model.parameters())
    flat = torch.cat([p.detach().reshape(-1).float() for p in params])
    o = 0
    for p in params:
        p.data = flat[o:o + p.numel()].view_as(p)
        o += p.numel()
    return flat


def init_state(model: nn.Module, tx: Optimizer) -> TrainState:
    flat = flatten_params_(model)
    return TrainState(step=0, params=flat, opt_state=tx.init(flat))


# ---------------------------------------------------------------- the step

_EPS_TAG, _AUG_TAG = 0, 0x0A96   # noise streams: reparameterisation, jitter


def _aug_active(tcfg) -> bool:
    return tcfg.augment_noise > 0.0 or (
        tcfg.augment_noise_anneal_steps > 0 and tcfg.augment_noise_final > 0.0)


def _aug_sigma(tcfg, step: int) -> float:
    """Jitter std at ``step``: linear anneal augment_noise ->
    augment_noise_final over augment_noise_anneal_steps, then hold."""
    if tcfg.augment_noise_anneal_steps <= 0:
        return tcfg.augment_noise
    frac = min(max(step / float(tcfg.augment_noise_anneal_steps), 0.0), 1.0)
    return tcfg.augment_noise + (tcfg.augment_noise_final - tcfg.augment_noise) * frac


def _generator(seed: int, step: int, tag: int, device: torch.device) -> torch.Generator:
    key = int(np.random.SeedSequence((seed, step, tag)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key & (2**63 - 1))


def make_train_step(model: DPF, tx: Optimizer, cfg: Config
                    ) -> Callable[[TrainState, Dict[str, Tensor]], Tuple[TrainState, Dict]]:
    """(state, batch) -> (state, metrics); ``batch`` holds ``x`` [B, N, 3]
    on the model's device and optionally ``eps`` [B, dz] and ``xnoise``
    [B, N, 3], else they are drawn from generators seeded by
    (train.seed, step). The metrics are 0-d tensors on the device."""
    tcfg = cfg.train
    params = list(model.parameters())

    def step_fn(state: TrainState, batch: Dict[str, Tensor]):
        x = batch["x"]
        dev = x.device
        if _aug_active(tcfg):
            xn = batch.get("xnoise")
            if xn is None:
                xn = torch.randn(x.shape, device=dev,
                                 generator=_generator(tcfg.seed, state.step, _AUG_TAG, dev))
            x = x + _aug_sigma(tcfg, state.step) * xn
        eps = batch.get("eps")
        if eps is None:
            eps = torch.randn((x.shape[0], cfg.model.dz), device=dev,
                              generator=_generator(tcfg.seed, state.step, _EPS_TAG, dev))
        loss, metrics = elbo_loss(
            model, x, eps, kl_weight=tcfg.kl_weight, recon_reduction=tcfg.recon_reduction,
            fused_point_flow=tcfg.fused_point_flow, fused_encoder=tcfg.fused_encoder,
            fused_latent_flow=tcfg.fused_latent_flow)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for g, p in zip(grads, params)])
        gnorm = torch.linalg.vector_norm(flat)     # raw grads, before the clip
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics["grad_norm"] = gnorm
        good = bool(torch.isfinite(gnorm))
        opt_state = state.opt_state
        if good or not tcfg.skip_nonfinite_updates:
            opt_state = tx.apply_(state.params, flat, gnorm, opt_state)
        if tcfg.skip_nonfinite_updates:
            metrics["nonfinite_skipped"] = torch.tensor(0.0 if good else 1.0, device=dev)
        return TrainState(state.step + 1, state.params, opt_state), metrics

    return step_fn


# ---------------------------------------------------------------- the loop

class Trainer:
    """Step-based training loop: logging, metrics.jsonl, params-only
    checkpoints. ``device`` defaults to cuda and raises without one."""

    def __init__(self, cfg: Config, device: DeviceLike = None, log_fn=print):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.log_fn = log_fn
        self.model = init_params_(DPF(cfg), cfg.train.seed).to(self.device)
        self.tx = make_optimizer(cfg.train)
        self.state = init_state(self.model, self.tx)
        self.train_step = make_train_step(self.model, self.tx, cfg)
        self.directory = os.path.join(cfg.train.ckpt_dir, cfg.name)
        self.writer = ScalarWriter(self.directory, tensorboard=cfg.train.tensorboard)

    def save(self) -> None:
        """Params-only state dict (``dpfx_torch.checkpoint`` reads it)."""
        path = os.path.join(self.directory, f"params_{self.state.step:08d}.pt")
        torch.save({k: v.detach().cpu().clone() for k, v in self.model.state_dict().items()},
                   path)

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def fit(self, batches: Iterator[Dict[str, np.ndarray]],
            steps: Optional[int] = None) -> TrainState:
        tcfg = self.cfg.train
        steps = steps or tcfg.steps
        window: list = []
        skipped_windows = 0
        last_ckpt = self.state.step
        t0 = time.perf_counter()
        for batch in batches:
            if self.state.step >= steps:
                break
            batch = self._to_device(batch)
            self.state, metrics = self.train_step(self.state, batch)
            window.append(metrics)
            step = self.state.step
            if step % tcfg.log_every == 0 or step == steps:
                m = {k: float(torch.stack([w[k] for w in window]).float().mean().cpu())
                     for k in window[0]}
                dt = time.perf_counter() - t0
                pts = len(window) * batch["x"].shape[0] * batch["x"].shape[1]
                skipped = round(m.get("nonfinite_skipped", 0.0) * len(window))
                skipped_windows = skipped_windows + 1 if skipped == len(window) else 0
                self.log_fn(f"[dpfx_torch] step {step}/{steps} loss={m['loss']:.4f} "
                            f"nll/pt={m['neg_elbo_per_point']:.4f} kl={m['kl']:.3f} "
                            f"gnorm={m['grad_norm']:.2f}"
                            + (f" SKIPPED={skipped}" if skipped else "")
                            + f" ({pts / dt:,.0f} pts/s)")
                self.writer.write({"kind": "train", "step": step, **m,
                                   "points_per_sec": pts / dt})
                window = []
                t0 = time.perf_counter()
                limit = tcfg.abort_after_skipped_windows
                if limit and skipped_windows >= limit:
                    raise TrainDivergedError(
                        f"every update in the last {limit} log windows had a non-finite grad "
                        f"norm: the run has diverged and cannot recover by skipping. Lower "
                        f"train.lr or model.*.scale_cap (train.abort_after_skipped_windows=0 "
                        f"disables this abort)")
            if step % tcfg.ckpt_every == 0 or step == steps:
                if skipped_windows > 0:
                    self.log_fn(f"[dpfx_torch] skipping checkpoint at step {step}: "
                                f"run is in a fully-skipped window")
                else:
                    self.save()
                    last_ckpt = step
        if self.state.step != last_ckpt:
            self.save()     # never exit without a checkpoint of the last trained step
        return self.state
