"""Training (counterpart of ``dpfx/train/trainer.py``): the learning-rate
schedules, clip-by-global-norm then Adam or AdamW written out over one flat
parameter vector, the train step, K steps per call
(``train.steps_per_call``: replays of one step captured in a CUDA graph),
the device-resident split's draw (``data.device_resident``), the
validation step, full-state checkpoints (``CheckpointManager``) and the
loop: ``Trainer.fit`` / ``Trainer.fit_resident`` with evaluation every
``train.eval_every`` steps, ``Trainer.evaluate``, ``Trainer.maybe_resume``
and ``Trainer.fit_auto`` (divergence recovery).

The optimizer follows optax exactly: ``optax.chain(clip_by_global_norm,
adam|adamw)`` with the schedule read at the optimizer's own update count,
which starts at 0 (so with warmup the first update uses lr(0) = 0), and
the warmup inside the ``decay_steps`` horizon. The parameters live in one
flat float32 buffer (each ``nn.Parameter`` is a view of it), as
``train.flat_optimizer`` arranges in the JAX package: the update is a
handful of kernels, not a few per tensor.

The step makes no host decision, so that a CUDA graph can hold it. The
optimizer's count and the step counter are device tensors; the learning
rate and the jitter sigma are computed from them on the device, in float32
as optax computes them. A step whose raw gradient norm is not finite is
skipped as in the JAX package: the update is computed and then not taken
(``torch.where`` keeps the old parameters and Adam moments, and the count
advances by 0), while ``TrainState.step`` (which drives the noise streams
and the jitter anneal) advances. The step updates the state's tensors in
place, where the JAX package donates them; ``TrainState.host_step`` mirrors
the step on the host for the noise keys and the loop's cadence.

Data parallel (``group``, a ``torch.distributed`` process group of D
ranks, one GPU each): every rank takes rows [r B/D, (r+1) B/D) of each
global batch and of its noise, which is drawn at the global shape from the
same generators; the step all-reduces the flat gradient and the metrics in
one buffer and divides by D, so every rank makes the same update and the
same skip decision, as ``dpfx``'s ``pmean`` under ``shard_map``. Under NCCL
the all-reduce is inside the captured graph. Rank 0 logs and writes the
checkpoints; the state is broadcast from it after init and each restore.
"""

from __future__ import annotations

import dataclasses
import math
import os
import re
import time
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn as nn

from dpfx_torch.config import Config
from dpfx_torch.device import DeviceLike, resolve_device
from dpfx_torch.models.coupling import Conditioner
from dpfx_torch.models.dpf import DPF
from dpfx_torch.parallel import (Group, all_reduce_mean_, broadcast_, capturable, gather_rows,
                                 rank_slice, shard_resident_stack, world_rank)
from dpfx_torch.train.loss import elbo_loss
from dpfx_torch.utils.writers import ScalarWriter

Tensor = torch.Tensor
Schedule = Callable[[Tensor], Tensor]


class TrainDivergedError(RuntimeError):
    """Raised when every update across train.abort_after_skipped_windows
    consecutive log windows was skipped as non-finite."""


# ---------------------------------------------------------------- schedules
# Computed as optax computes them: float32 throughout, from an integer count
# tensor, so that a step reads no schedule value on the host.

def _div(a: Tensor, d: float) -> Tensor:
    """a / d rounded once: torch takes a division by a Python scalar on the
    card as a product with its reciprocal, optax does not."""
    return a / torch.full_like(a, float(d))


def _linear(init: float, end: float, steps: int) -> Schedule:
    """optax.polynomial_schedule with power 1."""
    return lambda count: (init - end) * (1.0 - _div(count.clamp(0, steps).float(), steps)) + end


def _cosine(init: float, decay_steps: int, alpha: float) -> Schedule:
    """optax.cosine_decay_schedule."""
    def f(count):
        c = count.float().clamp(max=float(decay_steps))
        cos = 0.5 * (1.0 + torch.cos(_div(math.pi * c, decay_steps)))
        return init * ((1.0 - alpha) * cos + alpha)
    return f


def _piecewise(lr: float, bounds) -> Schedule:
    """optax.piecewise_constant_schedule (and, with no bounds, the constant)."""
    def f(count):
        v = count.new_full((), lr, dtype=torch.float32)
        for b, s in bounds:
            ind = torch.sign(b - count).clamp(min=0).float()
            v = v * ind + (1 - ind) * s * v
        return v
    return f


def _join(first: Schedule, then: Schedule, boundary: int) -> Schedule:
    """optax.join_schedules."""
    return lambda count: torch.where(count < boundary, first(count), then(count - boundary))


def make_schedule(tcfg) -> Schedule:
    """count -> learning rate, as ``dpfx.train.trainer.make_schedule``:
    ``lr_warmup_steps`` of linear ramp from 0 occupy the first part of the
    ``decay_steps`` horizon, and every schedule reaches its terminal value
    at ``decay_steps``. An integer tensor count gives a float32 tensor on
    its device; a Python int, a float."""
    decay_steps = tcfg.lr_decay_steps or tcfg.steps
    warmup = min(tcfg.lr_warmup_steps, max(decay_steps - 1, 0))
    span = decay_steps - warmup
    lr = tcfg.lr
    if tcfg.lr_schedule == "cosine":
        if warmup > 0:
            alpha = 0.0 if lr == 0 else lr * tcfg.lr_min_ratio / lr
            sched = _join(_linear(0.0, lr, warmup), _cosine(lr, decay_steps - warmup, alpha),
                          warmup)
        else:
            sched = _cosine(lr, decay_steps, tcfg.lr_min_ratio)
    else:
        if tcfg.lr_schedule == "constant":
            sched = _piecewise(lr, [])
        elif tcfg.lr_schedule == "step":
            # halve at each quarter of the post-warmup span (a dict, as in the
            # JAX package: coinciding boundaries collapse into one)
            sched = _piecewise(lr, sorted({span // 4 * (i + 1): 0.5 for i in range(3)}.items()))
        else:
            raise ValueError(f"unknown lr_schedule {tcfg.lr_schedule!r}")
        if warmup > 0:
            sched = _join(_linear(0.0, lr, warmup), sched, warmup)
    return lambda count: (sched(count) if isinstance(count, Tensor)
                          else float(sched(torch.tensor(count, dtype=torch.int32))))


# ---------------------------------------------------------------- optimizer

@dataclass
class OptState:
    count: Tensor       # 0-d int32 on the device: updates applied (the schedule's and the
    #                     bias corrections' count)
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
        return OptState(torch.zeros((), dtype=torch.int32, device=params.device),
                        torch.zeros_like(params), torch.zeros_like(params))

    @torch.no_grad()
    def apply_(self, params: Tensor, grads: Tensor, gnorm: Tensor, state: OptState,
               good: Optional[Tensor] = None) -> OptState:
        """One update of the flat ``params``, the moments and the count in
        place, from ``grads`` whose global norm is ``gnorm``. Where the 0-d
        bool ``good`` is false, each keeps its value: the update is computed
        and then not taken, with no value read on the host."""
        g = grads
        if self.clip > 0:
            g = torch.where(gnorm < self.clip, g, g / gnorm * self.clip)
        count = state.count + 1
        mu = state.mu.mul(self.b1).add_(g, alpha=1.0 - self.b1)
        nu = state.nu.mul(self.b2).addcmul_(g, g, value=1.0 - self.b2)
        c = count.float()
        mu_hat = mu / (1.0 - torch.pow(self.b1, c))
        nu_hat = nu / (1.0 - torch.pow(self.b2, c))
        update = mu_hat / (nu_hat.sqrt() + self.eps)
        if self.weight_decay > 0:
            update = update + self.weight_decay * params
        new = params - self.schedule(state.count) * update
        if good is not None:
            new, mu, nu, count = (torch.where(good, a, b) for a, b in (
                (new, params), (mu, state.mu), (nu, state.nu), (count, state.count)))
        params.copy_(new)
        state.mu.copy_(mu)
        state.nu.copy_(nu)
        state.count.copy_(count)
        return state


def make_optimizer(tcfg) -> Optimizer:
    return Optimizer(tcfg)


# ---------------------------------------------------------------- state

@dataclass
class TrainState:
    step: Tensor        # 0-d int64 on the device: steps taken, skipped ones included
    params: Tensor      # the flat buffer every model parameter is a view of
    opt_state: OptState
    host_step: int = 0  # ``step`` mirrored on the host (noise keys, the loop's cadence)


@torch.no_grad()
def init_params_(model: nn.Module, seed: int) -> nn.Module:
    """flax's default initialisation, seeded: every Dense and Conv kernel
    lecun-normal over its fan-in (in_features; kh * kw * cin for a conv),
    truncated at two standard deviations, every bias zero, every
    LayerNorm and GroupNorm scale one, and the couplings' ``out`` layers
    zero (each coupling starts as the identity)."""
    g = torch.Generator().manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Linear, nn.Conv2d)):
            fan_in = m.weight[0].numel()
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            w = torch.empty(m.weight.shape)
            nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std, generator=g)
            m.weight.copy_(w)
            if m.bias is not None:
                m.bias.zero_()
        elif isinstance(m, (nn.LayerNorm, nn.GroupNorm)):
            m.weight.fill_(1.0)
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
    return TrainState(step=torch.zeros((), dtype=torch.int64, device=flat.device), params=flat,
                      opt_state=tx.init(flat))


# ---------------------------------------------------------------- the step

# noise streams: reparameterisation, jitter, the validation eps; the
# resident draw's cloud ids, point ids and epoch permutations
_EPS_TAG, _AUG_TAG, _EVAL_TAG = 0, 0x0A96, 0x0E7A1
_IDS_TAG, _POINTS_TAG, _EPOCH_TAG = 0x0DA7A, 0x0DA7B, 0x0E90C


def _aug_active(tcfg) -> bool:
    return tcfg.augment_noise > 0.0 or (
        tcfg.augment_noise_anneal_steps > 0 and tcfg.augment_noise_final > 0.0)


def _aug_sigma(tcfg, step: Tensor) -> Union[float, Tensor]:
    """Jitter std at ``step`` (a device tensor), float32 as in the JAX
    package: linear anneal augment_noise -> augment_noise_final over
    augment_noise_anneal_steps, then hold; a constant without the anneal."""
    if tcfg.augment_noise_anneal_steps <= 0:
        return tcfg.augment_noise
    frac = _div(step.float(), tcfg.augment_noise_anneal_steps).clamp(0.0, 1.0)
    return tcfg.augment_noise + (tcfg.augment_noise_final - tcfg.augment_noise) * frac


def _generator(seed: int, step: int, tag: int, device: torch.device) -> torch.Generator:
    key = int(np.random.SeedSequence((seed, step, tag)).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(key & (2**63 - 1))


def _noise(cfg: Config, start: int, k: int, x_shape, device: torch.device,
           eps: Optional[Tensor] = None, xn: Optional[Tensor] = None, group: Group = None
           ) -> Tuple[Tensor, Optional[Tensor]]:
    """eps [K, B, dz] and the jitter's xnoise [K, B, N, 3] (None without
    jitter) of the k steps from ``start``: the given ones, else drawn, each
    step from generators keyed by (train.seed, step, stream), so that a step
    draws the same numbers alone, in a replayed call or in a resident one.
    Under a ``group`` the batch ``x_shape`` is the rank's [B/D, N, 3]: the
    noise is drawn at the global shape and the rank's rows are returned
    (given noise is taken to be the rank's already)."""
    tcfg = cfg.train
    b, n = x_shape[-3] * world_rank(group)[0], x_shape[-2]

    def draw(shape, tag):
        return rank_slice(torch.stack([torch.randn(shape, device=device,
                                                   generator=_generator(tcfg.seed, s, tag, device))
                                       for s in range(start, start + k)]), group, dim=1)

    if eps is None:
        eps = draw((b, cfg.model.dz), _EPS_TAG)
    if not _aug_active(tcfg):
        xn = None
    elif xn is None:
        xn = draw((b, n, 3), _AUG_TAG)
    return eps, xn


StepCore = Callable[[TrainState, Tensor, Tensor, Optional[Tensor], Optional[Tensor]],
                    Dict[str, Tensor]]


def _make_step(model: DPF, tx: Optimizer, cfg: Config, group: Group = None) -> StepCore:
    """The train step on given noise: (state, x [B, N, 3], eps [B, dz],
    xnoise [B, N, 3] or None, image [B, H, W, 3] or None) -> metrics, 0-d
    tensors on the device; with an image (SVR) the posterior is the image
    encoder's. It updates the state's tensors in place and reads no value
    on the host, so a CUDA graph can hold it; the eager step and every
    replay run it. Under a ``group`` the inputs are the rank's rows, and
    one all-reduce of the flat gradient and the metrics (divided by D)
    comes before the norm, the clip, the skip and Adam."""
    tcfg = cfg.train
    params = list(model.parameters())

    def step(state: TrainState, x: Tensor, eps: Tensor, xn: Optional[Tensor],
             image: Optional[Tensor] = None):
        if xn is not None:
            x = x + _aug_sigma(tcfg, state.step) * xn
        loss, metrics = elbo_loss(
            model, x, eps, kl_weight=tcfg.kl_weight, recon_reduction=tcfg.recon_reduction,
            fused_point_flow=tcfg.fused_point_flow, fused_encoder=tcfg.fused_encoder,
            fused_latent_flow=tcfg.fused_latent_flow, image=image)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                          for g, p in zip(grads, params)])
        metrics = {k: v.detach() for k, v in metrics.items()}
        if group is not None:       # the flat gradient is the bucket; the metrics ride along
            names = list(metrics)
            buf = all_reduce_mean_(torch.cat([flat, torch.stack([metrics[k] for k in names])]),
                                   group)
            flat = buf[:flat.numel()]
            metrics = dict(zip(names, buf[flat.numel():]))
        gnorm = torch.linalg.vector_norm(flat)     # raw grads, before the clip
        metrics["grad_norm"] = gnorm
        good = torch.isfinite(gnorm) if tcfg.skip_nonfinite_updates else None
        tx.apply_(state.params, flat, gnorm, state.opt_state, good)
        if good is not None:
            metrics["nonfinite_skipped"] = 1.0 - good.float()
        state.step.add_(1)
        return metrics

    return step


def make_train_step(model: DPF, tx: Optimizer, cfg: Config, group: Group = None
                    ) -> Callable[[TrainState, Dict[str, Tensor]], Tuple[TrainState, Dict]]:
    """(state, batch) -> (state, metrics), one eager step; ``batch`` holds
    ``x`` [B, N, 3] on the model's device, ``image`` [B, H, W, 3] for SVR,
    and optionally ``eps`` [B, dz] and ``xnoise`` [B, N, 3], else they are
    drawn from generators seeded by (train.seed, step). The metrics are 0-d
    tensors on the device; the state's tensors update in place. Under a
    ``group`` the batch is the rank's B/D rows and the metrics are the
    ranks' means."""
    step = _make_step(model, tx, cfg, group)

    def step_fn(state: TrainState, batch: Dict[str, Tensor]):
        x, eps, xn = batch["x"], batch.get("eps"), batch.get("xnoise")
        eps, xn = _noise(cfg, state.host_step, 1, x.shape, x.device,
                         None if eps is None else eps[None], None if xn is None else xn[None],
                         group)
        metrics = step(state, x, eps[0], None if xn is None else xn[0], batch.get("image"))
        state.host_step += 1
        return state, metrics

    return step_fn


# ---------------------------------------------------------------- K steps per call

_WARMUP = 3     # eager steps on a side stream before a capture (PyTorch's whole-network recipe)


def _launch_counters() -> List[Dict[str, int]]:
    """The launch counts of the kernels a train step runs."""
    from dpfx_torch.ops import fused_encoder, fused_latent, fused_train

    return [fused_train.launches, fused_encoder.launches, fused_latent.launches]


class MultiStep:
    """K train steps per call (``train.steps_per_call``), the counterpart of
    ``dpfx``'s ``make_multi_step``: (state, batches) -> (state, metrics),
    with ``batches["x"]`` [K, B, N, 3], ``batches["image"]`` [K, B, H, W, 3]
    for SVR (and optionally ``eps`` [K, B, dz] and ``xnoise`` [K, B, N, 3])
    and each metric stacked [K]. K may differ from call to call.

    On the card the first call captures one step (``_make_step``) in a CUDA
    graph, after ``_WARMUP`` eager steps on a side stream whose effect on
    the state is undone; a failed capture raises. Each step of a call then
    copies its inputs into the graph's static buffers, replays it and copies
    its metrics out, so K replays compute what K eager steps compute. The
    graph reads the storage it was captured on: a call raises if the
    parameters, the flat buffer, the moments or the counters have moved
    since. On the CPU the same step runs K times.

    A kernel's launch counter counts when Python runs its wrapper, and a
    replay runs none: the counts the capture made (it launched nothing) are
    taken back, and added again for each replay.

    Under an NCCL ``group`` the step's all-reduce is captured with it (the
    warm-up steps run it too, as NCCL's capture needs). A group whose
    collectives cannot be captured (gloo) on the card raises a ValueError
    with ``train.steps_per_call`` > 1 and at any call there: such a group
    trains with eager steps (``train.steps_per_call=1``)."""

    def __init__(self, model: DPF, tx: Optimizer, cfg: Config, group: Group = None):
        self.cfg = cfg
        self.group = group
        self.step = _make_step(model, tx, cfg, group)
        self.params = list(model.parameters())
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        if self.params[0].is_cuda and cfg.train.steps_per_call > 1:
            self._check_capturable()

    def _check_capturable(self) -> None:
        if not capturable(self.group):
            raise ValueError(
                f"a {torch.distributed.get_backend(self.group)} process group's collectives "
                "cannot be captured in a CUDA graph: train with train.steps_per_call=1 (eager "
                "steps, the all-reduce outside any graph) or over an NCCL group")

    def __call__(self, state: TrainState, batches: Dict[str, Tensor]):
        xs = batches["x"]
        k = xs.shape[0]
        eps, xn = _noise(self.cfg, state.host_step, k, xs.shape, xs.device, batches.get("eps"),
                         batches.get("xnoise"), self.group)
        img = batches.get("image")
        if xs.is_cuda:
            self._check_capturable()
            out = self._replay(state, xs, eps, xn, img)
        else:
            ms = [self.step(state, xs[i], eps[i], None if xn is None else xn[i],
                            None if img is None else img[i]) for i in range(k)]
            out = {key: torch.stack([m[key] for m in ms]) for key in ms[0]}
        state.host_step += k
        return state, out

    def release(self) -> None:
        """Drop the captured graph and its static tensors and return their
        memory pool to the card, so that another capture does not hold two
        graphs' activations."""
        if self.graph is not None:
            self.graph = self.inputs = self.outputs = None
            torch.cuda.empty_cache()

    def _storage(self, state: TrainState) -> List[int]:
        return [t.data_ptr() for t in (*self.params, state.params, state.opt_state.mu,
                                       state.opt_state.nu, state.opt_state.count, state.step)]

    def _capture(self, state: TrainState, x: Tensor, eps: Tensor, xn: Optional[Tensor],
                 img: Optional[Tensor]) -> None:
        dev = x.device
        self.inputs = [x.clone(), eps.clone(), None if xn is None else xn.clone(),
                       None if img is None else img.clone()]
        held = (state.params, state.opt_state.mu, state.opt_state.nu, state.opt_state.count,
                state.step)
        saved = [t.clone() for t in held]
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            for _ in range(_WARMUP):
                self.step(state, *self.inputs)
        torch.cuda.current_stream(dev).wait_stream(side)
        for t, v in zip(held, saved):
            t.copy_(v)
        counters = _launch_counters()
        before = [dict(c) for c in counters]
        graph = torch.cuda.CUDAGraph()
        # under a group, NCCL's watchdog thread queries its events while this
        # thread captures: only this thread's calls are checked
        with torch.cuda.graph(graph, capture_error_mode=(
                "global" if self.group is None else "thread_local")):
            self.outputs = self.step(state, *self.inputs)
        self.per_replay = [{key: c[key] - b[key] for key in c} for c, b in zip(counters, before)]
        for c, b in zip(counters, before):
            c.update(b)
        self.graph, self.storage = graph, self._storage(state)

    def _replay(self, state: TrainState, xs: Tensor, eps: Tensor, xn: Optional[Tensor],
                img: Optional[Tensor]):
        if self.graph is None:
            self._capture(state, xs[0], eps[0], None if xn is None else xn[0],
                          None if img is None else img[0])
        if self._storage(state) != self.storage:
            raise RuntimeError(
                "the parameters, the optimizer state or the step counter moved to other storage "
                "after the train step was captured in a CUDA graph, which reads the storage it "
                "was captured on: build a new multi-step for the new state")
        held = self.inputs[3]
        if (xs.shape[1:] != self.inputs[0].shape or eps.shape[1:] != self.inputs[1].shape
                or (img is None) != (held is None)
                or (img is not None and img.shape[1:] != held.shape)):
            raise ValueError(f"batches of {tuple(xs.shape[1:])} (images "
                             f"{None if img is None else tuple(img.shape[1:])}) for a step "
                             f"captured on {tuple(self.inputs[0].shape)} (images "
                             f"{None if held is None else tuple(held.shape)})")
        names = list(self.outputs)
        out = torch.empty((xs.shape[0], len(names)), device=xs.device)
        counters = _launch_counters()
        for i in range(xs.shape[0]):
            self.inputs[0].copy_(xs[i])
            self.inputs[1].copy_(eps[i])
            if xn is not None:
                self.inputs[2].copy_(xn[i])
            if img is not None:
                self.inputs[3].copy_(img[i])
            self.graph.replay()
            torch.stack([self.outputs[n] for n in names], out=out[i])
            for c, add in zip(counters, self.per_replay):
                for key, v in add.items():
                    c[key] += v
        return {n: out[:, j] for j, n in enumerate(names)}


def make_multi_step(model: DPF, tx: Optimizer, cfg: Config, group: Group = None) -> MultiStep:
    return MultiStep(model, tx, cfg, group)


# ---------------------------------------------------------------- evaluation

def make_eval_step(model: DPF, cfg: Config, group: Group = None
                   ) -> Callable[[Dict[str, Tensor], int], Dict[str, Tensor]]:
    """The validation step (counterpart of ``dpfx``'s ``make_eval_step``):
    (batch, i) -> the ELBO's five metrics, 0-d tensors on the device,
    computed under ``torch.no_grad()`` with the train step's fused flags and
    no jitter. ``batch`` holds ``x`` [B, N, 3], ``image`` [B, H, W, 3] for
    SVR, and optionally ``eps`` [B, dz]; else eps is drawn from a generator
    keyed by (train.seed, i, stream), which does not depend on the training
    step (``fold_in(rng, i)`` in the JAX package). It reads the parameters
    and writes nothing.

    Under a ``group`` of D ranks every rank passes the whole batch and
    evaluates its share of the first B - B % D rows (eps drawn at the full
    batch shape), whose means are all-reduced; the ragged tail of B % D
    rows is evaluated by every rank on the same rows and merged, weighted
    by rows, as ``dpfx``'s ``Trainer.evaluate`` splits a batch: the result
    is the batch's per-cloud mean at any D, the same on every rank."""
    tcfg = cfg.train
    world = world_rank(group)[0]

    def metrics_of(x: Tensor, eps: Tensor, image: Optional[Tensor]) -> Dict[str, Tensor]:
        _, metrics = elbo_loss(
            model, x, eps, kl_weight=tcfg.kl_weight, recon_reduction=tcfg.recon_reduction,
            fused_point_flow=tcfg.fused_point_flow, fused_encoder=tcfg.fused_encoder,
            fused_latent_flow=tcfg.fused_latent_flow, image=image)
        return metrics

    @torch.no_grad()
    def eval_step(batch: Dict[str, Tensor], i: int) -> Dict[str, Tensor]:
        x, image = batch["x"], batch.get("image")
        eps = batch.get("eps")
        if eps is None:
            eps = torch.randn((x.shape[0], cfg.model.dz), device=x.device,
                              generator=_generator(tcfg.seed, i, _EVAL_TAG, x.device))
        if group is None:
            return metrics_of(x, eps, image)
        b = x.shape[0]
        keep = b - b % world
        parts = []
        if keep:
            head = metrics_of(rank_slice(x[:keep], group), rank_slice(eps[:keep], group),
                              None if image is None else rank_slice(image[:keep], group))
            names = list(head)
            buf = all_reduce_mean_(torch.stack([head[k] for k in names]), group)
            parts.append((keep, dict(zip(names, buf))))
        if keep < b:
            parts.append((b - keep, metrics_of(x[keep:], eps[keep:],
                                               None if image is None else image[keep:])))
        if len(parts) == 1:
            return parts[0][1]
        (nh, mh), (nt, mt) = parts
        return {k: (mh[k] * nh + mt[k] * nt) / b for k in mh}

    return eval_step


# ---------------------------------------------------------------- checkpoints

def _atomic_save(obj, path: str) -> None:
    """torch.save under a temporary name, then a rename: a reader sees the
    whole file or none."""
    tmp = path + ".tmp"
    torch.save(obj, tmp)
    os.replace(tmp, path)


class CheckpointManager:
    """Full-state checkpoints (counterpart of ``dpfx``'s orbax
    ``CheckpointManager``): for each saved step, ``state_<step:08d>.ckpt``
    (the flat Adam moments, the count, the step and the parameters' layout:
    names and sizes) and ``params_<step:08d>.pt`` (the model's state dict,
    which ``dpfx_torch.checkpoint`` and the eval and generate CLIs read).
    Each file is written under a temporary name and renamed, the state file
    first, so a step counts only once both files are whole. After a save,
    the oldest steps beyond ``max_to_keep`` lose both files (None keeps
    every step)."""

    def __init__(self, directory: str, max_to_keep: Optional[int] = 3):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep

    def paths(self, step: int) -> Tuple[str, str]:
        """(state file, params file) of ``step``."""
        return (os.path.join(self.directory, f"state_{step:08d}.ckpt"),
                os.path.join(self.directory, f"params_{step:08d}.pt"))

    def _steps(self, pattern: str) -> set:
        return {int(m.group(1)) for name in os.listdir(self.directory)
                if (m := re.fullmatch(pattern, name))}

    def all_steps(self) -> List[int]:
        """The steps with both files, in order."""
        return sorted(self._steps(r"state_(\d+)\.ckpt") & self._steps(r"params_(\d+)\.pt"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    @staticmethod
    def layout(model: nn.Module) -> Tuple[List[str], List[int]]:
        names, sizes = zip(*((n, p.numel()) for n, p in model.named_parameters()))
        return list(names), list(sizes)

    def save(self, step: int, model: nn.Module, state: TrainState) -> None:
        """Write ``step``'s two files from the state (one read back of the
        flat buffer and each moment), then apply the retention."""
        names, sizes = self.layout(model)
        flat, mu, nu = (t.detach().cpu() for t in (state.params, state.opt_state.mu,
                                                   state.opt_state.nu))
        views = dict(zip(names, flat.split(sizes)))
        params = {k: (views[k] if k in views else v.detach().cpu()).reshape(v.shape).clone()
                  for k, v in model.state_dict().items()}
        spath, ppath = self.paths(step)
        _atomic_save({"step": step, "count": int(state.opt_state.count), "mu": mu, "nu": nu,
                      "names": names, "sizes": sizes}, spath)
        _atomic_save(params, ppath)
        if self.max_to_keep:
            steps = self._steps(r"state_(\d+)\.ckpt") | self._steps(r"params_(\d+)\.pt")
            for old in sorted(steps)[:-self.max_to_keep]:
                for path in self.paths(old):
                    if os.path.exists(path):
                        os.remove(path)

    @torch.no_grad()
    def restore(self, step: int, model: nn.Module, state: TrainState) -> None:
        """Copy ``step``'s checkpoint into the state's tensors, which keep
        their storage (the model's parameters stay views of the flat buffer
        and a captured step stays valid); raise if the parameters' layout
        differs from the checkpoint's."""
        spath, ppath = self.paths(step)
        saved = torch.load(spath, map_location="cpu", weights_only=True)
        names, sizes = self.layout(model)
        if saved["names"] != names or saved["sizes"] != sizes:
            raise ValueError(f"the checkpoint at step {step} in {self.directory} holds another "
                             "parameter layout than this model's")
        params = torch.load(ppath, map_location="cpu", weights_only=True)
        state.params.copy_(torch.cat([params[n].reshape(-1).float() for n in names]))
        state.opt_state.mu.copy_(saved["mu"])
        state.opt_state.nu.copy_(saved["nu"])
        state.opt_state.count.fill_(saved["count"])
        state.step.fill_(saved["step"])
        state.host_step = int(saved["step"])


# ---------------------------------------------------------------- the resident split

def resident_draw(cfg: Config, start: int, k: int, s: int, p: int, device: torch.device):
    """The batches of the k steps from ``start`` on a resident split of s
    clouds of p stored points (the counterpart of ``dpfx``'s
    ``_resident_draw``), keyed by the absolute step so that the streams
    survive a resume. Returns (ci [K, B] cloud ids, pi [K, B, N] point ids
    or None where p == n_points, eps [K, B, dz], xnoise [K, B, N, 3] or
    None without jitter). Cloud ids (``data.resident_draw``): "epoch", a
    permutation of the split per epoch (``torch.randperm`` seeded from
    (train.seed, epoch)) walked in batches of B, s // B batches an epoch
    with the ragged tail dropped; "iid", uniform ids. Points: the top N of
    per-point uniform keys (without replacement), or uniform with
    replacement where p < N, as ``sample_cloud`` does. The noise is the
    eager step's (``_noise``). The RNGs are torch's, not JAX's: the rules
    are the JAX package's, the numbers are not."""
    tcfg, draw = cfg.train, cfg.data.resident_draw
    b, n = tcfg.batch_size, cfg.data.n_points
    if draw not in ("epoch", "iid"):
        raise ValueError(f"unknown data.resident_draw {draw!r}")
    gen = lambda key, tag: _generator(tcfg.seed, key, tag, device)  # noqa: E731
    per_epoch = max(s // b, 1)
    perms: Dict[int, Tensor] = {}
    ci, pi = [], []
    for sv in range(start, start + k):
        if draw == "epoch":
            epoch, pos = divmod(sv, per_epoch)
            if epoch not in perms:
                perms[epoch] = torch.randperm(s, generator=gen(epoch, _EPOCH_TAG), device=device)
            pos *= b
            ci.append(perms[epoch][pos:pos + b] if pos + b <= s else
                      perms[epoch][(pos + torch.arange(b, device=device)) % s])
        else:
            ci.append(torch.randint(0, s, (b,), generator=gen(sv, _IDS_TAG), device=device))
        if p < n:
            pi.append(torch.randint(0, p, (b, n), generator=gen(sv, _POINTS_TAG), device=device))
        elif p > n:
            keys = torch.rand((b, p), generator=gen(sv, _POINTS_TAG), device=device)
            pi.append(keys.topk(n, dim=1).indices)
    eps, xn = _noise(cfg, start, k, (b, n, 3), device)
    return torch.stack(ci), torch.stack(pi) if pi else None, eps, xn


def gather_resident(data: Tensor, ci: Tensor, pi: Optional[Tensor]) -> Tensor:
    """x [K, B, N, 3] from the resident stack ``data`` [S, P, 3]: clouds
    ``ci`` [K, B], their points ``pi`` [K, B, N] (None or empty: all P)."""
    if pi is None or pi.shape[-1] == 0:
        return data[ci]
    s, p, _ = data.shape
    return data.reshape(s * p, 3)[ci[..., None] * p + pi]


def make_resident_multi_step(model: DPF, tx: Optimizer, cfg: Config,
                             multi: Optional[Callable] = None, group: Group = None,
                             sharded: bool = False, logical_rows: Optional[int] = None
                             ) -> Callable:
    """K steps per call on batches gathered on the device from the resident
    stack [S, P, 3] (``data.device_resident``), the counterpart of
    ``dpfx``'s ``make_resident_multi_step``:
    (state, data, k, draws=None, images=None) -> (state, metrics [K]).
    ``images`` is an SVR run's resident render stack [S, H, W, 3]: each
    step's images are gathered with the cloud ids ``ci`` of its clouds, so
    the pairs (cloud i, image i) stay the dataset's. ``draws`` supplies
    ``resident_draw``'s four outputs (then k is theirs); ``multi`` runs the
    stacked steps (default: a new ``MultiStep``).

    Under a ``group`` the draw stays global and each rank trains on its
    rows of it. Replicated, every rank holds the whole stack and gathers
    its rows. ``sharded`` (``parallel.resident_sharding: sharded``): ``data``
    (and ``images``) is this rank's padded block of ceil(S/D) rows
    (``shard_resident_stack``) and ``logical_rows`` the unpadded S, which
    the draw indexes, so the pad is never drawn; each step's [B, N, 3]
    clouds are gathered after the point subsample by ``gather_rows`` (one
    all-reduce for the call's K steps) and the images with the same ids, as
    ``dpfx`` gathers them under ``shard_map``."""
    multi = multi or MultiStep(model, tx, cfg, group)
    if sharded and logical_rows is None:
        raise ValueError("a sharded resident stack needs logical_rows (the unpadded split size)")

    def resident(state: TrainState, data: Tensor, k: Optional[int] = None, draws=None,
                 images: Optional[Tensor] = None):
        if draws is None:
            s = logical_rows if logical_rows is not None else data.shape[0]
            draws = resident_draw(cfg, state.host_step, k, s, data.shape[1], data.device)
        ci, pi, eps, xn = draws
        if pi is not None and pi.shape[-1] == 0:
            pi = None
        mine = lambda t: None if t is None else rank_slice(t, group, dim=1)  # noqa: E731
        if sharded:
            kk, b = ci.shape
            x = gather_rows(data, ci.reshape(-1), group,
                            None if pi is None else pi.reshape(kk * b, -1))
            batches = {"x": mine(x.reshape(kk, b, *x.shape[1:]))}
            if images is not None:
                img = gather_rows(images, ci.reshape(-1), group)
                batches["image"] = mine(img.reshape(kk, b, *img.shape[1:]))
        else:
            ci = mine(ci)
            batches = {"x": gather_resident(data, ci, mine(pi))}
            if images is not None:
                batches["image"] = images[ci]
        batches.update(eps=mine(eps), xnoise=mine(xn))
        return multi(state, batches)

    return resident


# ---------------------------------------------------------------- the loop

class _Cadence:
    """The logging, evaluation and checkpoint cadence of ``fit`` and
    ``fit_resident`` (``dpfx``'s ``_Cadence``): a call of K steps can jump
    over a multiple of log_every, eval_every or ckpt_every, so each test is
    whether the call crossed one; one host transfer per log window; a
    checkpoint of the last step whatever the cadence."""

    def __init__(self, trainer: "Trainer", steps: int,
                 val_batches_fn: Optional[Callable[[], Iterator]] = None):
        self.tr = trainer
        self.steps = steps
        self.val_fn = val_batches_fn
        self.step = self.last_ckpt = trainer.state.host_step
        self.last_eval_step = -1
        self.window: list = []
        self.window_steps = 0
        self.skipped_windows = 0
        self.t0 = time.perf_counter()

    def record(self, took: int, metrics: Dict[str, Tensor], points_per_step: int) -> None:
        """Account for a call that advanced ``took`` steps; ``metrics`` are
        0-d (one step) or stacked [K]."""
        tr, tcfg = self.tr, self.tr.cfg.train
        self.step += took
        self.window.append(metrics)
        self.window_steps += took
        step, steps = self.step, self.steps
        crossed = lambda every: step // every > (step - took) // every  # noqa: E731
        if crossed(tcfg.log_every) or step == steps:
            keys = list(self.window[0])
            host = torch.stack([torch.cat([w[k].reshape(-1).float() for w in self.window])
                                for k in keys]).cpu()
            m = {k: float(v.mean()) for k, v in zip(keys, host)}
            dt = time.perf_counter() - self.t0
            pts = self.window_steps * points_per_step
            skipped = round(m.get("nonfinite_skipped", 0.0) * self.window_steps)
            self.skipped_windows = self.skipped_windows + 1 if skipped == self.window_steps else 0
            tr.log_fn(f"[dpfx_torch] step {step}/{steps} loss={m['loss']:.4f} "
                      f"nll/pt={m['neg_elbo_per_point']:.4f} kl={m['kl']:.3f} "
                      f"gnorm={m['grad_norm']:.2f}"
                      + (f" SKIPPED={skipped}" if skipped else "")
                      + f" ({pts / dt:,.0f} pts/s)")
            tr.history.append({"step": step, **m})
            tr.writer.write({"kind": "train", "step": step, **m, "points_per_sec": pts / dt})
            self.window, self.window_steps = [], 0
            self.t0 = time.perf_counter()
            limit = tcfg.abort_after_skipped_windows
            if limit and self.skipped_windows >= limit:
                raise TrainDivergedError(
                    f"every update in the last {limit} log windows had a non-finite grad "
                    f"norm: the run has diverged and cannot recover by skipping. Lower "
                    f"train.lr or model.*.scale_cap (train.abort_after_skipped_windows=0 "
                    f"disables this abort; train.recover_on_divergence restores the last "
                    f"checkpoint at a lower lr)")
        if self.val_fn is not None and crossed(tcfg.eval_every):
            tr.evaluate(self.val_fn())
            self.last_eval_step = step
        if crossed(tcfg.ckpt_every) or step == steps:
            if self.skipped_windows > 0:
                # saving now would let a recovery restore the diverged state
                tr.log_fn(f"[dpfx_torch] skipping checkpoint at step {step}: "
                          f"run is in a fully-skipped window")
            else:
                tr.save()
                self.last_ckpt = step

    def finish(self) -> None:
        if self.step != self.last_ckpt:
            self.tr.save()     # never exit without a checkpoint of the last trained step
        self.tr.writer.flush()


class Trainer:
    """Step-based training loop: logging, metrics.jsonl (and TensorBoard
    with ``train.tensorboard``), evaluation every ``train.eval_every``
    steps, full-state checkpoints kept by ``train.ckpt_keep``, resume and
    divergence recovery; ``train.steps_per_call`` steps per call. ``device``
    defaults to cuda and raises without one.

    Under a ``group`` (``dpfx_torch.parallel.init_from_config``) the batches
    ``fit`` takes are the rank's rows of each global batch
    (``iterate_batches(batch_shard=...)``); rank 0 logs, writes
    ``metrics.jsonl`` and TensorBoard and the checkpoints, and every other
    rank logs nothing and writes its own ``metrics.jsonl`` under
    ``proc<r>/``. The parameters and the optimizer state are broadcast from
    rank 0 after init and after each restore."""

    def __init__(self, cfg: Config, device: DeviceLike = None, log_fn=print,
                 group: Group = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.group = group
        self.world, self.rank = world_rank(group)
        if cfg.train.batch_size % self.world:
            raise ValueError(f"train.batch_size={cfg.train.batch_size} does not divide over "
                             f"{self.world} ranks")
        if cfg.parallel.resident_sharding not in ("replicated", "sharded"):
            raise ValueError(f"unknown parallel.resident_sharding "
                             f"{cfg.parallel.resident_sharding!r} (replicated | sharded)")
        self.log_fn = log_fn if self.rank == 0 else (lambda *a, **k: None)
        self.model = init_params_(DPF(cfg), cfg.train.seed).to(self.device)
        self.tx = make_optimizer(cfg.train)
        self.state = init_state(self.model, self.tx)
        self._broadcast()
        self.train_step = make_train_step(self.model, self.tx, cfg, group)
        self.steps_per_call = max(1, cfg.train.steps_per_call)
        # captures at its first call
        self.multi_step = make_multi_step(self.model, self.tx, cfg, group)
        self.eval_step = make_eval_step(self.model, cfg, group)
        self.directory = os.path.join(cfg.train.ckpt_dir, cfg.name)
        self.ckpt = CheckpointManager(self.directory, max_to_keep=cfg.train.ckpt_keep or None)
        self.writer = (ScalarWriter(self.directory, tensorboard=cfg.train.tensorboard)
                       if self.rank == 0 else
                       ScalarWriter(os.path.join(self.directory, f"proc{self.rank}"),
                                    tensorboard=False))
        self.history: list = []         # the logged train records
        self.last_eval_step = -1        # the step of the last evaluation in a fit

    def _broadcast(self) -> None:
        """Rank 0's parameters, moments, count and step on every rank."""
        st = self.state
        broadcast_([st.params, st.opt_state.mu, st.opt_state.nu, st.opt_state.count, st.step],
                   self.group)

    def _latest_step(self) -> Optional[int]:
        """The newest checkpoint's step as rank 0 sees it, on every rank."""
        step = self.ckpt.latest_step() if self.rank == 0 else None
        if self.group is None:
            return step
        t = torch.tensor([-1 if step is None else step], dtype=torch.int64, device=self.device)
        broadcast_([t], self.group)
        return None if int(t) < 0 else int(t)

    def _restore(self, step: int) -> None:
        """Rank 0 restores ``step`` in place; every rank then takes its state."""
        if self.rank == 0:
            self.ckpt.restore(step, self.model, self.state)
        self._broadcast()
        self.state.host_step = step

    def save(self) -> None:
        """A full-state checkpoint of the current step, written by rank 0."""
        if self.rank == 0:
            self.ckpt.save(self.state.host_step, self.model, self.state)

    def maybe_resume(self) -> int:
        """Restore the latest checkpoint in place, if there is one; returns
        its step (0 without one). The layout must match the model's."""
        step = self._latest_step()
        if step is None:
            return 0
        self._restore(step)
        self.log_fn(f"[dpfx_torch] resumed from step {step}")
        return step

    def _to_device(self, batch: Dict[str, np.ndarray]) -> Dict[str, Tensor]:
        return {k: torch.as_tensor(v).to(self.device, non_blocking=True)
                for k, v in batch.items()}

    def evaluate(self, batches: Iterator[Dict[str, np.ndarray]]) -> Dict[str, float]:
        """The validation metrics over ``batches`` (``x``, optionally
        ``eps``): means weighted by batch size, and ``<key>_median`` over the
        per-batch means (one outlier batch cannot hide a healthy fit). Logs a
        ``val`` line and writes a ``kind: val`` record; one read back to the
        host for the whole pass."""
        ms, weights = [], []
        for i, batch in enumerate(batches):
            batch = self._to_device(batch)
            ms.append(self.eval_step(batch, i))
            weights.append(batch["x"].shape[0])
        if not ms:
            return {}
        keys = list(ms[0])
        host = torch.stack([torch.stack([m[k].float() for k in keys]) for m in ms]).cpu().numpy()
        w = np.asarray(weights, np.float64)
        agg = {k: float(np.average(host[:, j], weights=w)) for j, k in enumerate(keys)}
        for j, k in enumerate(keys):
            agg[f"{k}_median"] = float(np.median(host[:, j]))
        step = self.state.host_step
        med = agg.get("neg_elbo_per_point_median")
        self.log_fn(f"[dpfx_torch] val @ step {step}: "
                    + " ".join(f"{k}={agg[k]:.4f}" for k in keys)
                    + (f" (median neg_elbo/pt={med:.4f})" if med is not None else ""))
        self.writer.write({"kind": "val", "step": step, **agg})
        return agg

    def fit(self, batches: Iterator[Dict[str, np.ndarray]],
            val_batches_fn: Optional[Callable[[], Iterator]] = None,
            steps: Optional[int] = None) -> TrainState:
        """Train on host batches: steps_per_call of them stacked into one
        call; a partial group at the end goes through single steps.
        ``val_batches_fn()`` gives the validation batches at each eval_every
        crossing; ``steps`` stops the run early (the schedule keeps
        train.steps' horizon)."""
        steps = steps or self.cfg.train.steps
        cad = _Cadence(self, steps, val_batches_fn)
        spc = self.steps_per_call
        pending: list = []
        for batch in batches:
            if cad.step >= steps:
                break
            if spc > 1 and cad.step + spc <= steps:
                pending.append(batch)
                if len(pending) < spc:
                    continue
                stacked = self._to_device({k: np.stack([p[k] for p in pending])
                                           for k in pending[0]})
                pending = []
                self.state, metrics = self.multi_step(self.state, stacked)
                xs = stacked["x"].shape
                cad.record(spc, metrics, xs[1] * xs[2] * self.world)
            else:
                batch = self._to_device(batch)
                self.state, metrics = self.train_step(self.state, batch)
                cad.record(1, metrics, batch["x"].shape[0] * batch["x"].shape[1] * self.world)
        for batch in pending:       # the iterator ran dry mid-group
            if cad.step >= steps:
                break
            batch = self._to_device(batch)
            self.state, metrics = self.train_step(self.state, batch)
            cad.record(1, metrics, batch["x"].shape[0] * batch["x"].shape[1] * self.world)
        cad.finish()
        self.last_eval_step = cad.last_eval_step
        return self.state

    def fit_resident(self, clouds: Union[np.ndarray, Tensor],
                     val_batches_fn: Optional[Callable[[], Iterator]] = None,
                     steps: Optional[int] = None,
                     images: Union[np.ndarray, Tensor, None] = None,
                     clouds_are_local_shard: bool = False,
                     logical_rows: Optional[int] = None) -> TrainState:
        """Train with the split resident on the device
        (``data.device_resident``): ``clouds`` is the [S, P, 3] stack of
        ``dpfx_torch.data.preload_clouds`` and, for SVR, ``images`` the
        [S, H, W, 3] render stack of ``preload_images``, each moved to the
        device once; each call draws and gathers steps_per_call batches
        there (the images with the clouds' ids), and a last call takes the
        remaining steps. The draws are keyed by the absolute step, so a
        resumed run draws what the uninterrupted one would have.

        Under a group with ``parallel.resident_sharding: sharded`` each rank
        keeps only its padded block of the stack; with
        ``clouds_are_local_shard`` the stacks given are that block already
        (loaded alone: ``process_local_rows``), and ``logical_rows`` is the
        split's unpadded size."""
        steps = steps or self.cfg.train.steps
        b, n = self.cfg.train.batch_size, self.cfg.data.n_points
        sharded = self.group is not None and self.cfg.parallel.resident_sharding == "sharded"
        if clouds_are_local_shard and not (sharded and logical_rows is not None):
            raise ValueError("clouds_are_local_shard needs a group, parallel.resident_sharding="
                             "sharded and logical_rows (the unpadded split size)")
        logical = logical_rows if logical_rows is not None else int(clouds.shape[0])
        if sharded:
            place = lambda t: shard_resident_stack(  # noqa: E731
                t, self.world, self.rank, self.device, is_local_shard=clouds_are_local_shard)
        else:
            place = lambda t: torch.as_tensor(t, dtype=torch.float32).to(self.device)  # noqa: E731
        data = place(clouds)
        if images is not None:
            images = place(images)
            if images.shape[0] != data.shape[0]:
                raise ValueError(f"{images.shape[0]} resident images for {data.shape[0]} clouds")
        spc = self.steps_per_call

        def one_step(state, batches):       # train.steps_per_call = 1: the eager step
            return self.train_step(state, {k: v[0] for k, v in batches.items() if v is not None})

        resident = make_resident_multi_step(self.model, self.tx, self.cfg,
                                            self.multi_step if spc > 1 else one_step,
                                            group=self.group, sharded=sharded,
                                            logical_rows=logical)
        cad = _Cadence(self, steps, val_batches_fn)
        while cad.step < steps:
            k = min(spc, steps - cad.step)
            self.state, metrics = resident(self.state, data, k, images=images)
            cad.record(k, metrics, b * n)
        cad.finish()
        self.last_eval_step = cad.last_eval_step
        return self.state

    def fit_auto(self, make_batches: Optional[Callable[[], Iterator]] = None,
                 val_batches_fn: Optional[Callable[[], Iterator]] = None,
                 resident_clouds: Union[np.ndarray, Tensor, None] = None,
                 resident_images: Union[np.ndarray, Tensor, None] = None,
                 clouds_are_local_shard: bool = False,
                 logical_rows: Optional[int] = None) -> TrainState:
        """``fit`` on ``make_batches()`` (or ``fit_resident`` on
        ``resident_clouds`` and, for SVR, ``resident_images``, with
        ``clouds_are_local_shard`` and ``logical_rows`` as there) with
        divergence recovery
        (``train.recover_on_divergence``, off by default): on
        TrainDivergedError, restore the latest checkpoint in place (or
        re-initialise without one), multiply ``train.lr`` by
        ``train.recovery_lr_factor``, build a new optimizer and train steps
        (the captured graph holds the learning rate as a constant, so the
        old graph is released and the step captured again at its next
        call), restart the batch stream and go on towards ``train.steps``;
        at most ``train.max_recoveries`` times, then re-raise. Under a group
        every rank reads the same all-reduced metrics, so all of them
        diverge at the same call and recover in step."""
        tries = 0
        while True:
            try:
                if resident_clouds is not None:
                    return self.fit_resident(resident_clouds, val_batches_fn=val_batches_fn,
                                             images=resident_images,
                                             clouds_are_local_shard=clouds_are_local_shard,
                                             logical_rows=logical_rows)
                return self.fit(make_batches(), val_batches_fn=val_batches_fn)
            except TrainDivergedError:
                tcfg = self.cfg.train
                tries += 1
                if not tcfg.recover_on_divergence or tries > tcfg.max_recoveries:
                    raise
                self.cfg.train = tcfg = dataclasses.replace(
                    tcfg, lr=tcfg.lr * tcfg.recovery_lr_factor)
                self.multi_step.release()
                self.tx = make_optimizer(tcfg)
                self.train_step = make_train_step(self.model, self.tx, self.cfg, self.group)
                self.multi_step = make_multi_step(self.model, self.tx, self.cfg, self.group)
                restored = self._latest_step()
                if restored is None:
                    self._reinit()
                else:
                    self._restore(restored)
                self.log_fn(f"[dpfx_torch] diverged (recovery {tries}/{tcfg.max_recoveries}): "
                            f"restored step {restored or 0}, lr -> {tcfg.lr:g}; continuing")

    @torch.no_grad()
    def _reinit(self) -> None:
        """The initial state again, written into the existing storage."""
        fresh = init_params_(DPF(self.cfg), self.cfg.train.seed)
        for p, q in zip(self.model.parameters(), fresh.parameters()):
            p.copy_(q)
        for t in (self.state.opt_state.mu, self.state.opt_state.nu, self.state.opt_state.count,
                  self.state.step):
            t.zero_()
        self.state.host_step = 0
        self._broadcast()
