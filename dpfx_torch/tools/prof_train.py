"""Ablation profiler for the flagship train step: the step cut into pieces,
each timed alone (the counterpart of the JAX package's
``tools/prof_train.py``, with the same pieces and names).

    python -m dpfx_torch.tools.prof_train [--device cpu] [--trace-dir DIR] [piece ...]
    Env: DPFX_PROF_B (64), DPFX_PROF_N (2048), DPFX_PROF_REPS (20)

Pieces: ``full`` (the train step: loss, backward, clip and Adam, with the
config's fused kernels), ``fwd`` and ``fwdbwd`` (the ELBO through the
modules), ``nometrics`` (loss, backward, clip and Adam without the metrics, the
ELBO through the modules as in the JAX tool), ``pf_fwd``, ``pf_fwdbwd`` (the point flow's log-likelihood
through the modules), ``enc_fwdbwd`` (the PointNet encoder's module),
``pf_fused_fwd``, ``pf_fused_fwdbwd`` (the ``fused_train`` kernels),
``enc_fused_fwdbwd`` (the ``fused_encoder`` kernels), ``full_fe`` (the
step with the fused encoder forced on) and ``lf_fwdbwd`` (the latent
flow). With no piece named, ``full``, ``fwd``, ``fwdbwd``, ``pf_fwd``,
``pf_fwdbwd``, ``enc_fwdbwd`` and ``lf_fwdbwd`` run, and ``nometrics``
runs with ``full``, as in the JAX tool. Every gradient piece sums every
gradient leaf, so no part of the backward can be skipped.

The model is the flagship (``dpfx_torch.config.flagship``) freshly initialised
(seeded: each coupling starts as the identity, as a training run does); x and z are N(0, 1) and the ELBO's eps is drawn once, outside the
pieces. On the card each piece is captured in a CUDA graph and ``reps``
replays are timed between CUDA events (``graph_time_ms``): an eager piece
would time the host's launch rate, not the device. Each line gives ms per
call and M points/s and, on the card, the device-busy ms per call that
``torch.profiler`` saw over ``min(reps, 5)`` more replays (written as a
Chrome trace per piece under ``--trace-dir`` when given). On the CPU the
pieces run eagerly, timed by the host clock. The state-updating pieces
restore the weights and the optimizer state after their run, so every
piece sees the same weights. The kernel launches, counted across replays,
are printed last.
"""

from __future__ import annotations

import argparse
import copy
import os
import sys
from typing import Callable, Dict, List, Tuple

import torch

Tensor = torch.Tensor

DEFAULT = ("full", "fwd", "fwdbwd", "pf_fwd", "pf_fwdbwd", "enc_fwdbwd", "lf_fwdbwd")
PIECES = ("full", "fwd", "fwdbwd", "nometrics", "pf_fwd", "pf_fwdbwd", "enc_fwdbwd",
          "pf_fused_fwd", "pf_fused_fwdbwd", "enc_fused_fwdbwd", "full_fe", "lf_fwdbwd")
LABELS = {
    "full": "full step (fwd+bwd+adam)",
    "fwd": "elbo fwd",
    "fwdbwd": "elbo fwd+bwd",
    "nometrics": "bare fwd+bwd+adam (no metrics)",
    "pf_fwd": "point_flow log_prob fwd",
    "pf_fwdbwd": "point_flow fwd+bwd",
    "enc_fwdbwd": "encoder fwd+bwd",
    "pf_fused_fwd": "point_flow FUSED fwd",
    "pf_fused_fwdbwd": "point_flow FUSED fwd+bwd",
    "enc_fused_fwdbwd": "encoder FUSED fwd+bwd",
    "full_fe": "full step + fused encoder",
    "lf_fwdbwd": "latent_flow fwd+bwd",
}
UPDATES_STATE = ("full", "nometrics", "full_fe")


def selected(names) -> List[str]:
    """The pieces to run, in the tool's order: the named ones (or the
    default set), with ``nometrics`` beside ``full``."""
    which = set(names) or set(DEFAULT)
    bad = which - set(PIECES)
    if bad:
        raise SystemExit(f"unknown pieces {sorted(bad)}; choose from {', '.join(PIECES)}")
    if "full" in which:
        which.add("nometrics")
    return [p for p in PIECES if p in which]


def gsum(grads) -> Tensor:
    """The sum of every gradient leaf (a leaf the loss does not reach is a
    zero, as jax.grad gives it)."""
    return torch.stack([g.float().sum() for g in grads if g is not None]).sum()


def build_pieces(model, cfg, x: Tensor, z: Tensor, eps: Tensor, names
                 ) -> Tuple[Dict[str, Callable[[], Tensor]], Callable[[], None]]:
    """``({piece: fn() -> closing scalar}, restore)`` for ``names`` on
    ``model`` (``cfg`` its config), batch x [B, N, 3], z and eps [B, dz].
    ``restore()`` puts back the weights and the optimizer state that the
    state-updating pieces change."""
    from dpfx_torch.ops.fused_encoder import fused_pointnet_posterior
    from dpfx_torch.ops.fused_train import fused_point_flow_recon_ll
    from dpfx_torch.train import elbo_loss, init_state, make_optimizer
    from dpfx_torch.train.trainer import _make_step

    tx = make_optimizer(cfg.train)
    state = init_state(model, tx)
    params = list(model.parameters())
    saved = [t.clone() for t in (state.params, state.opt_state.mu, state.opt_state.nu,
                                 state.opt_state.count, state.step)]

    def restore() -> None:
        for t, v in zip((state.params, state.opt_state.mu, state.opt_state.nu,
                         state.opt_state.count, state.step), saved):
            t.copy_(v)

    def grad_of(loss: Tensor) -> Tensor:
        return gsum(torch.autograd.grad(loss, params, allow_unused=True))

    def elbo(fe: bool = False, fpf: bool = False) -> Tensor:
        return elbo_loss(model, x, eps, fused_point_flow=fpf, fused_encoder=fe)[0]

    def no_grad(fn: Callable[[], Tensor]) -> Callable[[], Tensor]:
        return lambda: torch.no_grad()(fn)()

    pfc = cfg.model.point_flow
    fns: Dict[str, Callable[[], Tensor]] = {}
    for name in names:
        if name in ("full", "full_fe"):
            c = copy.deepcopy(cfg)
            if name == "full_fe":
                c.train.fused_encoder = True
            step = _make_step(model, tx, c)
            fns[name] = lambda step=step: step(state, x, eps, None)["loss"]
        elif name == "nometrics":
            def bare() -> Tensor:
                loss = elbo()
                grads = torch.autograd.grad(loss, params, allow_unused=True)
                flat = torch.cat([(torch.zeros_like(p) if g is None else g).reshape(-1)
                                  for g, p in zip(grads, params)])
                tx.apply_(state.params, flat, torch.linalg.vector_norm(flat), state.opt_state)
                state.step.add_(1)
                return state.step.float()
            fns[name] = bare
        elif name == "fwd":
            fns[name] = no_grad(elbo)
        elif name == "fwdbwd":
            fns[name] = lambda: grad_of(elbo())
        elif name == "pf_fwd":
            fns[name] = no_grad(lambda: model.point_flow.log_prob(x, z).sum())
        elif name == "pf_fwdbwd":
            fns[name] = lambda: grad_of(model.point_flow.log_prob(x, z).sum())
        elif name == "enc_fwdbwd":
            fns[name] = lambda: grad_of(sum(t.sum() for t in model.encoder(x)))
        elif name == "pf_fused_fwd":
            fns[name] = no_grad(lambda: fused_point_flow_recon_ll(model, x, z, pfc).sum())
        elif name == "pf_fused_fwdbwd":
            fns[name] = lambda: grad_of(fused_point_flow_recon_ll(model, x, z, pfc).sum())
        elif name == "enc_fused_fwdbwd":
            fns[name] = lambda: grad_of(sum(t.sum() for t in
                                            fused_pointnet_posterior(model.encoder, x)))
        elif name == "lf_fwdbwd":
            fns[name] = lambda: grad_of(model.latent_flow.log_prob(z).sum())
    return fns, restore


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("pieces", nargs="*", help=f"any of {', '.join(PIECES)}")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--trace-dir", default=None,
                    help="write each piece's profiled replays as a Chrome trace here")
    args = ap.parse_args(argv)
    names = selected(args.pieces)

    from dpfx_torch.config.flagship import flagship_config, flagship_model
    from dpfx_torch.tools._common import card, launch_counters, launches_line, reset_launch_counts
    from dpfx_torch.utils.profiling import device_busy_us, device_profile, graph_time_ms, trace

    b = int(os.environ.get("DPFX_PROF_B", "64"))
    n = int(os.environ.get("DPFX_PROF_N", "2048"))
    reps = int(os.environ.get("DPFX_PROF_REPS", "20"))
    cfg = flagship_config()
    model = flagship_model(args.device, cfg)
    dev = model.device
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.randn((b, n, 3), generator=g, device=dev)
    z = torch.randn((b, cfg.model.dz), generator=g, device=dev)
    eps = torch.randn((b, cfg.model.dz), generator=g, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    reset_launch_counts()
    fns, restore = build_pieces(model, cfg, x, z, eps, names)

    pts = b * n
    on_card = dev.type == "cuda"
    print(f"B={b} N={n} reps={reps} (ms/call, "
          f"{'CUDA-graph replays between CUDA events' if on_card else 'eager, host clock'}; "
          f"{card(dev)})")
    for name in names:
        t = graph_time_ms(fns[name], reps, launch_counters())
        busy = ""
        if on_card:
            calls = min(reps, 5)
            ctx = (trace(os.path.join(args.trace_dir, name)) if args.trace_dir
                   else device_profile(record_shapes=False))
            with ctx as prof:
                for _ in range(calls):
                    t["call"]()
            busy = f"   busy {device_busy_us(prof) / calls / 1e3:8.3f} ms"
        if name in UPDATES_STATE:
            restore()
        ms, closing = t["ms"], t["closing"]
        del t
        if on_card:
            torch.cuda.empty_cache()
        print(f"  {LABELS[name]:32s} {ms:8.3f} ms   {pts / ms * 1000 / 1e6:7.1f}M pts/s{busy}"
              f"   closing {closing:.6g}", flush=True)
    print(launches_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
