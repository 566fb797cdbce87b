#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build the kernels, hold each one
against its plain PyTorch version at the flagship widths, drive the main
paths (flagship sampling, flagship training, evaluation: the generation
suite and AE reconstruction, the differentiable distances and the int8
sampler) through the normal entry points, and report.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints its result on its own line; any failure raises and the
script exits non-zero without a result line):
  1. the card's name and power limit; build every kernel with nvcc (sm_90a),
     all sources at once, and print ptxas' register and spill lines;
  2. kernel vs plain version at K=32, H=128, dz=128, B=8, N=2048 and a
     ragged N=2000: f32 and bf16 for fused_inverse, bf16 for fused_sample
     against the plain inverse of the noise it drew, noise moments at
     tau=1 and 1.1, and same-seed determinism; then the training kernels in
     f32 and bf16: fused_train forward (u, log-det) and backward (dx, dhz,
     every weight gradient), fused_encoder forward and backward (encoder
     128/128/256/512, a cloud of duplicated points and a dead feature), each
     backward run twice and required bit-identical; the plain f32 backwards
     run once more with TF32 products allowed, a control that the f32 limit
     must fail; then the latent-flow kernels (fused_latent.cu) at the
     flagship latent widths (K=14, dz=128, H=256) and B=8, 64 and 130 (a
     ragged last tile over nine blocks): forward (u, log-det), inverse and
     backward (dz, every weight and bias gradient) in f32 and bf16, the
     backward twice and required bit-identical, a TF32 control of the plain
     f32 backward, and the f32 round trip fwd(inv(eps)) = eps;
  2c. the evaluation kernels (chamfer.cu, emd.cu) vs their plain versions on
     synthetic test-split clouds at N=2048 and at a ragged N=2000 against
     M=2048, with one pair of identical clouds: nnd_fwd (B=8), cd_pairwise
     exact, fast and symmetric (16 x 16), emd_batched exact (B=8, also
     against an f64 run of the plain version), emd_pairwise fast and exact
     (8 x 8); each kernel run twice and required bit-identical; the plain
     exact CD with TF32 products allowed, a control that the CD limit must
     fail; fast against exact EMD on a near-identical pair, reported;
  3. the sampling path at full width (configs/flagship_quality_v3_aug_100k.yaml,
     random seeded weights): dpfx_torch.generate.main for 64 clouds, the
     timed make_sampler(64, 2048), make_decoder and DPF.reconstruct on
     Gaussian-blob clouds; launch counts are zeroed just before and read
     just after; then generate.main and make_sampler(64, 2048) again under
     DPFX_SAMPLE_FUSED_LATENT=1 (the fused latent inverse), counts zeroed
     and read around them, and the two samplers timed in turns;
  3b. the training path at full width: dpfx_torch.train's CLI for 30 steps of
     B=64 x N=2048 (data.synthetic_size cut to 512 clouds to bound host data
     generation), launch counts zeroed just before and read just after; every
     logged loss and grad norm finite, no step skipped, the params moved, and
     the saved checkpoint sampled by dpfx_torch.generate; then the train
     step's time (CUDA events, batches on the card); the CLI again for 10
     steps with train.fused_latent_flow=true on the same schedule (the same
     checks, the latent kernels launched, its loss windows held to the
     first run's); the train step with the fused latent flow off and on,
     timed in turns; and one fused step, with and without the fused latent
     flow, against the module path on the same batch and noise;
  3c. the evaluation paths at full width on phase 3b's checkpoint:
     dpfx_torch.evaluate's CLI for the generation suite
     (flagship_quality_v3_aug_100k.yaml) and AE reconstruction
     (flagship_ae_quality_synthetic.yaml), each with --limit 128 (the
     protocol's 400 test clouds cut to bound the run), launch counts zeroed
     just before each and read just after; then compute_all_metrics on two
     disjoint stratified halves of the test split (the ideal-generator row)
     and on one half shifted by 0.5;
  3d. the differentiable distances at full width, on phase 3's 64 sampled
     clouds against 64 test-split clouds (N=M=2048) and a ragged 2000 x
     2048 batch: nnd_bwd against nn_distances_backward_plain on the same
     minima (per point, twice for bit-identity), two tie cases (y = x with
     every point duplicated; y duplicated and x perturbed, where the copies
     must share the gradient); the EMD gradient mode at B=32, 64 and the
     ragged batch (its cost equal to emd_nograd's bit for bit, gx and gy
     per pair against emd_grads_plain by median and maximum, twice for
     bit-identity, the ragged batch also against an f64 run); then 20
     steps of gradient descent on chamfer + emd from a perturbed copy of
     the test clouds towards them (launch counts zeroed just before and
     read just after), which must lower both for every pair;
  3e. the int8 sampler: fused_sample_points(quantized=quantize_flow_params)
     on the flagship stack, bf16, at B=64 (launch counts zeroed and read
     around it) and B=256, N=2048: bit-identical to the kernel on the
     dequantized stacks with the same seed, within phase 2's bf16 limits
     of the plain inverse of its noise, its coordinate RMS against the bf16
     clouds, and int8 and bf16 timed in turns;
  4. at the main paths' shapes (B=64, N=2048, bf16): the training kernels
     held against their plain versions again (u, log-det, every gradient;
     each backward bit-identical across two runs), the latent-flow kernels
     at B=64, then one JSON line with
     every kernel's error, time, plain time and bound, the evaluation
     kernels' at their paths' shapes (a 128 x 128 matrix at N=2048 for the
     pairwise kernels, CD also in triangle mode, B=32 for the diagonal ones),
     each held to its plain version there by phase 2c's limits, and the
     rows of phases 3d and 3e (16 rows in all);
  5. torch.profiler breakdowns of make_sampler(64, 2048) (plain and fused
     latent inverse), of 5 train steps (fused latent flow off and on), and
     (5c) of one generation suite at S=128: device-busy time, idle share,
     kernels per call and the kernels that take the time;
  6. the card line again, then the last line: {"ok": true, "device": {...}}.
It needs no network and starts no process that outlives it (nvcc and
nvidia-smi are waited for).
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "flagship_quality_v3_aug_100k.yaml"
AE_CONFIG = ROOT / "configs" / "flagship_ae_quality_synthetic.yaml"
WORK = ROOT / "build" / "chip_smoke"

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# issue rates outside the tensor cores: 132 SMs at the 1.98 GHz boost clock,
# each with 128 FP32 lanes (one FP32 instruction per lane per clock, an FMA
# counting once) and 16 special-function lanes (MUFU: ex2, rsqrt, ...)
SMS, BOOST_HZ = 132, 1.98e9
PEAK_FP32_INSTR = SMS * 128 * BOOST_HZ     # 33.45e12 per second
PEAK_MUFU = SMS * 16 * BOOST_HZ            # 4.18e12 per second
# FP32 instructions per distance element: x.y (a product and two FMAs), the
# norms' add, the fused -2 x.y, the max, and (CD) the row and column mins
CD_FP32_PER_ELEM = 8
# approxmatch per element and level, at the least: two distances (pass 1
# and the recomputed pass 2, 6 each), the exp arguments, the w, rowsum, ss,
# colsum, cdist and delta arithmetic (21 FP32), and the exp of each pass
# and the sqrt (3 MUFU)
EMD_FP32_PER_ELEM_LEVEL = 21
EMD_MUFU_PER_ELEM_LEVEL = 3
# the CD backward per element, at the least: one distance (6) and the row
# and column mask tests (2), the forward's scan. The tie counts and the
# masked sums (sum_j maskl y_j, sum_j wr_ij and sum_j wr_ij y_j for gx;
# sum_i maskr x_i, sum_i wl_ij and sum_i wl_ij x_i for gy) add only where
# d <= dmin: per neighbour of a row and of a column, two counts and 14 sums
CD_BWD_FP32_PER_ELEM = 8
CD_BWD_FP32_PER_MATCH = 16
# the EMD gradient mode per element and level, on top of the cost's (no
# [N, M] intermediate is kept, so the plan of each level is used where it
# is made, as the cost's own count assumes): the
# difference x_i - y_j and its squared norm (3 + 3), the plan's share
# delta / max(|x_i - y_j|, eps) (an rsqrt on MUFU, a max, a product) and its
# sums into gx and gy (6 FMAs)
EMD_GRAD_FP32_PER_ELEM_LEVEL = 14
EMD_GRAD_MUFU_PER_ELEM_LEVEL = 1

# tolerances of kernel vs plain version (max abs error over the outputs)
# on O(1)-O(10) clouds. f32: both sum in IEEE f32, in other orders, through
# 32 layers (seen: 4e-6). bf16: the operands round identically, but a sum
# that lands on the other side of a bf16 rounding boundary flips one hidden
# unit by one ulp and 32 layers carry it on (seen: max 4e-3, p99.9 2e-4).
TOL_F32 = 1e-4
TOL_BF16_MAX = 5e-2
TOL_BF16_P999 = 2e-3
# training kernels: relative norm error of each gradient tensor (and of the
# pooled feature and log-det). f32: IEEE sums in other orders, and tanh/exp
# whose device and torch versions differ in the last ulp, carried through 32
# layers of dy *= exp(s) and of inputs rebuilt from outputs (seen at B=8 on
# the seeded weights: <= 2.9e-7). The limit sits well below what products
# on TF32 operands read: phase 2b runs the plain f32 backward once with
# TF32 allowed as a control and requires that control to fail the limit
# (seen: 3.3e-3 fused_train, 6.7e-2 fused_encoder). bf16: one flipped
# rounding of a hidden unit or of a max-pool argmax moves a few entries
# (seen: <= 1.3e-4 at B=8; at B=64 on the synthetic clouds, whose
# near-ties flip a few argmaxes, up to 5.6e-3 on the encoder's dx); the
# bracket that tests/test_fused_train.py allows bf16 against flax is 5%.
TOL_GRAD_F32 = 1e-5
TOL_GRAD_BF16 = 2e-2
# whole fused step against the module path (bf16 rounds at other places in
# the two): the bracket of tests/test_fused_train.py:192-231
TOL_STEP_LOSS = 2e-2
TOL_STEP_GNORM = 5e-2
# the loss windows of 10 training steps with the fused latent flow against
# the same steps with the module path (same init, data and noise): bf16
# rounds at other places in the two, and 10 updates carry it on (seen:
# 3.7e-5); a schedule that diverges in one diverges in the other as well
TOL_TRAIN_DRIFT = 5e-2
TRAIN_STEPS = 30


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def errors(a, b):
    import torch

    e = (a.float() - b.float()).abs().flatten()
    return float(e.max()), float(torch.quantile(e[:: max(1, e.numel() // 2**24)], 0.999))


def bound(sp, b: int, n: int, with_ut: bool, weight_bytes: int = 2):
    """Least time for one call: FLOP over the bf16 tensor-core peak, and
    bytes (each input read once, each output written once) over HBM; the
    weight stacks at ``weight_bytes`` per element (int8 mode: 1, and the
    [K, 8] f32 scales)."""
    k, h, _ = sp.wx.shape
    nh1 = sp.wh.shape[1]
    flops = 2.0 * b * n * k * (3 * h + nh1 * h * h + 6 * h)
    weights = (weight_bytes * (k * h * 3 + k * nh1 * h * h + k * 6 * h)
               + 4 * (k * nh1 * h + k * 6 + k * 3) + (32 * k if weight_bytes == 1 else 0))
    nbytes = 4 * b * k * h + weights + 4 * 3 * b * n * (2 if with_ut else 1)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes"), flops


def bound_of(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def bound_cores(fp32_instr: float, mufu_ops: float, nbytes: float):
    """Least time (ms) of work that runs on the CUDA cores, not the tensor
    cores: the larger of its FP32 instructions over the FP32 issue rate and
    its special-function operations over the MUFU rate, against its bytes
    over HBM."""
    t_ops = max(fp32_instr / PEAK_FP32_INSTR, mufu_ops / PEAK_MUFU) * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes else "bytes")


def eval_bounds(n_pairs: int, n: int, m: int, s_left: int, s_right: int, out_floats: int):
    """CD and approxmatch EMD over n_pairs pairs of N x M points: the
    per-element instruction counts above, and the bytes of the s_left + s_right
    input clouds read once and the outputs written once."""
    elems = float(n_pairs) * n * m
    nbytes = 12.0 * (s_left * n + s_right * m) + 4.0 * out_floats
    cd = bound_cores(CD_FP32_PER_ELEM * elems, 0.0, nbytes)
    lv = elems * 10
    emd = bound_cores(EMD_FP32_PER_ELEM_LEVEL * lv, EMD_MUFU_PER_ELEM_LEVEL * lv, nbytes)
    return cd, emd


def grad_bounds(b: int, n: int, m: int):
    """The CD backward (nnd_bwd) and the EMD gradient mode over b diagonal
    pairs of N x M points: the instruction counts above, and the bytes of
    their inputs read once (clouds; for CD also dl, dr and the cotangents)
    and outputs written once (gx, gy; for EMD also the cost). Each row and
    each column of a CD pair has one nearest neighbour (ties aside)."""
    elems = float(b) * n * m
    grads = 12.0 * b * (n + m)
    cd = bound_cores(CD_BWD_FP32_PER_ELEM * elems + CD_BWD_FP32_PER_MATCH * b * (n + m), 0.0,
                     2 * grads + 16.0 * b * (n + m))
    lv = elems * 10
    emd = bound_cores((EMD_FP32_PER_ELEM_LEVEL + EMD_GRAD_FP32_PER_ELEM_LEVEL) * lv,
                      (EMD_MUFU_PER_ELEM_LEVEL + EMD_GRAD_MUFU_PER_ELEM_LEVEL) * lv,
                      2 * grads + 4.0 * b)
    return cd, emd


def train_bounds(sp, b: int, n: int):
    """Forward and backward of the fused point flow: FLOP of the products
    (the backward recomputes the conditioner, then the cotangent and weight
    products: 2(27H + 3(n_hidden-1)H^2) per point and layer) and the bytes
    of their inputs and outputs (bf16 weights, f32 gradients)."""
    k, h, _ = sp.wx.shape
    nh1 = sp.wh.shape[1]
    nw = k * (3 * h + nh1 * h * h + 6 * h)
    small = 4 * k * (nh1 * h + 6 + 3)
    fwd = bound_of(2.0 * b * n * k * (9 * h + nh1 * h * h),
                   2 * 12 * b * n + 4 * b * k * h + 2 * nw + small + 4 * b)
    bwd = bound_of(2.0 * b * n * k * (27 * h + 3 * nh1 * h * h),
                   3 * 12 * b * n + 2 * 4 * b * k * h + 4 * b + 2 * nw + small
                   + 4 * (nw + k * (nh1 * h + 6)))
    return fwd, bwd


def latent_bounds(w, b: int):
    """Forward (the inverse does the same work) and backward of the fused
    latent flow at batch b: FLOP of the conditioner products (the backward
    recomputes them, then the cotangent and weight-gradient products) and
    the bytes of their inputs and outputs (bf16 weights, f32 biases, masks,
    latents and gradients)."""
    k, h, d = w["win"].shape
    nh1 = w["wh"].shape[1]
    nw = k * (h * d + nh1 * h * h + 2 * d * h)
    nb = k * (h + nh1 * h + 2 * d)
    small = 4 * (nb + k * d)
    fwd = bound_of(2.0 * b * nw, 2 * nw + small + 2 * 4 * b * d + 4 * b)
    bwd = bound_of(3 * 2.0 * b * nw, 2 * nw + small + 3 * 4 * b * d + 4 * b + 4 * (nw + nb))
    return fwd, bwd


def encoder_bounds(widths, b: int, n: int):
    """Forward and backward of the fused PointNet MLP + max-pool (the
    backward recomputes the chain, then the weight and cotangent products)."""
    macs = sum(widths[i] * widths[i + 1] for i in range(len(widths) - 1))
    nw, w = macs + sum(widths[1:]), widths[-1]
    fwd = bound_of(2.0 * b * n * macs, 12 * b * n + 2 * nw + 2 * 4 * b * w)
    bwd = bound_of(2.0 * b * n * 3 * macs, 2 * 12 * b * n + 2 * nw + 3 * 4 * b * w + 4 * nw)
    return fwd, bwd


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30))


def tf32_control(plain, ref) -> float:
    """The largest relative error against ``ref`` of the plain f32 version
    run with TF32 products allowed: what a kernel whose f32 mode quietly
    multiplied TF32 operands would read."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    got = plain()
    torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32 = False
    return max(rel(a, b) for a, b in zip(got, ref) if b.numel())


# evaluation kernels against their plain versions: relative error per pair,
# |a - b| / max(|b|, floor). CD: the kernel's distances equal the plain
# version's bit for bit (both round every operation on its own), so only the
# order of the sums of minima differs; the limit is the JAX package's own
# (tests/test_chamfer.py:40), in both modes. The plain exact CD with its x.y
# products on TF32 operands must fail it (a control).
TOL_CD = 1e-5
CD_FLOOR = 1e-7
# EMD: approxmatch carries rounding through its saturation recursion, and two
# f32 runs of one schedule that sum in other orders part on a few pairs (the
# f32 plain version against an f64 run of it: median 2e-6, max 1.7e-3 over
# 200 random pairs of 37 x 101 points, a CPU measurement). So the median pair
# is held to the JAX package's limit (tests/test_emd.py:76: rtol 1e-4, atol
# 1e-5) and the largest to that drift; exact mode also against an f64 run.
TOL_EMD_MEDIAN = 1e-4
TOL_EMD_MAX = 5e-3
EMD_FLOOR = 1e-5
TOL_EMD_FAST_EXACT = 2e-2     # fast against exact: tests/test_emd.py:124 (rtol, atol)
EMD_FAST_ATOL = 1e-3
# an identical pair reads near 0: tests/test_chamfer.py:52, tests/test_emd.py:79
TOL_CD_IDENTICAL = 1e-5
TOL_EMD_IDENTICAL = 1e-3
TOL_EMD_IDENTICAL_SHARE = 0.05
EVAL_LIMIT = 128              # test clouds per evaluation path (the protocol uses 400)
# the CD backward against its plain version: the masks see the same
# distances bit for bit (the forward's minima, one sqdist expression), so
# only the order of the f32 sums differs. Per point, |gk_i - gp_i| over
# |gp_i| plus the mean |gp| of the pair (a floor for points whose terms
# cancel); the limit is the CD limit (seen on the first card run: gradients
# of O(1) within 2.4e-6 absolute at 8 x 2048)
TOL_CD_GRAD = 1e-5
# the EMD gradients against emd_grads_plain, per pair by the relative norm
# of gx and of gy, the median pair and the largest held apart as the cost
# is. On these clouds approxmatch's plan is well conditioned: the kernel
# read median 8.7e-7, max 1.3e-6 (near-identical 2.0e-7), and against an
# f64 run of the plain version median 3.6e-6, max 9.3e-6, as far as the
# f32 plain version (NVIDIA H100 80GB HBM3, 700 W). The limits sit ~10x and
# ~80x above those. Weighing by sqrt of the expanded distance, as the Pallas
# body does, reads 2.5e-6 (median) to 7.8e-6 on the ragged pair, inside the
# limits, and ~1e5 on the near-identical pair, which is where a control
# must fail them.
# (On 200-2048 random Gaussian pairs the plan is chaotic in f32, and the f32
# plain version itself parts from f64 by up to 2.8e-2: tests/test_torch_cuda.py.)
TOL_EMD_GRAD_MEDIAN = 1e-5
TOL_EMD_GRAD_MAX = 1e-4
# against the f64 run the kernel may part by no more than this many times
# as far as the f32 plain version does (seen: 1.01x), plus a floor
EMD_GRAD_F64_RATIO = 4.0
EMD_GRAD_F64_FLOOR = 1e-6
# the int8 sampler's clouds against the bf16 ones with the same noise: dpfx
# documents ~0.3% coordinate RMS (dpfx/ops/fused_sampler.py:424)
TOL_INT8_RMS = 2e-2


def pair_err(a, b, floor: float):
    """Per-pair relative error |a - b| / max(|b|, floor), in f64."""
    return (a.double() - b.double()).abs() / b.double().abs().clamp_min(floor)


def cd_tf32_control(xs, ys):
    """The plain exact CD matrix with x.y as a matmul on TF32 operands (K
    padded to 16, a tensor-core shape): what a CD kernel that quietly
    multiplied TF32 operands would read."""
    import torch

    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        x2, y2 = (xs * xs).sum(-1), (ys * ys).sum(-1)
        pad = lambda t: torch.nn.functional.pad(t, (0, 13))
        rows = []
        for i in range(xs.shape[0]):
            xy = torch.matmul(pad(xs[i]), pad(ys).transpose(1, 2))          # [S2, N, M]
            d = (x2[i][None, :, None] + y2[:, None, :] - 2.0 * xy).clamp_min(0.0)
            rows.append(d.min(-1)[0].mean(-1) + d.min(-2)[0].mean(-1))
        torch.cuda.synchronize()
        return torch.stack(rows)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def split_clouds(cfg, idx, n: int, seed: int, dev):
    """Clouds of the config's synthetic test split, subsampled to n points."""
    import numpy as np
    import torch

    from dpfx_torch.data import build_dataset, load_all

    ds = build_dataset(cfg.data, "test")
    return torch.from_numpy(load_all(ds, n, seed=seed, indices=np.asarray(idx))).to(dev)


def eval_kernel_checks(cfg, dev) -> None:
    """Phase 2c: the four evaluation kernels against their plain versions."""
    import torch

    from dpfx_torch.ops import chamfer as cdk
    from dpfx_torch.ops import emd as emdk

    med = lambda e: float(e.median())
    for n in (2048, 2000):
        xs = split_clouds(cfg, range(16), n, 2, dev)
        ys = split_clouds(cfg, range(16, 32), 2048, 1, dev)
        ident = n == 2048
        if ident:
            ys[0] = xs[0]               # pair 0 compares a cloud with itself
        tag = f"N={n} M=2048"

        x, y = xs[:8], ys[:8]
        dl, dr = cdk.nn_distances(x, y)
        again = cdk.nn_distances(x, y)
        pdl, _, pdr, _ = cdk.nn_distances_plain(x, y)
        torch.cuda.synchronize()
        pt = max(float(pair_err(dl, pdl, CD_FLOOR).max()), float(pair_err(dr, pdr, CD_FLOOR).max()))
        cd_k = dl.mean(-1) + dr.mean(-1)
        e_cd = float(pair_err(cd_k, pdl.mean(-1) + pdr.mean(-1), CD_FLOOR).max())
        print(f"kernel-vs-plain nnd_fwd {tag} B=8: per-point rel max {pt:.2e}, CD rel max "
              f"{e_cd:.2e}" + (f", identical pair CD {float(cd_k[0]):.2e}" if ident else ""))
        check(torch.equal(dl, again[0]) and torch.equal(dr, again[1]),
              f"nnd_fwd bit-identical from run to run {tag}")
        check(pt <= TOL_CD and e_cd <= TOL_CD, f"nnd_fwd {tag}: per point {pt}, CD {e_cd}")
        check(not ident or float(cd_k[0]) <= TOL_CD_IDENTICAL, "CD of a cloud with itself")

        errs = {}
        for prec in ("exact", "fast"):
            a = cdk.chamfer_pairwise(xs, ys, prec)
            a2 = cdk.chamfer_pairwise(xs, ys, prec)
            b = cdk.chamfer_pairwise_plain(xs, ys, prec)
            torch.cuda.synchronize()
            errs[prec] = float(pair_err(a, b, CD_FLOOR).max())
            check(torch.equal(a, a2), f"cd_pairwise {prec} bit-identical from run to run {tag}")
            check(errs[prec] <= TOL_CD, f"cd_pairwise {prec} {tag}: {errs[prec]}")
        line = (f"kernel-vs-plain cd_pairwise {tag} 16x16: exact rel max {errs['exact']:.2e}, "
                f"fast rel max {errs['fast']:.2e}")
        if ident:
            sym = cdk.chamfer_pairwise(xs, xs, "exact", symmetric=True)
            full = cdk.chamfer_pairwise(xs, xs, "exact")
            ctl = float(pair_err(cd_tf32_control(xs, ys), cdk.chamfer_pairwise_plain(xs, ys),
                                 CD_FLOOR).max())
            line += (f"; symmetric == full {torch.equal(sym, full)}, mirrored "
                     f"{torch.equal(sym, sym.t())}, diagonal max {float(sym.diagonal().max()):.2e}; "
                     f"limit {TOL_CD:.0e} against the TF32 control {ctl:.2e}")
            check(torch.equal(sym, full) and torch.equal(sym, sym.t()),
                  "the symmetric matrix equals the full one and its transpose")
            check(float(sym.diagonal().max()) <= TOL_CD_IDENTICAL, "CD of each cloud with itself")
            check(ctl > TOL_CD, f"the CD limit fails a TF32 control ({ctl})")
        print(line)

        a = emdk.emd_nograd(x, y)
        a2 = emdk.emd_nograd(x, y)
        b = emdk.emd_plain(x, y)
        r64 = emdk.emd_plain(x.double(), y.double())
        torch.cuda.synchronize()
        kp, k64, p64 = pair_err(a, b, EMD_FLOOR), pair_err(a, r64, EMD_FLOOR), pair_err(b, r64, EMD_FLOOR)
        print(f"kernel-vs-plain emd_batched exact {tag} B=8: rel median {med(kp):.2e} max "
              f"{float(kp.max()):.2e}; against f64: kernel median {med(k64):.2e} max "
              f"{float(k64.max()):.2e}, plain f32 median {med(p64):.2e} max {float(p64.max()):.2e}"
              + (f"; identical pair {float(a[0]):.2e}" if ident else ""))
        check(torch.equal(a, a2), f"emd_batched bit-identical from run to run {tag}")
        for nm, e in (("plain", kp), ("f64", k64)):
            check(med(e) <= TOL_EMD_MEDIAN and float(e.max()) <= TOL_EMD_MAX,
                  f"emd_batched {tag} against {nm}: median {med(e)}, max {float(e.max())}")
        if ident:
            # the JAX package's own case (tests/test_emd.py:79): 64 random
            # points, identical clouds read < 1e-3; on a dense 2048-point
            # surface the first level (-4^7) still spreads mass to neighbours
            # ~0.01 away, so there the pair is held to a share of the EMD
            # between different clouds
            sparse = torch.randn((2, 64, 3), generator=torch.Generator(device=dev).manual_seed(3),
                                 device=dev) * 0.5
            e64 = emdk.emd_nograd(sparse, sparse)
            print(f"EMD of a cloud with itself: 64 random points {float(e64.max()):.2e}; "
                  f"2048-point test cloud {float(a[0]):.2e} against {float(a[1:].median()):.2e}, "
                  f"the median of the other pairs")
            check(float(e64.max()) < TOL_EMD_IDENTICAL, "EMD of a 64-point cloud with itself")
            check(float(a[0]) <= TOL_EMD_IDENTICAL_SHARE * float(a[1:].median()),
                  "EMD of a test cloud with itself")

        x8, y8 = xs[:8], ys[:8]
        got = {}
        for prec in ("fast", "exact"):
            a = emdk.emd_pairwise(x8, y8, precision=prec)
            a2 = emdk.emd_pairwise(x8, y8, precision=prec)
            b = emdk.emd_pairwise_plain(x8, y8, precision=prec)
            torch.cuda.synchronize()
            e = pair_err(a, b, EMD_FLOOR)
            got[prec] = (a, e)
            check(torch.equal(a, a2), f"emd_pairwise {prec} bit-identical from run to run {tag}")
            check(med(e) <= TOL_EMD_MEDIAN and float(e.max()) <= TOL_EMD_MAX,
                  f"emd_pairwise {prec} {tag}: median {med(e)}, max {float(e.max())}")
        fa, ex = got["fast"][0].clone(), got["exact"][0].clone()
        if ident:
            # fast mode's x.y from bf16 coordinates puts a phantom distance
            # between identical points (exact reads ~0): not a drift
            fa[0, 0] = ex[0, 0] = 1.0
        fe = pair_err(fa, ex, EMD_FLOOR)
        print(f"kernel-vs-plain emd_pairwise {tag} 8x8: fast rel median {med(got['fast'][1]):.2e} "
              f"max {float(got['fast'][1].max()):.2e}, exact median {med(got['exact'][1]):.2e} max "
              f"{float(got['exact'][1].max()):.2e}; fast against exact rel max {float(fe.max()):.2e}"
              + (f" (identical pair left out: fast {float(got['fast'][0][0, 0]):.2e}, exact "
                 f"{float(got['exact'][0][0, 0]):.2e})" if ident else ""))
        check(bool(((fa - ex).abs() <= EMD_FAST_ATOL + TOL_EMD_FAST_EXACT * ex.abs()).all()),
              f"emd_pairwise fast against exact {tag}: rel max {float(fe.max())}")
        if not ident:
            # a near-identical pair (cloud 0 at N points against itself at
            # 2048): the phantom distance of fast mode's bf16 x.y on top of
            # a small exact EMD, reported and left out of the check above
            near = split_clouds(cfg, range(1), 2048, 2, dev)
            nf = float(emdk.emd_pairwise(xs[:1], near, precision="fast")[0, 0])
            ne = float(emdk.emd_pairwise(xs[:1], near, precision="exact")[0, 0])
            print(f"near-identical pair {tag} (cloud 0 at both sizes): EMD fast {nf:.4e}, exact "
                  f"{ne:.4e}, fast against exact rel {abs(nf - ne) / ne:.3e}")


def run_eval_cli(argv):
    """dpfx_torch.evaluate.main in-process; its output is echoed. Returns
    (exit code, the results JSON of its last line, its own "wall s" timings,
    the wall seconds of the whole call)."""
    import contextlib
    import io

    import torch

    from dpfx_torch import evaluate

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = evaluate.main(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    lines = buf.getvalue().strip().splitlines()
    timed = [ln for ln in lines if ln.startswith("[dpfx_torch] wall s: ")]
    check(len(timed) == 1, "dpfx_torch.evaluate printed its timings")
    return rc, json.loads(lines[-1]), json.loads(timed[0].split(": ", 1)[1]), wall


def finite_numbers(d: dict) -> bool:
    import math

    for v in d.values():
        if isinstance(v, dict) and not finite_numbers(v):
            return False
        if isinstance(v, (int, float)) and not math.isfinite(v):
            return False
    return True


def eval_paths(cfg, dev, ckpt_dir: Path, trained_pt: Path):
    """Phase 3c. Returns the launch counts of each path, the two halves of
    the test split and the ideal row's matrix timings."""
    import numpy as np

    from dpfx_torch.data import build_dataset, load_all_labels, stratified_indices
    from dpfx_torch.metrics import compute_all_metrics
    from dpfx_torch.ops import chamfer as cdk
    from dpfx_torch.ops import emd as emdk
    from dpfx_torch.ops import fused_sampler as fs

    mods = (fs, cdk, emdk)
    counts = lambda: {k: v for m in mods for k, v in m.launches.items()}

    for m in mods:
        m.reset_launch_counts()
    rc, gen, gen_t, gen_wall = run_eval_cli([str(CONFIG), f"train.ckpt_dir={ckpt_dir}", "--step",
                                      str(TRAIN_STEPS), "--limit", str(EVAL_LIMIT)])
    gen_launches = counts()
    keys = {"step", "n_test", "mmd-cd", "cov-cd", "1-nna-cd", "mmd-emd", "cov-emd", "1-nna-emd",
            "jsd", "jsd_fit", "jsd_raw", "jsd_frame", "per_category", "per_category_convention"}
    check(rc == 0 and set(gen) == keys, f"generation results keys {sorted(gen)}")
    check(gen["step"] == TRAIN_STEPS and gen["n_test"] == EVAL_LIMIT and finite_numbers(gen),
          f"generation results {gen}")
    check(all(0.0 <= gen[k] <= 1.0 for k in ("cov-cd", "1-nna-cd", "cov-emd", "1-nna-emd")),
          "COV and 1-NNA in [0, 1]")
    for k in ("cd_pairwise", "emd_pairwise", "fused_sample"):
        check(gen_launches[k] > 0, f"kernel {k} was not launched on the generation path")

    for m in mods:
        m.reset_launch_counts()
    rc, ae, ae_t, ae_wall = run_eval_cli([str(AE_CONFIG), "--weights", str(trained_pt), "--limit",
                                    str(EVAL_LIMIT)])
    ae_launches = counts()
    check(rc == 0 and {"step", "n_test", "recon-cd", "recon-emd"} <= set(ae) and finite_numbers(ae),
          f"AE results {ae}")
    for k in ("nnd_fwd", "emd_batched", "fused_sample"):
        check(ae_launches[k] > 0, f"kernel {k} was not launched on the AE path")
    from dpfx_torch.config import load_config

    ae_bsz = load_config(str(AE_CONFIG)).eval.batch_size
    batches = -(-EVAL_LIMIT // ae_bsz)
    print(f"evaluation paths on the {TRAIN_STEPS}-step checkpoint, {EVAL_LIMIT} test clouds: "
          f"generation suite {gen_t['total']:.3f} s ({gen_wall:.2f} s with restore and data), "
          f"launches {json.dumps(gen_launches)}; AE {ae_t['total'] / batches * 1e3:.2f} ms per "
          f"{ae_bsz}-cloud batch ({batches} batches, {ae_wall:.2f} s with restore "
          f"and data), launches {json.dumps(ae_launches)}")

    # the suite is not vacuous: two halves of one distribution read ~0.5,
    # a shifted copy ~1
    labels = load_all_labels(build_dataset(cfg.data, "test"))
    pick = stratified_indices(labels, 2 * EVAL_LIMIT, seed=1)
    half_a = split_clouds(cfg, pick[0::2], 2048, 1, dev)
    half_b = split_clouds(cfg, pick[1::2], 2048, 2, dev)
    ideal_t, shift_t = {}, {}
    ideal = compute_all_metrics(half_a, half_b, ("cd", "emd"), timings=ideal_t)
    shifted = compute_all_metrics(half_a + 0.5, half_b, ("cd", "emd"), timings=shift_t)
    s, n_sym = EVAL_LIMIT, EVAL_LIMIT * (EVAL_LIMIT + 1) // 2
    per_pair = {k: v / (n_sym if k in ("cd_gg", "cd_rr") else s * s) * 1e6
                for k, v in ideal_t.items() if k != "jsd"}
    print(f"non-vacuity ({s} + {s} clouds): ideal halves 1-NNA-CD {ideal['1-nna-cd']:.4f}, "
          f"1-NNA-EMD {ideal['1-nna-emd']:.4f}, COV-CD {ideal['cov-cd']:.4f}, JSD "
          f"{ideal['jsd']:.5f}; shifted by 0.5: 1-NNA-CD {shifted['1-nna-cd']:.4f}, 1-NNA-EMD "
          f"{shifted['1-nna-emd']:.4f}; matrix wall s {json.dumps({k: round(v, 4) for k, v in ideal_t.items()})}"
          f"; us per pair {json.dumps({k: round(v, 2) for k, v in per_pair.items()})}")
    for k in ("1-nna-cd", "1-nna-emd"):
        check(0.35 <= ideal[k] <= 0.65, f"ideal-row {k} {ideal[k]} in [0.35, 0.65]")
        check(shifted[k] >= 0.9, f"shifted {k} {shifted[k]} >= 0.9")
    return gen_launches, ae_launches, half_a, half_b


def profiled(fn, calls: int, warmup: bool = True):
    """fn() ``calls`` times under torch.profiler, synchronised (after one
    unprofiled call with ``warmup``). Returns (wall us, device-busy us, the
    device-side events: an aten op's entry would repeat its kernels' time)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    if warmup:
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    return wall_us, sum(e.self_device_time_total for e in events), events


def timed_once(fn):
    """(fn(), its ms on CUDA events): one call, for the slow plain versions,
    whose result is also the reference of a check."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def eval_kernel_rows(half_a, half_b, gen_launches, ae_launches):
    """Phase 4's rows for the evaluation kernels: a 128 x 128 matrix at
    N=2048 for the pairwise kernels (CD exact, EMD fast: the suite's
    defaults; CD also in the triangle mode of the suite's self-matrices),
    B=32 (the eval batch) for the diagonal ones. Each is held to its plain
    version at these shapes by phase 2c's rules."""
    import torch

    from dpfx_torch.ops import chamfer as cdk
    from dpfx_torch.ops import emd as emdk

    med = lambda e: float(e.median())
    s, n = half_a.shape[0], half_a.shape[1]
    xb, yb = half_a[:32], half_b[:32]
    b = xb.shape[0]
    rows = []

    dl, dr = cdk.nn_distances(xb, yb)
    (pdl, _, pdr, _), plain = timed_once(lambda: cdk.nn_distances_plain(xb, yb))
    err = max(float((dl - pdl).abs().max()), float((dr - pdr).abs().max()))
    pt = max(float(pair_err(dl, pdl, CD_FLOOR).max()), float(pair_err(dr, pdr, CD_FLOOR).max()))
    e_nnd = float(pair_err(dl.mean(-1) + dr.mean(-1), pdl.mean(-1) + pdr.mean(-1), CD_FLOOR).max())
    check(pt <= TOL_CD and e_nnd <= TOL_CD, f"nnd_fwd B={b}: per point {pt}, CD {e_nnd}")
    ms = cuda_ms(lambda: cdk.nn_distances(xb, yb), 20)
    (bd, by), _ = eval_bounds(b, n, n, b, b, b * 2 * n)
    rows.append(("nnd_fwd", "chamfer", "dpfx/ops/chamfer.py:130", ae_launches["nnd_fwd"], err, ms,
                 plain, bd, by))

    m = cdk.chamfer_pairwise(half_a, half_b)
    pm, plain = timed_once(lambda: cdk.chamfer_pairwise_plain(half_a, half_b))
    err = float((m - pm).abs().max())
    e_cd = float(pair_err(m, pm, CD_FLOOR).max())
    check(e_cd <= TOL_CD, f"cd_pairwise {s}x{s}: {e_cd}")
    sym = cdk.chamfer_pairwise(half_a, half_a, symmetric=True)
    e_sym = float(pair_err(sym, cdk.chamfer_pairwise_plain(half_a, half_a), CD_FLOOR).max())
    check(e_sym <= TOL_CD and torch.equal(sym, sym.t()), f"cd_pairwise symmetric {s}x{s}: {e_sym}")
    ms = cuda_ms(lambda: cdk.chamfer_pairwise(half_a, half_b), 5)
    (bd, by), _ = eval_bounds(s * s, n, n, s, s, s * s)
    rows.append(("cd_pairwise", "chamfer", "dpfx/ops/chamfer.py:255", gen_launches["cd_pairwise"],
                 err, ms, plain, bd, by))
    sym_ms = cuda_ms(lambda: cdk.chamfer_pairwise(half_a, half_a, symmetric=True), 5)
    fast_ms = cuda_ms(lambda: cdk.chamfer_pairwise(half_a, half_b, "fast"), 5)

    e = emdk.emd_nograd(xb, yb)
    pe, plain = timed_once(lambda: emdk.emd_plain(xb, yb))
    err = float((e - pe).abs().max())
    e_b = pair_err(e, pe, EMD_FLOOR)
    check(med(e_b) <= TOL_EMD_MEDIAN and float(e_b.max()) <= TOL_EMD_MAX,
          f"emd_batched B={b}: median {med(e_b)}, max {float(e_b.max())}")
    ms = cuda_ms(lambda: emdk.emd_nograd(xb, yb), 5)
    _, (bd, by) = eval_bounds(b, n, n, b, b, b)
    rows.append(("emd_batched", "emd", "dpfx/ops/emd.py:356", ae_launches["emd_batched"], err, ms,
                 plain, bd, by))

    e, ms = timed_once(lambda: emdk.emd_pairwise(half_a, half_b))
    pe, plain = timed_once(lambda: emdk.emd_pairwise_plain(half_a, half_b))
    err = float((e - pe).abs().max())
    e_p = pair_err(e, pe, EMD_FLOOR)
    check(med(e_p) <= TOL_EMD_MEDIAN and float(e_p.max()) <= TOL_EMD_MAX,
          f"emd_pairwise fast {s}x{s}: median {med(e_p)}, max {float(e_p.max())}")
    exact_ms = cuda_ms(lambda: emdk.emd_pairwise(half_a, half_b, precision="exact"), 1, warmup=0)
    _, (bd, by) = eval_bounds(s * s, n, n, s, s, s * s)
    rows.append(("emd_pairwise", "emd", "dpfx/ops/emd.py:435", gen_launches["emd_pairwise"], err,
                 ms, plain, bd, by))
    torch.cuda.synchronize()
    print(f"kernel-vs-plain at the paths' shapes, N={n}: nnd_fwd B={b} per-point rel max {pt:.2e}, "
          f"CD rel max {e_nnd:.2e}; cd_pairwise {s}x{s} exact rel max {e_cd:.2e}, symmetric "
          f"(triangle) rel max {e_sym:.2e}; emd_batched B={b} rel median {med(e_b):.2e} max "
          f"{float(e_b.max()):.2e}; emd_pairwise {s}x{s} fast rel median {med(e_p):.2e} max "
          f"{float(e_p.max()):.2e}")
    print(f"evaluation kernels at N={n}: nnd_fwd B={b} {rows[0][5]:.3f} ms; cd_pairwise {s}x{s} "
          f"exact {rows[1][5]:.3f} ms ({rows[1][5] / (s * s) * 1e3:.3f} us/pair), fast "
          f"{fast_ms:.3f} ms, symmetric {sym_ms:.3f} ms; emd_batched B={b} {rows[2][5]:.3f} ms; "
          f"emd_pairwise {s}x{s} fast {rows[3][5]:.3f} ms ({rows[3][5] / (s * s) * 1e3:.2f} "
          f"us/pair), exact {exact_ms:.3f} ms ({exact_ms / (s * s) * 1e3:.2f} us/pair)")
    return [{"name": nm, "route": "cuda", "source": f"dpfx_torch/ops/csrc/{src}.cu",
             "replaces": where, "launches": launched, "max_abs_err": err, "ms": ms,
             "plain_ms": plain, "bound_ms": bd, "bound_by": by, "library_ms": None}
            for nm, src, where, launched, err, ms, plain, bd, by in rows]


def grad_point_err(a, b):
    """Per point |a_i - b_i| / (|b_i| + mean_i |b_i|) of gradients [B, N, 3],
    the mean taken per pair; returns the largest."""
    na, nb = (a - b).double().norm(dim=-1), b.double().norm(dim=-1)
    return float((na / (nb + nb.mean(-1, keepdim=True))).max())


def emd_expanded_weight_control(x, y):
    """dcost/dx / n of each diagonal pair with the plan of approx_match_plain
    held constant and each pair weighed by 1/max(sqrt of the expanded
    squared distance, eps), as dpfx's Pallas body weighs it: what an EMD
    gradient kernel with that weighting would read."""
    import torch

    from dpfx_torch.ops import emd as emdk
    from dpfx_torch.ops.chamfer import sqdist_matrix

    out = []
    for i in range(x.shape[0]):
        a, b = x[i:i + 1], y[i:i + 1]
        match = emdk.approx_match_plain(a, b)
        dist = torch.sqrt(sqdist_matrix(a, b)).clamp_min(emdk.EPS)
        diff = a[..., :, None, :] - b[..., None, :, :]
        out.append((match[..., None] * diff / dist[..., None]).sum(-2) / a.shape[1])
    return torch.cat(out)


def pair_norm_err(a, b):
    """Per pair |a - b| / |b| (norms over a pair's points), [B], in f64."""
    d = (a.double() - b.double()).flatten(1).norm(dim=1)
    return d / b.double().flatten(1).norm(dim=1).clamp_min(1e-30)


def distance_grad_paths(cfg, dev, sampled):
    """Phase 3d: the differentiable distances at full width. The CD backward
    (nnd_bwd) and the EMD gradient mode held to their plain versions on the
    phase-3 sampled clouds against test-split clouds (B=64 x 2048, a ragged
    2000 x 2048 batch, tie cases), then the main path of this slice: 20
    steps of gradient descent on chamfer + emd through the public
    functions, counts zeroed just before and read just after. Returns the
    two kernel rows."""
    import torch

    from dpfx_torch.ops import chamfer as cdk
    from dpfx_torch.ops import emd as emdk

    med = lambda e: float(e.median())
    g = torch.Generator(device=dev).manual_seed(11)
    b, n = sampled.shape[0], sampled.shape[1]
    test = split_clouds(cfg, range(b), n, 3, dev)
    xs = sampled.float().contiguous()

    # CD backward: B=64 x 2048 and a ragged 2000 x 2048 batch
    cd_err = 0.0
    for x, y, tag in ((xs, test, f"B={b} N={n} M={n}"),
                      (xs[:8, :2000].contiguous(), test[:8], "B=8 N=2000 M=2048")):
        dl, dr = cdk.nnd_forward(x, y)
        gl = torch.randn(dl.shape, generator=g, device=dev)
        gr = torch.randn(dr.shape, generator=g, device=dev)
        gx, gy = cdk.nnd_backward(x, y, dl, dr, gl, gr)
        gx2, gy2 = cdk.nnd_backward(x, y, dl, dr, gl, gr)
        px, py = cdk.nn_distances_backward_plain(x, y, dl, dr, gl, gr)
        torch.cuda.synchronize()
        e = max(grad_point_err(gx, px), grad_point_err(gy, py))
        print(f"kernel-vs-plain nnd_bwd {tag}: per-point rel max {e:.2e}, max_abs "
              f"{max(float((gx - px).abs().max()), float((gy - py).abs().max())):.2e} "
              f"(|g|max {float(px.abs().max()):.2f})")
        check(torch.equal(gx, gx2) and torch.equal(gy, gy2), f"nnd_bwd bit-identical {tag}")
        check(e <= TOL_CD_GRAD, f"nnd_bwd {tag}: per point {e}")
        if x.shape[0] == b:
            cd_err = max(float((gx - px).abs().max()), float((gy - py).abs().max()))
            cd_args = (x, y, dl, dr, gl, gr)

    # ties: (a) y = x with every point duplicated: every distance to a point
    # and its copy is 0, so each mask holds two and the gradients vanish (a
    # mask that missed would leave 2 gl x); (b) only y duplicated and x a
    # perturbed copy: each x's neighbour is a pair of copies, which must
    # share its gradient evenly, as the plain version does (the copies get
    # equal cotangents, so their gradients must be equal)
    half = test[:8, : n // 2]
    dup = torch.cat([half, half], 1)
    xp = dup + 1e-3 * torch.randn(dup.shape, generator=g, device=dev)
    for x, y, tag in ((dup, dup, "y = x, duplicated"), (xp, dup, "y duplicated, x perturbed")):
        dl, dr = cdk.nnd_forward(x, y)
        gl = torch.randn(dl.shape, generator=g, device=dev)
        gr = torch.randn((8, n // 2), generator=g, device=dev).repeat(1, 2)
        gx, gy = cdk.nnd_backward(x, y, dl, dr, gl, gr)
        px, py = cdk.nn_distances_backward_plain(x, y, dl, dr, gl, gr)
        torch.cuda.synchronize()
        e = max(float((gx - px).abs().max()), float((gy - py).abs().max()))
        split = float((gy[:, : n // 2] - gy[:, n // 2:]).abs().max())
        print(f"nnd_bwd ties ({tag}, B=8 x {n}): max_abs against plain {e:.2e}, |gx|max "
              f"{float(gx.abs().max()):.2e}, copies' gy differ by {split:.2e}")
        check(e <= TOL_CD_GRAD * float(px.abs().max() + 1.0), f"nnd_bwd ties {tag}: {e}")
        if x is y:
            check(float(gx.abs().max()) <= 1e-5 and float(gy.abs().max()) <= 1e-5,
                  "every duplicated point found its masks")
        else:
            check(split <= TOL_CD_GRAD * float(gy.abs().max()), "the copies share the gradient")

    # EMD gradient mode at B=32 (the AE eval batch) and 64, and ragged
    emd_err = 0.0
    # the last case puts pairs of points within ~1e-4 of each other, where
    # the expanded distance cancels (the gradient weighs by the coordinates'
    # own difference, as emd_grads_plain does)
    near = test[:8] + 1e-4 * torch.randn(test[:8].shape, generator=g, device=dev)
    for x, y, tag in ((xs[:32], test[:32], f"B=32 N={n}"), (xs, test, f"B={b} N={n}"),
                      (xs[:8, :2000].contiguous(), test[:8], "B=8 N=2000 M=2048"),
                      (near, test[:8], "B=8 near-identical")):
        cost, gx, gy = emdk.emd_with_grads(x, y)
        cost2, gx2, gy2 = emdk.emd_with_grads(x, y)
        nograd = emdk.emd_nograd(x, y)
        _, px, py = emdk.emd_grads_plain(x, y)
        pc = emdk.emd_plain(x, y)
        torch.cuda.synchronize()
        ex, ey = pair_norm_err(gx, px), pair_norm_err(gy, py)
        e = torch.maximum(ex, ey)
        ce = pair_err(cost, pc, EMD_FLOOR)
        print(f"kernel-vs-plain emd_batched_grad {tag}: cost equal to emd_nograd "
              f"{torch.equal(cost, nograd)}; gradients per pair rel median {med(e):.2e} max "
              f"{float(e.max()):.2e}; cost against emd_plain rel median {med(ce):.2e} max "
              f"{float(ce.max()):.2e}")
        check(torch.equal(cost, nograd), f"the gradient mode's cost equals emd_nograd's {tag}")
        check(torch.equal(cost, cost2) and torch.equal(gx, gx2) and torch.equal(gy, gy2),
              f"emd_batched_grad bit-identical from run to run {tag}")
        check(med(e) <= TOL_EMD_GRAD_MEDIAN and float(e.max()) <= TOL_EMD_GRAD_MAX,
              f"emd_batched_grad {tag}: median {med(e)}, max {float(e.max())}")
        check(med(ce) <= TOL_EMD_MEDIAN and float(ce.max()) <= TOL_EMD_MAX,
              f"emd_batched_grad cost {tag}: median {med(ce)}, max {float(ce.max())}")
        if x.shape[0] == b:
            emd_err = max(float((gx - px).abs().max()), float((gy - py).abs().max()))
            emd_args = (x, y)
        if x.shape[0] == 8:
            # control: the Pallas body's weighting (sqrt of the expanded d)
            # on the same plan must fail the limits on the near-identical
            # pair (its reading on generic clouds is printed)
            c = pair_norm_err(emd_expanded_weight_control(x, y), px)
            print(f"  control, the Pallas weighting ({tag}): gx per pair median {med(c):.2e} "
                  f"max {float(c.max()):.2e}")
            if x is near:
                check(med(c) > TOL_EMD_GRAD_MEDIAN and float(c.max()) > TOL_EMD_GRAD_MAX,
                      "the EMD gradient limits tell the Pallas weighting apart")
        if x.shape[1] == 2000:
            # against an f64 run: the kernel drifts no further than the f32
            # plain version does
            _, qx, _ = emdk.emd_grads_plain(x.double(), y.double())
            k64, p64 = pair_norm_err(gx, qx), pair_norm_err(px, qx)
            print(f"  against f64 ({tag}): gx per pair kernel median {med(k64):.2e} max "
                  f"{float(k64.max()):.2e}, plain f32 median {med(p64):.2e} max "
                  f"{float(p64.max()):.2e}")
            check(float(k64.max()) <= TOL_EMD_GRAD_MAX
                  and med(k64) <= EMD_GRAD_F64_RATIO * med(p64) + EMD_GRAD_F64_FLOOR
                  and float(k64.max()) <= EMD_GRAD_F64_RATIO * float(p64.max()) + EMD_GRAD_F64_FLOOR,
                  f"emd_batched_grad against f64: median {med(k64)}, max {float(k64.max())}")

    # the main path of this slice: 20 descent steps on chamfer + emd
    target = test
    x = target + 0.05 * torch.randn(target.shape, generator=g, device=dev)
    lr = 0.01 * n               # per-point gradients are O(1/n)
    with torch.no_grad():
        cd0, emd0 = cdk.chamfer(x, target), emdk.emd(x, target)
    for m in (cdk, emdk):
        m.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(20):
        x = x.detach().requires_grad_(True)
        (cdk.chamfer(x, target) + emdk.emd(x, target)).sum().backward()
        x = x - lr * x.grad
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {**cdk.launches, **emdk.launches}
    with torch.no_grad():
        cd1, emd1 = cdk.chamfer(x, target), emdk.emd(x, target)
    print(f"descent on chamfer + emd, {b} pairs x {n} points, 20 steps in {wall:.3f} s: CD mean "
          f"{float(cd0.mean()):.4e} -> {float(cd1.mean()):.4e}, EMD mean {float(emd0.mean()):.4e} "
          f"-> {float(emd1.mean()):.4e}; launches {json.dumps(launched)}")
    for k in ("nnd_fwd", "nnd_bwd", "emd_batched_grad"):
        check(launched[k] > 0, f"kernel {k} was not launched on the descent path")
    check(launched["emd_batched"] == 0, "the descent took the gradient mode, not emd_nograd")
    check(bool(torch.isfinite(x).all()) and bool((cd1 < cd0).all()) and bool((emd1 < emd0).all()),
          "20 descent steps lower CD and EMD of every pair")

    # the rows, at the descent's shapes
    nb_ms = cuda_ms(lambda: cdk.nnd_backward(*cd_args), 20)
    _, nb_plain = timed_once(lambda: cdk.nn_distances_backward_plain(*cd_args))
    eg_ms = cuda_ms(lambda: emdk.emd_with_grads(*emd_args), 3)
    _, eg_plain = timed_once(lambda: emdk.emd_grads_plain(*emd_args))
    e32_ms = cuda_ms(lambda: emdk.emd_with_grads(emd_args[0][:32], emd_args[1][:32]), 3)
    eng_ms = cuda_ms(lambda: emdk.emd_nograd(emd_args[0][:32], emd_args[1][:32]), 3)
    nf_ms = cuda_ms(lambda: cdk.nnd_forward(*cd_args[:2]), 20)
    (b_cd, by_cd), (b_emd, by_emd) = grad_bounds(b, n, n)
    print(f"gradient kernels at B={b} N={n}: nnd_bwd {nb_ms:.3f} ms (nnd_fwd {nf_ms:.3f} ms, bound "
          f"{b_cd:.4f}), emd_batched_grad {eg_ms:.3f} ms (bound {b_emd:.3f}); at B=32 "
          f"emd_batched_grad {e32_ms:.3f} ms against emd_nograd {eng_ms:.3f} ms")
    return [{"name": "nnd_bwd", "route": "cuda", "source": "dpfx_torch/ops/csrc/chamfer.cu",
             "replaces": "dpfx/ops/chamfer.py:174", "launches": launched["nnd_bwd"],
             "max_abs_err": cd_err, "ms": nb_ms, "plain_ms": nb_plain, "bound_ms": b_cd,
             "bound_by": by_cd, "library_ms": None},
            {"name": "emd_batched_grad", "route": "cuda", "source": "dpfx_torch/ops/csrc/emd.cu",
             "replaces": "dpfx/ops/emd.py:356", "launches": launched["emd_batched_grad"],
             "max_abs_err": emd_err, "ms": eg_ms, "plain_ms": eg_plain, "bound_ms": b_emd,
             "bound_by": by_emd, "library_ms": None}]


def int8_sampler_path(sp, cfg, dev, card):
    """Phase 3e: the int8 mode of fused_sample_points on the flagship stack,
    bf16, at B=64 (the main path: counts zeroed just before, read just
    after) and B=256: bit-identical to the kernel on the dequantized stacks
    with the same seed, within phase 2's bf16 limits of the plain inverse
    of its noise, its RMS distance to the bf16 clouds, and int8 and bf16 timed
    in turns. Returns the kernel row."""
    import torch

    from dpfx_torch.ops import fused_sampler as fs

    act, bf, n = cfg.model.point_flow.activation, torch.bfloat16, 2048
    q = fs.quantize_flow_params(sp)
    dq = fs.dequantize(q)
    dsp = sp._replace(wx=dq.wx, wh=dq.wh, wout=dq.wout)
    g = torch.Generator(device=dev).manual_seed(12)
    row = None
    for b in (64, 256):
        z = torch.randn((b, cfg.model.dz), generator=g, device=dev)
        if b == 64:
            fs.reset_launch_counts()
        x, u = fs.fused_sample_points(sp, z, 21, n, dtype=bf, activation=act, quantized=q,
                                      return_noise=True)
        torch.cuda.synchronize()
        if b == 64:
            launched = dict(fs.launches)
            check(launched["fused_sample_int8"] > 0 and launched["fused_sample"] == 0,
                  f"the int8 path launched the int8 mode: {launched}")
        xd, ud = fs.fused_sample_points(dsp, z, 21, n, dtype=bf, activation=act, return_noise=True)
        xb = fs.fused_sample_points(sp, z, 21, n, dtype=bf, activation=act)
        xp = fs.fused_inverse_transposed_plain(dsp, u.transpose(1, 2).contiguous(),
                                               fs.z_projection(sp, z), bf, act).transpose(1, 2)
        torch.cuda.synchronize()
        emax, e999 = errors(x, xp)
        rms = float((x - xb).pow(2).mean().sqrt() / xb.pow(2).mean().sqrt())
        check(torch.equal(x, xd) and torch.equal(u, ud),
              f"int8 kernel equals the kernel on the dequantized stacks B={b}")
        check(emax <= TOL_BF16_MAX and e999 <= TOL_BF16_P999,
              f"int8 kernel vs plain B={b}: max {emax}, p99.9 {e999}")
        check(bool(torch.isfinite(x).all()) and rms <= TOL_INT8_RMS, f"int8 RMS B={b}: {rms}")
        turns = [cuda_ms(lambda: fs.fused_sample_points(sp, z, 22, n, dtype=bf, activation=act,
                                                        quantized=q if mode == "int8" else None), 20)
                 for mode in ("bf16", "int8", "int8", "bf16")]
        i8_ms, bf_ms = (turns[1] + turns[2]) / 2, (turns[0] + turns[3]) / 2
        print(f"int8 sampler B={b} x {n}: equal to the kernel on dequantized stacks; against the "
              f"plain inverse max_abs={emax:.3e} p99.9={e999:.3e}; coordinate RMS against bf16 "
              f"{rms:.3e}; int8 {i8_ms:.3f} ms, bf16 {bf_ms:.3f} ms (turns "
              f"{', '.join(f'{t:.3f}' for t in turns)}; {card})")
        if b == 64:
            plain_ms = cuda_ms(lambda: fs.fused_sample_points_plain(
                dsp, fs.z_projection(sp, z), 22, n, bf, act), 3, warmup=1)
            bd, by, _ = bound(sp, b, n, with_ut=False, weight_bytes=1)
            row = {"name": "fused_sample_int8", "route": "cuda",
                   "source": "dpfx_torch/ops/csrc/fused_sampler.cu",
                   "replaces": "dpfx/ops/fused_sampler.py:309", "launches": launched["fused_sample_int8"],
                   "max_abs_err": emax, "ms": i8_ms, "plain_ms": plain_ms, "bound_ms": bd,
                   "bound_by": by, "library_ms": None}
    return [row]


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2

    from dpfx_torch import generate
    from dpfx_torch.compat import randomize_
    from dpfx_torch.config import load_config
    from dpfx_torch.models import DPF
    from dpfx_torch.ops import _build
    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_latent as fl
    from dpfx_torch.ops import fused_sampler as fs
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.sampling import make_decoder, make_sampler

    dev = torch.device("cuda")
    torch.manual_seed(0)     # the modules' own init: every run sees the same weights
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")

    # ---- 1. build
    t0 = time.perf_counter()
    built = _build.build_all(force=True)
    print(f"build: {json.dumps({k: round(v, 2) for k, v in built.items()})} "
          f"total {time.perf_counter() - t0:.2f}s")
    for name in _build.sources():
        for line in _build.ptxas_log(name).splitlines():
            if "Used" in line or "spill" in line:
                print(f"ptxas {name}: {line.strip()}")

    # ---- 2. kernel vs plain at flagship widths
    cfg = load_config(str(CONFIG))
    pf = cfg.model.point_flow
    # 0.02: at 0.05 the random 32-layer inverse is unstable (|x| reaches
    # 1e7-1e10); at 0.02 the clouds stay O(1), as a trained
    # flow's do, and the out layers are still far from the identity
    model = randomize_(DPF(cfg), seed=0, scale=0.02).to(dev).eval()
    with torch.no_grad():
        sp = fs.stack_point_flow_params(model.point_flow)
    k, h, _ = sp.wx.shape
    check((k, h, cfg.model.dz) == (32, 128, 128), f"flagship widths, got K={k} H={h}")
    g = torch.Generator(device=dev).manual_seed(1)
    for n in (2048, 2000):
        ut = torch.randn((8, 3, n), generator=g, device=dev)
        z = torch.randn((8, cfg.model.dz), generator=g, device=dev)
        hz = fs.z_projection(sp, z)
        for dtype in (torch.float32, torch.bfloat16):
            xk = fs.fused_inverse_transposed(sp, ut, z, dtype=dtype, activation=pf.activation)
            xp = fs.fused_inverse_transposed_plain(sp, ut, hz, dtype, pf.activation)
            torch.cuda.synchronize()
            check(bool(torch.isfinite(xk).all()), f"fused_inverse finite N={n} {dtype}")
            emax, e999 = errors(xk, xp)
            print(f"kernel-vs-plain fused_inverse N={n} {dtype}: max_abs={emax:.3e} "
                  f"p99.9={e999:.3e} (|x|max={float(xp.abs().max()):.2f})")
            if dtype == torch.float32:
                check(emax <= TOL_F32, f"fused_inverse f32 N={n}: {emax} > {TOL_F32}")
            else:
                check(emax <= TOL_BF16_MAX and e999 <= TOL_BF16_P999,
                      f"fused_inverse bf16 N={n}: max {emax}, p99.9 {e999}")
        for tau in (1.0, 1.1):
            x, u = fs.fused_sample_points(sp, z, 1234, n, dtype=torch.bfloat16,
                                          activation=pf.activation, noise_scale=tau,
                                          return_noise=True)
            xp = fs.fused_inverse_transposed_plain(sp, u.transpose(1, 2).contiguous(), hz,
                                                   torch.bfloat16, pf.activation)
            emax, e999 = errors(x, xp.transpose(1, 2))
            mean, var = float(u.mean()), float(u.var())
            x2 = fs.fused_sample_points(sp, z, 1234, n, dtype=torch.bfloat16,
                                        activation=pf.activation, noise_scale=tau)
            x3 = fs.fused_sample_points(sp, z, 1235, n, dtype=torch.bfloat16,
                                        activation=pf.activation, noise_scale=tau)
            print(f"kernel-vs-plain fused_sample N={n} tau={tau}: max_abs={emax:.3e} "
                  f"p99.9={e999:.3e} noise mean={mean:.4f} var/tau^2={var / tau**2:.4f}")
            check(emax <= TOL_BF16_MAX and e999 <= TOL_BF16_P999,
                  f"fused_sample vs plain inverse of its noise: max {emax}, p99.9 {e999}")
            # 49k draws: the standard errors are 0.0045 (mean) and 0.0064 (var)
            check(abs(mean) < 0.025 and abs(var / tau**2 - 1) < 0.035, "noise moments")
            check(torch.equal(x, x2), "same seed gives the same clouds")
            check(not torch.equal(x, x3), "another seed gives other clouds")

    # ---- 2b. the training kernels vs their plain versions at flagship widths
    tw = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
    enc = model.encoder
    ews = [getattr(enc, f"point_{i}").weight.detach().clone() for i in range(enc.n_point)]
    ebs = [getattr(enc, f"point_{i}").bias.detach().clone() for i in range(enc.n_point)]
    ebs[-1][3] = -100.0          # a dead feature: its pooled max is 0
    widths = [3] + [int(w.shape[0]) for w in ews]
    check(widths == [3, 128, 128, 256, 512], f"flagship encoder widths, got {widths}")
    grad_names = ["dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"]
    enc_names = ["dx"] + [f"dW{i}" for i in range(4)] + [f"db{i}" for i in range(4)]
    flat = lambda r: [r[0]] + list(r[1]) + list(r[2])
    for n in (2048, 2000):
        xt = torch.randn((8, 3, n), generator=g, device=dev)
        hz = fs.z_projection(sp, torch.randn((8, cfg.model.dz), generator=g, device=dev))
        xc = torch.randn((8, n, 3), generator=g, device=dev)
        xc[0, n // 2:] = xc[0, : n - n // 2].clone()     # duplicated points: max-pool ties
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            tol = TOL_GRAD_F32 if f32 else TOL_GRAD_BF16
            u, ld = ft.fused_forward_kernel(*tw, xt, hz, dtype)
            u_p, ld_p = ft.fused_forward_plain(*tw, xt, hz, dtype)
            du = torch.randn(u.shape, generator=g, device=dev)
            dld = torch.randn(ld.shape, generator=g, device=dev)
            got = ft.fused_backward_kernel(*tw, u_p, hz, du, dld, dtype)
            again = ft.fused_backward_kernel(*tw, u_p, hz, du, dld, dtype)
            ref = ft.fused_backward_plain(*tw, u_p, hz, du, dld, dtype)
            torch.cuda.synchronize()
            emax, e999 = errors(u, u_p)
            gerr = {nm: rel(a, b) for nm, a, b in zip(grad_names, got, ref)}
            print(f"kernel-vs-plain fused_train N={n} {dtype}: u max_abs={emax:.3e} "
                  f"p99.9={e999:.3e} (|u|max={float(u_p.abs().max()):.2f}); log-det rel "
                  f"{rel(ld, ld_p):.3e}; grad rel " + " ".join(f"{k}={v:.2e}" for k, v in gerr.items()))
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"fused_train backward bit-identical from run to run N={n} {dtype}")
            if f32:
                check(emax <= TOL_F32, f"fused_train forward f32 N={n}: {emax}")
            else:
                check(emax <= TOL_BF16_MAX and e999 <= TOL_BF16_P999,
                      f"fused_train forward bf16 N={n}: max {emax}, p99.9 {e999}")
            check(rel(ld, ld_p) <= tol and max(gerr.values()) <= tol,
                  f"fused_train N={n} {dtype}: log-det {rel(ld, ld_p)}, grads {gerr}")
            if f32 and n == 2048:
                ctl = tf32_control(lambda: ft.fused_backward_plain(*tw, u_p, hz, du, dld, dtype),
                                   ref)
                print(f"f32 limit {TOL_GRAD_F32:.0e} against a TF32 control of the plain "
                      f"fused_train backward: {ctl:.2e}")
                check(ctl > TOL_GRAD_F32, f"the f32 limit fails a TF32 control ({ctl})")

            pk, ck = fe.pool_forward_kernel(ews, ebs, xc, dtype)
            pp, cp = fe.pool_forward_plain(ews, ebs, xc, dtype)
            dg = torch.randn(pk.shape, generator=g, device=dev)
            got = fe.pool_backward_kernel(ews, ebs, xc, pk, ck, dg, dtype)
            again = fe.pool_backward_kernel(ews, ebs, xc, pk, ck, dg, dtype)
            ref = fe.pool_backward_plain(ews, ebs, xc, pp, cp, dg, dtype)
            torch.cuda.synchronize()
            eerr = {nm: rel(a, b) for nm, a, b in zip(enc_names, flat(got), flat(ref))}
            print(f"kernel-vs-plain fused_encoder N={n} {dtype}: pooled rel {rel(pk, pp):.3e} "
                  f"(ties in cloud 0: {float((ck[0] > 1).float().mean()):.2f} of the features; "
                  f"dead feature pooled {float(pk[:, 3].abs().max())}); grad rel "
                  + " ".join(f"{k}={v:.2e}" for k, v in eerr.items()))
            check(all(torch.equal(a, c) for a, c in zip(flat(got), flat(again))),
                  f"fused_encoder backward bit-identical from run to run N={n} {dtype}")
            check(float(pk[:, 3].abs().max()) == 0.0 and float(got[2][3][3].abs()) == 0.0,
                  "the dead feature pools 0 and takes no gradient")
            check(rel(pk, pp) <= tol and max(eerr.values()) <= tol,
                  f"fused_encoder N={n} {dtype}: pooled {rel(pk, pp)}, grads {eerr}")
            if f32 and n == 2048:
                ctl = tf32_control(lambda: flat(fe.pool_backward_plain(
                    ews, ebs, xc, *fe.pool_forward_plain(ews, ebs, xc, dtype), dg, dtype)),
                    flat(ref))
                print(f"f32 limit {TOL_GRAD_F32:.0e} against a TF32 control of the plain "
                      f"fused_encoder forward and backward: {ctl:.2e}")
                check(ctl > TOL_GRAD_F32, f"the f32 limit fails a TF32 control ({ctl})")

    # ---- 2b'. the latent-flow kernels vs their plain versions at the flagship
    # latent widths; B=130 is a ragged last tile over nine blocks
    lfc = cfg.model.latent_flow
    with torch.no_grad():
        lw = fl.stack_latent_params(model.latent_flow)
    lmasks = fl.latent_masks(lfc.n_layers, cfg.model.dz, dev)
    cap = float(lfc.scale_cap)
    check((lfc.n_layers, lw["win"].shape[1], lw["wh"].shape[1]) == (14, 256, 1),
          f"flagship latent widths, got K={lfc.n_layers} H={lw['win'].shape[1]}")
    lat_names = ("dz",) + fl.KEYS
    lat_flat = lambda r: [r[0]] + [r[1][kk] for kk in fl.KEYS]
    for b in (8, 64, 130):
        z = torch.randn((b, cfg.model.dz), generator=g, device=dev)
        for dtype in (torch.float32, torch.bfloat16):
            f32 = dtype == torch.float32
            tol = TOL_GRAD_F32 if f32 else TOL_GRAD_BF16
            u, ld = fl.latent_forward_kernel(lw, lmasks, cap, z, dtype)
            u_p, ld_p = fl.latent_forward_plain(lw, lmasks, cap, z, dtype)
            zi = fl.latent_inverse_kernel(lw, lmasks, cap, z, dtype)
            zi_p = fl.latent_inverse_plain(lw, lmasks, cap, z, dtype)
            du = torch.randn(u.shape, generator=g, device=dev)
            dld = torch.randn(ld.shape, generator=g, device=dev)
            got = lat_flat(fl.latent_backward_kernel(lw, lmasks, cap, u_p, du, dld, dtype))
            again = lat_flat(fl.latent_backward_kernel(lw, lmasks, cap, u_p, du, dld, dtype))
            ref = lat_flat(fl.latent_backward_plain(lw, lmasks, cap, u_p, du, dld, dtype))
            torch.cuda.synchronize()
            emax, e999 = errors(zi, zi_p)
            gerr = {nm: rel(a, r) for nm, a, r in zip(lat_names, got, ref) if r.numel()}
            print(f"kernel-vs-plain fused_latent B={b} {dtype}: u rel {rel(u, u_p):.3e}, log-det "
                  f"rel {rel(ld, ld_p):.3e}; inverse max_abs={emax:.3e} p99.9={e999:.3e} "
                  f"(|z|max={float(zi_p.abs().max()):.2f}); grad rel "
                  + " ".join(f"{kk}={v:.2e}" for kk, v in gerr.items()))
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"fused_latent backward bit-identical from run to run B={b} {dtype}")
            check(rel(u, u_p) <= tol and rel(ld, ld_p) <= tol and max(gerr.values()) <= tol,
                  f"fused_latent B={b} {dtype}: u {rel(u, u_p)}, log-det {rel(ld, ld_p)}, "
                  f"grads {gerr}")
            if f32:
                check(emax <= TOL_F32, f"fused_latent inverse f32 B={b}: {emax}")
                back, _ = fl.latent_forward_kernel(lw, lmasks, cap, zi, dtype)
                trip = float((back - z).abs().max())
                print(f"fused_latent f32 round trip fwd(inv(eps)) B={b}: max_abs={trip:.3e}")
                check(trip <= TOL_F32, f"fused_latent round trip B={b}: {trip}")
            else:
                check(emax <= TOL_BF16_MAX and e999 <= TOL_BF16_P999,
                      f"fused_latent inverse bf16 B={b}: max {emax}, p99.9 {e999}")
            if f32 and b == 64:
                ctl = tf32_control(lambda: lat_flat(fl.latent_backward_plain(
                    lw, lmasks, cap, u_p, du, dld, dtype)), ref)
                print(f"f32 limit {TOL_GRAD_F32:.0e} against a TF32 control of the plain "
                      f"fused_latent backward: {ctl:.2e}")
                check(ctl > TOL_GRAD_F32, f"the f32 limit fails a TF32 control ({ctl})")

    # ---- 2c. the evaluation kernels vs their plain versions
    eval_kernel_checks(cfg, dev)

    # ---- 3. the main path at full width
    WORK.mkdir(parents=True, exist_ok=True)
    weights, samples = WORK / "flagship_random.pt", WORK / "samples.npy"
    torch.save({kk: v.cpu() for kk, v in model.state_dict().items()}, weights)
    blobs_g = torch.Generator().manual_seed(2)
    blobs = (torch.randn((16, 1, 3), generator=blobs_g)
             + 0.2 * torch.randn((16, 2048, 3), generator=blobs_g)).to(dev)

    fs.reset_launch_counts()
    rc = generate.main([str(CONFIG), "--weights", str(weights), "--n-clouds", "64",
                        "--out", str(samples), "--seed", "3"])
    sampler = make_sampler(model, 64, 2048, temperature=cfg.eval.temperature,
                           latent_temperature=cfg.eval.latent_temperature)
    sample_ms = cuda_ms(lambda: sampler(4), iters=20)
    clouds = sampler(5)
    decoded = make_decoder(model, 2048)(model.encode(blobs)[0], 6)
    recon = model.reconstruct(blobs, generator=torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    main_launches = dict(fs.launches)

    gen = np.load(samples)
    check(rc == 0 and gen.shape == (64, 2048, 3) and bool(np.isfinite(gen).all()),
          f"generate output {gen.shape}")
    for name, t, shape in (("sample", clouds, (64, 2048, 3)), ("decode", decoded, (16, 2048, 3)),
                           ("reconstruct", recon, (16, 2048, 3))):
        check(tuple(t.shape) == shape and bool(torch.isfinite(t).all()), f"{name} {tuple(t.shape)}")
    for kname in ("fused_inverse", "fused_sample"):
        check(main_launches[kname] > 0, f"kernel {kname} was not launched on the main path")
    print(f"main path: launches {json.dumps(main_launches)}; make_sampler(64, 2048) "
          f"{sample_ms:.3f} ms/batch, {64 / sample_ms * 1e3:,.1f} clouds/s, "
          f"{64 * 2048 / sample_ms * 1e3:,.0f} points/s; sample std {float(clouds.std()):.3f}")

    # the sampling path with the fused latent inverse (DPFX_SAMPLE_FUSED_LATENT=1)
    lat_samples = WORK / "samples_fused_latent.npy"
    os.environ["DPFX_SAMPLE_FUSED_LATENT"] = "1"
    try:
        fs.reset_launch_counts()
        fl.reset_launch_counts()
        rc = generate.main([str(CONFIG), "--weights", str(weights), "--n-clouds", "64",
                            "--out", str(lat_samples), "--seed", "3"])
        lat_sampler = make_sampler(model, 64, 2048, temperature=cfg.eval.temperature,
                                   latent_temperature=cfg.eval.latent_temperature)
        lat_clouds = lat_sampler(5)
        torch.cuda.synchronize()
        lat_launches = {**fs.launches, **fl.launches}
    finally:
        del os.environ["DPFX_SAMPLE_FUSED_LATENT"]
    gen = np.load(lat_samples)
    check(rc == 0 and gen.shape == (64, 2048, 3) and bool(np.isfinite(gen).all()),
          f"generate output with the fused latent inverse {gen.shape}")
    check(tuple(lat_clouds.shape) == (64, 2048, 3) and bool(torch.isfinite(lat_clouds).all()),
          "sample with the fused latent inverse")
    for kname in ("fused_latent_inv", "fused_sample"):
        check(lat_launches[kname] > 0, f"kernel {kname} was not launched on the fused-latent "
                                       "sampling path")
    # the two samplers in turns (module latent, fused, fused, module)
    turns = [cuda_ms(lambda: fn(4), iters=20)
             for fn in (sampler, lat_sampler, lat_sampler, sampler)]
    plain_lat_ms, fused_lat_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    eps = torch.randn((64, cfg.model.dz), generator=g, device=dev)
    with torch.no_grad():
        z_mod = model.latent_flow.inverse(eps)[0]
    z_ker = fl.fused_latent_inverse(lw, eps, lfc)
    print(f"sampling with the fused latent inverse: launches {json.dumps(lat_launches)}; "
          f"make_sampler(64, 2048) module latent {plain_lat_ms:.3f} ms/batch, fused latent "
          f"{fused_lat_ms:.3f} ms/batch (turns {', '.join(f'{t:.3f}' for t in turns)}; {card}); "
          f"z kernel vs module max_abs {float((z_ker - z_mod).abs().max()):.3e} (bf16 rounds "
          f"at other places), sample std {float(lat_clouds.std()):.3f}")

    # ---- 3b. the training path at full width (dpfx_torch.train's CLI)
    import copy
    import shutil

    from dpfx_torch.data import build_dataset, iterate_batches
    from dpfx_torch.train import __main__ as train_cli
    from dpfx_torch.train import trainer as trainer_mod

    ckpt_dir = WORK / "train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    init_weights: dict = {}
    flax_init = trainer_mod.init_params_

    def init_then_randomize(m, seed):
        # seeded random weights with every coupling off the identity, as in
        # phase 2: a check on identity couplings passes whatever the math
        randomize_(flax_init(m, seed), seed, 0.02)
        init_weights.update({kk: v.detach().clone() for kk, v in m.state_dict().items()})
        return m

    trainer_mod.init_params_ = init_then_randomize
    for mod in (ft, fe):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = train_cli.main([str(CONFIG), f"train.steps={TRAIN_STEPS}", "train.log_every=5",
                             f"train.ckpt_every={TRAIN_STEPS}", f"train.ckpt_dir={ckpt_dir}",
                             "data.synthetic_size=512"])
    finally:
        trainer_mod.init_params_ = flax_init
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = {**ft.launches, **fe.launches}
    run_dir = ckpt_dir / cfg.name
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    check(rc == 0 and [r["step"] for r in records] == list(range(5, TRAIN_STEPS + 1, 5)),
          f"train records {records}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in records),
          "every logged loss and grad norm is finite")
    check(all(r["nonfinite_skipped"] == 0 for r in records), "no step was skipped")
    for kname, count in train_launches.items():
        check(count > 0, f"kernel {kname} was not launched on the training path")
    trained_pt = run_dir / f"params_{TRAIN_STEPS:08d}.pt"
    trained = torch.load(trained_pt, map_location="cpu", weights_only=True)
    moved = sum(not torch.equal(trained[kk], v) for kk, v in init_weights.items())
    check(moved == len(init_weights), f"{moved} of {len(init_weights)} parameters moved")
    trained_samples = WORK / "trained_samples.npy"
    rc = generate.main([str(CONFIG), "--weights", str(trained_pt), "--n-clouds", "16",
                        "--out", str(trained_samples), "--seed", "4"])
    tclouds = np.load(trained_samples)
    check(rc == 0 and tclouds.shape == (16, 2048, 3) and bool(np.isfinite(tclouds).all()),
          f"clouds sampled from the trained checkpoint {tclouds.shape}")
    print(f"training path: {TRAIN_STEPS} steps of 64 x 2048 in {train_wall:.1f} s wall "
          f"(build, data and warm-up included); launches {json.dumps(train_launches)}; loss "
          + ", ".join(f"{r['loss']:.1f}" for r in records) + "; grad norm "
          + ", ".join(f"{r['grad_norm']:.1f}" for r in records) + "; points/s "
          + ", ".join(f"{r['points_per_sec']:,.0f}" for r in records)
          + f"; {moved} tensors moved; trained checkpoint sampled, std {float(tclouds.std()):.3f}")

    # the training CLI with the fused latent flow (train.fused_latent_flow=true)
    # for 10 steps on the 30-step run's schedule (lr_decay_steps=30: warmup
    # over 29 steps; with steps=10 alone it would reach the peak lr at step
    # 9), so its loss windows are held to that run's first two
    lat_dir = WORK / "train_fused_latent"
    shutil.rmtree(lat_dir, ignore_errors=True)
    init_weights.clear()
    trainer_mod.init_params_ = init_then_randomize
    for mod in (ft, fe, fl):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        rc = train_cli.main([str(CONFIG), "train.steps=10", "train.log_every=5",
                             f"train.lr_decay_steps={TRAIN_STEPS}", "train.ckpt_every=10",
                             f"train.ckpt_dir={lat_dir}", "data.synthetic_size=512",
                             "train.fused_latent_flow=true"])
    finally:
        trainer_mod.init_params_ = flax_init
    torch.cuda.synchronize()
    lat_wall = time.perf_counter() - t0
    lat_train_launches = {**ft.launches, **fe.launches, **fl.launches}
    lat_run = lat_dir / cfg.name
    lrecs = [json.loads(line) for line in (lat_run / "metrics.jsonl").read_text().splitlines()]
    check(rc == 0 and [r["step"] for r in lrecs] == [5, 10], f"fused-latent train records {lrecs}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in lrecs),
          "every logged loss and grad norm is finite (fused latent flow)")
    check(all(r["nonfinite_skipped"] == 0 for r in lrecs), "no step was skipped (fused latent flow)")
    for kname in ("fused_train_fwd", "fused_train_bwd", "fused_encoder_fwd", "fused_encoder_bwd",
                  "fused_latent_fwd", "fused_latent_bwd"):
        check(lat_train_launches[kname] > 0,
              f"kernel {kname} was not launched on the fused-latent training path")
    lat_trained = torch.load(lat_run / "params_00000010.pt", map_location="cpu", weights_only=True)
    lat_moved = sum(not torch.equal(lat_trained[kk], v) for kk, v in init_weights.items())
    check(lat_moved == len(init_weights),
          f"{lat_moved} of {len(init_weights)} parameters moved (fused latent flow)")
    drift = max(abs(a["loss"] - r["loss"]) / abs(r["loss"]) for a, r in zip(lrecs, records))
    print(f"training path with the fused latent flow: 10 steps of 64 x 2048 in {lat_wall:.1f} s "
          f"wall; launches {json.dumps(lat_train_launches)}; loss "
          + ", ".join(f"{r['loss']:.1f}" for r in lrecs) + "; grad norm "
          + ", ".join(f"{r['grad_norm']:.1f}" for r in lrecs) + f"; {lat_moved} tensors moved; "
          f"loss windows against the module-latent run's: rel {drift:.2e}")
    check(drift <= TOL_TRAIN_DRIFT, f"fused-latent training tracks the module path ({drift})")

    # the train step alone, batches already on the card
    dcfg = copy.deepcopy(cfg.data)
    dcfg.synthetic_size = 512
    batches = [{"x": torch.from_numpy(bt["x"]).to(dev)} for bt, _ in
               zip(iterate_batches(build_dataset(dcfg, "train"), 64, 2048, seed=5), range(4))]
    tmodel = randomize_(flax_init(DPF(cfg), 1), 1, 0.02).to(dev)
    ref_model = copy.deepcopy(tmodel)
    tx = trainer_mod.make_optimizer(cfg.train)
    tstate = trainer_mod.init_state(tmodel, tx)
    train_step = trainer_mod.make_train_step(tmodel, tx, cfg)
    for i in range(3):
        tstate, _ = train_step(tstate, batches[i % 4])
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for i in range(10):
        tstate, tm = train_step(tstate, batches[i % 4])
    end.record()
    torch.cuda.synchronize()
    step_ms = start.elapsed_time(end) / 10
    print(f"train step at 64 x 2048 (fused point flow + fused encoder, bf16): {step_ms:.3f} "
          f"ms/step, {64 * 2048 / step_ms * 1e3:,.0f} points/s ({card})")

    # the same step with the fused latent flow: off and on in turns (off,
    # on, on, off), 10 steps each after 3 warm-up steps of each
    lcfg = copy.deepcopy(cfg)
    lcfg.train.fused_latent_flow = True
    lmodel = copy.deepcopy(ref_model)
    ltx = trainer_mod.make_optimizer(lcfg.train)
    lstate = trainer_mod.init_state(lmodel, ltx)
    lat_step = trainer_mod.make_train_step(lmodel, ltx, lcfg)
    for i in range(3):
        lstate, _ = lat_step(lstate, batches[i % 4])
    runs = {"off": [train_step, tstate], "on": [lat_step, lstate]}

    def timed_steps(key):
        fn, st = runs[key]
        start.record()
        for i in range(10):
            st, _ = fn(st, batches[i % 4])
        end.record()
        torch.cuda.synchronize()
        runs[key][1] = st
        return start.elapsed_time(end) / 10

    ab = [(key, timed_steps(key)) for key in ("off", "on", "on", "off")]
    tstate, lstate = runs["off"][1], runs["on"][1]
    off_ms = sum(t for key, t in ab if key == "off") / 2
    on_ms = sum(t for key, t in ab if key == "on") / 2
    print(f"train step at 64 x 2048, fused latent flow off {off_ms:.3f} ms/step, on {on_ms:.3f} "
          f"ms/step (turns {', '.join(f'{key} {t:.3f}' for key, t in ab)}; {card})")

    # one fused step (latent flow fused or not) against the module path:
    # same weights, batch and noise
    mcfg = copy.deepcopy(cfg)
    mcfg.train.fused_point_flow = mcfg.train.fused_encoder = False
    gb = torch.Generator(device=dev).manual_seed(6)
    batch = {"x": batches[0]["x"], "eps": torch.randn((64, cfg.model.dz), generator=gb, device=dev),
             "xnoise": torch.randn((64, 2048, 3), generator=gb, device=dev)}
    out = {}
    for name, c in (("fused", cfg), ("fused latent", lcfg), ("module", mcfg)):
        m = copy.deepcopy(ref_model)          # a step updates its model's parameters in place
        txm = trainer_mod.make_optimizer(c.train)
        _, mm = trainer_mod.make_train_step(m, txm, c)(trainer_mod.init_state(m, txm), batch)
        out[name] = (float(mm["loss"]), float(mm["grad_norm"]))
    lm, gm = out["module"]
    for name in ("fused", "fused latent"):
        lf, gf = out[name]
        print(f"{name} step vs module path: loss {lf:.4f} vs {lm:.4f} (rel "
              f"{abs(lf - lm) / abs(lm):.2e}), grad norm {gf:.4f} vs {gm:.4f} (rel "
              f"{abs(gf - gm) / abs(gm):.2e})")
        check(abs(lf - lm) <= TOL_STEP_LOSS * abs(lm) and abs(gf - gm) <= TOL_STEP_GNORM * abs(gm),
              f"{name} step agrees with the module path")
    del ref_model, lmodel

    # ---- 3c. the evaluation paths at full width, on phase 3b's checkpoint
    gen_launches, ae_launches, half_a, half_b = eval_paths(cfg, dev, ckpt_dir, trained_pt)

    # ---- 3d. the differentiable distances at full width (B=64 x 2048)
    grad_rows = distance_grad_paths(cfg, dev, clouds)

    # ---- 3e. the int8 sampler (flagship stack, bf16, B=64 and 256)
    int8_rows = int8_sampler_path(sp, cfg, dev, card)

    # ---- 4. per-kernel numbers at the main path's shapes (B=64, N=2048, bf16)
    b, n = 64, 2048
    z = torch.randn((b, cfg.model.dz), generator=g, device=dev)
    ut = torch.randn((b, 3, n), generator=g, device=dev)
    hz = fs.z_projection(sp, z)
    act, bf = pf.activation, torch.bfloat16
    xk = fs.fused_inverse_transposed(sp, ut, z, dtype=bf, activation=act)
    xp = fs.fused_inverse_transposed_plain(sp, ut, hz, bf, act)
    inv_err = errors(xk, xp)[0]
    xs, us = fs.fused_sample_points(sp, z, 8, n, dtype=bf, activation=act, return_noise=True)
    smp_err = errors(xs, fs.fused_inverse_transposed_plain(
        sp, us.transpose(1, 2).contiguous(), hz, bf, act).transpose(1, 2))[0]
    inv_ms = cuda_ms(lambda: fs.fused_inverse_transposed(sp, ut, z, dtype=bf, activation=act), 20)
    smp_ms = cuda_ms(lambda: fs.fused_sample_points(sp, z, 9, n, dtype=bf, activation=act), 20)
    plain_inv_ms = cuda_ms(lambda: fs.fused_inverse_transposed_plain(
        sp, ut, fs.z_projection(sp, z), bf, act), 3, warmup=1)
    plain_smp_ms = cuda_ms(lambda: fs.fused_sample_points_plain(
        sp, fs.z_projection(sp, z), 9, n, bf, act), 3, warmup=1)
    b_inv, by_inv, flops = bound(sp, b, n, with_ut=True)
    b_smp, by_smp, _ = bound(sp, b, n, with_ut=False)
    src = "dpfx_torch/ops/csrc/fused_sampler.cu"
    kernels = [
        {"name": "fused_inverse", "route": "cuda", "source": src,
         "replaces": "dpfx/ops/fused_sampler.py:112", "launches": main_launches["fused_inverse"],
         "max_abs_err": inv_err, "ms": inv_ms, "plain_ms": plain_inv_ms, "bound_ms": b_inv,
         "bound_by": by_inv, "library_ms": None},
        {"name": "fused_sample", "route": "cuda", "source": src,
         "replaces": "dpfx/ops/fused_sampler.py:309", "launches": main_launches["fused_sample"],
         "max_abs_err": smp_err, "ms": smp_ms, "plain_ms": plain_smp_ms, "bound_ms": b_smp,
         "bound_by": by_smp, "library_ms": None},
    ]
    check(inv_err <= TOL_BF16_MAX and smp_err <= TOL_BF16_MAX, "B=64 kernel errors")

    # the training kernels held against their plain versions at the main
    # path's batch, as phase 2b holds them at B=8: here each block of either
    # backward adds ~16 tiles into its gradient partials (1-2 at B=8)
    xt = torch.randn((b, 3, n), generator=g, device=dev)
    u_k, ld_k = ft.fused_forward_kernel(*tw, xt, hz, bf)
    u_p, ld_p = ft.fused_forward_plain(*tw, xt, hz, bf)
    du = torch.randn(u_p.shape, generator=g, device=dev)
    dld = torch.randn((b,), generator=g, device=dev)
    maxerr = lambda xs, ys: max(float((p_ - q_).abs().max()) for p_, q_ in zip(xs, ys) if q_.numel())
    got = ft.fused_backward_kernel(*tw, u_p, hz, du, dld, bf)
    again = ft.fused_backward_kernel(*tw, u_p, hz, du, dld, bf)
    ref = ft.fused_backward_plain(*tw, u_p, hz, du, dld, bf)
    torch.cuda.synchronize()
    tf_err, tf_999 = errors(u_k, u_p)
    tb_err = maxerr(got, ref)
    gerr = {nm: rel(a, r) for nm, a, r in zip(grad_names, got, ref)}
    print(f"kernel-vs-plain fused_train B={b} N={n} bf16: u max_abs={tf_err:.3e} "
          f"p99.9={tf_999:.3e}; log-det rel {rel(ld_k, ld_p):.3e}; grad rel "
          + " ".join(f"{k}={v:.2e}" for k, v in gerr.items()))
    check(tf_err <= TOL_BF16_MAX and tf_999 <= TOL_BF16_P999,
          f"fused_train forward B={b}: max {tf_err}, p99.9 {tf_999}")
    check(rel(ld_k, ld_p) <= TOL_GRAD_BF16 and max(gerr.values()) <= TOL_GRAD_BF16,
          f"fused_train B={b}: log-det {rel(ld_k, ld_p)}, grads {gerr}")
    check(all(torch.equal(a, c) for a, c in zip(got, again)),
          f"fused_train backward bit-identical from run to run at B={b}")
    del got, again, ref
    tf_ms = cuda_ms(lambda: ft.fused_forward_kernel(*tw, xt, hz, bf), 20)
    tb_ms = cuda_ms(lambda: ft.fused_backward_kernel(*tw, u_p, hz, du, dld, bf), 10)
    tf_plain = cuda_ms(lambda: ft.fused_forward_plain(*tw, xt, hz, bf), 3, warmup=1)
    tb_plain = cuda_ms(lambda: ft.fused_backward_plain(*tw, u_p, hz, du, dld, bf), 2, warmup=1)
    ews = [getattr(enc, f"point_{i}").weight.detach() for i in range(enc.n_point)]
    ebs = [getattr(enc, f"point_{i}").bias.detach() for i in range(enc.n_point)]
    xc = batches[0]["x"]
    pk, ck = fe.pool_forward_kernel(ews, ebs, xc, bf)
    pp, cp = fe.pool_forward_plain(ews, ebs, xc, bf)
    dg = torch.randn(pk.shape, generator=g, device=dev)
    ef_err = float((pk - pp).abs().max())
    got = flat(fe.pool_backward_kernel(ews, ebs, xc, pk, ck, dg, bf))
    again = flat(fe.pool_backward_kernel(ews, ebs, xc, pk, ck, dg, bf))
    ref = flat(fe.pool_backward_plain(ews, ebs, xc, pp, cp, dg, bf))
    torch.cuda.synchronize()
    eb_err = maxerr(got, ref)
    eerr = {nm: rel(a, r) for nm, a, r in zip(enc_names, got, ref)}
    print(f"kernel-vs-plain fused_encoder B={b} N={n} bf16: pooled rel {rel(pk, pp):.3e}; "
          f"grad rel " + " ".join(f"{k}={v:.2e}" for k, v in eerr.items()))
    check(rel(pk, pp) <= TOL_GRAD_BF16 and max(eerr.values()) <= TOL_GRAD_BF16,
          f"fused_encoder B={b}: pooled {rel(pk, pp)}, grads {eerr}")
    check(all(torch.equal(a, c) for a, c in zip(got, again)),
          f"fused_encoder backward bit-identical from run to run at B={b}")
    del got, again, ref
    ef_ms = cuda_ms(lambda: fe.pool_forward_kernel(ews, ebs, xc, bf), 20)
    eb_ms = cuda_ms(lambda: fe.pool_backward_kernel(ews, ebs, xc, pk, ck, dg, bf), 10)
    ef_plain = cuda_ms(lambda: fe.pool_forward_plain(ews, ebs, xc, bf), 3, warmup=1)
    eb_plain = cuda_ms(lambda: fe.pool_backward_plain(ews, ebs, xc, pp, cp, dg, bf), 3, warmup=1)
    (b_tf, by_tf), (b_tb, by_tb) = train_bounds(sp, b, n)
    (b_ef, by_ef), (b_eb, by_eb) = encoder_bounds(widths, b, n)
    tsrc, esrc = "dpfx_torch/ops/csrc/fused_train.cu", "dpfx_torch/ops/csrc/fused_encoder.cu"
    for name, src, where, launched, err, ms, plain, bnd, by in (
            ("fused_train_fwd", tsrc, "dpfx/ops/fused_train.py:131", train_launches["fused_train_fwd"],
             tf_err, tf_ms, tf_plain, b_tf, by_tf),
            ("fused_train_bwd", tsrc, "dpfx/ops/fused_train.py:231", train_launches["fused_train_bwd"],
             tb_err, tb_ms, tb_plain, b_tb, by_tb),
            ("fused_encoder_fwd", esrc, "dpfx/ops/fused_encoder.py:75",
             train_launches["fused_encoder_fwd"], ef_err, ef_ms, ef_plain, b_ef, by_ef),
            ("fused_encoder_bwd", esrc, "dpfx/ops/fused_encoder.py:98",
             train_launches["fused_encoder_bwd"], eb_err, eb_ms, eb_plain, b_eb, by_eb)):
        kernels.append({"name": name, "route": "cuda", "source": src, "replaces": where,
                        "launches": launched, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bnd, "bound_by": by, "library_ms": None})
    print(f"training kernels at B={b} N={n} bf16: fused_train fwd {tf_ms:.3f} ms "
          f"(bound {b_tf:.4f}), bwd {tb_ms:.3f} ms (bound {b_tb:.4f}); fused_encoder fwd "
          f"{ef_ms:.3f} ms (bound {b_ef:.4f}), bwd {eb_ms:.3f} ms (bound {b_eb:.4f}) ({card})")
    print(f"kernel rates at B={b} N={n}: fused_inverse {flops / inv_ms / 1e9:.1f} TFLOP/s, "
          f"fused_sample {flops / smp_ms / 1e9:.1f} TFLOP/s ({card})")

    # the latent-flow kernels at the main paths' batch (B=64, bf16)
    z = torch.randn((b, cfg.model.dz), generator=g, device=dev)
    u_k, ld_k = fl.latent_forward_kernel(lw, lmasks, cap, z, bf)
    u_p, ld_p = fl.latent_forward_plain(lw, lmasks, cap, z, bf)
    zi_k = fl.latent_inverse_kernel(lw, lmasks, cap, z, bf)
    zi_p = fl.latent_inverse_plain(lw, lmasks, cap, z, bf)
    du = torch.randn(u_p.shape, generator=g, device=dev)
    dld = torch.randn((b,), generator=g, device=dev)
    got = lat_flat(fl.latent_backward_kernel(lw, lmasks, cap, u_p, du, dld, bf))
    ref = lat_flat(fl.latent_backward_plain(lw, lmasks, cap, u_p, du, dld, bf))
    torch.cuda.synchronize()
    lf_err, li_err, lb_err = maxerr((u_k, ld_k), (u_p, ld_p)), maxerr((zi_k,), (zi_p,)), maxerr(got, ref)
    del got, ref
    lf_ms = cuda_ms(lambda: fl.latent_forward_kernel(lw, lmasks, cap, z, bf), 50)
    li_ms = cuda_ms(lambda: fl.latent_inverse_kernel(lw, lmasks, cap, z, bf), 50)
    lb_ms = cuda_ms(lambda: fl.latent_backward_kernel(lw, lmasks, cap, u_p, du, dld, bf), 20)
    lf_plain = cuda_ms(lambda: fl.latent_forward_plain(lw, lmasks, cap, z, bf), 5, warmup=1)
    li_plain = cuda_ms(lambda: fl.latent_inverse_plain(lw, lmasks, cap, z, bf), 5, warmup=1)
    lb_plain = cuda_ms(lambda: fl.latent_backward_plain(lw, lmasks, cap, u_p, du, dld, bf), 5,
                       warmup=1)
    (b_lf, by_lf), (b_lb, by_lb) = latent_bounds(lw, b)
    lsrc = "dpfx_torch/ops/csrc/fused_latent.cu"
    for name, where, launched, err, ms, plain, bnd, by in (
            ("fused_latent_fwd", "dpfx/ops/fused_latent.py:151",
             lat_train_launches["fused_latent_fwd"], lf_err, lf_ms, lf_plain, b_lf, by_lf),
            ("fused_latent_bwd", "dpfx/ops/fused_latent.py:185",
             lat_train_launches["fused_latent_bwd"], lb_err, lb_ms, lb_plain, b_lb, by_lb),
            ("fused_latent_inv", "dpfx/ops/fused_latent.py:170", lat_launches["fused_latent_inv"],
             li_err, li_ms, li_plain, b_lf, by_lf)):
        kernels.append({"name": name, "route": "cuda", "source": lsrc, "replaces": where,
                        "launches": launched, "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bnd, "bound_by": by, "library_ms": None})
    print(f"latent-flow kernels at B={b} bf16: forward {lf_ms:.4f} ms (plain {lf_plain:.3f}, bound "
          f"{b_lf:.5f}), backward {lb_ms:.4f} ms (plain {lb_plain:.3f}, bound {b_lb:.5f}), inverse "
          f"{li_ms:.4f} ms (plain {li_plain:.3f}); max_abs err fwd {lf_err:.2e}, bwd {lb_err:.2e}, "
          f"inv {li_err:.2e} ({card})")
    kernels += eval_kernel_rows(half_a, half_b, gen_launches, ae_launches)
    kernels += grad_rows + int8_rows
    check(len(kernels) == 16, f"{len(kernels)} kernel rows")
    print(json.dumps({"kernels": kernels}))

    # ---- 5. where the sampler's time goes (torch.profiler, 5 calls each)
    seeds = iter(range(10, 1000))
    for name, fn, kname in (("make_sampler(64, 2048)", sampler, "fused_inverse_kernel"),
                            ("make_sampler(64, 2048), fused latent", lat_sampler, "flow_kernel")):
        wall_us, busy_us, dev_events = profiled(lambda: fn(next(seeds)), 5)
        check(any(kname in e.key for e in dev_events),
              f"the profiler saw {kname} on the device ({name})")
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
        unprofiled = fused_lat_ms if fn is lat_sampler else sample_ms
        print(f"profile {name} x5: wall {wall_us / 5e3:.3f} ms/batch, device busy "
              f"{busy_us / 5e3:.3f} ms/batch, idle share {1 - busy_us / wall_us:.3f} under the "
              f"profiler, {1 - busy_us / 5e3 / unprofiled:.3f} against phase 3's unprofiled "
              f"{unprofiled:.3f} ms/batch; {sum(e.count for e in dev_events) // 5} kernels/batch; "
              "top: " + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 5e3:.3f} ms "
                                  f"x{e.count // 5}" for e in top))

    # ---- 5b. where the train step's time goes (torch.profiler, 5 steps each)
    for key, name, unprofiled in (("off", "train step", off_ms),
                                  ("on", "train step, fused latent flow", on_ms)):
        def one_step():
            fn, st = runs[key]
            runs[key][1], _ = fn(st, batches[next(seeds) % 4])

        wall_us, busy_us, dev_events = profiled(one_step, 5)
        check(sum("bwd_kernel" in e.key for e in dev_events) >= (3 if key == "on" else 2)
              and sum("fwd_kernel" in e.key for e in dev_events) >= 2
              and (key == "off" or any("flow_kernel" in e.key for e in dev_events)),
              f"the profiler saw the training kernels on the device ({name})")
        top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:8]
        print(f"profile {name} x5: wall {wall_us / 5e3:.3f} ms/step, device busy "
              f"{busy_us / 5e3:.3f} ms/step, idle share {1 - busy_us / wall_us:.3f} under the "
              f"profiler, {1 - busy_us / 5e3 / unprofiled:.3f} against the unprofiled "
              f"{unprofiled:.3f} ms/step; {sum(e.count for e in dev_events) // 5} kernels/step; "
              "top: " + "; ".join(f"{e.key[:70]} {e.self_device_time_total / 5e3:.3f} ms "
                                  f"x{e.count // 5}" for e in top))

    # ---- 5c. where the generation suite's time goes (one call at S=128)
    from dpfx_torch.metrics import compute_all_metrics

    wall_us, busy_us, dev_events = profiled(
        lambda: compute_all_metrics(half_a, half_b, ("cd", "emd")), 1, warmup=False)
    check(any("emd_kernel" in e.key for e in dev_events)
          and any("chamfer_kernel" in e.key for e in dev_events),
          "the profiler saw the evaluation kernels on the device")
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profile generation suite {half_a.shape[0]} + {half_b.shape[0]} clouds x 2048 (CD "
          f"exact, EMD fast, JSD): wall {wall_us / 1e6:.3f} s, device busy {busy_us / 1e6:.3f} s, "
          f"idle share {1 - busy_us / wall_us:.3f}; top: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                      for e in top))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
