#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build the kernels, hold each one
against its plain PyTorch version at the flagship widths, drive the main
paths (flagship sampling, flagship training, evaluation: the generation
suite and AE reconstruction, the differentiable distances, the int8
sampler and the two probe tools) through the normal entry points, and
report.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints its result on its own line; any failure raises and the
script exits non-zero without a result line):
  1. the card's name and power limit; build every kernel with nvcc (sm_90a),
     all sources at once, and print ptxas' register and spill lines and
     the instruction mix of the EMD and Chamfer kernels' element loops and
     of the Chamfer backward's sweep, with its instructions an element
     (their SASS, read by dpfx_torch.tools.sass_loops);
  2. kernel vs plain version at K=32, H=128, dz=128, B=8, N=2048 and a
     ragged N=2000: f32 and bf16 for fused_inverse, bf16 for fused_sample
     against the plain inverse of the noise it drew, its noise against
     philox_noise_plain (the plain Philox stream), noise moments at
     tau=1 and 1.1, and same-seed determinism; the round trip of the bf16
     training forward and the sampler's bf16 inverse (the same row code:
     median within 1e-5); then the training kernels in
     f32 and bf16: fused_train forward (u, log-det) and backward (dx, dhz,
     every weight gradient), fused_encoder forward and backward (encoder
     128/128/256/512, a cloud of duplicated points and a dead feature), each
     backward run twice and required bit-identical; the plain f32 backwards
     run once more with TF32 products allowed, a control that the f32 limit
     must fail; the encoder on clouds of one repeated point (every row
     critical: the backward walks all of them) at N=2000 and 77, the share
     of critical rows at B=64 and the registers and spills of the encoder's
     bf16 kernels (forward, select, walk); then the latent-flow kernels (fused_latent.cu) at the
     flagship latent widths (K=14, dz=128, H=256) and B=8, 64 and 130 (f32
     block-wide, a ragged last tile over nine blocks; bf16 on clusters of
     16 CTAs over groups of 16 samples, at 130 nine groups, the last ragged,
     walked by eight clusters into eight gradient slices): forward
     (u, log-det), inverse and backward (dz, every weight and bias
     gradient) in f32 and bf16, the backward twice and required
     bit-identical, a TF32 control of the plain f32 backward, the f32 round
     trip fwd(inv(eps)) = eps and the bf16 one (median and max, as the
     point flow's);
  2c. the evaluation kernels (chamfer.cu, emd.cu) vs their plain versions on
     synthetic test-split clouds at N=2048 and at a ragged N=2000 against
     M=2048, with one pair of identical clouds: nnd_fwd (B=8; dl and dr
     equal to the plain version's bit for bit, CD within 1e-5, on a cluster
     of CTAs equal to one CTA bit for bit), cd_pairwise exact, fast
     (both equal bit for bit to onepass_plain, the plain version of the
     kernel's order) and symmetric (16 x 16), emd_batched exact (B=8, also
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
     just before each and read just after, with the CTAs per pair of the
     EMD launches (1 for the suite's matrices, a cluster for the AE
     batches); then compute_all_metrics on two
     disjoint stratified halves of the test split (the ideal-generator row)
     and on one half shifted by 0.5;
  3d. the differentiable distances at full width, on phase 3's 64 sampled
     clouds against 64 test-split clouds (N=M=2048), a ragged 2000 x
     2048 batch and hubs (a collapsed 0.01 N(0, 1) cloud against the test
     clouds: inverse lists past 32): nnd_bwd against nn_distances_backward_plain on the same
     minima (per point, twice for bit-identity) and against the three-pass
     kernel bit for bit, with the pairs by path (lists, fix-up, three
     passes) and the CTAs per pair; two tie cases (y = x with every point
     duplicated; y duplicated and x perturbed, where the copies must share
     the gradient), which must take the three passes; on the descent's
     first inputs nnd_bwd against the three-pass kernel and
     onepass_bwd_plain bit for bit; the EMD gradient mode at B=32, 64 and the
     ragged batch (its cost equal to emd_nograd's bit for bit, gx and gy
     per pair against emd_grads_plain by median and maximum, twice for
     bit-identity, the ragged batch also against an f64 run); then 20
     steps of gradient descent on chamfer + emd from a perturbed copy of
     the test clouds towards them (launch counts zeroed just before and
     read just after, the EMD launches on clusters, nnd_bwd's pairs by
     path), which must lower both for every pair; then nnd_bwd and the
     three-pass kernel timed in turns on the sampled, the descent's and
     the hubs' inputs;
  3e. the int8 sampler: fused_sample_points(quantized=quantize_flow_params)
     on the flagship stack, bf16, at B=64 (launch counts zeroed and read
     around it) and B=256, N=2048: bit-identical to the kernel on the
     dequantized stacks with the same seed, within phase 2's bf16 limits
     of the plain inverse of its noise, its coordinate RMS against the bf16
     clouds, and int8 and bf16 timed in turns;
  3f. the probe tools at full width (K=32, H=128, n_hidden=2, B=64,
     N=2048, bf16; the dual-issue probe at L=32, G=16, T=2048), with ptxas'
     registers and spills of every bf16 probe instance and dual-issue mode:
     the probe backward (full, nowg, walk, rolled: the training backward's
     body on 8 rows) and the interleaved one (2 and 4 groups) against
     probe_bwd_plain at N=2048 and with the log-det mask at 2000, by phase
     2b's bf16 limits, twice each for bit-identity; every variant in f32 at
     K=32 on ten input sets
     against an f64 run of the plain version, within a multiple of the f32
     plain version's own drift from that run or a floor, which a TF32 run
     must fail on every set; full and
     2 stripes in f32 at B=8 on the flow's first 3 layers against the f32
     limit, which a TF32 run of the plain version must fail; full on
     zero-padded production inputs against fused_backward_kernel (f32 at
     K=3, B=8, by the f32 limit; bf16 at K=32, B=64, bit for bit); the
     dual-issue modes A, B, C against their plain version; the times beside
     the first design's (FIRST_PROBE_MS), full / lib (at most
     TOL_FULL_LIB) and the split (full - nowg, nowg - walk, walk as shares
     of full; walk < nowg < full required); then `python -m
     dpfx_torch.tools.bench_fused_bwd lib full nowg walk rolled ilv2 ilv4
     ilv2r ilv4r` (DPFX_PROBE_REPS=3, DPFX_PROBE_TILES=128) and `python -m
     dpfx_torch.tools.probe_dual_issue` as child processes, which must exit
     0 with their lines (the bench's split line among them); each counts
     its launches from 0 and prints them last;
  4. at the main paths' shapes (B=64, N=2048, bf16): the training kernels
     held against their plain versions again (u, log-det, every gradient;
     each backward bit-identical across two runs), the redesigned
     fused_train kernels' times beside their first versions' (FIRST_TRAIN_MS;
     the backward's median of three also beside SHARED_BODY_BWD_MS, and
     within TOL_SHARED_BWD of it),
     with their bounds and ptxas' registers and spills, the redesigned
     fused_encoder kernels' times beside their first design's
     (FIRST_ENCODER_MS), the backward's select, walk and reduce apart (the
     profiler), the training batch's critical rows and the FLOP the kernels
     issue beside the bounds' dense work, and the train
     step's ms/step with the fused latent flow off and on, the latent-flow kernels
     at B=64 (every cluster plan of LATENT_PLANS held to the plain versions
     and timed, the default plan's times beside their first design's,
     FIRST_LATENT_MS, with us per layer and ptxas' registers and spills),
     the redesigned sampler and Chamfer kernels' times beside their
     first designs' (FIRST_SAMPLER_MS, FIRST_CD_MS), then one JSON line with
     every kernel's error, time, plain time and bound, the evaluation
     kernels' at their paths' shapes (a 128 x 128 matrix at N=2048 for the
     pairwise kernels, CD also in triangle mode, B=32 for the diagonal ones),
     each held to its plain version there by phase 2c's limits (nnd_fwd's
     minima bit for bit); the EMD
     kernel also held to emd_sweeps_plain, the plain version of its own
     sweep order, on phase 2c's pairs in every mode, with the CTAs per pair
     of each launch, and fast and exact pairwise timed in turns; and the
     rows of phases 3d, 3e and 3f (24 rows in all);
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
import statistics
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
# FP32 instructions per distance element, at the least: x.y (a product and
# two FMAs), the norms' add, the fused -2 x.y and the row and column mins;
# the clamp at 0 goes once to each minimum, not to each element (monotone).
# (CD_FP32_PER_ELEM was 8 until the one-pass kernel, which charged a max per
# element; the kernel itself issues 9: x.y without FMAs, for the plain
# version's bits.)
CD_FP32_PER_ELEM = 7
# approxmatch per element at 10 levels, at the least: two sweeps per level
# (the rows', the columns'), each with an exp (MUFU ex2) but level 0's, where
# L = 0, and the columns' with a sqrt: 19 exps and 10 square roots, 29 MUFU.
# FP32 per element and level, with the distances and the sums on the
# tensor cores as fast mode does: the exponent's scale, the w and ss
# products, the two squarings that give level k's exp from level k+1's,
# the w of level k and the ss sqrt(d) term (7)
EMD_MUFU_PER_ELEM = 2 * 10 - 1 + 10
EMD_FP32_PER_ELEM_LEVEL = 7
# the CD backward per element, at the least: one distance (5, as
# CD_FP32_PER_ELEM counts it) and the row and column mask tests (2), the
# forward's scan; the tests take the unclamped distance, since the minima
# are clamped (>= 0: sweep_bound in csrc/chamfer.cu), so no clamp goes to an
# element. (CD_BWD_FP32_PER_ELEM was 8 until the one-sweep kernel, which
# charged a clamp per element.) The tie counts and the masked sums (sum_j
# maskl y_j, sum_j wr_ij and sum_j wr_ij y_j for gx; sum_i maskr x_i, sum_i
# wl_ij and sum_i wl_ij x_i for gy) add only where d <= dmin: per
# neighbour of a row and of a column, two counts and 14 sums
CD_BWD_FP32_PER_ELEM = 7
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
# the probe backward in f32 at K=32 against an f64 run of its plain version,
# per output (phase 3f's sweep, probe_f64_sweep). The cotangent's 32-layer
# walk from random layer outputs is ill-conditioned in f32: a relu gate
# within rounding of 0 flips in one sum order and not in another, and each
# flip moves the gradients by 1e-5 to 4e-4 of their norm. So the drift of an
# f32 version from the f64 run comes in such steps, and the f32 plain
# version is one draw of it: on the sweep's ten input sets it read 4e-8 to
# 2.2e-4, the probe kernels 6e-8 to 3.6e-4 (up to 512x the plain version's
# drift on a set where the plain version flipped no gate), and the
# production backward's f32 kernel the same 3.6e-4 on the same set; a TF32
# run of the plain version read 1.7e-3 to 7.6e-3 at its largest (NVIDIA
# H100 80GB HBM3, 700 W). A kernel may part from the f64 run by
# PROBE_F64_RATIO times the f32 plain version's drift, and always by
# PROBE_F64_FLOOR, ~3x above the largest step seen and below TF32's reading
# on every set, which the sweep requires. The inverse walk alone (walk) is
# well conditioned (f32 2.3e-7 at most) and is held to the f32 limit, which
# TF32 (1.2e-4 to 1.9e-4) fails.
PROBE_F64_RATIO = 4.0
PROBE_F64_FLOOR = {"full": 1e-3, "nowg": 1e-3, "walk": TOL_GRAD_F32}
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
# the fused_train bf16 kernels' times at B=64 x 2048 in their first,
# block-wide design (WMMA through a staging tile, 64-point backward tiles;
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside phase 4's
FIRST_TRAIN_MS = {"fwd": 4.808, "bwd": 14.805}
# the fused_train bf16 backward's time at B=64 x 2048 before its body moved
# into flow_bwd_rows.cuh, shared with the decomposition probe (the tree
# before the move; NVIDIA H100 80GB HBM3, 700.00 W), printed beside phase
# 4's and held as its limit (TOL_SHARED_BWD)
SHARED_BODY_BWD_MS = 2.672
TOL_SHARED_BWD = 1.03
# the probe kernels' times at B=64 x 2048 in their first, block-wide design
# (WMMA through a staging tile, bf16 tile 64, the interleaved form one block
# per cloud; the dual-issue chain on WMMA with each W_i loaded synchronously;
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside phase 3f's
# the probe's full (8 rows) may take at most this much longer than the
# production backward on the tool's 3-row slice
TOL_FULL_LIB = 1.25
FIRST_PROBE_MS = {"full": 23.653, "nowg": 13.954, "walk": 6.258, "rolled": 23.074,
                  "ilv2": 49.421, "ilv4": 47.621, "dual_issue_A": 0.4205, "dual_issue_B": 0.4204,
                  "dual_issue_C": 0.0235}
# the fused_encoder bf16 kernels' times at B=64 x 2048 before the rows
# design (WMMA through a staging tile, 64-point tiles, a dense backward;
# NVIDIA H100 80GB HBM3, 700.00 W), printed beside phase 4's
FIRST_ENCODER_MS = {"fwd": 2.641, "bwd": 5.606}
# the fused sampler's bf16 times at B=64 x 2048 in its first design (block-
# wide WMMA through a staging tile, one warp per point for Wout), and the
# Chamfer forward's in its two-pass design (a thread per row, then a thread
# per column: every distance twice) at 128 x 128 pairs of 2048 points and
# B=32 diagonal pairs (NVIDIA H100 80GB HBM3, 700.00 W), printed beside
# phase 4's
FIRST_SAMPLER_MS = {"fused_sample": 3.558, "fused_inverse": 3.580, "fused_sample_int8": 3.818}
FIRST_CD_MS = {"exact": 48.11, "triangle": 24.41, "fast": 58.68, "nnd_fwd": 0.457}
# the Chamfer backward's time at B=64 x 2048 in its three-pass design (one
# block per pair, every distance three times; NVIDIA H100 80GB HBM3,
# 700.00 W), printed beside phase 3d's; the design stays as the kernel's
# path for pairs with many ties and as nnd_backward(three_pass=True)
FIRST_CD_BWD_MS = 1.151
# the fused latent flow's bf16 times at B=64 in its first design (a block
# of 16 samples walking all 14 layers, WMMA on weights read from global
# memory; NVIDIA H100 80GB HBM3, 700.00 W), printed beside phase 4's
FIRST_LATENT_MS = {"fwd": 0.486, "inv": 0.360, "bwd": 1.031}
# the cluster plans (CTAs per cluster, samples per cluster) phase 4 times
LATENT_PLANS = ((8, 64), (16, 64), (16, 32), (8, 32), (16, 16), (8, 16))
# the round trip of the bf16 training forward and the sampler's bf16
# inverse on the same hz: both run flow_rows.cuh on the same passthrough
# coordinates, so (s, t) agree bit for bit and x comes back up to the f32
# rounding of the affine update (median); a coordinate recovered a few ulps
# off can cross a bf16 rounding boundary at a later layer's input, which the
# largest error is held to TOL_BF16_MAX for
TOL_TRIP_MEDIAN = 1e-5
# the kernel's base noise against philox_noise_plain: the integer rounds
# are exact, logf and cosf a few ulps from torch's
TOL_NOISE = 1e-6


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
    emd = bound_cores(EMD_FP32_PER_ELEM_LEVEL * lv, EMD_MUFU_PER_ELEM * elems, nbytes)
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
                      EMD_MUFU_PER_ELEM * elems + EMD_GRAD_MUFU_PER_ELEM_LEVEL * lv,
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


def encoder_issued(widths, b: int, n: int, rows: int):
    """FLOP the encoder's bf16 kernels issue at B x N with ``rows`` critical
    rows: the forward and the select run the dense chain over whole tiles
    of 128 points; the walk recomputes h_1 .. h_{L-1} and runs the
    weight-gradient and cotangent products on its groups of 64 gathered
    rows."""
    macs = [widths[i] * widths[i + 1] for i in range(len(widths) - 1)]
    tile_rows = b * -(-n // 128) * 128
    walk_rows = -(-rows // 64) * 64
    chain = 2.0 * tile_rows * sum(macs)
    return chain, chain + 2.0 * walk_rows * (sum(macs[:-1]) + 2 * sum(macs))


def critical_rows(fe, ws, bs, x, g, dtype) -> int:
    """Points of x that reach some live feature's max (g > 0): the rows the
    encoder's backward walks, from its plain select."""
    import torch

    with torch.no_grad():
        h = fe._chain(ws, bs, x, dtype)[-1].float()
        return int(((h == g[:, None]) & (g[:, None] > 0)).any(-1).sum())


def encoder_ptxas() -> dict:
    """Registers and spilled bytes (stores/loads) of the fused_encoder bf16
    rows-design kernels (forward, select, walk), from ptxas' log."""
    import re

    from dpfx_torch.ops import _build

    names = {"tile_kernelILb0E": "forward", "tile_kernelILb1E": "select",
             "walk_kernel": "walk"}
    found, cur = {}, None
    for line in _build.ptxas_log("fused_encoder").splitlines():
        if "Compiling entry function" in line:
            cur = next((v for k, v in names.items() if k in line), None)
        elif cur and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            found.setdefault(cur, {})["spill"] = f"{st}/{ld}"
        elif cur and "Used" in line:
            found.setdefault(cur, {})["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return found


def latent_ptxas() -> dict:
    """Registers and spilled bytes (stores/loads) of the fused latent flow's
    bf16 cluster kernels (forward, inverse, backward), from ptxas' log."""
    import re

    from dpfx_torch.ops import _build

    names = {"cluster_flow_kernelILb0E": "fwd", "cluster_flow_kernelILb1E": "inv",
             "cluster_bwd_kernel": "bwd"}
    found, cur = {}, None
    for line in _build.ptxas_log("fused_latent").splitlines():
        if "Compiling entry function" in line:
            cur = next((v for k, v in names.items() if k in line), None)
        elif cur and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            found.setdefault(cur, {})["spill"] = f"{st}/{ld}"
        elif cur and "Used" in line:
            found.setdefault(cur, {})["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return found


def sampler_ptxas() -> str:
    """Registers and spilled bytes of the fused sampler's flagship instance
    (bf16 weights, H=128, relu, two stages), from ptxas' log."""
    import re

    from dpfx_torch.ops import _build

    cur, out = "", {}
    for line in _build.ptxas_log("fused_sampler").splitlines():
        if "Compiling entry function" in line:
            cur = line
        elif "rows_kernelI13__nv_bfloat16Li128ELb1ELb1E" in cur:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                out["regs"] = int(m.group(1))
            m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
            if m:
                out["spill"] = f"{m.group(1)}/{m.group(2)}"
    return f"{out.get('regs')} registers, spilled bytes (stores/loads) {out.get('spill')}"


def rel(a, b) -> float:
    """|a - b| / |b|, the norms in f64 (the probe's weight gradients on the
    JAX tool's scales overflow a float32 norm)."""
    return float((a.double() - b.double()).norm() / b.double().norm().clamp_min(1e-300))


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
# the dual-issue chain against its plain version: v is expf in f32 on both
# sides and the chain contracts (slope 1/4 at its fixed point); x takes bf16
# products whose f32 sums run in other orders, so now and then an entry
# lands one bf16 ulp away and the later products carry it on: every entry
# within 2% of the largest, 99% within 0.4% (tests/test_torch_probe_dual_issue.py)
TOL_DUAL_V = 1e-6
TOL_DUAL_X_MAX = 2e-2
TOL_DUAL_X_P99 = 4e-3


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
        cdk.reset_launch_counts()
        dl, dr = cdk.nn_distances(x, y)
        again = cdk.nn_distances(x, y)
        # the same pairs among 264 (2 x 132): one CTA each, where B=8 runs
        # each pair on a cluster
        ml, mr = cdk.nn_distances(x.repeat(33, 1, 1), y.repeat(33, 1, 1))
        pdl, _, pdr, _ = cdk.nn_distances_plain(x, y)
        torch.cuda.synchronize()
        exact = torch.equal(dl, pdl) and torch.equal(dr, pdr)
        one_cta = torch.equal(dl, ml[:8]) and torch.equal(dr, mr[:8])
        cd_k = dl.mean(-1) + dr.mean(-1)
        e_cd = float(pair_err(cd_k, pdl.mean(-1) + pdr.mean(-1), CD_FLOOR).max())
        print(f"kernel-vs-plain nnd_fwd {tag} B=8: minima equal to the plain version's bit for bit "
              f"{exact}, CD rel max {e_cd:.2e}; CTAs per pair {sorted(cdk.clusters['nnd_fwd'])}, the "
              f"cluster equal to one CTA bit for bit {one_cta}"
              + (f", identical pair CD {float(cd_k[0]):.2e}" if ident else ""))
        check(torch.equal(dl, again[0]) and torch.equal(dr, again[1]),
              f"nnd_fwd bit-identical from run to run {tag}")
        check(exact and e_cd <= TOL_CD, f"nnd_fwd {tag}: minima bit for bit {exact}, CD {e_cd}")
        check(one_cta and cdk.clusters["nnd_fwd"] == {cdk.cluster_size(8, n, 2048), 1}
              and cdk.cluster_size(8, n, 2048) > 1, f"nnd_fwd on a cluster equals one CTA {tag}")
        check(not ident or float(cd_k[0]) <= TOL_CD_IDENTICAL, "CD of a cloud with itself")

        errs = {}
        ii, jj = (v.flatten() for v in torch.meshgrid(torch.arange(16), torch.arange(16),
                                                         indexing="ij"))
        for prec in ("exact", "fast"):
            a = cdk.chamfer_pairwise(xs, ys, prec)
            a2 = cdk.chamfer_pairwise(xs, ys, prec)
            b = cdk.chamfer_pairwise_plain(xs, ys, prec)
            one = cdk.onepass_plain(xs[ii], ys[jj], fast=prec == "fast")[2].view(16, 16)
            torch.cuda.synchronize()
            errs[prec] = float(pair_err(a, b, CD_FLOOR).max())
            check(torch.equal(a, a2), f"cd_pairwise {prec} bit-identical from run to run {tag}")
            check(errs[prec] <= TOL_CD, f"cd_pairwise {prec} {tag}: {errs[prec]}")
            check(torch.equal(a, one), f"cd_pairwise {prec} {tag} equals onepass_plain bit for bit")
        line = (f"kernel-vs-plain cd_pairwise {tag} 16x16: exact rel max {errs['exact']:.2e}, "
                f"fast rel max {errs['fast']:.2e}; both equal to onepass_plain bit for bit")
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
    gen_clusters = sorted(emdk.clusters["emd_pairwise"])
    check(gen_clusters == [1], f"the suite's emd_pairwise launches run a pair per CTA: {gen_clusters}")

    for m in mods:
        m.reset_launch_counts()
    rc, ae, ae_t, ae_wall = run_eval_cli([str(AE_CONFIG), "--weights", str(trained_pt), "--limit",
                                    str(EVAL_LIMIT)])
    ae_launches = counts()
    check(rc == 0 and {"step", "n_test", "recon-cd", "recon-emd"} <= set(ae) and finite_numbers(ae),
          f"AE results {ae}")
    for k in ("nnd_fwd", "emd_batched", "fused_sample"):
        check(ae_launches[k] > 0, f"kernel {k} was not launched on the AE path")
    ae_clusters = sorted(emdk.clusters["emd_batched"])
    check(ae_clusters and min(ae_clusters) > 1,
          f"the AE path's emd_batched launches run a pair on a cluster: {ae_clusters}")
    from dpfx_torch.config import load_config

    ae_bsz = load_config(str(AE_CONFIG)).eval.batch_size
    batches = -(-EVAL_LIMIT // ae_bsz)
    print(f"evaluation paths on the {TRAIN_STEPS}-step checkpoint, {EVAL_LIMIT} test clouds: "
          f"generation suite {gen_t['total']:.3f} s ({gen_wall:.2f} s with restore and data), "
          f"launches {json.dumps(gen_launches)}; AE {ae_t['total'] / batches * 1e3:.2f} ms per "
          f"{ae_bsz}-cloud batch ({batches} batches, {ae_wall:.2f} s with restore "
          f"and data), launches {json.dumps(ae_launches)}; CTAs per pair: emd_pairwise "
          f"{gen_clusters}, emd_batched {ae_clusters}")

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


def emd_sweeps_checks(cfg, dev) -> None:
    """Phase 4: the EMD kernel against emd_sweeps_plain, the plain version of
    its own sweep order, on phase 2c's pairs (8 at N=2048 and 2000 against
    M=2048): emd_nograd (a cluster of 4 CTAs per pair) and the diagonals of
    the 8 x 8 pairwise matrices (2 CTAs per pair), exact and fast, the
    gradient mode's cost (its gradients are held to emd_grads_plain in phase
    3d), by phase 2c's limits."""
    import torch

    from dpfx_torch.ops import emd as emdk

    med = lambda e: float(e.median())
    for n in (2048, 2000):
        xs = split_clouds(cfg, range(16), n, 2, dev)[:8]
        ys = split_clouds(cfg, range(16, 32), 2048, 1, dev)[:8]
        emdk.reset_launch_counts()
        got = {"emd_batched exact": emdk.emd_nograd(xs, ys),
               "emd_batched_grad cost": emdk.emd_with_grads(xs, ys)[0],
               "emd_pairwise exact": emdk.emd_pairwise(xs, ys, precision="exact").diagonal(),
               "emd_pairwise fast": emdk.emd_pairwise(xs, ys, precision="fast").diagonal()}
        ref = {"exact": emdk.emd_sweeps_plain(xs, ys), "fast": emdk.emd_sweeps_plain(xs, ys, precision="fast")}
        torch.cuda.synchronize()
        parts = []
        for name, a in got.items():
            e = pair_err(a, ref["fast" if name.endswith("fast") else "exact"], EMD_FLOOR)
            parts.append(f"{name} rel median {med(e):.2e} max {float(e.max()):.2e}")
            check(med(e) <= TOL_EMD_MEDIAN and float(e.max()) <= TOL_EMD_MAX,
                  f"{name} N={n} against emd_sweeps_plain: median {med(e)}, max {float(e.max())}")
        cl = {k: sorted(v) for k, v in emdk.clusters.items()}
        print(f"kernel-vs-emd_sweeps_plain N={n} M=2048, 8 pairs (CTAs per pair {json.dumps(cl)}): "
              + "; ".join(parts))


def eval_kernel_rows(cfg, half_a, half_b, gen_launches, ae_launches):
    """Phase 4's rows for the evaluation kernels: a 128 x 128 matrix at
    N=2048 for the pairwise kernels (CD exact, EMD fast: the suite's
    defaults; CD also in the triangle mode of the suite's self-matrices),
    B=32 (the eval batch) for the diagonal ones. Each is held to its plain
    version at these shapes by phase 2c's rules; the EMD kernel also to
    emd_sweeps_plain (emd_sweeps_checks), and fast and exact pairwise are
    timed in turns (exact, fast, fast, exact)."""
    import torch

    from dpfx_torch.ops import chamfer as cdk
    from dpfx_torch.ops import emd as emdk

    emd_sweeps_checks(cfg, half_a.device)
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
    check(torch.equal(dl, pdl) and torch.equal(dr, pdr) and e_nnd <= TOL_CD,
          f"nnd_fwd B={b}: minima bit for bit, per point {pt}, CD {e_nnd}")
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
    # exact and fast in turns (exact, fast, fast, exact)
    cd_turns = {"exact": [], "fast": []}
    for prec in ("exact", "fast", "fast", "exact"):
        cd_turns[prec].append(cuda_ms(lambda: cdk.chamfer_pairwise(half_a, half_b, prec), 3,
                                      warmup=1))
    ms, fast_ms = sum(cd_turns["exact"]) / 2, sum(cd_turns["fast"]) / 2
    (bd, by), _ = eval_bounds(s * s, n, n, s, s, s * s)
    rows.append(("cd_pairwise", "chamfer", "dpfx/ops/chamfer.py:255", gen_launches["cd_pairwise"],
                 err, ms, plain, bd, by))
    sym_ms = cuda_ms(lambda: cdk.chamfer_pairwise(half_a, half_a, symmetric=True), 5)

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
    turns = {"exact": [], "fast": []}
    for prec in ("exact", "fast", "fast", "exact"):
        turns[prec].append(cuda_ms(lambda: emdk.emd_pairwise(half_a, half_b, precision=prec), 1,
                                   warmup=1))
    exact_ms = sum(turns["exact"]) / 2
    _, exact_plain = timed_once(lambda: emdk.emd_pairwise_plain(half_a, half_b, precision="exact"))
    print(f"emd_pairwise {s}x{s} in turns (exact, fast, fast, exact): "
          f"{', '.join(f'{t:.2f}' for t in (turns['exact'][0], *turns['fast'], turns['exact'][1]))} ms; "
          f"fast / exact {sum(turns['fast']) / sum(turns['exact']):.4f}")
    ms = sum(turns["fast"]) / 2
    _, (bd, by) = eval_bounds(s * s, n, n, s, s, s * s)
    rows.append(("emd_pairwise", "emd", "dpfx/ops/emd.py:435", gen_launches["emd_pairwise"], err,
                 ms, plain, bd, by))
    torch.cuda.synchronize()
    print(f"kernel-vs-plain at the paths' shapes, N={n}: nnd_fwd B={b} per-point rel max {pt:.2e}, "
          f"CD rel max {e_nnd:.2e}; cd_pairwise {s}x{s} exact rel max {e_cd:.2e}, symmetric "
          f"(triangle) rel max {e_sym:.2e}; emd_batched B={b} rel median {med(e_b):.2e} max "
          f"{float(e_b.max()):.2e}; emd_pairwise {s}x{s} fast rel median {med(e_p):.2e} max "
          f"{float(e_p.max()):.2e}")
    cd_first = ", ".join(f"{k} {FIRST_CD_MS[k]:.3f} ms ({FIRST_CD_MS[k] / v:.2f}x)" for k, v in (
        ("exact", rows[1][5]), ("triangle", sym_ms), ("fast", fast_ms), ("nnd_fwd", rows[0][5])))
    print(f"redesigned Chamfer forward (one pass) at N={n}: cd_pairwise {s}x{s} exact "
          f"{rows[1][5]:.3f} ms, triangle {sym_ms:.3f}, fast {fast_ms:.3f} (fast / exact "
          f"{fast_ms / rows[1][5]:.3f}; turns exact, fast, fast, exact "
          f"{', '.join(f'{v:.3f}' for v in (cd_turns['exact'][0], *cd_turns['fast'], cd_turns['exact'][1]))}"
          f"), nnd_fwd B={b} {rows[0][5]:.4f} ms on "
          f"{cdk.cluster_size(b, n, n)} CTAs per pair; first design: {cd_first}; bound "
          f"{rows[1][7]:.3f} ms ({rows[1][5] / rows[1][7]:.2f}x)")
    print(f"evaluation kernels at N={n}: nnd_fwd B={b} {rows[0][5]:.3f} ms; cd_pairwise {s}x{s} "
          f"exact {rows[1][5]:.3f} ms ({rows[1][5] / (s * s) * 1e3:.3f} us/pair), fast "
          f"{fast_ms:.3f} ms, symmetric {sym_ms:.3f} ms; emd_batched B={b} {rows[2][5]:.3f} ms; "
          f"emd_pairwise {s}x{s} fast {rows[3][5]:.3f} ms ({rows[3][5] / (s * s) * 1e3:.2f} "
          f"us/pair), exact {exact_ms:.3f} ms ({exact_ms / (s * s) * 1e3:.2f} us/pair; its plain "
          f"version {exact_plain:.1f} ms)")
    return [{"name": nm, "route": "cuda", "source": f"dpfx_torch/ops/csrc/{src}.cu",
             "replaces": where, "launches": launched, "max_abs_err": err, "ms": ms,
             "plain_ms": plain, "bound_ms": bd, "bound_by": by, "library_ms": None}
            for nm, src, where, launched, err, ms, plain, bd, by in rows]


def path_counts(paths) -> str:
    """The pairs of nnd_bwd launches by path (paths: uint8 [B], chamfer.PATH_*)."""
    import torch

    c = torch.bincount(paths.long(), minlength=3).tolist()
    return f"pairs by path: lists {c[0]}, fix-up {c[1]}, three passes {c[2]}"


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

    # CD backward: B=64 x 2048, a ragged 2000 x 2048 batch, and hubs: a
    # collapsed cloud (0.01 N(0, 1)) against the test clouds, as a generator
    # early in training gives (inverse lists past 32, which the fix-up takes)
    cd_err = 0.0
    hubs = 0.01 * torch.randn(test.shape, generator=g, device=dev)
    for x, y, tag in ((xs, test, f"B={b} N={n} M={n}"),
                      (xs[:8, :2000].contiguous(), test[:8], "B=8 N=2000 M=2048"),
                      (hubs, test, f"hubs B={b} N={n} M={n}")):
        dl, dr = cdk.nnd_forward(x, y)
        gl = torch.randn(dl.shape, generator=g, device=dev)
        gr = torch.randn(dr.shape, generator=g, device=dev)
        gx, gy = cdk.nnd_backward(x, y, dl, dr, gl, gr)
        paths = cdk.last_paths
        gx2, gy2 = cdk.nnd_backward(x, y, dl, dr, gl, gr)
        px, py = cdk.nn_distances_backward_plain(x, y, dl, dr, gl, gr)
        tx, ty = cdk.nnd_backward(x, y, dl, dr, gl, gr, three_pass=True)
        torch.cuda.synchronize()
        e = max(grad_point_err(gx, px), grad_point_err(gy, py))
        print(f"kernel-vs-plain nnd_bwd {tag}: per-point rel max {e:.2e}, max_abs "
              f"{max(float((gx - px).abs().max()), float((gy - py).abs().max())):.2e} "
              f"(|g|max {float(px.abs().max()):.2f}); {path_counts(paths)}, CTAs per pair "
              f"{cdk.cluster_size(x.shape[0], x.shape[1], y.shape[1])}; equal to the three-pass "
              f"kernel {torch.equal(gx, tx) and torch.equal(gy, ty)}")
        check(torch.equal(gx, gx2) and torch.equal(gy, gy2), f"nnd_bwd bit-identical {tag}")
        check(e <= TOL_CD_GRAD, f"nnd_bwd {tag}: per point {e}")
        check(torch.equal(gx, tx) and torch.equal(gy, ty), f"nnd_bwd equals the three passes {tag}")
        if x is xs:
            cd_err = max(float((gx - px).abs().max()), float((gy - py).abs().max()))
            cd_args = (x, y, dl, dr, gl, gr)
        if x is hubs:
            hub_args = (x, y, dl, dr, gl, gr)

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
        paths = cdk.last_paths
        px, py = cdk.nn_distances_backward_plain(x, y, dl, dr, gl, gr)
        torch.cuda.synchronize()
        e = max(float((gx - px).abs().max()), float((gy - py).abs().max()))
        split = float((gy[:, : n // 2] - gy[:, n // 2:]).abs().max())
        print(f"nnd_bwd ties ({tag}, B=8 x {n}): max_abs against plain {e:.2e}, |gx|max "
              f"{float(gx.abs().max()):.2e}, copies' gy differ by {split:.2e}; {path_counts(paths)}")
        check(e <= TOL_CD_GRAD * float(px.abs().max() + 1.0), f"nnd_bwd ties {tag}: {e}")
        check(bool((paths == cdk.PATH_THREE).all()), f"nnd_bwd ties {tag} took the three passes")
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
    # the first step's CD backward: the one-sweep kernel against the
    # three-pass kernel and onepass_bwd_plain, bit for bit (every path adds
    # the three passes' nonzero terms in their order)
    dl, dr = cdk.nnd_forward(x, target)
    d_args = (x, target, dl, dr, torch.full_like(dl, 1.0 / n), torch.full_like(dr, 1.0 / n))
    gx, gy = cdk.nnd_backward(*d_args)
    paths = cdk.last_paths
    tx, ty = cdk.nnd_backward(*d_args, three_pass=True)
    ox, oy, op = cdk.onepass_bwd_plain(*d_args)
    torch.cuda.synchronize()
    same = torch.equal(gx, tx) and torch.equal(gy, ty)
    print(f"nnd_bwd on the descent's first inputs (B={b} x {n}): equal to the three-pass kernel "
          f"{same}, to onepass_bwd_plain {torch.equal(gx, ox) and torch.equal(gy, oy)}; "
          f"{path_counts(paths)}")
    check(same, "nnd_bwd equals the three-pass kernel on the descent's inputs")
    check(torch.equal(gx, ox) and torch.equal(gy, oy) and torch.equal(paths, op),
          "nnd_bwd equals onepass_bwd_plain on the descent's inputs")
    with torch.no_grad():
        cd0, emd0 = cdk.chamfer(x, target), emdk.emd(x, target)
    step_paths = []
    for m in (cdk, emdk):
        m.reset_launch_counts()
    t0 = time.perf_counter()
    for _ in range(20):
        x = x.detach().requires_grad_(True)
        (cdk.chamfer(x, target) + emdk.emd(x, target)).sum().backward()
        step_paths.append(cdk.last_paths)
        x = x - lr * x.grad
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {**cdk.launches, **emdk.launches}
    grad_clusters = sorted(emdk.clusters["emd_batched_grad"])
    bwd_clusters = sorted(cdk.clusters["nnd_bwd"])
    print(f"descent nnd_bwd paths over its 20 launches: {path_counts(torch.cat(step_paths))}; "
          f"CTAs per pair {bwd_clusters}")
    with torch.no_grad():
        cd1, emd1 = cdk.chamfer(x, target), emdk.emd(x, target)
    print(f"descent on chamfer + emd, {b} pairs x {n} points, 20 steps in {wall:.3f} s: CD mean "
          f"{float(cd0.mean()):.4e} -> {float(cd1.mean()):.4e}, EMD mean {float(emd0.mean()):.4e} "
          f"-> {float(emd1.mean()):.4e}; launches {json.dumps(launched)}; emd_batched_grad CTAs "
          f"per pair {grad_clusters}")
    check(grad_clusters and min(grad_clusters) > 1,
          f"the descent's emd_batched_grad launches run a pair on a cluster: {grad_clusters}")
    for k in ("nnd_fwd", "nnd_bwd", "emd_batched_grad"):
        check(launched[k] > 0, f"kernel {k} was not launched on the descent path")
    check(launched["emd_batched"] == 0, "the descent took the gradient mode, not emd_nograd")
    check(bool(torch.isfinite(x).all()) and bool((cd1 < cd0).all()) and bool((emd1 < emd0).all()),
          "20 descent steps lower CD and EMD of every pair")

    # the rows, at the descent's shapes; the one-sweep and the three-pass
    # kernels in turns (one, three, three, one) on the sampled clouds, on
    # the descent's first inputs and on the hubs
    turns = {}
    for tag, args in (("sampled", cd_args), ("descent", d_args), ("hubs", hub_args)):
        t = [cuda_ms(lambda: cdk.nnd_backward(*args, three_pass=k), 20) for k in (False, True, True, False)]
        turns[tag] = (t[0] + t[3]) / 2, (t[1] + t[2]) / 2
        print(f"nnd_bwd in turns ({tag}, B={b} x {n}): one sweep {t[0]:.4f}, {t[3]:.4f} ms; three "
              f"passes {t[1]:.4f}, {t[2]:.4f} ms (first design: {FIRST_CD_BWD_MS})")
    nb_ms = turns["sampled"][0]
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


def probe_bounds(b: int, n: int, k: int, h: int, nh1: int, mode: str):
    """The probe backward on the 8-row layout: FLOP of its products per
    point and layer (recompute Wx, Wh, Wout: 16H + NH1 H^2 multiply-adds;
    the cotangent chain the same; the weight gradients the same, full only)
    and the bytes of its inputs and outputs (bf16 weights, f32 gradients)."""
    macs = {"walk": 1, "nowg": 2, "full": 3}[mode] * (16 * h + nh1 * h * h)
    nw = k * (16 * h + nh1 * h * h)
    small = 4 * k * (nh1 * h + 16)
    nbytes = 3 * 4 * 8 * b * n + 4 * b * k * h + 4 * b + 2 * nw + small
    if mode == "full":
        nbytes += 4 * b * k * h + 4 * (nw + k * (nh1 * h + 8))
    return bound_of(2.0 * b * n * k * macs, nbytes)


def dual_issue_bounds(n_layers: int, g: int, h: int, t: int, mode: str):
    """The dual-issue probe: A's products on the tensor cores, C's v-chain
    on the CUDA cores (a MUFU exp and two FP32 operations per entry and
    step), B both at once; x read and written, v read and written."""
    nbytes = 2 * 4.0 * g * h * t + 2.0 * n_layers * h * h + 2 * 4.0 * g * 8 * t
    tc = bound_of(2.0 * g * n_layers * h * h * t, nbytes)
    cores = bound_cores(2.0 * g * n_layers * 8 * t, float(g) * n_layers * 8 * t, nbytes)
    return {"A": tc, "B": max(tc, cores), "C": cores}[mode]


def run_tool(module: str, args, env_extra):
    """``python -m <module> <args>`` in a child process from the repo root;
    returns its stdout lines and the launch counts of its last line."""
    env = {**os.environ, **env_extra}
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    print(proc.stdout, end="")
    check(proc.returncode == 0, f"{module} exited {proc.returncode}: {proc.stderr[-2000:]}")
    lines = proc.stdout.strip().splitlines()
    check(lines[-1].startswith("launches "), f"{module} printed its launches")
    return lines, json.loads(lines[-1].split(" ", 1)[1])


def probe_check_inputs(sp, b: int, n: int, g, dev, pad_scale: float = 0.02):
    """Phase 2's seeded flagship point flow on the probe's 8-row layout:
    wx's columns 0-2 and wout's rows 0-5 as the model has them (the mask
    folded in), the pad columns 3-7 and rows 6-7 drawn at the model's own
    scale (``pad_scale``; 0 gives the zero-padded production inputs), so
    the walk is as well conditioned as phase 2b's; u, du unit normal in all
    8 rows (rows 3-7 zero with pad_scale 0); hz the model's z-projection."""
    import torch

    from dpfx_torch.ops import fused_sampler as fs

    k, h, _ = sp.wx.shape
    rn = lambda *shape: torch.randn(shape, generator=g, device=dev)
    w = {"wx": torch.cat([sp.wx, pad_scale * rn(k, h, 5)], 2),
         "wh": sp.wh, "bh": sp.bh[..., None],
         "wout": torch.cat([sp.wout, pad_scale * rn(k, 2, h)], 1),
         "bout": torch.cat([sp.bout, pad_scale * rn(k, 2)], 1)[..., None]}
    u, du = rn(b, 8, n), rn(b, 8, n)
    if pad_scale == 0:
        u[:, 3:] = 0
        du[:, 3:] = 0
    hz = fs.z_projection(sp, rn(b, sp.wz.shape[1]))[..., None]
    return w, u, hz, du, rn(b)


def probe_ptxas() -> str:
    """Registers and spills of the probe's bf16 instances (probe_rows_kernel:
    each mode rolled and not, the interleaved groups) from ptxas' log of
    bench_fused_bwd.cu, and of the dual-issue kernel's modes."""
    import re

    from dpfx_torch.ops import _build

    found, cur = {}, None
    for name, pat in (("bench_fused_bwd", r"probe_rows_kernelILi(\d)ELb(\d)ELi(\d)E"),
                      ("dual_issue", r"dual_issue_kernelILb(\d)ELb(\d)E")):
        for line in _build.ptxas_log(name).splitlines():
            if "Compiling entry function" in line:
                m = re.search(pat, line)
                if not m:
                    cur = None
                elif name == "dual_issue":
                    cur = "dual_issue " + pdi_mode(m.group(1) == "1", m.group(2) == "1")
                else:
                    cur = (f"{('full', 'nowg', 'walk')[int(m.group(1))]} groups={m.group(3)}"
                           f"{' rolled' if m.group(2) == '1' else ''}")
            elif cur and "spill stores" in line:
                st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                                   line).groups()
                found.setdefault(cur, {})["spill"] = f"{st}/{ld} B spilled"
            elif cur and "Used" in line:
                found.setdefault(cur, {})["regs"] = re.search(r"Used (\d+) registers",
                                                              line).group(1)
    check(len([k for k in found if not k.startswith("dual")]) == 10 and
          all("regs" in d for d in found.values()),
          f"ptxas reported every probe_rows_kernel instance: {sorted(found)}")
    return "; ".join(f"{k} {d.get('regs')} registers, {d.get('spill')}"
                     for k, d in sorted(found.items()))


def pdi_mode(mxu: bool, vpu: bool) -> str:
    from dpfx_torch.tools import probe_dual_issue as pdi

    return pdi.mode_of(mxu, vpu)


def train_ptxas(h: int = 128) -> dict:
    """Registers and spilled bytes (stores/loads) of the fused_train bf16
    kernels at hidden h, from ptxas' log of fused_train.cu."""
    import re

    from dpfx_torch.ops import _build

    found, cur = {}, None
    for line in _build.ptxas_log("fused_train").splitlines():
        if "Compiling entry function" in line:
            m = re.search(rf"(fwd|bwd)_kernel_mmaILi{h}E", line)
            cur = f"fused_train_{m.group(1)}" if m else None
        elif cur and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            found.setdefault(cur, {})["spill"] = f"{st}/{ld}"
        elif cur and "Used" in line:
            regs = re.search(r"Used (\d+) registers", line).group(1)
            found.setdefault(cur, {})["regs"] = int(regs)
    return found


def probe_f64_sweep(sp, n: int, dev, call) -> None:
    """Phase 3f's f32 check at full depth: every probe variant in f32 at
    K=32 against an f64 run of probe_bwd_plain (n_points=2000) on ten input
    sets (pad rows at the model's scale or zero; B=2 or 8; seeds 13-16),
    within PROBE_F64_RATIO times the f32 plain version's own drift from that
    run or PROBE_F64_FLOOR; a TF32 run of the plain version must fail the
    limit on every set. On the zero-padded sets the production backward's
    f32 kernel, whose function the probe's is there, is read against the
    same f64 run (all 2048 points)."""
    import torch

    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.tools import bench_fused_bwd as bfb

    f32, f64 = torch.float32, torch.float64
    seen = {"plain": [], "kernel": [], "ratio": [], "tf32": [], "production": []}
    for pad in (0.02, 0.0):
        for b, seed in ((2, 13), (8, 13), (8, 14), (2, 15), (8, 16)):
            ins = probe_check_inputs(sp, b, n, torch.Generator(device=dev).manual_seed(seed), dev,
                                     pad_scale=pad)
            tag = f"pad {pad} B={b} seed {seed}"
            for mode, vs in (("full", ("full", "rolled", "ilv2", "ilv4")), ("nowg", ("nowg",)),
                             ("walk", ("walk",))):
                p64 = bfb.probe_bwd_plain(*ins, mode=mode, n_points=2000, dtype=f64)
                p32 = bfb.probe_bwd_plain(*ins, mode=mode, n_points=2000, dtype=f32)
                torch.backends.cuda.matmul.allow_tf32 = True
                t32 = bfb.probe_bwd_plain(*ins, mode=mode, n_points=2000, dtype=f32)
                torch.cuda.synchronize()
                torch.backends.cuda.matmul.allow_tf32 = False
                live = [i for i, r in enumerate(p64) if r.abs().max() > 0]
                drift = {bfb.GRAD_NAMES[i]: rel(p32[i], p64[i]) for i in live}
                terr = {bfb.GRAD_NAMES[i]: rel(t32[i], p64[i]) for i in live}
                lim = {k: max(PROBE_F64_RATIO * e, PROBE_F64_FLOOR[mode]) for k, e in drift.items()}
                print(f"probe {mode} K=32 {tag} f32 against f64: plain " + " ".join(
                    f"{k}={e:.2e}" for k, e in drift.items()) + "; TF32 control " + " ".join(
                    f"{k}={e:.2e}" for k, e in terr.items()))
                check(any(terr[k] > lim[k] for k in terr),
                      f"the probe's f32 limit at K=32 fails a TF32 control ({mode}, {tag}): {terr}")
                if mode != "walk":
                    seen["plain"] += drift.values()
                    seen["tf32"].append(max(terr.values()))
                for v in vs:
                    got = call(v, ins, 2000, f32)
                    torch.cuda.synchronize()
                    kerr = {bfb.GRAD_NAMES[i]: rel(got[i], p64[i]) for i in live}
                    print(f"  kernel {v}: " + " ".join(f"{k}={e:.2e} ({e / drift[k]:.2f}x)"
                                                        for k, e in kerr.items()))
                    check(all(kerr[k] <= lim[k] for k in kerr), f"probe {v} f32 K=32 {tag}: {kerr}")
                    if mode != "walk":
                        seen["kernel"] += kerr.values()
                        seen["ratio"] += [kerr[k] / drift[k] for k in kerr]
                    del got
                del p64, p32, t32
            if pad == 0:
                _, u, hz, du, dld = ins
                pr = ft.fused_backward_kernel(sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks,
                                              sp.scale_cap, u[:, :3].contiguous(),
                                              hz[..., 0].contiguous(), du[:, :3].contiguous(), dld,
                                              f32)
                q = bfb.probe_bwd_plain(*ins, mode="full", n_points=n, dtype=f64)
                torch.cuda.synchronize()
                cut = [q[0][:, :3], q[1][..., 0], q[2][..., :3], q[3], q[4][..., 0], q[5][:, :6],
                       q[6][:, :6, 0]]
                perr = [rel(a, r) for a, r in zip(pr, cut)]
                seen["production"] += perr
                print(f"  the production backward's f32 kernel against f64 ({tag}, all {n} "
                      "points): " + " ".join(f"{k}={e:.2e}" for k, e in zip(bfb.GRAD_NAMES, perr)))
    print("probe f32 at K=32 against f64 (full and nowg, every gradient): plain "
          f"{min(seen['plain']):.2e} to {max(seen['plain']):.2e}, kernels {min(seen['kernel']):.2e} "
          f"to {max(seen['kernel']):.2e} (at most {max(seen['ratio']):.1f}x the plain version's "
          f"drift), the production kernel {min(seen['production']):.2e} to "
          f"{max(seen['production']):.2e}; TF32 control, largest gradient error per set: "
          f"{min(seen['tf32']):.2e} to {max(seen['tf32']):.2e}")


def probe_tools_path(sp, dev, card):
    """Phase 3f: the probe tools at full width. The probe backward (full,
    nowg, walk, rolled) and the interleaved one (2 and 4 groups) against
    probe_bwd_plain at B=64, N=2048 and with the log-det mask at 2000,
    twice each for bit-identity, on phase 2's flagship flow extended to 8
    rows; f32 at B=8 with a TF32 control; full against the production
    backward on zero-padded production inputs (bf16 bit for bit); the
    dual-issue modes against their plain version; the times beside the
    first design's, full / lib and the split; then both CLIs, each counting
    its launches from 0 in a process of its own. Returns the eight kernel
    rows."""
    import torch

    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.tools import bench_fused_bwd as bfb
    from dpfx_torch.tools import probe_dual_issue as pdi

    bf, f32 = torch.bfloat16, torch.float32
    b, n, cap = 64, bfb.N, sp.scale_cap
    print(f"ptxas probe_rows_kernel (bf16, tile 128) and dual_issue_kernel: {probe_ptxas()}")
    check(torch.equal(sp.masks, bfb.masks8(sp.wx.shape[0], dev)[:, :3, 0]) and cap == bfb.CAP,
          "the flagship flow's masks and cap are the probe's")
    g = torch.Generator(device=dev).manual_seed(13)
    w, u, hz, du, dld = probe_check_inputs(sp, b, n, g, dev)
    variants = {"full": dict(mode="full"), "nowg": dict(mode="nowg"), "walk": dict(mode="walk"),
                "rolled": dict(mode="full", rolled=True)}

    def call(v, ins, npts, dt=bf):
        if v.startswith("ilv"):
            return bfb.ilv_bwd_kernel(*ins, stripes=int(v[3:]), n_points=npts, dtype=dt)
        return bfb.probe_bwd_kernel(*ins, n_points=npts, dtype=dt, **variants[v])

    ins = (w, u, hz, du, dld)
    bfb.probe_bwd_plain(*ins, mode="walk", n_points=n, dtype=bf)   # warm-up: the plain ms below
    errs, plains = {}, {}
    for npts in (n, 2000):
        for v in ("full", "nowg", "walk", "rolled", "ilv2", "ilv4"):
            mode = variants.get(v, {"mode": "full"})["mode"]
            got, again = call(v, ins, npts), call(v, ins, npts)
            ref, plain_ms = timed_once(lambda: bfb.probe_bwd_plain(*ins, mode=mode, n_points=npts,
                                                                   dtype=bf))
            torch.cuda.synchronize()
            gerr = {nm: rel(a, r) for nm, a, r in zip(bfb.GRAD_NAMES, got, ref) if r.abs().max() > 0}
            print(f"kernel-vs-plain probe {v} B={b} N={n} n_points={npts} bf16: grad rel "
                  + " ".join(f"{k}={e:.2e}" for k, e in gerr.items()))
            check(all(torch.equal(a, c) for a, c in zip(got, again)),
                  f"probe {v} bit-identical from run to run n_points={npts}")
            check(all(not torch.any(a) for a, r in zip(got, ref) if not r.abs().max() > 0),
                  f"probe {v}: the outputs its mode leaves out are zero")
            check(max(gerr.values()) <= TOL_GRAD_BF16, f"probe {v} n_points={npts}: {gerr}")
            if npts == n:
                errs[v] = max(float((a - r).abs().max()) for a, r in zip(got, ref))
                plains[v] = plain_ms
            del got, again, ref

    probe_f64_sweep(sp, n, dev, call)
    pw, pu, phz, pdu, pdld = probe_check_inputs(sp, b, n, g, dev, pad_scale=0.0)

    # f32 at B=8 on the flow's first 3 layers, where the walk is well
    # conditioned: the kernels against the plain version at the f32 limit,
    # which a TF32 run of the plain version must fail
    cut3 = lambda d: {kk: t[:3] for kk, t in d.items()}
    i8 = (cut3(w), u[:8], hz[:8, :3].contiguous(), du[:8], dld[:8])
    ref = bfb.probe_bwd_plain(*i8, mode="full", n_points=2000, dtype=f32)
    for v in ("full", "ilv2"):
        got = call(v, i8, 2000, f32)
        torch.cuda.synchronize()
        gerr = {nm: rel(a, r) for nm, a, r in zip(bfb.GRAD_NAMES, got, ref)}
        print(f"kernel-vs-plain probe {v} K=3 B=8 n_points=2000 f32: grad rel "
              + " ".join(f"{k}={e:.2e}" for k, e in gerr.items()))
        check(max(gerr.values()) <= TOL_GRAD_F32, f"probe {v} f32: {gerr}")
    ctl = tf32_control(lambda: bfb.probe_bwd_plain(*i8, mode="full", n_points=2000, dtype=f32),
                       ref)
    print(f"f32 limit {TOL_GRAD_F32:.0e} against a TF32 control of the plain probe backward: "
          f"{ctl:.2e}")
    check(ctl > TOL_GRAD_F32, f"the f32 limit fails a TF32 control ({ctl})")

    # full on zero-padded production inputs against the production kernel:
    # f32 on the first 3 layers, as above (the block-wide check mode, sums in
    # other orders), within the f32 limit; bf16 at K=32, which runs the
    # production backward's own body, bit for bit
    for dt, bb, kk, tol in ((f32, 8, 3, TOL_GRAD_F32), (bf, b, sp.wx.shape[0], 0.0)):
        got = bfb.probe_bwd_kernel({nm: t[:kk] for nm, t in pw.items()}, pu[:bb],
                                   phz[:bb, :kk].contiguous(), pdu[:bb], pdld[:bb], mode="full",
                                   n_points=n, dtype=dt)
        ref = ft.fused_backward_kernel(sp.wx[:kk], sp.wh[:kk], sp.bh[:kk], sp.wout[:kk],
                                       sp.bout[:kk], sp.masks[:kk], cap, pu[:bb, :3].contiguous(),
                                       phz[:bb, :kk, :, 0].contiguous(), pdu[:bb, :3].contiguous(),
                                       pdld[:bb], dt)
        torch.cuda.synchronize()
        cut = [got[0][:, :3], got[1][..., 0], got[2][..., :3], got[3], got[4][..., 0],
               got[5][:, :6], got[6][:, :6, 0]]
        gerr = {nm: rel(a, r) for nm, a, r in zip(bfb.GRAD_NAMES, cut, ref)}
        same = {nm: torch.equal(a, r) for nm, a, r in zip(bfb.GRAD_NAMES, cut, ref)}
        print(f"probe full on zero-padded inputs vs fused_backward_kernel K={kk} B={bb} {dt}: "
              "grad rel " + " ".join(f"{k}={e:.2e}" for k, e in gerr.items())
              + "; bit for bit " + " ".join(f"{k}={v}" for k, v in same.items()))
        check(max(gerr.values()) <= tol, f"padded probe vs production {dt}: {gerr}")
        if dt == bf:
            check(all(same.values()), f"padded probe bit for bit the production backward: {same}")

    # the dual-issue modes at the tool's shapes
    n_layers, groups = 32, 16
    dw, dx, dv = pdi.probe_inputs(n_layers, groups, dev, seed=5)
    di = {}
    for m, (mxu, vpu) in pdi.MODES.items():
        ox, ov = pdi.dual_issue_kernel(dw, dx, dv, do_mxu=mxu, do_vpu=vpu)
        ox2, ov2 = pdi.dual_issue_kernel(dw, dx, dv, do_mxu=mxu, do_vpu=vpu)
        (px, pv), plain_ms = timed_once(lambda: pdi.dual_issue_plain(dw, dx, dv, do_mxu=mxu,
                                                                     do_vpu=vpu))
        torch.cuda.synchronize()
        ex = (ox - px).abs().flatten() / px.abs().max()
        e99 = float(torch.quantile(ex[:: max(1, ex.numel() // 2**24)], 0.99))
        ev = float((ov - pv).abs().max())
        print(f"kernel-vs-plain dual_issue {m} L={n_layers} G={groups}: x rel to max "
              f"{float(ex.max()):.2e} (99% {e99:.2e}; |x|max {float(px.abs().max()):.2e}), v max_abs "
              f"{ev:.2e}")
        check(torch.equal(ox, ox2) and torch.equal(ov, ov2), f"dual_issue {m} bit-identical")
        check(float(ex.max()) <= TOL_DUAL_X_MAX and e99 <= TOL_DUAL_X_P99 and ev <= TOL_DUAL_V,
              f"dual_issue {m}: x max {float(ex.max())}, 99% {e99}, v {ev}")
        di[m] = (max(float((ox - px).abs().max()), ev), plain_ms)

    # the rows' times on the JAX tool's inputs (what the CLI times), whose
    # weight scales make the 8-row backward explode
    tool = bfb.flagship_inputs(b, dev)
    big = call("full", tool, n)
    print("probe full on the JAX tool's inputs: max " + ", ".join(
        f"|{nm}| {float(t.abs().max()):.2e}" for nm, t in zip(bfb.GRAD_NAMES, big)))
    del big
    times = {v: cuda_ms(lambda v=v: call(v, tool, n), 5) for v in ("full", "nowg", "walk", "rolled",
                                                                    "ilv2", "ilv4")}
    dtimes = {m: cuda_ms(lambda m=m: pdi.dual_issue_kernel(dw, dx, dv, do_mxu=pdi.MODES[m][0],
                                                            do_vpu=pdi.MODES[m][1]), 20)
              for m in pdi.MODES}
    p = bfb.production_slice(*tool[:4])
    lib_ms = cuda_ms(lambda: ft.fused_backward_kernel(
        p["wx"], p["wh"], p["bh"], p["wout"], p["bout"], p["masks"], bfb.CAP, p["u"], p["hz"],
        p["du"], tool[4], bf), 5)
    print(f"probe kernels at B={b} N={n} bf16: " + ", ".join(
        f"{v} {t:.3f} ms (first design {FIRST_PROBE_MS[v]:.3f}, {FIRST_PROBE_MS[v] / t:.2f}x)"
        for v, t in times.items())
          + f"; production backward (3 rows) {lib_ms:.3f} ms; full / lib {times['full'] / lib_ms:.3f}"
          + "; dual-issue " + ", ".join(
              f"{m} {t:.4f} ms (first design {FIRST_PROBE_MS['dual_issue_' + m]:.4f}, "
              f"{FIRST_PROBE_MS['dual_issue_' + m] / t:.2f}x)" for m, t in dtimes.items())
          + f" ({card})")
    print(f"probe {bfb.split_line({**times, 'lib': lib_ms})}; walk < nowg < full: "
          f"{times['walk'] < times['nowg'] < times['full']}; t(B) - t(A) = "
          f"{dtimes['B'] - dtimes['A']:.4f} ms against t(C) = {dtimes['C']:.4f} ms ({card})")
    # the probe's own sanity checks: full is the production backward on 8
    # rows, and each mode leaves out part of the one before it
    check(times["full"] / lib_ms <= TOL_FULL_LIB,
          f"probe full / lib {times['full'] / lib_ms:.3f} above {TOL_FULL_LIB}")
    check(times["walk"] < times["nowg"] < times["full"],
          f"probe walk < nowg < full: {times['walk']:.3f}, {times['nowg']:.3f}, {times['full']:.3f}")

    # the main path: both CLIs as a user runs them
    t0 = time.perf_counter()
    tool_variants = ["lib", "full", "nowg", "walk", "rolled", "ilv2", "ilv4", "ilv2r", "ilv4r"]
    lines, bench_launches = run_tool("dpfx_torch.tools.bench_fused_bwd", tool_variants,
                                     {"DPFX_PROBE_REPS": "3", "DPFX_PROBE_TILES": "128"})
    for v in tool_variants:
        check(any(ln.startswith(f"  {v} ") and " ms " in ln for ln in lines), f"bench line {v}")
    check(any(ln.startswith("  full   tile= 128 ") and " ms " in ln for ln in lines),
          "bench line full at tile 128")
    check(any(ln.startswith("split of full: ") for ln in lines), "bench split line")
    dlines, dual_launches = run_tool("dpfx_torch.tools.probe_dual_issue", [], {})
    for label in pdi.LABELS.values():
        check(any(ln.startswith(f"{label}: ") for ln in dlines), f"dual-issue line {label}")
    check(any(ln.startswith("t(B) - t(A) = ") for ln in dlines), "dual-issue verdict line")
    print(f"probe CLIs in {time.perf_counter() - t0:.1f} s: launches "
          f"{json.dumps({**bench_launches, **dual_launches})}")
    names = {"full": "probe_bwd_full", "nowg": "probe_bwd_nowg", "walk": "probe_bwd_walk",
             "rolled": "probe_bwd_full_rolled", "ilv2": "ilv_bwd_2"}
    for v, key in names.items():
        check(bench_launches.get(key, 0) > 0, f"kernel {key} was not launched by the tool")
    for m in pdi.MODES:
        check(dual_launches.get(f"dual_issue_{m}", 0) > 0, f"dual_issue {m} was not launched")
    src = "dpfx_torch/ops/csrc/bench_fused_bwd.cu"
    rows = []
    for v, key in names.items():
        mode = variants.get(v, {"mode": "full"})["mode"]
        bd, by = probe_bounds(b, n, bfb.K, bfb.H, bfb.NH, mode)
        rows.append({"name": key, "route": "cuda", "source": src,
                     "replaces": "tools/bench_fused_bwd.py:155" if v == "ilv2" else
                     "tools/bench_fused_bwd.py:49", "launches": bench_launches[key],
                     "max_abs_err": errs[v], "ms": times[v], "plain_ms": plains[v], "bound_ms": bd,
                     "bound_by": by, "library_ms": None})
    for m in pdi.MODES:
        bd, by = dual_issue_bounds(n_layers, groups, pdi.H, pdi.T, m)
        rows.append({"name": f"dual_issue_{m}", "route": "cuda",
                     "source": "dpfx_torch/ops/csrc/dual_issue.cu",
                     "replaces": "tools/probe_dual_issue.py:43",
                     "launches": dual_launches[f"dual_issue_{m}"], "max_abs_err": di[m][0],
                     "ms": dtimes[m], "plain_ms": di[m][1], "bound_ms": bd, "bound_by": by,
                     "library_ms": None})
    return rows


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
    # the EMD kernel's element loops, read from its SASS (cuobjdump)
    from dpfx_torch.tools import sass_loops

    for line in sass_loops.report(sass_loops.disassemble("emd")):
        print(f"sass emd: {line}")
    # the Chamfer forward's element loops: 256 distances a trip (exact: 9
    # FP32 each, x.y unfused for the plain version's bits, and the two mins;
    # fast: 7, its bf16 products being exact)
    cd_sass = sass_loops.disassemble("chamfer")
    cd_loops = sass_loops.report(cd_sass, "fmnmx")
    for line in cd_loops:
        print(f"sass chamfer: {line}")
    check(any(ln.startswith("chamfer_kernel FAST=0 loop") for ln in cd_loops)
          and any(ln.startswith("chamfer_kernel FAST=1 loop") for ln in cd_loops),
          "the Chamfer kernel's element loop in its SASS")
    # the Chamfer backward's sweep: nnd_bwd_kernel's largest loop, one trip
    # a chunk of 8 rows x 32 columns a lane
    bwd_loops = [ln for ln in sass_loops.report(cd_sass, "all") if ln.startswith("nnd_bwd_kernel loop")]
    check(bool(bwd_loops), "the Chamfer backward's sweep loop in its SASS")
    sweep = max(bwd_loops, key=lambda ln: int(ln.split(": ")[1].split()[0]))
    print(f"sass nnd_bwd sweep: {sweep}; {int(sweep.split(': ')[1].split()[0]) / 256:.2f} issued "
          f"instructions an element")

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
            e_noise = float((u.cpu() - fs.philox_noise_plain(1234, 8, n, tau)).abs().max())
            x2 = fs.fused_sample_points(sp, z, 1234, n, dtype=torch.bfloat16,
                                        activation=pf.activation, noise_scale=tau)
            x3 = fs.fused_sample_points(sp, z, 1235, n, dtype=torch.bfloat16,
                                        activation=pf.activation, noise_scale=tau)
            print(f"kernel-vs-plain fused_sample N={n} tau={tau}: max_abs={emax:.3e} "
                  f"p99.9={e999:.3e} noise mean={mean:.4f} var/tau^2={var / tau**2:.4f}; noise "
                  f"against philox_noise_plain max_abs={e_noise:.3e}")
            check(emax <= TOL_BF16_MAX and e999 <= TOL_BF16_P999,
                  f"fused_sample vs plain inverse of its noise: max {emax}, p99.9 {e999}")
            check(e_noise <= TOL_NOISE, f"the kernel's noise is philox_noise_plain's ({e_noise})")
            # 49k draws: the standard errors are 0.0045 (mean) and 0.0064 (var)
            check(abs(mean) < 0.025 and abs(var / tau**2 - 1) < 0.035, "noise moments")
            check(torch.equal(x, x2), "same seed gives the same clouds")
            check(not torch.equal(x, x3), "another seed gives other clouds")
        # the round trip: the bf16 training forward, then the sampler's bf16
        # inverse with the same hz (flow_rows.cuh on both sides)
        check(pf.activation == "relu", "the training kernels take relu")
        xr = torch.randn((8, 3, n), generator=torch.Generator(device=dev).manual_seed(11),
                         device=dev)
        u_f, _ = ft.fused_forward_kernel(sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks,
                                         sp.scale_cap, xr, hz, torch.bfloat16)
        back = fs.fused_inverse_transposed(sp, u_f, z, dtype=torch.bfloat16, activation=pf.activation)
        torch.cuda.synchronize()
        e = (back - xr).abs().flatten()
        t_med, (t_max, t_999) = float(e.median()), errors(back, xr)
        print(f"round trip fused_train forward -> fused_inverse, bf16, B=8 N={n}: median "
              f"{t_med:.3e} p99.9 {t_999:.3e} max {t_max:.3e}, share above 1e-4 "
              f"{float((e > 1e-4).float().mean()):.2e} (|u - x| max {float((u_f - xr).abs().max()):.2f})")
        check(t_med <= TOL_TRIP_MEDIAN and t_max <= TOL_BF16_MAX,
              f"round trip N={n}: median {t_med}, max {t_max}")

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

    # the encoder's backward walks only the critical rows (those at some live
    # feature's max): every row critical (each cloud one point repeated) at a
    # ragged N and at one smaller than a tile, then the share of critical
    # rows at B=64 and the rows-design kernels' registers and spills
    for n in (2000, 77):
        xi = torch.randn((4, 1, 3), generator=g, device=dev).expand(4, n, 3).contiguous()
        for dtype in (torch.float32, torch.bfloat16):
            tol = TOL_GRAD_F32 if dtype == torch.float32 else TOL_GRAD_BF16
            pk, ck = fe.pool_forward_kernel(ews, ebs, xi, dtype)
            pp, cp = fe.pool_forward_plain(ews, ebs, xi, dtype)
            dg = torch.randn(pk.shape, generator=g, device=dev)
            got = fe.pool_backward_kernel(ews, ebs, xi, pk, ck, dg, dtype)
            again = fe.pool_backward_kernel(ews, ebs, xi, pk, ck, dg, dtype)
            ref = fe.pool_backward_plain(ews, ebs, xi, pp, cp, dg, dtype)
            torch.cuda.synchronize()
            eerr = {nm: rel(a, b) for nm, a, b in zip(enc_names, flat(got), flat(ref))}
            live = pk > 0
            crit = critical_rows(fe, ews, ebs, xi, pp, dtype)
            print(f"kernel-vs-plain fused_encoder, every row critical, B=4 N={n} {dtype}: "
                  f"critical rows {crit} of {4 * n}; pooled rel {rel(pk, pp):.3e}; grad rel "
                  + " ".join(f"{k}={v:.2e}" for k, v in eerr.items()))
            check(crit == 4 * n and bool((ck[live] == n).all()),
                  f"every row of identical points is critical ({crit} of {4 * n})")
            check(all(torch.equal(a, c) for a, c in zip(flat(got), flat(again))),
                  f"fused_encoder backward bit-identical, every row critical, N={n} {dtype}")
            check(rel(pk, pp) <= tol and max(eerr.values()) <= tol,
                  f"fused_encoder every row critical N={n} {dtype}: {rel(pk, pp)}, {eerr}")
    x64 = torch.randn((64, 2048, 3), generator=g, device=dev)
    p64, _ = fe.pool_forward_plain(ews, ebs, x64, torch.bfloat16)
    crit = critical_rows(fe, ews, ebs, x64, p64, torch.bfloat16)
    eregs = encoder_ptxas()
    print(f"fused_encoder critical rows at B=64 N=2048 bf16 (unit normal clouds): {crit} of "
          f"{64 * 2048} ({crit / (64 * 2048):.4f}); ptxas "
          + "; ".join(f"{k} {v.get('regs')} registers, spilled bytes (stores/loads) "
                      f"{v.get('spill')}" for k, v in eregs.items()))
    check(all("regs" in eregs.get(k, {}) for k in ("forward", "select", "walk")),
          f"ptxas reported the fused_encoder rows-design kernels: {eregs}")
    del x64, p64

    # ---- 2b'. the latent-flow kernels vs their plain versions at the flagship
    # latent widths: f32 on the block-wide kernels (B=130 a ragged last tile
    # over nine blocks), bf16 on clusters (B=130: nine groups of 16, the
    # last ragged, eight gradient slices)
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
                # the cluster kernels' round trip: forward and inverse run the
                # same conditioner code (`cond`) on the same passthrough
                # features, as phase 2's point-flow round trip
                back, _ = fl.latent_forward_kernel(lw, lmasks, cap, zi, dtype)
                trip = (back - z).abs()
                t_med, t_max = float(trip.median()), float(trip.max())
                plan = fl.cluster_plan(b, cfg.model.dz, lw["win"].shape[1], lw["wh"].shape[1],
                                       backward=True)
                print(f"fused_latent bf16 round trip fwd(inv(eps)) B={b}: median {t_med:.3e}, "
                      f"max {t_max:.3e}; backward plan {plan}")
                check(t_med <= TOL_TRIP_MEDIAN and t_max <= TOL_BF16_MAX,
                      f"fused_latent bf16 round trip B={b}: median {t_med}, max {t_max}")
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

    # ---- 3f. the probe tools at full width (bench_fused_bwd, probe_dual_issue)
    probe_rows = probe_tools_path(sp, dev, card)

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
    tb_ms = statistics.median(cuda_ms(lambda: ft.fused_backward_kernel(*tw, u_p, hz, du, dld, bf),
                                      10) for _ in range(3))
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
    # the rows design: the backward's select, walk and reduce apart (the
    # profiler's device time over 10 calls), the critical rows of this
    # batch and the FLOP the kernels issue beside the dense work of the bound
    _, _, evs = profiled(lambda: fe.pool_backward_kernel(ews, ebs, xc, pk, ck, dg, bf), 10)
    split = {part: sum(e.self_device_time_total for e in evs if key in e.key) / 10e3
             for part, key in (("select", "tile_kernel"), ("walk", "walk_kernel"),
                               ("reduce", "reduce_slices"))}
    check(all(v > 0 for v in split.values()), f"the profiler saw the encoder's backward: {split}")
    crit = critical_rows(fe, ews, ebs, xc, pp, bf)
    fwd_issued, bwd_issued = encoder_issued(widths, b, n, crit)
    macs = sum(widths[i] * widths[i + 1] for i in range(len(widths) - 1))
    eregs = encoder_ptxas()
    print(f"redesigned fused_encoder at B={b} N={n} bf16 (training batch): forward {ef_ms:.3f} ms "
          f"(first design: {FIRST_ENCODER_MS['fwd']:.3f} ms, {FIRST_ENCODER_MS['fwd'] / ef_ms:.2f}x), "
          f"bound {b_ef:.4f} ms ({ef_ms / b_ef:.1f}x); backward {eb_ms:.3f} ms (first design: "
          f"{FIRST_ENCODER_MS['bwd']:.3f} ms, {FIRST_ENCODER_MS['bwd'] / eb_ms:.2f}x), bound "
          f"{b_eb:.4f} ms ({eb_ms / b_eb:.1f}x): select {split['select']:.4f}, walk "
          f"{split['walk']:.4f}, reduce {split['reduce']:.4f} ms (profiler); critical rows {crit} "
          f"of {b * n} ({crit / (b * n):.4f}); FLOP issued forward {fwd_issued / 1e9:.2f} G, "
          f"backward {bwd_issued / 1e9:.2f} G (the bounds' dense work: "
          f"{2.0 * b * n * macs / 1e9:.2f} G and {6.0 * b * n * macs / 1e9:.2f} G); ptxas "
          + "; ".join(f"{k} {v.get('regs')} registers, spilled {v.get('spill')}"
                      for k, v in eregs.items()) + f" ({card})")
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
    # the redesigned point-flow kernels (mma.sync, register-held gradient
    # sums) beside the times of their first versions
    regs = train_ptxas()
    for kname, ms, old, bnd in (("fused_train_bwd", tb_ms, FIRST_TRAIN_MS["bwd"], b_tb),
                                ("fused_train_fwd", tf_ms, FIRST_TRAIN_MS["fwd"], b_tf)):
        r = regs.get(kname, {})
        check("regs" in r, f"ptxas reported the registers of {kname}'s bf16 kernel")
        shared = (f", before the body moved into flow_bwd_rows.cuh: {SHARED_BODY_BWD_MS:.3f} ms"
                  if kname == "fused_train_bwd" else "")
        print(f"redesigned {kname} at B={b} N={n} K={k} H={h} bf16: {ms:.3f} ms (first "
              f"design: {old:.3f} ms, {old / ms:.2f}x{shared}), bound {bnd:.4f} ms "
              f"({ms / bnd:.1f}x), {r['regs']} registers, spilled bytes (stores/loads) "
              f"{r.get('spill')} ({card})")
    # sharing the backward's body with the probe must not slow training: the
    # median of three timings within 3% (the spread between machines) of
    # the time before the body moved
    check(tb_ms <= TOL_SHARED_BWD * SHARED_BODY_BWD_MS,
          f"fused_train backward {tb_ms:.3f} ms against {SHARED_BODY_BWD_MS} ms before the body "
          f"moved into flow_bwd_rows.cuh (limit x{TOL_SHARED_BWD})")
    print(f"train step at 64 x 2048 with the redesigned kernels: {step_ms:.3f} ms/step (fused "
          f"point flow + fused encoder), fused latent flow off {off_ms:.3f}, on {on_ms:.3f} "
          f"ms/step (first design: 45.606 and 39.643); idle shares in phase 5b ({card})")
    print(f"kernel rates at B={b} N={n}: fused_inverse {flops / inv_ms / 1e9:.1f} TFLOP/s, "
          f"fused_sample {flops / smp_ms / 1e9:.1f} TFLOP/s ({card})")
    print(f"redesigned fused sampler (rows of 16 points per warp on mma.sync) at B={b} N={n} "
          f"bf16: fused_sample {smp_ms:.3f} ms (first design: {FIRST_SAMPLER_MS['fused_sample']:.3f} "
          f"ms, {FIRST_SAMPLER_MS['fused_sample'] / smp_ms:.2f}x), fused_inverse {inv_ms:.3f} ms "
          f"(first design: {FIRST_SAMPLER_MS['fused_inverse']:.3f} ms, "
          f"{FIRST_SAMPLER_MS['fused_inverse'] / inv_ms:.2f}x), int8 {int8_rows[0]['ms']:.3f} ms (first "
          f"design: {FIRST_SAMPLER_MS['fused_sample_int8']:.3f} ms), bound {b_smp:.4f} ms "
          f"({smp_ms / b_smp:.1f}x); the training forward {tf_ms:.3f} ms; ptxas "
          f"{sampler_ptxas()} ({card})")

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
    # the kernels on weights cast to bf16 once (as the sampler keeps them);
    # the cast per call, which a training step pays once for both, apart
    lwc = fl.cast_latent_weights(lw, bf)
    lf_ms = cuda_ms(lambda: fl.latent_forward_kernel(lwc, lmasks, cap, z, bf), 50)
    li_ms = cuda_ms(lambda: fl.latent_inverse_kernel(lwc, lmasks, cap, z, bf), 50)
    lb_ms = cuda_ms(lambda: fl.latent_backward_kernel(lwc, lmasks, cap, u_p, du, dld, bf), 20)
    cast_ms = cuda_ms(lambda: fl.cast_latent_weights(lw, bf), 50)
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
    # the redesigned latent kernels (a layer split across a cluster): every
    # plan of LATENT_PLANS held to the plain versions at B=64 and timed, the
    # default plan's times beside the first design's, with ptxas' registers
    lshape = (cfg.model.dz, lw["win"].shape[1], lw["wh"].shape[1])
    n_lat = lmasks.shape[0]
    sweep = {}
    for c_, g_ in LATENT_PLANS:
        row = {}
        for kname, bwd in (("fwd", False), ("inv", False), ("bwd", True)):
            try:
                plan = fl.cluster_plan(b, *lshape, bwd, c_, g_)
            except ValueError:
                row[kname] = "does not fit"
                continue
            if kname == "fwd":
                uu, ll = fl.latent_forward_kernel(lwc, lmasks, cap, z, bf, plan=plan)
                ok = rel(uu, u_p) <= TOL_GRAD_BF16 and rel(ll, ld_p) <= TOL_GRAD_BF16
                fn = lambda: fl.latent_forward_kernel(lwc, lmasks, cap, z, bf, plan=plan)
            elif kname == "inv":
                emax, e999 = errors(fl.latent_inverse_kernel(lwc, lmasks, cap, z, bf, plan=plan), zi_p)
                ok = emax <= TOL_BF16_MAX and e999 <= TOL_BF16_P999
                fn = lambda: fl.latent_inverse_kernel(lwc, lmasks, cap, z, bf, plan=plan)
            else:
                got = lat_flat(fl.latent_backward_kernel(lwc, lmasks, cap, u_p, du, dld, bf, plan=plan))
                ref = lat_flat(fl.latent_backward_plain(lw, lmasks, cap, u_p, du, dld, bf))
                ok = max(rel(a_, r_) for a_, r_ in zip(got, ref) if r_.numel()) <= TOL_GRAD_BF16
                del got, ref
                fn = lambda: fl.latent_backward_kernel(lwc, lmasks, cap, u_p, du, dld, bf, plan=plan)
            check(ok, f"fused_latent {kname} on clusters of {c_}, groups of {g_}, against the plain "
                      "version")
            row[kname] = round(cuda_ms(fn, 50 if kname != "bwd" else 20), 4)
        sweep[f"C={c_} G={g_}"] = row
    pf = fl.cluster_plan(b, *lshape, False)
    pb = fl.cluster_plan(b, *lshape, True)
    lregs = latent_ptxas()
    check(all("regs" in lregs.get(kk, {}) for kk in ("fwd", "inv", "bwd")),
          f"ptxas reported the fused_latent cluster kernels: {lregs}")
    print(f"redesigned fused_latent at B={b} K={n_lat} bf16 (a layer split across a cluster): "
          f"forward {lf_ms:.4f} ms (first design: {FIRST_LATENT_MS['fwd']:.3f} ms, "
          f"{FIRST_LATENT_MS['fwd'] / lf_ms:.2f}x), {lf_ms * 1e3 / n_lat:.2f} us/layer; inverse "
          f"{li_ms:.4f} ms (first design: {FIRST_LATENT_MS['inv']:.3f} ms, "
          f"{FIRST_LATENT_MS['inv'] / li_ms:.2f}x), {li_ms * 1e3 / n_lat:.2f} us/layer; backward "
          f"{lb_ms:.4f} ms (first design: {FIRST_LATENT_MS['bwd']:.3f} ms, "
          f"{FIRST_LATENT_MS['bwd'] / lb_ms:.2f}x), {lb_ms * 1e3 / n_lat:.2f} us/layer; plans: "
          f"forward and inverse (C, G) = ({pf.cluster}, {pf.group}) {pf.smem} B, backward "
          f"({pb.cluster}, {pb.group}) {pb.smem} B, {pb.slices} slices; the four weight casts a "
          f"call on f32 stacks would add {cast_ms:.4f} ms; times of every plan (ms) "
          f"{json.dumps(sweep)}; ptxas "
          + "; ".join(f"{kk} {v.get('regs')} registers, spilled bytes (stores/loads) "
                      f"{v.get('spill')}" for kk, v in lregs.items()) + f" ({card})")
    kernels += eval_kernel_rows(cfg, half_a, half_b, gen_launches, ae_launches)
    kernels += grad_rows + int8_rows + probe_rows
    check(len(kernels) == 24, f"{len(kernels)} kernel rows")
    print(json.dumps({"kernels": kernels}))

    # ---- 5. where the sampler's time goes (torch.profiler, 5 calls each)
    seeds = iter(range(10, 1000))
    for name, fn, kname in (("make_sampler(64, 2048)", sampler, "rows_kernel"),
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
        seen = lambda name: sum(name in e.key for e in dev_events)
        check(seen("fwd_kernel_mma") and seen("bwd_kernel_mma") and seen("tile_kernel") >= 2
              and seen("walk_kernel") and seen("reduce_slices")
              and (key == "off" or (seen("flow_kernel") and seen("bwd_kernel") >= 2)),
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
