#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port: build the kernels, hold each one
against its plain PyTorch version at the flagship widths, drive the main
paths (flagship sampling, flagship training, evaluation: the generation
suite and AE reconstruction, the differentiable distances, the int8
sampler, the two probe tools, single-view reconstruction's training and
evaluation, training from a packed stack through the native loader with
the montage and the checkpoint converter, and data parallel on the one
card) through the normal entry points, run the measurement and data
tools, and report.

Run from the root of a checkout, on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (each prints its result on its own line; any failure raises and the
script exits non-zero without a result line; `--dp-worker` runs one of
phase 3j's ranks, which the script starts itself):
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
  3b. the training path at full width: dpfx_torch.train's CLI on the
     flagship YAML as written (steps_per_call 20, device_resident) for 30
     steps of B=64 x N=2048 (data.synthetic_size cut to 512 clouds, a 25 MB
     resident split): one call of 20 replays of the captured step and a
     tail of 10, launch counts zeroed just before and read just after (the
     capture's eager warm-up steps plus one step's launches per replay);
     every logged loss and grad norm finite, no step skipped, the params
     moved, and the saved checkpoint sampled by dpfx_torch.generate; then
     the eager train step's time (CUDA events, batches on the card); the
     CLI again for 10 steps with train.fused_latent_flow=true on the same
     schedule and draws (one tail call; the same checks, the latent
     kernels launched, its loss windows held to the first run's); with the
     latent flow through the module and fused, on supplied noise: 20
     replays against 20 eager steps and a resident call against eager
     steps on the batches its draw chose, bit for bit (params, moments,
     count, step), and a replay on a batch holding an inf (skipped), then
     a good one; the eager, replayed and resident steps with the latent
     flow off and on, timed in turns (calls of 20); and one fused step,
     with and without the fused latent flow, against the module path on
     the same batch and noise;
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
  3h. single-view reconstruction (SVR) at the flagship widths
     (configs/flagship_svr_quality_resident.yaml: the mixer image encoder at
     64 px, patch 8, width 256, depth 4) and the ShapeNet npy layout:
     dpfx_torch.train's CLI on the YAML as written for 30 steps of B=64 x
     N=2048 (data.synthetic_size cut to 512: the clouds and the renders
     resident, a call of 20 replays and a tail of 10), launch counts zeroed
     just before and read just after (fused_train as in phase 3b, no
     fused_encoder launch), every logged loss and grad norm finite, no step
     skipped, the params moved; 20 replays and a resident call of the SVR
     step against eager steps bit for bit (images gathered with the clouds'
     ids), the replayed SVR step timed in turns with phase 3b's point
     step, and one replayed SVR call profiled (the point-flow kernels
     against the rest, the image encoder alone); dpfx_torch.evaluate on the
     checkpoint at --limit 64 (recon-cd, recon-emd, the per-category
     table; fused_sample, nnd_fwd and emd_batched launched); the conv
     backbone at 128 px for 10 steps in one call, and its replayed step's
     time; then a PointFlow npy tree written here (2 synsets x 3 splits x
     40 clouds of 2500 points) trained through
     configs/flagship_gen_npydir.yaml for 20 steps under the per_shape and
     the global frame, and, where pillow imports, 4 PNG views a model and
     the SVR YAML through shapenet_svr for 10 steps (ShapeNetH5 needs h5py,
     which the card's machine lacks: the CPU tests hold it);
  3i. the packed-stack training path (configs/flagship_quality_v3_aug_100k.yaml,
     data.synthetic_size 512): `python -m dpfx_torch.tools.pack_dataset`
     as a child process (a [512, 4096, 3] stack, 25 MB, and its sidecar),
     the native loader alone at 64 x 2048 with 2 workers (batches/s beside
     the replayed step's), dpfx_torch.train's CLI with
     data.device_resident=false and data.packed_path for 30 steps (a call
     of 20 replays and 10 eager steps; launch counts zeroed just before and
     read just after, as on the resident path; the "native loader" line;
     finite losses, no step skipped, the params moved, its first 5-step
     loss window and its final validation held to phase 3b's), a call of 20 replays on packed host
     batches (20 from the loader, np.stack, one copy) timed in turns with
     the resident call and each profiled once (idle share), the host parts
     of a packed call timed apart; then `dpfx_torch.generate --png` on the
     run's checkpoint (a 16 x 128 by 3 x 128 montage, not blank;
     fused_sample launched) and the weights written in the reference
     layout and converted back by `python -m dpfx_torch.convert_checkpoint`
     (a child process): equal bit for bit, and make_sampler(64, 2048) gives
     the same clouds bit for bit from both;
  3j. data parallel at the flagship's width (global B=64, N=2048, the
     512-cloud split): (a) NCCL with one rank, the step's all-reduce
     captured in the graph: resident calls of 20 replays against calls with
     no group, replicated and sharded (the gather the identity), params,
     moments, count and step bit for bit, equal fused_train and
     fused_encoder launches, the ms/step of each in turns; (b) two gloo
     ranks sharing the card (child processes, `chip_smoke.py --dp-worker`),
     B/D=32, three eager resident steps, replicated then sharded, against
     one process on the same weights: each rank's x, eps and xnoise the
     one-process step's rows bit for bit (the sharded gather's too), step
     1's all-reduced gradient within phase 2's bf16 gradient limit per
     tensor, step 1's loss within 1e-5 (and a step with the fused latent
     flow), steps 2-3 and the parameters printed, a multi-step of 20 under
     the gloo group refused; (c) the rank-sharded sampler's 64 clouds
     (module and fused latent inverse) equal make_sampler on each rank's
     seeds, the row-sharded CD and EMD (fast) matrices against 64 test
     clouds equal one process's bit for bit, MMD/COV/1-NNA equal, every
     kernel of the path launched on each rank (counts from 0 in each
     child); (d) the training CLI asked for one card more than are visible
     raises, naming the visible count; the flat gradient's bytes, the
     sharded gather's bytes a step and each rank's resident MB printed
     beside the card;
  3l. (after 3j) the kernels' widths and depths off the flagship's grid
     (phase 2's weights, the noise scaled by sqrt(128 / H)): fused_train
     at K=32, B=8, N=2048 on every layout past the mma and block-wide ones
     (H=128 with n_hidden 3-4, H=256 with n_hidden 2-4 in bf16, 1-4 in
     f32) and the padded widths 96 and 192, each on the layout _layout
     picks (f32: the f32 layout at H = 128 and 256) and held to its plain
     version by phase 2's rules (f32's backward, whose 32-layer walk is
     ill-conditioned on these flows, to an f64 run of the plain version as
     phase 3f holds its f32 kernels, with a TF32 control), twice
     bit-identical; the f32 layout's forward against the block-wide one's
     bits at H=128 (n_hidden 1-2); the sampler's f32 layout at H=256
     (n_hidden 1-4) and
     the padded widths 96 and 192 in both dtypes (bf16 relu at H=256 on
     the cluster inverse), the int8 f32 mode equal
     to the dequantized stacks; the latent flow at dz=24 (padded to 32)
     through the kernels and fused_latent_inverse; the encoder at point
     widths (120, 200), padded to (128, 208), against the plain versions
     and the module; ptxas of the new layouts; then (a) the flagship with
     model.point_flow.hidden=256 through the training CLI (10 steps as one
     resident call, launches counted, every loss finite), its step against
     the module path (TOL_STEP_LOSS, TOL_STEP_GNORM), its replayed step
     timed in turns with phase 3b's, make_sampler(64, 2048) and
     `evaluate --limit 64` on its checkpoint (every sampler launch on the
     cluster inverse, counted by layout), and the cluster layout's
     kernels at B=64 against the plain versions, timed, with their bounds;
     the round trip fwd_cluster -> inv_cluster on the same hz
     (TOL_TRIP_MEDIAN, TOL_BF16_MAX), inv_cluster's noise against
     philox_noise_plain, its time in turns with rows_kernel<256>, and at
     each shape of the cluster inverse (K=32, B=64) the cluster inverse
     against its plain version and in turns with rows_kernel, the route's
     choice beside them; and the other cases the route takes there
     (inverse_cases: gelu, tanh, leaky_relu, the int8 mode with relu and
     gelu; every one at H=256) through fused_sample_points, each against
     its plain version (int8: on the dequantized stacks, and bit for bit
     the bf16 mode there on the same layout), twice bit-identical, timed in
     turns with rows_kernel, with its bound (int8's weights at 1 byte); (a2)
     the deep conditioners (DEEP_SHAPES: H=128
     with n_hidden 3-4, H=256 with n_hidden 3-4; all but the first stream
     the backward's Wh through the ring) at B=64 x 2048, K=32 against the plain versions,
     twice bit-identical, timed with their bounds, and the flagship at
     H=256 with n_hidden 4 through the training CLI (10 steps as one
     resident call, fused and on the module path from the same seeded
     weights: both finite with loss windows within TOL_TRAIN_DRIFT, or both
     non-finite from the same step; every fused launch on the cluster
     layout), then the bf16 sampler at H=256 through its entry points,
     every launch on the cluster inverse: generate on that fused run's
     checkpoint, make_sampler(64, 2048) on a seeded gelu model at n_hidden
     2, bench_sample_int8 --run-flow on the same checkpoint (B=64, reps 2);
     (b) config #3 (shapenet_airplane_gen.yaml, f32 point flow) at H=256 and
     at its own width (H=128, n_hidden 2) on the synthetic family: the
     training CLI's 10 steps as one resident call on config #3's own
     schedule with the fused point flow and with the module path from the
     same seeded weights (both finite with their loss windows within
     TOL_TRAIN_DRIFT, or both non-finite from the same step, and then the
     pair on the flagship's schedule, F32_SCHEDULE, finite); the fused run
     that stays finite with every fused_train launch on the f32 layout and
     every loss finite, its step against the module path; the f32 sampler
     and `evaluate --limit 32` on the H=256 checkpoint; the f32 layout's
     forward and backward at B=64 x 2048, K=32 on seeded weights at H=256
     and on the H=128 checkpoint's trained weights against f64 runs of the
     plain versions, twice bit-identical, timed with their bounds; the round trip
     fwd_f32 -> f32_kernel on the same hz (F32_TRIP); the sampler's kernel
     at B=64 against the plain version, timed; (c) latcap
     with train.fused_latent_flow=true (10 steps), the sampler under
     DPFX_SAMPLE_FUSED_LATENT=1 and its latent kernels at B=64 timed;
  3m. (after 3l) CD and EMD at 15,000 points a cloud, on the large-cloud
     layout: a PC15k-layout tree of 15,000-point clouds (64 train, 32 val,
     32 test over five synsets: data.category=all) written by
     make_synthetic_shapenet, 4 training steps of
     configs/shapenet_airplane_ae_emd.yaml and shapenet_airplane_gen.yaml
     through the training CLI at their n_points 2048 (the flagship's
     warmup and clip), then dpfx_torch.evaluate at data.n_points_eval=15000:
     AE reconstruction (recon-cd, recon-emd) over the 32 test clouds and the
     generation suite at --limit 16, finite; 3 descent steps on chamfer +
     emd of 4 test clouds, lowering both; launch counts zeroed just before
     and read just after, every CD and EMD launch on the large layout
     (chamfer.layouts, emd.layouts); then each large-layout kernel against
     its plain version, twice bit-identical, timed with its bound: nnd_fwd
     and nnd_bwd at B=32, N=M=15,000 and 15,000 x 4,500 (minima and
     gradients bit for bit the plain version's and onepass_bwd_plain's, the
     pairs by path), cd_pairwise exact and fast at 8 x 8 (bit for bit the
     mirror of its order, large_plain), emd at B=8 (emd_sweeps_plain and
     emd_plain by phase 2c's limits), the gradient mode (its cost bit for
     bit the plain launch's, its gradients against an f64 run as phase 3d's
     ragged batch), emd_pairwise fast and exact at 4 x 4, in turns;
  3k. (run after 5c: its trace is held to phase 5b's) the tools of
     dpfx_torch.tools at the flagship widths, in turn in one child process,
     each counting its launches from 0 and printing them last, each required to
     have launched its kernels: bench_kernels (reps 5; every key finite),
     bench_serving (B = 1, 16, 64, 1024, reps 5), prof_train (all twelve
     pieces as CUDA-graph replays, reps 5, each with its device-busy ms),
     bench_batch_sweep (B = 64, 128, 256, reps 5; MFU finite and in (0, 1]),
     bench_sample_int8 on phase 3b's checkpoint (its int8 error printed
     beside the checkpoint's bf16-against-f32 clouds), quality_oracle on the
     flagship YAML (data.synthetic_size 512, --limit 128) with phase 3c's
     gates (train-vs-test 1-NNA in [0.35, 0.65], noise-vs-test >= 0.9),
     make_synthetic_shapenet (a 20/5/5 tree with 3 PNG views a model) read
     back by build_dataset as shapenet_npy_dir and shapenet_svr,
     part_count_pin on phase 3's sampled clouds (--limit 128), a
     utils.profiling.trace around one replayed call of 20 steps read by
     parse_trace (its device total within 5% of phase 5b's busy time for
     such a call); then the phase's wall time;
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
     rows of phases 3d, 3e, 3f, 3l and 3m (62 rows in all: 24 of the cluster
     inverse's cases, 6 of the large-cloud layout's);
  5. torch.profiler breakdowns of make_sampler(64, 2048) (plain and fused
     latent inverse), of 5 eager train steps and (5b) of one replayed and
     one resident call of 20 steps (fused latent flow off and on), and
     (5c) of one generation suite at S=128: device-busy time, idle share,
     kernels per call or step and the kernels that take the time;
  6. (after phase 3k) the card line again, then the last line:
     {"ok": true, "device": {...}}.
It needs no network and starts no process that outlives it (nvcc and
nvidia-smi are waited for).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import statistics
import subprocess
import sys
import time
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CONFIG = ROOT / "configs" / "flagship_quality_v3_aug_100k.yaml"
AE_CONFIG = ROOT / "configs" / "flagship_ae_quality_synthetic.yaml"
SVR_CONFIG = ROOT / "configs" / "flagship_svr_quality_resident.yaml"
NPYDIR_CONFIG = ROOT / "configs" / "flagship_gen_npydir.yaml"
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
# the packed-stack run (phase 3i) against phase 3b's resident run: the same
# initial weights, schedule and noise (keyed by the step), other batches of
# the same 512 clouds (the native loader's draws against the resident
# draw; with 2 workers the loader's order depends on scheduling, so every
# run draws others). Its first 5-step loss window, taken on near-identical
# weights, is held to TOL_TRAIN_DRIFT (seen: 7.6e-4 to 2.3e-3 in three
# runs); after it the random flagship's first steps (grad norms up to 5e7)
# carry the two batch streams apart (the second window seen 3% to 129%
# apart: not held). The final validation neg-ELBO per point on the same
# 128 clouds and noise may be worse than the resident run's by at most this
# share (seen: 0.895x to 1.027x in three runs; a model trained on wrong
# points validates far worse)
TOL_PACKED_VAL = 0.25
TRAIN_STEPS = 30
# validation batches of the training runs: data.synthetic_size 512 gives
# 128 val clouds, eval.batch_size 32
VAL_BATCHES = 4
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


def train_bounds_f32(sp, b: int, n: int):
    """The f32 pair on the CUDA cores: one FP32 FMA instruction per product
    term (train_bounds' FLOP halved) over the FP32 instruction rate, against the
    bytes of its inputs and outputs with the weights in f32."""
    k, h, _ = sp.wx.shape
    nh1 = sp.wh.shape[1]
    nw = k * (3 * h + nh1 * h * h + 6 * h)
    small = 4 * k * (nh1 * h + 6 + 3)
    fwd = bound_cores(1.0 * b * n * k * (9 * h + nh1 * h * h), 0.0,
                      2 * 12 * b * n + 4 * b * k * h + 4 * nw + small + 4 * b)
    bwd = bound_cores(1.0 * b * n * k * (27 * h + 3 * nh1 * h * h), 0.0,
                      3 * 12 * b * n + 2 * 4 * b * k * h + 4 * b + 4 * nw + small
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


def cluster_ptxas() -> dict:
    """Registers and spilled bytes (stores/loads) of the cluster layout's
    instances (``fwd_cluster<H, n_hidden-1>``, ``bwd_cluster<...>``), keyed
    "fused_train_{fwd,bwd} cluster H=.. n_hidden=..", from ptxas' log."""
    import re

    from dpfx_torch.ops import _build

    found, cur = {}, None
    for line in _build.ptxas_log("fused_train").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(fwd|bwd)_clusterILi(\d+)ELi(\d+)E", line)
            cur = (f"fused_train_{m.group(1)} cluster H={m.group(2)} n_hidden={int(m.group(3)) + 1}"
                   if m else None)
        elif cur and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            found.setdefault(cur, {})["spill"] = f"{st}/{ld}"
        elif cur and "Used" in line:
            found.setdefault(cur, {})["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return found


def f32_layout_ptxas() -> dict:
    """Registers and spilled bytes (stores/loads) of the f32 layout's
    instances (``fwd_f32<H>``, ``bwd_f32<H, T>``), keyed "fused_train_{fwd,
    bwd} f32 H=.." (and " T=.." for the backward), from ptxas' log."""
    import re

    from dpfx_torch.ops import _build

    found, cur = {}, None
    for line in _build.ptxas_log("fused_train").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"(fwd|bwd)_f32ILi(\d+)E(?:Li(\d+)E)?", line)
            cur = (f"fused_train_{m.group(1)} f32 H={m.group(2)}"
                   + (f" T={m.group(3)}" if m.group(3) else "") if m else None)
        elif cur and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            found.setdefault(cur, {})["spill"] = f"{st}/{ld}"
        elif cur and "Used" in line:
            found.setdefault(cur, {})["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return found


def inverse_ptxas() -> dict:
    """Registers and spilled bytes (stores/loads) of every cluster inverse
    instance, keyed "inv_cluster<H, NH1, Act, W>", from ptxas' log."""
    import re

    from dpfx_torch.ops import _build

    found, cur = {}, None
    for line in _build.ptxas_log("fused_sampler").splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"inv_clusterILi(\d+)ELi(\d+)ENS_\d+([A-Za-z]+)E(13__nv_bfloat16|a|v)E",
                          line)
            cur = (f"inv_cluster<{m.group(1)}, {m.group(2)}, {m.group(3)}, "
                   f"{ {'a': 'int8', 'v': 'bf16 or int8'}.get(m.group(4), 'bf16')}>" if m else None)
        elif cur and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            found.setdefault(cur, {})["spill"] = f"{st}/{ld}"
        elif cur and "Used" in line:
            found.setdefault(cur, {})["regs"] = int(re.search(r"Used (\d+) registers", line).group(1))
    return found


def sampler_ptxas(instance: str = "rows_kernelI13__nv_bfloat16Li128ELb1ELb1E") -> str:
    """Registers and spilled bytes of one instance of the fused sampler
    (its mangled name; by default the flagship's: bf16 weights, H=128,
    relu, two stages), from ptxas' log."""
    import re

    from dpfx_torch.ops import _build

    cur, out = "", {}
    for line in _build.ptxas_log("fused_sampler").splitlines():
        if "Compiling entry function" in line:
            cur = line
        elif instance in cur:
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
SVR_EVAL_LIMIT = 64           # test clouds of the SVR evaluation
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
    mma kernels at hidden h, from ptxas' log of fused_train.cu."""
    import re

    from dpfx_torch.ops import _build

    pat = rf"(fwd|bwd)_kernel_mmaILi{h}E"
    found, cur = {}, None
    for line in _build.ptxas_log("fused_train").splitlines():
        if "Compiling entry function" in line:
            m = re.search(pat, line)
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


def train_cli_run(argv, scale: float = 0.02, flax: bool = True, seed=None):
    """``python -m dpfx_torch.train``'s main in this process, its model
    initialised to seeded random weights off the identity (a check on
    identity couplings passes whatever the math): flax's initialisation
    plus noise of ``scale``, or (``flax=False``) the modules' own, as phase
    2's models; each call of its loop recorded. The modules' own init draws
    from the global generator: with ``seed`` it is seeded first (in a fork,
    the caller's stream left as it was), so two runs start from the same
    weights. Returns (exit code, what it printed, [(steps, per-step losses)]
    a call, the initial weights)."""
    import contextlib
    import io

    import torch

    from dpfx_torch.compat import randomize_
    from dpfx_torch.train import __main__ as train_cli
    from dpfx_torch.train import trainer as tm

    init_weights, calls = {}, []
    flax_init, record = tm.init_params_, tm._Cadence.record

    def init_then_randomize(m, seed):
        randomize_(flax_init(m, seed) if flax else m, seed, scale)
        init_weights.update({k: v.detach().clone() for k, v in m.state_dict().items()})
        return m

    def recording(self, took, metrics, points_per_step):
        calls.append((took, metrics["loss"].reshape(-1).clone()))
        return record(self, took, metrics, points_per_step)

    out = io.StringIO()
    tm.init_params_, tm._Cadence.record = init_then_randomize, recording
    try:
        with contextlib.redirect_stdout(out), (
                contextlib.nullcontext() if seed is None else torch.random.fork_rng(devices=[])):
            if seed is not None:
                torch.manual_seed(seed)
            rc = train_cli.main(argv)
    finally:
        tm.init_params_, tm._Cadence.record = flax_init, record
        print(out.getvalue(), end="")
    return rc, out.getvalue(), [(k, v.tolist()) for k, v in calls], init_weights


def same_state(a, b) -> bool:
    """Two train states equal bit for bit: params, moments, count, step."""
    import torch

    return all(torch.equal(u, v) for u, v in (
        (a.params, b.params), (a.opt_state.mu, b.opt_state.mu), (a.opt_state.nu, b.opt_state.nu),
        (a.opt_state.count, b.opt_state.count), (a.step, b.step)))


def captured_step_checks(c, dev, clouds, x20, name: str, images=None, img20=None):
    """The captured train step at full width with the latent flow as ``c``
    sets it: 20 replays against 20 eager steps on the same batches and
    supplied noise, a resident call of 20 against eager steps on the
    batches and noise its draw chose (both bit for bit: params, moments,
    count, step), and a replay on a batch holding an inf (skipped), then a
    good one (finite). For SVR, ``img20`` holds the batches' images and
    ``images`` the resident render stack, gathered with the clouds' ids.
    Returns ((multi-step, its state), (resident call, its state)) for the
    timings."""
    import torch

    from dpfx_torch.compat import randomize_
    from dpfx_torch.models import DPF
    from dpfx_torch.train import trainer as tm

    def fresh():
        m = randomize_(tm.init_params_(DPF(c), 1), 1, 0.02).to(dev)
        tx = tm.make_optimizer(c.train)
        return m, tx, tm.init_state(m, tx)

    k = x20.shape[0]
    g = torch.Generator(device=dev).manual_seed(12)
    eps = torch.randn((k, x20.shape[1], c.model.dz), generator=g, device=dev)
    xn = torch.randn(x20.shape, generator=g, device=dev)
    img = (lambda i: {}) if img20 is None else (lambda i: {"image": img20[i]})  # noqa: E731
    m, tx, eager = fresh()
    step = tm.make_train_step(m, tx, c)
    for i in range(k):
        eager, _ = step(eager, {"x": x20[i], "eps": eps[i], "xnoise": xn[i], **img(i)})
    m2, tx2, rep = fresh()
    multi = tm.make_multi_step(m2, tx2, c)
    rep, mr = multi(rep, {"x": x20, "eps": eps, "xnoise": xn, **img(slice(None))})
    torch.cuda.synchronize()
    check(same_state(rep, eager) and rep.host_step == eager.host_step == k,
          f"{k} replays equal {k} eager steps bit for bit ({name})")
    del m, eager, step

    s, p = clouds.shape[:2]
    m3, tx3, res = fresh()
    resident = tm.make_resident_multi_step(m3, tx3, c)
    res, _ = resident(res, clouds, k, images=images)
    m4, tx4, eager = fresh()
    ci, pi, reps, rxn = tm.resident_draw(c, 0, k, s, p, dev)
    xr = tm.gather_resident(clouds, ci, pi)
    step = tm.make_train_step(m4, tx4, c)
    for i in range(k):
        eager, _ = step(eager, {"x": xr[i], "eps": reps[i],
                                **({} if rxn is None else {"xnoise": rxn[i]}),
                                **({} if images is None else {"image": images[ci[i]]})})
    torch.cuda.synchronize()
    check(same_state(res, eager), f"a resident call equals eager steps on its draws ({name})")
    del m4, eager, step, xr

    bad = x20[:1].clone()
    bad[0, 1, 5, 0] = float("inf")
    held = lambda st: (st.params, st.opt_state.mu, st.opt_state.nu, st.opt_state.count)  # noqa: E731
    before = [t.clone() for t in held(rep)]
    at = int(rep.step)
    rep, mb = multi(rep, {"x": bad, "eps": eps[:1], "xnoise": xn[:1], **img(slice(0, 1))})
    torch.cuda.synchronize()
    kept = all(torch.equal(a, b) for a, b in zip(held(rep), before))
    check(float(mb["nonfinite_skipped"][0]) == 1.0 and kept and int(rep.step) == at + 1,
          f"a replay on a batch holding an inf skips ({name})")
    rep, mg = multi(rep, {"x": x20[1:2], "eps": eps[1:2], "xnoise": xn[1:2], **img(slice(1, 2))})
    check(float(mg["nonfinite_skipped"][0]) == 0.0 and bool(torch.isfinite(mg["loss"]).all())
          and int(rep.opt_state.count) == int(before[3]) + 1,
          f"the replay after the skipped one is finite and counts ({name})")
    print(f"captured step, {name}, 64 x 2048: {k} replays equal {k} eager steps bit for bit "
          f"(params, mu, nu, count, step; losses {float(mr['loss'][0]):.2f} .. "
          f"{float(mr['loss'][-1]):.2f}); a resident call of {k} equals eager steps on the "
          f"batches and noise its draw chose, bit for bit; a replay on a batch holding an inf "
          f"skipped (params, moments, count kept; step {at} -> {at + 1}), the next replay "
          f"finite (loss {float(mg['loss'][0]):.2f})")
    return (multi, rep), (resident, res)


def svr_train_run(argv, run_dir: Path, steps: int, n_calls):
    """Phase 3h's training CLI runs: ``train_cli_run`` with the checks
    every run shares (exit code, the calls and log records, one final
    evaluation, every logged loss and grad norm finite, no step skipped,
    every parameter moved). Returns (what it printed, the train records,
    the per-call losses, the wall seconds)."""
    import torch

    t0 = time.perf_counter()
    rc, text, calls, init_weights = train_cli_run(argv)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in records if r["kind"] == "val"]
    records = [r for r in records if r["kind"] == "train"]
    check(rc == 0 and [k for k, _ in calls] == n_calls and records and records[-1]["step"] == steps,
          f"train calls {calls}, records {records}")
    check([r["step"] for r in val] == [steps] and finite_numbers(val[0]),
          f"one final evaluation, finite: {val}")
    check("ignored" not in text, "the CLI trains the YAML as written")
    check(all(math.isfinite(r["loss"]) and math.isfinite(r["grad_norm"]) for r in records),
          f"every logged loss and grad norm is finite: {records}")
    check(all(r["nonfinite_skipped"] == 0 for r in records), "no step was skipped")
    trained = torch.load(run_dir / f"params_{steps:08d}.pt", map_location="cpu", weights_only=True)
    moved = sum(not torch.equal(trained[k], v) for k, v in init_weights.items())
    check(moved == len(init_weights), f"{moved} of {len(init_weights)} parameters moved")
    return text, records, calls, wall


def svr_path(dev, card, point_replayed):
    """Phase 3h: single-view reconstruction at the flagship widths and the
    ShapeNet npy layout. ``point_replayed`` is phase 3b's [replayed call of
    20 point-modality steps, its state], timed in turns with the SVR step."""
    import shutil
    from importlib.util import find_spec

    import numpy as np
    import torch

    from dpfx_torch.compat import randomize_
    from dpfx_torch.config import load_config
    from dpfx_torch.data import (SYNSET_IDS, SyntheticDataset, build_dataset, iterate_batches,
                                 preload_clouds, preload_images)
    from dpfx_torch.models import DPF
    from dpfx_torch.ops import chamfer as cdk
    from dpfx_torch.ops import emd as emdk
    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_latent as fl
    from dpfx_torch.ops import fused_sampler as fs
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.train import trainer as tm

    counts = lambda mods: {k: v for m in mods for k, v in m.launches.items()}  # noqa: E731
    train_mods = (ft, fe, fl)
    cfg = load_config(str(SVR_CONFIG))
    ie = cfg.model.image_encoder
    check(cfg.experiment == "svr" and (ie.arch, ie.image_size, ie.patch, ie.width, ie.depth)
          == ("mixer", 64, 8, 256, 4) and cfg.model.point_flow.n_layers == 32
          and cfg.train.fused_point_flow and not cfg.train.fused_encoder,
          "the flagship SVR YAML: mixer 64 px, patch 8, width 256, depth 4; fused point flow")

    def launch_checks(launches, steps, val_batches, what):
        for kname, count in launches.items():
            want = (0 if not kname.startswith("fused_train") else
                    tm._WARMUP + steps + (val_batches if kname.endswith("fwd") else 0))
            check(count == want, f"kernel {kname}: {count} launches on {what} (want {want}: "
                                 f"{tm._WARMUP} warm-up steps, {steps} steps, {val_batches} "
                                 "evaluation batches; the image posterior launches no encoder "
                                 "kernel)")

    # SVR training through the CLI on the YAML as written (mixer), cut to
    # 512 clouds and 30 steps: a resident call of 20 replays and a tail of 10
    run_root = WORK / "train_svr"
    shutil.rmtree(run_root, ignore_errors=True)
    for m in train_mods:
        m.reset_launch_counts()
    text, records, calls, wall = svr_train_run(
        [str(SVR_CONFIG), f"train.steps={TRAIN_STEPS}", "train.log_every=5",
         f"train.ckpt_every={TRAIN_STEPS}", f"train.ckpt_dir={run_root}",
         "data.synthetic_size=512"], run_root / cfg.name, TRAIN_STEPS, [20, TRAIN_STEPS - 20])
    train_launches = counts(train_mods)
    check("images=64px" in text and "device-resident split: 512 clouds x 2048 stored pts (13 MB"
          in text and "+ renders 64x64x3 (25 MB); steps_per_call=20" in text,
          "the SVR CLI preloads both stacks and prints their MB")
    launch_checks(train_launches, TRAIN_STEPS, VAL_BATCHES, "the SVR training path")
    trained_pt = run_root / cfg.name / f"params_{TRAIN_STEPS:08d}.pt"
    print(f"SVR training path (mixer 64 px, B=64 x 2048): {TRAIN_STEPS} steps (calls "
          f"{[k for k, _ in calls]}, resident clouds and renders) in {wall:.1f} s wall; launches "
          f"{json.dumps(train_launches)}; loss " + ", ".join(f"{r['loss']:.1f}" for r in records)
          + "; grad norm " + ", ".join(f"{r['grad_norm']:.1f}" for r in records) + "; points/s "
          + ", ".join(f"{r['points_per_sec']:,.0f}" for r in records))

    # the captured SVR step: replays and a resident call against eager steps,
    # bit for bit, on supplied noise
    dcfg = load_config(str(SVR_CONFIG), overrides=["data.synthetic_size=512"]).data
    train_ds = build_dataset(dcfg, "train", ie.image_size)
    host = [bt for bt, _ in zip(iterate_batches(train_ds, 64, 2048, seed=5, with_images=True),
                                range(4))]
    x20 = torch.stack([torch.from_numpy(host[i % 4]["x"]) for i in range(20)]).to(dev)
    img20 = torch.stack([torch.from_numpy(host[i % 4]["image"]) for i in range(20)]).to(dev)
    clouds = torch.from_numpy(preload_clouds(train_ds)).to(dev)
    images = torch.from_numpy(preload_images(train_ds)).to(dev)
    (multi, rstate), _ = captured_step_checks(cfg, dev, clouds, x20, "SVR, mixer", images=images,
                                              img20=img20)
    svr_replayed = [lambda st: multi(st, {"x": x20, "image": img20}), rstate]
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed_call(timer):
        torch.cuda.synchronize()
        start.record()
        timer[1], _ = timer[0](timer[1])
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20

    turns = [timed_call(t) for t in (point_replayed, svr_replayed, svr_replayed, point_replayed)]
    point_ms, svr_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"replayed step at 64 x 2048 (calls of 20, in turns): SVR (mixer 64 px) {svr_ms:.3f} "
          f"ms/step, point modality (fused encoder) {point_ms:.3f} ms/step; turns "
          + ", ".join(f"{t:.3f}" for t in turns) + f" ({card})")

    # where the replayed SVR step's time goes: the point-flow kernels against
    # the rest, and the image encoder's forward and backward alone
    def svr_call():
        svr_replayed[1], _ = svr_replayed[0](svr_replayed[1])

    wall_us, busy_us, dev_events = profiled(svr_call, 1)
    flow_us = sum(e.self_device_time_total for e in dev_events
                  if "fwd_kernel_mma" in e.key or "bwd_kernel_mma" in e.key)
    check(flow_us > 0, "the profiler saw the point-flow kernels in a replayed SVR call")
    top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
    enc = randomize_(DPF(cfg).image_encoder, 3, 0.02).to(dev)

    def enc_step():
        mu, logvar = enc(img20[0])
        torch.autograd.grad(mu.sum() + logvar.sum(), list(enc.parameters()))

    enc_ms = cuda_ms(enc_step, 20, warmup=1)
    _, enc_busy_us, _ = profiled(enc_step, 5)
    print(f"profile replayed SVR call of 20 steps: wall {wall_us / 20e3:.3f} ms/step, device busy "
          f"{busy_us / 20e3:.3f} ms/step, idle share {1 - busy_us / wall_us:.3f}; point-flow "
          f"kernels (fwd_kernel_mma, bwd_kernel_mma) {flow_us / 20e3:.3f} ms/step, the rest "
          f"(image encoder, latent flow, optimizer) {(busy_us - flow_us) / 20e3:.3f} ms/step; the "
          f"image encoder's forward and backward alone (eager, B=64): device busy "
          f"{enc_busy_us / 5e3:.3f} ms, {enc_ms:.3f} ms on CUDA events; "
          f"{sum(e.count for e in dev_events) / 20:.1f} kernels/step; top: "
          + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 20e3:.3f} ms x{e.count / 20:g}"
                      for e in top) + f" ({card})")
    del multi, svr_replayed, clouds, images

    # SVR evaluation through the CLI on the trained checkpoint
    eval_mods = (fs, cdk, emdk, ft, fe)
    for m in eval_mods:
        m.reset_launch_counts()
    rc, res, res_t, res_wall = run_eval_cli([str(SVR_CONFIG), "--weights", str(trained_pt),
                                             "--limit", str(SVR_EVAL_LIMIT)])
    eval_launches = {k: v for k, v in counts(eval_mods).items() if v or k.startswith("fused_enc")}
    check(rc == 0 and set(res) == {"step", "n_test", "recon-cd", "recon-emd", "per_category"}
          and res["n_test"] == SVR_EVAL_LIMIT and res["step"] == TRAIN_STEPS
          and finite_numbers(res), f"SVR results {res}")
    check(len(res["per_category"]) == 5, f"the per-category table: {sorted(res['per_category'])}")
    for k in ("fused_sample", "nnd_fwd", "emd_batched"):
        check(eval_launches.get(k, 0) > 0, f"kernel {k} was not launched on the SVR evaluation path")
    check(all(v == 0 for k, v in eval_launches.items() if k.startswith("fused_enc")),
          f"no encoder kernel on the SVR evaluation path: {eval_launches}")
    print(f"SVR evaluation on the {TRAIN_STEPS}-step checkpoint, {SVR_EVAL_LIMIT} test clouds: "
          f"recon-cd {res['recon-cd']:.5f}, recon-emd {res['recon-emd']:.5f}, per category "
          + json.dumps({k: round(v["recon-cd"], 5) for k, v in res["per_category"].items()})
          + f"; {res_t['total']:.3f} s ({res_wall:.2f} s with restore and renders); launches "
          f"{json.dumps(eval_launches)}")

    # the conv backbone (configs/shapenet_airplane_svr.yaml's: 128 px), one call of 10
    conv_over = ["model.image_encoder.arch=conv", "model.image_encoder.image_size=128"]
    conv_root = WORK / "train_svr_conv"
    shutil.rmtree(conv_root, ignore_errors=True)
    for m in train_mods:
        m.reset_launch_counts()
    text, crecords, _, cwall = svr_train_run(
        [str(SVR_CONFIG), *conv_over, "train.steps=10", "train.log_every=5",
         f"train.lr_decay_steps={TRAIN_STEPS}", "train.ckpt_every=10",
         f"train.ckpt_dir={conv_root}", "data.synthetic_size=512"], conv_root / cfg.name, 10, [10])
    conv_launches = counts(train_mods)
    check("+ renders 128x128x3 (101 MB)" in text, "the conv run preloads 128 px renders")
    launch_checks(conv_launches, 10, VAL_BATCHES, "the conv SVR training path")
    ccfg = load_config(str(SVR_CONFIG), overrides=conv_over + ["data.synthetic_size=512"])
    cds = build_dataset(ccfg.data, "train", 128)
    chost = [bt for bt, _ in zip(iterate_batches(cds, 64, 2048, seed=6, with_images=True),
                                 range(4))]
    cx = torch.stack([torch.from_numpy(chost[i % 4]["x"]) for i in range(20)]).to(dev)
    cimg = torch.stack([torch.from_numpy(chost[i % 4]["image"]) for i in range(20)]).to(dev)
    cmodel = randomize_(tm.init_params_(DPF(ccfg), 1), 1, 0.02).to(dev)
    ctx = tm.make_optimizer(ccfg.train)
    cstate = tm.init_state(cmodel, ctx)
    cmulti = tm.make_multi_step(cmodel, ctx, ccfg)
    cstate, _ = cmulti(cstate, {"x": cx[:2], "image": cimg[:2]})      # the capture
    ctimer = [lambda st: cmulti(st, {"x": cx, "image": cimg}), cstate]
    conv_ms = timed_call(ctimer)
    print(f"SVR training path, conv backbone (widths {list(ccfg.model.image_encoder.widths)}, "
          f"128 px): 10 steps in one call in {cwall:.1f} s wall; launches "
          f"{json.dumps(conv_launches)}; loss {crecords[-1]['loss']:.1f}, grad norm "
          f"{crecords[-1]['grad_norm']:.1f}; replayed {conv_ms:.3f} ms/step (a call of 20; "
          f"{card})")
    del cmulti, ctimer, cmodel, cstate, cx, cimg

    # the ShapeNet layouts: 2 synsets x 3 splits x 40 clouds of 2500 stored
    # points in a PointFlow npy tree, the flagship generative model through
    # the npy-dir loader under the per_shape and global frames; with pillow,
    # 4 PNG views a model (render_cloud) and the SVR model through
    # shapenet_svr; h5 files need h5py, which the card's machine lacks
    from dpfx_torch.data import render_cloud

    tree, renders = WORK / "shapenet_npy", WORK / "shapenet_renders"
    shutil.rmtree(tree, ignore_errors=True)
    shutil.rmtree(renders, ignore_errors=True)
    have_pil = find_spec("PIL") is not None
    for c, cat in enumerate(("airplane", "chair")):
        for split in ("train", "val", "test"):
            d = tree / SYNSET_IDS[cat] / split
            d.mkdir(parents=True)
            src = SyntheticDataset(size=40, n_stored=2500, split=split, family="v2", seed=c)
            for i in range(40):
                cloud = src[i] * (1.0 + c) + np.float32(c)
                model = f"{split}_{i:03d}"           # model ids are unique across splits
                np.save(d / f"{model}.npy", cloud)
                if have_pil:
                    from PIL import Image

                    r = renders / SYNSET_IDS[cat] / model / "rendering"
                    r.mkdir(parents=True)
                    for v in range(4):
                        px = (render_cloud(cloud, 64, v * 2) * 255).astype(np.uint8)
                        Image.fromarray(px).save(r / f"{v:02d}.png")
    rows = []
    for norm in ("per_shape", "global"):
        nroot = WORK / f"train_npydir_{norm}"
        shutil.rmtree(nroot, ignore_errors=True)
        for m in train_mods:
            m.reset_launch_counts()
        text, nrec, _, nwall = svr_train_run(
            [str(NPYDIR_CONFIG), f"data.path={tree}", f"data.normalize={norm}", "train.steps=20",
             "train.log_every=10", f"train.lr_decay_steps={TRAIN_STEPS}", "train.ckpt_every=20",
             f"train.ckpt_dir={nroot}"], nroot / "flagship_gen_npydir", 20, [20])
        launches = counts(train_mods)
        check("train=80 val=80 clouds" in text
              and "device-resident split: 80 clouds x 2500 stored pts" in text,
              f"the npy tree's clouds counted ({norm})")
        check(launches["fused_train_fwd"] == tm._WARMUP + 20 + 3
              and launches["fused_encoder_bwd"] == tm._WARMUP + 20,
              f"the training kernels launched on the npy-dir path ({norm}): {launches}")
        rows.append(f"{norm}: loss {nrec[-1]['loss']:.1f}, grad norm {nrec[-1]['grad_norm']:.1f}, "
                    f"{nwall:.1f} s wall, launches {json.dumps(launches)}")
    if have_pil:
        sroot = WORK / "train_shapenet_svr"
        shutil.rmtree(sroot, ignore_errors=True)
        for m in train_mods:
            m.reset_launch_counts()
        text, srec, _, swall = svr_train_run(
            [str(SVR_CONFIG), "data.dataset=shapenet_svr", f"data.path={tree}",
             f"data.render_path={renders}", "data.views_per_model=4", "data.normalize=per_shape",
             "train.steps=10", "train.log_every=10", f"train.lr_decay_steps={TRAIN_STEPS}",
             "train.ckpt_every=10", f"train.ckpt_dir={sroot}"], sroot / cfg.name, 10, [10])
        launches = counts(train_mods)
        check("train=80 val=80 clouds" in text and "80 clouds x 2500 stored pts" in text
              and "+ renders 64x64x3 (4 MB)" in text, "the paired tree's clouds and renders counted")
        launch_checks(launches, 10, 3, "the shapenet_svr training path")
        rows.append(f"shapenet_svr (4 PNG views a model, mixer 64 px, 10 steps): loss "
                    f"{srec[-1]['loss']:.1f}, grad norm {srec[-1]['grad_norm']:.1f}, {swall:.1f} s "
                    f"wall, launches {json.dumps(launches)}")
    print("ShapeNet layouts (2 synsets x train/val/test x 40 clouds of 2500 points, the "
          "subsample on the device; flagship_gen_npydir.yaml for 20 steps, one call): "
          + "; ".join(rows) + f". h5py importable: {find_spec('h5py') is not None}, pillow: "
          f"{have_pil}; what is not importable here (ShapeNetH5; ShapeNetRenderDataset "
          "without pillow) is held to dpfx on the CPU by tests/test_torch_datasets.py only")


# the reference's torch names from the port's (the inverse of
# dpfx_torch.compat.convert.DEFAULT_RULES for the generation model: a
# rename, the Linear weights [out, in] on both sides)
TO_REFERENCE = [
    (r"^(point_flow|latent_flow)\.coupling_(\d+)\.cond_net\.hidden_(\d+)\.",
     r"\1.couplings.\2.cond_net.hiddens.\3."),
    (r"^(point_flow|latent_flow)\.coupling_(\d+)\.cond_net\.(in_x|in_z|out)\.",
     r"\1.couplings.\2.cond_net.\3."),
]


def reference_layout(model) -> dict:
    """The port model's weights under the reference's names, with the
    coupling masks the reference stores as buffers."""
    import re

    out = {}
    for key, t in model.state_dict().items():
        for pat, rep in TO_REFERENCE:
            key = re.sub(pat, rep, key)
        out[key] = t.detach().cpu().clone()
    for key, t in model.named_buffers():
        out[re.sub(r"\.coupling_(\d+)\.mask$", r".couplings.\1.mask", key)] = t.detach().cpu()
    return out


def run_cli(module: str, args):
    """``python -m <module> <args>`` in a child process from the repo root;
    returns (its stdout, its wall seconds)."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    wall = time.perf_counter() - t0
    print(proc.stdout, end="")
    check(proc.returncode == 0, f"{module} exited {proc.returncode}: {proc.stderr[-2000:]}")
    return proc.stdout, wall


def packed_path(cfg, dev, card, multi, timers, train_ms, step_losses, resident_val):
    """Phase 3i: the packed-stack training path at full width. ``multi`` is
    phase 3b's captured step (module latent flow) and ``timers`` its
    [call, state] pairs: the packed call replays that step on host batches
    and is timed in turns with the resident call; ``train_ms`` holds 3b's
    ms/step, ``step_losses`` 3b's per-step losses and ``resident_val`` its
    final validation record."""
    import shutil

    import numpy as np
    import torch

    from dpfx_torch import generate
    from dpfx_torch.checkpoint import restore_for_eval
    from dpfx_torch.native import NativeBatcher
    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_sampler as fs
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.sampling import make_sampler
    from dpfx_torch.train import trainer as tm

    work = WORK / "packed"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)

    # (a) the pack tool on 3b's 512-cloud cut
    stack = work / "train.npy"
    text, pack_s = run_cli("dpfx_torch.tools.pack_dataset",
                           [str(CONFIG), "data.synthetic_size=512", "--out", str(stack)])
    packed = np.load(stack, mmap_mode="r")
    meta = json.loads(Path(f"{stack}.meta.json").read_text())
    check(packed.shape == (512, 4096, 3) and packed.dtype == np.float32
          and meta["normalize_applied"] == cfg.data.normalize and meta["n_stored"] == 4096,
          f"the packed stack {packed.shape} {packed.dtype}, sidecar {meta}")
    mb = stack.stat().st_size / 1e6
    print(f"packed stack: {packed.shape} float32, {mb:.1f} MB in {pack_s:.2f} s (the tool as a "
          f"child process, start-up included)")

    # (b) the loader alone at the flagship batch, 2 workers
    nb = NativeBatcher(str(stack), 64, 2048, seed=cfg.train.seed, n_workers=2)
    for _ in range(8):
        nb.next()
    t0 = time.perf_counter()
    for _ in range(100):
        nb.next()
    loader_rate = 100 / (time.perf_counter() - t0)
    step_rate = 1e3 / train_ms[("off", "replayed")]
    print(f"native loader alone, 64 x 2048 from 4096 stored points, 2 workers: "
          f"{loader_rate:,.1f} batches/s against {step_rate:,.1f} batches/s of the replayed step "
          f"(module latent flow; {card})")

    # (c) the training CLI on the stack: a call of 20 replays and 10 eager steps
    ckpt_dir = work / "train"
    for mod in (ft, fe):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    rc, text, calls, init_weights = train_cli_run(
        [str(CONFIG), f"train.steps={TRAIN_STEPS}", "train.log_every=5",
         f"train.ckpt_every={TRAIN_STEPS}", f"train.ckpt_dir={ckpt_dir}",
         "data.synthetic_size=512", "data.device_resident=false", f"data.packed_path={stack}"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {**ft.launches, **fe.launches}
    run_dir = ckpt_dir / cfg.name
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    val = [r for r in records if r["kind"] == "val"]
    records = [r for r in records if r["kind"] == "train"]
    check(rc == 0 and [k for k, _ in calls] == [20] + [1] * (TRAIN_STEPS - 20)
          and [r["step"] for r in records] == [20, 25, TRAIN_STEPS],
          f"packed train calls {[k for k, _ in calls]}, records {records}")
    check([r["step"] for r in val] == [TRAIN_STEPS] and finite_numbers(val[0]),
          f"one final evaluation, finite: {val}")
    check(f"native loader: 512 clouds x 4096 pts from {stack}; steps_per_call=20" in text
          and "device-resident" not in text and "ignored" not in text,
          "the CLI trains from the packed stack through the native loader")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in records),
          "every logged loss and grad norm is finite (packed)")
    check(all(r["nonfinite_skipped"] == 0 for r in records), "no step was skipped (packed)")
    for kname, count in launches.items():
        want = tm._WARMUP + TRAIN_STEPS + (VAL_BATCHES if kname.endswith("fwd") else 0)
        check(count == want, f"kernel {kname}: {count} launches on the packed path, {want} on the "
                             "resident one")
    losses = [v for _, ls in calls for v in ls]
    windows = lambda ls: [sum(ls[i:i + 5]) / 5 for i in (0, 5)]  # noqa: E731
    drift = [abs(a - r) / abs(r) for a, r in zip(windows(losses), windows(step_losses))]
    key = "neg_elbo_per_point"
    val_drift = (val[0][key] - resident_val[key]) / abs(resident_val[key])
    trained_pt = run_dir / f"params_{TRAIN_STEPS:08d}.pt"
    trained = torch.load(trained_pt, map_location="cpu", weights_only=True)
    moved = sum(not torch.equal(trained[k], v) for k, v in init_weights.items())
    check(moved == len(init_weights), f"{moved} of {len(init_weights)} parameters moved (packed)")
    print(f"packed training path: {TRAIN_STEPS} steps of 64 x 2048 (calls of 20 replays and 10 "
          f"eager steps) in {wall:.1f} s wall (capture and warm-up included); launches "
          f"{json.dumps(launches)}; loss " + ", ".join(f"{r['loss']:.1f}" for r in records)
          + "; grad norm " + ", ".join(f"{r['grad_norm']:.1f}" for r in records) + "; loss "
          f"windows of 5 steps {[round(w, 1) for w in windows(losses)]} against the resident "
          f"run's {[round(w, 1) for w in windows(step_losses)]}: rel "
          + ", ".join(f"{d:.2e}" for d in drift) + f"; validation {key} {val[0][key]:.4f} "
          f"against the resident run's {resident_val[key]:.4f}: rel {val_drift:+.2e}; {moved} "
          "tensors moved")
    check(drift[0] <= TOL_TRAIN_DRIFT, f"the packed run's first loss window tracks the resident "
                                       f"run's ({drift[0]} > {TOL_TRAIN_DRIFT})")
    check(val_drift <= TOL_PACKED_VAL, f"the packed run validates no worse than the resident "
                                       f"run by more than {TOL_PACKED_VAL} ({val_drift})")

    # (d) calls of 20 on packed host batches (Trainer.fit's stacked path:
    # 20 batches from the loader, one np.stack, one copy, 20 replays) in
    # turns with resident calls, both with the module latent flow: one call
    # synchronised on its own (the host's preparation in front of the
    # replays) and runs of 5 calls back to back, as the trainer issues them
    # (the next call's preparation under this call's replays)
    replayed, resident = timers[("off", "replayed")], timers[("off", "resident")]

    def one_call(kind):
        if kind == "packed":
            xs = np.stack([nb.next() for _ in range(20)])
            replayed[1], _ = multi(replayed[1], {"x": torch.as_tensor(xs).to(dev, non_blocking=True)})
        else:
            resident[1], _ = resident[0](resident[1])

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)

    def timed(kind, calls):
        torch.cuda.synchronize()
        start.record()
        for _ in range(calls):
            one_call(kind)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / (20 * calls)

    one_call("packed")
    turns = {calls: [(kind, timed(kind, calls)) for kind in ("packed", "resident") * 2
                     + ("resident", "packed") * 2] for calls in (1, 5)}
    ms = {(kind, calls): statistics.mean(t for k, t in turns[calls] if k == kind)
          for kind in ("packed", "resident") for calls in (1, 5)}
    # the host parts of a packed call, each on its own (perf_counter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pending = [nb.next() for _ in range(20)]
    t1 = time.perf_counter()
    xs = np.stack(pending)
    t2 = time.perf_counter()
    torch.as_tensor(xs).to(dev)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    for calls, what in ((1, "one call synchronised"), (5, "5 calls back to back")):
        p_ms, r_ms = ms[("packed", calls)], ms[("resident", calls)]
        print(f"train step at 64 x 2048, module latent flow, {what}: packed host batches "
              f"{p_ms:.3f} ms/step against resident {r_ms:.3f} ms/step (calls of 20; packed / "
              f"resident {p_ms / r_ms:.3f}); turns (ms/step) "
              + ", ".join(f"{k} {t:.3f}" for k, t in turns[calls]) + f" ({card})")
    print(f"a packed call's host parts: 20 batches from the loader {(t1 - t0) * 1e3:.2f} ms, "
          f"np.stack {(t2 - t1) * 1e3:.2f} ms, the copy of {xs.nbytes / 1e6:.1f} MB from pageable "
          f"memory {(t3 - t2) * 1e3:.2f} ms ({card})")
    for kind in ("packed", "resident"):
        for calls in (1, 3):
            wall_us, busy_us, dev_events = profiled(lambda: one_call(kind), calls)
            seen = lambda name: sum(name in e.key for e in dev_events)  # noqa: E731
            check(seen("fwd_kernel_mma") and seen("bwd_kernel_mma") and seen("walk_kernel"),
                  f"the profiler saw the training kernels in a {kind} call")
            steps = 20 * calls
            print(f"profile {kind} calls of 20 steps x{calls}, module latent flow: wall "
                  f"{wall_us / steps / 1e3:.3f} ms/step, device busy {busy_us / steps / 1e3:.3f} "
                  f"ms/step, idle share {1 - busy_us / wall_us:.3f} under the profiler ({card})")
    nb.close()

    # (e) generate --png on the packed run's checkpoint, then its weights in
    # the reference layout converted back by the converter CLI
    fs.reset_launch_counts()
    png, out = work / "m.png", work / "samples.npy"
    rc = generate.main([str(CONFIG), "--weights", str(trained_pt), "--out", str(out), "--png",
                        str(png), "--seed", "6"])
    png_launches = dict(fs.launches)
    from PIL import Image

    with Image.open(png) as im:
        img = np.asarray(im)
    # not blank: every tile (16 clouds x 3 views) holds a lit pixel
    tiles = img[..., 0].reshape(16, 128, 3, 128).max(axis=(1, 3))
    check(rc == 0 and img.shape == (16 * 128, 3 * 128, 3) and img.dtype == np.uint8
          and bool((tiles > 0).all()),
          f"the montage {img.shape}, tiles lit {(tiles > 0).sum()} of 48, max {img.max()}")
    check(png_launches["fused_sample"] > 0, f"generate --png launched {png_launches}")
    ref_pt, conv_pt = work / "reference_layout.pt", work / "converted.pt"
    model = restore_for_eval(cfg, str(trained_pt), dev)
    reference = reference_layout(model)
    torch.save({"model": reference}, ref_pt)
    text, conv_s = run_cli("dpfx_torch.convert_checkpoint",
                           [str(ref_pt), str(CONFIG), "--out", str(conv_pt)])
    converted = torch.load(conv_pt, map_location="cpu", weights_only=True)
    check(converted.keys() == trained.keys()
          and all(torch.equal(converted[k], trained[k]) for k in trained),
          "the converted state dict equals the trained one bit for bit")
    a = make_sampler(model, 64, 2048)(11)
    b = make_sampler(restore_for_eval(cfg, str(conv_pt), dev), 64, 2048)(11)
    torch.cuda.synchronize()
    check(torch.equal(a, b) and bool(torch.isfinite(a).all()),
          "the converted weights sample the trained weights' clouds bit for bit")
    print(f"generate --png: a {img.shape[0]} x {img.shape[1]} montage, {(img > 0).mean():.3f} of "
          f"its pixels lit, launches {json.dumps(png_launches)}; the trained weights in the "
          f"reference layout ({len(converted)} tensors and {len(reference) - len(converted)} coupling "
          f"masks) converted back in {conv_s:.2f} s (child process): equal bit for bit, "
          f"make_sampler(64, 2048) on both gives the same clouds bit for bit (std "
          f"{float(a.std()):.3f})")


def trainer_loop_path(cfg, dev, card):
    """Phase 3g: the trainer loop at full width on the flagship YAML
    (data.synthetic_size 512: 128 val clouds, 4 batches of 32). (1) The CLI
    for 30 steps with eval_every=10, ckpt_every=10 and ckpt_keep=2: val
    records at 20 and 30 and no second final one, exactly steps 20 and 30
    on disk with both files, then --resume to step 40; (2) a resident run
    stopped at 20 and resumed by a new Trainer to 30 against the
    uninterrupted 30 steps, bit for bit (params, moments, count, step),
    the latent flow through the module and fused; (3) fit_auto on host
    batches holding an inf from step 21 on (steps_per_call 2, log_every 2,
    ckpt_every 4): restored step 20, lr halved, the step captured again on
    the same storage, the run finished and finite; (4) Trainer.evaluate on
    the card against the same call on the CPU (plain versions) on the same
    weights, batches (one ragged) and eps. Prints one evaluation's ms per
    batch, one save's ms and bytes and the recapture's ms, and a profile of
    one evaluation pass (device busy, idle share, the top kernels)."""
    import copy
    import shutil

    import numpy as np
    import torch

    from dpfx_torch.compat import randomize_
    from dpfx_torch.config import load_config
    from dpfx_torch.data import build_dataset, iterate_batches, preload_clouds
    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_latent as fl
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.train import trainer as tm

    timed = {"evaluate": [], "save": [], "capture": []}
    evaluate, save, capture = tm.Trainer.evaluate, tm.CheckpointManager.save, tm.MultiStep._capture

    def clocked(name, fn, note):
        def wrapper(self, *a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(self, *a, **k)
            torch.cuda.synchronize()
            timed[name].append(((time.perf_counter() - t0) * 1e3, note(self, *a)))
            return out
        return wrapper

    tm.Trainer.evaluate = clocked("evaluate", evaluate, lambda tr, batches: tr.state.host_step)
    tm.CheckpointManager.save = clocked(
        "save", save, lambda mgr, step, *a: (step, sum(os.path.getsize(p) for p in mgr.paths(step))))
    tm.MultiStep._capture = clocked("capture", capture, lambda multi, *a: multi)
    try:
        # (1) the CLI: evaluation, retention, --resume
        run = WORK / "loop_cli"
        shutil.rmtree(run, ignore_errors=True)
        argv = [str(CONFIG), f"train.steps={TRAIN_STEPS}", "train.log_every=10",
                "train.ckpt_every=10", "train.eval_every=10", "train.ckpt_keep=2",
                f"train.ckpt_dir={run}", "data.synthetic_size=512"]
        rc, _, calls, _ = train_cli_run(argv)
        d = run / cfg.name

        def records(kind):
            return [r for r in map(json.loads, (d / "metrics.jsonl").read_text().splitlines())
                    if r["kind"] == kind]

        def on_disk():
            return sorted(p.name for p in d.iterdir() if p.name != "metrics.jsonl")

        val = records("val")
        check(rc == 0 and [k for k, _ in calls] == [20, 10], f"loop CLI calls {calls}")
        check([r["step"] for r in val] == [20, 30] and all(finite_numbers(r) for r in val),
              f"val records at 20 and 30, finite, no second final evaluation: {val}")
        check(on_disk() == ["params_00000020.pt", "params_00000030.pt", "state_00000020.ckpt",
                            "state_00000030.ckpt"], f"ckpt_keep=2 keeps steps 20 and 30: {on_disk()}")
        eval_ms = [ms for ms, step in timed["evaluate"] if step == 30][0] / VAL_BATCHES
        save_ms, (_, save_bytes) = [(ms, n) for ms, n in timed["save"] if n[0] == 30][0]
        # --resume: on to step 40 on the same schedule (lr_decay_steps=30, the
        # first run's horizon; its terminal lr after it)
        rc, text, calls, _ = train_cli_run(
            [argv[0], "train.steps=40", f"train.lr_decay_steps={TRAIN_STEPS}", *argv[2:],
             "--resume"])
        val = records("val")
        check(rc == 0 and "resumed from step 30" in text and [k for k, _ in calls] == [10]
              and [r["step"] for r in val] == [20, 30, 40] and finite_numbers(val[-1])
              and on_disk() == ["params_00000030.pt", "params_00000040.pt",
                                "state_00000030.ckpt", "state_00000040.ckpt"],
              f"--resume continues the run to step 40: calls {calls}, val {val}, {on_disk()}")
        print(f"trainer loop CLI: {TRAIN_STEPS} steps (calls {[20, 10]}), val at "
              f"{[20, 30]} (finite, loss {val[1]['loss']:.2f}, median neg_elbo/pt "
              f"{val[1]['neg_elbo_per_point_median']:.4f}), steps 20 and 30 kept (ckpt_keep=2), "
              f"--resume to 40 (one call of 10, val at 40, steps 30 and 40 kept); evaluation "
              f"{eval_ms:.3f} ms per 32 x 2048 batch (4 batches, host to host); save {save_ms:.1f} "
              f"ms, {save_bytes:,} bytes (params, both moments, the layout) ({card})")

        # (2) resume bit for bit on the resident split
        base = load_config(CONFIG, overrides=[f"train.steps={TRAIN_STEPS}", "train.log_every=10",
                                              "data.synthetic_size=512"])
        clouds = preload_clouds(build_dataset(base.data, "train"))

        def loop_trainer(c, name, fresh=True):
            c = copy.deepcopy(c)
            c.train.ckpt_dir = str(WORK / name)
            if fresh:
                shutil.rmtree(c.train.ckpt_dir, ignore_errors=True)
            tr = tm.Trainer(c, device=dev, log_fn=lambda s: None)
            randomize_(tr.model, 1, 0.02)
            return tr

        for fused_latent, name in ((False, "module latent flow"), (True, "fused latent flow")):
            c = copy.deepcopy(base)
            c.train.fused_latent_flow = fused_latent
            tag = "loop_resume_fused" if fused_latent else "loop_resume"
            whole = loop_trainer(c, tag + "_whole")
            whole.fit_resident(clouds)
            whole.multi_step.release()
            part = loop_trainer(c, tag)
            part.fit_resident(clouds, steps=20)
            part.multi_step.release()
            check(part.ckpt.all_steps() == [20], f"the stopped run saved step 20 ({name})")
            del part
            resumed = loop_trainer(c, tag, fresh=False)
            flat = resumed.state.params.data_ptr()
            check(resumed.maybe_resume() == 20, f"resumed from step 20 ({name})")
            resumed.fit_resident(clouds)
            torch.cuda.synchronize()
            check(same_state(resumed.state, whole.state) and resumed.state.host_step == TRAIN_STEPS
                  and resumed.state.params.data_ptr() == flat,
                  f"a resumed run equals the uninterrupted one bit for bit ({name})")
            print(f"resume at full width, {name}: 20 steps, a new Trainer restored step 20 in "
                  f"place and captured again, 10 more: params, mu, nu, count and step equal the "
                  f"uninterrupted {TRAIN_STEPS} steps bit for bit")
            resumed.multi_step.release()
            del whole, resumed

        # (3) divergence recovery with a recaptured step
        rcfg = load_config(CONFIG, overrides=[
            "train.steps=40", "train.lr_decay_steps=100000", "train.steps_per_call=2",
            "train.log_every=2", "train.ckpt_every=4", "train.recover_on_divergence=true",
            "data.synthetic_size=512", f"train.ckpt_dir={WORK / 'loop_recover'}"])
        shutil.rmtree(WORK / "loop_recover", ignore_errors=True)
        train_ds = build_dataset(rcfg.data, "train")
        streams = []

        def stream(poisoned):
            for i, bt in enumerate(iterate_batches(train_ds, 64, 2048, seed=rcfg.train.seed)):
                if poisoned and i >= 20:
                    bt["x"][0, 0, 0] = np.inf
                yield bt

        def make_batches():
            streams.append(1)
            return stream(len(streams) == 1)

        logs = []
        tr = tm.Trainer(rcfg, device=dev, log_fn=logs.append)
        randomize_(tr.model, 1, 0.02)
        first, lr0, flat = tr.multi_step, rcfg.train.lr, tr.state.params.data_ptr()
        at = len(timed["capture"])
        state = tr.fit_auto(make_batches)
        torch.cuda.synchronize()
        caps = timed["capture"][at:]
        check(any("restored step 20" in line for line in logs),
              f"the recovery restored step 20: {[ln for ln in logs if 'diverged' in ln]}")
        check(tr.cfg.train.lr == lr0 * 0.5, f"lr halved: {tr.cfg.train.lr}")
        check(len(caps) == 2 and caps[0][1] is first and caps[1][1] is tr.multi_step
              and first.graph is None and tr.multi_step.graph is not None,
              "the step was captured again after the recovery, the old graph released")
        check(len(streams) == 2 and state.host_step == int(state.step) == 40
              and state.params.data_ptr() == flat and bool(torch.isfinite(state.params).all()),
              "the recovered run ends at step 40 with finite params on its storage")
        recapture_ms = caps[1][0]
        print(f"recovery at full width: host batches with an inf from step 21, calls of 2: "
              f"{[ln for ln in logs if 'diverged' in ln][0]}; lr {lr0:g} -> {tr.cfg.train.lr:g}; "
              f"captures {[f'{ms:.1f}' for ms, _ in caps]} ms (the recapture: {tm._WARMUP} "
              f"warm-up steps and the capture, {recapture_ms:.1f} ms); ended at step 40, finite "
              f"({card})")
        tr.multi_step.release()
        del tr, state

        # (4) Trainer.evaluate on the card against the CPU
        ecfg = load_config(CONFIG, overrides=["data.synthetic_size=512",
                                              f"train.ckpt_dir={WORK / 'loop_eval'}"])
        gtr = tm.Trainer(ecfg, device=dev, log_fn=lambda s: None)
        randomize_(gtr.model, 1, 0.02)
        ctr = tm.Trainer(copy.deepcopy(ecfg), device="cpu", log_fn=lambda s: None)
        ctr.state.params.copy_(gtr.state.params.cpu())
        first_batch = next(iterate_batches(build_dataset(ecfg.data, "val"), 48, 2048, seed=0,
                                           shuffle=False, epochs=1))["x"]
        rng = np.random.default_rng(9)
        batches = [{"x": x, "eps": rng.normal(size=(len(x), ecfg.model.dz)).astype(np.float32)}
                   for x in (first_batch[:32], first_batch[32:])]
        for mod in (ft, fe, fl):
            mod.reset_launch_counts()
        on_card = gtr.evaluate(iter(batches))
        launches = {**ft.launches, **fe.launches, **fl.launches}
        on_cpu = ctr.evaluate(iter(batches))
        check(launches["fused_train_fwd"] == launches["fused_encoder_fwd"] == 2
              and launches["fused_train_bwd"] == launches["fused_encoder_bwd"] == 0,
              f"evaluation ran the forward kernels once a batch: {launches}")
        errs = {k: abs(on_card[k] - v) / abs(v) for k, v in on_cpu.items()}
        print("evaluation, card (fused kernels) vs CPU (plain versions), batches of 32 and 16 x "
              "2048: " + ", ".join(f"{k} {on_card[k]:.4f} vs {on_cpu[k]:.4f} ({errs[k]:.1e})"
                                   for k in on_cpu) + f"; launches {json.dumps(launches)}")
        check(max(errs.values()) <= TOL_STEP_LOSS,
              f"evaluation on the card agrees with the CPU ({max(errs.values())})")
        # where an evaluation pass's time goes: the CLI's 4 batches of 32
        val4 = list(iterate_batches(build_dataset(ecfg.data, "val"), 32, 2048, seed=0,
                                    shuffle=False, epochs=1))
        wall_us, busy_us, events = profiled(lambda: gtr.evaluate(iter(val4)), 1)
        top = sorted(events, key=lambda e: -e.self_device_time_total)[:5]
        print(f"profile evaluation pass, 4 x 32 x 2048 (module latent flow): wall "
              f"{wall_us / 1e3:.3f} ms, device busy {busy_us / 1e3:.3f} ms, idle share "
              f"{1 - busy_us / wall_us:.3f}, {sum(e.count for e in events)} kernels; top: "
              + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.3f} ms x{e.count}"
                          for e in top) + f" ({card})")
        gtr.multi_step.release()
        del gtr, ctr
        torch.cuda.empty_cache()
    finally:
        tm.Trainer.evaluate, tm.CheckpointManager.save, tm.MultiStep._capture = (
            evaluate, save, capture)


# ---------------------------------------------------------------- phase 3j: data parallel

DP_SEED = 11            # the sampler's seed in phase 3j
DP_POINTS = 2048        # the points of a cloud in phase 3j (the flagship's N)
DP_STEPS = 3            # eager steps of each two-rank form
DP_TURNS = ("none", "world-1", "world-1", "none", "none", "world-1")   # phase 3j (a)'s timed calls
TOL_DP_LOSS = 1e-5      # a step's loss at two ranks against one process (the batch mean's order)


def dp_inputs(*overrides):
    """Phase 3j's config (the flagship YAML with the 512-cloud synthetic
    split and ``overrides``), the resident split [512, 4096, 3] and 64
    test-split clouds, both numpy."""
    from dpfx_torch.config import load_config
    from dpfx_torch.data import build_dataset, load_all, preload_clouds

    cfg = load_config(str(CONFIG), overrides=["data.synthetic_size=512", *overrides])
    return (cfg, preload_clouds(build_dataset(cfg.data, "train")),
            load_all(build_dataset(cfg.data, "test"), DP_POINTS, limit=64).astype("float32"))


def dp_model(cfg, dev):
    """The seeded random flagship weights every rank and the one-process
    runs of phase 3j start from."""
    from dpfx_torch.compat import randomize_
    from dpfx_torch.models import DPF
    from dpfx_torch.train import trainer as tm

    return randomize_(tm.init_params_(DPF(cfg), 1), 1, 0.02).to(dev)


def dp_steps(cfg, dev, clouds, group, sharded: bool, steps: int = DP_STEPS) -> dict:
    """``steps`` resident steps, eager and one a call (train.steps_per_call
    = 1), on the rank's rows under ``group`` (None: one process). Records
    each step's batch as the step got it (x, eps, xnoise), the losses, step
    1's flat gradient as Adam got it (all-reduced under a group), the final
    parameters and the bytes of the resident stack this process holds."""
    import torch

    from dpfx_torch.parallel import shard_resident_stack, world_rank
    from dpfx_torch.train import trainer as tm

    world, rank = world_rank(group)
    model = dp_model(cfg, dev)
    tx = tm.make_optimizer(cfg.train)
    state = tm.init_state(model, tx)
    step = tm.make_train_step(model, tx, cfg, group)
    seen, grads, apply = [], [], tx.apply_

    def recording_apply(params, g, *a, **k):
        if not grads:
            grads.append(g.clone())
        return apply(params, g, *a, **k)

    def one_step(st, batches):
        batch = {k: v[0] for k, v in batches.items() if v is not None}
        seen.append({k: v.clone() for k, v in batch.items()})
        return step(st, batch)

    tx.apply_ = recording_apply
    data = (shard_resident_stack(clouds, world, rank, dev) if sharded
            else torch.from_numpy(clouds).to(dev))
    resident = tm.make_resident_multi_step(model, tx, cfg, one_step, group=group,
                                           sharded=sharded, logical_rows=clouds.shape[0])
    losses = []
    for _ in range(steps):
        state, m = resident(state, data, 1)
        losses.append(float(m["loss"]))
    return {"seen": seen, "losses": losses, "grad": grads[0], "params": state.params.clone(),
            "sizes": [p.numel() for p in model.parameters()], "resident_bytes": data.numel() * 4}


def dp_samples(model, n: int, group=None, seed: int = DP_SEED, fused_latent: bool = False):
    """make_sampler(n, 2048) of ``seed``, the latent inverse through the
    module or (``fused_latent``) the fused kernel."""
    from dpfx_torch.sampling import make_sampler

    old = os.environ.pop("DPFX_SAMPLE_FUSED_LATENT", None)
    if fused_latent:
        os.environ["DPFX_SAMPLE_FUSED_LATENT"] = "1"
    try:
        return make_sampler(model, n, DP_POINTS, group=group)(seed)
    finally:
        os.environ.pop("DPFX_SAMPLE_FUSED_LATENT", None)
        if old is not None:
            os.environ["DPFX_SAMPLE_FUSED_LATENT"] = old


def dp_counters():
    from dpfx_torch.ops import chamfer, emd, fused_encoder, fused_latent, fused_sampler, fused_train

    return (fused_train, fused_encoder, fused_latent, fused_sampler, chamfer, emd)


def dp_worker(rank: int, port: int, out_dir: Path, device: str) -> int:
    """One of phase 3j's two gloo ranks, both on cuda:0 (a child process of
    the smoke): the replicated and the sharded resident forms (B/D = 32,
    eager steps), a step with the fused latent flow, the rank-sharded
    sampler (module and fused latent inverse) and the row-sharded suite on
    64 x 64 clouds; the launch counts from 0; a multi-step of 20 under the
    gloo group must refuse. Writes ``rank<r>.pt``. ``device``: the parent's
    device (cuda: both ranks take cuda:0)."""
    import copy

    import torch
    import torch.distributed as dist

    from dpfx_torch.metrics.generation import compute_all_metrics, pairwise_matrix
    from dpfx_torch.train import trainer as tm

    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("chip_smoke: no CUDA device", file=sys.stderr)
            return 2
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", world_size=2,
                            rank=rank)
    group = dist.group.WORLD
    cfg, clouds, ref = dp_inputs("train.steps_per_call=1")
    lcfg = copy.deepcopy(cfg)
    lcfg.train.fused_latent_flow = True
    for mod in dp_counters():
        mod.reset_launch_counts()
    out = {"replicated": dp_steps(cfg, dev, clouds, group, False),
           "sharded": dp_steps(cfg, dev, clouds, group, True),
           "latent": dp_steps(lcfg, dev, clouds, group, False, 1)}
    model = dp_model(cfg, dev)
    gen = dp_samples(model, 64, group)
    out["gen"], out["gen_latent"] = gen, dp_samples(model, 64, group, fused_latent=True)
    ref = torch.from_numpy(ref).to(dev)
    for metric in ("cd", "emd"):
        out[metric] = pairwise_matrix(gen, ref, metric, group=group)
    with warnings.catch_warnings():      # random weights: samples past the JSD grid
        warnings.simplefilter("ignore")
        out["metrics"] = compute_all_metrics(gen, ref, metrics=("cd", "emd"), group=group)
    out["launches"] = {k: v for mod in dp_counters() for k, v in mod.launches.items()}
    c20 = copy.deepcopy(cfg)
    c20.train.steps_per_call = 20
    try:
        tm.MultiStep(model, tm.make_optimizer(c20.train), c20, group)
        out["refusal"] = ""
    except ValueError as e:
        out["refusal"] = str(e)
    on_cpu = lambda v: v.cpu() if isinstance(v, torch.Tensor) else (  # noqa: E731
        {k: on_cpu(u) for k, u in v.items()} if isinstance(v, dict) else
        [on_cpu(u) for u in v] if isinstance(v, list) else v)
    torch.save(on_cpu(out), out_dir / f"rank{rank}.pt")
    dist.destroy_process_group()
    return 0


def dp_world1(dev, card):
    """Phase 3j (a): NCCL with one rank, the all-reduce captured inside the
    step's graph, against the call with no group: resident calls of 20
    replays (the YAML's steps_per_call), replicated and then sharded (the
    gather the identity), bit for bit and with equal launch counts, then
    timed in turns. Returns {sharded: ({"none": [ms], "world-1": [ms]},
    launches)} and the flat gradient's bytes."""
    import torch
    import torch.distributed as dist

    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.parallel import free_port, shard_resident_stack
    from dpfx_torch.train import trainer as tm

    cfg, clouds_np, _ = dp_inputs()
    clouds = torch.from_numpy(clouds_np).to(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    out = {}
    try:
        for sharded in (False, True):
            calls, launches, multis = {}, {}, []
            for name, group in (("none", None), ("world-1", dist.group.WORLD)):
                model = dp_model(cfg, dev)
                tx = tm.make_optimizer(cfg.train)
                state = tm.init_state(model, tx)
                multi = tm.MultiStep(model, tx, cfg, group)
                use_block = sharded and group is not None
                data = shard_resident_stack(clouds_np, 1, 0, dev) if use_block else clouds
                resident = tm.make_resident_multi_step(model, tx, cfg, multi, group=group,
                                                       sharded=use_block, logical_rows=512)
                for mod in (ft, fe):
                    mod.reset_launch_counts()
                state, _ = resident(state, data, 20)
                torch.cuda.synchronize()
                launches[name] = {**ft.launches, **fe.launches}
                calls[name] = [lambda st, f=resident, d=data: f(st, d, 20), state]
                multis.append(multi)
                flat_bytes = state.params.numel() * 4
            what = "sharded" if sharded else "replicated"
            check(same_state(calls["none"][1], calls["world-1"][1]),
                  f"world-1 NCCL ({what}): a resident call of 20 replays with the all-reduce "
                  "captured equals the call with no group bit for bit")
            check(launches["none"] == launches["world-1"] and all(launches["none"].values()),
                  f"world-1 NCCL ({what}): launches {launches}")
            times = {"none": [], "world-1": []}
            for name in ("none", "world-1") + DP_TURNS:     # one untimed call each, then turns
                call, st = calls[name]
                torch.cuda.synchronize()
                start.record()
                calls[name][1], _ = call(st)
                end.record()
                torch.cuda.synchronize()
                times[name].append(start.elapsed_time(end) / 20)
            times = {k: v[1:] for k, v in times.items()}
            check(same_state(calls["none"][1], calls["world-1"][1]),
                  f"world-1 NCCL ({what}): still bit for bit after {len(times['none']) + 1} more "
                  "calls each")
            for multi in multis:
                multi.release()
            out[sharded] = (times, launches["none"])
    finally:
        dist.destroy_process_group()
    return out, flat_bytes


def data_parallel_path(dev, card):
    """Phase 3j: data parallel at the flagship's full width (global B=64,
    N=2048, the 512-cloud split): (a) ``dp_world1``; (b) two gloo ranks
    sharing the card (``dp_worker`` in two child processes) against one
    process on the same weights: every step's x, eps and xnoise of the two
    ranks concatenate to the one-process step's bit for bit (replicated and
    sharded), step 1's all-reduced gradient within phase 2's bf16 gradient
    limit per tensor, step 1's loss within TOL_DP_LOSS (the fused latent
    flow's step too), steps 2-3 and the parameters printed, a multi-step of
    20 refused; (c) the rank-sharded sampler's clouds (module and fused
    latent inverse) equal make_sampler on each rank's seeds bit for bit,
    the row-sharded CD and EMD (fast) matrices equal the one-process ones,
    and so do MMD/COV/1-NNA; every kernel of the path launched on each rank;
    (d) the training CLI asked for one card more than are visible raises,
    naming the visible count."""
    import copy
    import shutil

    import torch

    from dpfx_torch.metrics.generation import compute_all_metrics, pairwise_matrix
    from dpfx_torch.parallel import free_port, rank_seed
    from dpfx_torch.train import __main__ as train_cli

    t0 = time.perf_counter()
    world1, flat_bytes = dp_world1(dev, card)
    t_a = time.perf_counter() - t0

    out_dir = WORK / "data_parallel"
    shutil.rmtree(out_dir, ignore_errors=True)
    out_dir.mkdir(parents=True)
    port = free_port()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--dp-worker",
                               str(r), str(port), str(out_dir), dev.type], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for r in (0, 1)]
    try:
        cfg, clouds, ref_np = dp_inputs("train.steps_per_call=1")
        lcfg = copy.deepcopy(cfg)
        lcfg.train.fused_latent_flow = True
        one = {"replicated": dp_steps(cfg, dev, clouds, None, False),
               "latent": dp_steps(lcfg, dev, clouds, None, False, 1)}
        model = dp_model(cfg, dev)
        gen = torch.cat([dp_samples(model, 32, seed=rank_seed(DP_SEED, r)) for r in (0, 1)])
        gen_lat = torch.cat([dp_samples(model, 32, seed=rank_seed(DP_SEED, r), fused_latent=True)
                             for r in (0, 1)])
        ref = torch.from_numpy(ref_np).to(dev)
        mats = {m: pairwise_matrix(gen, ref, m) for m in ("cd", "emd")}
        with warnings.catch_warnings():  # random weights: samples past the JSD grid
            warnings.simplefilter("ignore")
            metrics = compute_all_metrics(gen, ref, metrics=("cd", "emd"))
        torch.cuda.synchronize()
        for r, p in enumerate(procs):
            text, err = p.communicate(timeout=600)
            check(p.returncode == 0,
                  f"data-parallel rank {r} failed:\n{text[-2000:]}\n{err[-4000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    ranks = [torch.load(out_dir / f"rank{r}.pt", weights_only=False) for r in (0, 1)]
    t_bc = time.perf_counter() - t0 - t_a

    # (b) the two ranks' steps against one process
    ref_steps = one["replicated"]
    for form in ("replicated", "sharded"):
        for t in range(DP_STEPS):
            for key in ("x", "eps", "xnoise"):
                parts = [rk[form]["seen"][t][key] for rk in ranks]
                check(torch.equal(torch.cat(parts), ref_steps["seen"][t][key].cpu()),
                      f"{form} step {t + 1}: the ranks' {key} concatenate to the one-process "
                      "step's bit for bit")
    for rk in ranks:
        check(all(torch.equal(a[key], b[key]) for a, b in zip(rk["sharded"]["seen"],
                                                             rk["replicated"]["seen"])
                  for key in ("x", "eps", "xnoise")),
              "the sharded gather's rows equal the replicated rows bit for bit")
    sizes = ref_steps["sizes"]
    grad_err = {}
    for form in ("replicated", "sharded"):
        g0, g1 = (rk[form]["grad"] for rk in ranks)
        check(torch.equal(g0, g1), f"{form}: both ranks' all-reduced gradients are equal")
        errs = [float((a - b).norm() / b.norm().clamp_min(1e-30)) for a, b in
                zip(g0.split(sizes), ref_steps["grad"].cpu().split(sizes))]
        grad_err[form] = max(errs)
        check(grad_err[form] <= TOL_GRAD_BF16, f"{form}: step 1's all-reduced gradient against "
              f"one process, largest per-tensor relative error {grad_err[form]:.3e}")
    loss_err = {}
    for form, want in (("replicated", ref_steps), ("sharded", ref_steps),
                       ("latent", one["latent"])):
        got = [rk[form]["losses"] for rk in ranks]
        check(got[0] == got[1], f"{form}: both ranks log the same losses")
        loss_err[form] = abs(got[0][0] - want["losses"][0]) / abs(want["losses"][0])
        check(loss_err[form] <= TOL_DP_LOSS, f"{form}: step 1's loss {got[0][0]} against one "
              f"process's {want['losses'][0]} (rel {loss_err[form]:.2e})")
    param_diff = max(float((rk[form]["params"] - ref_steps["params"].cpu()).abs().max())
                     for rk in ranks for form in ("replicated", "sharded"))
    check(all("train.steps_per_call=1" in rk["refusal"] for rk in ranks),
          f"a gloo group on the card refuses a multi-step of 20: {ranks[0]['refusal']!r}")

    # (c) the sampler and the suite
    for rk in ranks:
        check(torch.equal(rk["gen"], gen.cpu()) and torch.equal(rk["gen_latent"], gen_lat.cpu()),
              "the rank-sharded sampler's clouds equal make_sampler on each rank's seeds")
    held = {}
    for metric, (name, tol) in (("cd", ("cd_pairwise", TOL_CD)), ("emd", ("emd_pairwise", None))):
        want = mats[metric].cpu()
        same = all(torch.equal(rk[metric], want) for rk in ranks)
        if same:
            held[metric] = "bit for bit"
        else:
            # the kernel's value for a pair depends on the launch's shape: held by phase 2c's limits
            rel = max(float(((rk[metric] - want).abs() / want.abs().clamp_min(1e-12)).max())
                      for rk in ranks)
            med = max(float(((rk[metric] - want).abs() / want.abs().clamp_min(1e-12)).median())
                      for rk in ranks)
            ok = rel <= tol if tol else (med <= TOL_EMD_MEDIAN and rel <= TOL_EMD_MAX)
            check(ok, f"{name}: the row-sharded matrix against one process, rel max {rel:.3e}")
            held[metric] = (f"{name} depends on the launch's shape: rel max {rel:.3e}, "
                            f"median {med:.3e}")
    suite_keys = [k for k in metrics if k.split("-")[0] in ("mmd", "cov", "1")]
    for rk in ranks:
        check(all(rk["metrics"][k] == metrics[k] for k in suite_keys),
              f"MMD/COV/1-NNA at two ranks {[rk['metrics'][k] for k in suite_keys]} against one "
              f"process {[metrics[k] for k in suite_keys]}")
    path_kernels = ("fused_train_fwd", "fused_train_bwd", "fused_encoder_fwd", "fused_encoder_bwd",
                    "fused_latent_fwd", "fused_latent_bwd", "fused_latent_inv", "fused_sample",
                    "cd_pairwise", "emd_pairwise")
    for r, rk in enumerate(ranks):
        check(all(rk["launches"][k] > 0 for k in path_kernels),
              f"rank {r} launched every kernel of the path: {rk['launches']}")

    # (d) more cards than are visible
    visible = torch.cuda.device_count()
    try:
        train_cli.main([str(CONFIG), f"parallel.data_axis={visible + 1}",
                        "data.synthetic_size=512"])
        refused = ""
    except ValueError as e:
        refused = str(e)
    check(f"only {visible} are visible" in refused,
          f"the training CLI asked for {visible + 1} cards on {visible}: {refused!r}")

    (rep_t, rep_l), (sh_t, sh_l) = world1[False], world1[True]
    mean = lambda v: sum(v) / len(v)  # noqa: E731
    launches = {k: [rk["launches"][k] for rk in ranks] for k in path_kernels}
    print(f"data parallel (a) world-1 NCCL, the all-reduce captured, resident calls of 20 replays "
          f"bit for bit with no group (replicated and sharded), launches equal "
          f"{json.dumps(rep_l)}; ms/step in turns, replicated world-1 {mean(rep_t['world-1']):.3f} "
          f"({', '.join(f'{v:.3f}' for v in rep_t['world-1'])}) against no group "
          f"{mean(rep_t['none']):.3f} ({', '.join(f'{v:.3f}' for v in rep_t['none'])}), sharded "
          f"world-1 {mean(sh_t['world-1']):.3f} ({', '.join(f'{v:.3f}' for v in sh_t['world-1'])}) "
          f"against {mean(sh_t['none']):.3f} ({', '.join(f'{v:.3f}' for v in sh_t['none'])}); "
          f"flat gradient "
          f"{flat_bytes:,} bytes; {t_a:.1f} s ({card})")
    print(f"data parallel (b) two gloo ranks on one card, B/D=32, {DP_STEPS} eager steps: x, eps, "
          f"xnoise of every step bit for bit with one process (replicated and sharded), step 1's "
          f"gradient max per-tensor rel err {grad_err['replicated']:.3e} (sharded "
          f"{grad_err['sharded']:.3e}), step 1's loss rel err {loss_err['replicated']:.2e} "
          f"(sharded {loss_err['sharded']:.2e}, fused latent flow {loss_err['latent']:.2e}); "
          f"losses two ranks {', '.join(f'{v:.3f}' for v in ranks[0]['replicated']['losses'])} "
          f"against one process {', '.join(f'{v:.3f}' for v in ref_steps['losses'])}; params "
          f"max abs diff after {DP_STEPS} steps {param_diff:.3e}; sharded gather "
          f"{64 * DP_POINTS * 3 * 4:,} bytes a step; resident a rank "
          f"{ranks[0]['sharded']['resident_bytes'] / 1e6:.1f} MB sharded against "
          f"{ranks[0]['replicated']['resident_bytes'] / 1e6:.1f} MB replicated; "
          f"steps_per_call=20 refused")
    print(f"data parallel (c) the suite at two ranks, 64 x 64 x {DP_POINTS}: sampled clouds bit "
          f"for bit (module and fused latent inverse), CD {held['cd']}, EMD fast {held['emd']}, "
          f"MMD/COV/1-NNA equal ({', '.join(f'{k} {metrics[k]:.4f}' for k in suite_keys)}); "
          f"launches a rank {json.dumps(launches)}; (b)+(c) {t_bc:.1f} s")
    print(f"data parallel (d) the training CLI with parallel.data_axis={visible + 1}: {refused}")


# ---------------------------------------------------------------- phase 3l: the kernels' widths

LATCAP_CONFIG = ROOT / "configs" / "flagship_quality_v3_aug_latcap.yaml"
# the bf16 inverse's p99.9 against the plain version for latcap's prior (28
# layers of 512, twice the flagship's depth and width, so twice the chances
# of a flipped rounding, carried twice as far): its forward read max
# 1.64e-2, p99.9 5.28e-3 at B=64 on phase 2's weights (NVIDIA H100 80GB
# HBM3, 700.00 W), past TOL_BF16_P999, which was set on the 32-layer point
# flow at H=128; the max stays held to TOL_BF16_MAX, u and every gradient to
# TOL_GRAD_BF16 by their norms, as phase 2 holds the flagship's prior
TOL_LATCAP_P999 = 1e-2
F32_CONFIG = ROOT / "configs" / "shapenet_airplane_gen.yaml"
# the round trip of the f32 training forward and the f32 sampler's inverse
# on the same hz, on the inputs of `python -m dpfx_torch.tools.bwd_ab PARENT
# --hidden 256 --dtype float32` (B=64 x 2048, K=32, n_hidden 2, seed 3):
# what the stream layout's forward (fwd_stream<float, 256>) read there, in
# the call that measured the f32 layout's (NVIDIA H100 80GB HBM3, 700.00 W).
# The two forwards give u the same bits, so the limit is no looser than the
# stream layout's own round trip.
F32_TRIP = {"median": 2.0 ** -23, "max": 28 * 2.0 ** -23}
# the schedule of phase 3l (b)'s training runs of config #3 where its own
# (lr 1e-3 from the first step, no clip) takes the random model's fused and
# module runs both to non-finite losses from the same step (H=256): the
# flagship's warmup and clip (configs/flagship_quality_v3_aug_100k.yaml)
F32_SCHEDULE = ["train.lr_warmup_steps=1000", "train.grad_clip=1.0"]
# the shapes the mma and block-wide layouts of the forward or the
# backward overflow (fused_train.overflows_block): in bf16 the cluster
# layout's (CLUSTER_SHAPES), in f32 the f32 layout's; and one padded width
# (96 -> 128: the mma layout in bf16, the f32 layout in f32; 192 -> 256:
# the cluster layout in bf16, the f32 layout in f32), (hidden, n_hidden) in
# each compute dtype
OVERFLOW_SHAPES = {"bfloat16": ((128, 3), (128, 4), (256, 2), (256, 3), (256, 4), (96, 2), (192, 2)),
                 "float32": ((128, 3), (128, 4), (256, 1), (256, 2), (256, 3), (256, 4), (96, 2),
                             (192, 2))}
# the sampler's new f32 layout (Wh in chunks at H=256) and the padded widths
SAMPLER_SHAPES = ((256, 1), (256, 2), (256, 3), (256, 4), (96, 2), (192, 3))
# the cluster layout's shapes (kernel H, n_hidden - 1): fused_train.uses_cluster
# must take exactly these; the deep ones stream their slabs through the ring
CLUSTER_SHAPES = ((128, 2), (128, 3), (256, 1), (256, 2), (256, 3))
# the deep shapes (H, n_hidden) whose pair phase 3l times at the main shape
# (B=64 x 2048, K=32) against their bounds (all but H=128 with n_hidden 3
# on the ring); the last one is also trained through the CLI and gives the
# kernels line its *_cluster_deep rows
DEEP_SHAPES = ((128, 3), (128, 4), (256, 3), (256, 4))
DEEP = ["model.point_flow.hidden=256", "model.point_flow.n_hidden=4"]


def inverse_cases(fs, shape):
    """The cluster inverse's cases past relu with bf16 weights that phase 3l
    checks and times at a shape of fused_sampler.CLUSTER_INVERSE: (activation,
    int8) for each other activation the route takes with bf16 weights, and
    relu and gelu where it takes them with int8 weights (tanh and leaky_relu
    run gelu's instance)."""
    acts, int8_acts = fs.CLUSTER_CASES[shape]
    return ([(a, False) for a in acts]
            + [(a, True) for a in int8_acts if a in ("relu", "gelu")])
WIDE = ["model.point_flow.hidden=256"]
WIDTH_CHECK = (8, 2048, 32)     # B, N, K of the layouts' checks against the plain versions
WIDTH_MAIN = (64, 2048)         # B, N of the main paths


def held_to_plain(name: str, dtype, fwd, fwd_plain, grads=(), grads_again=(), grads_plain=(),
                  names=(), *, fwd_again):
    """Phase 2's rules for one kernel against its plain version: the
    forward's output by max abs (f32) or max and p99.9 (bf16), each further
    output and gradient by its relative norm error, the forward
    (``fwd_again``, its second run) and the backward run twice
    bit-identical. Returns the largest abs error over everything."""
    import torch

    f32 = dtype == torch.float32
    check(len(fwd_again) == len(fwd) and all(torch.equal(a, c) for a, c in zip(fwd, fwd_again)),
          f"{name} {dtype}: the forward bit-identical from run to run")
    check(float(fwd_plain[0].abs().max()) < 1e3,
          f"{name}: the seeded flow stays bounded (the absolute limits are for O(1)-O(10) "
          f"clouds): |ref| {float(fwd_plain[0].abs().max())}")
    emax, e999 = errors(fwd[0], fwd_plain[0])
    errs = {nm: rel(a, b) for nm, a, b in zip(names, list(fwd[1:]) + list(grads),
                                              list(fwd_plain[1:]) + list(grads_plain))
            if b.numel()}
    print(f"kernel-vs-plain {name} {dtype}: max_abs={emax:.3e} p99.9={e999:.3e} "
          f"(|ref|max={float(fwd_plain[0].abs().max()):.2f}); rel "
          + " ".join(f"{k}={v:.2e}" for k, v in errs.items()))
    if f32:
        check(emax <= TOL_F32, f"{name} f32: max {emax}")
    else:
        check(emax <= TOL_BF16_MAX and e999 <= TOL_BF16_P999, f"{name} bf16: {emax}, {e999}")
    tol = TOL_GRAD_F32 if f32 else TOL_GRAD_BF16
    check(all(v <= tol for v in errs.values()), f"{name} {dtype}: {errs}")
    check(all(torch.equal(a, c) for a, c in zip(grads, grads_again)),
          f"{name} {dtype}: the backward bit-identical from run to run")
    return max([emax] + [float((a - b).abs().max()) for a, b in zip(grads, grads_plain)
                         if b.numel()])


def f64_held(name: str, fwd_check, got, again, ref, ref64, plain, names):
    """An f32 kernel whose backward is ill-conditioned on its seeded inputs
    (phase 3f's finding: a relu gate within rounding of 0 flips with the
    order of the sums, and a flip moves a gradient by up to ~4e-4 of its
    norm; the point flow's plain f32 backward at K=32, B=8 x 2048 parts
    from its f64 run by 1e-5 to 2e-4, and ``flippable_gates`` counts the
    gates that an order can flip there): the forward by ``fwd_check``
    (the latent flow: phase 2's f32 rules; the point flow:
    ``f64_forward_held``), the backward bit-identical run to run and, by
    phase 3f's rule for its f32 backward, within PROBE_F64_RATIO times the
    f32 plain version's own drift from ``ref64`` (the plain version run in
    f64), or PROBE_F64_FLOOR["full"], per output; ``plain`` (the f32 plain
    version) run with TF32 products must part from ``ref64`` by more than
    every such limit. The same kernels at K=4 are held to phase 2's f32
    limits themselves."""
    import torch

    fwd_check()
    check(all(torch.equal(a, c) for a, c in zip(got, again)),
          f"{name}: the backward bit-identical from run to run")
    drift = {nm: rel(r, r64) for nm, r, r64 in zip(names, ref, ref64) if r64.numel()}
    kern = {nm: rel(a, r64) for nm, a, r64 in zip(names, got, ref64) if r64.numel()}
    limit = {nm: max(PROBE_F64_FLOOR["full"], PROBE_F64_RATIO * drift[nm]) for nm in drift}
    ctl = tf32_control(plain, ref64)
    print(f"f64-held {name}: kernel rel " + " ".join(f"{k}={v:.2e}" for k, v in kern.items())
          + "; the f32 plain version's drift " + " ".join(f"{k}={v:.2e}" for k, v in drift.items())
          + f"; TF32 control {ctl:.2e}")
    check(all(kern[nm] <= limit[nm] for nm in kern), f"{name}: {kern} against {limit}")
    check(ctl > max(limit.values()), f"{name}: the TF32 control {ctl} fails the limits {limit}")


def f64_forward_held(name: str, fwd, fwd_again, fwd_p, u64, plain):
    """The f32 forward of a 32-layer flow whose seeded weights throw some
    points far out (|u| up to ~180 at H=256), where phase 2's absolute
    limit on u, set on O(1)-O(10) clouds, meets the f32 rounding of |u|
    itself: u by its max abs error against ``u64`` (the plain version run
    in f64) within TOL_F32 or PROBE_F64_RATIO times the f32 plain
    version's own, the log-det by its relative error against the plain
    version at TOL_GRAD_F32, the forward bit-identical run to run; the
    plain version run with TF32 products must part from ``u64`` by more
    than the limit."""
    import torch

    check(all(torch.equal(a, c) for a, c in zip(fwd, fwd_again)),
          f"{name}: the forward bit-identical from run to run")
    check(float(fwd_p[0].abs().max()) < 1e3, f"{name}: the seeded flow stays bounded")
    kern = float((fwd[0].double() - u64).abs().max())
    drift = float((fwd_p[0].double() - u64).abs().max())
    limit = max(TOL_F32, PROBE_F64_RATIO * drift)
    torch.backends.cuda.matmul.allow_tf32 = True
    u_tf = plain()[0]
    torch.cuda.synchronize()
    torch.backends.cuda.matmul.allow_tf32 = False
    ctl = float((u_tf.double() - u64).abs().max())
    ld_err = rel(fwd[1], fwd_p[1])
    print(f"f64-held forward {name}: u max abs from f64 {kern:.3e}, the f32 plain version's "
          f"{drift:.3e} (|u|max={float(u64.abs().max()):.2f}); log-det rel {ld_err:.2e}; TF32 "
          f"control {ctl:.2e}")
    check(kern <= limit and ld_err <= TOL_GRAD_F32, f"{name}: u {kern} (limit {limit}), "
                                                    f"log-det {ld_err}")
    check(ctl > limit, f"{name}: the TF32 control {ctl} fails the limit {limit}")


def flippable_gates(tw, u, hz):
    """(gates, gates within rounding of 0, gates that one f32 order flips)
    of the point flow's backward recompute: the conditioners' relu
    pre-activations of every layer on the layer inputs rebuilt from u in
    f64, as the backward rebuilds them, over the units with a nonzero term
    (a padded unit is 0 in every order). Within rounding: |pre| at most
    n 2^-24 sum |terms| (n terms: what an f32 sum in some order can put on
    either side of 0). One order: the same pre-activations summed in f32 by
    torch (no TF32) on the f64 operands rounded to f32, whose sign differs
    from the f64 sum's."""
    import torch

    wx, wh, bh, wout, bout, masks, cap = (t.double() if torch.is_tensor(t) else t for t in tw)
    y, hz = u.double(), hz.double()
    counts = [0, 0, 0]

    def tally(eq, w, x, b, n):
        pre = torch.einsum(eq, w, x) + b
        mag = torch.einsum(eq, w.abs(), x.abs()) + b.abs()
        pre32 = torch.einsum(eq, w.float(), x.float()) + b.float()
        live = mag > 0
        counts[0] += int(live.sum())
        counts[1] += int((live & (pre.abs() <= n * 2.0 ** -24 * mag)).sum())
        counts[2] += int((live & ((pre > 0) != (pre32 > 0))).sum())
        return torch.relu(pre)

    for k in reversed(range(wx.shape[0])):
        h = tally("hc,bcn->bhn", wx[k], y, hz[:, k, :, None], 4)
        for j in range(wh.shape[1]):
            h = tally("oi,bin->bon", wh[k, j], h, bh[k, j][:, None], wh.shape[-1] + 1)
        st = torch.einsum("rh,bhn->brn", wout[k], h) + bout[k][:, None]
        s = cap * torch.tanh(st[:, :3] / cap)
        y = torch.where(masks[k][:, None] > 0, y, (y - st[:, 3:]) * torch.exp(-s))
    return tuple(counts)


def latent_held(name: str, dtype, u, ld, zi, u_p, ld_p, zi_p, got=(), again=(), ref=(),
                names=(), p999: float = TOL_BF16_P999, *, fwd_again):
    """Phase 2's rules for the latent flow's kernels against their plain
    versions: u and the log-det by their relative norm error, the inverse
    by its max abs (f32) or max and p99.9 (bf16), each gradient by its
    relative norm error, the forward and the inverse (``fwd_again``: u, the
    log-det and the inverse again) and the backward bit-identical run to
    run."""
    import torch

    f32 = dtype == torch.float32
    check(len(fwd_again) == 3 and all(torch.equal(a, c) for a, c in zip((u, ld, zi), fwd_again)),
          f"{name} {dtype}: the forward and the inverse bit-identical from run to run")
    tol = TOL_GRAD_F32 if f32 else TOL_GRAD_BF16
    check(float(u_p.abs().max()) < 1e3 and float(zi_p.abs().max()) < 1e3,
          f"{name}: the seeded prior stays bounded: |u| {float(u_p.abs().max())}, "
          f"|z| {float(zi_p.abs().max())}")
    emax, e999 = errors(zi, zi_p)
    gerr = {nm: rel(a, r) for nm, a, r in zip(names, got, ref) if r.numel()}
    print(f"kernel-vs-plain {name} {dtype}: u rel {rel(u, u_p):.3e}, log-det rel "
          f"{rel(ld, ld_p):.3e}; inverse max_abs={emax:.3e} p99.9={e999:.3e} (|z|max="
          f"{float(zi_p.abs().max()):.2f}); grad rel "
          + " ".join(f"{kk}={v:.2e}" for kk, v in gerr.items()))
    check(rel(u, u_p) <= tol and rel(ld, ld_p) <= tol and all(v <= tol for v in gerr.values()),
          f"{name} {dtype}: u {rel(u, u_p)}, log-det {rel(ld, ld_p)}, grads {gerr}")
    if f32:
        check(emax <= TOL_F32, f"{name} inverse f32: {emax}")
    else:
        check(emax <= TOL_BF16_MAX and e999 <= p999,
              f"{name} inverse bf16: max {emax}, p99.9 {e999} (limit {p999})")
    check(all(torch.equal(a, c) for a, c in zip(got, again)),
          f"{name} {dtype}: the backward bit-identical from run to run")


def fused_latent_sampler(model, b: int, n: int):
    """make_sampler(model, b, n) with DPFX_SAMPLE_FUSED_LATENT=1: the
    latent inverse in one kernel."""
    from dpfx_torch.sampling import make_sampler

    old = os.environ.get("DPFX_SAMPLE_FUSED_LATENT")
    os.environ["DPFX_SAMPLE_FUSED_LATENT"] = "1"
    try:
        return make_sampler(model, b, n)
    finally:
        if old is None:
            os.environ.pop("DPFX_SAMPLE_FUSED_LATENT")
        else:
            os.environ["DPFX_SAMPLE_FUSED_LATENT"] = old


@contextlib.contextmanager
def forced_layout(fs, layout: str):
    """Within the block, the sampler's bf16 route takes ``layout``
    ("cluster" or "rows") wherever the cluster inverse is built for the
    shape and the case (the library's dpfx_fused_sampler_cluster_built);
    what ran before it: rows_kernel."""
    route = fs.inverse_layout

    def forced(h, nh1, dtype, activation="relu", int8=False):
        got = route(h, nh1, dtype, activation, int8)
        built = got != "f32" and fs._cluster_lib().dpfx_fused_sampler_cluster_built(
            h, nh1, fs.ACT_CODES[activation], int(int8)) == 1
        return layout if built else got

    fs.inverse_layout = forced
    try:
        yield
    finally:
        fs.inverse_layout = route


def inverse_turns(fs, call, iters: int = 5):
    """(cluster inverse ms, rows_kernel ms) of ``call`` timed in turns
    (cluster, rows, rows, cluster; the means of each layout's two)."""
    ms = {"cluster": [], "rows": []}
    for lay in ("cluster", "rows", "rows", "cluster"):
        with forced_layout(fs, lay):
            ms[lay].append(cuda_ms(call, iters))
    return sum(ms["cluster"]) / 2, sum(ms["rows"]) / 2


def sampler_entry_points(dev, card, ddir: Path, finite: bool, flagship_like) -> dict:
    """Phase 3l (a2)'s bf16 sampler at H=256 through the entry points a user
    calls, counts from 0 around each: ``generate`` on the checkpoint of the
    fused CLI run at n_hidden 4 in ``ddir`` (its clouds finite where that
    run stayed finite), ``make_sampler(64, 2048)`` on a seeded gelu model at
    n_hidden 2, and ``bench_sample_int8 --run-flow`` on the same checkpoint
    (B=64, reps 2): every sampler launch on the cluster inverse. Removes
    ``ddir``. Returns each case's launches, keyed (H, n_hidden, activation,
    int8)."""
    import contextlib
    import io
    import shutil

    import numpy as np
    import torch
    import yaml

    from dpfx_torch import generate
    from dpfx_torch.ops import fused_sampler as fs
    from dpfx_torch.sampling import make_sampler
    from dpfx_torch.tools import bench_sample_int8

    bm, nm = WIDTH_MAIN
    cluster_only = lambda n: fs.layout_launches == {"rows": 0, "cluster": n, "f32": 0}  # noqa: E731
    # generate on the checkpoint of the fused run
    fs.reset_launch_counts()
    out_npy = ddir / "generated.npy"
    buf, t0 = io.StringIO(), time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = generate.main([str(CONFIG), *DEEP, f"train.ckpt_dir={ddir}", "data.synthetic_size=512",
                            "--n-clouds", str(bm), "--n-points", str(nm), "--out", str(out_npy)])
    torch.cuda.synchronize()
    gen_wall = time.perf_counter() - t0
    print(buf.getvalue(), end="")
    clouds = np.load(out_npy)
    gen_n = fs.launches["fused_sample"]
    check(rc == 0 and clouds.shape == (bm, nm, 3) and (bool(np.isfinite(clouds).all()) or not finite),
          f"generate at H=256 n_hidden 4: rc {rc}, {clouds.shape}")
    check(gen_n >= 1 and cluster_only(gen_n),
          f"generate at H=256 n_hidden 4 samples on the cluster inverse: {fs.layout_launches}")
    # make_sampler on a seeded gelu model at n_hidden 2
    gelu = flagship_like([*WIDE, "model.point_flow.activation=gelu"], 21).eval()
    check(gelu.point_flow.activation == "gelu", "the gelu point flow")
    sampler_g = make_sampler(gelu, bm, nm)
    fs.reset_launch_counts()
    xg = sampler_g(5)
    torch.cuda.synchronize()
    check(xg.shape == (bm, nm, 3) and bool(torch.isfinite(xg).all()) and cluster_only(1),
          f"make_sampler at H=256 n_hidden 2 gelu: {fs.layout_launches}")
    gelu_ms = cuda_ms(lambda: sampler_g(6), 3)
    gelu_n = 1
    del gelu, sampler_g, xg
    # bench_sample_int8 on the same checkpoint, its run's own point flow
    y = yaml.safe_load(CONFIG.read_text())
    y["model"]["point_flow"].update(hidden=256, n_hidden=4)
    y["train"]["ckpt_dir"] = str(ddir)
    y["data"]["synthetic_size"] = 512
    i8_cfg = ddir / "int8.yaml"
    i8_cfg.write_text(yaml.safe_dump(y))
    env = {"DPFX_INT8_CKPT": str(i8_cfg), "DPFX_INT8_B": str(bm), "DPFX_INT8_REPS": "2"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    fs.reset_launch_counts()
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            rc = bench_sample_int8.main(["--run-flow"])
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    torch.cuda.synchronize()
    print(buf.getvalue(), end="")
    lines = buf.getvalue().strip().splitlines()
    i8 = json.loads(lines[-2])
    i8_n = dict(fs.launches)
    check(rc == 0 and i8["weights"].endswith("@10") and i8["shapes"][0] == bm,
          f"bench_sample_int8 --run-flow on the H=256 n_hidden 4 checkpoint: {i8}")
    check(i8_n["fused_sample"] > 0 and i8_n["fused_sample_int8"] > 0
          and cluster_only(i8_n["fused_sample"] + i8_n["fused_sample_int8"]),
          f"bench_sample_int8 at H=256 n_hidden 4 samples on the cluster inverse: {i8_n}, "
          f"{fs.layout_launches}")
    shutil.rmtree(ddir, ignore_errors=True)
    print(f"(a2) the bf16 sampler at H=256 through its entry points, every launch on the cluster "
          f"inverse: generate on the n_hidden 4 checkpoint {gen_n} launches in {gen_wall:.1f} s "
          f"wall; make_sampler({bm}, {nm}) gelu n_hidden 2 {gelu_ms:.3f} ms/batch; "
          f"bench_sample_int8 --run-flow (B={bm}, reps 2): bf16 {i8['bf16_ms']} ms, int8 "
          f"{i8['int8_ms']} ms, int8 against bf16 relative RMS {i8['rel_rms']}, launches "
          f"{json.dumps(i8_n)} ({card})")
    return {(256, 4, "relu", False): gen_n + i8_n["fused_sample"],
            (256, 2, "gelu", False): gelu_n, (256, 4, "relu", True): i8_n["fused_sample_int8"]}


def shapes_path(dev, card, x20, h128_replayed):
    """Phase 3l. The kernels at the widths and depths off the flagship's
    grid: every layout past the mma and block-wide ones and one padded
    width per family against the plain versions by phase 2's rules, then
    (a) the flagship widened to H=256 trained, sampled and evaluated, (a2)
    the deep bf16 pairs timed and the flagship at H=256 n_hidden 4 trained
    fused and on the module path, (b) the f32 config #3 at H=256 sampled
    and evaluated, (c) latcap trained and sampled with the fused latent
    flow. ``x20`` are phase 3b's batches, ``h128_replayed`` its
    replayed call of 20 steps. Returns the kernels line's rows of the new
    layouts."""
    import copy
    import shutil

    import numpy as np
    import torch

    from dpfx_torch.compat import randomize_
    from dpfx_torch.config import load_config
    from dpfx_torch.models import DPF
    from dpfx_torch.models.coupling import CouplingFlow
    from dpfx_torch.ops import fused_encoder as fe
    from dpfx_torch.ops import fused_latent as fl
    from dpfx_torch.ops import fused_sampler as fs
    from dpfx_torch.ops import fused_train as ft
    from dpfx_torch.sampling import make_sampler
    from dpfx_torch.train import trainer as tm

    t_phase = time.perf_counter()
    bm, nm = WIDTH_MAIN
    bc, nc, kc = WIDTH_CHECK
    g = torch.Generator(device=dev).manual_seed(31)
    grad_names = ["log-det", "dx", "dhz", "dwx", "dwh", "dbh", "dwout", "dbout"]
    windows = lambda ls: [sum(ls[i:i + 5]) / 5 for i in (0, 5)]  # noqa: E731

    def flagship_like(over, seed, path=CONFIG):
        # phase 2's weights (the module init, then seeded noise), the noise
        # scaled by sqrt(128 / H) so that a conditioner's sums vary as the
        # flagship's at 0.02: at 0.02 itself the 32-layer flow at H=256
        # with n_hidden 1 reaches |u| ~ 4e4 (3e13 from flax's init), where
        # no absolute limit means anything; scaled, every shape here stays
        # below ~40 (a CPU sweep of the plain versions)
        c = load_config(str(path), overrides=over)
        torch.manual_seed(seed)
        h = fs.kernel_hidden(c.model.point_flow.hidden)
        return randomize_(DPF(c), seed, 0.02 * (128 / h) ** 0.5).to(dev)

    def flow_stack(h, nh, k=kc, seed=0):
        m = flagship_like([f"model.point_flow.hidden={h}", f"model.point_flow.n_hidden={nh}",
                           f"model.point_flow.n_layers={k}"], seed)
        with torch.no_grad():
            return fs.stack_point_flow_params(m.point_flow)

    def train_runs(tw, xt, hz, dt):
        # the kernels' forward twice, the plain forward, and the backward
        # twice from the plain forward's u, with the plain backward
        u, ld = ft.fused_forward_kernel(*tw, xt, hz, dt)
        u2, ld2 = ft.fused_forward_kernel(*tw, xt, hz, dt)
        u_p, ld_p = ft.fused_forward_plain(*tw, xt, hz, dt)
        du = torch.randn(u.shape, generator=g, device=dev)
        dld = torch.randn(ld.shape, generator=g, device=dev)
        got = ft.fused_backward_kernel(*tw, u_p, hz, du, dld, dt)
        again = ft.fused_backward_kernel(*tw, u_p, hz, du, dld, dt)
        ref = ft.fused_backward_plain(*tw, u_p, hz, du, dld, dt)
        torch.cuda.synchronize()
        return (u, ld), (u2, ld2), (u_p, ld_p), du, dld, got, again, ref

    def flow_inputs(sp):
        xt = torch.randn((bc, 3, nc), generator=g, device=dev)
        return xt, fs.z_projection(sp, torch.randn((bc, 128), generator=g, device=dev))

    # every layout past the mma and block-wide ones and the padded widths: fused_train forward and
    # backward at K=4 by phase 2's limits in both dtypes, and at K=32, B=8,
    # N=2048 (bf16: phase 2's limits; f32: phase 3f's f64 rule, where the
    # backward at this depth is ill-conditioned), each forward and backward
    # twice bit-identical
    for dname, shapes in OVERFLOW_SHAPES.items():
        dt = getattr(torch, dname)
        for h, nh in shapes:
            for k in (4, kc):
                sp = flow_stack(h, nh, k)
                kh, nh1 = sp.wx.shape[1], sp.wh.shape[1]
                check(kh == fs.kernel_hidden(h), f"H={h} padded to {kh}")
                tw = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
                xt, hz = flow_inputs(sp)
                fwd, fwd2, fwd_p, du, dld, got, again, ref = train_runs(tw, xt, hz, dt)
                layout = ft._layout(kh, nh1, dt, True)
                overflow = (kh == 128 and nh1 >= 2) or (kh == 256 and (nh1 >= 1 or dname == "float32"))
                want = ("f32" if dname == "float32" else "cluster" if overflow else "parent")
                check(want != "cluster" or (kh, nh1) in CLUSTER_SHAPES, f"H={h} n_hidden={nh}")
                check(layout == want, f"H={h} n_hidden={nh} {dname} takes the {layout} layout")
                tname = f"fused_train H={h}->{kh} n_hidden={nh} ({layout} layout) K={k} B={bc} N={nc}"
                if dname == "float32" and k == kc:
                    w64 = tuple(t.double() if torch.is_tensor(t) else t for t in tw)
                    u64 = ft.fused_forward_plain(*w64, xt.double(), hz.double(), torch.float64)[0]
                    ref64 = ft.fused_backward_plain(*w64, fwd_p[0].double(), hz.double(),
                                                    du.double(), dld.double(), torch.float64)
                    gates = flippable_gates(tw, fwd_p[0], hz)
                    f64_held(tname, lambda: f64_forward_held(
                                 tname, fwd, fwd2, fwd_p, u64,
                                 lambda: ft.fused_forward_plain(*tw, xt, hz, dt)),
                             got, again, ref, ref64,
                             lambda: ft.fused_backward_plain(*tw, fwd_p[0], hz, du, dld, dt),
                             grad_names[1:])
                    print(f"relu gates of {tname}'s backward recompute: {gates[0]:,}; "
                          f"within the f32 rounding of 0 {gates[1]:,}; flipped by torch's f32 "
                          f"sums {gates[2]:,}")
                    del ref64, u64
                else:
                    held_to_plain(tname, dt, fwd, fwd_p, got, again, ref, grad_names,
                                  fwd_again=fwd2)
                del got, again, ref

    # the f32 layout's forward is the block-wide layout's arithmetic (each
    # sum over k in order, the same 128-point block and log-det sum): forced
    # onto the block-wide pair where both fit (H=128, n_hidden 1-2), the same
    # bits; its backward sums the weight gradients over other tiles (128
    # points against 32), held to phase 2's f32 limits
    f32 = torch.float32
    for nh in (1, 2):
        sp = flow_stack(128, nh, 4)
        tw = (sp.wx, sp.wh, sp.bh, sp.wout, sp.bout, sp.masks, sp.scale_cap)
        xt, hz = flow_inputs(sp)
        check(not ft.overflows_block(128, nh - 1, f32), f"H=128 n_hidden={nh} f32 fits the block-wide "
                                                    "layout")
        u, ld = ft.fused_forward_kernel(*tw, xt, hz, f32)
        du = torch.randn(u.shape, generator=g, device=dev)
        dld = torch.randn(ld.shape, generator=g, device=dev)
        got = ft.fused_backward_kernel(*tw, u, hz, du, dld, f32)
        f32_layout = ft.uses_f32
        ft.uses_f32 = lambda *a: False
        try:
            check(ft._layout(128, nh - 1, f32, True) == "parent", "forced onto the block-wide pair")
            ub, ldb = ft.fused_forward_kernel(*tw, xt, hz, f32)
            gb_ = ft.fused_backward_kernel(*tw, u, hz, du, dld, f32)
        finally:
            ft.uses_f32 = f32_layout
        torch.cuda.synchronize()
        same = {nm: torch.equal(a, c) for nm, a, c in zip(grad_names[1:], got, gb_)}
        gerr = {nm: rel(a, c) for nm, a, c in zip(grad_names[1:], got, gb_) if c.numel()}
        print(f"fused_train f32 H=128 n_hidden={nh} K=4 B={bc} N={nc}, f32 layout against the "
              f"block-wide one: u same bits {torch.equal(ub, u)}, log-det same bits "
              f"{torch.equal(ldb, ld)}; backward same bits "
              + " ".join(f"{kk}={v}" for kk, v in same.items()) + "; rel "
              + " ".join(f"{kk}={v:.2e}" for kk, v in gerr.items()))
        check(torch.equal(ub, u) and torch.equal(ldb, ld),
              f"the f32 layout's forward has the block-wide one's bits (n_hidden={nh})")
        check(all(v <= TOL_GRAD_F32 for v in gerr.values()),
              f"the f32 layout's backward against the block-wide one: {gerr}")
        del got, gb_

    # the sampler: the f32 layout at H=256 and the padded widths, K=32, B=8
    for h, nh in SAMPLER_SHAPES:
        sp = flow_stack(h, nh)
        for dt in (torch.float32, torch.bfloat16):
            ut = torch.randn((bc, 3, nc), generator=g, device=dev)
            z = torch.randn((bc, 128), generator=g, device=dev)
            x = fs.fused_inverse_transposed(sp, ut, z, dtype=dt)
            x2 = fs.fused_inverse_transposed(sp, ut, z, dtype=dt)
            xp = fs.fused_inverse_transposed_plain(sp, ut, fs.z_projection(sp, z), dt, "relu")
            torch.cuda.synchronize()
            held_to_plain(f"fused_inverse H={h}->{sp.wx.shape[1]} n_hidden={nh} B={bc} N={nc}", dt,
                          (x,), (xp,), (x,), (x2,), (xp,), ("x",), fwd_again=(x2,))
        if h == 256:
            q = fs.quantize_flow_params(sp)
            dq = fs.dequantize(q)
            z = torch.randn((bc, 128), generator=g, device=dev)
            xa = fs.fused_sample_points(sp, z, 5, nc, dtype=torch.float32, quantized=q)
            xb = fs.fused_sample_points(sp._replace(wx=dq.wx, wh=dq.wh, wout=dq.wout), z, 5, nc,
                                        dtype=torch.float32)
            torch.cuda.synchronize()
            check(torch.equal(xa, xb), f"the int8 f32 sampler at H=256 n_hidden={nh} equals "
                                       "the f32 one on the dequantized stacks")

    # the latent flow at dz=24 (padded to 32), 4 and the flagship's 14
    # layers of 256, B=64: the kernels on the padded stacks (at 4 layers by
    # phase 2's limits in both dtypes; at 14 the f32 backward by phase 3f's
    # f64 rule), and the public entry points
    lat = lambda r: [r[0]] + [r[1][kk] for kk in fl.KEYS]  # noqa: E731
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        for nl in (4, 14):
            lflow = flagship_like(["model.dz=24", f"model.latent_flow.n_layers={nl}"], 3).latent_flow
            check((lflow.n_layers, lflow.dim) == (nl, 24), "the latent flow at dz=24")
            with torch.no_grad():
                lw = fl.pad_latent_params(fl.stack_latent_params(lflow))
            mp = fl.latent_masks(nl, 24, dev, 32)
            z = torch.nn.functional.pad(torch.randn((bm, 24), generator=g, device=dev), (0, 8))
            u, ld = fl.latent_forward_kernel(lw, mp, 3.0, z, dt)
            zi = fl.latent_inverse_kernel(lw, mp, 3.0, z, dt)
            again_fwd = (*fl.latent_forward_kernel(lw, mp, 3.0, z, dt),
                         fl.latent_inverse_kernel(lw, mp, 3.0, z, dt))
            u_p, ld_p = fl.latent_forward_plain(lw, mp, 3.0, z, dt)
            zi_p = fl.latent_inverse_plain(lw, mp, 3.0, z, dt)
            du = torch.nn.functional.pad(torch.randn((bm, 24), generator=g, device=dev), (0, 8))
            dld = torch.randn((bm,), generator=g, device=dev)
            got = lat(fl.latent_backward_kernel(lw, mp, 3.0, u_p, du, dld, dt))
            again = lat(fl.latent_backward_kernel(lw, mp, 3.0, u_p, du, dld, dt))
            ref = lat(fl.latent_backward_plain(lw, mp, 3.0, u_p, du, dld, dt))
            torch.cuda.synchronize()
            check(not u[:, 24:].any() and not zi[:, 24:].any() and not got[0][:, 24:].any(),
                  "the padded latent features pass through as 0 and take no cotangent")
            lname = f"fused_latent dz=24->32 K={nl} H=256 B={bm}"
            if dname == "float32" and nl == 14:
                w64 = {kk: v.double() for kk, v in lw.items()}
                ref64 = lat(fl.latent_backward_plain(w64, mp.double(), 3.0, u_p.double(),
                                                     du.double(), dld.double(), torch.float64))
                f64_held(lname, lambda: latent_held(lname, dt, u, ld, zi, u_p, ld_p, zi_p,
                                                    fwd_again=again_fwd),
                         got, again, ref, ref64,
                         lambda: lat(fl.latent_backward_plain(lw, mp, 3.0, u_p, du, dld, dt)),
                         ["dz"] + list(fl.KEYS))
            else:
                latent_held(lname, dt, u, ld, zi, u_p, ld_p, zi_p, got, again, ref,
                            ["dz"] + list(fl.KEYS), fwd_again=again_fwd)
            del got, again, ref
        lcfg = load_config(str(CONFIG), overrides=["model.dz=24"]).model.latent_flow
        lcfg.compute_dtype = dname
        check(fl.fused_latent_supported(lcfg, 24), f"dz=24 is in the latent domain ({dname})")
        eps = torch.randn((bm, 24), generator=g, device=dev)
        fl.reset_launch_counts()
        with torch.no_grad():
            zf = fl.fused_latent_inverse(fl.stack_latent_params(lflow), eps, lcfg)
        torch.cuda.synchronize()
        zpl = fl.latent_inverse_plain(lw, mp, 3.0, torch.nn.functional.pad(eps, (0, 8)), dt)[:, :24]
        check(fl.launches["fused_latent_inv"] == 1 and zf.shape == (bm, 24)
              and torch.equal(zf, fl.latent_inverse_kernel(
                  lw, mp, 3.0, torch.nn.functional.pad(eps, (0, 8)).contiguous(), dt)[:, :24])
              and rel(zf, zpl) <= (TOL_GRAD_F32 if dname == "float32" else TOL_GRAD_BF16),
              f"fused_latent_inverse at dz=24 ({dname})")

    # the encoder at point widths (120, 200), padded to (128, 208), B=8
    for dname in ("bfloat16", "float32"):
        dt = getattr(torch, dname)
        torch.manual_seed(4)
        from dpfx_torch.models import PointNetEncoder

        enc = randomize_(PointNetEncoder(128, (120, 200), (256,), dt), 4, 0.1).to(dev)
        ws, bs = fe.encoder_point_weights(enc)
        pws, pbs = fe.pad_point_layers([w.detach() for w in ws], [b_.detach() for b_ in bs])
        check([tuple(w.shape) for w in pws] == [(128, 3), (208, 128)], "encoder widths padded")
        xc = torch.randn((bc, nc, 3), generator=g, device=dev)
        xc[0, nc // 2:] = xc[0, :nc - nc // 2].clone()
        pk, ck = fe.pool_forward_kernel(pws, pbs, xc, dt)
        pk2, _ = fe.pool_forward_kernel(pws, pbs, xc, dt)
        pp, cp = fe.pool_forward_plain(pws, pbs, xc, dt)
        dg = torch.nn.functional.pad(torch.randn((bc, 200), generator=g, device=dev), (0, 8))
        flat = lambda r: [r[0]] + list(r[1]) + list(r[2])  # noqa: E731
        got = flat(fe.pool_backward_kernel(pws, pbs, xc, pk, ck, dg, dt))
        again = flat(fe.pool_backward_kernel(pws, pbs, xc, pk, ck, dg, dt))
        ref = flat(fe.pool_backward_plain(pws, pbs, xc, pp, cp, dg, dt))
        torch.cuda.synchronize()
        check(not pk[:, 200:].any(), "the padded channels pool to 0")
        held_to_plain(f"fused_encoder widths (120, 200)->(128, 208) B={bc} N={nc}", dt, (pk,), (pp,),
                      got, again, ref, ["dx", "dW0", "dW1", "db0", "db1"], fwd_again=(pk2,))
        mu, lv = fe.fused_pointnet_posterior(enc, xc)
        mu_m, lv_m = enc(xc)
        check(rel(mu, mu_m) <= TOL_GRAD_BF16 and rel(lv, lv_m) <= TOL_GRAD_BF16,
              f"the fused posterior at widths (120, 200) against the module ({dname}): "
              f"{rel(mu, mu_m)}, {rel(lv, lv_m)}")
    taken = [(hh, nn) for hh in ft.WIDE_HIDDEN for nn in range(6)
             if ft.uses_cluster(hh, nn, torch.bfloat16)]
    check(taken == list(CLUSTER_SHAPES), f"uses_cluster takes {taken}, not {CLUSTER_SHAPES}")
    regs = cluster_ptxas()
    regs.update(f32_layout_ptxas())
    f32_regs = sampler_ptxas("f32_kernelIfLi256E")
    inv_regs = inverse_ptxas()
    check(all("regs" in regs.get(f"fused_train_{kk} cluster H={hh} n_hidden={nh1 + 1}", {})
                  for kk in ("fwd", "bwd") for hh, nh1 in CLUSTER_SHAPES)
          and all(any(kk.startswith(f"fused_train_{d} f32 H={hh}") and "regs" in v
                      for kk, v in regs.items()) for d in ("fwd", "bwd") for hh in (128, 256))
          and not f32_regs.startswith("None")
          and all("regs" in inv_regs.get(f"inv_cluster<{hh}, {nh1}, ReluNan, bf16>", {})
                  for hh, nh1 in fs.CLUSTER_INVERSE),
          f"ptxas reported the new layouts: {regs}, the f32 sampler at H=256 {f32_regs}, "
          f"the cluster inverse {inv_regs}")
    print("ptxas of the new layouts: " + "; ".join(
        f"{kk} {v.get('regs')} registers, spilled bytes (stores/loads) {v.get('spill')}"
        for kk, v in sorted(regs.items())) + f"; fused_sample f32 H=256 (f32_kernel<float, 256>) "
        f"{f32_regs}; " + "; ".join(
            f"{kk} {v.get('regs')} registers, spilled bytes (stores/loads) {v.get('spill')}"
            for kk, v in sorted(inv_regs.items())))
    t_checks = time.perf_counter() - t_phase

    # (a) the flagship with its point flow widened to H=256: the CLI trains
    # 10 steps as one resident call, the fused point flow and encoder on
    wide_dir = WORK / "train_h256"
    shutil.rmtree(wide_dir, ignore_errors=True)
    for mod in (ft, fe, fl):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    rc, _, calls, init_weights = train_cli_run(
        [str(CONFIG), *WIDE, "train.steps=10", "train.steps_per_call=10", "train.log_every=5",
         f"train.lr_decay_steps={TRAIN_STEPS}", "train.ckpt_every=10",
         f"train.ckpt_dir={wide_dir}", "data.synthetic_size=512"],
        scale=0.02 * (128 / 256) ** 0.5, flax=False)
    torch.cuda.synchronize()
    wide_wall = time.perf_counter() - t0
    wide_launches = {**ft.launches, **fe.launches}
    wide_layouts = dict(ft.layout_launches)
    cfg_a = load_config(str(CONFIG), overrides=WIDE)
    run_dir = wide_dir / cfg_a.name
    recs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    trecs = [r for r in recs if r["kind"] == "train"]
    check(rc == 0 and [kk for kk, _ in calls] == [10] and [r["step"] for r in trecs] == [10],
          f"H=256 train calls {calls}, records {trecs}")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
              and r["nonfinite_skipped"] == 0 for r in trecs)
          and all(np.isfinite(v) for _, ls in calls for v in ls),
          f"H=256 training: every loss finite, no step skipped: {trecs}")
    check(ft._layout(256, 1, torch.bfloat16, True) == "cluster",
          "H=256 n_hidden 2 bf16 trains on the cluster layout")
    for kname in ("fused_train_fwd", "fused_train_bwd", "fused_encoder_fwd", "fused_encoder_bwd"):
        want = tm._WARMUP + 10 + (VAL_BATCHES if kname.endswith("fwd") else 0)
        check(wide_launches[kname] == want, f"H=256 kernel {kname}: {wide_launches[kname]} launches")
    for d in ("fwd", "bwd"):
        check(wide_layouts[f"cluster_{d}"] == wide_launches[f"fused_train_{d}"],
              f"H=256: every fused_train {d} launch on the cluster layout: {wide_layouts}")
    wide_pt = run_dir / "params_00000010.pt"
    trained = torch.load(wide_pt, map_location="cpu", weights_only=True)
    check(trained["point_flow.coupling_0.cond_net.in_x.weight"].shape[0] == 256,
          "the trained point flow is 256 wide")
    moved = sum(not torch.equal(trained[kk], v) for kk, v in init_weights.items())
    check(moved == len(init_weights), f"{moved} of {len(init_weights)} parameters moved (H=256)")
    # its first step against the module path: same weights, batch and noise
    gb = torch.Generator(device=dev).manual_seed(16)
    batch = {"x": x20[0], "eps": torch.randn((bm, 128), generator=gb, device=dev),
             "xnoise": torch.randn((bm, nm, 3), generator=gb, device=dev)}
    ref_model = flagship_like(WIDE, 1)
    mcfg = copy.deepcopy(cfg_a)
    mcfg.train.fused_point_flow = mcfg.train.fused_encoder = False
    out = {}
    for name, c in (("fused", cfg_a), ("module", mcfg)):
        m = copy.deepcopy(ref_model)
        txm = tm.make_optimizer(c.train)
        _, mm = tm.make_train_step(m, txm, c)(tm.init_state(m, txm), batch)
        out[name] = (float(mm["loss"]), float(mm["grad_norm"]))
    (lf, gf), (lm, gm) = out["fused"], out["module"]
    print(f"H=256 fused step vs module path: loss {lf:.4f} vs {lm:.4f} (rel "
          f"{abs(lf - lm) / abs(lm):.2e}), grad norm {gf:.4f} vs {gm:.4f} (rel "
          f"{abs(gf - gm) / abs(gm):.2e})")
    check(abs(lf - lm) <= TOL_STEP_LOSS * abs(lm) and abs(gf - gm) <= TOL_STEP_GNORM * abs(gm),
          "the H=256 fused step agrees with the module path")
    del ref_model, m
    # the replayed step at H=256 timed in turns with phase 3b's at H=128
    wm = flagship_like(WIDE, 1)
    wtx = tm.make_optimizer(cfg_a.train)
    wmulti = tm.make_multi_step(wm, wtx, cfg_a)
    wide_call = [lambda st: wmulti(st, {"x": x20}), tm.init_state(wm, wtx)]
    wide_call[1], _ = wide_call[0](wide_call[1])      # the capture
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    step_ms = {"H=128": [], "H=256": []}
    for key, call in (("H=128", h128_replayed), ("H=256", wide_call), ("H=256", wide_call),
                      ("H=128", h128_replayed)):
        torch.cuda.synchronize()
        start.record()
        call[1], mtr = call[0](call[1])
        end.record()
        torch.cuda.synchronize()
        check(bool(torch.isfinite(mtr["loss"]).all()), f"replayed {key} steps finite")
        step_ms[key].append(start.elapsed_time(end) / 20)
    del wmulti, wide_call, wm
    # its sampler and the evaluation CLI on its checkpoint
    model_a = DPF(cfg_a).to(dev).eval()
    model_a.load_state_dict({kk: v.to(dev) for kk, v in trained.items()})
    sampler_a = make_sampler(model_a, bm, nm)
    fs.reset_launch_counts()
    xa = sampler_a(3)
    torch.cuda.synchronize()
    check(fs.launches["fused_sample"] == 1 and xa.shape == (bm, nm, 3)
          and bool(torch.isfinite(xa).all()), "the H=256 sampler")
    rc, res_a, _, eval_a = run_eval_cli([str(CONFIG), *WIDE, f"train.ckpt_dir={wide_dir}",
                                         "data.synthetic_size=512", "--limit", "64"])
    # the sampler's call and the evaluation's, all on the cluster inverse
    bf_sample_launches = fs.launches["fused_sample"]
    sample_layouts = dict(fs.layout_launches)
    check(bf_sample_launches >= 2 and sample_layouts == {"rows": 0, "cluster": bf_sample_launches,
                                                         "f32": 0},
          f"H=256: every sampler launch on the cluster inverse: {bf_sample_launches} launches, "
          f"by layout {sample_layouts}")
    smp_a = cuda_ms(lambda: sampler_a(4), 5)
    # the same with the latent inverse in one kernel: the module latent flow
    # (~450 small kernels) is host-bound, and hides the point flow's kernel
    sampler_af = fused_latent_sampler(model_a, bm, nm)
    smp_af = cuda_ms(lambda: sampler_af(4), 5)
    check(rc == 0 and res_a["n_test"] == 64 and finite_numbers(res_a),
          f"the H=256 evaluation: {res_a}")
    print(f"(a) flagship at H=256 n_hidden 2 bf16: 10 steps (one resident call) in "
          f"{wide_wall:.1f} s wall; launches {json.dumps(wide_launches)}; loss "
          + ", ".join(f"{r['loss']:.1f}" for r in trecs) + "; grad norm "
          + ", ".join(f"{r['grad_norm']:.1f}" for r in trecs)
          + f"; replayed step in turns (ms/step) {json.dumps(step_ms)}; make_sampler({bm}, {nm}) "
          f"{smp_a:.3f} ms ({smp_af:.3f} with the fused latent inverse); sampler launches by "
          f"layout (its call and the evaluation's) {json.dumps(sample_layouts)}; evaluation "
          f"--limit 64 in {eval_a:.1f} s: 1-NNA-CD "
          f"{res_a['1-nna-cd']:.4f}, 1-NNA-EMD {res_a['1-nna-emd']:.4f} ({card})")

    # the cluster layout's rows at the main path's shapes (B=64, N=2048, K=32,
    # H=256, n_hidden 2, bf16), on the seeded initial weights: ten chaotic
    # steps of the random model (grad norms ~1e7) leave a flow that sends
    # clouds to |u| ~ 1e7, where no absolute limit means anything
    bf = torch.bfloat16
    with torch.no_grad():
        sp_a = fs.stack_point_flow_params(flagship_like(WIDE, 1).point_flow)
    tw = (sp_a.wx, sp_a.wh, sp_a.bh, sp_a.wout, sp_a.bout, sp_a.masks, sp_a.scale_cap)
    xt = x20[1].transpose(1, 2).contiguous()
    za = torch.randn((bm, 128), generator=g, device=dev)
    hz = fs.z_projection(sp_a, za)
    check(ft._layout(256, 1, bf, False) == "cluster", "the main shape runs the cluster layout")
    (u_k, ld_k), fwd2, (u_p, ld_p), du, dld, got, again, ref = train_runs(tw, xt, hz, bf)
    held_to_plain(f"fused_train (cluster layout) B={bm} N={nm} K={sp_a.wx.shape[0]} H=256 "
                  "n_hidden 2", bf, (u_k, ld_k), (u_p, ld_p), got, again, ref, grad_names,
                  fwd_again=fwd2)
    f_err = errors(u_k, u_p)[0]
    b_err = max(float((a - r).abs().max()) for a, r in zip(got, ref) if r.numel())
    del got, again, ref
    tf_ms = cuda_ms(lambda: ft.fused_forward_kernel(*tw, xt, hz, bf), 5)
    tb_ms = cuda_ms(lambda: ft.fused_backward_kernel(*tw, u_p, hz, du, dld, bf), 3)
    tf_plain = cuda_ms(lambda: ft.fused_forward_plain(*tw, xt, hz, bf), 2, warmup=1)
    tb_plain = cuda_ms(lambda: ft.fused_backward_plain(*tw, u_p, hz, du, dld, bf), 1, warmup=1)
    (b_tf, by_tf), (b_tb, by_tb) = train_bounds(sp_a, bm, nm)
    print(f"fused_train at B={bm} N={nm} K=32 H=256 n_hidden 2 bf16, cluster layout (forward, "
          f"backward): {tf_ms:.3f} / {tb_ms:.3f} ms = {tf_ms / b_tf:.2f}x / {tb_ms / b_tb:.2f}x the "
          f"bound ({b_tf:.4f} / {b_tb:.4f}); plain {tf_plain:.2f} / {tb_plain:.2f} ({card})")
    # the round trip: the cluster forward, then the cluster inverse on the
    # same hz (cl_st_partials on both sides), as phase 2's at H=128
    back = fs.fused_inverse_transposed(sp_a, u_k, za, dtype=bf)
    torch.cuda.synchronize()
    e = (back - xt).abs().flatten()
    t_med, (t_max, t_999) = float(e.median()), errors(back, xt)
    print(f"round trip fwd_cluster -> inv_cluster, bf16, B={bm} N={nm} K=32 H=256 n_hidden 2: "
          f"median {t_med:.3e} p99.9 {t_999:.3e} max {t_max:.3e}, share above 1e-4 "
          f"{float((e > 1e-4).float().mean()):.2e} (|u - x| max {float((u_k - xt).abs().max()):.2f})")
    check(t_med <= TOL_TRIP_MEDIAN and t_max <= TOL_BF16_MAX,
          f"round trip at H=256: median {t_med}, max {t_max}")
    del back, e
    # the bf16 sampler at H=256 (inv_cluster<256, 1>) alone at the main
    # shape, on the same weights, against its plain version, its noise
    # against philox_noise_plain; timed in turns with rows_kernel<256> on
    # the same inputs (the route turned to it: what ran before)
    zs = torch.randn((bm, 128), generator=g, device=dev)
    fs.reset_launch_counts()
    xs_k, us_k = fs.fused_sample_points(sp_a, zs, 11, nm, dtype=bf, return_noise=True)
    xs_k2 = fs.fused_sample_points(sp_a, zs, 11, nm, dtype=bf)
    xs_kp = fs.fused_inverse_transposed_plain(sp_a, us_k.transpose(1, 2).contiguous(),
                                              fs.z_projection(sp_a, zs), bf,
                                              "relu").transpose(1, 2)
    torch.cuda.synchronize()
    check(fs.layout_launches["cluster"] == 2, f"the main shape samples on the cluster inverse: "
                                              f"{fs.layout_launches}")
    e_noise = float((us_k - fs.philox_noise_plain(11, bm, nm, device=dev)).abs().max())
    check(e_noise <= TOL_NOISE, f"the cluster inverse's noise is philox_noise_plain's ({e_noise})")
    bs_err = held_to_plain(f"fused_sample (inv_cluster) bf16 B={bm} N={nm} K={sp_a.wx.shape[0]} "
                           "H=256 n_hidden 2", bf, (xs_k,), (xs_kp,), fwd_again=(xs_k2,))
    bs_ms, rows_ms = inverse_turns(fs, lambda: fs.fused_sample_points(sp_a, zs, 12, nm, dtype=bf))
    bs_plain = cuda_ms(lambda: fs.fused_sample_points_plain(sp_a, fs.z_projection(sp_a, zs), 12,
                                                            nm, bf, "relu"), 2, warmup=1)
    b_bs, by_bs, _ = bound(sp_a, bm, nm, with_ut=False)
    print(f"fused_sample bf16 H=256 n_hidden 2 at B={bm} N={nm}: inv_cluster {bs_ms:.3f} ms = "
          f"{bs_ms / b_bs:.2f}x its bound {b_bs:.4f} ({by_bs}), rows_kernel<256> in turns "
          f"{rows_ms:.3f} ms; plain {bs_plain:.2f}; noise against philox_noise_plain "
          f"{e_noise:.2e} ({card})")
    # every shape of the cluster layout at the main shape, K=32: the cluster
    # inverse against its plain version, and timed in turns with rows_kernel;
    # where every case is built (H=256), also each other activation and the
    # int8 mode (relu, gelu) through the sampler's entry, held to the plain
    # version on the noise it drew (the int8 mode's on the dequantized
    # stacks, and bit for bit to the bf16 mode there), timed in turns with
    # rows_kernel, with their bounds
    ut_w = torch.randn((bm, 3, nm), generator=g, device=dev)
    case_rows = []     # (H, n_hidden, activation, int8, err, ms, plain ms, bound, by)
    for hh, nh1 in fs.CLUSTER_INVERSE:
        spw = flow_stack(hh, nh1 + 1, seed=hh + nh1)
        layout = fs.inverse_layout(hh, nh1, bf)
        check(layout == ("rows" if (hh, nh1) in fs.ROWS_KEPT else "cluster"),
              f"H={hh} n_hidden={nh1 + 1} bf16 samples on the {layout} layout")
        fs.reset_launch_counts()
        with forced_layout(fs, "cluster"):
            xw = fs.fused_inverse_transposed(spw, ut_w, zs, dtype=bf)
            xw2 = fs.fused_inverse_transposed(spw, ut_w, zs, dtype=bf)
        xwp = fs.fused_inverse_transposed_plain(spw, ut_w, fs.z_projection(spw, zs), bf, "relu")
        torch.cuda.synchronize()
        check(fs.layout_launches["cluster"] == 2, f"inv_cluster at H={hh} n_hidden={nh1 + 1}")
        held_to_plain(f"fused_inverse (inv_cluster) B={bm} N={nm} K=32 H={hh} n_hidden={nh1 + 1}",
                      bf, (xw,), (xwp,), fwd_again=(xw2,))
        c_ms, r_ms = inverse_turns(fs, lambda: fs.fused_inverse_transposed(spw, ut_w, zs, dtype=bf))
        b_w, by_w, _ = bound(spw, bm, nm, with_ut=True)
        print(f"inverse at B={bm} N={nm} K=32 H={hh} n_hidden={nh1 + 1} bf16, in turns: inv_cluster "
              f"{c_ms:.3f} ms, rows_kernel {r_ms:.3f} ms, bound {b_w:.4f} ({by_w}); the route takes "
              f"{layout} ({card})")
        if (hh, nh1) == (256, 3):
            w_err = errors(xw, xwp)[0]
            w_plain = cuda_ms(lambda: fs.fused_inverse_transposed_plain(
                spw, ut_w, fs.z_projection(spw, zs), bf, "relu"), 1, warmup=1)
            case_rows.append((hh, nh1 + 1, "relu", False, w_err, c_ms, w_plain, b_w, by_w))
        del xw, xw2, xwp
        qw = fs.quantize_flow_params(spw)
        dqw = fs.dequantize(qw)
        spd = spw._replace(wx=dqw.wx, wh=dqw.wh, wout=dqw.wout)
        hzw = fs.z_projection(spw, zs)
        for act, int8 in inverse_cases(fs, (hh, nh1)):
            qq = qw if int8 else None
            cname = f"H={hh} n_hidden={nh1 + 1} {act}{' int8' if int8 else ''}"
            check(fs.inverse_layout(hh, nh1, bf, act, int8) == "cluster",
                  f"{cname} samples on the cluster inverse")
            fs.reset_launch_counts()
            xc, uc = fs.fused_sample_points(spw, zs, 13, nm, dtype=bf, activation=act, quantized=qq,
                                            return_noise=True)
            xc2 = fs.fused_sample_points(spw, zs, 13, nm, dtype=bf, activation=act, quantized=qq)
            xcp = fs.fused_inverse_transposed_plain(spd if int8 else spw,
                                                    uc.transpose(1, 2).contiguous(), hzw, bf,
                                                    act).transpose(1, 2)
            torch.cuda.synchronize()
            check(fs.layout_launches == {"rows": 0, "cluster": 2, "f32": 0},
                  f"{cname}: on the cluster inverse: {fs.layout_launches}")
            c_err = held_to_plain(f"fused_sample (inv_cluster) B={bm} N={nm} K=32 {cname}", bf,
                                  (xc,), (xcp,), fwd_again=(xc2,))
            same = ""
            if int8:     # the bf16 mode on the same layout (ROWS_KEPT's relu too)
                with forced_layout(fs, "cluster"):
                    xd = fs.fused_sample_points(spd, zs, 13, nm, dtype=bf, activation=act)
                torch.cuda.synchronize()
                check(torch.equal(xc, xd), f"{cname}: the int8 cluster inverse equals the bf16 one "
                                           "on the dequantized stacks")
                same = "; bit for bit the bf16 mode on the dequantized stacks"
                del xd
            c_ms, r_ms = inverse_turns(fs, lambda: fs.fused_sample_points(
                spw, zs, 12, nm, dtype=bf, activation=act, quantized=qq), iters=3)
            c_plain = cuda_ms(lambda: fs.fused_sample_points_plain(spd if int8 else spw, hzw, 12, nm,
                                                                   bf, act), 1, warmup=1)
            b_c, by_c, _ = bound(spw, bm, nm, with_ut=False, weight_bytes=1 if int8 else 2)
            print(f"fused_sample at B={bm} N={nm} K=32 {cname} bf16, in turns: inv_cluster "
                  f"{c_ms:.3f} ms = {c_ms / b_c:.2f}x its bound {b_c:.4f} ({by_c}), rows_kernel "
                  f"{r_ms:.3f} ms; plain {c_plain:.2f}{same} ({card})")
            case_rows.append((hh, nh1 + 1, act, int8, c_err, c_ms, c_plain, b_c, by_c))
            del xc, uc, xc2, xcp
        del qw, dqw, spd, hzw
    del model_a, sampler_a, sampler_af, u_p, du

    # (a2) the deep conditioners (the ring's): each pair of DEEP_SHAPES at the
    # main shape (B=64 x 2048, K=32, seeded weights) against the plain
    # versions, twice bit-identical, timed with their bounds; then the
    # flagship at H=256 with n_hidden 4 through the training CLI, 10 steps as
    # one resident call with the fused point flow and with the module path
    # from the same seeded weights on the same batches and noise: both
    # finite with their loss windows within TOL_TRAIN_DRIFT, or both
    # non-finite from the same step; every fused_train launch of the fused
    # run on the cluster layout (counts from 0 around each run)
    deep = {}
    for hh, nh in DEEP_SHAPES:
        spd = flow_stack(hh, nh, k=32, seed=hh + nh)
        twd = (spd.wx, spd.wh, spd.bh, spd.wout, spd.bout, spd.masks, spd.scale_cap)
        check(ft._layout(hh, nh - 1, bf, False) == ft._layout(hh, nh - 1, bf, True) == "cluster",
              f"H={hh} n_hidden={nh} bf16 runs the cluster layout")
        hzd = fs.z_projection(spd, za)
        (u_d, ld_d), fwd2d, (u_dp, ld_dp), dud, dldd, gd, gd2, gdr = train_runs(twd, xt, hzd, bf)
        d_err = held_to_plain(f"fused_train (cluster layout) B={bm} N={nm} K=32 H={hh} "
                              f"n_hidden {nh}", bf, (u_d, ld_d), (u_dp, ld_dp), gd, gd2, gdr,
                              grad_names, fwd_again=fwd2d)
        del gd, gd2, gdr, fwd2d, u_d, ld_d
        d_ms = (cuda_ms(lambda: ft.fused_forward_kernel(*twd, xt, hzd, bf), 5),
                cuda_ms(lambda: ft.fused_backward_kernel(*twd, u_dp, hzd, dud, dldd, bf), 3))
        d_plain = (cuda_ms(lambda: ft.fused_forward_plain(*twd, xt, hzd, bf), 2, warmup=1),
                   cuda_ms(lambda: ft.fused_backward_plain(*twd, u_dp, hzd, dud, dldd, bf), 1,
                           warmup=1))
        d_bounds = train_bounds(spd, bm, nm)
        deep[hh, nh] = (d_err, d_ms, d_plain, d_bounds)
        print(f"fused_train at B={bm} N={nm} K=32 H={hh} n_hidden {nh} bf16, cluster layout "
              f"(T = {ft._cluster_lib().dpfx_fused_train_cluster_tile_points(hh, nh - 1, 0)} / "
              f"{ft._cluster_lib().dpfx_fused_train_cluster_tile_points(hh, nh - 1, 1)} points a "
              f"tile): forward {d_ms[0]:.3f} ms, backward {d_ms[1]:.3f} ms = "
              f"{d_ms[0] / d_bounds[0][0]:.2f}x / {d_ms[1] / d_bounds[1][0]:.2f}x the bound "
              f"({d_bounds[0][0]:.4f} / {d_bounds[1][0]:.4f}); plain {d_plain[0]:.2f} / "
              f"{d_plain[1]:.2f} ({card})")
        del u_dp, ld_dp, dud, dldd, twd, spd, hzd
    deep_runs = {}
    for fused in ("true", "false"):
        ddir = WORK / f"train_deep_{fused}"
        shutil.rmtree(ddir, ignore_errors=True)
        for mod in (ft, fe, fl):
            mod.reset_launch_counts()
        t0 = time.perf_counter()
        rc, _, dcalls, _ = train_cli_run(
            [str(CONFIG), *DEEP, f"train.fused_point_flow={fused}", "train.steps=10",
             "train.steps_per_call=10", "train.log_every=5", f"train.lr_decay_steps={TRAIN_STEPS}",
             "train.ckpt_every=10", f"train.ckpt_dir={ddir}", "data.synthetic_size=512"],
            scale=0.02 * (128 / 256) ** 0.5, flax=False, seed=9)
        torch.cuda.synchronize()
        losses = [float(v) for _, ls in dcalls for v in ls]
        check(rc == 0 and [kk for kk, _ in dcalls] == [10],
              f"H=256 n_hidden 4 (fused {fused}) train calls {dcalls}")
        deep_runs[fused] = {"wall": time.perf_counter() - t0, "losses": losses,
                            "launch": dict(ft.launches), "lay": dict(ft.layout_launches),
                            "bad": next((i + 1 for i, v in enumerate(losses)
                                         if not np.isfinite(v)), None)}
        if fused == "false":     # the fused run's checkpoint is sampled below
            shutil.rmtree(ddir, ignore_errors=True)
    dfr, dmr = deep_runs["true"], deep_runs["false"]
    check(sum(dmr["launch"].values()) == 0,
          f"the module path launches no fused_train: {dmr['launch']}")
    for kname in ("fused_train_fwd", "fused_train_bwd"):
        want = tm._WARMUP + 10 + (VAL_BATCHES if kname.endswith("fwd") else 0)
        check(dfr["launch"][kname] == want, f"H=256 n_hidden 4 kernel {kname}: {dfr['launch']}")
    check(all(dfr["lay"][f"cluster_{d}"] == dfr["launch"][f"fused_train_{d}"]
              for d in ("fwd", "bwd")),
          f"H=256 n_hidden 4: every fused_train launch on the cluster layout: {dfr['lay']}")
    if dfr["bad"] is None and dmr["bad"] is None:
        deep_drift = max(abs(a_ - r_) / abs(r_) for a_, r_ in zip(windows(dfr["losses"]),
                                                                  windows(dmr["losses"])))
        check(deep_drift <= TOL_TRAIN_DRIFT,
              f"H=256 n_hidden 4: the fused run's loss windows against the module path's: rel "
              f"{deep_drift} (fused {dfr['losses']}, module {dmr['losses']})")
        deep_reading = f"both finite, loss windows rel {deep_drift:.2e}"
    else:
        check(dfr["bad"] == dmr["bad"],
              f"H=256 n_hidden 4: the fused run non-finite from step {dfr['bad']}, the module path "
              f"from step {dmr['bad']} (fused {dfr['losses']}, module {dmr['losses']})")
        deep_reading = f"both non-finite from step {dfr['bad']}"
    print(f"(a2) flagship at H=256 n_hidden 4 bf16 through the CLI, 10 steps (one resident call): "
          f"fused {dfr['wall']:.1f} s wall, loss " + ", ".join(f"{v:.1f}" for v in dfr["losses"])
          + f"; module path {dmr['wall']:.1f} s wall, loss "
          + ", ".join(f"{v:.1f}" for v in dmr["losses"]) + f"; {deep_reading}; fused launches "
          f"{json.dumps(dfr['launch'])} by layout {json.dumps(dfr['lay'])} ({card})")
    entry_launches = sampler_entry_points(dev, card, WORK / "train_deep_true", dfr["bad"] is None,
                                          flagship_like)

    # (b) config #3 (f32 point flow) on the synthetic family, through the
    # CLI at H=256 and at config #3's own width (H=128, n_hidden 2): its 10
    # steps as one resident call on config #3's own schedule (lr 1e-3 from
    # the first step, no clip), with the fused point flow and with the
    # module path from the same seeded weights on the same batches and
    # noise. Both finite, their loss windows within TOL_TRAIN_DRIFT; or both
    # non-finite from the same step (the random model diverges on that
    # schedule whatever computes its gradients), and then the same pair on
    # the flagship's schedule (F32_SCHEDULE), which must stay finite. The
    # fused run that stays finite is the width's: every fused_train launch
    # on the f32 layout, every loss finite, its first step against the
    # module path; then the f32 sampler and the evaluation CLI on the H=256
    # checkpoint, and the f32 pair against the f64 run on the H=128 one
    f32 = torch.float32
    over_b = [*WIDE, "data.dataset=synthetic", "data.synthetic_size=512"]
    f32_runs, f32_layouts, f32_pairs = {}, {}, {}

    def f32_cli(hb, over, sched, fused, tag):
        bdir = WORK / f"train_f32_h{hb}_{tag}_{fused}"
        shutil.rmtree(bdir, ignore_errors=True)
        for mod in (ft, fe, fl):
            mod.reset_launch_counts()
        t0 = time.perf_counter()
        rc, _, calls, init = train_cli_run(
            [str(F32_CONFIG), *over, *sched, f"train.fused_point_flow={fused}",
             "train.steps=10", "train.steps_per_call=10", "train.log_every=5",
             f"train.lr_decay_steps={TRAIN_STEPS}", "train.ckpt_every=10",
             f"train.ckpt_dir={bdir}"],
            scale=0.02 * (128 / hb) ** 0.5, flax=False, seed=7)
        torch.cuda.synchronize()
        losses = [v for _, ls in calls for v in ls]
        check(rc == 0 and [kk for kk, _ in calls] == [10],
              f"config #3 H={hb} ({tag} schedule, fused {fused}) train calls {calls}")
        return {"wall": time.perf_counter() - t0, "calls": calls, "init": init, "bdir": bdir,
                "losses": losses, "launch": dict(ft.launches), "lay": dict(ft.layout_launches),
                "bad": next((i + 1 for i, v in enumerate(losses) if not np.isfinite(v)), None)}

    for hb, over in ((256, over_b), (128, over_b[1:])):
        readings = []
        for tag, sched in (("own", []), ("flagship's", F32_SCHEDULE)):
            runs = {fu: f32_cli(hb, over, sched, fu, tag) for fu in ("true", "false")}
            fr, mr = runs["true"], runs["false"]
            check(sum(mr["launch"].values()) == 0, f"the module path launches no fused_train: "
                                                   f"{mr['launch']}")
            if fr["bad"] is None and mr["bad"] is None:
                drift = max(abs(a - r) / abs(r) for a, r in zip(windows(fr["losses"]),
                                                                 windows(mr["losses"])))
                check(drift <= TOL_TRAIN_DRIFT,
                      f"config #3 H={hb} ({tag} schedule): the fused run's loss windows against "
                      f"the module path's: rel {drift} (fused {fr['losses']}, module "
                      f"{mr['losses']})")
                readings.append(f"{tag} schedule: both finite, loss windows rel {drift:.2e}")
            else:
                check(fr["bad"] == mr["bad"],
                      f"config #3 H={hb} ({tag} schedule): the fused run non-finite from step "
                      f"{fr['bad']}, the module path from step {mr['bad']} (fused "
                      f"{fr['losses']}, module {mr['losses']})")
                readings.append(f"{tag} schedule: both non-finite from step {fr['bad']} (fused "
                                f"{fr['losses'][:fr['bad']]}, module {mr['losses'][:mr['bad']]})")
            if fr["bad"] is None:
                break
        check(fr["bad"] is None, f"config #3 H={hb}: the flagship's schedule stays finite")
        run = fr
        bdir, bcalls, binit, blaunch, blay = (run["bdir"], run["calls"], run["init"],
                                              run["launch"], run["lay"])
        cfg_bb = load_config(str(F32_CONFIG),
                             overrides=[*over, *sched, "train.fused_point_flow=true"])
        check(cfg_bb.model.point_flow.compute_dtype == "float32"
              and cfg_bb.model.point_flow.hidden == hb, "config #3's point flow is f32")
        brecs = [json.loads(line) for line in
                 (bdir / cfg_bb.name / "metrics.jsonl").read_text().splitlines()]
        btr = [r for r in brecs if r["kind"] == "train"]
        check([r["step"] for r in btr] == [10], f"config #3 H={hb} records {btr}")
        check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"])
                  and r["nonfinite_skipped"] == 0 for r in btr)
              and all(np.isfinite(v) for v in run["losses"]),
              f"config #3 H={hb}: every loss finite, no step skipped: {btr}")
        lay_b = ft._layout(hb, 1, f32, True)
        check(lay_b == "f32", f"config #3 at H={hb} n_hidden 2 trains on the {lay_b} layout")
        for d in ("fwd", "bwd"):
            want = tm._WARMUP + 10 + (VAL_BATCHES if d == "fwd" else 0)
            check(blaunch[f"fused_train_{d}"] == want and blay[f"{lay_b}_{d}"] == want
                  and sum(blay.values()) == 2 * tm._WARMUP + 20 + VAL_BATCHES,
                  f"config #3 H={hb}: every fused_train {d} launch on the {lay_b} layout: "
                  f"{blaunch}, {blay}")
        trained_b = torch.load(bdir / cfg_bb.name / "params_00000010.pt", map_location="cpu",
                               weights_only=True)
        moved = sum(not torch.equal(trained_b[kk], v) for kk, v in binit.items())
        check(moved == len(binit), f"{moved} of {len(binit)} parameters moved (config #3 H={hb})")
        # its first step against the module path: same weights, batch and noise
        gb = torch.Generator(device=dev).manual_seed(17)
        batch = {"x": x20[0], "eps": torch.randn((bm, cfg_bb.model.dz), generator=gb, device=dev)}
        ref_model = flagship_like(over, 7, F32_CONFIG)
        mcfg = copy.deepcopy(cfg_bb)
        mcfg.train.fused_point_flow = False
        out = {}
        for name, c in (("fused", cfg_bb), ("module", mcfg)):
            m = copy.deepcopy(ref_model)
            txm = tm.make_optimizer(c.train)
            _, mm = tm.make_train_step(m, txm, c)(tm.init_state(m, txm), batch)
            out[name] = (float(mm["loss"]), float(mm["grad_norm"]))
        (lf, gf), (lm, gm) = out["fused"], out["module"]
        check(abs(lf - lm) <= TOL_STEP_LOSS * abs(lm) and abs(gf - gm) <= TOL_STEP_GNORM * abs(gm),
              f"the config #3 H={hb} fused step agrees with the module path: {out}")
        f32_runs[hb] = (run["wall"], btr, out, bdir, cfg_bb)
        f32_layouts[hb] = blay
        f32_pairs[hb] = readings
        print(f"(b) config #3 at H={hb} n_hidden 2 f32 (route: {lay_b} layout), fused and module "
              f"path through the CLI from the same seeded weights: " + "; ".join(readings)
              + f". The fused run on the {tag} schedule: 10 steps (one resident call) in "
              f"{run['wall']:.1f} s wall; launches {json.dumps(blaunch)}, by layout "
              f"{json.dumps(blay)}; per-step loss "
              + ", ".join(f"{v:.1f}" for v in run["losses"]) + "; grad norm "
              + ", ".join(f"{r['grad_norm']:.1f}" for r in btr)
              + f"; fused step vs module path: loss {lf:.4f} vs {lm:.4f} (rel "
              f"{abs(lf - lm) / abs(lm):.2e}), grad norm {gf:.4f} vs {gm:.4f} (rel "
              f"{abs(gf - gm) / abs(gm):.2e}) ({card})")
        del ref_model, m
    # the f32 sampler and the evaluation CLI on the H=256 checkpoint
    bdir, cfg_b = f32_runs[256][3], f32_runs[256][4]
    model_b = DPF(cfg_b).to(dev).eval()
    model_b.load_state_dict({kk: v.to(dev) for kk, v in torch.load(
        bdir / cfg_b.name / "params_00000010.pt", map_location="cpu", weights_only=True).items()})
    sampler_b = make_sampler(model_b, bm, nm)
    fs.reset_launch_counts()
    xb = sampler_b(5)
    rc, res_b, _, eval_b = run_eval_cli([str(F32_CONFIG), *over_b, f"train.ckpt_dir={bdir}",
                                         "--limit", "32"])
    f32_launches = fs.launches["fused_sample"]
    check(fs.layout_launches["f32"] == f32_launches, f"(b) every sampler launch on the f32 "
                                                     f"layout: {fs.layout_launches}")
    smp_b = cuda_ms(lambda: sampler_b(6), 5)
    check(xb.shape == (bm, nm, 3) and bool(torch.isfinite(xb).all()) and rc == 0
          and res_b["n_test"] == 32 and finite_numbers(res_b) and f32_launches >= 2,
          f"(b) the f32 sampler at H=256 and its evaluation: {res_b}, {f32_launches} launches")
    del model_b, sampler_b
    # the f32 sampler's kernel at the main shape on seeded initial weights
    # (ten chaotic steps of the random model may leave the flow unbounded)
    model_b = flagship_like(over_b, 7, F32_CONFIG)
    with torch.no_grad():
        sp_b = fs.stack_point_flow_params(model_b.point_flow)
    z = torch.randn((bm, 128), generator=g, device=dev)
    xs, us = fs.fused_sample_points(sp_b, z, 8, nm, dtype=f32, return_noise=True)
    xs2 = fs.fused_sample_points(sp_b, z, 8, nm, dtype=f32)
    xs_p = fs.fused_inverse_transposed_plain(sp_b, us.transpose(1, 2).contiguous(),
                                             fs.z_projection(sp_b, z), f32, "relu").transpose(1, 2)
    s_err = held_to_plain(f"fused_sample f32 (Wh in chunks) B={bm} N={nm} K={sp_b.wx.shape[0]} H=256", f32,
                          (xs,), (xs_p,), fwd_again=(xs2,))
    s_ms = cuda_ms(lambda: fs.fused_sample_points(sp_b, z, 9, nm, dtype=f32), 5)
    s_plain = cuda_ms(lambda: fs.fused_sample_points_plain(sp_b, fs.z_projection(sp_b, z), 9,
                                                           nm, f32, "relu"), 2, warmup=1)
    _, _, s_flops = bound(sp_b, bm, nm, with_ut=False, weight_bytes=4)
    kk_, hh_, _ = sp_b.wx.shape
    s_bytes = (4 * bm * kk_ * hh_ + 4 * kk_ * (3 * hh_ + sp_b.wh.shape[1] * hh_ * hh_ + 6 * hh_)
               + 4 * 3 * bm * nm)
    b_s, by_s = bound_cores(s_flops / 2, 0.0, s_bytes)     # one FMA an operation pair
    print(f"(b) config #3 at H=256 n_hidden 2 f32: make_sampler(64, 2048) {smp_b:.3f} ms; "
          f"evaluation --limit 32 in {eval_b:.1f} s: 1-NNA-CD {res_b['1-nna-cd']:.4f}, "
          f"MMD-CD {res_b['mmd-cd']:.5f}; the f32 sampler {s_ms:.3f} ms (plain {s_plain:.3f}, "
          f"bound {b_s:.4f} ms on the FP32 cores) ({card})")
    # the f32 layout at the main shape (B=64 x 2048, K=32, H=256, n_hidden
    # 2) on the same seeded weights: against f64 runs of the plain versions,
    # twice bit-identical, timed with its bounds
    tw = (sp_b.wx, sp_b.wh, sp_b.bh, sp_b.wout, sp_b.bout, sp_b.masks, sp_b.scale_cap)
    xt = x20[1].transpose(1, 2).contiguous()
    hz = fs.z_projection(sp_b, z)
    check(ft._layout(256, 1, f32, False) == "f32", "the main f32 shape runs the f32 layout")
    (u_k, ld_k), fwd2, (u_p, ld_p), du, dld, got, again, ref = train_runs(tw, xt, hz, f32)
    w64 = tuple(t.double() if torch.is_tensor(t) else t for t in tw)
    u64 = ft.fused_forward_plain(*w64, xt.double(), hz.double(), torch.float64)[0]
    ref64 = ft.fused_backward_plain(*w64, u_p.double(), hz.double(), du.double(), dld.double(),
                                    torch.float64)
    fname = f"fused_train (f32 layout) B={bm} N={nm} K=32 H=256 n_hidden 2"
    f64_held(fname, lambda: f64_forward_held(fname, (u_k, ld_k), fwd2, (u_p, ld_p), u64,
                                             lambda: ft.fused_forward_plain(*tw, xt, hz, f32)),
             got, again, ref, ref64,
             lambda: ft.fused_backward_plain(*tw, u_p, hz, du, dld, f32), grad_names[1:])
    ff_err = float((u_k - u_p).abs().max())
    fb_err = max(float((a_ - r_).abs().max()) for a_, r_ in zip(got, ref) if r_.numel())
    del got, again, ref, ref64, u64
    ff_ms = cuda_ms(lambda: ft.fused_forward_kernel(*tw, xt, hz, f32), 5)
    fb_ms = cuda_ms(lambda: ft.fused_backward_kernel(*tw, u_p, hz, du, dld, f32), 3)
    ff_plain = cuda_ms(lambda: ft.fused_forward_plain(*tw, xt, hz, f32), 2, warmup=1)
    fb_plain = cuda_ms(lambda: ft.fused_backward_plain(*tw, u_p, hz, du, dld, f32), 1, warmup=1)
    (b_ff, by_ff), (b_fb, by_fb) = train_bounds_f32(sp_b, bm, nm)
    print(f"fused_train f32 layout at B={bm} N={nm} K=32 H=256 n_hidden 2: forward {ff_ms:.3f} ms "
          f"= {ff_ms / b_ff:.2f}x its bound {b_ff:.4f} ({by_ff}), backward {fb_ms:.3f} ms = "
          f"{fb_ms / b_fb:.2f}x its bound {b_fb:.4f} ({by_fb}); plain {ff_plain:.2f} / "
          f"{fb_plain:.2f} ({card})")
    del model_b, u_p, du, dld
    # at config #3's own width (H=128, n_hidden 2) the f32 pair on the
    # weights that the width's 10 steps left (away from their initial
    # values), at the main shape: against the f64 runs of the plain
    # versions, twice bit-identical, timed with its bounds (the block-wide
    # pair that the route took before is timed in turns with it by
    # `python -m dpfx_torch.tools.bwd_ab PARENT --hidden 128 --dtype float32`)
    bdir_c, cfg_c = f32_runs[128][3], f32_runs[128][4]
    model_c = DPF(cfg_c)
    model_c.load_state_dict(torch.load(bdir_c / cfg_c.name / "params_00000010.pt",
                                       map_location="cpu", weights_only=True))
    with torch.no_grad():
        sp_c = fs.stack_point_flow_params(model_c.point_flow.to(dev))
    twc = (sp_c.wx, sp_c.wh, sp_c.bh, sp_c.wout, sp_c.bout, sp_c.masks, sp_c.scale_cap)
    hzc = fs.z_projection(sp_c, z)
    check(ft._layout(128, 1, f32, False) == ft._layout(128, 1, f32, True) == "f32",
          "config #3's own width runs the f32 layout")
    (u_c, ld_c), fwd2c, (u_cp, ld_cp), duc, dldc, gc, gc2, gcr = train_runs(twc, xt, hzc, f32)
    w64c = tuple(t.double() if torch.is_tensor(t) else t for t in twc)
    u64c = ft.fused_forward_plain(*w64c, xt.double(), hzc.double(), torch.float64)[0]
    ref64c = ft.fused_backward_plain(*w64c, u_cp.double(), hzc.double(), duc.double(),
                                     dldc.double(), torch.float64)
    cname = (f"fused_train (f32 layout) B={bm} N={nm} K=32 H=128 n_hidden 2, config #3's "
             "trained weights")
    f64_held(cname, lambda: f64_forward_held(cname, (u_c, ld_c), fwd2c, (u_cp, ld_cp), u64c,
                                             lambda: ft.fused_forward_plain(*twc, xt, hzc, f32)),
             gc, gc2, gcr, ref64c,
             lambda: ft.fused_backward_plain(*twc, u_cp, hzc, duc, dldc, f32), grad_names[1:])
    del gc, gc2, gcr, ref64c, u64c
    cf_ms = cuda_ms(lambda: ft.fused_forward_kernel(*twc, xt, hzc, f32), 5)
    cb_ms = cuda_ms(lambda: ft.fused_backward_kernel(*twc, u_cp, hzc, duc, dldc, f32), 3)
    (b_cf, _), (b_cb, _) = train_bounds_f32(sp_c, bm, nm)
    print(f"fused_train f32 layout at B={bm} N={nm} K=32 H=128 n_hidden 2 (config #3's width, its "
          f"trained weights): forward {cf_ms:.3f} ms, backward {cb_ms:.3f} ms; bounds "
          f"{b_cf:.4f} / {b_cb:.4f}; the route takes the {ft._layout(128, 1, f32, True)} layout "
          f"({card})")
    del model_c, u_c, u_cp, duc, dldc
    # the round trip: the f32 forward, then the f32 sampler's inverse on the
    # same hz (f32_walk walked both ways) on bwd_ab --dtype float32's inputs,
    # where the stream layout's forward read F32_TRIP in the same call
    torch.manual_seed(3)
    rflow = randomize_(CouplingFlow(3, 32, 256, 2, cond_dim=128, scale_cap=3.0), 3,
                       0.02 * (128 / 256) ** 0.5)
    with torch.no_grad():
        sp_r = fs.stack_point_flow_params(rflow.to(dev))
    g3 = torch.Generator(device=dev).manual_seed(3)
    xt3 = torch.randn((bm, 3, nm), generator=g3, device=dev)
    z3 = torch.randn((bm, 128), generator=g3, device=dev)
    u3, _ = ft.fused_forward_kernel(sp_r.wx, sp_r.wh, sp_r.bh, sp_r.wout, sp_r.bout, sp_r.masks,
                                    sp_r.scale_cap, xt3, fs.z_projection(sp_r, z3), f32)
    back = fs.fused_inverse_transposed(sp_r, u3, z3, dtype=f32)
    torch.cuda.synchronize()
    e = (back - xt3).abs().flatten()
    r_med, r_max = float(e.median()), float(e.max())
    print(f"round trip fwd_f32 -> f32_kernel, f32, B={bm} N={nm} K=32 H=256 n_hidden 2: median "
          f"{r_med:.6e} max {r_max:.6e} (limits: the stream layout's forward's {F32_TRIP})")
    check(r_med <= F32_TRIP["median"] and r_max <= F32_TRIP["max"],
          f"the f32 round trip: median {r_med}, max {r_max} against {F32_TRIP}")
    del back, e, u3, rflow

    # (c) latcap (the latent flow 28 x 512) with the fused latent flow: 10
    # steps, then the sampler through the fused latent inverse
    cap_dir = WORK / "train_latcap"
    shutil.rmtree(cap_dir, ignore_errors=True)
    for mod in (ft, fe, fl):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    rc, _, ccalls, _ = train_cli_run(
        [str(LATCAP_CONFIG), "train.fused_latent_flow=true", "train.steps=10",
         "train.steps_per_call=10", "train.log_every=5", f"train.lr_decay_steps={TRAIN_STEPS}",
         "train.ckpt_every=10", f"train.ckpt_dir={cap_dir}", "data.synthetic_size=512"],
        flax=False)     # phase 2's init: from flax's at 0.02 latcap's prior reaches |u| ~ 7e5
    torch.cuda.synchronize()
    cap_wall = time.perf_counter() - t0
    cap_launches = {**ft.launches, **fe.launches, **fl.launches}
    cfg_c = load_config(str(LATCAP_CONFIG))
    lc = cfg_c.model.latent_flow
    crecs = [json.loads(line) for line in
             (cap_dir / cfg_c.name / "metrics.jsonl").read_text().splitlines()]
    crecs = [r for r in crecs if r["kind"] == "train"]
    check(rc == 0 and [kk for kk, _ in ccalls] == [10]
          and all(np.isfinite(r["loss"]) and r["nonfinite_skipped"] == 0 for r in crecs)
          and all(np.isfinite(v) for _, ls in ccalls for v in ls),
          f"latcap training: calls {ccalls}, records {crecs}")
    for kname in ("fused_latent_fwd", "fused_latent_bwd"):
        want = tm._WARMUP + 10 + (VAL_BATCHES if kname.endswith("fwd") else 0)
        check(cap_launches[kname] == want, f"latcap kernel {kname}: {cap_launches[kname]} launches")
    pfw = fl.cluster_plan(bm, 128, lc.hidden, lc.n_hidden - 1, False)
    pbw = fl.cluster_plan(bm, 128, lc.hidden, lc.n_hidden - 1, True)
    model_c = DPF(cfg_c).to(dev).eval()
    model_c.load_state_dict({kk: v.to(dev) for kk, v in torch.load(
        cap_dir / cfg_c.name / "params_00000010.pt", map_location="cpu", weights_only=True).items()})
    sampler_c = fused_latent_sampler(model_c, bm, nm)
    fl.reset_launch_counts()
    xc = sampler_c(7)
    torch.cuda.synchronize()
    check(fl.launches["fused_latent_inv"] == 1 and xc.shape == (bm, nm, 3)
          and bool(torch.isfinite(xc).all()), "latcap sampled through the fused latent inverse")
    smp_c = cuda_ms(lambda: sampler_c(8), 5)
    # latcap's latent kernels at B=bm on the seeded initial weights (ten
    # chaotic steps of the random model may leave the prior unbounded),
    # against the plain versions, with their bounds
    with torch.no_grad():
        cw = fl.cast_latent_weights(fl.pad_latent_params(fl.stack_latent_params(
            flagship_like([], 2, LATCAP_CONFIG).latent_flow)), bf)
    cm = fl.latent_masks(lc.n_layers, 128, dev)
    zc = torch.randn((bm, 128), generator=g, device=dev)
    u_c, ld_c = fl.latent_forward_kernel(cw, cm, 3.0, zc, bf)
    u_cp, ld_cp = fl.latent_forward_plain(cw, cm, 3.0, zc, bf)
    zi_c = fl.latent_inverse_kernel(cw, cm, 3.0, zc, bf)
    zi_cp = fl.latent_inverse_plain(cw, cm, 3.0, zc, bf)
    cap_again = (*fl.latent_forward_kernel(cw, cm, 3.0, zc, bf),
                 fl.latent_inverse_kernel(cw, cm, 3.0, zc, bf))
    dzc = torch.randn((bm, 128), generator=g, device=dev)
    dldc = torch.randn((bm,), generator=g, device=dev)
    got = lat(fl.latent_backward_kernel(cw, cm, 3.0, u_cp, dzc, dldc, bf))
    again = lat(fl.latent_backward_kernel(cw, cm, 3.0, u_cp, dzc, dldc, bf))
    ref = lat(fl.latent_backward_plain(cw, cm, 3.0, u_cp, dzc, dldc, bf))
    torch.cuda.synchronize()
    latent_held(f"fused_latent latcap {lc.n_layers} x {lc.hidden} B={bm}", bf, u_c, ld_c, zi_c,
                u_cp, ld_cp, zi_cp, got, again, ref, ["dz"] + list(fl.KEYS),
                p999=TOL_LATCAP_P999, fwd_again=cap_again)
    del got, again, ref
    cap_ms = {"fwd": cuda_ms(lambda: fl.latent_forward_kernel(cw, cm, 3.0, zc, bf), 20),
              "inv": cuda_ms(lambda: fl.latent_inverse_kernel(cw, cm, 3.0, zc, bf), 20),
              "bwd": cuda_ms(lambda: fl.latent_backward_kernel(cw, cm, 3.0, u_cp, dzc, dldc, bf),
                             10)}
    cap_plain = {"fwd": cuda_ms(lambda: fl.latent_forward_plain(cw, cm, 3.0, zc, bf), 3, warmup=1),
                 "inv": cuda_ms(lambda: fl.latent_inverse_plain(cw, cm, 3.0, zc, bf), 3, warmup=1),
                 "bwd": cuda_ms(lambda: fl.latent_backward_plain(cw, cm, 3.0, u_cp, dzc, dldc, bf),
                                2, warmup=1)}
    (b_cf, by_cf), (b_cb, by_cb) = latent_bounds(cw, bm)
    print(f"latcap latent kernels at B={bm} bf16: forward {cap_ms['fwd']:.4f} ms (plain "
          f"{cap_plain['fwd']:.3f}, bound {b_cf:.5f}, {by_cf}), inverse {cap_ms['inv']:.4f} (plain "
          f"{cap_plain['inv']:.3f}), backward {cap_ms['bwd']:.4f} ms (plain {cap_plain['bwd']:.3f}, "
          f"bound {b_cb:.5f}, {by_cb}) ({card})")
    print(f"(c) latcap (latent flow {lc.n_layers} x {lc.hidden}) with the fused latent flow: 10 "
          f"steps (one resident call) in {cap_wall:.1f} s wall; launches "
          f"{json.dumps(cap_launches)}; loss " + ", ".join(f"{r['loss']:.1f}" for r in crecs)
          + f"; plans forward (C, G) = ({pfw.cluster}, {pfw.group}) {pfw.smem} B, backward "
          f"({pbw.cluster}, {pbw.group}) {pbw.smem} B, {pbw.slices} slices; make_sampler({bm}, "
          f"{nm}) with the fused latent inverse {smp_c:.3f} ms ({card})")
    del model_c, sampler_c
    print(f"phase 3l: the kernels' widths in {time.perf_counter() - t_phase:.1f} s (checks "
          f"{t_checks:.1f} s) ({card})")

    src = "dpfx_torch/ops/csrc/flow_cluster.cuh"
    row = lambda name, s_, where, n_, err, ms, plain, bnd, by: {  # noqa: E731
        "name": name, "route": "cuda", "source": s_, "replaces": where, "launches": n_,
        "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bnd, "bound_by": by,
        "library_ms": None}
    d_err, d_ms, d_plain, ((b_df, by_df), (b_db, by_db)) = deep[DEEP_SHAPES[-1]]
    return [row("fused_train_fwd_cluster", src, "dpfx/ops/fused_train.py:131",
                wide_layouts["cluster_fwd"], f_err, tf_ms, tf_plain, b_tf, by_tf),
            row("fused_train_bwd_cluster", src, "dpfx/ops/fused_train.py:231",
                wide_layouts["cluster_bwd"], b_err, tb_ms, tb_plain, b_tb, by_tb),
            row("fused_train_fwd_cluster_deep", src, "dpfx/ops/fused_train.py:131",
                dfr["lay"]["cluster_fwd"], d_err, d_ms[0], d_plain[0], b_df, by_df),
            row("fused_train_bwd_cluster_deep", src, "dpfx/ops/fused_train.py:231",
                dfr["lay"]["cluster_bwd"], d_err, d_ms[1], d_plain[1], b_db, by_db),
            row("fused_sample_inv_cluster", src, "dpfx/ops/fused_sampler.py:309",
                sample_layouts["cluster"], bs_err, bs_ms, bs_plain, b_bs, by_bs),
            row("fused_sample_f32_h256", "dpfx_torch/ops/csrc/fused_sampler.cu",
                "dpfx/ops/fused_sampler.py:309", f32_launches, s_err, s_ms, s_plain, b_s, by_s),
            row("fused_train_fwd_f32", "dpfx_torch/ops/csrc/fused_train.cu",
                "dpfx/ops/fused_train.py:131", f32_layouts[256]["f32_fwd"], ff_err, ff_ms, ff_plain,
                b_ff, by_ff),
            row("fused_train_bwd_f32", "dpfx_torch/ops/csrc/fused_train.cu",
                "dpfx/ops/fused_train.py:231", f32_layouts[256]["f32_bwd"], fb_err, fb_ms, fb_plain,
                b_fb, by_fb)] + [
            row(f"fused_sample_inv_cluster_h{hh}_nh{nh}_{act}{'_int8' if q8 else ''}", src,
                "dpfx/ops/fused_sampler.py:338" if q8 else "dpfx/ops/fused_sampler.py:309",
                entry_launches.get((hh, nh, act, q8), 0), err, ms, plain, bnd, by)
            for hh, nh, act, q8, err, ms, plain, bnd, by in case_rows]


# ---------------------------------------------------------------- phase 3m: large clouds

LARGE_POINTS = 15000        # PointFlow's ShapeNetCore.v2.PC15k clouds
LARGE_RAGGED = 4500         # the ragged clouds' points, against LARGE_POINTS
LARGE_AE_CONFIG = ROOT / "configs" / "shapenet_airplane_ae_emd.yaml"
LARGE_GEN_CONFIG = ROOT / "configs" / "shapenet_airplane_gen.yaml"
LARGE_TRAIN_STEPS = 4
LARGE_GEN_LIMIT = 16        # the generation suite's test clouds
LARGE_DESCENT = 3           # descent steps on chamfer + emd at LARGE_POINTS
# nnd_bwd against nn_distances_backward_plain at LARGE_POINTS, per point as
# TOL_CD_GRAD: the two sum the same terms in other orders, and at 15,000
# points a cloud a point's nearest neighbour is ~2x closer than at 2048, so
# its gradient's terms cancel more and the plain version's order moves it
# further (seen: 1.5e-5 at B=32); the kernel's own check is the three
# passes' order bit for bit (onepass_bwd_plain)
TOL_CD_GRAD_LARGE = 1e-4
LARGE_F64_PAIRS = 2         # pairs of the gradient mode held to an f64 run


def large_cloud_path(dev, card):
    """Phase 3m: CD and EMD above 4096 points a cloud, on the large-cloud
    layout. The main path: a PC15k-layout tree of 15,000-point clouds
    written by make_synthetic_shapenet (64 train, 32 val and 32 test clouds
    over its five synsets, so data.category=all), 4 training steps of
    shapenet_airplane_ae_emd.yaml and shapenet_airplane_gen.yaml through the
    training CLI at their own n_points 2048, then dpfx_torch.evaluate at
    data.n_points_eval=15000 on each checkpoint (AE reconstruction over the
    32 test clouds, a generation suite at --limit 16), then 3 steps of
    gradient descent on chamfer + emd of 4 test clouds perturbed towards
    them; counts zeroed just before and read just after, every CD and EMD
    launch on the large layout. Then each large-layout kernel against its
    plain version, twice bit-identical: nnd_fwd and nnd_bwd at B=32,
    N=M=15,000 and 15,000 against 4,500 (minima and gradients bit for bit,
    the backward's paths), cd_pairwise exact and fast at 8 x 8 (bit for bit
    the mirror of its order), emd exact and the gradient mode at B=8 (phase
    2c's limits; the gradient mode's cost bit for bit the plain launch's),
    emd_pairwise fast and exact at 4 x 4, each timed with its bound. Returns
    the kernels line's six rows."""
    import tempfile

    import numpy as np
    import torch

    from dpfx_torch.ops import chamfer as cdk
    from dpfx_torch.ops import emd as emdk
    from dpfx_torch.ops import fused_sampler as fs
    from dpfx_torch.tools import make_synthetic_shapenet

    t_phase = time.perf_counter()
    med = lambda e: float(e.median())  # noqa: E731
    mods = (cdk, emdk, fs)
    counts = lambda: {k: v for m in (cdk, emdk) for k, v in m.launches.items()}  # noqa: E731
    layouts = lambda: {**cdk.layouts, **emdk.layouts}  # noqa: E731
    WORK.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=WORK) as tmp:
        tree = Path(tmp) / "pc15k"
        t0 = time.perf_counter()
        check(make_synthetic_shapenet.main([str(tree), "--points", str(LARGE_POINTS), "--train", "64",
                                            "--valtest", "32"]) == 0, "make_synthetic_shapenet")
        t_tree = time.perf_counter() - t0
        data = [f"data.path={tree}", "data.category=all"]
        ckpts, train_s = {}, {}
        for name, yaml in (("ae", LARGE_AE_CONFIG), ("gen", LARGE_GEN_CONFIG)):
            ckpts[name] = Path(tmp) / f"ck_{name}"
            t0 = time.perf_counter()
            # the flagship's warmup and clip (F32_SCHEDULE): on the configs'
            # own schedule the random model diverges at once (phase 3l (b))
            rc, out, calls, _ = train_cli_run([str(yaml), *data, f"train.steps={LARGE_TRAIN_STEPS}",
                                               "train.log_every=2", f"train.ckpt_every={LARGE_TRAIN_STEPS}",
                                               f"train.eval_every={LARGE_TRAIN_STEPS}",
                                               f"train.ckpt_dir={ckpts[name]}", *F32_SCHEDULE])
            train_s[name] = time.perf_counter() - t0
            losses = [v for _, ls in calls for v in ls]
            check(rc == 0 and len(losses) == LARGE_TRAIN_STEPS and all(math.isfinite(v) for v in losses)
                  and "SKIPPED" not in out and "skipping" not in out and any(ckpts[name].rglob(f"params_{LARGE_TRAIN_STEPS:08d}.pt")),
                  f"{name} training at n_points 2048 on the PC15k tree: rc {rc}, losses {losses}, no step "
                  "skipped, the checkpoint written")
        for m in mods:
            m.reset_launch_counts()
        rc, ae, ae_t, ae_wall = run_eval_cli([str(LARGE_AE_CONFIG), *data, f"train.ckpt_dir={ckpts['ae']}",
                                              f"data.n_points_eval={LARGE_POINTS}"])
        ae_counts = counts()
        check(rc == 0 and ae["n_test"] == 32 and {"recon-cd", "recon-emd"} <= set(ae) and finite_numbers(ae),
              f"AE reconstruction at {LARGE_POINTS} points: {ae}")
        check(ae_counts["nnd_fwd"] > 0 and ae_counts["emd_batched"] > 0 and fs.launches["fused_sample"] > 0,
              f"the AE path launched nnd_fwd, emd_batched and the sampler: {ae_counts}")
        for m in (cdk, emdk):
            m.launches.update(dict.fromkeys(m.launches, 0))
        rc, gen, gen_t, gen_wall = run_eval_cli([str(LARGE_GEN_CONFIG), *data, f"train.ckpt_dir={ckpts['gen']}",
                                                 f"data.n_points_eval={LARGE_POINTS}", "--limit",
                                                 str(LARGE_GEN_LIMIT)])
        gen_counts = counts()
        check(rc == 0 and gen["n_test"] == LARGE_GEN_LIMIT and finite_numbers(gen)
              and all(0.0 <= gen[k] <= 1.0 for k in ("cov-cd", "1-nna-cd", "cov-emd", "1-nna-emd")),
              f"generation suite at {LARGE_POINTS} points: {gen}")
        check(gen_counts["cd_pairwise"] > 0 and gen_counts["emd_pairwise"] > 0,
              f"the suite launched cd_pairwise and emd_pairwise: {gen_counts}")
        rng = np.random.default_rng(5)
        load = lambda split: torch.from_numpy(np.stack([  # noqa: E731
            np.load(f) for f in sorted(tree.glob(f"*/{split}/*.npy"))]).astype(np.float32)).to(dev)
        test, val = load("test"), load("val")
    check(test.shape == (32, LARGE_POINTS, 3) and val.shape == test.shape, f"the tree's splits {tuple(test.shape)}")

    # gradient descent on chamfer + emd at 15,000 points (the losses' path)
    for m in (cdk, emdk):
        m.launches.update(dict.fromkeys(m.launches, 0))
    target = test[:4]
    x = target + 0.02 * torch.randn(target.shape, generator=torch.Generator(device=dev).manual_seed(7),
                                    device=dev)
    first = None
    for _ in range(LARGE_DESCENT):
        xv = x.clone().requires_grad_(True)
        cd, em = cdk.chamfer(xv, target), emdk.emd(xv, target)
        (cd.sum() + em.sum()).backward()
        first = first or (cd.detach(), em.detach())
        x = x - 0.01 * LARGE_POINTS * xv.grad
    last = (cdk.chamfer(x, target), emdk.emd_nograd(x, target))
    torch.cuda.synchronize()
    descent_counts = counts()
    check(bool((last[0] < first[0]).all()) and bool((last[1] < first[1]).all()),
          f"descent lowers CD {first[0].tolist()} -> {last[0].tolist()} and EMD {first[1].tolist()} -> "
          f"{last[1].tolist()}")
    check(all(descent_counts[k] > 0 for k in ("nnd_fwd", "nnd_bwd", "emd_batched_grad")),
          f"the descent launched the gradient kernels: {descent_counts}")
    path_layouts = {k: dict(v) for k, v in layouts().items()}
    launched = {k: ae_counts[k] + gen_counts[k] + descent_counts[k] for k in ae_counts}
    check(all(v["pair"] == 0 for v in path_layouts.values())
          and all(path_layouts[k]["large"] == launched[k] for k in launched),
          f"every CD and EMD launch of the main path on the large layout: {path_layouts}")
    print(f"large clouds, the main path ({card}): PC15k tree of 15,000-point clouds {t_tree:.1f} s, "
          f"training at 2048 points {json.dumps({k: round(v, 1) for k, v in train_s.items()})} s; AE "
          f"reconstruction at {LARGE_POINTS} points over 32 test clouds {json.dumps(ae)} "
          f"({ae_t['total']:.2f} s, {ae_wall:.1f} s with restore and data); generation suite "
          f"--limit {LARGE_GEN_LIMIT} {json.dumps({k: gen[k] for k in ('mmd-cd', 'cov-cd', '1-nna-cd', 'mmd-emd', 'cov-emd', '1-nna-emd', 'jsd')})} "
          f"({gen_t['total']:.2f} s, {gen_wall:.1f} s with restore and data); descent on chamfer + emd "
          f"of 4 clouds, {LARGE_DESCENT} steps: CD {[round(v, 6) for v in first[0].tolist()]} -> "
          f"{[round(v, 6) for v in last[0].tolist()]}, EMD {[round(v, 5) for v in first[1].tolist()]} -> "
          f"{[round(v, 5) for v in last[1].tolist()]}; launches {json.dumps(launched)}, by layout "
          f"{json.dumps(path_layouts)}")

    # each large-layout kernel against its plain version
    n = LARGE_POINTS
    perm = torch.from_numpy(rng.permutation(n)[:LARGE_RAGGED]).to(dev)
    rows = []
    for m in (cdk, emdk):
        m.reset_launch_counts()
    g = torch.Generator(device=dev).manual_seed(13)
    for tag, xb, yb in ((f"B=32 N=M={n}", test, val), (f"B=32 N={n} M={LARGE_RAGGED}", test, val[:, perm])):
        b, mm = xb.shape[0], yb.shape[1]
        dl, dr = cdk.nnd_forward(xb, yb)
        dl2, dr2 = cdk.nnd_forward(xb, yb)
        (pdl, _, pdr, _), fwd_plain = timed_once(lambda: cdk.nn_distances_plain(xb, yb))
        check(torch.equal(dl, pdl) and torch.equal(dr, pdr), f"nnd_fwd {tag}: minima bit for bit")
        check(torch.equal(dl, dl2) and torch.equal(dr, dr2), f"nnd_fwd {tag} bit-identical from run to run")
        fwd_ms = cuda_ms(lambda: cdk.nnd_forward(xb, yb), 10)
        gl = torch.randn(dl.shape, generator=g, device=dev) / n
        gr = torch.randn(dr.shape, generator=g, device=dev) / mm
        gx, gy = cdk.nnd_backward(xb, yb, dl, dr, gl, gr)
        paths = cdk.last_paths.clone()
        gx2, gy2 = cdk.nnd_backward(xb, yb, dl, dr, gl, gr)
        rx, ry, rp = cdk.onepass_bwd_plain(xb, yb, dl, dr, gl, gr)
        (px, py), bwd_plain = timed_once(lambda: cdk.nn_distances_backward_plain(xb, yb, dl, dr, gl, gr))
        torch.cuda.synchronize()
        check(torch.equal(gx, rx) and torch.equal(gy, ry) and torch.equal(paths, rp),
              f"nnd_bwd {tag}: onepass_bwd_plain's gradients and paths bit for bit")
        check(torch.equal(gx, gx2) and torch.equal(gy, gy2), f"nnd_bwd {tag} bit-identical from run to run")
        e_bwd = max(grad_point_err(gx, px), grad_point_err(gy, py))
        check(e_bwd <= TOL_CD_GRAD_LARGE, f"nnd_bwd {tag} against nn_distances_backward_plain: {e_bwd}")
        bwd_ms = cuda_ms(lambda: cdk.nnd_backward(xb, yb, dl, dr, gl, gr), 10)
        (fbd, fby), _ = eval_bounds(b, n, mm, b, b, b * (n + mm))
        (bbd, bby), _ = grad_bounds(b, n, mm)
        print(f"kernel-vs-plain large layout nnd_fwd {tag}: minima bit for bit, {fwd_ms:.3f} ms (bound "
              f"{fbd:.3f} ms, {fwd_ms / fbd:.2f}x; plain {fwd_plain:.1f} ms); nnd_bwd: onepass_bwd_plain "
              f"bit for bit, {path_counts(paths)}, per point against the plain version {e_bwd:.2e}, "
              f"{bwd_ms:.3f} ms (bound {bbd:.3f} ms, {bwd_ms / bbd:.2f}x; plain {bwd_plain:.1f} ms); "
              f"{cdk.large_ctas(mm)} CTAs a pair ({card})")
        if mm == n:
            rows.append(("nnd_fwd_large", "chamfer", "dpfx/ops/chamfer.py:130", "nnd_fwd",
                         float((dl - pdl).abs().max()), fwd_ms, fwd_plain, fbd, fby))
            rows.append(("nnd_bwd_large", "chamfer", "dpfx/ops/chamfer.py:174", "nnd_bwd",
                         max(float((gx - px).abs().max()), float((gy - py).abs().max())), bwd_ms, bwd_plain,
                         bbd, bby))

    xs, ys = test[:8], val[:8]
    s = xs.shape[0]
    got = {prec: cdk.chamfer_pairwise(xs, ys, prec) for prec in ("exact", "fast")}
    for prec, mat in got.items():
        mirror = torch.stack([cdk.large_plain(xs[i:i + 1].expand(s, -1, -1), ys, prec == "fast")[2]
                              for i in range(s)])
        check(torch.equal(mat, mirror) and torch.equal(mat, cdk.chamfer_pairwise(xs, ys, prec)),
              f"cd_pairwise {prec} {s}x{s}: the mirror of its order bit for bit, twice the same")
    pm, cd_plain = timed_once(lambda: cdk.chamfer_pairwise_plain(xs, ys))
    e_cd = float(pair_err(got["exact"], pm, CD_FLOOR).max())
    check(e_cd <= TOL_CD, f"cd_pairwise {s}x{s} against chamfer_pairwise_plain: {e_cd}")
    cd_turns = {"exact": [], "fast": []}
    for prec in ("exact", "fast", "fast", "exact"):
        cd_turns[prec].append(cuda_ms(lambda: cdk.chamfer_pairwise(xs, ys, prec), 3, warmup=1))
    cd_ms = sum(cd_turns["exact"]) / 2
    (cbd, cby), _ = eval_bounds(s * s, n, n, s, s, s * s)
    rows.append(("cd_pairwise_large", "chamfer", "dpfx/ops/chamfer.py:255", "cd_pairwise",
                 float((got["exact"] - pm).abs().max()), cd_ms, cd_plain, cbd, cby))
    print(f"kernel-vs-plain large layout cd_pairwise {s}x{s} N={n}: exact and fast bit for bit the mirror, "
          f"exact against the plain version rel max {e_cd:.2e}; exact {cd_ms:.3f} ms, fast "
          f"{sum(cd_turns['fast']) / 2:.3f} ms in turns (bound {cbd:.3f} ms; plain {cd_plain:.1f} ms)")

    xe, ye = test[:8], val[:8]
    b = xe.shape[0]
    cost = emdk.emd_nograd(xe, ye)
    gc, gxe, gye = emdk.emd_with_grads(xe, ye)
    gc2, gxe2, gye2 = emdk.emd_with_grads(xe, ye)
    check(torch.equal(cost, emdk.emd_nograd(xe, ye)) and torch.equal(gc, cost) and torch.equal(gc2, cost)
          and torch.equal(gxe, gxe2) and torch.equal(gye, gye2),
          "emd B=8: bit-identical from run to run, the gradient mode's cost the plain launch's bit for bit")
    sw = emdk.emd_sweeps_plain(xe, ye)
    pe, emd_plain_ms = timed_once(lambda: emdk.emd_plain(xe, ye))
    (_, px, py), grad_plain_ms = timed_once(lambda: emdk.emd_grads_plain(xe, ye))
    torch.cuda.synchronize()
    e_sw, e_pl = pair_err(cost, sw, EMD_FLOOR), pair_err(cost, pe, EMD_FLOOR)
    e_g = torch.maximum(pair_norm_err(gxe, px), pair_norm_err(gye, py))
    check(med(e_sw) <= TOL_EMD_MEDIAN and float(e_sw.max()) <= TOL_EMD_MAX
          and med(e_pl) <= TOL_EMD_MEDIAN and float(e_pl.max()) <= TOL_EMD_MAX,
          f"emd B=8 N={n}: against emd_sweeps_plain {med(e_sw)}, {float(e_sw.max())}; emd_plain {med(e_pl)}, "
          f"{float(e_pl.max())}")
    # the gradients against an f64 run, as phase 3d holds the ragged batch:
    # the kernel no further from it than EMD_GRAD_F64_RATIO times the f32
    # plain version, plus a floor
    k = LARGE_F64_PAIRS
    _, qx, qy = emdk.emd_grads_plain(xe[:k].double(), ye[:k].double())
    k64 = torch.maximum(pair_norm_err(gxe[:k], qx), pair_norm_err(gye[:k], qy))
    p64 = torch.maximum(pair_norm_err(px[:k], qx), pair_norm_err(py[:k], qy))
    check(float(k64.max()) <= EMD_GRAD_F64_RATIO * float(p64.max()) + EMD_GRAD_F64_FLOOR,
          f"emd gradient mode B=8 N={n} against f64: kernel {k64.tolist()}, plain f32 {p64.tolist()}")
    emd_ms = cuda_ms(lambda: emdk.emd_nograd(xe, ye), 3, warmup=1)
    grad_ms = cuda_ms(lambda: emdk.emd_with_grads(xe, ye), 3, warmup=1)
    _, (ebd, eby) = eval_bounds(b, n, n, b, b, b)
    _, (gbd, gby) = grad_bounds(b, n, n)
    rows.append(("emd_batched_large", "emd", "dpfx/ops/emd.py:356", "emd_batched",
                 float((cost - pe).abs().max()), emd_ms, emd_plain_ms, ebd, eby))
    rows.append(("emd_batched_grad_large", "emd", "dpfx/ops/emd.py:356", "emd_batched_grad",
                 max(float((gxe - px).abs().max()), float((gye - py).abs().max())), grad_ms, grad_plain_ms,
                 gbd, gby))
    print(f"kernel-vs-plain large layout emd B={b} N={n}: against emd_sweeps_plain rel median {med(e_sw):.2e} "
          f"max {float(e_sw.max()):.2e}, emd_plain median {med(e_pl):.2e} max {float(e_pl.max()):.2e}; "
          f"{emd_ms:.2f} ms (bound {ebd:.2f} ms, {emd_ms / ebd:.2f}x; plain {emd_plain_ms:.1f} ms); gradient "
          f"mode: cost bit for bit, gradients per pair against emd_grads_plain rel median {med(e_g):.2e} max "
          f"{float(e_g.max()):.2e}, against f64 ({k} pairs) max {float(k64.max()):.2e} (the f32 plain version "
          f"{float(p64.max()):.2e}), "
          f"{grad_ms:.2f} ms (bound {gbd:.2f} ms, {grad_ms / gbd:.2f}x; plain {grad_plain_ms:.1f} ms); "
          f"{emdk.large_own(b, n, n)} points a CTA")

    xp_, yp_ = test[:4], val[:4]
    s = xp_.shape[0]
    pw = {}
    for prec in ("fast", "exact"):
        pw[prec] = emdk.emd_pairwise(xp_, yp_, precision=prec)
        ref, t_plain = timed_once(lambda: emdk.emd_pairwise_plain(xp_, yp_, precision=prec))
        e = pair_err(pw[prec], ref, EMD_FLOOR)
        check(torch.equal(pw[prec], emdk.emd_pairwise(xp_, yp_, precision=prec))
              and med(e) <= TOL_EMD_MEDIAN and float(e.max()) <= TOL_EMD_MAX,
              f"emd_pairwise {prec} {s}x{s} N={n}: twice the same, against the plain version {med(e)}, "
              f"{float(e.max())}")
        pw[prec + "_err"], pw[prec + "_rel"] = float((pw[prec] - ref).abs().max()), float(e.max())
        pw[prec + "_plain"] = t_plain
    turns = {"exact": [], "fast": []}
    for prec in ("exact", "fast", "fast", "exact"):
        turns[prec].append(cuda_ms(lambda: emdk.emd_pairwise(xp_, yp_, precision=prec), 1, warmup=1))
    pw_ms = sum(turns["fast"]) / 2
    _, (pbd, pby) = eval_bounds(s * s, n, n, s, s, s * s)
    rows.append(("emd_pairwise_large", "emd", "dpfx/ops/emd.py:435", "emd_pairwise", pw["fast_err"], pw_ms,
                 pw["fast_plain"], pbd, pby))
    print(f"kernel-vs-plain large layout emd_pairwise {s}x{s} N={n}: fast rel max {pw['fast_rel']:.2e}, exact "
          f"rel max {pw['exact_rel']:.2e}; in turns (exact, fast, fast, exact) "
          f"{', '.join(f'{t:.2f}' for t in (turns['exact'][0], *turns['fast'], turns['exact'][1]))} ms "
          f"(bound {pbd:.2f} ms; plain fast {pw['fast_plain']:.1f} ms, exact {pw['exact_plain']:.1f} ms)")
    check(all(v["pair"] == 0 for v in layouts().values()), f"every check's launch on the large layout: {layouts()}")
    print(f"phase 3m (large clouds) {time.perf_counter() - t_phase:.1f} s")
    return [{"name": nm, "route": "cuda", "source": f"dpfx_torch/ops/csrc/{src}.cu", "replaces": where,
             "launches": launched[key], "max_abs_err": err, "ms": ms, "plain_ms": plain, "bound_ms": bd,
             "bound_by": by, "library_ms": None}
            for nm, src, where, key, err, ms, plain, bd, by in rows]


# ---------------------------------------------------------------- phase 3k: the tools

TOL_TRACE_BUSY = 0.05   # parse_trace's device total against phase 5b's busy time, relative

# one child process runs the tools in turn: each tool's main(args) with its
# environment set and the launch counts reset, its stdout captured; one JSON
# line a tool, prefixed TOOL_MARK
TOOL_MARK = "dpfx-tool "
TOOL_CHILD = """
import contextlib, gc, importlib, io, json, os, sys, time, traceback
import torch
from dpfx_torch.tools._common import reset_launch_counts
for module, args, env in json.loads(sys.argv[1]):
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    reset_launch_counts()
    out, t0 = io.StringIO(), time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            rc = importlib.import_module(module).main(args)
    except BaseException:
        rc = traceback.format_exc()[-3000:]
    for k, v in saved.items():
        if v is None:
            os.environ.pop(k, None)
        else:
            os.environ[k] = v
    gc.collect()
    torch.cuda.empty_cache()
    print(sys.argv[2] + json.dumps({"module": module, "rc": rc, "stdout": out.getvalue(),
                                    "s": time.perf_counter() - t0}), flush=True)
"""


def run_tools(plan):
    """Each (module, args, env) of ``plan`` in turn in ONE child process from
    the repo root (the child reaches the card once): ``main(args)`` with env
    set and the launch counts reset. Returns each tool's stdout lines and
    the launch counts of its last line (None where it prints none)."""
    proc = subprocess.run([sys.executable, "-c", TOOL_CHILD, json.dumps(plan), TOOL_MARK],
                          cwd=ROOT, capture_output=True, text=True, timeout=600)
    check(proc.returncode == 0, f"the tools' process exited {proc.returncode}: "
                                f"{proc.stderr[-2000:]}")
    done = [json.loads(ln[len(TOOL_MARK):]) for ln in proc.stdout.splitlines()
            if ln.startswith(TOOL_MARK)]
    check([r["module"] for r in done] == [m for m, _, _ in plan],
          f"the tools' process ran {[r['module'] for r in done]}: {proc.stderr[-2000:]}")
    out = []
    for r in done:
        print(r["stdout"], end="")
        print(f"({r['module']}: {r['s']:.1f} s)")
        check(r["rc"] == 0, f"{r['module']} returned {r['rc']}")
        lines = r["stdout"].strip().splitlines()
        launches = (json.loads(lines[-1].split(" ", 1)[1])
                    if lines and lines[-1].startswith("launches ") else None)
        out.append((lines, launches))
    return out


def tools_path(cfg, dev, card, ckpt_dir: Path, samples: Path, replayed, busy_us: float):
    """Phase 3k: every measurement and data tool of ``dpfx_torch.tools`` at
    the flagship widths, in turn in one child process (``run_tools``), each
    counting its launches from 0 and printing them last; ``replayed`` is
    phase 3b's [replayed call of 20, state] and ``busy_us`` phase 5b's
    device-busy time for such a call."""
    import shutil

    import numpy as np
    import torch
    import yaml

    from dpfx_torch.config import config_from_dict
    from dpfx_torch.data import build_dataset
    from dpfx_torch.tools import parse_trace
    from dpfx_torch.tools.prof_train import LABELS, PIECES
    from dpfx_torch.utils.profiling import trace

    t0 = time.perf_counter()
    work = WORK / "tools"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    # a trace around one replayed call of 20, for parse_trace
    tdir = work / "trace"
    with trace(str(tdir)):
        call, st = replayed
        replayed[1], _ = call(st)
    torch.cuda.empty_cache()      # the child needs the card's memory (B=256 steps)
    with open(CONFIG) as f:
        y = yaml.safe_load(f)
    y["train"]["ckpt_dir"] = str(ckpt_dir)
    int8_cfg = work / "int8.yaml"
    int8_cfg.write_text(yaml.safe_dump(y))
    tree, renders = work / "shapenet", work / "renders"
    (kb_out, serve_out, prof_out, sweep_out, i8_out, oracle_out, _, pin_out,
     trace_out) = run_tools([
        ("dpfx_torch.tools.bench_kernels", ["5"], {}),
        ("dpfx_torch.tools.bench_serving", [],
         {"DPFX_SERVE_BATCHES": "1,16,64,1024", "DPFX_SERVE_REPS": "5"}),
        ("dpfx_torch.tools.prof_train", list(PIECES), {"DPFX_PROF_REPS": "5"}),
        ("dpfx_torch.tools.bench_batch_sweep", ["--batches", "64,128,256", "--reps", "5"], {}),
        ("dpfx_torch.tools.bench_sample_int8", [],
         {"DPFX_INT8_CKPT": str(int8_cfg), "DPFX_INT8_REPS": "5"}),
        ("dpfx_torch.tools.quality_oracle",
         [str(CONFIG), "data.synthetic_size=512", "--limit", "128"], {}),
        ("dpfx_torch.tools.make_synthetic_shapenet",
         [str(tree), "--train", "20", "--valtest", "5", "--points", "2500", "--renders",
          str(renders), "--views", "3", "--imgsize", "64"], {}),
        ("dpfx_torch.tools.part_count_pin", [str(CONFIG), str(samples), "--limit", "128"], {}),
        ("dpfx_torch.tools.parse_trace", [str(tdir), "20", "8"], {}),
    ])

    def need(launches, names, what):
        check(launches is not None, f"{what} printed its launches")
        for k in names:
            check(launches.get(k, 0) > 0, f"{what}: kernel {k} launched ({launches})")

    # bench_kernels: each kernel against its plain twin
    lines, launches = kb_out
    kb = json.loads(lines[-2])
    check(kb["protocol"] == "cuda-events" and finite_numbers(kb)
          and all(v > 0 for k, v in kb.items() if k.endswith("_ms")) and len(kb) == 17,
          f"bench_kernels' keys {sorted(kb)}")
    need(launches, ("nnd_fwd", "nnd_bwd", "cd_pairwise", "emd_batched", "emd_pairwise",
                    "fused_sample"), "bench_kernels")
    # bench_serving at B = 1, 16, 64, 1024
    lines, launches = serve_out
    serve = [ln.split() for ln in lines if ln.startswith("fused ")]
    check([int(r[1]) for r in serve] == [1, 16, 64, 1024]
          and all(math.isfinite(float(r[2])) and float(r[2]) > 0 for r in serve),
          f"bench_serving's rows {serve}")
    need(launches, ("fused_sample",), "bench_serving")
    # prof_train: every piece, replays of a captured graph
    lines, launches = prof_out
    pieces = [ln for ln in lines if ln.startswith("  ") and " ms " in ln]
    check(len(pieces) == len(PIECES) and all(ln.strip().startswith(LABELS[p])
                                             for ln, p in zip(pieces, PIECES))
          and all("busy" in ln for ln in pieces), f"prof_train's pieces {pieces}")
    need(launches, ("fused_train_fwd", "fused_train_bwd", "fused_encoder_fwd",
                    "fused_encoder_bwd"), "prof_train")
    # bench_batch_sweep: ms/step and MFU at B = 64, 128, 256
    lines, launches = sweep_out
    rows = [ln.strip("|").split("|") for ln in lines if ln.startswith("| ") and "%" in ln]
    mfu = [float(r[3].strip().rstrip("%")) / 100 for r in rows]
    check([int(r[0]) for r in rows] == [64, 128, 256]
          and all(math.isfinite(m) and 0 < m <= 1 for m in mfu), f"bench_batch_sweep's rows {rows}")
    need(launches, ("fused_train_fwd", "fused_train_bwd", "fused_encoder_fwd",
                    "fused_encoder_bwd"), "bench_batch_sweep")
    # bench_sample_int8 on phase 3b's checkpoint
    lines, launches = i8_out
    i8 = json.loads(lines[-2])
    check(i8["weights"] == f"{cfg.name}@{TRAIN_STEPS}" and finite_numbers(i8),
          f"bench_sample_int8 on the trained checkpoint: {i8}")
    need(launches, ("fused_sample", "fused_sample_int8"), "bench_sample_int8")
    # the checkpoint's own sensitivity to rounding, beside the int8 error
    # (phase 3e holds the int8 kernel to the kernel on dequantized stacks):
    # its bf16 clouds against its f32 clouds on the tool's z and seed
    from dpfx_torch.checkpoint import restore_for_eval
    from dpfx_torch.ops import fused_sampler as fs

    tmodel = restore_for_eval(cfg, str(ckpt_dir / cfg.name / f"params_{TRAIN_STEPS:08d}.pt"), dev)
    with torch.no_grad():
        tsp = fs.stack_point_flow_params(tmodel.point_flow)
    tz = torch.randn((256, cfg.model.dz), generator=torch.Generator(device=dev).manual_seed(7),
                     device=dev)
    x16, x32 = (fs.fused_sample_points(tsp, tz, 3, 2048, dtype=dt)
                for dt in (torch.bfloat16, torch.float32))
    sens = float((x16 - x32).pow(2).mean().sqrt() / x16.pow(2).mean().sqrt())
    med = float((x16 - x32).norm(dim=-1).median())
    print(f"bench_sample_int8 on the {TRAIN_STEPS}-step checkpoint: int8 against bf16 relative "
          f"RMS {i8['rel_rms']}, a point's distance median {i8['point_err_median']:.3e}, p99.9 "
          f"{i8['point_err_p999']:.3e}, max {i8['point_err_max']:.3e}; the checkpoint's bf16 "
          f"against f32 clouds: relative RMS {sens:.5f}, median {med:.3e} (its sensitivity to "
          f"rounding); bf16 {i8['bf16_ms']} ms, int8 {i8['int8_ms']} ms ({card})")
    del tmodel, tsp
    # quality_oracle at --limit 128: phase 3c's ideal and shifted gates
    lines, launches = oracle_out
    rows = {r["oracle"]: r for r in (json.loads(ln) for ln in lines if ln.startswith("{"))}
    for m in cfg.eval.metrics:
        check(0.35 <= rows["train_vs_test"][f"1-nna-{m}"] <= 0.65,
              f"quality_oracle train_vs_test 1-NNA-{m} {rows['train_vs_test'][f'1-nna-{m}']}")
        check(rows["noise_vs_test"][f"1-nna-{m}"] >= 0.9,
              f"quality_oracle noise_vs_test 1-NNA-{m} {rows['noise_vs_test'][f'1-nna-{m}']}")
    need(launches, ("cd_pairwise", "emd_pairwise"), "quality_oracle")
    # make_synthetic_shapenet's tree with renders, read back by build_dataset
    for name, extra in (("shapenet_npy_dir", {}),
                        ("shapenet_svr", {"render_path": str(renders), "views_per_model": 3})):
        dcfg = config_from_dict({"data": {"dataset": name, "path": str(tree), "category": "all",
                                          **extra}}).data
        for split, size in (("train", 20), ("test", 5)):
            ds = build_dataset(dcfg, split, 64)
            check(len(ds) == size and ds[0].shape == (2500, 3)
                  and bool(np.isfinite(ds[0]).all()), f"{name} {split}: {len(ds)} clouds")
            if name == "shapenet_svr":
                check(ds.image(0).shape == (64, 64, 3), f"{name}'s renders")
    # part_count_pin on phase 3's sampled clouds
    lines, launches = pin_out
    pin = json.loads("\n".join(lines[lines.index("{"):-1]))
    check(pin["n_chain_refs"] > 0 and sum(pin["ref_true_k_hist"].values()) == pin["n_chain_refs"],
          f"part_count_pin's report {pin}")
    need(launches, ("cd_pairwise",), "part_count_pin")
    # parse_trace on the trace of one replayed call of 20
    text = "\n".join(trace_out[0])
    total = float(text.split("device total: ")[1].split()[0])
    check(abs(total - busy_us / 20e3) <= TOL_TRACE_BUSY * busy_us / 20e3,
          f"parse_trace's device total {total} ms/step against phase 5b's {busy_us / 20e3}")
    check(abs(parse_trace.device_total_ms(str(tdir), 20) - total) < 1e-3, "parse_trace's total")
    print(f"phase 3k: the tools: parse_trace's device total {total:.4f} ms/step against phase "
          f"5b's {busy_us / 20e3:.4f}; {time.perf_counter() - t0:.1f} s ({card})")


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
            fwd2 = ft.fused_forward_kernel(*tw, xt, hz, dtype)
            u_p, ld_p = ft.fused_forward_plain(*tw, xt, hz, dtype)
            du = torch.randn(u.shape, generator=g, device=dev)
            dld = torch.randn(ld.shape, generator=g, device=dev)
            got = ft.fused_backward_kernel(*tw, u_p, hz, du, dld, dtype)
            again = ft.fused_backward_kernel(*tw, u_p, hz, du, dld, dtype)
            ref = ft.fused_backward_plain(*tw, u_p, hz, du, dld, dtype)
            torch.cuda.synchronize()
            held_to_plain(f"fused_train N={n}", dtype, (u, ld), (u_p, ld_p), got, again, ref,
                          ["log-det"] + grad_names, fwd_again=fwd2)
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
            u, ld = fl.latent_forward_kernel(lw, lmasks, cap, z, dtype)
            zi = fl.latent_inverse_kernel(lw, lmasks, cap, z, dtype)
            again_fwd = (*fl.latent_forward_kernel(lw, lmasks, cap, z, dtype),
                         fl.latent_inverse_kernel(lw, lmasks, cap, z, dtype))
            u_p, ld_p = fl.latent_forward_plain(lw, lmasks, cap, z, dtype)
            zi_p = fl.latent_inverse_plain(lw, lmasks, cap, z, dtype)
            du = torch.randn(u.shape, generator=g, device=dev)
            dld = torch.randn(ld.shape, generator=g, device=dev)
            got = lat_flat(fl.latent_backward_kernel(lw, lmasks, cap, u_p, du, dld, dtype))
            again = lat_flat(fl.latent_backward_kernel(lw, lmasks, cap, u_p, du, dld, dtype))
            ref = lat_flat(fl.latent_backward_plain(lw, lmasks, cap, u_p, du, dld, dtype))
            torch.cuda.synchronize()
            latent_held(f"fused_latent B={b}", dtype, u, ld, zi, u_p, ld_p, zi_p, got, again, ref,
                        lat_names, fwd_again=again_fwd)
            if f32:
                back, _ = fl.latent_forward_kernel(lw, lmasks, cap, zi, dtype)
                trip = float((back - z).abs().max())
                print(f"fused_latent f32 round trip fwd(inv(eps)) B={b}: max_abs={trip:.3e}")
                check(trip <= TOL_F32, f"fused_latent round trip B={b}: {trip}")
            else:
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

    # ---- 3b. the training path at full width (dpfx_torch.train's CLI, the
    # YAML's steps_per_call=20 and device_resident as written)
    import copy
    import shutil

    from dpfx_torch.data import build_dataset, iterate_batches, preload_clouds
    from dpfx_torch.train import trainer as trainer_mod

    ckpt_dir = WORK / "train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    flax_init = trainer_mod.init_params_
    for mod in (ft, fe):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    rc, text, calls, init_weights = train_cli_run(
        [str(CONFIG), f"train.steps={TRAIN_STEPS}", "train.log_every=5",
         f"train.ckpt_every={TRAIN_STEPS}", f"train.ckpt_dir={ckpt_dir}",
         "data.synthetic_size=512"])
    torch.cuda.synchronize()
    train_wall = time.perf_counter() - t0
    train_launches = {**ft.launches, **fe.launches}
    run_dir = ckpt_dir / cfg.name
    records = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    val_records = [r for r in records if r["kind"] == "val"]
    records = [r for r in records if r["kind"] == "train"]
    # one call of 20 steps and a tail of 10; a call logs where it crosses a
    # multiple of log_every=5, and the run's last step checkpoints; the
    # YAML's eval_every (5000) is not crossed, so the CLI evaluates the
    # validation split (128 clouds, 4 batches of 32) once, at the end
    check(rc == 0 and [kk for kk, _ in calls] == [20, TRAIN_STEPS - 20]
          and [r["step"] for r in records] == [20, TRAIN_STEPS], f"train calls {calls}, records {records}")
    check([r["step"] for r in val_records] == [TRAIN_STEPS] and finite_numbers(val_records[0]),
          f"one final evaluation, finite: {val_records}")
    check("ignored" not in text and "device-resident split: 512 clouds x 4096 stored pts" in text
          and "steps_per_call=20" in text, "the CLI trains the YAML as written")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in records),
          "every logged loss and grad norm is finite")
    check(all(r["nonfinite_skipped"] == 0 for r in records), "no step was skipped")
    # the launch counts stay true under replay: the capture's warm-up steps
    # (eager) and one step's launches per replay; the forwards also once a
    # batch of the final evaluation
    for kname, count in train_launches.items():
        want = trainer_mod._WARMUP + TRAIN_STEPS + (VAL_BATCHES if kname.endswith("fwd") else 0)
        check(count == want, f"kernel {kname}: {count} launches for {trainer_mod._WARMUP} warm-up "
                             f"steps, {TRAIN_STEPS} replays and {VAL_BATCHES} evaluation batches")
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
    step_losses = [v for _, ls in calls for v in ls]
    print(f"training path: {TRAIN_STEPS} steps of 64 x 2048 (resident split, calls of "
          f"{[kk for kk, _ in calls]} steps, replays of the captured step) in {train_wall:.1f} s "
          f"wall (build, data, capture and warm-up included); launches {json.dumps(train_launches)}; "
          "loss " + ", ".join(f"{r['loss']:.1f}" for r in records) + "; grad norm "
          + ", ".join(f"{r['grad_norm']:.1f}" for r in records) + "; points/s "
          + ", ".join(f"{r['points_per_sec']:,.0f}" for r in records)
          + f"; {moved} tensors moved; trained checkpoint sampled, std {float(tclouds.std()):.3f}")

    # the training CLI with the fused latent flow (train.fused_latent_flow=true)
    # for 10 steps, a tail call alone, on the 30-step run's schedule
    # (lr_decay_steps=30: warmup over 29 steps; with steps=10 alone it would
    # reach the peak lr at step 9) and its draws (keyed by the step), so its
    # loss windows of 5 steps are held to that run's first two
    lat_dir = WORK / "train_fused_latent"
    shutil.rmtree(lat_dir, ignore_errors=True)
    for mod in (ft, fe, fl):
        mod.reset_launch_counts()
    t0 = time.perf_counter()
    rc, text, lcalls, init_weights = train_cli_run(
        [str(CONFIG), "train.steps=10", "train.log_every=5", f"train.lr_decay_steps={TRAIN_STEPS}",
         "train.ckpt_every=10", f"train.ckpt_dir={lat_dir}", "data.synthetic_size=512",
         "train.fused_latent_flow=true"])
    torch.cuda.synchronize()
    lat_wall = time.perf_counter() - t0
    lat_train_launches = {**ft.launches, **fe.launches, **fl.launches}
    lat_run = lat_dir / cfg.name
    lrecs = [json.loads(line) for line in (lat_run / "metrics.jsonl").read_text().splitlines()]
    lval = [r for r in lrecs if r["kind"] == "val"]
    lrecs = [r for r in lrecs if r["kind"] == "train"]
    check(rc == 0 and [kk for kk, _ in lcalls] == [10] and [r["step"] for r in lrecs] == [10]
          and [r["step"] for r in lval] == [10] and finite_numbers(lval[0]),
          f"fused-latent train calls {lcalls}, records {lrecs}, {lval}")
    check("ignored" not in text, "the CLI trains the YAML as written (fused latent flow)")
    check(all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in lrecs),
          "every logged loss and grad norm is finite (fused latent flow)")
    check(all(r["nonfinite_skipped"] == 0 for r in lrecs), "no step was skipped (fused latent flow)")
    for kname in ("fused_train_fwd", "fused_train_bwd", "fused_encoder_fwd", "fused_encoder_bwd",
                  "fused_latent_fwd", "fused_latent_bwd"):
        want = trainer_mod._WARMUP + 10 + (VAL_BATCHES if kname.endswith("fwd") else 0)
        check(lat_train_launches[kname] == want,
              f"kernel {kname}: {lat_train_launches[kname]} launches on the fused-latent "
              "training path")
    lat_trained = torch.load(lat_run / "params_00000010.pt", map_location="cpu", weights_only=True)
    lat_moved = sum(not torch.equal(lat_trained[kk], v) for kk, v in init_weights.items())
    check(lat_moved == len(init_weights),
          f"{lat_moved} of {len(init_weights)} parameters moved (fused latent flow)")
    lat_losses = [v for _, ls in lcalls for v in ls]
    windows = lambda ls: [sum(ls[i:i + 5]) / 5 for i in (0, 5)]  # noqa: E731
    drift = max(abs(a - r) / abs(r) for a, r in zip(windows(lat_losses), windows(step_losses)))
    print(f"training path with the fused latent flow: 10 steps of 64 x 2048 (one call) in "
          f"{lat_wall:.1f} s wall; launches {json.dumps(lat_train_launches)}; loss "
          + ", ".join(f"{r['loss']:.1f}" for r in lrecs) + "; grad norm "
          + ", ".join(f"{r['grad_norm']:.1f}" for r in lrecs) + f"; {lat_moved} tensors moved; "
          f"loss windows of 5 steps against the module-latent run's: rel {drift:.2e}")
    check(drift <= TOL_TRAIN_DRIFT, f"fused-latent training tracks the module path ({drift})")

    # the train step alone, batches already on the card
    dcfg = copy.deepcopy(cfg.data)
    dcfg.synthetic_size = 512
    train_ds = build_dataset(dcfg, "train")
    batches = [{"x": torch.from_numpy(bt["x"]).to(dev)} for bt, _ in
               zip(iterate_batches(train_ds, 64, 2048, seed=5), range(4))]
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

    # the captured step at full width, the latent flow through the module and
    # fused: replays against eager steps, a resident call against eager steps
    # on its draws (bit for bit, on supplied noise), the skip inside a replay
    lcfg = copy.deepcopy(cfg)
    lcfg.train.fused_latent_flow = True
    x20 = torch.stack([batches[i % 4]["x"] for i in range(20)])
    clouds_dev = torch.from_numpy(preload_clouds(train_ds)).to(dev)
    timers, multis = {}, {}
    for key, c, name in (("off", cfg, "module latent flow"), ("on", lcfg, "fused latent flow")):
        (multi, rstate), (resident, sstate) = captured_step_checks(c, dev, clouds_dev, x20, name)
        multis[key] = multi
        timers[(key, "replayed")] = [lambda st, f=multi: f(st, {"x": x20}), rstate]
        timers[(key, "resident")] = [lambda st, f=resident: f(st, clouds_dev, 20), sstate]

    # the eager, replayed and resident step with the latent flow off and on,
    # 20 steps a turn, in turns (each kind off then on, then back)
    lmodel = copy.deepcopy(ref_model)
    ltx = trainer_mod.make_optimizer(lcfg.train)
    lstate = trainer_mod.init_state(lmodel, ltx)
    lat_step = trainer_mod.make_train_step(lmodel, ltx, lcfg)
    for i in range(3):
        lstate, _ = lat_step(lstate, batches[i % 4])
    runs = {"off": [train_step, tstate], "on": [lat_step, lstate]}

    def eager_call(key):
        def call(st):
            for i in range(20):
                st, m = runs[key][0](st, batches[i % 4])
            return st, m
        return call

    for key in ("off", "on"):
        timers[(key, "eager")] = [eager_call(key), runs[key][1]]

    def timed_call(key):
        call, st = timers[key]
        torch.cuda.synchronize()
        start.record()
        timers[key][1], _ = call(st)
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / 20

    order = [(m_, kind) for m_ in ("off", "on") for kind in ("eager", "replayed", "resident")]
    turns = [(key, timed_call(key)) for key in order + order[::-1]]
    train_ms = {key: sum(t for k2, t in turns if k2 == key) / 2 for key in order}
    runs["off"][1], runs["on"][1] = timers[("off", "eager")][1], timers[("on", "eager")][1]
    tstate, lstate = runs["off"][1], runs["on"][1]
    off_ms, on_ms = train_ms[("off", "eager")], train_ms[("on", "eager")]
    for m_, name in (("off", "module latent flow"), ("on", "fused latent flow")):
        print(f"train step at 64 x 2048, {name}: eager {train_ms[(m_, 'eager')]:.3f} ms/step, "
              f"replayed {train_ms[(m_, 'replayed')]:.3f}, resident {train_ms[(m_, 'resident')]:.3f} "
              f"(calls of 20); points/s eager {64 * 2048 / train_ms[(m_, 'eager')] * 1e3:,.0f}, "
              f"replayed {64 * 2048 / train_ms[(m_, 'replayed')] * 1e3:,.0f}, resident "
              f"{64 * 2048 / train_ms[(m_, 'resident')] * 1e3:,.0f} ({card})")
    print("train step turns (ms/step): " + ", ".join(f"{k1} {k2} {t:.3f}" for (k1, k2), t in turns)
          + f" ({card})")

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

    # ---- 3g. the trainer loop at full width: evaluation, checkpoints kept
    # by ckpt_keep, --resume, resume bit for bit, recovery with a recapture,
    # evaluation against the CPU
    trainer_loop_path(cfg, dev, card)

    # ---- 3c. the evaluation paths at full width, on phase 3b's checkpoint
    gen_launches, ae_launches, half_a, half_b = eval_paths(cfg, dev, ckpt_dir, trained_pt)

    # ---- 3d. the differentiable distances at full width (B=64 x 2048)
    grad_rows = distance_grad_paths(cfg, dev, clouds)

    # ---- 3e. the int8 sampler (flagship stack, bf16, B=64 and 256)
    int8_rows = int8_sampler_path(sp, cfg, dev, card)

    # ---- 3f. the probe tools at full width (bench_fused_bwd, probe_dual_issue)
    probe_rows = probe_tools_path(sp, dev, card)

    # ---- 3h. single-view reconstruction (mixer and conv) and the ShapeNet npy layout
    svr_path(dev, card, timers[("off", "replayed")])

    # ---- 3i. the packed-stack training path, generate --png and the converter
    packed_path(cfg, dev, card, multis["off"], timers, train_ms, step_losses, val_records[0])

    # ---- 3j. data parallel: world-1 NCCL with the all-reduce captured, two gloo
    # ranks sharing the card, the row-sharded suite, the CLI's card count
    data_parallel_path(dev, card)

    # ---- 3l. the kernels' widths off the flagship's grid: the cluster and
    # f32 layouts, the f32 sampler at H=256, padded widths, runs (a) to (c)
    shape_rows = shapes_path(dev, card, x20, timers[("off", "replayed")])

    # ---- 3m. CD and EMD at 15,000 points: the large-cloud layout
    large_rows = large_cloud_path(dev, card)

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
    kernels += grad_rows + int8_rows + probe_rows + shape_rows + large_rows
    # 32 rows, then the cluster inverse's cases of phase 3l: relu at H=256
    # n_hidden 4, and inverse_cases at each shape of CLUSTER_INVERSE, then
    # phase 3m's six large-layout rows
    from dpfx_torch.ops import fused_sampler as fsm

    check(len(kernels) == 32 + 1 + sum(len(inverse_cases(fsm, sh)) for sh in fsm.CLUSTER_INVERSE) + 6,
          f"{len(kernels)} kernel rows")
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

    # one replayed call and one resident call of 20 steps each (replays of
    # the captured step), the latent flow off and on
    call_busy_us = {}
    for key, name in (("off", "module latent flow"), ("on", "fused latent flow")):
        for kind in ("replayed", "resident"):
            def one_call():
                call, st = timers[(key, kind)]
                timers[(key, kind)][1], _ = call(st)

            wall_us, busy_us, dev_events = profiled(one_call, 1)
            call_busy_us[(key, kind)] = busy_us
            seen = lambda name: sum(name in e.key for e in dev_events)  # noqa: E731
            check(seen("fwd_kernel_mma") and seen("bwd_kernel_mma") and seen("walk_kernel")
                  and (key == "off" or seen("cluster_bwd_kernel")),
                  f"the profiler saw the training kernels in a {kind} call ({name})")
            top = sorted(dev_events, key=lambda e: -e.self_device_time_total)[:6]
            unprofiled = train_ms[(key, kind)]
            print(f"profile {kind} call of 20 steps, {name}: wall {wall_us / 20e3:.3f} ms/step, "
                  f"device busy {busy_us / 20e3:.3f} ms/step, idle share "
                  f"{1 - busy_us / wall_us:.3f} under the profiler, "
                  f"{1 - busy_us / 20e3 / unprofiled:.3f} against the unprofiled {unprofiled:.3f} "
                  f"ms/step; {sum(e.count for e in dev_events) / 20:.1f} kernels/step; top: "
                  + "; ".join(f"{e.key[:60]} {e.self_device_time_total / 20e3:.3f} ms "
                              f"x{e.count / 20:g}" for e in top) + f" ({card})")

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

    # ---- 3k. the tools (after 5b: parse_trace is held to its busy time)
    tools_path(cfg, dev, card, ckpt_dir, samples, timers[("off", "replayed")],
               call_busy_us[("off", "replayed")])
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dp-worker"]:      # a rank of phase 3j, started by the smoke itself
        sys.exit(dp_worker(int(sys.argv[2]), int(sys.argv[3]), Path(sys.argv[4]), sys.argv[5]))
    sys.exit(main())
