// Approximate EMD (approxmatch) on Hopper (sm_90a): the matching cost of
// diagonal pairs, and the pairwise cost matrix of two sets.
//
// Replaces the Pallas TPU kernels `_emd_pallas_batched` (dpfx/ops/emd.py:356),
// with_grad False and True, and `_emd_pallas_pairwise` (:435), which share
// `_emd_kernel_body` (:147). One kernel serves all three, over a list of
// (left, right) cloud pairs: diagonal pairs (emd_batched, exact f32; with
// GRAD also the gradients, emd_batched_grad) or the pairs of an S1 x S2
// matrix (emd_pairwise, fast or exact).
//
// The algorithm (10 annealed levels; level = -4^j, 0 on the last):
//   w_ij = exp(level d_ij) remainr_j            d = squared distance
//   ss_ij = w_ij remainl_i / (sum_j w_ij + eps)
//   ratio_j = min(remainr_j / (sum_i ss_ij + eps), 1)
//   cost += sum_j ratio_j sum_i ss_ij sqrt(d_ij)
//   remainl_i -= sum_j ss_ij ratio_j ; remainr_j -= ratio_j sum_i ss_ij
// and the wrapper divides the cost by n.
//
// What bounds it: per pair and level N x M elements, each needing an exp
// (MUFU ex2) and a sqrt (MUFU) besides ~20 FP32 instructions; MUFU runs at
// 16 per clock per SM against 128 FP32 lanes, so the issue rate of the
// special-function units and the CUDA cores bound it. The two clouds (48 KB)
// are read once per pair: memory plays no part.
//
// Design:
//   * The Pallas kernels keep [Np, Mp] caches in VMEM (a bf16 w cache; in
//     exact mode f32 d and ss caches, 32 MB at N = 2048). An SM has 227 KB.
//     But one pair's whole state fits in one SM: both clouds as float4
//     (x, y, z, |p|^2), 64 KB at N = M = 2048, and the per-point vectors
//     (remainl, rowsum, scale per row; remainr, its next value, ratio per
//     column), 48 KB. So one block per pair, and every [N, M] tile is
//     recomputed from the coordinates when a pass needs it: a distance is a
//     few FP32 instructions, reading it back would be 4 bytes of memory.
//   * Per level, three passes, each with one thread per row or per column
//     holding R points in registers while the other cloud streams from
//     shared memory as broadcasts: (A) rows: rowsum_i = sum_j w_ij, and the
//     row's scale remainl_i / (rowsum_i + eps); (B) columns: sum_i ss_ij and
//     sum_i ss_ij sqrt(d_ij), then ratio_j, the next remainr_j and the
//     level's cost (a block sum); (C) rows: remainl_i -= (sum_j w_ij
//     ratio_j) remainl_i / (rowsum_i + eps). Rows need the whole row's sum
//     before any ss exists, and columns the whole column's, so the passes
//     alternate; every w is recomputed with the same instructions, so its
//     value is the same in all three. No atomics: every sum runs per thread
//     in a fixed order, the cost across warps in a fixed order, and the
//     result is bit-identical from run to run.
//   * Exact mode: IEEE f32 on the CUDA cores, distances rounded op by op
//     (dpfx_common.cuh's sqdist, equal to the plain torch expression), expf and sqrtf
//     at full precision. Fast mode rounds where the Pallas fast mode rounds:
//     the coordinates to bf16 for the product, d, w and ss to bf16, the
//     row scale to bf16, each ss sqrt(d) term to bf16; exp and sqrt in f32.
//   * Ragged N != M: factorl = max(n, m) / n and factorr = max(n, m) / m
//     come from the wrapper; loops run to the true sizes, so nothing is
//     padded.
//   * GRAD (exact only, as in dpfx): the gradients of the cost with the plan
//     held constant, summed over the levels,
//       gx_i = sum_j delta_ij (x_i - y_j) / max(|x_i - y_j|, eps)
//       gy_j = sum_i delta_ij (y_j - x_i) / max(|x_i - y_j|, eps)
//     with delta_ij = ss_ij ratio_j, the level's share of the plan. The
//     distance here comes from the coordinates' difference, as in dpfx's
//     emd_grads_jnp, not from the expanded d of the cost: near coincident
//     points d cancels to ~0 while |x_i - y_j| is ~1e-4, and 1 / sqrt(d)
//     would weigh the pair by up to 1 / eps (gradients of ~1e2 where they
//     are ~1e-3; the Pallas body divides by sqrt(d) and has that fault).
//     Both sums fit in the passes that exist: (B) owns column j and ends
//     with ratio_j, so it sums ss_ij (y_j - x_i) / max(|x_i - y_j|, eps)
//     beside cs and cdist and adds ratio_j times that to gy_j; (C) owns row
//     i while scale_i = remainl_i / (rowsum_i + eps) is still this level's,
//     so it sums w_ij ratio_j (x_i - y_j) / max(|x_i - y_j|, eps) beside its
//     sum of w ratio and adds scale_i times that to gx_i. The owning thread
//     adds into gx and gy in global memory once per level, so shared memory
//     does not grow and the sums stay in a fixed order. The cost's
//     arithmetic is the same instructions in both modes: the cost of a GRAD
//     launch equals the plain launch's bit for bit. Costs an rsqrt (MUFU)
//     and ~10 FP32 instructions more per element and level in (B) and in (C).
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). The
// launch returns cudaGetLastError().

#include "dpfx_common.cuh"

namespace {

using namespace dpfx;

constexpr int R = 8;                    // points per thread in a pass
constexpr int CHUNK = THREADS * R;      // points a pass covers at once
constexpr float EPS = 1e-9f;

template <bool FAST>
__device__ __forceinline__ float weight(float level, float d, float remainr) {
  const float w = __fmul_rn(expf(__fmul_rn(level, d)), remainr);
  return FAST ? rnd<__nv_bfloat16>(w) : w;
}

// acc += k (a - b) / max(|a - b|, eps), |a - b| from the coordinates
__device__ __forceinline__ void add_unit(float3& acc, float k, const float4 a, const float4 b) {
  const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
  const float s = k * rsqrtf(fmaxf(fmaf(dx, dx, fmaf(dy, dy, dz * dz)), EPS * EPS));
  acc.x = fmaf(s, dx, acc.x);
  acc.y = fmaf(s, dy, acc.y);
  acc.z = fmaf(s, dz, acc.z);
}

// dst (3 floats in global memory, zeroed by the wrapper) += s * g, by the
// owning thread
__device__ __forceinline__ void add_grad(float* dst, float s, const float3 g) {
  dst[0] += s * g.x;
  dst[1] += s * g.y;
  dst[2] += s * g.z;
}

// the row pass: for each row i owned by this thread, acc_i = sum_j w_ij
// (RATIO false) or sum_j w_ij ratio_j (RATIO true), and with GRAD
// g_i = sum_j w_ij ratio_j (x_i - y_j) / max(|x_i - y_j|, eps); then
// fin(i, acc_i, g_i)
template <bool FAST, bool RATIO, bool GRAD, typename Fin>
__device__ void row_pass(const float4* xp, int N, const float4* yp, int M, const float* remainr,
                         const float* ratio, float level, Fin fin) {
  for (int base = 0; base < N; base += CHUNK) {
    float4 p[R];
    float acc[R];
    float3 g[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = xp[min(base + (int)threadIdx.x + r * THREADS, N - 1)];
      acc[r] = 0.f;
      g[r] = make_float3(0.f, 0.f, 0.f);
    }
    for (int j = 0; j < M; ++j) {
      const float4 q = yp[j];
      const float rr = remainr[j];
      const float rt = RATIO ? ratio[j] : 1.f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = sqdist<FAST>(p[r], q);
        const float w = weight<FAST>(level, d, rr);
        acc[r] = RATIO ? __fadd_rn(acc[r], __fmul_rn(w, rt)) : __fadd_rn(acc[r], w);
        if (GRAD) add_unit(g[r], w * rt, p[r], q);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = base + threadIdx.x + r * THREADS;
      if (i < N) fin(i, acc[r], g[r]);
    }
  }
}

// pair p compares cloud pairs[2p] of xs [*, N, 3] with cloud pairs[2p+1] of
// ys [*, M, 3] and writes the matching cost (not yet divided by n) at p;
// GRAD also its gradients (not yet divided by n) at gx [p, N, 3], gy [p, M, 3]
template <bool FAST, bool GRAD>
__global__ void __launch_bounds__(THREADS) emd_kernel(const float* __restrict__ xs,
                                                      const float* __restrict__ ys,
                                                      const int* __restrict__ pairs, int N, int M,
                                                      int n_iters, float factorl, float factorr,
                                                      float* __restrict__ cost_out,
                                                      float* __restrict__ gx,
                                                      float* __restrict__ gy) {
  static_assert(!(FAST && GRAD), "the gradient mode is exact only");
  extern __shared__ float4 pts[];
  __shared__ float red[WARPS];
  float4* xp = pts;
  float4* yp = pts + N;
  float* remainl = reinterpret_cast<float*>(yp + M);
  float* rowsum = remainl + N;
  float* scale = rowsum + N;
  float* remainr = scale + N;
  float* rnext = remainr + M;
  float* ratio = rnext + M;
  const long long p = blockIdx.x;
  if (GRAD) {
    gx += p * N * 3;
    gy += p * M * 3;
  }
  load_points<FAST>(xp, xs + (long long)pairs[2 * p] * N * 3, N);
  load_points<FAST>(yp, ys + (long long)pairs[2 * p + 1] * M * 3, M);
  for (int i = threadIdx.x; i < N; i += THREADS) remainl[i] = factorl;
  for (int j = threadIdx.x; j < M; j += THREADS) remainr[j] = factorr;
  __syncthreads();

  float cost = 0.f;
  for (int it = 0; it < n_iters; ++it) {
    const float level = it == n_iters - 1 ? 0.f : -ldexpf(1.f, 2 * (n_iters - 3 - it));

    // (A) rows: rowsum and the row scale
    row_pass<FAST, false, false>(xp, N, yp, M, remainr, nullptr, level, [&](int i, float rs, float3) {
      rowsum[i] = rs;
      const float sc = __fdiv_rn(remainl[i], __fadd_rn(rs, EPS));
      scale[i] = FAST ? rnd<__nv_bfloat16>(sc) : sc;
    });
    __syncthreads();

    // (B) columns: sum_i ss and sum_i ss sqrt(d); ratio, next remainr, cost
    float part = 0.f;
    for (int base = 0; base < M; base += CHUNK) {
      float4 q[R];
      float rr[R], cs[R], cdist[R];
      float3 g[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = min(base + (int)threadIdx.x + r * THREADS, M - 1);
        q[r] = yp[j];
        rr[r] = remainr[j];
        cs[r] = 0.f;
        cdist[r] = 0.f;
        g[r] = make_float3(0.f, 0.f, 0.f);
      }
      for (int i = 0; i < N; ++i) {
        const float4 x = xp[i];
        const float sc = scale[i];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d = sqdist<FAST>(x, q[r]);
          float ss = __fmul_rn(weight<FAST>(level, d, rr[r]), sc);
          if (FAST) ss = rnd<__nv_bfloat16>(ss);
          float t = __fmul_rn(ss, sqrtf(d));
          if (FAST) t = rnd<__nv_bfloat16>(t);
          cs[r] = __fadd_rn(cs[r], ss);
          cdist[r] = __fadd_rn(cdist[r], t);
          if (GRAD) add_unit(g[r], ss, q[r], x);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = base + threadIdx.x + r * THREADS;
        if (j < M) {
          const float rt = fminf(__fdiv_rn(rr[r], __fadd_rn(cs[r], EPS)), 1.f);
          ratio[j] = rt;
          rnext[j] = fmaxf(__fsub_rn(rr[r], __fmul_rn(cs[r], rt)), 0.f);
          part = __fadd_rn(part, __fmul_rn(rt, cdist[r]));
          if (GRAD) add_grad(gy + 3 * j, rt, g[r]);
        }
      }
    }
    cost = __fadd_rn(cost, block_sum(part, red));   // its barriers publish ratio and rnext

    // (C) rows: remainl -= (sum_j w ratio) remainl / (rowsum + eps)
    row_pass<FAST, true, GRAD>(xp, N, yp, M, remainr, ratio, level, [&](int i, float wr, float3 gi) {
      const float rl = remainl[i];
      remainl[i] = fmaxf(__fsub_rn(rl, __fmul_rn(__fdiv_rn(wr, __fadd_rn(rowsum[i], EPS)), rl)), 0.f);
      if (GRAD) add_grad(gx + 3 * i, scale[i], gi);
    });
    __syncthreads();
    float* t = remainr;
    remainr = rnext;
    rnext = t;
  }
  if (threadIdx.x == 0) cost_out[p] = cost;
}

int smem_bytes(int N, int M) { return (N + M) * (int)sizeof(float4) + 3 * (N + M) * (int)sizeof(float); }

template <bool FAST, bool GRAD>
cudaError_t launch(const float* xs, const float* ys, const int* pairs, int P, int N, int M, int n_iters,
                   float factorl, float factorr, float* cost, float* gx, float* gy,
                   cudaStream_t stream) {
  const int bytes = smem_bytes(N, M);
  cudaError_t e = cudaFuncSetAttribute(emd_kernel<FAST, GRAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return e;
  emd_kernel<FAST, GRAD><<<P, THREADS, bytes, stream>>>(xs, ys, pairs, N, M, n_iters, factorl, factorr,
                                                        cost, gx, gy);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dynamic shared memory of one block (the wrapper checks it against the limit)
int dpfx_emd_smem_bytes(int N, int M) { return smem_bytes(N, M); }

// gx, gy: null, or the gradients' outputs, zeroed (exact mode only; then fast is 0)
int dpfx_emd_launch(const float* xs, const float* ys, const int* pairs, int P, int N, int M, int n_iters,
                    int fast, float factorl, float factorr, float* cost, float* gx, float* gy,
                    void* stream) {
  if (P <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (gx || gy) {
    if (fast || !gx || !gy) return (int)cudaErrorInvalidValue;
    return launch<false, true>(xs, ys, pairs, P, N, M, n_iters, factorl, factorr, cost, gx, gy, s);
  }
  return fast ? launch<true, false>(xs, ys, pairs, P, N, M, n_iters, factorl, factorr, cost, gx, gy, s)
              : launch<false, false>(xs, ys, pairs, P, N, M, n_iters, factorl, factorr, cost, gx, gy, s);
}

}  // extern "C"
