// Chamfer distance on Hopper (sm_90a): per-point squared nearest-neighbour
// distances of diagonal pairs and their backward, and the pairwise CD matrix
// of two sets.
//
// Replaces the Pallas TPU kernels `_nnd_fwd_pallas` (dpfx/ops/chamfer.py:130)
// and `_cd_pallas_pairwise` (:255) with `chamfer_kernel`, and
// `_nnd_bwd_pallas` (:174) with `nnd_bwd_kernel` (below). `chamfer_kernel`
// serves both forwards, over a list of (left, right) cloud pairs: diagonal
// pairs writing dl [P, N] and dr [P, M] (nnd_fwd), or the pairs of an
// S1 x S2 matrix, or its upper triangle, writing mean(dl) + mean(dr) per
// pair (cd_pairwise).
//
// What bounds it: per pair N x M distance elements, each a few FP32
// instructions (3 products and 2 adds for x.y, one add of the squared norms,
// one multiply-subtract, one max) and two mins. The clouds are 24 KB each at
// N = 2048 and are read once per pair, so the work is issue-bound on the CUDA
// cores, far from the memory's rate.
//
// Design:
//   * One block per pair; both clouds sit in shared memory as float4
//     (x, y, z, |p|^2), 64 KB at N = M = 2048. The [N, M] distance tile
//     is never stored: the Pallas kernel carried running column minima in
//     VMEM across a sequential row-tile axis, which a Hopper grid does not
//     have. Here the block makes two passes over the pair: one with a thread
//     per row (row minima), one with a thread per column (column minima),
//     each thread holding R points in registers while the other cloud's
//     points stream from shared memory as broadcasts. The distance is
//     recomputed in the second pass; no atomics.
//   * Exact mode is IEEE f32 on the CUDA cores, no tensor cores (TF32's
//     cancellation error in |x|^2 + |y|^2 - 2 x.y on near-identical points
//     corrupts near-zero distances): every operation is rounded on its own
//     (__fmul_rn / __fadd_rn, never contracted into an FMA), so a distance
//     equals the plain torch expression bit for bit.
//   * Fast mode rounds the coordinates to bf16 for the product (exact in
//     f32), keeps the norms f32, and rounds each distance to bf16, as the
//     Pallas fast mode does. Rounding is monotone, so the f32 min of rounded
//     values is the rounded min.
//   * Minima are exact in any order; the sums of minima run per thread in a
//     fixed order, then across warps in a fixed order: bit-identical from
//     run to run.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). The
// launch returns cudaGetLastError().

#include "dpfx_common.cuh"

namespace {

using namespace dpfx;

constexpr int R = 8;                    // points per thread in a pass
constexpr int CHUNK = THREADS * R;      // points a pass covers at once

// For each of the na points of a: its least squared distance to the nb
// points of b. Thread t owns points t + k * THREADS. Writes each minimum to
// out (when not null) and returns the sum of the thread's minima, in order.
template <bool FAST>
__device__ float min_pass(const float4* a, int na, const float4* b, int nb, float* __restrict__ out) {
  float sum = 0.f;
  for (int base = 0; base < na; base += CHUNK) {
    float4 p[R];
    float mn[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      p[r] = a[min(base + (int)threadIdx.x + r * THREADS, na - 1)];
      mn[r] = INFINITY;
    }
    for (int j = 0; j < nb; ++j) {
      const float4 q = b[j];
#pragma unroll
      for (int r = 0; r < R; ++r) mn[r] = fminf(mn[r], sqdist<FAST>(p[r], q));
    }
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int i = base + threadIdx.x + r * THREADS;
      if (i < na) {
        sum += mn[r];
        if (out) out[i] = mn[r];
      }
    }
  }
  return sum;
}

// pair p compares cloud pairs[2p] of xs [*, N, 3] with cloud pairs[2p+1] of
// ys [*, M, 3]; dl/dr (nullable) get the per-point minima at row p, cd
// (nullable) gets mean(dl) + mean(dr) at p
template <bool FAST>
__global__ void __launch_bounds__(THREADS) chamfer_kernel(const float* __restrict__ xs,
                                                          const float* __restrict__ ys,
                                                          const int* __restrict__ pairs, int N, int M,
                                                          float* __restrict__ cd, float* __restrict__ dl,
                                                          float* __restrict__ dr) {
  extern __shared__ float4 pts[];
  __shared__ float red[WARPS];
  float4* xp = pts;
  float4* yp = pts + N;
  const long long p = blockIdx.x;
  load_points<FAST>(xp, xs + (long long)pairs[2 * p] * N * 3, N);
  load_points<FAST>(yp, ys + (long long)pairs[2 * p + 1] * M * 3, M);
  __syncthreads();
  const float sl = min_pass<FAST>(xp, N, yp, M, dl ? dl + p * N : nullptr);
  const float sr = min_pass<FAST>(yp, M, xp, N, dr ? dr + p * M : nullptr);
  if (cd) {
    const float a = block_sum(sl, red);
    const float b = block_sum(sr, red);
    if (threadIdx.x == 0) cd[p] = a / (float)N + b / (float)M;
  }
}

template <bool FAST>
cudaError_t launch(const float* xs, const float* ys, const int* pairs, int P, int N, int M, float* cd,
                   float* dl, float* dr, cudaStream_t stream) {
  const int bytes = (N + M) * (int)sizeof(float4);
  cudaError_t e = cudaFuncSetAttribute(chamfer_kernel<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return e;
  chamfer_kernel<FAST><<<P, THREADS, bytes, stream>>>(xs, ys, pairs, N, M, cd, dl, dr);
  return cudaGetLastError();
}

// ---- the backward of nn_distances (nnd_bwd)
//
// With gl = dL/d dl and gr = dL/d dr, the nearest neighbours are the masks
// maskl_ij = d_ij <= dl_i and maskr_ij = d_ij <= dr_j, ties splitting the
// gradient evenly (as `_nnd_bwd_pallas` does, not one argmin):
//   wl_ij = gl_i maskl_ij / max(rowcnt_i, 1),  rowcnt_i = sum_j maskl_ij
//   wr_ij = gr_j maskr_ij / max(colcnt_j, 1),  colcnt_j = sum_i maskr_ij
//   gx_i = 2 gl_i x_i - 2 sum_j wl_ij y_j + 2 x_i sum_j wr_ij - 2 sum_j wr_ij y_j
//   gy_j = 2 y_j (gr_j + sum_i wl_ij) - 2 sum_i wl_ij x_i - 2 sum_i wr_ij x_i
//
// A mask is d == dmin in effect, so each distance must equal the forward's
// bit for bit: it comes from the same sqdist<false> (whose argument order
// does not matter). A distance that came out other than the forward's
// would leave a row with no neighbour, and max(count, 1) would hide it.
//
// What bounds it: per pair N x M elements in each of three passes, each a
// distance (6 FP32 instructions), the mask tests and up to 8 masked sums;
// the clouds and the per-point vectors are read once. Issue-bound on the
// CUDA cores, as the forward is.
//
// Design: one block per diagonal pair. Both clouds sit in shared memory as
// in the forward, with (dl_i, wl_i) per row and (dr_j, wr_j) per column
// ((N + M) x 24 B: 96 KB at N = M = 2048, 192 KB at 4096). Every output
// point is owned by one thread, which sums over the other cloud in a fixed
// order, so no atomics are needed and the result is bit-identical from run
// to run; that takes three passes, because the row weights wl need the row
// counts and gx needs the column weights wr:
//   (A) rows: rowcnt_i, then wl_i = gl_i / max(rowcnt_i, 1);
//   (B) columns: colcnt_j, sum_i maskr x_i, sum_i wl_ij and
//       sum_i wl_ij x_i, then wr_j and the whole of gy_j (the r-direction
//       term divided by the count at the end);
//   (C) rows: sum_j maskl y_j, sum_j wr_ij and sum_j wr_ij y_j: the whole
//       of gx_i.

constexpr int RB = 4;                   // points per thread in a backward pass
constexpr int CHUNK_B = THREADS * RB;

__global__ void __launch_bounds__(THREADS) nnd_bwd_kernel(const float* __restrict__ xs,
                                                          const float* __restrict__ ys, int N, int M,
                                                          const float* __restrict__ dl,
                                                          const float* __restrict__ dr,
                                                          const float* __restrict__ gl,
                                                          const float* __restrict__ gr,
                                                          float* __restrict__ gx,
                                                          float* __restrict__ gy) {
  extern __shared__ float4 pts[];
  float4* xp = pts;
  float4* yp = pts + N;
  float2* rowv = reinterpret_cast<float2*>(yp + M);   // (dl_i, wl_i)
  float2* colv = rowv + N;                            // (dr_j, wr_j)
  const long long p = blockIdx.x;
  xs += p * N * 3;
  ys += p * M * 3;
  dl += p * N;
  gl += p * N;
  dr += p * M;
  gr += p * M;
  gx += p * N * 3;
  gy += p * M * 3;
  load_points<false>(xp, xs, N);
  load_points<false>(yp, ys, M);
  for (int i = threadIdx.x; i < N; i += THREADS) rowv[i] = make_float2(dl[i], 0.f);
  for (int j = threadIdx.x; j < M; j += THREADS) colv[j] = make_float2(dr[j], 0.f);
  __syncthreads();

  // (A) rows: the row counts and the row weights
  for (int base = 0; base < N; base += CHUNK_B) {
    float4 a[RB];
    float dmin[RB], cnt[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = min(base + (int)threadIdx.x + r * THREADS, N - 1);
      a[r] = xp[i];
      dmin[r] = rowv[i].x;
      cnt[r] = 0.f;
    }
    for (int j = 0; j < M; ++j) {
      const float4 q = yp[j];
#pragma unroll
      for (int r = 0; r < RB; ++r) cnt[r] += sqdist<false>(a[r], q) <= dmin[r] ? 1.f : 0.f;
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = base + threadIdx.x + r * THREADS;
      if (i < N) rowv[i].y = __fdiv_rn(gl[i], fmaxf(cnt[r], 1.f));
    }
  }
  __syncthreads();

  // (B) columns: the column counts and weights, and the whole of gy
  for (int base = 0; base < M; base += CHUNK_B) {
    float4 b[RB];
    float dmin[RB], cnt[RB], swl[RB];
    float3 sx[RB], swx[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int j = min(base + (int)threadIdx.x + r * THREADS, M - 1);
      b[r] = yp[j];
      dmin[r] = colv[j].x;
      cnt[r] = swl[r] = 0.f;
      sx[r] = swx[r] = make_float3(0.f, 0.f, 0.f);
    }
    for (int i = 0; i < N; ++i) {
      const float4 a = xp[i];
      const float2 v = rowv[i];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float d = sqdist<false>(a, b[r]);
        const float mr = d <= dmin[r] ? 1.f : 0.f;
        const float wl = d <= v.x ? v.y : 0.f;
        cnt[r] += mr;
        sx[r].x = fmaf(mr, a.x, sx[r].x);
        sx[r].y = fmaf(mr, a.y, sx[r].y);
        sx[r].z = fmaf(mr, a.z, sx[r].z);
        swl[r] += wl;
        swx[r].x = fmaf(wl, a.x, swx[r].x);
        swx[r].y = fmaf(wl, a.y, swx[r].y);
        swx[r].z = fmaf(wl, a.z, swx[r].z);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int j = base + threadIdx.x + r * THREADS;
      if (j < M) {
        const float g = gr[j];
        const float wr = __fdiv_rn(g, fmaxf(cnt[r], 1.f));
        const float c = 2.f * (g + swl[r]);
        colv[j].y = wr;
        gy[3 * j] = c * b[r].x - 2.f * swx[r].x - 2.f * wr * sx[r].x;
        gy[3 * j + 1] = c * b[r].y - 2.f * swx[r].y - 2.f * wr * sx[r].y;
        gy[3 * j + 2] = c * b[r].z - 2.f * swx[r].z - 2.f * wr * sx[r].z;
      }
    }
  }
  __syncthreads();

  // (C) rows: the whole of gx
  for (int base = 0; base < N; base += CHUNK_B) {
    float4 a[RB];
    float dmin[RB], swr[RB];
    float3 sy[RB], swy[RB];
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = min(base + (int)threadIdx.x + r * THREADS, N - 1);
      a[r] = xp[i];
      dmin[r] = rowv[i].x;
      swr[r] = 0.f;
      sy[r] = swy[r] = make_float3(0.f, 0.f, 0.f);
    }
    for (int j = 0; j < M; ++j) {
      const float4 q = yp[j];
      const float2 c = colv[j];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const float d = sqdist<false>(a[r], q);
        const float ml = d <= dmin[r] ? 1.f : 0.f;
        const float wr = d <= c.x ? c.y : 0.f;
        sy[r].x = fmaf(ml, q.x, sy[r].x);
        sy[r].y = fmaf(ml, q.y, sy[r].y);
        sy[r].z = fmaf(ml, q.z, sy[r].z);
        swr[r] += wr;
        swy[r].x = fmaf(wr, q.x, swy[r].x);
        swy[r].y = fmaf(wr, q.y, swy[r].y);
        swy[r].z = fmaf(wr, q.z, swy[r].z);
      }
    }
#pragma unroll
    for (int r = 0; r < RB; ++r) {
      const int i = base + threadIdx.x + r * THREADS;
      if (i < N) {
        const float c = 2.f * (gl[i] + swr[r]);
        const float wl = 2.f * rowv[i].y;
        gx[3 * i] = c * a[r].x - wl * sy[r].x - 2.f * swy[r].x;
        gx[3 * i + 1] = c * a[r].y - wl * sy[r].y - 2.f * swy[r].y;
        gx[3 * i + 2] = c * a[r].z - wl * sy[r].z - 2.f * swy[r].z;
      }
    }
  }
}

int bwd_smem_bytes(int N, int M) { return (N + M) * (int)(sizeof(float4) + sizeof(float2)); }

}  // namespace

extern "C" {

// dynamic shared memory of one block (the wrapper checks it against the limit)
int dpfx_chamfer_smem_bytes(int N, int M) { return (N + M) * (int)sizeof(float4); }
int dpfx_nnd_bwd_smem_bytes(int N, int M) { return bwd_smem_bytes(N, M); }

// gx [P, N, 3], gy [P, M, 3] of diagonal pairs xs [P, N, 3], ys [P, M, 3]
// from the forward's dl [P, N], dr [P, M] and the cotangents gl, gr
int dpfx_nnd_bwd_launch(const float* xs, const float* ys, int P, int N, int M, const float* dl,
                        const float* dr, const float* gl, const float* gr, float* gx, float* gy,
                        void* stream) {
  if (P <= 0) return 0;
  const int bytes = bwd_smem_bytes(N, M);
  cudaError_t e = cudaFuncSetAttribute(nnd_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  nnd_bwd_kernel<<<P, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(xs, ys, N, M, dl, dr, gl, gr,
                                                                           gx, gy);
  return cudaGetLastError();
}

int dpfx_chamfer_launch(const float* xs, const float* ys, const int* pairs, int P, int N, int M, int fast,
                        float* cd, float* dl, float* dr, void* stream) {
  if (P <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<true>(xs, ys, pairs, P, N, M, cd, dl, dr, s)
              : launch<false>(xs, ys, pairs, P, N, M, cd, dl, dr, s);
}

}  // extern "C"
