// Chamfer distance on Hopper (sm_90a): per-point squared nearest-neighbour
// distances of diagonal pairs, and the pairwise CD matrix of two sets.
//
// Replaces the Pallas TPU kernels `_nnd_fwd_pallas` (dpfx/ops/chamfer.py:130)
// and `_cd_pallas_pairwise` (:255). One kernel serves both, over a list of
// (left, right) cloud pairs: diagonal pairs writing dl [P, N] and dr [P, M]
// (nnd_fwd), or the pairs of an S1 x S2 matrix, or its upper triangle,
// writing mean(dl) + mean(dr) per pair (cd_pairwise).
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

}  // namespace

extern "C" {

// dynamic shared memory of one block (the wrapper checks it against the limit)
int dpfx_chamfer_smem_bytes(int N, int M) { return (N + M) * (int)sizeof(float4); }

int dpfx_chamfer_launch(const float* xs, const float* ys, const int* pairs, int P, int N, int M, int fast,
                        float* cd, float* dl, float* dr, void* stream) {
  if (P <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return fast ? launch<true>(xs, ys, pairs, P, N, M, cd, dl, dr, s)
              : launch<false>(xs, ys, pairs, P, N, M, cd, dl, dr, s);
}

}  // extern "C"
