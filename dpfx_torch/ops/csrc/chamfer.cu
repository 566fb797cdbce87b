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
// one multiply-subtract) and two mins. The clouds are 24 KB each at N = 2048
// and are read once per pair, so the work is issue-bound on the CUDA cores,
// far from the memory's rate.
//
// Design: one pass per pair, every distance computed once.
//   * Both clouds sit in shared memory as float4 (x, y, z, |p|^2). The
//     pair's N x M matrix is cut into tiles of 256 rows x 256 columns, which
//     the block's warps take in turn. In a tile each lane holds 8 rows in
//     registers, and per chunk of 32 columns computes the 8 x 32 distances
//     of its rows, lane l reading column j0 + (jj ^ l) at step jj. Each
//     distance goes into the row's running minimum and the column's minimum
//     over the lane's rows; the 32 lanes' column minima then meet by an xor
//     butterfly (31 shuffles and 31 mins), after which lane l holds column
//     j0 + l's minimum over the warp's 256 rows. 8 x 32 + 62 minima and 32
//     shared loads for 256 distances: ~9.7 issued instructions per element
//     in exact mode, read from the SASS (sass_loops chamfer --loops fmnmx).
//   * The element is the unclamped, unrounded distance (|x|^2 + |y|^2) -
//     2 x.y, each operation rounded on its own as the plain torch expression
//     (x.y never contracted into an FMA; s - 2 ab is one FFMA, exact since
//     2 ab is). The clamp max(., 0) and fast mode's rounding to bf16 are
//     monotone non-decreasing, so they are applied once to each minimum
//     instead of to each element, with the same result bit for bit. In fast
//     mode the coordinates are bf16, so each product x_c y_c is exact in
//     f32 (16 significant bits) and FFMA(x_c, y_c, acc) rounds exactly as
//     acc + FMUL(x_c, y_c): x.y takes 3 instructions instead of 5, 7 an
//     element in all, with the same bits.
//   * A tile's row and column minima, clamped (and rounded), are
//     non-negative floats, whose bits order as unsigned integers: they meet
//     the other tiles' in shared memory by integer atomicMin, exact in any
//     order. No float atomics.
//   * Few pairs (below 2 x 132): a pair runs on a thread-block cluster of 2
//     or 4 CTAs (cluster_size), each taking a share of the tiles; rank 0
//     takes the minimum of the CTAs' arrays through distributed shared
//     memory. Minima are exact, so the result equals the one-CTA launch bit
//     for bit.
//   * Sums: each cloud's minima are summed by point index, thread t over
//     t, t + 256, ... in order, then across the block in a fixed order
//     (block_sum), the same for the left and the right cloud: CD = mean(dl)
//     + mean(dr) is bit-identical from run to run, and CD(X, Y) equals
//     CD(Y, X) bit for bit (the triangle mode's mirror).
//   * Exact mode is IEEE f32 on the CUDA cores, no tensor cores (TF32's
//     cancellation error in |x|^2 + |y|^2 - 2 x.y on near-identical points
//     corrupts near-zero distances). Fast mode rounds the coordinates to
//     bf16 for the product (exact in f32), keeps the norms f32, and rounds
//     each minimum to bf16, as the Pallas fast mode rounds each distance.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). The
// launch returns cudaGetLastError().

#include <cooperative_groups.h>

#include "dpfx_common.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace dpfx;

constexpr int RA = 8;                   // rows per lane in a tile
constexpr int ROWS = 32 * RA;           // rows of a tile (a warp's)
constexpr int COLS = 256;               // columns of a tile
constexpr int SMS = 132;                // the H100 SXM's SMs
constexpr uint32_t INF_BITS = 0x7f800000u;

// padded sizes and the shared-memory carve-up: xp [np] and yp [mp] float4
// (padding points (0, 0, 0, inf) are infinitely far from every point),
// then the row and column minima as u32 bits
struct Sizes {
  int np, mp, bytes;
  __host__ __device__ Sizes(int N, int M)
      : np((N + ROWS - 1) / ROWS * ROWS), mp((M + 31) / 32 * 32),
        bytes(16 * (np + mp) + 4 * (N + M)) {}
  __host__ __device__ int tiles() const { return np / ROWS * ((mp + COLS - 1) / COLS); }
};

// (|a|^2 + |b|^2) - 2 a.b, unclamped, each operation rounded on its own (the
// argument order does not matter: IEEE add and multiply commute); FAST (bf16
// coordinates, exact products) fuses the products into the sums, same bits
template <bool FAST>
__device__ __forceinline__ float raw_dist(const float4 a, const float4 b) {
  const float ab =
      FAST ? __fmaf_rn(a.z, b.z, __fmaf_rn(a.y, b.y, __fmul_rn(a.x, b.x)))
           : __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
  return __fmaf_rn(-2.f, ab, __fadd_rn(a.w, b.w));
}

// a minimum as the plain version's distance: clamped at 0 (FAST: then
// rounded to bf16), as the bits of a non-negative float
template <bool FAST>
__device__ __forceinline__ uint32_t min_bits(float v) {
  const float c = fmaxf(v, 0.f);
  return __float_as_uint(FAST ? rnd<__nv_bfloat16>(c) : c);
}

// one step of the column minima's xor butterfly: cm[k] for k < O takes the
// minimum with lane ^ O's cm[k ^ O] (the same column); a template, so that
// every index is a constant and cm stays in registers
template <int O>
__device__ __forceinline__ void fold(float (&cm)[32]) {
#pragma unroll
  for (int k = 0; k < O; ++k) cm[k] = fminf(cm[k], __shfl_xor_sync(0xffffffffu, cm[k ^ O], O));
}

// the minima of tile t: rows g * ROWS .., columns cc * COLS .., into rmin
// and cmin by atomicMin (the warp calls it)
template <bool FAST>
__device__ void tile_minima(const float4* xp, const float4* yp, const Sizes& z, int N, int M, int t,
                            uint32_t* rmin, uint32_t* cmin) {
  const int lane = lane_id(), gc = (z.mp + COLS - 1) / COLS;
  const int r0 = t / gc * ROWS, c0 = t % gc * COLS, c1 = min(c0 + COLS, z.mp);
  float4 a[RA];
  float rm[RA];
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    a[r] = xp[r0 + lane + 32 * r];
    rm[r] = INFINITY;
  }
  for (int j0 = c0; j0 < c1; j0 += 32) {
    const float4* yc = yp + j0;
    float cm[32];
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const float4 q = yc[jj ^ lane];
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        const float d = raw_dist<FAST>(a[r], q);
        rm[r] = fminf(rm[r], d);
        cm[jj] = r ? fminf(cm[jj], d) : d;
      }
    }
    // cm[k] holds column j0 + (k ^ lane); after the butterfly cm[0] holds
    // column j0 + lane's minimum over the warp's rows
    fold<16>(cm);
    fold<8>(cm);
    fold<4>(cm);
    fold<2>(cm);
    fold<1>(cm);
    if (j0 + lane < M) atomicMin(cmin + j0 + lane, min_bits<FAST>(cm[0]));
  }
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int i = r0 + lane + 32 * r;
    if (i < N) atomicMin(rmin + i, min_bits<FAST>(rm[r]));
  }
}

// v's minimum over the cluster's CTAs at i of arr (u32 bits)
__device__ __forceinline__ uint32_t cluster_min(uint32_t* arr, int i, int C) {
  uint32_t v = arr[i];
  for (int r = 1; r < C; ++r) v = min(v, cg::this_cluster().map_shared_rank(arr, r)[i]);
  return v;
}

// pair p compares cloud pairs[2p] of xs [*, N, 3] with cloud pairs[2p+1] of
// ys [*, M, 3] on a cluster of C CTAs (blocks C p .. C p + C - 1); dl/dr
// (nullable) get the per-point minima at row p, cd (nullable) gets
// mean(dl) + mean(dr) at p
template <bool FAST>
__global__ void __launch_bounds__(THREADS, 2) chamfer_kernel(const float* __restrict__ xs,
                                                             const float* __restrict__ ys,
                                                             const int* __restrict__ pairs, int N, int M,
                                                             int C, float* __restrict__ cd,
                                                             float* __restrict__ dl,
                                                             float* __restrict__ dr) {
  extern __shared__ float4 pts[];
  __shared__ float red[WARPS];
  const Sizes z(N, M);
  float4* xp = pts;
  float4* yp = pts + z.np;
  uint32_t* rmin = reinterpret_cast<uint32_t*>(yp + z.mp);
  uint32_t* cmin = rmin + N;
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const long long p = blockIdx.x / C;
  load_points<FAST>(xp, xs + (long long)pairs[2 * p] * N * 3, N);
  load_points<FAST>(yp, ys + (long long)pairs[2 * p + 1] * M * 3, M);
  for (int i = N + threadIdx.x; i < z.np; i += THREADS) xp[i] = make_float4(0.f, 0.f, 0.f, INFINITY);
  for (int j = M + threadIdx.x; j < z.mp; j += THREADS) yp[j] = make_float4(0.f, 0.f, 0.f, INFINITY);
  for (int i = threadIdx.x; i < N + M; i += THREADS) rmin[i] = INF_BITS;
  __syncthreads();

  const int T = z.tiles(), t1 = (rank + 1) * T / C;
  for (int t = rank * T / C + (int)threadIdx.x / 32; t < t1; t += WARPS)
    tile_minima<FAST>(xp, yp, z, N, M, t, rmin, cmin);
  if (C > 1) cg::this_cluster().sync();
  else __syncthreads();

  if (rank == 0) {
    float sl = 0.f, sr = 0.f;
    for (int i = threadIdx.x; i < N; i += THREADS) {
      const float v = __uint_as_float(cluster_min(rmin, i, C));
      if (dl) dl[p * N + i] = v;
      sl += v;
    }
    for (int j = threadIdx.x; j < M; j += THREADS) {
      const float v = __uint_as_float(cluster_min(cmin, j, C));
      if (dr) dr[p * M + j] = v;
      sr += v;
    }
    if (cd) {
      const float a = block_sum(sl, red);
      const float b = block_sum(sr, red);
      if (threadIdx.x == 0) cd[p] = a / (float)N + b / (float)M;
    }
  }
  if (C > 1) cg::this_cluster().sync();   // the other CTAs' minima stay until rank 0 has read them
}

// CTAs per pair: a cluster of 4 while 4 P CTAs fit on the SMs, of 2 below
// 2 x SMS pairs, else 1; never more than the pair's tiles
int cluster_size(int P, int N, int M) {
  if (P >= 2 * SMS) return 1;
  int C = 4 * P <= SMS ? 4 : 2;
  const int T = Sizes(N, M).tiles();
  while (C > 1 && T < C) C /= 2;
  return C;
}

template <bool FAST>
cudaError_t launch(const float* xs, const float* ys, const int* pairs, int P, int N, int M, float* cd,
                   float* dl, float* dr, cudaStream_t stream) {
  const int bytes = Sizes(N, M).bytes;
  cudaError_t e = cudaFuncSetAttribute(chamfer_kernel<FAST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return e;
  const int C = cluster_size(P, N, M);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(P * C));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = C > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, chamfer_kernel<FAST>, xs, ys, pairs, N, M, C, cd, dl, dr);
  if (e != cudaSuccess) return e;
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
// bit for bit: sqdist (whose argument order does not matter) is the
// clamped form of the forward's raw_dist (s - round(2 ab) and FFMA(-2, ab,
// s) round alike, 2 ab being exact), and the forward clamps each minimum,
// which is the minimum of the clamped distances. A distance that came out
// other than the forward's would leave a row with no neighbour, and
// max(count, 1) would hide it.
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
      for (int r = 0; r < RB; ++r) cnt[r] += sqdist(a[r], q) <= dmin[r] ? 1.f : 0.f;
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
        const float d = sqdist(a, b[r]);
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
        const float d = sqdist(a[r], q);
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
int dpfx_chamfer_smem_bytes(int N, int M) { return Sizes(N, M).bytes; }

// CTAs a launch of P pairs of N x M points gives each pair
int dpfx_chamfer_cluster_size(int P, int N, int M) { return cluster_size(P, N, M); }
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
