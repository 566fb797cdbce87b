// Chamfer distance on Hopper (sm_90a): per-point squared nearest-neighbour
// distances of diagonal pairs and their backward, and the pairwise CD matrix
// of two sets.
//
// Replaces the Pallas TPU kernels `_nnd_fwd_pallas` (dpfx/ops/chamfer.py:130)
// and `_cd_pallas_pairwise` (:255) with `chamfer_kernel`, and
// `_nnd_bwd_pallas` (:174) with `nnd_bwd_kernel` (below: one distance
// sweep per pair). `chamfer_kernel` serves both forwards, over a list of
// (left, right) cloud pairs: diagonal pairs writing dl [P, N] and dr [P, M]
// (nnd_fwd), or the pairs of an S1 x S2 matrix, or its upper triangle,
// writing mean(dl) + mean(dr) per pair (cd_pairwise).
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
                                                             float* __restrict__ cd,
                                                             float* __restrict__ dl,
                                                             float* __restrict__ dr, int C) {
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

// kernel over P pairs, each on a cluster of C = cluster_size(P, N, M) CTAs
// with bytes of dynamic shared memory; C follows the kernel's arguments
template <typename... K, typename... A>
cudaError_t launch_clusters(void (*kernel)(K...), int P, int N, int M, int bytes, cudaStream_t stream,
                            A... args) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
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
  e = cudaLaunchKernelEx(&cfg, kernel, args..., C);
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
// What bounds it: per pair N x M elements, each a distance (7 FP32
// instructions unfused) and the two mask tests; then per nearest neighbour
// a few sums. The clouds and the per-point vectors are read once.
// Issue-bound on the CUDA cores, as the forward is.
//
// Design (nnd_bwd_kernel): one distance sweep per pair, then sums over the
// nearest-neighbour lists.
//   * The sweep takes the forward's tiles (256 rows x 256 columns, 8 rows
//     a lane, chunks of 32 columns read at j0 + (jj ^ lane)) and computes
//     each distance once, unclamped (raw_dist). The mask tests may take the
//     unclamped value: the forward's minima are clamped, so dmin >= 0, and
//     max(raw, 0) <= dmin holds exactly when raw <= dmin. A dmin below 0
//     (or NaN), which no clamped distance reaches, is tested as -inf
//     (sweep_bound), so the equivalence holds for any input.
//   * Counts are packed: a hit at index k adds HIT + k to a u32 (HIT above
//     every index), so one integer add carries both the count and the
//     index, and the word is HIT + k exactly when there is one hit, at k
//     (two or more make it >= 2 HIT; none leaves 0). A row's word stays in
//     a register over a tile and meets the other tiles' by one atomicAdd
//     in shared memory; a column's words over a lane's 8 rows meet the
//     other lanes' by an integer xor butterfly per chunk of 32 columns (as
//     the forward's minima), then one atomicAdd. Integer sums are exact in
//     any order: no float atomics. Each test and add is one FSETP and one
//     predicated IADD (add_if_le): 12.3 issued instructions an element,
//     read from the SASS (sass_loops chamfer --loops all, the kernel's
//     largest loop).
//   * Few pairs (below 2 x 132): a pair runs on a cluster of 2 or 4 CTAs
//     (cluster_size, as the forward), each taking a share of the tiles;
//     rank 0 adds the CTAs' words through distributed shared memory, exact,
//     so a cluster's result equals one CTA's bit for bit, and goes on
//     alone.
//   * PATH_LISTS, a pair whose every count is 1 (one nearest neighbour
//     each way), needs no second sweep: the own-direction sums are gathers
//     (sum_j maskl_ij y_j = y_j*(i), sum_i maskr_ij x_i = x_i*(j)), and the
//     cross sums run over inverse lists (the columns whose neighbour is row
//     i, the rows whose neighbour is column j), laid out in shared memory as
//     CSR: integer counts, their prefix sums (block_scan), the members
//     placed by atomicAdd in any order. Each list is sorted by index: by its
//     owner's thread in registers up to SHORT members (sort_short; every
//     thread does the same work, whatever its list's length), across a
//     warp's lanes up to 32 (bitonic; the warps take these lists in turn
//     from a list of them, longk, LONG_LISTS long: a list of more than SHORT
//     members holds points no other list holds), and summed in ascending
//     order: the order in which the three passes below add their nonzero
//     terms, the rest being zeros (fmaf(0, a, s) = s). So gx and gy equal
//     the three passes' bit for bit. A longer list sends its owner to the fix-up
//     below, which is exact for any point. Shape clouds have dense regions,
//     where a point is the neighbour of up to 16 others, and a tight cloud
//     against a spread one makes hubs.
//   * PATH_FIX, a pair with 1 to FIX_MAX points whose count is not 1 (a
//     tie: a few pairs in 64 of random clouds of 2048 points have one):
//     each such point counts its hits again in a scan of the other cloud
//     that the block's warps share, and marks the points it hits
//     (count_mark); the lists leave it out. Every marked point, and every
//     point whose count is not 1, is summed by one warp over the whole
//     other cloud with the three passes' arithmetic and order (fix_row,
//     fix_col: 4 x 32 distances at a time, the hits' terms added in index
//     order; the warps take these points in turn from a list of them, which
//     the members' room holds once the lists are summed), the others over
//     their lists. The result again equals the three passes' bit for bit,
//     and a tie costs a few scans of one cloud, not three sweeps of the
//     pair: one pair on three passes would set the launch's time.
//   * PATH_THREE, a pair with more such points (duplicated clouds), takes
//     the three passes on rank 0 (three_pass). The path is uniform over
//     the block and is written to paths[p].
//   * Shared memory: the clouds as float4 (16 (np + mp) B), the words
//     (4 (N + M)), the lists' u16 members (2 (N + M), in 4 (N + M)), the
//     bounds (4 (N + mp)), which the lists' u32 ends overlay until the
//     fix-up; the three passes' (dmin, weight) pairs overlay words and
//     members. 112 KB at N = M = 2048, 224 KB at 4096, and 2.2 KB static
//     (longk, the few tied points). After the sweep each point's w holds
//     its cotangent (gl_i, gr_j); the fix-up's scans round the norms again.
//
// three_pass (also nnd_bwd3_kernel, one block per pair, the reference the
// tests hold the kernel to): every output point is owned by one thread,
// which sums over the other cloud in a fixed order, in three passes,
// because the row weights wl need the row counts and gx needs the column
// weights wr:
//   (A) rows: rowcnt_i, then wl_i = gl_i / max(rowcnt_i, 1);
//   (B) columns: colcnt_j, sum_i maskr x_i, sum_i wl_ij and
//       sum_i wl_ij x_i, then wr_j and the whole of gy_j (the r-direction
//       term divided by the count at the end);
//   (C) rows: sum_j maskl y_j, sum_j wr_ij and sum_j wr_ij y_j: the whole
//       of gx_i.
// Every path finishes a point with gx_coord / gy_coord, each operation
// rounded on its own (no FMA contraction), so the plain version
// (onepass_bwd_plain) repeats them.

constexpr int RB = 4;                   // points per thread in a pass of three_pass
constexpr int CHUNK_B = THREADS * RB;
constexpr int MAX_POINTS = 4096;        // per cloud (chamfer.MAX_POINTS)
constexpr uint32_t HIT = 8192;          // a hit's weight in a packed count (> MAX_POINTS)
constexpr uint32_t AFF = 1u << 31;      // a word's mark: the fix-up takes this point's sums
constexpr uint16_t NONE = 0xffff;       // the end of an inverse list
constexpr int FIX_MAX = 64;             // points whose count is not 1 that the fix-up takes
constexpr int SHORT = 8;                // a list its owner's thread sorts in registers
// lists of more than SHORT members: their members are distinct points, so
// there are at most 2 MAX_POINTS / (SHORT + 1)
constexpr int LONG_LISTS = 2 * MAX_POINTS / (SHORT + 1);
enum { PATH_LISTS = 0, PATH_FIX = 1, PATH_THREE = 2 };   // a pair's path (paths [p])

// gx_i's coordinate from its sums: (c x - wl2 sy) - 2 swy, c = 2 (gl_i + swr)
__device__ __forceinline__ float gx_coord(float c, float x, float wl2, float sy, float swy) {
  return __fsub_rn(__fsub_rn(__fmul_rn(c, x), __fmul_rn(wl2, sy)), __fmul_rn(2.f, swy));
}

// gy_j's coordinate from its sums: (c y - 2 swx) - wr2 sx, c = 2 (gr_j + swl)
__device__ __forceinline__ float gy_coord(float c, float y, float swx, float wr2, float sx) {
  return __fsub_rn(__fsub_rn(__fmul_rn(c, y), __fmul_rn(2.f, swx)), __fmul_rn(wr2, sx));
}

// x_i, y_j as float4 with norms in xp [N], yp [M]; rowv [N], colv [M] are
// scratch; gx, gy, dl, ... at the pair. The whole block calls it.
__device__ void three_pass(const float4* xp, const float4* yp, float2* rowv, float2* colv, int N, int M,
                           const float* dl, const float* dr, const float* gl, const float* gr, float* gx,
                           float* gy) {
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
        const float c = __fmul_rn(2.f, __fadd_rn(g, swl[r])), wr2 = __fmul_rn(2.f, wr);
        colv[j].y = wr;
        gy[3 * j] = gy_coord(c, b[r].x, swx[r].x, wr2, sx[r].x);
        gy[3 * j + 1] = gy_coord(c, b[r].y, swx[r].y, wr2, sx[r].y);
        gy[3 * j + 2] = gy_coord(c, b[r].z, swx[r].z, wr2, sx[r].z);
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
        const float c = __fmul_rn(2.f, __fadd_rn(gl[i], swr[r]));
        const float wl2 = __fmul_rn(2.f, rowv[i].y);
        gx[3 * i] = gx_coord(c, a[r].x, wl2, sy[r].x, swy[r].x);
        gx[3 * i + 1] = gx_coord(c, a[r].y, wl2, sy[r].y, swy[r].y);
        gx[3 * i + 2] = gx_coord(c, a[r].z, wl2, sy[r].z, swy[r].z);
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS) nnd_bwd3_kernel(const float* __restrict__ xs,
                                                           const float* __restrict__ ys, int N, int M,
                                                           const float* __restrict__ dl,
                                                           const float* __restrict__ dr,
                                                           const float* __restrict__ gl,
                                                           const float* __restrict__ gr,
                                                           float* __restrict__ gx, float* __restrict__ gy) {
  extern __shared__ float4 pts[];
  float4* xp = pts;
  float4* yp = pts + N;
  float2* rowv = reinterpret_cast<float2*>(yp + M);
  const long long p = blockIdx.x;
  load_points<false>(xp, xs + p * N * 3, N);
  load_points<false>(yp, ys + p * M * 3, M);
  three_pass(xp, yp, rowv, rowv + N, N, M, dl + p * N, dr + p * M, gl + p * N, gr + p * M, gx + p * N * 3,
             gy + p * M * 3);
}

int bwd3_smem_bytes(int N, int M) { return (N + M) * (int)(sizeof(float4) + sizeof(float2)); }

// the sweep's bound on a distance: dmin where dmin >= 0, else -inf (see above)
__device__ __forceinline__ float sweep_bound(float v) { return v >= 0.f ? v : -INFINITY; }

// the one hit's index of a word from the sweep, or -1 when its count is not 1
__device__ __forceinline__ int one_hit(uint32_t w) { return w - HIT < HIT ? (int)(w - HIT) : -1; }

// A settled word (after the fix-up's counts, which replace the words of the
// points whose count is not 1 by the count) holds HIT + k or the count,
// and the fix-up's mark AFF.
__device__ __forceinline__ int single(uint32_t w) { return one_hit(w & ~AFF); }
__device__ __forceinline__ float hits(uint32_t w) { return single(w) >= 0 ? 1.f : (float)(w & ~AFF); }
__device__ __forceinline__ bool fixed(uint32_t w) { return (w & AFF) || single(w) < 0; }

// a point as the sweep saw it: coordinates, and the norm load_points rounds
__device__ __forceinline__ float4 with_norm(float4 a) {
  a.w = __fadd_rn(__fadd_rn(__fmul_rn(a.x, a.x), __fmul_rn(a.y, a.y)), __fmul_rn(a.z, a.z));
  return a;
}

// acc += v where a <= b: a predicated add (written in PTX: left to itself
// the compiler selects and adds, 1.4 more instructions an element)
__device__ __forceinline__ void add_if_le(uint32_t& acc, float a, float b, uint32_t v) {
  asm("{\n .reg .pred p;\n setp.le.f32 p, %1, %2;\n @p add.u32 %0, %0, %3;\n}"
      : "+r"(acc)
      : "f"(a), "f"(b), "r"(v));
}

// one step of an integer xor butterfly, as fold<O> for the minima: cm[k]
// for k < O adds lane ^ O's cm[k ^ O] (the same column)
template <int O>
__device__ __forceinline__ void fold_add(uint32_t (&cm)[32]) {
#pragma unroll
  for (int k = 0; k < O; ++k) cm[k] += __shfl_xor_sync(0xffffffffu, cm[k ^ O], O);
}

// the hits of tile t (the warp calls it): per row, raw <= dmin over the
// tile's columns packed in a register, then added to rw; per column, the
// lanes' words meet by an xor butterfly per chunk of 32 columns (as the
// forward's minima) and are added to cw (rb, cb: the rows' and columns'
// bounds)
__device__ void tile_hits(const float4* xp, const float4* yp, const float* rb, const float* cb, const Sizes& z,
                          int N, int t, uint32_t* rw, uint32_t* cw) {
  const int lane = lane_id(), gc = (z.mp + COLS - 1) / COLS;
  const int r0 = t / gc * ROWS, c0 = t % gc * COLS, c1 = min(c0 + COLS, z.mp);
  float4 a[RA];
  float dm[RA];
  uint32_t w[RA], hi[RA];   // hi: what row i's hit adds to a column's word
#pragma unroll
  for (int r = 0; r < RA; ++r) {
    const int i = r0 + lane + 32 * r;
    a[r] = xp[i];
    dm[r] = i < N ? rb[i] : -INFINITY;
    w[r] = 0u;
    hi[r] = HIT + i;
  }
  for (int j0 = c0; j0 < c1; j0 += 32) {
    uint32_t cm[32];
#pragma unroll
    for (int jj = 0; jj < 32; ++jj) {
      const int j = j0 + (jj ^ lane);
      const float4 q = yp[j];
      const float dc = cb[j];
      cm[jj] = 0u;
#pragma unroll
      for (int r = 0; r < RA; ++r) {
        const float d = raw_dist<false>(a[r], q);
        add_if_le(w[r], d, dm[r], HIT + j);
        add_if_le(cm[jj], d, dc, hi[r]);
      }
    }
    // cm[k] holds column j0 + (k ^ lane); after the butterfly cm[0] holds
    // column j0 + lane's word over the warp's rows
    fold_add<16>(cm);
    fold_add<8>(cm);
    fold_add<4>(cm);
    fold_add<2>(cm);
    fold_add<1>(cm);
    if (cm[0]) atomicAdd(cw + j0 + lane, cm[0]);   // columns past M never hit
  }
#pragma unroll
  for (int r = 0; r < RA; ++r)
    if (w[r]) atomicAdd(rw + hi[r] - HIT, w[r]);   // rows past N never hit
}


// e ascending (an odd-even transposition network: every index a constant)
__device__ __forceinline__ void sort_short(uint32_t (&e)[SHORT]) {
#pragma unroll
  for (int r = 0; r < SHORT; ++r)
#pragma unroll
    for (int t = r & 1; t + 1 < SHORT; t += 2) {
      const uint32_t lo = min(e[t], e[t + 1]), hi = max(e[t], e[t + 1]);
      e[t] = lo;
      e[t + 1] = hi;
    }
}

// one term of an owner's cross sums: member m of the other cloud o, whose w
// holds its cotangent (its count is 1: the weight is the cotangent / 1)
__device__ __forceinline__ void fold(const float4* o, int m, float& sw, float3& sv) {
  const float4 c = o[m];
  sw = __fadd_rn(sw, c.w);
  sv.x = __fmaf_rn(c.w, c.x, sv.x);
  sv.y = __fmaf_rn(c.w, c.y, sv.y);
  sv.z = __fmaf_rn(c.w, c.z, sv.z);
}

// the gradient of owner o (rows 0 .. N-1, then columns) whose count is 1,
// from its cross sums: its own-direction sum is its hit's point
__device__ __forceinline__ void finish(int o, int N, const float4* xp, const float4* yp, const uint32_t* rw,
                                       float sw, float3 sv, float* gx, float* gy) {
  if (o < N) {
    const float4 a = xp[o], q = yp[single(rw[o])];
    const float c = __fmul_rn(2.f, __fadd_rn(a.w, sw)), wl2 = __fmul_rn(2.f, a.w);
    gx[3 * o] = gx_coord(c, a.x, wl2, __fadd_rn(0.f, q.x), sv.x);
    gx[3 * o + 1] = gx_coord(c, a.y, wl2, __fadd_rn(0.f, q.y), sv.y);
    gx[3 * o + 2] = gx_coord(c, a.z, wl2, __fadd_rn(0.f, q.z), sv.z);
  } else {
    const int j = o - N;
    const float4 b = yp[j], q = xp[single(rw[o])];
    const float c = __fmul_rn(2.f, __fadd_rn(b.w, sw)), wr2 = __fmul_rn(2.f, b.w);
    gy[3 * j] = gy_coord(c, b.x, sv.x, wr2, __fadd_rn(0.f, q.x));
    gy[3 * j + 1] = gy_coord(c, b.y, sv.y, wr2, __fadd_rn(0.f, q.y));
    gy[3 * j + 2] = gy_coord(c, b.z, sv.z, wr2, __fadd_rn(0.f, q.z));
  }
}

// v[0 .. n) exclusive prefix sums in place, n <= 2 MAX_POINTS (the whole
// block; red: WARPS words of shared memory)
__device__ void block_scan(uint32_t* v, int n, uint32_t* red) {
  const int len = (n + THREADS - 1) / THREADS, a0 = min((int)threadIdx.x * len, n), a1 = min(a0 + len, n);
  uint32_t s = 0;
  for (int a = a0; a < a1; ++a) s += v[a];
  uint32_t incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane_id() >= o) incl += u;
  }
  if (lane_id() == 31) red[threadIdx.x / 32] = incl;
  __syncthreads();
  uint32_t base = incl - s;
  for (int w = 0; w < (int)threadIdx.x / 32; ++w) base += red[w];
  for (int a = a0; a < a1; ++a) {
    const uint32_t c = v[a];
    v[a] = base;
    base += c;
  }
}

// the fix-up's first step, for one point whose count is not 1 (every warp
// takes every WARPS-th chunk of 32): point p (with its norm) against the n
// points o of the other cloud; the hits raw <= bound each marked in ow, and
// counted into *cnt
__device__ void count_mark(float4 p, float bound, const float4* o, int n, uint32_t* ow, uint32_t* cnt) {
  for (int base = (int)threadIdx.x / 32 * 32; base < n; base += THREADS) {
    const int k = base + lane_id();
    const bool hit = k < n && raw_dist<false>(p, with_norm(o[k])) <= bound;
    if (hit) atomicOr(ow + k, AFF);
    const unsigned b = __ballot_sync(0xffffffffu, hit);
    if (b && lane_id() == 0) atomicAdd(cnt, (uint32_t)__popc(b));
  }
}

// gx_i by pass (C)'s arithmetic (one warp): the columns j in order, the
// lanes' distances to 4 x 32 at a time, the terms of the hits added in
// column order (the others are the passes' zeros). xp, yp hold the
// cotangents in w; rb, cb the bounds.
__device__ void fix_row(int i, const float4* xp, const float4* yp, int M, const float* rb, const float* cb,
                        const uint32_t* rw, const uint32_t* cw, float* gx) {
  const unsigned all = 0xffffffffu;
  const float4 a = xp[i], an = with_norm(a);
  const float bound = rb[i];
  float swr = 0.f;
  float3 sy = make_float3(0.f, 0.f, 0.f), swy = sy;
  for (int base = 0; base < M; base += 4 * 32) {
    float4 q[4];
    float ml[4], wr[4];
    unsigned bal[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = base + 32 * u + lane_id();
      q[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      ml[u] = wr[u] = 0.f;
      bool mr = false;
      if (j < M) {
        q[u] = yp[j];
        const float d = raw_dist<false>(an, with_norm(q[u]));
        ml[u] = d <= bound ? 1.f : 0.f;
        mr = d <= cb[j];
        if (mr) wr[u] = __fdiv_rn(q[u].w, fmaxf(hits(cw[j]), 1.f));
      }
      bal[u] = __ballot_sync(all, ml[u] != 0.f || mr);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      for (unsigned b = bal[u]; b; b &= b - 1) {
        const int l = __ffs(b) - 1;
        const float m = __shfl_sync(all, ml[u], l), w = __shfl_sync(all, wr[u], l);
        const float qx = __shfl_sync(all, q[u].x, l), qy = __shfl_sync(all, q[u].y, l),
                    qz = __shfl_sync(all, q[u].z, l);
        sy.x = fmaf(m, qx, sy.x);
        sy.y = fmaf(m, qy, sy.y);
        sy.z = fmaf(m, qz, sy.z);
        swr += w;
        swy.x = fmaf(w, qx, swy.x);
        swy.y = fmaf(w, qy, swy.y);
        swy.z = fmaf(w, qz, swy.z);
      }
  }
  if (lane_id() == 0) {
    const float c = __fmul_rn(2.f, __fadd_rn(a.w, swr));
    const float wl2 = __fmul_rn(2.f, __fdiv_rn(a.w, fmaxf(hits(rw[i]), 1.f)));
    gx[3 * i] = gx_coord(c, a.x, wl2, sy.x, swy.x);
    gx[3 * i + 1] = gx_coord(c, a.y, wl2, sy.y, swy.y);
    gx[3 * i + 2] = gx_coord(c, a.z, wl2, sy.z, swy.z);
  }
}

// gy_j by pass (B)'s arithmetic (one warp), as fix_row
__device__ void fix_col(int j, const float4* xp, const float4* yp, int N, const float* rb, const float* cb,
                        const uint32_t* rw, float* gy) {
  const unsigned all = 0xffffffffu;
  const float4 b = yp[j], bn = with_norm(b);
  const float bound = cb[j];
  float cnt = 0.f, swl = 0.f;
  float3 sx = make_float3(0.f, 0.f, 0.f), swx = sx;
  for (int base = 0; base < N; base += 4 * 32) {
    float4 a[4];
    float mr[4], wl[4];
    unsigned bal[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = base + 32 * u + lane_id();
      a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      mr[u] = wl[u] = 0.f;
      bool ml = false;
      if (i < N) {
        a[u] = xp[i];
        const float d = raw_dist<false>(with_norm(a[u]), bn);
        mr[u] = d <= bound ? 1.f : 0.f;
        ml = d <= rb[i];
        if (ml) wl[u] = __fdiv_rn(a[u].w, fmaxf(hits(rw[i]), 1.f));
      }
      bal[u] = __ballot_sync(all, mr[u] != 0.f || ml);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      for (unsigned bits = bal[u]; bits; bits &= bits - 1) {
        const int l = __ffs(bits) - 1;
        const float m = __shfl_sync(all, mr[u], l), w = __shfl_sync(all, wl[u], l);
        const float ax = __shfl_sync(all, a[u].x, l), ay = __shfl_sync(all, a[u].y, l),
                    az = __shfl_sync(all, a[u].z, l);
        cnt += m;
        sx.x = fmaf(m, ax, sx.x);
        sx.y = fmaf(m, ay, sx.y);
        sx.z = fmaf(m, az, sx.z);
        swl += w;
        swx.x = fmaf(w, ax, swx.x);
        swx.y = fmaf(w, ay, swx.y);
        swx.z = fmaf(w, az, swx.z);
      }
  }
  if (lane_id() == 0) {
    const float wr = __fdiv_rn(b.w, fmaxf(cnt, 1.f));
    const float c = __fmul_rn(2.f, __fadd_rn(b.w, swl)), wr2 = __fmul_rn(2.f, wr);
    gy[3 * j] = gy_coord(c, b.x, swx.x, wr2, sx.x);
    gy[3 * j + 1] = gy_coord(c, b.y, swx.y, wr2, sx.y);
    gy[3 * j + 2] = gy_coord(c, b.z, swx.z, wr2, sx.z);
  }
}

// the one-pass layout's bytes (see the design above)
__host__ __device__ int bwd_smem_bytes(int N, int M) {
  const Sizes z(N, M);
  return 16 * (z.np + z.mp) + 8 * (N + M) + 4 * (N + z.mp);
}

// pair p (xs [P, N, 3], ys [P, M, 3], diagonal) on a cluster of C CTAs;
// paths [p] gets the pair's path (PATH_*)
__global__ void __launch_bounds__(THREADS, 1) nnd_bwd_kernel(const float* __restrict__ xs,
                                                             const float* __restrict__ ys, int N, int M,
                                                             const float* __restrict__ dl,
                                                             const float* __restrict__ dr,
                                                             const float* __restrict__ gl,
                                                             const float* __restrict__ gr,
                                                             float* __restrict__ gx,
                                                             float* __restrict__ gy,
                                                             uint8_t* __restrict__ paths, int C) {
  extern __shared__ float4 pts[];
  __shared__ int odd, nfix, nlong;
  __shared__ uint32_t oddn[FIX_MAX], red[WARPS];
  __shared__ uint16_t oddk[FIX_MAX], longk[LONG_LISTS];
  const Sizes z(N, M);
  float4* xp = pts;
  float4* yp = pts + z.np;
  uint32_t* rw = reinterpret_cast<uint32_t*>(yp + z.mp);   // rows' packed counts
  uint32_t* cw = rw + N;                                   // columns' (rw [N + j])
  uint16_t* mem = reinterpret_cast<uint16_t*>(cw + M);     // the lists' members [N + M]
  float* rb = reinterpret_cast<float*>(mem + 2 * (N + M));  // the rows' bounds
  float* cb = rb + N;                                      // the columns' [mp]
  uint32_t* off = reinterpret_cast<uint32_t*>(rb);         // then the lists' ends [N + M]
  float2* rowv = reinterpret_cast<float2*>(rw);            // the three passes
  const int rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  const int lane = lane_id(), warp = (int)threadIdx.x / 32;
  const long long p = blockIdx.x / C;
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
  for (int i = N + threadIdx.x; i < z.np; i += THREADS) xp[i] = make_float4(0.f, 0.f, 0.f, INFINITY);
  for (int j = M + threadIdx.x; j < z.mp; j += THREADS) yp[j] = make_float4(0.f, 0.f, 0.f, INFINITY);
  for (int i = threadIdx.x; i < N + M; i += THREADS) rw[i] = 0u;
  for (int i = threadIdx.x; i < N; i += THREADS) rb[i] = sweep_bound(dl[i]);
  for (int j = threadIdx.x; j < z.mp; j += THREADS) cb[j] = j < M ? sweep_bound(dr[j]) : -INFINITY;
  if (threadIdx.x == 0) odd = nfix = nlong = 0;
  __syncthreads();

  const int T = z.tiles(), t1 = (rank + 1) * T / C;
  for (int t = rank * T / C + warp; t < t1; t += WARPS) tile_hits(xp, yp, rb, cb, z, N, t, rw, cw);
  if (C > 1) {
    cg::this_cluster().sync();
    if (rank == 0)
      for (int i = threadIdx.x; i < N + M; i += THREADS) {
        uint32_t v = rw[i];
        for (int r = 1; r < C; ++r) v += cg::this_cluster().map_shared_rank(rw, r)[i];
        rw[i] = v;
      }
    cg::this_cluster().sync();   // the other CTAs' words stay until rank 0 has read them
    if (rank != 0) return;
  } else {
    __syncthreads();
  }

  // the pair's path, from its points whose count is not 1 (listed, in no
  // order, while they are few)
  for (int k = threadIdx.x; k < N + M; k += THREADS)
    if (one_hit(rw[k]) < 0) {
      const int e = atomicAdd(&odd, 1);
      if (e < FIX_MAX) {
        oddk[e] = (uint16_t)k;
        oddn[e] = 0u;
      }
    }
  __syncthreads();
  const int path = odd == 0 ? PATH_LISTS : odd <= FIX_MAX ? PATH_FIX : PATH_THREE;
  if (threadIdx.x == 0) paths[p] = (uint8_t)path;
  if (path == PATH_THREE) {
    three_pass(xp, yp, rowv, rowv + N, N, M, dl, dr, gl, gr, gx, gy);
    return;
  }

  for (int i = threadIdx.x; i < N; i += THREADS) xp[i].w = gl[i];
  for (int j = threadIdx.x; j < M; j += THREADS) yp[j].w = gr[j];
  __syncthreads();
  // the fix-up's counts: each point whose count is not 1 counts its hits
  // again (its word takes the count) and marks the points it hits, whose
  // sums then include it
  if (path == PATH_FIX) {
    for (int e = 0; e < odd; ++e) {
      const int k = oddk[e];
      if (k < N) count_mark(with_norm(xp[k]), rb[k], yp, M, cw, oddn + e);
      else count_mark(with_norm(yp[k - N]), cb[k - N], xp, N, rw, oddn + e);
    }
    __syncthreads();
    for (int e = threadIdx.x; e < odd; e += THREADS) rw[oddk[e]] = oddn[e] | AFF;
    __syncthreads();   // the words are settled
  }
  // the inverse lists, as CSR over the owners (rows 0 .. N-1, then the
  // columns): each point whose count is 1 is a member of its hit's list (a
  // list whose owner's count is not 1 is left out: the fix-up takes it);
  // counts, their prefix sums, then the members placed in any order (the
  // lists' ends overlay the bounds, which the fix-up loads again)
  auto owner = [&](int k) {
    const int one = single(rw[k]);
    const int o = one < 0 ? -1 : k < N ? N + one : one;
    return o >= 0 && single(rw[o]) >= 0 ? o : -1;
  };
  for (int k = threadIdx.x; k < N + M; k += THREADS) off[k] = 0u;
  __syncthreads();
  for (int k = threadIdx.x; k < N + M; k += THREADS) {
    const int o = owner(k);
    if (o >= 0) atomicAdd(off + o, 1u);
  }
  __syncthreads();
  block_scan(off, N + M, red);
  __syncthreads();
  for (int k = threadIdx.x; k < N + M; k += THREADS) {
    const int o = owner(k);
    if (o >= 0) mem[atomicAdd(off + o, 1u)] = (uint16_t)(k < N ? k : k - N);
  }
  __syncthreads();

  // each owner's cross sums over its list in ascending order (wr_j = gr_j
  // / 1, wl_i = gl_i / 1), its own-direction sum its hit's point: a list of
  // up to SHORT members sorted in registers by its thread, a longer one
  // (up to 32) across a warp's lanes (listed in longk, which cannot
  // overflow), a longer still by the fix-up
  bool more = false;
  for (int o = threadIdx.x; o < N + M; o += THREADS) {
    if (fixed(rw[o])) continue;
    const uint32_t s0 = o ? off[o - 1] : 0u;
    const int n = (int)(off[o] - s0);
    if (n > 32) {
      atomicOr(rw + o, AFF);
      more = true;
      continue;
    }
    if (n > SHORT) {
      longk[atomicAdd(&nlong, 1)] = (uint16_t)o;
      continue;
    }
    uint32_t e[SHORT];
#pragma unroll
    for (int t = 0; t < SHORT; ++t) e[t] = t < n ? mem[s0 + t] : NONE;
    sort_short(e);
    float sw = 0.f;
    float3 sv = make_float3(0.f, 0.f, 0.f);
    const float4* other = o < N ? yp : xp;
#pragma unroll
    for (int t = 0; t < SHORT; ++t)
      if (t < n) fold(other, (int)e[t], sw, sv);
    finish(o, N, xp, yp, rw, sw, sv, gx, gy);
  }
  __syncthreads();
  for (int e = warp; e < nlong; e += WARPS) {
    const int o = longk[e];
    const uint32_t s0 = o ? off[o - 1] : 0u;
    const int n = (int)(off[o] - s0);
    uint32_t v = lane < n ? mem[s0 + lane] : NONE;
#pragma unroll
    for (int k = 2; k <= 32; k <<= 1)   // bitonic sort across the lanes, ascending
#pragma unroll
      for (int j = k >> 1; j > 0; j >>= 1) {
        const uint32_t u = __shfl_xor_sync(0xffffffffu, v, j);
        v = ((lane & j) == 0) == ((lane & k) == 0) ? min(v, u) : max(v, u);
      }
    float sw = 0.f;
    float3 sv = make_float3(0.f, 0.f, 0.f);
    const float4* other = o < N ? yp : xp;
    for (int t = 0; t < n; ++t) fold(other, (int)__shfl_sync(0xffffffffu, v, t), sw, sv);
    if (lane == 0) finish(o, N, xp, yp, rw, sw, sv, gx, gy);
  }
  // the fix-up: every marked point (and every point whose count is not 1)
  // summed over the whole other cloud in the passes' order, a warp each,
  // listed in the members' room (the lists are done; up to N + M points)
  if (__syncthreads_or(more) || path == PATH_FIX) {
    for (int i = threadIdx.x; i < N; i += THREADS) rb[i] = sweep_bound(dl[i]);
    for (int j = threadIdx.x; j < M; j += THREADS) cb[j] = sweep_bound(dr[j]);
    for (int k = threadIdx.x; k < N + M; k += THREADS)
      if (fixed(rw[k])) mem[atomicAdd(&nfix, 1)] = (uint16_t)k;
    __syncthreads();
    for (int e = warp; e < nfix; e += WARPS) {
      const int k = mem[e];
      if (k < N) fix_row(k, xp, yp, M, rb, cb, rw, cw, gx);
      else fix_col(k - N, xp, yp, N, rb, cb, rw, gy);
    }
  }
}

}  // namespace

extern "C" {

// dynamic shared memory of one block (the wrapper checks it against the limit)
int dpfx_chamfer_smem_bytes(int N, int M) { return Sizes(N, M).bytes; }

// CTAs a launch of P pairs of N x M points gives each pair
int dpfx_chamfer_cluster_size(int P, int N, int M) { return cluster_size(P, N, M); }
int dpfx_nnd_bwd_smem_bytes(int N, int M) { return bwd_smem_bytes(N, M); }
int dpfx_nnd_bwd3_smem_bytes(int N, int M) { return bwd3_smem_bytes(N, M); }

// gx [P, N, 3], gy [P, M, 3] of diagonal pairs xs [P, N, 3], ys [P, M, 3]
// from the forward's dl [P, N], dr [P, M] and the cotangents gl, gr; paths
// [P] gets each pair's path: 0 the lists, 1 the lists and the fix-up, 2 the
// three passes
int dpfx_nnd_bwd_launch(const float* xs, const float* ys, int P, int N, int M, const float* dl,
                        const float* dr, const float* gl, const float* gr, float* gx, float* gy,
                        uint8_t* paths, void* stream) {
  if (P <= 0) return 0;
  if (N > MAX_POINTS || M > MAX_POINTS) return cudaErrorInvalidValue;
  return launch_clusters(nnd_bwd_kernel, P, N, M, bwd_smem_bytes(N, M), static_cast<cudaStream_t>(stream), xs,
                         ys, N, M, dl, dr, gl, gr, gx, gy, paths);
}

// the same through the three passes, one block per pair
int dpfx_nnd_bwd3_launch(const float* xs, const float* ys, int P, int N, int M, const float* dl,
                         const float* dr, const float* gl, const float* gr, float* gx, float* gy,
                         void* stream) {
  if (P <= 0) return 0;
  const int bytes = bwd3_smem_bytes(N, M);
  cudaError_t e = cudaFuncSetAttribute(nnd_bwd3_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  nnd_bwd3_kernel<<<P, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(xs, ys, N, M, dl, dr, gl, gr,
                                                                            gx, gy);
  return cudaGetLastError();
}

int dpfx_chamfer_launch(const float* xs, const float* ys, const int* pairs, int P, int N, int M, int fast,
                        float* cd, float* dl, float* dr, void* stream) {
  if (P <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int bytes = Sizes(N, M).bytes;
  return fast ? launch_clusters(chamfer_kernel<true>, P, N, M, bytes, s, xs, ys, pairs, N, M, cd, dl, dr)
              : launch_clusters(chamfer_kernel<false>, P, N, M, bytes, s, xs, ys, pairs, N, M, cd, dl, dr);
}

}  // extern "C"
