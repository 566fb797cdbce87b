// Building blocks shared by the port's Hopper kernels (fused_sampler.cu,
// fused_train.cu, fused_encoder.cu, fused_latent.cu, chamfer.cu, emd.cu,
// bench_fused_bwd.cu, dual_issue.cu):
// dtype helpers, the activations, the staging of a square weight matrix
// into shared memory, one block-wide matrix product with a per-element
// epilogue (WMMA on the tensor cores for bf16 operands, register-tiled IEEE
// f32 FMA for f32), warp-level mma.sync / ldmatrix / cp.async primitives,
// the fixed-order reduction of per-block partial sums, and
// the point-cloud pieces of the CD and EMD kernels (points as float4,
// squared distances, a block-wide sum).
//
// Every function here is deterministic: a given input gives bit-identical
// output from run to run (no atomics; every sum in a fixed order).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

// A named namespace only: a second anonymous one would make nvcc's host
// stubs for the including file's kernels ambiguous.
namespace dpfx {

constexpr int THREADS = 256;    // 8 warps per block
constexpr int WARPS = THREADS / 32;

// Consecutive warps that share the work of a call below: the whole block
// (barrier 0), or a part of it that walks its own tiles (a named barrier of
// its own: bench_fused_bwd.cu's f32 stripes, flow_bwd_rows.cuh's groups).
// The overloads without a group take the whole block.
struct Group {
  int bar, warp0, warps;
  static __device__ Group block() { return Group{0, 0, WARPS}; }
  __device__ int tid() const { return (int)threadIdx.x - warp0 * 32; }
  __device__ int size() const { return warps * 32; }
  __device__ int warp() const { return (int)threadIdx.x / 32 - warp0; }
  __device__ void sync() const {
    if (bar == 0) __syncthreads();
    else asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(warps * 32) : "memory");
  }
};

__host__ __device__ constexpr int round128(int n) { return (n + 127) / 128 * 128; }

// row padding of a shared-memory activation or weight tile (bank conflicts)
template <typename S>
struct Layout {
  static constexpr int PAD = sizeof(S) == 2 ? 8 : 1;
};

template <typename S>
constexpr bool is_bf16 = std::is_same<S, __nv_bfloat16>::value;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename S> __device__ __forceinline__ S from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}
// round a float to the compute dtype and back
template <typename S> __device__ __forceinline__ float rnd(float v) { return to_f(from_f<S>(v)); }

__device__ __forceinline__ float activate(float v, int act) {
  switch (act) {
    case 0: return v > 0.f ? v : 0.f;                                      // relu
    case 1: return 0.5f * v * (1.f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    case 2: return tanhf(v);
    default: return v >= 0.f ? v : 0.01f * v;                              // leaky_relu
  }
}

// relu that keeps a NaN, as jnp.maximum(v, 0) does (training must see it)
__device__ __forceinline__ float relu_nan(float v) { return v < 0.f ? 0.f : v; }

// stage one H x H matrix (row-major in global) into ws with row stride ld
template <int H>
__device__ void load_square(__nv_bfloat16* ws, const __nv_bfloat16* g, int ld) {
  constexpr int VPR = H / 8;  // 16-byte vectors per row
  for (int v = threadIdx.x; v < H * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    *reinterpret_cast<uint4*>(ws + r * ld + c) = *reinterpret_cast<const uint4*>(g + r * H + c);
  }
}
template <int H>
__device__ void load_square(float* ws, const float* g, int ld) {
  for (int v = threadIdx.x; v < H * H; v += THREADS) ws[(v / H) * ld + v % H] = g[v];
}

// C[M x N] = sum_k A(m, k) B(k, n), operands in shared or global memory:
//   AT false: A(m, k) = a[m * lda + k];   AT true: A(m, k) = a[k * lda + m]
//   BT false: B(k, n) = b[k * ldb + n];   BT true: B(k, n) = b[n * ldb + k]
// M, N, K multiples of 16. The whole block calls it; epi(m, n, v) is called
// once for each element of C with its float32 sum v, and returns the value
// that the column sums take. bf16: WMMA (bf16 operands, f32 accumulation),
// one 16 x 16 tile of C per warp at a time, finished through the warp's
// 16 x 16 f32 staging tile; with colpart, lanes 0-15 then sum the returned
// values of the tile's 16 rows (in row order) into colpart[tm * N + n].
// f32: register-tiled FMA (exact IEEE f32, k in order), thread (tm, tn)
// owning rows tm + 16i and columns tn + 16j of each 128 x 128 chunk; colpart is not
// written (the caller sums the values it stored, see column_sums).
// The caller synchronises before and after; epi must not write an operand.
// With a group, only its warps work (stage still holds one tile per warp
// of the block); in f32 its threads form a (size / 16) x 16 grid, each
// owning 8 rows and 8 columns of a chunk, so per element the same sum as
// with the whole block (the overloads without a group).
template <bool AT, bool BT, typename Epi>
__device__ void gemm(const Group& g, int M, int N, int K, const __nv_bfloat16* a, int lda,
                     const __nv_bfloat16* b, int ldb, float* stage, float* colpart, Epi epi) {
  using namespace nvcuda;
  using LA = std::conditional_t<AT, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<BT, wmma::col_major, wmma::row_major>;
  const int lane = threadIdx.x % 32;
  const int MT = M / 16, NT = N / 16;
  float* st = stage + (threadIdx.x / 32) * 256;
  for (int t = g.warp(); t < MT * NT; t += g.warps) {
    const int tm = t % MT, tn = t / MT;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.f);
    for (int kk = 0; kk < K; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb;
      const __nv_bfloat16* pa = AT ? a + (size_t)kk * lda + tm * 16 : a + (size_t)tm * 16 * lda + kk;
      const __nv_bfloat16* pb = BT ? b + (size_t)tn * 16 * ldb + kk : b + (size_t)kk * ldb + tn * 16;
      wmma::load_matrix_sync(fa, pa, lda);
      wmma::load_matrix_sync(fb, pb, ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(st, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) st[e] = epi(tm * 16 + e / 16, tn * 16 + e % 16, st[e]);
    __syncwarp();
    if (colpart && lane < 16) {
      float s = 0.f;
      for (int r = 0; r < 16; ++r) s += st[r * 16 + lane];
      colpart[tm * N + tn * 16 + lane] = s;
    }
    __syncwarp();
  }
}

template <bool AT, bool BT, typename Epi>
__device__ void gemm(int M, int N, int K, const __nv_bfloat16* a, int lda,
                     const __nv_bfloat16* b, int ldb, float* stage, float* colpart, Epi epi) {
  gemm<AT, BT>(Group::block(), M, N, K, a, lda, b, ldb, stage, colpart, epi);
}

template <bool AT, bool BT, typename Epi>
__device__ void gemm(const Group& g, int M, int N, int K, const float* a, int lda,
                     const float* b, int ldb, float*, float*, Epi epi) {
  const size_t sam = AT ? 1 : lda, sak = AT ? lda : 1;
  const size_t sbk = BT ? 1 : ldb, sbn = BT ? ldb : 1;
  const int RS = g.size() / 16;   // rows of the group's 16-wide thread grid
  const int tm = g.tid() / 16, tn = g.tid() % 16;
  for (int m0 = 0; m0 < M; m0 += 8 * RS)
    for (int n0 = 0; n0 < N; n0 += 128) {
      const int mi = min(8, (M - m0) / RS), nj = min(8, (N - n0) / 16);
      float acc[8][8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
      for (int k = 0; k < K; ++k) {
        float av[8], bv[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) av[i] = i < mi ? a[(m0 + tm + RS * i) * sam + k * sak] : 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j) bv[j] = j < nj ? b[k * sbk + (n0 + tn + 16 * j) * sbn] : 0.f;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (i < mi && j < nj) epi(m0 + tm + RS * i, n0 + tn + 16 * j, acc[i][j]);
    }
}

template <bool AT, bool BT, typename Epi>
__device__ void gemm(int M, int N, int K, const float* a, int lda, const float* b, int ldb,
                     float* stage, float* colpart, Epi epi) {
  gemm<AT, BT>(Group::block(), M, N, K, a, lda, b, ldb, stage, colpart, epi);
}

// C[M x N] = A B (first) or C += A B, C row-major with row stride ldc in
// global or shared memory; operands and layouts as gemm. bf16: the WMMA
// accumulators start from C's values, so C is read and written once per
// 16 x 16 tile (C 32-byte aligned, ldc a multiple of 4); a warp takes
// ACC_TILES tiles at a time, so their loads from global memory are in
// flight together. f32: through gemm's epilogue. Deterministic: every
// element sums in a fixed order.
constexpr int ACC_TILES = 4;

template <bool AT, bool BT>
__device__ void gemm_acc(const Group& g, int M, int N, int K, const __nv_bfloat16* a, int lda,
                         const __nv_bfloat16* b, int ldb, float* c, int ldc, bool first) {
  using namespace nvcuda;
  using LA = std::conditional_t<AT, wmma::col_major, wmma::row_major>;
  using LB = std::conditional_t<BT, wmma::col_major, wmma::row_major>;
  const int MT = M / 16, NT = N / 16;
  for (int t0 = g.warp(); t0 < MT * NT; t0 += ACC_TILES * g.warps) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[ACC_TILES];
#pragma unroll
    for (int u = 0; u < ACC_TILES; ++u) {
      const int t = t0 + u * g.warps;
      if (t >= MT * NT) break;
      if (first) wmma::fill_fragment(acc[u], 0.f);
      else wmma::load_matrix_sync(acc[u], c + (size_t)(t % MT) * 16 * ldc + (t / MT) * 16, ldc,
                                  wmma::mem_row_major);
    }
    for (int kk = 0; kk < K; kk += 16) {
#pragma unroll
      for (int u = 0; u < ACC_TILES; ++u) {
        const int t = t0 + u * g.warps;
        if (t >= MT * NT) break;
        const int tm = t % MT, tn = t / MT;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, LA> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, LB> fb;
        const __nv_bfloat16* pa = AT ? a + (size_t)kk * lda + tm * 16 : a + (size_t)tm * 16 * lda + kk;
        const __nv_bfloat16* pb = BT ? b + (size_t)tn * 16 * ldb + kk : b + (size_t)kk * ldb + tn * 16;
        wmma::load_matrix_sync(fa, pa, lda);
        wmma::load_matrix_sync(fb, pb, ldb);
        wmma::mma_sync(acc[u], fa, fb, acc[u]);
      }
    }
#pragma unroll
    for (int u = 0; u < ACC_TILES; ++u) {
      const int t = t0 + u * g.warps;
      if (t >= MT * NT) break;
      wmma::store_matrix_sync(c + (size_t)(t % MT) * 16 * ldc + (t / MT) * 16, acc[u], ldc,
                              wmma::mem_row_major);
    }
  }
}

template <bool AT, bool BT>
__device__ void gemm_acc(int M, int N, int K, const __nv_bfloat16* a, int lda,
                         const __nv_bfloat16* b, int ldb, float* c, int ldc, bool first) {
  gemm_acc<AT, BT>(Group::block(), M, N, K, a, lda, b, ldb, c, ldc, first);
}

template <bool AT, bool BT>
__device__ void gemm_acc(const Group& g, int M, int N, int K, const float* a, int lda,
                         const float* b, int ldb, float* c, int ldc, bool first) {
  gemm<AT, BT>(g, M, N, K, a, lda, b, ldb, nullptr, nullptr, [&](int m, int n, float v) {
    float* p = c + (size_t)m * ldc + n;
    *p = first ? v : *p + v;
    return 0.f;
  });
}

template <bool AT, bool BT>
__device__ void gemm_acc(int M, int N, int K, const float* a, int lda, const float* b, int ldb,
                         float* c, int ldc, bool first) {
  gemm_acc<AT, BT>(Group::block(), M, N, K, a, lda, b, ldb, c, ldc, first);
}

// After an epilogue that stored its returned values into buf (M x N, row
// stride ld): out[n] = sum over the M rows (accumulate: out[n] += it), in a
// fixed order. bf16 sums the per-tile column sums of colpart (the stored
// values are rounded); f32 sums buf itself (the stored values are exact).
template <typename S>
__device__ void column_sums(const Group& g, int M, int N, const float* colpart, const S* buf,
                            int ld, float* out, bool accumulate) {
  for (int n = g.tid(); n < N; n += g.size()) {
    float s = 0.f;
    if constexpr (is_bf16<S>) {
      for (int tm = 0; tm < M / 16; ++tm) s += colpart[tm * N + n];
    } else {
      for (int m = 0; m < M; ++m) s += buf[m * ld + n];
    }
    out[n] = accumulate ? out[n] + s : s;
  }
}

template <typename S>
__device__ void column_sums(int M, int N, const float* colpart, const S* buf, int ld,
                            float* out, bool accumulate = false) {
  column_sums<S>(Group::block(), M, N, colpart, buf, ld, out, accumulate);
}

// ---- warp-level tensor-core products (flow_rows.cuh, fused_train.cu,
// fused_encoder.cu)
//
// mma.sync m16n8k16 / m16n8k8 on bf16 operands with f32 accumulators, and
// the ldmatrix loads that feed it. Fragments as the PTX ISA lays them out,
// with g = lane / 4 and t = lane % 4:
//   A (16 x 16, row major), 4 registers of two bf16: a[0] = (row g, cols
//     2t, 2t+1), a[1] = (row g+8, cols 2t, 2t+1), a[2] and a[3] the same
//     rows at cols 2t+8, 2t+9 (m16n8k8 takes a[0] and a[1] only);
//   B (16 x 8, column major), 2 registers: b[0] = (rows 2t, 2t+1, col g),
//     b[1] = (rows 2t+8, 2t+9, col g) (m16n8k8 takes b[0]);
//   C (16 x 8, f32): c[0], c[1] = (row g, cols 2t, 2t+1), c[2], c[3] = (row
//     g+8, cols 2t, 2t+1).
// Two C tiles side by side (cols 0-7 and 8-15) are, packed to bf16, the A
// fragment of the next product over those 16 columns (a[0], a[1] from the
// first, a[2], a[3] from the second): a warp carries its rows from one layer
// to the next in registers.

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// four 8 x 8 b16 matrices; lanes 8i..8i+7 give the row addresses of matrix
// i, and register i receives matrix i (trans: its transpose)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_u32(p)));
}
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

// c += a b on the tensor cores (bf16 operands, f32 sums)
__device__ __forceinline__ void mma16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                      uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void mma8(float (&c)[4], uint32_t a0, uint32_t a1, uint32_t b0) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(b0));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

__device__ __forceinline__ int lane_id() { return threadIdx.x & 31; }

// the A fragment (m16 k8) of the warp's 16 points' coordinates, rounded to
// bf16 and zero in k = 3..7, each lane p < 16 (and its mirror p + 16)
// holding point p's x[3] (flow_rows.cuh's users, fused_encoder.cu)
__device__ __forceinline__ void coord_frag(const float (&x)[3], uint32_t& a0, uint32_t& a1) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  float r[6];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    r[c] = __shfl_sync(0xffffffffu, x[c], g);
    r[3 + c] = __shfl_sync(0xffffffffu, x[c], g + 8);
  }
  a0 = t == 0 ? pack_bf16(r[0], r[1]) : t == 1 ? pack_bf16(r[2], 0.f) : 0u;
  a1 = t == 0 ? pack_bf16(r[3], r[4]) : t == 1 ? pack_bf16(r[5], 0.f) : 0u;
}

// the same for 8 coordinates (bench_fused_bwd.cu's 8-row layout): k = 0..7
// all filled
__device__ __forceinline__ void coord_frag(const float (&x)[8], uint32_t& a0, uint32_t& a1) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  uint32_t lo[4], hi[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const float x0 = __shfl_sync(0xffffffffu, x[2 * q], g);
    const float x1 = __shfl_sync(0xffffffffu, x[2 * q + 1], g);
    const float y0 = __shfl_sync(0xffffffffu, x[2 * q], g + 8);
    const float y1 = __shfl_sync(0xffffffffu, x[2 * q + 1], g + 8);
    lo[q] = pack_bf16(x0, x1);
    hi[q] = pack_bf16(y0, y1);
  }
  a0 = t == 0 ? lo[0] : t == 1 ? lo[1] : t == 2 ? lo[2] : lo[3];
  a1 = t == 0 ? hi[0] : t == 1 ? hi[1] : t == 2 ? hi[2] : hi[3];
}

// 16-byte copies from global to shared memory that run behind the
// threads' work (cp.async); wait_all makes the thread's copies land
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_u32(smem)), "l"(gmem));
}
// the same, 4 bytes (4-byte aligned; L1-allocating, as .ca must be below 16 bytes)
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(smem)), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;"); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
}

// out[g * E + e] = sum over s < S of part[(g * S + s) * E + e], s in order
static __global__ void reduce_slices(const float* __restrict__ part, float* __restrict__ out, int G,
                              int S, long long E) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)G * E) return;
  const long long g = i / E, e = i % E;
  const float* p = part + g * S * E + e;
  float s = 0.f;
  for (int k = 0; k < S; ++k) s += p[(long long)k * E];
  out[i] = s;
}

inline cudaError_t launch_reduce(const float* part, float* out, int G, int S, long long E,
                          cudaStream_t stream) {
  const long long n = (long long)G * E;
  reduce_slices<<<(unsigned)((n + 255) / 256), 256, 0, stream>>>(part, out, G, S, E);
  return cudaGetLastError();
}

// ---- point clouds (chamfer.cu, emd.cu)

// [n, 3] f32 -> float4 (x, y, z, |p|^2), the block's threads striding over
// the points; FAST rounds x, y, z to bf16 after the norm is taken
template <bool FAST>
__device__ void load_points(float4* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const float a = src[3 * i], b = src[3 * i + 1], c = src[3 * i + 2];
    const float nrm = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
    dst[i] = FAST ? make_float4(rnd<__nv_bfloat16>(a), rnd<__nv_bfloat16>(b), rnd<__nv_bfloat16>(c), nrm)
                  : make_float4(a, b, c, nrm);
  }
}

// squared distance max((|a|^2 + |b|^2) - 2 a.b, 0) of two loaded points,
// each operation rounded on its own (never contracted into an FMA), so it
// equals the plain torch expression bit for bit; the argument order does
// not matter (IEEE add and multiply commute)
__device__ __forceinline__ float sqdist(const float4 a, const float4 b) {
  const float ab = __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
  return fmaxf(__fsub_rn(__fadd_rn(a.w, b.w), __fmul_rn(2.f, ab)), 0.f);
}

// the block's sum of v, the same in every thread, in a fixed order (a
// butterfly within each warp, then the warps in order); red holds WARPS
// floats of shared memory; every thread of a THREADS-wide block calls it
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) s += red[w];
  return s;
}

}  // namespace dpfx
