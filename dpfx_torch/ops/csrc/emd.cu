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
// The algorithm (n_iters annealed levels L_k = -4^(n_iters-3-k), 0 on the last):
//   w_ij = exp(L d_ij) remainr_j            d = squared distance
//   ss_ij = w_ij remainl_i / (sum_j w_ij + eps)
//   ratio_j = min(remainr_j / (sum_i ss_ij + eps), 1)
//   cost += sum_j ratio_j sum_i ss_ij sqrt(d_ij)
//   remainl_i -= sum_j ss_ij ratio_j ; remainr_j -= ratio_j sum_i ss_ij
// and the wrapper divides the cost by n.
//
// What bounds it: per pair and level N x M elements, each needing exps (MUFU
// ex2), a sqrt (MUFU) and ~10 FP32 instructions per sweep; MUFU runs at 16
// per clock per SM against 128 FP32 lanes, so the issue rate of the
// special-function units and of the CUDA cores bounds it. The two clouds are
// read once per pair: memory plays no part.
//
// Design:
//   * One pair's whole state fits in one SM: both clouds (16 B a point) and
//     the per-point vectors, 112 KB at N = M = 2048 (two blocks per SM). Every
//     [N, M] element is recomputed from the coordinates when a sweep needs it.
//   * Two sweeps per level, each with every element once. A row's sums need
//     the whole row, a column's the whole column, so the sweeps alternate:
//     (B_k) columns: cs_j = sum_i ss_ij and cdist_j = sum_i ss_ij sqrt(d_ij),
//     then ratio_j, the next remainr_j and the level's cost; (F_k) rows: the
//     update of remainl (the row sum sum_j w_ij ratio_j of level k) fused with
//     the next level's row sums (sum_j w_ij of level k+1). The levels are
//     fixed: L_k = 4 L_{k+1} up to the last but one, so F_k computes one
//     e = exp(L_{k+1} d) and takes level k's exp as (e e)(e e). The squarings
//     carry ~4x one exp's relative error (~1e-6 in f32), far inside
//     approxmatch's own f32 drift (the f32 plain version against an f64 run:
//     median 2e-6, max 1.7e-3 per pair). Level 0 (L = 0) needs no exp: its
//     row sums are sum_j remainr_j, one sum for every row; F before it
//     computes level k's exp itself, and the last C runs only with GRAD.
//     Per element at 10 levels: 19 exps and 10 square roots (29 MUFU), where
//     three recomputing sweeps per level took 30 exps and 10 square roots.
//   * The exact element loop: d is the plain version's expanded form
//     max((|x|^2 + |y|^2) - 2 x.y, 0), rounded op by op as it rounds it (3
//     products, 3 adds, an FMA, a max), so d is the plain version's bit for
//     bit, the same in the row and the column sweep, and 0 for a point
//     against itself; the exponent is t = s d with s = L log2(e), exp2 is
//     MUFU ex2 of t, the square root MUFU sqrt of d, and the scales of two
//     levels differ by exactly 4, so t_k = 4 t_{k+1} bit for bit. Two
//     cheaper forms failed on the card: the expanded form on coordinates
//     scaled per level (X = -2 s x, 3 FMAs and an add) gave a cloud against
//     itself phantom distances of ~2e-4 (its pair's EMD 1.5% off the plain
//     version and f64), and the coordinates' difference, exact for
//     coincident points, parted from the plain version on a pair of clouds
//     1e-4 apart by 1.5e-2 (median) where the plain version's expanded d is
//     all rounding; either rounded otherwise in the two sweeps makes their
//     w part by ~1% at the steep levels (10x the plain version's drift from
//     f64). Per-row and per-column factors stay out of the sums (cs_j =
//     remainr_j sum_i e_ij scale_i). Rows: a thread holds R rows in registers
//     while the columns stream from shared memory as broadcasts; when a CTA
//     owns fewer rows than its threads can hold, the columns are split among
//     G groups of threads whose partial sums are added in group order. The
//     sums run in other orders than the plain version's: exact mode is held
//     to it by the median and the largest pair, and to an f64 run.
//   * Fast mode on the tensor cores, as the Pallas fast mode uses its MXU.
//     Rounding to bf16 at each of the places the plain fast version rounds
//     (d, w, the row scale, ss, each ss sqrt(d) term) costs a conversion and
//     an unpack per element on the CUDA cores, which made fast mode slower
//     than exact. Here a warp owns 16 rows (or columns) and walks the other
//     side in tiles of 16: d comes from mma.sync m16n8k8 (bf16 coordinates,
//     the point's |x|^2 in f32 as the accumulator's start, the other side's
//     norm as three bf16 parts whose sum is the f32 norm exactly); it is
//     clamped and rounded by one packed cvt.rn.relu.bf16x2; w and the
//     cdist terms are rounded by packed conversions straight into the A
//     operand of an m16n8k16 product with a ones column (the accumulator
//     fragment reused as the A operand), which sums them in f32; ss = w scale
//     is one mul.rn.bf16x2 of two bf16 values, rounded once as torch rounds
//     it; the column sweep's w is one ex2 of s d + log2(remainr_j) (an FFMA
//     where exp and the product took two FMULs: fast mode is bound by the
//     issue of its ~10 instructions per element, not by its conversions:
//     rounding d by Veltkamp's split on the FP32 pipe instead of a packed
//     cvt ran slower on the card); the f32 ratio enters its row sum as three bf16 parts (hi, mid, lo),
//     a product exact to f32.
//   * Few pairs: one CTA per pair leaves SMs idle (32 pairs on 132 SMs), so
//     below 2 x 132 pairs a pair runs on a thread-block cluster of 2 or 4
//     CTAs (cluster_size: 4 while 4P <= 132, else 2). Each CTA holds both
//     clouds and owns a slice of the rows and one of the columns, in units
//     of 16; after each sweep the owner of a row or column writes its values
//     (scale; next remainr, remainr ratio, the ratio's parts) into every CTA
//     of the cluster through distributed shared memory, and cluster.sync()
//     separates the sweeps. The level's cost is summed over the cluster in
//     rank order by rank 0. The split depends on P, N and M alone, so the
//     GRAD and plain launches of the same pairs sum in the same order.
//   * Deterministic: no atomics; every sum runs in a fixed order (per
//     thread, tensor-core products in tile order, groups and warps in order),
//     so results are bit-identical from run to run, and the cost of a GRAD
//     launch equals the plain launch's bit for bit (the cost's arithmetic is
//     the same instructions, written with the _rn intrinsics that nvcc does
//     not contract).
//   * Ragged N != M: factorl = max(n, m) / n and factorr = max(n, m) / m
//     come from the wrapper; padded points (to 16) carry no mass.
//   * GRAD (exact only, as in dpfx): the gradients of the cost with the plan
//     held constant, summed over the levels,
//       gx_i = sum_j delta_ij (x_i - y_j) / max(|x_i - y_j|, eps)
//       gy_j = sum_i delta_ij (y_j - x_i) / max(|x_i - y_j|, eps)
//     with delta_ij = ss_ij ratio_j, the level's share of the plan, and the
//     distance from the coordinates' difference, as in dpfx's emd_grads_jnp
//     (near coincident points the expanded d cancels to ~0 while |x_i - y_j|
//     is ~1e-4; the Pallas body divides by sqrt(d) and has that fault).
//     B_k sums e_ij scale_i (y_j - x_i) / max(|x_i - y_j|, eps) and adds
//     remainr_j ratio_j times it to gy_j; F_k sums e_ij^(4) remainr_j ratio_j
//     (x_i - y_j) / ... and adds scale_i (level k's) times it to gx_i.
//
// SASS of the element loops (python -m dpfx_torch.tools.sass_loops emd, on
// the library chip_smoke.py builds; instructions per element, one trip of a
// loop divided by the elements it covers: exact 16 a row trip, 8 a column
// trip; fast 16 a trip of two tiles):
//   exact  rows F 14.6 (13 FP32, 1 MUFU), rows A / CEXP 11.6 (10, 1),
//          columns 14.9 (12 FP32, 2 MUFU), columns of level 0 11.9 (10, 1)
//   fast   rows F 11.2 (5 FP32, 1 MUFU, 1.5 packed cvt, 0.5 HMMA), rows A
//          7.0, columns 10.1 (2 FP32, 2 MUFU, 1.5 cvt, 0.5 HMMA), level 0 7.7
//   GRAD   rows F 24.6 (2 MUFU), columns 26.9 (3 MUFU)
// MUFU per element over 10 levels: 1 (A) + 8 (F) + 1 (CEXP) + 9 x 2 + 1
// (columns) = 29; with GRAD 49 (an rsqrt in each sweep). Exact rows issue
// ~15 instructions for 1 MUFU, so the row sweep is bound by issue, the
// column sweep by the MUFU (2 per element: 16 issue slots' worth).
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). The
// launch returns the CUDA error of the launch.

#include <cooperative_groups.h>

#include "dpfx_common.cuh"

namespace {

using namespace dpfx;
namespace cg = cooperative_groups;

constexpr int R = 8;                    // rows (columns) a thread holds in an exact sweep
constexpr int UNIT = 16;                // the cluster splits rows and columns in these
constexpr int SMS = 132;                // streaming multiprocessors of an H100 SXM
constexpr float EPS = 1e-9f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr uint32_t ONES2 = 0x3F803F80u; // two bf16 ones

// the row sweeps: A (row sums of the first level), F (remainl of level k and
// row sums of level k+1, e^4), CEXP (remainl of level k, its own exp; the
// next level is 0), CONE (GRAD on level 0: gx only), S (row sums of level 0
// without a sweep)
enum Kind { K_A, K_F, K_CEXP, K_CONE, K_S };

__host__ __device__ constexpr int round16(int n) { return (n + 15) / 16 * 16; }

__device__ __forceinline__ float ex2(float t) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(e) : "f"(t));
  return e;
}
__device__ __forceinline__ float lg2(float v) {
  float r;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float sqrt_a(float v) {
  float r;
  asm("sqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
__device__ __forceinline__ float rsqrt_a(float v) {
  float r;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}
// two floats to bf16x2 (lo in the low half), rounded to nearest even
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
// the same with negative values clamped to 0 (max(d, 0))
__device__ __forceinline__ uint32_t pack2_relu(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.relu.bf16x2.f32 %0, %1, %2;" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}
__device__ __forceinline__ float lo_f(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }
__device__ __forceinline__ uint32_t mul_bf2(uint32_t a, uint32_t b) {
  uint32_t r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}
__device__ __forceinline__ uint16_t bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// d = a b + c, A 16x8 (a0: row g, a1: row g+8; k 2t..2t+1), B 8x8 (k 2t..2t+1, col g)
__device__ __forceinline__ void mma_k8(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t b0,
                                       const float (&c)[4]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5}, {%6}, "
      "{%7,%8,%9,%10};"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a0), "r"(a1), "r"(b0), "f"(c[0]), "f"(c[1]), "f"(c[2]), "f"(c[3]));
}
// d += a b, A 16x16 (a0/a2: row g, a1/a3: row g+8; k 2t.., 2t+8..), B 16x8
__device__ __forceinline__ void mma_k16(float (&d)[4], uint32_t a0, uint32_t a1, uint32_t a2,
                                        uint32_t a3, uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

// dst (3 floats in global memory, zeroed by the wrapper) += s * g, by the owner
__device__ __forceinline__ void add_grad(float* dst, float s, const float3 g) {
  dst[0] += s * g.x;
  dst[1] += s * g.y;
  dst[2] += s * g.z;
}

// ---- shared memory: both clouds, the per-point vectors, the exact sweeps' scratch

struct Sizes {
  int np, mp, ps;                        // padded N, M; row stride of the ratio parts (u32)
  __host__ __device__ Sizes(int N, int M) : np(round16(N)), mp(round16(M)), ps(round16(M) / 2 + 8) {}
  // bytes: clouds 16 B a point; scale (f32 or bf16), remainl, rowsum a row;
  // remainr and its partner (8 B) and the ratio's parts (bf16 x 3) a column
  __host__ __device__ int exact_bytes() const {
    return 16 * (np + mp) + 12 * np + 8 * mp + 4 * THREADS * R;
  }
  __host__ __device__ int fast_bytes() const {
    return 16 * (np + mp) + 10 * np + 8 * mp + 12 * ps;
  }
};

struct Sm {
  float4* xp;          // exact: (x, y, z, |x|^2); fast: 8 bf16 (x, y, z, n_hi, n_mid, n_lo, 0, 0)
  float4* yp;          // exact: as xp; fast: (-2y, m_hi, m_mid, m_lo, 0, 0)
  float* scale;        // exact: remainl / (rowsum + eps), every row (exchanged)
  uint16_t* scaleb;    // fast: the same in bf16
  float* remainl;      // own rows
  float* rowsum;       // own rows
  float* pack;         // per column pair (nx_2m, nx_2m+1, o_2m, o_2m+1); nx the next
                       // level's remainr, o remainr ratio (exact) or remainr (fast)
  uint32_t* parts;     // fast: the ratio as bf16 hi, mid, lo: 3 rows of ps words
  float* scratch;      // exact: the groups' partial sums
  int ps;
  __device__ float& nx(int j) const { return pack[(j >> 1) * 4 + (j & 1)]; }
  __device__ float& o(int j) const { return pack[(j >> 1) * 4 + 2 + (j & 1)]; }
};

template <bool FAST>
__device__ Sm carve(void* base, const Sizes& z) {
  Sm s;
  s.ps = z.ps;
  char* p = static_cast<char*>(base);
  s.xp = reinterpret_cast<float4*>(p);
  s.yp = s.xp + z.np;
  p = reinterpret_cast<char*>(s.yp + z.mp);
  s.pack = reinterpret_cast<float*>(p);
  p += 8 * z.mp;
  s.remainl = reinterpret_cast<float*>(p);
  s.rowsum = s.remainl + z.np;
  p += 8 * z.np;
  s.scale = nullptr;
  s.scaleb = nullptr;
  s.parts = nullptr;
  s.scratch = nullptr;
  if (FAST) {
    s.parts = reinterpret_cast<uint32_t*>(p);
    p += 12 * z.ps;
    s.scaleb = reinterpret_cast<uint16_t*>(p);
  } else {
    s.scale = reinterpret_cast<float*>(p);
    s.scratch = s.scale + z.np;
  }
  return s;
}

// ---- the cluster: its size, this CTA's rank and the rows and columns it owns

struct Ctx {
  int C, rank, r0, r1, c0, c1;
};

// [a, b) of n points in units of 16 for rank of C
__device__ void slice(int n, int C, int rank, int& a, int& b) {
  const int units = (n + UNIT - 1) / UNIT;
  a = min(n, rank * units / C * UNIT);
  b = min(n, (rank + 1) * units / C * UNIT);
}

// write v at i of arr in every CTA of the cluster
template <typename T>
__device__ __forceinline__ void put(const Ctx& cx, T* arr, int i, T v) {
  if (cx.C == 1) {
    arr[i] = v;
    return;
  }
  cg::cluster_group cl = cg::this_cluster();
  for (int r = 0; r < cx.C; ++r) cl.map_shared_rank(arr, r)[i] = v;
}

__device__ __forceinline__ void sync_all(const Ctx& cx) {
  if (cx.C > 1) cg::this_cluster().sync();
  else __syncthreads();
}

__device__ __forceinline__ int pow2ceil(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// threads per group holding R points each, for n owned points: a power of
// two in 32..THREADS; THREADS / it groups split the other side
__device__ __forceinline__ int group_threads(int n) {
  return min(THREADS, max(32, pow2ceil((n + R - 1) / R)));
}

// v[r] of group 0 += the other groups' v[r], in group order (G > 1); every
// thread of the block calls it
__device__ __forceinline__ void combine(float (&v)[R], float* scratch, int G, int RT) {
  if (G == 1) return;
  const int grp = threadIdx.x / RT, rt = threadIdx.x % RT;
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) scratch[(grp * R + r) * RT + rt] = v[r];
  __syncthreads();
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < R; ++r)
      for (int q = 1; q < G; ++q) v[r] = __fadd_rn(v[r], scratch[(q * R + r) * RT + rt]);
  }
}

__device__ __forceinline__ void combine3(float3 (&g)[R], float* scratch, int G, int RT) {
  float v[R];
#pragma unroll
  for (int r = 0; r < R; ++r) v[r] = g[r].x;
  combine(v, scratch, G, RT);
#pragma unroll
  for (int r = 0; r < R; ++r) g[r].x = v[r], v[r] = g[r].y;
  combine(v, scratch, G, RT);
#pragma unroll
  for (int r = 0; r < R; ++r) g[r].y = v[r], v[r] = g[r].z;
  combine(v, scratch, G, RT);
#pragma unroll
  for (int r = 0; r < R; ++r) g[r].z = v[r];
}

// ---- the end of a row or a column (the owner thread), shared by both modes

// row i: the remainl update of level k from ao = sum_j w_ij ratio_j (F,
// CEXP), gx with level k's scale (GRAD), and the next level's row sum and
// scale (an, or S when that level is 0)
template <bool FAST, bool GRAD>
__device__ void row_fin(const Sm& s, const Ctx& cx, int kind, int i, float an, float ao, float3 g,
                        float S, float* gx) {
  float rl = s.remainl[i];
  if (GRAD && (kind == K_F || kind == K_CEXP || kind == K_CONE)) add_grad(gx + 3 * i, s.scale[i], g);
  if (kind == K_CONE) return;
  if (kind == K_F || kind == K_CEXP) {
    rl = fmaxf(__fsub_rn(rl, __fmul_rn(__fdiv_rn(ao, __fadd_rn(s.rowsum[i], EPS)), rl)), 0.f);
    s.remainl[i] = rl;
  }
  const float rs = (kind == K_CEXP || kind == K_S) ? S : an;
  s.rowsum[i] = rs;
  const float sc = __fdiv_rn(rl, __fadd_rn(rs, EPS));
  if (FAST) put(cx, s.scaleb, i, bf16_bits(sc));
  else put(cx, s.scale, i, sc);
}


// column j with cs = sum_i ss_ij and cd = sum_i ss_ij sqrt(d_ij) (remainr
// included): ratio, the next remainr, the column's pack and ratio parts, gy
// (GRAD, g = sum_i e_ij scale_i unit_ij); returns ratio cd
template <bool FAST, bool GRAD>
__device__ float col_fin(const Sm& s, const Ctx& cx, int j, float rr, float cs, float cd, float3 g,
                         float* gy) {
  const float ratio = fminf(__fdiv_rn(rr, __fadd_rn(cs, EPS)), 1.f);
  const float rnext = fmaxf(__fsub_rn(rr, __fmul_rn(cs, ratio)), 0.f);
  put(cx, s.pack, (j >> 1) * 4 + (j & 1), rnext);
  put(cx, s.pack, (j >> 1) * 4 + 2 + (j & 1), FAST ? rr : __fmul_rn(rr, ratio));
  if (FAST) {
    // the ratio as hi + mid + lo, three bf16 whose sum is the f32 value
    const float hi = __bfloat162float(__float2bfloat16_rn(ratio));
    const float r1 = __fsub_rn(ratio, hi);
    const float mid = __bfloat162float(__float2bfloat16_rn(r1));
    uint16_t* p = reinterpret_cast<uint16_t*>(s.parts);
    put(cx, p, j, bf16_bits(hi));
    put(cx, p, 2 * s.ps + j, bf16_bits(mid));
    put(cx, p, 4 * s.ps + j, bf16_bits(__fsub_rn(r1, mid)));
  }
  if (GRAD) add_grad(gy + 3 * j, ratio * rr, g);
  return __fmul_rn(ratio, cd);
}

// ---- exact sweeps (CUDA cores)

// the squared distance max((|a|^2 + |b|^2) - 2 a.b, 0) of two loaded points,
// each operation rounded as the plain version rounds it, so d is the plain
// version's bit for bit (and 0 for a point against itself); 2 a.b is exact,
// so the FMA equals the plain subtraction of the rounded product
__device__ __forceinline__ float sqd(const float4 a, const float4 b) {
  const float ab = __fadd_rn(__fadd_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)), __fmul_rn(a.z, b.z));
  return fmaxf(__fmaf_rn(-2.f, ab, __fadd_rn(a.w, b.w)), 0.f);
}

// acc += k (a - b) / max(|a - b|, eps), |a - b| from the coordinates
__device__ __forceinline__ void add_unit(float3& acc, float k, const float4 a, const float4 b) {
  const float dx = a.x - b.x, dy = a.y - b.y, dz = a.z - b.z;
  const float w = k * rsqrt_a(fmaxf(fmaf(dx, dx, fmaf(dy, dy, dz * dz)), EPS * EPS));
  acc.x = fmaf(w, dx, acc.x);
  acc.y = fmaf(w, dy, acc.y);
  acc.z = fmaf(w, dz, acc.z);
}

// rows [r0, r1): KIND's sums over every column (see Kind), then row_fin.
// sig scales the exponent: e = 2^(sig d)
template <int KIND, bool GRAD>
__device__ void rows_exact(const Sm& s, const Ctx& cx, int M, float sig, float S, float* gx) {
  const int nr = cx.r1 - cx.r0;
  if (nr <= 0) return;
  const int RT = group_threads(nr), G = THREADS / RT;
  const int grp = threadIdx.x / RT, rt = threadIdx.x % RT;
  const int pairs = (M + 1) / 2, per = (pairs + G - 1) / G;
  const int m0 = min(pairs, grp * per), m1 = min(pairs, m0 + per);
  const float4* pk4 = reinterpret_cast<const float4*>(s.pack);
  for (int base = cx.r0; base < cx.r1; base += RT * R) {
    float4 P[R];
    float an[R], ao[R];
    float3 g[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      P[r] = s.xp[min(base + rt + r * RT, cx.r1 - 1)];
      an[r] = ao[r] = 0.f;
      g[r] = make_float3(0.f, 0.f, 0.f);
    }
    for (int m = m0; m < m1; ++m) {
      const float4 pk = pk4[m];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float4 q = s.yp[2 * m + h];
        const float nx = h ? pk.y : pk.x, o = h ? pk.w : pk.z;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float e = KIND == K_CONE ? 1.f : ex2(__fmul_rn(sig, sqd(P[r], q)));
          if (KIND == K_A || KIND == K_F) an[r] = __fmaf_rn(e, nx, an[r]);
          float eo = e;
          if (KIND == K_F) {
            const float e2 = __fmul_rn(e, e);
            eo = __fmul_rn(e2, e2);
          }
          if (KIND == K_F || KIND == K_CEXP) ao[r] = __fmaf_rn(eo, o, ao[r]);
          if (GRAD && KIND != K_A) add_unit(g[r], eo * o, P[r], q);
        }
      }
    }
    if (KIND == K_A || KIND == K_F) combine(an, s.scratch, G, RT);
    if (KIND == K_F || KIND == K_CEXP) combine(ao, s.scratch, G, RT);
    if (GRAD && KIND != K_A) combine3(g, s.scratch, G, RT);
    if (grp == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int i = base + rt + r * RT;
        if (i < cx.r1) row_fin<false, GRAD>(s, cx, KIND, i, an[r], ao[r], g[r], S, gx);
      }
    }
  }
}

// columns [c0, c1) over every row: cs, cdist, ratio, the next remainr;
// returns this thread's share of the level's cost. ZERO: level 0 (no exp)
template <bool ZERO, bool GRAD>
__device__ float cols_exact(const Sm& s, const Ctx& cx, int N, float sig, float* gy) {
  const int nc = cx.c1 - cx.c0;
  float part = 0.f;
  if (nc <= 0) return part;
  const int RT = group_threads(nc), G = THREADS / RT;
  const int grp = threadIdx.x / RT, rt = threadIdx.x % RT;
  const int per = (N + G - 1) / G;
  const int i0 = min(N, grp * per), i1 = min(N, i0 + per);
  for (int base = cx.c0; base < cx.c1; base += RT * R) {
    float4 Q[R];
    float cs[R], cd[R];
    float3 g[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      Q[r] = s.yp[min(base + rt + r * RT, cx.c1 - 1)];
      cs[r] = cd[r] = 0.f;
      g[r] = make_float3(0.f, 0.f, 0.f);
    }
    for (int i = i0; i < i1; ++i) {
      const float4 p = s.xp[i];
      const float sc = s.scale[i];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d = sqd(p, Q[r]);
        const float u = ZERO ? sc : __fmul_rn(ex2(__fmul_rn(sig, d)), sc);
        cs[r] = __fadd_rn(cs[r], u);
        cd[r] = __fmaf_rn(u, sqrt_a(d), cd[r]);
        if (GRAD) add_unit(g[r], u, Q[r], p);
      }
    }
    combine(cs, s.scratch, G, RT);
    combine(cd, s.scratch, G, RT);
    if (GRAD) combine3(g, s.scratch, G, RT);
    if (grp == 0) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int j = base + rt + r * RT;
        if (j < cx.c1) {
          const float rr = s.nx(j);
          part = __fadd_rn(part, col_fin<false, GRAD>(s, cx, j, rr, __fmul_rn(cs[r], rr),
                                                     __fmul_rn(cd[r], rr), g[r], gy));
        }
      }
    }
  }
  return part;
}

// ---- fast sweeps (tensor cores)

// the A operand of a point's k = 2t, 2t+1 for d: (x0, x1), (x2, 1), (1, 1), 0
__device__ __forceinline__ uint32_t feat_a(const uint32_t* w, int i, int t) {
  const uint32_t v = w[i * 4 + min(t, 1)];
  return t == 0 ? v : t == 1 ? (v & 0xffffu) | 0x3F800000u : t == 2 ? ONES2 : 0u;
}
// the point's f32 norm, hi + (mid + lo)
__device__ __forceinline__ float feat_norm(const uint32_t* w, int i) {
  const uint32_t w1 = w[i * 4 + 1], w2 = w[i * 4 + 2];
  return __fadd_rn(hi_f(w1), __fadd_rn(lo_f(w2), hi_f(w2)));
}

// Both fast sweeps walk the other side two tiles at a time into two sets of
// accumulators (even and odd tiles), added at the strip's end: the two
// tiles' chains (d product, conversions, ex2, sum product) interleave.

// rows [r0, r1) in strips of 16, one warp a strip: K_A, K_F or K_CEXP
template <int KIND>
__device__ void rows_fast(const Sm& s, const Ctx& cx, int mp, float sig, float S) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(s.xp);
  const uint32_t* yw = reinterpret_cast<const uint32_t*>(s.yp);
  const float4* pk4 = reinterpret_cast<const float4*>(s.pack);
  const uint32_t* pr = s.parts + min(g, 2) * s.ps;
  const uint32_t ob = g == 0 ? ONES2 : 0u;
  constexpr bool NEW = KIND == K_A || KIND == K_F, OLD = KIND == K_F || KIND == K_CEXP;
  const int s1 = (cx.r1 + UNIT - 1) / UNIT;
  for (int st = cx.r0 / UNIT + (int)threadIdx.x / 32; st < s1; st += WARPS) {
    const int i0 = st * UNIT;
    const uint32_t a0 = feat_a(xw, i0 + g, t), a1 = feat_a(xw, i0 + g + 8, t);
    const float na = feat_norm(xw, i0 + g), nb = feat_norm(xw, i0 + g + 8);
    const float c[4] = {na, na, nb, nb};
    float dn[2][4] = {}, dold[2][4] = {};
    auto tile = [&](int j0, float (&an)[4], float (&ao)[4]) {
      float d0[4], d1[4];
      mma_k8(d0, a0, a1, yw[(j0 + g) * 4 + t], c);
      mma_k8(d1, a0, a1, yw[(j0 + 8 + g) * 4 + t], c);
      // q[0]: row g, columns j0+2t, +1; q[1]: row g+8; q[2], q[3]: columns j0+8+2t, +1
      float db[8];
      const uint32_t q[4] = {pack2_relu(d0[0], d0[1]), pack2_relu(d0[2], d0[3]),
                             pack2_relu(d1[0], d1[1]), pack2_relu(d1[2], d1[3])};
#pragma unroll
      for (int k = 0; k < 4; ++k) db[2 * k] = lo_f(q[k]), db[2 * k + 1] = hi_f(q[k]);
      const float4 v0 = pk4[(j0 >> 1) + t], v1 = pk4[(j0 >> 1) + 4 + t];
      float e[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) e[k] = ex2(__fmul_rn(sig, db[k]));
      if (NEW) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4& v = k < 2 ? v0 : v1;
          w[k] = pack2(__fmul_rn(e[2 * k], v.x), __fmul_rn(e[2 * k + 1], v.y));
        }
        mma_k16(an, w[0], w[1], w[2], w[3], ob, ob);
      }
      if (OLD) {
        uint32_t w[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float4& v = k < 2 ? v0 : v1;
          float e0 = e[2 * k], e1 = e[2 * k + 1];
          if (KIND == K_F) {
            e0 = __fmul_rn(e0, e0);
            e1 = __fmul_rn(e1, e1);
            e0 = __fmul_rn(e0, e0);
            e1 = __fmul_rn(e1, e1);
          }
          w[k] = pack2(__fmul_rn(e0, v.z), __fmul_rn(e1, v.w));
        }
        const uint32_t b0 = g < 3 ? pr[(j0 >> 1) + t] : 0u, b1 = g < 3 ? pr[(j0 >> 1) + 4 + t] : 0u;
        mma_k16(ao, w[0], w[1], w[2], w[3], b0, b1);
      }
    };
    int j0 = 0;
    for (; j0 + 32 <= mp; j0 += 32) {
      tile(j0, dn[0], dold[0]);
      tile(j0 + 16, dn[1], dold[1]);
    }
    if (j0 < mp) tile(j0, dn[0], dold[0]);
    float sn[4], so[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      sn[k] = __fadd_rn(dn[0][k], dn[1][k]);
      so[k] = __fadd_rn(dold[0][k], dold[1][k]);
    }
    // column 0 of sn: the row sums (lanes t = 0); columns 0, 1, 2 of so: the
    // ratio's hi, mid and lo parts (t = 0 holds 0 and 1, t = 1 holds 2)
    const float lo_g = __shfl_down_sync(0xffffffffu, so[0], 1);
    const float lo_g8 = __shfl_down_sync(0xffffffffu, so[2], 1);
    if (t == 0) {
      const float3 z = make_float3(0.f, 0.f, 0.f);
      if (i0 + g < cx.r1)
        row_fin<true, false>(s, cx, KIND, i0 + g, sn[0], __fadd_rn(__fadd_rn(so[0], so[1]), lo_g),
                             z, S, nullptr);
      if (i0 + g + 8 < cx.r1)
        row_fin<true, false>(s, cx, KIND, i0 + g + 8, sn[2], __fadd_rn(__fadd_rn(so[2], so[3]), lo_g8),
                             z, S, nullptr);
    }
  }
}

// columns [c0, c1) in strips of 16, one warp a strip, over every row;
// returns this thread's share of the level's cost. ZERO: level 0 (no exp)
template <bool ZERO>
__device__ float cols_fast(const Sm& s, const Ctx& cx, int np, float sig) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const uint32_t* xw = reinterpret_cast<const uint32_t*>(s.xp);
  const uint32_t* yw = reinterpret_cast<const uint32_t*>(s.yp);
  const uint32_t* sw = reinterpret_cast<const uint32_t*>(s.scaleb);
  const uint32_t ob = g == 0 ? ONES2 : 0u;
  float part = 0.f;
  const int s1 = (cx.c1 + UNIT - 1) / UNIT;
  for (int st = cx.c0 / UNIT + (int)threadIdx.x / 32; st < s1; st += WARPS) {
    const int j0 = st * UNIT;
    const uint32_t a0 = feat_a(yw, j0 + g, t), a1 = feat_a(yw, j0 + g + 8, t);
    const float na = feat_norm(yw, j0 + g), nb = feat_norm(yw, j0 + g + 8);
    const float c[4] = {na, na, nb, nb};
    const float rra = s.nx(j0 + g), rrb = s.nx(j0 + g + 8);
    const uint32_t wa = pack2(rra, rra), wb = pack2(rrb, rrb);   // level 0: w = remainr
    const float lra = lg2(rra), lrb = lg2(rrb);
    float cs[2][4] = {}, cd[2][4] = {};
    auto tile = [&](int i0, float (&as)[4], float (&ad)[4]) {
      float d0[4], d1[4];
      mma_k8(d0, a0, a1, xw[(i0 + g) * 4 + t], c);
      mma_k8(d1, a0, a1, xw[(i0 + 8 + g) * 4 + t], c);
      // q[0]: column g, rows i0+2t, +1; q[1]: column g+8; q[2], q[3]: rows i0+8+2t, +1
      float db[8];
      const uint32_t q[4] = {pack2_relu(d0[0], d0[1]), pack2_relu(d0[2], d0[3]),
                             pack2_relu(d1[0], d1[1]), pack2_relu(d1[2], d1[3])};
#pragma unroll
      for (int k = 0; k < 4; ++k) db[2 * k] = lo_f(q[k]), db[2 * k + 1] = hi_f(q[k]);
      const uint32_t sc0 = sw[(i0 >> 1) + t], sc1 = sw[(i0 >> 1) + 4 + t];
      uint32_t ss[4], tm[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float db0 = db[2 * k], db1 = db[2 * k + 1];
        uint32_t w = k & 1 ? wb : wa;
        if (!ZERO) {
          // exp(L d) remainr as one ex2 of s d + log2(remainr)
          const float lr = k & 1 ? lrb : lra;
          w = pack2(ex2(__fmaf_rn(sig, db0, lr)), ex2(__fmaf_rn(sig, db1, lr)));
        }
        ss[k] = mul_bf2(w, k < 2 ? sc0 : sc1);
        tm[k] = pack2(__fmul_rn(lo_f(ss[k]), sqrt_a(db0)), __fmul_rn(hi_f(ss[k]), sqrt_a(db1)));
      }
      mma_k16(as, ss[0], ss[1], ss[2], ss[3], ob, ob);
      mma_k16(ad, tm[0], tm[1], tm[2], tm[3], ob, ob);
    };
    int i0 = 0;
    for (; i0 + 32 <= np; i0 += 32) {
      tile(i0, cs[0], cd[0]);
      tile(i0 + 16, cs[1], cd[1]);
    }
    if (i0 < np) tile(i0, cs[0], cd[0]);
    if (t == 0) {
      const float3 z = make_float3(0.f, 0.f, 0.f);
      if (j0 + g < cx.c1)
        part = __fadd_rn(part, col_fin<true, false>(s, cx, j0 + g, rra, __fadd_rn(cs[0][0], cs[1][0]),
                                                    __fadd_rn(cd[0][0], cd[1][0]), z, nullptr));
      if (j0 + g + 8 < cx.c1)
        part = __fadd_rn(part, col_fin<true, false>(s, cx, j0 + g + 8, rrb, __fadd_rn(cs[0][2], cs[1][2]),
                                                    __fadd_rn(cd[0][2], cd[1][2]), z, nullptr));
    }
  }
  return part;
}

// ---- the kernel

// [n, 3] f32 -> dst[npad]: exact (x, y, z, |p|^2); fast 8 bf16 (k x, k y,
// k z, the norm's hi, mid, lo, 0, 0) with k = 1 (left) or -2 (right), the
// coordinates rounded to bf16 after the norm is taken; padding zero
template <bool FAST>
__device__ void load_cloud(float4* dst, const float* __restrict__ src, int n, int npad, float k) {
  for (int i = threadIdx.x; i < npad; i += THREADS) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (i < n) {
      const float a = src[3 * i], b = src[3 * i + 1], c = src[3 * i + 2];
      const float nrm = __fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)), __fmul_rn(c, c));
      if (!FAST) {
        v = make_float4(a, b, c, nrm);
      } else {
        const float hi = rnd<__nv_bfloat16>(nrm), r1 = __fsub_rn(nrm, hi);
        const float mid = rnd<__nv_bfloat16>(r1);
        v.x = __uint_as_float(pack2(k * rnd<__nv_bfloat16>(a), k * rnd<__nv_bfloat16>(b)));
        v.y = __uint_as_float(pack2(k * rnd<__nv_bfloat16>(c), hi));
        v.z = __uint_as_float(pack2(mid, __fsub_rn(r1, mid)));
      }
    }
    dst[i] = v;
  }
}

__device__ __forceinline__ float level_of(int k, int n_iters) {
  return k == n_iters - 1 ? 0.f : -ldexpf(1.f, 2 * (n_iters - 3 - k));
}
// the exponent's scale of a level: L log2(e); -1 on level 0 (distances only)
__device__ __forceinline__ float sigma_of(float level) {
  return level == 0.f ? -1.f : __fmul_rn(level, LOG2E);
}

// pair p compares cloud pairs[2p] of xs [*, N, 3] with cloud pairs[2p+1] of
// ys [*, M, 3] on a cluster of C CTAs (blocks C p .. C p + C - 1) and writes
// the matching cost (not yet divided by n) at p; GRAD also its gradients (not
// yet divided by n) at gx [p, N, 3], gy [p, M, 3]
template <bool FAST, bool GRAD>
__global__ void __launch_bounds__(THREADS, GRAD ? 1 : 2)
    emd_kernel(const float* __restrict__ xs, const float* __restrict__ ys, const int* __restrict__ pairs,
               int N, int M, int n_iters, float factorl, float factorr, int C,
               float* __restrict__ cost_out, float* __restrict__ gx, float* __restrict__ gy) {
  static_assert(!(FAST && GRAD), "the gradient mode is exact only");
  extern __shared__ float4 smem[];
  __shared__ float red[WARPS];
  __shared__ float slots[4];
  const Sizes z(N, M);
  const Sm s = carve<FAST>(smem, z);
  Ctx cx;
  cx.C = C;
  cx.rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  slice(N, C, cx.rank, cx.r0, cx.r1);
  slice(M, C, cx.rank, cx.c0, cx.c1);
  const long long p = blockIdx.x / C;
  if (GRAD) {
    gx += p * N * 3;
    gy += p * M * 3;
  }
  load_cloud<FAST>(s.xp, xs + (long long)pairs[2 * p] * N * 3, N, z.np, 1.f);
  load_cloud<FAST>(s.yp, ys + (long long)pairs[2 * p + 1] * M * 3, M, z.mp, -2.f);
  for (int j = threadIdx.x; j < z.mp; j += THREADS) {
    s.nx(j) = j < M ? factorr : 0.f;
    s.o(j) = 0.f;
  }
  for (int i = threadIdx.x; i < z.np; i += THREADS) {
    s.remainl[i] = i < N ? factorl : 0.f;
    s.rowsum[i] = 0.f;
    if (FAST) s.scaleb[i] = 0;
    else s.scale[i] = 0.f;
  }
  if (FAST)
    for (int w = threadIdx.x; w < 3 * z.ps; w += THREADS) s.parts[w] = 0u;
  sync_all(cx);   // every CTA of the cluster runs before any writes into another

  // sum_j remainr_j of the next level (bf16 w in fast mode), one sum for every row
  auto next_sum = [&]() {
    float v = 0.f;
    for (int j = threadIdx.x; j < M; j += THREADS)
      v = __fadd_rn(v, FAST ? rnd<__nv_bfloat16>(s.nx(j)) : s.nx(j));
    return block_sum(v, red);
  };

  float cost = 0.f;
  const float L0 = level_of(0, n_iters);
  if (L0 != 0.f) {
    if (FAST) rows_fast<K_A>(s, cx, z.mp, sigma_of(L0), 0.f);
    else rows_exact<K_A, GRAD>(s, cx, M, sigma_of(L0), 0.f, gx);
  } else {
    const float S = next_sum();
    for (int i = cx.r0 + threadIdx.x; i < cx.r1; i += THREADS)
      row_fin<FAST, false>(s, cx, K_S, i, 0.f, 0.f, make_float3(0.f, 0.f, 0.f), S, nullptr);
  }
  sync_all(cx);
  for (int k = 0; k < n_iters; ++k) {
    const float level = level_of(k, n_iters), sig = sigma_of(level);
    float part;
    if (FAST) part = level == 0.f ? cols_fast<true>(s, cx, z.np, sig) : cols_fast<false>(s, cx, z.np, sig);
    else part = level == 0.f ? cols_exact<true, GRAD>(s, cx, N, sig, gy)
                             : cols_exact<false, GRAD>(s, cx, N, sig, gy);
    const float lv = block_sum(part, red);
    if (C == 1) cost = __fadd_rn(cost, lv);
    else if (threadIdx.x == 0) cg::this_cluster().map_shared_rank(slots, 0)[cx.rank] = lv;
    sync_all(cx);
    if (C > 1 && cx.rank == 0 && threadIdx.x == 0) {
      float sum = slots[0];
      for (int r = 1; r < C; ++r) sum = __fadd_rn(sum, slots[r]);
      cost = __fadd_rn(cost, sum);
    }
    if (k + 1 < n_iters) {
      const float nxt = level_of(k + 1, n_iters);
      if (nxt != 0.f) {
        if (FAST) rows_fast<K_F>(s, cx, z.mp, sigma_of(nxt), 0.f);
        else rows_exact<K_F, GRAD>(s, cx, M, sigma_of(nxt), 0.f, gx);
      } else {
        const float S = next_sum();
        if (FAST) rows_fast<K_CEXP>(s, cx, z.mp, sig, S);
        else rows_exact<K_CEXP, GRAD>(s, cx, M, sig, S, gx);
      }
      sync_all(cx);
    } else if (GRAD) {
      rows_exact<K_CONE, GRAD>(s, cx, M, sig, 0.f, gx);
    }
  }
  if (cx.rank == 0 && threadIdx.x == 0) cost_out[p] = cost;
}

// CTAs per pair: a cluster of 4 while 4 P CTAs fit on the SMs, of 2 below
// 2 x SMS pairs, else 1; at most one per 16 points of the smaller cloud
int cluster_size(int P, int N, int M) {
  if (P >= 2 * SMS) return 1;
  int C = 4 * P <= SMS ? 4 : 2;
  const int units = (min(N, M) + UNIT - 1) / UNIT;
  while (C > 1 && units < C) C /= 2;
  return C;
}

int smem_bytes(int N, int M) {
  const Sizes z(N, M);
  return z.exact_bytes() > z.fast_bytes() ? z.exact_bytes() : z.fast_bytes();
}

template <bool FAST, bool GRAD>
cudaError_t launch(const float* xs, const float* ys, const int* pairs, int P, int N, int M, int n_iters,
                   float factorl, float factorr, float* cost, float* gx, float* gy,
                   cudaStream_t stream) {
  const Sizes z(N, M);
  const int bytes = FAST ? z.fast_bytes() : z.exact_bytes();
  cudaError_t e = cudaFuncSetAttribute(emd_kernel<FAST, GRAD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  e = cudaLaunchKernelEx(&cfg, emd_kernel<FAST, GRAD>, xs, ys, pairs, N, M, n_iters, factorl, factorr, C,
                         cost, gx, gy);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---- the large-cloud layout (N or M above PAIR_POINTS, up to LARGE_POINTS)
//
// emd_kernel holds both clouds and the per-point vectors in each CTA's
// shared memory: past PAIR_POINTS = 4096 a cloud they do not fit (~780 KB
// at N = M = 15,000). The large layout keeps the same sweeps and moves
// their state to global memory: each cloud is stored once as the sweeps
// read it (load_cloud: float4 with the norm, or fast mode's bf16 features),
// each pair's per-point vectors (pack, remainl, rowsum, scale, the ratio's
// parts) in a slice of scratch, and every sweep is one launch over (pair,
// block of `own` rows or columns), so the launch boundary is the barrier
// that cluster.sync() is in the cluster. A CTA runs the same rows_exact /
// cols_exact / rows_fast / cols_fast on these global arrays (the other side
// read as broadcasts through L1: at most 16 B an element's column, against
// ~15 issued instructions and 1-2 MUFU, so the element loop stays bound by
// its issue and its MUFU). A pair's two clouds (480 KB at 15,000 points)
// stay in L2. Per pair and level: one columns launch and one rows launch, 2
// n_iters + 1 sweeps in all, plus the clouds' and the state's set-up and the
// cost's sum.
//   * `own` (large_own) depends on P, N and M alone: 2048 points a CTA,
//     halved down to 256 while the pairs give fewer than 2 x 132 CTAs.
//     Within a CTA the split into groups (group_threads) follows from it. So
//     the GRAD and plain launches of the same pairs sum in the same order,
//     and the GRAD launch's cost equals the plain launch's bit for bit.
//   * The level's cost: each columns CTA's block_sum, stored; emd_large_cost
//     adds them per level in block order and the levels in order, as rank 0
//     adds the cluster's. No atomics: bit-identical from run to run.
//   * Pairs go in chunks whose state stays within LARGE_STATE bytes (the
//     chunk, and so `own`, again a function of P, N and M).

constexpr int PAIR_POINTS = 4096;                // emd_kernel's largest cloud (chamfer.PAIR_POINTS)
constexpr int LARGE_POINTS = 16384;              // the large layout's (chamfer.MAX_POINTS)
constexpr long long LARGE_STATE = 1ll << 28;     // bytes of a chunk's per-pair state (256 MB)

__host__ __device__ inline bool large_layout(int N, int M) { return N > PAIR_POINTS || M > PAIR_POINTS; }
__host__ __device__ inline long long round_up16(long long v) { return (v + 15) / 16 * 16; }

// a pair's state: pack (8 B a column), remainl and rowsum (8 B a row), then
// exact: scale (4 B a row); fast: the ratio's parts (12 ps B), scaleb (2 B a row)
__host__ __device__ inline long long state_bytes(const Sizes& z, bool fast) {
  return round_up16(8ll * z.mp + 8ll * z.np + (fast ? 12ll * z.ps + 2ll * z.np : 4ll * z.np));
}

// points a sweep's CTA owns: 2048, halved down to 256 while P pairs give
// fewer than 2 x SMS CTAs
int large_own(int P, int N, int M) {
  int own = 2048;
  const int n = N < M ? N : M;
  while (own > 256 && (long long)P * ((n + own - 1) / own) < 2 * SMS) own /= 2;
  return own;
}

// pairs in a chunk: its state within LARGE_STATE
int large_chunk(int P, int N, int M, bool fast) {
  const long long c = LARGE_STATE / state_bytes(Sizes(N, M), fast);
  return c < 1 ? 1 : c < P ? (int)c : P;
}

template <bool FAST>
__device__ Sm large_sm(char* st, const Sizes& z, const float4* xp, const float4* yp, float* scratch) {
  Sm s;
  s.ps = z.ps;
  s.xp = const_cast<float4*>(xp);
  s.yp = const_cast<float4*>(yp);
  s.pack = reinterpret_cast<float*>(st);
  s.remainl = s.pack + 2 * z.mp;
  s.rowsum = s.remainl + z.np;
  s.scale = nullptr;
  s.scaleb = nullptr;
  s.parts = nullptr;
  s.scratch = scratch;
  if (FAST) {
    s.parts = reinterpret_cast<uint32_t*>(s.rowsum + z.np);
    s.scaleb = reinterpret_cast<uint16_t*>(s.parts + 3 * z.ps);
  } else {
    s.scale = s.rowsum + z.np;
  }
  return s;
}

// block c < S1: left cloud c into xq [S1, np]; else right cloud c - S1 into
// yq [S2, mp], as emd_kernel loads them
template <bool FAST>
__global__ void __launch_bounds__(THREADS) emd_large_prep(const float* __restrict__ xs,
                                                          const float* __restrict__ ys, int S1, int N, int M,
                                                          float4* __restrict__ xq, float4* __restrict__ yq) {
  const Sizes z(N, M);
  const long long c = blockIdx.x;
  if (c < S1) load_cloud<FAST>(xq + c * z.np, xs + c * N * 3, N, z.np, 1.f);
  else load_cloud<FAST>(yq + (c - S1) * z.mp, ys + (c - S1) * M * 3, M, z.mp, -2.f);
}

// pair p (one CTA): its state as emd_kernel starts it
template <bool FAST>
__global__ void __launch_bounds__(THREADS) emd_large_init(int N, int M, float factorl, float factorr,
                                                          char* __restrict__ state, long long stride) {
  const Sizes z(N, M);
  const Sm s = large_sm<FAST>(state + blockIdx.x * stride, z, nullptr, nullptr, nullptr);
  for (int j = threadIdx.x; j < z.mp; j += THREADS) {
    s.nx(j) = j < M ? factorr : 0.f;
    s.o(j) = 0.f;
  }
  for (int i = threadIdx.x; i < z.np; i += THREADS) {
    s.remainl[i] = i < N ? factorl : 0.f;
    s.rowsum[i] = 0.f;
    if (FAST) s.scaleb[i] = 0;
    else s.scale[i] = 0.f;
  }
  if (FAST)
    for (int w = threadIdx.x; w < 3 * z.ps; w += THREADS) s.parts[w] = 0u;
}

// sum_j remainr_j of the next level (bf16 w in fast mode), emd_kernel's next_sum
template <bool FAST>
__device__ float large_next_sum(const Sm& s, int M, float* red) {
  float v = 0.f;
  for (int j = threadIdx.x; j < M; j += THREADS) v = __fadd_rn(v, FAST ? rnd<__nv_bfloat16>(s.nx(j)) : s.nx(j));
  return block_sum(v, red);
}

// one rows sweep of KIND on pair p = blockIdx.x / nb, rows (blockIdx.x % nb)
// own ..; the exponent's scale that of level lk (as emd_kernel passes it)
template <bool FAST, bool GRAD, int KIND>
__global__ void __launch_bounds__(THREADS, GRAD ? 1 : 2)
    emd_large_rows(const int* __restrict__ pairs, int N, int M, int n_iters, int lk, int own,
                   const float4* __restrict__ xq, const float4* __restrict__ yq, char* __restrict__ state,
                   long long stride, float* __restrict__ gx) {
  __shared__ float red[WARPS];
  __shared__ float scratch[R * THREADS];
  const Sizes z(N, M);
  const int nb = (N + own - 1) / own;
  const long long p = blockIdx.x / nb;
  Ctx cx;
  cx.C = 1;
  cx.rank = 0;
  cx.r0 = (int)(blockIdx.x % nb) * own;
  cx.r1 = min(N, cx.r0 + own);
  cx.c0 = cx.c1 = 0;
  const Sm s = large_sm<FAST>(state + p * stride, z, xq + (long long)pairs[2 * p] * z.np,
                              yq + (long long)pairs[2 * p + 1] * z.mp, scratch);
  if (GRAD) gx += p * N * 3;
  const float sig = sigma_of(level_of(lk, n_iters));
  const float S = (KIND == K_CEXP || KIND == K_S) ? large_next_sum<FAST>(s, M, red) : 0.f;
  if constexpr (KIND == K_S) {
    for (int i = cx.r0 + threadIdx.x; i < cx.r1; i += THREADS)
      row_fin<FAST, false>(s, cx, K_S, i, 0.f, 0.f, make_float3(0.f, 0.f, 0.f), S, nullptr);
  } else if constexpr (FAST) {
    rows_fast<KIND>(s, cx, z.mp, sig, S);
  } else {
    rows_exact<KIND, GRAD>(s, cx, M, sig, S, gx);
  }
}

// level k's columns sweep on pair p = blockIdx.x / nb, columns (blockIdx.x %
// nb) own ..: the CTA's share of the level's cost into costs [p, k, nb]
template <bool FAST, bool GRAD, bool ZERO>
__global__ void __launch_bounds__(THREADS, GRAD ? 1 : 2)
    emd_large_cols(const int* __restrict__ pairs, int N, int M, int n_iters, int k, int own,
                   const float4* __restrict__ xq, const float4* __restrict__ yq, char* __restrict__ state,
                   long long stride, float* __restrict__ costs, float* __restrict__ gy) {
  __shared__ float red[WARPS];
  __shared__ float scratch[R * THREADS];
  const Sizes z(N, M);
  const int nb = (M + own - 1) / own, b = (int)(blockIdx.x % nb);
  const long long p = blockIdx.x / nb;
  Ctx cx;
  cx.C = 1;
  cx.rank = 0;
  cx.r0 = cx.r1 = 0;
  cx.c0 = b * own;
  cx.c1 = min(M, cx.c0 + own);
  const Sm s = large_sm<FAST>(state + p * stride, z, xq + (long long)pairs[2 * p] * z.np,
                              yq + (long long)pairs[2 * p + 1] * z.mp, scratch);
  if (GRAD) gy += p * M * 3;
  const float sig = sigma_of(level_of(k, n_iters));
  float part;
  if constexpr (FAST) {
    part = cols_fast<ZERO>(s, cx, z.np, sig);
  } else {
    part = cols_exact<ZERO, GRAD>(s, cx, N, sig, gy);
  }
  const float lv = block_sum(part, red);
  if (threadIdx.x == 0) costs[(p * n_iters + k) * nb + b] = lv;
}

// pair p's cost: per level its columns CTAs' shares added in block order,
// then the levels in order (emd_kernel's rank 0 over the cluster)
__global__ void __launch_bounds__(THREADS) emd_large_cost(int P, int n_iters, int nb,
                                                          const float* __restrict__ costs,
                                                          float* __restrict__ cost) {
  const long long p = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (p >= P) return;
  float c = 0.f;
  for (int k = 0; k < n_iters; ++k) {
    const float* v = costs + (p * n_iters + k) * nb;
    float sum = v[0];
    for (int r = 1; r < nb; ++r) sum = __fadd_rn(sum, v[r]);
    c = __fadd_rn(c, sum);
  }
  cost[p] = c;
}

// level k's L as level_of gives it, on the host (only whether it is 0 matters here)
inline bool level_zero(int k, int n_iters) { return k == n_iters - 1; }

// the large layout's scratch: the clouds (S1 np + S2 mp float4), a chunk's
// costs (n_iters x column blocks a pair) and its pairs' state
long long large_scratch(int S1, int S2, int P, int N, int M, int n_iters, bool fast) {
  const Sizes z(N, M);
  const int chunk = large_chunk(P, N, M, fast), own = large_own(chunk, N, M);
  const long long clouds = 16ll * ((long long)S1 * z.np + (long long)S2 * z.mp);
  const long long costs = round_up16(4ll * chunk * n_iters * ((M + own - 1) / own));
  return clouds + costs + (long long)chunk * state_bytes(z, fast);
}

template <bool FAST, bool GRAD>
cudaError_t launch_large(const float* xs, const float* ys, int S1, int S2, const int* pairs, int P, int N, int M,
                         int n_iters, float factorl, float factorr, float* cost, float* gx, float* gy,
                         char* scratch, cudaStream_t st) {
  const Sizes z(N, M);
  const int chunk = large_chunk(P, N, M, FAST), own = large_own(chunk, N, M);
  const int rb = (N + own - 1) / own, cb = (M + own - 1) / own;
  const long long stride = state_bytes(z, FAST);
  float4* xq = reinterpret_cast<float4*>(scratch);
  float4* yq = xq + (long long)S1 * z.np;
  float* costs = reinterpret_cast<float*>(yq + (long long)S2 * z.mp);
  char* state = reinterpret_cast<char*>(costs) + round_up16(4ll * chunk * n_iters * cb);
  emd_large_prep<FAST><<<S1 + S2, THREADS, 0, st>>>(xs, ys, S1, N, M, xq, yq);
  for (int p0 = 0; p0 < P; p0 += chunk) {
    const int q = P - p0 < chunk ? P - p0 : chunk;
    const int* pr = pairs + 2ll * p0;
    float* gxc = GRAD ? gx + 3ll * p0 * N : nullptr;
    float* gyc = GRAD ? gy + 3ll * p0 * M : nullptr;
    const unsigned rows = (unsigned)((long long)q * rb), cols = (unsigned)((long long)q * cb);
    emd_large_init<FAST><<<q, THREADS, 0, st>>>(N, M, factorl, factorr, state, stride);
    if (!level_zero(0, n_iters))
      emd_large_rows<FAST, GRAD, K_A><<<rows, THREADS, 0, st>>>(pr, N, M, n_iters, 0, own, xq, yq, state, stride, gxc);
    else
      emd_large_rows<FAST, GRAD, K_S><<<rows, THREADS, 0, st>>>(pr, N, M, n_iters, 0, own, xq, yq, state, stride, gxc);
    for (int k = 0; k < n_iters; ++k) {
      if (level_zero(k, n_iters))
        emd_large_cols<FAST, GRAD, true><<<cols, THREADS, 0, st>>>(pr, N, M, n_iters, k, own, xq, yq, state,
                                                                   stride, costs, gyc);
      else
        emd_large_cols<FAST, GRAD, false><<<cols, THREADS, 0, st>>>(pr, N, M, n_iters, k, own, xq, yq, state,
                                                                    stride, costs, gyc);
      if (k + 1 < n_iters) {
        if (!level_zero(k + 1, n_iters))
          emd_large_rows<FAST, GRAD, K_F><<<rows, THREADS, 0, st>>>(pr, N, M, n_iters, k + 1, own, xq, yq, state,
                                                                    stride, gxc);
        else
          emd_large_rows<FAST, GRAD, K_CEXP><<<rows, THREADS, 0, st>>>(pr, N, M, n_iters, k, own, xq, yq, state,
                                                                       stride, gxc);
      } else if constexpr (GRAD) {
        emd_large_rows<FAST, GRAD, K_CONE><<<rows, THREADS, 0, st>>>(pr, N, M, n_iters, k, own, xq, yq, state,
                                                                     stride, gxc);
      }
    }
    emd_large_cost<<<(q + THREADS - 1) / THREADS, THREADS, 0, st>>>(q, n_iters, cb, costs, cost + p0);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" {

// dynamic shared memory of one CTA, the larger of the two modes' (the
// wrapper checks it against the limit)
int dpfx_emd_smem_bytes(int N, int M) { return smem_bytes(N, M); }

// CTAs a launch of P pairs of N x M points gives each pair
int dpfx_emd_cluster_size(int P, int N, int M) { return cluster_size(P, N, M); }

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


// the large layout: its route (1 where N or M is above PAIR_POINTS), the
// points a sweep's CTA owns, the pairs a chunk takes and the scratch bytes
// of a launch over S1 left and S2 right clouds
int dpfx_emd_large(int N, int M) { return large_layout(N, M) ? 1 : 0; }
int dpfx_emd_large_own(int P, int N, int M, int fast) { return large_own(large_chunk(P, N, M, fast), N, M); }
int dpfx_emd_large_chunk(int P, int N, int M, int fast) { return large_chunk(P, N, M, fast); }
long long dpfx_emd_large_scratch_bytes(int S1, int S2, int P, int N, int M, int n_iters, int fast) {
  return large_scratch(S1, S2, P, N, M, n_iters, fast);
}

// dpfx_emd_launch on the large layout: xs [S1, N, 3], ys [S2, M, 3], and
// scratch of dpfx_emd_large_scratch_bytes
int dpfx_emd_large_launch(const float* xs, const float* ys, int S1, int S2, const int* pairs, int P, int N, int M,
                          int n_iters, int fast, float factorl, float factorr, float* cost, float* gx, float* gy,
                          void* scratch, void* stream) {
  if (P <= 0) return 0;
  if (N <= 0 || M <= 0 || N > LARGE_POINTS || M > LARGE_POINTS || n_iters <= 0 || !scratch)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  char* sc = static_cast<char*>(scratch);
  if (gx || gy) {
    if (fast || !gx || !gy) return (int)cudaErrorInvalidValue;
    return launch_large<false, true>(xs, ys, S1, S2, pairs, P, N, M, n_iters, factorl, factorr, cost, gx, gy, sc, s);
  }
  return fast ? launch_large<true, false>(xs, ys, S1, S2, pairs, P, N, M, n_iters, factorl, factorr, cost, gx, gy,
                                          sc, s)
              : launch_large<false, false>(xs, ys, S1, S2, pairs, P, N, M, n_iters, factorl, factorr, cost, gx,
                                           gy, sc, s);
}

}  // extern "C"
