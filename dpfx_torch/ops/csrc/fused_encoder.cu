// Fused PointNet encoder on Hopper (sm_90a): the per-point MLP and the
// max-pool over the points, forward and backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (dpfx/ops/fused_encoder.py:75)
// and `_bwd_kernel` (:98).
//
// Work per point: 2(3 W1 + W1 W2 + ... + W_{L-1} W_L) FLOP forward, 361 kFLOP
// for the flagship's 3 -> 128 -> 128 -> 256 -> 512, 47.3 GFLOP per 64 x 2048
// batch; a dense backward recomputes the chain and adds the cotangent and
// weight-gradient products, about 3x that. The inputs (the cloud, 0.4 MB of
// weights) and outputs are small: the bound is the tensor cores' rate
// (~0.05 ms forward, ~0.14 ms dense backward at 989 TFLOP/s bf16).
//
// bf16 mode, the rows design (`tile_kernel`, `walk_kernel`), for stored
// widths W_1 .. W_{L-1} up to 256 (16 * KMAX) and shared memory that fits:
//   * Rows per warp on mma.sync. A tile is 128 points, 16 per warp. A warp
//     takes its rows through the chain on its own: layer 0 on m16n8k8 (the
//     coordinates, K = 3 padded to 8), every later layer on m16n8k16 with
//     the rows' A fragments in registers (loaded once per layer from the
//     warp's own rows in shared memory, where the previous layer's output
//     was stored in place). Rounding as flax's Dense: the f32 sum rounded to
//     bf16, + bias in bf16, relu that keeps a NaN, so NaN wins the max as in
//     jnp.max.
//   * Weights staged once per block and tile, CH = 32 rows of W_l at a time
//     with cp.async into two buffers (the next chunk lands while this one
//     runs: W_4 alone is 256 KB, above a block's 227 KB), read by every warp
//     through ldmatrix. One block barrier per chunk.
//   * The last layer is never stored: each 32-column chunk folds into the
//     tile's per-feature max and tie count (shuffles across the warp's rows,
//     then the warps in order at the next barrier), written as [B, nt, W]
//     tile partials for the two torch reductions of the wrapper.
//   * The backward walks only the rows the max-pool's cotangent reaches. Its
//     cotangent dg * tie / count * (h_L > 0) is nonzero only on a cloud's
//     critical points (those reaching a live feature's max: a tenth to a
//     fifth of the points at the flagship widths on random weights), and
//     relu' keeps every later cotangent on those rows; every other row adds
//     exactly 0 to every dW, db and dx. So:
//     1. select (`tile_kernel<true>`): the forward's own chain over every
//        tile, bit for bit (the tie test h_L == g is exact), writes each
//        tile's count of critical rows, their point indices and 512-bit
//        tie masks into the tile's own slots, and zeros dx of the others;
//     2. walk (`walk_kernel`): a persistent grid, one block per SM. Every
//        block scans the tiles' counts (one global order: cloud, then
//        point) and takes groups of G = 64 gathered rows, group k on block
//        k mod grid. For a group it recomputes h_1 .. h_{L-1} through the
//        same per-column device code (on a tie h_L == g, so h_L > 0 <=>
//        g > 0 and the widest layer is never recomputed), forms dh_L from
//        the masks, and walks the layers down: dW_{L-1} sparse (dh_L has a
//        few tie bits per row: a warp per feature sums over the rows with
//        its bit, and a later group touches only those rows of the slice),
//        the other dW_l = rnd(dh)^T rnd(h_l) on mma.sync over the group's
//        rows, eight 16 x 16 tiles per warp at a time so that a later
//        group's slice loads are in flight together, every dh_{l-1} =
//        (rnd(dh) W_l) * (h > 0) on mma.sync in place over h with W_l
//        staged 64 rows at a time, then dW_0 and dx (3 wide) on the FMA
//        units. Each block sums its groups into its own slice of a global
//        scratch (the first group stores, later ones add; a block with no
//        group writes zeros);
//     3. `reduce_slices` sums the slices in a fixed order.
//     No host sync (the number of critical rows lives on the device; the
//     grid is fixed) and no float atomics: bit-identical from run to run.
//     When every row is critical the walk takes all B N rows, slower but
//     right. A NaN or inf on a row that reaches no max no longer reaches
//     dW; it still makes g non-finite.
//
// f32 mode, and bf16 beyond the rows design, keep the first, block-wide
// design (`fwd_kernel`, `bwd_kernel`): tiles of 64 (bf16) or 32 (f32)
// points with every activation in shared memory, WMMA or register-tiled
// IEEE f32 FMA products through `gemm` with the weights read from L2, and
// a persistent backward that adds each tile's gradients into its block's
// slice (`gemm_acc`), reduced in the same fixed order.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). Each
// launch returns cudaGetLastError().

#include "dpfx_common.cuh"

// the point layers: weights [W_{l+1}][W_l] and biases [W_{l+1}] in the
// compute dtype, width[0] = 3. A kernel argument, so not in the anonymous
// namespace (nvcc's host stubs cannot name such a type).
namespace dpfx_encoder {
constexpr int MAXL = 8;
struct Layers {
  const void* w[MAXL];
  const void* b[MAXL];
  int width[MAXL + 1];
  int L;
};
}  // namespace dpfx_encoder

namespace {

using namespace dpfx;
using dpfx_encoder::Layers;
using dpfx_encoder::MAXL;

// ------------------------------------------------ the block-wide design
// (f32, and bf16 beyond the rows design)

template <typename S> __host__ __device__ constexpr int tile_t() { return sizeof(S) == 2 ? 64 : 32; }

// shared-memory carve-up, one layout for both kernels
template <typename S>
struct EncSmem {
  int xs, hs[MAXL], ld[MAXL], stage, colpart, total;
  __host__ __device__ EncSmem(const Layers& P) {
    const int T = tile_t<S>();
    int o = 0, wmax = 0;
    xs = o; o += round128(T * 3 * 4);
    for (int l = 0; l < P.L; ++l) {
      ld[l] = P.width[l + 1] + Layout<S>::PAD;
      hs[l] = o;
      o += round128(T * ld[l] * (int)sizeof(S));
      wmax = P.width[l + 1] > wmax ? P.width[l + 1] : wmax;
    }
    stage = o;   o += round128(WARPS * 256 * 4);
    colpart = o; o += round128(T / 16 * wmax * 4);
    total = o;
  }
};

// Dense rounding: the f32 sum rounded to S, + bias in S, relu
template <typename S>
__device__ __forceinline__ S dense_out(float v, S bias) {
  return from_f<S>(relu_nan(to_f(from_f<S>(to_f(from_f<S>(v)) + to_f(bias)))));
}

// the tile's chain: xs [T][3] (f32, zero past N), h_l [T][W_{l+1}] in S
template <typename S>
__device__ void chain(const Layers& P, const EncSmem<S>& L, unsigned char* smem,
                      const float* __restrict__ x, int b, int n0, int N) {
  constexpr int T = tile_t<S>();
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  for (int e = threadIdx.x; e < T * 3; e += THREADS) {
    const int n = n0 + e / 3;
    xs[e] = n < N ? x[((size_t)b * N + n) * 3 + e % 3] : 0.f;
  }
  __syncthreads();
  {
    const S* w0 = static_cast<const S*>(P.w[0]);
    const S* b0 = static_cast<const S*>(P.b[0]);
    S* h = reinterpret_cast<S*>(smem + L.hs[0]);
    const int W = P.width[1], ld = L.ld[0];
    for (int e = threadIdx.x; e < T * W; e += THREADS) {
      const int p = e / W, o = e % W;
      float v = to_f(w0[o * 3 + 0]) * rnd<S>(xs[p * 3 + 0]);
      v = fmaf(to_f(w0[o * 3 + 1]), rnd<S>(xs[p * 3 + 1]), v);
      v = fmaf(to_f(w0[o * 3 + 2]), rnd<S>(xs[p * 3 + 2]), v);
      h[p * ld + o] = dense_out<S>(v, b0[o]);
    }
  }
  for (int l = 1; l < P.L; ++l) {
    __syncthreads();
    const S* in = reinterpret_cast<const S*>(smem + L.hs[l - 1]);
    S* out = reinterpret_cast<S*>(smem + L.hs[l]);
    const S* bl = static_cast<const S*>(P.b[l]);
    const int ldo = L.ld[l];
    gemm<false, true>(T, P.width[l + 1], P.width[l], in, L.ld[l - 1],
                      static_cast<const S*>(P.w[l]), P.width[l], stage, nullptr,
                      [&](int m, int n, float v) {
                        out[m * ldo + n] = dense_out<S>(v, bl[n]);
                        return 0.f;
                      });
  }
  __syncthreads();
}

template <typename S>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ x, Layers P, float* __restrict__ pmax,
           float* __restrict__ pcnt, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int T = tile_t<S>();
  const EncSmem<S> L(P);
  const int b = blockIdx.y, n0 = blockIdx.x * T, nt = gridDim.x;
  chain<S>(P, L, smem, x, b, n0, N);
  const S* h = reinterpret_cast<const S*>(smem + L.hs[P.L - 1]);
  const int W = P.width[P.L], ld = L.ld[P.L - 1];
  const size_t row = ((size_t)b * nt + blockIdx.x) * W;
  for (int f = threadIdx.x; f < W; f += THREADS) {
    float m = -INFINITY;
    for (int p = 0; p < T && n0 + p < N; ++p) {
      const float v = to_f(h[p * ld + f]);
      if (v > m || v != v) m = v;     // a NaN wins, as in jnp.max
    }
    float c = 0.f;
    for (int p = 0; p < T && n0 + p < N; ++p) c += to_f(h[p * ld + f]) == m ? 1.f : 0.f;
    pmax[row + f] = m;
    pcnt[row + f] = c;
  }
}

// add v into this block's slice; the block's first tile stores it
__device__ __forceinline__ void put(float* p, float v, bool first) { *p = first ? v : *p + v; }

template <typename S>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const float* __restrict__ x, Layers P, const float* __restrict__ g,
           const float* __restrict__ cnt, const float* __restrict__ dg, float* __restrict__ dx,
           float* __restrict__ part, int B, int N, long long per_slice) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int T = tile_t<S>();
  const EncSmem<S> L(P);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nt = (N + T - 1) / T;
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* colpart = reinterpret_cast<float*>(smem + L.colpart);
  float* out = part + (size_t)blockIdx.x * per_slice;
  long long off_w[MAXL], off_b[MAXL];
  {
    long long o = 0;
    for (int l = 0; l < P.L; ++l) { off_w[l] = o; o += (long long)P.width[l + 1] * P.width[l]; }
    for (int l = 0; l < P.L; ++l) { off_b[l] = o; o += P.width[l + 1]; }
  }

  for (int tile = blockIdx.x; tile < B * nt; tile += gridDim.x) {
    const int b = tile / nt, n0 = (tile % nt) * T;
    const bool first = tile == blockIdx.x;
    __syncthreads();  // the previous tile is done with the shared buffers and its slice writes
    chain<S>(P, L, smem, x, b, n0, N);

    // the pooled cotangent, in place over h_L: dg * tie / count * (h > 0)
    {
      const int W = P.width[P.L], ld = L.ld[P.L - 1];
      S* h = reinterpret_cast<S*>(smem + L.hs[P.L - 1]);
      for (int f = tid; f < W; f += THREADS) {
        const float gv = g[(size_t)b * W + f], dgv = dg[(size_t)b * W + f];
        const float cv = fmaxf(cnt[(size_t)b * W + f], 1.f);
        float s = 0.f;
        for (int p = 0; p < T; ++p) {
          const float hv = to_f(h[p * ld + f]);
          const float tie = (n0 + p < N && hv == gv) ? 1.f : 0.f;
          const float d = dgv * tie / cv * (hv > 0.f ? 1.f : 0.f);
          s += d;
          h[p * ld + f] = from_f<S>(d);
        }
        put(out + off_b[P.L - 1] + f, s, first);
      }
    }

    for (int l = P.L - 1; l >= 0; --l) {
      // dh: the cotangent of layer l's output, in the buffer of h_{l+1}
      const S* dh = reinterpret_cast<const S*>(smem + L.hs[l]);
      const int ldd = L.ld[l], Wo = P.width[l + 1], Wi = P.width[l];
      float* dw = out + off_w[l];
      __syncthreads();
      if (l > 0) {
        const S* hin = reinterpret_cast<const S*>(smem + L.hs[l - 1]);
        // dW_l += rnd(dh)^T rnd(h_l)
        gemm_acc<true, false>(Wo, Wi, T, dh, ldd, hin, L.ld[l - 1], dw, Wi, first);
        __syncthreads();
        // dh_in = (rnd(dh) W_l) * (h_l > 0), in place over h_l
        S* hw = reinterpret_cast<S*>(smem + L.hs[l - 1]);
        const int ldi = L.ld[l - 1];
        gemm<false, false>(T, Wi, Wo, dh, ldd, static_cast<const S*>(P.w[l]), Wi, stage,
                           colpart, [&](int m, int n, float v) {
                             const float mv = v * (to_f(hw[m * ldi + n]) > 0.f ? 1.f : 0.f);
                             hw[m * ldi + n] = from_f<S>(mv);
                             return mv;
                           });
        __syncthreads();
        column_sums<S>(T, Wi, colpart, hw, ldi, out + off_b[l - 1], !first);
      } else {
        // dW_0 += rnd(dh)^T rnd(x); dx = rnd(dh) rnd(W_0), one warp per point
        for (int e = tid; e < Wo * 3; e += THREADS) {
          const int o = e / 3, c = e % 3;
          float s = 0.f;
          for (int p = 0; p < T; ++p) s = fmaf(to_f(dh[p * ldd + o]), rnd<S>(xs[p * 3 + c]), s);
          put(dw + e, s, first);
        }
        const S* w0 = static_cast<const S*>(P.w[0]);
        for (int p = warp; p < T; p += WARPS) {
          float s[3] = {0.f, 0.f, 0.f};
          for (int o = lane; o < Wo; o += 32) {
            const float d = to_f(dh[p * ldd + o]);
            for (int c = 0; c < 3; ++c) s[c] = fmaf(to_f(w0[o * 3 + c]), d, s[c]);
          }
          for (int c = 0; c < 3; ++c)
            for (int off = 16; off; off >>= 1) s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
          if (lane == 0 && n0 + p < N)
            for (int c = 0; c < 3; ++c) dx[((size_t)b * N + n0 + p) * 3 + c] = s[c];
        }
      }
    }
  }
}


// ------------------------------------------------ bf16: the rows design

using bf16 = __nv_bfloat16;

constexpr int RT = 128;            // points per tile, 16 per warp
constexpr int KMAX = 16;           // 16-wide column chunks of the widest stored layer
constexpr int CH = 32;             // weight rows per staged chunk (one tie-mask word)
constexpr int G = 64;              // gathered rows per walk group
constexpr int WCH = 64;            // weight rows per staged chunk of the walk
constexpr int DW_TILES = 8;        // dW tiles a warp takes at once (slice loads in flight)
constexpr int SMEM_MAX = 232448;   // bytes of shared memory a block may use (sm_90)

__host__ __device__ inline int chunks(int w, int ch = CH) { return (w + ch - 1) / ch; }
__host__ __device__ inline int mask_words(const Layers& P) { return chunks(P.width[P.L]); }
// the widest stored activation h_1 .. h_{L-1} (0 for one layer)
__host__ __device__ inline int stored_max(const Layers& P) {
  int w = 0;
  for (int l = 1; l < P.L; ++l) w = P.width[l] > w ? P.width[l] : w;
  return w;
}

// shared memory of the tile kernel (forward or select): each warp's rows
// [16][ldr] (the current layer's output, stored in place), two weight
// stages [CH][lds], W_0^T [8][ld0], and the forward's per-warp max partials
// of two chunks or the select's tie masks [RT][MW] and slots
struct TileSmem {
  int rows, ldr, stage, lds, w0t, ld0, part, mask, slot, total;
  __host__ __device__ TileSmem(const Layers& P, bool select) {
    ldr = lds = stored_max(P) + 8;
    ld0 = P.width[1] + 8;
    int o = 0;
    rows = o;  o += round128(WARPS * 16 * ldr * 2);
    stage = o; o += P.L > 1 ? round128(2 * CH * lds * 2) : 0;
    w0t = o;   o += round128(8 * ld0 * 2);
    part = mask = slot = o;
    if (select) {
      mask = o; o += round128(RT * mask_words(P) * 4);
      slot = o; o += round128(RT * 4);
    } else {
      part = o; o += round128(2 * WARPS * CH * 8);
    }
    total = o;
  }
};

// shared memory of the walk: the group's h_1 .. h_{L-1} [G][ldh] (each
// overwritten by its cotangent), rnd(dh_L) [G][ldt], two weight stages,
// W_0^T, the rows' tie masks, x, cloud and point, and the column sums of
// the four row warps
struct WalkSmem {
  int hb[MAXL], ldh[MAXL], dtop, ldt, stage, lds, w0t, ld0, mask, colpart, xs, rb, rn, rtile,
      rslot, wsum, total;
  __host__ __device__ WalkSmem(const Layers& P) {
    lds = stored_max(P) + 8;
    ld0 = P.width[1] + 8;
    ldt = P.width[P.L] + 8;
    int o = 0;
    for (int l = 1; l < P.L; ++l) {
      ldh[l] = P.width[l] + 8;
      hb[l] = o; o += round128(G * ldh[l] * 2);
    }
    dtop = o;    o += round128(G * ldt * 2);
    stage = o;   o += P.L > 1 ? round128(2 * WCH * lds * 2) : 0;
    w0t = o;     o += round128(8 * ld0 * 2);
    mask = o;    o += round128(G * mask_words(P) * 4);
    colpart = o; o += round128(4 * (stored_max(P) + 1) * 4);
    xs = o;      o += round128(G * 3 * 4);
    rb = o;      o += round128(G * 4);
    rn = o;      o += round128(G * 4);
    rtile = o;   o += round128(G * 4);
    rslot = o;   o += round128(G * 4);
    wsum = o;    o += round128(WARPS * 4);
    total = o;
  }
};

bool rows_design(const Layers& P) {
  return stored_max(P) <= 16 * KMAX && TileSmem(P, false).total <= SMEM_MAX &&
         TileSmem(P, true).total <= SMEM_MAX && WalkSmem(P).total <= SMEM_MAX;
}

// W_0^T [8][ld0] in shared memory: rows 0-2 the three input columns of
// W_0 [W_1][3], rows 3-7 zero (layer 0's K = 3 padded to 8)
__device__ void load_w0t(bf16* w0t, const bf16* w0, int w1, int ld0) {
  const bf16 z = __float2bfloat16_rn(0.f);
  for (int e = threadIdx.x; e < 8 * ld0; e += THREADS) {
    const int c = e / ld0, o = e % ld0;
    w0t[e] = c < 3 && o < w1 ? w0[o * 3 + c] : z;
  }
}

// start the cp.async copies of rows [ch c, ch c + ch) of W_l [W_{l+1}][W_l]
// into a stage with row stride lds
__device__ void stage_chunk(bf16* st, const Layers& P, int l, int c, int lds, int ch) {
  const int wi = P.width[l], r0 = c * ch, vpr = wi / 8;
  const int nr = min(ch, P.width[l + 1] - r0);
  const bf16* w = static_cast<const bf16*>(P.w[l]) + (size_t)r0 * wi;
  for (int v = threadIdx.x; v < nr * vpr; v += THREADS) {
    const int r = v / vpr, k = (v % vpr) * 8;
    cp_async16(st + r * lds + k, w + (size_t)r * wi + k);
  }
  cp_async_commit();
}

// the A fragments of a warp's 16 rows (row stride ld) over nk 16-wide chunks
__device__ __forceinline__ void load_rows(uint32_t (&a)[KMAX][4], const bf16* rows, int ld,
                                          int nk) {
  const int lane = lane_id();
  const bf16* p = rows + ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
#pragma unroll
  for (int kc = 0; kc < KMAX; ++kc)
    if (kc < nk) ldsm_x4(a[kc], p + 16 * kc);
}

// The per-column products of the chain, shared by the forward, the select
// and the walk's recompute, so that all three give the same bits: output
// columns 16u .. 16u + 15 of a layer as two C tiles, k in order.
// Layer l >= 1: B = 16 staged rows of W_l (k contiguous) from w.
__device__ __forceinline__ void cols16(float (&c0)[4], float (&c1)[4],
                                       const uint32_t (&a)[KMAX][4], int nk, const bf16* w,
                                       int lds) {
  const int lane = lane_id();
  const bf16* p = w + ((lane & 7) + ((lane >> 4) << 3)) * lds + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int i = 0; i < 4; ++i) c0[i] = c1[i] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KMAX; ++kc)
    if (kc < nk) {
      uint32_t b[4];
      ldsm_x4(b, p + 16 * kc);
      mma16(c0, a[kc], b[0], b[1]);
      mma16(c1, a[kc], b[2], b[3]);
    }
}
// layer 0: A the coordinates (k8), B = W_0^T [8][ld0]
__device__ __forceinline__ void cols16_x(float (&c0)[4], float (&c1)[4], uint32_t a0, uint32_t a1,
                                         const bf16* w0t, int ld0, int u) {
  const int lane = lane_id();
  uint32_t b[2];
  ldsm_x2_t(b, w0t + (lane & 7) * ld0 + 16 * u + ((lane >> 3) & 1) * 8);
#pragma unroll
  for (int i = 0; i < 4; ++i) c0[i] = c1[i] = 0.f;
  mma8(c0, a0, a1, b[0]);
  mma8(c1, a0, a1, b[1]);
}

// Dense rounding on the accumulators of columns col0 .. col0 + 15: the f32
// sum rounded to bf16, + bias in bf16, relu that keeps a NaN (each value is
// then exact in bf16)
__device__ __forceinline__ float dense1(float v, float bias) {
  return relu_nan(rnd<bf16>(rnd<bf16>(v) + bias));
}
__device__ __forceinline__ void dense16(float (&c0)[4], float (&c1)[4], const bf16* bias,
                                        int col0) {
  const int t = lane_id() & 3;
  const float2 b0 = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col0 + 2 * t));
  const float2 b1 =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(bias + col0 + 8 + 2 * t));
  c0[0] = dense1(c0[0], b0.x); c0[1] = dense1(c0[1], b0.y);
  c0[2] = dense1(c0[2], b0.x); c0[3] = dense1(c0[3], b0.y);
  c1[0] = dense1(c1[0], b1.x); c1[1] = dense1(c1[1], b1.y);
  c1[2] = dense1(c1[2], b1.x); c1[3] = dense1(c1[3], b1.y);
}

// the two tiles into 16 rows of a shared tile (row stride ld) at column col0
__device__ __forceinline__ void store16(bf16* rows, int ld, int col0, const float (&c0)[4],
                                        const float (&c1)[4]) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  *reinterpret_cast<uint32_t*>(rows + g * ld + col0 + 2 * t) = pack_bf16(c0[0], c0[1]);
  *reinterpret_cast<uint32_t*>(rows + (g + 8) * ld + col0 + 2 * t) = pack_bf16(c0[2], c0[3]);
  *reinterpret_cast<uint32_t*>(rows + g * ld + col0 + 8 + 2 * t) = pack_bf16(c1[0], c1[1]);
  *reinterpret_cast<uint32_t*>(rows + (g + 8) * ld + col0 + 8 + 2 * t) = pack_bf16(c1[2], c1[3]);
}

// (m, c) <- the max of m and m2 (a NaN wins, as in jnp.max) and how many
// values reach it; order-free
__device__ __forceinline__ void merge_max(float& m, float& c, float m2, float c2) {
  const float mm = m2 > m || m2 != m2 ? m2 : m;
  c = (m == mm ? c : 0.f) + (m2 == mm ? c2 : 0.f);
  m = mm;
}

// forward: each of the 16 columns' max over the warp's valid rows (v0: row
// g, v1: row g + 8) and its count, into out[16] (lanes g == 0)
__device__ __forceinline__ void fold16(const float (&c0)[4], const float (&c1)[4], bool v0,
                                       bool v1, float2* out) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const float top[4] = {c0[0], c0[1], c1[0], c1[1]}, bot[4] = {c0[2], c0[3], c1[2], c1[3]};
  const int col[4] = {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    float m = -INFINITY, c = 0.f;
    if (v0) merge_max(m, c, top[j], 1.f);
    if (v1) merge_max(m, c, bot[j], 1.f);
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
      const float c2 = __shfl_xor_sync(0xffffffffu, c, off);
      merge_max(m, c, m2, c2);
    }
    if (g == 0) out[col[j]] = make_float2(m, c);
  }
}

// select: the tie bits h == g, g > 0 of the 16 columns (at bit q0 .. q0 +
// 15 of the chunk's word) for row g (lo) and row g + 8 (hi); gcol = g of
// the cloud at the first column
__device__ __forceinline__ void tie16(const float (&c0)[4], const float (&c1)[4], bool v0,
                                      bool v1, const float* gcol, int q0, uint32_t& lo,
                                      uint32_t& hi) {
  const int t = lane_id() & 3;
  const float top[4] = {c0[0], c0[1], c1[0], c1[1]}, bot[4] = {c0[2], c0[3], c1[2], c1[3]};
  const int col[4] = {2 * t, 2 * t + 1, 8 + 2 * t, 9 + 2 * t};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float gv = gcol[col[j]];
    if (gv > 0.f) {
      if (v0 && top[j] == gv) lo |= 1u << (q0 + col[j]);
      if (v1 && bot[j] == gv) hi |= 1u << (q0 + col[j]);
    }
  }
}

// The forward (SELECT false) and the backward's select (SELECT true) over
// one tile of RT points: grid (ceil(N / RT), B). The forward writes the
// tile's per-feature max and count at that max into pmax, pcnt [B, nt, W_L];
// the select writes the tile's count of critical rows into tcount, their
// point indices (in point order) and tie masks into its slots of tidx
// [B nt][RT] and tmask [B nt][RT][MW], and zeros dx of its other points.
template <bool SELECT>
__global__ void __launch_bounds__(THREADS, 2)
tile_kernel(const float* __restrict__ x, Layers P, float* __restrict__ pmax,
            float* __restrict__ pcnt, const float* __restrict__ gpool, int* __restrict__ tcount,
            int* __restrict__ tidx, uint32_t* __restrict__ tmask, float* __restrict__ dx, int N) {
  extern __shared__ __align__(128) unsigned char smem[];
  const TileSmem S(P, SELECT);
  const int L = P.L, WL = P.width[L], MW = mask_words(P);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y, n0 = blockIdx.x * RT, r0 = warp * 16;
  const size_t tile = (size_t)b * gridDim.x + blockIdx.x;
  bf16* rows = reinterpret_cast<bf16*>(smem + S.rows) + r0 * S.ldr;
  bf16* stage = reinterpret_cast<bf16*>(smem + S.stage);
  const bf16* w0t = reinterpret_cast<const bf16*>(smem + S.w0t);
  float2* part = reinterpret_cast<float2*>(smem + S.part);    // [2][WARPS][CH]
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + S.mask);
  const bool v0 = n0 + r0 + g < N, v1 = n0 + r0 + g + 8 < N;

  if (L > 1) stage_chunk(stage, P, 1, 0, S.lds, CH);
  load_w0t(reinterpret_cast<bf16*>(smem + S.w0t), static_cast<const bf16*>(P.w[0]), P.width[1],
           S.ld0);
  float xv[3];
  {
    const int n = n0 + r0 + (lane & 15);
#pragma unroll
    for (int c = 0; c < 3; ++c) xv[c] = n < N ? x[((size_t)b * N + n) * 3 + c] : 0.f;
  }
  uint32_t a0, a1;
  coord_frag(xv, a0, a1);
  __syncthreads();

  // the forward's partials of chunk c: the warps in order
  auto merge_chunk = [&](int c) {
    const int w = min(CH, WL - c * CH);
    if (tid < w) {
      float m = -INFINITY, k = 0.f;
      for (int q = 0; q < WARPS; ++q) {
        const float2 v = part[((c & 1) * WARPS + q) * CH + tid];
        merge_max(m, k, v.x, v.y);
      }
      pmax[tile * WL + c * CH + tid] = m;
      pcnt[tile * WL + c * CH + tid] = k;
    }
  };

  uint32_t a[KMAX][4];
  int s = 0;   // staged chunks so far
  for (int l = 0; l < L; ++l) {
    const bool last = l == L - 1;
    const int nk = P.width[l] / 16, wo = P.width[l + 1];
    const bf16* bias = static_cast<const bf16*>(P.b[l]);
    float c0[4], c1[4];
    if (l == 0 && !last) {
      for (int u = 0; u < wo / 16; ++u) {
        cols16_x(c0, c1, a0, a1, w0t, S.ld0, u);
        dense16(c0, c1, bias, 16 * u);
        store16(rows, S.ldr, 16 * u, c0, c1);
      }
      continue;
    }
    for (int c = 0; c < chunks(wo); ++c) {
      const bf16* w = nullptr;
      if (l > 0) cp_async_wait_all();
      __syncthreads();   // chunk s landed; every warp is done with the other stage
      if (l > 0) {
        const int nl = c + 1 < chunks(wo) ? l : l + 1, nc = c + 1 < chunks(wo) ? c + 1 : 0;
        if (nl < L) stage_chunk(stage + ((s + 1) & 1) * CH * S.lds, P, nl, nc, S.lds, CH);
        w = stage + (s & 1) * CH * S.lds;
        ++s;
        if (c == 0) {
          __syncwarp();
          load_rows(a, rows, S.ldr, nk);
          __syncwarp();
        }
      }
      if (!SELECT && last && c > 0) merge_chunk(c - 1);
      uint32_t lo = 0, hi = 0;
      for (int u = 0; u < 2 && c * CH + 16 * u < wo; ++u) {
        const int col = c * CH + 16 * u;
        if (l == 0) cols16_x(c0, c1, a0, a1, w0t, S.ld0, 2 * c + u);
        else cols16(c0, c1, a, nk, w + 16 * u * S.lds, S.lds);
        dense16(c0, c1, bias, col);
        if (!last) store16(rows, S.ldr, col, c0, c1);
        else if (SELECT) tie16(c0, c1, v0, v1, gpool + (size_t)b * WL + col, 16 * u, lo, hi);
        else fold16(c0, c1, v0, v1, part + ((c & 1) * WARPS + warp) * CH + 16 * u);
      }
      if (SELECT && last) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          lo |= __shfl_xor_sync(0xffffffffu, lo, off);
          hi |= __shfl_xor_sync(0xffffffffu, hi, off);
        }
        if (t == 0) {
          mask[(r0 + g) * MW + c] = lo;
          mask[(r0 + g + 8) * MW + c] = hi;
        }
      }
    }
  }
  __syncthreads();
  if constexpr (!SELECT) {
    merge_chunk(chunks(WL) - 1);
  } else {
    // the tile's critical rows in point order: valid, with a tie bit
    int* slot = reinterpret_cast<int*>(smem + S.slot);
    if (warp == 0) {
      int base = 0;
      for (int q = 0; q < RT / 32; ++q) {
        const int r = 32 * q + lane;
        bool crit = false;
        if (n0 + r < N)
          for (int w = 0; w < MW; ++w) crit |= mask[r * MW + w] != 0u;
        const unsigned bal = __ballot_sync(0xffffffffu, crit);
        slot[r] = crit ? base + __popc(bal & ((1u << lane) - 1u)) : -1;
        base += __popc(bal);
      }
      if (lane == 0) tcount[tile] = base;
    }
    __syncthreads();
    for (int e = tid; e < RT * MW; e += THREADS) {
      const int sl = slot[e / MW];
      if (sl >= 0) tmask[(tile * RT + sl) * MW + e % MW] = mask[e];
    }
    for (int r = tid; r < RT; r += THREADS) {
      if (slot[r] >= 0) {
        tidx[tile * RT + slot[r]] = n0 + r;
      } else if (n0 + r < N) {
        for (int c = 0; c < 3; ++c) dx[((size_t)b * N + n0 + r) * 3 + c] = 0.f;
      }
    }
  }
}

// store v into this block's slice (its first group) or add it
__device__ __forceinline__ void put2(float* p, float v0, float v1, bool first) {
  float2* q = reinterpret_cast<float2*>(p);
  if (first) {
    *q = make_float2(v0, v1);
  } else {
    const float2 o = *q;
    *q = make_float2(o.x + v0, o.y + v1);
  }
}

// dW [wo][wi] (+)= rnd(dh)^T rnd(h) over the group's G rows: dh [G][wo],
// h [G][wi] in shared memory (points as the K dimension, ldmatrix.trans),
// 16 x 16 tiles of dW, DW_TILES per warp at a time: a later group's slice
// values are loaded for all of them before their products
__device__ void dw_product(float* dw, const bf16* dh, int ldd, const bf16* h, int ldh, int wo,
                           int wi, bool first) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int nt = wi / 16, total = (wo / 16) * nt;
  auto at = [&](int tt) { return dw + (size_t)(16 * (tt / nt) + g) * wi + 16 * (tt % nt) + 2 * t; };
  for (int t0 = threadIdx.x / 32; t0 < total; t0 += DW_TILES * WARPS) {
    float2 prev[DW_TILES][4];
#pragma unroll
    for (int u = 0; u < DW_TILES; ++u) {
      const int tt = t0 + u * WARPS;
      if (first || tt >= total) continue;
      const float* p = at(tt);
      prev[u][0] = *reinterpret_cast<const float2*>(p);
      prev[u][1] = *reinterpret_cast<const float2*>(p + 8 * (size_t)wi);
      prev[u][2] = *reinterpret_cast<const float2*>(p + 8);
      prev[u][3] = *reinterpret_cast<const float2*>(p + 8 * (size_t)wi + 8);
    }
#pragma unroll
    for (int u = 0; u < DW_TILES; ++u) {
      const int tt = t0 + u * WARPS;
      if (tt >= total) break;
      const int tm = tt / nt, tn = tt % nt;
      float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < G / 16; ++kk) {
        uint32_t a[4], bq[4];
        ldsm_x4_t(a, dh + (16 * kk + (lane & 7) + ((lane >> 4) & 1) * 8) * ldd + 16 * tm +
                         ((lane >> 3) & 1) * 8);
        ldsm_x4_t(bq, h + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * ldh + 16 * tn +
                          (lane >> 4) * 8);
        mma16(c0, a, bq[0], bq[1]);
        mma16(c1, a, bq[2], bq[3]);
      }
      float2 v[4] = {make_float2(c0[0], c0[1]), make_float2(c0[2], c0[3]),
                     make_float2(c1[0], c1[1]), make_float2(c1[2], c1[3])};
      if (!first)
#pragma unroll
        for (int i = 0; i < 4; ++i) v[i] = make_float2(prev[u][i].x + v[i].x, prev[u][i].y + v[i].y);
      float* p = at(tt);
      *reinterpret_cast<float2*>(p) = v[0];
      *reinterpret_cast<float2*>(p + 8 * (size_t)wi) = v[1];
      *reinterpret_cast<float2*>(p + 8) = v[2];
      *reinterpret_cast<float2*>(p + 8 * (size_t)wi + 8) = v[3];
    }
  }
}

// dW_{L-1} [wl][wi] (+)= rnd(dh_L)^T rnd(h_{L-1}) over the group's G = 64
// rows. dh_L is nonzero only at the rows' tie bits (a few per row), so a
// warp per feature sums rnd(dh_L) times h over the rows with that bit, in
// row order (FMA, the products exact as on the tensor cores); the first
// group writes every row of dW_{L-1}, a later one adds into the rows its
// bits reach and leaves the others. mask is word-major, [MW][G].
__device__ void dw_top(float* dw, const uint32_t* mask, const bf16* dtop, int ldt, const bf16* h,
                       int ldh, int wl, int wi, bool first) {
  static_assert(G == 64, "two ballots cover a group's rows");
  const int lane = lane_id();
  for (int w = threadIdx.x / 32; w < chunks(wl); w += WARPS) {
    const uint32_t lo = mask[w * G + lane], hi = mask[w * G + 32 + lane];
    for (int bit = 0; bit < 32 && 32 * w + bit < wl; ++bit) {
      const int f = 32 * w + bit;
      const unsigned m0 = __ballot_sync(0xffffffffu, (lo >> bit) & 1u);
      const unsigned m1 = __ballot_sync(0xffffffffu, (hi >> bit) & 1u);
      if (!first && !(m0 | m1)) continue;
      float acc[KMAX / 2];
#pragma unroll
      for (int j = 0; j < KMAX / 2; ++j) acc[j] = 0.f;
      for (int q = 0; q < 2; ++q)
        for (unsigned m = q ? m1 : m0; m; m &= m - 1) {
          const int r = 32 * q + __ffs(m) - 1;
          const float c = __bfloat162float(dtop[r * ldt + f]);
#pragma unroll
          for (int j = 0; j < KMAX / 2; ++j)
            if (32 * j + lane < wi)
              acc[j] = fmaf(c, __bfloat162float(h[r * ldh + 32 * j + lane]), acc[j]);
        }
#pragma unroll
      for (int j = 0; j < KMAX / 2; ++j)
        if (32 * j + lane < wi) {
          float* p = dw + (size_t)f * wi + 32 * j + lane;
          *p = first ? acc[j] : *p + acc[j];
        }
    }
  }
}

// dh_{l-1} = (rnd(dh_l) W_l) * (h_l > 0) over the group's rows on mma.sync,
// in place over h_l (hb, row stride ld): K (W_{l+1}, the columns of dsrc)
// in staged chunks of WCH rows of W_l (next_stage waits for the next one);
// a warp takes its 16 rows and the 16-column units of its parity;
// colpart[row warp] gets the column sums of its rows
template <typename Next>
__device__ void cotangent(Next next_stage, const bf16* dsrc, int ldd, bf16* hb, int ld,
                          int wo, int wi, int lds, float* colpart, int ws) {
  const int lane = lane_id(), warp = threadIdx.x / 32, g = lane >> 2, t = lane & 3;
  const int rw = (warp & 3) * 16, half = warp >> 2, nu = wi / 16;
  float acc[KMAX / 2][2][4];
#pragma unroll
  for (int j = 0; j < KMAX / 2; ++j)
#pragma unroll
    for (int i = 0; i < 4; ++i) acc[j][0][i] = acc[j][1][i] = 0.f;
  for (int c = 0; c < chunks(wo, WCH); ++c) {
    const bf16* w = next_stage();   // its barrier also ends dw_product's reads of h_l
    for (int j = 0; j < WCH / 16 && c * WCH + 16 * j < wo; ++j) {
      uint32_t av[4];
      ldsm_x4(av, dsrc + (rw + (lane & 7) + ((lane >> 3) & 1) * 8) * ldd + c * WCH + 16 * j +
                      (lane >> 4) * 8);
#pragma unroll
      for (int jj = 0; jj < KMAX / 2; ++jj) {
        const int u = half + 2 * jj;
        if (u < nu) {
          uint32_t bq[4];
          ldsm_x4_t(bq, w + (16 * j + (lane & 7) + ((lane >> 3) & 1) * 8) * lds + 16 * u +
                            (lane >> 4) * 8);
          mma16(acc[jj][0], av, bq[0], bq[1]);
          mma16(acc[jj][1], av, bq[2], bq[3]);
        }
      }
    }
  }
  bf16* h = hb + rw * ld;
#pragma unroll
  for (int jj = 0; jj < KMAX / 2; ++jj) {
    const int u = half + 2 * jj;
    if (u >= nu) continue;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const int col = 16 * u + 8 * q + 2 * t;
      uint32_t* p0 = reinterpret_cast<uint32_t*>(h + g * ld + col);
      uint32_t* p1 = reinterpret_cast<uint32_t*>(h + (g + 8) * ld + col);
      const float2 m0 = unpack_bf16(*p0), m1 = unpack_bf16(*p1);
      const float e0 = acc[jj][q][0] * (m0.x > 0.f ? 1.f : 0.f);
      const float e1 = acc[jj][q][1] * (m0.y > 0.f ? 1.f : 0.f);
      const float e2 = acc[jj][q][2] * (m1.x > 0.f ? 1.f : 0.f);
      const float e3 = acc[jj][q][3] * (m1.y > 0.f ? 1.f : 0.f);
      *p0 = pack_bf16(e0, e1);
      *p1 = pack_bf16(e2, e3);
      float s0 = e0 + e2, s1 = e1 + e3;
#pragma unroll
      for (int off = 4; off < 32; off <<= 1) {
        s0 += __shfl_xor_sync(0xffffffffu, s0, off);
        s1 += __shfl_xor_sync(0xffffffffu, s1, off);
      }
      if (g == 0) {
        colpart[(warp & 3) * ws + col] = s0;
        colpart[(warp & 3) * ws + col + 1] = s1;
      }
    }
  }
}

// the staged chunk of step s of the walk: the recompute's layers 1 .. L-2
// (rows of W_l = its output columns), then the cotangent's layers L-1 .. 1
// (rows of W_l = its K dimension); false past the last
__device__ bool walk_step(const Layers& P, int s, int& l, int& c) {
  for (int q = 1; q <= P.L - 2; ++q) {
    const int n = chunks(P.width[q + 1], WCH);
    if (s < n) { l = q; c = s; return true; }
    s -= n;
  }
  for (int q = P.L - 1; q >= 1; --q) {
    const int n = chunks(P.width[q + 1], WCH);
    if (s < n) { l = q; c = s; return true; }
    s -= n;
  }
  return false;
}

// Rows lo .. lo + G - 1 of the global order of critical rows: their tiles
// and slots into rtile, rslot (those below the total); returns the total.
// Every thread of the block calls it.
__device__ long long scan_group(const int* __restrict__ tcount, int tiles, long long lo,
                                int* rtile, int* rslot, int* wsum) {
  const int lane = lane_id(), warp = threadIdx.x / 32;
  long long base = 0;
  for (int t0 = 0; t0 < tiles; t0 += THREADS) {
    const int tt = t0 + (int)threadIdx.x;
    const int c = tt < tiles ? tcount[tt] : 0;
    int v = c;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += y;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    long long start = base + v - c, total = base;
    for (int q = 0; q < WARPS; ++q) {
      if (q < warp) start += wsum[q];
      total += wsum[q];
    }
    const long long a = start > lo ? start : lo;
    const long long e = start + c < lo + G ? start + c : lo + G;
    for (long long p = a; p < e; ++p) {
      rtile[p - lo] = tt;
      rslot[p - lo] = (int)(p - start);
    }
    base = total;
    __syncthreads();   // wsum is reused
  }
  return base;
}

// The walk over the gathered critical rows: a persistent grid, one block per
// SM, group k of G rows on block k mod gridDim.x; each block sums its groups'
// dW, db into its slice part[blockIdx.x] ([dW_0 .. dW_{L-1}, db_0 .. db_{L-1}])
// and writes dx of its rows.
__global__ void __launch_bounds__(THREADS, 1)
walk_kernel(const float* __restrict__ x, Layers P, const float* __restrict__ cnt,
            const float* __restrict__ dg, const int* __restrict__ tcount,
            const int* __restrict__ tidx, const uint32_t* __restrict__ tmask,
            float* __restrict__ dx, float* __restrict__ part, int B, int N, long long per_slice) {
  extern __shared__ __align__(128) unsigned char smem[];
  const WalkSmem S(P);
  const int L = P.L, WL = P.width[L], MW = mask_words(P), WS = stored_max(P) + 1;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = (warp & 3) * 16, half = warp >> 2;   // a warp's 16 rows and column parity
  const int nt = (N + RT - 1) / RT, tiles = B * nt;
  bf16* stage = reinterpret_cast<bf16*>(smem + S.stage);
  const bf16* w0t = reinterpret_cast<const bf16*>(smem + S.w0t);
  bf16* dtop = reinterpret_cast<bf16*>(smem + S.dtop);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + S.mask);
  float* colpart = reinterpret_cast<float*>(smem + S.colpart);   // [4][WS]
  float* xs = reinterpret_cast<float*>(smem + S.xs);
  int* rb = reinterpret_cast<int*>(smem + S.rb);
  int* rn = reinterpret_cast<int*>(smem + S.rn);
  int* rtile = reinterpret_cast<int*>(smem + S.rtile);
  int* rslot = reinterpret_cast<int*>(smem + S.rslot);
  auto hb = [&](int l) { return reinterpret_cast<bf16*>(smem + S.hb[l]); };
  float* out = part + (size_t)blockIdx.x * per_slice;
  long long off_w[MAXL], off_b[MAXL];
  {
    long long o = 0;
    for (int l = 0; l < L; ++l) { off_w[l] = o; o += (long long)P.width[l + 1] * P.width[l]; }
    for (int l = 0; l < L; ++l) { off_b[l] = o; o += P.width[l + 1]; }
  }
  load_w0t(reinterpret_cast<bf16*>(smem + S.w0t), static_cast<const bf16*>(P.w[0]), P.width[1],
           S.ld0);
  __syncthreads();

  bool first = true;
  for (long long k = blockIdx.x;; k += gridDim.x) {
    const long long lo = k * G;
    const long long R = scan_group(tcount, tiles, lo, rtile, rslot,
                                   reinterpret_cast<int*>(smem + S.wsum));
    if (lo >= R) break;

    // the group's rows: cloud, point, x and tie mask (zeros past the total)
    for (int r = tid; r < G; r += THREADS) {
      int bb = 0, n = -1;
      if (lo + r < R) {
        bb = rtile[r] / nt;
        n = tidx[(size_t)rtile[r] * RT + rslot[r]];
      }
      rb[r] = bb;
      rn[r] = n;
      for (int c = 0; c < 3; ++c) xs[r * 3 + c] = n >= 0 ? x[((size_t)bb * N + n) * 3 + c] : 0.f;
    }
    int s = 0, sl, sc;
    if (walk_step(P, 0, sl, sc)) stage_chunk(stage, P, sl, sc, S.lds, WCH);
    for (int e = tid; e < G * MW; e += THREADS) {   // word-major: mask[w][r]
      const int r = e / MW;
      mask[(e % MW) * G + r] =
          lo + r < R ? tmask[((size_t)rtile[r] * RT + rslot[r]) * MW + e % MW] : 0u;
    }
    __syncthreads();
    // the next staged chunk: wait for this one, then start the following
    auto next_stage = [&]() {
      cp_async_wait_all();
      __syncthreads();
      int nl, nc;
      if (walk_step(P, s + 1, nl, nc))
        stage_chunk(stage + ((s + 1) & 1) * WCH * S.lds, P, nl, nc, S.lds, WCH);
      return stage + (s++ & 1) * WCH * S.lds;
    };

    // recompute h_1 .. h_{L-1} of the rows, the chain's own per-column code
    if (L > 1) {
      float xv[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) xv[c] = xs[(rw + (lane & 15)) * 3 + c];
      uint32_t a0, a1;
      coord_frag(xv, a0, a1);
      for (int u = half; u < P.width[1] / 16; u += 2) {
        float c0[4], c1[4];
        cols16_x(c0, c1, a0, a1, w0t, S.ld0, u);
        dense16(c0, c1, static_cast<const bf16*>(P.b[0]), 16 * u);
        store16(hb(1) + rw * S.ldh[1], S.ldh[1], 16 * u, c0, c1);
      }
    }
    for (int l = 1; l + 1 < L; ++l) {
      const int nk = P.width[l] / 16;
      uint32_t a[KMAX][4];
      for (int c = 0; c < chunks(P.width[l + 1], WCH); ++c) {
        const bf16* w = next_stage();
        if (c == 0) load_rows(a, hb(l) + rw * S.ldh[l], S.ldh[l], nk);
        for (int i = half; i < WCH / 16 && c * WCH + 16 * i < P.width[l + 1]; i += 2) {
          const int u = c * WCH / 16 + i;
          float c0[4], c1[4];
          cols16(c0, c1, a, nk, w + 16 * i * S.lds, S.lds);
          dense16(c0, c1, static_cast<const bf16*>(P.b[l]), 16 * u);
          store16(hb(l + 1) + rw * S.ldh[l + 1], S.ldh[l + 1], 16 * u, c0, c1);
        }
      }
    }

    // dh_L = mask * dg / max(count, 1) (the mask holds g > 0), rounded; db_{L-1}
    for (int f = tid; f < WL; f += THREADS) {
      float sum = 0.f;
      for (int r = 0; r < G; ++r) {
        float v = 0.f;
        if ((mask[(f / 32) * G + r] >> (f % 32)) & 1u) {
          const size_t i = (size_t)rb[r] * WL + f;
          v = dg[i] / fmaxf(cnt[i], 1.f);
        }
        sum += v;
        dtop[r * S.ldt + f] = __float2bfloat16_rn(v);
      }
      out[off_b[L - 1] + f] = first ? sum : out[off_b[L - 1] + f] + sum;
    }
    __syncthreads();

    // down the layers: dW_l, then dh_{l-1} = (rnd(dh_l) W_l) * (h > 0) in place
    for (int l = L - 1; l >= 1; --l) {
      const bf16* dsrc = l == L - 1 ? dtop : hb(l + 1);
      const int ldd = l == L - 1 ? S.ldt : S.ldh[l + 1];
      const int wo = P.width[l + 1], wi = P.width[l];
      if (l == L - 1) dw_top(out + off_w[l], mask, dtop, S.ldt, hb(l), S.ldh[l], wo, wi, first);
      else dw_product(out + off_w[l], dsrc, ldd, hb(l), S.ldh[l], wo, wi, first);
      cotangent(next_stage, dsrc, ldd, hb(l), S.ldh[l], wo, wi, S.lds, colpart, WS);
      __syncthreads();
      for (int i = tid; i < wi; i += THREADS) {
        float sum = 0.f;
        for (int q = 0; q < 4; ++q) sum += colpart[q * WS + i];
        out[off_b[l - 1] + i] = first ? sum : out[off_b[l - 1] + i] + sum;
      }
    }

    // layer 0: dW_0 = rnd(dh_1)^T rnd(x) and dx = rnd(dh_1) rnd(W_0), 3 wide
    __syncthreads();
    const bf16* d1 = L > 1 ? hb(1) : dtop;
    const int ld1 = L > 1 ? S.ldh[1] : S.ldt, w1 = P.width[1];
    for (int e = tid; e < w1 * 3; e += THREADS) {
      const int o = e / 3, c = e % 3;
      float sum = 0.f;
      for (int r = 0; r < G; ++r) sum = fmaf(__bfloat162float(d1[r * ld1 + o]), rnd<bf16>(xs[r * 3 + c]), sum);
      out[off_w[0] + e] = first ? sum : out[off_w[0] + e] + sum;
    }
    const bf16* w0 = static_cast<const bf16*>(P.w[0]);
    for (int r = warp; r < G; r += WARPS) {
      float sum[3] = {0.f, 0.f, 0.f};
      for (int o = lane; o < w1; o += 32) {
        const float d = __bfloat162float(d1[r * ld1 + o]);
        for (int c = 0; c < 3; ++c) sum[c] = fmaf(__bfloat162float(w0[o * 3 + c]), d, sum[c]);
      }
      for (int c = 0; c < 3; ++c)
        for (int off = 16; off; off >>= 1) sum[c] += __shfl_xor_sync(0xffffffffu, sum[c], off);
      if (lane == 0 && rn[r] >= 0)
        for (int c = 0; c < 3; ++c) dx[((size_t)rb[r] * N + rn[r]) * 3 + c] = sum[c];
    }
    first = false;
    __syncthreads();   // the next group reuses every buffer
  }
  if (first)
    for (long long e = tid; e < per_slice; e += THREADS) out[e] = 0.f;
}

// ------------------------------------------------ launches

template <typename S>
int smem_of(const Layers& P) { return EncSmem<S>(P).total; }

bool make_layers(Layers& P, void* const* w, void* const* b, const int* widths, int L) {
  if (L < 1 || L > MAXL || widths[0] != 3) return false;
  P.L = L;
  P.width[0] = 3;
  for (int l = 0; l < L; ++l) {
    if (widths[l + 1] <= 0 || widths[l + 1] % 16) return false;
    P.w[l] = w ? w[l] : nullptr;
    P.b[l] = b ? b[l] : nullptr;
    P.width[l + 1] = widths[l + 1];
  }
  return true;
}

int tile_points(const Layers& P, bool bf) {
  if (!bf) return tile_t<float>();
  return rows_design(P) ? RT : tile_t<bf16>();
}

// scratch of the rows design's backward: per tile its count, then its
// slots' point indices [RT], then their tie masks [RT][MW]
long long rows_bytes(const Layers& P, int B, int N) {
  const long long tiles = (long long)B * ((N + RT - 1) / RT);
  return 4 * tiles * (1 + RT + (long long)RT * mask_words(P));
}

long long slice_floats(const Layers& P) {
  long long n = 0;
  for (int l = 0; l < P.L; ++l) n += (long long)P.width[l + 1] * (P.width[l] + 1);
  return n;
}

template <typename S>
cudaError_t launch_fwd(const float* x, const Layers& P, float* pmax, float* pcnt, int B, int N,
                       cudaStream_t s) {
  const int bytes = smem_of<S>(P);
  cudaError_t e = cudaFuncSetAttribute(fwd_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((N + tile_t<S>() - 1) / tile_t<S>(), B);
  fwd_kernel<S><<<grid, THREADS, bytes, s>>>(x, P, pmax, pcnt, N);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_bwd(const float* x, const Layers& P, const float* g, const float* cnt,
                       const float* dg, float* dx, float* part, float* grads, int B, int N,
                       int blocks, cudaStream_t s) {
  // every block must own at least one tile, or its slice is never written
  if (blocks <= 0 || (long long)blocks > (long long)B * ((N + tile_t<S>() - 1) / tile_t<S>()))
    return cudaErrorInvalidValue;
  const int bytes = smem_of<S>(P);
  cudaError_t e = cudaFuncSetAttribute(bwd_kernel<S>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  const long long per_slice = slice_floats(P);
  bwd_kernel<S><<<blocks, THREADS, bytes, s>>>(x, P, g, cnt, dg, dx, part, B, N, per_slice);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_reduce(part, grads, 1, blocks, per_slice, s);
}

cudaError_t launch_rows_fwd(const float* x, const Layers& P, float* pmax, float* pcnt, int B,
                            int N, cudaStream_t s) {
  const int bytes = TileSmem(P, false).total;
  cudaError_t e = cudaFuncSetAttribute(tile_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((N + RT - 1) / RT, B);
  tile_kernel<false><<<grid, THREADS, bytes, s>>>(x, P, pmax, pcnt, nullptr, nullptr, nullptr,
                                                  nullptr, nullptr, N);
  return cudaGetLastError();
}

cudaError_t launch_rows_bwd(const float* x, const Layers& P, const float* g, const float* cnt,
                            const float* dg, float* dx, float* part, float* grads, void* rows,
                            int B, int N, int blocks, cudaStream_t s) {
  if (blocks <= 0 || !rows) return cudaErrorInvalidValue;
  const int nt = (N + RT - 1) / RT;
  const size_t tiles = (size_t)B * nt;
  int* tcount = static_cast<int*>(rows);
  int* tidx = tcount + tiles;
  uint32_t* tmask = reinterpret_cast<uint32_t*>(tidx + tiles * RT);
  const int sel = TileSmem(P, true).total, walk = WalkSmem(P).total;
  cudaError_t e = cudaFuncSetAttribute(tile_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, sel);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(walk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, walk);
  if (e != cudaSuccess) return e;
  tile_kernel<true><<<dim3(nt, B), THREADS, sel, s>>>(x, P, nullptr, nullptr, g, tcount, tidx,
                                                      tmask, dx, N);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const long long per_slice = slice_floats(P);
  walk_kernel<<<blocks, THREADS, walk, s>>>(x, P, cnt, dg, tcount, tidx, tmask, dx, part, B, N,
                                            per_slice);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_reduce(part, grads, 1, blocks, per_slice, s);
}

}  // namespace

extern "C" {

// points per forward tile (the wrapper sizes the forward's per-tile partials
// from it): 128 in the rows design, else 64 (bf16) or 32 (f32)
int dpfx_fused_encoder_tile_points(const int* widths, int L, int bf) {
  Layers P;
  if (!make_layers(P, nullptr, nullptr, widths, L)) return -1;
  return tile_points(P, bf != 0);
}

// the most dynamic shared memory any of the mode's kernels takes
int dpfx_fused_encoder_smem_bytes(const int* widths, int L, int bf) {
  Layers P;
  if (!make_layers(P, nullptr, nullptr, widths, L)) return -1;
  if (!bf) return smem_of<float>(P);
  if (!rows_design(P)) return smem_of<bf16>(P);
  const int a = TileSmem(P, false).total, b = TileSmem(P, true).total, c = WalkSmem(P).total;
  return a > b ? (a > c ? a : c) : (b > c ? b : c);
}

// the backward's persistent grid for `sms` SMs: the rows design takes one
// block per SM up to the number of G-row groups that B N rows would make;
// the block-wide design one per SM up to the number of tiles
int dpfx_fused_encoder_bwd_blocks(const int* widths, int L, int bf, int B, int N, int sms) {
  Layers P;
  if (B <= 0 || N <= 0 || sms <= 0 || !make_layers(P, nullptr, nullptr, widths, L)) return -1;
  const long long most = bf && rows_design(P)
                             ? ((long long)B * N + G - 1) / G
                             : (long long)B * ((N + tile_points(P, bf) - 1) / tile_points(P, bf));
  return (int)(most < sms ? most : sms);
}

// bytes of the backward's row scratch (0 where the mode needs none)
long long dpfx_fused_encoder_bwd_scratch_bytes(const int* widths, int L, int bf, int B, int N) {
  Layers P;
  if (B <= 0 || N <= 0 || !make_layers(P, nullptr, nullptr, widths, L)) return -1;
  return bf && rows_design(P) ? rows_bytes(P, B, N) : 0;
}

int dpfx_fused_encoder_fwd(const float* x, void* const* w, void* const* b, const int* widths,
                           int L, float* pmax, float* pcnt, int B, int N, int bf,
                           void* stream) {
  Layers P;
  if (B <= 0 || N <= 0 || B > 65535 || !make_layers(P, w, b, widths, L))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf) return (int)launch_fwd<float>(x, P, pmax, pcnt, B, N, s);
  if (rows_design(P)) return (int)launch_rows_fwd(x, P, pmax, pcnt, B, N, s);
  return (int)launch_fwd<bf16>(x, P, pmax, pcnt, B, N, s);
}

int dpfx_fused_encoder_bwd(const float* x, void* const* w, void* const* b, const int* widths,
                           int L, const float* g, const float* cnt, const float* dg, float* dx,
                           float* part, float* grads, void* rows, int B, int N, int bf,
                           int blocks, void* stream) {
  Layers P;
  if (B <= 0 || N <= 0 || B > 65535 || !make_layers(P, w, b, widths, L))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!bf) return (int)launch_bwd<float>(x, P, g, cnt, dg, dx, part, grads, B, N, blocks, s);
  if (rows_design(P))
    return (int)launch_rows_bwd(x, P, g, cnt, dg, dx, part, grads, rows, B, N, blocks, s);
  return (int)launch_bwd<bf16>(x, P, g, cnt, dg, dx, part, grads, B, N, blocks, s);
}

}  // extern "C"
