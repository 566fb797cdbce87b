// The point flow's f32 device code on Hopper, shared by the sampler's f32
// inverse (fused_sampler.cu's f32_kernel) and the f32 training pair past one
// block-wide layout (fused_train.cu's fwd_f32 and bwd_f32).
//
// f32 is the tight-check mode: IEEE f32 FMA, every sum over k in order from
// 0 and the bias (or hz) added after it, the activation in f32, the coupling
// in f32. Every element of an activation is therefore one k-sum whose bits
// do not depend on the tile, the chunking or the thread that computes it:
// the forward, the backward's recompute and the inverse compute the same
// (s, t) bits from the same passthrough coordinates, at any points per
// block. What bounds all three is the FP32 pipes (the FMAs of the H x H
// products), so the products are register-tiled and Wh is streamed:
//
//   * chunk_fma: thread (tp, to) of a TP x TO grid (TP TO = 256) owns points
//     tp + TP i and outputs to + TO j, keeps their sums in registers across
//     Wh's chunks of KC input columns, and reads its operands from rows of
//     ld (activations) and KC + 1 (the chunk), which keeps both reads free
//     of bank conflicts. The sampler's and the forward's 128 points take TP
//     = 16 (8 points x 16 outputs at H=256: 128 FFMA per 24 LDS a k).
//   * f32_walk: the K layers of one block of 128 points, walked forwards
//     (the training forward, with the log-det) or backwards (the inverse).
//     From H=128 on (f32_pipe) the float walk streams Wh: two chunk buffers
//     used in turn, chunk q + 1 (across a product or a layer boundary the
//     next one's first) copied with 4-byte cp.async while the FMAs run on
//     chunk q, each product's bh with its last chunk, and the next layer's
//     Wx, hz, Wout and bout (a second small set) with that layer's first
//     chunk. 16-byte copies would need rows of a multiple of 4 floats, and
//     every such stride puts two of a warp's 16 output rows on one bank.
//     At H=256: 128 x 257 floats of activations, two chunk buffers of 256 x
//     33 (+ bh), two small sets: 226,560 B; the forward adds its log-det row
//     [128]: 227,072 B (F32Smem).
//   * The backward (F32BwdSmem, fused_train.cu's bwd_f32) keeps every level
//     of a tile of T points (T = 64 at H=256 with n_hidden 2: 228,608 B; the
//     table below), recomputes the forward's levels with chunk_fma on row
//     chunks of Wh as the forward does, and runs the cotangent product on
//     the same chunk_fma over Wh's rows, staged transposed ([H][KC + 1]:
//     row i holds column i of KC rows of Wh). dWh goes through dwh_pass.
//
// Shapes of the backward's plan (points a tile, bytes; the carve below;
// tests/_torch_f32_plan.py mirrors it):
//   H=256: n_hidden 1-2 T=64 (94,464 and 228,608 B), 3-4 T=32 (194,816
//          and 230,144 B);
//   H=128: n_hidden 1-2 T=128 (89,344 and 190,720 B), 3-4 T=64 (152,832
//          and 187,648 B).
// The forward's block: 214,784 B at H=128, 227,072 B at H=256.

#pragma once

#include "flow_rows.cuh"

namespace dpfx {

constexpr int F32_T = MT;   // points per block of the sampler and the training forward

// input columns of Wh per staged chunk of the 128-point walk: the whole row
// up to H=128; 32 at H=256, so that two chunk buffers fit beside the 128
// points' activations
__host__ __device__ constexpr int f32_kc(int H) { return H <= 128 ? H : 32; }

// whether the float walk streams its Wh chunks: two chunk buffers and two
// sets of the small weights, filled with cp.async behind the products. The
// int8 sampler converts as it stages, through the registers, and stages
// synchronously into buffer 0 and set 0.
__host__ __device__ constexpr bool f32_pipe(int H) { return H >= 128; }

// Shared-memory carve-up of the 128-point walk; the Python wrappers mirror
// it (fused_sampler.smem_bytes). The points' activations in rows of H + 1.
// A chunk buffer: KC columns of Wh in rows of KC + 1 (row o holds output o),
// then bh [H] of the chunk's product. A small set: Wx [H][3], hz [H], Wout
// [6][H], bout [8] of one layer. The forward's log-det row [128] last.
struct F32Smem {
  int ld, hs, xs, st, ws, wbuf, wbh, small, sbuf, hz, wout, bout, ldp, total;
  __host__ __device__ F32Smem(int H, bool logdet = false) {
    ld = H + 1;
    const int nbuf = f32_pipe(H) ? 2 : 1;
    int o = 0;
    hs = o;    o += round128(F32_T * ld * 4);
    xs = o;    o += round128(3 * F32_T * 4);
    st = o;    o += round128(6 * F32_T * 4);
    wbh = round128(H * (f32_kc(H) + 1) * 4);
    wbuf = wbh + round128(H * 4);
    ws = o;    o += nbuf * wbuf;
    hz = round128(3 * H * 4);
    wout = hz + round128(H * 4);
    bout = wout + round128(6 * H * 4);
    sbuf = bout + round128(8 * 4);
    small = o; o += nbuf * sbuf;
    ldp = o;   o += logdet ? round128(F32_T * 4) : 0;
    total = o;
  }
};

// a stored weight as f32 sees it: an f32 as it is, an int8 q with its scale
// s as q * s
__device__ __forceinline__ float weight_f(float v, float) { return v; }
__device__ __forceinline__ float weight_f(int8_t q, float s) { return __fmul_rn((float)q, s); }

// the sampler's runtime activation
struct ActRt {
  int act;
  __device__ __forceinline__ float operator()(float v) const { return activate(v, act); }
};

// acc += hs[:, k0 .. k0 + KC) . ws^T, ws one chunk [H][KC + 1]: thread (tp,
// to) of a TP x TO grid owns points tp + TP i and outputs to + TO j, and its
// sums take k in order, so they are exact IEEE f32 and the same at every KC
// and tile. Reads are free of bank conflicts: a warp reads one or two rows
// of hs (rows of ld, ld % 32 != 0), and its outputs' rows of ws (KC + 1)
// fall a bank apart. The k loop is unrolled by 8, which timed faster than
// 1, 2, 4 and the compiler's choice at H = 128 and 256 (PERF.md).
template <int H, int KC = f32_kc(H), int TP = 16, int PI = F32_T / 16>
__device__ __forceinline__ void chunk_fma(float (&acc)[PI][H * TP / THREADS], const float* hs,
                                          const float* ws, int ld, int k0) {
  constexpr int TO = THREADS / TP, NJ = H / TO, LW = KC + 1;
  const int tp = threadIdx.x / TO, to = threadIdx.x % TO;
#pragma unroll 8
  for (int kk = 0; kk < KC; ++kk) {
    float a[PI], w[NJ];
#pragma unroll
    for (int i = 0; i < PI; ++i) a[i] = hs[(tp + TP * i) * ld + k0 + kk];
#pragma unroll
    for (int j = 0; j < NJ; ++j) w[j] = ws[(to + TO * j) * LW + kk];
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
  }
}

// h = act(Wx . x + hz) for the T points of xs [3][T]: Wx [H][3], hz [H]
template <int H, typename Act>
__device__ __forceinline__ void first_layer_f32(float* hs, int ld, const float* xs, int T,
                                                const float* wxs, const float* hzs,
                                                const Act& act) {
  for (int e = threadIdx.x; e < T * H; e += THREADS) {
    const int p = e / H, o = e % H;
    float v = wxs[o * 3 + 0] * xs[p];
    v = fmaf(wxs[o * 3 + 1], xs[T + p], v);
    v = fmaf(wxs[o * 3 + 2], xs[2 * T + p], v);
    hs[p * ld + o] = act(v + hzs[o]);
  }
}

// st[r][p] = Wout[r] . h[p] + bout[r] for the T points: one warp per point,
// lanes split the H sum, then a shuffle tree (the backward's recompute;
// f32_walk has the same code in place, held to this text by a CPU test)
template <int H>
__device__ __forceinline__ void st_f32(float* sts, const float* hs, int ld, int T,
                                       const float* wos, const float* bos) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < T; p += WARPS) {
    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int kk = lane; kk < H; kk += 32) {
      const float hv = hs[p * ld + kk];
#pragma unroll
      for (int r = 0; r < 6; ++r) part[r] = fmaf(wos[r * H + kk], hv, part[r]);
    }
#pragma unroll
    for (int r = 0; r < 6; ++r)
      for (int off = 16; off; off >>= 1) part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
    if (lane < 6) {
      float v = part[0];
#pragma unroll
      for (int r = 1; r < 6; ++r) if (lane == r) v = part[r];
      sts[lane * T + p] = v + bos[lane];
    }
  }
}

// The K layers of one block of F32_T points whose coordinates are in xs
// [3][F32_T] (filled by the caller): walked forwards (FWD: the training
// forward, each coupling's s added to ldp [F32_T]) or backwards (the
// inverse). Ends with a barrier; xs then holds the result.
// W: float (weights in f32) or int8_t (the int8 sampler, with scales [K,
// 8]). The layers' Wh chunks form one sequence q = 0 .. K NH1 NC - 1 (layer,
// product, chunk in walk order). Streamed (PIPE): chunk q + 1 goes into
// buffer (q + 1) & 1 with cp.async while the FMAs run on chunk q, the
// product's bh with its last chunk, and the next layer's small set with
// that layer's first chunk, which is in flight behind the last product.
template <typename W, int H, bool FWD, typename Act>
__device__ __forceinline__ void f32_walk(unsigned char* smem, const F32Smem& L,
                                         const float* __restrict__ hz, const W* __restrict__ wx,
                                         const W* __restrict__ wh, const float* __restrict__ bh,
                                         const W* __restrict__ wout,
                                         const float* __restrict__ bout,
                                         const float* __restrict__ masks,
                                         const float* __restrict__ scales, int b, int K, int NH1,
                                         float cap, const Act& act) {
  constexpr bool PIPE = std::is_same<W, float>::value && f32_pipe(H);
  constexpr int TILE = F32_T, NJ = H / 16, KC = f32_kc(H), NC = H / KC, PI = TILE / 16;
  const int ld = L.ld;
  float* hs = reinterpret_cast<float*>(smem + L.hs);      // [TILE][H + 1]
  float* xs = reinterpret_cast<float*>(smem + L.xs);      // [3][TILE]
  float* sts = reinterpret_cast<float*>(smem + L.st);     // [6][TILE]
  float* ldp = reinterpret_cast<float*>(smem + L.ldp);    // [TILE] (FWD)
  auto wbuf = [&](int s) { return reinterpret_cast<float*>(smem + L.ws + s * L.wbuf); };
  auto sset = [&](int s) { return smem + L.small + s * L.sbuf; };
  auto layer = [&](int i) { return FWD ? i : K - 1 - i; };

  const int tid = threadIdx.x;
  const int nq = K * NH1 * NC;

  // walk step i's small set into set s: cp.async (PIPE; the caller
  // commits), or loaded and converted by the threads
  auto small_load = [&](int i, int s) {
    const int k = layer(i);
    float* wxs = reinterpret_cast<float*>(sset(s));
    float* hzs = reinterpret_cast<float*>(sset(s) + L.hz);
    float* wos = reinterpret_cast<float*>(sset(s) + L.wout);
    float* bos = reinterpret_cast<float*>(sset(s) + L.bout);
    const float* hzk = hz + ((size_t)b * K + k) * H;
    if constexpr (PIPE) {
      for (int e = tid; e < 3 * H; e += THREADS) cp_async4(wxs + e, wx + (size_t)k * 3 * H + e);
      for (int e = tid; e < H; e += THREADS) cp_async4(hzs + e, hzk + e);
      for (int e = tid; e < 6 * H; e += THREADS) cp_async4(wos + e, wout + (size_t)k * 6 * H + e);
      if (tid < 6) cp_async4(bos + tid, bout + k * 6 + tid);
    } else {
      const float s_wx = scales ? scales[k * 8] : 1.f;
      const float s_wo = scales ? scales[k * 8 + 2] : 1.f;
      for (int e = tid; e < 3 * H; e += THREADS) wxs[e] = weight_f(wx[(size_t)k * 3 * H + e], s_wx);
      for (int e = tid; e < H; e += THREADS) hzs[e] = hzk[e];
      for (int e = tid; e < 6 * H; e += THREADS) wos[e] = weight_f(wout[(size_t)k * 6 * H + e], s_wo);
      if (tid < 6) bos[tid] = bout[k * 6 + tid];
    }
  };
  // chunk q into buffer s (PIPE: cp.async, with the product's bh at its last
  // chunk and the layer's small set at its first but the walk's first; the
  // copies are committed as one group), or staged and converted by the
  // threads (bh with the product's first chunk)
  auto chunk_load = [&](int q, int s) {
    const int i = q / (NH1 * NC), j = (q / NC) % NH1, c = q % NC, k = layer(i);
    const W* g = wh + ((size_t)k * NH1 + j) * H * H + c * KC;
    const float* bhj = bh + ((size_t)k * NH1 + j) * H;
    float* ws = wbuf(s);
    float* wb = reinterpret_cast<float*>(reinterpret_cast<unsigned char*>(ws) + L.wbh);
    if constexpr (PIPE) {
      for (int v = tid; v < H * KC; v += THREADS) {
        const int o = v / KC, cc = v % KC;
        cp_async4(ws + o * (KC + 1) + cc, g + (size_t)o * H + cc);
      }
      if (c == NC - 1)
        for (int e = tid; e < H; e += THREADS) cp_async4(wb + e, bhj + e);
      if (c == 0 && j == 0 && i > 0) small_load(i, i & 1);
      cp_async_commit();
    } else {
      const float s_wh = scales ? scales[k * 8 + 1] : 1.f;
      for (int v = tid; v < H * KC; v += THREADS) {
        const int o = v / KC, cc = v % KC;
        ws[o * (KC + 1) + cc] = weight_f(g[(size_t)o * H + cc], s_wh);
      }
      if (c == 0)
        for (int e = tid; e < H; e += THREADS) wb[e] = bhj[e];
    }
  };

  if constexpr (PIPE) {
    small_load(0, 0);
    if (nq) chunk_load(0, 0);
    else cp_async_commit();
  }

  int q = 0;   // the next chunk of the walk
  for (int i = 0; i < K; ++i) {
    const int k = layer(i), s = PIPE ? (i & 1) : 0;
    if constexpr (PIPE) {
      cp_async_wait_all();
      __syncthreads();  // step i's small set has landed; step i-1 is done with xs and the other set
      if (!nq && i + 1 < K) {
        small_load(i + 1, (i + 1) & 1);
        cp_async_commit();
      }
    } else {
      __syncthreads();  // the previous layer is done with xs and the small set
      small_load(i, 0);
      __syncthreads();
    }
    const float* wxs = reinterpret_cast<const float*>(sset(s));              // [H][3]
    const float* hzs = reinterpret_cast<const float*>(sset(s) + L.hz);       // [H]
    const float* wos = reinterpret_cast<const float*>(sset(s) + L.wout);     // [6][H]
    const float* bos = reinterpret_cast<const float*>(sset(s) + L.bout);     // [6]

    // h = act(Wx . x + hz)
    first_layer_f32<H>(hs, ld, xs, TILE, wxs, hzs, act);

    // h = act(h . Wh^T + bh), n_hidden - 1 times, Wh in NC chunks
    for (int j = 0; j < NH1; ++j) {
      float acc[PI][NJ];
#pragma unroll
      for (int ii = 0; ii < PI; ++ii)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) acc[ii][jj] = 0.f;
      for (int c = 0; c < NC; ++c, ++q) {
        if constexpr (PIPE) {
          cp_async_wait_all();
          __syncthreads();  // chunk q has landed; every thread is done with chunk q - 1 and wrote h
          if (q + 1 < nq) chunk_load(q + 1, (q + 1) & 1);
        } else {
          __syncthreads();  // every thread is done with the previous chunk and wrote h
          chunk_load(q, 0);
          __syncthreads();
        }
        chunk_fma<H>(acc, hs, wbuf(PIPE ? q & 1 : 0), ld, c * KC);
      }
      __syncthreads();  // every thread has read hs
      // bh from the buffer of the product's last chunk (PIPE) or of its
      // first (the only buffer), rewritten only after the next barrier
      const float* bhs = reinterpret_cast<const float*>(
          reinterpret_cast<const unsigned char*>(wbuf(PIPE ? (q - 1) & 1 : 0)) + L.wbh);
      const int tp = tid / 16, to = tid % 16;
#pragma unroll
      for (int ii = 0; ii < PI; ++ii)
#pragma unroll
        for (int jj = 0; jj < NJ; ++jj) {
          const int o = to + 16 * jj;
          hs[(tp + 16 * ii) * ld + o] = act(acc[ii][jj] + bhs[o]);
        }
    }
    __syncthreads();

    // st = Wout . h + bout: st_f32's code, written in place (called as the
    // function, it made nvcc schedule f32_kernel<float, 256> 2% slower with
    // the same bits; PERF.md); tests/test_torch_flow_f32.py holds the two to
    // one text
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int p = warp; p < TILE; p += WARPS) {
        float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        for (int kk = lane; kk < H; kk += 32) {
          const float hv = hs[p * ld + kk];
#pragma unroll
          for (int r = 0; r < 6; ++r) part[r] = fmaf(wos[r * H + kk], hv, part[r]);
        }
#pragma unroll
        for (int r = 0; r < 6; ++r)
          for (int off = 16; off; off >>= 1) part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
        if (lane < 6) {
          float v = part[0];
#pragma unroll
          for (int r = 1; r < 6; ++r) if (lane == r) v = part[r];
          sts[lane * TILE + p] = v + bos[lane];
        }
      }
    }
    __syncthreads();

    // the coupling on the transformed coordinates: forwards (x exp(s) + t,
    // the log-det) or inverted ((x - t) exp(-s))
    if (tid < TILE) {
      for (int c = 0; c < 3; ++c) {
        if (masks[k * 3 + c] > 0.f) continue;
        const float sv = cap * tanhf(sts[c * TILE + tid] / cap);
        const float t = sts[(3 + c) * TILE + tid];
        if constexpr (FWD) {
          ldp[tid] += sv;
          xs[c * TILE + tid] = xs[c * TILE + tid] * expf(sv) + t;
        } else {
          xs[c * TILE + tid] = (xs[c * TILE + tid] - t) * expf(-sv);
        }
      }
    }
  }
  __syncthreads();
}

// ---------------------------------------------------------------- backward

constexpr int F32_BWD_KC = 32;   // Wh rows or columns per staged chunk of the backward

// The f32 training backward's carve-up (dpfx_fused_train_f32_smem_bytes
// reports its size; tests/_torch_f32_plan.py mirrors it): a tile of T
// points (the largest of 128 (64 at H=256), 64, 32 that fits) with every
// level h_0 .. h_{n_hidden-1} in rows of H + 4 (16-byte aligned for
// dwh_pass; the chunk_fma reads of two rows 4 banks apart stay free of
// conflicts), which become the cotangents in place; two chunk buffers [H][KC
// + 1] (n_hidden > 1); the tile's coordinates, cotangents and (s, t); a
// layer's small weights and biases, and the block's sums of their
// gradients over its tiles.
struct F32BwdSmem {
  int T, ld, hstride, hs, ws, wbuf, ys, dys, xks, dst, dyn;
  int wx, wout, bout, hz, bh, adwx, adwout, adbout, dhz, adbh, total;
  __host__ __device__ void carve(int H, int NH1, int t) {
    const int nb = NH1 > 1 ? NH1 : 1;
    T = t;
    ld = H + 4;
    hstride = round128(t * ld * 4);
    wbuf = round128(H * (F32_BWD_KC + 1) * 4);
    int o = 0;
    hs = o;      o += (NH1 + 1) * hstride;
    ws = o;      o += NH1 > 0 ? 2 * wbuf : 0;
    ys = o;      o += round128(3 * t * 4);
    dys = o;     o += round128(3 * t * 4);
    xks = o;     o += round128(3 * t * 4);
    dst = o;     o += round128(8 * t * 4);
    dyn = o;     o += round128(3 * t * 4);
    wx = o;      o += round128(3 * H * 4);
    wout = o;    o += round128(6 * H * 4);
    bout = o;    o += round128(8 * 4);
    hz = o;      o += round128(H * 4);
    bh = o;      o += round128(nb * H * 4);
    adwx = o;    o += round128(3 * H * 4);
    adwout = o;  o += round128(6 * H * 4);
    adbout = o;  o += round128(8 * 4);
    dhz = o;     o += round128(H * 4);
    adbh = o;    o += round128(nb * H * 4);
    total = o;
  }
  __host__ __device__ F32BwdSmem(int H, int NH1) {
    for (int t = H >= 256 ? 64 : 128; t >= 32; t /= 2) {
      carve(H, NH1, t);
      if (total <= SMEM_MAX) return;
    }
  }
};

// floats of a block's partial of one layer in the f32 backward: [dWx | dWh |
// dbh | dWout | dbout], padded to a multiple of 4 so that every dWh row of
// every (block, layer) slice is 16-byte aligned
__host__ __device__ constexpr int f32_part_row(int H, int NH1) {
  return (3 * H + NH1 * H * H + NH1 * H + 6 * H + 6 + 3) / 4 * 4;
}

// Wh_j's chunk c for the backward into ws [H][KC + 1] with 4-byte cp.async
// (the caller commits): ROWS, the forward's operand (row o holds Wh[o][cKC
// .. cKC + KC)); else the cotangent product's, transposed (row i holds
// Wh[cKC .. cKC + KC)[i]). Consecutive threads read consecutive floats of a
// row of Wh and write rows KC + 1 apart (a bank apart).
template <int H, bool ROWS>
__device__ __forceinline__ void bwd_chunk(float* ws, const float* __restrict__ whj, int c) {
  constexpr int KC = F32_BWD_KC;
  if constexpr (ROWS) {
    const float* g = whj + c * KC;
    for (int v = threadIdx.x; v < H * KC; v += THREADS) {
      const int o = v / KC, cc = v % KC;
      cp_async4(ws + o * (KC + 1) + cc, g + (size_t)o * H + cc);
    }
  } else {
    const float* g = whj + (size_t)c * KC * H;
    for (int v = threadIdx.x; v < H * KC; v += THREADS) {
      const int cc = v / H, i = v % H;
      cp_async4(ws + i * (KC + 1) + cc, g + (size_t)cc * H + i);
    }
  }
}

// dWh_j += dh^T h_j over a tile's T points, into sl [H][H] (global; first:
// sl = the tile's sums), each element one sum over the points in order then
// added to sl, as gemm_acc's f32 path does. In passes of bands of 8 A output
// rows: warp w owns rows ob + A w .. + A, lane l the input columns 4 l +
// 128 g (g < H / 128), 64 sums a thread. Per point a warp reads its A dh
// values as broadcast 16-byte loads and its h_j values as 16-byte loads of
// one contiguous row segment; each band's slice is read with 16-byte loads
// before its FMAs (a warp's 512 contiguous bytes a load) and written after.
template <int H>
__device__ __forceinline__ void dwh_pass(float* __restrict__ sl, const float* dh,
                                         const float* hj, int ld, int T, bool first) {
  constexpr int G = H / 128, A = 16 / G, BO = 8 * A;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int ob = 0; ob < H; ob += BO) {
    const int o0 = ob + A * warp;
    float4 prior[A][G];
    if (!first) {
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int g = 0; g < G; ++g)
          prior[a][g] = *reinterpret_cast<const float4*>(sl + (size_t)(o0 + a) * H + 4 * lane +
                                                         128 * g);
    }
    float s[A][4 * G];
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int c = 0; c < 4 * G; ++c) s[a][c] = 0.f;
#pragma unroll 2
    for (int p = 0; p < T; ++p) {
      float dv[A], hv[4 * G];
#pragma unroll
      for (int q = 0; q < A / 4; ++q) {
        const float4 v = *reinterpret_cast<const float4*>(dh + p * ld + o0 + 4 * q);
        dv[4 * q] = v.x;
        dv[4 * q + 1] = v.y;
        dv[4 * q + 2] = v.z;
        dv[4 * q + 3] = v.w;
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 v = *reinterpret_cast<const float4*>(hj + p * ld + 4 * lane + 128 * g);
        hv[4 * g] = v.x;
        hv[4 * g + 1] = v.y;
        hv[4 * g + 2] = v.z;
        hv[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int a = 0; a < A; ++a)
#pragma unroll
        for (int c = 0; c < 4 * G; ++c) s[a][c] = fmaf(dv[a], hv[c], s[a][c]);
    }
#pragma unroll
    for (int a = 0; a < A; ++a)
#pragma unroll
      for (int g = 0; g < G; ++g) {
        float4 v = make_float4(s[a][4 * g], s[a][4 * g + 1], s[a][4 * g + 2], s[a][4 * g + 3]);
        if (!first) {
          v.x = prior[a][g].x + v.x;
          v.y = prior[a][g].y + v.y;
          v.z = prior[a][g].z + v.z;
          v.w = prior[a][g].w + v.w;
        }
        *reinterpret_cast<float4*>(sl + (size_t)(o0 + a) * H + 4 * lane + 128 * g) = v;
      }
  }
}

}  // namespace dpfx
