// Fused inverse point flow for Hopper (sm_90a): all K inverted affine
// couplings of the DPF point flow in one kernel, each point kept on chip
// from the base noise to the output.
//
// Replaces the Pallas TPU kernels `_fused_inverse_kernel`
// (dpfx/ops/fused_sampler.py:112) and `_fused_sample_kernel` (:309), the
// latter with its int8 mode (`quantized=`, :338-369). One kernel serves
// all: with `ut == nullptr` it draws the base noise itself (Philox4x32-10
// keyed by the seed, counter = (point, cloud), Box-Muller with the +1e-7
// guard on u1), so the stream does not depend on the tiling.
//
// Work per point and layer: Wx (H x 3), (n_hidden-1) x Wh (H x H), Wout
// (6 x H): 2(3H + (n_hidden-1)H^2 + 6H) FLOP, about 35 kFLOP at H=128,
// n_hidden=2. At the flagship batch (64 x 2048 points, K=32) that is
// ~147 GFLOP against ~3 MB of inputs and outputs, so the bound is the tensor
// cores' rate (~0.15 ms at 989 TFLOP/s bf16), not memory.
//
// bf16 mode (`rows_kernel`): the training forward's rows design, run
// backwards through the layers, on the same device code (flow_rows.cuh).
//   * grid (ceil(N / 128), B), 16 points per warp, layers K-1 .. 0. A warp
//     takes its rows through the conditioner on its own, on mma.sync:
//     first_rows (Wx x + hz, K = 3 padded to 8), hidden_rows n_hidden-1
//     times, out_rows; the activations stay in registers. Then, through the
//     warp's [16][8] exchange, the inverse update of the coordinates that
//     are not passed through: x = (x - t) exp(-s), s = cap tanh(st / cap).
//     Coordinate rows 3.. of a C=8 input pass through untouched.
//   * One block barrier per layer. Where two whole layers' weights fit
//     (the flagship shape: 2 x 39 KB, two blocks per SM), the next layer's
//     weights go into the other stage while this layer runs: bf16 Wh and
//     Wout with cp.async (stage_load), Wx through registers (WxRegs), as the
//     training forward does. Where they do not (H=256; deep conditioners),
//     one stage holds Wx, Wout and one Wh, and each Wh is loaded between two
//     barriers. The two are separate instances (TWO): compiled into one, the
//     one-stage path's registers cost the flagship's two-stage path ~25%.
//   * int8 mode (scales non-null): cp.async cannot convert, so the next
//     layer's int8 Wh goes with cp.async into a raw byte area, and after the
//     layer each thread turns the bytes that it copied itself (visible to it
//     once its own copies have landed, no barrier needed) into rnd<bf16>(q s)
//     in the other stage; Wx and Wout (9H bytes) go through registers. That
//     is, bit for bit, the bf16 mode on the host-dequantized stacks. The raw
//     area keeps the prefetch out of the registers that the products use.
//   * The activation is relu as a compile-time case (the flagship's) in the
//     two-stage instances; the others (gelu, tanh, leaky_relu), and every
//     activation of the one-stage instances, go through the runtime code
//     `activate` (about twice the time: a switch in every epilogue).
//   * Rounding is the Pallas kernel's: bf16 operands, f32 sums, + hz or bias
//     in f32, the activation in f32, one cast; the coupling update in f32.
//     A forward (fused_train.cu's fwd_kernel_mma) and this inverse run the
//     same device functions on the same passthrough coordinates, so they
//     compute the same (s, t) bits, and x comes back through a round trip
//     up to the f32 rounding of the affine update.
//
// f32 mode (`f32_kernel`): the tight-check mode, IEEE f32 FMA with k in
// order, the block's 128 points in shared memory, weights staged one
// matrix at a time, one thread per point for the coupling. At H=256 one
// f32 Wh (256 x 257 floats, 263 KB) is more than a block's shared memory
// holds, so that instance stages each Wh in chunks of 64 input columns
// (k) beside the 128 points' activations (214 KB in all): every thread
// keeps its outputs' sums in registers across the chunks, so each sum
// still runs k = 0 .. H-1 in order and the bits are the whole matrix's.
// The smaller point tile was the other choice; it would have given two
// layouts of every buffer and half the points per staged weight byte.
//
// The ragged last tile computes on zeros and writes nothing past N.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). The
// launch returns cudaGetLastError().

#include "flow_rows.cuh"

namespace {

using namespace dpfx;

constexpr int TILE = MT;        // points per block

// Philox4x32-10 (Salmon et al., SC'11)
__device__ __forceinline__ void philox(uint32_t c[4], uint32_t k0, uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
  }
}

__device__ __forceinline__ float box_muller(uint32_t a, uint32_t b) {
  const float inv24 = 1.0f / 16777216.0f;
  float u1 = (float)(a >> 8) * inv24 + 1e-7f;
  float u2 = (float)(b >> 8) * inv24;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

// point n of cloud b: its base noise read from ut, or drawn (and written to
// u_out when write is set and u_out is not null); zeros past N
__device__ __forceinline__ void base_noise(float (&x)[3], int n, int b, int N, size_t cloud,
                                           const float* ut, float* u_out, bool write,
                                           unsigned long long seed, float noise_scale) {
  x[0] = x[1] = x[2] = 0.f;
  if (n >= N) return;
  if (ut) {
    for (int c = 0; c < 3; ++c) x[c] = ut[cloud + (size_t)c * N + n];
    return;
  }
  uint32_t r0[4] = {(uint32_t)n, (uint32_t)b, 0u, 0u};
  uint32_t r1[4] = {(uint32_t)n, (uint32_t)b, 1u, 0u};
  philox(r0, (uint32_t)seed, (uint32_t)(seed >> 32));
  philox(r1, (uint32_t)seed, (uint32_t)(seed >> 32));
  x[0] = box_muller(r0[0], r0[1]) * noise_scale;
  x[1] = box_muller(r0[2], r0[3]) * noise_scale;
  x[2] = box_muller(r1[0], r1[1]) * noise_scale;
  if (write && u_out)
    for (int c = 0; c < 3; ++c) u_out[cloud + (size_t)c * N + n] = x[c];
}

// ---------------------------------------------------------------- bf16 mode

// The rows kernel's shared-memory carve-up (dpfx_fused_sampler_smem_bytes
// reports its size): the per-warp [16][8] f32 exchange, (int8 with two
// stages) the raw bytes of the next layer's Wh, then the stages. A stage
// holds Wh (all n_hidden-1 of a layer with two stages, one with one),
// Wout [8][LD] (rows 6-7 zero) and Wx^T [8][LD] (rows 3-7 zero). H=256 takes
// one stage (a layer's Wh alone is 132 KB).
struct RowsSmem {
  int stw, raw, stage, stage_bytes, wout, wxt, nst, total;
  __host__ __device__ RowsSmem(int H, int NH1, bool int8) {
    const int ld = H + 8, w8 = round128(8 * ld * 2);
    int o = 0;
    stw = o;   o += WARPS * 16 * 8 * 4;
    const int rawb = int8 ? round128(NH1 * H * H) : 0;
    nst = H < 256 && o + rawb + 2 * (round128(NH1 * H * ld * 2) + 2 * w8) <= SMEM_MAX ? 2 : 1;
    raw = o;
    if (nst == 2) o += rawb;
    wout = round128((nst == 2 ? NH1 : NH1 > 0 ? 1 : 0) * H * ld * 2);
    wxt = wout + w8;
    stage_bytes = wxt + w8;
    stage = o;
    total = o + nst * stage_bytes;
  }
};

// relu as a compile-time case, the other activations through `activate`
template <bool RELU>
struct SampleAct {
  int act;
  __device__ __forceinline__ float operator()(float v) const {
    return RELU ? (v > 0.f ? v : 0.f) : activate(v, act);
  }
};

// a stored weight as bf16: as it is, or an int8 q with its scale s as
// rnd<bf16>(q * s), what dequantize() and the cast to bf16 give on the host
__device__ __forceinline__ bf16 as_bf16(bf16 v, float) { return v; }
__device__ __forceinline__ bf16 as_bf16(int8_t q, float s) {
  return __float2bfloat16_rn(__fmul_rn((float)q, s));
}

// 16 int8 weights at q into 16 bf16 rnd<bf16>(q * s) at dst (16-byte aligned)
__device__ __forceinline__ void convert16(bf16* dst, const int8_t* q, float s) {
  const int4 raw = *reinterpret_cast<const int4*>(q);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
  uint32_t w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = pack_bf16(__fmul_rn((float)b[2 * i], s), __fmul_rn((float)b[2 * i + 1], s));
  *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
  *reinterpret_cast<uint4*>(dst + 8) = make_uint4(w[4], w[5], w[6], w[7]);
}

// mats [H x H] matrices of g (W per element, int8 with its scale s) into
// rows of LD at dst, as bf16; the whole block, synchronously
template <int H>
__device__ void load_wh(bf16* dst, const bf16* g, float, int mats) {
  constexpr int LD = Mma<H>::LD, VPR = H / 8;
  for (int v = threadIdx.x; v < mats * H * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    *reinterpret_cast<uint4*>(dst + r * LD + c) = *reinterpret_cast<const uint4*>(g + (size_t)r * H + c);
  }
}
template <int H>
__device__ void load_wh(bf16* dst, const int8_t* g, float s, int mats) {
  constexpr int LD = Mma<H>::LD, VPR = H / 16;
  for (int v = threadIdx.x; v < mats * H * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 16;
    convert16(dst + r * LD + c, g + (size_t)r * H + c, s);
  }
}

// a layer's Wx [H][3] and Wout [6][H] in registers, stored into a stage's
// Wx^T rows 0-2 and Wout rows 0-5 as bf16
template <int H, typename W>
struct SmallRegs {
  static constexpr int NX = (3 * H + THREADS - 1) / THREADS, NO = (6 * H + THREADS - 1) / THREADS;
  W x[NX], o[NO];
  float sx, so;
  __device__ void load(const W* wx, const W* wout, const float* scales, int k) {
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (e < 3 * H) x[i] = wx[(size_t)k * 3 * H + e];
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (e < 6 * H) o[i] = wout[(size_t)k * 6 * H + e];
    }
    sx = scales ? scales[k * 8] : 1.f;
    so = scales ? scales[k * 8 + 2] : 1.f;
  }
  __device__ void store(unsigned char* st, const RowsSmem& L) const {
    constexpr int LD = Mma<H>::LD;
    bf16* wxt = reinterpret_cast<bf16*>(st + L.wxt);
    bf16* wo8 = reinterpret_cast<bf16*>(st + L.wout);
#pragma unroll
    for (int i = 0; i < NX; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (e < 3 * H) wxt[(e % 3) * LD + e / 3] = as_bf16(x[i], sx);
    }
#pragma unroll
    for (int i = 0; i < NO; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (e < 6 * H) wo8[(e / H) * LD + e % H] = as_bf16(o[i], so);
    }
  }
};

// int8 with two stages: start the cp.async copies of layer k's Wh bytes into
// the raw area (thread t copies chunks t, t + THREADS, ...), and after they
// land turn the same chunks into bf16 Wh of a stage
template <int H>
__device__ void raw_load(unsigned char* raw, const int8_t* wh, int k, int NH1) {
  const int8_t* g = wh + (size_t)k * NH1 * H * H;
  for (int v = threadIdx.x; v < NH1 * H * H / 16; v += THREADS)
    cp_async16(raw + 16 * v, g + 16 * v);
  cp_async_commit();
}
template <int H>
__device__ void raw_convert(unsigned char* st, const unsigned char* raw, float s, int NH1) {
  constexpr int LD = Mma<H>::LD;
  bf16* swh = reinterpret_cast<bf16*>(st);
  for (int v = threadIdx.x; v < NH1 * H * H / 16; v += THREADS) {
    const int e = 16 * v;
    convert16(swh + (e / H) * LD + e % H, reinterpret_cast<const int8_t*>(raw + e), s);
  }
}

// W: bf16 (weights in the compute dtype) or int8_t (int8 mode, scales [K, 8]);
// TWO: two stages (RowsSmem's nst == 2), else one
template <typename W, int H, bool RELU, bool TWO>
__global__ void __launch_bounds__(THREADS, H <= 128 ? 2 : 1)
rows_kernel(const float* __restrict__ hz, const float* __restrict__ ut, float* __restrict__ out,
            float* __restrict__ u_out, const W* __restrict__ wx, const W* __restrict__ wh,
            const float* __restrict__ bh, const W* __restrict__ wout,
            const float* __restrict__ bout, const float* __restrict__ masks,
            const float* __restrict__ scales, int C, int N, int K, int NH1, float cap, int act,
            unsigned long long seed, float noise_scale) {
  constexpr bool Q8 = std::is_same<W, int8_t>::value;
  constexpr int LD = Mma<H>::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  const RowsSmem L(H, NH1, Q8);
  const SampleAct<RELU> fn{act};
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = lane & 15, b = blockIdx.y, n = blockIdx.x * TILE + warp * 16 + p;
  const size_t cloud = (size_t)b * C * N;
  float* sw = reinterpret_cast<float*>(smem + L.stw) + warp * 128;
  auto stage = [&](int s) { return smem + L.stage + s * L.stage_bytes; };
  auto scale_wh = [&](int k) { return Q8 ? scales[k * 8 + 1] : 1.f; };

  // the padding rows that the products read
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int s = 0; s < (TWO ? 2 : 1); ++s) {
    bf16* swo = reinterpret_cast<bf16*>(stage(s) + L.wout);
    bf16* swx = reinterpret_cast<bf16*>(stage(s) + L.wxt);
    for (int e = tid; e < 2 * LD; e += THREADS) swo[6 * LD + e] = zero;
    for (int e = tid; e < 5 * LD; e += THREADS) swx[3 * LD + e] = zero;
  }
  // lanes p and p + 16 both carry point p (coord_frag reads lanes < 16)
  float x[3];
  base_noise(x, n, b, N, cloud, ut, u_out, lane < 16, seed, noise_scale);

  SmallRegs<H, W> sm;
  WxRegs<H> wr;
  if constexpr (TWO) {   // layer K-1 into stage 0
    if constexpr (Q8) {
      load_wh<H>(reinterpret_cast<bf16*>(stage(0)), wh + (size_t)(K - 1) * NH1 * H * H,
                 scale_wh(K - 1), NH1);
      sm.load(wx, wout, scales, K - 1);
      sm.store(stage(0), L);
    } else {
      stage_load<H>(stage(0), L, wh, wout, K - 1, NH1);
      wr.load(wx, K - 1);
      wr.store(reinterpret_cast<bf16*>(stage(0) + L.wxt));
    }
  }
  for (int i = 0; i < K; ++i) {
    const int k = K - 1 - i, s = TWO ? (i & 1) : 0;
    const bool ahead = TWO && i + 1 < K;
    if constexpr (TWO) {
      if constexpr (!Q8) cp_async_wait_all();
      __syncthreads();   // layer k's stage is visible; layer k+1 is done with the other
      if (ahead) {
        if constexpr (Q8) {
          raw_load<H>(smem + L.raw, wh, k - 1, NH1);
          sm.load(wx, wout, scales, k - 1);
        } else {
          stage_load<H>(stage(s ^ 1), L, wh, wout, k - 1, NH1);
          wr.load(wx, k - 1);
        }
      }
    } else {
      __syncthreads();   // every warp is done with the single stage
      sm.load(wx, wout, scales, k);
      sm.store(stage(0), L);
      if (NH1) load_wh<H>(reinterpret_cast<bf16*>(stage(0)), wh + (size_t)k * NH1 * H * H,
                          scale_wh(k), 1);
      __syncthreads();
    }
    unsigned char* st = stage(s);
    const bf16* swh = reinterpret_cast<const bf16*>(st);
    uint32_t a0, a1;
    coord_frag(x, a0, a1);
    Rows<H> h;
    first_rows<H>(h, a0, a1, reinterpret_cast<const bf16*>(st + L.wxt),
                  hz + ((size_t)b * K + k) * H, nullptr, fn);
    for (int j = 0; j < NH1; ++j) {
      if (!TWO && j > 0) {   // one Wh at a time
        __syncthreads();
        load_wh<H>(reinterpret_cast<bf16*>(st), wh + ((size_t)k * NH1 + j) * H * H, scale_wh(k), 1);
        __syncthreads();
      }
      Rows<H> o;
      hidden_rows<H>(o, h, swh + (TWO ? j * H * LD : 0), bh + ((size_t)k * NH1 + j) * H,
                     nullptr, fn);
      h = o;
    }
    float stv[4];
    out_rows<H>(stv, h, reinterpret_cast<const bf16*>(st + L.wout), bout + k * 6);
    st_exchange(sw, stv);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (masks[k * 3 + c] > 0.f) continue;
      const float sc = cap * tanhf(sw[p * 8 + c] / cap);
      x[c] = (x[c] - sw[p * 8 + 3 + c]) * expf(-sc);
    }
    __syncwarp();
    if (ahead) {
      if constexpr (Q8) {
        cp_async_wait_all();   // this thread's own chunks have landed
        raw_convert<H>(stage(s ^ 1), smem + L.raw, scale_wh(k - 1), NH1);
        sm.store(stage(s ^ 1), L);
      } else {
        wr.store(reinterpret_cast<bf16*>(stage(s ^ 1) + L.wxt));
      }
    }
  }
  if (lane < 16 && n < N)
    for (int c = 0; c < 3; ++c) out[cloud + (size_t)c * N + n] = x[c];
}

// ---------------------------------------------------------------- f32 mode

// input columns of Wh per staged chunk of the f32 kernel: the whole row up
// to H=128, 64 at H=256
__host__ __device__ constexpr int f32_kc(int H) { return H <= 128 ? H : 64; }

// Shared-memory carve-up of the f32 kernel; the Python wrapper mirrors it
// (smem_bytes)
struct F32Smem {
  int ld, hs, ws, xs, st, wx, hz, bh, wout, bout, total;
  __host__ __device__ F32Smem(int H) {
    ld = H + 1;
    int o = 0;
    hs = o;    o += round128(TILE * ld * 4);
    ws = o;    o += round128(H * (f32_kc(H) + 1) * 4);
    xs = o;    o += round128(3 * TILE * 4);
    st = o;    o += round128(6 * TILE * 4);
    wx = o;    o += round128(3 * H * 4);
    hz = o;    o += round128(H * 4);
    bh = o;    o += round128(H * 4);
    wout = o;  o += round128(6 * H * 4);
    bout = o;  o += round128(8 * 4);
    total = o;
  }
};

// a stored weight as f32 sees it: an f32 as it is, an int8 q with its scale
// s as q * s
__device__ __forceinline__ float weight_f(float v, float) { return v; }
__device__ __forceinline__ float weight_f(int8_t q, float s) { return __fmul_rn((float)q, s); }

// hs[T x H] <- act(hs . Wh^T + bh): Wh = g [H x H] (row o holds output o)
// in global memory, staged through ws in chunks of KC input columns
// ([H][KC + 1]; one chunk, the whole matrix, up to H=128). Register-tiled
// FMA: thread (tp, to) owns points tp + 16i and outputs to + 16j, and its
// sums stay in registers across the chunks, k in order, so they are exact
// IEEE f32 and the same at every KC. The k loop is unrolled by 8, which
// timed faster than 1, 2, 4 and the compiler's choice at H = 128 and 256
// (PERF.md, PR 21). The caller has loaded bh and synchronised after the
// previous product.
template <typename W, int H>
__device__ void hidden_gemm(float* hs, float* ws, const W* g, float s, const float* bh,
                                    int ld, int act) {
  constexpr int PI = TILE / 16, NJ = H / 16, KC = f32_kc(H), LW = KC + 1;
  const int tp = threadIdx.x / 16, to = threadIdx.x % 16;
  float acc[PI][NJ];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < H; k0 += KC) {
    if (k0) __syncthreads();  // every thread is done with the previous chunk
    for (int v = threadIdx.x; v < H * KC; v += THREADS) {
      const int o = v / KC, c = v % KC;
      ws[o * LW + c] = weight_f(g[(size_t)o * H + k0 + c], s);
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < KC; ++kk) {
      float a[PI], w[NJ];
#pragma unroll
      for (int i = 0; i < PI; ++i) a[i] = hs[(tp + 16 * i) * ld + k0 + kk];
#pragma unroll
      for (int j = 0; j < NJ; ++j) w[j] = ws[(to + 16 * j) * LW + kk];
#pragma unroll
      for (int i = 0; i < PI; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
  }
  __syncthreads();  // every thread has read hs
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int o = to + 16 * j;
      hs[(tp + 16 * i) * ld + o] = activate(acc[i][j] + bh[o], act);
    }
}

// W: float (weights in f32) or int8_t (int8 mode, with scales [K, 8])
template <typename W, int H>
__global__ void __launch_bounds__(THREADS)
f32_kernel(const float* __restrict__ hz, const float* __restrict__ ut, float* __restrict__ out,
           float* __restrict__ u_out, const W* __restrict__ wx, const W* __restrict__ wh,
           const float* __restrict__ bh, const W* __restrict__ wout,
           const float* __restrict__ bout, const float* __restrict__ masks,
           const float* __restrict__ scales, int C, int N, int K, int NH1, float cap, int act,
           unsigned long long seed, float noise_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const F32Smem L(H);
  const int ld = L.ld;
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  float* xs = reinterpret_cast<float*>(smem + L.xs);      // [3][TILE]
  float* sts = reinterpret_cast<float*>(smem + L.st);     // [6][TILE]
  float* wxs = reinterpret_cast<float*>(smem + L.wx);     // [H][3]
  float* hzs = reinterpret_cast<float*>(smem + L.hz);     // [H]
  float* bhs = reinterpret_cast<float*>(smem + L.bh);     // [H]
  float* wos = reinterpret_cast<float*>(smem + L.wout);   // [6][H]
  float* bos = reinterpret_cast<float*>(smem + L.bout);   // [6]

  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TILE;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const size_t cloud = (size_t)b * C * N;

  if (tid < TILE) {
    float x[3];
    base_noise(x, n0 + tid, b, N, cloud, ut, u_out, true, seed, noise_scale);
    for (int c = 0; c < 3; ++c) xs[c * TILE + tid] = x[c];
  }

  for (int i = 0; i < K; ++i) {
    const int k = K - 1 - i;
    __syncthreads();  // previous layer done with xs and the small weights
    const float s_wx = scales ? scales[k * 8] : 1.f;
    const float s_wh = scales ? scales[k * 8 + 1] : 1.f;
    const float s_wo = scales ? scales[k * 8 + 2] : 1.f;
    for (int e = tid; e < 3 * H; e += THREADS) wxs[e] = weight_f(wx[(size_t)k * 3 * H + e], s_wx);
    for (int e = tid; e < H; e += THREADS) hzs[e] = hz[((size_t)b * K + k) * H + e];
    for (int e = tid; e < 6 * H; e += THREADS) wos[e] = weight_f(wout[(size_t)k * 6 * H + e], s_wo);
    if (tid < 6) bos[tid] = bout[k * 6 + tid];
    __syncthreads();

    // h = act(Wx . x + hz)
    for (int e = tid; e < TILE * H; e += THREADS) {
      const int p = e / H, o = e % H;
      float v = wxs[o * 3 + 0] * xs[p];
      v = fmaf(wxs[o * 3 + 1], xs[TILE + p], v);
      v = fmaf(wxs[o * 3 + 2], xs[2 * TILE + p], v);
      hs[p * ld + o] = activate(v + hzs[o], act);
    }

    for (int j = 0; j < NH1; ++j) {
      __syncthreads();  // hs written; the previous product is done with ws, bhs
      const W* g = wh + ((size_t)k * NH1 + j) * H * H;
      for (int e = tid; e < H; e += THREADS) bhs[e] = bh[((size_t)k * NH1 + j) * H + e];
      hidden_gemm<W, H>(hs, ws, g, s_wh, bhs, ld, act);
    }
    __syncthreads();

    // st = Wout . h + bout: one warp per point, lanes split the H sum
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
    __syncthreads();

    // inverse coupling on the transformed coordinates
    if (tid < TILE) {
      for (int c = 0; c < 3; ++c) {
        if (masks[k * 3 + c] > 0.f) continue;
        const float s = cap * tanhf(sts[c * TILE + tid] / cap);
        const float t = sts[(3 + c) * TILE + tid];
        xs[c * TILE + tid] = (xs[c * TILE + tid] - t) * expf(-s);
      }
    }
  }
  __syncthreads();
  if (tid < TILE && n0 + tid < N)
    for (int c = 0; c < 3; ++c) out[cloud + (size_t)c * N + n0 + tid] = xs[c * TILE + tid];
}

// ---------------------------------------------------------------- launch

struct Args {
  const float *hz, *ut;
  float *out, *u_out;
  const void *wx, *wh;
  const float* bh;
  const void* wout;
  const float *bout, *masks, *scales;
  int B, C, N, K, NH1;
  float cap;
  int act;
  unsigned long long seed;
  float noise_scale;
};

template <typename Kern, typename W>
cudaError_t launch(Kern kernel, int bytes, const Args& a, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((a.N + TILE - 1) / TILE, a.B);
  kernel<<<grid, THREADS, bytes, stream>>>(
      a.hz, a.ut, a.out, a.u_out, static_cast<const W*>(a.wx), static_cast<const W*>(a.wh), a.bh,
      static_cast<const W*>(a.wout), a.bout, a.masks, a.scales, a.C, a.N, a.K, a.NH1, a.cap, a.act,
      a.seed, a.noise_scale);
  return cudaGetLastError();
}

template <typename W, int H>
cudaError_t launch_rows(const Args& a, cudaStream_t s) {
  const RowsSmem L(H, a.NH1, std::is_same<W, int8_t>::value);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  if (L.nst == 1) return launch<decltype(&rows_kernel<W, H, false, false>), W>(
      rows_kernel<W, H, false, false>, L.total, a, s);
  if constexpr (H < 256) {
    if (a.act == 0) return launch<decltype(&rows_kernel<W, H, true, true>), W>(
        rows_kernel<W, H, true, true>, L.total, a, s);
    return launch<decltype(&rows_kernel<W, H, false, true>), W>(
        rows_kernel<W, H, false, true>, L.total, a, s);
  }
  return cudaErrorInvalidValue;
}

template <typename W, int H>
cudaError_t launch_f32(const Args& a, cudaStream_t s) {
  return launch<decltype(&f32_kernel<W, H>), W>(f32_kernel<W, H>, F32Smem(H).total, a, s);
}

template <typename W, bool BF16, int H>
cudaError_t launch_h(const Args& a, cudaStream_t s) {
  if constexpr (BF16) return launch_rows<W, H>(a, s);
  else return launch_f32<W, H>(a, s);
}

template <typename W, bool BF16>
cudaError_t dispatch(int H, const Args& a, cudaStream_t s) {
#define DPFX_CASE(HH) \
  case HH: return launch_h<W, BF16, HH>(a, s);
  switch (H) {
    DPFX_CASE(32)
    DPFX_CASE(64)
    DPFX_CASE(128)
    DPFX_CASE(256)
    default: return cudaErrorInvalidValue;
  }
#undef DPFX_CASE
}

}  // namespace

extern "C" {

int dpfx_fused_sampler_smem_bytes(int H, int NH1, int bf16, int int8) {
  return bf16 ? RowsSmem(H, NH1, int8 != 0).total : F32Smem(H).total;
}

// scales: null (wx, wh, wout in the compute dtype) or [K, 8] f32 (int8 mode:
// wx, wh, wout are int8 stacks of the same shapes)
int dpfx_fused_sampler_launch(const float* hz, const float* ut, float* out, float* u_out,
                              const void* wx, const void* wh, const float* bh, const void* wout,
                              const float* bout, const float* masks, int B, int C, int N, int K,
                              int H, int NH1, float cap, int act, int bf16,
                              unsigned long long seed, float noise_scale, const float* scales,
                              void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || C < 3 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const Args a{hz, ut, out, u_out, wx, wh, bh, wout, bout, masks, scales, B, C, N, K, NH1,
               cap, act, seed, noise_scale};
  using BF = __nv_bfloat16;
  cudaError_t e;
  if (scales) e = bf16 ? dispatch<int8_t, true>(H, a, s) : dispatch<int8_t, false>(H, a, s);
  else e = bf16 ? dispatch<BF, true>(H, a, s) : dispatch<float, false>(H, a, s);
  return (int)e;
}

}  // extern "C"
