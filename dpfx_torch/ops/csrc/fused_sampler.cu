// Fused inverse point flow for Hopper (sm_90a): all K inverted affine
// couplings of the DPF point flow in one kernel, each point kept on chip
// (or, in the cluster inverse, in L2 between layers) from the base noise
// to the output.
//
// Replaces the Pallas TPU kernels `_fused_inverse_kernel`
// (dpfx/ops/fused_sampler.py:112) and `_fused_sample_kernel` (:309), the
// latter with its int8 mode (`quantized=`, :338-369). Each kernel serves
// both: with `ut == nullptr` it draws the base noise itself (Philox4x32-10
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
// cluster inverse (`inv_cluster`, flow_cluster.cuh; bf16, relu, weights in
// bf16): at the shapes where the training kernels take their cluster
// layout (H=128 with n_hidden 3-4, H=256 with n_hidden 2-3) the wrapper
// routes the inverse onto the training forward's cluster design walked
// backwards: a layer split across H / 64 CTAs, a persistent grid with the
// layer loop outside the groups of tiles (each weight read from L2 once per
// cluster, not once per 128-point tile as rows_kernel<256>'s 1,024 blocks
// do), and the forward's own (s, t) code (cl_st_partials), so a forward and
// its inverse share (s, t) bits there as fwd_kernel_mma and rows_kernel do
// at the flagship's shape. Where rows_kernel timed faster in turns the
// wrapper keeps it (fused_sampler.ROWS_KEPT).
//
// f32 mode (`f32_kernel`): the tight-check mode, IEEE f32 FMA with k in
// order, the block's 128 points in shared memory, one thread per point for
// the coupling, on the device code of flow_f32.cuh (f32_walk walked
// backwards; fused_train.cu's training forward fwd_f32 walks it forwards,
// so the two compute the same (s, t) bits). The hidden products are
// register-tiled (chunk_fma, thread (tp, to): points tp + 16i, outputs to +
// 16j; 128 FFMA per 24 LDS a k) on Wh staged in chunks of KC input columns
// (the whole row up to H=128; 32 at H=256, where one f32 Wh, 263 KB, is
// more than a block holds): every thread keeps its outputs' sums in
// registers across the chunks, so each sum runs k = 0 .. H-1 in order and
// the bits are the whole matrix's at any KC. What bounds it is the FP32
// pipes. From H=128 on (f32_pipe) the float instances stream the chunks
// with cp.async behind the FMAs (two chunk buffers, two small sets: 226,560
// B at H=256; see the header). What is left is the product itself
// (PERF.md: one 256 x 256 product of the 64 x 2048 points at about half
// the FP32 rate): 24 shared-memory wavefronts a k and warp for its 128 FFMA
// a thread, at two warps a scheduler. The int8 instances convert as they
// stage and keep synchronous staging into the first buffer.
//
// The ragged last tile computes on zeros and writes nothing past N.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). The
// launch returns cudaGetLastError().

#include "flow_cluster.cuh"
#include "flow_f32.cuh"

namespace {

using namespace dpfx;

constexpr int TILE = MT;        // points per block

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

// the f32 inverse: the block's 128 points walked backwards through the K
// layers on flow_f32.cuh's device code (f32_walk), the training forward's
// (fused_train.cu's fwd_f32) walked the other way
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
  float* xs = reinterpret_cast<float*>(smem + L.xs);      // [3][TILE]
  const int b = blockIdx.y;
  const int n0 = blockIdx.x * TILE;
  const int tid = threadIdx.x;
  const size_t cloud = (size_t)b * C * N;
  if (tid < TILE) {
    float x[3];
    base_noise(x, n0 + tid, b, N, cloud, ut, u_out, true, seed, noise_scale);
    for (int c = 0; c < 3; ++c) xs[c * TILE + tid] = x[c];
  }
  f32_walk<W, H, false>(smem, L, hz, wx, wh, bh, wout, bout, masks, scales, b, K, NH1, cap,
                        ActRt{act});
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

// The cluster inverse (flow_cluster.cuh's inv_cluster, bf16 relu, weights
// in bf16) at H=128 with n_hidden 3-4 and H=256 with n_hidden 2-3: shared
// memory of one CTA (for any shape: a plan past the limit reports its
// size), the clusters of its persistent grid that the card holds at once,
// and the launch on `clusters` clusters of H / 64 CTAs. ut [B, CR, N] (null:
// draw the noise, into u_out [B, 3, N] where it is not null), out [B, CR,
// N], carry [H / 64, B, 3, N] f32 scratch.
#define DPFX_DISPATCH_INVERSE(H, NH1, CALL)                                             \
  if (H == 128 && NH1 == 2) { constexpr int HH = 128, NN = 2; return (int)(CALL); }     \
  if (H == 128 && NH1 == 3) { constexpr int HH = 128, NN = 3; return (int)(CALL); }     \
  if (H == 256 && NH1 == 1) { constexpr int HH = 256, NN = 1; return (int)(CALL); }     \
  if (H == 256 && NH1 == 2) { constexpr int HH = 256, NN = 2; return (int)(CALL); }     \
  return (int)cudaErrorInvalidValue;

int dpfx_fused_sampler_cluster_smem_bytes(int H, int NH1) {
  return cluster_plan(H, NH1, false).total;
}

int dpfx_fused_sampler_cluster_grid(int H, int NH1) {
  DPFX_DISPATCH_INVERSE(H, NH1, (inverse_grid<HH, NN>()))
}

int dpfx_fused_sampler_cluster_launch(const float* hz, const float* ut, float* out, float* u_out,
                                      float* carry, const void* wx, const void* wh,
                                      const float* bh, const void* wout, const float* bout,
                                      const float* masks, int B, int C, int N, int K, int H,
                                      int NH1, float cap, unsigned long long seed,
                                      float noise_scale, int clusters, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || C < 3 || clusters <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DPFX_DISPATCH_INVERSE(H, NH1, (launch_inv_cluster<HH, NN>(hz, ut, out, u_out, carry, wx, wh, bh,
                                                            wout, bout, masks, B, C, N, K, cap,
                                                            seed, noise_scale, clusters, s)))
}

// the CUDA runtime's text for an error a launch returned
const char* dpfx_fused_sampler_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

}  // extern "C"
