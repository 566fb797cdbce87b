// Fused inverse point flow for Hopper (sm_90a): all K inverted affine
// couplings of the DPF point flow in one kernel, the points of a tile kept in
// shared memory from the base noise to the output.
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
// Design:
//   * grid (ceil(N / 128), B): one block takes 128 points of one cloud and
//     loops over the K layers inside the kernel, in inverse order.
//   * The whole weight stack (~1.1 MB bf16 at K=32, H=128) does not fit in
//     shared memory, so each layer's weights are staged into shared memory
//     one matrix at a time (Wh at H=128 bf16 is 32 KB); they come from L2,
//     where every block finds them.
//   * The H x H product runs on the tensor cores through WMMA (bf16
//     operands, f32 accumulation) in bf16 mode, and as register-tiled f32
//     FMA in f32 mode (exact IEEE f32, for the tight check against the plain
//     version). Wx and Wout are thin (3 and 6 wide) and run on the FMA units.
//   * Rounding matches the Pallas kernel: operands in the compute dtype, f32
//     accumulation, bias and hz added in f32, the activation in f32, then a
//     cast back to the compute dtype; the coupling update is f32.
//   * The ragged last tile computes on zeros and writes nothing past N.
//   * int8 mode (W = int8_t): Wx, Wh and Wout arrive as int8 with one f32
//     scale per (layer, tensor) (scales [K, 8]: wx, wh, wout), and are
//     dequantized where each layer's weights are staged into shared memory,
//     as rnd<S>(q * s) -- what the Pallas kernel computes in VMEM, and what
//     the compute-dtype mode gets from stacks dequantized on the host, bit
//     for bit. Only the staging differs: a quarter (bf16: half) of the
//     weight bytes come from L2, and one multiply per weight element.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). The
// launch returns cudaGetLastError().

#include "dpfx_common.cuh"

namespace {

using namespace dpfx;

constexpr int TILE = 128;       // points per block

// Shared-memory carve-up; the Python wrapper mirrors it (smem_bytes).
template <typename S>
struct Smem {
  int ld, hs, ws, stage, xs, st, wx, hz, bh, wout, bout, total;
  __host__ __device__ Smem(int H) {
    ld = H + Layout<S>::PAD;
    int o = 0;
    hs = o;    o += round128(TILE * ld * (int)sizeof(S));
    ws = o;    o += round128(H * ld * (int)sizeof(S));
    stage = o; o += round128(WARPS * 256 * 4);
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

// hs[T x H] <- act(hs . W^T + bh), W = ws [H x H] (row o holds output o).
// bf16: tensor cores via WMMA; every warp keeps its output tiles in
// registers until all warps have read hs, then writes them back through a
// per-warp 16 x 16 f32 staging tile.
template <int H>
__device__ void hidden_gemm(__nv_bfloat16* hs, const __nv_bfloat16* ws, const float* bh,
                            float* stage, int ld, int act) {
  using namespace nvcuda;
  constexpr int MT = TILE / 16, NT = H / 16, PER_WARP = MT * NT / WARPS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[PER_WARP];
#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) {
    const int t = warp + WARPS * i, tm = t % MT, tn = t / MT;
    wmma::fill_fragment(acc[i], 0.f);
#pragma unroll 4
    for (int kk = 0; kk < H; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> b;
      wmma::load_matrix_sync(a, hs + tm * 16 * ld + kk, ld);
      wmma::load_matrix_sync(b, ws + tn * 16 * ld + kk, ld);
      wmma::mma_sync(acc[i], a, b, acc[i]);
    }
  }
  __syncthreads();  // every warp has read hs
  float* st = stage + warp * 256;
#pragma unroll
  for (int i = 0; i < PER_WARP; ++i) {
    const int t = warp + WARPS * i, tm = t % MT, tn = t / MT;
    wmma::store_matrix_sync(st, acc[i], 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) {
      const int r = e / 16, c = e % 16, o = tn * 16 + c;
      hs[(tm * 16 + r) * ld + o] = __float2bfloat16_rn(activate(st[e] + bh[o], act));
    }
    __syncwarp();
  }
}

// f32: register-tiled FMA, thread (tp, to) owns points tp + 16i and outputs
// to + 16j; the sums are exact IEEE f32.
template <int H>
__device__ void hidden_gemm(float* hs, const float* ws, const float* bh, float*, int ld,
                            int act) {
  constexpr int PI = TILE / 16, NJ = H / 16;
  const int tp = threadIdx.x / 16, to = threadIdx.x % 16;
  float acc[PI][NJ];
#pragma unroll
  for (int i = 0; i < PI; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  for (int kk = 0; kk < H; ++kk) {
    float a[PI], w[NJ];
#pragma unroll
    for (int i = 0; i < PI; ++i) a[i] = hs[(tp + 16 * i) * ld + kk];
#pragma unroll
    for (int j = 0; j < NJ; ++j) w[j] = ws[(to + 16 * j) * ld + kk];
#pragma unroll
    for (int i = 0; i < PI; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
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

// a stored weight as the compute dtype S sees it: an S as it is, an int8
// q with its scale s as rnd<S>(q * s)
template <typename S, typename W>
__device__ __forceinline__ float weight_f(W v, float s) {
  if constexpr (std::is_same<W, int8_t>::value) return rnd<S>(__fmul_rn((float)v, s));
  else return to_f(v);
}

// stage one H x H matrix g (W per element, int8 with its scale s) into ws as S
template <typename S, typename W, int H>
__device__ void stage_square(S* ws, const W* g, float s, int ld) {
  if constexpr (std::is_same<W, int8_t>::value) {
    for (int v = threadIdx.x; v < H * H; v += THREADS)
      ws[(v / H) * ld + v % H] = from_f<S>(__fmul_rn((float)g[v], s));
  } else {
    load_square<H>(ws, g, ld);
  }
}

// W: the stored weight type, S (compute-dtype mode) or int8_t (int8 mode,
// with scales [K, 8])
template <typename S, typename W, int H>
__global__ void __launch_bounds__(THREADS)
fused_inverse_kernel(const float* __restrict__ hz, const float* __restrict__ ut,
                     float* __restrict__ out, float* __restrict__ u_out,
                     const W* __restrict__ wx, const W* __restrict__ wh,
                     const float* __restrict__ bh, const W* __restrict__ wout,
                     const float* __restrict__ bout, const float* __restrict__ masks,
                     const float* __restrict__ scales,
                     int C, int N, int K, int NH1, float cap, int act,
                     unsigned long long seed, float noise_scale) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<S> L(H);
  const int ld = L.ld;
  S* hs = reinterpret_cast<S*>(smem + L.hs);
  S* ws = reinterpret_cast<S*>(smem + L.ws);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
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

  // base noise: read it, or draw it
  if (tid < TILE) {
    const int n = n0 + tid;
    float x[3] = {0.f, 0.f, 0.f};
    if (n < N) {
      if (ut) {
        for (int c = 0; c < 3; ++c) x[c] = ut[cloud + (size_t)c * N + n];
      } else {
        uint32_t r0[4] = {(uint32_t)n, (uint32_t)b, 0u, 0u};
        uint32_t r1[4] = {(uint32_t)n, (uint32_t)b, 1u, 0u};
        philox(r0, (uint32_t)seed, (uint32_t)(seed >> 32));
        philox(r1, (uint32_t)seed, (uint32_t)(seed >> 32));
        x[0] = box_muller(r0[0], r0[1]) * noise_scale;
        x[1] = box_muller(r0[2], r0[3]) * noise_scale;
        x[2] = box_muller(r1[0], r1[1]) * noise_scale;
        if (u_out)
          for (int c = 0; c < 3; ++c) u_out[cloud + (size_t)c * N + n] = x[c];
      }
    }
    for (int c = 0; c < 3; ++c) xs[c * TILE + tid] = x[c];
  }

  for (int i = 0; i < K; ++i) {
    const int k = K - 1 - i;
    __syncthreads();  // previous layer done with xs and the small weights
    const float s_wx = scales ? scales[k * 8] : 1.f;
    const float s_wh = scales ? scales[k * 8 + 1] : 1.f;
    const float s_wo = scales ? scales[k * 8 + 2] : 1.f;
    for (int e = tid; e < 3 * H; e += THREADS) wxs[e] = weight_f<S>(wx[(size_t)k * 3 * H + e], s_wx);
    for (int e = tid; e < H; e += THREADS) hzs[e] = hz[((size_t)b * K + k) * H + e];
    for (int e = tid; e < 6 * H; e += THREADS) wos[e] = weight_f<S>(wout[(size_t)k * 6 * H + e], s_wo);
    if (tid < 6) bos[tid] = bout[k * 6 + tid];
    __syncthreads();

    // h = act(Wx . x + hz), x and Wx rounded to the compute dtype
    for (int e = tid; e < TILE * H; e += THREADS) {
      const int p = e / H, o = e % H;
      float v = wxs[o * 3 + 0] * rnd<S>(xs[p]);
      v = fmaf(wxs[o * 3 + 1], rnd<S>(xs[TILE + p]), v);
      v = fmaf(wxs[o * 3 + 2], rnd<S>(xs[2 * TILE + p]), v);
      hs[p * ld + o] = from_f<S>(activate(v + hzs[o], act));
    }

    for (int j = 0; j < NH1; ++j) {
      __syncthreads();  // hs written; the previous product is done with ws, bhs
      stage_square<S, W, H>(ws, wh + ((size_t)k * NH1 + j) * H * H, s_wh, ld);
      for (int e = tid; e < H; e += THREADS) bhs[e] = bh[((size_t)k * NH1 + j) * H + e];
      __syncthreads();
      hidden_gemm<H>(hs, ws, bhs, stage, ld, act);
    }
    __syncthreads();

    // st = Wout . h + bout: one warp per point, lanes split the H sum
    for (int p = warp; p < TILE; p += WARPS) {
      float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      for (int kk = lane; kk < H; kk += 32) {
        const float hv = to_f(hs[p * ld + kk]);
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

template <typename S, typename W, int H>
cudaError_t launch(const float* hz, const float* ut, float* out, float* u_out, const void* wx,
                   const void* wh, const float* bh, const void* wout, const float* bout,
                   const float* masks, const float* scales, int B, int C, int N, int K, int NH1,
                   float cap, int act, unsigned long long seed, float noise_scale,
                   cudaStream_t stream) {
  const int bytes = Smem<S>(H).total;
  cudaError_t e = cudaFuncSetAttribute(fused_inverse_kernel<S, W, H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((N + TILE - 1) / TILE, B);
  fused_inverse_kernel<S, W, H><<<grid, THREADS, bytes, stream>>>(
      hz, ut, out, u_out, static_cast<const W*>(wx), static_cast<const W*>(wh), bh,
      static_cast<const W*>(wout), bout, masks, scales, C, N, K, NH1, cap, act, seed, noise_scale);
  return cudaGetLastError();
}

template <typename S, typename W>
cudaError_t dispatch(int H, const float* hz, const float* ut, float* out, float* u_out,
                     const void* wx, const void* wh, const float* bh, const void* wout,
                     const float* bout, const float* masks, const float* scales, int B, int C,
                     int N, int K, int NH1, float cap, int act, unsigned long long seed,
                     float noise_scale, cudaStream_t s) {
#define DPFX_CASE(HH)                                                                       \
  case HH:                                                                                  \
    return launch<S, W, HH>(hz, ut, out, u_out, wx, wh, bh, wout, bout, masks, scales, B, C, \
                            N, K, NH1, cap, act, seed, noise_scale, s);
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

int dpfx_fused_sampler_smem_bytes(int H, int bf16) {
  return bf16 ? Smem<__nv_bfloat16>(H).total : Smem<float>(H).total;
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
  using BF = __nv_bfloat16;
#define DPFX_ARGS H, hz, ut, out, u_out, wx, wh, bh, wout, bout, masks, scales, B, C, N, K, NH1, \
                  cap, act, seed, noise_scale, s
  cudaError_t e;
  if (scales) e = bf16 ? dispatch<BF, int8_t>(DPFX_ARGS) : dispatch<float, int8_t>(DPFX_ARGS);
  else e = bf16 ? dispatch<BF, BF>(DPFX_ARGS) : dispatch<float, float>(DPFX_ARGS);
#undef DPFX_ARGS
  return (int)e;
}

}  // extern "C"
