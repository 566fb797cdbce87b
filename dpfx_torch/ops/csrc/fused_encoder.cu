// Fused PointNet encoder on Hopper (sm_90a): the per-point MLP and the
// max-pool over the points, forward and backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (dpfx/ops/fused_encoder.py:75)
// and `_bwd_kernel` (:98).
//
// Work per point: 2(3 W1 + W1 W2 + ... + W_{L-1} W_L) FLOP forward, 361 kFLOP
// for the flagship's 3 -> 128 -> 128 -> 256 -> 512, 47.3 GFLOP per 64 x 2048
// batch; the backward recomputes the chain and adds the cotangent and
// weight-gradient products, about 3x that. The inputs (the cloud, 0.4 MB of
// weights) and outputs are small: the bound is the tensor cores' rate
// (~0.05 ms forward, ~0.14 ms backward at 989 TFLOP/s bf16).
//
// Design:
//   * The Pallas kernel keeps a whole cloud in one grid step; its [512, N]
//     activation alone is 2 MB at N=2048, far above a block's 227 KB of
//     shared memory. So the points are tiled: grid (ceil(N / T), B), T = 64
//     points (bf16) or 32 (f32), every activation of the tile kept in shared
//     memory, the weights read by the tensor cores straight from L2.
//   * Products: WMMA (bf16 operands, f32 accumulation) in bf16 mode,
//     register-tiled IEEE f32 FMA in f32 mode; layer 0 (3 wide) on the FMA
//     units. Rounding as flax's Dense: the f32 sum rounded to the compute
//     dtype, + bias in the compute dtype, relu.
//   * Forward: each tile writes, per feature, its maximum over its valid
//     points and how many of them reach it. The per-cloud max and the tie
//     count over the whole cloud follow from these partials (order-free).
//   * Backward: the chain is recomputed by the forward's own code (`chain`),
//     so the activations equal the forward's bit for bit and the tie mask
//     (h == g) is exact; the cotangent dg * tie / count * (h > 0) splits
//     evenly among every maximal point of the cloud and skips a feature
//     whose max is 0. Every later cotangent overwrites the activation it is
//     masked by, in place.
//   * The weight gradients sum over every point of every cloud. The grid is
//     persistent, one block per SM: a block walks its tiles in order and
//     adds each tile's gradients of every layer into its own slice of a
//     global scratch, which no other block touches; `reduce_slices` then
//     sums the slices in a fixed order. No float atomics: bit-identical from
//     run to run. The slice (all four layers' dW and db, 727 KB at the
//     flagship widths) does not fit in a block's shared memory, and moving
//     the layer loop outside the tile loop, as fused_train.cu does, would
//     carry every point's W_l-wide cotangent between layers. So the slice
//     lives in global memory, and the scratch is blocks x slice (96 MB on
//     132 SMs) whatever B and N are. The dW products start their WMMA
//     accumulators from the slice and store them back (`gemm_acc`): one
//     fragment load and one store per 16 x 16 tile, not a dependent
//     load-add-store per element.
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
  long long per_slice = 0;
  for (int l = 0; l < P.L; ++l) per_slice += (long long)P.width[l + 1] * (P.width[l] + 1);
  bwd_kernel<S><<<blocks, THREADS, bytes, s>>>(x, P, g, cnt, dg, dx, part, B, N, per_slice);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_reduce(part, grads, 1, blocks, per_slice, s);
}

}  // namespace

extern "C" {

// points per block (the wrappers size the forward's per-tile partials and
// the backward's grid from it)
int dpfx_fused_encoder_tile_points(int bf16) {
  return bf16 ? tile_t<__nv_bfloat16>() : tile_t<float>();
}

int dpfx_fused_encoder_smem_bytes(const int* widths, int L, int bf16) {
  Layers P;
  if (!make_layers(P, nullptr, nullptr, widths, L)) return -1;
  return bf16 ? smem_of<__nv_bfloat16>(P) : smem_of<float>(P);
}

int dpfx_fused_encoder_fwd(const float* x, void* const* w, void* const* b, const int* widths,
                           int L, float* pmax, float* pcnt, int B, int N, int bf16,
                           void* stream) {
  Layers P;
  if (B <= 0 || N <= 0 || B > 65535 || !make_layers(P, w, b, widths, L))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_fwd<__nv_bfloat16>(x, P, pmax, pcnt, B, N, s)
                    : launch_fwd<float>(x, P, pmax, pcnt, B, N, s));
}

int dpfx_fused_encoder_bwd(const float* x, void* const* w, void* const* b, const int* widths,
                           int L, const float* g, const float* cnt, const float* dg, float* dx,
                           float* part, float* grads, int B, int N, int bf16, int blocks,
                           void* stream) {
  Layers P;
  if (B <= 0 || N <= 0 || !make_layers(P, w, b, widths, L)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(bf16 ? launch_bwd<__nv_bfloat16>(x, P, g, cnt, dg, dx, part, grads, B, N, blocks, s)
                    : launch_bwd<float>(x, P, g, cnt, dg, dx, part, grads, B, N, blocks, s));
}

}  // extern "C"
