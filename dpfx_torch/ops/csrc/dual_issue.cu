// Dual-issue probe on Hopper (sm_90a): does independent FP32/MUFU work run
// under a serial chain of tensor-core products?
//
// Replaces the Pallas TPU kernel `_kernel` (tools/probe_dual_issue.py:43).
// w [L, H, H] bf16, x [G, H, T] and v [G, 8, T] f32. Mode A (MXU): x is
// rounded to bf16, then x <- bf16(W_i x) for i < L, each product on the
// previous one's result (f32 accumulation). Mode B (MXU and VPU): the same
// chain and, in the same warps, L steps v <- expf(v / 4) - 1 on the
// separate v buffer (expf, not __expf), with no data dependence on x.
// Mode C (VPU): the v-chain alone (x is only rounded). Outputs ox (x as
// f32) and ov.
//
// Bound: A's products, 2 G L H^2 T FLOP, 34.4 GFLOP at L=32, G=16, H=128,
// T=2048: 0.035 ms at 989 TFLOP/s bf16, against 33 MB of inputs and outputs
// (0.010 ms at 3.35 TB/s). The v-chain is G L 8 T = 8.4 M exps: 0.002 ms of
// MUFU at 132 SMs x 16 x 1.98 GHz. So B is bound as A is, and C by its
// bytes (x read and written: 0.010 ms).
//
// Design: grid (T / 128, G), so that 256 blocks fill the card at the
// defaults. A block keeps its 128 columns of x in shared memory as bf16
// (two buffers: the product's input and output), stages each W_i (32 KB)
// into shared memory as the sampler stages its weights, and runs the
// 128 x 128 x 128 product on the tensor cores through WMMA (dpfx::gemm).
// Each thread holds 4 of the block's 8 x 128 v entries in registers and
// steps them once per layer, after issuing its part of the product.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). The
// launch returns cudaGetLastError().

#include "dpfx_common.cuh"

namespace {

using namespace dpfx;

constexpr int H = 128;                  // rows of x, the product's width
constexpr int TT = 128;                 // columns of x per block
constexpr int LDX = TT + Layout<__nv_bfloat16>::PAD;
constexpr int LDW = H + Layout<__nv_bfloat16>::PAD;
constexpr int VPT = 8 * TT / THREADS;   // v entries per thread
constexpr int XBYTES = round128(H * LDX * 2);
constexpr int SMEM = 2 * XBYTES + round128(H * LDW * 2) + round128(WARPS * 256 * 4);

template <bool MXU, bool VPU>
__global__ void __launch_bounds__(THREADS)
dual_issue_kernel(const __nv_bfloat16* __restrict__ w, const float* __restrict__ x,
                  const float* __restrict__ v, float* __restrict__ ox, float* __restrict__ ov,
                  int L, int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* cur = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* nxt = reinterpret_cast<__nv_bfloat16*>(smem + XBYTES);
  __nv_bfloat16* ws = reinterpret_cast<__nv_bfloat16*>(smem + 2 * XBYTES);
  float* stage = reinterpret_cast<float*>(smem + 2 * XBYTES + round128(H * LDW * 2));
  const int c0 = blockIdx.x * TT;
  const size_t xo = (size_t)blockIdx.y * H * T, vo = (size_t)blockIdx.y * 8 * T;
  for (int e = threadIdx.x; e < H * TT; e += THREADS)
    cur[(e / TT) * LDX + e % TT] = __float2bfloat16_rn(x[xo + (size_t)(e / TT) * T + c0 + e % TT]);
  float vr[VPT];
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    const int e = threadIdx.x + q * THREADS;
    vr[q] = v[vo + (size_t)(e / TT) * T + c0 + e % TT];
  }
  for (int i = 0; i < L; ++i) {
    if (MXU) {
      __syncthreads();  // cur is written; the previous product is done with ws
      load_square<H>(ws, w + (size_t)i * H * H, LDW);
      __syncthreads();
      __nv_bfloat16* out = nxt;
      gemm<false, false>(H, TT, H, ws, LDW, cur, LDX, stage, nullptr,
                         [&](int m, int n, float val) {
                           out[m * LDX + n] = __float2bfloat16_rn(val);
                           return 0.f;
                         });
      nxt = cur;
      cur = out;
    }
    if (VPU) {
#pragma unroll
      for (int q = 0; q < VPT; ++q) vr[q] = expf(vr[q] * 0.25f) - 1.f;
    }
  }
  __syncthreads();
  for (int e = threadIdx.x; e < H * TT; e += THREADS)
    ox[xo + (size_t)(e / TT) * T + c0 + e % TT] = __bfloat162float(cur[(e / TT) * LDX + e % TT]);
#pragma unroll
  for (int q = 0; q < VPT; ++q) {
    const int e = threadIdx.x + q * THREADS;
    ov[vo + (size_t)(e / TT) * T + c0 + e % TT] = vr[q];
  }
}

template <bool MXU, bool VPU>
cudaError_t launch(const __nv_bfloat16* w, const float* x, const float* v, float* ox, float* ov,
                   int L, int G, int T, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(dual_issue_kernel<MXU, VPU>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (e != cudaSuccess) return e;
  dual_issue_kernel<MXU, VPU><<<dim3(T / TT, G), THREADS, SMEM, stream>>>(w, x, v, ox, ov, L, T);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int dpfx_dual_issue(const void* w, const float* x, const float* v, float* ox, float* ov, int L,
                    int G, int Hx, int T, int mxu, int vpu, void* stream) {
  if (L < 0 || G <= 0 || G > 65535 || Hx != H || T <= 0 || T % TT) return (int)cudaErrorInvalidValue;
  const auto* wb = static_cast<const __nv_bfloat16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mxu && vpu) return (int)launch<true, true>(wb, x, v, ox, ov, L, G, T, s);
  if (mxu) return (int)launch<true, false>(wb, x, v, ox, ov, L, G, T, s);
  if (vpu) return (int)launch<false, true>(wb, x, v, ox, ov, L, G, T, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
