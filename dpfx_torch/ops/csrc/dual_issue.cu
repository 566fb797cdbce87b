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
// Design: the rows on which the sampler and the training kernels run their
// chains (flow_rows.cuh). Grid (T / 128, G), so that 256 blocks fill the
// card at the defaults. Each warp holds 16 of the block's 128 columns of x
// as A fragments (Rows<128>: a column of x is a row of the product x^T
// W_i^T) and takes them through every layer on its own: each layer is
// hidden_rows with no activation (Ident) and a zero bias, the bf16 cast on
// the accumulator fragments, the result the next layer's A fragments, in
// registers throughout. W_i is double-buffered in shared memory and staged
// with cp.async behind the previous layer's products: one block barrier a
// layer, where W_i becomes visible, and none inside it. Mode B steps each
// lane's 4 v entries (its warp's 16 columns x 8 rows) once per layer, in
// the same warps, after issuing that layer's products. x comes in and goes
// out through a free stage as bf16 [H][LD], read from and written to
// device memory a row of 128 columns at a time (16-byte accesses), and
// turned between rows of x and the warps' fragments by ldmatrix.trans and
// by the fragments' own lanes.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). The
// launch returns cudaGetLastError().

#include "flow_rows.cuh"

namespace {

using namespace dpfx;

constexpr int H = 128;                      // rows of x, the product's width
constexpr int TT = MT;                      // columns of x per block, 16 per warp
constexpr int WBYTES = round128(H * Mma<H>::LD * 2);   // one staged W_i
constexpr int SMEM = 2 * WBYTES;

__device__ __align__(16) float zero_bias[H];   // the chain's bias: zero

// start the cp.async copies of W_i into a stage [H][LD]
__device__ void stage_w(bf16* ws, const bf16* w) {
  constexpr int VPR = H / 8;
  for (int v = threadIdx.x; v < H * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    cp_async16(ws + r * Mma<H>::LD + c, w + (size_t)r * H + c);
  }
  cp_async_commit();
}

template <bool MXU, bool VPU>
__global__ void __launch_bounds__(THREADS)
dual_issue_kernel(const bf16* __restrict__ w, const float* __restrict__ x,
                  const float* __restrict__ v, float* __restrict__ ox, float* __restrict__ ov,
                  int L, int T) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int c0 = blockIdx.x * TT + warp * 16;   // the warp's first column
  const size_t xo = (size_t)blockIdx.y * H * T, vo = (size_t)blockIdx.y * 8 * T;
  auto stage = [&](int s) { return reinterpret_cast<bf16*>(smem + s * WBYTES); };
  constexpr int LD = Mma<H>::LD;
  if (MXU && L > 0) stage_w(stage(0), w);

  // the block's x [H][128] into stage 1 as bf16, then the warp's columns as
  // A fragments: a[kc] holds (column g or g + 8, rows 16 kc + 2t, +1 and
  // +8, +9)
  bf16* xs = stage(1);
  const float* xb = x + xo + blockIdx.x * TT;
  for (int e = threadIdx.x; e < H * TT / 4; e += THREADS) {
    const int r = e / (TT / 4), c = (e % (TT / 4)) * 4;
    const float4 f = *reinterpret_cast<const float4*>(xb + (size_t)r * T + c);
    *reinterpret_cast<uint2*>(xs + r * LD + c) = make_uint2(pack_bf16(f.x, f.y), pack_bf16(f.z, f.w));
  }
  __syncthreads();
  Rows<H> h;
  if (MXU) {
#pragma unroll
    for (int kc = 0; kc < H / 16; ++kc)
      ldsm_x4_t(h.a[kc], xs + (16 * kc + (lane & 7) + ((lane >> 4) & 1) * 8) * LD + warp * 16 +
                             ((lane >> 3) & 1) * 8);
  }
  // the warp's 8 x 16 v entries, 4 a lane
  float vr[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) vr[q] = v[vo + (size_t)(lane / 16 + 2 * q) * T + c0 + lane % 16];

  for (int i = 0; i < L; ++i) {
    if (MXU) {
      cp_async_wait_all();
      __syncthreads();   // W_i is visible; every warp is done with W_{i-1}'s stage
      if (i + 1 < L) stage_w(stage((i + 1) & 1), w + (size_t)(i + 1) * H * H);
      Rows<H> o;
      hidden_rows<H, Ident>(o, h, stage(i & 1), zero_bias, nullptr);
      h = o;
    }
    if (VPU) {
#pragma unroll
      for (int q = 0; q < 4; ++q) vr[q] = expf(vr[q] * 0.25f) - 1.f;
    }
  }

  // x back through the stage the last layer did not read (without the
  // chain x is still in stage 1)
  const bf16* ob = MXU ? stage(L > 0 ? (L & 1) : 0) : xs;
  if (MXU) {
    bf16* os = stage(L > 0 ? (L & 1) : 0);
#pragma unroll
    for (int kc = 0; kc < H / 16; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int col = warp * 16 + g + (i & 1) * 8, row = 16 * kc + 2 * t + (i >> 1) * 8;
        const __nv_bfloat162 v = *reinterpret_cast<const __nv_bfloat162*>(&h.a[kc][i]);
        os[row * LD + col] = v.x;
        os[(row + 1) * LD + col] = v.y;
      }
    __syncthreads();
  }
  float* obx = ox + xo + blockIdx.x * TT;
  for (int e = threadIdx.x; e < H * TT / 4; e += THREADS) {
    const int r = e / (TT / 4), c = (e % (TT / 4)) * 4;
    const uint2 u = *reinterpret_cast<const uint2*>(ob + r * LD + c);
    const float2 a = unpack_bf16(u.x), b = unpack_bf16(u.y);
    *reinterpret_cast<float4*>(obx + (size_t)r * T + c) = make_float4(a.x, a.y, b.x, b.y);
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) ov[vo + (size_t)(lane / 16 + 2 * q) * T + c0 + lane % 16] = vr[q];
}

template <bool MXU, bool VPU>
cudaError_t launch(const bf16* w, const float* x, const float* v, float* ox, float* ov, int L,
                   int G, int T, cudaStream_t stream) {
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
  const auto* wb = static_cast<const bf16*>(w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mxu && vpu) return (int)launch<true, true>(wb, x, v, ox, ov, L, G, T, s);
  if (mxu) return (int)launch<true, false>(wb, x, v, ox, ov, L, G, T, s);
  if (vpu) return (int)launch<false, true>(wb, x, v, ox, ov, L, G, T, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
