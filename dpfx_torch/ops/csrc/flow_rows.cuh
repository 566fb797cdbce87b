// The point flow's conditioner on rows of 16 points per warp, on the tensor
// cores (mma.sync), in bf16: shared by the training forward and backward
// (fused_train.cu's fwd_kernel_mma, bwd_kernel_mma) and the inverse
// (fused_sampler.cu's rows_kernel). Keeping one copy of this code is what
// makes a forward and an inverse over the same passthrough coordinates
// compute the same (s, t) bits.
//
// A tile is 128 points, 16 per warp. A warp takes its rows through the
// whole conditioner on its own: h_0 = act(Wx x + hz) (m16n8k8, K = 3
// padded to 8), each h_{j+1} = act(h_j Wh_j^T + bh_j) (m16n8k16) and
// st = Wout h_last + bout (N = 6 padded to 8). The activations stay in
// registers from one product to the next (two f32 C tiles, packed to bf16,
// are the next product's A fragment); bias, hz, the activation and the cast
// to bf16 apply on the accumulator fragments. Rounding is the Pallas
// kernels': f32 sums, + hz or bias in f32, the activation in f32, one cast.
// Weights come from a stage in shared memory through ldmatrix: Wh
// [n_hidden-1][H][LD], Wout [8][LD] (rows 6, 7 zero), Wx^T [8][LD] (rows
// 3-7 zero), loaded with cp.async (stage_load) and through registers
// (WxRegs) behind the previous layer's work. The backward's row code is
// flow_bwd_rows.cuh. Template parameters NS (rows of Wout: 6) and R
// (coordinates: 3) let the decomposition probe (bench_fused_bwd.cu) fill
// all 8 rows of the same fragments; their defaults are the model's.

#pragma once

#include "dpfx_common.cuh"

// A named namespace only (see dpfx_common.cuh).
namespace dpfx {

using bf16 = __nv_bfloat16;

constexpr int MT = 128;          // points per tile, 16 per warp
constexpr int SMEM_MAX = 232448;  // bytes of shared memory a block may use (sm_90)

// per-H constants of the bf16 kernels
template <int H>
struct Mma {
  static constexpr int LD = H + 8;   // row stride of a shared activation or weight tile
  // the deepest conditioner whose tile fits the backward's shared memory
  static constexpr int NH1_MAX = H == 32 ? 8 : H == 64 ? 3 : H == 128 ? 1 : 0;
  static constexpr int ACC = NH1_MAX > 0 ? NH1_MAX : 1;
  // a warp's block of each dWh: WM m16 tiles x WN n8 tiles, warps GM x GN
  static constexpr int GM = H == 32 ? 2 : 4;
  static constexpr int GN = WARPS / GM;
  static constexpr int WM = NH1_MAX > 0 ? H / 16 / GM : 1;
  static constexpr int WN = NH1_MAX > 0 ? H / 8 / GN : 1;
  // n8 tiles of a column sum that lane (g, t) keeps: nt = g, g + 8, ...
  static constexpr int KEEP = H >= 64 ? H / 64 : 1;
};

// A warp's 16 rows x H as A fragments (bf16 pairs): chunk kc covers
// columns 16kc .. 16kc + 15
template <int H>
struct Rows {
  uint32_t a[H / 16][4];
};

// start the cp.async copies of layer k's Wh and Wout (NS rows) into a
// stage; L.wout is the stage's offset of Wout
template <int H, typename Lay, int NS = 6>
__device__ void stage_load(unsigned char* st, const Lay& L, const bf16* wh, const bf16* wout,
                           int k, int NH1) {
  constexpr int LD = Mma<H>::LD, VPR = H / 8;
  bf16* swh = reinterpret_cast<bf16*>(st);
  bf16* swo = reinterpret_cast<bf16*>(st + L.wout);
  const bf16* gwh = wh + (size_t)k * NH1 * H * H;
  for (int v = threadIdx.x; v < NH1 * H * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    cp_async16(swh + r * LD + c, gwh + (size_t)r * H + c);
  }
  for (int v = threadIdx.x; v < NS * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    cp_async16(swo + r * LD + c, wout + ((size_t)k * NS + r) * H + c);
  }
  cp_async_commit();
}

// Wx [H][R] of a layer, loaded into registers and stored transposed into a
// stage's Wx^T rows 0..R-1 later (the loads run behind other work)
template <int H, int R = 3>
struct WxRegs {
  static constexpr int N = (R * H + THREADS - 1) / THREADS;
  bf16 v[N];
  __device__ void load(const bf16* wx, int k) {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (e < R * H) v[i] = wx[(size_t)k * R * H + e];
    }
  }
  __device__ void store(bf16* wxt) const {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int e = threadIdx.x + i * THREADS;
      if (e < R * H) wxt[(e % R) * Mma<H>::LD + e / R] = v[i];
    }
  }
};

// the training kernels' activation: relu that keeps a NaN
struct ReluNan {
  __device__ __forceinline__ float operator()(float v) const { return relu_nan(v); }
};

// no activation (dual_issue.cu's chain of plain products)
struct Ident {
  __device__ __forceinline__ float operator()(float v) const { return v; }
};

// act(c + bias) of C tile nt, cast to bf16 into the A fragments (and into
// the warp's rows of a shared tile)
template <int H, typename Act>
__device__ __forceinline__ void epi_act(Rows<H>& h, int nt, const float (&c)[4],
                                        const float* bias, bf16* store, const Act& act) {
  constexpr int LD = Mma<H>::LD;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3, col = 8 * nt + 2 * t;
  const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
  const uint32_t lo = pack_bf16(act(c[0] + bb.x), act(c[1] + bb.y));
  const uint32_t hi = pack_bf16(act(c[2] + bb.x), act(c[3] + bb.y));
  h.a[nt >> 1][(nt & 1) * 2] = lo;
  h.a[nt >> 1][(nt & 1) * 2 + 1] = hi;
  if (store) {
    *reinterpret_cast<uint32_t*>(store + g * LD + col) = lo;
    *reinterpret_cast<uint32_t*>(store + (g + 8) * LD + col) = hi;
  }
}

// h_0 = act(Wx x + hz): A the coordinates (k8), B = Wx^T [8][LD] (rows k)
template <int H, typename Act = ReluNan>
__device__ __forceinline__ void first_rows(Rows<H>& h, uint32_t a0, uint32_t a1, const bf16* wxt,
                                           const float* hz, bf16* store, const Act& act = Act()) {
  constexpr int LD = Mma<H>::LD;
  const int lane = lane_id();
#pragma unroll
  for (int q = 0; q < H / 32; ++q) {
    uint32_t b[4];
    ldsm_x4_t(b, wxt + (lane & 7) * LD + 32 * q + (lane >> 3) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma8(c, a0, a1, b[i]);
      epi_act<H>(h, 4 * q + i, c, hz, store, act);
    }
  }
}

// out = act(in Wh^T + bh): B = Wh [out][in] (rows n, k contiguous)
template <int H, typename Act = ReluNan>
__device__ __forceinline__ void hidden_rows(Rows<H>& out, const Rows<H>& in, const bf16* w,
                                            const float* bias, bf16* store,
                                            const Act& act = Act()) {
  constexpr int LD = Mma<H>::LD;
  const int lane = lane_id();
#pragma unroll
  for (int np = 0; np < H / 16; ++np) {
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < H / 16; ++kc) {
      uint32_t b[4];
      ldsm_x4(b, w + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * kc +
                     ((lane >> 3) & 1) * 8);
      mma16(c0, in.a[kc], b[0], b[1]);
      mma16(c1, in.a[kc], b[2], b[3]);
    }
    epi_act<H>(out, 2 * np, c0, bias, store, act);
    epi_act<H>(out, 2 * np + 1, c1, bias, store, act);
  }
}

// st = Wout h + bout: B = Wout [8][LD] (rows n = 0..NS-1, k contiguous); C
// tile columns 0..NS-1 are (s, t) (bout added), the rest zero
template <int H, int NS = 6>
__device__ __forceinline__ void out_rows(float (&c)[4], const Rows<H>& h, const bf16* wout8,
                                         const float* bout) {
  constexpr int LD = Mma<H>::LD;
  const int lane = lane_id(), t = lane & 3;
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = 0.f;
#pragma unroll
  for (int kk = 0; kk < H / 32; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, wout8 + (lane & 7) * LD + 32 * kk + (lane >> 3) * 8);
    mma16(c, h.a[2 * kk], b[0], b[1]);
    mma16(c, h.a[2 * kk + 1], b[2], b[3]);
  }
  if (2 * t < NS) {
    c[0] += bout[2 * t];
    c[1] += bout[2 * t + 1];
    c[2] += bout[2 * t];
    c[3] += bout[2 * t + 1];
  }
}

// (s, t) of C tile st through the warp's [16][8] f32 exchange sw, row p of
// it read back by lanes p and p + 16: sw[p * 8 + c] is s_c, [p * 8 + 3 + c] t_c
__device__ __forceinline__ void st_exchange(float* sw, const float (&st)[4]) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  *reinterpret_cast<float2*>(sw + g * 8 + 2 * t) = make_float2(st[0], st[1]);
  *reinterpret_cast<float2*>(sw + (g + 8) * 8 + 2 * t) = make_float2(st[2], st[3]);
  __syncwarp();
}

}  // namespace dpfx
