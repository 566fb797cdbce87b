// Fused point flow for training on Hopper (sm_90a): the forward of all K
// affine couplings with the per-cloud log-det, and its backward.
//
// Replaces the Pallas TPU kernels `_fwd_kernel` (dpfx/ops/fused_train.py:131)
// and `_bwd_kernel` (:231).
//
// What bounds them. Per point and layer the conditioner does the Wx (H x 3),
// (n_hidden-1) x Wh (H x H) and Wout (6 x H) products, 2(9H + (n_hidden-1)
// H^2) FLOP forward; the backward recomputes them and adds the cotangent
// and weight-gradient products, 2(27H + 3(n_hidden-1)H^2). At the flagship
// batch (64 x 2048 points, K=32, H=128, n_hidden=2) that is ~147 GFLOP
// forward and ~441 GFLOP backward against a few MB of inputs and outputs:
// the bound is the tensor cores' rate (~0.15 ms and ~0.45 ms at 989 TFLOP/s
// bf16, chip_smoke.py's train_bounds), never memory. So the design keeps
// every product on the tensor cores, keeps the operands a warp reuses in
// registers, and keeps barriers and shared-memory round trips off the path.
//
// bf16 mode (`fwd_kernel_mma`, `bwd_kernel_mma`): warp-level mma.sync.
//   * Rows per warp. A tile is 128 points, 16 per warp. A warp takes its
//     rows through the whole conditioner on its own: h_0 = relu(Wx x + hz)
//     (m16n8k8, K = 3 padded to 8), each h_{j+1} = relu(h_j Wh_j^T + bh_j)
//     (m16n8k16) and st = Wout h_last + bout (N = 6 padded to 8). The
//     activations stay in registers from one product to the next (two f32
//     C tiles, packed to bf16, are the next product's A fragment); bias, hz,
//     relu and the cast to bf16 apply on the accumulator fragments. Rounding
//     is the Pallas kernel's: f32 sums, + hz or bias in f32, relu, one cast;
//     coupling and log-det in f32. Weights come from shared memory through
//     ldmatrix. The forward and the backward's recompute call the same
//     device functions (first_rows, hidden_rows, out_rows, in flow_rows.cuh,
//     which fused_sampler.cu's inverse shares) on the same operands, so the
//     recomputed activations, relu masks and (s, t) are the forward's bit
//     for bit. The backward's body is bwd_rows in flow_bwd_rows.cuh, which
//     bench_fused_bwd.cu's decomposition probe runs on its 8-row layout.
//   * The forward needs no block barrier inside a layer: grid (N / 128, B),
//     one barrier per layer, where the next layer's weights (staged with
//     cp.async while this layer runs) become visible; two per layer where
//     only one layer's weights fit.
//   * The backward: no stored chain. Layer k's input is rebuilt from its
//     output by the closed-form inverse, its conditioner recomputed from the
//     passthrough rows (equal in input and output; the mask is folded into
//     Wx). The cotangent chain runs on the same rows of the same warp:
//     dh_last = rnd(dst) Wout (K = 6 padded to 8), dh_j = (rnd(dh_{j+1}) Wh_j)
//     * (h_j > 0), dy_in = dyn + rnd(dh_0) Wx (N = 3 padded to 8). Bias and
//     hz gradients are column sums of the unrounded f32 fragments (shuffles
//     within the warp, then the warps in order); no float atomics.
//   * Weight gradients sum over every point of every cloud. The grid is
//     persistent, one block per SM, with the layer loop outside the tile
//     loop; each point's (y, dy) is carried in global memory between layers.
//     A warp owns a fixed slice of dWh (a 32 x 64 block at H=128), of dWout
//     and of dWx, and keeps it in registers through the block's whole tile
//     loop of a layer: per tile the products over the tile's 128 points
//     (points as the K dimension, operands through ldmatrix.trans) add into
//     it, and it is written once per layer into the block's slice of a global
//     scratch, which `reduce_slices` sums in a fixed order. Gradients are
//     bit-identical from run to run. Two block barriers per tile: before the
//     weight-gradient products (they sum over every warp's points) and after
//     them (the next tile reuses the buffers).
//   * Layer k-1's weights are staged with cp.async into a second buffer
//     while layer k's tiles run, where shared memory allows (the flagship
//     shape does).
//   * Limits: H in {32, 64, 128, 256}; every activation and cotangent of a
//     tile and a layer's weights sit in shared memory, so the backward takes
//     n_hidden - 1 <= 8, 3, 1, 0 at H = 32, 64, 128, 256 (smem_bytes reports
//     more than a block may use beyond that). Past those limits the wrapper
//     takes the cluster layout (below) for the forward and the backward.
//   Cotangents are cast to bf16 before each product; ragged points carry
//   zero cotangent and no log-det gradient.
//
// f32 mode (`fwd_kernel`, `bwd_kernel`): the tight-check mode, IEEE f32 FMA
// with k in order, block-wide products through shared memory (`gemm`), the
// same persistent layer-outside-tile structure, f32 dWh accumulated in
// shared memory, tile 128 forward and 32 backward.
//
// f32 layout (`fwd_f32`, `bwd_f32`; flow_f32.cuh, the f32 sampler's device
// code): the f32 shapes whose block-wide layout overflows (H=256 with
// n_hidden 1-4, H=128 with n_hidden 3-4), and H=128 with n_hidden 1-2 where
// it timed faster than the block-wide pair in turns. The forward is the
// sampler's 128-point walk run forwards; the backward keeps every level of
// a tile of 32-128 points and runs its three products per hidden layer on
// the same register tile, with Wh streamed by cp.async. See fwd_f32 and
// bwd_f32 below.
//
// cluster layout (`fwd_cluster`, `bwd_cluster`, bf16; flow_cluster.cuh): the
// bf16 shapes whose mma layout overflows a block (H=128 with n_hidden 3-4,
// H=256 with n_hidden 2-4): one layer split across a thread-block cluster of
// H / 64 CTAs, rank r owning hidden columns [64r, 64r + 64). See its header.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). Each
// launch returns cudaGetLastError().

#include "flow_bwd_rows.cuh"
#include "flow_cluster.cuh"
#include "flow_f32.cuh"

namespace {

using namespace dpfx;

// ---------------------------------------------------------------- bf16 mode

// MmaSmem, zero_pads and the backward's body (bwd_rows) are in
// flow_bwd_rows.cuh, shared with bench_fused_bwd.cu's decomposition probe.

template <int H>
__global__ void __launch_bounds__(THREADS, H <= 128 ? 2 : 1)
fwd_kernel_mma(const float* __restrict__ xt, const float* __restrict__ hz, float* __restrict__ u,
               float* __restrict__ ld_part, const bf16* __restrict__ wx,
               const bf16* __restrict__ wh, const float* __restrict__ bh,
               const bf16* __restrict__ wout, const float* __restrict__ bout,
               const float* __restrict__ masks, int N, int K, int NH1, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = Mma<H>::LD;
  const MmaSmem L(H, NH1, false);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int p = lane & 15, b = blockIdx.y, n = blockIdx.x * MT + warp * 16 + p;
  const bool valid = n < N;
  const size_t cloud = (size_t)b * 3 * N;
  float* sw = reinterpret_cast<float*>(smem + L.stw) + warp * 128;
  auto stage = [&](int s) { return smem + L.stage + s * L.stage_bytes; };

  zero_pads<H>(smem, L, false);
  float x[3], ldsum = 0.f;
#pragma unroll
  for (int c = 0; c < 3; ++c) x[c] = valid ? xt[cloud + (size_t)c * N + n] : 0.f;
  WxRegs<H> wr;
  stage_load<H>(stage(0), L, wh, wout, 0, NH1);
  wr.load(wx, 0);
  wr.store(reinterpret_cast<bf16*>(stage(0) + L.wxt));
  for (int k = 0; k < K; ++k) {
    const int s = L.nst == 2 ? (k & 1) : 0;
    if (L.nst == 1 && k > 0) {
      __syncthreads();   // every warp is done with the single stage
      stage_load<H>(stage(0), L, wh, wout, k, NH1);
      wr.load(wx, k);
      wr.store(reinterpret_cast<bf16*>(stage(0) + L.wxt));
    }
    cp_async_wait_all();
    __syncthreads();     // layer k's stage is visible; layer k-1 is done with the other
    const bool ahead = L.nst == 2 && k + 1 < K;
    if (ahead) {
      stage_load<H>(stage(s ^ 1), L, wh, wout, k + 1, NH1);
      wr.load(wx, k + 1);
    }
    const bf16* swh = reinterpret_cast<const bf16*>(stage(s));
    uint32_t a0, a1;
    coord_frag(x, a0, a1);
    Rows<H> h;
    first_rows<H>(h, a0, a1, reinterpret_cast<const bf16*>(stage(s) + L.wxt),
                  hz + ((size_t)b * K + k) * H, nullptr);
    for (int j = 0; j < NH1; ++j) {
      Rows<H> o;
      hidden_rows<H>(o, h, swh + j * H * LD, bh + ((size_t)k * NH1 + j) * H, nullptr);
      h = o;
    }
    float st[4];
    out_rows<H>(st, h, reinterpret_cast<const bf16*>(stage(s) + L.wout), bout + k * 6);
    st_exchange(sw, st);
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      if (masks[k * 3 + c] > 0.f) continue;
      const float sc = cap * tanhf(sw[p * 8 + c] / cap);
      ldsum += sc;
      x[c] = x[c] * expf(sc) + sw[p * 8 + 3 + c];
    }
    __syncwarp();
    if (ahead) wr.store(reinterpret_cast<bf16*>(stage(s ^ 1) + L.wxt));
  }
  if (lane < 16 && valid)
    for (int c = 0; c < 3; ++c) u[cloud + (size_t)c * N + n] = x[c];
  // the block's log-det: the warp's valid points, then the warps in order
  float* ldw = reinterpret_cast<float*>(smem + L.ldw);
  float v = lane < 16 && valid ? ldsum : 0.f;
#pragma unroll
  for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if (lane == 0) ldw[warp] = v;
  __syncthreads();
  if (tid == 0) {
    float a = 0.f;
    for (int w = 0; w < WARPS; ++w) a += ldw[w];
    ld_part[(size_t)b * gridDim.x + blockIdx.x] = a;
  }
}

template <int H>
__global__ void __launch_bounds__(THREADS, 1)
bwd_kernel_mma(float* __restrict__ y, float* __restrict__ dy, const float* __restrict__ dld,
               const float* __restrict__ hz, const bf16* __restrict__ wx,
               const bf16* __restrict__ wh, const float* __restrict__ bh,
               const bf16* __restrict__ wout, const float* __restrict__ bout,
               const float* __restrict__ masks, float* __restrict__ part,
               float* __restrict__ dhz_part, int B, int N, int K, int NH1, float cap) {
  bwd_rows<H>(y, dy, dld, hz, wx, wh, bh, wout, bout, masks, part, dhz_part, B, N, N, K, NH1,
              cap);
}

template <int H>
cudaError_t launch_fwd_mma(const float* xt, const float* hz, float* u, float* ld_part,
                           const void* wx, const void* wh, const float* bh, const void* wout,
                           const float* bout, const float* masks, int B, int N, int K, int NH1,
                           float cap, cudaStream_t stream) {
  const int bytes = MmaSmem(H, NH1, false).total;
  if (bytes > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fwd_kernel_mma<H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((N + MT - 1) / MT, B);
  fwd_kernel_mma<H><<<grid, THREADS, bytes, stream>>>(
      xt, hz, u, ld_part, static_cast<const bf16*>(wx), static_cast<const bf16*>(wh), bh,
      static_cast<const bf16*>(wout), bout, masks, N, K, NH1, cap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_bwd_mma(float* y, float* dy, const float* dld, const float* hz,
                           const void* wx, const void* wh, const float* bh, const void* wout,
                           const float* bout, const float* masks, float* part, float* dhz_part,
                           float* dw, float* dhz, int B, int N, int K, int NH1, float cap,
                           int blocks, cudaStream_t stream) {
  const int bytes = MmaSmem(H, NH1, true).total;
  if (NH1 > Mma<H>::NH1_MAX || bytes > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(bwd_kernel_mma<H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  bwd_kernel_mma<H><<<blocks, THREADS, bytes, stream>>>(
      y, dy, dld, hz, static_cast<const bf16*>(wx), static_cast<const bf16*>(wh), bh,
      static_cast<const bf16*>(wout), bout, masks, part, dhz_part, B, N, K, NH1, cap);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return bwd_rows_reduce<H>(part, dhz_part, dw, dhz, B, N, K, NH1, blocks, stream);
}

// The per-tile pieces of the persistent backward that bwd_kernel and
// bwd_f32 share (S: the stored type of the activations and cotangents, each
// rounded to S where it enters a product): the coupling cotangents with the
// layer input from the closed-form inverse, dWout, dh_last, and dWx with
// this tile's dhz partial and dy_in. Each sum runs over the tile's points in
// order.

// the coupling's cotangents of the tile's T points: from (s, t) in dst
// [6][T] and the layer output and its cotangent (ys, dys [3][T]), the layer
// input xks, d(s, t) into dst and where(mask, dy, dy * es) into dyn
__device__ __forceinline__ void tile_cotangents(int T, int n0, int N, float dld_b,
                                                const float* masks_k, float cap, const float* ys,
                                                const float* dys, float* dst, float* xks,
                                                float* dyn) {
  for (int p = threadIdx.x; p < T; p += THREADS) {
    const bool valid = n0 + p < N;
    const float g_ld = valid ? dld_b : 0.f;
    float st_s[3], st_t[3];
    for (int c = 0; c < 3; ++c) {
      st_s[c] = dst[c * T + p];
      st_t[c] = dst[(3 + c) * T + p];
    }
    for (int c = 0; c < 3; ++c) {
      const float yv = ys[c * T + p], dyv = dys[c * T + p];
      if (masks_k[c] > 0.f) {
        xks[c * T + p] = yv;
        dst[c * T + p] = 0.f;
        dst[(3 + c) * T + p] = 0.f;
        dyn[c * T + p] = dyv;
      } else {
        const float th = tanhf(st_s[c] / cap), es = expf(cap * th);
        const float xk = (yv - st_t[c]) / es;
        const float ds = dyv * xk * es + g_ld;
        xks[c * T + p] = xk;
        dst[c * T + p] = ds * (1.f - th * th);
        dst[(3 + c) * T + p] = dyv;
        dyn[c * T + p] = dyv * es;
      }
    }
  }
}

// dWout += rnd(dst) h_last^T, dbout += sum(dst)
template <typename S, int H>
__device__ __forceinline__ void tile_dwout(int T, int ld, const float* dst, const S* hlast,
                                          float* adwout, float* adbout) {
  for (int e = threadIdx.x; e < 6 * H; e += THREADS) {
    const int r = e / H, o = e % H;
    float s = 0.f;
    for (int p = 0; p < T; ++p) s = fmaf(rnd<S>(dst[r * T + p]), to_f(hlast[p * ld + o]), s);
    adwout[e] += s;
  }
  if (threadIdx.x < 6) {
    float s = 0.f;
    for (int p = 0; p < T; ++p) s += dst[threadIdx.x * T + p];
    adbout[threadIdx.x] += s;
  }
}

// dh_last = (Wout^T rnd(dst)) * (h_last > 0), in place over h_last; its
// column sums into first_sum (added to it where accumulate)
template <typename S, int H>
__device__ __forceinline__ void tile_dh_last(int T, int ld, const float* dst, const float* wos,
                                            S* hlast, float* first_sum, bool accumulate) {
  for (int o = threadIdx.x; o < H; o += THREADS) {
    float w[6];
    for (int r = 0; r < 6; ++r) w[r] = wos[r * H + o];
    float s = 0.f;
    for (int p = 0; p < T; ++p) {
      float v = 0.f;
      for (int r = 0; r < 6; ++r) v = fmaf(w[r], rnd<S>(dst[r * T + p]), v);
      v = v * (to_f(hlast[p * ld + o]) > 0.f ? 1.f : 0.f);
      s += v;
      hlast[p * ld + o] = from_f<S>(v);
    }
    first_sum[o] = accumulate ? first_sum[o] + s : s;
  }
}

// dWx += rnd(dh_0) rnd(x_k)^T; this tile's dhz partial; dy_in = where(mask,
// dy, dy * es) + rnd(Wx)^T rnd(dh_0) (one warp per point) and the layer
// input written over the layer output
template <typename S, int H>
__device__ __forceinline__ void tile_dwx_dy(int T, int ld, int n0, int N, size_t cloud,
                                           const S* dh0, const float* xks, const float* dyn,
                                           const float* wxs, const float* dhzs, float* adwx,
                                           float* dhz_out, float* y, float* dy) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int e = threadIdx.x; e < 3 * H; e += THREADS) {
    const int o = e / 3, c = e % 3;
    float s = 0.f;
    for (int p = 0; p < T; ++p) s = fmaf(to_f(dh0[p * ld + o]), rnd<S>(xks[c * T + p]), s);
    adwx[e] += s;
  }
  for (int e = threadIdx.x; e < H; e += THREADS) dhz_out[e] = dhzs[e];
  for (int p = warp; p < T; p += WARPS) {
    float s[3] = {0.f, 0.f, 0.f};
    for (int o = lane; o < H; o += 32) {
      const float d = to_f(dh0[p * ld + o]);
      for (int c = 0; c < 3; ++c) s[c] = fmaf(wxs[o * 3 + c], d, s[c]);
    }
    for (int c = 0; c < 3; ++c)
      for (int off = 16; off; off >>= 1) s[c] += __shfl_xor_sync(0xffffffffu, s[c], off);
    if (lane == 0 && n0 + p < N)
      for (int c = 0; c < 3; ++c) {
        dy[cloud + (size_t)c * N + n0 + p] = dyn[c * T + p] + s[c];
        y[cloud + (size_t)c * N + n0 + p] = xks[c * T + p];
      }
  }
}

// ---------------------------------------------------------------- f32 mode

constexpr int FWD_T = 128;
constexpr int BWD_T = 32;   // points per backward tile (f32)

// shared-memory carve-ups (dpfx_fused_train_smem_bytes reports their size)
struct FwdSmem {
  int ld, hs0, hs1, ws, stage, xs, st, ldp, wx, wout, bout, hz, bh, total;
  __host__ __device__ FwdSmem(int H, int NH1) {
    ld = H + Layout<float>::PAD;
    const int T = FWD_T;
    int o = 0;
    hs0 = o;   o += round128(T * ld * 4);
    hs1 = o;   o += round128(T * ld * 4);
    ws = o;    o += round128(H * ld * 4);
    stage = o; o += round128(WARPS * 256 * 4);
    xs = o;    o += round128(3 * T * 4);
    st = o;    o += round128(8 * T * 4);
    ldp = o;   o += round128(T * 4);
    wx = o;    o += round128(3 * H * 4);
    wout = o;  o += round128(6 * H * 4);
    bout = o;  o += round128(8 * 4);
    hz = o;    o += round128(H * 4);
    bh = o;    o += round128((NH1 > 1 ? NH1 : 1) * H * 4);
    total = o;
  }
};

struct BwdSmem {
  int ld, lda, hs, ws, awh, stage, colpart, ys, dys, xks, dst, dyn;
  int wx, wout, bout, hz, bh, adwx, adwout, adbout, dhz, adbh, total;
  __host__ __device__ BwdSmem(int H, int NH1) {
    ld = H + Layout<float>::PAD;
    lda = H + 4;
    const int T = BWD_T, nb = NH1 > 1 ? NH1 : 1;
    int o = 0;
    hs = o;      o += (NH1 + 1) * round128(T * ld * 4);
    ws = o;      o += nb * round128(H * ld * 4);
    awh = o;     o += NH1 * round128(H * lda * 4);
    stage = o;   o += round128(WARPS * 256 * 4);
    colpart = o; o += round128(T / 16 * H * 4);
    ys = o;      o += round128(3 * T * 4);
    dys = o;     o += round128(3 * T * 4);
    xks = o;     o += round128(3 * T * 4);
    dst = o;     o += round128(8 * T * 4);
    dyn = o;     o += round128(3 * T * 4);
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
};

// h_0 = relu(Wx . x + hz) for T points: x [3][T], Wx [H][3]
template <int H>
__device__ void first_layer(float* h, int ld, const float* xs, int T, const float* wxs,
                            const float* hzs) {
  for (int e = threadIdx.x; e < T * H; e += THREADS) {
    const int p = e / H, o = e % H;
    float v = wxs[o * 3 + 0] * xs[p];
    v = fmaf(wxs[o * 3 + 1], xs[T + p], v);
    v = fmaf(wxs[o * 3 + 2], xs[2 * T + p], v);
    h[p * ld + o] = relu_nan(v + hzs[o]);
  }
}

// st[r][p] = Wout[r] . h[p] + bout[r]: one warp per point, lanes split H
template <int H>
__device__ void out_layer(float* sts, const float* h, int ld, int T, const float* wos,
                          const float* bos) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < T; p += WARPS) {
    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int kk = lane; kk < H; kk += 32) {
      const float hv = h[p * ld + kk];
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

// the conditioner of layer k on the T points of xs: h_0 .. h_NH1 into
// hs + j * hstride, with Wh[j] staged at ws + j * wstride
template <int H>
__device__ void conditioner(float* hs, int hstride, const float* ws, int wstride, int ld, int NH1,
                            const float* xs, int T, const float* wxs, const float* hzs,
                            const float* bhs, float* stage) {
  first_layer<H>(hs, ld, xs, T, wxs, hzs);
  for (int j = 0; j < NH1; ++j) {
    __syncthreads();
    float* out = hs + (j + 1) * hstride;
    const float* bj = bhs + j * H;
    gemm<false, true>(T, H, H, hs + j * hstride, ld, ws + j * wstride, ld, stage, nullptr,
                      [&](int m, int n, float v) {
                        out[m * ld + n] = relu_nan(v + bj[n]);
                        return 0.f;
                      });
  }
}

template <int H>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const float* __restrict__ xt, const float* __restrict__ hz, float* __restrict__ u,
           float* __restrict__ ld_part, const float* __restrict__ wx, const float* __restrict__ wh,
           const float* __restrict__ bh, const float* __restrict__ wout,
           const float* __restrict__ bout, const float* __restrict__ masks, int N, int K,
           int NH1, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int T = FWD_T;
  const FwdSmem L(H, NH1);
  const int ld = L.ld;
  float* hs0 = reinterpret_cast<float*>(smem + L.hs0);
  float* hs1 = reinterpret_cast<float*>(smem + L.hs1);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* xs = reinterpret_cast<float*>(smem + L.xs);      // [3][T]
  float* sts = reinterpret_cast<float*>(smem + L.st);     // [6][T]
  float* ldp = reinterpret_cast<float*>(smem + L.ldp);    // [T]
  float* wxs = reinterpret_cast<float*>(smem + L.wx);
  float* wos = reinterpret_cast<float*>(smem + L.wout);
  float* bos = reinterpret_cast<float*>(smem + L.bout);
  float* hzs = reinterpret_cast<float*>(smem + L.hz);
  float* bhs = reinterpret_cast<float*>(smem + L.bh);

  const int b = blockIdx.y, n0 = blockIdx.x * T, tid = threadIdx.x;
  const size_t cloud = (size_t)b * 3 * N;
  if (tid < T) {
    const int n = n0 + tid;
    for (int c = 0; c < 3; ++c) xs[c * T + tid] = n < N ? xt[cloud + (size_t)c * N + n] : 0.f;
    ldp[tid] = 0.f;
  }
  for (int k = 0; k < K; ++k) {
    __syncthreads();  // the previous layer is done with xs and the small weights
    for (int e = tid; e < 3 * H; e += THREADS) wxs[e] = wx[(size_t)k * 3 * H + e];
    for (int e = tid; e < 6 * H; e += THREADS) wos[e] = wout[(size_t)k * 6 * H + e];
    if (tid < 6) bos[tid] = bout[k * 6 + tid];
    for (int e = tid; e < H; e += THREADS) hzs[e] = hz[((size_t)b * K + k) * H + e];
    for (int e = tid; e < NH1 * H; e += THREADS) bhs[e] = bh[(size_t)k * NH1 * H + e];
    __syncthreads();
    first_layer<H>(hs0, ld, xs, T, wxs, hzs);
    float* cur = hs0;
    float* nxt = hs1;
    for (int j = 0; j < NH1; ++j) {
      __syncthreads();  // cur written; the previous product is done with ws
      load_square<H>(ws, wh + ((size_t)k * NH1 + j) * H * H, ld);
      __syncthreads();
      const float* bj = bhs + j * H;
      float* out = nxt;
      gemm<false, true>(T, H, H, cur, ld, ws, ld, stage, nullptr, [&](int m, int n, float v) {
        out[m * ld + n] = relu_nan(v + bj[n]);
        return 0.f;
      });
      nxt = cur;
      cur = out;
    }
    __syncthreads();
    out_layer<H>(sts, cur, ld, T, wos, bos);
    __syncthreads();
    if (tid < T) {
      for (int c = 0; c < 3; ++c) {
        if (masks[k * 3 + c] > 0.f) continue;
        const float s = cap * tanhf(sts[c * T + tid] / cap);
        ldp[tid] += s;
        xs[c * T + tid] = xs[c * T + tid] * expf(s) + sts[(3 + c) * T + tid];
      }
    }
  }
  __syncthreads();
  if (tid < T && n0 + tid < N)
    for (int c = 0; c < 3; ++c) u[cloud + (size_t)c * N + n0 + tid] = xs[c * T + tid];
  if (tid < 32) {
    float s = 0.f;
    for (int p = tid; p < T; p += 32) s += n0 + p < N ? ldp[p] : 0.f;
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tid == 0) ld_part[(size_t)b * gridDim.x + blockIdx.x] = s;
  }
}

template <int H>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(float* __restrict__ y, float* __restrict__ dy, const float* __restrict__ dld,
           const float* __restrict__ hz, const float* __restrict__ wx, const float* __restrict__ wh,
           const float* __restrict__ bh, const float* __restrict__ wout,
           const float* __restrict__ bout, const float* __restrict__ masks,
           float* __restrict__ part, float* __restrict__ dhz_part, int B, int N, int K, int NH1,
           float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int T = BWD_T;
  const BwdSmem L(H, NH1);
  const int ld = L.ld, lda = L.lda;
  const int hstride = round128(T * ld * 4) / 4;
  const int wstride = round128(H * ld * 4) / 4;
  const int astride = round128(H * lda * 4) / 4;
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  float* awh = reinterpret_cast<float*>(smem + L.awh);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* colpart = reinterpret_cast<float*>(smem + L.colpart);
  float* ys = reinterpret_cast<float*>(smem + L.ys);      // [3][T] layer output
  float* dys = reinterpret_cast<float*>(smem + L.dys);    // [3][T] its cotangent
  float* xks = reinterpret_cast<float*>(smem + L.xks);    // [3][T] layer input
  float* dst = reinterpret_cast<float*>(smem + L.dst);    // [6][T] d(s, t)
  float* dyn = reinterpret_cast<float*>(smem + L.dyn);    // [3][T] where(mask, dy, dy*es)
  float* wxs = reinterpret_cast<float*>(smem + L.wx);
  float* wos = reinterpret_cast<float*>(smem + L.wout);
  float* bos = reinterpret_cast<float*>(smem + L.bout);
  float* hzs = reinterpret_cast<float*>(smem + L.hz);
  float* bhs = reinterpret_cast<float*>(smem + L.bh);
  float* adwx = reinterpret_cast<float*>(smem + L.adwx);      // [H][3]
  float* adwout = reinterpret_cast<float*>(smem + L.adwout);  // [6][H]
  float* adbout = reinterpret_cast<float*>(smem + L.adbout);  // [6]
  float* dhzs = reinterpret_cast<float*>(smem + L.dhz);       // [H] this tile's dhz
  float* adbh = reinterpret_cast<float*>(smem + L.adbh);      // [NH1][H]

  const int tid = threadIdx.x;
  const int nt = (N + T - 1) / T, tiles = B * nt;
  const int per_layer = 3 * H + NH1 * H * H + NH1 * H + 6 * H + 6;
  float* hlast = hs + NH1 * hstride;

  for (int i = 0; i < K; ++i) {
    const int k = K - 1 - i;
    __syncthreads();  // the previous layer's partials are written
    for (int e = tid; e < 3 * H; e += THREADS) wxs[e] = wx[(size_t)k * 3 * H + e];
    for (int e = tid; e < 6 * H; e += THREADS) wos[e] = wout[(size_t)k * 6 * H + e];
    if (tid < 6) bos[tid] = bout[k * 6 + tid];
    for (int e = tid; e < NH1 * H; e += THREADS) bhs[e] = bh[(size_t)k * NH1 * H + e];
    for (int j = 0; j < NH1; ++j) load_square<H>(ws + j * wstride, wh + ((size_t)k * NH1 + j) * H * H, ld);
    for (int j = 0; j < NH1; ++j)
      for (int e = tid; e < H * lda; e += THREADS) awh[j * astride + e] = 0.f;
    for (int e = tid; e < 3 * H; e += THREADS) adwx[e] = 0.f;
    for (int e = tid; e < 6 * H; e += THREADS) adwout[e] = 0.f;
    if (tid < 6) adbout[tid] = 0.f;
    for (int e = tid; e < NH1 * H; e += THREADS) adbh[e] = 0.f;

    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int b = tile / nt, n0 = (tile % nt) * T;
      const size_t cloud = (size_t)b * 3 * N;
      __syncthreads();  // the previous tile is done with the shared buffers
      if (tid < T) {
        const int n = n0 + tid;
        for (int c = 0; c < 3; ++c) {
          ys[c * T + tid] = n < N ? y[cloud + (size_t)c * N + n] : 0.f;
          dys[c * T + tid] = n < N ? dy[cloud + (size_t)c * N + n] : 0.f;
        }
      }
      for (int e = tid; e < H; e += THREADS) hzs[e] = hz[((size_t)b * K + k) * H + e];
      __syncthreads();

      // the forward conditioner, recomputed from the layer output
      conditioner<H>(hs, hstride, ws, wstride, ld, NH1, ys, T, wxs, hzs, bhs, stage);
      __syncthreads();
      out_layer<H>(dst, hlast, ld, T, wos, bos);   // st into dst, overwritten below
      __syncthreads();

      tile_cotangents(T, n0, N, dld[b], masks + k * 3, cap, ys, dys, dst, xks, dyn);
      __syncthreads();
      tile_dwout<float, H>(T, ld, dst, hlast, adwout, adbout);
      __syncthreads();
      float* first_sum = NH1 > 0 ? adbh + (NH1 - 1) * H : dhzs;
      tile_dh_last<float, H>(T, ld, dst, wos, hlast, first_sum, NH1 > 0);

      for (int j = NH1 - 1; j >= 0; --j) {
        float* dh = hs + (j + 1) * hstride;   // cotangent of h_{j+1}, masked
        float* hj = hs + j * hstride;
        float* acc = awh + j * astride;
        __syncthreads();
        // dWh[j] += dh^T h_j (zeroed before the tile loop)
        gemm_acc<true, false>(H, H, T, dh, ld, hj, ld, acc, lda, false);
        __syncthreads();
        // dh_j = (dh Wh[j]) * (h_j > 0), in place over h_j
        gemm<false, false>(T, H, H, dh, ld, ws + j * wstride, ld, stage, colpart,
                           [&](int m, int n, float v) {
                             const float mv = v * (hj[m * ld + n] > 0.f ? 1.f : 0.f);
                             hj[m * ld + n] = mv;
                             return mv;
                           });
        __syncthreads();
        // db of hidden layer j-1 (summed over the tiles), or this tile's dhz
        column_sums<float>(T, H, colpart, hj, ld, j > 0 ? adbh + (j - 1) * H : dhzs, j > 0);
      }
      __syncthreads();

      tile_dwx_dy<float, H>(T, ld, n0, N, cloud, hs, xks, dyn, wxs, dhzs, adwx,
                            dhz_part + ((size_t)tile * K + k) * H, y, dy);
    }
    __syncthreads();
    // this block's partial of layer k: [dWx | dWh | dbh | dWout | dbout]
    float* out = part + ((size_t)blockIdx.x * K + k) * per_layer;
    for (int e = tid; e < 3 * H; e += THREADS) out[e] = adwx[e];
    out += 3 * H;
    for (int e = tid; e < NH1 * H * H; e += THREADS) {
      const int j = e / (H * H), r = (e / H) % H, c = e % H;
      out[e] = awh[j * astride + r * lda + c];
    }
    out += NH1 * H * H;
    for (int e = tid; e < NH1 * H; e += THREADS) out[e] = adbh[e];
    out += NH1 * H;
    for (int e = tid; e < 6 * H; e += THREADS) out[e] = adwout[e];
    out += 6 * H;
    if (tid < 6) out[tid] = adbout[tid];
  }
}

// ---------------------------------------------------------------- f32 layout

// The f32 forward on the sampler's block (flow_f32.cuh): 128 points, the
// layers walked forwards on f32_walk, the inverse's own device code, so u
// (each element one k-sum in order) has the bits of every f32 forward and
// the sampler's f32_kernel inverts it on the same (s, t) bits. The block's
// log-det as fwd_kernel sums it.
template <int H>
__global__ void __launch_bounds__(THREADS)
fwd_f32(const float* __restrict__ xt, const float* __restrict__ hz, float* __restrict__ u,
        float* __restrict__ ld_part, const float* __restrict__ wx, const float* __restrict__ wh,
        const float* __restrict__ bh, const float* __restrict__ wout,
        const float* __restrict__ bout, const float* __restrict__ masks, int N, int K, int NH1,
        float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int T = F32_T;
  const F32Smem L(H, true);
  float* xs = reinterpret_cast<float*>(smem + L.xs);      // [3][T]
  float* ldp = reinterpret_cast<float*>(smem + L.ldp);    // [T]
  const int b = blockIdx.y, n0 = blockIdx.x * T, tid = threadIdx.x;
  const size_t cloud = (size_t)b * 3 * N;
  if (tid < T) {
    const int n = n0 + tid;
    for (int c = 0; c < 3; ++c) xs[c * T + tid] = n < N ? xt[cloud + (size_t)c * N + n] : 0.f;
    ldp[tid] = 0.f;
  }
  f32_walk<float, H, true>(smem, L, hz, wx, wh, bh, wout, bout, masks, nullptr, b, K, NH1, cap,
                           ReluNan{});
  if (tid < T && n0 + tid < N)
    for (int c = 0; c < 3; ++c) u[cloud + (size_t)c * N + n0 + tid] = xs[c * T + tid];
  if (tid < 32) {
    float s = 0.f;
    for (int p = tid; p < T; p += 32) s += n0 + p < N ? ldp[p] : 0.f;
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tid == 0) ld_part[(size_t)b * gridDim.x + blockIdx.x] = s;
  }
}

// The f32 backward (F32BwdSmem): a persistent grid, the layer loop outside
// the tile loop, bwd_kernel's coupling, dWout, dWx, dhz and dy code, with the
// products on flow_f32.cuh's register tile. Per tile of T points: the
// forward's levels recomputed (chunk_fma on row chunks of Wh, as the
// forward: the same bits at any T), then per hidden product from the last:
// dWh_j += dh^T h_j (dwh_pass) straight into the block's slice of the
// partials, and dh_j = (dh Wh_j) * (h_j > 0) on chunk_fma over transposed
// chunks of Wh's rows, each sum over Wh's rows in order. The chunks of a
// tile (recompute, then cotangent) and across tiles and layers form one
// sequence streamed with cp.async into two buffers, chunk q + 1 behind the
// FMAs of chunk q. Thread grid of the products: 8 x 32 at H=256 (8 points x
// 8 outputs at T=64: 64 FFMA per 16 LDS a k), 16 x 16 at H=128.
template <int H, int T>
__global__ void __launch_bounds__(THREADS, 1)
bwd_f32(float* __restrict__ y, float* __restrict__ dy, const float* __restrict__ dld,
        const float* __restrict__ hz, const float* __restrict__ wx, const float* __restrict__ wh,
        const float* __restrict__ bh, const float* __restrict__ wout,
        const float* __restrict__ bout, const float* __restrict__ masks,
        float* __restrict__ part, float* __restrict__ dhz_part, int B, int N, int K, int NH1,
        float cap) {
  constexpr int KC = F32_BWD_KC, NC = H / KC, TP = H >= 256 ? 8 : 16, TO = THREADS / TP;
  constexpr int PI = T / TP, NJ = H / TO;
  extern __shared__ __align__(128) unsigned char smem[];
  const F32BwdSmem L(H, NH1);
  const int ld = L.ld, hst = L.hstride / 4;
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* ys = reinterpret_cast<float*>(smem + L.ys);      // [3][T] layer output
  float* dys = reinterpret_cast<float*>(smem + L.dys);    // [3][T] its cotangent
  float* xks = reinterpret_cast<float*>(smem + L.xks);    // [3][T] layer input
  float* dst = reinterpret_cast<float*>(smem + L.dst);    // [6][T] (s, t), then d(s, t)
  float* dyn = reinterpret_cast<float*>(smem + L.dyn);    // [3][T] where(mask, dy, dy*es)
  float* wxs = reinterpret_cast<float*>(smem + L.wx);
  float* wos = reinterpret_cast<float*>(smem + L.wout);
  float* bos = reinterpret_cast<float*>(smem + L.bout);
  float* hzs = reinterpret_cast<float*>(smem + L.hz);
  float* bhs = reinterpret_cast<float*>(smem + L.bh);
  float* adwx = reinterpret_cast<float*>(smem + L.adwx);      // [H][3]
  float* adwout = reinterpret_cast<float*>(smem + L.adwout);  // [6][H]
  float* adbout = reinterpret_cast<float*>(smem + L.adbout);  // [6]
  float* dhzs = reinterpret_cast<float*>(smem + L.dhz);       // [H] this tile's dhz
  float* adbh = reinterpret_cast<float*>(smem + L.adbh);      // [NH1][H]
  auto wbuf = [&](int s) { return reinterpret_cast<float*>(smem + L.ws + s * L.wbuf); };

  const int tid = threadIdx.x;
  const int tp = tid / TO, to = tid % TO;
  const int nt = (N + T - 1) / T, tiles = B * nt;
  const int per_layer = f32_part_row(H, NH1);
  const int nq = 2 * NH1 * NC;   // chunks a tile: the recompute's, then the cotangents'
  float* hlast = hs + NH1 * hst;

  // chunk q of a tile of walk step i (layer K-1-i) into buffer s, committed
  auto chunk_load = [&](int i, int q, int s) {
    const int k = K - 1 - i;
    if (q < NH1 * NC) {
      bwd_chunk<H, true>(wbuf(s), wh + ((size_t)k * NH1 + q / NC) * H * H, q % NC);
    } else {
      const int r = q - NH1 * NC;
      bwd_chunk<H, false>(wbuf(s), wh + ((size_t)k * NH1 + NH1 - 1 - r / NC) * H * H, r % NC);
    }
    cp_async_commit();
  };
  int used = 0;   // chunks consumed: the next is in buffer used & 1
  // chunk q of the tile has landed and every thread is done with the one
  // before (whose buffer the copy of the next chunk of the walk then takes)
  auto next_chunk = [&](int i, int q, bool more_tiles) {
    cp_async_wait_all();
    __syncthreads();
    const int s = (used + 1) & 1;
    if (q + 1 < nq) chunk_load(i, q + 1, s);
    else if (more_tiles) chunk_load(i, 0, s);
    else if (i + 1 < K) chunk_load(i + 1, 0, s);
    return wbuf(used++ & 1);
  };

  if (nq) chunk_load(0, 0, 0);
  for (int i = 0; i < K; ++i) {
    const int k = K - 1 - i;
    __syncthreads();  // the previous layer's partials are written
    for (int e = tid; e < 3 * H; e += THREADS) wxs[e] = wx[(size_t)k * 3 * H + e];
    for (int e = tid; e < 6 * H; e += THREADS) wos[e] = wout[(size_t)k * 6 * H + e];
    if (tid < 6) bos[tid] = bout[k * 6 + tid];
    for (int e = tid; e < NH1 * H; e += THREADS) bhs[e] = bh[(size_t)k * NH1 * H + e];
    for (int e = tid; e < 3 * H; e += THREADS) adwx[e] = 0.f;
    for (int e = tid; e < 6 * H; e += THREADS) adwout[e] = 0.f;
    if (tid < 6) adbout[tid] = 0.f;
    for (int e = tid; e < NH1 * H; e += THREADS) adbh[e] = 0.f;
    float* slice = part + ((size_t)blockIdx.x * K + k) * per_layer;   // this block's partial

    bool first = true;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const bool more = tile + (int)gridDim.x < tiles;
      const int b = tile / nt, n0 = (tile % nt) * T;
      const size_t cloud = (size_t)b * 3 * N;
      __syncthreads();  // the previous tile is done with the shared buffers
      for (int p = tid; p < T; p += THREADS) {
        const int n = n0 + p;
        for (int c = 0; c < 3; ++c) {
          ys[c * T + p] = n < N ? y[cloud + (size_t)c * N + n] : 0.f;
          dys[c * T + p] = n < N ? dy[cloud + (size_t)c * N + n] : 0.f;
        }
      }
      for (int e = tid; e < H; e += THREADS) hzs[e] = hz[((size_t)b * K + k) * H + e];
      __syncthreads();

      // the forward conditioner, recomputed from the layer output
      first_layer_f32<H>(hs, ld, ys, T, wxs, hzs, ReluNan{});
      int q = 0;
      for (int j = 0; j < NH1; ++j) {
        float acc[PI][NJ];
#pragma unroll
        for (int ii = 0; ii < PI; ++ii)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) acc[ii][jj] = 0.f;
        for (int c = 0; c < NC; ++c, ++q)
          chunk_fma<H, KC, TP, PI>(acc, hs + j * hst, next_chunk(i, q, more), ld, c * KC);
        float* out = hs + (j + 1) * hst;
        const float* bj = bhs + j * H;
#pragma unroll
        for (int ii = 0; ii < PI; ++ii)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            const int o = to + TO * jj;
            out[(tp + TP * ii) * ld + o] = relu_nan(acc[ii][jj] + bj[o]);
          }
      }
      __syncthreads();
      st_f32<H>(dst, hlast, ld, T, wos, bos);   // st into dst, overwritten below
      __syncthreads();

      tile_cotangents(T, n0, N, dld[b], masks + k * 3, cap, ys, dys, dst, xks, dyn);
      __syncthreads();
      tile_dwout<float, H>(T, ld, dst, hlast, adwout, adbout);
      __syncthreads();
      float* first_sum = NH1 > 0 ? adbh + (NH1 - 1) * H : dhzs;
      tile_dh_last<float, H>(T, ld, dst, wos, hlast, first_sum, NH1 > 0);

      for (int j = NH1 - 1; j >= 0; --j) {
        float* dh = hs + (j + 1) * hst;   // cotangent of h_{j+1}, masked
        float* hj = hs + j * hst;
        __syncthreads();
        dwh_pass<H>(slice + 3 * H + (size_t)j * H * H, dh, hj, ld, T, first);
        // dh_j = (dh Wh_j) * (h_j > 0), in place over h_j (every thread
        // has read h_j in dwh_pass before the first chunk's barrier)
        float acc[PI][NJ];
#pragma unroll
        for (int ii = 0; ii < PI; ++ii)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) acc[ii][jj] = 0.f;
        for (int c = 0; c < NC; ++c, ++q)
          chunk_fma<H, KC, TP, PI>(acc, dh, next_chunk(i, q, more), ld, c * KC);
#pragma unroll
        for (int ii = 0; ii < PI; ++ii)
#pragma unroll
          for (int jj = 0; jj < NJ; ++jj) {
            float* e = hj + (tp + TP * ii) * ld + to + TO * jj;
            *e = acc[ii][jj] * (*e > 0.f ? 1.f : 0.f);
          }
        __syncthreads();
        // db of hidden layer j-1 (summed over the tiles), or this tile's dhz
        column_sums<float>(T, H, nullptr, hj, ld, j > 0 ? adbh + (j - 1) * H : dhzs, j > 0);
      }
      first = false;
      __syncthreads();

      tile_dwx_dy<float, H>(T, ld, n0, N, cloud, hs, xks, dyn, wxs, dhzs, adwx,
                            dhz_part + ((size_t)tile * K + k) * H, y, dy);
    }
    __syncthreads();
    // this block's partial of layer k: [dWx | dWh (written by dwh_pass) |
    // dbh | dWout | dbout | zero padding]
    float* out = slice;
    for (int e = tid; e < 3 * H; e += THREADS) out[e] = adwx[e];
    out += 3 * H + NH1 * H * H;
    for (int e = tid; e < NH1 * H; e += THREADS) out[e] = adbh[e];
    out += NH1 * H;
    for (int e = tid; e < 6 * H; e += THREADS) out[e] = adwout[e];
    out += 6 * H;
    if (tid < 6) out[tid] = adbout[tid];
    const int pad = per_layer - (3 * H + NH1 * H * H + NH1 * H + 6 * H + 6);
    if (tid < pad) out[6 + tid] = 0.f;
  }
}

template <int H>
cudaError_t launch_fwd_f32(const float* xt, const float* hz, float* u, float* ld_part,
                           const void* wx, const void* wh, const float* bh, const void* wout,
                           const float* bout, const float* masks, int B, int N, int K, int NH1,
                           float cap, cudaStream_t stream) {
  const int bytes = F32Smem(H, true).total;
  cudaError_t e = cudaFuncSetAttribute(fwd_f32<H>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((N + F32_T - 1) / F32_T, B);
  fwd_f32<H><<<grid, THREADS, bytes, stream>>>(
      xt, hz, u, ld_part, static_cast<const float*>(wx), static_cast<const float*>(wh), bh,
      static_cast<const float*>(wout), bout, masks, N, K, NH1, cap);
  return cudaGetLastError();
}

template <int H, int T>
cudaError_t launch_bwd_f32_t(float* y, float* dy, const float* dld, const float* hz,
                             const void* wx, const void* wh, const float* bh, const void* wout,
                             const float* bout, const float* masks, float* part, float* dhz_part,
                             float* dw, float* dhz, int B, int N, int K, int NH1, float cap,
                             int blocks, cudaStream_t stream) {
  const int bytes = F32BwdSmem(H, NH1).total;
  cudaError_t e = cudaFuncSetAttribute(bwd_f32<H, T>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  bwd_f32<H, T><<<blocks, THREADS, bytes, stream>>>(
      y, dy, dld, hz, static_cast<const float*>(wx), static_cast<const float*>(wh), bh,
      static_cast<const float*>(wout), bout, masks, part, dhz_part, B, N, K, NH1, cap);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int nt = (N + T - 1) / T;
  if ((e = launch_reduce(part, dw, 1, blocks, (long long)f32_part_row(H, NH1) * K, stream)) !=
      cudaSuccess)
    return e;
  return launch_reduce(dhz_part, dhz, B, nt, (long long)K * H, stream);
}

// the instances of the backward's plan: T = 64 or 32 at H=256, 128 or 64
// at H=128 (F32BwdSmem picks by n_hidden)
template <int H>
cudaError_t launch_bwd_f32(float* y, float* dy, const float* dld, const float* hz,
                           const void* wx, const void* wh, const float* bh, const void* wout,
                           const float* bout, const float* masks, float* part, float* dhz_part,
                           float* dw, float* dhz, int B, int N, int K, int NH1, float cap,
                           int blocks, cudaStream_t stream) {
  const F32BwdSmem L(H, NH1);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  constexpr int TBIG = H >= 256 ? 64 : 128;
  if (L.T == TBIG)
    return launch_bwd_f32_t<H, TBIG>(y, dy, dld, hz, wx, wh, bh, wout, bout, masks, part,
                                     dhz_part, dw, dhz, B, N, K, NH1, cap, blocks, stream);
  if (L.T == TBIG / 2)
    return launch_bwd_f32_t<H, TBIG / 2>(y, dy, dld, hz, wx, wh, bh, wout, bout, masks, part,
                                         dhz_part, dw, dhz, B, N, K, NH1, cap, blocks, stream);
  return cudaErrorInvalidValue;
}

int fwd_smem(int H, int NH1) { return FwdSmem(H, NH1).total; }
int bwd_smem(int H, int NH1) { return BwdSmem(H, NH1).total; }

template <int H>
cudaError_t launch_fwd(const float* xt, const float* hz, float* u, float* ld_part, const void* wx,
                       const void* wh, const float* bh, const void* wout, const float* bout,
                       const float* masks, int B, int N, int K, int NH1, float cap,
                       cudaStream_t stream) {
  const int bytes = fwd_smem(H, NH1);
  cudaError_t e = cudaFuncSetAttribute(fwd_kernel<H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  dim3 grid((N + FWD_T - 1) / FWD_T, B);
  fwd_kernel<H><<<grid, THREADS, bytes, stream>>>(
      xt, hz, u, ld_part, static_cast<const float*>(wx), static_cast<const float*>(wh), bh,
      static_cast<const float*>(wout), bout, masks, N, K, NH1, cap);
  return cudaGetLastError();
}

template <int H>
cudaError_t launch_bwd(float* y, float* dy, const float* dld, const float* hz, const void* wx,
                       const void* wh, const float* bh, const void* wout, const float* bout,
                       const float* masks, float* part, float* dhz_part, float* dw,
                       float* dhz, int B, int N, int K, int NH1, float cap, int blocks,
                       cudaStream_t stream) {
  const int bytes = bwd_smem(H, NH1);
  cudaError_t e = cudaFuncSetAttribute(bwd_kernel<H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  bwd_kernel<H><<<blocks, THREADS, bytes, stream>>>(
      y, dy, dld, hz, static_cast<const float*>(wx), static_cast<const float*>(wh), bh,
      static_cast<const float*>(wout), bout, masks, part, dhz_part, B, N, K, NH1, cap);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int T = BWD_T, nt = (N + T - 1) / T;
  const long long per_layer = 3LL * H + (long long)NH1 * H * H + (long long)NH1 * H + 6 * H + 6;
  if ((e = launch_reduce(part, dw, 1, blocks, per_layer * K, stream)) != cudaSuccess) return e;
  return launch_reduce(dhz_part, dhz, B, nt, (long long)K * H, stream);
}

}  // namespace

using bf16_t = __nv_bfloat16;

// the f32 layout is built for the widths where the block-wide layout
// overflows at n_hidden <= 4 (H = 32 and 64 fit it)
#define DPFX_DISPATCH_WIDE(H, CALL)                                                     \
  switch (H) {                                                                          \
    case 128: { constexpr int HH = 128; return (int)(CALL); }                           \
    case 256: { constexpr int HH = 256; return (int)(CALL); }                           \
    default: return (int)cudaErrorInvalidValue;                                         \
  }

#define DPFX_DISPATCH_CLUSTER(H, NH1, CALL)                                             \
  if (H == 128 && NH1 == 2) { constexpr int HH = 128, NN = 2; return (int)(CALL); }     \
  if (H == 128 && NH1 == 3) { constexpr int HH = 128, NN = 3; return (int)(CALL); }     \
  if (H == 256 && NH1 == 1) { constexpr int HH = 256, NN = 1; return (int)(CALL); }     \
  if (H == 256 && NH1 == 2) { constexpr int HH = 256, NN = 2; return (int)(CALL); }     \
  if (H == 256 && NH1 == 3) { constexpr int HH = 256, NN = 3; return (int)(CALL); }     \
  return (int)cudaErrorInvalidValue;

#define DPFX_DISPATCH(H, CALL)                                                          \
  switch (H) {                                                                          \
    case 32: { constexpr int HH = 32; return (int)(CALL); }                             \
    case 64: { constexpr int HH = 64; return (int)(CALL); }                             \
    case 128: { constexpr int HH = 128; return (int)(CALL); }                           \
    case 256: { constexpr int HH = 256; return (int)(CALL); }                           \
    default: return (int)cudaErrorInvalidValue;                                         \
  }

extern "C" {

// points per forward block / per backward tile (the wrappers size the
// log-det and dhz partials from it)
int dpfx_fused_train_tile_points(int bf16, int backward) {
  if (bf16) return MT;
  return backward ? BWD_T : FWD_T;
}

int dpfx_fused_train_smem_bytes(int H, int NH1, int bf16, int backward) {
  if (bf16) return MmaSmem(H, NH1, backward != 0).total;
  return backward ? bwd_smem(H, NH1) : fwd_smem(H, NH1);
}

// The f32 layout (flow_f32.cuh): points per forward block or backward tile,
// shared memory of a block, and the two launches at H = 128 and 256. bwd's
// part is [blocks, K, f32_part_row(H, n_hidden-1)] (each layer's partial
// padded to a multiple of 4 floats), dw [K, f32_part_row], dhz_part [B,
// ceil(N / T), K, H].
int dpfx_fused_train_f32_tile_points(int H, int NH1, int backward) {
  return backward ? F32BwdSmem(H, NH1).T : F32_T;
}

int dpfx_fused_train_f32_smem_bytes(int H, int NH1, int backward) {
  return backward ? F32BwdSmem(H, NH1).total : F32Smem(H, true).total;
}

int dpfx_fused_train_f32_part_row(int H, int NH1) { return f32_part_row(H, NH1); }

int dpfx_fused_train_f32_fwd(const float* xt, const float* hz, float* u, float* ld_part,
                             const void* wx, const void* wh, const float* bh, const void* wout,
                             const float* bout, const float* masks, int B, int N, int K, int H,
                             int NH1, float cap, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || NH1 < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  DPFX_DISPATCH_WIDE(H, (launch_fwd_f32<HH>(xt, hz, u, ld_part, wx, wh, bh, wout, bout, masks, B,
                                            N, K, NH1, cap, static_cast<cudaStream_t>(stream))))
}

int dpfx_fused_train_f32_bwd(float* y, float* dy, const float* dld, const float* hz,
                             const void* wx, const void* wh, const float* bh, const void* wout,
                             const float* bout, const float* masks, float* part, float* dhz_part,
                             float* dw, float* dhz, int B, int N, int K, int H, int NH1, float cap,
                             int blocks, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || NH1 < 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  DPFX_DISPATCH_WIDE(H, (launch_bwd_f32<HH>(y, dy, dld, hz, wx, wh, bh, wout, bout, masks, part,
                                            dhz_part, dw, dhz, B, N, K, NH1, cap, blocks,
                                            static_cast<cudaStream_t>(stream))))
}

// The cluster layout (flow_cluster.cuh): points per tile and shared memory
// of one CTA (for any shape: a plan past the limit reports its size), and
// the two launches on `clusters` clusters of H / 64 CTAs. fwd's carry is
// [H / 64, B, 4, N] f32 scratch and ld_part [B, ceil(N / T)]; bwd's carry
// [H / 64, B, 9, N], part [clusters, K, cluster_part_row], dw [K,
// cluster_part_row], dhz_part [B, ceil(N / T), K, H]; bwd reads u, du and
// writes y (the rebuilt input) and dx. fwd takes at most one cluster per
// group of the plan's G tiles, bwd one per tile.
int dpfx_fused_train_cluster_tile_points(int H, int NH1, int backward) {
  return cluster_plan(H, NH1, backward != 0).T;
}

// floats of a cluster's partial of one layer (padded where dWh adds into
// the slice tile by tile)
int dpfx_fused_train_cluster_part_row(int H, int NH1) {
  DPFX_DISPATCH_CLUSTER(H, NH1, (cluster_part_row(HH, NN, Cl<HH, NN, true>::SPILL > 0)))
}

int dpfx_fused_train_cluster_smem_bytes(int H, int NH1, int backward) {
  return cluster_plan(H, NH1, backward != 0).total;
}

// clusters of the persistent grid that the card holds at once (the
// forward takes at most this many, the backward's part has one slice each)
int dpfx_fused_train_cluster_grid(int H, int NH1, int backward) {
  DPFX_DISPATCH_CLUSTER(H, NH1, (cluster_grid<HH, NN>(backward != 0)))
}

int dpfx_fused_train_cluster_fwd(const float* xt, const float* hz, float* u, float* ld_part,
                                 float* carry, const void* wx, const void* wh, const float* bh,
                                 const void* wout, const float* bout, const float* masks, int B,
                                 int N, int K, int H, int NH1, float cap, int clusters,
                                 void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || clusters <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DPFX_DISPATCH_CLUSTER(H, NH1, (launch_fwd_cluster<HH, NN>(xt, hz, u, ld_part, carry, wx, wh, bh,
                                                            wout, bout, masks, B, N, K, cap,
                                                            clusters, s)))
}

int dpfx_fused_train_cluster_bwd(const float* u, const float* du, float* y, float* dx,
                                 float* carry, const float* dld, const float* hz, const void* wx,
                                 const void* wh, const float* bh, const void* wout,
                                 const float* bout, const float* masks, float* part,
                                 float* dhz_part, float* dw, float* dhz, int B, int N, int K,
                                 int H, int NH1, float cap, int clusters, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || clusters <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DPFX_DISPATCH_CLUSTER(H, NH1, (launch_bwd_cluster<HH, NN>(u, du, y, dx, carry, dld, hz, wx, wh,
                                                            bh, wout, bout, masks, part, dhz_part,
                                                            dw, dhz, B, N, K, cap, clusters, s)))
}

// the CUDA runtime's text for an error a launch returned
const char* dpfx_fused_train_error_string(int e) {
  return cudaGetErrorString(static_cast<cudaError_t>(e));
}

int dpfx_fused_train_fwd(const float* xt, const float* hz, float* u, float* ld_part,
                         const void* wx, const void* wh, const float* bh, const void* wout,
                         const float* bout, const float* masks, int B, int N, int K, int H,
                         int NH1, float cap, int bf16, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || NH1 < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    DPFX_DISPATCH(H, (launch_fwd_mma<HH>(xt, hz, u, ld_part, wx, wh, bh, wout, bout, masks, B, N,
                                         K, NH1, cap, s)))
  }
  DPFX_DISPATCH(H, (launch_fwd<HH>(xt, hz, u, ld_part, wx, wh, bh, wout, bout, masks, B,
                                          N, K, NH1, cap, s)))
}

int dpfx_fused_train_bwd(float* y, float* dy, const float* dld, const float* hz, const void* wx,
                         const void* wh, const float* bh, const void* wout, const float* bout,
                         const float* masks, float* part, float* dhz_part, float* dw, float* dhz,
                         int B, int N, int K, int H, int NH1, float cap, int bf16, int blocks,
                         void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || NH1 < 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    DPFX_DISPATCH(H, (launch_bwd_mma<HH>(y, dy, dld, hz, wx, wh, bh, wout, bout, masks, part,
                                         dhz_part, dw, dhz, B, N, K, NH1, cap, blocks, s)))
  }
  DPFX_DISPATCH(H, (launch_bwd<HH>(y, dy, dld, hz, wx, wh, bh, wout, bout, masks, part,
                                          dhz_part, dw, dhz, B, N, K, NH1, cap, blocks, s)))
}

}  // extern "C"
