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
//     takes the stream layout (below) for the forward and the backward.
//   Cotangents are cast to bf16 before each product; ragged points carry
//   zero cotangent and no log-det gradient.
//
// f32 mode (`fwd_kernel`, `bwd_kernel`): the tight-check mode, IEEE f32 FMA
// with k in order, block-wide products through shared memory (`gemm`), the
// same persistent layer-outside-tile structure, f32 dWh accumulated in
// shared memory, tile 128 forward and 32 backward.
//
// stream layout (`fwd_stream`, `bwd_stream`, both dtypes, H = 128 and 256):
// the shapes whose activations or weights overflow the two designs above
// (the bf16 backward at H=128 with n_hidden 3-4 and at H=256 with n_hidden
// 2-4, the f32 layouts at H=256, ...): smaller point tiles, Wh staged in
// chunks of output columns, dWh summed in a global slice. See StreamSmem.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). Each
// launch returns cudaGetLastError().

#include "flow_bwd_rows.cuh"

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

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
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

      // coupling cotangents; the layer input from the closed-form inverse
      if (tid < T) {
        const bool valid = n0 + tid < N;
        const float g_ld = valid ? dld[b] : 0.f;
        float st_s[3], st_t[3];
        for (int c = 0; c < 3; ++c) {
          st_s[c] = dst[c * T + tid];
          st_t[c] = dst[(3 + c) * T + tid];
        }
        for (int c = 0; c < 3; ++c) {
          const float yv = ys[c * T + tid], dyv = dys[c * T + tid];
          if (masks[k * 3 + c] > 0.f) {
            xks[c * T + tid] = yv;
            dst[c * T + tid] = 0.f;
            dst[(3 + c) * T + tid] = 0.f;
            dyn[c * T + tid] = dyv;
          } else {
            const float th = tanhf(st_s[c] / cap), es = expf(cap * th);
            const float xk = (yv - st_t[c]) / es;
            const float ds = dyv * xk * es + g_ld;
            xks[c * T + tid] = xk;
            dst[c * T + tid] = ds * (1.f - th * th);
            dst[(3 + c) * T + tid] = dyv;
            dyn[c * T + tid] = dyv * es;
          }
        }
      }
      __syncthreads();

      // dWout += rnd(dst) rnd(h_last)^T, dbout += sum(dst)
      for (int e = tid; e < 6 * H; e += THREADS) {
        const int r = e / H, o = e % H;
        float s = 0.f;
        for (int p = 0; p < T; ++p) s = fmaf(dst[r * T + p], hlast[p * ld + o], s);
        adwout[e] += s;
      }
      if (tid < 6) {
        float s = 0.f;
        for (int p = 0; p < T; ++p) s += dst[tid * T + p];
        adbout[tid] += s;
      }
      __syncthreads();

      // dh_last = (Wout^T rnd(dst)) * (h_last > 0), in place over h_last
      float* first_sum = NH1 > 0 ? adbh + (NH1 - 1) * H : dhzs;
      for (int o = tid; o < H; o += THREADS) {
        float w[6];
        for (int r = 0; r < 6; ++r) w[r] = wos[r * H + o];
        float s = 0.f;
        for (int p = 0; p < T; ++p) {
          float v = 0.f;
          for (int r = 0; r < 6; ++r) v = fmaf(w[r], dst[r * T + p], v);
          v = v * (hlast[p * ld + o] > 0.f ? 1.f : 0.f);
          s += v;
          hlast[p * ld + o] = v;
        }
        first_sum[o] = NH1 > 0 ? first_sum[o] + s : s;
      }

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

      // dWx += rnd(dh_0) rnd(x_k)^T; this tile's dhz partial
      const float* dh0 = hs;
      for (int e = tid; e < 3 * H; e += THREADS) {
        const int o = e / 3, c = e % 3;
        float s = 0.f;
        for (int p = 0; p < T; ++p) s = fmaf(dh0[p * ld + o], xks[c * T + p], s);
        adwx[e] += s;
      }
      for (int e = tid; e < H; e += THREADS)
        dhz_part[((size_t)tile * K + k) * H + e] = dhzs[e];

      // dy_in = where(mask, dy, dy * es) + Wx^T rnd(dh_0): one warp per point
      for (int p = warp; p < T; p += WARPS) {
        float s[3] = {0.f, 0.f, 0.f};
        for (int o = lane; o < H; o += 32) {
          const float d = dh0[p * ld + o];
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

// ---------------------------------------------------------------- stream layout

// The layout for the shapes whose activations or weights overflow the
// layouts above (the bf16 backward at H=128 with n_hidden 3-4 and at H=256
// with n_hidden 2-4, the bf16 forward at H=256 with n_hidden 3-4, the f32
// forward and backward at H=256, the f32 backward at H=128 with n_hidden
// 3-4): the wrapper picks it for the forward and the backward together
// wherever either of the others does not fit, so that the backward's
// recompute is the forward's arithmetic. S is the stored type: bf16 (the
// bf16 mode: the activations and cotangents stored rounded, as the Pallas
// kernel's operands are; WMMA products on the tensor cores, f32 sums) or
// float (the f32 mode: IEEE FMA, each sum over k in order, so the forward
// has fwd_kernel's bits where both take a 128-point tile, as chip_smoke.py's
// phase 3l checks; the backward sums its weight gradients over other tiles
// than bwd_kernel's 32 points). What it does about the overflow:
//   * a point tile of T (128 .. 16) points, the largest whose activations
//     fit beside one chunk of weights: the forward keeps two levels of the
//     tile, the backward all n_hidden (they become the cotangents in place);
//   * Wh staged NC output columns at a time (rows of Wh for the forward
//     product, columns for the cotangent product), each chunk's sums over
//     the whole k, so chunking changes no sum;
//   * dWh summed per tile into the block's slice of a global scratch (wacc,
//     [blocks][n_hidden-1][H][H] f32, L2-resident): no register-held dW
//     blocks, which at H=256 would need 256 registers a thread per matrix.
// Bound: the same FLOP as the other layouts; the price is every Wh read
// from L2 twice per tile and dWh read and written once per tile.
struct StreamSmem {
  int T, NC, ld, lw, hstride, hs, ws, stage, colpart, xs, dys, xks, dst, dyn, ldp;
  int wx, wout, bout, hz, bh, adwx, adwout, adbout, dhz, adbh, total;
  __host__ __device__ void carve(int H, int NH1, bool bf, bool backward, int t, int nc) {
    const int es = bf ? 2 : 4, pad = bf ? Layout<bf16>::PAD : Layout<float>::PAD;
    const int nb = NH1 > 1 ? NH1 : 1;
    T = t;
    NC = nc;
    ld = H + pad;
    lw = nc + pad;
    hstride = round128(t * ld * es);
    int o = 0;
    hs = o;      o += (backward ? NH1 + 1 : 2) * hstride;
    ws = o;      o += round128((backward && H * lw > nc * ld ? H * lw : nc * ld) * es);
    stage = o;   o += bf ? round128(WARPS * 256 * 4) : 0;
    colpart = o; o += bf && backward ? round128(t / 16 * nc * 4) : 0;
    xs = o;      o += round128(3 * t * 4);
    dst = o;     o += round128(8 * t * 4);
    dys = xks = dyn = ldp = o;
    if (backward) {
      dys = o;   o += round128(3 * t * 4);
      xks = o;   o += round128(3 * t * 4);
      dyn = o;   o += round128(3 * t * 4);
    } else {
      ldp = o;   o += round128(t * 4);
    }
    wx = o;      o += round128(3 * H * 4);
    wout = o;    o += round128(6 * H * 4);
    bout = o;    o += round128(8 * 4);
    hz = o;      o += round128(H * 4);
    bh = o;      o += round128(nb * H * 4);
    adwx = adwout = adbout = dhz = adbh = o;
    if (backward) {
      adwx = o;   o += round128(3 * H * 4);
      adwout = o; o += round128(6 * H * 4);
      adbout = o; o += round128(8 * 4);
      dhz = o;    o += round128(H * 4);
      adbh = o;   o += round128(nb * H * 4);
    }
    total = o;
  }
  // the largest tile, then the widest chunk, that fits
  __host__ __device__ StreamSmem(int H, int NH1, bool bf, bool backward) {
    for (int t = 128; t >= 16; t /= 2)
      for (int nc = H < 128 ? H : 128; nc >= 32 || nc == H; nc /= 2) {
        if (H % nc) continue;
        carve(H, NH1, bf, backward, t, nc);
        if (total <= SMEM_MAX) return;
      }
  }
};

// rows x cols of g (row stride gs) into dst (row stride ld): bf16 16 bytes
// at a time (cols, gs, ld and the bases are multiples of 8 elements)
__device__ void stage_rows(bf16* dst, int ld, const bf16* g, int gs, int rows, int cols) {
  const int vpr = cols / 8;
  for (int v = threadIdx.x; v < rows * vpr; v += THREADS) {
    const int r = v / vpr, c = (v % vpr) * 8;
    *reinterpret_cast<uint4*>(dst + r * ld + c) =
        *reinterpret_cast<const uint4*>(g + (size_t)r * gs + c);
  }
}
__device__ void stage_rows(float* dst, int ld, const float* g, int gs, int rows, int cols) {
  for (int v = threadIdx.x; v < rows * cols; v += THREADS) {
    const int r = v / cols, c = v % cols;
    dst[r * ld + c] = g[(size_t)r * gs + c];
  }
}

// h_0 = act(rnd(Wx) rnd(x) + hz) for the T points of xs into h (stored as S)
template <typename S, int H>
__device__ void first_layer_s(S* h, int ld, const float* xs, int T, const float* wxs,
                              const float* hzs) {
  for (int e = threadIdx.x; e < T * H; e += THREADS) {
    const int p = e / H, o = e % H;
    float v = wxs[o * 3 + 0] * rnd<S>(xs[p]);
    v = fmaf(wxs[o * 3 + 1], rnd<S>(xs[T + p]), v);
    v = fmaf(wxs[o * 3 + 2], rnd<S>(xs[2 * T + p]), v);
    h[p * ld + o] = from_f<S>(relu_nan(v + hzs[o]));
  }
}

// st[r][p] = rnd(Wout)[r] . h[p] + bout[r]: one warp per point, lanes split H
template <typename S, int H>
__device__ void out_layer_s(float* sts, const S* h, int ld, int T, const float* wos,
                            const float* bos) {
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int p = warp; p < T; p += WARPS) {
    float part[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int kk = lane; kk < H; kk += 32) {
      const float hv = to_f(h[p * ld + kk]);
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

// a layer's small weights as f32 (rounded to S already) and biases
template <typename S, int H>
__device__ void small_weights(const StreamSmem& L, unsigned char* smem, const S* wx,
                              const S* wout, const float* bout, const float* bh, int k,
                              int NH1) {
  float* wxs = reinterpret_cast<float*>(smem + L.wx);
  float* wos = reinterpret_cast<float*>(smem + L.wout);
  float* bos = reinterpret_cast<float*>(smem + L.bout);
  float* bhs = reinterpret_cast<float*>(smem + L.bh);
  for (int e = threadIdx.x; e < 3 * H; e += THREADS) wxs[e] = to_f(wx[(size_t)k * 3 * H + e]);
  for (int e = threadIdx.x; e < 6 * H; e += THREADS) wos[e] = to_f(wout[(size_t)k * 6 * H + e]);
  if (threadIdx.x < 6) bos[threadIdx.x] = bout[k * 6 + threadIdx.x];
  for (int e = threadIdx.x; e < NH1 * H; e += THREADS) bhs[e] = bh[(size_t)k * NH1 * H + e];
}

// out = relu(in Wh^T + bh) for the tile: Wh's rows staged NC at a time into
// ws [NC][ld]; every sum over the whole k. Starts and ends with a barrier.
template <typename S, int H>
__device__ void hidden_stream(const StreamSmem& L, unsigned char* smem, const S* in, S* out,
                              const S* g, const float* bj) {
  S* ws = reinterpret_cast<S*>(smem + L.ws);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  const int ld = L.ld, NC = L.NC;
  for (int n0 = 0; n0 < H; n0 += NC) {
    __syncthreads();   // in is written; the previous chunk's product is done with ws
    stage_rows(ws, ld, g + (size_t)n0 * H, H, NC, H);
    __syncthreads();
    gemm<false, true>(L.T, NC, H, in, ld, ws, ld, stage, nullptr, [&](int m, int n, float v) {
      out[m * ld + n0 + n] = from_f<S>(relu_nan(v + bj[n0 + n]));
      return 0.f;
    });
  }
  __syncthreads();
}

template <typename S, int H>
__global__ void __launch_bounds__(THREADS)
fwd_stream(const float* __restrict__ xt, const float* __restrict__ hz, float* __restrict__ u,
           float* __restrict__ ld_part, const S* __restrict__ wx, const S* __restrict__ wh,
           const float* __restrict__ bh, const S* __restrict__ wout,
           const float* __restrict__ bout, const float* __restrict__ masks, int N, int K,
           int NH1, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StreamSmem L(H, NH1, is_bf16<S>, false);
  const int T = L.T, ld = L.ld;
  S* hs0 = reinterpret_cast<S*>(smem + L.hs);
  S* hs1 = reinterpret_cast<S*>(smem + L.hs + L.hstride);
  float* xs = reinterpret_cast<float*>(smem + L.xs);      // [3][T]
  float* sts = reinterpret_cast<float*>(smem + L.dst);    // [6][T]
  float* ldp = reinterpret_cast<float*>(smem + L.ldp);    // [T]
  const float* wxs = reinterpret_cast<const float*>(smem + L.wx);
  const float* wos = reinterpret_cast<const float*>(smem + L.wout);
  const float* bos = reinterpret_cast<const float*>(smem + L.bout);
  float* hzs = reinterpret_cast<float*>(smem + L.hz);
  const float* bhs = reinterpret_cast<const float*>(smem + L.bh);

  const int b = blockIdx.y, n0 = blockIdx.x * T, tid = threadIdx.x;
  const size_t cloud = (size_t)b * 3 * N;
  for (int p = tid; p < T; p += THREADS) {
    const int n = n0 + p;
    for (int c = 0; c < 3; ++c) xs[c * T + p] = n < N ? xt[cloud + (size_t)c * N + n] : 0.f;
    ldp[p] = 0.f;
  }
  for (int k = 0; k < K; ++k) {
    __syncthreads();  // the previous layer is done with xs and the small weights
    small_weights<S, H>(L, smem, wx, wout, bout, bh, k, NH1);
    for (int e = tid; e < H; e += THREADS) hzs[e] = hz[((size_t)b * K + k) * H + e];
    __syncthreads();
    first_layer_s<S, H>(hs0, ld, xs, T, wxs, hzs);
    S* cur = hs0;
    S* nxt = hs1;
    for (int j = 0; j < NH1; ++j) {
      hidden_stream<S, H>(L, smem, cur, nxt, wh + ((size_t)k * NH1 + j) * H * H, bhs + j * H);
      S* t = cur;
      cur = nxt;
      nxt = t;
    }
    __syncthreads();
    out_layer_s<S, H>(sts, cur, ld, T, wos, bos);
    __syncthreads();
    for (int p = tid; p < T; p += THREADS) {
      for (int c = 0; c < 3; ++c) {
        if (masks[k * 3 + c] > 0.f) continue;
        const float s = cap * tanhf(sts[c * T + p] / cap);
        ldp[p] += s;
        xs[c * T + p] = xs[c * T + p] * expf(s) + sts[(3 + c) * T + p];
      }
    }
  }
  __syncthreads();
  for (int p = tid; p < T; p += THREADS)
    if (n0 + p < N)
      for (int c = 0; c < 3; ++c) u[cloud + (size_t)c * N + n0 + p] = xs[c * T + p];
  if (tid < 32) {
    float s = 0.f;
    for (int p = tid; p < T; p += 32) s += n0 + p < N ? ldp[p] : 0.f;
    for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
    if (tid == 0) ld_part[(size_t)b * gridDim.x + blockIdx.x] = s;
  }
}

template <typename S, int H>
__global__ void __launch_bounds__(THREADS)
bwd_stream(float* __restrict__ y, float* __restrict__ dy, const float* __restrict__ dld,
           const float* __restrict__ hz, const S* __restrict__ wx, const S* __restrict__ wh,
           const float* __restrict__ bh, const S* __restrict__ wout,
           const float* __restrict__ bout, const float* __restrict__ masks,
           float* __restrict__ part, float* __restrict__ dhz_part, float* __restrict__ wacc,
           int B, int N, int K, int NH1, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const StreamSmem L(H, NH1, is_bf16<S>, true);
  const int T = L.T, ld = L.ld, lw = L.lw, NC = L.NC;
  const int hst = L.hstride / (int)sizeof(S);
  S* hs = reinterpret_cast<S*>(smem + L.hs);
  S* ws = reinterpret_cast<S*>(smem + L.ws);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* colpart = reinterpret_cast<float*>(smem + L.colpart);
  float* ys = reinterpret_cast<float*>(smem + L.xs);      // [3][T] layer output
  float* dys = reinterpret_cast<float*>(smem + L.dys);    // [3][T] its cotangent
  float* xks = reinterpret_cast<float*>(smem + L.xks);    // [3][T] layer input
  float* dst = reinterpret_cast<float*>(smem + L.dst);    // [6][T] (s, t), then d(s, t)
  float* dyn = reinterpret_cast<float*>(smem + L.dyn);    // [3][T] where(mask, dy, dy*es)
  const float* wxs = reinterpret_cast<const float*>(smem + L.wx);
  const float* wos = reinterpret_cast<const float*>(smem + L.wout);
  const float* bos = reinterpret_cast<const float*>(smem + L.bout);
  float* hzs = reinterpret_cast<float*>(smem + L.hz);
  const float* bhs = reinterpret_cast<const float*>(smem + L.bh);
  float* adwx = reinterpret_cast<float*>(smem + L.adwx);      // [H][3]
  float* adwout = reinterpret_cast<float*>(smem + L.adwout);  // [6][H]
  float* adbout = reinterpret_cast<float*>(smem + L.adbout);  // [6]
  float* dhzs = reinterpret_cast<float*>(smem + L.dhz);       // [H] this tile's dhz
  float* adbh = reinterpret_cast<float*>(smem + L.adbh);      // [NH1][H]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nt = (N + T - 1) / T, tiles = B * nt;
  const int per_layer = 3 * H + NH1 * H * H + NH1 * H + 6 * H + 6;
  S* hlast = hs + NH1 * hst;
  float* acc = wacc + (size_t)blockIdx.x * NH1 * H * H;   // this block's dWh sums

  for (int i = 0; i < K; ++i) {
    const int k = K - 1 - i;
    __syncthreads();  // the previous layer's partials are written
    small_weights<S, H>(L, smem, wx, wout, bout, bh, k, NH1);
    for (int e = tid; e < 3 * H; e += THREADS) adwx[e] = 0.f;
    for (int e = tid; e < 6 * H; e += THREADS) adwout[e] = 0.f;
    if (tid < 6) adbout[tid] = 0.f;
    for (int e = tid; e < NH1 * H; e += THREADS) adbh[e] = 0.f;

    bool first = true;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
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
      first_layer_s<S, H>(hs, ld, ys, T, wxs, hzs);
      for (int j = 0; j < NH1; ++j)
        hidden_stream<S, H>(L, smem, hs + j * hst, hs + (j + 1) * hst,
                            wh + ((size_t)k * NH1 + j) * H * H, bhs + j * H);
      __syncthreads();
      out_layer_s<S, H>(dst, hlast, ld, T, wos, bos);   // st into dst, overwritten below
      __syncthreads();

      // coupling cotangents; the layer input from the closed-form inverse
      for (int p = tid; p < T; p += THREADS) {
        const bool valid = n0 + p < N;
        const float g_ld = valid ? dld[b] : 0.f;
        float st_s[3], st_t[3];
        for (int c = 0; c < 3; ++c) {
          st_s[c] = dst[c * T + p];
          st_t[c] = dst[(3 + c) * T + p];
        }
        for (int c = 0; c < 3; ++c) {
          const float yv = ys[c * T + p], dyv = dys[c * T + p];
          if (masks[k * 3 + c] > 0.f) {
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
      __syncthreads();

      // dWout += rnd(dst) h_last^T, dbout += sum(dst)
      for (int e = tid; e < 6 * H; e += THREADS) {
        const int r = e / H, o = e % H;
        float s = 0.f;
        for (int p = 0; p < T; ++p) s = fmaf(rnd<S>(dst[r * T + p]), to_f(hlast[p * ld + o]), s);
        adwout[e] += s;
      }
      if (tid < 6) {
        float s = 0.f;
        for (int p = 0; p < T; ++p) s += dst[tid * T + p];
        adbout[tid] += s;
      }
      __syncthreads();

      // dh_last = (Wout^T rnd(dst)) * (h_last > 0), in place over h_last
      float* first_sum = NH1 > 0 ? adbh + (NH1 - 1) * H : dhzs;
      for (int o = tid; o < H; o += THREADS) {
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
        first_sum[o] = NH1 > 0 ? first_sum[o] + s : s;
      }

      for (int j = NH1 - 1; j >= 0; --j) {
        S* dh = hs + (j + 1) * hst;   // cotangent of h_{j+1}, masked
        S* hj = hs + j * hst;
        const S* g = wh + ((size_t)k * NH1 + j) * H * H;
        float* sums = j > 0 ? adbh + (j - 1) * H : dhzs;
        __syncthreads();
        // dWh[j] += dh^T h_j, into the block's slice
        gemm_acc<true, false>(H, H, T, dh, ld, hj, ld, acc + (size_t)j * H * H, H, first);
        // dh_j = (dh Wh[j]) * (h_j > 0), in place over h_j, Wh's columns
        // staged NC at a time into ws [H][lw]
        for (int c0 = 0; c0 < H; c0 += NC) {
          __syncthreads();   // the previous product is done with ws and h_j
          stage_rows(ws, lw, g + c0, H, H, NC);
          __syncthreads();
          gemm<false, false>(T, NC, H, dh, ld, ws, lw, stage, colpart, [&](int m, int n, float v) {
            S* q = hj + m * ld + c0 + n;
            const float mv = v * (to_f(*q) > 0.f ? 1.f : 0.f);
            *q = from_f<S>(mv);
            return mv;
          });
          if constexpr (is_bf16<S>) {   // the f32 sums of the chunk's unrounded values
            __syncthreads();
            column_sums<S>(T, NC, colpart, hj + c0, ld, sums + c0, j > 0);
          }
        }
        if constexpr (!is_bf16<S>) {   // the stored values are exact
          __syncthreads();
          column_sums<S>(T, H, colpart, hj, ld, sums, j > 0);
        }
      }
      first = false;
      __syncthreads();

      // dWx += rnd(dh_0) rnd(x_k)^T; this tile's dhz partial
      const S* dh0 = hs;
      for (int e = tid; e < 3 * H; e += THREADS) {
        const int o = e / 3, c = e % 3;
        float s = 0.f;
        for (int p = 0; p < T; ++p) s = fmaf(to_f(dh0[p * ld + o]), rnd<S>(xks[c * T + p]), s);
        adwx[e] += s;
      }
      for (int e = tid; e < H; e += THREADS)
        dhz_part[((size_t)tile * K + k) * H + e] = dhzs[e];

      // dy_in = where(mask, dy, dy * es) + rnd(Wx)^T rnd(dh_0): one warp per point
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
    __syncthreads();  // this block's dWh sums are in its slice
    // this block's partial of layer k: [dWx | dWh | dbh | dWout | dbout]
    float* out = part + ((size_t)blockIdx.x * K + k) * per_layer;
    for (int e = tid; e < 3 * H; e += THREADS) out[e] = adwx[e];
    out += 3 * H;
    for (int e = tid; e < NH1 * H * H; e += THREADS) out[e] = acc[e];
    out += NH1 * H * H;
    for (int e = tid; e < NH1 * H; e += THREADS) out[e] = adbh[e];
    out += NH1 * H;
    for (int e = tid; e < 6 * H; e += THREADS) out[e] = adwout[e];
    out += 6 * H;
    if (tid < 6) out[tid] = adbout[tid];
  }
}

int stream_smem(int H, int NH1, bool bf, bool backward) {
  return StreamSmem(H, NH1, bf, backward).total;
}

template <typename S, int H>
cudaError_t launch_fwd_stream(const float* xt, const float* hz, float* u, float* ld_part,
                              const void* wx, const void* wh, const float* bh, const void* wout,
                              const float* bout, const float* masks, int B, int N, int K,
                              int NH1, float cap, cudaStream_t stream) {
  const StreamSmem L(H, NH1, is_bf16<S>, false);
  if (L.total > SMEM_MAX) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(fwd_stream<S, H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return e;
  dim3 grid((N + L.T - 1) / L.T, B);
  fwd_stream<S, H><<<grid, THREADS, L.total, stream>>>(
      xt, hz, u, ld_part, static_cast<const S*>(wx), static_cast<const S*>(wh), bh,
      static_cast<const S*>(wout), bout, masks, N, K, NH1, cap);
  return cudaGetLastError();
}

template <typename S, int H>
cudaError_t launch_bwd_stream(float* y, float* dy, const float* dld, const float* hz,
                              const void* wx, const void* wh, const float* bh, const void* wout,
                              const float* bout, const float* masks, float* part,
                              float* dhz_part, float* wacc, float* dw, float* dhz, int B, int N,
                              int K, int NH1, float cap, int blocks, cudaStream_t stream) {
  const StreamSmem L(H, NH1, is_bf16<S>, true);
  if (L.total > SMEM_MAX || (NH1 > 0 && !wacc)) return cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(bwd_stream<S, H>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, L.total);
  if (e != cudaSuccess) return e;
  bwd_stream<S, H><<<blocks, THREADS, L.total, stream>>>(
      y, dy, dld, hz, static_cast<const S*>(wx), static_cast<const S*>(wh), bh,
      static_cast<const S*>(wout), bout, masks, part, dhz_part, wacc, B, N, K, NH1, cap);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  const int nt = (N + L.T - 1) / L.T;
  const long long per_layer = 3LL * H + (long long)NH1 * H * H + (long long)NH1 * H + 6 * H + 6;
  if ((e = launch_reduce(part, dw, 1, blocks, per_layer * K, stream)) != cudaSuccess) return e;
  return launch_reduce(dhz_part, dhz, B, nt, (long long)K * H, stream);
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

// the stream layout is built for the widths where the other layouts
// overflow at n_hidden <= 4 (H = 32 and 64 fit them)
#define DPFX_DISPATCH_WIDE(H, CALL)                                                     \
  switch (H) {                                                                          \
    case 128: { constexpr int HH = 128; return (int)(CALL); }                           \
    case 256: { constexpr int HH = 256; return (int)(CALL); }                           \
    default: return (int)cudaErrorInvalidValue;                                         \
  }

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

// The stream layout (see StreamSmem): points per tile, shared memory of a
// block, and the two launches; bwd's wacc is [blocks][n_hidden-1][H][H]
// f32 scratch
int dpfx_fused_train_stream_tile_points(int H, int NH1, int bf16, int backward) {
  return StreamSmem(H, NH1, bf16 != 0, backward != 0).T;
}

int dpfx_fused_train_stream_smem_bytes(int H, int NH1, int bf16, int backward) {
  return stream_smem(H, NH1, bf16 != 0, backward != 0);
}

int dpfx_fused_train_stream_fwd(const float* xt, const float* hz, float* u, float* ld_part,
                                const void* wx, const void* wh, const float* bh,
                                const void* wout, const float* bout, const float* masks, int B,
                                int N, int K, int H, int NH1, float cap, int bf16, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || NH1 < 0 || B > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    DPFX_DISPATCH_WIDE(H, (launch_fwd_stream<bf16_t, HH>(xt, hz, u, ld_part, wx, wh, bh, wout, bout,
                                                    masks, B, N, K, NH1, cap, s)))
  }
  DPFX_DISPATCH_WIDE(H, (launch_fwd_stream<float, HH>(xt, hz, u, ld_part, wx, wh, bh, wout, bout,
                                                 masks, B, N, K, NH1, cap, s)))
}

int dpfx_fused_train_stream_bwd(float* y, float* dy, const float* dld, const float* hz,
                                const void* wx, const void* wh, const float* bh,
                                const void* wout, const float* bout, const float* masks,
                                float* part, float* dhz_part, float* wacc, float* dw, float* dhz,
                                int B, int N, int K, int H, int NH1, float cap, int bf16,
                                int blocks, void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || NH1 < 0 || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    DPFX_DISPATCH_WIDE(H, (launch_bwd_stream<bf16_t, HH>(y, dy, dld, hz, wx, wh, bh, wout, bout, masks,
                                                    part, dhz_part, wacc, dw, dhz, B, N, K, NH1,
                                                    cap, blocks, s)))
  }
  DPFX_DISPATCH_WIDE(H, (launch_bwd_stream<float, HH>(y, dy, dld, hz, wx, wh, bh, wout, bout, masks,
                                                 part, dhz_part, wacc, dw, dhz, B, N, K, NH1,
                                                 cap, blocks, s)))
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
