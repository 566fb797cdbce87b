// The decomposition probe of the fused point-flow backward on Hopper
// (sm_90a), and its interleaved form.
//
// Replaces the Pallas TPU kernels `_kernel` (tools/bench_fused_bwd.py:49)
// and `_ilv_kernel` (:155) of the JAX tool. The function: u, du [B, 8, N]
// f32; wx [K, H, 8] (no mask folded in: the conditioner reads all 8 rows),
// wh [K, NH1, H, H], wout [K, 8, H] in the compute dtype; bh, bout, hz, the
// masks (rows 3-7 pass through) in f32. Per layer, from its output y: the
// conditioner h_0 = relu(Wx y + hz), h_{j+1} = relu(Wh_j h_j + bh_j),
// st = Wout h_last + bout; the shift of row r is st[(r + 3) % 8] (the
// Pallas `roll(st, 5)`), the layer input x = (y - shift) / exp(s) on the
// transformed rows; the cotangent of st takes ds (1 - tanh^2) plus the
// translation cotangent dy[(r + 5) % 8] inv (`roll(dy * inv, 3)`); columns
// at or beyond n_points take no log-det cotangent. Modes: FULL gives dx,
// dhz and every weight gradient; NOWG leaves out what only the weight
// gradients need (dx only); WALK runs only the conditioner recompute and
// the inverse, and leaves x_0 in y.
//
// Bound: the products on the tensor cores. Per point and layer, on the
// 8-row layout, the recompute is Wx (8H), NH1 Wh (H^2) and Wout (8H)
// multiply-adds; the cotangent chain the same again; the weight gradients
// the same again: 2(48H + 3 NH1 H^2) FLOP for FULL, 2(32H + 2 NH1 H^2) for
// NOWG, 2(16H + NH1 H^2) for WALK. At B=64, N=2048, K=32, H=128, NH1=1:
// 464, 309 and 155 GFLOP, 0.469, 0.313 and 0.156 ms at 989 TFLOP/s bf16,
// against ~14 MB of inputs and outputs (4 us at 3.35 TB/s).
//
// bf16 (`probe_rows_kernel`): the training backward itself. Its body is
// bwd_rows of flow_bwd_rows.cuh, the one copy that fused_train.cu's
// bwd_kernel_mma runs, here on 8 rows (R = 8): mma.sync on 16 rows of a
// 128-point tile per warp, a persistent grid (one block per SM), the layer
// loop outside the tile loop, the next layer's weights staged behind this
// one, the gradient sums in registers through a layer's tiles, per-block
// slices summed in order by reduce_slices; no float atomics, bit-identical
// from run to run. The model pads its operands to 8 (m16n8k8 with K = 3
// padded, N = 8 for (s, t) and dy_in), so the 8-row function issues the
// same products per point and layer as training, and on the model's rows
// padded with zeros it computes training's values bit for bit. So the
// gaps full - nowg (the weight gradients), nowg - walk (the cotangent
// chain) and walk (the recompute and the inverse) split the backward that
// training runs. `rolled` puts the layer loop under `#pragma unroll 1`;
// full leaves it as training writes it (nvcc may compile the two alike).
// Interleaved (S = 2, 4 groups of 8 / S warps): the same body, each group
// on its own tiles of 128 / S points with its own named barrier inside a
// layer, so that one group's products can overlap another's coupling math
// and weight-gradient products; per-group gradient slices, their dWh read
// and written per tile in global memory (see flow_bwd_rows.cuh).
//
// f32 (`probe_kernel`, the check mode, as fused_train.cu keeps bwd_kernel
// for f32): the first, block-wide design, IEEE f32 FMA with k in order.
// STRIPES == 1: a persistent grid, the layer loop outside the tile loop,
// tiles of 32 points carrying each point's 16-float state in global memory
// between layers, the weight gradients summed in shared memory, one slice
// per block and layer; STRIPES = 2 or 4 (tile 16): one block per cloud,
// its points split into independent stripes walked by their own warps with
// named barriers, each stripe's dWh in a global slice, the stripes summed
// in order at each layer's end.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). Each
// launch returns cudaGetLastError().

#include "flow_bwd_rows.cuh"

namespace {

using namespace dpfx;

constexpr int R = 8;          // rows of the probe layout
constexpr int HID = 128;      // the conditioner width the kernels are built for
enum { FULL = BWD_FULL, NOWG = BWD_NOWG, WALK = BWD_WALK };

// ---------------------------------------------------------------- f32 mode

// Shared-memory carve-up of the f32 kernel: the block's weights, then one
// region per group (dpfx_probe_bwd_smem_bytes reports the total). The dWh
// sums live here only with one group. bench_fused_bwd.py's smem_bytes
// mirrors this layout: change both together.
struct Smem {
  int ld, lda, nb, ws, awh, stage, wx, wout, bout, bh, masks, group0;
  int hs, colpart, ys, dys, xks, dst, dyn, hz, dhz, adwx, adwout, adbout, adbh, adhz, gsize;
  int total;
  __host__ __device__ Smem(int H, int NH1, int T, int groups) {
    ld = H + Layout<float>::PAD;
    lda = H + 4;
    nb = NH1 > 1 ? NH1 : 1;
    int o = 0;
    ws = o;      o += nb * round128(H * ld * 4);
    awh = o;     o += groups == 1 ? NH1 * round128(H * lda * 4) : 0;
    stage = o;   o += round128(WARPS * 256 * 4);
    wx = o;      o += round128(R * H * 4);
    wout = o;    o += round128(R * H * 4);
    bout = o;    o += round128(R * 4);
    bh = o;      o += round128(nb * H * 4);
    masks = o;   o += round128(R * 4);
    group0 = o;
    int q = 0;
    hs = q;      q += (NH1 + 1) * round128(T * ld * 4);
    colpart = q; q += round128(T / 16 * H * 4);
    ys = q;      q += round128(R * T * 4);
    dys = q;     q += round128(R * T * 4);
    xks = q;     q += round128(R * T * 4);
    dst = q;     q += round128(R * T * 4);
    dyn = q;     q += round128(R * T * 4);
    hz = q;      q += round128(H * 4);
    dhz = q;     q += round128(H * 4);
    adwx = q;    q += round128(H * R * 4);
    adwout = q;  q += round128(R * H * 4);
    adbout = q;  q += round128(R * 4);
    adbh = q;    q += round128(nb * H * 4);
    adhz = q;    q += round128(H * 4);
    gsize = q;
    total = o + groups * gsize;
  }
};

struct Args {
  float* y;            // [B, 8, N] in: u; between layers each layer's input; out: x_0
  float* dy;           // [B, 8, N] in: du; out: dx
  const float* dld;    // [B]
  const float* hz;     // [B, K, H]
  const void* wx;      // [K, H, 8] compute dtype
  const void* wh;      // [K, NH1, H, H]
  const float* bh;     // [K, NH1, H]
  const void* wout;    // [K, 8, H]
  const float* bout;   // [K, 8]
  const float* masks;  // [K, 8]
  float* part;         // [blocks, K, per_layer] weight-gradient partials
  float* dhz_part;     // [B, nt, K, H] (one block per SM) or unused
  float* dw;           // [K, per_layer] out
  float* dhz;          // [B, K, H] out
  float* awh;          // [B, STRIPES, max(NH1, 1), H, H] dWh per stripe (interleaved)
  int B, N, n_valid, K, NH1;
  float cap;
  int blocks;
  cudaStream_t stream;
};

template <int MODE, int T, bool ROLLED, int STRIPES>
__global__ void __launch_bounds__(THREADS)
probe_kernel(Args a) {
  constexpr int H = HID;
  constexpr int GW = WARPS / STRIPES;   // warps per group
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(H, a.NH1, T, STRIPES);
  const int ld = L.ld, lda = L.lda, K = a.K, N = a.N, NH1 = a.NH1;
  const int hstride = round128(T * ld * 4) / 4;
  const int wstride = round128(H * ld * 4) / 4;
  const int astride = round128(H * lda * 4) / 4;
  const int per_layer = 2 * R * H + NH1 * H * H + NH1 * H + R;
  const float* wx = static_cast<const float*>(a.wx);
  const float* wh = static_cast<const float*>(a.wh);
  const float* wout = static_cast<const float*>(a.wout);
  float* ws = reinterpret_cast<float*>(smem + L.ws);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* wxs = reinterpret_cast<float*>(smem + L.wx);     // [H][8]
  float* wos = reinterpret_cast<float*>(smem + L.wout);   // [8][H]
  float* bos = reinterpret_cast<float*>(smem + L.bout);
  float* bhs = reinterpret_cast<float*>(smem + L.bh);
  float* mks = reinterpret_cast<float*>(smem + L.masks);

  const int s = STRIPES == 1 ? 0 : (int)threadIdx.x / 32 / GW;
  const Group g{STRIPES == 1 ? 0 : 1 + s, s * GW, GW};
  unsigned char* gb = smem + L.group0 + s * L.gsize;
  float* hs = reinterpret_cast<float*>(gb + L.hs);
  float* colpart = reinterpret_cast<float*>(gb + L.colpart);
  float* ys = reinterpret_cast<float*>(gb + L.ys);       // [8][T] layer output
  float* dys = reinterpret_cast<float*>(gb + L.dys);     // [8][T] its cotangent
  float* xks = reinterpret_cast<float*>(gb + L.xks);     // [8][T] layer input
  float* dst = reinterpret_cast<float*>(gb + L.dst);     // [8][T] st, then d(st)
  float* dyn = reinterpret_cast<float*>(gb + L.dyn);     // [8][T] where(mask, dy, dy * es)
  float* hzs = reinterpret_cast<float*>(gb + L.hz);
  float* dhzs = reinterpret_cast<float*>(gb + L.dhz);    // this tile's dhz
  float* adwx = reinterpret_cast<float*>(gb + L.adwx);   // [H][8]
  float* adwout = reinterpret_cast<float*>(gb + L.adwout);
  float* adbout = reinterpret_cast<float*>(gb + L.adbout);
  float* adbh = reinterpret_cast<float*>(gb + L.adbh);   // [NH1][H]
  float* adhz = reinterpret_cast<float*>(gb + L.adhz);   // the stripe's dhz
  float* hlast = hs + NH1 * hstride;
  // dWh sums: in shared memory (one group), or this stripe's global slice
  float* awh = STRIPES == 1 ? reinterpret_cast<float*>(smem + L.awh)
                            : a.awh + ((size_t)blockIdx.x * STRIPES + s) * L.nb * H * H;
  const int awh_ld = STRIPES == 1 ? lda : H;
  const int awh_stride = STRIPES == 1 ? astride : H * H;
  const int lane = threadIdx.x % 32;
  const int nt = (N + T - 1) / T;

  // one tile of T points of cloud b from n0 (points at or past hi lie
  // outside the array) through layer k
  auto tile_step = [&](int k, int b, int n0, int hi, int tile, bool first) {
    const size_t cloud = (size_t)b * R * N;
    g.sync();  // the group's previous tile is done with its buffers
    for (int e = g.tid(); e < R * T; e += g.size()) {
      const int r = e / T, n = n0 + e % T;
      ys[e] = n < hi ? a.y[cloud + (size_t)r * N + n] : 0.f;
      if (MODE != WALK) dys[e] = n < hi ? a.dy[cloud + (size_t)r * N + n] : 0.f;
    }
    for (int e = g.tid(); e < H; e += g.size()) hzs[e] = a.hz[((size_t)b * K + k) * H + e];
    g.sync();

    // the conditioner, recomputed from the layer output
    for (int e = g.tid(); e < T * H; e += g.size()) {
      const int p = e / H, o = e % H;
      float v = wxs[o * R] * ys[p];
#pragma unroll
      for (int c = 1; c < R; ++c) v = fmaf(wxs[o * R + c], ys[c * T + p], v);
      hs[p * ld + o] = relu_nan(v + hzs[o]);
    }
    for (int j = 0; j < NH1; ++j) {
      g.sync();
      float* out = hs + (j + 1) * hstride;
      const float* bj = bhs + j * H;
      gemm<false, true>(g, T, H, H, hs + j * hstride, ld, ws + j * wstride, ld, stage, nullptr,
                         [&](int m, int n, float v) {
                           out[m * ld + n] = relu_nan(v + bj[n]);
                           return 0.f;
                         });
    }
    g.sync();
    // st = Wout h_last + bout: one warp per point, lanes split H
    for (int p = g.warp(); p < T; p += g.warps) {
      float part[R];
#pragma unroll
      for (int r = 0; r < R; ++r) part[r] = 0.f;
      for (int kk = lane; kk < H; kk += 32) {
        const float hv = hlast[p * ld + kk];
#pragma unroll
        for (int r = 0; r < R; ++r) part[r] = fmaf(wos[r * H + kk], hv, part[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r)
        for (int off = 16; off; off >>= 1) part[r] += __shfl_xor_sync(0xffffffffu, part[r], off);
      if (lane < R) {
        float v = part[0];
#pragma unroll
        for (int r = 1; r < R; ++r) if (lane == r) v = part[r];
        dst[lane * T + p] = v + bos[lane];
      }
    }
    g.sync();

    // the layer input by the closed-form inverse; the coupling cotangents
    for (int p = g.tid(); p < T; p += g.size()) {
      const int n = n0 + p;
      const float valid = n < hi && n < a.n_valid ? 1.f : 0.f;
      float st[R], th[R], es[R], xk[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        st[r] = dst[r * T + p];
        th[r] = tanhf(st[r] / a.cap);
        es[r] = expf(a.cap * th[r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float yv = ys[r * T + p];
        xk[r] = mks[r] > 0.f ? yv : (yv - st[(r + 3) % R]) / es[r];
        xks[r * T + p] = xk[r];
      }
      if (MODE == WALK) continue;
      const float g_ld = a.dld[b];
      float dyv[R];
#pragma unroll
      for (int r = 0; r < R; ++r) dyv[r] = dys[r * T + p];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float inv = 1.f - mks[r];
        const int q = (r + 5) % R;
        const float ds = dyv[r] * xk[r] * es[r] * inv + g_ld * inv * valid;
        dst[r * T + p] = ds * (1.f - th[r] * th[r]) + dyv[q] * (1.f - mks[q]);
        dyn[r * T + p] = mks[r] > 0.f ? dyv[r] : dyv[r] * es[r];
      }
    }
    g.sync();
    if (MODE == WALK) {
      for (int e = g.tid(); e < R * T; e += g.size()) {
        const int n = n0 + e % T;
        if (n < hi) a.y[cloud + (size_t)(e / T) * N + n] = xks[e];
      }
      return;
    }

    if (MODE == FULL) {
      // dWout += rnd(dst) rnd(h_last)^T, dbout += sum(dst)
      for (int e = g.tid(); e < R * H; e += g.size()) {
        const int r = e / H, o = e % H;
        float sm = 0.f;
        for (int p = 0; p < T; ++p) sm = fmaf(dst[r * T + p], hlast[p * ld + o], sm);
        adwout[e] += sm;
      }
      for (int r = g.tid(); r < R; r += g.size()) {
        float sm = 0.f;
        for (int p = 0; p < T; ++p) sm += dst[r * T + p];
        adbout[r] += sm;
      }
      g.sync();
    }

    // dh_last = (Wout^T rnd(dst)) * (h_last > 0), in place over h_last;
    // its f32 sum is the last hidden bias's gradient (or the tile's dhz)
    float* first_sum = NH1 > 0 ? adbh + (NH1 - 1) * H : dhzs;
    for (int o = g.tid(); o < H; o += g.size()) {
      float w[R];
#pragma unroll
      for (int r = 0; r < R; ++r) w[r] = wos[r * H + o];
      float sm = 0.f;
      for (int p = 0; p < T; ++p) {
        float v = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) v = fmaf(w[r], dst[r * T + p], v);
        v = v * (hlast[p * ld + o] > 0.f ? 1.f : 0.f);
        sm += v;
        hlast[p * ld + o] = v;
      }
      if (MODE == FULL) first_sum[o] = NH1 > 0 ? first_sum[o] + sm : sm;
    }

    for (int j = NH1 - 1; j >= 0; --j) {
      float* dh = hs + (j + 1) * hstride;   // cotangent of h_{j+1}, masked
      float* hj = hs + j * hstride;
      if (MODE == FULL) {
        g.sync();
        // dWh[j] += dh^T h_j
        gemm_acc<true, false>(g, H, H, T, dh, ld, hj, ld, awh + j * awh_stride, awh_ld, first);
      }
      g.sync();
      // dh_j = (dh Wh[j]) * (h_j > 0), in place over h_j
      gemm<false, false>(g, T, H, H, dh, ld, ws + j * wstride, ld, stage,
                          MODE == FULL ? colpart : nullptr, [&](int m, int n, float v) {
                            const float mv = v * (hj[m * ld + n] > 0.f ? 1.f : 0.f);
                            hj[m * ld + n] = mv;
                            return mv;
                          });
      g.sync();
      if (MODE == FULL)
        column_sums<float>(g, T, H, colpart, hj, ld, j > 0 ? adbh + (j - 1) * H : dhzs, j > 0);
    }
    g.sync();

    const float* dh0 = hs;
    if (MODE == FULL) {
      // dWx += rnd(dh_0) rnd(x_k)^T; this tile's dhz
      for (int e = g.tid(); e < H * R; e += g.size()) {
        const int o = e / R, c = e % R;
        float sm = 0.f;
        for (int p = 0; p < T; ++p) sm = fmaf(dh0[p * ld + o], xks[c * T + p], sm);
        adwx[e] += sm;
      }
      for (int e = g.tid(); e < H; e += g.size()) {
        if (STRIPES == 1) a.dhz_part[((size_t)tile * K + k) * H + e] = dhzs[e];
        else adhz[e] += dhzs[e];
      }
    }
    // dy_in = where(mask, dy, dy * es) + Wx^T rnd(dh_0): one warp per point
    for (int p = g.warp(); p < T; p += g.warps) {
      float sm[R];
#pragma unroll
      for (int c = 0; c < R; ++c) sm[c] = 0.f;
      for (int o = lane; o < H; o += 32) {
        const float d = dh0[p * ld + o];
#pragma unroll
        for (int c = 0; c < R; ++c) sm[c] = fmaf(wxs[o * R + c], d, sm[c]);
      }
#pragma unroll
      for (int c = 0; c < R; ++c)
        for (int off = 16; off; off >>= 1) sm[c] += __shfl_xor_sync(0xffffffffu, sm[c], off);
      const int n = n0 + p;
      if (lane < R && n < hi) {
        float v = sm[0];
#pragma unroll
        for (int c = 1; c < R; ++c) if (lane == c) v = sm[c];
        a.dy[cloud + (size_t)lane * N + n] = dyn[lane * T + p] + v;
        a.y[cloud + (size_t)lane * N + n] = xks[lane * T + p];
      }
    }
  };

  auto layer = [&](int i) {
    const int k = K - 1 - i;
    __syncthreads();  // every group is done with the previous layer's weights and sums
    for (int e = threadIdx.x; e < R * H; e += THREADS) {
      wxs[e] = wx[(size_t)k * R * H + e];
      wos[e] = wout[(size_t)k * R * H + e];
    }
    if (threadIdx.x < R) {
      bos[threadIdx.x] = a.bout[k * R + threadIdx.x];
      mks[threadIdx.x] = a.masks[k * R + threadIdx.x];
    }
    for (int e = threadIdx.x; e < NH1 * H; e += THREADS) bhs[e] = a.bh[(size_t)k * NH1 * H + e];
    for (int j = 0; j < NH1; ++j)
      load_square<H>(ws + j * wstride, wh + ((size_t)k * NH1 + j) * H * H, ld);
    if (MODE == FULL) {
      for (int e = g.tid(); e < H * R; e += g.size()) adwx[e] = adwout[e] = 0.f;
      for (int e = g.tid(); e < R; e += g.size()) adbout[e] = 0.f;
      for (int e = g.tid(); e < NH1 * H; e += g.size()) adbh[e] = 0.f;
      for (int e = g.tid(); e < H; e += g.size()) adhz[e] = 0.f;
    }
    __syncthreads();

    // the tiles: all B * nt round-robin over the blocks, or this block's
    // cloud's stripe s
    bool first = true;
    if (STRIPES == 1) {
      for (int tile = blockIdx.x; tile < a.B * nt; tile += gridDim.x, first = false)
        tile_step(k, tile / nt, (tile % nt) * T, N, tile, first);
    } else {
      const int per = N / STRIPES, lo = s * per;
      for (int n0 = lo; n0 < lo + per; n0 += T, first = false)
        tile_step(k, blockIdx.x, n0, lo + per, 0, first);
    }
    __syncthreads();
    if (MODE != FULL) return;
    // this block's partial of layer k, its stripes summed in order:
    // [dWx | dWh | dbh | dWout | dbout]
    auto groups = [&](int off, int e) {
      float sm = 0.f;
      for (int q = 0; q < STRIPES; ++q)
        sm += reinterpret_cast<const float*>(smem + L.group0 + q * L.gsize + off)[e];
      return sm;
    };
    float* out = a.part + ((size_t)blockIdx.x * K + k) * per_layer;
    for (int e = threadIdx.x; e < R * H; e += THREADS) out[e] = groups(L.adwx, e);
    out += R * H;
    for (int e = threadIdx.x; e < NH1 * H * H; e += THREADS) {
      const int j = e / (H * H), r = (e / H) % H, c = e % H;
      float sm = 0.f;
      if (STRIPES == 1) {
        sm = awh[j * astride + r * lda + c];
      } else {
        for (int q = 0; q < STRIPES; ++q)
          sm += a.awh[(((size_t)blockIdx.x * STRIPES + q) * L.nb + j) * H * H + r * H + c];
      }
      out[e] = sm;
    }
    out += NH1 * H * H;
    for (int e = threadIdx.x; e < NH1 * H; e += THREADS) out[e] = groups(L.adbh, e);
    out += NH1 * H;
    for (int e = threadIdx.x; e < R * H; e += THREADS) out[e] = groups(L.adwout, e);
    out += R * H;
    if (threadIdx.x < R) out[threadIdx.x] = groups(L.adbout, threadIdx.x);
    if (STRIPES > 1)
      for (int e = threadIdx.x; e < H; e += THREADS)
        a.dhz[((size_t)blockIdx.x * K + k) * H + e] = groups(L.adhz, e);
  };

  if constexpr (ROLLED) {
#pragma unroll 1
    for (int i = 0; i < K; ++i) layer(i);
  } else {
#pragma unroll 2
    for (int i = 0; i < K; ++i) layer(i);
  }
}

template <int MODE, int T, bool ROLLED, int STRIPES>
cudaError_t launch_f32(const Args& a) {
  const int bytes = Smem(HID, a.NH1, T, STRIPES).total;
  auto kernel = probe_kernel<MODE, T, ROLLED, STRIPES>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<a.blocks, THREADS, bytes, a.stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess || MODE != FULL) return e;
  const long long per_layer = 2LL * R * HID + (long long)a.NH1 * HID * HID + (long long)a.NH1 * HID + R;
  if ((e = launch_reduce(a.part, a.dw, 1, a.blocks, per_layer * a.K, a.stream)) != cudaSuccess)
    return e;
  if (STRIPES > 1) return cudaSuccess;
  return launch_reduce(a.dhz_part, a.dhz, a.B, (a.N + T - 1) / T, (long long)a.K * HID, a.stream);
}

// ---------------------------------------------------------------- bf16 mode

template <int MODE, bool ROLLED, int S>
__global__ void __launch_bounds__(THREADS, 1) probe_rows_kernel(Args a) {
  bwd_rows<HID, R, MODE, ROLLED, S>(
      a.y, a.dy, a.dld, a.hz, static_cast<const bf16*>(a.wx), static_cast<const bf16*>(a.wh),
      a.bh, static_cast<const bf16*>(a.wout), a.bout, a.masks, a.part, a.dhz_part, a.B, a.N,
      a.n_valid, a.K, a.NH1, a.cap);
}

template <int MODE, bool ROLLED, int S>
cudaError_t launch_rows(const Args& a) {
  const int bytes = MmaSmem(HID, a.NH1, true).total;
  if (a.NH1 > Mma<HID>::NH1_MAX || bytes > SMEM_MAX) return cudaErrorInvalidValue;
  auto kernel = probe_rows_kernel<MODE, ROLLED, S>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  kernel<<<a.blocks, THREADS, bytes, a.stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess || MODE != FULL) return e;
  return bwd_rows_reduce<HID, R, S>(a.part, a.dhz_part, a.dw, a.dhz, a.B, a.N, a.K, a.NH1,
                                    a.blocks, a.stream);
}

// The forms the library is built for (bench_fused_bwd.py: BUILT, ILV_BUILT,
// ILV_TILE): bf16 tile 128 in each mode and loop form, interleaved with 2
// and 4 groups on the same 128-point tile, rolled or not; f32 tile 32 in
// each mode unrolled and full rolled, interleaved with 2 and 4 stripes of
// 16-point tiles, unrolled.
cudaError_t probe_bf16(int tile, int mode, int rolled, int stripes, const Args& a) {
  if (tile != MT) return cudaErrorInvalidValue;
  switch ((stripes * 3 + mode) * 2 + rolled) {
    case 6: return launch_rows<FULL, false, 1>(a);
    case 7: return launch_rows<FULL, true, 1>(a);
    case 8: return launch_rows<NOWG, false, 1>(a);
    case 9: return launch_rows<NOWG, true, 1>(a);
    case 10: return launch_rows<WALK, false, 1>(a);
    case 11: return launch_rows<WALK, true, 1>(a);
    case 12: return launch_rows<FULL, false, 2>(a);
    case 13: return launch_rows<FULL, true, 2>(a);
    case 24: return launch_rows<FULL, false, 4>(a);
    case 25: return launch_rows<FULL, true, 4>(a);
    default: return cudaErrorInvalidValue;
  }
}

constexpr int TILE_F32 = 32, ILV_T_F32 = 16;

cudaError_t probe_f32(int tile, int mode, int rolled, int stripes, const Args& a) {
  if (stripes > 1) {
    if (tile != ILV_T_F32 || rolled || mode != FULL || a.N % stripes) return cudaErrorInvalidValue;
    if (stripes == 2) return launch_f32<FULL, ILV_T_F32, false, 2>(a);
    if (stripes == 4) return launch_f32<FULL, ILV_T_F32, false, 4>(a);
    return cudaErrorInvalidValue;
  }
  if (tile != TILE_F32) return cudaErrorInvalidValue;
  switch (mode * 2 + rolled) {
    case 0: return launch_f32<FULL, TILE_F32, false, 1>(a);
    case 1: return launch_f32<FULL, TILE_F32, true, 1>(a);
    case 2: return launch_f32<NOWG, TILE_F32, false, 1>(a);
    case 4: return launch_f32<WALK, TILE_F32, false, 1>(a);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int dpfx_probe_bwd_smem_bytes(int H, int NH1, int bf16, int tile, int stripes) {
  return bf16 ? MmaSmem(H, NH1, true).total : Smem(H, NH1, tile, stripes).total;
}

int dpfx_probe_bwd(float* y, float* dy, const float* dld, const float* hz, const void* wx,
                   const void* wh, const float* bh, const void* wout, const float* bout,
                   const float* masks, float* part, float* dhz_part, float* dw, float* dhz,
                   float* awh, int B, int N, int n_valid, int K, int H, int NH1, float cap,
                   int bf16, int mode, int rolled, int tile, int stripes, int blocks,
                   void* stream) {
  if (B <= 0 || N <= 0 || K <= 0 || NH1 < 0 || blocks <= 0 || H != HID || mode < 0 || mode > 2 ||
      n_valid < 0 || n_valid > N || (stripes != 1 && stripes != 2 && stripes != 4) ||
      (stripes > 1 && mode != FULL))
    return (int)cudaErrorInvalidValue;
  const Args a{y, dy, dld, hz, wx, wh, bh, wout, bout, masks, part, dhz_part, dw, dhz, awh,
               B, N, n_valid, K, NH1, cap, blocks, static_cast<cudaStream_t>(stream)};
  rolled = rolled ? 1 : 0;
  return (int)(bf16 ? probe_bf16(tile, mode, rolled, stripes, a)
                    : probe_f32(tile, mode, rolled, stripes, a));
}

}  // extern "C"
