// Fused latent-prior flow on Hopper (sm_90a): the forward of all K affine
// couplings with the per-sample log-det, its backward, and the inverse.
//
// Replaces the Pallas TPU kernels `_lat_fwd_kernel`
// (dpfx/ops/fused_latent.py:151), `_lat_inv_kernel` (:170) and
// `_lat_bwd_kernel` (:185).
//
// Work per sample and layer: the conditioner's Win (H x D), (n_hidden-1) x
// Wh (H x H), Ws and Wt (D x H each) products, 2(3DH + (n_hidden-1)H^2)
// FLOP forward; the backward recomputes the conditioner and adds the
// cotangent and weight-gradient products, about 3x the forward. At the
// flagship latent flow (K=14, D=dz=128, H=256, n_hidden=2) and B=64 that is
// 294 MFLOP forward against 4.6 MB of bf16 weights: 0.30 us of tensor-core
// time and 1.4 us of HBM time at 3.35 TB/s. Neither binds: the floor is the
// dependent chain of 14 layers x 3 products (Win -> Wh -> Ws/Wt), each
// needing the whole of the one before it.
//
// bf16 mode (`cluster_flow_kernel`, `cluster_bwd_kernel`): one layer split
// across a thread-block cluster.
//   * A cluster of C CTAs owns a group of G samples (grid: ceil(B / G)
//     clusters). Rank r owns HC = H / C hidden columns and DC = D / C latent
//     features: for every layer it computes only its columns of h_0 ..
//     h_NH1 and its features of (st_s, st_t) and of the coupling. Every
//     product element is one whole K-sum inside one CTA: per CTA a product
//     is a G x HC (or G x DC) tile, m16n8k16 `mma.sync` tiles one per warp,
//     both operands from shared memory through ldmatrix.
//   * Exchange. After each product a rank writes its bf16 slice (f32 bias
//     and relu, one cast) into the full activation buffer of every CTA of
//     the cluster through distributed shared memory, then the cluster
//     syncs: 3 exchanges a layer forward and inverse at n_hidden = 2 (h_0,
//     h_1, the new state; Ws and Wt are one stage). A rank keeps its own
//     features of the state in f32; the rounded state is exchanged.
//   * Weights. Each rank stages only its slices of a layer: the rows of Win,
//     Wh, Ws and Wt it owns, their biases and its mask features (~21 KB at
//     C = 16), with cp.async into two stages in walk order (forward
//     ascending, inverse descending), the next layer's behind this one's.
//   * Log-det. Each rank sums its own features of each layer per sample in
//     feature order and keeps the running sum; at the end the ranks' sums
//     are added in rank order. Bit-identical from run to run.
//   * Backward, same split, and the conditioner recomputed by the device
//     function the forward calls (`cond`), so relu masks agree bit for bit.
//     Per layer, in reverse: the recompute (3 exchanges); for its own
//     features x_k from the closed-form inverse, ds_s, d_t and dy * es, and
//     rnd(ds_s), rnd(d_t), rnd(x_k) exchanged; dh_last[:, own columns] =
//     (rnd(ds_s) Ws + rnd(d_t) Wt)[:, own] * (h_last > 0), exchanged; down
//     the hidden layers the same; dy_in[:, own features] = dy es +
//     rnd(dh_0) Win[:, own]. These use the column slices of Ws, Wt, Wh and
//     Win, staged too (~37 KB at C = 16). The weight and bias gradients of
//     the rows a rank owns sum over the group's G samples inside that CTA
//     (points as the K dimension, through ldmatrix.trans); at B <= G the
//     kernel writes them directly, above G each cluster writes one slice
//     (walking groups cluster, cluster + clusters, ... in order) and
//     `reduce_slices` adds the slices in order. No float atomics. One
//     region each for the row and the column slices: the next layer's rows
//     load behind this layer's cotangent products, its columns behind its
//     recompute. A cluster sync ends each layer (the next layer writes into
//     buffers this one still reads).
//   * Shared memory per CTA (bytes, `CLay`; at D=128, H=256, n_hidden=2):
//     forward and inverse at G=64, C=16: xr (the rounded state, G x D) 17,408,
//     h_0 .. h_NH1 (G x H each) 67,584, own f32 state, st_s, st_t 6,144,
//     log-det 256, the ranks' log-det slots 4,096, two row stages 43,776:
//     139,264. Backward at G=64, C=16: xr, h as above, dh (G x H) 33,792, a
//     second dh that also holds rnd(ds_s) and rnd(d_t) 34,816, own f32 y,
//     dy, ds_s, d_t 8,192, own f32 dh twice 8,192, g_ld 256, one row region
//     21,888, one column region 36,864: 228,992 of 232,448. At C=8 the
//     backward fits only at G=32. The wrapper chooses (C, G) up front
//     (`fused_latent.cluster_plan`, which mirrors CLay); a launch the card
//     refuses returns its error.
//   * What bounds it: the chain of exchanges. Each is an all-gather (every
//     CTA receives the group's whole activation, G x H x 2 bytes, through
//     distributed shared memory, whose rate per SM is far below HBM's) and
//     a cluster barrier. So the time grows with G, and the default plan is
//     the smallest group, G = 16 on clusters of 16: the fastest of the plans
//     chip_smoke.py's phase 4 times, the backward's slice reduction
//     included (PERF.md).
//
// f32 mode (`flow_kernel`, `bwd_kernel`), the check mode: a
// block owns a tile of TB = 16 samples, keeps the tile's state and every
// activation in shared memory and walks all K layers itself; every product
// reads its weights from global memory as register-tiled IEEE f32 FMA
// (dpfx_common.cuh's gemm), so the f32 check is not blurred by TF32. Its
// backward writes per-block gradient slices that `reduce_slices` adds.
//
// Rounding as the Pallas kernels: operands in the compute dtype, f32 sums,
// bias and relu in f32, one cast; coupling, tanh cap and log-det in f32.
// Cotangents are cast to the compute dtype before each product; bias
// gradients sum the f32 values. Ragged samples carry zero cotangent and no
// log-det gradient.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). Each
// launch returns cudaGetLastError().

#include <cooperative_groups.h>

#include "dpfx_common.cuh"

namespace cg = cooperative_groups;

// A named namespace: `Weights` is a kernel argument, and nvcc's host stubs
// break on an argument type in an anonymous namespace.
namespace dpfx_latent {

using namespace dpfx;

// ============================================================ f32 mode

constexpr int TB = 16;   // samples per block

// the stacked f32 weights of all K layers
struct Weights {
  const float* win;     // [K, H, D], mask folded
  const float* bin;     // [K, H]
  const float* wh;      // [K, NH1, H, H]
  const float* bh;      // [K, NH1, H]
  const float* ws;      // [K, D, H]
  const float* bs;      // [K, D]
  const float* wt;      // [K, D, H]
  const float* bt;      // [K, D]
  const float* masks;   // [K, D], 1 = passthrough
};

// floats of one layer's gradients: [Win | bin | Wh | bh | Ws | bs | Wt | bt]
__host__ __device__ inline long long per_layer(int D, int H, int NH1) {
  return (long long)H * D + H + (long long)NH1 * H * H + (long long)NH1 * H + 2LL * (D * H + D);
}

// shared-memory carve-up of the f32 kernels (dpfx_fused_latent_smem_bytes
// reports its size)
struct Smem {
  int ldd, ldh, hstride;                  // row strides and hidden-tile stride, in elements
  int xs, xr, hs, sts, stt, stage, lds;   // every kernel
  int dys, dyn, dssr, dtr, dhf, dhr;      // backward only
  int total;
  __host__ __device__ Smem(int D, int H, int NH1, bool bwd) {
    ldd = D + 1;
    ldh = H + 1;
    const int hbytes = round128(TB * ldh * 4);
    hstride = hbytes / 4;
    int o = 0;
    xs = o;    o += round128(TB * D * 4);                    // the state (y in the backward)
    xr = o;    o += round128(TB * ldd * 4);                  // the conditioner's input, padded rows
    hs = o;    o += (NH1 + 1) * hbytes;                      // h_0 .. h_NH1
    sts = o;   o += round128(TB * D * 4);                    // st_s (backward: ds_s)
    stt = o;   o += round128(TB * D * 4);                    // st_t (backward: d_t)
    stage = o; o += round128(WARPS * 256 * 4);
    lds = o;   o += round128(TB * 4);                        // log-det (backward: its cotangent)
    dys = dyn = dssr = dtr = dhf = dhr = o;
    if (bwd) {
      dys = o;  o += round128(TB * D * 4);                   // cotangent of the layer output
      dyn = o;  o += round128(TB * D * 4);                   // where(mask, dy, dy * es)
      dssr = o; o += round128(TB * ldd * 4);                 // ds_s, padded rows
      dtr = o;  o += round128(TB * ldd * 4);                 // d_t, padded rows
      dhf = o;  o += round128(TB * H * 4);                   // hidden cotangent, f32
      dhr = o;  o += round128(TB * ldh * 4);                 // it, padded rows
    }
    total = o;
  }
};

// The conditioner of layer k on the tile's input xr: h_0 .. h_NH1 into hs
// + j * hstride (after relu), then st_s and st_t (bias added) into sts and
// stt. Synchronises before it returns.
__device__ void cond_st(const Weights& w, int k, int D, int H, int NH1, const Smem& L,
                        unsigned char* smem) {
  const float* xr = reinterpret_cast<const float*>(smem + L.xr);
  float* hs = reinterpret_cast<float*>(smem + L.hs);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* sts = reinterpret_cast<float*>(smem + L.sts);
  float* stt = reinterpret_cast<float*>(smem + L.stt);
  const int ldd = L.ldd, ldh = L.ldh;
  const float* bin = w.bin + (size_t)k * H;
  gemm<false, true>(TB, H, D, xr, ldd, w.win + (size_t)k * H * D, D, stage, nullptr,
                    [&](int m, int n, float v) {
                      hs[m * ldh + n] = relu_nan(v + bin[n]);
                      return 0.f;
                    });
  for (int j = 0; j < NH1; ++j) {
    __syncthreads();
    const float* hin = hs + j * L.hstride;
    float* hout = hs + (j + 1) * L.hstride;
    const float* bj = w.bh + ((size_t)k * NH1 + j) * H;
    gemm<false, true>(TB, H, H, hin, ldh, w.wh + ((size_t)k * NH1 + j) * H * H, H, stage, nullptr,
                      [&](int m, int n, float v) {
                        hout[m * ldh + n] = relu_nan(v + bj[n]);
                        return 0.f;
                      });
  }
  __syncthreads();
  const float* hl = hs + NH1 * L.hstride;
  const float* bs = w.bs + (size_t)k * D;
  const float* bt = w.bt + (size_t)k * D;
  gemm<false, true>(TB, D, H, hl, ldh, w.ws + (size_t)k * D * H, H, stage, nullptr,
                    [&](int m, int n, float v) {
                      sts[m * D + n] = v + bs[n];
                      return 0.f;
                    });
  gemm<false, true>(TB, D, H, hl, ldh, w.wt + (size_t)k * D * H, H, stage, nullptr,
                    [&](int m, int n, float v) {
                      stt[m * D + n] = v + bt[n];
                      return 0.f;
                    });
  __syncthreads();
}

// forward (INV false: z -> u and the log-det) or inverse (eps -> z)
template <bool INV>
__global__ void __launch_bounds__(THREADS)
flow_kernel(const float* __restrict__ in, float* __restrict__ out, float* __restrict__ ld,
            Weights w, int B, int D, int H, int K, int NH1, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(D, H, NH1, false);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* xr = reinterpret_cast<float*>(smem + L.xr);
  float* sts = reinterpret_cast<float*>(smem + L.sts);
  const float* stt = reinterpret_cast<const float*>(smem + L.stt);
  float* lds = reinterpret_cast<float*>(smem + L.lds);
  const int tid = threadIdx.x, b0 = blockIdx.x * TB;
  const int rows = min(TB, B - b0);

  for (int e = tid; e < TB * D; e += THREADS) xs[e] = e / D < rows ? in[(size_t)b0 * D + e] : 0.f;
  if (tid < TB) lds[tid] = 0.f;
  for (int i = 0; i < K; ++i) {
    const int k = INV ? K - 1 - i : i;
    __syncthreads();  // the previous layer is done with xs and sts
    for (int e = tid; e < TB * D; e += THREADS) xr[(e / D) * L.ldd + e % D] = xs[e];
    __syncthreads();
    cond_st(w, k, D, H, NH1, L, smem);
    const float* mk = w.masks + (size_t)k * D;
    for (int e = tid; e < TB * D; e += THREADS) {
      if (mk[e % D] > 0.f) {
        sts[e] = 0.f;
        continue;
      }
      const float s = cap * tanhf(sts[e] / cap);
      xs[e] = INV ? (xs[e] - stt[e]) * expf(-s) : xs[e] * expf(s) + stt[e];
      sts[e] = s;
    }
    if (!INV) {
      __syncthreads();
      // the layer's log-det of each sample: a warp per sample, lanes over
      // the features in order, then a butterfly (a fixed order)
      const int warp = tid / 32, lane = tid % 32;
      for (int m = warp; m < TB; m += WARPS) {
        float s = 0.f;
        for (int d = lane; d < D; d += 32) s += sts[m * D + d];
        for (int off = 16; off; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
        if (lane == 0) lds[m] += s;
      }
    }
  }
  __syncthreads();
  for (int e = tid; e < rows * D; e += THREADS) out[(size_t)b0 * D + e] = xs[e];
  if (!INV && tid < rows) ld[b0 + tid] = lds[tid];
}

__global__ void __launch_bounds__(THREADS)
bwd_kernel(const float* __restrict__ u, const float* __restrict__ du,
           const float* __restrict__ dld, float* __restrict__ dz, float* __restrict__ part,
           Weights w, int B, int D, int H, int K, int NH1, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem L(D, H, NH1, true);
  const int ldd = L.ldd, ldh = L.ldh;
  float* ys = reinterpret_cast<float*>(smem + L.xs);
  float* xr = reinterpret_cast<float*>(smem + L.xr);
  const float* hs = reinterpret_cast<const float*>(smem + L.hs);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* dss = reinterpret_cast<float*>(smem + L.sts);   // st_s, then ds_s
  float* dts = reinterpret_cast<float*>(smem + L.stt);   // st_t, then d_t
  float* gld = reinterpret_cast<float*>(smem + L.lds);
  float* dys = reinterpret_cast<float*>(smem + L.dys);
  float* dyn = reinterpret_cast<float*>(smem + L.dyn);
  float* dssr = reinterpret_cast<float*>(smem + L.dssr);
  float* dtr = reinterpret_cast<float*>(smem + L.dtr);
  float* dhf = reinterpret_cast<float*>(smem + L.dhf);
  float* dhr = reinterpret_cast<float*>(smem + L.dhr);
  const int tid = threadIdx.x;
  const long long pl = per_layer(D, H, NH1);
  const float* hl = hs + NH1 * L.hstride;

  for (int tile = blockIdx.x; tile * TB < B; tile += gridDim.x) {
    const bool first = tile == (int)blockIdx.x;   // the block's first tile stores its slice
    const int b0 = tile * TB, rows = min(TB, B - b0);
    __syncthreads();  // the previous tile is done with the shared buffers
    for (int e = tid; e < TB * D; e += THREADS) {
      const bool valid = e / D < rows;
      ys[e] = valid ? u[(size_t)b0 * D + e] : 0.f;
      dys[e] = valid ? du[(size_t)b0 * D + e] : 0.f;
    }
    if (tid < TB) gld[tid] = tid < rows ? dld[b0 + tid] : 0.f;

    for (int k = K - 1; k >= 0; --k) {
      // this block's gradient slice of layer k
      float* gwin = part + ((size_t)blockIdx.x * K + k) * pl;
      float* gbin = gwin + (size_t)H * D;
      float* gwh = gbin + H;
      float* gbh = gwh + (size_t)NH1 * H * H;
      float* gws = gbh + (size_t)NH1 * H;
      float* gbs = gws + (size_t)D * H;
      float* gwt = gbs + D;
      float* gbt = gwt + (size_t)D * H;
      __syncthreads();  // the previous layer is done with ys, dys, xr and dh
      for (int e = tid; e < TB * D; e += THREADS) xr[(e / D) * ldd + e % D] = ys[e];
      __syncthreads();
      // the forward conditioner, recomputed from the layer output
      cond_st(w, k, D, H, NH1, L, smem);

      // coupling cotangents; the layer input from the closed-form inverse
      const float* mk = w.masks + (size_t)k * D;
      for (int e = tid; e < TB * D; e += THREADS) {
        const int m = e / D, d = e % D;
        const float yv = ys[e], dyv = dys[e];
        float xk = yv, ds_s = 0.f, d_t = 0.f, dy_n = dyv;
        if (mk[d] <= 0.f) {
          const float th = tanhf(dss[e] / cap), es = expf(cap * th);
          xk = (yv - dts[e]) / es;
          ds_s = (dyv * xk * es + gld[m]) * (1.f - th * th);
          d_t = dyv;
          dy_n = dyv * es;
        }
        ys[e] = xk;
        xr[m * ldd + d] = xk;
        dss[e] = ds_s;
        dts[e] = d_t;
        dssr[m * ldd + d] = ds_s;
        dtr[m * ldd + d] = d_t;
        dyn[e] = dy_n;
      }
      __syncthreads();

      // dWs, dWt (+)= rnd(ds_s)^T rnd(h_last), rnd(d_t)^T rnd(h_last); dbs, dbt
      gemm_acc<true, false>(D, H, TB, dssr, ldd, hl, ldh, gws, H, first);
      gemm_acc<true, false>(D, H, TB, dtr, ldd, hl, ldh, gwt, H, first);
      column_sums<float>(TB, D, nullptr, dss, D, gbs, !first);
      column_sums<float>(TB, D, nullptr, dts, D, gbt, !first);
      // dh_last = (rnd(ds_s) Ws + rnd(d_t) Wt) * (h_last > 0)
      gemm<false, false>(TB, H, D, dssr, ldd, w.ws + (size_t)k * D * H, H, stage, nullptr,
                         [&](int m, int n, float v) {
                           dhf[m * H + n] = v;
                           return 0.f;
                         });
      __syncthreads();
      gemm<false, false>(TB, H, D, dtr, ldd, w.wt + (size_t)k * D * H, H, stage, nullptr,
                         [&](int m, int n, float v) {
                           const float g = (dhf[m * H + n] + v) * (to_f(hl[m * ldh + n]) > 0.f ? 1.f : 0.f);
                           dhf[m * H + n] = g;
                           dhr[m * ldh + n] = g;
                           return 0.f;
                         });
      for (int j = NH1 - 1; j >= 0; --j) {
        const float* hj = hs + j * L.hstride;
        __syncthreads();
        // dWh[j] (+)= rnd(dh)^T rnd(h_j); dbh[j] (+)= column sums of dh
        gemm_acc<true, false>(H, H, TB, dhr, ldh, hj, ldh, gwh + (size_t)j * H * H, H, first);
        column_sums<float>(TB, H, nullptr, dhf, H, gbh + (size_t)j * H, !first);
        __syncthreads();
        // dh_j = (rnd(dh) Wh[j]) * (h_j > 0): f32 first, rounded after (dhr
        // is this product's operand)
        gemm<false, false>(TB, H, H, dhr, ldh, w.wh + ((size_t)k * NH1 + j) * H * H, H, stage,
                           nullptr, [&](int m, int n, float v) {
                             dhf[m * H + n] = v * (to_f(hj[m * ldh + n]) > 0.f ? 1.f : 0.f);
                             return 0.f;
                           });
        __syncthreads();
        for (int e = tid; e < TB * H; e += THREADS) dhr[(e / H) * ldh + e % H] = dhf[e];
      }
      __syncthreads();
      // dWin (+)= rnd(dh_0)^T rnd(x_k); dbin (+)= column sums of dh_0
      gemm_acc<true, false>(H, D, TB, dhr, ldh, xr, ldd, gwin, D, first);
      column_sums<float>(TB, H, nullptr, dhf, H, gbin, !first);
      // dy of the layer input = where(mask, dy, dy * es) + rnd(dh_0) Win
      gemm<false, false>(TB, D, H, dhr, ldh, w.win + (size_t)k * H * D, D, stage, nullptr,
                         [&](int m, int n, float v) {
                           dys[m * D + n] = dyn[m * D + n] + v;
                           return 0.f;
                         });
    }
    __syncthreads();
    for (int e = tid; e < rows * D; e += THREADS) dz[(size_t)b0 * D + e] = dys[e];
  }
}

Weights weights(const void* win, const float* bin, const void* wh, const float* bh,
                const void* ws, const float* bs, const void* wt, const float* bt,
                const float* masks) {
  return Weights{static_cast<const float*>(win), bin, static_cast<const float*>(wh), bh,
                 static_cast<const float*>(ws), bs, static_cast<const float*>(wt), bt, masks};
}

template <bool INV>
cudaError_t launch_flow(const float* in, float* out, float* ld, const Weights& w, int B, int D,
                        int H, int K, int NH1, float cap, cudaStream_t stream) {
  const int bytes = Smem(D, H, NH1, false).total;
  cudaError_t e = cudaFuncSetAttribute(flow_kernel<INV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  flow_kernel<INV><<<(B + TB - 1) / TB, THREADS, bytes, stream>>>(in, out, ld, w, B, D, H, K,
                                                                      NH1, cap);
  return cudaGetLastError();
}

cudaError_t launch_bwd(const float* u, const float* du, const float* dld, float* dz, float* part,
                       float* dw, const Weights& w, int B, int D, int H, int K, int NH1,
                       float cap, int blocks, cudaStream_t stream) {
  const int bytes = Smem(D, H, NH1, true).total;
  cudaError_t e = cudaFuncSetAttribute(bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return e;
  bwd_kernel<<<blocks, THREADS, bytes, stream>>>(u, du, dld, dz, part, w, B, D, H, K, NH1, cap);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_reduce(part, dw, 1, blocks, per_layer(D, H, NH1) * K, stream);
}


// ============================================================ bf16 mode: clusters

using bf16 = __nv_bfloat16;

// row stride of a bf16 tile of n columns: a whole and odd number of 16-byte
// units, so the 8 rows of an ldmatrix fall in 8 different bank groups
__host__ __device__ constexpr int ldp(int n) { return (n / 8) % 2 ? n + 16 : n + 8; }

// Shared-memory carve-up of one CTA (byte offsets; fused_latent.py's
// cluster_smem_bytes mirrors it)
struct CLay {
  int HC, DC, ldd, ldh, lhc, ldc, hstride;
  int xr, hs, xs, sts, stt, lds, slots, dys, dA, dB, dhf0, dhf1, rows0, rows1, cols;
  // within a row region: layer k's rows of Win, Wh, Ws, Wt, then f32 vectors
  int r_win, r_wh, r_ws, r_wt, r_bin, r_bh, r_bs, r_bt, r_mask, rbytes;
  // within the column region (backward): layer k's columns of Ws, Wt, Wh, Win
  int c_ws, c_wt, c_wh, c_win, cbytes;
  int total;
  __host__ __device__ CLay(int D, int H, int NH1, int G, int C, bool bwd) {
    HC = H / C;
    DC = D / C;
    ldd = ldp(D);
    ldh = ldp(H);
    lhc = ldp(HC);
    ldc = ldp(DC);
    int o = 0;
    r_win = o;  o += round128(HC * ldd * 2);
    r_wh = o;   o += round128(NH1 * HC * ldh * 2);
    r_ws = o;   o += round128(DC * ldh * 2);
    r_wt = o;   o += round128(DC * ldh * 2);
    r_bin = o;  o += round128(HC * 4);
    r_bh = o;   o += round128(NH1 * HC * 4);
    r_bs = o;   o += round128(DC * 4);
    r_bt = o;   o += round128(DC * 4);
    r_mask = o; o += round128(DC * 4);
    rbytes = o;
    o = 0;
    c_ws = o;  o += round128(D * lhc * 2);
    c_wt = o;  o += round128(D * lhc * 2);
    c_wh = o;  o += round128(NH1 * H * lhc * 2);
    c_win = o; o += round128(H * ldc * 2);
    cbytes = bwd ? o : 0;
    const int hb = round128(G * ldh * 2), own = round128(G * DC * 4);
    hstride = hb / 2;
    o = 0;
    xr = o;  o += round128(G * ldd * 2);      // the rounded state: the conditioner's input
    hs = o;  o += (NH1 + 1) * hb;             // h_0 .. h_NH1
    xs = o;  o += own;                        // own features of the state, f32 (backward: y)
    sts = o; o += own;                        // st_s (backward: ds_s)
    stt = o; o += own;                        // st_t (backward: d_t)
    lds = o; o += round128(G * 4);            // log-det sums (backward: g_ld)
    slots = dys = dA = dB = dhf0 = dhf1 = o;
    if (!bwd) {
      slots = o; o += round128(C * G * 4);    // every rank's log-det sums, in rank 0
    } else {
      dys = o;  o += own;                     // dy of the own features (then dy es)
      dA = o;   o += hb;                      // rnd(dh), full
      dB = o;   o += round128((2 * G * ldd > G * ldh ? 2 * G * ldd : G * ldh) * 2);  // rnd(ds_s), rnd(d_t); or rnd(dh)
      dhf0 = o; o += round128(G * HC * 4);    // own columns of dh, f32
      dhf1 = o; o += round128(G * HC * 4);
    }
    rows0 = o; o += rbytes;
    rows1 = rows0;
    if (!bwd) { rows1 = o; o += rbytes; }
    cols = o;  o += cbytes;
    total = o;
  }
};

// the stacked bf16 weights of all K layers; biases and masks in f32
struct WB {
  const bf16* win;      // [K, H, D], mask folded
  const float* bin;     // [K, H]
  const bf16* wh;       // [K, NH1, H, H]
  const float* bh;      // [K, NH1, H]
  const bf16* ws;       // [K, D, H]
  const float* bs;      // [K, D]
  const bf16* wt;       // [K, D, H]
  const float* bt;      // [K, D]
  const float* masks;   // [K, D], 1 = passthrough
};

// this CTA's place in the cluster
struct Cx {
  int C, rank, HC, DC;
};

__device__ __forceinline__ void csync(const Cx& cx) {
  if (cx.C > 1) cg::this_cluster().sync();
  else __syncthreads();
}

__device__ __forceinline__ uint32_t mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

// the bf16 pair v at element i of buf, in every CTA of the cluster
__device__ __forceinline__ void put2(const Cx& cx, bf16* buf, int i, uint32_t v) {
  if (cx.C == 1) {
    *reinterpret_cast<uint32_t*>(buf + i) = v;
    return;
  }
  const uint32_t a = smem_u32(buf + i);
  for (int q = 0; q < cx.C; ++q) {
    int r = cx.rank + q;
    if (r >= cx.C) r -= cx.C;
    asm volatile("st.shared::cluster.u32 [%0], %1;" ::"r"(mapa(a, r)), "r"(v) : "memory");
  }
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];"
               : "=r"(r[0]), "=r"(r[1]) : "r"(smem_u32(p)));
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// c = sum over k < K of A(m0 + i, k) B(k, n0 + j): one m16 x n8 tile of a
// warp, operands in shared memory through ldmatrix, K a multiple of 16.
//   AT false: A(m, k) = a[m * lda + k];   AT true: A(m, k) = a[k * lda + m]
//   BK false: B(k, n) = b[n * ldb + k];   BK true: B(k, n) = b[k * ldb + n]
// Four k16 steps' fragments are loaded before their products; even and odd
// steps sum into two accumulators, added at the end (a fixed order).
template <bool AT, bool BK>
__device__ __forceinline__ void tile(float (&c)[4], const bf16* a, int lda, int m0, const bf16* b,
                                     int ldb, int n0, int K) {
  const int lane = lane_id();
  const bf16* pa = AT ? a + ((lane & 7) + ((lane >> 4) << 3)) * lda + m0 + ((lane >> 3) & 1) * 8
                      : a + (m0 + (lane & 15)) * lda + (lane >> 4) * 8;
  const bf16* pb = BK ? b + ((lane & 7) + ((lane >> 3) & 1) * 8) * ldb + n0
                      : b + (n0 + (lane & 7)) * ldb + ((lane >> 3) & 1) * 8;
  const int sa = AT ? 16 * lda : 16, sb = BK ? 16 * ldb : 16;
  float e[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] = 0.f;
  for (int k0 = 0; k0 < K; k0 += 64) {
    uint32_t fa[4][4], fb[4][2];
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (k0 + 16 * s < K) {
        if (AT) ldsm_x4_t(fa[s], pa + s * sa);
        else ldsm_x4(fa[s], pa + s * sa);
        if (BK) ldsm_x2_t(fb[s], pb + s * sb);
        else ldsm_x2(fb[s], pb + s * sb);
      }
    }
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      if (k0 + 16 * s < K) {
        if (s & 1) mma16(e, fa[s], fb[s][0], fb[s][1]);
        else mma16(c, fa[s], fb[s][0], fb[s][1]);
      }
    }
    pa += 4 * sa;
    pb += 4 * sb;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += e[i];
}

// n floats (a multiple of 4) from global to shared memory with cp.async
__device__ __forceinline__ void copy_f32(float* dst, const float* src, int n) {
  for (int v = threadIdx.x; v < n / 4; v += THREADS) cp_async16(dst + 4 * v, src + 4 * v);
}

// rows x 8v bf16 from global (row stride gs) to shared memory (row stride
// ss) with cp.async: a thread copies one 16-byte column of THREADS / v rows
// a pass (v <= THREADS), so its loop holds no division
__device__ __forceinline__ void copy_rows(bf16* dst, int ss, const bf16* src, size_t gs, int rows,
                                          int v) {
  const int per = THREADS / v, r0 = threadIdx.x / v, c = (threadIdx.x % v) * 8;
  if (r0 >= per) return;
  for (int r = r0; r < rows; r += per) cp_async16(dst + r * ss + c, src + r * gs + c);
}

// start the cp.async copies of the rows of layer k that rank owns: Win, Wh,
// Ws, Wt (its HC hidden units, its DC features), their biases and its mask
__device__ void load_rows(unsigned char* st, const CLay& L, const WB& w, int k, int rank, int D,
                          int H, int NH1) {
  const int HC = L.HC, DC = L.DC;
  copy_rows(reinterpret_cast<bf16*>(st + L.r_win), L.ldd, w.win + ((size_t)k * H + rank * HC) * D,
            D, HC, D / 8);
  for (int j = 0; j < NH1; ++j)
    copy_rows(reinterpret_cast<bf16*>(st + L.r_wh) + j * HC * L.ldh, L.ldh,
              w.wh + (((size_t)k * NH1 + j) * H + rank * HC) * H, H, HC, H / 8);
  copy_rows(reinterpret_cast<bf16*>(st + L.r_ws), L.ldh, w.ws + ((size_t)k * D + rank * DC) * H,
            H, DC, H / 8);
  copy_rows(reinterpret_cast<bf16*>(st + L.r_wt), L.ldh, w.wt + ((size_t)k * D + rank * DC) * H,
            H, DC, H / 8);
  copy_f32(reinterpret_cast<float*>(st + L.r_bin), w.bin + (size_t)k * H + rank * HC, HC);
  for (int j = 0; j < NH1; ++j)
    copy_f32(reinterpret_cast<float*>(st + L.r_bh) + j * HC,
             w.bh + ((size_t)k * NH1 + j) * H + rank * HC, HC);
  copy_f32(reinterpret_cast<float*>(st + L.r_bs), w.bs + (size_t)k * D + rank * DC, DC);
  copy_f32(reinterpret_cast<float*>(st + L.r_bt), w.bt + (size_t)k * D + rank * DC, DC);
  copy_f32(reinterpret_cast<float*>(st + L.r_mask), w.masks + (size_t)k * D + rank * DC, DC);
}

// start the copies of the columns of layer k that rank owns (backward): Ws
// and Wt [D][own HC], Wh [NH1][H][own HC], Win [H][own DC]
__device__ void load_cols(unsigned char* st, const CLay& L, const WB& w, int k, int rank, int D,
                          int H, int NH1) {
  const int HC = L.HC, DC = L.DC;
  copy_rows(reinterpret_cast<bf16*>(st + L.c_ws), L.lhc, w.ws + (size_t)k * D * H + rank * HC, H,
            D, HC / 8);
  copy_rows(reinterpret_cast<bf16*>(st + L.c_wt), L.lhc, w.wt + (size_t)k * D * H + rank * HC, H,
            D, HC / 8);
  for (int j = 0; j < NH1; ++j)
    copy_rows(reinterpret_cast<bf16*>(st + L.c_wh) + (size_t)j * H * L.lhc, L.lhc,
              w.wh + ((size_t)k * NH1 + j) * H * H + rank * HC, H, H, HC / 8);
  copy_rows(reinterpret_cast<bf16*>(st + L.c_win), L.ldc, w.win + (size_t)k * H * D + rank * DC, D,
            H, DC / 8);
}

// Layer k's conditioner on the rounded state xr, the row stage rs holding
// the rank's rows of the layer: its columns of h_0 .. h_NH1 (bf16, after
// bias and relu) into every CTA's hs, a cluster sync after each; then its
// features of st_s and st_t (f32, bias added) into its own sts and stt.
// The forward, the inverse and the backward's recompute all call this.
// Synchronises the CTA before it returns.
__device__ void cond(const Cx& cx, const CLay& L, unsigned char* smem, const unsigned char* rs,
                     int D, int H, int NH1, int G) {
  const int warp = threadIdx.x >> 5, lane = lane_id(), g = lane >> 2, t = lane & 3;
  const bf16* xr = reinterpret_cast<const bf16*>(smem + L.xr);
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  const int MT = G / 16;
  for (int j = 0; j <= NH1; ++j) {
    const bf16* a = j == 0 ? xr : hs + (j - 1) * L.hstride;
    const int lda = j == 0 ? L.ldd : L.ldh;
    const bf16* w = j == 0 ? reinterpret_cast<const bf16*>(rs + L.r_win)
                           : reinterpret_cast<const bf16*>(rs + L.r_wh) + (j - 1) * cx.HC * L.ldh;
    const float* bias = j == 0 ? reinterpret_cast<const float*>(rs + L.r_bin)
                               : reinterpret_cast<const float*>(rs + L.r_bh) + (j - 1) * cx.HC;
    bf16* out = hs + j * L.hstride;
    for (int tt = warp; tt < MT * (cx.HC / 8); tt += WARPS) {
      const int m0 = 16 * (tt % MT), n0 = 8 * (tt / MT);
      float c[4];
      tile<false, false>(c, a, lda, m0, w, lda, n0, j == 0 ? D : H);
      const float b0 = bias[n0 + 2 * t], b1 = bias[n0 + 2 * t + 1];
      const int col = cx.rank * cx.HC + n0 + 2 * t;
      put2(cx, out, (m0 + g) * L.ldh + col, pack_bf16(relu_nan(c[0] + b0), relu_nan(c[1] + b1)));
      put2(cx, out, (m0 + g + 8) * L.ldh + col,
           pack_bf16(relu_nan(c[2] + b0), relu_nan(c[3] + b1)));
    }
    csync(cx);
  }
  const bf16* hl = hs + NH1 * L.hstride;
  const int nd = MT * (cx.DC / 8);
  for (int tt = warp; tt < 2 * nd; tt += WARPS) {
    const int q = tt / nd, m0 = 16 * (tt % nd % MT), n0 = 8 * (tt % nd / MT);
    const bf16* w = reinterpret_cast<const bf16*>(rs + (q ? L.r_wt : L.r_ws));
    const float* bias = reinterpret_cast<const float*>(rs + (q ? L.r_bt : L.r_bs));
    float* dst = reinterpret_cast<float*>(smem + (q ? L.stt : L.sts));
    float c[4];
    tile<false, false>(c, hl, L.ldh, m0, w, L.ldh, n0, H);
    const int col = n0 + 2 * t;
    const float b0 = bias[col], b1 = bias[col + 1];
    *reinterpret_cast<float2*>(dst + (m0 + g) * cx.DC + col) = make_float2(c[0] + b0, c[1] + b1);
    *reinterpret_cast<float2*>(dst + (m0 + g + 8) * cx.DC + col) = make_float2(c[2] + b0, c[3] + b1);
  }
  __syncthreads();
}

// forward (INV false: z -> u and the log-det) or inverse (eps -> z); blocks
// C g .. C g + C - 1 form the cluster of group g
template <bool INV>
__global__ void __launch_bounds__(THREADS, 1)
cluster_flow_kernel(const float* __restrict__ in, float* __restrict__ out, float* __restrict__ ld,
                    WB w, int B, int D, int H, int K, int NH1, float cap, int C, int G) {
  extern __shared__ __align__(128) unsigned char smem[];
  const CLay L(D, H, NH1, G, C, false);
  Cx cx;
  cx.C = C;
  cx.rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  cx.HC = L.HC;
  cx.DC = L.DC;
  const int tid = threadIdx.x, DC = cx.DC, f0 = cx.rank * DC;
  const int b0 = (int)(blockIdx.x / C) * G, rows = min(G, B - b0);
  bf16* xr = reinterpret_cast<bf16*>(smem + L.xr);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  float* sts = reinterpret_cast<float*>(smem + L.sts);
  const float* stt = reinterpret_cast<const float*>(smem + L.stt);
  float* lds = reinterpret_cast<float*>(smem + L.lds);
  unsigned char* stage[2] = {smem + L.rows0, smem + L.rows1};

  // the first two layers of the walk
  load_rows(stage[0], L, w, INV ? K - 1 : 0, cx.rank, D, H, NH1);
  cp_async_commit();
  if (K > 1) load_rows(stage[1], L, w, INV ? K - 2 : 1, cx.rank, D, H, NH1);
  cp_async_commit();
  for (int e = tid; e < G * D; e += THREADS) {
    const int m = e / D, d = e % D;
    const float v = m < rows ? in[(size_t)(b0 + m) * D + d] : 0.f;
    xr[m * L.ldd + d] = __float2bfloat16_rn(v);
    if (d >= f0 && d < f0 + DC) xs[m * DC + d - f0] = v;
  }
  if (tid < G) lds[tid] = 0.f;
  csync(cx);   // every CTA of the cluster runs before any writes into another

  for (int i = 0; i < K; ++i) {
    const unsigned char* rs = stage[i & 1];
    cp_async_wait<1>();   // layer i's stage (one group per layer, the next may be in flight)
    __syncthreads();
    cond(cx, L, smem, rs, D, H, NH1, G);
    const float* mk = reinterpret_cast<const float*>(rs + L.r_mask);
    for (int e = tid; e < G * DC / 2; e += THREADS) {
      const int m = e / (DC / 2), d = 2 * (e % (DC / 2));
      float x2[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int o = m * DC + d + q;
        float x = xs[o], s = 0.f;
        if (mk[d + q] <= 0.f) {
          s = cap * tanhf(sts[o] / cap);
          x = INV ? (x - stt[o]) * expf(-s) : x * expf(s) + stt[o];
        }
        xs[o] = x;
        sts[o] = s;
        x2[q] = x;
      }
      put2(cx, xr, m * L.ldd + f0 + d, pack_bf16(x2[0], x2[1]));
    }
    csync(cx);
    // the stage is free: layer i + 2 goes into it
    if (i + 2 < K) load_rows(stage[i & 1], L, w, INV ? K - 3 - i : i + 2, cx.rank, D, H, NH1);
    cp_async_commit();
    if (!INV && tid < G) {
      float s = 0.f;
      for (int d = 0; d < DC; ++d) s += sts[tid * DC + d];
      lds[tid] += s;
    }
  }
  for (int e = tid; e < rows * DC; e += THREADS)
    out[(size_t)(b0 + e / DC) * D + f0 + e % DC] = xs[e];
  if (!INV) {
    // the ranks' sums meet in rank 0 and are added in rank order
    float* slots = reinterpret_cast<float*>(smem + L.slots);
    if (tid < G) {
      float* p = slots + cx.rank * G + tid;
      if (C > 1) p = cg::this_cluster().map_shared_rank(p, 0);
      *p = lds[tid];
    }
    csync(cx);
    if (cx.rank == 0 && tid < rows) {
      float s = slots[tid];
      for (int r = 1; r < C; ++r) s += slots[r * G + tid];
      ld[b0 + tid] = s;
    }
  }
}

__device__ __forceinline__ void acc_store(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// The weight gradient of the NC rows of a weight that a rank owns, from
// row own0 on: dst[(own0 + n) * M + m] (+)= sum over the G samples s of
// A(s, m) B(s, own0 + n), with A and B stored [s][.] in shared memory
// (rows lda and ldb): the transposed product, samples as K. Warp w takes
// the tiles w - skew, w - skew + WARPS, ... (mod WARPS), so the warps that
// carry the exchange's tiles (0 .. skew - 1) come to these last.
__device__ void wgrad(const bf16* a, int lda, int M, const bf16* b, int ldb, int own0, int NC,
                      int G, float* dst, bool first, int skew) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int warp = ((int)(threadIdx.x >> 5) + WARPS - skew % WARPS) % WARPS;
  const int MT = M / 16;
  for (int tt = warp; tt < MT * (NC / 8); tt += WARPS) {
    const int m0 = 16 * (tt % MT), n0 = 8 * (tt / MT);
    float c[4];
    tile<true, true>(c, a, lda, m0, b, ldb, own0 + n0, G);
    float* p = dst + (size_t)(own0 + n0 + 2 * t) * M + m0 + g;
    acc_store(p, c[0], first);
    acc_store(p + M, c[1], first);
    acc_store(p + 8, c[2], first);
    acc_store(p + M + 8, c[3], first);
  }
}

// out[n] (+)= sum over the G rows of v[m * NC + n]: four running sums (rows
// m = 0, 1, 2, 3 mod 4, in order) added pairwise, a fixed order; the
// block's last NC threads
__device__ __forceinline__ void bias_grad(const float* v, int NC, int G, float* out, bool first) {
  for (int n = THREADS - 1 - (int)threadIdx.x; n < NC; n += THREADS) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll 4
    for (int m = 0; m < G; m += 4) {
      s0 += v[m * NC + n];
      s1 += v[(m + 1) * NC + n];
      s2 += v[(m + 2) * NC + n];
      s3 += v[(m + 3) * NC + n];
    }
    acc_store(out + n, (s0 + s1) + (s2 + s3), first);
  }
}

// (u, du, dld) -> dz and the weight gradients: into grad [K, per layer]
// directly (one cluster), or into cluster c's slice grad [c, K, per layer],
// cluster c walking the groups c, c + clusters, ... in order
__global__ void __launch_bounds__(THREADS, 1)
cluster_bwd_kernel(const float* __restrict__ u, const float* __restrict__ du,
                   const float* __restrict__ dld, float* __restrict__ dz, float* __restrict__ grad,
                   WB w, int B, int D, int H, int K, int NH1, float cap, int C, int G, int clusters) {
  extern __shared__ __align__(128) unsigned char smem[];
  const CLay L(D, H, NH1, G, C, true);
  Cx cx;
  cx.C = C;
  cx.rank = C > 1 ? (int)cg::this_cluster().block_rank() : 0;
  cx.HC = L.HC;
  cx.DC = L.DC;
  const int tid = threadIdx.x, warp = tid >> 5, lane = lane_id(), g = lane >> 2, t = lane & 3;
  const int HC = cx.HC, DC = cx.DC, f0 = cx.rank * DC, c0 = cx.rank * HC, MT = G / 16;
  const int slice = (int)blockIdx.x / C;
  const long long pl = per_layer(D, H, NH1);
  bf16* xr = reinterpret_cast<bf16*>(smem + L.xr);
  const bf16* hs = reinterpret_cast<const bf16*>(smem + L.hs);
  const bf16* hl = hs + NH1 * L.hstride;
  float* ys = reinterpret_cast<float*>(smem + L.xs);
  float* dss = reinterpret_cast<float*>(smem + L.sts);   // st_s, then ds_s
  float* dts = reinterpret_cast<float*>(smem + L.stt);   // st_t, then d_t
  float* gld = reinterpret_cast<float*>(smem + L.lds);
  float* dys = reinterpret_cast<float*>(smem + L.dys);
  bf16* dA = reinterpret_cast<bf16*>(smem + L.dA);
  bf16* dB = reinterpret_cast<bf16*>(smem + L.dB);
  bf16* dssr = dB;                      // rnd(ds_s), full
  bf16* dtr = dB + G * L.ldd;           // rnd(d_t), full
  unsigned char* rs = smem + L.rows0;
  const unsigned char* cs = smem + L.cols;

  csync(cx);   // every CTA of the cluster runs before any writes into another
  for (int grp = slice; grp * G < B; grp += clusters) {
    const bool first = grp == slice;
    const int b0 = grp * G, rows = min(G, B - b0);
    load_rows(rs, L, w, K - 1, cx.rank, D, H, NH1);
    load_cols(smem + L.cols, L, w, K - 1, cx.rank, D, H, NH1);
    cp_async_commit();
    for (int e = tid; e < G * D; e += THREADS) {
      const int m = e / D, d = e % D;
      const bool valid = m < rows;
      const float v = valid ? u[(size_t)(b0 + m) * D + d] : 0.f;
      xr[m * L.ldd + d] = __float2bfloat16_rn(v);
      if (d >= f0 && d < f0 + DC) {
        ys[m * DC + d - f0] = v;
        dys[m * DC + d - f0] = valid ? du[(size_t)(b0 + m) * D + d] : 0.f;
      }
    }
    if (tid < G) gld[tid] = tid < rows ? dld[b0 + tid] : 0.f;
    cp_async_wait<0>();
    __syncthreads();

    for (int k = K - 1; k >= 0; --k) {
      float* gwin = grad + ((size_t)slice * K + k) * pl;
      float* gbin = gwin + (size_t)H * D;
      float* gwh = gbin + H;
      float* gbh = gwh + (size_t)NH1 * H * H;
      float* gws = gbh + (size_t)NH1 * H;
      float* gbs = gws + (size_t)D * H;
      float* gwt = gbs + D;
      float* gbt = gwt + (size_t)D * H;

      // the forward conditioner, recomputed from the layer output
      cond(cx, L, smem, rs, D, H, NH1, G);

      // coupling cotangents of the own features; the layer input from the
      // closed-form inverse (ragged rows stay 0)
      const float* mk = reinterpret_cast<const float*>(rs + L.r_mask);
      for (int e = tid; e < G * DC / 2; e += THREADS) {
        const int m = e / (DC / 2), d = 2 * (e % (DC / 2));
        float xk2[2], ds2[2], dt2[2];
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int o = m * DC + d + q;
          const float yv = ys[o], dyv = dys[o];
          float xk = yv, ds_s = 0.f, d_t = 0.f, dy_n = dyv;
          if (mk[d + q] <= 0.f) {
            const float th = tanhf(dss[o] / cap), es = expf(cap * th);
            xk = (yv - dts[o]) / es;
            ds_s = (dyv * xk * es + gld[m]) * (1.f - th * th);
            d_t = dyv;
            dy_n = dyv * es;
          }
          if (m >= rows) xk = 0.f;
          ys[o] = xk;
          dys[o] = dy_n;
          dss[o] = ds_s;
          dts[o] = d_t;
          xk2[q] = xk;
          ds2[q] = ds_s;
          dt2[q] = d_t;
        }
        const int i = m * L.ldd + f0 + d;
        put2(cx, dssr, i, pack_bf16(ds2[0], ds2[1]));
        put2(cx, dtr, i, pack_bf16(dt2[0], dt2[1]));
        put2(cx, xr, i, pack_bf16(xk2[0], xk2[1]));
      }
      cp_async_wait<0>();   // this layer's columns
      csync(cx);
      // the row region is free: layer k - 1's rows load behind the cotangents
      if (k > 0) load_rows(rs, L, w, k - 1, cx.rank, D, H, NH1);
      cp_async_commit();

      // dh_last[:, own] = (rnd(ds_s) Ws + rnd(d_t) Wt)[:, own] * (h_last > 0)
      float* dhf = reinterpret_cast<float*>(smem + L.dhf0);
      float* dhn = reinterpret_cast<float*>(smem + L.dhf1);
      for (int tt = warp; tt < MT * (HC / 8); tt += WARPS) {
        const int m0 = 16 * (tt % MT), n0 = 8 * (tt / MT);
        float cs_[4], ct_[4];
        tile<false, true>(cs_, dssr, L.ldd, m0, reinterpret_cast<const bf16*>(cs + L.c_ws), L.lhc,
                          n0, D);
        tile<false, true>(ct_, dtr, L.ldd, m0, reinterpret_cast<const bf16*>(cs + L.c_wt), L.lhc,
                          n0, D);
        float v[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int m = m0 + g + (q >> 1) * 8, n = n0 + 2 * t + (q & 1);
          v[q] = (cs_[q] + ct_[q]) * (to_f(hl[m * L.ldh + c0 + n]) > 0.f ? 1.f : 0.f);
          dhf[m * HC + n] = v[q];
        }
        put2(cx, dA, (m0 + g) * L.ldh + c0 + n0 + 2 * t, pack_bf16(v[0], v[1]));
        put2(cx, dA, (m0 + g + 8) * L.ldh + c0 + n0 + 2 * t, pack_bf16(v[2], v[3]));
      }
      // dWs, dWt (+)= rnd(ds_s)^T rnd(h_last), rnd(d_t)^T rnd(h_last) of the
      // own rows; dbs, dbt
      const int nx = MT * (HC / 8);   // the exchange's tiles, on warps 0 .. nx - 1
      wgrad(hl, L.ldh, H, dssr, L.ldd, f0, DC, G, gws, first, nx);
      wgrad(hl, L.ldh, H, dtr, L.ldd, f0, DC, G, gwt, first, nx + (H / 16) * (DC / 8));
      bias_grad(dss, DC, G, gbs + f0, first);
      bias_grad(dts, DC, G, gbt + f0, first);
      csync(cx);

      // down the hidden layers: cur holds rnd(dh_{j+1}), full
      bf16* cur = dA;
      bf16* nxt = dB;
      for (int j = NH1 - 1; j >= 0; --j) {
        const bf16* hj = hs + j * L.hstride;
        // dh_j[:, own] = (rnd(dh) Wh[j])[:, own] * (h_j > 0)
        const bf16* whc = reinterpret_cast<const bf16*>(cs + L.c_wh) + (size_t)j * H * L.lhc;
        for (int tt = warp; tt < MT * (HC / 8); tt += WARPS) {
          const int m0 = 16 * (tt % MT), n0 = 8 * (tt / MT);
          float c[4];
          tile<false, true>(c, cur, L.ldh, m0, whc, L.lhc, n0, H);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const int m = m0 + g + (q >> 1) * 8, n = n0 + 2 * t + (q & 1);
            c[q] *= to_f(hj[m * L.ldh + c0 + n]) > 0.f ? 1.f : 0.f;
            dhn[m * HC + n] = c[q];
          }
          put2(cx, nxt, (m0 + g) * L.ldh + c0 + n0 + 2 * t, pack_bf16(c[0], c[1]));
          put2(cx, nxt, (m0 + g + 8) * L.ldh + c0 + n0 + 2 * t, pack_bf16(c[2], c[3]));
        }
        // dWh[j] (+)= rnd(dh)^T rnd(h_j) of the own rows; dbh[j]
        wgrad(hj, L.ldh, H, cur, L.ldh, c0, HC, G, gwh + (size_t)j * H * H, first, nx);
        bias_grad(dhf, HC, G, gbh + (size_t)j * H + c0, first);
        csync(cx);
        bf16* sw = cur;
        cur = nxt;
        nxt = sw;
        float* fw = dhf;
        dhf = dhn;
        dhn = fw;
      }
      // dy[:, own] of the layer input = dy es + (rnd(dh_0) Win)[:, own]
      const bf16* winc = reinterpret_cast<const bf16*>(cs + L.c_win);
      for (int tt = warp; tt < MT * (DC / 8); tt += WARPS) {
        const int m0 = 16 * (tt % MT), n0 = 8 * (tt / MT);
        float c[4];
        tile<false, true>(c, cur, L.ldh, m0, winc, L.ldc, n0, H);
#pragma unroll
        for (int q = 0; q < 4; ++q) dys[(m0 + g + (q >> 1) * 8) * DC + n0 + 2 * t + (q & 1)] += c[q];
      }
      // dWin (+)= rnd(dh_0)^T rnd(x_k) of the own rows; dbin
      wgrad(xr, L.ldd, D, cur, L.ldh, c0, HC, G, gwin, first, MT * (DC / 8));
      bias_grad(dhf, HC, G, gbin + c0, first);
      cp_async_wait<0>();   // layer k - 1's rows
      csync(cx);            // every CTA is done with this layer's buffers
      if (k > 0) load_cols(smem + L.cols, L, w, k - 1, cx.rank, D, H, NH1);
      cp_async_commit();
    }
    for (int e = tid; e < rows * DC; e += THREADS)
      dz[(size_t)(b0 + e / DC) * D + f0 + e % DC] = dys[e];
  }
}

template <typename Kern, typename... Args>
cudaError_t launch_cluster(Kern kern, int n_clusters, int C, int bytes, cudaStream_t stream,
                           Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  if (C > 8) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(n_clusters * C));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = C > 1 ? 1 : 0;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the shapes the split takes: D and H multiples of 16 up to 8 THREADS (a
// row copied in one pass), each rank owning a multiple of 8 of both, G a
// multiple of 16 up to THREADS
bool cluster_ok(int D, int H, int C, int G) {
  return C >= 1 && C <= 16 && D % 16 == 0 && H % 16 == 0 && D % (8 * C) == 0 &&
         H % (8 * C) == 0 && D <= 8 * THREADS && H <= 8 * THREADS && G >= 16 && G <= THREADS &&
         G % 16 == 0;
}

bool shapes_ok(int B, int D, int H, int K, int NH1) {
  return B > 0 && K > 0 && NH1 >= 0 && D > 0 && H > 0 && D % 16 == 0 && H % 16 == 0;
}

WB weights_bf16(const void* win, const float* bin, const void* wh, const float* bh,
                const void* ws, const float* bs, const void* wt, const float* bt,
                const float* masks) {
  return WB{static_cast<const bf16*>(win), bin, static_cast<const bf16*>(wh), bh,
            static_cast<const bf16*>(ws), bs, static_cast<const bf16*>(wt), bt, masks};
}

}  // namespace dpfx_latent

using namespace dpfx_latent;

extern "C" {

// samples per block of the f32 kernels (the wrappers size the f32
// backward's scratch from it)
int dpfx_fused_latent_tile_samples() { return TB; }

// dynamic shared memory of one block of the f32 kernels
int dpfx_fused_latent_smem_bytes(int D, int H, int NH1, int backward) {
  return Smem(D, H, NH1, backward).total;
}

// dynamic shared memory of one CTA of the bf16 cluster kernels
int dpfx_fused_latent_cluster_smem_bytes(int D, int H, int NH1, int G, int C, int backward) {
  return CLay(D, H, NH1, G, C, backward).total;
}

// z -> (u, log-det) (inverse 0) or eps -> z (inverse 1, ld unused); bf16 on
// clusters of C CTAs per group of G samples
int dpfx_fused_latent_flow(const float* in, float* out, float* ld, const void* win,
                           const float* bin, const void* wh, const float* bh, const void* ws,
                           const float* bs, const void* wt, const float* bt, const float* masks,
                           int B, int D, int H, int K, int NH1, float cap, int bf16, int inverse,
                           int C, int G, void* stream) {
  if (!shapes_ok(B, D, H, K, NH1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (!cluster_ok(D, H, C, G)) return (int)cudaErrorInvalidValue;
    const WB w = weights_bf16(win, bin, wh, bh, ws, bs, wt, bt, masks);
    const int bytes = CLay(D, H, NH1, G, C, false).total, n = (B + G - 1) / G;
    return (int)(inverse ? launch_cluster(cluster_flow_kernel<true>, n, C, bytes, s, in, out, ld, w,
                                          B, D, H, K, NH1, cap, C, G)
                         : launch_cluster(cluster_flow_kernel<false>, n, C, bytes, s, in, out, ld,
                                          w, B, D, H, K, NH1, cap, C, G));
  }
  const Weights w = weights(win, bin, wh, bh, ws, bs, wt, bt, masks);
  return (int)(inverse ? launch_flow<true>(in, out, ld, w, B, D, H, K, NH1, cap, s)
                       : launch_flow<false>(in, out, ld, w, B, D, H, K, NH1, cap, s));
}

// (u, du, dld) -> dz and the weight gradients dw [K, per layer]. f32:
// through per-block partials part [blocks, K, per layer]. bf16: `blocks`
// clusters of C CTAs, groups of G samples; with one cluster the kernel
// writes dw itself (part unused), with more each writes its slice of part
// and reduce_slices adds them in order.
int dpfx_fused_latent_bwd(const float* u, const float* du, const float* dld, float* dz,
                          float* part, float* dw, const void* win, const float* bin,
                          const void* wh, const float* bh, const void* ws, const float* bs,
                          const void* wt, const float* bt, const float* masks, int B, int D,
                          int H, int K, int NH1, float cap, int bf16, int blocks, int C, int G,
                          void* stream) {
  if (!shapes_ok(B, D, H, K, NH1) || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    if (!cluster_ok(D, H, C, G) || (blocks > 1 && !part)) return (int)cudaErrorInvalidValue;
    const WB w = weights_bf16(win, bin, wh, bh, ws, bs, wt, bt, masks);
    const int bytes = CLay(D, H, NH1, G, C, true).total;
    cudaError_t e = launch_cluster(cluster_bwd_kernel, blocks, C, bytes, s, u, du, dld, dz,
                                   blocks > 1 ? part : dw, w, B, D, H, K, NH1, cap, C, G, blocks);
    if (e != cudaSuccess || blocks == 1) return (int)e;
    return (int)launch_reduce(part, dw, 1, blocks, per_layer(D, H, NH1) * K, s);
  }
  return (int)launch_bwd(u, du, dld, dz, part, dw,
                         weights(win, bin, wh, bh, ws, bs, wt, bt, masks), B, D, H, K, NH1, cap,
                         blocks, s);
}

}  // extern "C"
