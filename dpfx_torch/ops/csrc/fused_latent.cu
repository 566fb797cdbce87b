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
// time and 1.4 us of HBM time at 3.35 TB/s, so the bound is the bytes of
// the weights. The backward adds 9.2 MB of f32 weight gradients (~4.1 us).
//
// Design. Layout is feature-last: a sample is a row of D floats, and a
// block owns a tile of TB = 16 samples (one WMMA row tile), keeps the
// tile's state and every activation in shared memory and walks all K
// layers itself. The Pallas kernels keep all K layers' weights resident in
// VMEM; one layer's bf16 weights are 320 KB here, more than a block's
// 227 KB, so every product reads its weight operand straight from global
// memory, 16 x 16 WMMA fragments at a time: the 4.6 MB stack stays in the
// 50 MB L2 and each fragment is used by the one warp that needs it. bf16
// products run on the tensor cores through WMMA (bf16 operands, f32
// accumulation); f32 mode runs them as register-tiled IEEE f32 FMA
// (dpfx_common.cuh's gemm), so the f32 check is not blurred by TF32.
// Rounding as the Pallas kernels: operands in the compute dtype, f32 sums,
// bias and relu in f32, one cast; coupling, tanh cap and log-det in f32.
//
// Backward (`bwd_kernel`), one reverse walk as in the Pallas kernel:
//   * No stored chain: each layer's input is rebuilt from its output by the
//     closed-form inverse, and the conditioner recomputed from the output
//     (its passthrough rows equal the input's; the mask is folded into Win).
//   * The weight gradients sum over every sample. The Pallas grid runs in
//     order and adds into one output; here each block writes its own slice
//     of a global scratch (WMMA accumulators straight into it, gemm_acc),
//     walking its tiles in order when there are more tiles than blocks, and
//     `reduce_slices` sums the slices in a fixed order. No float atomics:
//     the gradients are bit-identical from run to run.
//   * Cotangents are cast to the compute dtype before each product; bias
//     gradients sum the f32 values. Ragged samples carry zero cotangent and
//     no log-det gradient.
//
// At B=64 the grid has 4 blocks on 132 SMs; splitting H across a cluster
// is later work.
//
// Plain C interface, loaded with ctypes (dpfx_torch/ops/_build.py). Each
// launch returns cudaGetLastError().

#include "dpfx_common.cuh"

// A named namespace: `Weights` is a kernel argument, and nvcc's host stubs
// break on an argument type in an anonymous namespace.
namespace dpfx_latent {

using namespace dpfx;

constexpr int TB = 16;   // samples per block: one WMMA row tile

// the stacked weights of all K layers: matrices in the compute dtype S,
// biases and masks in f32
template <typename S>
struct Weights {
  const S* win;         // [K, H, D], mask folded
  const float* bin;     // [K, H]
  const S* wh;          // [K, NH1, H, H]
  const float* bh;      // [K, NH1, H]
  const S* ws;          // [K, D, H]
  const float* bs;      // [K, D]
  const S* wt;          // [K, D, H]
  const float* bt;      // [K, D]
  const float* masks;   // [K, D], 1 = passthrough
};

// floats of one layer's gradients: [Win | bin | Wh | bh | Ws | bs | Wt | bt]
__host__ __device__ inline long long per_layer(int D, int H, int NH1) {
  return (long long)H * D + H + (long long)NH1 * H * H + (long long)NH1 * H + 2LL * (D * H + D);
}

// shared-memory carve-up (dpfx_fused_latent_smem_bytes reports its size)
template <typename S>
struct Smem {
  int ldd, ldh, hstride;                  // row strides and hidden-tile stride, in elements
  int xs, xr, hs, sts, stt, stage, lds;   // every kernel
  int dys, dyn, dssr, dtr, dhf, dhr;      // backward only
  int total;
  __host__ __device__ Smem(int D, int H, int NH1, bool bwd) {
    ldd = D + Layout<S>::PAD;
    ldh = H + Layout<S>::PAD;
    const int hbytes = round128(TB * ldh * (int)sizeof(S));
    hstride = hbytes / (int)sizeof(S);
    int o = 0;
    xs = o;    o += round128(TB * D * 4);                    // the state (y in the backward)
    xr = o;    o += round128(TB * ldd * (int)sizeof(S));     // it rounded: the conditioner's input
    hs = o;    o += (NH1 + 1) * hbytes;                      // h_0 .. h_NH1, compute dtype
    sts = o;   o += round128(TB * D * 4);                    // st_s (backward: ds_s)
    stt = o;   o += round128(TB * D * 4);                    // st_t (backward: d_t)
    stage = o; o += round128(WARPS * 256 * 4);
    lds = o;   o += round128(TB * 4);                        // log-det (backward: its cotangent)
    dys = dyn = dssr = dtr = dhf = dhr = o;
    if (bwd) {
      dys = o;  o += round128(TB * D * 4);                   // cotangent of the layer output
      dyn = o;  o += round128(TB * D * 4);                   // where(mask, dy, dy * es)
      dssr = o; o += round128(TB * ldd * (int)sizeof(S));    // ds_s rounded
      dtr = o;  o += round128(TB * ldd * (int)sizeof(S));    // d_t rounded
      dhf = o;  o += round128(TB * H * 4);                   // hidden cotangent, f32
      dhr = o;  o += round128(TB * ldh * (int)sizeof(S));    // it rounded
    }
    total = o;
  }
};

// The conditioner of layer k on the tile's rounded input xr: h_0 .. h_NH1
// into hs + j * hstride (compute dtype, after relu), then st_s and st_t
// (f32, bias added) into sts and stt. Synchronises before it returns.
template <typename S>
__device__ void cond_st(const Weights<S>& w, int k, int D, int H, int NH1, const Smem<S>& L,
                        unsigned char* smem) {
  const S* xr = reinterpret_cast<const S*>(smem + L.xr);
  S* hs = reinterpret_cast<S*>(smem + L.hs);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* sts = reinterpret_cast<float*>(smem + L.sts);
  float* stt = reinterpret_cast<float*>(smem + L.stt);
  const int ldd = L.ldd, ldh = L.ldh;
  const float* bin = w.bin + (size_t)k * H;
  gemm<false, true>(TB, H, D, xr, ldd, w.win + (size_t)k * H * D, D, stage, nullptr,
                    [&](int m, int n, float v) {
                      hs[m * ldh + n] = from_f<S>(relu_nan(v + bin[n]));
                      return 0.f;
                    });
  for (int j = 0; j < NH1; ++j) {
    __syncthreads();
    const S* hin = hs + j * L.hstride;
    S* hout = hs + (j + 1) * L.hstride;
    const float* bj = w.bh + ((size_t)k * NH1 + j) * H;
    gemm<false, true>(TB, H, H, hin, ldh, w.wh + ((size_t)k * NH1 + j) * H * H, H, stage, nullptr,
                      [&](int m, int n, float v) {
                        hout[m * ldh + n] = from_f<S>(relu_nan(v + bj[n]));
                        return 0.f;
                      });
  }
  __syncthreads();
  const S* hl = hs + NH1 * L.hstride;
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
template <typename S, bool INV>
__global__ void __launch_bounds__(THREADS)
flow_kernel(const float* __restrict__ in, float* __restrict__ out, float* __restrict__ ld,
            Weights<S> w, int B, int D, int H, int K, int NH1, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<S> L(D, H, NH1, false);
  float* xs = reinterpret_cast<float*>(smem + L.xs);
  S* xr = reinterpret_cast<S*>(smem + L.xr);
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
    for (int e = tid; e < TB * D; e += THREADS) xr[(e / D) * L.ldd + e % D] = from_f<S>(xs[e]);
    __syncthreads();
    cond_st<S>(w, k, D, H, NH1, L, smem);
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

template <typename S>
__global__ void __launch_bounds__(THREADS)
bwd_kernel(const float* __restrict__ u, const float* __restrict__ du,
           const float* __restrict__ dld, float* __restrict__ dz, float* __restrict__ part,
           Weights<S> w, int B, int D, int H, int K, int NH1, float cap) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Smem<S> L(D, H, NH1, true);
  const int ldd = L.ldd, ldh = L.ldh;
  float* ys = reinterpret_cast<float*>(smem + L.xs);
  S* xr = reinterpret_cast<S*>(smem + L.xr);
  const S* hs = reinterpret_cast<const S*>(smem + L.hs);
  float* stage = reinterpret_cast<float*>(smem + L.stage);
  float* dss = reinterpret_cast<float*>(smem + L.sts);   // st_s, then ds_s
  float* dts = reinterpret_cast<float*>(smem + L.stt);   // st_t, then d_t
  float* gld = reinterpret_cast<float*>(smem + L.lds);
  float* dys = reinterpret_cast<float*>(smem + L.dys);
  float* dyn = reinterpret_cast<float*>(smem + L.dyn);
  S* dssr = reinterpret_cast<S*>(smem + L.dssr);
  S* dtr = reinterpret_cast<S*>(smem + L.dtr);
  float* dhf = reinterpret_cast<float*>(smem + L.dhf);
  S* dhr = reinterpret_cast<S*>(smem + L.dhr);
  const int tid = threadIdx.x;
  const long long pl = per_layer(D, H, NH1);
  const S* hl = hs + NH1 * L.hstride;

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
      for (int e = tid; e < TB * D; e += THREADS) xr[(e / D) * ldd + e % D] = from_f<S>(ys[e]);
      __syncthreads();
      // the forward conditioner, recomputed from the layer output
      cond_st<S>(w, k, D, H, NH1, L, smem);

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
        xr[m * ldd + d] = from_f<S>(xk);
        dss[e] = ds_s;
        dts[e] = d_t;
        dssr[m * ldd + d] = from_f<S>(ds_s);
        dtr[m * ldd + d] = from_f<S>(d_t);
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
                           dhr[m * ldh + n] = from_f<S>(g);
                           return 0.f;
                         });
      for (int j = NH1 - 1; j >= 0; --j) {
        const S* hj = hs + j * L.hstride;
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
        for (int e = tid; e < TB * H; e += THREADS) dhr[(e / H) * ldh + e % H] = from_f<S>(dhf[e]);
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

template <typename S>
Weights<S> weights(const void* win, const float* bin, const void* wh, const float* bh,
                   const void* ws, const float* bs, const void* wt, const float* bt,
                   const float* masks) {
  return Weights<S>{static_cast<const S*>(win), bin, static_cast<const S*>(wh), bh,
                    static_cast<const S*>(ws), bs, static_cast<const S*>(wt), bt, masks};
}

template <typename S, bool INV>
cudaError_t launch_flow(const float* in, float* out, float* ld, const Weights<S>& w, int B, int D,
                        int H, int K, int NH1, float cap, cudaStream_t stream) {
  const int bytes = Smem<S>(D, H, NH1, false).total;
  cudaError_t e = cudaFuncSetAttribute(flow_kernel<S, INV>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  flow_kernel<S, INV><<<(B + TB - 1) / TB, THREADS, bytes, stream>>>(in, out, ld, w, B, D, H, K,
                                                                      NH1, cap);
  return cudaGetLastError();
}

template <typename S>
cudaError_t launch_bwd(const float* u, const float* du, const float* dld, float* dz, float* part,
                       float* dw, const Weights<S>& w, int B, int D, int H, int K, int NH1,
                       float cap, int blocks, cudaStream_t stream) {
  const int bytes = Smem<S>(D, H, NH1, true).total;
  cudaError_t e = cudaFuncSetAttribute(bwd_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       bytes);
  if (e != cudaSuccess) return e;
  bwd_kernel<S><<<blocks, THREADS, bytes, stream>>>(u, du, dld, dz, part, w, B, D, H, K, NH1, cap);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  return launch_reduce(part, dw, 1, blocks, per_layer(D, H, NH1) * K, stream);
}

bool shapes_ok(int B, int D, int H, int K, int NH1) {
  return B > 0 && K > 0 && NH1 >= 0 && D > 0 && H > 0 && D % 16 == 0 && H % 16 == 0;
}

}  // namespace dpfx_latent

using namespace dpfx_latent;

extern "C" {

// samples per block (the wrappers size the backward's scratch from it)
int dpfx_fused_latent_tile_samples() { return TB; }

int dpfx_fused_latent_smem_bytes(int D, int H, int NH1, int bf16, int backward) {
  return bf16 ? Smem<__nv_bfloat16>(D, H, NH1, backward).total
              : Smem<float>(D, H, NH1, backward).total;
}

// z -> (u, log-det) (inverse 0) or eps -> z (inverse 1, ld unused)
int dpfx_fused_latent_flow(const float* in, float* out, float* ld, const void* win,
                           const float* bin, const void* wh, const float* bh, const void* ws,
                           const float* bs, const void* wt, const float* bt, const float* masks,
                           int B, int D, int H, int K, int NH1, float cap, int bf16, int inverse,
                           void* stream) {
  if (!shapes_ok(B, D, H, K, NH1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    const auto w = weights<__nv_bfloat16>(win, bin, wh, bh, ws, bs, wt, bt, masks);
    return (int)(inverse ? launch_flow<__nv_bfloat16, true>(in, out, ld, w, B, D, H, K, NH1, cap, s)
                         : launch_flow<__nv_bfloat16, false>(in, out, ld, w, B, D, H, K, NH1, cap, s));
  }
  const auto w = weights<float>(win, bin, wh, bh, ws, bs, wt, bt, masks);
  return (int)(inverse ? launch_flow<float, true>(in, out, ld, w, B, D, H, K, NH1, cap, s)
                       : launch_flow<float, false>(in, out, ld, w, B, D, H, K, NH1, cap, s));
}

// (u, du, dld) -> dz and the weight gradients dw [K, per layer], through
// per-block partials part [blocks, K, per layer]
int dpfx_fused_latent_bwd(const float* u, const float* du, const float* dld, float* dz,
                          float* part, float* dw, const void* win, const float* bin,
                          const void* wh, const float* bh, const void* ws, const float* bs,
                          const void* wt, const float* bt, const float* masks, int B, int D,
                          int H, int K, int NH1, float cap, int bf16, int blocks, void* stream) {
  if (!shapes_ok(B, D, H, K, NH1) || blocks <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16)
    return (int)launch_bwd<__nv_bfloat16>(u, du, dld, dz, part, dw,
                                          weights<__nv_bfloat16>(win, bin, wh, bh, ws, bs, wt, bt, masks),
                                          B, D, H, K, NH1, cap, blocks, s);
  return (int)launch_bwd<float>(u, du, dld, dz, part, dw,
                                weights<float>(win, bin, wh, bh, ws, bs, wt, bt, masks), B, D, H,
                                K, NH1, cap, blocks, s);
}

}  // extern "C"
