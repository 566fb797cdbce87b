// The point flow's backward on rows of 16 points per warp (mma.sync, bf16):
// the one copy of the training backward's body, run by fused_train.cu's
// bwd_kernel_mma (the model's 3 coordinates) and by bench_fused_bwd.cu's
// probe_rows_kernel (the decomposition probe's 8-row layout, its modes and
// its interleaved groups). Keeping one copy is what makes the probe's
// split (full - nowg, nowg - walk, walk) the split of the backward that
// training runs.
//
// Per layer k (last to first) and per tile of 128 points, each warp takes
// its 16 rows through: the conditioner recomputed from the layer output
// (first_rows, hidden_rows, out_rows of flow_rows.cuh, each level stored
// for the weight gradients), the layer input by the closed-form inverse
// and the coupling cotangents, the cotangent chain (cot_first,
// cot_hidden: dh_last = rnd(d(s, t)) Wout, dh_j = (rnd(dh_{j+1}) Wh_j) *
// (h_j > 0), the masks read from the stored levels), and dy_in = dyn +
// rnd(dh_0) Wx. Then the tile's weight gradients: dWh[j] += dh_{j+1}^T
// h_j, dWout^T += h_last^T rnd(d(s, t)), dWx += rnd(dh_0)^T rnd(x_k),
// points as the K dimension (operands through ldmatrix.trans), into
// register sums that last the layer's whole tile loop; this tile's dhz;
// the bias gradients are column sums of the unrounded f32 fragments. Each
// layer's sums go to the block's slice of a global scratch (one slice per
// block and layer), which reduce_slices adds in a fixed order: no float
// atomics, bit-identical from run to run. The grid is persistent (one
// block per SM), the layer loop outside the tile loop, each point's
// (y, dy) carried in global memory between layers; layer k-1's weights
// are staged with cp.async behind layer k where shared memory allows.
//
// Template parameters (the defaults are the training backward's):
//   R     coordinates per point: 3 (the model: Wx^T rows 3-7 and Wout
//         rows 6-7 zero, (s, t) in columns 0-5) or 8 (the probe: all 8
//         rows, the shift of row r in column (r + 3) % 8, the translation
//         cotangent of row (r + 5) % 8 added to column r). The products
//         are the same m16n8k8 / N = 8 instructions either way: the model
//         pads its operands to 8. With 8 rows the cotangents are loaded
//         after the recompute and the masks read once a layer: 8-row
//         arrays live through the recompute made ptxas spill there, and
//         the probe markedly slower than the training kernel on the same
//         zero-padded inputs.
//   MODE  BWD_FULL; BWD_NOWG leaves out what only the weight gradients
//         need (their products, the column sums, the dbout and dhz sums,
//         the cotangents' stores, the partial write-out and the two block
//         barriers per tile); BWD_WALK runs only the recompute (no stores)
//         and the inverse, and leaves x_0 in y.
//   ROLLED the layer loop under `#pragma unroll 1` (the default leaves it
//         as written).
//   S     groups: 1, or 2 and 4 interleaved. Group s is warps s*8/S ..
//         (s+1)*8/S - 1 with their rows of the shared tiles (a tile of
//         128/S points), its own tiles and its own named barrier (bar.sync
//         1 + s) in place of __syncthreads() inside a layer, so one group's
//         products can run under another's coupling math. Each group has
//         its own gradient slice (S per block, summed in order with the
//         blocks'); its warps cover the whole dWh, production's eight
//         warp blocks (32 x 64 at H = 128) dealt S to a warp, too many to
//         keep in registers through the layer: per tile each block's sums
//         are read from the group's slice in global memory, added to and
//         written back.
//
// Limits (Mma<H>::NH1_MAX): every activation and cotangent of a tile and
// one layer's weights sit in shared memory (MmaSmem).

#pragma once

#include "flow_rows.cuh"

// A named namespace only (see dpfx_common.cuh).
namespace dpfx {

enum { BWD_FULL = 0, BWD_NOWG = 1, BWD_WALK = 2 };

// columns of (s, t) for R coordinates: the model's 3 give 6, the probe's 8
template <int R>
__host__ __device__ constexpr int st_cols() {
  static_assert(R == 3 || R == 8, "the rows are built for 3 or 8 coordinates");
  return R == 3 ? 6 : 8;
}

// The shared-memory carve-up of the bf16 kernels (dpfx_fused_train_smem_bytes
// and bench_fused_bwd.py's smem_bytes report its size). A stage holds one
// layer's weights: Wh [n_hidden-1][H][LD], Wout [8][LD] and Wx^T [8][LD]
// (the rows past the layout's zero); two stages where they fit (the next
// layer's loads behind this layer's work), else one. bench_fused_bwd.py's
// smem_bytes mirrors the backward's layout: change both together.
struct MmaSmem {
  int hs, dhs, hstride, dstb, xkb, dhzw, stw, ldw, stage, stage_bytes, wout, wxt, nst, total;
  __host__ __device__ MmaSmem(int H, int NH1, bool backward) {
    const int ld = H + 8;
    hstride = round128(MT * ld * 2);
    wout = round128(NH1 * H * ld * 2);
    wxt = wout + round128(8 * ld * 2);
    stage_bytes = wxt + round128(8 * ld * 2);
    int o = 0;
    hs = dhs = dstb = xkb = dhzw = ldw = 0;
    if (backward) {
      hs = o;    o += (NH1 + 1) * hstride;      // h_0 .. h_last of the tile
      dhs = o;   o += (NH1 + 1) * hstride;      // their masked cotangents
      dstb = o;  o += round128(8 * (MT + 8) * 2);   // rnd(d(s, t)) [8][MT + 8]
      xkb = o;   o += round128(8 * (MT + 8) * 2);   // rnd(x_k) [8][MT + 8]
      dhzw = o;  o += round128(WARPS * H * 4);      // per-warp dhz sums of the tile
    } else {
      ldw = o;   o += 128;                      // per-warp log-det sums
    }
    stw = o;     o += WARPS * 16 * 8 * 4;       // per-warp [16][8] f32 exchange
    stage = o;
    nst = o + 2 * stage_bytes <= SMEM_MAX ? 2 : 1;
    total = o + nst * stage_bytes;
  }
};

// zero the padding rows that the products read: each stage's Wout rows
// NS-7 and Wx^T rows R-7, and (backward) the rows NS-7 of d(s, t), R-7 of x_k
template <int H, int R = 3>
__device__ void zero_pads(unsigned char* smem, const MmaSmem& L, bool backward) {
  constexpr int LD = Mma<H>::LD, NS = st_cols<R>();
  const bf16 z = __float2bfloat16_rn(0.f);
  for (int s = 0; s < L.nst; ++s) {
    bf16* swo = reinterpret_cast<bf16*>(smem + L.stage + s * L.stage_bytes + L.wout);
    bf16* swx = reinterpret_cast<bf16*>(smem + L.stage + s * L.stage_bytes + L.wxt);
    for (int e = threadIdx.x; e < (8 - NS) * LD; e += THREADS) swo[NS * LD + e] = z;
    for (int e = threadIdx.x; e < (8 - R) * LD; e += THREADS) swx[R * LD + e] = z;
  }
  if (backward) {
    bf16* db = reinterpret_cast<bf16*>(smem + L.dstb);
    bf16* xb = reinterpret_cast<bf16*>(smem + L.xkb);
    for (int e = threadIdx.x; e < (8 - NS) * (MT + 8); e += THREADS) db[NS * (MT + 8) + e] = z;
    for (int e = threadIdx.x; e < (8 - R) * (MT + 8); e += THREADS) xb[R * (MT + 8) + e] = z;
  }
}

// c * (h > 0) of C tile nt, h from the warp's rows of a shared tile: into the
// A fragments and (WG) the warp's rows of dstore (bf16); the column sums of
// the f32 values over the warp's 16 rows go to kept[nt / 8] in lanes
// g = nt % 8 (WG)
template <int H, bool WG = true>
__device__ __forceinline__ void epi_mask(Rows<H>& dh, int nt, const float (&c)[4],
                                         const bf16* hmask, bf16* dstore,
                                         float (&kept)[Mma<H>::KEEP][2]) {
  constexpr int LD = Mma<H>::LD;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3, col = 8 * nt + 2 * t;
  const float2 m0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(hmask + g * LD + col));
  const float2 m1 = unpack_bf16(*reinterpret_cast<const uint32_t*>(hmask + (g + 8) * LD + col));
  const float v0 = c[0] * (m0.x > 0.f ? 1.f : 0.f), v1 = c[1] * (m0.y > 0.f ? 1.f : 0.f);
  const float v2 = c[2] * (m1.x > 0.f ? 1.f : 0.f), v3 = c[3] * (m1.y > 0.f ? 1.f : 0.f);
  const uint32_t lo = pack_bf16(v0, v1), hi = pack_bf16(v2, v3);
  dh.a[nt >> 1][(nt & 1) * 2] = lo;
  dh.a[nt >> 1][(nt & 1) * 2 + 1] = hi;
  if constexpr (WG) {
    *reinterpret_cast<uint32_t*>(dstore + g * LD + col) = lo;
    *reinterpret_cast<uint32_t*>(dstore + (g + 8) * LD + col) = hi;
    float s0 = v0 + v2, s1 = v1 + v3;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (nt % 8 == g) {
      kept[nt / 8][0] = s0;
      kept[nt / 8][1] = s1;
    }
  }
}

// dh_last = (rnd(dst) Wout) * (h_last > 0): A = d(s, t) (k8), B = Wout [8][LD]
// read as rows k
template <int H, bool WG = true>
__device__ __forceinline__ void cot_first(Rows<H>& dh, uint32_t a0, uint32_t a1,
                                          const bf16* wout8, const bf16* hmask, bf16* dstore,
                                          float (&kept)[Mma<H>::KEEP][2]) {
  constexpr int LD = Mma<H>::LD;
  const int lane = lane_id();
#pragma unroll
  for (int q = 0; q < H / 32; ++q) {
    uint32_t b[4];
    ldsm_x4_t(b, wout8 + (lane & 7) * LD + 32 * q + (lane >> 3) * 8);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float c[4] = {0.f, 0.f, 0.f, 0.f};
      mma8(c, a0, a1, b[i]);
      epi_mask<H, WG>(dh, 4 * q + i, c, hmask, dstore, kept);
    }
  }
}

// dh_j = (rnd(dh_{j+1}) Wh_j) * (h_j > 0): B = Wh [out][in] read as rows k
template <int H, bool WG = true>
__device__ __forceinline__ void cot_hidden(Rows<H>& out, const Rows<H>& in, const bf16* w,
                                           const bf16* hmask, bf16* dstore,
                                           float (&kept)[Mma<H>::KEEP][2]) {
  constexpr int LD = Mma<H>::LD;
  const int lane = lane_id();
#pragma unroll
  for (int np = 0; np < H / 16; ++np) {
    float c0[4] = {0.f, 0.f, 0.f, 0.f}, c1[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int kc = 0; kc < H / 16; ++kc) {
      uint32_t b[4];
      ldsm_x4_t(b, w + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + 16 * np +
                       (lane >> 4) * 8);
      mma16(c0, in.a[kc], b[0], b[1]);
      mma16(c1, in.a[kc], b[2], b[3]);
    }
    epi_mask<H, WG>(out, 2 * np, c0, hmask, dstore, kept);
    epi_mask<H, WG>(out, 2 * np + 1, c1, hmask, dstore, kept);
  }
}

// a warp's block (mw, nw) of one dWh [H][H] in f32, as its C fragments:
// written (STORE) to or read from dwh (the interleaved groups' slices)
template <int H, bool STORE>
__device__ __forceinline__ void dwh_io(float (&acc)[Mma<H>::WM][Mma<H>::WN][4], float* dwh,
                                       int mw, int nw) {
  using M = Mma<H>;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mi = 0; mi < M::WM; ++mi)
#pragma unroll
    for (int ni = 0; ni < M::WN; ++ni) {
      const int o = (mw * M::WM + mi) * 16 + g, c = (nw * M::WN + ni) * 8 + 2 * t;
      float2* p0 = reinterpret_cast<float2*>(dwh + o * H + c);
      float2* p1 = reinterpret_cast<float2*>(dwh + (o + 8) * H + c);
      if constexpr (STORE) {
        *p0 = make_float2(acc[mi][ni][0], acc[mi][ni][1]);
        *p1 = make_float2(acc[mi][ni][2], acc[mi][ni][3]);
      } else {
        const float2 v0 = *p0, v1 = *p1;
        acc[mi][ni][0] = v0.x;
        acc[mi][ni][1] = v0.y;
        acc[mi][ni][2] = v1.x;
        acc[mi][ni][3] = v1.y;
      }
    }
}

// The backward (see the top of this file). y, dy [B, R, N] f32 (y: in, the
// flow's output; between layers each layer's output, out: x_0 in walk mode;
// dy: in, its cotangent; out: dx), dld [B], hz [B, K, H]; wx [K, H, R], wh
// [K, NH1, H, H], wout [K, NS, H] bf16; bh [K, NH1, H], bout [K, NS],
// masks [K, R] f32; part [gridDim.x * S, K, per_layer] and dhz_part [B,
// ceil(N / (128 / S)), K, H] f32 scratch (full mode). Points at or past
// n_valid (<= N) take no log-det cotangent.
template <int H, int R = 3, int MODE = BWD_FULL, bool ROLLED = false, int S = 1>
__device__ __forceinline__ void bwd_rows(float* __restrict__ y, float* __restrict__ dy,
                                         const float* __restrict__ dld, const float* __restrict__ hz,
                                         const bf16* __restrict__ wx, const bf16* __restrict__ wh,
                                         const float* __restrict__ bh,
                                         const bf16* __restrict__ wout,
                                         const float* __restrict__ bout,
                                         const float* __restrict__ masks, float* __restrict__ part,
                                         float* __restrict__ dhz_part, int B, int N, int n_valid,
                                         int K, int NH1, float cap) {
  using M = Mma<H>;
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int LD = M::LD, LDT = MT + 8, NS = st_cols<R>();
  constexpr bool WG = MODE == BWD_FULL, COT = MODE != BWD_WALK;
  constexpr int GW = WARPS / S, TP = MT / S;   // warps and points of a group's tile
  constexpr int MTW = (H / 16 + GW - 1) / GW;  // dWout^T and dWx m16 tiles per warp
  static_assert(S == 1 || ((S == 2 || S == 4) && MODE == BWD_FULL), "groups interleave full only");
  const MmaSmem L(H, NH1, true);
  const int hst = L.hstride / 2;   // elements between two levels' tiles
  bf16* hs = reinterpret_cast<bf16*>(smem + L.hs);
  bf16* dhs = reinterpret_cast<bf16*>(smem + L.dhs);
  bf16* dstb = reinterpret_cast<bf16*>(smem + L.dstb);   // [8][LDT] rnd(d(s, t)), points along
  bf16* xkb = reinterpret_cast<bf16*>(smem + L.xkb);     // [8][LDT] rnd(x_k)
  float* dhzw = reinterpret_cast<float*>(smem + L.dhzw); // [WARPS][H]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int p = lane & 15, r0 = warp * 16;
  const int s = S == 1 ? 0 : warp / GW, wg = S == 1 ? warp : warp % GW;
  const Group grp{S == 1 ? 0 : 1 + s, s * GW, GW};
  const int q0 = S == 1 ? 0 : s * TP;   // the group's first point in the shared tiles
  float* sw = reinterpret_cast<float*>(smem + L.stw) + warp * 128;
  auto stage = [&](int st) { return smem + L.stage + st * L.stage_bytes; };
  const int nt = (N + TP - 1) / TP, tiles = B * nt;
  const int per_layer = R * H + NH1 * H * H + NH1 * H + NS * H + NS;
  const int slice = blockIdx.x * S + s, slices = gridDim.x * S;
  const int mw = warp / M::GN, nw = warp % M::GN;

  zero_pads<H, R>(smem, L, true);
  WxRegs<H, R> wr;
  stage_load<H, MmaSmem, NS>(stage(0), L, wh, wout, K - 1, NH1);
  wr.load(wx, K - 1);
  wr.store(reinterpret_cast<bf16*>(stage(0) + L.wxt));

  // ROLLED puts `#pragma unroll 1` on the layer loop; a pragma of 0 is
  // ignored, which leaves the loop as written. The body is written out in
  // place, with no lambda and no helper that takes the register sums by
  // reference: through those, nvcc scheduled the training kernel otherwise
  // and it ran ~1.5% slower (PERF.md).
#pragma unroll (ROLLED ? 1 : 0)
  for (int i = 0; i < K; ++i) {
    const int k = K - 1 - i, st = L.nst == 2 ? (i & 1) : 0;
    if (L.nst == 1 && i > 0) {
      __syncthreads();   // every warp is done with the single stage
      stage_load<H, MmaSmem, NS>(stage(0), L, wh, wout, k, NH1);
      wr.load(wx, k);
      wr.store(reinterpret_cast<bf16*>(stage(0) + L.wxt));
    }
    cp_async_wait_all();
    __syncthreads();     // layer k's stage is visible; the previous layer's partials are out
    const bool ahead = L.nst == 2 && i + 1 < K;
    if (ahead) {
      stage_load<H, MmaSmem, NS>(stage(st ^ 1), L, wh, wout, k - 1, NH1);
      wr.load(wx, k - 1);
    }
    const bf16* swh = reinterpret_cast<const bf16*>(stage(st));
    const bf16* wo8 = reinterpret_cast<const bf16*>(stage(st) + L.wout);
    const bf16* wx8 = reinterpret_cast<const bf16*>(stage(st) + L.wxt);
    unsigned mbits = 0;   // (R = 8) the layer's pass-through rows
    if constexpr (R == 8) {
#pragma unroll
      for (int r = 0; r < 8; ++r) mbits |= masks[k * 8 + r] > 0.f ? 1u << r : 0u;
    }

    // the layer's gradient sums, held in registers through the tile loop
    // (dWh: one group only; with groups each tile adds to the slice)
    float acc[M::ACC][M::WM][M::WN][4], aout[MTW][4], ax[MTW][4];
    float run[M::ACC][M::KEEP][2], rbout[NS];
    if constexpr (WG) {
#pragma unroll
      for (int jj = 0; jj < M::ACC; ++jj)
#pragma unroll
        for (int mi = 0; mi < M::WM; ++mi)
#pragma unroll
          for (int ni = 0; ni < M::WN; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[jj][mi][ni][e] = 0.f;
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
        for (int e = 0; e < 4; ++e) aout[mi][e] = ax[mi][e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < M::ACC; ++jj)
#pragma unroll
        for (int e = 0; e < M::KEEP; ++e) run[jj][e][0] = run[jj][e][1] = 0.f;
#pragma unroll
      for (int r = 0; r < NS; ++r) rbout[r] = 0.f;
    }

    bool first = true;   // (groups) no tile of this layer has added to the slice yet
    for (int tile = slice; tile < tiles; tile += slices) {
      const int b = tile / nt, n = (tile % nt) * TP + wg * 16 + p;
      const bool valid = n < N;
      const size_t cloud = (size_t)b * R * N;
      float yv[R], dyv[R];
#pragma unroll
      for (int c = 0; c < R; ++c) {
        yv[c] = valid ? y[cloud + (size_t)c * N + n] : 0.f;
        if constexpr (COT && R == 3) dyv[c] = valid ? dy[cloud + (size_t)c * N + n] : 0.f;
      }

      // the forward conditioner on the warp's rows, recomputed from the
      // layer output, each level stored for the cotangent chain's masks and
      // the weight gradients
      uint32_t a0, a1;
      coord_frag(yv, a0, a1);
      Rows<H> h;
      first_rows<H>(h, a0, a1, wx8, hz + ((size_t)b * K + k) * H, COT ? hs + r0 * LD : nullptr);
      for (int j = 0; j < NH1; ++j) {
        Rows<H> o;
        hidden_rows<H>(o, h, swh + j * H * LD, bh + ((size_t)k * NH1 + j) * H,
                       COT ? hs + (j + 1) * hst + r0 * LD : nullptr);
        h = o;
      }
      float stv[4];
      out_rows<H, NS>(stv, h, wo8, bout + k * NS);
      if constexpr (COT && R == 8) {
        // 8 rows load their cotangent after the recompute, whose registers
        // are free by then
#pragma unroll
        for (int c = 0; c < R; ++c) dyv[c] = valid ? dy[cloud + (size_t)c * N + n] : 0.f;
      }
      st_exchange(sw, stv);

      // the layer input from the closed-form inverse; the coupling cotangents
      const float g_ld = COT && n < n_valid ? dld[b] : 0.f;
      float xk[R], d[NS], dyn[R];
      if constexpr (R == 3) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          if (masks[k * 3 + c] > 0.f) {
            xk[c] = yv[c];
            d[c] = d[3 + c] = 0.f;
            dyn[c] = dyv[c];
          } else {
            const float th = tanhf(sw[p * 8 + c] / cap), es = expf(cap * th);
            xk[c] = (yv[c] - sw[p * 8 + 3 + c]) / es;
            const float ds = dyv[c] * xk[c] * es + g_ld;
            d[c] = ds * (1.f - th * th);
            d[3 + c] = dyv[c];
            dyn[c] = dyv[c] * es;
          }
        }
      } else {
        // row r scales by column r and shifts by column (r + 3) % 8; column
        // r also takes row q = (r + 5) % 8's translation cotangent. Written
        // with selects, so on the model's rows padded to 8 (rows 3-7
        // passing through) each value is the R = 3 branch's.
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int q = (r + 5) & 7;
          const bool mr = (mbits >> r) & 1u, mq = (mbits >> q) & 1u;
          float a = 0.f;
          if (mr) {
            xk[r] = yv[r];
            if constexpr (COT) dyn[r] = dyv[r];
          } else {
            const float th = tanhf(sw[p * 8 + r] / cap), es = expf(cap * th);
            xk[r] = (yv[r] - sw[p * 8 + ((r + 3) & 7)]) / es;
            if constexpr (COT) {
              const float ds = dyv[r] * xk[r] * es + g_ld;
              a = ds * (1.f - th * th);
              dyn[r] = dyv[r] * es;
            }
          }
          if constexpr (COT) d[r] = mq ? a : mr ? dyv[q] : a + dyv[q];
        }
      }
      if constexpr (!COT) {
        if (lane < 16 && valid)
#pragma unroll
          for (int c = 0; c < R; ++c) y[cloud + (size_t)c * N + n] = xk[c];
        __syncwarp();   // the next tile's exchange reuses sw
      } else {
        __syncwarp();
        if (lane < 16) {
#pragma unroll
          for (int r = 0; r < NS; ++r) {
            sw[p * 8 + r] = d[r];
            if constexpr (WG) dstb[r * LDT + r0 + p] = __float2bfloat16_rn(d[r]);
          }
#pragma unroll
          for (int r = NS; r < 8; ++r) sw[p * 8 + r] = 0.f;
          if constexpr (WG) {
#pragma unroll
            for (int c = 0; c < R; ++c) xkb[c * LDT + r0 + p] = __float2bfloat16_rn(xk[c]);
          }
        }
        __syncwarp();
        const float2 dg = *reinterpret_cast<const float2*>(sw + g * 8 + 2 * t);
        const float2 dg8 = *reinterpret_cast<const float2*>(sw + (g + 8) * 8 + 2 * t);
        a0 = pack_bf16(dg.x, dg.y);
        a1 = pack_bf16(dg8.x, dg8.y);
        if constexpr (WG) {
#pragma unroll
          for (int r = 0; r < NS; ++r) {   // dbout over the warp's points
            float v = d[r];
#pragma unroll
            for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            rbout[r] += v;
          }
        }

        // the cotangent chain on the same rows
        float kept[M::KEEP][2] = {};
        auto keep = [&](int level) {   // level j + 1 > 0: dbh of hidden layer j; 0: the tile's dhz
          if (level > 0) {
#pragma unroll
            for (int jj = 0; jj < M::ACC; ++jj)
              if (jj == level - 1)
#pragma unroll
                for (int e = 0; e < M::KEEP; ++e) {
                  run[jj][e][0] += kept[e][0];
                  run[jj][e][1] += kept[e][1];
                }
          } else {
#pragma unroll
            for (int e = 0; e < M::KEEP; ++e) {
              const int ntl = g + 8 * e;
              if (ntl < H / 8)
                *reinterpret_cast<float2*>(dhzw + warp * H + 8 * ntl + 2 * t) =
                    make_float2(kept[e][0], kept[e][1]);
            }
          }
        };
        Rows<H> dh;
        cot_first<H, WG>(dh, a0, a1, wo8, hs + NH1 * hst + r0 * LD, dhs + NH1 * hst + r0 * LD,
                         kept);
        if constexpr (WG) keep(NH1);
        for (int j = NH1 - 1; j >= 0; --j) {
          Rows<H> o;
          cot_hidden<H, WG>(o, dh, swh + j * H * LD, hs + j * hst + r0 * LD,
                            dhs + j * hst + r0 * LD, kept);
          if constexpr (WG) keep(j);
          dh = o;
        }
        // dy_in = where(mask, dy, dy * es) + rnd(dh_0) Wx: B = Wx^T [8][LD] (rows n)
        float dc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < H / 32; ++kk) {
          uint32_t bq[4];
          ldsm_x4(bq, wx8 + (lane & 7) * LD + 32 * kk + (lane >> 3) * 8);
          mma16(dc, dh.a[2 * kk], bq[0], bq[1]);
          mma16(dc, dh.a[2 * kk + 1], bq[2], bq[3]);
        }
        __syncwarp();   // the d(s, t) reads above are done
        *reinterpret_cast<float2*>(sw + g * 8 + 2 * t) = make_float2(dc[0], dc[1]);
        *reinterpret_cast<float2*>(sw + (g + 8) * 8 + 2 * t) = make_float2(dc[2], dc[3]);
        __syncwarp();
        if (lane < 16 && valid)
#pragma unroll
          for (int c = 0; c < R; ++c) {
            dy[cloud + (size_t)c * N + n] = dyn[c] + sw[p * 8 + c];
            y[cloud + (size_t)c * N + n] = xk[c];
          }
        if constexpr (!WG) {
          __syncwarp();   // the next tile's exchange reuses sw
        } else {
          grp.sync();   // every warp's rows of the (group's) tile are in the shared tiles

          // weight gradients over the group's points: dWh[j] += dh_{j+1}^T h_j.
          // One group: the warp's block (mw, nw) of each dWh, summed in
          // registers. S groups: production's eight blocks dealt S to each of
          // the group's warps, each read from the group's slice, added to and
          // written back.
#pragma unroll (S == 1 ? 0 : 1)
          for (int qb = 0; qb < S; ++qb) {
            const int bw = S == 1 ? warp : wg + GW * qb, bm = bw / M::GN, bn = bw % M::GN;
#pragma unroll
            for (int jj = 0; jj < M::ACC; ++jj) {
              if (jj >= NH1) break;
              const int ja = S == 1 ? jj : 0;   // the register sums the block adds to
              float* dwh = part + ((size_t)slice * K + k) * per_layer + R * H + jj * H * H;
              if constexpr (S > 1) {
                if (first) {
#pragma unroll
                  for (int mi = 0; mi < M::WM; ++mi)
#pragma unroll
                    for (int ni = 0; ni < M::WN; ++ni)
#pragma unroll
                      for (int e = 0; e < 4; ++e) acc[0][mi][ni][e] = 0.f;
                } else {
                  dwh_io<H, false>(acc[0], dwh, bm, bn);
                }
              }
              const bf16* A = dhs + (jj + 1) * hst + q0 * LD;
              const bf16* Bm = hs + jj * hst + q0 * LD;
#pragma unroll
              for (int kk = 0; kk < TP / 16; ++kk) {
                uint32_t a[M::WM][4];
#pragma unroll
                for (int mi = 0; mi < M::WM; ++mi)
                  ldsm_x4_t(a[mi], A + (16 * kk + (lane & 7) + ((lane >> 4) & 1) * 8) * LD +
                                       (bm * M::WM + mi) * 16 + ((lane >> 3) & 1) * 8);
                if constexpr (M::WN % 2 == 0) {
#pragma unroll
                  for (int ni = 0; ni < M::WN; ni += 2) {
                    uint32_t bq[4];
                    ldsm_x4_t(bq, Bm + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                      (bn * M::WN + ni) * 8 + (lane >> 4) * 8);
#pragma unroll
                    for (int mi = 0; mi < M::WM; ++mi) {
                      mma16(acc[ja][mi][ni], a[mi], bq[0], bq[1]);
                      mma16(acc[ja][mi][ni + 1], a[mi], bq[2], bq[3]);
                    }
                  }
                } else {
#pragma unroll
                  for (int ni = 0; ni < M::WN; ++ni) {
                    uint32_t bq[2];
                    ldsm_x2_t(bq, Bm + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                                      (bn * M::WN + ni) * 8);
#pragma unroll
                    for (int mi = 0; mi < M::WM; ++mi) mma16(acc[ja][mi][ni], a[mi], bq[0], bq[1]);
                  }
                }
              }
              if constexpr (S > 1) dwh_io<H, true>(acc[0], dwh, bm, bn);
            }
          }
          first = false;
          // dWout^T += h_last^T rnd(d(s, t)), dWx += rnd(dh_0)^T rnd(x_k)
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi) {
            const int mt = wg + GW * mi;
            if (mt >= H / 16) break;
#pragma unroll
            for (int kq = 0; kq < TP / 32; ++kq) {
              uint32_t bd[4], bx[4];
              ldsm_x4(bd, dstb + (lane & 7) * LDT + q0 + 32 * kq + (lane >> 3) * 8);
              ldsm_x4(bx, xkb + (lane & 7) * LDT + q0 + 32 * kq + (lane >> 3) * 8);
#pragma unroll
              for (int hf = 0; hf < 2; ++hf) {
                const int row = q0 + 16 * (2 * kq + hf) + (lane & 7) + ((lane >> 4) & 1) * 8;
                const int col = 16 * mt + ((lane >> 3) & 1) * 8;
                uint32_t a[4];
                ldsm_x4_t(a, hs + NH1 * hst + row * LD + col);
                mma16(aout[mi], a, bd[2 * hf], bd[2 * hf + 1]);
                ldsm_x4_t(a, dhs + row * LD + col);
                mma16(ax[mi], a, bx[2 * hf], bx[2 * hf + 1]);
              }
            }
          }
          // this tile's dhz: the group's warps' sums in order
          for (int e = grp.tid(); e < H; e += grp.size()) {
            float a = 0.f;
            for (int w = 0; w < GW; ++w) a += dhzw[(s * GW + w) * H + e];
            dhz_part[((size_t)tile * K + k) * H + e] = a;
          }
          grp.sync();   // the next tile reuses the shared tiles
        }
      }
    }
    if (ahead) wr.store(reinterpret_cast<bf16*>(stage(st ^ 1) + L.wxt));
    if constexpr (WG) {
      // this slice's partial of layer k: [dWx | dWh | dbh | dWout | dbout]
      float* out = part + ((size_t)slice * K + k) * per_layer;
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        const int mt = wg + GW * mi;
        if (mt >= H / 16) break;
        const int o = 16 * mt + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * t + e;
          if (c < R) {
            out[o * R + c] = ax[mi][e];
            out[(o + 8) * R + c] = ax[mi][2 + e];
          }
          if (c < NS) {
            float* dwo = out + R * H + NH1 * H * H + NH1 * H;
            dwo[c * H + o] = aout[mi][e];
            dwo[c * H + o + 8] = aout[mi][2 + e];
          }
        }
      }
      if constexpr (S == 1) {
#pragma unroll
        for (int jj = 0; jj < M::ACC; ++jj) {
          if (jj >= NH1) break;
          float* dwh = out + R * H + jj * H * H;
#pragma unroll
          for (int mi = 0; mi < M::WM; ++mi)
#pragma unroll
            for (int ni = 0; ni < M::WN; ++ni) {
              const int o = (mw * M::WM + mi) * 16 + g, c = (nw * M::WN + ni) * 8 + 2 * t;
              *reinterpret_cast<float2*>(dwh + o * H + c) =
                  make_float2(acc[jj][mi][ni][0], acc[jj][mi][ni][1]);
              *reinterpret_cast<float2*>(dwh + (o + 8) * H + c) =
                  make_float2(acc[jj][mi][ni][2], acc[jj][mi][ni][3]);
            }
        }
      } else if (first) {   // a group without a tile in this layer: its dWh is zero
#pragma unroll
        for (int mi = 0; mi < M::WM; ++mi)
#pragma unroll
          for (int ni = 0; ni < M::WN; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[0][mi][ni][e] = 0.f;
        for (int qb = 0; qb < S; ++qb)
          for (int jj = 0; jj < NH1; ++jj)
            dwh_io<H, true>(acc[0], out + R * H + jj * H * H, (wg + GW * qb) / M::GN,
                            (wg + GW * qb) % M::GN);
      }
      // dbh and dbout: the group's warps' sums in order, through the (now
      // free) h tiles
      if constexpr (S > 1) __syncthreads();   // every group is done with the h tiles
      float* red = reinterpret_cast<float*>(hs);
      const int rs = NH1 * H + 8;
#pragma unroll
      for (int jj = 0; jj < M::ACC; ++jj) {
        if (jj >= NH1) break;
#pragma unroll
        for (int e = 0; e < M::KEEP; ++e) {
          const int ntl = g + 8 * e;
          if (ntl < H / 8)
            *reinterpret_cast<float2*>(red + warp * rs + jj * H + 8 * ntl + 2 * t) =
                make_float2(run[jj][e][0], run[jj][e][1]);
        }
      }
      if (lane == 0)
#pragma unroll
        for (int r = 0; r < NS; ++r) red[warp * rs + NH1 * H + r] = rbout[r];
      __syncthreads();
      for (int e = grp.tid(); e < NH1 * H + NS; e += grp.size()) {
        float a = 0.f;
        for (int w = 0; w < GW; ++w) a += red[(s * GW + w) * rs + e];
        if (e < NH1 * H) out[R * H + NH1 * H * H + e] = a;
        else out[R * H + NH1 * H * H + NH1 * H + NS * H + (e - NH1 * H)] = a;
      }
    }
  }
}

// Sums the slices of a bwd_rows launch of `blocks` blocks: dw [K, per_layer]
// and dhz [B, K, H] (full mode)
template <int H, int R = 3, int S = 1>
cudaError_t bwd_rows_reduce(const float* part, const float* dhz_part, float* dw, float* dhz,
                            int B, int N, int K, int NH1, int blocks, cudaStream_t stream) {
  constexpr int NS = st_cols<R>();
  const int nt = (N + MT / S - 1) / (MT / S);
  const long long per_layer =
      (long long)R * H + (long long)NH1 * H * H + (long long)NH1 * H + NS * H + NS;
  cudaError_t e = launch_reduce(part, dw, 1, blocks * S, per_layer * K, stream);
  if (e != cudaSuccess) return e;
  return launch_reduce(dhz_part, dhz, B, nt, (long long)K * H, stream);
}

}  // namespace dpfx
