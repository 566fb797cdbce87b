// The point flow's training forward and backward split across a
// thread-block cluster (bf16, mma.sync): the layout for the conditioners
// whose weights or activations overflow one block of the mma layout
// (fused_train.cu's fwd_kernel_mma / bwd_kernel_mma): H = 128 with n_hidden
// 3-4 and H = 256 with n_hidden 2-4; and the sampler's inverse on the
// forward's design walked backwards (inv_cluster), at the shapes
// fused_sampler.cu builds it for.
// Included by fused_train.cu and fused_sampler.cu.
//
// Replaces, for those shapes, the Pallas TPU kernels `_fwd_kernel`
// (dpfx/ops/fused_train.py:131) and `_bwd_kernel` (:231), and (inv_cluster)
// `_fused_inverse_kernel` (dpfx/ops/fused_sampler.py:112) and
// `_fused_sample_kernel` (:309).
//
// What bounds it: the tensor cores, as the mma layout (2(9H + (n_hidden-1)
// H^2) FLOP a point and layer forward, ~3x that backward; 0.575 ms and 1.73
// ms at 64 x 2048 points, K=32, H=256, n_hidden 2). What stands in the way
// at H=256 is room: a layer's Wh is 128 KB, its dWh 256 KB of f32 (a whole
// register file), the tile's activations as much again. The design:
//   * Column ownership. A cluster of C = H / 64 CTAs takes one layer of one
//     tile of T points. Rank r owns hidden columns cols_r = [64r, 64r + 64)
//     of every hidden level: it holds the row slab Wh_j[cols_r, :] (the
//     forward product) and, backward, the column slab Wh_j[:, cols_r] (the
//     cotangent product) of each matrix, Wx^T whole, Wout[:, cols_r]; 32 KB
//     a slab at H=256. A layer's slabs are staged once per CTA (cp.async,
//     the next layer's behind this one where shared memory holds two
//     stages): the grid is persistent, as many clusters as the card holds
//     at once (30 of 4 CTAs on the H100: clusters sit inside a GPC), with
//     the layer loop outside the tile loop, so a launch reads each weight
//     from L2 once per cluster and not once per tile. Where whole-layer
//     stages would cost the backward its tile (a stage grows with depth:
//     141 KB at H=256, n_hidden 3), the ring takes their place: Wx^T and
//     Wout staged per layer, the slabs streamed one at a time through two
//     buffers in the order a tile uses them, the next slab's cp.async
//     behind the work on this one, one stream across tiles and layers. A
//     tile then reads its 2 (n_hidden - 1) slabs (33-36 KB each) from L2
//     again. The forward has less work a slab than the load takes: on the
//     ring the H=256 n_hidden 4 forward timed 22.41 ms against 21.59 on
//     the stream layout it replaced (bwd_ab, PERF.md), so it keeps
//     whole-layer stages with fewer tiles a group. Each point's state
//     is carried in global memory between layers, one copy per rank (every
//     rank computes the same bits and reads back what it wrote).
//   * Rows. A warp takes 16 points through the conditioner on m16n8k16
//     (flow_rows.cuh's fragments; ldmatrix for shared operands). h_0 =
//     relu(Wx x + hz) is computed whole in every rank (K = 3, first_rows);
//     h_{j+1}[:, cols_r] is local. Where the next product needs all of h
//     (n_hidden >= 3) each warp writes its slice into every rank's
//     exchange tile through distributed shared memory (16-byte
//     st.shared::cluster), and a cluster barrier makes it visible; two
//     exchange tiles in turn, so that a rank never writes into a tile that
//     another still reads without a barrier between. With
//     T < 128 the 8 warps are T / 16 point groups x 128 / T column groups
//     of 64 T / 128 columns. Every output element is one whole k-sum (k
//     chunks in order), so the forward and the backward's recompute give
//     the same bits at any T.
//   * (s, t) = sum over ranks of Wout[:, cols_r] h_last[:, cols_r] (a k-sum
//     over the rank's 64 columns, four chunks in order), + bout: each rank
//     pushes its 6 partials per point into its slot of every rank
//     (st.shared::cluster), a cluster barrier, then every rank adds the C
//     slots, all local, in rank order 0..C-1, so every rank holds the same
//     (s, t) bits and runs the coupling, its cotangents and the log-det
//     itself. The forward takes G tiles between two such exchanges (their
//     points' state in shared memory): CL_G = 4 (a barrier serves 512
//     points at T=128), fewer where the plan needs the room.
//   * Backward, per tile: the recompute (the forward's device code), the
//     coupling cotangents, dh_last[:, cols_r] = (rnd(d(s, t)) Wout[:, cols_r])
//     * (h_last > 0) locally; down the hidden levels dh_j[:, cols_r] =
//     (sum_q dh_{j+1}[:, cols_q] Wh_j[cols_q, cols_r]) * (h_j > 0) with the
//     other ranks' slices of dh_{j+1} exchanged as above (two exchange
//     tiles in turn: one cluster barrier an exchange). dy_in = dyn + Wx^T
//     dh_0: each rank's partial goes into its carry, and the next layer
//     adds the ranks' partials in rank order when it loads the point (a
//     cluster barrier at each layer's start hands the carries over), so no
//     barrier a tile waits for it.
//   * Weight gradients, summed over every point in registers through a
//     layer's whole tile loop. dWh_j[:, cols_r] += dh_{j+1}^T h_j[:, cols_r]
//     (the exchanged dh_{j+1} is in the rank's tile anyway, and only its own
//     columns of h_j are needed: no tile of all of h_j): H x 64 f32 per rank,
//     64 registers a lane at H=256 (32 at 128), points as the K dimension
//     through ldmatrix.trans. The registers hold MP matrices (one at H=256,
//     two at 128), which is every matrix where whole-layer stages fit. On
//     the ring the matrices past MP (Cl::SPILL) add each tile's product
//     into the cluster's slice (cl_dwh_tile: 16-byte loads and stores, the
//     tiles in order, the first one writing), 128 KB of L2 traffic a CTA,
//     tile and matrix; the tile is walked once. Walking it once per group
//     of MP matrices instead (passes, each recomputing the tile and
//     repeating its exchanges) timed 1.5-2.0x slower on the ring (bwd_ab,
//     PERF.md). dWout[:, cols_r], dWx[cols_r]
//     and the bias and hz gradients of the own columns are local; every
//     rank writes its parts of the cluster's slice once per layer and
//     `reduce_slices` adds the slices in a fixed order. No float atomics:
//     bit-identical from run to run.
//   * Inverse (inv_cluster): the forward's plan, grid and groups, the
//     layers walked K-1 .. 0; the same (s, t) device code (cl_st_partials),
//     so a forward and its inverse compute the same (s, t) bits at every
//     cluster shape and x comes back through a round trip up to the f32
//     rounding of the affine update. The base noise is read from ut or
//     drawn (Philox keyed by (point, cloud)) at the first layer walked;
//     x is carried between layers per rank ([C, B, 3, N]), no log-det.
//     A carve of its own (no log-det row or sums) would be 2,176 B smaller
//     at T=128, which gives no shape a larger tile or a second stage.
//   * Shared memory (ClusterPlan; tests/_torch_cluster_plan.py mirrors
//     it): the largest T of 128, 64, 32 that fits, on whole-layer stages
//     where they fit at that T (the forward: the most tiles a group, 4 down
//     to 2; two stages before one), else (the backward) on the ring. At
//     H=256, n_hidden 2: forward T=128 with two stages (184,960 B),
//     backward T=128 with one (217,600 B). On the ring: H=256 n_hidden 3
//     backward T=64 (199,424 B), n_hidden 4 backward T=64 (208,640 B),
//     H=128 n_hidden 4 backward T=128 (217,856 B); whole-layer stages would
//     need 280,576 B at T=32 for the n_hidden 4 backward. The n_hidden 4
//     forward: T=64, one whole stage, 3 tiles a group (223,616 B). T=128
//     stays out of reach at H=256 past n_hidden 2: the two exchange tiles
//     alone are 135 KB.

#pragma once

#include <cooperative_groups.h>

#include "flow_rows.cuh"

// A named namespace only (see dpfx_common.cuh).
namespace dpfx {

namespace cgrp = cooperative_groups;

constexpr int CL_HC = 64;            // hidden columns a rank owns
constexpr int CL_LDO = CL_HC + 8;    // row stride of an own-columns tile
constexpr int CL_G = 4;              // forward: tiles between two (s, t) exchanges, at most

__host__ __device__ constexpr int cmin(int a, int b) { return a < b ? a : b; }

// Byte offsets of one CTA's shared memory. A stage holds one layer's
// weights: the row slabs [NH1][64][H+8], (backward) the column slabs
// [NH1][H][72], Wx^T [8][H+8] (rows 3-7 zero), Wout[:, cols_r] [8][72]
// (rows 6-7 zero). A ring plan stages Wx^T and Wout alone and streams the
// slabs through two buffers of `slab` bytes at `ring`.
struct ClusterPlan {
  int T, G, nst, ring, slab, s_wh, s_wc, s_wxt, s_wout, stage_bytes;
  int xch, nx, hown, dh0, dstb, xkb, slot0, dhzw, ldw, xs, stage, total;
};

__host__ __device__ constexpr ClusterPlan cluster_carve(int H, int NH1, bool bwd, int T, int nst,
                                                        bool ring = false, int G = CL_G) {
  ClusterPlan p{};
  const int ldh = H + 8, ldt = T + 8;
  const int rows = round128(CL_HC * ldh * 2), cols = round128(H * CL_LDO * 2);
  int o = 0;
  p.s_wh = o;   o += ring ? 0 : NH1 * rows;
  p.s_wc = o;   o += bwd && !ring ? NH1 * cols : 0;
  p.s_wxt = o;  o += round128(8 * ldh * 2);
  p.s_wout = o; o += round128(8 * CL_LDO * 2);
  p.stage_bytes = o;
  const int tx = round128(T * ldh * 2), to = round128(T * CL_LDO * 2);
  o = 0;
  // exchange tiles, all H columns: two, used in turn, wherever a layer
  // exchanges at all (with one, a rank could overwrite a tile another
  // still reads; see fwd_cluster and bwd_cluster)
  p.nx = bwd ? cmin(NH1, 2) : (NH1 > 1 ? 2 : 0);
  p.xch = o;   o += p.nx * tx;
  p.hown = o;  o += bwd ? (NH1 + 1) * to : (T < 128 ? to : 0);   // own columns of h_0 .. h_last
  p.dh0 = o;   o += bwd ? to : 0;                          // own columns of dh_0
  p.dstb = o;  o += bwd ? round128(8 * ldt * 2) : 0;       // rnd(d(s, t)) [8][T+8]
  p.xkb = o;   o += bwd ? round128(8 * ldt * 2) : 0;       // rnd(x_k) [8][T+8]
  // every rank's (s, t) partials [C][T][6] (forward: of G tiles, two groups in turn)
  p.slot0 = o; o += (bwd ? 1 : 2 * G) * (H / CL_HC) * round128(T * 6 * 4);
  p.dhzw = o;  o += bwd ? round128(WARPS * CL_HC * 4) : 0;  // per-warp dhz sums of a tile
  p.ldw = o;   o += bwd ? 0 : 128;                         // per-warp log-det sums
  p.xs = o;    o += bwd ? 0 : round128(G * 4 * T * 4);  // the group's x and log-det [G][4][T]
  p.stage = o;
  p.T = T;
  p.G = G;
  p.nst = nst;
  p.total = o + nst * p.stage_bytes;
  if (ring) {
    p.slab = rows > cols ? rows : cols;
    p.ring = p.total;
    p.total += 2 * p.slab;
  }
  return p;
}

// the largest tile, then whole-layer stages (the forward: the most tiles a
// group, CL_G down to 2; two stages before one), then (the backward) the
// ring (two small stages before one), that fits (a plan that does not fit
// anywhere reports its T = 32, one-stage size)
__host__ __device__ constexpr ClusterPlan cluster_plan(int H, int NH1, bool bwd) {
  for (int T = 128; T >= 32; T /= 2) {
    for (int G = CL_G; G >= (bwd ? CL_G : 2); --G)
      for (int nst = 2; nst >= 1; --nst) {
        const ClusterPlan p = cluster_carve(H, NH1, bwd, T, nst, false, G);
        if (p.total <= SMEM_MAX) return p;
      }
    for (int nst = 2; bwd && nst >= 1; --nst) {
      const ClusterPlan p = cluster_carve(H, NH1, bwd, T, nst, true);
      if (p.total <= SMEM_MAX) return p;
    }
  }
  return cluster_carve(H, NH1, bwd, 32, 1);
}

// floats of a cluster's partial of one layer in the backward: [dWx | dWh |
// dbh | dWout | dbout], padded where dWh adds into it tile by tile (spill)
// to a multiple of 4, so that every dWh row of every (cluster, layer)
// slice is 16-byte aligned (cl_dwh_tile)
__host__ __device__ constexpr int cluster_part_row(int H, int NH1, bool spill) {
  return spill ? (3 * H + NH1 * H * H + NH1 * H + 6 * H + 6 + 3) / 4 * 4
               : 3 * H + NH1 * H * H + NH1 * H + 6 * H + 6;
}

// the compile-time constants of one instance
template <int H, int NH1, bool BWD>
struct Cl {
  static constexpr int C = H / CL_HC;                    // CTAs of a cluster
  // the plan's offsets as scalars (device code may not name a class-type constant)
  static constexpr int T = cluster_plan(H, NH1, BWD).T,
                       G = cluster_plan(H, NH1, BWD).G,
                       NST = cluster_plan(H, NH1, BWD).nst,
                       SWH = cluster_plan(H, NH1, BWD).s_wh,
                       SWC = cluster_plan(H, NH1, BWD).s_wc,
                       SWXT = cluster_plan(H, NH1, BWD).s_wxt,
                       SWOUT = cluster_plan(H, NH1, BWD).s_wout,
                       STAGE_BYTES = cluster_plan(H, NH1, BWD).stage_bytes,
                       XCH = cluster_plan(H, NH1, BWD).xch,
                       HOWN = cluster_plan(H, NH1, BWD).hown,
                       DH0 = cluster_plan(H, NH1, BWD).dh0,
                       DSTB = cluster_plan(H, NH1, BWD).dstb,
                       XKB = cluster_plan(H, NH1, BWD).xkb,
                       SLOT0 = cluster_plan(H, NH1, BWD).slot0,
                       DHZW = cluster_plan(H, NH1, BWD).dhzw,
                       LDW = cluster_plan(H, NH1, BWD).ldw,
                       XSB = cluster_plan(H, NH1, BWD).xs,
                       STAGE = cluster_plan(H, NH1, BWD).stage,
                       TOTAL = cluster_plan(H, NH1, BWD).total,
                       RINGB = cluster_plan(H, NH1, BWD).ring,
                       SLAB = cluster_plan(H, NH1, BWD).slab;
  static constexpr bool RING = RINGB != 0;               // Wh slabs streamed through the ring
  static constexpr int PG = T / 16, WC = WARPS / PG, W = CL_HC / WC, NW = W / 8;
  static constexpr int LDH = H + 8, LDO = CL_LDO, LDT = T + 8;
  static constexpr int WM = H / 128;                     // m16 tiles of a warp's dWh rows
  static constexpr int MP = 2 / WM;                      // dWh matrices held in registers
  // the matrices past MP (j < SPILL), whose dWh adds into the cluster's
  // slice tile by tile (cl_dwh_tile): only where the ring takes the room
  static constexpr int SPILL = NH1 > MP ? NH1 - MP : 0;
  static_assert(H == 128 || H == 256, "the cluster layout is built for H = 128 and 256");
  static_assert(TOTAL <= SMEM_MAX, "the cluster plan does not fit");
  static_assert(!RING || NH1 >= 2, "a ring streams the slabs of two or more matrices");
  static_assert(RING || !BWD || SPILL == 0, "whole-layer stages hold every dWh in registers");
};

__device__ __forceinline__ uint32_t cl_mapa(uint32_t addr, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
__device__ __forceinline__ void cl_st16(uint32_t addr, const uint4& v) {
  asm volatile("st.shared::cluster.v4.b32 [%0], {%1, %2, %3, %4};" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}
__device__ __forceinline__ void cl_st2(uint32_t addr, const float2& v) {
  asm volatile("st.shared::cluster.v2.f32 [%0], {%1, %2};" ::"r"(addr), "f"(v.x), "f"(v.y)
               : "memory");
}

// the row slab Wh[cols_r, :] ([64][H+8]) and the column slab Wh[:, cols_r]
// ([H][72]) of the matrix g into dst (cp.async)
template <int H>
__device__ __forceinline__ void cl_rows_slab(bf16* dst, const bf16* g, int rank) {
  constexpr int LDH = H + 8, VPR = H / 8;
  for (int v = threadIdx.x; v < CL_HC * VPR; v += THREADS) {
    const int r = v / VPR, c = (v % VPR) * 8;
    cp_async16(dst + r * LDH + c, g + (size_t)(rank * CL_HC + r) * H + c);
  }
}
template <int H>
__device__ __forceinline__ void cl_cols_slab(bf16* dst, const bf16* g, int rank) {
  for (int v = threadIdx.x; v < H * 8; v += THREADS) {
    const int r = v / 8, c = (v % 8) * 8;
    cp_async16(dst + r * CL_LDO + c, g + (size_t)r * H + rank * CL_HC + c);
  }
}

// Stage layer k's weights for rank `rank` into st (cp.async for the slabs
// and Wout, plain loads for the transposed Wx; a ring plan's stage has no
// slabs); the caller commits and waits
template <int H, int NH1, bool BWD>
__device__ void cl_stage(unsigned char* st, const bf16* wx, const bf16* wh, const bf16* wout,
                         int k, int rank) {
  using Q = Cl<H, NH1, BWD>;
  constexpr int LDH = Q::LDH, LDO = Q::LDO;
  if constexpr (!Q::RING) {
    for (int j = 0; j < NH1; ++j) {
      const bf16* g = wh + ((size_t)k * NH1 + j) * H * H;
      cl_rows_slab<H>(reinterpret_cast<bf16*>(st + Q::SWH + j * round128(CL_HC * LDH * 2)), g,
                      rank);
      if constexpr (BWD)
        cl_cols_slab<H>(reinterpret_cast<bf16*>(st + Q::SWC + j * round128(H * LDO * 2)), g,
                        rank);
    }
  }
  bf16* wo = reinterpret_cast<bf16*>(st + Q::SWOUT);
  for (int v = threadIdx.x; v < 6 * 8; v += THREADS) {
    const int r = v / 8, c = (v % 8) * 8;
    cp_async16(wo + r * LDO + c, wout + ((size_t)k * 6 + r) * H + rank * CL_HC + c);
  }
  cp_async_commit();
  bf16* wxt = reinterpret_cast<bf16*>(st + Q::SWXT);
  for (int e = threadIdx.x; e < 3 * H; e += THREADS)
    wxt[(e % 3) * LDH + e / 3] = wx[(size_t)k * 3 * H + e];
}

// The backward's ring (Q::RING): the slabs a tile uses, in order (the
// recompute's row slabs j = 0 .. NH1-1, then the column slabs j = NH1-1 ..
// 0), one stream across tiles and layers; use s reads buffer s & 1. Before
// use s every thread waits for its copies and a barrier makes them
// visible; after that barrier slab s + 1 is issued into the other buffer,
// which every warp left before the barrier (use s - 1 precedes it).
template <int H, int NH1>
__device__ __forceinline__ const bf16* cl_ring_buf(unsigned char* smem, int s) {
  using Q = Cl<H, NH1, true>;
  return reinterpret_cast<const bf16*>(smem + Q::RINGB + (s & 1) * Q::SLAB);
}

// slab use s: layer k's row slab j (col: its column slab), one cp.async
// group; nothing where k < 0 (past the last layer walked)
template <int H, int NH1>
__device__ __forceinline__ void cl_ring_load(unsigned char* smem, int s, const bf16* wh, int k,
                                             int j, bool col, int rank) {
  using Q = Cl<H, NH1, true>;
  if (k < 0) return;
  bf16* dst = reinterpret_cast<bf16*>(smem + Q::RINGB + (s & 1) * Q::SLAB);
  const bf16* g = wh + ((size_t)k * NH1 + j) * H * H;
  if (col) cl_cols_slab<H>(dst, g, rank);
  else cl_rows_slab<H>(dst, g, rank);
  cp_async_commit();
}

// zero the padding rows the products read: each stage's Wx^T rows 3-7 and
// Wout rows 6-7, and (backward) rnd(d(s, t)) rows 6-7, rnd(x_k) rows 3-7
template <int H, int NH1, bool BWD>
__device__ void cl_zero_pads(unsigned char* smem) {
  using Q = Cl<H, NH1, BWD>;
  const bf16 z = __float2bfloat16_rn(0.f);
  for (int s = 0; s < Q::NST; ++s) {
    bf16* wxt = reinterpret_cast<bf16*>(smem + Q::STAGE + s * Q::STAGE_BYTES + Q::SWXT);
    bf16* wo = reinterpret_cast<bf16*>(smem + Q::STAGE + s * Q::STAGE_BYTES + Q::SWOUT);
    for (int e = threadIdx.x; e < 5 * Q::LDH; e += THREADS) wxt[3 * Q::LDH + e] = z;
    for (int e = threadIdx.x; e < 2 * Q::LDO; e += THREADS) wo[6 * Q::LDO + e] = z;
  }
  if constexpr (BWD) {
    bf16* db = reinterpret_cast<bf16*>(smem + Q::DSTB);
    bf16* xb = reinterpret_cast<bf16*>(smem + Q::XKB);
    for (int e = threadIdx.x; e < 2 * Q::LDT; e += THREADS) db[6 * Q::LDT + e] = z;
    for (int e = threadIdx.x; e < 5 * Q::LDT; e += THREADS) xb[3 * Q::LDT + e] = z;
  }
}

// c (the warp's NW n8 tiles) = A B, A the warp's 16 rows x H in registers
// (Rows<H>), B a row slab [n][LDH] (rows n, k contiguous) from the warp's
// first column; for each tile the k chunks in order. The k loop is outside,
// so the NW accumulators' mma chains are in flight together.
template <int H, int NW>
__device__ __forceinline__ void cl_prod_regs(float (&c)[NW][4], const Rows<H>& a, const bf16* w) {
  constexpr int LD = H + 8;
  const int lane = lane_id();
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < H / 16; ++kc) {
#pragma unroll
    for (int np = 0; np < NW / 2; ++np) {
      uint32_t b[4];
      ldsm_x4(b, w + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * LD + 16 * kc +
                     ((lane >> 3) & 1) * 8);
      mma16(c[2 * np], a.a[kc], b[0], b[1]);
      mma16(c[2 * np + 1], a.a[kc], b[2], b[3]);
    }
  }
}

// c = A B, A the warp's 16 rows of a shared tile (row stride lda, KD
// columns), B a slab: BT false rows n ([n][ldw], k contiguous), BT true rows
// k ([k][ldw], n contiguous); the same per-element sums as cl_prod_regs
template <int KD, int NW, bool BT>
__device__ __forceinline__ void cl_prod_smem(float (&c)[NW][4], const bf16* a, int lda,
                                             const bf16* w, int ldw) {
  const int lane = lane_id();
#pragma unroll
  for (int i = 0; i < NW; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[i][e] = 0.f;
#pragma unroll 4
  for (int kc = 0; kc < KD / 16; ++kc) {
    uint32_t af[4];
    ldsm_x4(af, a + (lane & 15) * lda + 16 * kc + (lane >> 4) * 8);
#pragma unroll
    for (int np = 0; np < NW / 2; ++np) {
      uint32_t b[4];
      if constexpr (BT)
        ldsm_x4_t(b, w + (16 * kc + (lane & 7) + ((lane >> 3) & 1) * 8) * ldw + 16 * np +
                         (lane >> 4) * 8);
      else
        ldsm_x4(b, w + (16 * np + (lane & 7) + ((lane >> 4) << 3)) * ldw + 16 * kc +
                       ((lane >> 3) & 1) * 8);
      mma16(c[2 * np], af, b[0], b[1]);
      mma16(c[2 * np + 1], af, b[2], b[3]);
    }
  }
}

// relu(c + bias) of the warp's tiles as bf16 pairs (lo: row g, hi: row g + 8,
// columns 8i + 2t of the warp's), the rounding of flow_rows.cuh's epi_act
template <int NW>
__device__ __forceinline__ void cl_epi_act(uint32_t (&lo)[NW], uint32_t (&hi)[NW],
                                           const float (&c)[NW][4], const float* bias) {
  const int t = lane_id() & 3;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + 8 * i + 2 * t));
    lo[i] = pack_bf16(relu_nan(c[i][0] + bb.x), relu_nan(c[i][1] + bb.y));
    hi[i] = pack_bf16(relu_nan(c[i][2] + bb.x), relu_nan(c[i][3] + bb.y));
  }
}

// c * (h > 0), h from the warp's rows of an own-columns tile, as bf16 pairs;
// the column sums of the f32 values over the warp's 16 rows: lane g keeps
// tile g (g < NW) in kept[0..1] (flow_bwd_rows.cuh's epi_mask)
template <int NW>
__device__ __forceinline__ void cl_epi_mask(uint32_t (&lo)[NW], uint32_t (&hi)[NW],
                                            const float (&c)[NW][4], const bf16* hmask,
                                            float (&kept)[2]) {
  constexpr int LD = CL_LDO;
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    const int col = 8 * i + 2 * t;
    const float2 m0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(hmask + g * LD + col));
    const float2 m1 = unpack_bf16(*reinterpret_cast<const uint32_t*>(hmask + (g + 8) * LD + col));
    const float v0 = c[i][0] * (m0.x > 0.f ? 1.f : 0.f), v1 = c[i][1] * (m0.y > 0.f ? 1.f : 0.f);
    const float v2 = c[i][2] * (m1.x > 0.f ? 1.f : 0.f), v3 = c[i][3] * (m1.y > 0.f ? 1.f : 0.f);
    lo[i] = pack_bf16(v0, v1);
    hi[i] = pack_bf16(v2, v3);
    float s0 = v0 + v2, s1 = v1 + v3;
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) {
      s0 += __shfl_xor_sync(0xffffffffu, s0, off);
      s1 += __shfl_xor_sync(0xffffffffu, s1, off);
    }
    if (g == i) {
      kept[0] = s0;
      kept[1] = s1;
    }
  }
}

// the pairs into the warp's 16 rows of a tile (row stride ld) from its first column
template <int NW>
__device__ __forceinline__ void cl_store(bf16* dst, int ld, const uint32_t (&lo)[NW],
                                         const uint32_t (&hi)[NW]) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    *reinterpret_cast<uint32_t*>(dst + g * ld + 8 * i + 2 * t) = lo[i];
    *reinterpret_cast<uint32_t*>(dst + (g + 8) * ld + 8 * i + 2 * t) = hi[i];
  }
}

// the warp's 16 x W block at src (row stride ld, already in this CTA's
// tile) into the same place of every other rank's tile
template <int C, int W>
__device__ __forceinline__ void cl_push(const bf16* src, int ld, int rank) {
  constexpr int VPR = W / 8;
  __syncwarp();
  const int lane = lane_id();
#pragma unroll
  for (int v = lane; v < 16 * VPR; v += 32) {
    const bf16* p = src + (v / VPR) * ld + (v % VPR) * 8;
    const uint4 val = *reinterpret_cast<const uint4*>(p);
    const uint32_t a = smem_u32(p);
#pragma unroll
    for (int q = 1; q < C; ++q) {
      const int r = rank + q < C ? rank + q : rank + q - C;
      cl_st16(cl_mapa(a, r), val);
    }
  }
}

// the rank's (s, t) partial of the warp's 16 points: A = h_last's own 64
// columns (four k chunks in order), B = Wout[:, cols_r] [8][72]
__device__ __forceinline__ void cl_out_partial(float (&c)[4], const uint32_t (&a)[4][4],
                                               const bf16* wout8) {
  const int lane = lane_id();
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 2; ++kk) {
    uint32_t b[4];
    ldsm_x4(b, wout8 + (lane & 7) * CL_LDO + 32 * kk + (lane >> 3) * 8);
    mma16(c, a[2 * kk], b[0], b[1]);
    mma16(c, a[2 * kk + 1], b[2], b[3]);
  }
}

// the A fragments of the warp's 16 rows x 64 columns of an own-columns tile
__device__ __forceinline__ void cl_load_own(uint32_t (&a)[4][4], const bf16* rows) {
  const int lane = lane_id();
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
    ldsm_x4(a[kc], rows + (lane & 15) * CL_LDO + 16 * kc + (lane >> 4) * 8);
}

// the same from the last product's pairs (W = 64: the warp has all columns)
template <int NW>
__device__ __forceinline__ void cl_frags(uint32_t (&a)[4][4], const uint32_t (&lo)[NW],
                                         const uint32_t (&hi)[NW]) {
  static_assert(NW == 8, "the warp holds all 64 own columns");
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    a[kc][0] = lo[2 * kc];
    a[kc][1] = hi[2 * kc];
    a[kc][2] = lo[2 * kc + 1];
    a[kc][3] = hi[2 * kc + 1];
  }
}

// the warp's C tile c (16 x 8) columns 0..5, the rank's (s, t) partials of
// its 16 points, into slot rows r0 + (g, g + 8) of every rank of the
// cluster (st.shared::cluster: the stores need no answer)
template <int C>
__device__ __forceinline__ void cl_slot_push(float* slot, int r0, const float (&c)[4]) {
  const int lane = lane_id(), g = lane >> 2, t = lane & 3;
  if (2 * t < 6) {
    const uint32_t a0 = smem_u32(slot + (r0 + g) * 6 + 2 * t);
    const uint32_t a1 = smem_u32(slot + (r0 + g + 8) * 6 + 2 * t);
#pragma unroll
    for (int r = 0; r < C; ++r) {
      cl_st2(cl_mapa(a0, r), make_float2(c[0], c[1]));
      cl_st2(cl_mapa(a1, r), make_float2(c[2], c[3]));
    }
  }
}

// point q's 6 partials summed over the ranks' slots (this CTA's copies,
// [C][SS floats]) in rank order
template <int C>
__device__ __forceinline__ void cl_slot_sum(float (&v)[6], const float* slots, int ss, int q) {
#pragma unroll
  for (int e = 0; e < 6; ++e) v[e] = slots[q * 6 + e];
#pragma unroll
  for (int r = 1; r < C; ++r)
#pragma unroll
    for (int e = 0; e < 6; ++e) v[e] += slots[r * ss + q * 6 + e];
}

// The rank's (s, t) partials of tile q of a group, pushed into slot rows
// r0 .. r0 + 15 of every rank (`myslot`: this rank's slot of the tile):
// the warp's 16 points x through h_0 (whole, first_rows), the deeper
// levels on the rank's own columns (exchanged where the next product needs
// all of h), and Wout[:, cols_r] h_last[:, cols_r]. The one copy of this
// code that fwd_cluster and inv_cluster run, so that a forward and its
// inverse over the same passthrough coordinates compute the same (s, t)
// bits. hzb: the tile's cloud's hz of the layer; swh, wxt, wo8: the
// layer's stage; bhk: bh of the layer from the warp's first own column.
// The group's e-th exchange (e = q (NH1 - 1) + j - 1) uses exchange tile
// e & 1. A rank writes tile e & 1 again at exchange e + 2 only after the
// barrier of exchange e + 1, which no rank reaches before its reads of
// exchange e are done; the caller's barrier after a group's last tile
// follows every read of the group, so each group starts at tile 0.
template <int H, int NH1>
__device__ __forceinline__ void cl_st_partials(cgrp::cluster_group& cl, unsigned char* smem,
                                               const float (&x)[3], const float* hzb,
                                               const bf16* swh, const bf16* wxt, const bf16* wo8,
                                               const float* bhk, float* myslot, int q, int rank) {
  using Q = Cl<H, NH1, false>;
  constexpr int C = Q::C, W = Q::W, NW = Q::NW, LDH = Q::LDH;
  constexpr int XS = round128(Q::T * LDH * 2) / 2, RS = round128(CL_HC * LDH * 2) / 2;
  const int warp = threadIdx.x / 32, cgp = warp / Q::PG, r0 = (warp % Q::PG) * 16, c0 = cgp * W;
  bf16* xch = reinterpret_cast<bf16*>(smem + Q::XCH);
  uint32_t a0, a1;
  coord_frag(x, a0, a1);
  uint32_t lo[NW], hi[NW];
  {
    Rows<H> h;
    first_rows<H>(h, a0, a1, wxt, hzb, nullptr);
    float c[NW][4];
    cl_prod_regs<H, NW>(c, h, swh + c0 * LDH);
    cl_epi_act<NW>(lo, hi, c, bhk);
  }
#pragma unroll
  for (int j = 1; j < NH1; ++j) {
    const int xb = (q * (NH1 - 1) + j - 1) & 1;
    bf16* xo = xch + xb * XS + r0 * LDH + rank * CL_HC + c0;
    cl_store<NW>(xo, LDH, lo, hi);
    cl_push<C, W>(xo, LDH, rank);
    cl.sync();   // every rank's columns of h_j
    float c[NW][4];
    cl_prod_smem<H, NW, false>(c, xch + xb * XS + r0 * LDH, LDH, swh + j * RS + c0 * LDH, LDH);
    cl_epi_act<NW>(lo, hi, c, bhk + j * H);
  }
  if constexpr (Q::WC > 1) {
    bf16* own = reinterpret_cast<bf16*>(smem + Q::HOWN) + r0 * Q::LDO + c0;
    __syncthreads();   // the previous tile's reads of h_last are done
    cl_store<NW>(own, Q::LDO, lo, hi);
    __syncthreads();   // every column group's part of h_last
  }
  if (cgp == 0) {
    uint32_t af[4][4];
    if constexpr (Q::WC > 1)
      cl_load_own(af, reinterpret_cast<const bf16*>(smem + Q::HOWN) + r0 * Q::LDO);
    else cl_frags<NW>(af, lo, hi);
    float sc[4];
    cl_out_partial(sc, af, wo8);
    cl_slot_push<C>(myslot, r0, sc);
  }
}

// The forward. xt [B, 3, N] (read at layer 0), u [B, 3, N] and ld_part [B,
// ceil(N / T)] (written by rank 0 at the last layer), carry [C, B, 4, N]
// f32 scratch (x and the running log-det per point, one copy per rank).
// The grid: clusters x C CTAs, cluster c taking the groups of CL_G tiles
// c, c + clusters, ...; one (s, t) exchange a group and layer.
template <int H, int NH1>
__global__ void __launch_bounds__(THREADS, 1)
fwd_cluster(const float* __restrict__ xt, const float* __restrict__ hz, float* __restrict__ u,
            float* __restrict__ ld_part, float* __restrict__ carry, const bf16* __restrict__ wx,
            const bf16* __restrict__ wh, const float* __restrict__ bh,
            const bf16* __restrict__ wout, const float* __restrict__ bout,
            const float* __restrict__ masks, int B, int N, int K, float cap) {
  using Q = Cl<H, NH1, false>;
  constexpr int T = Q::T, C = Q::C, G = Q::G;
  constexpr int SS = round128(T * 6 * 4) / 4;   // floats of one tile's slot
  extern __shared__ __align__(128) unsigned char smem[];
  cgrp::cluster_group cl = cgrp::this_cluster();
  const int rank = (int)cl.block_rank(), cid = blockIdx.x / C, clusters = gridDim.x / C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, p = lane & 15;
  const int pg = warp % Q::PG, cgp = warp / Q::PG, r0 = pg * 16, c0 = cgp * Q::W;
  const int nt = (N + T - 1) / T, tiles = B * nt, groups = (tiles + G - 1) / G;
  float* cr = carry + (size_t)rank * B * 4 * N;
  float* ldw = reinterpret_cast<float*>(smem + Q::LDW);   // [G][PG]
  float* xsg = reinterpret_cast<float*>(smem + Q::XSB);   // [G][4][T]
  auto stage = [&](int st) { return smem + Q::STAGE + st * Q::STAGE_BYTES; };

  cl_zero_pads<H, NH1, false>(smem);
  cl_stage<H, NH1, false>(stage(0), wx, wh, wout, 0, rank);
  cl.sync();   // every CTA of the cluster runs before any reads another's memory
  int it = 0;
  for (int k = 0; k < K; ++k) {
    const int st = Q::NST == 2 ? (k & 1) : 0;
    if (Q::NST == 1 && k > 0) {
      __syncthreads();   // every warp is done with the single stage
      cl_stage<H, NH1, false>(stage(0), wx, wh, wout, k, rank);
    }
    cp_async_wait_all();
    __syncthreads();     // layer k's stage is visible; layer k-1 is done with the other
    if (Q::NST == 2 && k + 1 < K) cl_stage<H, NH1, false>(stage(st ^ 1), wx, wh, wout, k + 1, rank);
    const bf16* swh = reinterpret_cast<const bf16*>(stage(st) + Q::SWH);
    const bf16* wxt = reinterpret_cast<const bf16*>(stage(st) + Q::SWXT);
    const bf16* wo8 = reinterpret_cast<const bf16*>(stage(st) + Q::SWOUT);
    const float* bhk = bh + (size_t)k * NH1 * H + rank * CL_HC + c0;
    bool pass[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) pass[c] = masks[k * 3 + c] > 0.f;
    float bo[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) bo[e] = bout[k * 6 + e];

    for (int grp = cid; grp < groups; grp += clusters, ++it) {
      // the group's points: tile grp * G + q; x and the running log-det of
      // point pt of tile q at xsg[(q * 4 + c) * T + pt]
      __syncthreads();   // the previous group is done with xsg
      for (int e = tid; e < G * T; e += THREADS) {
        const int q = e / T, pt = e % T, tile = grp * G + q;
        const int b = tile / nt, n = (tile % nt) * T + pt;
        const bool valid = tile < tiles && n < N;
        const size_t row = (size_t)b * (k == 0 ? 3 : 4);
#pragma unroll
        for (int c = 0; c < 3; ++c)
          xsg[(q * 4 + c) * T + pt] = !valid ? 0.f : (k == 0 ? xt : cr)[(row + c) * N + n];
        xsg[(q * 4 + 3) * T + pt] = k > 0 && valid ? cr[(row + 3) * N + n] : 0.f;
      }
      __syncthreads();
      // this group's slots: [G][C][SS], rank r's partials of tile q at (q * C
      // + r) * SS; two sets in turn: a rank pushes into set it & 1 again in
      // group it + 2, after group it + 1's last barrier, which no rank
      // reaches before it has summed group it's slots
      float* slot = reinterpret_cast<float*>(smem + Q::SLOT0) + (it & 1) * G * C * SS;
#pragma unroll 1
      for (int q = 0; q < G; ++q) {
        const int b = min(grp * G + q, tiles - 1) / nt;
        float x[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) x[c] = xsg[(q * 4 + c) * T + r0 + p];
        cl_st_partials<H, NH1>(cl, smem, x, hz + ((size_t)b * K + k) * H, swh, wxt, wo8, bhk,
                               slot + (q * C + rank) * SS, q, rank);
      }
      cl.sync();   // every rank's (s, t) partials of the group are in every rank's slots
      if (cgp == 0) {
#pragma unroll 1
        for (int q = 0; q < G; ++q) {
          const int tile = grp * G + q, b = tile / nt, n = (tile % nt) * T + r0 + p;
          const bool valid = tile < tiles && n < N;
          float x[3], sv[6];
#pragma unroll
          for (int c = 0; c < 3; ++c) x[c] = xsg[(q * 4 + c) * T + r0 + p];
          float ld = xsg[(q * 4 + 3) * T + r0 + p];
          cl_slot_sum<C>(sv, slot + q * C * SS, SS, r0 + p);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            if (pass[c]) continue;
            const float sc = cap * tanhf((sv[c] + bo[c]) / cap);
            ld += sc;
            x[c] = x[c] * expf(sc) + (sv[3 + c] + bo[3 + c]);
          }
          if (k + 1 < K) {
            if (lane < 16 && valid) {
              const size_t row = (size_t)b * 4;
#pragma unroll
              for (int c = 0; c < 3; ++c) cr[(row + c) * N + n] = x[c];
              cr[(row + 3) * N + n] = ld;
            }
          } else if (rank == 0) {
            if (lane < 16 && valid)
#pragma unroll
              for (int c = 0; c < 3; ++c) u[((size_t)b * 3 + c) * N + n] = x[c];
            float v = lane < 16 && valid ? ld : 0.f;
#pragma unroll
            for (int off = 8; off; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            if (lane == 0) ldw[q * Q::PG + pg] = v;
          }
        }
      }
      if (k + 1 == K && rank == 0) {   // each tile's log-det: its point groups in order
        __syncthreads();
        if (tid < G && grp * G + tid < tiles) {
          float a = 0.f;
          for (int q = 0; q < Q::PG; ++q) a += ldw[tid * Q::PG + q];
          ld_part[grp * G + tid] = a;
        }
      }
    }
  }
  cl.sync();   // no CTA leaves while another may read its slots
}

// The sampler's base noise, shared by its rows kernel (fused_sampler.cu)
// and inv_cluster: Philox4x32-10 (Salmon et al., SC'11)
__device__ __forceinline__ void philox(uint32_t c[4], uint32_t k0, uint32_t k1) {
  for (int r = 0; r < 10; ++r) {
    if (r) { k0 += 0x9E3779B9u; k1 += 0xBB67AE85u; }
    uint32_t hi0 = __umulhi(0xD2511F53u, c[0]), lo0 = 0xD2511F53u * c[0];
    uint32_t hi1 = __umulhi(0xCD9E8D57u, c[2]), lo1 = 0xCD9E8D57u * c[2];
    uint32_t n0 = hi1 ^ c[1] ^ k0, n2 = hi0 ^ c[3] ^ k1;
    c[0] = n0; c[1] = lo1; c[2] = n2; c[3] = lo0;
  }
}

__device__ __forceinline__ float box_muller(uint32_t a, uint32_t b) {
  const float inv24 = 1.0f / 16777216.0f;
  float u1 = (float)(a >> 8) * inv24 + 1e-7f;
  float u2 = (float)(b >> 8) * inv24;
  return sqrtf(-2.0f * logf(u1)) * cosf(6.283185307179586f * u2);
}

// point n of cloud b: its base noise read from ut, or drawn (and written to
// u_out when write is set and u_out is not null); zeros past N
__device__ __forceinline__ void base_noise(float (&x)[3], int n, int b, int N, size_t cloud,
                                           const float* ut, float* u_out, bool write,
                                           unsigned long long seed, float noise_scale) {
  x[0] = x[1] = x[2] = 0.f;
  if (n >= N) return;
  if (ut) {
    for (int c = 0; c < 3; ++c) x[c] = ut[cloud + (size_t)c * N + n];
    return;
  }
  uint32_t r0[4] = {(uint32_t)n, (uint32_t)b, 0u, 0u};
  uint32_t r1[4] = {(uint32_t)n, (uint32_t)b, 1u, 0u};
  philox(r0, (uint32_t)seed, (uint32_t)(seed >> 32));
  philox(r1, (uint32_t)seed, (uint32_t)(seed >> 32));
  x[0] = box_muller(r0[0], r0[1]) * noise_scale;
  x[1] = box_muller(r0[2], r0[3]) * noise_scale;
  x[2] = box_muller(r1[0], r1[1]) * noise_scale;
  if (write && u_out)
    for (int c = 0; c < 3; ++c) u_out[cloud + (size_t)c * N + n] = x[c];
}

// The inverse (the sampler's bf16 relu layout at these shapes), on the
// forward's plan and grid, the layers walked K-1 .. 0. ut [B, CR, N] (CR =
// 3 or 8; coordinates in rows 0-2) is read at the first layer walked; with
// ut null the base noise is drawn there instead (base_noise: keyed by
// (point, cloud), so the stream does not depend on the tiling; every rank
// draws the same bits, rank 0 writes them to u_out [B, 3, N] where it is
// not null). out [B, CR, N]: rows 0-2 written by rank 0 after layer 0 (the
// other rows are the caller's). carry [C, B, 3, N] f32 scratch: x per
// point between layers, one copy per rank (every rank computes the same
// bits and reads back what it wrote). The coupling is rows_kernel's
// inverse: x = (x - t) exp(-s), s = cap tanh(st / cap), no log-det.
template <int H, int NH1>
__global__ void __launch_bounds__(THREADS, 1)
inv_cluster(const float* __restrict__ hz, const float* __restrict__ ut, float* __restrict__ out,
            float* __restrict__ u_out, float* __restrict__ carry, const bf16* __restrict__ wx,
            const bf16* __restrict__ wh, const float* __restrict__ bh,
            const bf16* __restrict__ wout, const float* __restrict__ bout,
            const float* __restrict__ masks, int B, int CR, int N, int K, float cap,
            unsigned long long seed, float noise_scale) {
  using Q = Cl<H, NH1, false>;
  constexpr int T = Q::T, C = Q::C, G = Q::G;
  constexpr int SS = round128(T * 6 * 4) / 4;   // floats of one tile's slot
  extern __shared__ __align__(128) unsigned char smem[];
  cgrp::cluster_group cl = cgrp::this_cluster();
  const int rank = (int)cl.block_rank(), cid = blockIdx.x / C, clusters = gridDim.x / C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, p = lane & 15;
  const int cgp = warp / Q::PG, r0 = (warp % Q::PG) * 16, c0 = cgp * Q::W;
  const int nt = (N + T - 1) / T, tiles = B * nt, groups = (tiles + G - 1) / G;
  float* cr = carry + (size_t)rank * B * 3 * N;
  float* xsg = reinterpret_cast<float*>(smem + Q::XSB);   // [G][4][T], rows 0-2
  auto stage = [&](int st) { return smem + Q::STAGE + st * Q::STAGE_BYTES; };

  cl_zero_pads<H, NH1, false>(smem);
  cl_stage<H, NH1, false>(stage(0), wx, wh, wout, K - 1, rank);
  cl.sync();   // every CTA of the cluster runs before any writes into another
  int it = 0;
  for (int i = 0; i < K; ++i) {
    const int k = K - 1 - i, st = Q::NST == 2 ? (i & 1) : 0;
    if (Q::NST == 1 && i > 0) {
      __syncthreads();   // every warp is done with the single stage
      cl_stage<H, NH1, false>(stage(0), wx, wh, wout, k, rank);
    }
    cp_async_wait_all();
    __syncthreads();     // layer k's stage is visible; layer k+1 is done with the other
    if (Q::NST == 2 && i + 1 < K) cl_stage<H, NH1, false>(stage(st ^ 1), wx, wh, wout, k - 1, rank);
    const bf16* swh = reinterpret_cast<const bf16*>(stage(st) + Q::SWH);
    const bf16* wxt = reinterpret_cast<const bf16*>(stage(st) + Q::SWXT);
    const bf16* wo8 = reinterpret_cast<const bf16*>(stage(st) + Q::SWOUT);
    const float* bhk = bh + (size_t)k * NH1 * H + rank * CL_HC + c0;
    bool pass[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) pass[c] = masks[k * 3 + c] > 0.f;
    float bo[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) bo[e] = bout[k * 6 + e];

    for (int grp = cid; grp < groups; grp += clusters, ++it) {
      // the group's points: x of point pt of tile q at xsg[(q * 4 + c) * T + pt]
      __syncthreads();   // the previous group is done with xsg
      for (int e = tid; e < G * T; e += THREADS) {
        const int q = e / T, pt = e % T, tile = grp * G + q;
        const int b = tile / nt, n = (tile % nt) * T + pt;
        const bool valid = tile < tiles && n < N;
        float x[3] = {0.f, 0.f, 0.f};
        if (i == 0)
          base_noise(x, valid ? n : N, b, N, (size_t)b * CR * N, ut, u_out, rank == 0, seed,
                     noise_scale);
        else if (valid)
#pragma unroll
          for (int c = 0; c < 3; ++c) x[c] = cr[((size_t)b * 3 + c) * N + n];
#pragma unroll
        for (int c = 0; c < 3; ++c) xsg[(q * 4 + c) * T + pt] = x[c];
      }
      __syncthreads();
      // the group's slots, two sets in turn, as fwd_cluster's
      float* slot = reinterpret_cast<float*>(smem + Q::SLOT0) + (it & 1) * G * C * SS;
#pragma unroll 1
      for (int q = 0; q < G; ++q) {
        const int b = min(grp * G + q, tiles - 1) / nt;
        float x[3];
#pragma unroll
        for (int c = 0; c < 3; ++c) x[c] = xsg[(q * 4 + c) * T + r0 + p];
        cl_st_partials<H, NH1>(cl, smem, x, hz + ((size_t)b * K + k) * H, swh, wxt, wo8, bhk,
                               slot + (q * C + rank) * SS, q, rank);
      }
      cl.sync();   // every rank's (s, t) partials of the group are in every rank's slots
      if (cgp == 0) {
#pragma unroll 1
        for (int q = 0; q < G; ++q) {
          const int tile = grp * G + q, b = tile / nt, n = (tile % nt) * T + r0 + p;
          if (!(lane < 16 && tile < tiles && n < N)) continue;
          float x[3], sv[6];
#pragma unroll
          for (int c = 0; c < 3; ++c) x[c] = xsg[(q * 4 + c) * T + r0 + p];
          cl_slot_sum<C>(sv, slot + q * C * SS, SS, r0 + p);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            if (pass[c]) continue;
            const float sc = cap * tanhf((sv[c] + bo[c]) / cap);
            x[c] = (x[c] - (sv[3 + c] + bo[3 + c])) * expf(-sc);
          }
          if (k > 0) {
#pragma unroll
            for (int c = 0; c < 3; ++c) cr[((size_t)b * 3 + c) * N + n] = x[c];
          } else if (rank == 0) {
#pragma unroll
            for (int c = 0; c < 3; ++c) out[((size_t)b * CR + c) * N + n] = x[c];
          }
        }
      }
    }
  }
  cl.sync();   // no CTA leaves while another may read its slots
}

// A tile's dWh_j[:, cols_r] for a matrix the registers do not hold: the
// tile's dh_{j+1}^T h_j[:, cols_r] (the register-held matrices' products,
// one m16 band of the warp's rows at a time), added into the cluster's
// slice (dwh, row stride H, from the rank's first column oc) with 16-byte
// loads and stores; the cluster's first tile of the layer (first) writes
// it. Lanes t and t ^ 1 swap halves, so that each holds 4 columns of one
// row: even t row g, odd t row g + 8. Each lane reads and writes the same
// addresses every tile: no fence, and the tiles add in order.
template <int H, int T>
__device__ __forceinline__ void cl_dwh_tile(float* dwh, const bf16* xin, const bf16* hj, int oc,
                                            bool first) {
  constexpr int LDH = H + 8, WM = H / 128;
  const int warp = threadIdx.x / 32, lane = lane_id(), g = lane >> 2, t = lane & 3;
  const bool odd = t & 1;
#pragma unroll
  for (int mi = 0; mi < WM; ++mi) {
    float acc[8][4];
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < T / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4_t(a, xin + (16 * kk + (lane & 7) + ((lane >> 4) & 1) * 8) * LDH +
                       (warp * WM + mi) * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int ni = 0; ni < 8; ni += 2) {
        uint32_t bq[4];
        ldsm_x4_t(bq, hj + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * CL_LDO + ni * 8 +
                          (lane >> 4) * 8);
        mma16(acc[ni], a, bq[0], bq[1]);
        mma16(acc[ni + 1], a, bq[2], bq[3]);
      }
    }
    float* row = dwh + (size_t)((warp * WM + mi) * 16 + g + (odd ? 8 : 0)) * H + oc + 2 * (t & 2);
#pragma unroll
    for (int ni = 0; ni < 8; ++ni) {
      const float s0 = __shfl_xor_sync(0xffffffffu, odd ? acc[ni][0] : acc[ni][2], 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, odd ? acc[ni][1] : acc[ni][3], 1);
      float4 v = odd ? make_float4(s0, s1, acc[ni][2], acc[ni][3])
                     : make_float4(acc[ni][0], acc[ni][1], s0, s1);
      float4* d = reinterpret_cast<float4*>(row + ni * 8);
      if (!first) {
        const float4 pr = *d;
        v = make_float4(pr.x + v.x, pr.y + v.y, pr.z + v.z, pr.w + v.w);
      }
      *d = v;
    }
  }
}

// The backward. u, du [B, 3, N] (read at the last layer, the first walked),
// y, dx [B, 3, N] (written by rank 0 at the end: the rebuilt input and its
// cotangent), carry [C, B, 9, N] f32 scratch (rank r's copy: each point's
// layer input y and dyn = where(mask, dy, dy * es), identical in every
// rank, and the rank's partial of Wx^T dh_0; the next layer's dy is dyn
// plus the ranks' partials in rank order), dld [B], hz [B, K, H]; part
// [clusters, K, per_layer] (the cluster's slice: every rank writes its
// parts) and dhz_part [B, ceil(N / T), K, H] f32 scratch.
template <int H, int NH1>
__global__ void __launch_bounds__(THREADS, 1)
bwd_cluster(const float* __restrict__ u, const float* __restrict__ du, float* __restrict__ y,
            float* __restrict__ dx, float* __restrict__ carry, const float* __restrict__ dld,
            const float* __restrict__ hz, const bf16* __restrict__ wx, const bf16* __restrict__ wh,
            const float* __restrict__ bh, const bf16* __restrict__ wout,
            const float* __restrict__ bout, const float* __restrict__ masks,
            float* __restrict__ part, float* __restrict__ dhz_part, int B, int N, int K,
            float cap) {
  using Q = Cl<H, NH1, true>;
  constexpr int T = Q::T, C = Q::C, W = Q::W, NW = Q::NW, LDH = Q::LDH, LDO = Q::LDO;
  constexpr int LDT = Q::LDT, WM = Q::WM, MP = Q::MP;
  constexpr int XS = round128(T * LDH * 2) / 2, OS = round128(T * LDO * 2) / 2;
  constexpr int RS = round128(CL_HC * LDH * 2) / 2, CS = round128(H * LDO * 2) / 2;
  constexpr int SS = round128(T * 6 * 4) / 4;
  extern __shared__ __align__(128) unsigned char smem[];
  cgrp::cluster_group cl = cgrp::this_cluster();
  const int rank = (int)cl.block_rank(), cid = blockIdx.x / C, clusters = gridDim.x / C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
  const int p = lane & 15, pg = warp % Q::PG, cgp = warp / Q::PG, r0 = pg * 16, c0 = cgp * W;
  const int nt = (N + T - 1) / T, tiles = B * nt;
  constexpr int per_layer = cluster_part_row(H, NH1, Q::SPILL > 0);
  const int oc = rank * CL_HC;   // the rank's first column
  const size_t cstride = (size_t)B * 9 * N;   // floats of one rank's carry
  float* cr = carry + rank * cstride;
  bf16* xch = reinterpret_cast<bf16*>(smem + Q::XCH);
  bf16* hown = reinterpret_cast<bf16*>(smem + Q::HOWN);
  bf16* dh0 = reinterpret_cast<bf16*>(smem + Q::DH0);
  bf16* dstb = reinterpret_cast<bf16*>(smem + Q::DSTB);
  bf16* xkb = reinterpret_cast<bf16*>(smem + Q::XKB);
  float* slot0 = reinterpret_cast<float*>(smem + Q::SLOT0);   // [C][SS]
  float* dhzw = reinterpret_cast<float*>(smem + Q::DHZW);
  auto stage = [&](int s) { return smem + Q::STAGE + s * Q::STAGE_BYTES; };

  cl_zero_pads<H, NH1, true>(smem);
  cl_stage<H, NH1, true>(stage(0), wx, wh, wout, K - 1, rank);
  if constexpr (Q::RING) cl_ring_load<H, NH1>(smem, 0, wh, K - 1, 0, false, rank);
  int sq = 0;   // the ring's slab uses so far
  cl.sync();   // every CTA of the cluster runs before any writes into another
  for (int i = 0; i < K; ++i) {
    const int k = K - 1 - i, s = Q::NST == 2 ? (i & 1) : 0;
    if (Q::NST == 1 && i > 0) {
      __syncthreads();   // every warp is done with the single stage
      cl_stage<H, NH1, true>(stage(0), wx, wh, wout, k, rank);
    }
    cp_async_wait_all();
    // layer k's stage is visible; every rank's carry of layer k + 1 is written
    if (i > 0) cl.sync();
    else __syncthreads();
    if (Q::NST == 2 && i + 1 < K) cl_stage<H, NH1, true>(stage(s ^ 1), wx, wh, wout, k - 1, rank);
    const bf16* swh = reinterpret_cast<const bf16*>(stage(s) + Q::SWH);
    const bf16* swc = reinterpret_cast<const bf16*>(stage(s) + Q::SWC);
    const bf16* wxt = reinterpret_cast<const bf16*>(stage(s) + Q::SWXT);
    const bf16* wo8 = reinterpret_cast<const bf16*>(stage(s) + Q::SWOUT);
    const float* bhk = bh + (size_t)k * NH1 * H + oc + c0;
    float* out = part + ((size_t)cid * K + k) * per_layer;
    bool pass_c[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) pass_c[c] = masks[k * 3 + c] > 0.f;
    float bo[6];
#pragma unroll
    for (int e = 0; e < 6; ++e) bo[e] = bout[k * 6 + e];

    {   // one walk of the layer's tiles
      // acc[q]: dWh_{NH1-1-q}[:, cols] (q < MP, down to matrix SPILL); aw:
      // warps 0-3 dWout[:, cols]^T, warps 4-7 dWx[cols] (an m16 tile each)
      float acc[MP][WM][8][4], aw[4], run[NH1][2], rbout[6];
#pragma unroll
      for (int q = 0; q < MP; ++q)
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[q][mi][ni][e] = 0.f;
#pragma unroll
      for (int e = 0; e < 4; ++e) aw[e] = 0.f;
#pragma unroll
      for (int j = 0; j < NH1; ++j) run[j][0] = run[j][1] = 0.f;
#pragma unroll
      for (int r = 0; r < 6; ++r) rbout[r] = 0.f;

      for (int tile = cid; tile < tiles; tile += clusters) {
        // the layer whose row slab 0 the next tile of the ring uses
        const int knext = tile + clusters < tiles ? k : k - 1;
        const int b = tile / nt, n = (tile % nt) * T + r0 + p;
        const bool valid = n < N;
        const float g_ld = valid ? dld[b] : 0.f;
        float yv[3], dyv[3];
        if (i == 0) {
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            yv[c] = valid ? u[((size_t)b * 3 + c) * N + n] : 0.f;
            dyv[c] = valid ? du[((size_t)b * 3 + c) * N + n] : 0.f;
          }
        } else {
          float pr[C][3];
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            yv[c] = valid ? cr[((size_t)b * 9 + c) * N + n] : 0.f;
            dyv[c] = valid ? cr[((size_t)b * 9 + 3 + c) * N + n] : 0.f;
#pragma unroll
            for (int r = 0; r < C; ++r)
              pr[r][c] = valid ? carry[r * cstride + ((size_t)b * 9 + 6 + c) * N + n] : 0.f;
          }
#pragma unroll
          for (int c = 0; c < 3; ++c) {   // dy = dyn + the ranks' partials in rank order
            float a = pr[0][c];
#pragma unroll
            for (int r = 1; r < C; ++r) a += pr[r][c];
            dyv[c] += a;
          }
        }

        // the forward conditioner, recomputed from the layer output; each
        // level's own columns kept for the masks and the weight gradients.
        // A tile's exchanges, in order: h_1 .. h_{NH1-1} (exchange tile (j -
        // 1) & 1), dh_last (tile 0), dh_{NH1-1} .. dh_1 (tile (NH1 - j) & 1).
        // Two in a row on the same tile (h_{NH1-1} and dh_last at even NH1)
        // have the (s, t) barrier between the reads of the first and the
        // writes of the second; else they alternate, and a rank writes a
        // tile again only after the barrier of the exchange between, which
        // no rank reaches before its reads of the tile are done. The (s, t)
        // slots are written before that barrier and read after it, and
        // rewritten in the next tile after dh_last's. The tile's last
        // barrier (n_hidden >= 3) follows every read of the tile.
        uint32_t a0, a1;
        coord_frag(yv, a0, a1);
        {
          uint32_t lo[NW], hi[NW];
          {
            Rows<H> h;
            first_rows<H>(h, a0, a1, wxt, hz + ((size_t)b * K + k) * H, nullptr);
#pragma unroll
            for (int kc = 0; kc < H / 16; ++kc) {   // the own columns of h_0
              if (kc / 4 != rank || (kc % 4) * 16 / W != cgp) continue;
              bf16* d = hown + (r0 + g) * LDO + (kc % 4) * 16 + 2 * t;
              *reinterpret_cast<uint32_t*>(d) = h.a[kc][0];
              *reinterpret_cast<uint32_t*>(d + 8 * LDO) = h.a[kc][1];
              *reinterpret_cast<uint32_t*>(d + 8) = h.a[kc][2];
              *reinterpret_cast<uint32_t*>(d + 8 * LDO + 8) = h.a[kc][3];
            }
            const bf16* w0 = swh;
            if constexpr (Q::RING) {
              cp_async_wait_all();
              __syncthreads();   // row slab 0 is in the ring
              cl_ring_load<H, NH1>(smem, sq + 1, wh, k, 1, false, rank);
              w0 = cl_ring_buf<H, NH1>(smem, sq++);
            }
            float c[NW][4];
            cl_prod_regs<H, NW>(c, h, w0 + c0 * LDH);
            cl_epi_act<NW>(lo, hi, c, bhk);
          }
          cl_store<NW>(hown + OS + r0 * LDO + c0, LDO, lo, hi);
#pragma unroll
          for (int j = 1; j < NH1; ++j) {   // the deeper levels, exchanged
            bf16* xo = xch + ((j - 1) & 1) * XS + r0 * LDH + oc + c0;
            cl_store<NW>(xo, LDH, lo, hi);
            cl_push<C, W>(xo, LDH, rank);
            if constexpr (Q::RING) cp_async_wait_all();
            cl.sync();   // every rank's columns of h_j (and row slab j in the ring)
            const bf16* wj = swh + j * RS;
            if constexpr (Q::RING) {   // next: row slab j + 1, else the chain's first
              if (j + 1 < NH1) cl_ring_load<H, NH1>(smem, sq + 1, wh, k, j + 1, false, rank);
              else cl_ring_load<H, NH1>(smem, sq + 1, wh, k, NH1 - 1, true, rank);
              wj = cl_ring_buf<H, NH1>(smem, sq++);
            }
            float c[NW][4];
            cl_prod_smem<H, NW, false>(c, xch + ((j - 1) & 1) * XS + r0 * LDH, LDH,
                                       wj + c0 * LDH, LDH);
            cl_epi_act<NW>(lo, hi, c, bhk + j * H);
            cl_store<NW>(hown + (j + 1) * OS + r0 * LDO + c0, LDO, lo, hi);
          }
          if constexpr (Q::WC > 1) __syncthreads();   // every column group's part of h_last
          if (cgp == 0) {
            uint32_t af[4][4];
            if constexpr (Q::WC > 1) cl_load_own(af, hown + NH1 * OS + r0 * LDO);
            else cl_frags<NW>(af, lo, hi);
            float sc[4];
            cl_out_partial(sc, af, wo8);
            cl_slot_push<C>(slot0 + rank * SS, r0, sc);
          }
        }
        cl.sync();   // every rank's (s, t) partials are in every rank's slots

        // the layer input from the closed-form inverse; the coupling cotangents
        float xk[3], dyn[3];
        if (cgp == 0) {
          float st[6], d[6];
          cl_slot_sum<C>(st, slot0, SS, r0 + p);
#pragma unroll
          for (int c = 0; c < 3; ++c) {
            if (pass_c[c]) {
              xk[c] = yv[c];
              d[c] = d[3 + c] = 0.f;
              dyn[c] = dyv[c];
            } else {
              const float th = tanhf((st[c] + bo[c]) / cap), es = expf(cap * th);
              xk[c] = (yv[c] - (st[3 + c] + bo[3 + c])) / es;
              const float ds = dyv[c] * xk[c] * es + g_ld;
              d[c] = ds * (1.f - th * th);
              d[3 + c] = dyv[c];
              dyn[c] = dyv[c] * es;
            }
          }
          if (lane < 16) {
#pragma unroll
            for (int r = 0; r < 6; ++r) dstb[r * LDT + r0 + p] = __float2bfloat16_rn(d[r]);
#pragma unroll
            for (int c = 0; c < 3; ++c) xkb[c * LDT + r0 + p] = __float2bfloat16_rn(xk[c]);
          }
#pragma unroll
          for (int r = 0; r < 6; ++r) {   // dbout over the warp's points
            float v = d[r];
#pragma unroll
            for (int off = 1; off < 16; off <<= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
            rbout[r] += v;
          }
        }
        // rnd(d(s, t)) of the point group (written by its column group 0)
        if constexpr (Q::WC > 1) __syncthreads();
        else __syncwarp();

        // dh_last[:, cols] = (rnd(d(s, t)) Wout[:, cols]) * (h_last > 0)
        {
          const uint16_t* db = reinterpret_cast<const uint16_t*>(dstb);
          a0 = (uint32_t)db[(2 * t) * LDT + r0 + g] |
               ((uint32_t)db[(2 * t + 1) * LDT + r0 + g] << 16);
          a1 = (uint32_t)db[(2 * t) * LDT + r0 + g + 8] |
               ((uint32_t)db[(2 * t + 1) * LDT + r0 + g + 8] << 16);
          float c[NW][4];
#pragma unroll
          for (int q = 0; q < NW; ++q)
#pragma unroll
            for (int e = 0; e < 4; ++e) c[q][e] = 0.f;
          if constexpr (NW >= 4) {
#pragma unroll
            for (int q = 0; q < NW / 4; ++q) {
              uint32_t bq[4];
              ldsm_x4_t(bq, wo8 + (lane & 7) * LDO + c0 + 32 * q + (lane >> 3) * 8);
#pragma unroll
              for (int e = 0; e < 4; ++e) mma8(c[4 * q + e], a0, a1, bq[e]);
            }
          } else {
            uint32_t bq[2];
            ldsm_x2_t(bq, wo8 + (lane & 7) * LDO + c0 + ((lane >> 3) & 1) * 8);
            mma8(c[0], a0, a1, bq[0]);
            mma8(c[1], a0, a1, bq[1]);
          }
          uint32_t lo[NW], hi[NW];
          float kept[2] = {0.f, 0.f};
          cl_epi_mask<NW>(lo, hi, c, hown + NH1 * OS + r0 * LDO + c0, kept);
          run[NH1 - 1][0] += kept[0];
          run[NH1 - 1][1] += kept[1];
          bf16* xo = xch + r0 * LDH + oc + c0;   // dh_{NH1} into exchange tile 0
          cl_store<NW>(xo, LDH, lo, hi);
          cl_push<C, W>(xo, LDH, rank);
        }
        if constexpr (Q::RING) cp_async_wait_all();
        cl.sync();   // every rank's columns of dh_last are in every tile

        // down the hidden levels: dWh_j += dh_{j+1}^T h_j[:, cols] (in
        // registers, or into the slice), dh_j[:, cols] = (dh_{j+1} Wh_j[:,
        // cols]) * (h_j > 0)
#pragma unroll
        for (int j = NH1 - 1; j >= 0; --j) {
          const bf16* xin = xch + ((NH1 - 1 - j) & 1) * XS;   // dh_{j+1}, all columns
          const bf16* hj = hown + j * OS;
          const bf16* wc = swc + j * CS;
          if constexpr (Q::RING) {   // next: column slab j - 1, else the next tile's row slab 0
            if (j > 0) cl_ring_load<H, NH1>(smem, sq + 1, wh, k, j - 1, true, rank);
            else cl_ring_load<H, NH1>(smem, sq + 1, wh, knext, 0, false, rank);
            wc = cl_ring_buf<H, NH1>(smem, sq++);
          }
#pragma unroll
          for (int q = 0; q < MP; ++q) {
            if (j != NH1 - 1 - q || j < Q::SPILL) continue;
#pragma unroll 2
            for (int kk = 0; kk < T / 16; ++kk) {
              uint32_t a[WM][4];
#pragma unroll
              for (int mi = 0; mi < WM; ++mi)
                ldsm_x4_t(a[mi], xin + (16 * kk + (lane & 7) + ((lane >> 4) & 1) * 8) * LDH +
                                     (warp * WM + mi) * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
              for (int ni = 0; ni < 8; ni += 2) {
                uint32_t bq[4];
                ldsm_x4_t(bq, hj + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) * LDO + ni * 8 +
                                  (lane >> 4) * 8);
#pragma unroll
                for (int mi = 0; mi < WM; ++mi) {
                  mma16(acc[q][mi][ni], a[mi], bq[0], bq[1]);
                  mma16(acc[q][mi][ni + 1], a[mi], bq[2], bq[3]);
                }
              }
            }
          }
          if constexpr (Q::SPILL > 0) {
            if (j < Q::SPILL) cl_dwh_tile<H, T>(out + 3 * H + (size_t)j * H * H, xin, hj, oc,
                                                tile == cid);
          }
          float c[NW][4];
          cl_prod_smem<H, NW, true>(c, xin + r0 * LDH, LDH, wc + c0, LDO);
          uint32_t lo[NW], hi[NW];
          float kept[2] = {0.f, 0.f};
          cl_epi_mask<NW>(lo, hi, c, hj + r0 * LDO + c0, kept);
          if (j > 0) {
            run[j - 1][0] += kept[0];
            run[j - 1][1] += kept[1];
            bf16* xo = xch + ((NH1 - j) & 1) * XS + r0 * LDH + oc + c0;
            cl_store<NW>(xo, LDH, lo, hi);
            cl_push<C, W>(xo, LDH, rank);
            if constexpr (Q::RING) cp_async_wait_all();
            cl.sync();
          } else {
            cl_store<NW>(dh0 + r0 * LDO + c0, LDO, lo, hi);
            if (g < NW)   // this tile's dhz: the warp's column sums
              *reinterpret_cast<float2*>(dhzw + warp * CL_HC + c0 + 8 * g + 2 * t) =
                  make_float2(kept[0], kept[1]);
          }
        }
        __syncthreads();   // dh_0's own columns of every warp

        // dy_in's partial of the rank: rnd(dh_0)[:, cols] Wx[cols, :], into
        // its carry beside the layer input and dyn
        if (cgp == 0) {
          uint32_t af[4][4];
          cl_load_own(af, dh0 + r0 * LDO);
          float dc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int kk = 0; kk < 2; ++kk) {
            uint32_t bq[4];
            ldsm_x4(bq, wxt + (lane & 7) * LDH + oc + 32 * kk + (lane >> 3) * 8);
            mma16(dc, af[2 * kk], bq[0], bq[1]);
            mma16(dc, af[2 * kk + 1], bq[2], bq[3]);
          }
          const int nb = (tile % nt) * T + r0 + g;   // the points of rows g and g + 8
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 2 * t + e;
            if (c < 3) {
              float* pc = cr + ((size_t)b * 9 + 6 + c) * N;
              if (nb < N) pc[nb] = dc[e];
              if (nb + 8 < N) pc[nb + 8] = dc[2 + e];
            }
          }
          if (lane < 16 && valid) {
#pragma unroll
            for (int c = 0; c < 3; ++c) {
              cr[((size_t)b * 9 + c) * N + n] = xk[c];
              cr[((size_t)b * 9 + 3 + c) * N + n] = dyn[c];
            }
          }
        }
        // dWout[:, cols]^T += h_last[:, cols]^T rnd(d(s, t)) (warps 0-3),
        // dWx[cols] += rnd(dh_0)[:, cols]^T rnd(x_k) (warps 4-7)
        {
          const int mt = warp & 3;
          const bf16* bsrc = warp < 4 ? dstb : xkb;
          const bf16* asrc = warp < 4 ? hown + NH1 * OS : dh0;
#pragma unroll
          for (int kq = 0; kq < T / 32; ++kq) {
            uint32_t bd[4];
            ldsm_x4(bd, bsrc + (lane & 7) * LDT + 32 * kq + (lane >> 3) * 8);
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const int row = 16 * (2 * kq + hf) + (lane & 7) + ((lane >> 4) & 1) * 8;
              uint32_t a[4];
              ldsm_x4_t(a, asrc + row * LDO + 16 * mt + ((lane >> 3) & 1) * 8);
              mma16(aw, a, bd[2 * hf], bd[2 * hf + 1]);
            }
          }
        }
        // the tile's dhz: the point groups' column sums in order
        for (int e = tid; e < CL_HC; e += THREADS) {
          const int cg = e / W;   // the column group that owns column e
          float a = 0.f;
          for (int q = 0; q < Q::PG; ++q) a += dhzw[(cg * Q::PG + q) * CL_HC + e];
          dhz_part[((size_t)tile * K + k) * H + oc + e] = a;
        }
        // the next tile reuses this CTA's shared tiles (and, with n_hidden
        // >= 3, its recompute writes exchange tiles the others still read)
        if constexpr (NH1 >= 2) cl.sync();
        else __syncthreads();
      }

      // the register-held dWh columns into the cluster's slice
#pragma unroll
      for (int q = 0; q < MP; ++q) {
        const int j = NH1 - 1 - q;
        if (j < Q::SPILL) break;
        float* dwh = out + 3 * H + (size_t)j * H * H;
#pragma unroll
        for (int mi = 0; mi < WM; ++mi)
#pragma unroll
          for (int ni = 0; ni < 8; ++ni) {
            const int o = (warp * WM + mi) * 16 + g, c = oc + ni * 8 + 2 * t;
            *reinterpret_cast<float2*>(dwh + o * H + c) =
                make_float2(acc[q][mi][ni][0], acc[q][mi][ni][1]);
            *reinterpret_cast<float2*>(dwh + (o + 8) * H + c) =
                make_float2(acc[q][mi][ni][2], acc[q][mi][ni][3]);
          }
      }
      // dWx[cols] and dWout[:, cols]
      {
        const int mt = warp & 3, o = oc + 16 * mt + g;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 2 * t + e;
          if (warp >= 4 && c < 3) {
            out[o * 3 + c] = aw[e];
            out[(o + 8) * 3 + c] = aw[2 + e];
          }
          if (warp < 4 && c < 6) {
            float* dwo = out + 3 * H + NH1 * H * H + NH1 * H;
            dwo[c * H + o] = aw[e];
            dwo[c * H + o + 8] = aw[2 + e];
          }
        }
      }
      // dbh[cols] and (rank 0) dbout: each warp's sums, then the point
      // groups in order, through the (now free) own-columns tiles
      __syncthreads();
      float* red = reinterpret_cast<float*>(hown);
      constexpr int RW = NH1 * CL_HC + 8;
      if (g < NW)
#pragma unroll
        for (int j = 0; j < NH1; ++j)
          *reinterpret_cast<float2*>(red + warp * RW + j * CL_HC + c0 + 8 * g + 2 * t) =
              make_float2(run[j][0], run[j][1]);
      if (lane == 0 && cgp == 0)
#pragma unroll
        for (int r = 0; r < 6; ++r) red[warp * RW + NH1 * CL_HC + r] = rbout[r];
      __syncthreads();
      for (int e = tid; e < NH1 * CL_HC + 6; e += THREADS) {
        if (e < NH1 * CL_HC) {
          const int cg = (e % CL_HC) / W;
          float a = 0.f;
          for (int q = 0; q < Q::PG; ++q) a += red[(cg * Q::PG + q) * RW + e];
          out[3 * H + NH1 * H * H + (e / CL_HC) * H + oc + e % CL_HC] = a;
        } else if (rank == 0) {
          float a = 0.f;
          for (int q = 0; q < Q::PG; ++q) a += red[q * RW + e];
          out[3 * H + NH1 * H * H + NH1 * H + 6 * H + (e - NH1 * CL_HC)] = a;
        }
      }
      __syncthreads();   // the next layer's tiles reuse the own-columns tiles
    }
    __threadfence();   // the carry, before the barrier that hands it to the other ranks
  }
  cl.sync();   // every rank's carry of layer 0 is written
  if (rank == 0) {   // the rebuilt input and dx = dyn + the ranks' partials in rank order
    for (int tile = cid; tile < tiles; tile += clusters) {
      const int b = tile / nt;
      for (int e = tid; e < 3 * T; e += THREADS) {
        const int c = e / T, nn = (tile % nt) * T + e % T;
        if (nn >= N) continue;
        const size_t row = ((size_t)b * 9 + c) * N + nn;
        float a = carry[row + 6 * (size_t)N];
#pragma unroll
        for (int r = 1; r < C; ++r) a += carry[r * cstride + row + 6 * (size_t)N];
        y[((size_t)b * 3 + c) * N + nn] = carry[row];
        dx[((size_t)b * 3 + c) * N + nn] = carry[row + 3 * (size_t)N] + a;
      }
    }
  }
}

// clusters of C CTAs, one per SM at most
template <typename Kern, typename... Args>
cudaError_t cl_launch(Kern kern, int clusters, int C, int bytes, cudaStream_t stream,
                      Args... args) {
  cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(clusters * C));
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// the clusters of C CTAs with `bytes` of shared memory each that the card
// holds at once (clusters sit inside one GPC, so fewer than SMs / C): the
// persistent grids' size
template <typename Kern>
int cl_max_clusters(Kern kern, int C, int bytes) {
  if (cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes) != cudaSuccess)
    return -1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = bytes;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = C;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int n = 0;
  if (cudaOccupancyMaxActiveClusters(&n, (const void*)kern, &cfg) != cudaSuccess) return -1;
  return n;
}

template <int H, int NH1>
int cluster_grid(bool backward) {
  return backward ? cl_max_clusters(bwd_cluster<H, NH1>, H / CL_HC, Cl<H, NH1, true>::TOTAL)
                  : cl_max_clusters(fwd_cluster<H, NH1>, H / CL_HC, Cl<H, NH1, false>::TOTAL);
}

template <int H, int NH1>
cudaError_t launch_fwd_cluster(const float* xt, const float* hz, float* u, float* ld_part,
                               float* carry, const void* wx, const void* wh, const float* bh,
                               const void* wout, const float* bout, const float* masks, int B,
                               int N, int K, float cap, int clusters, cudaStream_t stream) {
  using Q = Cl<H, NH1, false>;
  const int groups = (B * ((N + Q::T - 1) / Q::T) + Q::G - 1) / Q::G;
  if (clusters > groups) clusters = groups;
  return cl_launch(fwd_cluster<H, NH1>, clusters, Q::C, Q::TOTAL, stream, xt, hz, u, ld_part,
                   carry, static_cast<const bf16*>(wx), static_cast<const bf16*>(wh), bh,
                   static_cast<const bf16*>(wout), bout, masks, B, N, K, cap);
}

// clusters of the inverse's persistent grid that the card holds at once
template <int H, int NH1>
int inverse_grid() {
  return cl_max_clusters(inv_cluster<H, NH1>, H / CL_HC, Cl<H, NH1, false>::TOTAL);
}

template <int H, int NH1>
cudaError_t launch_inv_cluster(const float* hz, const float* ut, float* out, float* u_out,
                               float* carry, const void* wx, const void* wh, const float* bh,
                               const void* wout, const float* bout, const float* masks, int B,
                               int CR, int N, int K, float cap, unsigned long long seed,
                               float noise_scale, int clusters, cudaStream_t stream) {
  using Q = Cl<H, NH1, false>;
  const int groups = (B * ((N + Q::T - 1) / Q::T) + Q::G - 1) / Q::G;
  if (clusters > groups) clusters = groups;
  return cl_launch(inv_cluster<H, NH1>, clusters, Q::C, Q::TOTAL, stream, hz, ut, out, u_out,
                   carry, static_cast<const bf16*>(wx), static_cast<const bf16*>(wh), bh,
                   static_cast<const bf16*>(wout), bout, masks, B, CR, N, K, cap, seed,
                   noise_scale);
}

template <int H, int NH1>
cudaError_t launch_bwd_cluster(const float* u, const float* du, float* y, float* dx, float* carry,
                               const float* dld, const float* hz, const void* wx, const void* wh,
                               const float* bh, const void* wout, const float* bout,
                               const float* masks, float* part, float* dhz_part, float* dw,
                               float* dhz, int B, int N, int K, float cap, int clusters,
                               cudaStream_t stream) {
  using Q = Cl<H, NH1, true>;
  const int nt = (N + Q::T - 1) / Q::T;
  if (clusters > B * nt) clusters = B * nt;   // every cluster takes a tile of each layer
  cudaError_t e = cl_launch(bwd_cluster<H, NH1>, clusters, Q::C, Q::TOTAL, stream, u, du, y,
                            dx, carry, dld, hz, static_cast<const bf16*>(wx),
                            static_cast<const bf16*>(wh), bh, static_cast<const bf16*>(wout),
                            bout, masks, part, dhz_part, B, N, K, cap);
  if (e != cudaSuccess) return e;
  const long long per_layer = cluster_part_row(H, NH1, Q::SPILL > 0);
  if ((e = launch_reduce(part, dw, 1, clusters, per_layer * K, stream)) != cudaSuccess) return e;
  return launch_reduce(dhz_part, dhz, B, nt, (long long)K * H, stream);
}

}  // namespace dpfx
