// The bf16 NSA block-sparse kernels on Hopper's tensor cores: the forward
// of csrc/block_sparse_fwd.cu (B13) and the two walks of
// csrc/block_sparse_bwd.cu (B14: dq query-major, dk/dv key-major). The
// float32 entries keep their CUDA-core bodies (block_sparse_fwd.cu,
// block_sparse_bwd.cu): the 1e-5 gates need float32 FMA.
//
// What they compute is the float32 bodies' function over a chunk table
// (csrc/block_sparse.cuh): per (kv head h, q block b), the block's query
// rows attend the n_keys = C * ds keys its table row names, in table order,
// a chunk named twice counting twice.
//
// Design (building blocks in csrc/tc.cuh; the structure of
// csrc/ffa_fwd_tc.cuh, csrc/ffa_bwd_dq_tc.cuh and csrc/bwd_kv_tc.cuh with
// FUSED false, whose results this header leaves untouched). One warpgroup
// (128 threads) a CTA; every tile is 64 rows of bf16 in 128-byte-swizzled
// shared memory, filled by cp.async 16-byte copies with per-row source
// addresses (gather_pair_async): Hopper's TMA has no row gather.
// - Forward, one CTA per 64 query rows of a (kv head, q block): the Q tile
//   gathered once by RowMap; each step's 64 key rows gathered through the
//   table (SlotMap) into K and V tiles, double-buffered; S = Q K^T by
//   wgmma, the online softmax in registers in the exp2 domain, key slots
//   past n_keys at -inf (no finite mask value), P in registers as the A
//   operand of O += P V. A row with no key gives out 0 and lse -inf.
// - dq walk, the same CTA and steps: S = Q K^T and dP = dO V^T, dS = P (dP
//   - delta) in registers, dQ += dS K with dS as the A operand (one bf16
//   rounding of dS, as B3: a row sums C * ds terms of one head). dq is
//   written once.
// - dk/dv walk, one CTA per 64 consecutive key rows of one kv head (the
//   CTAs take the (kv head, key tile) pairs in the order the wrapper gives,
//   most visits first): K and V stay in shared memory and dk, dv in
//   registers. It visits every q block whose table row names a chunk of its
//   tile (the transposed table: kernels/block_sparse.py:key_table) and, per
//   visit, each 64-row tile of the block's r = bq * g query rows: Q, dO,
//   lse and delta gathered by RowMap, and each key row's weight w, the
//   multiplicity of its chunk in that row (0 where the row does not name
//   it, 2 where it names it twice), double-buffered. S^T = K Q^T, dP^T = V
//   dO^T; P^T = w exp(S^T - lse), dS^T = P^T (dP^T - delta); dV += P^T dO
//   and dK += dS^T Q, each as hi + lo products (tc.cuh:to_a_frags_split):
//   a key many q blocks select sums thousands of rows, where one bf16
//   rounding of P and dS leaves them 2^-9 relative from float32. dk and dv
//   are written once. The weight reproduces "a chunk named twice counts
//   twice" term for term, and no walk has an atomic: both are bitwise
//   reproducible.
//
// What bounds them on this card: operations on the bf16 tensor cores (989
// TFLOP/s dense on an H100 SXM): 4 * D flops per (query row, key slot)
// pair forward, 10 * D for the backward's function (the two walks
// recompute S and dP: 4 + 8 * D executed, the lo products 4 * D more).
// Shared memory: forward Q and two stages of K and V, 5 * 64 * D * 2 +
// 1024 bytes (82,944 at D = 128); dq walk Q, dO and two stages of K, V
// (99,328); dk/dv walk K, V and two stages of Q, dO and of lse, delta and
// w (100,864): two CTAs per SM each.
//
// Head dim 256: each kernel takes one 128-column half of what it writes (out,
// dq, dk and dv; the forward and dq walk in grid z = row tile * 2 + half,
// the dk/dv walk in grid y) and keeps the width-128 register plan; S (and
// dP) still run over the full width from shared memory, so each half
// recomputes them, and the half's products read its two 64-column panels
// of K, dO or Q. Shared memory: forward 129 KB (V tiles the half), dq walk
// 193 KB, dk/dv walk 194 KB: one CTA per SM.
#pragma once

#include "block_sparse.cuh"
#include "tc.cuh"

namespace {
namespace bsp_tc {

using namespace magi::tc;
using magi::LN2;
using magi::LOG2E;

// Two 64-row tiles of D bf16 values into the swizzled tiles at dst0 and
// dst1 by cp.async, row r of each from src0 / src1 + off(r) * D (zeros
// where off(r) < 0): a step's K and V, or Q and dO, share their rows, so
// each row's source is computed once. The NT threads t = 0 .. NT - 1 each
// copy 2 * 64 * D / 8 / NT chunks of 16 bytes.
template <int D, int NT, typename Off>
__device__ __forceinline__ void gather_pair_async(
    uint32_t dst0, uint32_t dst1, const __nv_bfloat16* src0,
    const __nv_bfloat16* src1, const Off& off, int t) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  static_assert((64 * CPR) % NT == 0, "chunks must divide among threads");
#pragma unroll
  for (int it = 0; it < 64 * CPR / NT; ++it) {
    const int i = t + it * NT;
    const int r = i / CPR, cc = i % CPR;
    const long o = off(r);
    const bool ok = o >= 0;
    const uint32_t at =
        (cc >> 3) * PANEL_BYTES + r * 128 + (((cc & 7) ^ (r & 7)) << 4);
    cp_async16(dst0 + at, ok ? src0 + o * D + cc * 8 : src0, ok);
    cp_async16(dst1 + at, ok ? src1 + o * D + cc * 8 : src1, ok);
  }
}

// One 64-row tile of W bf16 values into the swizzled tile at dst by
// cp.async, row r from src + off(r) * LD (a W-column chunk of rows LD
// wide), zeros where off(r) < 0.
template <int W, int LD, int NT, typename Off>
__device__ __forceinline__ void gather_async(uint32_t dst,
                                             const __nv_bfloat16* src,
                                             const Off& off, int t) {
  constexpr int CPR = W / 8;  // 16-byte chunks a row
  static_assert((64 * CPR) % NT == 0, "chunks must divide among threads");
#pragma unroll
  for (int it = 0; it < 64 * CPR / NT; ++it) {
    const int i = t + it * NT;
    const int r = i / CPR, cc = i % CPR;
    const long o = off(r);
    const bool ok = o >= 0;
    cp_async16(dst + (cc >> 3) * PANEL_BYTES + r * 128 +
                   (((cc & 7) ^ (r & 7)) << 4),
               ok ? src + o * LD + cc * 8 : src, ok);
  }
}

// The (S, hk) row of key slot k0 + r of a table row (keys in table order),
// -1 past n_keys: what step_keys (csrc/block_sparse.cuh) computes, per
// thread, so the gathered copies need no shared key list.
struct SlotMap {
  const int* tbl_row;
  int k0, n_keys, ds, hk, h;

  __device__ __forceinline__ long operator()(int r) const {
    const int f = k0 + r;
    if (f >= n_keys) return -1;
    return (long)(__ldg(tbl_row + f / ds) * ds + f % ds) * hk + h;
  }
};

template <int D>
struct FwdSmem {
  static constexpr uint32_t TILE = 64 * D * 2;                  // Q or K
  static constexpr uint32_t STAGE = TILE + 64 * BSP_DV<D> * 2;  // K, V
  static constexpr uint32_t KV = TILE;  // [2 stages][K, V] after Q
  // + 1024: the dynamic window is rounded up to a 1024-byte boundary
  static constexpr size_t bytes = KV + 2 * STAGE + 1024;
};

template <int D>
__global__ void __launch_bounds__(128, 1)
    bsp_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      const int* __restrict__ tbl,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, int hq, int hk, int bq,
                      int n_qb, int C, int ds, float scale) {
  using S = FwdSmem<D>;
  constexpr int W = BSP_DV<D>;  // out columns of this CTA
  constexpr int NCH = BSP_NCH<D>;
  constexpr int NACC = W / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // rows r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane & 3);  // columns c0, c0 + 1 of each 8-col chunk
  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = (int)(blockIdx.z / NCH) * 64;
  const int ch = NCH > 1 ? (int)(blockIdx.z % NCH) : 0;  // the column half
  const int g = hq / hk;
  const RowMap rows{b, h, bq, g, hq, bq * g};
  const int n_keys = C * ds;
  const int* tbl_row = tbl + ((long)h * n_qb + b) * C;
  const uint32_t Qs = base;

  {  // the Q tile
    const auto row_of = [&](int r) { return rows(row0 + r); };
    constexpr int CPR = D / 8;
#pragma unroll
    for (int it = 0; it < 64 * CPR / 128; ++it) {
      const int i = t + it * 128;
      const int r = i / CPR, cc = i % CPR;
      const long o = row_of(r);
      const bool ok = o >= 0;
      cp_async16(Qs + (cc >> 3) * PANEL_BYTES + r * 128 +
                     (((cc & 7) ^ (r & 7)) << 4),
                 ok ? q + o * D + cc * 8 : q, ok);
    }
  }
  cp_async_commit();
  auto load_kv = [&](int k0, int stage) {
    const uint32_t Ks = base + S::KV + stage * S::STAGE;
    const SlotMap keys{tbl_row, k0, n_keys, ds, hk, h};
    if constexpr (NCH == 1) {
      gather_pair_async<D, 128>(Ks, Ks + S::TILE, k, v, keys, t);
    } else {
      gather_async<D, D, 128>(Ks, k, keys, t);
      gather_async<W, D, 128>(Ks + S::TILE, v + ch * W, keys, t);
    }
  };
  if (n_keys > 0) load_kv(0, 0);
  cp_async_commit();

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float qk_scale = scale * LOG2E;

  int stage = 0;
  for (int k0 = 0; k0 < n_keys; k0 += 64) {
    if (k0 + 64 < n_keys) load_kv(k0 + 64, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q and this step's K, V have landed
    fence_async_smem();
    __syncthreads();

    const uint32_t Ks = base + S::KV + stage * S::STAGE;
    const uint32_t Vs = Ks + S::TILE;
    const bool full = k0 + 64 <= n_keys;

    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64_t00(s, desc_k(Qs, kk), desc_k(Ks, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int col = (i >> 2) * 8 + c0 + (i & 1);  // key slot of the step
      float x = s[i] * qk_scale;
      if (!full && k0 + col >= n_keys) x = -INFINITY;
      s[i] = x;
      rmax[(i >> 1) & 1] = fmaxf(rmax[(i >> 1) & 1], x);
    }
    float m_use[2], alpha[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mx = rmax[hh];
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[hh], mx);
      m_use[hh] = m_new == -INFINITY ? 0.f : m_new;
      alpha[hh] = exp2f(m[hh] - m_use[hh]);  // 0 while the row is empty
      m[hh] = m_new;
      l[hh] *= alpha[hh];
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const float p = exp2f(s[i] - m_use[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[4][4];
    to_a_frags(pa, s);
    fence_regs(pa);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_t1<W>(acc, pa[kk], desc_mn(Vs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    __syncthreads();  // the warpgroup is done with this stage's K and V
    stage ^= 1;
  }
  cp_async_wait<0>();  // a row with no key loaded Q and nothing else

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const long row = rows(row0 + r0 + 8 * hh);
    if (row < 0) continue;
    const bool empty = l[hh] == 0.f;
    __nv_bfloat16* o = out + row * D + ch * W;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float a0 = empty ? 0.f : acc[4 * j + 2 * hh] / l[hh];
      const float a1 = empty ? 0.f : acc[4 * j + 2 * hh + 1] / l[hh];
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + c0) =
          __floats2bfloat162_rn(a0, a1);
    }
    if ((lane & 3) == 0 && ch == 0)
      lse[row] = empty ? -INFINITY : (m[hh] + log2f(l[hh])) * LN2;
  }
}

template <int D>
struct DqSmem {
  static constexpr uint32_t TILE = 64 * D * 2;
  static constexpr uint32_t DO = TILE;      // dO after Q
  static constexpr uint32_t KV = 2 * TILE;  // [2 stages][K, V]
  static constexpr size_t bytes = KV + 4 * TILE + 1024;
};

template <int D>
__global__ void __launch_bounds__(128, 1)
    bsp_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int* __restrict__ tbl, float* __restrict__ dq,
                         int hq, int hk, int bq, int n_qb, int C, int ds,
                         float scale) {
  using S = DqSmem<D>;
  constexpr int W = BSP_DV<D>;  // dq columns of this CTA
  constexpr int NCH = BSP_NCH<D>;
  constexpr int NACC = W / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);
  const int c0 = 2 * (lane & 3);
  const int b = blockIdx.x, h = blockIdx.y;
  const int row0 = (int)(blockIdx.z / NCH) * 64;
  const int ch = NCH > 1 ? (int)(blockIdx.z % NCH) : 0;  // the column half
  const int g = hq / hk;
  const RowMap rows{b, h, bq, g, hq, bq * g};
  const int n_keys = C * ds;
  const int* tbl_row = tbl + ((long)h * n_qb + b) * C;
  const uint32_t Qs = base, dOs = base + S::DO;

  const auto row_of = [&](int r) { return rows(row0 + r); };
  gather_pair_async<D, 128>(Qs, dOs, q, dout, row_of, t);
  cp_async_commit();
  auto load_kv = [&](int k0, int stage) {
    const uint32_t Ks = base + S::KV + 2 * stage * S::TILE;
    const SlotMap keys{tbl_row, k0, n_keys, ds, hk, h};
    gather_pair_async<D, 128>(Ks, Ks + S::TILE, k, v, keys, t);
  };
  if (n_keys > 0) load_kv(0, 0);
  cp_async_commit();

  // lse to the log2 domain; rows past the block have lse = -inf: P = 0
  const float qk_scale = scale * LOG2E;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long row = row_of(r0 + 8 * hh);
    row_lse[hh] = row < 0 ? -INFINITY : lse[row] * LOG2E;
    row_delta[hh] = row < 0 ? 0.f : delta[row];
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  int stage = 0;
  for (int k0 = 0; k0 < n_keys; k0 += 64) {
    if (k0 + 64 < n_keys) load_kv(k0 + 64, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and this step's K, V have landed
    fence_async_smem();
    __syncthreads();

    const uint32_t Ks = base + S::KV + 2 * stage * S::TILE;
    const uint32_t Vs = Ks + S::TILE;
    const bool full = k0 + 64 <= n_keys;

    float s[32], dp[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
    fence_regs(s);
    fence_regs(dp);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64_t00(s, desc_k(Qs, kk), desc_k(Ks, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64_t00(dp, desc_k(dOs, kk), desc_k(Vs, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;
      const int col = (i >> 2) * 8 + c0 + (i & 1);  // key slot of the step
      const bool live =
          row_lse[hh] != -INFINITY && (full || k0 + col < n_keys);
      const float p = live ? exp2f(s[i] * qk_scale - row_lse[hh]) : 0.f;
      dp[i] = p * (dp[i] - row_delta[hh]);
    }

    uint32_t da[4][4];
    to_a_frags(da, dp);
    fence_regs(da);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t1<W>(acc, da[kk],
                     desc_mn(Ks + ch * (W / 64) * PANEL_BYTES, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(da);
    __syncthreads();  // the warpgroup is done with this stage's K and V
    stage ^= 1;
  }
  cp_async_wait<0>();

  // one write per query row; the scale folds in here (dS carries none)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const long row = row_of(r0 + 8 * hh);
    if (row < 0) continue;
    float* o = dq + row * D + ch * W;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<float2*>(o + 8 * j + c0) = make_float2(
          acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
  }
}

template <int D>
struct DkvSmem {
  static constexpr uint32_t TILE = 64 * D * 2;
  static constexpr uint32_t QDO = 2 * TILE;       // [2 stages][Q, dO]
  static constexpr uint32_t STATS = QDO + 4 * TILE;  // [2][lse, delta, w]
  static constexpr size_t bytes = STATS + 2 * 3 * 64 * 4 + 1024;
};

// The key-major dk/dv walk. pairs: the (kv head, key tile) of CTA x is
// order[x] = h * n_tiles + kt; its visits are [vptr[p], vptr[p + 1]) of
// vq (q block) and vmult (M chunk multiplicities each, chunk kt * 64 / ds
// + m of the block's table row).
template <int D>
__global__ void __launch_bounds__(128, 1)
    bsp_bwd_dkv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          const __nv_bfloat16* __restrict__ dout,
                          const float* __restrict__ lse,
                          const float* __restrict__ delta,
                          const int* __restrict__ order,
                          const int* __restrict__ vptr,
                          const int* __restrict__ vq,
                          const int* __restrict__ vmult,
                          float* __restrict__ dk, float* __restrict__ dv,
                          int hq, int hk, int bq, int S, int ds, int M,
                          int n_tiles, float scale) {
  using Sm = DkvSmem<D>;
  constexpr int W = BSP_DV<D>;  // dk / dv columns of this CTA
  constexpr int NACC = W / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  // the column half (grid y), and its first panel's offset in a D-wide tile
  const int ch = BSP_NCH<D> > 1 ? (int)blockIdx.y : 0;
  const uint32_t chp = ch * (W / 64) * PANEL_BYTES;

  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // key rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);  // q columns c0, c0 + 1 of each chunk
  const int pair = order[blockIdx.x];
  const int h = pair / n_tiles, k0 = (pair % n_tiles) * 64;
  const int n_valid = min(64, S - k0);
  const int g = hq / hk, r_total = bq * g;
  const int nrt = (r_total + 63) / 64;  // 64-row tiles of a q block
  const int chunk0 = k0 / ds;
  const long kv_rs = (long)hk * D;

  // K at base, V at base + TILE, for the whole walk
  load_tile_async<D, 128>(base, k + ((long)k0 * hk + h) * D, kv_rs, n_valid,
                          t);
  load_tile_async<D, 128>(base + Sm::TILE, v + ((long)k0 * hk + h) * D, kv_rs,
                          n_valid, t);
  cp_async_commit();

  const int v_beg = vptr[pair];
  const int n_steps = (vptr[pair + 1] - v_beg) * nrt;
  auto load_step = [&](int st, int stage) {
    const int vi = v_beg + st / nrt, row0 = (st % nrt) * 64;
    const RowMap rows{vq[vi], h, bq, g, hq, r_total};
    const auto row_of = [&](int r) { return rows(row0 + r); };
    const uint32_t Qs = base + Sm::QDO + 2 * stage * Sm::TILE;
    const int tt = (int)opaque(t);  // per-chunk addresses are not kept
    gather_pair_async<D, 128>(Qs, Qs + Sm::TILE, q, dout, row_of, tt);
    const uint32_t sa = base + Sm::STATS + stage * 768;
    if (tt < 64) {  // rows past the block: zeros, never live
      const long row = row_of(tt);
      const bool ok = row >= 0;
      cp_async4(sa + tt * 4, ok ? lse + row : lse, ok);
      cp_async4(sa + 256 + tt * 4, ok ? delta + row : delta, ok);
    } else {  // key rows past S: weight 0
      const int j = tt - 64;
      const bool ok = j < n_valid;
      cp_async4(sa + 512 + j * 4,
                ok ? vmult + (long)vi * M + (k0 + j) / ds - chunk0 : vmult,
                ok);
    }
  };

  if (n_steps > 0) load_step(0, 0);
  cp_async_commit();

  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const float qk_scale = scale * LOG2E;

  int stage = 0;
  for (int st = 0; st < n_steps; ++st) {
    if (st + 1 < n_steps) load_step(st + 1, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this step's Q, dO, lse, delta, w landed
    fence_async_smem();
    __syncthreads();

    const int n_live = min(64, r_total - (st % nrt) * 64);
    // the K, V descriptors are rebuilt every step, not hoisted
    const uint32_t Ks = opaque(base), Vs = Ks + Sm::TILE;
    const uint32_t Qs = base + Sm::QDO + 2 * stage * Sm::TILE;
    const uint32_t dOs = Qs + Sm::TILE;
    const float* Ls =
        reinterpret_cast<const float*>(smem + Sm::STATS + stage * 768);
    const float* Dls = Ls + 64;
    const int* Ws = reinterpret_cast<const int*>(Ls + 128);

    float sT[32], dpT[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sT[i] = dpT[i] = 0.f;
    fence_regs(sT);
    fence_regs(dpT);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64_t00(sT, desc_k(Ks, kk), desc_k(Qs, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64_t00(dpT, desc_k(Vs, kk), desc_k(dOs, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sT);
    fence_regs(dpT);

    const float w[2] = {(float)Ws[r0], (float)Ws[r0 + 8]};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hh = (i >> 1) & 1;                  // key row r0 + 8 hh
      const int col = (i >> 2) * 8 + c0 + (i & 1);  // q row of the tile
      const float lv = Ls[col];
      // a key its row does not name (w = 0) may score above the row's
      // lse: exp2 is not taken there
      const bool live = w[hh] != 0.f && col < n_live && lv != -INFINITY;
      const float p =
          live ? w[hh] * exp2f(sT[i] * qk_scale - lv * LOG2E) : 0.f;
      sT[i] = p;
      dpT[i] = p * (dpT[i] - Dls[col]);
    }
    // dV += P^T dO (hi, lo), then dK += dS^T Q (hi, lo)
    uint32_t fh[4][4], fl[4][4];
    to_a_frags_split(fh, fl, sT);
    fence_regs(fh);
    fence_regs(fl);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t1<W>(dv_acc, fh[kk], desc_mn(dOs + chp, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t1<W>(dv_acc, fl[kk], desc_mn(dOs + chp, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(fh);
    fence_regs(fl);

    to_a_frags_split(fh, fl, dpT);
    fence_regs(fh);
    fence_regs(fl);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t1<W>(dk_acc, fh[kk], desc_mn(Qs + chp, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs_t1<W>(dk_acc, fl[kk], desc_mn(Qs + chp, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(fh);
    fence_regs(fl);
    __syncthreads();  // this stage is free
    stage ^= 1;
  }
  cp_async_wait<0>();  // a tile no row names loaded K, V and nothing else

  // one write per (key tile, kv head); the scale folds into dk here
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k0 + r0 + 8 * hh;
    if (row >= S) continue;
    float* ok = dk + ((long)row * hk + h) * D + ch * W;
    float* ov = dv + ((long)row * hk + h) * D + ch * W;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      *reinterpret_cast<float2*>(ok + 8 * j + c0) = make_float2(
          dk_acc[4 * j + 2 * hh] * scale, dk_acc[4 * j + 2 * hh + 1] * scale);
      *reinterpret_cast<float2*>(ov + 8 * j + c0) =
          make_float2(dv_acc[4 * j + 2 * hh], dv_acc[4 * j + 2 * hh + 1]);
    }
  }
}

}  // namespace bsp_tc
}  // namespace
