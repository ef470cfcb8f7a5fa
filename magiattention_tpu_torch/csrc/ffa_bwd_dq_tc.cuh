// The bf16 FFA dq backward on Hopper's tensor cores, shared by the bf16
// entries of csrc/ffa_bwd_dq.cu (B3: one q head per CTA, G = 1) and
// csrc/ffa_bwd_dq_gqa.cu (B4: G q heads of one GQA group per CTA); at d 64
// and 128 their card-default instances (B3 at 128 x 128, B4 at two heads
// of 64 x 128) run csrc/ffa_bwd_dq_ws.cuh instead, bit for bit this body's
// at the same tiles. The float32 entries keep the CUDA-core body of
// csrc/ffa_bwd_dq.cuh: their 1e-5 gate against the plain version needs
// float32 FMA.
//
// What it computes is csrc/ffa_bwd_dq.cuh's function: for every q head h
// and q row i, dq[i] = scale * sum_j dS[i, j] k[j] over the k rows j some
// slice lets row i see, dS = P (dP - delta[i]) (times 1 - tanh^2 under a
// softcap), P = exp(s - lse[i]) from the forward's natural-log lse, 0
// where the pair is masked or lse = -inf (no finite mask value), so a row
// no slice covers gets dq = 0 exactly. The result is float32.
//
// Design at D = 64 and 128 (building blocks in csrc/tc.cuh; the structure
// of the forward, csrc/ffa_fwd_tc.cuh). One CTA owns one q tile and G heads
// of one kv head and loops that q tile's run of the q-major plan, last q
// tile first; each head has its own warpgroup (128 threads) running the
// same per-head code, so B4's rows are bit-identical to B3's. The head's Q
// and dO tiles stay in shared memory for the run; the item's K and V tiles
// are double-buffered by cp.async, loaded once for the G heads. Per item:
// - S = Q K^T and dP = dO V^T by wgmma m64n64k16 (bf16 in, float32
//   accumulate), all four operands read K-major;
// - P and dS in the accumulator registers (q-major: a thread holds two q
//   rows), with the row's lse and delta read once per run;
// - dS rounded to bf16 in registers and fed as wgmma's A operand to
//   dQ += dS K (m64nDk16, K read MN-major: transposed B), as the forward
//   feeds P to O += P V. The q-major accumulator is wgmma's A layout, so
//   dS never goes through shared memory.
// dq stays in registers for the whole run and is written once, scaled:
// no atomics, so the result does not depend on the order CTAs run in (the
// deterministic mode). One bf16 rounding of dS suffices here (a row's dq
// sums at most sk terms of one head; tests/test_torch_tensor_cores.py
// holds it within the bf16 gate at causal 8192 and the sink window),
// where dk/dv (csrc/bwd_kv_tc.cuh) sum over every row and head of a
// group and take hi + lo products.
//
// Tiles (BQ, BK) of 64 or 128 rows. A 128-row q tile is two warpgroups,
// each owning a 64-row half (its Q, dO, lse, delta and dQ), that share
// every K/V stage; it packs no heads (G = 1). A 128-row k tile is loaded
// whole (its rows contiguous in each 64-column panel) and walked as two
// 64-key blocks inside the item, S, dP and dQ += dS K per block: the
// register plan stays the 64 x 64 one (S and dP of n = 128 beside a
// 64-float dQ would leave no room at D = 128).
//
// Head dim 256: no column split, S and dP once an item (the mirror of the
// k-major pass, csrc/bwd_kv_tc.cuh). A full-width dQ (128 floats a thread)
// beside S, dP and dS does not fit one warpgroup, so a CTA runs two
// consumer warpgroups on one 64-row q tile, each owning one 128-column
// half of dQ (64 floats a thread per head). Per item and head S and dP
// are computed once, split between the warpgroups along the keys: each
// runs m64n32k16 over the full 256 depth (16 k-steps) for its 32 keys.
// Each forms P and dS of its keys (softcap, mask, lse = -inf rows: 0) and
// stores dS once as bf16 (the same single round-to-nearest the register
// path makes) into the head's swizzled 64 x 64 tile in shared memory; one
// barrier; then both read the whole tile as wgmma's A operand (K-major)
// for dQ[:, half] += dS K[:, half] (m64n128k16, K read MN-major). Executed
// flops are the bound's 6 * D per live pair and head. 64 x 64 tiles only
// (a 128-row tile doubles a term that has no room). Shared memory: the G
// heads' Q and dO tiles for the run, K and V, a dS tile a head, 1024 to
// align the window:
// - B3 (G = 1): 64 KB + two K/V stages 128 KB + 8 KB + 1 KB = 205,824
//   bytes; the next item's K and V load under this item's products, and
//   an item's S and dP are issued behind the last item's dQ products (two
//   barriers between them: K/V landed, then the last dQ done by both);
// - B4 (G = 2): 128 KB + one K/V stage 64 KB + 16 KB + 1 KB = 214,016
//   bytes. The two column warpgroups walk the two heads in turn on each
//   stage, each holding both heads' half of dQ (2 x 64 floats), and each
//   buffer is refilled once its last reader is done: both heads' dP = dO
//   V^T first, then the next item's V loads under S, dS and dQ; this
//   item's K loads under the dP products. Each head's products run in B3's
//   order on the same tiles, so B4 equals B3 to the bit.
// One CTA of 256 threads an SM either way (__launch_bounds__(256, 1): 255
// registers a thread). Registers: dQ (64 G) beside S (16) and dP (16 G):
// the dQ products read their A operand from shared memory, so no
// fragments are held.
//
// What bounds it on this card: operations, 6 * D flops per live pair and
// head on the bf16 tensor cores (989 TFLOP/s on an H100 SXM). Shared
// memory at D <= 128: the warpgroups' Q and dO tiles and two stages of K
// and V, 2 * G * BQ * D * 2 + 2 * 2 * BK * D * 2 + 1024 bytes (99,328 at
// D = 128, 64 x 64, G = 1: two CTAs per SM; 132,096 at G = 2: one; 197,632
// at 128 x 128). Registers at D <= 128: the dQ accumulator (D / 2 floats a
// thread), S and dP (32 each), dS's A fragments (16).
#pragma once

#include "tc.cuh"

namespace {
namespace dq_tc {

using namespace magi::tc;
using magi::LOG2E;
using magi::META_DIM;

// D = 256: two warpgroups on one 64-row q tile, one a column half of dQ
template <int D>
constexpr bool WIDE = D > 128;

// G heads of one kv head, or (G = 1) the BQ / 64 row halves of one head:
// one warpgroup each; at D = 256 the two column halves
template <int D, int G, int BQ>
constexpr int NWG = WIDE<D> ? 2 : G * (BQ / 64);

template <int D, int G, int BQ = 64, int BK = 64>
struct Smem {
  static constexpr uint32_t TILE = 64 * D * 2;    // Q or dO of 64 rows
  static constexpr uint32_t KT = BK * D * 2;      // K (or V) of a stage
  static constexpr uint32_t DO = G * BQ * D * 2;  // dO tiles after Q tiles
  static constexpr uint32_t KV = 2 * DO;          // [stages][K, V]
  // D = 256 at G = 2: two heads' Q and dO leave room for one K/V stage
  static constexpr int STAGES = WIDE<D> && G > 1 ? 1 : 2;
  static constexpr uint32_t DS = KV + STAGES * 2 * KT;  // D = 256: [G] dS
  // + 1024: the dynamic window is rounded up to a 1024-byte boundary
  static constexpr size_t bytes =
      DS + (WIDE<D> ? G * BQ * BK * 2 : 0) + 1024;
};

template <int D, int G, int BQ, int BK>
__device__ __forceinline__ void dq_narrow(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, const int* __restrict__ work_kt,
    const int* __restrict__ meta, const int* __restrict__ run_ptr, int sq,
    int sk, int hq, int hk, int num_q_tiles, float scale, float softcap) {
  static_assert(G == 1 || BQ == 64, "a 128-row q tile packs no heads");
  using S = Smem<D, G, BQ, BK>;
  constexpr int NT = 128 * NWG<D, G, BQ>;
  constexpr int NACC = D / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // rows r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane & 3);  // columns c0, c0 + 1 of each 8-col chunk
  const int qt = num_q_tiles - 1 - (int)blockIdx.x;
  const int h = blockIdx.y * G + wg % G;
  const int hkv = (int)(blockIdx.y * G) / (hq / hk);
  const int q0 = qt * BQ + (wg / G) * 64;  // this warpgroup's first row
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;
  const uint32_t Qs = base + wg * S::TILE;
  const uint32_t dOs = base + S::DO + wg * S::TILE;

  load_tile_async<D, 128>(Qs, q + ((long)q0 * hq + h) * D, q_rs,
                          min(64, sq - q0), t);
  load_tile_async<D, 128>(dOs, dout + ((long)q0 * hq + h) * D, q_rs,
                          min(64, sq - q0), t);
  cp_async_commit();

  const int w_end = run_ptr[qt + 1];
  auto next_real = [&](int w) {  // skip dummy items of an uncovered tile
    while (w < w_end && magi::Item(meta + (long)w * META_DIM).empty()) ++w;
    return w;
  };
  auto load_kv = [&](int w, int stage) {
    const int k0 = work_kt[w] * BK;
    const uint32_t Ks = base + S::KV + 2 * stage * S::KT;
    const long off = ((long)k0 * hk + hkv) * D;
    load_tile_async<D, NT, BK>(Ks, k + off, kv_rs, min(BK, sk - k0), tid);
    load_tile_async<D, NT, BK>(Ks + S::KT, v + off, kv_rs, min(BK, sk - k0),
                               tid);
  };

  int w = next_real(run_ptr[qt]);
  if (w < w_end) load_kv(w, 0);
  cp_async_commit();

  // softcap-free scores go straight to the log2 domain, and lse with them;
  // with a softcap the tanh runs on the naturally scaled score. Rows past
  // sq and rows no slice covers have lse = -inf: P = 0 there.
  const bool capped = softcap > 0.f;
  const float qk_scale = capped ? scale : scale * LOG2E;
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    const long at = (long)row * hq + h;
    const float l = row < sq ? lse[at] : -INFINITY;
    row_lse[hh] = capped ? l : l * LOG2E;
    row_delta[hh] = row < sq ? delta[at] : 0.f;
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  int stage = 0;
  while (w < w_end) {
    const int wn = next_real(w + 1);
    if (wn < w_end) load_kv(wn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // Q, dO and this item's K, V have landed
    fence_async_smem();
    __syncthreads();

    const magi::Item item(meta + (long)w * META_DIM);
#pragma unroll 1
    for (int j = 0; j < BK / 64; ++j) {  // the tile's 64-key blocks
      const int k0 = work_kt[w] * BK + 64 * j;
      // block j: rows 64 j .. of the tiles, 64 j * 128 bytes into a panel
      const uint32_t Ks = base + S::KV + 2 * stage * S::KT + j * 8192;
      const uint32_t Vs = Ks + S::KT;

      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64_t00(s, desc_k(Qs, kk), desc_k<BK>(Ks, kk), 1);
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        wgmma_ss_n64_t00(dp, desc_k(dOs, kk), desc_k<BK>(Vs, kk), 1);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int hh = (i >> 1) & 1;
        const int row = r0 + hh * 8;                  // q row of the tile
        const int col = (i >> 2) * 8 + c0 + (i & 1);  // k row of the block
        float x = s[i] * qk_scale, dcap = 1.f;
        if (capped) {
          const float th = tanhf(x / softcap);
          x = softcap * th;
          dcap = 1.f - th * th;
        }
        const bool live = row_lse[hh] != -INFINITY &&
                          (item.full || item.live(q0 + row, k0 + col));
        const float p =
            live ? (capped ? expf(x - row_lse[hh]) : exp2f(x - row_lse[hh]))
                 : 0.f;
        dp[i] = p * (dp[i] - row_delta[hh]) * dcap;
      }

      uint32_t da[4][4];
      to_a_frags(da, dp);
      fence_regs(da);
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs_t1<D>(acc, da[kk], desc_mn<BK>(Ks, kk));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
    }
    __syncthreads();  // every warpgroup is done with this stage's K and V
    w = wn;
    stage ^= 1;
  }
  cp_async_wait<0>();  // an uncovered tile loaded Q, dO and nothing else

  // one write per (q tile, head); the scale folds in here (dS carries none)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    if (row >= sq) continue;
    float* o = dq + ((long)row * hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(o + 8 * j + c0) = make_float2(
          acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
  }
}

// dS = P (dP - delta) (times 1 - tanh^2 under a softcap) from S and dP,
// in place of S, for an m64n32 accumulator's elements: q rows row and row
// + 8, keys col + 8 j + {0, 1}. The softcap (CAP) and an item's mask (FULL:
// no pair masked) are template arguments, so the branch is taken once an
// item and not per element.
template <bool CAP, bool FULL>
__device__ __forceinline__ void ds_of(float (&s)[16], const float (&dp)[16],
                                      const float (&lse)[2],
                                      const float (&delta)[2],
                                      const magi::Item& item, int row, int col,
                                      float qk_scale, float softcap) {
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int hh = (i >> 1) & 1;
    float x = s[i] * qk_scale, dcap = 1.f;
    if constexpr (CAP) {
      const float th = tanhf(x / softcap);
      x = softcap * th;
      dcap = 1.f - th * th;
    }
    const bool live =
        lse[hh] != -INFINITY &&
        (FULL || item.live(row + 8 * hh, col + (i >> 2) * 8 + (i & 1)));
    const float p =
        live ? (CAP ? expf(x - lse[hh]) : exp2f(x - lse[hh])) : 0.f;
    s[i] = p * (dp[i] - delta[hh]) * dcap;
  }
}

// D = 256 (the header's design): warpgroup wg owns keys 32 wg .. 32 wg + 31
// of every S and dP and columns 128 wg .. of dQ, for the G heads.
template <int G>
__device__ __forceinline__ void dq_wide(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    float* __restrict__ dq, const int* __restrict__ work_kt,
    const int* __restrict__ meta, const int* __restrict__ run_ptr, int sq,
    int sk, int hq, int hk, int num_q_tiles, float scale, float softcap) {
  constexpr int D = 256, NT = 256;
  using S = Smem<D, G>;
  constexpr bool ONE_STAGE = S::STAGES == 1;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // q rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);  // columns c0, c0 + 1 of each 8-col chunk
  const int qt = num_q_tiles - 1 - (int)blockIdx.x;
  const int h0 = blockIdx.y * G;
  const int hkv = h0 / (hq / hk);
  const int q0 = qt * 64;
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;
  // this warpgroup's 32 key rows of a K or V tile, and its dQ columns'
  // two 64-column panels of K
  const uint32_t keys = wg * 4096, cols = wg * 2 * PANEL_BYTES;

#pragma unroll
  for (int gi = 0; gi < G; ++gi) {
    const long off = ((long)q0 * hq + h0 + gi) * D;
    load_tile_async<D, NT>(base + gi * S::TILE, q + off, q_rs,
                           min(64, sq - q0), tid);
    load_tile_async<D, NT>(base + S::DO + gi * S::TILE, dout + off, q_rs,
                           min(64, sq - q0), tid);
  }
  cp_async_commit();

  const int w_end = run_ptr[qt + 1];
  auto next_real = [&](int w) {  // skip dummy items of an uncovered tile
    while (w < w_end && magi::Item(meta + (long)w * META_DIM).empty()) ++w;
    return w;
  };
  // K (which 0) or V (1) of item w into stage `stage`
  auto load = [&](int w, int stage, int which) {
    const int k0 = work_kt[w] * 64;
    const long off = ((long)k0 * hk + hkv) * D;
    const int tt = (int)opaque(tid);  // per-chunk addresses are not kept
    load_tile_async<D, NT>(base + S::KV + (2 * stage + which) * S::KT,
                           (which ? v : k) + off, kv_rs, min(64, sk - k0),
                           tt);
  };

  int w = next_real(run_ptr[qt]);
  if (w < w_end) {
    load(w, 0, 1);
    if constexpr (!ONE_STAGE) load(w, 0, 0);
  }
  cp_async_commit();

  // as dq_narrow: scores in the log2 domain unless capped; lse = -inf on
  // rows past sq and rows no slice covers
  const bool capped = softcap > 0.f;
  const float qk_scale = capped ? scale : scale * LOG2E;
  float row_lse[G][2], row_delta[G][2];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      const long at = (long)row * hq + h0 + gi;
      const float l = row < sq ? lse[at] : -INFINITY;
      row_lse[gi][hh] = capped ? l : l * LOG2E;
      row_delta[gi][hh] = row < sq ? delta[at] : 0.f;
    }

  float acc[G][64];
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[gi][i] = 0.f;

  // S (16 floats) of head gi against K at Ks: issued, not waited for
  auto issue_s = [&](float (&s)[16], int gi, uint32_t Ks) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32_t00(s, desc_k(base + gi * S::TILE, kk),
                       desc_k(Ks + keys, kk), 1);
  };
  auto issue_dp = [&](float (&dp)[16], int gi, uint32_t Vs) {
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n32_t00(dp, desc_k(base + S::DO + gi * S::TILE, kk),
                       desc_k(Vs + keys, kk), 1);
  };
  // dS of head gi from its S and dP, this warpgroup's 32 keys, rounded
  // once to bf16 into the head's dS tile (q rows by keys, swizzled)
  auto store_ds = [&](float (&s)[16], const float (&dp)[16], int gi,
                      const magi::Item& item, int k0) {
    const int row = q0 + r0, col = k0 + 32 * wg + c0;
    const float(&l)[2] = row_lse[gi];
    const float(&dl)[2] = row_delta[gi];
    if (capped) {
      if (item.full)
        ds_of<true, true>(s, dp, l, dl, item, row, col, qk_scale, softcap);
      else
        ds_of<true, false>(s, dp, l, dl, item, row, col, qk_scale, softcap);
    } else if (item.full) {
      ds_of<false, true>(s, dp, l, dl, item, row, col, qk_scale, softcap);
    } else {
      ds_of<false, false>(s, dp, l, dl, item, row, col, qk_scale, softcap);
    }
    const int rr = (int)opaque(r0), cc = 32 * wg + (int)opaque(c0);
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(
            smem + S::DS + gi * 8192 + tile_offset(rr + 8 * hh, cc + 8 * j)) =
            pack_bf16(s[4 * j + 2 * hh], s[4 * j + 2 * hh + 1]);
  };

  int stage = 0;
  while (w < w_end) {
    const int wn = next_real(w + 1);
    const uint32_t Ks = base + S::KV + 2 * stage * S::KT, Vs = Ks + S::KT;
    const magi::Item item(meta + (long)w * META_DIM);
    const int k0 = work_kt[w] * 64;
    // this item's V (B3: and K) has landed; B4: every warpgroup is done
    // with the last item's K and the dS tiles
    cp_async_wait<0>();
    fence_async_smem();
    __syncthreads();
    if constexpr (ONE_STAGE) {
      load(w, 0, 0);  // K, under the dP products
      cp_async_commit();
      float dp[G][16];
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
#pragma unroll
        for (int i = 0; i < 16; ++i) dp[gi][i] = 0.f;
        fence_regs(dp[gi]);
      }
      wgmma_fence();
#pragma unroll
      for (int gi = 0; gi < G; ++gi) issue_dp(dp[gi], gi, Vs);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int gi = 0; gi < G; ++gi) fence_regs(dp[gi]);
      __syncthreads();  // both warpgroups are done with V
      if (wn < w_end) load(wn, 0, 1);  // the next V, under S, dS and dQ
      cp_async_commit();
      cp_async_wait<1>();  // this item's K has landed
      fence_async_smem();
      __syncthreads();
#pragma unroll
      for (int gi = 0; gi < G; ++gi) {
        float s[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) s[i] = 0.f;
        fence_regs(s);
        wgmma_fence();
        issue_s(s, gi, Ks);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        store_ds(s, dp[gi], gi, item, k0);
      }
    } else {
      // S and dP queue behind the last item's dQ products
      float s[16], dp[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) s[i] = dp[i] = 0.f;
      fence_regs(s);
      fence_regs(dp);
      wgmma_fence();
      issue_s(s, 0, Ks);
      issue_dp(dp, 0, Vs);
      wgmma_commit();
      wgmma_wait<1>();  // this thread's last dQ products are done
      fence_regs(acc[0]);
      __syncthreads();  // every thread's: the other stage and the dS tile are free
      if (wn < w_end) {  // the next item's K and V, under this item's
        load(wn, stage ^ 1, 1);
        load(wn, stage ^ 1, 0);
      }
      cp_async_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      store_ds(s, dp, 0, item, k0);
    }
    fence_async_smem();  // the dS tiles are visible to wgmma
    __syncthreads();     // both warpgroups' keys are in

    // dQ[:, half] += dS K[:, half], A K-major from the dS tile
#pragma unroll
    for (int gi = 0; gi < G; ++gi) fence_regs(acc[gi]);
    wgmma_fence();
#pragma unroll
    for (int gi = 0; gi < G; ++gi)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_n128_t01(acc[gi], desc_k(base + S::DS + gi * 8192, kk),
                          desc_mn(Ks + cols, kk), 1);
    wgmma_commit();
    // B3 waits for them under the next item's S and dP
    if constexpr (ONE_STAGE) wgmma_wait<0>();
#pragma unroll
    for (int gi = 0; gi < G; ++gi) fence_regs(acc[gi]);
    w = wn;
    if constexpr (!ONE_STAGE) stage ^= 1;
  }
  wgmma_wait<0>();
#pragma unroll
  for (int gi = 0; gi < G; ++gi) fence_regs(acc[gi]);
  cp_async_wait<0>();  // an uncovered tile loaded Q, dO and nothing else

  // one write per (q tile, head, column half), scaled
#pragma unroll
  for (int gi = 0; gi < G; ++gi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = q0 + r0 + 8 * hh;
      if (row >= sq) continue;
      float* o = dq + ((long)row * hq + h0 + gi) * D + 128 * wg;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(o + 8 * j + c0) =
            make_float2(acc[gi][4 * j + 2 * hh] * scale,
                        acc[gi][4 * j + 2 * hh + 1] * scale);
    }
}

template <int D, int G, int BQ, int BK>
__global__ void __launch_bounds__(128 * NWG<D, G, BQ>, 1)
    ffa_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v,
                         const __nv_bfloat16* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         float* __restrict__ dq,
                         const int* __restrict__ work_kt,
                         const int* __restrict__ meta,
                         const int* __restrict__ run_ptr, int sq, int sk,
                         int hq, int hk, int num_q_tiles, float scale,
                         float softcap) {
  if constexpr (WIDE<D>) {
    static_assert(BQ == 64 && BK == 64, "D = 256 takes 64 x 64 tiles");
    dq_wide<G>(q, k, v, dout, lse, delta, dq, work_kt, meta, run_ptr, sq, sk,
               hq, hk, num_q_tiles, scale, softcap);
  } else {
    dq_narrow<D, G, BQ, BK>(q, k, v, dout, lse, delta, dq, work_kt, meta,
                            run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                            softcap);
  }
}

// A pair is compiled where the CTA fits; a 128-row q tile packs no heads.
template <int D, int G, int BQ, int BK>
constexpr bool compiled() {
  return Smem<D, G, BQ, BK>::bytes <= magi::SMEM_LIMIT && (G == 1 || BQ == 64);
}

template <int D, int G, int BQ = 64, int BK = 64>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq,
           const int* work_kt, const int* meta, const int* run_ptr, int sq,
           int sk, int hq, int hk, int num_q_tiles, float scale,
           float softcap, void* stream) {
  if constexpr (!compiled<D, G, BQ, BK>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    static magi::SmemAllowed smem_ok;
    const size_t smem = Smem<D, G, BQ, BK>::bytes;
    cudaError_t e =
        magi::allow_smem(ffa_bwd_dq_tc_kernel<D, G, BQ, BK>, smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(num_q_tiles, hq / G);
    ffa_bwd_dq_tc_kernel<D, G, BQ, BK>
        <<<grid, 128 * NWG<D, G, BQ>, smem, (cudaStream_t)stream>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<const __nv_bfloat16*>(dout), lse, delta, dq, work_kt,
            meta, run_ptr, sq, sk, hq, hk, num_q_tiles, scale, softcap);
    return (int)cudaGetLastError();
  }
}

// The shared memory of an instance, 0 where it is not compiled.
template <int D, int G, int BQ, int BK>
constexpr long smem_bytes() {
  return compiled<D, G, BQ, BK>() ? (long)Smem<D, G, BQ, BK>::bytes : 0;
}

}  // namespace dq_tc
}  // namespace
