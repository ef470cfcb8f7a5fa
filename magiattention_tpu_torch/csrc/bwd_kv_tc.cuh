// The bf16 k-major FFA backward on Hopper's tensor cores, cp.async body,
// shared by the bf16 entries of csrc/ffa_bwd_dkv.cu (B5/B6: dk and dv, the
// split backward's second pass, FUSED false) and csrc/ffa_bwd_fused.cu
// (B8/B9: dk, dv and dq in one pass, FUSED true) for every instance but
// the 64 x 128 ones at d 64 and 128, which run the warp-specialised body of
// csrc/bwd_kv_ws.cuh (kv_bf16::launch routes them). The float32 entries
// keep the CUDA-core body of csrc/bwd_kv.cuh: their 1e-5 gates need float32
// FMA.
//
// What it computes is csrc/bwd_kv.cuh's function: for every kv head and k
// row j, over the live q rows i and the g query heads h of that kv head,
// dv[j] = sum P^T dO and dk[j] = scale * sum dS^T q; with FUSED also
// dq[i] += sum_j dS[i, j] k[j] into a zeroed float32 workspace (the
// wrapper's convert pass scales it). P = exp(s - lse) from the forward's
// natural-log lse, 0 where the lse is -inf or the pair is masked;
// dS = P (dP - delta), times 1 - tanh^2 under a softcap. A k tile no slice
// reaches, and every k row no live pair touches, gets exact zeros; dq of
// an uncovered q row is never added to.
//
// Design at d <= 128 (building blocks in csrc/tc.cuh): one warpgroup a
// 64-row block of the k tile (BK / 64 of them a CTA) owns its K and V in
// shared memory and dk, dv in registers for the CTA's k-major run, and
// writes them once: no atomics. Per (item, q head) step, and per 64-row
// block of a 128-row q tile: S^T = K Q^T and dP^T = V dO^T by wgmma
// m64n64k16; P^T and dS^T in registers, each split into bf16 hi + lo A
// fragments (tc.cuh:to_a_frags_split); dV += P^T dO and dK += dS^T Q
// (m64nDk16, A from registers), each as two products, hi then lo: dk and dv
// sum over every q row and head that sees a k row (all 32768 of them for a
// global token under a sink-window mask), where one bf16 rounding of P and
// dS alone leaves them 2^-9 relative, up to 2e-2 absolute, from float32.
// FUSED: dS^T (hi) stored once to shared memory, then dQ = dS K in
// 64-column halves, each added to the workspace with vector atomics (one
// 16-byte red.add per lane and 8-column chunk), rows outside the item
// skipped. Both instances run the dk/dv products in the same order on the
// same fragments, so the split dk/dv equals the fused kernel's to the bit,
// and bwd_kv_ws.cuh keeps that order. The next step's Q, dO, lse and delta
// are double-buffered by cp.async, which every thread issues and waits for.
//
// Head dim 256: no column split. Full-width dk and dv (2 x 128 floats a
// thread) do not fit one warpgroup, so a CTA runs two consumer warpgroups
// on one 64-row k tile, each owning one 128-column half of dk and dv (64 +
// 64 floats a thread) and, with FUSED, the same half of dq's atomics. Per
// step S^T and dP^T are computed once, split between the warpgroups along
// the q rows: each runs m64n32k16 over the full 256 depth (16 k-steps) for
// its 32 q rows. Each writes its columns of P^T and dS^T, hi and lo (the
// to_a_frags_split scheme, the same rounding), as four bf16 64 x 64
// swizzled tiles in shared memory; one barrier; then both read the whole
// tiles as wgmma's A operand from shared memory (m64n128k16, A K-major):
// dV[:, half] += P^T dO[:, half] and dK[:, half] += dS^T Q[:, half] (hi,
// then lo), and with FUSED dQ[:, half] = dS K[:, half] from the dS^T hi
// tile (read transposed), in two 64-column pieces. Shared memory: K and V
// 64 KB, two stages of Q and dO 128 KB, the four P/dS tiles 32 KB, two
// stages of lse and delta 1 KB and 1 KB to align the window: 231,424
// bytes, one CTA of 256 threads an SM, 64 x 64 tiles only.
//
// What bounds it on this card: operations on the bf16 tensor cores (989
// TFLOP/s on an H100 SXM): 8 * D flops per live pair and q head for dk/dv
// (the lo products make it 12 * D executed), 10 * D with FUSED (14 * D
// executed), then the dq atomics, 64 * D float32 adds per (item, q head).
// Shared memory at d <= 128: K and V of every warpgroup, two stages of Q
// and dO and of lse and delta, with FUSED each warpgroup's dS^T tile
// (108,544 bytes at D = 128, 64 x 64: two CTAs an SM).
#pragma once

#include "tc.cuh"

namespace {
namespace kv_tc {

using namespace magi::tc;
using magi::LOG2E;
using magi::META_DIM;

// D = 256: two warpgroups on one 64-row k tile, one a column half
template <int D>
constexpr bool WIDE = D > 128;

// the warpgroups: BK / 64, each owning 64 key rows; at D = 256 the two
// column halves
template <int D, int BK>
constexpr int NWG = WIDE<D> ? 2 : BK / 64;

template <int D, bool FUSED, int BQ = 64, int BK = 64>
struct Smem {
  static constexpr uint32_t TILE = 64 * D * 2;   // K or V of 64 key rows
  static constexpr uint32_t QT = BQ * D * 2;     // Q or dO of a stage
  static constexpr uint32_t QDO = (BK / 64) * 2 * TILE;  // [2 stages][Q, dO]
  // D = 256: [P^T hi, P^T lo, dS^T hi, dS^T lo], BK x BQ bf16 each; else
  // with FUSED [WG] dS^T, 64 x 64 bf16
  static constexpr uint32_t DS = QDO + 4 * QT;
  static constexpr uint32_t DS_BYTES =
      WIDE<D> ? 4 * BK * BQ * 2 : (FUSED ? NWG<D, BK> * 64 * 128 : 0);
  static constexpr uint32_t STATS = DS + DS_BYTES;  // [2 stages][lse, delta]
  static constexpr size_t bytes = STATS + 2 * 2 * BQ * 4 + 1024;
};

template <int D, bool FUSED, int BQ, int BK>
__global__ void __launch_bounds__(128 * NWG<D, BK>, 1)
    ffa_bwd_kv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            float* __restrict__ dq_acc,
                            const int* __restrict__ work_qt_t,
                            const int* __restrict__ meta_t,
                            const int* __restrict__ run_ptr_t, int sq, int sk,
                            int hq, int hk, float scale, float softcap) {
  using S = Smem<D, FUSED, BQ, BK>;
  constexpr bool WD = WIDE<D>;
  static_assert(!WD || (BQ == 64 && BK == 64), "D = 256 takes 64 x 64 tiles");
  constexpr int NT = 128 * NWG<D, BK>;
  constexpr int W = WD ? D / 2 : D;  // dk / dv columns of a warpgroup
  constexpr int NACC = W / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  // one warpgroup (a 64-row k tile): warpgroup 0, known at compile time
  const int tid = threadIdx.x;
  const int wg = NWG<D, BK> > 1 ? tid >> 7 : 0;
  const int t = NWG<D, BK> > 1 ? tid & 127 : tid;
  // the warpgroup's column half at D = 256, and its first panel's offset
  // in a D-wide tile of 64 rows (K) and of BQ rows (Q, dO)
  const int ch = WD ? wg : 0;
  const uint32_t chp = ch * (W / 64) * PANEL_BYTES;
  const uint32_t chq = ch * (W / 64) * (BQ * 128);
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // k rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);  // q columns c0, c0 + 1 of each chunk
  const int kt = blockIdx.x, hkv = blockIdx.y, g = hq / hk;
  // this warpgroup's first key row, and its K and V (D = 256: the CTA's)
  const int k0 = kt * BK + (WD ? 0 : wg * 64);
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;
  const uint32_t Kw = base + (WD ? 0 : wg * 2 * S::TILE);

  // K at Kw, V at Kw + TILE, for the whole run
  if constexpr (WD) {
    load_tile_async<D, NT>(Kw, k + ((long)k0 * hk + hkv) * D, kv_rs,
                           min(64, sk - k0), tid);
    load_tile_async<D, NT>(Kw + S::TILE, v + ((long)k0 * hk + hkv) * D,
                           kv_rs, min(64, sk - k0), tid);
  } else {
    load_tile_async<D, 128>(Kw, k + ((long)k0 * hk + hkv) * D, kv_rs,
                            min(64, sk - k0), t);
    load_tile_async<D, 128>(Kw + S::TILE, v + ((long)k0 * hk + hkv) * D,
                            kv_rs, min(64, sk - k0), t);
  }
  cp_async_commit();

  const int w_end = run_ptr_t[kt + 1];
  auto next_real = [&](int w) {  // skip dummy items of an unreached tile
    while (w < w_end && magi::Item(meta_t + (long)w * META_DIM).empty()) ++w;
    return w;
  };
  auto load_step = [&](int w, int gi, int stage) {
    const int q0 = work_qt_t[w] * BQ, h = hkv * g + gi;
    const uint32_t Qs = base + S::QDO + 2 * stage * S::QT;
    const long off = ((long)q0 * hq + h) * D;
    const int tt = (int)opaque(tid);  // per-chunk addresses are not kept
    load_tile_async<D, NT, BQ>(Qs, q + off, q_rs, min(BQ, sq - q0), tt);
    load_tile_async<D, NT, BQ>(Qs + S::QT, dout + off, q_rs,
                               min(BQ, sq - q0), tt);
    if (tt < BQ) {  // rows past sq: zeros, never live
      const int row = q0 + tt;
      const bool ok = row < sq;
      const uint32_t st = base + S::STATS + stage * (8 * BQ) + tt * 4;
      cp_async4(st, ok ? lse + (long)row * hq + h : lse, ok);
      cp_async4(st + 4 * BQ, ok ? delta + (long)row * hq + h : delta, ok);
    }
  };

  int w = next_real(run_ptr_t[kt]), gi = 0;
  if (w < w_end) load_step(w, 0, 0);
  cp_async_commit();

  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const bool capped = softcap > 0.f;
  const float qk_scale = capped ? scale : scale * LOG2E;

  int stage = 0;
  while (w < w_end) {
    int wn = w, gn = gi + 1;
    if (gn == g) {
      gn = 0;
      wn = next_real(w + 1);
    }
    if (wn < w_end) load_step(wn, gn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // K, V and this step's Q, dO, lse, delta landed
    fence_async_smem();
    __syncthreads();

    const magi::Item item(meta_t + (long)w * META_DIM);
    const int h = hkv * g + gi;
#pragma unroll 1
    for (int blk = 0; blk < BQ / 64; ++blk) {  // the q tile's 64-row blocks
      const int q0 = work_qt_t[w] * BQ + 64 * blk;
      // the K, V and dS^T descriptors are rebuilt every step, not hoisted;
      // block blk of Q and dO: its rows 64 blk .., 8 KB into a panel
      const uint32_t Ks = opaque(Kw), Vs = Ks + S::TILE;
      const uint32_t Qs = base + S::QDO + 2 * stage * S::QT + blk * 8192;
      const uint32_t dOs = Qs + S::QT;
      const float* Ls = reinterpret_cast<const float*>(
                            smem + S::STATS + stage * (8 * BQ)) + 64 * blk;
      const float* Dls = Ls + BQ;

      if constexpr (WD) {
        // S^T and dP^T once a step: this warpgroup's 32 q rows (columns
        // 32 wg .. of the tile), k rows r0, r0 + 8 of the 64
        const uint32_t Pt = base + S::DS;  // P^T hi, lo, dS^T hi, lo: 8 KB
        float st[16], dpt[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) st[i] = dpt[i] = 0.f;
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n32_t00(st, desc_k(Ks, kk), desc_k<BQ>(Qs + wg * 4096, kk), 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n32_t00(dpt, desc_k(Vs, kk), desc_k<BQ>(dOs + wg * 4096, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const int row = r0 + ((i >> 1) & 1) * 8;              // k row
          const int col = 32 * wg + (i >> 2) * 8 + c0 + (i & 1);  // q row
          const float lv = Ls[col];
          float x = st[i] * qk_scale, dcap = 1.f;
          if (capped) {
            const float th = tanhf(x / softcap);
            x = softcap * th;
            dcap = 1.f - th * th;
          }
          const bool live = lv != -INFINITY &&
                            (item.full || item.live(q0 + col, k0 + row));
          const float p =
              live ? (capped ? expf(x - lv) : exp2f(x - lv * LOG2E)) : 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - Dls[col]) * dcap;
        }
        // P^T and dS^T, each as hi = bf16(x) and lo = bf16(x - hi), into
        // this warpgroup's 32 columns of the four tiles
        const int rr = (int)opaque(r0), cc = 32 * wg + (int)opaque(c0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const uint32_t off = tile_offset(rr + 8 * hh, cc + 8 * j);
            const int i = 4 * j + 2 * hh;
            const float x[4] = {st[i], st[i + 1], dpt[i], dpt[i + 1]};
#pragma unroll
            for (int m = 0; m < 2; ++m) {
              __nv_bfloat162 hb = __floats2bfloat162_rn(x[2 * m], x[2 * m + 1]);
              const float2 hf = __bfloat1622float2(hb);
              uint8_t* tile = smem + S::DS + m * 16384 + off;
              *reinterpret_cast<uint32_t*>(tile) =
                  *reinterpret_cast<uint32_t*>(&hb);
              *reinterpret_cast<uint32_t*>(tile + 8192) =
                  pack_bf16(x[2 * m] - hf.x, x[2 * m + 1] - hf.y);
            }
          }
        fence_async_smem();  // the tiles are visible to wgmma
        __syncthreads();     // both warpgroups' columns are in

        // dV[:, half] += P^T dO[:, half], dK[:, half] += dS^T Q[:, half],
        // each hi then lo, A K-major from the tiles
        fence_regs(dv_acc);
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int lo = 0; lo < 2; ++lo)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n128_t01(dv_acc, desc_k(Pt + lo * 8192, kk),
                              desc_mn<BQ>(dOs + chq, kk), 1);
#pragma unroll
        for (int lo = 0; lo < 2; ++lo)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n128_t01(dk_acc, desc_k(Pt + 16384 + lo * 8192, kk),
                              desc_mn<BQ>(Qs + chq, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(dk_acc);
      } else {
        float st[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
        fence_regs(st);
        fence_regs(dpt);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64_t00(st, desc_k(Ks, kk), desc_k<BQ>(Qs, kk), 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          wgmma_ss_n64_t00(dpt, desc_k(Vs, kk), desc_k<BQ>(dOs, kk), 1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(st);
        fence_regs(dpt);

#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int row = r0 + ((i >> 1) & 1) * 8;        // k row of the tile
          const int col = (i >> 2) * 8 + c0 + (i & 1);    // q row of the tile
          const float lv = Ls[col];
          float x = st[i] * qk_scale, dcap = 1.f;
          if (capped) {
            const float th = tanhf(x / softcap);
            x = softcap * th;
            dcap = 1.f - th * th;
          }
          const bool live = lv != -INFINITY &&
                            (item.full || item.live(q0 + col, k0 + row));
          const float p =
              live ? (capped ? expf(x - lv) : exp2f(x - lv * LOG2E)) : 0.f;
          st[i] = p;
          dpt[i] = p * (dpt[i] - Dls[col]) * dcap;
        }
        // dV += P^T dO (hi, lo), then dK += dS^T Q (hi, lo): one pair of
        // fragment sets at a time keeps dk, dv and two 64 x 64 blocks the most
        // a thread holds
        uint32_t fh[4][4], fl[4][4];
        to_a_frags_split(fh, fl, st);
        fence_regs(fh);
        fence_regs(fl);
        fence_regs(dv_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_t1<W>(dv_acc, fh[kk], desc_mn<BQ>(dOs + chq, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_t1<W>(dv_acc, fl[kk], desc_mn<BQ>(dOs + chq, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dv_acc);
        fence_regs(fh);
        fence_regs(fl);

        to_a_frags_split(fh, fl, dpt);
        // dS^T (hi) to shared memory, the A operand of dQ = dS K (read
        // transposed)
        if constexpr (FUSED) {
          const int rr = (int)opaque(r0), cc = (int)opaque(c0);
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              *reinterpret_cast<uint32_t*>(
                  smem + S::DS + wg * 8192 +
                  tile_offset(rr + 8 * (e & 1), 16 * kk + 8 * (e >> 1) + cc)) =
                  fh[kk][e];
        }
        fence_regs(fh);
        fence_regs(fl);
        fence_regs(dk_acc);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_t1<W>(dk_acc, fh[kk], desc_mn<BQ>(Qs + chq, kk));
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          wgmma_rs_t1<W>(dk_acc, fl[kk], desc_mn<BQ>(Qs + chq, kk));
        wgmma_commit();
        if constexpr (FUSED) {
          fence_async_smem();  // the dS^T tile is visible to wgmma
          __syncthreads();
        }
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(fh);
        fence_regs(fl);

      }
      if constexpr (FUSED) {  // dQ = dS K, added to the workspace
        // dS^T (hi): D = 256 the shared tile, else this warpgroup's
        const uint32_t dSs = base + S::DS + (WD ? 16384 : wg * 8192);
#pragma unroll
        for (int half = 0; half < W / 64; ++half) {
          float dq[32];
#pragma unroll
          for (int i = 0; i < 32; ++i) dq[i] = 0.f;
          fence_regs(dq);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64_t11(dq, desc_mn(dSs, kk),
                             desc_mn(Ks + chp + half * PANEL_BYTES, kk), 1);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(dq);
          // lanes 2j, 2j + 1 swap a row pair: the even lane then holds 4
          // columns of the first row, the odd lane 4 of the second
          const bool odd = lane & 1;
          const int row = q0 + r0 + (odd ? 8 : 0);
          const bool add = row < sq && row >= item.qs && row < item.qe;
          float* dst = dq_acc + ((long)row * hq + h) * D + ch * W + half * 64 +
                       2 * (lane & 2);
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float s0 = odd ? dq[4 * j] : dq[4 * j + 2];
            const float s1 = odd ? dq[4 * j + 1] : dq[4 * j + 3];
            const float x0 = __shfl_xor_sync(0xffffffffu, s0, 1);
            const float x1 = __shfl_xor_sync(0xffffffffu, s1, 1);
            const float4 val =
                odd ? make_float4(x0, x1, dq[4 * j + 2], dq[4 * j + 3])
                    : make_float4(dq[4 * j], dq[4 * j + 1], x0, x1);
            if (add) atomicAdd(reinterpret_cast<float4*>(dst + 8 * j), val);
          }
        }
      }
      if constexpr (FUSED) {  // the next block rewrites the dS^T tiles
        if (blk + 1 < BQ / 64) __syncthreads();
      }
    }
    __syncthreads();  // this stage (and the dS^T tile) are free
    w = wn;
    gi = gn;
    stage ^= 1;
  }
  cp_async_wait<0>();  // an unreached tile loaded K, V and nothing else

  // one write per (k tile, kv head); the scale folds into dk here
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k0 + r0 + 8 * hh;
    if (row >= sk) continue;
    float* ok = dk + ((long)row * hk + hkv) * D + ch * W;
    float* ov = dv + ((long)row * hk + hkv) * D + ch * W;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      *reinterpret_cast<float2*>(ok + 8 * j + c0) = make_float2(
          dk_acc[4 * j + 2 * hh] * scale, dk_acc[4 * j + 2 * hh + 1] * scale);
      *reinterpret_cast<float2*>(ov + 8 * j + c0) =
          make_float2(dv_acc[4 * j + 2 * hh], dv_acc[4 * j + 2 * hh + 1]);
    }
  }
}

template <int D, bool FUSED, int BQ = 64, int BK = 64>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dk, float* dv,
           float* dq_acc, const int* work_qt_t, const int* meta_t,
           const int* run_ptr_t, int sq, int sk, int hq, int hk,
           int num_k_tiles, float scale, float softcap, void* stream) {
  if constexpr (Smem<D, FUSED, BQ, BK>::bytes > magi::SMEM_LIMIT) {
    return (int)cudaErrorInvalidValue;  // not compiled: the CTA does not fit
  } else {
    static magi::SmemAllowed smem_ok;
    const size_t smem = Smem<D, FUSED, BQ, BK>::bytes;
    cudaError_t e = magi::allow_smem(ffa_bwd_kv_tc_kernel<D, FUSED, BQ, BK>,
                                     smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(num_k_tiles, hk);
    ffa_bwd_kv_tc_kernel<D, FUSED, BQ, BK>
        <<<grid, 128 * NWG<D, BK>, smem, (cudaStream_t)stream>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<const __nv_bfloat16*>(dout), lse, delta, dk, dv,
            dq_acc, work_qt_t, meta_t, run_ptr_t, sq, sk, hq, hk, scale,
            softcap);
    return (int)cudaGetLastError();
  }
}

// The shared memory of an instance, 0 where it is not compiled.
template <int D, bool FUSED, int BQ, int BK>
constexpr long smem_bytes() {
  return Smem<D, FUSED, BQ, BK>::bytes > magi::SMEM_LIMIT
             ? 0
             : (long)Smem<D, FUSED, BQ, BK>::bytes;
}

}  // namespace kv_tc
}  // namespace
