// The bf16 k-major FFA backward at head dims 64 and 128 on a 128-row k
// tile (64 x 128), warp-specialised for Hopper: B5/B6's dk and dv (FUSED
// false, csrc/ffa_bwd_dkv.cu) and B8/B9's dk, dv and dq (FUSED true,
// csrc/ffa_bwd_fused.cu). The entries send their bf16 64 x 128 instances
// at d 64 and 128 here; every other bf16 instance keeps the cp.async body
// of csrc/bwd_kv_tc.cuh, whose function this is.
//
// What it computes: for every kv head and k row j, over the live q rows i
// and the g query heads of that kv head, dv[j] = sum P^T dO and dk[j] =
// scale * sum dS^T q; with FUSED also dq[i] += sum_j dS[i, j] k[j] into a
// zeroed float32 workspace (the wrapper's convert pass scales it). P =
// exp(s - lse), 0 where the lse is -inf or the pair is masked; dS = P (dP -
// delta), times 1 - tanh^2 under a softcap. A k tile no slice reaches, and
// every k row no live pair touches, gets exact zeros.
//
// Design (building blocks in csrc/tc.cuh and csrc/tma.cuh). One CTA of
// three warpgroups owns one (k tile of 128 rows, kv head), one CTA an SM:
// - warpgroup 0, the producer, drops to 24 registers (setmaxnreg.dec); its
//   first warp loads K and V once by TMA, then walks the same (item, q
//   head) steps as the consumers and fills a ring of Q/dO stages (three,
//   FUSED two): Q and dO of the step's 64 q rows by TMA (one box a
//   64-column panel), the rows' lse and delta (strided in [sq, hq]) by its
//   lanes' cp.async, all completing on the stage's "full" mbarrier; it
//   waits for the stage's "empty" barrier before refilling it;
// - warpgroups 1 and 2, the consumers, rise to 240 registers
//   (setmaxnreg.inc); consumer c owns k rows 64 c .. 64 c + 63 of the tile
//   (its K and V tiles, its dk and dv in registers) and runs, per step, the
//   products of bwd_kv_tc.cuh's 64 x 128 instance in its order: S^T = K
//   Q^T and dP^T = V dO^T (wgmma m64n64k16, operands from shared memory),
//   dV += P^T dO and dK += dS^T Q (m64nDk16, A from registers, each as bf16
//   hi then lo), so dk and dv equal that instance's to the bit, the split
//   kernel's equal the fused kernel's, and both are written once (no
//   atomics). A consumer issues no load and computes no load address: it
//   waits on "full" and, once the step's dK has read the stage, arrives on
//   "empty" (one arrival a warp).
// - The bits hold on a condition: the uncapped exponent's x - lse * LOG2E
//   is contracted by ptxas, and the cp.async body's build takes two
//   contractions within one step (the score's product fused with the lse
//   term, or the lse term's product with the rounded score), element by
//   element; this body keeps its bits only while ptxas makes the same
//   choice for every element here (no single written-out form does:
//   tools/ablate_bwd_kv.py's exp_fma_* candidates move millions). So any
//   change to this header, tc.cuh or the toolchain is held to the parent
//   build's dk/dv bit for bit by `chip_smoke.py --parent`.
// - Inside a consumer, the elementwise pass runs under products in
//   flight: a step issues S^T and dP^T as two commit groups behind the last
//   step's dK, still in flight; once that dK and S^T are in, the last
//   step's stage is released and P^T taken from S^T while dP^T runs
//   (p_pass); once dP^T is in, dS^T is taken in its registers (ds_pass),
//   P^T split into hi/lo A fragments and dV issued; once dV is in, dS^T is
//   split and dK issued, and the step ends without waiting for it.
//   Registers at D = 128: dk and dv (128 a thread), S^T and dP^T (64)
//   through the passes, one hi/lo fragment pair (32) beside them while a
//   split runs, dK's pair in flight across the loop's back edge. With dS^T
//   taken under dV (its fragments live through the pass) ptxas injected a
//   wait (C7517); with dK issued behind the next S^T and dP^T, or its
//   operands in shared memory, the body spilled, serialized its products
//   (C7512) or ran slower (tools/ablate_bwd_kv.py, PERF.md). Capped, the
//   tanh is taken under dP^T and the rest once it is in (th_pass,
//   cap_pass).
// - Between the consumers (ping-pong): two named barriers hand the turn to
//   issue a step's S^T and dP^T from one consumer to the other, so the two
//   consumers' chains keep out of step and one's pass and splits run while
//   the other's products occupy the tensor cores.
// - FUSED: each consumer stores its dS^T (hi) tile in shared memory
//   (double-buffered by step parity) and arrives on the parity's "dS full"
//   mbarrier; in the NEXT step it waits for both tiles and computes its D
//   / 2 columns of dQ = dS K over the CTA's 128 k rows (m64n(D/2)k16, eight
//   k-steps, both operands read MN-major), so the consumers never wait on
//   each other's current step: at d 64 behind the step's dP^T, at d 128
//   behind the step's dK, both waited at the step's end (its 32 registers a
//   thread do not fit beside S^T and dP^T there: ptxas serialized the
//   products, C7512). Once the block is in it arrives on "dS empty" (a tile
//   is rewritten once both consumers' products have read it). The float32
//   block goes to a swizzled staging box (double-buffered) and one thread
//   adds it to the workspace with a TMA bulk reduce (32-column boxes), so
//   the adds leave the consumers' path. A q row outside the item's [qs,
//   qe) is masked in every pair (P = 0, and a full item covers its whole q
//   tile), so its dS row and its dq block row are exact zeros and the add
//   leaves its dq as it was: dq of an uncovered q row stays exactly 0; rows
//   past sq are clipped by the map. The loop is one body for every step:
//   the first step's dQ product reads a tile no step wrote (its "dS full"
//   wait passes on the fresh barrier) and its block is dropped, so no
//   product is issued under a branch (ptxas serializes every wgmma of a
//   loop that does: C7514).
//
// What bounds it on this card: operations on the bf16 tensor cores (989
// TFLOP/s on an H100 SXM), 8 * D flops per live pair and q head for dk/dv,
// 10 * D with FUSED (the lo products make 12 * D and 14 * D executed).
// Shared memory (Smem): K and V 64 KB at D = 128, three Q/dO stages 96 KB
// (FUSED: two, 64 KB, beside the dS^T tiles 32 KB and the dq staging 64
// KB), the lse/delta stages, the barriers and 1024 bytes to align the
// window: 166,528 bytes (FUSED 231,552). A fourth stage timed no faster
// than the third (tools/ablate_bwd_kv.py), nor the third than the second
// in the first body (its three_stages candidate).
#pragma once

#include "bwd_kv_tc.cuh"
#include "tc.cuh"
#include "tma.cuh"

namespace {
namespace kv_ws {

using namespace magi::tc;
using namespace magi::tma;
using magi::LOG2E;
using magi::META_DIM;

constexpr int BQ = 64, BK = 128, NT = 384;
// named barriers: 2 + c, consumer c's own (its dq staging); TURN + c, the
// turn to issue products handed to consumer c
constexpr int TURN = 4;

template <int D, bool FUSED>
struct Smem {
  static constexpr int STAGES = FUSED ? 2 : 3;  // of the Q/dO ring
  static constexpr uint32_t TILE = 64 * D * 2;  // 64 rows of K, V, Q or dO
  static constexpr uint32_t KV = 0;             // [consumer][K, V]
  static constexpr uint32_t QDO = 4 * TILE;     // [stage][Q, dO]
  static constexpr uint32_t DS = QDO + STAGES * 2 * TILE;  // [parity][consumer] dS^T hi
  static constexpr uint32_t DS_BYTES = FUSED ? 4 * 8192 : 0;
  // [use][consumer] float32 dq staging, 64 rows x D / 2 columns each
  static constexpr uint32_t STG = 128 * D;
  static constexpr uint32_t DQ = DS + DS_BYTES;
  static constexpr uint32_t DQ_BYTES = FUSED ? 4 * STG : 0;
  static constexpr uint32_t STATS = DQ + DQ_BYTES;  // [stage][lse, delta]
  static constexpr uint32_t BARS = STATS + STAGES * 2 * BQ * 4;
  // the barriers (below) and the dq blocks' places
  static constexpr size_t bytes = BARS + 128 + 1024;
};

// the barriers: full[STAGES], empty[STAGES], K and V's; FUSED: dS full[2]
// and dS empty[2] (both consumers' dS^T tiles of a step parity written,
// read by both consumers' dQ products); then from + 96 the (q row, head)
// of each consumer's dq blocks, [step parity][consumer]
template <int ST>
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 * s; }
template <int ST>
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) { return bars + 8 * (ST + s); }
template <int ST>
__device__ __forceinline__ uint32_t bar_kv(uint32_t bars) { return bars + 16 * ST; }
template <int ST>
__device__ __forceinline__ uint32_t bar_ds_full(uint32_t bars, int p) { return bars + 16 * ST + 8 + 8 * p; }
template <int ST>
__device__ __forceinline__ uint32_t bar_ds_empty(uint32_t bars, int p) { return bars + 16 * ST + 24 + 8 * p; }
constexpr uint32_t ROWS_AT = 96;

// ---- the elementwise pass in two halves ----
// bwd_kv_tc.cuh's per-element pass, with the same float operations, cut
// where the body waits for dP^T: uncapped, p_pass takes P^T from S^T alone
// (under dP^T) and ds_pass dS^T from P^T and dP^T (under dV); capped,
// th_pass takes the softcap's tanh from S^T alone and cap_pass the rest
// (P^T and dS^T) once dP^T is in, as the tanh's derivative kept across the
// wait would need 32 more registers a thread. Element i is key row r0 +
// ((i >> 1) & 1) * 8 of the consumer's 64 and q row (i >> 2) * 8 + c0 +
// (i & 1) of the step; bit i of `live` says whether the item's slice
// covers the pair (FULL: every bit is set). Scores are in the log2 domain
// unless capped.
template <bool FULL>
__device__ __forceinline__ void p_pass(float (&st)[32], const float* Ls, uint32_t live_bits,
                                       int c0, float scale) {
  const float qk_scale = scale * LOG2E;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = (i >> 2) * 8 + c0 + (i & 1);
    const float lv = Ls[col];
    float x = st[i] * qk_scale;
    const bool live = lv != -INFINITY && (FULL || ((live_bits >> i) & 1u));
    st[i] = live ? exp2f(x - lv * LOG2E) : 0.f;
  }
}

__device__ __forceinline__ void ds_pass(const float (&st)[32], float (&dpt)[32], const float* Dls,
                                        int c0) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = (i >> 2) * 8 + c0 + (i & 1);
    const float p = st[i], dcap = 1.f;
    dpt[i] = p * (dpt[i] - Dls[col]) * dcap;
  }
}

__device__ __forceinline__ void th_pass(float (&st)[32], float scale, float softcap) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    float x = st[i] * scale;
    st[i] = tanhf(x / softcap);
  }
}

template <bool FULL>
__device__ __forceinline__ void cap_pass(float (&st)[32], float (&dpt)[32], const float* Ls,
                                         const float* Dls, uint32_t live_bits, int c0,
                                         float softcap) {
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int col = (i >> 2) * 8 + c0 + (i & 1);
    const float lv = Ls[col];
    const float th = st[i];
    const float x = softcap * th, dcap = 1.f - th * th;
    const bool live = lv != -INFINITY && (FULL || ((live_bits >> i) & 1u));
    const float p = live ? expf(x - lv) : 0.f;
    st[i] = p;
    dpt[i] = p * (dpt[i] - Dls[col]) * dcap;
  }
}

// the item's slice over the thread's 32 pairs of a step, bit i for
// element i (above)
__device__ __forceinline__ uint32_t live_bits(const magi::Item& item, int q0, int k0, int r0,
                                              int c0) {
  uint32_t bits = 0;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = r0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + c0 + (i & 1);
    bits |= (uint32_t)item.live(q0 + col, k0 + row) << i;
  }
  return bits;
}
// ---- end of the two halves ----

// S^T = K Q^T and dP^T = V dO^T of one step, each its own commit group
template <int D>
__device__ __forceinline__ void issue_st_dpt(float (&st)[32], float (&dpt)[32], uint32_t Ks,
                                             uint32_t Vs, uint32_t Qs, uint32_t dOs) {
#pragma unroll
  for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
  fence_regs(st);
  fence_regs(dpt);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64_t00(st, desc_k(Ks, kk), desc_k(Qs, kk), 1);
  wgmma_commit();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) wgmma_ss_n64_t00(dpt, desc_k(Vs, kk), desc_k(dOs, kk), 1);
  wgmma_commit();
}

// acc += A B from registers (hi, then lo fragments), B MN-major: dV += P^T
// dO or dK += dS^T Q, one commit group
template <int D>
__device__ __forceinline__ void issue_hi_lo(float (&acc)[D / 2], uint32_t (&fh)[4][4],
                                            uint32_t (&fl)[4][4], uint32_t B) {
  fence_regs(fh);
  fence_regs(fl);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_t1<D>(acc, fh[kk], desc_mn(B, kk));
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_t1<D>(acc, fl[kk], desc_mn(B, kk));
  wgmma_commit();
}

// BQ_ and BK_ only name the instance's tiles in its symbol, as the other
// FFA bodies' do (chip_smoke.py reads them from the SASS)
template <int D, bool FUSED, int BQ_ = BQ, int BK_ = BK>
__global__ void __launch_bounds__(NT, 1)
    ffa_bwd_kv_ws_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_dq,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dk, float* __restrict__ dv,
                            const int* __restrict__ work_qt_t, const int* __restrict__ meta_t,
                            const int* __restrict__ run_ptr_t, int sq, int sk, int hq, int hk,
                            float scale, float softcap) {
  static_assert(BQ_ == BQ && BK_ == BK && (D == 64 || D == 128), "64 x 128, d 64 or 128");
  using S = Smem<D, FUSED>;
  constexpr int ST = S::STAGES;
  constexpr int NACC = D / 2;  // dk, dv floats a thread
  constexpr int NDQ = D / 4;   // the dq block's (D / 2 columns)
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + S::BARS;
  const int tid = threadIdx.x;
  const int kt = blockIdx.x, hkv = blockIdx.y, g = hq / hk;

  if (tid == 0) {
#pragma unroll
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_full<ST>(bars, s), 33);  // the TMA thread's arrival + 32 lanes' cp.async
      mbar_init(bar_empty<ST>(bars, s), 8);  // one arrival a consumer warp
    }
    mbar_init(bar_kv<ST>(bars), 1);
    if (FUSED) {
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        mbar_init(bar_ds_full<ST>(bars, p), 256);  // every consumer thread
        mbar_init(bar_ds_empty<ST>(bars, p), 256);
      }
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int w_end = run_ptr_t[kt + 1];
  auto next_real = [&](int w) {  // skip dummy items of an unreached tile
    while (w < w_end && magi::Item(meta_t + (long)w * META_DIM).empty()) ++w;
    return w;
  };

  if (tid < 128) {  // ---- the producer ----
    setmaxnreg_dec<24>();
    if (tid >= 32) return;
    const int lane = tid;
    int w = next_real(run_ptr_t[kt]), gi = 0;
    if (w >= w_end) return;  // an unreached tile loads nothing
    if (lane == 0) {
      const uint32_t kv_full = bar_kv<ST>(bars);
      mbar_arrive_expect_tx(kv_full, 4 * S::TILE);
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {
          const uint32_t dst = base + S::KV + 2 * c * S::TILE + p * PANEL_BYTES;
          load_3d(dst, &tm_k, kv_full, 64 * p, hkv, kt * BK + 64 * c);
          load_3d(dst + S::TILE, &tm_v, kv_full, 64 * p, hkv, kt * BK + 64 * c);
        }
    }
    int stage = 0;
    uint32_t phase = 0;
    while (w < w_end) {
      mbar_wait(bar_empty<ST>(bars, stage), phase ^ 1);
      const int q0 = work_qt_t[w] * BQ, h = hkv * g + gi;
      const uint32_t full = bar_full<ST>(bars, stage);
      if (lane == 0) {
        mbar_arrive_expect_tx(full, 2 * S::TILE);
        const uint32_t Qs = base + S::QDO + 2 * stage * S::TILE;
#pragma unroll
        for (int p = 0; p < D / 64; ++p) {
          load_3d(Qs + p * PANEL_BYTES, &tm_q, full, 64 * p, h, q0);
          load_3d(Qs + S::TILE + p * PANEL_BYTES, &tm_do, full, 64 * p, h, q0);
        }
      }
#pragma unroll
      for (int half = 0; half < BQ / 32; ++half) {  // rows past sq: zeros, never live
        const int r = lane + 32 * half, row = q0 + r;
        const bool ok = row < sq;
        const uint32_t st = base + S::STATS + stage * (8 * BQ) + r * 4;
        cp_async4(st, ok ? lse + (long)row * hq + h : lse, ok);
        cp_async4(st + 4 * BQ, ok ? delta + (long)row * hq + h : delta, ok);
      }
      cp_async_mbar_arrive(full);
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
      if (++gi == g) {
        gi = 0;
        w = next_real(w + 1);
      }
    }
    return;
  }

  // ---- the consumers ----
  setmaxnreg_inc<240>();
  const int t = tid & 127;
  // this consumer's index c, read again from threadIdx.x where the step
  // needs it: kept in a register across the loop, it spills at d 128
  auto cw = [] { return (int)(opaque(threadIdx.x) >> 7) - 1; };
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // k rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);           // q columns c0, c0 + 1 of each chunk

  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  // FUSED: the dQ block of step `r` staged and added (its place kept by
  // the consumer's thread 0 in shared memory, by step parity)
  auto add_dq = [&](float (&dq)[NDQ], int r) {
    const int c = cw();
    const int* at = reinterpret_cast<const int*>(smem + S::BARS + ROWS_AT) + 4 * (r & 1) + 2 * c;
    const uint32_t stg = S::DQ + (2 * (r & 1) + c) * S::STG;
    if (t == 0) bulk_wait_read<1>();  // this box's add two steps ago has read it
    bar_sync(2 + c, 128);
    const int rr = (int)opaque(r0), cc = (int)opaque(c0);
#pragma unroll
    for (int j = 0; j < NDQ / 4; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<float2*>(smem + stg + tile_offset32<64>(rr + 8 * hh, 8 * j + cc)) =
            make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
    fence_async_smem();  // the staged box is visible to the bulk reduce
    bar_sync(2 + c, 128);
    if (t == 0) {
#pragma unroll
      for (int b = 0; b < D / 64; ++b)
        reduce_add_3d(&tm_dq, base + stg + b * 8192, c * (D / 2) + 32 * b, at[1], at[0]);
      bulk_commit();
    }
  };

  // FUSED: dQ = dS K of the step before step `it` (this consumer's D / 2
  // columns over the CTA's 128 k rows), once both consumers' dS^T tiles of
  // that step are in, issued as one commit group; before the first step it
  // reads a tile no step wrote (the fresh barrier's wait passes) and the
  // block is dropped
  auto issue_dq = [&](float (&dq)[NDQ], int it) {
    const int pp = (it + 1) & 1;
    mbar_wait(bar_ds_full<ST>(bars, pp), ((it - 1) >> 1) & 1);
    const uint32_t tiles = base + S::DS + pp * 16384;
    const int col = cw() * (D / 2);  // dQ's columns [col, col + D / 2)
#pragma unroll
    for (int i = 0; i < NDQ; ++i) dq[i] = 0.f;
    fence_regs(dq);
    wgmma_fence();
#pragma unroll
    for (int kw = 0; kw < 2; ++kw)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_ss_t11<D / 2>(
            dq, desc_mn(tiles + kw * 8192, kk),
            desc_mn(base + S::KV + 2 * kw * S::TILE + (col >> 6) * PANEL_BYTES + (col & 63) * 2,
                    kk));
    wgmma_commit();
  };

  int w = next_real(run_ptr_t[kt]), gi = 0;
  if (w < w_end) {
    if (cw() == 0) bar_arrive(TURN, 256);  // consumer 0 takes the first turn
    mbar_wait(bar_kv<ST>(bars), 0);
    int stage = 0, it = 0;
    uint32_t phase = 0;
    uint32_t fh[4][4], fl[4][4];  // the last step's dS^T: dK's A operand
    // the item's slice over this thread's pairs of the step, read and
    // tested under the last step's dK (its metadata loads off the path)
    auto step_bits = [&](int w_) {
      const magi::Item item(meta_t + (long)w_ * META_DIM);
      return item.full ? ~0u : live_bits(item, work_qt_t[w_] * BQ, kt * BK + 64 * cw(), r0, c0);
    };
    uint32_t bits = step_bits(w);
    for (; w < w_end; ++it) {
      const int c = cw();
      const uint32_t Ks = opaque(base + S::KV + 2 * c * S::TILE), Vs = Ks + S::TILE;
      const uint32_t Qs = base + S::QDO + 2 * stage * S::TILE, dOs = Qs + S::TILE;
      float st[32], dpt[32];
      [[maybe_unused]] float dq[NDQ];
      mbar_wait(bar_full<ST>(bars, stage), phase);
      bar_sync(TURN + c, 256);  // this consumer's turn
      issue_st_dpt<D>(st, dpt, Ks, Vs, Qs, dOs);
      bar_arrive(TURN + 1 - c, 256);
      wgmma_wait<1>();  // the last step's dK and this S^T are in
      fence_regs(st);
      fence_regs(dk_acc);
      fence_regs(fh);
      fence_regs(fl);
      if (it > 0 && lane == 0)  // this warp is done with the last step's Q, dO
        mbar_arrive(bar_empty<ST>(bars, stage == 0 ? ST - 1 : stage - 1));

      // P^T under dP^T; the softcap is read from the kernel's parameters
      // at each step, not kept in a register across the loop
      const float* Ls = reinterpret_cast<const float*>(smem + S::STATS + stage * (8 * BQ));
      const float* Dls = Ls + BQ;
      const bool full = __all_sync(~0u, bits == ~0u);
      if (softcap > 0.f)
        th_pass(st, scale, softcap);
      else if (full)
        p_pass<true>(st, Ls, bits, c0, scale);
      else
        p_pass<false>(st, Ls, bits, c0, scale);
      // FUSED at d 64: the last step's dQ block behind dP^T (at d 128 its
      // 32 registers a thread do not fit here: it follows this step's dK)
      if constexpr (FUSED && D == 64) issue_dq(dq, it);
      wgmma_wait<0>();  // dP^T (and that block) is in
      fence_regs(dpt);
      if constexpr (FUSED && D == 64) {
        fence_regs(dq);
        mbar_arrive(bar_ds_empty<ST>(bars, (it + 1) & 1));  // done with the last step's tiles
        if (it > 0) add_dq(dq, it - 1);
      }
      if (softcap > 0.f) {
        if (full)
          cap_pass<true>(st, dpt, Ls, Dls, bits, c0, softcap);
        else
          cap_pass<false>(st, dpt, Ls, Dls, bits, c0, softcap);
      } else {
        ds_pass(st, dpt, Dls, c0);
      }

      // dV += P^T dO (hi, lo), then dK += dS^T Q (hi, lo), as bwd_kv_tc.cuh
      to_a_frags_split(fh, fl, st);
      issue_hi_lo<D>(dv_acc, fh, fl, dOs);
      wgmma_wait<0>();
      fence_regs(dv_acc);
      fence_regs(fh);
      fence_regs(fl);
      to_a_frags_split(fh, fl, dpt);
      if constexpr (FUSED) {  // dS^T (hi), the A operand of both consumers' dQ
        const int p = it & 1, cc = cw();
        mbar_wait(bar_ds_empty<ST>(bars, p), ((it - 1) >> 1) & 1);  // read two steps ago
        const int rr = (int)opaque(r0), ccol = (int)opaque(c0);
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            *reinterpret_cast<uint32_t*>(
                smem + S::DS + p * 16384 + cc * 8192 +
                tile_offset(rr + 8 * (e & 1), 16 * kk + 8 * (e >> 1) + ccol)) = fh[kk][e];
        fence_async_smem();  // visible to both consumers' wgmma
        mbar_arrive(bar_ds_full<ST>(bars, p));
        if (t == 0) {  // this step's dq block's place, for its add
          int* at = reinterpret_cast<int*>(smem + S::BARS + ROWS_AT) + 4 * (it & 1) + 2 * cc;
          at[0] = work_qt_t[w] * BQ;
          at[1] = hkv * g + gi;
        }
      }
      issue_hi_lo<D>(dk_acc, fh, fl, Qs);
      if constexpr (FUSED && D == 128) {  // the last step's dQ block behind this dK, both waited
        issue_dq(dq, it);
        wgmma_wait<0>();
        fence_regs(dk_acc);
        fence_regs(fh);
        fence_regs(fl);
        fence_regs(dq);
        mbar_arrive(bar_ds_empty<ST>(bars, (it + 1) & 1));  // done with the last step's tiles
        if (it > 0) add_dq(dq, it - 1);
      }
      if (++stage == ST) {
        stage = 0;
        phase ^= 1;
      }
      if (++gi == g) {
        gi = 0;
        w = next_real(w + 1);
      }
      if (w < w_end) bits = step_bits(w);
    }
    [[maybe_unused]] float dq[NDQ];
    if constexpr (FUSED) issue_dq(dq, it);  // the last step's block
    wgmma_wait<0>();  // the last dK (FUSED: and dQ block) is in
    fence_regs(dk_acc);
    if constexpr (FUSED) {
      fence_regs(dq);
      add_dq(dq, it - 1);
    }
    if (cw() == 0) bar_sync(TURN, 256);  // consumer 1's last hand-over
  }

  // one write per (k tile, kv head); the scale folds into dk here
  const int k0 = kt * BK + 64 * cw();
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = k0 + r0 + 8 * hh;
    if (row >= sk) continue;
    float* ok = dk + ((long)row * hk + hkv) * D;
    float* ov = dv + ((long)row * hk + hkv) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<float2*>(ok + 8 * j + c0) = make_float2(
          dk_acc[4 * j + 2 * hh] * scale, dk_acc[4 * j + 2 * hh + 1] * scale);
      *reinterpret_cast<float2*>(ov + 8 * j + c0) =
          make_float2(dv_acc[4 * j + 2 * hh], dv_acc[4 * j + 2 * hh + 1]);
    }
  }
  if constexpr (FUSED) {
    if (t == 0) bulk_wait<0>();  // every add has landed before the CTA ends
  }
}

template <int D, bool FUSED>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dk, float* dv, float* dq_acc, const int* work_qt_t,
           const int* meta_t, const int* run_ptr_t, int sq, int sk, int hq, int hk,
           int num_k_tiles, float scale, float softcap, void* stream) {
  using S = Smem<D, FUSED>;
  static_assert(S::bytes <= magi::SMEM_LIMIT, "the CTA must fit");
  CUtensorMap tq, tdo, tk, tv, tdq;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_rows(&tq, q, bf16, 2, sq, hq, D, 64, BQ) ||
      !encode_rows(&tdo, dout, bf16, 2, sq, hq, D, 64, BQ) ||
      !encode_rows(&tk, k, bf16, 2, sk, hk, D, 64, 64) ||
      !encode_rows(&tv, v, bf16, 2, sk, hk, D, 64, 64))
    return (int)cudaErrorInvalidValue;
  if (FUSED) {
    if (!encode_rows(&tdq, dq_acc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, sq, hq, D, 32, BQ))
      return (int)cudaErrorInvalidValue;
  } else {
    tdq = tq;  // not read
  }
  static magi::SmemAllowed smem_ok;
  cudaError_t e = magi::allow_smem(ffa_bwd_kv_ws_tc_kernel<D, FUSED>, S::bytes, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_k_tiles, hk);
  ffa_bwd_kv_ws_tc_kernel<D, FUSED><<<grid, NT, S::bytes, (cudaStream_t)stream>>>(
      tq, tdo, tk, tv, tdq, lse, delta, dk, dv, work_qt_t, meta_t, run_ptr_t, sq, sk, hq, hk,
      scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace kv_ws
}  // namespace

namespace {
namespace kv_bf16 {

// The body of each bf16 k-major instance: the warp-specialised one above
// at 64 x 128 and d 64 or 128, bwd_kv_tc.cuh's everywhere else.
template <int D, int BQ, int BK>
constexpr bool WS = D <= 128 && BQ == 64 && BK == 128;

template <int D, bool FUSED, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dk, float* dv, float* dq_acc, const int* work_qt_t,
           const int* meta_t, const int* run_ptr_t, int sq, int sk, int hq, int hk,
           int num_k_tiles, float scale, float softcap, void* stream) {
  if constexpr (WS<D, BQ, BK>)
    return kv_ws::launch<D, FUSED>(q, k, v, dout, lse, delta, dk, dv, dq_acc, work_qt_t,
                                   meta_t, run_ptr_t, sq, sk, hq, hk, num_k_tiles, scale,
                                   softcap, stream);
  else
    return kv_tc::launch<D, FUSED, BQ, BK>(q, k, v, dout, lse, delta, dk, dv, dq_acc,
                                           work_qt_t, meta_t, run_ptr_t, sq, sk, hq, hk,
                                           num_k_tiles, scale, softcap, stream);
}

// The shared memory of an instance, 0 where it is not compiled.
template <int D, bool FUSED, int BQ, int BK>
constexpr long smem_bytes() {
  if constexpr (WS<D, BQ, BK>)
    return (long)kv_ws::Smem<D, FUSED>::bytes;
  else
    return kv_tc::smem_bytes<D, FUSED, BQ, BK>();
}

}  // namespace kv_bf16
}  // namespace
