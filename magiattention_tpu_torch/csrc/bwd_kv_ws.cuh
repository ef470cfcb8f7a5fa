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
//   head) steps as the consumers and fills a ring of two stages: Q and dO
//   of the step's 64 q rows by TMA (one box a 64-column panel), the rows'
//   lse and delta (strided in [sq, hq]) by its lanes' cp.async, all
//   completing on the stage's "full" mbarrier; it waits for the stage's
//   "empty" barrier before refilling it, so it runs up to two steps ahead;
// - warpgroups 1 and 2, the consumers, rise to 240 registers
//   (setmaxnreg.inc); consumer c owns k rows 64 c .. 64 c + 63 of the tile
//   (its K and V tiles, its dk and dv in registers) and runs, per step,
//   exactly the product sequence of bwd_kv_tc.cuh's 64 x 128 instance:
//   S^T = K Q^T and dP^T = V dO^T (wgmma m64n64k16, operands from shared
//   memory), the elementwise pass, dV += P^T dO and dK += dS^T Q (m64nDk16,
//   A from registers, each as bf16 hi then lo), so dk and dv equal that
//   instance's to the bit, the split kernel's equal the fused kernel's, and
//   both are written once (no atomics). The elementwise pass is taken once
//   an item on (softcap, item.full) into template instances with the same
//   float operations. A consumer issues no load and computes no load
//   address: it waits on "full" and, once its products have read the stage,
//   arrives on "empty" (one arrival a warp).
// - FUSED: both consumers store their dS^T (hi) tiles in shared memory
//   (double-buffered by step parity), meet at one named barrier (the
//   producer runs on), and dQ = dS K is one product over the CTA's 128 k
//   rows (m64n64k16, eight k-steps, both operands read MN-major): at d 128
//   consumer c computes columns 64 c .., at d 64 the consumer of the step's
//   parity computes all 64. The float32 block goes to a swizzled staging
//   tile (double-buffered) and one thread adds it to the workspace with a
//   TMA bulk reduce (two 32-column boxes), so the adds leave the consumers'
//   path, one per 64 x 128 pair where bwd_kv_tc.cuh's 64 x 64 instance
//   made two. A q row outside the item's [qs, qe) is masked in every pair
//   (P = 0, and a full item covers its whole q tile), so its dS row and its
//   dq block row are exact zeros and the add leaves its dq as it was: dq of
//   an uncovered q row stays exactly 0; rows past sq are clipped by the map.
//
// What bounds it on this card: operations on the bf16 tensor cores (989
// TFLOP/s on an H100 SXM), 8 * D flops per live pair and q head for dk/dv,
// 10 * D with FUSED (the lo products make 12 * D and 14 * D executed).
// Shared memory (FUSED, D = 128): K and V 64 KB, two Q/dO stages 64 KB,
// the dS^T tiles 32 KB, the dq staging 64 KB, two lse/delta stages, the
// barriers and 1024 bytes to align the window: 231,488 bytes. Registers: a
// consumer thread holds dk and dv (D / 2 each) beside S^T and dP^T (64),
// then one split fragment pair (32), then (FUSED) the dq block (32); the
// rest of a step's state is re-read where it is needed (at 240 a thread,
// every value kept across the loop spills at D = 128).
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

template <int D, bool FUSED>
struct Smem {
  static constexpr uint32_t TILE = 64 * D * 2;  // 64 rows of K, V, Q or dO
  static constexpr uint32_t KV = 0;             // [consumer][K, V]
  static constexpr uint32_t QDO = 4 * TILE;     // [stage][Q, dO]
  static constexpr uint32_t DS = QDO + 4 * TILE;  // [parity][consumer] dS^T hi
  static constexpr uint32_t DS_BYTES = FUSED ? 4 * 8192 : 0;
  // [use][consumer] float32 dq staging, 64 rows x 64 columns each
  static constexpr uint32_t DQ = DS + DS_BYTES;
  static constexpr uint32_t DQ_BYTES = FUSED ? 4 * 16384 : 0;
  static constexpr uint32_t STATS = DQ + DQ_BYTES;  // [stage][lse, delta]
  static constexpr uint32_t BARS = STATS + 2 * 2 * BQ * 4;
  static constexpr size_t bytes = BARS + 64 + 1024;
};

// the barriers: full[2], empty[2], K and V
__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 * s; }
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) { return bars + 16 + 8 * s; }

// P^T and dS^T in place of S^T and dP^T, rows r0 and r0 + 8 (keys of the
// consumer's 64), columns (i >> 2) * 8 + c0 + (i & 1) (q rows of the step):
// bwd_kv_tc.cuh's per-element pass, with the softcap (CAP) and the item's
// mask (FULL) fixed for the item; scores in the log2 domain unless capped
template <bool CAP, bool FULL>
__device__ __forceinline__ void p_ds(float (&st)[32], float (&dpt)[32], const float* Ls,
                                     const float* Dls, const magi::Item& item, int q0,
                                     int k0, int r0, int c0, float scale, float softcap) {
  const float qk_scale = CAP ? scale : scale * LOG2E;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int row = r0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + c0 + (i & 1);
    const float lv = Ls[col];
    float x = st[i] * qk_scale, dcap = 1.f;
    if (CAP) {
      const float th = tanhf(x / softcap);
      x = softcap * th;
      dcap = 1.f - th * th;
    }
    const bool live = lv != -INFINITY && (FULL || item.live(q0 + col, k0 + row));
    const float p = live ? (CAP ? expf(x - lv) : exp2f(x - lv * LOG2E)) : 0.f;
    st[i] = p;
    dpt[i] = p * (dpt[i] - Dls[col]) * dcap;
  }
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
  constexpr int NACC = D / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + S::BARS, kv_full = bars + 32;
  const int tid = threadIdx.x;
  const int kt = blockIdx.x, hkv = blockIdx.y, g = hq / hk;

  if (tid == 0) {
    mbar_init(bar_full(bars, 0), 33);  // the TMA thread's arrival + 32 lanes' cp.async
    mbar_init(bar_full(bars, 1), 33);
    mbar_init(bar_empty(bars, 0), 8);  // one arrival a consumer warp
    mbar_init(bar_empty(bars, 1), 8);
    mbar_init(kv_full, 1);
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
    for (int it = 0; w < w_end; ++it) {
      const int stage = it & 1;
      mbar_wait(bar_empty(bars, stage), ((it >> 1) & 1) ^ 1);
      const int q0 = work_qt_t[w] * BQ, h = hkv * g + gi;
      const uint32_t full = bar_full(bars, stage);
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
  const int c = cw();
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // k rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);           // q columns c0, c0 + 1 of each chunk
  const int k0 = kt * BK + 64 * c;
  const uint32_t Kw = base + S::KV + 2 * c * S::TILE;

  float dk_acc[NACC], dv_acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) dk_acc[i] = dv_acc[i] = 0.f;

  int w = next_real(run_ptr_t[kt]), gi = 0;
  if (w < w_end) mbar_wait(kv_full, 0);
  for (int it = 0; w < w_end; ++it) {
    const int stage = it & 1;
    const magi::Item item(meta_t + (long)w * META_DIM);
    const int q0 = work_qt_t[w] * BQ;
    const uint32_t Ks = opaque(Kw), Vs = Ks + S::TILE;
    const uint32_t Qs = base + S::QDO + 2 * stage * S::TILE, dOs = Qs + S::TILE;
    const float* Ls = reinterpret_cast<const float*>(smem + S::STATS + stage * (8 * BQ));
    const float* Dls = Ls + BQ;
    mbar_wait(bar_full(bars, stage), (it >> 1) & 1);

    float st[32], dpt[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64_t00(st, desc_k(Ks, kk), desc_k(Qs, kk), 1);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_n64_t00(dpt, desc_k(Vs, kk), desc_k(dOs, kk), 1);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);

    // the softcap is read from the kernel's parameters at each step, not
    // kept in a register across the loop
    if (softcap > 0.f) {
      if (item.full)
        p_ds<true, true>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
      else
        p_ds<true, false>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
    } else if (item.full) {
      p_ds<false, true>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
    } else {
      p_ds<false, false>(st, dpt, Ls, Dls, item, q0, k0, r0, c0, scale, softcap);
    }

    // dV += P^T dO (hi, lo), then dK += dS^T Q (hi, lo), as bwd_kv_tc.cuh
    uint32_t fh[4][4], fl[4][4];
    to_a_frags_split(fh, fl, st);
    fence_regs(fh);
    fence_regs(fl);
    fence_regs(dv_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_t1<D>(dv_acc, fh[kk], desc_mn(dOs, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_t1<D>(dv_acc, fl[kk], desc_mn(dOs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(fh);
    fence_regs(fl);

    to_a_frags_split(fh, fl, dpt);
    const uint32_t dS0 = base + S::DS + stage * 16384;  // this parity's two tiles
    if constexpr (FUSED) {  // dS^T (hi), the A operand of dQ = dS K
      const int rr = (int)opaque(r0), cc = (int)opaque(c0);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          *reinterpret_cast<uint32_t*>(
              smem + (dS0 - base) + cw() * 8192 +
              tile_offset(rr + 8 * (e & 1), 16 * kk + 8 * (e >> 1) + cc)) = fh[kk][e];
    }
    fence_regs(fh);
    fence_regs(fl);
    fence_regs(dk_acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_t1<D>(dk_acc, fh[kk], desc_mn(Qs, kk));
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_t1<D>(dk_acc, fl[kk], desc_mn(Qs, kk));
    wgmma_commit();
    if constexpr (FUSED) {
      fence_async_smem();  // this consumer's dS^T tile is visible to wgmma
      bar_sync(1, 256);    // and the other consumer's is in
    }
    wgmma_wait<0>();
    fence_regs(dk_acc);
    fence_regs(fh);
    fence_regs(fl);
    if (lane == 0) mbar_arrive(bar_empty(bars, stage));  // this warp is done with Q, dO

    // FUSED: dQ = dS K over the 128 k rows, staged and added by one bulk
    // reduce; at d 64 by the step parity's consumer only
    if constexpr (FUSED) {
      if (D == 128 || stage == cw()) {
        const int panel = D == 128 ? cw() : 0;  // dQ's 64 columns
        float dq[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) dq[i] = 0.f;
        fence_regs(dq);
        wgmma_fence();
#pragma unroll
        for (int kw = 0; kw < 2; ++kw)
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_ss_n64_t11(dq, desc_mn(dS0 + kw * 8192, kk),
                             desc_mn(base + S::KV + 2 * kw * S::TILE + panel * PANEL_BYTES, kk),
                             1);
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        // this consumer's two staging boxes, used in turn
        const int use = D == 128 ? stage : (it >> 1) & 1;
        const uint32_t stg = S::DQ + (2 * use + cw()) * 16384;
        if (t == 0) bulk_wait_read<1>();  // the box staged here two uses ago has been read
        bar_sync(2 + cw(), 128);
        const int rr = (int)opaque(r0), cc = (int)opaque(c0);
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            *reinterpret_cast<float2*>(smem + stg + tile_offset32<64>(rr + 8 * hh, 8 * j + cc)) =
                make_float2(dq[4 * j + 2 * hh], dq[4 * j + 2 * hh + 1]);
        fence_async_smem();  // the staged box is visible to the bulk reduce
        bar_sync(2 + cw(), 128);
        if (t == 0) {  // the block's rows and head, reloaded: no register keeps them
          const int rows = work_qt_t[w] * BQ, h = hkv * g + gi;
          reduce_add_3d(&tm_dq, base + stg, 64 * panel, h, rows);
          reduce_add_3d(&tm_dq, base + stg + 8192, 64 * panel + 32, h, rows);
          bulk_commit();
        }
      }
    }
    if (++gi == g) {
      gi = 0;
      w = next_real(w + 1);
    }
  }

  // one write per (k tile, kv head); the scale folds into dk here
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
