// The bf16 k-major FFA backward on Hopper's tensor cores, shared by the
// bf16 entries of csrc/ffa_bwd_dkv.cu (B5/B6: dk and dv, the split
// backward's second pass, FUSED false) and csrc/ffa_bwd_fused.cu (B8/B9:
// dk, dv and dq in one pass, FUSED true). The float32 entries of both keep
// the CUDA-core body of csrc/bwd_kv.cuh: their 1e-5 gates need float32 FMA.
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
// Design (building blocks in csrc/tc.cuh). One CTA (one warpgroup, 128
// threads) owns one (k tile, kv head), keeps K and V in shared memory and
// dk, dv in registers (float32, D / 2 each a thread) for its k-major run,
// and writes them once: no atomics, so dk and dv do not depend on the
// order CTAs run in. It loops the run's real items and, inside each, the
// query group; per (item, q head) "step":
// - S^T = K Q^T and dP^T = V dO^T by wgmma m64n64k16 (64 k rows), K, V,
//   Q and dO read K-major;
// - P^T and dS^T in registers, each split into bf16 hi + lo A fragments
//   (tc.cuh:to_a_frags_split);
// - dV += P^T dO and dK += dS^T Q (m64nDk16, A from registers, dO and Q
//   read MN-major), each as two products, hi then lo: dk and dv sum over
//   every q row and head that sees a k row (all 32768 of them for a global
//   token under a sink-window mask), where one bf16 rounding of P and dS
//   alone leaves them 2^-9 relative, up to 2e-2 absolute, from float32;
// - FUSED only: dS^T (hi) stored once to shared memory (bf16, swizzled),
//   then dQ = dS K in 64-column halves (m64n64k16, both operands MN-major:
//   dS is the transpose of the stored tile), each half added to the
//   workspace with vector atomics (one 16-byte red.add per lane and
//   8-column chunk: two lanes swap a row pair first), rows outside the
//   item skipped.
// Both instances run the dk/dv products in the same order on the same
// fragments, so the split dk/dv equals the fused kernel's to the bit. The
// next step's Q, dO, lse and delta are double-buffered by cp.async and
// land while this step's products run.
//
// Head dim 256: a column split. The CTA takes one 128-column half of dk and
// dv (grid z), and with FUSED the same half of dq's atomics, and keeps the
// width-128 register plan; S^T and dP^T run over the full width from
// shared memory, so each half recomputes them, and the dV, dK and dQ
// products read the half's two 64-column panels of dO, Q and K.
//
// Tiles (BQ, BK) of 64 or 128 rows. A 128-row k tile is two warpgroups,
// each owning 64 of its key rows (its K and V tiles, dk and dv, and with
// FUSED its dS^T tile), that share every Q/dO stage and its lse and delta.
// A 128-row q tile is loaded whole (its rows contiguous in each 64-column
// panel) and walked as two 64-row blocks inside the step, S^T and dP^T
// over each block in turn: the register plan stays the 64 x 64 one (S^T
// and dP^T of n = 128 beside dk and dv would need 256 floats a thread at
// D = 128).
//
// What bounds it on this card: operations on the bf16 tensor cores (989
// TFLOP/s on an H100 SXM): 8 * D flops per live pair and q head for dk/dv
// (S, dP, P^T dO, dS^T Q; the lo products make it 12 * D executed), 10 * D
// with FUSED (14 * D executed), then the dq atomics, 64 * D float32 adds
// per (item, q head). Shared memory: K and V of every warpgroup, two
// stages of Q and dO and of lse and delta (100,352 bytes at D = 128, 64 x
// 64), with FUSED also each warpgroup's dS^T tile (108,544 bytes): two CTAs
// per SM either way (at D = 256, 198,656 and 206,848 bytes: one, and no
// other pair fits there; 216,064 with FUSED at D = 128, 128 x 128). Registers: dk and dv (2 * DV / 2, DV = min(D,
// 128)) beside at most two 64 x 64 blocks: S^T and dP^T, then P^T's
// hi and lo fragments and dP^T, then dS^T's, then (FUSED) a dq half (dV's
// products finish before dK's fragments are formed).
#pragma once

#include "tc.cuh"

namespace {
namespace kv_tc {

using namespace magi::tc;
using magi::LOG2E;
using magi::META_DIM;

// the dk / dv columns one CTA computes (a 128-column half at D = 256) and
// the halves of a row
template <int D>
constexpr int DV = D > 128 ? 128 : D;
template <int D>
constexpr int NCH = D / DV<D>;

// the BK / 64 warpgroups, each owning 64 key rows
template <int BK>
constexpr int NWG = BK / 64;

template <int D, bool FUSED, int BQ = 64, int BK = 64>
struct Smem {
  static constexpr uint32_t TILE = 64 * D * 2;   // K or V of a warpgroup
  static constexpr uint32_t QT = BQ * D * 2;     // Q or dO of a stage
  static constexpr uint32_t QDO = NWG<BK> * 2 * TILE;  // [2 stages][Q, dO]
  static constexpr uint32_t DS = QDO + 4 * QT;   // [WG] dS^T, 64 x 64 bf16
  // [2 stages][lse, delta]
  static constexpr uint32_t STATS = DS + (FUSED ? NWG<BK> * 64 * 128 : 0);
  static constexpr size_t bytes = STATS + 2 * 2 * BQ * 4 + 1024;
};

template <int D, bool FUSED, int BQ, int BK>
__global__ void __launch_bounds__(128 * NWG<BK>, 1)
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
  constexpr int NT = 128 * NWG<BK>;
  constexpr int W = DV<D>;  // dk / dv columns of this CTA
  constexpr int NACC = W / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  // the column half, and its first panel's offset in a D-wide tile of 64
  // rows (K) and of BQ rows (Q, dO)
  const int ch = NCH<D> > 1 ? (int)blockIdx.z : 0;
  const uint32_t chp = ch * (W / 64) * PANEL_BYTES;
  const uint32_t chq = ch * (W / 64) * (BQ * 128);

  // one warpgroup (a 64-row k tile): warpgroup 0, known at compile time
  const int tid = threadIdx.x;
  const int wg = NWG<BK> > 1 ? tid >> 7 : 0;
  const int t = NWG<BK> > 1 ? tid & 127 : tid;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // k rows r0 and r0 + 8
  const int c0 = 2 * (lane & 3);  // q columns c0, c0 + 1 of each chunk
  const int kt = blockIdx.x, hkv = blockIdx.y, g = hq / hk;
  const int k0 = kt * BK + wg * 64;  // this warpgroup's first key row
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;
  const uint32_t Kw = base + wg * 2 * S::TILE;  // this warpgroup's K, V

  // K at Kw, V at Kw + TILE, for the whole run
  load_tile_async<D, 128>(Kw, k + ((long)k0 * hk + hkv) * D, kv_rs,
                          min(64, sk - k0), t);
  load_tile_async<D, 128>(Kw + S::TILE, v + ((long)k0 * hk + hkv) * D,
                          kv_rs, min(64, sk - k0), t);
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

      if constexpr (FUSED) {  // dQ = dS K, added to the workspace
        const uint32_t dSs = base + S::DS + wg * 8192;
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
    const dim3 grid(num_k_tiles, hk, NCH<D>);
    ffa_bwd_kv_tc_kernel<D, FUSED, BQ, BK>
        <<<grid, 128 * NWG<BK>, smem, (cudaStream_t)stream>>>(
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
