// The bf16 FFA dq backward on Hopper's tensor cores, shared by the bf16
// entries of csrc/ffa_bwd_dq.cu (B3: one q head per CTA, G = 1) and
// csrc/ffa_bwd_dq_gqa.cu (B4: G q heads of one GQA group per CTA). The
// float32 entries keep the CUDA-core body of csrc/ffa_bwd_dq.cuh: their
// 1e-5 gate against the plain version needs float32 FMA.
//
// What it computes is csrc/ffa_bwd_dq.cuh's function: for every q head h
// and q row i, dq[i] = scale * sum_j dS[i, j] k[j] over the k rows j some
// slice lets row i see, dS = P (dP - delta[i]) (times 1 - tanh^2 under a
// softcap), P = exp(s - lse[i]) from the forward's natural-log lse, 0
// where the pair is masked or lse = -inf (no finite mask value), so a row
// no slice covers gets dq = 0 exactly. The result is float32.
//
// Design (building blocks in csrc/tc.cuh; the structure of the forward,
// csrc/ffa_fwd_tc.cuh). One CTA owns one q tile and G heads of one kv
// head and loops that q tile's run of the q-major plan, last q tile first;
// each head has its own warpgroup (128 threads) running the same per-head
// code, so B4's rows are bit-identical to B3's. The head's Q and dO tiles
// stay in shared memory for the run; the item's K and V tiles are
// double-buffered by cp.async, loaded once for the G heads. Per item:
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
// Head dim 256: a column split. The CTA takes one 128-column half of dq
// (grid z) and keeps the width-128 register plan; S = Q K^T and dP = dO V^T
// run over the full width from shared memory, so each half recomputes
// them, and dQ += dS K reads the half's two 64-column panels of K.
//
// Tiles (BQ, BK) of 64 or 128 rows. A 128-row q tile is two warpgroups,
// each owning a 64-row half (its Q, dO, lse, delta and dQ), that share
// every K/V stage; it packs no heads (G = 1). A 128-row k tile is loaded
// whole (its rows contiguous in each 64-column panel) and walked as two
// 64-key blocks inside the item, S, dP and dQ += dS K per block: the
// register plan stays the 64 x 64 one (S and dP of n = 128 beside a
// 64-float dQ would leave no room at D = 128).
//
// What bounds it on this card: operations, 6 * D flops per live pair and
// head on the bf16 tensor cores (989 TFLOP/s on an H100 SXM). Shared
// memory: the warpgroups' Q and dO tiles and two stages of K and V,
// 2 * warpgroups * 64 * D * 2 + 2 * 2 * BK * D * 2 + 1024 bytes (99,328
// at D = 128, 64 x 64, G = 1: two CTAs per SM; 132,096 at G = 2: one;
// 197,632 at 128 x 128; 197,632 at D = 256, 64 x 64, the one pair that
// fits there). Registers: the dQ accumulator (DV / 2 floats a thread,
// DV = min(D, 128)), S and dP (32 each), dS's A fragments (16).
#pragma once

#include "tc.cuh"

namespace {
namespace dq_tc {

using namespace magi::tc;
using magi::LOG2E;
using magi::META_DIM;

// the dq columns one CTA computes (a 128-column half at D = 256) and the
// halves of a row
template <int D>
constexpr int DV = D > 128 ? 128 : D;
template <int D>
constexpr int NCH = D / DV<D>;

// G heads of one kv head, or (G = 1) the BQ / 64 row halves of one head:
// one warpgroup each
template <int G, int BQ>
constexpr int NWG = G * (BQ / 64);

template <int D, int G, int BQ = 64, int BK = 64>
struct Smem {
  static constexpr int WG = NWG<G, BQ>;
  static constexpr uint32_t TILE = 64 * D * 2;
  static constexpr uint32_t KT = BK * D * 2;     // K (or V) of a stage
  static constexpr uint32_t DO = WG * TILE;      // dO tiles after Q tiles
  static constexpr uint32_t KV = 2 * WG * TILE;  // [2 stages][K, V]
  // + 1024: the dynamic window is rounded up to a 1024-byte boundary
  static constexpr size_t bytes = KV + 4 * KT + 1024;
};

template <int D, int G, int BQ, int BK>
__global__ void __launch_bounds__(128 * NWG<G, BQ>, 1)
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
  static_assert(G == 1 || BQ == 64, "a 128-row q tile packs no heads");
  using S = Smem<D, G, BQ, BK>;
  constexpr int NT = 128 * NWG<G, BQ>;
  constexpr int W = DV<D>;  // dq columns of this CTA
  constexpr int NACC = W / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;

  const int ch = NCH<D> > 1 ? (int)blockIdx.z : 0;  // the column half
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
        wgmma_rs_t1<W>(acc, da[kk],
                       desc_mn<BK>(Ks + ch * (W / 64) * (BK * 128), kk));
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
    float* o = dq + ((long)row * hq + h) * D + ch * W;
#pragma unroll
    for (int j = 0; j < W / 8; ++j)
      *reinterpret_cast<float2*>(o + 8 * j + c0) = make_float2(
          acc[4 * j + 2 * hh] * scale, acc[4 * j + 2 * hh + 1] * scale);
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
    const dim3 grid(num_q_tiles, hq / G, NCH<D>);
    ffa_bwd_dq_tc_kernel<D, G, BQ, BK>
        <<<grid, 128 * NWG<G, BQ>, smem, (cudaStream_t)stream>>>(
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
