// The bf16 FFA forward on Hopper's tensor cores, shared by the bf16 entries
// of csrc/ffa_fwd.cu (B1: one q head per CTA, G = 1) and csrc/ffa_fwd_gqa.cu
// (B2: G q heads of one GQA group per CTA). The float32 entries run
// csrc/ffa_fwd_tf32.cuh, the same structure as 3xTF32 (one TF32 product
// would miss the float32 gates).
//
// What it computes: out = softmax(S) V over the live (q, k) pairs of the
// plan's slices, lse in natural log, out 0 and lse -inf on rows no slice
// covers, the optional per-(q tile, head) max of the scaled, softcapped
// logits in natural units, head_dim 64, 128 or 256, ragged last tiles, q
// tiles taken from the last to the first.
//
// Design (the building blocks are in csrc/tc.cuh). One CTA owns one q tile
// and G heads of one kv head and loops that q tile's run of work items;
// each head has its own consumer warpgroup (128 threads) that runs the same
// per-head code, so B2's rows are bit-identical to B1's. Per work item:
// - S = Q K^T by wgmma m64n64k16 (bf16 in, float32 accumulate), Q and K
//   read K-major from swizzled shared memory;
// - scale (times log2 e), softcap (tanh of the naturally scaled score),
//   mask unless IS_FULL and the online softmax in registers, in the exp2
//   domain (the running max of a row is shared by the 4 lanes that hold
//   it; the running sum stays per lane until the end);
// - P rounded to bf16 in registers and fed as wgmma's A operand to
//   O += P V (m64nDk16, V read MN-major: transposed B).
// The item's K and V tiles are double-buffered (but at 64 x 64 and D =
// 256, below): cp.async loads of the next real item are issued before this
// item's products, so they overlap.
//
// Head dim 256: no column split. A consumer warpgroup owns its 64 q rows
// at all 256 output columns: S = Q K^T once per item (16 k-steps of
// m64n64k16), O += P V as one m64n256k16 chain a k-step (V read MN-major
// at full width), O 128 floats a thread, and every warpgroup writes its
// rows' lse and max logits. Two consumer warpgroups a CTA share every K/V
// stage: B1 at a 128-row q tile, B2 at G = 2 heads (the per-warpgroup code
// is the same, so B2 stays bit-identical to B1). Shared memory at 128 x 64
// (or G = 2): two 64 x 256 q tiles (64 KB) and two stages of the 64-row K
// and V at full width (128 KB), 197,664 bytes, one CTA of 256 threads an
// SM. Registers: O (128) beside S (32) and P (16) and the softmax state,
// under __launch_bounds__(256, 1)'s 255; a 128-row k tile would add 48
// (S and P of n = 128) and does not fit the shared memory either, so the
// 256 instances take 64-row k tiles only. At 64 x 64 B1 is one warpgroup
// a CTA: with two stages (164,880 bytes) one CTA, one warpgroup, an SM;
// it keeps one K/V stage instead (99,344 bytes, __launch_bounds__(128, 2)),
// so two CTAs share an SM and each one's loads run under the other's
// products (the next item's K and V are loaded once the item's products
// are done): 1.35x faster than two stages at Gemma-2-9B's attention on an
// H100 SXM at 700 W, bitwise the same.
//
// Tiles (BQ, BK) of 64 or 128 rows each (kernels/ffa.py picks the pair
// from the plan; csrc/common.cuh MAGI_FFA_TILES lists the instances; at
// D = 64 and 128 the 128 x 128 instance and B2's two heads of 64 x 128
// run csrc/ffa_fwd_ws.cuh instead, fwd_bf16::WS there). A
// 128-row q tile is two consumer warpgroups, each owning a 64-row half of
// it, that share every K/V stage (so each K/V tile is loaded once for 128
// q rows); it packs no heads (G = 1). A 128-row k tile is one m64n128k16
// product a k-step for S (wgmma's n = 128) and eight k-steps of P V; its
// K and V tiles keep the 128 rows contiguous in each 64-column panel
// (tc.cuh: a tile of ROWS rows).
//
// What bounds it on this card: operations, 4 * D flops per live pair and
// head on the bf16 tensor cores (989 TFLOP/s on an H100 SXM). Shared
// memory (Smem below): the warpgroups' q tiles and two stages of K and V,
// 64 * D * 2 * (warpgroups) + 2 * BK * 2 * D * 2 + 16 * warpgroups + 1024
// bytes (80 KB at D = 128 and 64 x 64, G = 1: two CTAs per SM; 160 KB at
// 128 x 128; at D = 256 see above). Registers: the O accumulator (D / 2
// floats a thread), S (BK / 2) and P (BK / 4).
#pragma once

#include "tc.cuh"

namespace {
namespace fwd_tc {

using namespace magi::tc;
using magi::LN2;
using magi::LOG2E;
using magi::META_DIM;

// G heads of one kv head, or (G = 1) the BQ / 64 row halves of one head:
// one consumer warpgroup each
template <int G, int BQ>
constexpr int NWG = G * (BQ / 64);

template <int D, int G, int BQ = 64, int BK = 64>
struct Smem {
  static constexpr int WG = NWG<G, BQ>;
  // one K/V stage for the one-warpgroup CTA at D = 256 and a 64-row k
  // tile: two CTAs an SM
  static constexpr int STAGES = D > 128 && WG == 1 && BK == 64 ? 1 : 2;
  static constexpr uint32_t TILE = 64 * D * 2;  // one warpgroup's q tile
  static constexpr uint32_t KT = BK * D * 2;    // K of a stage
  static constexpr uint32_t STAGE = 2 * KT;     // K, V
  static constexpr uint32_t KV = WG * TILE;       // [2 stages][K, V]
  static constexpr uint32_t RED = KV + STAGES * STAGE;  // 4 floats a warpgroup
  // + 1024: the dynamic window is rounded up to a 1024-byte boundary
  static constexpr size_t bytes = RED + 16 * WG + 1024;
};

template <int D, int G, int BQ, int BK>
__global__ void __launch_bounds__(128 * NWG<G, BQ>,
                                  Smem<D, G, BQ, BK>::STAGES == 1 ? 2 : 1)
    ffa_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, float* __restrict__ max_logits,
                      const int* __restrict__ work_kt,
                      const int* __restrict__ meta,
                      const int* __restrict__ run_ptr, int sq, int sk, int hq,
                      int hk, int num_q_tiles, float scale, float softcap) {
  static_assert(G == 1 || BQ == 64, "a 128-row q tile packs no heads");
  using S = Smem<D, G, BQ, BK>;
  constexpr int NT = 128 * NWG<G, BQ>;
  constexpr int NACC = D / 2;  // O floats a thread
  constexpr int NS = BK / 2;   // S floats a thread
  constexpr int KS = BK / 16;  // k-steps of P V
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

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

  load_tile_async<D, 128>(Qs, q + ((long)q0 * hq + h) * D, q_rs,
                          min(64, sq - q0), t);
  cp_async_commit();

  const int w_end = run_ptr[qt + 1];
  auto next_real = [&](int w) {  // skip dummy items of an uncovered tile
    while (w < w_end && magi::Item(meta + (long)w * META_DIM).empty()) ++w;
    return w;
  };
  auto load_kv = [&](int w, int stage) {
    const int k0 = work_kt[w] * BK;
    const uint32_t Ks = base + S::KV + stage * S::STAGE;
    const long off = ((long)k0 * hk + hkv) * D;
    // one warpgroup at D = 256: 16 copies a thread and tile, whose
    // addresses are not kept beside O (they pushed it into spills)
    const int tt = D > 128 && NT == 128 ? (int)opaque(tid) : tid;
    load_tile_async<D, NT, BK>(Ks, k + off, kv_rs, min(BK, sk - k0), tt);
    load_tile_async<D, NT, BK>(Ks + S::KT, v + off, kv_rs, min(BK, sk - k0),
                               tt);
  };

  int w = next_real(run_ptr[qt]);
  if (w < w_end) load_kv(w, 0);
  cp_async_commit();

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // softcap-free scores go straight to the log2 domain; with a softcap the
  // tanh runs on the naturally scaled score first
  const float qk_scale = softcap > 0.f ? scale : scale * LOG2E;

  int stage = 0;
  while (w < w_end) {
    const int wn = next_real(w + 1);
    if constexpr (S::STAGES == 2) {
      if (wn < w_end) load_kv(wn, stage ^ 1);
      cp_async_commit();
      cp_async_wait<1>();  // q and this item's K, V have landed
    } else {
      cp_async_wait<0>();
    }
    fence_async_smem();
    __syncthreads();

    const magi::Item item(meta + (long)w * META_DIM);
    const int k0 = work_kt[w] * BK;
    const uint32_t Ks = base + S::KV + stage * S::STAGE;
    const uint32_t Vs = Ks + S::KT;

    float s[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) s[i] = 0.f;
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
      wgmma_ss_t00<BK>(s, desc_k(Qs, kk), desc_k<BK>(Ks, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);

    float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int row = r0 + ((i >> 1) & 1) * 8;
      const int col = (i >> 2) * 8 + c0 + (i & 1);
      float x = s[i] * qk_scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap) * LOG2E;
      if (!item.full && !item.live(q0 + row, k0 + col)) x = -INFINITY;
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
    for (int i = 0; i < NS; ++i) {
      const float p = exp2f(s[i] - m_use[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] *= alpha[(i >> 1) & 1];

    uint32_t pa[KS][4];
    to_a_frags(pa, s);
    fence_regs(pa);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
      wgmma_rs_t1<D>(acc, pa[kk], desc_mn<BK>(Vs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    __syncthreads();  // every warpgroup is done with this stage's K and V
    if constexpr (S::STAGES == 1) {  // the next item's K, V into the stage
      if (wn < w_end) load_kv(wn, 0);
      cp_async_commit();
    }
    w = wn;
    stage ^= S::STAGES - 1;
  }
  cp_async_wait<0>();  // an uncovered tile loaded q and nothing else

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = q0 + r0 + 8 * hh;
    if (row >= sq) continue;
    const bool empty = l[hh] == 0.f;  // no slice covers this row
    __nv_bfloat16* o = out + ((long)row * hq + h) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a0 = empty ? 0.f : acc[4 * j + 2 * hh] / l[hh];
      const float a1 = empty ? 0.f : acc[4 * j + 2 * hh + 1] / l[hh];
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + c0) =
          __floats2bfloat162_rn(a0, a1);
    }
    if ((lane & 3) == 0)
      lse[(long)row * hq + h] =
          empty ? -INFINITY : (m[hh] + log2f(l[hh])) * LN2;
  }
  if (max_logits != nullptr) {
    // the tile's max logit of each head: the row maxima of the 4 warps of
    // each warpgroup of that head
    float mx = fmaxf(m[0], m[1]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    float* red = reinterpret_cast<float*>(smem + S::RED);
    if (lane == 0) red[4 * wg + warp] = mx;
    __syncthreads();
    if (tid < G) {  // head blockIdx.y * G + tid: warpgroups tid, tid + G, ..
      float mm = -INFINITY;
      for (int x = tid; x < S::WG; x += G)
        mm = fmaxf(mm, fmaxf(fmaxf(red[4 * x], red[4 * x + 1]),
                             fmaxf(red[4 * x + 2], red[4 * x + 3])));
      max_logits[(long)qt * hq + blockIdx.y * G + tid] =
          mm == -INFINITY ? -INFINITY : mm * LN2;
    }
  }
}

template <int D, int G, int BQ = 64, int BK = 64>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           float* max_logits, const int* work_kt, const int* meta,
           const int* run_ptr, int sq, int sk, int hq, int hk,
           int num_q_tiles, float scale, float softcap, void* stream) {
  if constexpr (Smem<D, G, BQ, BK>::bytes > magi::SMEM_LIMIT ||
                (G > 1 && BQ != 64)) {
    return (int)cudaErrorInvalidValue;  // not compiled: the CTA does not fit
  } else {
    static magi::SmemAllowed smem_ok;
    const size_t smem = Smem<D, G, BQ, BK>::bytes;
    cudaError_t e =
        magi::allow_smem(ffa_fwd_tc_kernel<D, G, BQ, BK>, smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(num_q_tiles, hq / G);
    ffa_fwd_tc_kernel<D, G, BQ, BK>
        <<<grid, 128 * NWG<G, BQ>, smem, (cudaStream_t)stream>>>(
            static_cast<const __nv_bfloat16*>(q),
            static_cast<const __nv_bfloat16*>(k),
            static_cast<const __nv_bfloat16*>(v),
            static_cast<__nv_bfloat16*>(out), lse, max_logits, work_kt, meta,
            run_ptr, sq, sk, hq, hk, num_q_tiles, scale, softcap);
    return (int)cudaGetLastError();
  }
}

// The shared memory of an instance, 0 where it is not compiled.
template <int D, int G, int BQ, int BK>
constexpr long smem_bytes() {
  return Smem<D, G, BQ, BK>::bytes > magi::SMEM_LIMIT || (G > 1 && BQ != 64)
             ? 0
             : (long)Smem<D, G, BQ, BK>::bytes;
}

}  // namespace fwd_tc
}  // namespace
