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
// The item's K and V tiles are double-buffered: cp.async loads of the next
// real item are issued before this item's products, so they overlap.
//
// Head dim 256: a column split. The CTA keeps the width-128 register plan
// and takes one 128-column half of out (grid z); S = Q K^T still runs over
// the full 256 columns from shared memory (16 k-steps), so each half
// recomputes S: about 1.5x the flops of one pass at d = dv = 256. lse and
// the max logits are written by half 0 only.
//
// Tiles (BQ, BK) of 64 or 128 rows each (kernels/ffa.py picks the pair
// from the plan; csrc/common.cuh MAGI_FFA_TILES lists the instances). A
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
// 64 * D * 2 * (warpgroups) + 2 * BK * (D + DV) * 2 + 16 * warpgroups +
// 1024 bytes (80 KB at D = 128 and 64 x 64, G = 1: two CTAs per SM;
// 160 KB at 128 x 128; at D = 256 the V tiles are the 128-column half,
// 129 KB at 64 x 64, one CTA per SM; 128 x 128 does not fit there).
// Registers: the O accumulator (DV / 2 floats a thread, DV = min(D,
// 128)), S (BK / 2) and P (BK / 4).
#pragma once

#include "tc.cuh"

namespace {
namespace fwd_tc {

using namespace magi::tc;
using magi::LN2;
using magi::LOG2E;
using magi::META_DIM;

// the output columns one CTA computes (a 128-column half at D = 256) and
// the halves of a row
template <int D>
constexpr int DV = D > 128 ? 128 : D;
template <int D>
constexpr int NCH = D / DV<D>;

// G heads of one kv head, or (G = 1) the BQ / 64 row halves of one head:
// one consumer warpgroup each
template <int G, int BQ>
constexpr int NWG = G * (BQ / 64);

template <int D, int G, int BQ = 64, int BK = 64>
struct Smem {
  static constexpr int WG = NWG<G, BQ>;
  static constexpr uint32_t TILE = 64 * D * 2;  // one warpgroup's q tile
  static constexpr uint32_t KT = BK * D * 2;    // K of a stage
  static constexpr uint32_t STAGE = KT + BK * DV<D> * 2;  // K, V
  static constexpr uint32_t KV = WG * TILE;       // [2 stages][K, V]
  static constexpr uint32_t RED = KV + 2 * STAGE;  // 4 floats a warpgroup
  // + 1024: the dynamic window is rounded up to a 1024-byte boundary
  static constexpr size_t bytes = RED + 16 * WG + 1024;
};

template <int D, int G, int BQ, int BK>
__global__ void __launch_bounds__(128 * NWG<G, BQ>, 1)
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
  constexpr int W = DV<D>;  // output columns of this CTA
  constexpr int NACC = W / 2;
  constexpr int NS = BK / 2;   // S floats a thread
  constexpr int KS = BK / 16;  // k-steps of P V
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

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
    load_tile_async<D, NT, BK>(Ks, k + off, kv_rs, min(BK, sk - k0), tid);
    load_tile_async<W, NT, BK>(Ks + S::KT, v + off + ch * W, kv_rs,
                               min(BK, sk - k0), tid);
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
    if (wn < w_end) load_kv(wn, stage ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // q and this item's K, V have landed
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
      wgmma_rs_t1<W>(acc, pa[kk], desc_mn<BK>(Vs, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(pa);
    __syncthreads();  // every warpgroup is done with this stage's K and V
    w = wn;
    stage ^= 1;
  }
  cp_async_wait<0>();  // an uncovered tile loaded q and nothing else

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = q0 + r0 + 8 * hh;
    if (row >= sq) continue;
    const bool empty = l[hh] == 0.f;  // no slice covers this row
    __nv_bfloat16* o = out + ((long)row * hq + h) * D + ch * W;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float a0 = empty ? 0.f : acc[4 * j + 2 * hh] / l[hh];
      const float a1 = empty ? 0.f : acc[4 * j + 2 * hh + 1] / l[hh];
      *reinterpret_cast<__nv_bfloat162*>(o + 8 * j + c0) =
          __floats2bfloat162_rn(a0, a1);
    }
    if ((lane & 3) == 0 && ch == 0)
      lse[(long)row * hq + h] =
          empty ? -INFINITY : (m[hh] + log2f(l[hh])) * LN2;
  }
  if (max_logits != nullptr && ch == 0) {
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
    const dim3 grid(num_q_tiles, hq / G, NCH<D>);
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
