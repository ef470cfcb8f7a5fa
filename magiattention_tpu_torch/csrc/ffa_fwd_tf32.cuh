// The float32 FFA forward on Hopper's tensor cores as 3xTF32, shared by the
// float32 entries of csrc/ffa_fwd.cu (B1: one q head per CTA, G = 1) and
// csrc/ffa_fwd_gqa.cu (B2: G q heads of one GQA group per CTA).
//
// What it computes is csrc/ffa_fwd_tc.cuh's function in float32: out =
// softmax(S) V over the live (q, k) pairs of the plan's slices, lse in
// natural log, out 0 and lse -inf on rows no slice covers, the optional
// per-(q tile, head) max of the scaled, softcapped logits in natural units,
// head_dim 64, 128 or 256, ragged last tiles, q tiles taken from the last
// to the first.
//
// Precision. One tf32 product keeps 10 mantissa bits (about 2^-11 of each
// product), which misses the serving replay gates: a single-TF32 body is
// ruled out. Here every operand is split into hi = tf32(x) and lo = x - hi
// (csrc/tc.cuh: split_tf32) and a b is taken as hi hi + hi lo + lo hi, the
// dropped terms about 2^-21 of |a b|. The tensor cores' float32
// accumulation loses more than float32 FMA when many products are added
// into one accumulator (chip_smoke.py's tf32_probe phase: P V over 4096
// keys in one accumulator against one per 32-key chunk), so no
// accumulator takes many: S's hi hi terms, hi lo terms and lo hi terms go
// to three accumulators of D / 8 products each, added once; each 32-key
// chunk's P V goes to a fresh accumulator of 12 products, added into the
// running output by float32 FMA on the CUDA cores.
//
// Design (tf32 helpers in csrc/tc.cuh). One CTA owns one q tile and G heads
// of one kv head and loops that q tile's run of work items as 32-key
// chunks (the halves of a 64-key item that a live pair of the tile
// reaches); each head has its own consumer warpgroup (128 threads) that
// runs the same per-head code, so B2's rows are bit-identical to B1's.
// Once per CTA, each head's q tile is split into swizzled hi and lo tiles.
// A chunk's raw K and V rows are copied by cp.async into a staging buffer
// and split by all threads into one of two stages: K's hi and lo rows
// stacked in one 64-row K-major tile, and the hi and lo tiles of V
// transposed (head-dim rows of keys, in the A operand's key order, kperm),
// since wgmma reads a tf32 B operand K-major only. Per chunk:
// - S = Q K^T is issued by wgmma from shared memory: m64n64k8 of Q_hi
//   against the stacked K gives Q_hi K_hi and Q_hi K_lo in one product,
//   m64n32k8 gives Q_lo K_hi;
// - while it runs, the next chunk's tiles are split into the other stage
//   and the copy of the chunk after it is issued;
// - scale (times log2 e), softcap (tanh of the naturally scaled score),
//   mask unless IS_FULL and the online softmax in registers, in the exp2
//   domain (the running max of a row is shared by the 4 lanes that hold
//   it; the running sum stays per lane until the end);
// - P split in registers and fed as wgmma's A operand to P V (m64nDk8,
//   V^T from shared memory), then O = O * alpha + that chunk's P V.
//
// What bounds it on this card: operations, 4 * D flops per live pair and
// head, three tf32 products each (495 TFLOP/s dense TF32 on an H100 SXM,
// so 12 * D flops at that rate; against float32 FMA's 4 * D at 67
// TFLOP/s). What holds it back is the split's work on the CUDA cores and
// the many small products (a k-step of 8 against bf16's 16, three products
// a pair). Shared memory: G q tiles (hi and lo), the raw K and V chunk and
// two stages of K's and V^T's tiles, D * (512 G + 1280) + 16 G bytes and
// 1024 to align the window (225 KB at D = 128, G = 1: one CTA per SM);
// where two stages do not fit (D = 128, G = 2) one, each chunk split at
// the start of its own step.
// Registers: O and the chunk's P V (DV / 2 floats a thread each, DV =
// min(D, 128)), S in three accumulators (48) and P's hi and lo (32).
//
// Tiles (BQ, BK) of 64 or 128 rows: a 128-row q tile is two consumer
// warpgroups, each owning a 64-row half with its own hi and lo q tiles
// (the packed structure, here for the halves of one head, G = 1); a
// 128-row k tile is four 32-key chunks of its items instead of two. Shared
// memory does not depend on BK; a 128-row q tile takes what two packed
// heads take (145 KB at D = 64, 225 KB at D = 128 with one stage; it does
// not fit at D = 256).
//
// Head dim 256: a column split, as csrc/ffa_fwd_tc.cuh's. The CTA takes one
// 128-column half of out (grid z) and keeps the width-128 register plan;
// S runs over all 256 columns (32 k-steps), so each half recomputes it.
// The q tiles alone (hi and lo) take 128 KB there, so the raw staging
// buffer goes: each chunk's K rows and V half are read from global memory
// by the threads that split them (no cp.async), into one stage (K's
// stacked tile 64 KB, V^T's hi and lo 32 KB): 230,416 bytes at G = 1.
#pragma once

#include "tc.cuh"

namespace {
namespace fwd_tf32 {

using namespace magi::tc;
using magi::LN2;
using magi::LOG2E;
using magi::META_DIM;

constexpr int KC = 32;  // keys of a chunk

// the output columns one CTA computes (a 128-column half at D = 256), the
// halves of a row, and whether chunks are staged raw by cp.async (else
// read from global memory by the split itself)
template <int D>
constexpr int DV = D > 128 ? 128 : D;
template <int D>
constexpr int NCH = D / DV<D>;
template <int D>
constexpr bool RAW = D <= 128;

// G heads of one kv head, or (G = 1) the BQ / 64 row halves of one head:
// one consumer warpgroup each
template <int G, int BQ>
constexpr int NWG = G * (BQ / 64);

template <int D, int G, int BQ = 64>
struct Smem {
  static constexpr int WG = NWG<G, BQ>;
  static constexpr uint32_t QT = 64 * D * 4;  // one 64-row q tile, hi or lo
  static constexpr uint32_t CT = KC * D * 4;  // one K chunk tile
  static constexpr uint32_t CV = KC * DV<D> * 4;  // one V chunk tile
  static constexpr uint32_t QH = 0;            // [WG][hi, lo] q tiles
  static constexpr uint32_t KR = 2 * WG * QT;  // raw K chunk, row-major
  static constexpr uint32_t VR = KR + (RAW<D> ? CT : 0);  // raw V chunk
  // [NST stages][K hi and lo stacked (64 rows: hi, then lo), V^T hi, lo]
  static constexpr uint32_t ST = VR + (RAW<D> ? CV : 0);
  static constexpr uint32_t STAGE = 2 * CT + 2 * CV;
  // two stages where they fit the opt-in limit (+ 1024: the dynamic
  // window is rounded up to a 1024-byte boundary), else one
  static constexpr int NST = ST + 2 * STAGE + 16 * WG + 1024 <= 232448 ? 2 : 1;
  static constexpr uint32_t RED = ST + NST * STAGE;  // 4 floats a warpgroup
  static constexpr size_t bytes = RED + 16 * WG + 1024;
};

// The raw K and V rows [k0, k0 + KC) of kv head hkv by cp.async, row-major
// (rows at or past sk zero-filled); all NT threads take part.
template <int D, int NT>
__device__ __forceinline__ void load_chunk(uint32_t kr, uint32_t vr,
                                           const float* k, const float* v,
                                           int k0, int sk, int hk, int hkv,
                                           int t) {
  constexpr int CPR = D / 4;  // 16-byte copies a row
  static_assert((KC * CPR) % NT == 0, "copies must divide among threads");
#pragma unroll
  for (int it = 0; it < KC * CPR / NT; ++it) {
    const int i = t + it * NT;
    const int r = i / CPR, c = (i % CPR) * 4;
    const bool ok = k0 + r < sk;
    const long off = ((long)(k0 + r) * hk + hkv) * D + c;
    cp_async16(kr + (r * D + c) * 4, ok ? k + off : k, ok);
    cp_async16(vr + (r * D + c) * 4, ok ? v + off : v, ok);
  }
}

// The raw chunk split into one stage's tiles: K's hi rows 0 .. KC - 1 and
// lo rows KC .. 2 KC - 1 of one 64-row K-major tile (so one m64n64
// product takes Q_hi K_hi and Q_hi K_lo at once), and the hi and lo tiles
// of V^T (D rows of KC keys in kperm order); all NT threads take part.
template <int D, int NT>
__device__ __forceinline__ void split_chunk(uint8_t* stage, const float* kraw,
                                            const float* vraw, int t) {
  static_assert(RAW<D>, "staged chunks are D wide in K and V");
  constexpr uint32_t CT = KC * D * 4;
#pragma unroll 4
  for (int i = t; i < KC * D / 4; i += NT) {  // K: row r, columns c .. c + 3
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    const float4 x = *reinterpret_cast<const float4*>(kraw + r * D + c);
    float4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<float4*>(stage + tile_offset32<2 * KC>(r, c)) = hi;
    *reinterpret_cast<float4*>(stage + tile_offset32<2 * KC>(r + KC, c)) = lo;
  }
#pragma unroll 2
  for (int i = t; i < D * (KC / 8); i += NT) {  // V^T: row n, keys 8 gr ..
    const int n = i % D, gr = i / D;
    float hv[8], lv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j)
      split_tf32(vraw[(gr * 8 + j) * D + n], hv[kpos(j)], lv[kpos(j)]);
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t o = tile_offset32<D>(n, gr * 8 + hf * 4);
      *reinterpret_cast<float4*>(stage + 2 * CT + o) =
          make_float4(hv[4 * hf], hv[4 * hf + 1], hv[4 * hf + 2], hv[4 * hf + 3]);
      *reinterpret_cast<float4*>(stage + 3 * CT + o) =
          make_float4(lv[4 * hf], lv[4 * hf + 1], lv[4 * hf + 2], lv[4 * hf + 3]);
    }
  }
}

// split_chunk's tiles without a raw stage (D = 256): K rows [k0, k0 + KC)
// and the W = DV columns of V from column c0v, of kv head hkv, read from
// global memory (rows at or past sk zero); all NT threads take part.
template <int D, int NT>
__device__ __forceinline__ void split_chunk_global(uint8_t* stage,
                                                   const float* k,
                                                   const float* v, int k0,
                                                   int sk, int hk, int hkv,
                                                   int c0v, int t) {
  constexpr int W = DV<D>;
  constexpr uint32_t CT = KC * D * 4, CV = KC * W * 4;
  const long rs = (long)hk * D;
  const float* kb = k + ((long)k0 * hk + hkv) * D;
  const float* vb = v + ((long)k0 * hk + hkv) * D + c0v;
  const int nv = sk - k0;  // valid rows of the chunk
#pragma unroll 4
  for (int i = t; i < KC * D / 4; i += NT) {  // K: row r, columns c .. c + 3
    const int r = i / (D / 4), c = (i % (D / 4)) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < nv) x = __ldg(reinterpret_cast<const float4*>(kb + r * rs + c));
    float4 hi, lo;
    split_tf32(x.x, hi.x, lo.x);
    split_tf32(x.y, hi.y, lo.y);
    split_tf32(x.z, hi.z, lo.z);
    split_tf32(x.w, hi.w, lo.w);
    *reinterpret_cast<float4*>(stage + tile_offset32<2 * KC>(r, c)) = hi;
    *reinterpret_cast<float4*>(stage + tile_offset32<2 * KC>(r + KC, c)) = lo;
  }
#pragma unroll 2
  for (int i = t; i < W * (KC / 8); i += NT) {  // V^T: row n, keys 8 gr ..
    const int n = i % W, gr = i / W;
    float hv[8], lv[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = gr * 8 + j;
      split_tf32(r < nv ? __ldg(vb + r * rs + n) : 0.f, hv[kpos(j)],
                 lv[kpos(j)]);
    }
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t o = tile_offset32<W>(n, gr * 8 + hf * 4);
      *reinterpret_cast<float4*>(stage + 2 * CT + o) =
          make_float4(hv[4 * hf], hv[4 * hf + 1], hv[4 * hf + 2], hv[4 * hf + 3]);
      *reinterpret_cast<float4*>(stage + 2 * CT + CV + o) =
          make_float4(lv[4 * hf], lv[4 * hf + 1], lv[4 * hf + 2], lv[4 * hf + 3]);
    }
  }
}

template <int D, int G, int BQ, int BK>
__global__ void __launch_bounds__(128 * NWG<G, BQ>, 1)
    ffa_fwd_tf32_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        float* __restrict__ lse,
                        float* __restrict__ max_logits,
                        const int* __restrict__ work_kt,
                        const int* __restrict__ meta,
                        const int* __restrict__ run_ptr, int sq, int sk,
                        int hq, int hk, int num_q_tiles, float scale,
                        float softcap) {
  static_assert(G == 1 || BQ == 64, "a 128-row q tile packs no heads");
  using S = Smem<D, G, BQ>;
  constexpr int NT = 128 * NWG<G, BQ>;
  constexpr int W = DV<D>;  // output columns of this CTA
  constexpr int NACC = W / 2;
  constexpr int NSUB = BK / KC;  // chunks of an item
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
  const int qtile0 = qt * BQ;              // the CTA's first q row
  const int q0 = qtile0 + (wg / G) * 64;   // this warpgroup's first row
  const uint32_t Qh = base + S::QH + 2 * wg * S::QT, Ql = Qh + S::QT;
  const float* kraw = reinterpret_cast<const float*>(smem + S::KR);
  const float* vraw = reinterpret_cast<const float*>(smem + S::VR);

  // the run's chunks in order, (item w, chunk sub), skipping those no live
  // pair of this q tile reaches: a dummy item (an uncovered tile's
  // placeholder), keys past sk, keys outside the item's rectangle or band
  const int w_end = run_ptr[qt + 1];
  auto live_chunk = [&](int w, int sub) {
    const magi::Item it(meta + (long)w * META_DIM);
    const int a = work_kt[w] * BK + sub * KC, b = min(a + KC, sk);
    const int qa = max(qtile0, it.qs), qb = min(qtile0 + BQ, it.qe);
    const int ka = max(max(a, it.ks), qa + it.lo);
    const int kb = min(min(b, it.ke), qb + it.hi);  // qb - 1 + hi, exclusive
    return qa < qb && ka < kb;
  };
  auto next_chunk = [&](int& w, int& sub) {
    do {
      if (sub + 1 < NSUB) {
        ++sub;
      } else {
        ++w;
        sub = 0;
      }
    } while (w < w_end && !live_chunk(w, sub));
  };
  auto load = [&](int w, int sub) {
    if (RAW<D> && w < w_end)
      load_chunk<D, NT>(base + S::KR, base + S::VR, k, v,
                        work_kt[w] * BK + sub * KC, sk, hk, hkv, tid);
    cp_async_commit();
  };
  // the chunk (w, sub) into the stage at st: from the raw buffer, or
  // straight from global memory
  auto split = [&](uint8_t* st, int w, int sub) {
    if constexpr (RAW<D>)
      split_chunk<D, NT>(st, kraw, vraw, tid);
    else
      split_chunk_global<D, NT>(st, k, v, work_kt[w] * BK + sub * KC, sk, hk,
                                hkv, ch * W, tid);
  };

  int w = run_ptr[qt], sub = 0;
  if (w < w_end && !live_chunk(w, sub)) next_chunk(w, sub);
  load(w, sub);

  // each warpgroup's q tile, split into its hi and lo tiles (rows past sq
  // zero)
  {
    const float* qh = q + ((long)q0 * hq + h) * D;
#pragma unroll 4
    for (int i = t; i < 64 * D / 4; i += 128) {
      const int r = i / (D / 4), c = (i % (D / 4)) * 4;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (q0 + r < sq)
        x = __ldg(reinterpret_cast<const float4*>(qh + (long)r * hq * D + c));
      float4 hi, lo;
      split_tf32(x.x, hi.x, lo.x);
      split_tf32(x.y, hi.y, lo.y);
      split_tf32(x.z, hi.z, lo.z);
      split_tf32(x.w, hi.w, lo.w);
      const uint32_t o = tile_offset32<64>(r, c);
      *reinterpret_cast<float4*>(smem + (Qh - base) + o) = hi;
      *reinterpret_cast<float4*>(smem + (Ql - base) + o) = lo;
    }
  }

  // Two stages: the first chunk's tiles into stage 0, then the second
  // chunk's copy; each chunk's products run while the next chunk is split
  // into the other stage. One stage: each chunk is split at the start of
  // its own step.
  int wn = w, subn = sub;
  if (S::NST == 2 && w < w_end) {
    cp_async_wait<0>();
    __syncthreads();
    split(smem + S::ST, w, sub);
    next_chunk(wn, subn);
    fence_async_smem();
    __syncthreads();  // stage 0 is complete, raw is free
    load(wn, subn);
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  // softcap-free scores go straight to the log2 domain; with a softcap the
  // tanh runs on the naturally scaled score first
  const float qk_scale = softcap > 0.f ? scale : scale * LOG2E;

  for (int st = 0; w < w_end; st ^= S::NST - 1) {
    const magi::Item item(meta + (long)w * META_DIM);
    const int kc0 = work_kt[w] * BK + sub * KC;
    const uint32_t Kst = base + S::ST + st * S::STAGE;  // K hi / lo rows
    const uint32_t Vh = Kst + 2 * S::CT, Vl = Vh + S::CV;
    if (S::NST == 1) {  // this chunk's tiles (the last step's products are
                        // done in every warpgroup: the barrier), then the
                        // next chunk's copy
      cp_async_wait<0>();
      __syncthreads();
      split(smem + S::ST, w, sub);
      next_chunk(wn, subn);
      fence_async_smem();
      __syncthreads();  // the stage is complete (and the q tiles at the
                        // first step), raw is free
      load(wn, subn);
    }

    // S = Q K^T of this chunk, issued: [Q_hi K_hi | Q_hi K_lo] in one
    // accumulator's two halves, Q_lo K_hi in another
    float sd[32], se[16];
#pragma unroll
    for (int i = 0; i < 32; ++i) sd[i] = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) se[i] = 0.f;
    fence_regs(sd);
    fence_regs(se);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) {
      wgmma_tf32_ss_n64(sd, desc_k32<64>(Qh, kk), desc_k32<2 * KC>(Kst, kk));
      wgmma_tf32_ss_n32(se, desc_k32<64>(Ql, kk), desc_k32<2 * KC>(Kst, kk));
    }
    wgmma_commit();

    // under it (two stages): the next chunk's tiles into the other stage
    // (its last readers, the previous chunk's products, are done in every
    // warpgroup: the barrier), then the copy after it
    int wnn = wn, subnn = subn;
    if (S::NST == 2 && wn < w_end) {
      cp_async_wait<0>();
      __syncthreads();
      split(smem + S::ST + (st ^ 1) * S::STAGE, wn, subn);
      next_chunk(wnn, subnn);
      fence_async_smem();
      __syncthreads();  // raw is free
      load(wnn, subnn);
    }

    wgmma_wait<0>();
    fence_regs(sd);
    fence_regs(se);
    float rmax[2] = {-INFINITY, -INFINITY};
    float s[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int row = r0 + ((i >> 1) & 1) * 8;
      const int col = (i >> 2) * 8 + c0 + (i & 1);
      float x = (sd[i] + (sd[i + 16] + se[i])) * qk_scale;
      if (softcap > 0.f) x = softcap * tanhf(x / softcap) * LOG2E;
      if (!item.full && !item.live(q0 + row, kc0 + col)) x = -INFINITY;
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
    for (int i = 0; i < 16; ++i) {
      const float p = exp2f(s[i] - m_use[(i >> 1) & 1]);
      s[i] = p;
      l[(i >> 1) & 1] += p;
    }

    // this chunk's P V in a fresh accumulator, small terms first
    uint32_t ph[4][4], pl[4][4];
    to_a_frags_tf32(ph, pl, s);
    float o[NACC];
#pragma unroll
    for (int i = 0; i < NACC; ++i) o[i] = 0.f;
    fence_regs(ph);
    fence_regs(pl);
    fence_regs(o);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KC / 8; ++kk) {
      wgmma_tf32_rs<W>(o, pl[kk], desc_k32<W>(Vh, kk));
      wgmma_tf32_rs<W>(o, ph[kk], desc_k32<W>(Vl, kk));
      wgmma_tf32_rs<W>(o, ph[kk], desc_k32<W>(Vh, kk));
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(o);
    fence_regs(ph);
    fence_regs(pl);
#pragma unroll
    for (int i = 0; i < NACC; ++i) acc[i] = fmaf(acc[i], alpha[(i >> 1) & 1], o[i]);
    w = wn;
    sub = subn;
    wn = wnn;
    subn = subnn;
  }
  cp_async_wait<0>();  // the last (empty) copy group

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int row = q0 + r0 + 8 * hh;
    if (row >= sq) continue;
    const bool empty = l[hh] == 0.f;  // no slice covers this row
    float* orow = out + ((long)row * hq + h) * D + ch * W;
#pragma unroll
    for (int j = 0; j < W / 8; ++j) {
      const float a0 = empty ? 0.f : acc[4 * j + 2 * hh] / l[hh];
      const float a1 = empty ? 0.f : acc[4 * j + 2 * hh + 1] / l[hh];
      *reinterpret_cast<float2*>(orow + 8 * j + c0) = make_float2(a0, a1);
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

// A pair is compiled where the CTA fits and the body takes it: a 128-row q
// tile packs no heads. BK is any multiple of KC (64 or 128 here).
template <int D, int G, int BQ, int BK>
constexpr bool compiled() {
  return Smem<D, G, BQ>::bytes <= magi::SMEM_LIMIT && (G == 1 || BQ == 64) &&
         BK % KC == 0;
}

template <int D, int G, int BQ = 64, int BK = 64>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           float* max_logits, const int* work_kt, const int* meta,
           const int* run_ptr, int sq, int sk, int hq, int hk,
           int num_q_tiles, float scale, float softcap, void* stream) {
  if constexpr (!compiled<D, G, BQ, BK>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    static magi::SmemAllowed smem_ok;
    const size_t smem = Smem<D, G, BQ>::bytes;
    cudaError_t e =
        magi::allow_smem(ffa_fwd_tf32_kernel<D, G, BQ, BK>, smem, &smem_ok);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(num_q_tiles, hq / G, NCH<D>);
    ffa_fwd_tf32_kernel<D, G, BQ, BK>
        <<<grid, 128 * NWG<G, BQ>, smem, (cudaStream_t)stream>>>(
            static_cast<const float*>(q), static_cast<const float*>(k),
            static_cast<const float*>(v), static_cast<float*>(out), lse,
            max_logits, work_kt, meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
            scale, softcap);
    return (int)cudaGetLastError();
  }
}

// The shared memory of an instance, 0 where it is not compiled.
template <int D, int G, int BQ, int BK>
constexpr long smem_bytes() {
  return compiled<D, G, BQ, BK>() ? (long)Smem<D, G, BQ>::bytes : 0;
}

}  // namespace fwd_tf32
}  // namespace
