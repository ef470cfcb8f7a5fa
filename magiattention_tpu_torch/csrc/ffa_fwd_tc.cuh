// The bf16 FFA forward on Hopper's tensor cores, shared by the bf16 entries
// of csrc/ffa_fwd.cu (B1: one q head per CTA, G = 1) and csrc/ffa_fwd_gqa.cu
// (B2: G q heads of one GQA group per CTA). The float32 entries run
// csrc/ffa_fwd_tf32.cuh, the same structure as 3xTF32 (one TF32 product
// would miss the float32 gates).
//
// What it computes: out = softmax(S) V over the live (q, k) pairs of the
// plan's slices, lse in natural log, out 0 and lse -inf on rows no slice
// covers, the optional per-(q tile, head) max of the scaled, softcapped
// logits in natural units, head_dim 64 or 128, ragged last tiles, q tiles
// taken from the last to the first.
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
// What bounds it on this card: operations, 4 * D flops per live pair and
// head on the bf16 tensor cores (989 TFLOP/s on an H100 SXM). Shared
// memory: G q tiles and two stages of K and V, (G + 4) * 64 * D * 2 bytes
// (80 KB at D = 128, G = 1: two CTAs per SM). Registers: the O
// accumulator (D / 2 floats a thread), S (32) and P (16).
#pragma once

#include "tc.cuh"

namespace {
namespace fwd_tc {

using namespace magi::tc;
using magi::LN2;
using magi::LOG2E;
using magi::META_DIM;

constexpr int BQ = 64;
constexpr int BK = 64;

template <int D, int G>
struct Smem {
  static constexpr uint32_t TILE = 64 * D * 2;
  static constexpr uint32_t KV = G * TILE;        // [2 stages][K, V]
  static constexpr uint32_t RED = KV + 4 * TILE;  // 4 floats a warpgroup
  // + 1024: the dynamic window is rounded up to a 1024-byte boundary
  static constexpr size_t bytes = RED + 16 * G + 1024;
};

template <int D, int G>
__global__ void __launch_bounds__(128 * G, 1)
    ffa_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ lse, float* __restrict__ max_logits,
                      const int* __restrict__ work_kt,
                      const int* __restrict__ meta,
                      const int* __restrict__ run_ptr, int sq, int sk, int hq,
                      int hk, int num_q_tiles, float scale, float softcap) {
  using S = Smem<D, G>;
  constexpr int NT = 128 * G;
  constexpr int NACC = D / 2;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x, wg = tid >> 7, t = tid & 127;
  const int warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // rows r0 and r0 + 8 of the tile
  const int c0 = 2 * (lane & 3);  // columns c0, c0 + 1 of each 8-col chunk
  const int qt = num_q_tiles - 1 - (int)blockIdx.x;
  const int h = blockIdx.y * G + wg;
  const int hkv = (int)(blockIdx.y * G) / (hq / hk);
  const int q0 = qt * BQ;
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;
  const uint32_t Qs = base + wg * S::TILE;

  load_tile_async<D, 128>(Qs, q + ((long)q0 * hq + h) * D, q_rs,
                          min(BQ, sq - q0), t);
  cp_async_commit();

  const int w_end = run_ptr[qt + 1];
  auto next_real = [&](int w) {  // skip dummy items of an uncovered tile
    while (w < w_end && magi::Item(meta + (long)w * META_DIM).empty()) ++w;
    return w;
  };
  auto load_kv = [&](int w, int stage) {
    const int k0 = work_kt[w] * BK;
    const uint32_t Ks = base + S::KV + 2 * stage * S::TILE;
    const long off = ((long)k0 * hk + hkv) * D;
    load_tile_async<D, NT>(Ks, k + off, kv_rs, min(BK, sk - k0), tid);
    load_tile_async<D, NT>(Ks + S::TILE, v + off, kv_rs, min(BK, sk - k0),
                           tid);
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
    const uint32_t Ks = base + S::KV + 2 * stage * S::TILE;
    const uint32_t Vs = Ks + S::TILE;

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
    for (int kk = 0; kk < 4; ++kk) wgmma_rs_t1<D>(acc, pa[kk], desc_mn(Vs, kk));
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
    // the tile's max logit of this head: the row maxima of its 4 warps
    float mx = fmaxf(m[0], m[1]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    float* red = reinterpret_cast<float*>(smem + S::RED) + 4 * wg;
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    if (t == 0) {
      const float mm = fmaxf(fmaxf(red[0], red[1]), fmaxf(red[2], red[3]));
      max_logits[(long)qt * hq + h] = mm == -INFINITY ? -INFINITY : mm * LN2;
    }
  }
}

template <int D, int G>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           float* max_logits, const int* work_kt, const int* meta,
           const int* run_ptr, int sq, int sk, int hq, int hk,
           int num_q_tiles, float scale, float softcap, void* stream) {
  static bool smem_ok = false;
  const size_t smem = Smem<D, G>::bytes;
  cudaError_t e = magi::allow_smem(ffa_fwd_tc_kernel<D, G>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_q_tiles, hq / G);
  ffa_fwd_tc_kernel<D, G><<<grid, 128 * G, smem, (cudaStream_t)stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v),
      static_cast<__nv_bfloat16*>(out), lse, max_logits, work_kt, meta,
      run_ptr, sq, sk, hq, hk, num_q_tiles, scale, softcap);
  return (int)cudaGetLastError();
}

}  // namespace fwd_tc
}  // namespace
