// The bf16 FFA forward at head dims 64 and 128, warp-specialised for
// Hopper: B1 (csrc/ffa_fwd.cu, G = 1) at 128 x 128 and B2
// (csrc/ffa_fwd_gqa.cu) at two heads of one kv head on 64 x 128 (G = 2),
// the card's default tiles there. The entries send those bf16 instances
// here (fwd_bf16::WS below); every other bf16 instance keeps the cp.async
// body of csrc/ffa_fwd_tc.cuh, whose function this is.
//
// What it computes: out = softmax(S) V over the live (q, k) pairs of the
// plan's slices, lse in natural log, out 0 and lse -inf on rows no slice
// covers, the optional per-(q tile, head) max of the scaled, softcapped
// logits in natural units, ragged last tiles, q tiles taken from the last
// to the first.
//
// Design (building blocks in csrc/tc.cuh and csrc/tma.cuh). One CTA of
// three warpgroups owns one q tile and G heads, one CTA an SM:
// - warpgroup 0, the producer, drops to 24 registers (setmaxnreg.dec); one
//   thread loads the consumers' two 64-row Q tiles once by TMA, then walks
//   the q tile's run of work items (skipping dummies) and fills a ring of
//   K/V stages by TMA (one box a 64-column panel of the BK-row tile), each
//   completing on its stage's "full" mbarrier; it waits for the stage's
//   "empty" barrier before refilling it. Three stages;
// - warpgroups 1 and 2, the consumers, rise to 240 registers
//   (setmaxnreg.inc); consumer c owns 64 q rows of one head (B1: rows
//   64 c .. of the 128-row tile; B2: head c of the pair) and runs exactly
//   the per-warpgroup code of ffa_fwd_tc.cuh: S = Q K^T (wgmma, operands
//   from shared memory), the online softmax in the exp2 domain, P rounded
//   to bf16 in registers and O += P V (A from registers), on the same
//   fragments in the same order, so out and lse equal that body's at the
//   same tiles to the bit, and B2 equals B1. A consumer issues no load and
//   computes no load address: it waits on "full" and, once its P V has
//   read the stage, arrives on "empty" (one arrival a warp).
// - Inside a consumer (FA3's intra-warpgroup overlap): the next item's S
//   is issued before this item's P V, and its softmax runs while P V is on
//   the tensor cores (two products in flight, S in its own registers); O
//   is rescaled by the item's alpha before its P V is issued, as the
//   cp.async body does. The loop is peeled (the last item's P V follows
//   it): with the next S issued under a branch, ptxas serialized every
//   product of the loop (its C7514 "wgmma serialized" report).
// - Between the consumers (ping-pong): two named barriers hand the turn to
//   issue products from one consumer to the other, so one consumer's
//   softmax runs under the other's products.
// - The elementwise pass is taken once an item on (softcap, item.full) into
//   template instances with the same float operations (softmax_step).
// - Epilogue: O / l to bf16 in the consumer's Q tile (free by then), in
//   the swizzled layout, written by one TMA store a 64-column panel (rows
//   past sq clipped); lse and the max logits as the cp.async body writes
//   them.
//
// What bounds it on this card: operations, 4 * D flops per live pair and
// head on the bf16 tensor cores (989 TFLOP/s on an H100 SXM). Shared
// memory (Smem): two 64-row Q tiles, the K/V stages (BK * D * 4 bytes
// each), 32 bytes for the max-logits reduction, the barriers and 1024
// bytes to align the window: 230,496 bytes at D 128 and BK 128 (three
// stages). Registers: a consumer thread holds O (D / 2 floats), S (BK / 2)
// and P in bf16 (BK / 4), the softmax state and the item's indices.
#pragma once

#include "ffa_fwd_tc.cuh"
#include "tc.cuh"
#include "tma.cuh"

namespace {
namespace fwd_ws {

using namespace magi::tc;
using namespace magi::tma;
using magi::LN2;
using magi::LOG2E;
using magi::META_DIM;

constexpr int NT = 384;

template <int D, int BK>
struct Smem {
  static constexpr uint32_t TILE = 64 * D * 2;  // one consumer's Q tile (its O at the end)
  static constexpr uint32_t KT = BK * D * 2;    // K of a stage
  static constexpr uint32_t STAGE = 2 * KT;     // K, V
  static constexpr uint32_t KV = 2 * TILE;      // [stage][K, V]
  static constexpr int STAGES = 3;
  static constexpr uint32_t RED = KV + STAGES * STAGE;  // 4 floats a consumer
  static constexpr uint32_t BARS = RED + 32;  // q_full, full[STAGES], empty[STAGES]
  // + 1024: the dynamic window is rounded up to a 1024-byte boundary
  static constexpr size_t bytes = BARS + 64 + 1024;
};

__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 + 8 * s; }
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) { return bars + 32 + 8 * s; }

// One item's online-softmax step on S (rows r0 and r0 + 8 of the
// consumer's 64, columns (i >> 2) * 8 + c0 + (i & 1) of the k tile): the
// cp.async body's per-element pass with the softcap (CAP) and the item's
// mask (FULL) fixed for the item, then the row max, alpha (left for the O
// rescale), l and P = exp2(s - m) in place of S. Where FULL leaves no
// select between the scaled score and its use in the exp2, the product is
// taken unfused (__fmul_rn), as the masked form's select leaves it.
template <bool CAP, bool FULL, int NS>
__device__ __forceinline__ void softmax_step(float (&s)[NS], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const magi::Item& item, int q0,
                                             int k0, int r0, int c0, float scale,
                                             float softcap) {
  const float qk_scale = CAP ? scale : scale * LOG2E;
  float rmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    const int row = r0 + ((i >> 1) & 1) * 8;
    const int col = (i >> 2) * 8 + c0 + (i & 1);
    float x;
    if constexpr (CAP) {
      x = s[i] * qk_scale;
      x = FULL ? __fmul_rn(softcap * tanhf(x / softcap), LOG2E)
               : softcap * tanhf(x / softcap) * LOG2E;
    } else {
      x = FULL ? __fmul_rn(s[i], qk_scale) : s[i] * qk_scale;
    }
    if constexpr (!FULL) {
      if (!item.live(q0 + row, k0 + col)) x = -INFINITY;
    }
    s[i] = x;
    rmax[(i >> 1) & 1] = fmaxf(rmax[(i >> 1) & 1], x);
  }
  float m_use[2];
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
}

// softmax_step with its template taken from the item and the softcap (read
// from the kernel's parameters at each item, not kept across the loop)
template <int NS>
__device__ __forceinline__ void softmax_item(float (&s)[NS], float (&m)[2], float (&l)[2],
                                             float (&alpha)[2], const magi::Item& item, int q0,
                                             int k0, int r0, int c0, float scale,
                                             float softcap) {
  if (softcap > 0.f) {
    if (item.full)
      softmax_step<true, true>(s, m, l, alpha, item, q0, k0, r0, c0, scale, softcap);
    else
      softmax_step<true, false>(s, m, l, alpha, item, q0, k0, r0, c0, scale, softcap);
  } else if (item.full) {
    softmax_step<false, true>(s, m, l, alpha, item, q0, k0, r0, c0, scale, softcap);
  } else {
    softmax_step<false, false>(s, m, l, alpha, item, q0, k0, r0, c0, scale, softcap);
  }
}

// S = Q K^T of one item into s (its first k-step with scale-d 0: no
// instruction writes s before the product), issued and committed
template <int D, int BK>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t Qs, uint32_t Ks) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_t00<BK>(s, desc_k(Qs, kk), desc_k<BK>(Ks, kk), kk > 0);
  wgmma_commit();
}

// O *= alpha, then O += P V over the item's BK keys, issued and committed
template <int D, int BK>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2], uint32_t (&pa)[BK / 16][4],
                                         const float (&alpha)[2], uint32_t Vs) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
  fence_regs(pa);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) wgmma_rs_t1<D>(acc, pa[kk], desc_mn<BK>(Vs, kk));
  wgmma_commit();
}

template <int D, int G, int BQ, int BK>
__global__ void __launch_bounds__(NT, 1)
    ffa_fwd_ws_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_o,
                         float* __restrict__ lse, float* __restrict__ max_logits,
                         const int* __restrict__ work_kt, const int* __restrict__ meta,
                         const int* __restrict__ run_ptr, int sq, int hq, int hk,
                         int num_q_tiles, float scale, float softcap) {
  static_assert((D == 64 || D == 128) && ((G == 1 && BQ == 128) || (G == 2 && BQ == 64)),
                "two consumers: the halves of a 128-row q tile, or two heads of a 64-row one");
  using S = Smem<D, BK>;
  constexpr int NACC = D / 2;  // O floats a thread
  constexpr int NS = BK / 2;   // S floats a thread
  constexpr int KS = BK / 16;  // k-steps of P V
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t bars = base + S::BARS, q_full = bars;
  const int tid = threadIdx.x;
  const int qt = num_q_tiles - 1 - (int)blockIdx.x;
  const int hkv = (int)(blockIdx.y * G) / (hq / hk);

  if (tid == 0) {
    mbar_init(q_full, 1);
#pragma unroll
    for (int s = 0; s < S::STAGES; ++s) {
      mbar_init(bar_full(bars, s), 1);   // the TMA thread's arrival
      mbar_init(bar_empty(bars, s), 8);  // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  const int w_end = run_ptr[qt + 1];
  auto next_real = [&](int w) {  // skip dummy items of an uncovered tile
    while (w < w_end && magi::Item(meta + (long)w * META_DIM).empty()) ++w;
    return w;
  };

  if (tid < 128) {  // ---- the producer ----
    setmaxnreg_dec<24>();
    if (tid != 0) return;
    int w = next_real(run_ptr[qt]);
    if (w >= w_end) return;  // an uncovered tile loads nothing
    mbar_arrive_expect_tx(q_full, 2 * S::TILE);
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int p = 0; p < D / 64; ++p)
        load_3d(base + c * S::TILE + p * PANEL_BYTES, &tm_q, q_full, 64 * p,
                (int)blockIdx.y * G + c % G, qt * BQ + (c / G) * 64);
    int stage = 0;
    uint32_t phase = 0;
    for (; w < w_end; w = next_real(w + 1)) {
      mbar_wait(bar_empty(bars, stage), phase ^ 1);
      const int k0 = work_kt[w] * BK;
      const uint32_t full = bar_full(bars, stage);
      const uint32_t Ks = base + S::KV + stage * S::STAGE;
      mbar_arrive_expect_tx(full, S::STAGE);
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        load_3d(Ks + p * (BK * 128), &tm_k, full, 64 * p, hkv, k0);
        load_3d(Ks + S::KT + p * (BK * 128), &tm_v, full, 64 * p, hkv, k0);
      }
      if (++stage == S::STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // ---- the consumers ----
  setmaxnreg_inc<240>();
  const int c = (tid >> 7) - 1;
  const int t = tid & 127, warp = t >> 5, lane = t & 31;
  const int r0 = warp * 16 + (lane >> 2);  // rows r0 and r0 + 8 of the consumer's 64
  const int c0 = 2 * (lane & 3);           // columns c0, c0 + 1 of each 8-column chunk
  const int h = (int)blockIdx.y * G + c % G;
  const int q0 = qt * BQ + (c / G) * 64;  // this consumer's first row
  const uint32_t Qs = base + c * S::TILE;

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, alpha[2];

  int w = next_real(run_ptr[qt]);
  if (w < w_end) {
    // the turn to issue products: consumer c waits on named barrier 1 + c,
    // and hands the turn over by arriving on the other's; consumer 0 takes
    // the first
    if (c == 0) bar_arrive(1, 256);
    mbar_wait(q_full, 0);
    int stage = 0;
    uint32_t phase = 0;
    float s[NS];
    uint32_t pa[KS][4];
    mbar_wait(bar_full(bars, 0), 0);
    bar_sync(1 + c, 256);
    issue_s<D, BK>(s, Qs, base + S::KV);
    bar_arrive(2 - c, 256);
    {
      const magi::Item item(meta + (long)w * META_DIM);
      const int k0 = work_kt[w] * BK;
      w = next_real(w + 1);  // the next real item, found under this S
      wgmma_wait<0>();
      fence_regs(s);
      softmax_item(s, m, l, alpha, item, q0, k0, r0, c0, scale, softcap);
    }
    to_a_frags(pa, s);
    // ---- the consumer's item loop: w is the next item ----
    while (w < w_end) {
      const int ns = stage + 1 == S::STAGES ? 0 : stage + 1;
      const uint32_t nphase = ns == 0 ? phase ^ 1 : phase;
      mbar_wait(bar_full(bars, ns), nphase);
      bar_sync(1 + c, 256);
      issue_s<D, BK>(s, Qs, base + S::KV + ns * S::STAGE);
      issue_pv<D, BK>(acc, pa, alpha, base + S::KV + stage * S::STAGE + S::KT);
      bar_arrive(2 - c, 256);
      {  // the next item's softmax under this P V
        const magi::Item item(meta + (long)w * META_DIM);
        const int k0 = work_kt[w] * BK;
        w = next_real(w + 1);  // its metadata read under the products
        wgmma_wait<1>();
        fence_regs(s);
        softmax_item(s, m, l, alpha, item, q0, k0, r0, c0, scale, softcap);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      if (lane == 0) mbar_arrive(bar_empty(bars, stage));  // this warp is done with K, V
      to_a_frags(pa, s);
      stage = ns;
      phase = nphase;
    }
    // the last item's P V; the other consumer's last turn needs no hand-back
    bar_sync(1 + c, 256);
    issue_pv<D, BK>(acc, pa, alpha, base + S::KV + stage * S::STAGE + S::KT);
    if (c == 0) bar_arrive(2, 256);
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // ---- epilogue: O / l in bf16 through the Q tile, one TMA store a panel ----
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    const int r = r0 + 8 * hh, row = q0 + r;
    const bool empty = l[hh] == 0.f;  // no slice covers this row
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      const float a0 = empty ? 0.f : acc[4 * j + 2 * hh] / l[hh];
      const float a1 = empty ? 0.f : acc[4 * j + 2 * hh + 1] / l[hh];
      *reinterpret_cast<uint32_t*>(smem + c * S::TILE + tile_offset(r, 8 * j + c0)) =
          pack_bf16(a0, a1);
    }
    if ((lane & 3) == 0 && row < sq)
      lse[(long)row * hq + h] = empty ? -INFINITY : (m[hh] + log2f(l[hh])) * LN2;
  }
  fence_async_smem();  // the O tile is visible to the TMA store
  bar_sync(4 + c, 128);
  if (t == 0) {
#pragma unroll
    for (int p = 0; p < D / 64; ++p) store_3d(&tm_o, Qs + p * PANEL_BYTES, 64 * p, h, q0);
    bulk_commit();
  }
  if (max_logits != nullptr) {
    // the tile's max logit of each head: the row maxima of the 4 warps of
    // each consumer of that head
    float mx = fmaxf(m[0], m[1]);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 8));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 16));
    float* red = reinterpret_cast<float*>(smem + S::RED);
    if (lane == 0) red[4 * c + warp] = mx;
    bar_sync(3, 256);
    if (c == 0 && t < G) {  // head blockIdx.y * G + t: consumers t, t + G
      float mm = -INFINITY;
      for (int x = t; x < 2; x += G)
        mm = fmaxf(mm, fmaxf(fmaxf(red[4 * x], red[4 * x + 1]),
                             fmaxf(red[4 * x + 2], red[4 * x + 3])));
      max_logits[(long)qt * hq + blockIdx.y * G + t] = mm == -INFINITY ? -INFINITY : mm * LN2;
    }
  }
  if (t == 0) bulk_wait<0>();  // the O tile is stored before the CTA ends
}

template <int D, int G, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           float* max_logits, const int* work_kt, const int* meta, const int* run_ptr, int sq,
           int sk, int hq, int hk, int num_q_tiles, float scale, float softcap, void* stream) {
  using S = Smem<D, BK>;
  static_assert(S::bytes <= magi::SMEM_LIMIT, "the CTA must fit");
  CUtensorMap tq, tk, tv, to;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_rows(&tq, q, bf16, 2, sq, hq, D, 64, 64) ||
      !encode_rows(&tk, k, bf16, 2, sk, hk, D, 64, BK) ||
      !encode_rows(&tv, v, bf16, 2, sk, hk, D, 64, BK) ||
      !encode_rows(&to, out, bf16, 2, sq, hq, D, 64, 64))
    return (int)cudaErrorInvalidValue;
  static magi::SmemAllowed smem_ok;
  cudaError_t e = magi::allow_smem(ffa_fwd_ws_tc_kernel<D, G, BQ, BK>, S::bytes, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_q_tiles, hq / G);
  ffa_fwd_ws_tc_kernel<D, G, BQ, BK><<<grid, NT, S::bytes, (cudaStream_t)stream>>>(
      tq, tk, tv, to, lse, max_logits, work_kt, meta, run_ptr, sq, hq, hk, num_q_tiles, scale,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace fwd_ws
}  // namespace

namespace {
namespace fwd_bf16 {

// The body of each bf16 forward instance: the warp-specialised one above
// at the card's default tiles at d 64 and 128 (kernels/ffa.py
// card_fwd_params: B1 at 128 x 128, B2 at two heads of 64 x 128),
// ffa_fwd_tc.cuh's everywhere else.
template <int D, int G, int BQ, int BK>
constexpr bool WS = (D == 64 || D == 128) && BK == 128 &&
                    ((G == 1 && BQ == 128) || (G == 2 && BQ == 64));

template <int D, int G, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, void* out, float* lse,
           float* max_logits, const int* work_kt, const int* meta, const int* run_ptr, int sq,
           int sk, int hq, int hk, int num_q_tiles, float scale, float softcap, void* stream) {
  if constexpr (WS<D, G, BQ, BK>)
    return fwd_ws::launch<D, G, BQ, BK>(q, k, v, out, lse, max_logits, work_kt, meta, run_ptr,
                                        sq, sk, hq, hk, num_q_tiles, scale, softcap, stream);
  else
    return fwd_tc::launch<D, G, BQ, BK>(q, k, v, out, lse, max_logits, work_kt, meta, run_ptr,
                                        sq, sk, hq, hk, num_q_tiles, scale, softcap, stream);
}

// The shared memory of an instance, 0 where it is not compiled.
template <int D, int G, int BQ, int BK>
constexpr long smem_bytes() {
  if constexpr (WS<D, G, BQ, BK>)
    return (long)fwd_ws::Smem<D, BK>::bytes;
  else
    return fwd_tc::smem_bytes<D, G, BQ, BK>();
}

}  // namespace fwd_bf16
}  // namespace
