// The bf16 FFA dq backward at head dims 64 and 128, warp-specialised for
// Hopper: B3 (csrc/ffa_bwd_dq.cu, G = 1) at 128 x 128 and B4
// (csrc/ffa_bwd_dq_gqa.cu) at two heads of one kv head on 64 x 128 (G =
// 2): two 64-row halves or two heads over the same k tile, the card's
// default dq tiles there (128 x 64, three K/V stages, timed no faster:
// tools/ablate_dq.py's bk64 candidate).
// The entries send those bf16 instances here (dq_bf16::WS below); every
// other bf16 instance keeps the cp.async body of csrc/ffa_bwd_dq_tc.cuh,
// whose function this is.
//
// Replaces: magiattention_tpu/kernels/ffa.py:_bwd_dq_kernel (pallas_call
// at ffa.py:931) and _bwd_dq_kernel_gqa (pallas_call at ffa.py:1151).
//
// What it computes: for every q head h and q row i, dq[i] = scale * sum_j
// dS[i, j] k[j] over the k rows j some slice lets row i see, dS = P (dP -
// delta[i]) (times 1 - tanh^2 under a softcap), P = exp(s - lse[i]) from
// the forward's natural-log lse, 0 where the pair is masked or lse = -inf,
// so a row no slice covers gets dq = 0 exactly; float32 out, each row
// written once (no atomics: the deterministic mode's dq).
//
// Design (building blocks in csrc/tc.cuh and csrc/tma.cuh; the structure
// of the forward, csrc/ffa_fwd_ws.cuh). One CTA of three warpgroups owns
// one q tile and G heads, one CTA an SM:
// - warpgroup 0, the producer, drops to 24 registers (setmaxnreg.dec); one
//   thread loads the consumers' Q and dO tiles once by TMA (one box a
//   64-column panel), then walks the q tile's run of work items (skipping
//   dummies) and fills a ring of K/V stages by TMA, each completing on its
//   stage's "full" mbarrier; it waits for the stage's "empty" barrier
//   before refilling it;
// - warpgroups 1 and 2, the consumers, rise to 240 registers
//   (setmaxnreg.inc); consumer c owns 64 q rows of one head (B3: rows
//   64 c .. of the 128-row tile; B4: head c of the pair, so B4's rows run
//   B3's code on the same k tiles and equal B3's to the bit), holds their
//   lse and delta and its dQ in registers for the run and runs, per 64-key
//   block of each item, exactly the cp.async body's per-warpgroup
//   sequence: S = Q K^T and dP = dO V^T (wgmma m64n64k16, operands from
//   shared memory), the elementwise pass, dS rounded once to bf16 into A
//   fragments in registers, dQ += dS K (m64nDk16, K read MN-major), so dq
//   equals that body's at the same tiles to the bit. A 64-row half whose
//   pairs in an item are all masked adds exact zeros. A consumer issues no
//   load and computes no load address: it waits on "full" and, once the
//   item's last dQ product has read the stage, arrives on "empty" (one
//   arrival a warp).
// - Inside a consumer: the next block's S and dP are issued before this
//   block's dQ += dS K, and the next block's elementwise pass runs while
//   that product is on the tensor cores; this block's dS waits in its A
//   fragments, so S and dP reuse their registers. The loop is peeled (the
//   last block's dQ product follows it): a product issued under a branch
//   made ptxas serialize every wgmma of the forward's loop (C7514).
// - Between the consumers (ping-pong): two named barriers hand the turn to
//   issue products from one consumer to the other, so one consumer's
//   elementwise pass runs under the other's products.
// - The elementwise pass is taken once a block on (softcap, item.full and
//   the thread's rows' lse finite) into template instances (ds_step) with
//   the cp.async body's float operations as its compiled code runs them:
//   the scaled (softcapped) score less the row's lse is one multiply-add
//   there, written out here (__fmaf_rn), so no template instance rounds it
//   otherwise. The full form has no select left: with the rows' lse test
//   inside it, ptxas predicated every element's exp on it and the pass
//   took a third more time (tools/ablate_dq.py, its lse_select form).
// - Epilogue: dQ * scale straight from the accumulator to dq (rows past sq
//   skipped), once per (q tile, head).
//
// What the cp.async body's ranking said (tools/ablate_dq.py, PERF.md §6),
// and what this does about it: that body ran one chain per block in every
// warpgroup (S and dP, wait, the pass, dQ, wait), so the pass and the dQ
// product behind it were each about half of its time, tested the softcap
// and the mask per element (a fifth), and issued its own cp.async loads
// with two __syncthreads an item; here the loads leave the consumers, the
// pass runs under products (this consumer's last dQ and the other
// consumer's), and the tests are taken once a block.
//
// What bounds it on this card: operations, 6 * D flops per live pair and
// head on the bf16 tensor cores (989 TFLOP/s on an H100 SXM). Shared
// memory (Smem): the two consumers' Q and dO tiles, two K/V stages (BK * D
// * 4 bytes each), the barriers and 1024 bytes to align the window:
// 197,696 bytes at D 128. Registers: a consumer thread holds dQ (D / 2
// floats), S and dP (32 each), dS's A fragments (16), the rows' lse and
// delta.
#pragma once

#include "ffa_bwd_dq_tc.cuh"
#include "tc.cuh"
#include "tma.cuh"

namespace {
namespace dq_ws {

using namespace magi::tc;
using namespace magi::tma;
using magi::LOG2E;
using magi::META_DIM;

constexpr int NT = 384;

template <int D, int BK>
struct Smem {
  static constexpr uint32_t TILE = 64 * D * 2;  // one consumer's Q or dO tile
  static constexpr uint32_t KT = BK * D * 2;    // K (or V) of a stage
  static constexpr uint32_t STAGE = 2 * KT;     // K, V
  static constexpr uint32_t KV = 4 * TILE;      // after [consumer][Q, dO]
  static constexpr int STAGES = 2;
  static constexpr uint32_t BARS = KV + STAGES * STAGE;  // q_full, full[], empty[]
  // + 1024: the dynamic window is rounded up to a 1024-byte boundary
  static constexpr size_t bytes = BARS + 64 + 1024;
};

__device__ __forceinline__ uint32_t bar_full(uint32_t bars, int s) { return bars + 8 + 8 * s; }
__device__ __forceinline__ uint32_t bar_empty(uint32_t bars, int s) { return bars + 32 + 8 * s; }

// dS = P (dP - delta) (times 1 - tanh^2 under a softcap) in place of dP,
// from S, for the m64n64 accumulators of one 64-key block (q rows r0 and
// r0 + 8 of the consumer's 64 from q0, keys (i >> 2) * 8 + c0 + (i & 1)
// from k0): the cp.async body's per-element pass with the softcap (CAP)
// fixed for the block, and FULL where every pair of the block is live (a
// full item, both rows' lse finite), so no select is left: P is the exp,
// taken for every element and set to 0 where the pair is masked, which is
// the cp.async body's select. Scores are in the log2 domain unless capped
// (lse with them).
template <bool CAP, bool FULL>
__device__ __forceinline__ void ds_step(float (&dp)[32], const float (&s)[32],
                                        const float (&lse)[2], const float (&delta)[2],
                                        const magi::Item& item, int q0, int k0, int r0, int c0,
                                        float scale, float softcap) {
  const float qk_scale = CAP ? scale : scale * LOG2E;
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    const int hh = (i >> 1) & 1;
    const int row = r0 + hh * 8;
    const int col = (i >> 2) * 8 + c0 + (i & 1);
    float e, dcap = 1.f;  // the (softcapped) scaled score less the row's lse
    if constexpr (CAP) {
      const float th = tanhf(s[i] * qk_scale / softcap);
      e = __fmaf_rn(softcap, th, -lse[hh]);
      dcap = 1.f - th * th;
    } else {
      e = __fmaf_rn(s[i], qk_scale, -lse[hh]);
    }
    float p = CAP ? expf(e) : exp2f(e);
    if constexpr (!FULL) {
      if (!(lse[hh] != -INFINITY && item.live(q0 + row, k0 + col))) p = 0.f;
    }
    dp[i] = p * (dp[i] - delta[hh]) * dcap;
  }
}

// ds_step with its template taken from the item, the thread's rows and the
// softcap (read from the kernel's parameters at each block, not kept
// across the loop)
__device__ __forceinline__ void ds_block(float (&dp)[32], const float (&s)[32],
                                         const float (&lse)[2], const float (&delta)[2],
                                         const magi::Item& item, int q0, int k0, int r0, int c0,
                                         float scale, float softcap) {
  const bool full = item.full && lse[0] != -INFINITY && lse[1] != -INFINITY;
  if (softcap > 0.f) {
    if (full)
      ds_step<true, true>(dp, s, lse, delta, item, q0, k0, r0, c0, scale, softcap);
    else
      ds_step<true, false>(dp, s, lse, delta, item, q0, k0, r0, c0, scale, softcap);
  } else if (full) {
    ds_step<false, true>(dp, s, lse, delta, item, q0, k0, r0, c0, scale, softcap);
  } else {
    ds_step<false, false>(dp, s, lse, delta, item, q0, k0, r0, c0, scale, softcap);
  }
}

// S = Q K^T and dP = dO V^T of one 64-key block (K at Ks, V KT bytes on),
// issued and committed as one group
template <int D, int BK>
__device__ __forceinline__ void issue_sdp(float (&s)[32], float (&dp)[32], uint32_t Qs,
                                          uint32_t dOs, uint32_t Ks) {
  const uint32_t Vs = Ks + Smem<D, BK>::KT;
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
}

// dQ += dS K over one 64-key block (dS in A fragments), issued and committed
template <int D, int BK>
__device__ __forceinline__ void issue_dq(float (&acc)[D / 2], uint32_t (&da)[4][4],
                                         uint32_t Ks) {
  fence_regs(da);
  fence_regs(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) wgmma_rs_t1<D>(acc, da[kk], desc_mn<BK>(Ks, kk));
  wgmma_commit();
}

template <int D, int G, int BQ, int BK>
__global__ void __launch_bounds__(NT, 1)
    ffa_bwd_dq_ws_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const float* __restrict__ lse, const float* __restrict__ delta,
                            float* __restrict__ dq, const int* __restrict__ work_kt,
                            const int* __restrict__ meta, const int* __restrict__ run_ptr,
                            int sq, int hq, int hk, int num_q_tiles, float scale,
                            float softcap) {
  static_assert((D == 64 || D == 128) && ((G == 1 && BQ == 128) || (G == 2 && BQ == 64)),
                "two consumers: the halves of a 128-row q tile, or two heads of a 64-row one");
  using S = Smem<D, BK>;
  constexpr int NACC = D / 2;  // dQ floats a thread
  constexpr int NB = BK / 64;  // 64-key blocks an item
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
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
    mbar_arrive_expect_tx(q_full, 4 * S::TILE);
#pragma unroll
    for (int c = 0; c < 2; ++c)
#pragma unroll
      for (int p = 0; p < D / 64; ++p) {
        const uint32_t dst = base + 2 * c * S::TILE + p * PANEL_BYTES;
        const int h = (int)blockIdx.y * G + c % G, row = qt * BQ + (c / G) * 64;
        load_3d(dst, &tm_q, q_full, 64 * p, h, row);
        load_3d(dst + S::TILE, &tm_do, q_full, 64 * p, h, row);
      }
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
  const uint32_t Qs = base + 2 * c * S::TILE, dOs = Qs + S::TILE;

  // as the cp.async body: scores in the log2 domain unless capped, lse with
  // them; rows past sq and rows no slice covers have lse = -inf (P = 0)
  float row_lse[2], row_delta[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    const long at = (long)row * hq + h;
    const float l = row < sq ? lse[at] : -INFINITY;
    row_lse[hh] = softcap > 0.f ? l : l * LOG2E;
    row_delta[hh] = row < sq ? delta[at] : 0.f;
  }

  float acc[NACC];
#pragma unroll
  for (int i = 0; i < NACC; ++i) acc[i] = 0.f;

  int w = next_real(run_ptr[qt]);
  if (w < w_end) {
    // the turn to issue products: consumer c waits on named barrier 1 + c,
    // and hands the turn over by arriving on the other's; consumer 0 takes
    // the first
    if (c == 0) bar_arrive(1, 256);
    mbar_wait(q_full, 0);
    // the block to issue next: 64-key block j of item w in stage `stage`;
    // once its S and dP are issued, (w, j) moves on at once (the next
    // item's metadata is read under the products) and the pass reads the
    // issued block (bw, bj); da holds the dS of block dj of the item in
    // stage ds_stage
    int stage = 0, j = 0;
    uint32_t phase = 0;
    float s[32], dp[32];
    uint32_t da[4][4];
    auto block_at = [&](int st, int jj) { return base + S::KV + st * S::STAGE + jj * 8192; };
    // the next block after (w, j): the item's next, or the next real
    // item's first in the next stage
    auto advance = [&] {
      if (++j == NB) {
        j = 0;
        w = next_real(w + 1);
        if (++stage == S::STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    };
    mbar_wait(bar_full(bars, 0), 0);
    bar_sync(1 + c, 256);
    issue_sdp<D, BK>(s, dp, Qs, dOs, block_at(0, 0));
    bar_arrive(2 - c, 256);
    int bw = w, bj = j, ds_stage = stage;
    advance();
    {
      const magi::Item item(meta + (long)bw * META_DIM);
      const int k0 = work_kt[bw] * BK;
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      ds_block(dp, s, row_lse, row_delta, item, q0, k0, r0, c0, scale, softcap);
    }
    to_a_frags(da, dp);
    int dj = bj;
    // ---- the consumer's block loop: (w, j) is the next block ----
    while (w < w_end) {
      mbar_wait(bar_full(bars, stage), phase);  // at once within an item
      bar_sync(1 + c, 256);
      issue_sdp<D, BK>(s, dp, Qs, dOs, block_at(stage, j));
      issue_dq<D, BK>(acc, da, block_at(ds_stage, dj));
      bar_arrive(2 - c, 256);
      const int bstage = stage;
      bw = w;
      bj = j;
      advance();
      {  // the issued block's pass under the last block's dQ product
        const magi::Item item(meta + (long)bw * META_DIM);
        const int k0 = work_kt[bw] * BK + 64 * bj;
        wgmma_wait<1>();
        fence_regs(s);
        fence_regs(dp);
        ds_block(dp, s, row_lse, row_delta, item, q0, k0, r0, c0, scale, softcap);
      }
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(da);
      // this warp is done with the stage once its item's last block's dQ ran
      if (dj == NB - 1 && lane == 0) mbar_arrive(bar_empty(bars, ds_stage));
      to_a_frags(da, dp);
      ds_stage = bstage;
      dj = bj;
    }
    // the last block's dQ; the other consumer's last turn needs no hand-back
    bar_sync(1 + c, 256);
    issue_dq<D, BK>(acc, da, block_at(ds_stage, dj));
    if (c == 0) bar_arrive(2, 256);
    wgmma_wait<0>();
    fence_regs(acc);
  }

  // one write per (q tile, head); the scale folds in here (dS carries none)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int row = q0 + r0 + 8 * hh;
    if (row >= sq) continue;
    float* o = dq + ((long)row * hq + h) * D;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj)
      *reinterpret_cast<float2*>(o + 8 * jj + c0) =
          make_float2(acc[4 * jj + 2 * hh] * scale, acc[4 * jj + 2 * hh + 1] * scale);
  }
}

template <int D, int G, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dq, const int* work_kt, const int* meta,
           const int* run_ptr, int sq, int sk, int hq, int hk, int num_q_tiles, float scale,
           float softcap, void* stream) {
  using S = Smem<D, BK>;
  static_assert(S::bytes <= magi::SMEM_LIMIT, "the CTA must fit");
  CUtensorMap tq, tdo, tk, tv;
  const CUtensorMapDataType bf16 = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!encode_rows(&tq, q, bf16, 2, sq, hq, D, 64, 64) ||
      !encode_rows(&tdo, dout, bf16, 2, sq, hq, D, 64, 64) ||
      !encode_rows(&tk, k, bf16, 2, sk, hk, D, 64, BK) ||
      !encode_rows(&tv, v, bf16, 2, sk, hk, D, 64, BK))
    return (int)cudaErrorInvalidValue;
  static magi::SmemAllowed smem_ok;
  cudaError_t e = magi::allow_smem(ffa_bwd_dq_ws_tc_kernel<D, G, BQ, BK>, S::bytes, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_q_tiles, hq / G);
  ffa_bwd_dq_ws_tc_kernel<D, G, BQ, BK><<<grid, NT, S::bytes, (cudaStream_t)stream>>>(
      tq, tdo, tk, tv, lse, delta, dq, work_kt, meta, run_ptr, sq, hq, hk, num_q_tiles, scale,
      softcap);
  return (int)cudaGetLastError();
}

}  // namespace dq_ws
}  // namespace

namespace {
namespace dq_bf16 {

// The body of each bf16 dq instance: the warp-specialised one above at the
// card's default dq tiles at d 64 and 128 (kernels/ffa.py card_bwd_params:
// B3 at 128 x 128, B4 at two heads of 64 x 128), ffa_bwd_dq_tc.cuh's
// everywhere else.
template <int D, int G, int BQ, int BK>
constexpr bool WS = (D == 64 || D == 128) && BK == 128 &&
                    ((G == 1 && BQ == 128) || (G == 2 && BQ == 64));

template <int D, int G, int BQ, int BK>
int launch(const void* q, const void* k, const void* v, const void* dout, const float* lse,
           const float* delta, float* dq, const int* work_kt, const int* meta,
           const int* run_ptr, int sq, int sk, int hq, int hk, int num_q_tiles, float scale,
           float softcap, void* stream) {
  if constexpr (WS<D, G, BQ, BK>)
    return dq_ws::launch<D, G, BQ, BK>(q, k, v, dout, lse, delta, dq, work_kt, meta, run_ptr,
                                       sq, sk, hq, hk, num_q_tiles, scale, softcap, stream);
  else
    return dq_tc::launch<D, G, BQ, BK>(q, k, v, dout, lse, delta, dq, work_kt, meta, run_ptr,
                                       sq, sk, hq, hk, num_q_tiles, scale, softcap, stream);
}

// The shared memory of an instance, 0 where it is not compiled.
template <int D, int G, int BQ, int BK>
constexpr long smem_bytes() {
  if constexpr (WS<D, G, BQ, BK>)
    return (long)dq_ws::Smem<D, BK>::bytes;
  else
    return dq_tc::smem_bytes<D, G, BQ, BK>();
}

}  // namespace dq_bf16
}  // namespace
