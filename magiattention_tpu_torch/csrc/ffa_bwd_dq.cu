// FFA backward, dq, over the host-built q-major work list, for Hopper
// (sm_90a): one CTA per (q tile, q head), the split backward's first pass
// (the deterministic mode's dq: each CTA writes its rows once, no atomics).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_bwd_dq_kernel (wrapper
// _ffa_bwd_dq_pallas, pallas_call at ffa.py:931).
//
// Two bodies, each shared with the GQA-packed variant
// (csrc/ffa_bwd_dq_gqa.cu), here at G = 1. bfloat16: at d 64 and 128 and
// 128 x 128, the card's default dq tiles there, csrc/ffa_bwd_dq_ws.cuh (a
// TMA producer warpgroup and two consumer warpgroups, one a 64-row half of
// the q tile; 197,696 bytes at D = 128, one CTA per SM); elsewhere
// csrc/ffa_bwd_dq_tc.cuh, the three products S = Q K^T, dP = dO V^T and
// dQ += dS K on the tensor cores (wgmma, one warpgroup per CTA, K/V
// double-buffered by cp.async), bound by operations at 6 * D flops per
// live pair and head against 989 TFLOP/s; 99,328 bytes of shared memory at
// D = 128, 64 x 64, two CTAs per SM; at
// D = 256 two warpgroups a CTA, one a 128-column half of dq, S and dP run
// once an item and split between them by keys, dS crossing once through
// shared memory (205,824 bytes, one CTA per SM). float32:
// csrc/ffa_bwd_dq.cuh, float32 FMA on the CUDA cores (67 TFLOP/s peak):
// the float32 gate of 1e-5 against the plain version needs float32
// products; Q, dO, K, V at stride D + 4 and the 64 x 80 dS tile, 152 KB at
// D = 128, one CTA per SM; at 256 it splits dq's columns in two halves
// across the grid's z (each half recomputes S and dP over the full width,
// chunking that contraction 128 columns at a time). Head dims 64, 128 and
// 256. Their designs are in the headers.
#include "ffa_bwd_dq.cuh"
#include "ffa_bwd_dq_tc.cuh"
#include "ffa_bwd_dq_ws.cuh"

// Tiles: the bf16 body takes (bq, bk) in {64, 128}^2 wherever the CTA
// fits (csrc/common.cuh MAGI_FFA_TILES; at D = 256 only 64 x 64); the
// float32 CUDA-core body 64 x 64 only. ffa_bwd_dq_smem_bytes says which
// (0 where not compiled).

// q/do [sq, hq, d], k/v [sk, hk, d] are contiguous rows of one dtype;
// lse/delta [sq, hq] and dq [sq, hq, d] float32. work_kt (W,), meta
// (W, 15) and run_ptr (num_q_tiles + 1,) are the plan's q-major int32
// arrays on the device, at the launch's tiles.
extern "C" int ffa_bwd_dq_f32(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, float* dq,
                              const int* work_kt, const int* meta,
                              const int* run_ptr, int sq, int sk, int hq,
                              int hk, int d, int bq, int bk, int num_q_tiles,
                              float scale, float softcap, void* stream) {
  if (bq != 64 || bk != 64) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return launch<float, 64, 1>(q, k, v, dout, lse, delta, dq, work_kt,
                                  meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                                  scale, softcap, stream);
    case 128:
      return launch<float, 128, 1>(q, k, v, dout, lse, delta, dq, work_kt,
                                   meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                                   scale, softcap, stream);
    case 256:
      return launch<float, 256, 1>(q, k, v, dout, lse, delta, dq, work_kt,
                                   meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                                   scale, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ffa_bwd_dq_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, float* dq,
                               const int* work_kt, const int* meta,
                               const int* run_ptr, int sq, int sk, int hq,
                               int hk, int d, int bq, int bk, int num_q_tiles,
                               float scale, float softcap, void* stream) {
#define X(D, BQ, BK)                                                       \
  if (d == D && bq == BQ && bk == BK)                                      \
    return dq_bf16::launch<D, 1, BQ, BK>(q, k, v, dout, lse, delta, dq,    \
                                         work_kt, meta, run_ptr, sq, sk,   \
                                         hq, hk, num_q_tiles, scale,       \
                                         softcap, stream);
  MAGI_FFA_TILES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The shared memory one CTA of an instance takes (bf16: the tensor-core
// body, else the float32 one), for the wrapper's figure to be checked
// against: 0 for an instance this library does not compile.
extern "C" long ffa_bwd_dq_smem_bytes(int d, int bq, int bk, int bf16) {
  if (!bf16) {
    if (bq != 64 || bk != 64) return 0;
    if (d == 64) return (long)DqSmem<64, 1>::bytes;
    if (d == 128) return (long)DqSmem<128, 1>::bytes;
    if (d == 256) return (long)DqSmem<256, 1>::bytes;
    return 0;
  }
#define X(D, BQ, BK) \
  if (d == D && bq == BQ && bk == BK) return dq_bf16::smem_bytes<D, 1, BQ, BK>();
  MAGI_FFA_TILES(X)
#undef X
  return 0;
}
