// FFA forward over the host-built q-major work list, for Hopper (sm_90a):
// one CTA per (q tile, q head).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_fwd_kernel (wrapper
// _ffa_fwd_pallas, pallas_call at ffa.py:462), with its optional
// max-logits output (ffa.py:130, :482-487).
//
// Two bodies, each shared with the GQA-packed variant (csrc/ffa_fwd_gqa.cu),
// here at G = 1, both on the tensor cores (wgmma, one warpgroup per CTA).
// bfloat16: csrc/ffa_fwd_tc.cuh (K/V double-buffered by cp.async; 80 KB of
// shared memory at D = 128, two CTAs per SM), and at 128 x 128 and D = 64
// or 128, the card's default there, csrc/ffa_fwd_ws.cuh (a TMA producer
// warpgroup, two consumer warpgroups; bit for bit the cp.async body).
// float32: csrc/ffa_fwd_tf32.cuh,
// 3xTF32 (each operand split into tf32 hi and lo, three products a pair, so
// the serving replay tolerance holds; one TF32 product would not), each
// chunk's split under the previous chunk's products; 225 KB at D = 128,
// one CTA per SM. Head dims 64, 128 and 256; at 256 the bf16 body writes
// all 256 columns from one CTA (two warpgroups at a 128-row q tile; one, two
// CTAs an SM, at 64 x 64) and the float32 body splits the output columns in
// two halves across the grid's z (each half recomputes S over the full
// width). Their designs and what bounds them are in the headers.
//
// Max-logits: the TPU kernel keeps a per-(head, q tile) running max of the
// scaled, softcapped logits and reduces it on the host. Here the running
// row max m of the online softmax is that max already, in the exp2 domain
// (scale * log2(e) folded into the scores; softcapped scores are scaled by
// log2(e) after the tanh), so each CTA reduces its 64 rows' m, converts
// with ln(2) and writes one float per (q tile, head); the wrapper takes the
// max over q tiles. A nullptr skips it.
#include "ffa_fwd_ws.cuh"
#include "ffa_fwd_tf32.cuh"

// Tiles: (bq, bk) in {64, 128}^2 wherever the CTA fits (csrc/common.cuh
// MAGI_FFA_TILES; ffa_fwd_smem_bytes says which: 0 where not compiled).
// The plan's tiles must be the launch's: the kernel reads work_kt * bk and
// its q tile t as rows [t * bq, t * bq + bq).

// q [sq, hq, d], k/v [sk, hk, d] and out [sq, hq, d] are contiguous rows of
// one dtype; lse [sq, hq] float32; max_logits [num_q_tiles, hq] float32 or
// nullptr. work_kt (W,), meta (W, 15) and run_ptr (num_q_tiles + 1,) are the
// plan's int32 arrays on the device.
extern "C" int ffa_fwd_f32(const void* q, const void* k, const void* v,
                           void* out, float* lse, float* max_logits,
                           const int* work_kt, const int* meta,
                           const int* run_ptr, int sq, int sk, int hq, int hk,
                           int d, int bq, int bk, int num_q_tiles,
                           float scale, float softcap, void* stream) {
#define X(D, BQ, BK)                                                        \
  if (d == D && bq == BQ && bk == BK)                                       \
    return fwd_tf32::launch<D, 1, BQ, BK>(q, k, v, out, lse, max_logits,    \
                                          work_kt, meta, run_ptr, sq, sk,   \
                                          hq, hk, num_q_tiles, scale,       \
                                          softcap, stream);
  MAGI_FFA_TILES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

extern "C" int ffa_fwd_bf16(const void* q, const void* k, const void* v,
                            void* out, float* lse, float* max_logits,
                            const int* work_kt, const int* meta,
                            const int* run_ptr, int sq, int sk, int hq, int hk,
                            int d, int bq, int bk, int num_q_tiles,
                            float scale, float softcap, void* stream) {
#define X(D, BQ, BK)                                                        \
  if (d == D && bq == BQ && bk == BK)                                       \
    return fwd_bf16::launch<D, 1, BQ, BK>(q, k, v, out, lse, max_logits,      \
                                        work_kt, meta, run_ptr, sq, sk, hq, \
                                        hk, num_q_tiles, scale, softcap,    \
                                        stream);
  MAGI_FFA_TILES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The shared memory one CTA of an instance takes (bf16: csrc/ffa_fwd_tc.cuh,
// else csrc/ffa_fwd_tf32.cuh), for the wrapper's figure to be checked
// against: 0 for an instance this library does not compile.
extern "C" long ffa_fwd_smem_bytes(int d, int bq, int bk, int bf16) {
#define X(D, BQ, BK)                                                  \
  if (d == D && bq == BQ && bk == BK)                                 \
    return bf16 ? fwd_bf16::smem_bytes<D, 1, BQ, BK>()                  \
                : fwd_tf32::smem_bytes<D, 1, BQ, BK>();
  MAGI_FFA_TILES(X)
#undef X
  return 0;
}
