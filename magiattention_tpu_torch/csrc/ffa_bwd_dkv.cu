// FFA backward, dk and dv, over the host-built k-major work list, for
// Hopper (sm_90a): the split backward's second pass (the deterministic
// mode's dk/dv: one CTA owns a (k tile, kv head) and writes its rows once,
// no atomics).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_bwd_dkv_kernel (wrapper
// _ffa_bwd_dkv_pallas, pallas_call at ffa.py:1432) and its GQA-packed twin
// _bwd_dkv_kernel_gqa (wrapper _ffa_bwd_dkv_pallas_gqa, pallas_call at
// ffa.py:1657). One kernel does both: it always loops the query group.
//
// Two bodies, each shared with the fused backward (csrc/ffa_bwd_fused.cu),
// here without dq. bfloat16: the four products S^T, dP^T, P^T dO and dS^T Q
// on the tensor cores (wgmma, the last two as bf16 hi + lo pairs), bound by
// operations at 8 * D flops per live pair and q head against 989 TFLOP/s;
// at 64 x 128 and D = 64 or 128 (the card's default k-major tile there)
// csrc/bwd_kv_ws.cuh (FUSED false: a TMA producer warpgroup and two
// consumer warpgroups, 166,528 bytes at D = 128, one CTA an SM), at every
// other tile and at D = 256 csrc/bwd_kv_tc.cuh (cp.async; 100,352 bytes at
// D = 128, 64 x 64, two CTAs per SM). Either body's dk and dv equal the
// fused kernel's at the same tile to the bit. float32: csrc/bwd_kv.cuh (FUSED false), float32 FMA on the CUDA
// cores (67 TFLOP/s peak): the float32 gate of 1e-5 against the plain
// version needs float32 products; 173 KB of shared memory at D = 128, one
// CTA per SM. Head dims 64, 128 and 256; at 256 the bf16 body runs two
// warpgroups on one 64-row k tile, one a column half of dk and dv, with
// S^T and dP^T computed once (231,424 bytes, one CTA an SM), and the
// float32 body splits dk's and dv's columns in two halves across the
// grid's z (each half recomputes S^T and dP^T over the full width,
// chunking that contraction 128 columns at a time).
#include "bwd_kv.cuh"
#include "bwd_kv_ws.cuh"

// Tiles: the bf16 body takes (bq, bk) in {64, 128}^2 wherever the CTA
// fits (csrc/common.cuh MAGI_FFA_TILES; at D = 256 only 64 x 64); the
// float32 CUDA-core body 64 x 64 only. ffa_bwd_dkv_smem_bytes says which (0
// where not compiled).

// q/do [sq, hq, d], k/v [sk, hk, d] are contiguous rows of one dtype;
// lse/delta [sq, hq] float32; dk/dv [sk, hk, d] float32, every row written.
// work_qt_t (W_t,), meta_t (W_t, 15) and run_ptr_t (num_k_tiles + 1,) are
// the plan's k-major int32 arrays on the device, at the launch's tiles.
extern "C" int ffa_bwd_dkv_f32(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, float* dk, float* dv,
                               const int* work_qt_t, const int* meta_t,
                               const int* run_ptr_t, int sq, int sk, int hq,
                               int hk, int d, int bq, int bk, int num_k_tiles,
                               float scale, float softcap, void* stream) {
  if (bq != 64 || bk != 64) return (int)cudaErrorInvalidValue;
  return dispatch<float, false>(d, q, k, v, dout, lse, delta, dk, dv, nullptr,
                                work_qt_t, meta_t, run_ptr_t, sq, sk, hq, hk,
                                num_k_tiles, scale, softcap, stream);
}

extern "C" int ffa_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, float* dk, float* dv,
                                const int* work_qt_t, const int* meta_t,
                                const int* run_ptr_t, int sq, int sk, int hq,
                                int hk, int d, int bq, int bk,
                                int num_k_tiles, float scale, float softcap,
                                void* stream) {
#define X(D, BQ, BK)                                                        \
  if (d == D && bq == BQ && bk == BK)                                       \
    return kv_bf16::launch<D, false, BQ, BK>(q, k, v, dout, lse, delta, dk,   \
                                           dv, nullptr, work_qt_t, meta_t,  \
                                           run_ptr_t, sq, sk, hq, hk,       \
                                           num_k_tiles, scale, softcap,     \
                                           stream);
  MAGI_FFA_TILES(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The shared memory one CTA of an instance takes (bf16: the tensor-core
// body, else the float32 one), for the wrapper's figure to be checked
// against: 0 for an instance this library does not compile.
extern "C" long ffa_bwd_dkv_smem_bytes(int d, int bq, int bk, int bf16) {
  if (!bf16) {
    if (bq != 64 || bk != 64) return 0;
    if (d == 64) return (long)DkvSmem<64>::bytes;
    if (d == 128) return (long)DkvSmem<128>::bytes;
    if (d == 256) return (long)DkvSmem<256>::bytes;
    return 0;
  }
#define X(D, BQ, BK)                   \
  if (d == D && bq == BQ && bk == BK) \
    return kv_bf16::smem_bytes<D, false, BQ, BK>();
  MAGI_FFA_TILES(X)
#undef X
  return 0;
}
