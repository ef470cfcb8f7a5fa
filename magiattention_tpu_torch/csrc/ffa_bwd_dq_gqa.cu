// GQA-packed FFA backward, dq, over the host-built q-major work list, for
// Hopper (sm_90a): one CTA per (q tile, block of G q heads of one kv head).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_bwd_dq_kernel_gqa (wrapper
// _ffa_bwd_dq_pallas_gqa, pallas_call at ffa.py:1151).
//
// The TPU kernel stacks the g heads of a kv head into (g * bq)-row S and
// dP products so each K/V block is fetched once per work item for the
// group, with lse/delta tile-packed on the host. Here the CTA keeps the G
// heads' Q and dO tiles in shared memory, loads each item's k and v tiles
// once for the G heads, and runs the per-head body of the unpacked kernel
// once per head against them; lse and delta are read from the [sq, hq] rows
// directly. The per-row arithmetic and its order are the unpacked kernel's,
// so dq is bit-identical to csrc/ffa_bwd_dq.cu on the same inputs; only the
// grid differs. No atomics: the deterministic mode may take this kernel.
//
// Two bodies, as in csrc/ffa_bwd_dq.cu. bfloat16: at d 64 and 128 and two
// heads of 64 x 128, the card's default packed dq tiles there,
// csrc/ffa_bwd_dq_ws.cuh (a TMA producer warpgroup and a consumer
// warpgroup a head, 197,696 bytes at D = 128); elsewhere
// csrc/ffa_bwd_dq_tc.cuh, one warpgroup per head on the tensor cores;
// shared memory (2 G + 4) * 64 * D * 2 + 1024 bytes (G Q and dO tiles, two
// stages of K and V) and a thread's registers (the dQ accumulator, D / 2, beside S, dP and dS's
// fragments) make G 2 at D = 64 and 128 (132,096 bytes at D = 128; four
// warpgroups would leave 128 registers a thread). At D = 256 the CTA's two
// column warpgroups walk the G = 2 heads in turn over one K/V stage, each
// holding both heads' half of dQ (2 x 64 floats a thread): 214,016 bytes
// (two heads' Q and dO, one stage of K and V, a dS tile a head). float32:
// csrc/ffa_bwd_dq.cuh, float32 FMA on the CUDA cores (the 1e-5 gate needs
// float32 products); shared memory 4 * (2 * G * 64 + 2 * 64) * (D + 4) +
// 4 * 64 * 80 bytes, so G = 2 at D = 128 (223 KB; four heads' float32 Q and
// dO tiles would need 350 KB) and up to G = 4 at D = 64 (195 KB), one CTA
// per SM. The wrapper's guard (kernels/ffa.py:dq_pack_heads) computes the
// same figures; a larger group runs in blocks of G heads.
#include "ffa_bwd_dq.cuh"
#include "ffa_bwd_dq_tc.cuh"
#include "ffa_bwd_dq_ws.cuh"

namespace {

// the float32 body's instances: G = 2, and G = 4 where four heads' tiles
// fit (D = 64)
template <int D>
int dispatch_f32(int g, const void* q, const void* k, const void* v,
                 const void* dout, const float* lse, const float* delta,
                 float* dq, const int* work_kt, const int* meta,
                 const int* run_ptr, int sq, int sk, int hq, int hk,
                 int num_q_tiles, float scale, float softcap, void* stream) {
  switch (g) {
    case 2:
      return launch<float, D, 2>(q, k, v, dout, lse, delta, dq, work_kt,
                                 meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                                 scale, softcap, stream);
    case 4:
      if constexpr (D == 64)
        return launch<float, D, 4>(q, k, v, dout, lse, delta, dq, work_kt,
                                   meta, run_ptr, sq, sk, hq, hk,
                                   num_q_tiles, scale, softcap, stream);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The packed bf16 instances: G = 2 at D = 64 and 128, 64-row q tiles (a
// 128-row tile's two warpgroups are its halves) and 64- or 128-row k
// tiles, and at D = 256 64 x 64; the float32 CUDA-core body 64 x 64 only.
#define MAGI_DQ_GQA(X) X(64, 64) X(64, 128) X(128, 64) X(128, 128) X(256, 64)

// As ffa_bwd_dq_f32/_bf16 (csrc/ffa_bwd_dq.cu), plus heads_per_cta: G,
// which must divide hq / hk.
extern "C" int ffa_bwd_dq_gqa_f32(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  float* dq, const int* work_kt,
                                  const int* meta, const int* run_ptr, int sq,
                                  int sk, int hq, int hk, int d,
                                  int heads_per_cta, int bq, int bk,
                                  int num_q_tiles, float scale, float softcap,
                                  void* stream) {
  const int g = heads_per_cta;
  if (g < 2 || (hq / hk) % g || bq != 64 || bk != 64)
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return dispatch_f32<64>(g, q, k, v, dout, lse, delta, dq, work_kt, meta,
                              run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                              softcap, stream);
    case 128:
      return dispatch_f32<128>(g, q, k, v, dout, lse, delta, dq, work_kt,
                               meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                               scale, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" int ffa_bwd_dq_gqa_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   float* dq, const int* work_kt,
                                   const int* meta, const int* run_ptr,
                                   int sq, int sk, int hq, int hk, int d,
                                   int heads_per_cta, int bq, int bk,
                                   int num_q_tiles, float scale,
                                   float softcap, void* stream) {
  const int g = heads_per_cta;
  if (g != 2 || (hq / hk) % g || bq != 64) return (int)cudaErrorInvalidValue;
#define X(D, BK)                                                            \
  if (d == D && bk == BK)                                                   \
    return dq_bf16::launch<D, 2, 64, BK>(q, k, v, dout, lse, delta, dq,     \
                                         work_kt, meta, run_ptr, sq, sk, hq, \
                                         hk, num_q_tiles, scale, softcap,    \
                                         stream);
  MAGI_DQ_GQA(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The shared memory one CTA takes (bf16: the tensor-core body, else the
// float32 one), for the wrapper's guard to check its own figure against:
// 0 for a geometry this library has no kernel for.
extern "C" long ffa_bwd_dq_gqa_smem_bytes(int d, int g, int bq, int bk,
                                          int bf16) {
  if (bq != 64) return 0;
  if (bf16) {
    if (g != 2) return 0;
#define X(D, BK) \
  if (d == D && bk == BK) return dq_bf16::smem_bytes<D, 2, 64, BK>();
    MAGI_DQ_GQA(X)
#undef X
    return 0;
  }
  if (bk != 64) return 0;
  if (d == 64 && g == 2) return (long)DqSmem<64, 2>::bytes;
  if (d == 64 && g == 4) return (long)DqSmem<64, 4>::bytes;
  if (d == 128 && g == 2) return (long)DqSmem<128, 2>::bytes;
  return 0;
}
