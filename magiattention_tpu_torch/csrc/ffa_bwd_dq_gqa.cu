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
// once for the G heads, and runs the per-head body of csrc/ffa_bwd_dq.cuh
// once per head against them; lse and delta are read from the [sq, hq] rows
// directly. The per-row arithmetic and its order are the unpacked kernel's,
// so dq is bit-identical to csrc/ffa_bwd_dq.cu on the same inputs; only the
// grid differs.
//
// G is 2 or 4, the largest that divides the group and fits (the wrapper's
// guard, kernels/ffa.py:dq_pack_heads, computes the same figures): shared
// memory 4 * (2 * G * 64 + 2 * 64) * (D + 4) + 4 * 64 * 80 bytes, so G = 2
// at D = 128 (223 KB; four heads' float32 Q and dO tiles would need 350 KB)
// and up to G = 4 at D = 64 (195 KB), one CTA per SM; a larger group runs in
// blocks of G heads.
#include "ffa_bwd_dq.cuh"

namespace {

template <typename T, int D>
int dispatch_g(int g, const void* q, const void* k, const void* v,
               const void* dout, const float* lse, const float* delta,
               float* dq, const int* work_kt, const int* meta,
               const int* run_ptr, int sq, int sk, int hq, int hk,
               int num_q_tiles, float scale, float softcap, void* stream) {
  switch (g) {
    case 2:
      return launch<T, D, 2>(q, k, v, dout, lse, delta, dq, work_kt, meta,
                             run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                             softcap, stream);
    case 4:
      if constexpr (D == 64)  // four heads' tiles fit at D = 64 only
        return launch<T, D, 4>(q, k, v, dout, lse, delta, dq, work_kt, meta,
                               run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                               softcap, stream);
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

template <typename T>
int dispatch(int d, int g, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             float* dq, const int* work_kt, const int* meta,
             const int* run_ptr, int sq, int sk, int hq, int hk,
             int num_q_tiles, float scale, float softcap, void* stream) {
  if (g < 2 || (hq / hk) % g) return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return dispatch_g<T, 64>(g, q, k, v, dout, lse, delta, dq, work_kt,
                               meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                               scale, softcap, stream);
    case 128:
      return dispatch_g<T, 128>(g, q, k, v, dout, lse, delta, dq, work_kt,
                                meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                                scale, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// As ffa_bwd_dq_f32/_bf16 (csrc/ffa_bwd_dq.cu), plus heads_per_cta: G,
// which must divide hq / hk.
extern "C" int ffa_bwd_dq_gqa_f32(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const float* lse, const float* delta,
                                  float* dq, const int* work_kt,
                                  const int* meta, const int* run_ptr, int sq,
                                  int sk, int hq, int hk, int d,
                                  int heads_per_cta, int num_q_tiles,
                                  float scale, float softcap, void* stream) {
  return dispatch<float>(d, heads_per_cta, q, k, v, dout, lse, delta, dq,
                         work_kt, meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                         scale, softcap, stream);
}

extern "C" int ffa_bwd_dq_gqa_bf16(const void* q, const void* k,
                                   const void* v, const void* dout,
                                   const float* lse, const float* delta,
                                   float* dq, const int* work_kt,
                                   const int* meta, const int* run_ptr,
                                   int sq, int sk, int hq, int hk, int d,
                                   int heads_per_cta, int num_q_tiles,
                                   float scale, float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(d, heads_per_cta, q, k, v, dout, lse, delta,
                                 dq, work_kt, meta, run_ptr, sq, sk, hq, hk,
                                 num_q_tiles, scale, softcap, stream);
}

// The shared memory one CTA takes, for the wrapper's guard to check its
// own figure against: 0 for a geometry this library has no kernel for.
extern "C" long ffa_bwd_dq_gqa_smem_bytes(int d, int g) {
  if (d == 64 && g == 2) return (long)DqSmem<64, 2>::bytes;
  if (d == 64 && g == 4) return (long)DqSmem<64, 4>::bytes;
  if (d == 128 && g == 2) return (long)DqSmem<128, 2>::bytes;
  return 0;
}
