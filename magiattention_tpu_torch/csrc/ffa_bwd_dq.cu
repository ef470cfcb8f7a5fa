// FFA backward, dq, over the host-built q-major work list, for Hopper
// (sm_90a): one CTA per (q tile, q head).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_bwd_dq_kernel (wrapper
// _ffa_bwd_dq_pallas, pallas_call at ffa.py:931).
//
// The kernel body, its design and what bounds it are in
// csrc/ffa_bwd_dq.cuh, shared with the GQA-packed variant
// (csrc/ffa_bwd_dq_gqa.cu). Here G = 1: Q, dO, K, V at stride D + 4 and the
// 64 x 80 dS tile, 152 KB of shared memory at D = 128, one CTA per SM.
#include "ffa_bwd_dq.cuh"

namespace {

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             float* dq, const int* work_kt, const int* meta,
             const int* run_ptr, int sq, int sk, int hq, int hk,
             int num_q_tiles, float scale, float softcap, void* stream) {
  switch (d) {
    case 64:
      return launch<T, 64, 1>(q, k, v, dout, lse, delta, dq, work_kt, meta,
                              run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                              softcap, stream);
    case 128:
      return launch<T, 128, 1>(q, k, v, dout, lse, delta, dq, work_kt, meta,
                               run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                               softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/do [sq, hq, d], k/v [sk, hk, d] are contiguous rows of one dtype;
// lse/delta [sq, hq] and dq [sq, hq, d] float32. work_kt (W,), meta
// (W, 15) and run_ptr (num_q_tiles + 1,) are the plan's q-major int32
// arrays on the device, the forward's own.
extern "C" int ffa_bwd_dq_f32(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, float* dq,
                              const int* work_kt, const int* meta,
                              const int* run_ptr, int sq, int sk, int hq,
                              int hk, int d, int num_q_tiles, float scale,
                              float softcap, void* stream) {
  return dispatch<float>(d, q, k, v, dout, lse, delta, dq, work_kt, meta,
                         run_ptr, sq, sk, hq, hk, num_q_tiles, scale, softcap,
                         stream);
}

extern "C" int ffa_bwd_dq_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, float* dq,
                               const int* work_kt, const int* meta,
                               const int* run_ptr, int sq, int sk, int hq,
                               int hk, int d, int num_q_tiles, float scale,
                               float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dq, work_kt,
                                 meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                                 scale, softcap, stream);
}
