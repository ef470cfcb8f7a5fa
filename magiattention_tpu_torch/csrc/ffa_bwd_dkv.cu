// FFA backward, dk and dv, over the host-built k-major work list, for
// Hopper (sm_90a).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_bwd_dkv_kernel (wrapper
// _ffa_bwd_dkv_pallas, pallas_call at ffa.py:1432) and its GQA-packed twin
// _bwd_dkv_kernel_gqa (wrapper _ffa_bwd_dkv_pallas_gqa, pallas_call at
// ffa.py:1657). One kernel does both: it always loops the query group.
//
// The kernel body is in csrc/bwd_kv.cuh (shared with the fused backward,
// csrc/ffa_bwd_fused.cu); this source instantiates it without dq.
#include "bwd_kv.cuh"

// q/do [sq, hq, d], k/v [sk, hk, d] are contiguous rows of one dtype;
// lse/delta [sq, hq] float32; dk/dv [sk, hk, d] float32, every row written.
// work_qt_t (W_t,), meta_t (W_t, 15) and run_ptr_t (num_k_tiles + 1,) are
// the plan's k-major int32 arrays on the device.
extern "C" int ffa_bwd_dkv_f32(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, float* dk, float* dv,
                               const int* work_qt_t, const int* meta_t,
                               const int* run_ptr_t, int sq, int sk, int hq,
                               int hk, int d, int num_k_tiles, float scale,
                               float softcap, void* stream) {
  return dispatch<float, false>(d, q, k, v, dout, lse, delta, dk, dv, nullptr,
                                work_qt_t, meta_t, run_ptr_t, sq, sk, hq, hk,
                                num_k_tiles, scale, softcap, stream);
}

extern "C" int ffa_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, float* dk, float* dv,
                                const int* work_qt_t, const int* meta_t,
                                const int* run_ptr_t, int sq, int sk, int hq,
                                int hk, int d, int num_k_tiles, float scale,
                                float softcap, void* stream) {
  return dispatch<__nv_bfloat16, false>(d, q, k, v, dout, lse, delta, dk, dv,
                                        nullptr, work_qt_t, meta_t, run_ptr_t,
                                        sq, sk, hq, hk, num_k_tiles, scale,
                                        softcap, stream);
}
