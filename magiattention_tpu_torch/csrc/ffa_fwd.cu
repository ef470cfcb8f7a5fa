// FFA forward over the host-built q-major work list, for Hopper (sm_90a):
// one CTA per (q tile, q head).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_fwd_kernel (wrapper
// _ffa_fwd_pallas, pallas_call at ffa.py:462), with its optional
// max-logits output (ffa.py:130, :482-487).
//
// The kernel body, its design and what bounds it are in csrc/ffa_fwd.cuh,
// shared with the GQA-packed variant (csrc/ffa_fwd_gqa.cu). Here G = 1:
// Q and one K-or-V tile (the v tile replaces the k tile each item) and the
// 64 x 80 P tile, 86 KB of shared memory at D = 128, so two CTAs share an
// SM.
//
// Max-logits: the TPU kernel keeps a per-(head, q tile) running max of the
// scaled, softcapped logits and reduces it on the host. Here the running
// row max m of the online softmax is that max already, in the exp2 domain
// (scale * log2(e) folded into the scores; softcapped scores are scaled by
// log2(e) after the tanh), so each CTA reduces its 64 rows' m, converts
// with ln(2) and writes one float per (q tile, head); the wrapper takes the
// max over q tiles. A nullptr skips it.
#include "ffa_fwd.cuh"

namespace {

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v, void* out,
             float* lse, float* max_logits, const int* work_kt,
             const int* meta, const int* run_ptr, int sq, int sk, int hq,
             int hk, int num_q_tiles, float scale, float softcap,
             void* stream) {
  switch (d) {
    case 64:
      return launch<T, 64, 1>(q, k, v, out, lse, max_logits, work_kt, meta,
                              run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                              softcap, stream);
    case 128:
      return launch<T, 128, 1>(q, k, v, out, lse, max_logits, work_kt, meta,
                               run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                               softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q [sq, hq, d], k/v [sk, hk, d] and out [sq, hq, d] are contiguous rows of
// one dtype; lse [sq, hq] float32; max_logits [num_q_tiles, hq] float32 or
// nullptr. work_kt (W,), meta (W, 15) and run_ptr (num_q_tiles + 1,) are the
// plan's int32 arrays on the device.
extern "C" int ffa_fwd_f32(const void* q, const void* k, const void* v,
                           void* out, float* lse, float* max_logits,
                           const int* work_kt, const int* meta,
                           const int* run_ptr, int sq, int sk, int hq, int hk,
                           int d, int num_q_tiles, float scale, float softcap,
                           void* stream) {
  return dispatch<float>(d, q, k, v, out, lse, max_logits, work_kt, meta,
                         run_ptr, sq, sk, hq, hk, num_q_tiles, scale, softcap,
                         stream);
}

extern "C" int ffa_fwd_bf16(const void* q, const void* k, const void* v,
                            void* out, float* lse, float* max_logits,
                            const int* work_kt, const int* meta,
                            const int* run_ptr, int sq, int sk, int hq, int hk,
                            int d, int num_q_tiles, float scale,
                            float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(d, q, k, v, out, lse, max_logits, work_kt,
                                 meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                                 scale, softcap, stream);
}
