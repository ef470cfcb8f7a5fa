// FFA backward, dq, dk and dv in one pass over the host-built k-major work
// list, for Hopper (sm_90a).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_bwd_fused_kernel (wrapper
// _ffa_bwd_fused_pallas, pallas_call at ffa.py:2060) and its GQA-packed
// twin _bwd_fused_kernel_gqa (wrapper _ffa_bwd_fused_pallas_gqa,
// pallas_call at ffa.py:2312). One kernel does both: it always loops the
// query group.
//
// What it computes: dk and dv exactly as csrc/ffa_bwd_dkv.cu, and
//   dq[i] = scale * sum_j dS[i, j] k[j]
// as csrc/ffa_bwd_dq.cu, from ONE recompute of S and P per (work item,
// q head) of the k-major plan. Rows no slice covers get dq = 0 exactly,
// k rows no live pair touches dk = dv = 0 exactly. Results are float32.
//
// Design. The TPU kernel accumulates dq in its output window, revisited
// along a sequential grid under the plan's first/last-visit flags
// (QVF/QVL). A GPU runs CTAs in no order, so here dq goes to a float32
// workspace the wrapper zeroes: the kernel (csrc/bwd_kv.cuh, FUSED) adds
// each (item, head)'s dS K block to it with float32 atomics, and
// ffa_bwd_fused_convert then multiplies it by softmax_scale in place. The
// atomics make dq depend on the order of the additions, so it is not
// bitwise reproducible; the split backward (dq and dkv kernels) stays the
// deterministic mode. Scores are scaled in float32 inside the kernel, as in
// the other backward kernels (the TPU kernel pre-scales q by scale * log2e
// in the input type and divides ln 2 back out of dk); softcap keeps the
// exp domain and the 1 - tanh^2 factor.
//
// What bounds it on this card: operations. Work is 10 * D flops per live
// (row, col) pair and q head (S, dP, P^T dO, dS^T Q, dS K) on the CUDA
// cores in float32 (67 TFLOP/s peak on an H100 SXM); tensor cores and TMA
// are later work. Shared memory is the dk/dv kernel's (173 KB at D = 128):
// the dq block reads the dS^T and K tiles already resident. Atomic traffic
// is one 64 x D float32 block per (item, q head): a read-modify-write of
// 64 * D * 4 bytes in L2 each.
#include "bwd_kv.cuh"

namespace {

// dq *= scale, n floats (n % 4 == 0, 16-byte aligned).
__global__ void scale_kernel(float* __restrict__ dq, long n4, float scale) {
  const long stride = (long)gridDim.x * blockDim.x;
  for (long i = (long)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += stride) {
    float4 x = reinterpret_cast<float4*>(dq)[i];
    x.x *= scale;
    x.y *= scale;
    x.z *= scale;
    x.w *= scale;
    reinterpret_cast<float4*>(dq)[i] = x;
  }
}

}  // namespace

// q/do [sq, hq, d], k/v [sk, hk, d] are contiguous rows of one dtype;
// lse/delta [sq, hq] float32; dq [sq, hq, d] float32, ZEROED by the caller
// (the kernel adds into it; the scale is NOT applied here, see
// ffa_bwd_fused_convert); dk/dv [sk, hk, d] float32, every row written.
// work_qt_t (W_t,), meta_t (W_t, 15) and run_ptr_t (num_k_tiles + 1,) are
// the plan's k-major int32 arrays on the device.
extern "C" int ffa_bwd_fused_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, float* dq, float* dk,
                                 float* dv, const int* work_qt_t,
                                 const int* meta_t, const int* run_ptr_t,
                                 int sq, int sk, int hq, int hk, int d,
                                 int num_k_tiles, float scale, float softcap,
                                 void* stream) {
  return dispatch<float, true>(d, q, k, v, dout, lse, delta, dk, dv, dq,
                               work_qt_t, meta_t, run_ptr_t, sq, sk, hq, hk,
                               num_k_tiles, scale, softcap, stream);
}

extern "C" int ffa_bwd_fused_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const float* lse,
                                  const float* delta, float* dq, float* dk,
                                  float* dv, const int* work_qt_t,
                                  const int* meta_t, const int* run_ptr_t,
                                  int sq, int sk, int hq, int hk, int d,
                                  int num_k_tiles, float scale, float softcap,
                                  void* stream) {
  return dispatch<__nv_bfloat16, true>(d, q, k, v, dout, lse, delta, dk, dv,
                                       dq, work_qt_t, meta_t, run_ptr_t, sq,
                                       sk, hq, hk, num_k_tiles, scale,
                                       softcap, stream);
}

// The convert pass: dq (n float32 values, n % 4 == 0) *= scale, in place.
extern "C" int ffa_bwd_fused_convert(float* dq, long n, float scale,
                                     void* stream) {
  if (n % 4) return (int)cudaErrorInvalidValue;
  const long n4 = n / 4;
  if (n4 == 0) return 0;
  const int threads = 256;
  const int blocks = (int)((n4 + threads - 1) / threads < 132 * 16
                               ? (n4 + threads - 1) / threads
                               : 132 * 16);
  scale_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(dq, n4, scale);
  return (int)cudaGetLastError();
}
