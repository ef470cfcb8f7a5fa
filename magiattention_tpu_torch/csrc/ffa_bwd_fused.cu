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
// workspace the wrapper zeroes: the kernel adds each (item, head)'s dS K
// block to it (float32 atomics, or a TMA bulk reduce), and
// ffa_bwd_fused_convert then multiplies it by softmax_scale in place. The
// adds make dq depend on the order of the additions, so it is not
// bitwise reproducible; the split backward (dq and dkv kernels) stays the
// deterministic mode. Scores are scaled in float32 inside the kernel, as in
// the other backward kernels (the TPU kernel pre-scales q by scale * log2e
// in the input type and divides ln 2 back out of dk); softcap keeps the
// exp domain and the 1 - tanh^2 factor.
//
// Two bodies. bfloat16 (shared with the split dk/dv kernel's bf16 entry),
// the products on the tensor cores: at 64 x 128 and D = 64 or 128 (the
// card's default k-major tile there) csrc/bwd_kv_ws.cuh with FUSED (a TMA
// producer warpgroup, two consumer warpgroups on the 128-row k tile, each
// consumer's half of dQ one depth-128 product a step behind, added by TMA
// bulk reduces; 231,552 bytes at D = 128, one CTA an SM), at every other tile and at D = 256
// csrc/bwd_kv_tc.cuh with FUSED (one warpgroup per 64 k rows, the next
// step's Q and dO double-buffered by cp.async, dq added by 16-byte vector
// atomics; 108,544 bytes at D = 128, 64 x 64, two CTAs per SM).
// float32: csrc/bwd_kv.cuh with FUSED, float32 FMA on the CUDA cores (67
// TFLOP/s peak on an H100 SXM), shared with the split dk/dv kernel; its
// shared memory is the dk/dv kernel's (173 KB at D = 128): the dq block
// reads the dS^T and K tiles already resident, and adds with scalar
// atomics. What bounds both: operations, 10 * D flops per live (row, col)
// pair and q head (S, dP, P^T dO, dS^T Q, dS K); then the adds, one
// block_q x D float32 block per (item, q head), a read-modify-write of
// block_q * D * 4 bytes in L2 each (half of them at 64 x 128 as at 64 x 64). Head dims 64, 128 and 256: at 256 the bf16
// body's two warpgroups each take one 128-column half of dk, dv and the
// dq atomics in one CTA, and the float32 body one half per CTA (grid z),
// as csrc/ffa_bwd_dkv.cu's.
#include "bwd_kv.cuh"
#include "bwd_kv_ws.cuh"

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

// Tiles: the bf16 body takes (bq, bk) in {64, 128}^2 wherever the CTA
// fits (csrc/common.cuh MAGI_FFA_TILES; at D = 256 only 64 x 64); the
// float32 CUDA-core body 64 x 64 only. ffa_bwd_fused_smem_bytes says which (0
// where not compiled).

// q/do [sq, hq, d], k/v [sk, hk, d] are contiguous rows of one dtype;
// lse/delta [sq, hq] float32; dq [sq, hq, d] float32, ZEROED by the caller
// (the kernel adds into it; the scale is NOT applied here, see
// ffa_bwd_fused_convert); dk/dv [sk, hk, d] float32, every row written.
// work_qt_t (W_t,), meta_t (W_t, 15) and run_ptr_t (num_k_tiles + 1,) are
// the plan's k-major int32 arrays on the device, at the launch's tiles.
extern "C" int ffa_bwd_fused_f32(const void* q, const void* k, const void* v,
                                 const void* dout, const float* lse,
                                 const float* delta, float* dq, float* dk,
                                 float* dv, const int* work_qt_t,
                                 const int* meta_t, const int* run_ptr_t,
                                 int sq, int sk, int hq, int hk, int d,
                                 int bq, int bk, int num_k_tiles, float scale,
                                 float softcap, void* stream) {
  if (bq != 64 || bk != 64) return (int)cudaErrorInvalidValue;
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
                                  int bq, int bk, int num_k_tiles,
                                  float scale, float softcap, void* stream) {
#define X(D, BQ, BK)                                                       \
  if (d == D && bq == BQ && bk == BK)                                      \
    return kv_bf16::launch<D, true, BQ, BK>(q, k, v, dout, lse, delta, dk,   \
                                          dv, dq, work_qt_t, meta_t,       \
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
extern "C" long ffa_bwd_fused_smem_bytes(int d, int bq, int bk, int bf16) {
  if (!bf16) {
    if (bq != 64 || bk != 64) return 0;
    if (d == 64) return (long)DkvSmem<64>::bytes;
    if (d == 128) return (long)DkvSmem<128>::bytes;
    if (d == 256) return (long)DkvSmem<256>::bytes;
    return 0;
  }
#define X(D, BQ, BK)                   \
  if (d == D && bq == BQ && bk == BK) \
    return kv_bf16::smem_bytes<D, true, BQ, BK>();
  MAGI_FFA_TILES(X)
#undef X
  return 0;
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
