// Paged decode over an int8 KV cache for Hopper (sm_90a): one query row per
// slot, the pages dequantized in the kernel.
//
// Replaces: magiattention_tpu/kernels/paged_decode.py:_paged_decode_int8_kernel
// (wrapper _paged_decode_int8_pallas, pallas_call at paged_decode.py:699).
//
// What it computes: B10's function over pages that hold int8 codes, where
// the value of a K (V) element is code * k_scales[page, h] (v_scales), one
// float32 scale per (page, kv head). q (float32 or bf16) is taken to
// float32; the products and the accumulation are float32 (the probabilities
// are not rounded to the page type); out in q's dtype, lse float32 in
// natural log, (0, -inf) for an empty slot.
//
// Design: the body in paged_decode.cuh with one draft row (spec_k = 1). Each
// thread loads 16 codes at a time (16 bytes); as a 64-token chunk is
// converted to float32 in shared memory, each token row takes its own
// page's (page, head) scale (a chunk spans four 16-row pages and so four
// scales), so the rest of the kernel is B10's.
//
// What bounds it on this card: bytes. Each live token moves 2 * D bytes of
// codes per kv head (and 8 bytes of scales per page and kv head) against
// B10's 2 * D * 4 in float32, so its bound is about a quarter of B10's
// float32 bound; the dequantization is one multiply an element.
#include "paged_decode.cuh"

namespace {

constexpr int GMAX = 8;  // largest query group hq / hk

template <typename TQ>
int run(const void* q, const void* k_pages, const void* v_pages,
        const float* k_scales, const float* v_scales, const int* table,
        const int* lengths, void* out, float* lse, int S, int hq, int hk,
        int d, int ps, int P, float softmax_scale, void* stream) {
  return magi::decode::dispatch<TQ, int8_t, GMAX>(
      d, q, k_pages, v_pages, k_scales, v_scales, table, lengths, out, lse, S,
      hq, hk, ps, P, 1, softmax_scale, stream);
}

}  // namespace

// q [S, hq, d] and out [S, hq, d] contiguous (float32 or bf16); k/v pages
// [N, ps, hk, d] int8 contiguous; k/v scales [N, hk] float32; table [S, P]
// and lengths [S] int32 on the device; lse [S, hq] float32.
extern "C" int paged_decode_int8_f32(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const float* k_scales,
                                     const float* v_scales, const int* table,
                                     const int* lengths, void* out, float* lse,
                                     int S, int hq, int hk, int d, int ps,
                                     int P, float softmax_scale,
                                     void* stream) {
  return run<float>(q, k_pages, v_pages, k_scales, v_scales, table, lengths,
                    out, lse, S, hq, hk, d, ps, P, softmax_scale, stream);
}

extern "C" int paged_decode_int8_bf16(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const float* k_scales,
                                      const float* v_scales, const int* table,
                                      const int* lengths, void* out,
                                      float* lse, int S, int hq, int hk, int d,
                                      int ps, int P, float softmax_scale,
                                      void* stream) {
  return run<__nv_bfloat16>(q, k_pages, v_pages, k_scales, v_scales, table,
                            lengths, out, lse, S, hq, hk, d, ps, P,
                            softmax_scale, stream);
}
