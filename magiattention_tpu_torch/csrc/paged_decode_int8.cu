// Paged decode over an int8 KV cache for Hopper (sm_90a): one query row per
// slot, the pages' codes scaled in the kernel.
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
// Design: B10's split walk of the body in paged_decode.cuh over int8 pages,
// with one draft row (spec_k = 1) and B10's plan (decode_split_plan): grid
// (kv head, slot, split), 32-token chunks of raw codes double-buffered by
// cp.async (16 codes a copy) with each token row's K and V scale beside
// them in shared memory, a float32 workspace and merge_kernel in split
// order for a slot longer than one split. The scales are applied in the
// softmax warp: a token's score times its K scale, its stored probability
// times its V scale (the running sum unscaled), two multiplies per (token,
// row) instead of one per element.
//
// What bounds it on this card: bytes. Each live token moves 2 * D bytes of
// codes per kv head (and 8 bytes of scales per page and kv head) against
// B10's 2 * D * 4 in float32, so its bound is about a quarter of B10's
// float32 bound; the chunk's work on the CUDA cores is B10's at the same
// rows and d.
#include "paged_decode.cuh"

namespace {

constexpr int GMAX = 8;  // largest query group hq / hk

template <typename TQ>
int run(const void* q, const void* k_pages, const void* v_pages,
        const float* k_scales, const float* v_scales, const int* table,
        const int* lengths, void* out, float* lse, float* part, int S, int hq,
        int hk, int d, int ps, int P, int splits, int split_len,
        float softmax_scale, void* stream) {
  return magi::decode::dispatch<TQ, int8_t, GMAX>(
      d, q, k_pages, v_pages, k_scales, v_scales, table, lengths, out, lse,
      part, S, hq, hk, ps, P, 1, splits, split_len, softmax_scale, stream);
}

}  // namespace

// q [S, hq, d] and out [S, hq, d] contiguous (float32 or bf16); k/v pages
// [N, ps, hk, d] int8 contiguous; k/v scales [N, hk] float32; table [S, P]
// and lengths [S] int32 on the device; lse [S, hq] float32; the plan's
// splits x split_len tokens cover P * ps; part: splits * S * hq * (d + 2)
// float32 where splits > 1, else null.
extern "C" int paged_decode_int8_f32(const void* q, const void* k_pages,
                                     const void* v_pages,
                                     const float* k_scales,
                                     const float* v_scales, const int* table,
                                     const int* lengths, void* out, float* lse,
                                     float* part, int S, int hq, int hk, int d,
                                     int ps, int P, int splits, int split_len,
                                     float softmax_scale, void* stream) {
  return run<float>(q, k_pages, v_pages, k_scales, v_scales, table, lengths,
                    out, lse, part, S, hq, hk, d, ps, P, splits, split_len,
                    softmax_scale, stream);
}

extern "C" int paged_decode_int8_bf16(const void* q, const void* k_pages,
                                      const void* v_pages,
                                      const float* k_scales,
                                      const float* v_scales, const int* table,
                                      const int* lengths, void* out,
                                      float* lse, float* part, int S, int hq,
                                      int hk, int d, int ps, int P, int splits,
                                      int split_len, float softmax_scale,
                                      void* stream) {
  return run<__nv_bfloat16>(q, k_pages, v_pages, k_scales, v_scales, table,
                            lengths, out, lse, part, S, hq, hk, d, ps, P,
                            splits, split_len, softmax_scale, stream);
}

// The dynamic shared memory one walk CTA takes at head dim d over int8
// pages (q's dtype, bf16 1 or float32 0, does not change it); 0 where no
// instance is compiled. utils/mem_budget.py:decode_smem_bytes is its host
// model.
extern "C" long paged_decode_int8_smem_bytes(int d, int bf16) {
  (void)bf16;
  return magi::decode::smem_bytes<int8_t, GMAX>(d);
}
