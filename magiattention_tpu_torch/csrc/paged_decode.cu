// Paged decode attention for Hopper (sm_90a): one query row per slot,
// straight from the paged KV cache.
//
// Replaces: magiattention_tpu/kernels/paged_decode.py:_paged_decode_kernel
// (wrapper _paged_decode_pallas, pallas_call at paged_decode.py:192).
//
// What it computes: for slot s and q head h, softmax attention of q[s, h]
// over k/v rows [0, lengths[s]) of that slot, where row r lives in page
// page_table[s, r / ps] at row r % ps. out 0 and lse -inf for an empty slot
// (length 0); lse in natural log.
//
// Design: the body in paged_decode.cuh with one draft row (spec_k = 1): one
// CTA per (kv head, slot) holding the g = hq / hk query rows of that kv
// head, 64-token chunks of K/V in float32 shared memory, an online softmax
// in the exp2 domain, lengths and the table read on the device, the walk
// stopping at ceil(length / ps) pages.
//
// What bounds it on this card: bytes (each live K/V row read once, 2 * D *
// itemsize per token and kv head, against 4 * g * D flops); a small batch
// fills few SMs (8 x 8 = 64 CTAs of 132 at the serving shape).
#include "paged_decode.cuh"

namespace {

constexpr int GMAX = 8;  // largest query group hq / hk

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages,
        const int* table, const int* lengths, void* out, float* lse, int S,
        int hq, int hk, int d, int ps, int P, float softmax_scale,
        void* stream) {
  return magi::decode::dispatch<T, T, GMAX>(
      d, q, k_pages, v_pages, nullptr, nullptr, table, lengths, out, lse, S,
      hq, hk, ps, P, 1, softmax_scale, stream);
}

}  // namespace

// q [S, hq, d] and out [S, hq, d] contiguous; k/v pages [N, ps, hk, d]
// contiguous, same dtype as q; table [S, P] and lengths [S] int32 on the
// device; lse [S, hq] float32.
extern "C" int paged_decode_f32(const void* q, const void* k_pages,
                                const void* v_pages, const int* table,
                                const int* lengths, void* out, float* lse,
                                int S, int hq, int hk, int d, int ps, int P,
                                float softmax_scale, void* stream) {
  return run<float>(q, k_pages, v_pages, table, lengths, out, lse, S, hq, hk,
                    d, ps, P, softmax_scale, stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* k_pages,
                                 const void* v_pages, const int* table,
                                 const int* lengths, void* out, float* lse,
                                 int S, int hq, int hk, int d, int ps, int P,
                                 float softmax_scale, void* stream) {
  return run<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, out, lse, S,
                            hq, hk, d, ps, P, softmax_scale, stream);
}
