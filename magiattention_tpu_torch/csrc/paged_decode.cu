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
// Design: the split walk of the body in paged_decode.cuh with one draft row
// (spec_k = 1). The grid is (kv head, slot, split): each CTA of 256 threads
// holds the g = hq / hk query rows of its kv head over its split's token
// range (a whole number of 64-token units, fixed on the host:
// decode_split_plan), reads the slot's length on the device and returns at
// once past it. K/V chunks of 32 tokens are double-buffered raw in shared
// memory by cp.async, so the next chunk's loads overlap this chunk's
// scores, softmax and P V. A slot longer than one split leaves per-row
// partials (accumulator, max, sum) in the caller's workspace, and
// merge_kernel combines them in split order: deterministic, no atomics.
// At RMAX 8, three CTAs fit on an SM (73.1 KiB of shared memory with
// float32 pages at d 128, 80 registers).
//
// What bounds it on this card: bytes (each live K/V row read once, 2 * D *
// itemsize per token and kv head, against 4 * g * D flops). The split
// spreads a 4096-token slot over 8 x 16 CTAs at the serving shape; what
// remains is each chunk's work on the CUDA cores and in shared memory, and
// the merge launch.
#include "paged_decode.cuh"

namespace {

constexpr int GMAX = 8;  // largest query group hq / hk

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages,
        const int* table, const int* lengths, void* out, float* lse,
        float* part, int S, int hq, int hk, int d, int ps, int P, int splits,
        int split_len, float softmax_scale, void* stream) {
  return magi::decode::dispatch<T, T, GMAX>(
      d, q, k_pages, v_pages, nullptr, nullptr, table, lengths, out, lse,
      part, S, hq, hk, ps, P, 1, splits, split_len, softmax_scale, stream);
}

}  // namespace

// q [S, hq, d] and out [S, hq, d] contiguous; k/v pages [N, ps, hk, d]
// contiguous, same dtype as q; table [S, P] and lengths [S] int32 on the
// device; lse [S, hq] float32; the plan's splits x split_len tokens cover
// P * ps; part: splits * S * hq * (d + 2) float32 where splits > 1, else
// null.
extern "C" int paged_decode_f32(const void* q, const void* k_pages,
                                const void* v_pages, const int* table,
                                const int* lengths, void* out, float* lse,
                                float* part, int S, int hq, int hk, int d,
                                int ps, int P, int splits, int split_len,
                                float softmax_scale, void* stream) {
  return run<float>(q, k_pages, v_pages, table, lengths, out, lse, part, S,
                    hq, hk, d, ps, P, splits, split_len, softmax_scale,
                    stream);
}

extern "C" int paged_decode_bf16(const void* q, const void* k_pages,
                                 const void* v_pages, const int* table,
                                 const int* lengths, void* out, float* lse,
                                 float* part, int S, int hq, int hk, int d,
                                 int ps, int P, int splits, int split_len,
                                 float softmax_scale, void* stream) {
  return run<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, out, lse,
                            part, S, hq, hk, d, ps, P, splits, split_len,
                            softmax_scale, stream);
}

// The dynamic shared memory one walk CTA takes at head dim d with pages of
// q's dtype (bf16 1, float32 0); 0 where no instance is compiled.
// utils/mem_budget.py:decode_smem_bytes is its host model.
extern "C" long paged_decode_smem_bytes(int d, int bf16) {
  return bf16 ? magi::decode::smem_bytes<__nv_bfloat16, GMAX>(d)
              : magi::decode::smem_bytes<float, GMAX>(d);
}
