// Speculative-verify paged decode for Hopper (sm_90a): spec_k draft rows
// per slot, each with its own causal horizon, straight from the paged KV
// cache.
//
// Replaces: magiattention_tpu/kernels/paged_decode.py:_paged_decode_spec_kernel
// (wrapper _paged_decode_spec_pallas, pallas_call at paged_decode.py:480).
//
// What it computes: q [S, spec_k, hq, d]; the spec_k draft tokens of slot s
// are already appended, so token t sits at position lengths[s] - spec_k + t
// and its rows attend k/v rows [0, lengths[s] - (spec_k - 1 - t)). A row
// with nothing live (a slot shorter than spec_k, or length 0) gives out 0
// and lse -inf; lse in natural log.
//
// Design: the body in paged_decode.cuh. One CTA per (kv head, slot) holds
// the spec_k * g rows of that kv head, token-major (row r = t * g + j, as
// the TPU kernel's q tile), so every K/V chunk is read once for all draft
// tokens; each row masks the columns past its own limit and the walk stops
// at the longest row's horizon (the last token's, the slot's length). The
// row count picks the instance: RMAX 8, 16 or 32 (shared memory 74, 80 or
// 93 KB at d 128; one accumulator per row and output column in registers).
// At spec_k = 1 this is B10's instance and gives B10's bits.
//
// What bounds it on this card: bytes, as B10: each live K/V row is read
// once per CTA whatever spec_k is, while the flops grow with the rows
// (4 * spec_k * g * D per token), still below the float32 CUDA cores' ~20
// flops a byte at 32 rows.
#include "paged_decode.cuh"

namespace {

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages,
        const int* table, const int* lengths, void* out, float* lse, int S,
        int spec_k, int hq, int hk, int d, int ps, int P, float softmax_scale,
        void* stream) {
  if (hk <= 0 || hq % hk != 0 || spec_k < 1) return (int)cudaErrorInvalidValue;
  const int rows = spec_k * (hq / hk);
  if (rows <= 8)
    return magi::decode::dispatch<T, T, 8>(
        d, q, k_pages, v_pages, nullptr, nullptr, table, lengths, out, lse, S,
        hq, hk, ps, P, spec_k, softmax_scale, stream);
  if (rows <= 16)
    return magi::decode::dispatch<T, T, 16>(
        d, q, k_pages, v_pages, nullptr, nullptr, table, lengths, out, lse, S,
        hq, hk, ps, P, spec_k, softmax_scale, stream);
  return magi::decode::dispatch<T, T, 32>(
      d, q, k_pages, v_pages, nullptr, nullptr, table, lengths, out, lse, S,
      hq, hk, ps, P, spec_k, softmax_scale, stream);
}

}  // namespace

// q [S, spec_k, hq, d] and out [S, spec_k, hq, d] contiguous; k/v pages
// [N, ps, hk, d] contiguous, same dtype as q; table [S, P] and lengths [S]
// int32 on the device; lse [S, spec_k, hq] float32. spec_k * hq / hk <= 32.
extern "C" int paged_decode_spec_f32(const void* q, const void* k_pages,
                                     const void* v_pages, const int* table,
                                     const int* lengths, void* out, float* lse,
                                     int S, int spec_k, int hq, int hk, int d,
                                     int ps, int P, float softmax_scale,
                                     void* stream) {
  return run<float>(q, k_pages, v_pages, table, lengths, out, lse, S, spec_k,
                    hq, hk, d, ps, P, softmax_scale, stream);
}

extern "C" int paged_decode_spec_bf16(const void* q, const void* k_pages,
                                      const void* v_pages, const int* table,
                                      const int* lengths, void* out,
                                      float* lse, int S, int spec_k, int hq,
                                      int hk, int d, int ps, int P,
                                      float softmax_scale, void* stream) {
  return run<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, out, lse, S,
                            spec_k, hq, hk, d, ps, P, softmax_scale, stream);
}
