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
// Design: the split walk of the body in paged_decode.cuh. A CTA per (kv
// head, slot, split) holds the spec_k * g rows of that kv head,
// token-major (row r = t * g + j, as the TPU kernel's q tile), so every
// K/V chunk is read once for all draft tokens; each row masks the columns
// past its own limit, and the walk of a split stops at the slot's length.
// The split plan is B10's (decode_split_plan: from the table width, page
// size, kv-head count and SM count, never from spec_k or the lengths), so at spec_k = 1 this is B10's instance and gives B10's bits.
// K/V chunks of 32 tokens are double-buffered raw in shared memory by
// cp.async; a multi-split slot's partials are merged in split order by
// merge_kernel. A spec row whose limit falls in an earlier split than the
// slot's last token has no live column in the later ones: those leave
// (max -inf, sum 0, accumulator 0), which the merge skips. The row count
// picks the instance: RMAX 8, 16 or 32 (shared memory 73.1, 81.3 or 97.5
// KiB at d 128 in float32, 80, 128 and 128 registers: three, two and two
// CTAs an SM; P V holds two output columns' accumulators a thread, one at
// 32 rows).
//
// What bounds it on this card: bytes, as B10: each live K/V row is read
// once per CTA whatever spec_k is, while the flops grow with the rows
// (4 * spec_k * g * D per token), still below the float32 CUDA cores' ~20
// flops a byte at 32 rows; at 16 and 32 rows the chunk's scores and P V
// on the CUDA cores and in shared memory take longer than its copy.
#include "paged_decode.cuh"

namespace {

template <typename T>
int run(const void* q, const void* k_pages, const void* v_pages,
        const int* table, const int* lengths, void* out, float* lse,
        float* part, int S, int spec_k, int hq, int hk, int d, int ps, int P,
        int splits, int split_len, float softmax_scale, void* stream) {
  if (hk <= 0 || hq % hk != 0 || spec_k < 1) return (int)cudaErrorInvalidValue;
  const int rows = spec_k * (hq / hk);
  if (rows <= 8)
    return magi::decode::dispatch<T, T, 8>(
        d, q, k_pages, v_pages, nullptr, nullptr, table, lengths, out, lse,
        part, S, hq, hk, ps, P, spec_k, splits, split_len, softmax_scale,
        stream);
  if (rows <= 16)
    return magi::decode::dispatch<T, T, 16>(
        d, q, k_pages, v_pages, nullptr, nullptr, table, lengths, out, lse,
        part, S, hq, hk, ps, P, spec_k, splits, split_len, softmax_scale,
        stream);
  return magi::decode::dispatch<T, T, 32>(
      d, q, k_pages, v_pages, nullptr, nullptr, table, lengths, out, lse,
      part, S, hq, hk, ps, P, spec_k, splits, split_len, softmax_scale,
      stream);
}

}  // namespace

// q [S, spec_k, hq, d] and out [S, spec_k, hq, d] contiguous; k/v pages
// [N, ps, hk, d] contiguous, same dtype as q; table [S, P] and lengths [S]
// int32 on the device; lse [S, spec_k, hq] float32. spec_k * hq / hk <= 32.
// The plan's splits x split_len tokens cover P * ps; part: splits * S *
// spec_k * hq * (d + 2) float32 where splits > 1, else null.
extern "C" int paged_decode_spec_f32(const void* q, const void* k_pages,
                                     const void* v_pages, const int* table,
                                     const int* lengths, void* out, float* lse,
                                     float* part, int S, int spec_k, int hq,
                                     int hk, int d, int ps, int P, int splits,
                                     int split_len, float softmax_scale,
                                     void* stream) {
  return run<float>(q, k_pages, v_pages, table, lengths, out, lse, part, S,
                    spec_k, hq, hk, d, ps, P, splits, split_len,
                    softmax_scale, stream);
}

extern "C" int paged_decode_spec_bf16(const void* q, const void* k_pages,
                                      const void* v_pages, const int* table,
                                      const int* lengths, void* out,
                                      float* lse, float* part, int S,
                                      int spec_k, int hq, int hk, int d,
                                      int ps, int P, int splits,
                                      int split_len, float softmax_scale,
                                      void* stream) {
  return run<__nv_bfloat16>(q, k_pages, v_pages, table, lengths, out, lse,
                            part, S, spec_k, hq, hk, d, ps, P, splits,
                            split_len, softmax_scale, stream);
}

// The dynamic shared memory one walk CTA takes at head dim d for rows =
// spec_k * hq / hk query rows (the instance the launch picks: RMAX 8, 16 or
// 32) with pages of q's dtype (bf16 1, float32 0); 0 where no instance is
// compiled. utils/mem_budget.py:decode_smem_bytes is its host model.
extern "C" long paged_decode_spec_smem_bytes(int d, int rows, int bf16) {
  if (rows < 1 || rows > 32) return 0;
  if (rows <= 8)
    return bf16 ? magi::decode::smem_bytes<__nv_bfloat16, 8>(d)
                : magi::decode::smem_bytes<float, 8>(d);
  if (rows <= 16)
    return bf16 ? magi::decode::smem_bytes<__nv_bfloat16, 16>(d)
                : magi::decode::smem_bytes<float, 16>(d);
  return bf16 ? magi::decode::smem_bytes<__nv_bfloat16, 32>(d)
              : magi::decode::smem_bytes<float, 32>(d);
}
