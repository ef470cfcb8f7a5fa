// GQA-packed FFA forward over the host-built q-major work list, for Hopper
// (sm_90a): one CTA per (q tile, block of G q heads of one kv head).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_fwd_kernel_gqa (wrapper
// _ffa_fwd_pallas_gqa, pallas_call at ffa.py:692).
//
// The TPU kernel stacks the g heads of a kv head into one (g * bq)-row MXU
// operand so each K/V block is fetched once per work item for the group.
// Here the CTA keeps the G q tiles and the item's K and V in shared memory
// and runs csrc/ffa_fwd.cu's per-head body once per head against them, one
// consumer warpgroup a head: each K/V tile is loaded once per item for G
// heads, where the unpacked kernel loads it once per head. The per-row
// arithmetic and its order are the unpacked kernel's, so out and lse are
// bit-identical to csrc/ffa_fwd.cu on the same inputs; only the grid
// differs.
//
// bfloat16 (csrc/ffa_fwd_tc.cuh, tensor cores; at G = 2, 64 x 128 and D =
// 64 or 128, the card's default there, csrc/ffa_fwd_ws.cuh, which adds a
// TMA producer warpgroup and three K/V stages): one consumer warpgroup per
// head; G q tiles and two stages of K and V, (G + 4) * 64 * D * 2 bytes of
// shared memory, and a thread holds its head's O accumulator (D / 2
// floats), S (32) and P (16): G is 2 at D = 128 (four warpgroups would
// leave 128 registers a thread) and 2 or 4 at D = 64; at D = 256 (all 256
// columns: O of 128 floats, V tiles at full width) G is 2 at 64-row k
// tiles, 197,664 bytes (a 128-row k tile does not fit).
// float32 (csrc/ffa_fwd_tf32.cuh, 3xTF32 on the tensor cores): one consumer
// warpgroup per head; G q tiles in hi and lo, the raw K/V chunk and two
// stages of split K and V^T tiles where they fit (one at D = 128),
// D * (512 G + 256 + 512 stages) + 16 G + 1024 bytes (145 KB at D = 64,
// 225 KB at D = 128), and a thread holds its head's O accumulator and the
// chunk's P V (D / 2 floats each), S (48) and P (32): G is 2 (four
// warpgroups would leave 128 registers a thread); at D = 256 one head's
// tiles take 225 KB, so the guard never packs there.
// The wrapper's guard (kernels/ffa.py:fwd_pack_heads) computes the same
// figures. A larger group runs in blocks of G heads (g = 8: several CTAs
// per kv head). No max-logits output: the TPU's packed kernel emits none,
// and the guard sends a max-logits request to the unpacked kernel.
#include "ffa_fwd_ws.cuh"
#include "ffa_fwd_tf32.cuh"

// The packed instances: 64-row q tiles (a 128-row tile's two warpgroups
// are its halves, which leaves no room for heads) and 64- or 128-row k
// tiles, wherever the CTA fits; ffa_fwd_gqa_smem_bytes says which.
// (four warpgroups at 128 keys would hold S and P in 96 of their 128
// registers a thread: no G = 4 there).
#define MAGI_FWD_GQA(X)                                                 \
  X(64, 2, 64) X(64, 2, 128) X(64, 4, 64) X(128, 2, 64) X(128, 2, 128)  \
  X(256, 2, 64) X(256, 2, 128)
// float32 (3xTF32) packs two heads at D = 64 and 128 only
#define MAGI_FWD_GQA_F32(X) \
  X(64, 2, 64) X(64, 2, 128) X(128, 2, 64) X(128, 2, 128)

// As ffa_fwd_f32/_bf16 (csrc/ffa_fwd.cu) without max_logits, plus
// heads_per_cta: G, which must divide hq / hk.
extern "C" int ffa_fwd_gqa_f32(const void* q, const void* k, const void* v,
                               void* out, float* lse, const int* work_kt,
                               const int* meta, const int* run_ptr, int sq,
                               int sk, int hq, int hk, int d,
                               int heads_per_cta, int bq, int bk,
                               int num_q_tiles, float scale, float softcap,
                               void* stream) {
  const int g = heads_per_cta;
  if ((hq / hk) % g || bq != 64) return (int)cudaErrorInvalidValue;
#define X(D, G, BK)                                                          \
  if (d == D && g == G && bk == BK)                                          \
    return fwd_tf32::launch<D, G, 64, BK>(q, k, v, out, lse, nullptr,        \
                                          work_kt, meta, run_ptr, sq, sk,    \
                                          hq, hk, num_q_tiles, scale,        \
                                          softcap, stream);
  MAGI_FWD_GQA_F32(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

extern "C" int ffa_fwd_gqa_bf16(const void* q, const void* k, const void* v,
                                void* out, float* lse, const int* work_kt,
                                const int* meta, const int* run_ptr, int sq,
                                int sk, int hq, int hk, int d,
                                int heads_per_cta, int bq, int bk,
                                int num_q_tiles, float scale, float softcap,
                                void* stream) {
  const int g = heads_per_cta;
  if (g < 2 || (hq / hk) % g || bq != 64) return (int)cudaErrorInvalidValue;
#define X(D, G, BK)                                                          \
  if (d == D && g == G && bk == BK)                                          \
    return fwd_bf16::launch<D, G, 64, BK>(q, k, v, out, lse, nullptr, work_kt, \
                                        meta, run_ptr, sq, sk, hq, hk,       \
                                        num_q_tiles, scale, softcap, stream);
  MAGI_FWD_GQA(X)
#undef X
  return (int)cudaErrorInvalidValue;
}

// The shared memory one CTA takes (bf16: csrc/ffa_fwd_tc.cuh, else
// csrc/ffa_fwd_tf32.cuh), for the wrapper's guard to check its own figure
// against: 0 for a geometry this library has no kernel for (float32 packs
// two heads at D = 64 and 128 only).
extern "C" long ffa_fwd_gqa_smem_bytes(int d, int g, int bq, int bk,
                                       int bf16) {
  if (bq != 64) return 0;
#define X(D, G, BK) \
  if (bf16 && d == D && g == G && bk == BK) return fwd_bf16::smem_bytes<D, G, 64, BK>();
  MAGI_FWD_GQA(X)
#undef X
#define X(D, G, BK) \
  if (!bf16 && d == D && g == G && bk == BK) return fwd_tf32::smem_bytes<D, G, 64, BK>();
  MAGI_FWD_GQA_F32(X)
#undef X
  return 0;
}
