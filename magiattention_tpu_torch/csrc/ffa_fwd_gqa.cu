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
// bfloat16 (csrc/ffa_fwd_tc.cuh, tensor cores): one consumer warpgroup per
// head; G q tiles and two stages of K and V, (G + 4) * 64 * D * 2 bytes of
// shared memory, and a thread holds its head's O accumulator (D / 2
// floats), S (32) and P (16): G is 2 at D = 128 (four warpgroups would
// leave 128 registers a thread) and 2 or 4 at D = 64.
// float32 (csrc/ffa_fwd_tf32.cuh, 3xTF32 on the tensor cores): one consumer
// warpgroup per head; G q tiles in hi and lo, the raw K/V chunk and two
// stages of split K and V^T tiles where they fit (one at D = 128),
// D * (512 G + 256 + 512 stages) + 16 G + 1024 bytes (145 KB at D = 64,
// 225 KB at D = 128), and a thread holds its head's O accumulator and the
// chunk's P V (D / 2 floats each), S (48) and P (32): G is 2 (four
// warpgroups would leave 128 registers a thread).
// The wrapper's guard (kernels/ffa.py:fwd_pack_heads) computes the same
// figures. A larger group runs in blocks of G heads (g = 8: several CTAs
// per kv head). No max-logits output: the TPU's packed kernel emits none,
// and the guard sends a max-logits request to the unpacked kernel.
#include "ffa_fwd_tc.cuh"
#include "ffa_fwd_tf32.cuh"

// As ffa_fwd_f32/_bf16 (csrc/ffa_fwd.cu) without max_logits, plus
// heads_per_cta: G, which must divide hq / hk.
extern "C" int ffa_fwd_gqa_f32(const void* q, const void* k, const void* v,
                               void* out, float* lse, const int* work_kt,
                               const int* meta, const int* run_ptr, int sq,
                               int sk, int hq, int hk, int d,
                               int heads_per_cta, int num_q_tiles,
                               float scale, float softcap, void* stream) {
  const int g = heads_per_cta;
  if (g != 2 || (hq / hk) % g) return (int)cudaErrorInvalidValue;
  if (d == 128)
    return fwd_tf32::launch<128, 2>(q, k, v, out, lse, nullptr, work_kt, meta,
                                    run_ptr, sq, sk, hq, hk, num_q_tiles,
                                    scale, softcap, stream);
  if (d == 64)
    return fwd_tf32::launch<64, 2>(q, k, v, out, lse, nullptr, work_kt, meta,
                                   run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                                   softcap, stream);
  return (int)cudaErrorInvalidValue;
}

extern "C" int ffa_fwd_gqa_bf16(const void* q, const void* k, const void* v,
                                void* out, float* lse, const int* work_kt,
                                const int* meta, const int* run_ptr, int sq,
                                int sk, int hq, int hk, int d,
                                int heads_per_cta, int num_q_tiles,
                                float scale, float softcap, void* stream) {
  const int g = heads_per_cta;
  if (g < 2 || (hq / hk) % g) return (int)cudaErrorInvalidValue;
  if (d == 128 && g == 2)
    return fwd_tc::launch<128, 2>(q, k, v, out, lse, nullptr, work_kt, meta,
                                  run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                                  softcap, stream);
  if (d == 64 && g == 2)
    return fwd_tc::launch<64, 2>(q, k, v, out, lse, nullptr, work_kt, meta,
                                 run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                                 softcap, stream);
  if (d == 64 && g == 4)
    return fwd_tc::launch<64, 4>(q, k, v, out, lse, nullptr, work_kt, meta,
                                 run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                                 softcap, stream);
  return (int)cudaErrorInvalidValue;
}

// The shared memory one CTA takes (bf16: csrc/ffa_fwd_tc.cuh, else
// csrc/ffa_fwd_tf32.cuh), for the wrapper's guard to check its own figure
// against: 0 for a geometry this library has no kernel for.
extern "C" long ffa_fwd_gqa_smem_bytes(int d, int g, int bf16) {
  if (bf16) {
    if (d == 64 && g == 2) return (long)fwd_tc::Smem<64, 2>::bytes;
    if (d == 64 && g == 4) return (long)fwd_tc::Smem<64, 4>::bytes;
    if (d == 128 && g == 2) return (long)fwd_tc::Smem<128, 2>::bytes;
    return 0;
  }
  if (d == 64 && g == 2) return (long)fwd_tf32::Smem<64, 2>::bytes;
  if (d == 128 && g == 2) return (long)fwd_tf32::Smem<128, 2>::bytes;
  return 0;
}
