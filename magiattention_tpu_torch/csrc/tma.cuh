// Hopper's asynchronous units for the port's warp-specialised bodies
// (csrc/bwd_kv_ws.cuh, csrc/ffa_fwd_ws.cuh): mbarriers, TMA tensor loads,
// stores and bulk reduces, the register hand-over between warpgroups and
// named barriers; and, on the host, the tensor maps those copies read.
//
// A CTA's producer warp issues TMA loads (cp.async.bulk.tensor) that
// complete on an mbarrier with the bytes they carry (expect-tx, then
// complete-tx), and cp.async copies that arrive on it when they land
// (cp.async.mbarrier.arrive.noinc); consumers wait on the barrier's phase
// parity and release a stage by arriving on its "empty" barrier. A box of
// 64 bf16 columns x R rows lands under SWIZZLE_128B exactly as
// tc.cuh:tile_offset lays out one 64-column panel of an R-row tile (row r
// at r * 128 bytes, its 16-byte chunk c at c ^ (r % 8), the panel
// 1024-byte aligned), so desc_k / desc_mn read it as they read a cp.async
// tile; rows past the tensor's end are zero-filled. A bulk reduce
// (cp.reduce.async.bulk.tensor .add) adds a shared-memory box of float32
// into global memory in the L2, rows past the end clipped; the issuing
// thread waits for its reads (wait_group.read) before the box is written
// again.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums: types only, no libcuda symbol is linked

#include "tc.cuh"

namespace magi {
namespace tma {

// ---- mbarriers (one 8-byte word of shared memory each) ----

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// the barriers' initialisation is visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n"
      "}\n" ::"r"(bar)
      : "memory");
}

// one arrival, and `bytes` more to come from asynchronous copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n"
      ".reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n"
      "}\n" ::"r"(bar), "r"(bytes)
      : "memory");
}

// wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0: waiting on parity 1 returns at once)
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar), "r"(parity)
      : "memory");
}

// an arrival on `bar` once every cp.async this thread issued has landed;
// noinc: the barrier's count includes it
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}

// ---- TMA ----

// the box of a 3D tensor map at coordinates (c0 innermost, c1, c2) into
// shared memory at dst, completing on bar
__device__ __forceinline__ void load_3d(uint32_t dst, const CUtensorMap* map,
                                        uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// global box (c0, c1, c2) of a float32 tensor map += the box at src
__device__ __forceinline__ void reduce_add_3d(const CUtensorMap* map, uint32_t src,
                                              int c0, int c1, int c2) {
  asm volatile(
      "cp.reduce.async.bulk.tensor.3d.global.shared::cta.add.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the shared-memory box at src into global box (c0, c1, c2) of a tensor
// map, rows past the end clipped
__device__ __forceinline__ void store_3d(const CUtensorMap* map, uint32_t src, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// at most N of this thread's bulk groups still read shared memory
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// at most N of this thread's bulk groups still in flight
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---- warpgroups ----

// this warpgroup's registers a thread: fewer (a producer), more (a
// consumer), from the CTA's pool; every thread of the warpgroup executes it
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// named barrier `id` (1-15; 0 is __syncthreads) over `n` threads
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// this warp's arrival on named barrier `id` of `n` threads, not waiting
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- host: tensor maps ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// libcuda's cuTensorMapEncodeTiled, reached through the runtime (so a
// library links no libcuda), or null
static inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                            &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, heads, d] tensor of `esize`-byte elements at ptr as a 3D map
// (d innermost) whose box is box_cols x 1 head x box_rows, 128-byte
// swizzle (box_cols * esize == 128), zeros past the end. False where the
// encode call refuses it.
static inline bool encode_rows(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                               int esize, int rows, int heads, int d, int box_cols,
                               int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)heads, (cuuint64_t)rows};
  const cuuint64_t strides[2] = {(cuuint64_t)d * esize, (cuuint64_t)heads * d * esize};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, 1u, (cuuint32_t)box_rows};
  const cuuint32_t elem[3] = {1u, 1u, 1u};
  return fn(map, type, 3, const_cast<void*>(ptr), dims, strides, box, elem,
            CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace tma
}  // namespace magi
