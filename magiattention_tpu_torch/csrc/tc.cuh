// Tensor-core building blocks for the port's bf16 kernels on Hopper
// (sm_90a): csrc/ffa_fwd_tc.cuh (B1/B2), csrc/ffa_bwd_dq_tc.cuh (B3/B4) and
// csrc/bwd_kv_tc.cuh (B5/B6, B8/B9); and, below the bf16 ones, the tf32
// blocks of the float32 forward (csrc/ffa_fwd_tf32.cuh, 3xTF32).
//
// Tiles. An operand tile is 64 rows of bf16 in shared memory, cut into
// panels of 64 columns (128 bytes a row, 8 KB a panel, panels PANEL_BYTES
// apart, each 1024-byte aligned) under the 128-byte swizzle that wgmma and
// TMA call SWIZZLE_128B: the 16-byte chunk c of row r sits at chunk
// c ^ (r % 8), so the 8 rows a wgmma core matrix reads, and the column
// pairs a warp stores, fall in distinct banks. One such tile serves both
// ways wgmma reads it:
// - K-major (desc_k): the tile's columns are the reduction dim (Q and K
//   in S = Q K^T); k-step kk of 16 columns starts 32 bytes into its panel,
//   8-row groups 1024 bytes apart;
// - MN-major (desc_mn, the operand transposed): the tile's rows are the
//   reduction dim (V in O += P V); k-step kk of 16 rows starts kk * 2048
//   bytes in, 8-row groups 1024 bytes apart, 64-column panels PANEL_BYTES
//   apart.
// Tiles are filled by cp.async (16 bytes a thread and copy, rows past the
// valid count zero-filled), then fence.proxy.async makes the generic-proxy
// writes visible to wgmma's async proxy.
//
// Products. wgmma.mma_async m64nNk16, bf16 in and float32 accumulate, one
// warpgroup (128 threads) per 64-row product. The float32 accumulator of
// m64nN: thread t (warp w = t / 32, lane l) holds rows 16 w + l / 4 and
// that + 8, columns 8 j + 2 (l % 4) + {0, 1} of every 8-column chunk j, as
// d[4 j + {0, 1}] (first row) and d[4 j + {2, 3}] (second row). That is
// the register layout of wgmma's A operand too, so an accumulator rounded
// to bf16 pairs (pack_bf16) feeds the next product from registers. The
// accumulator and A registers are fenced around every product (fence_*)
// so the compiler neither reads the first nor reuses the second before
// wgmma.wait_group.
#pragma once

#include "common.cuh"

namespace magi {
namespace tc {

constexpr uint32_t PANEL_BYTES = 64 * 128;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of element (r, c) of a swizzled tile
__device__ __forceinline__ uint32_t tile_offset(int r, int c) {
  return (c >> 6) * PANEL_BYTES + r * 128 +
         ((((c & 63) >> 3) ^ (r & 7)) << 4) + ((c & 7) << 1);
}

// 16 bytes global -> shared, zeros where !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, zero where !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's shared-memory writes become visible to the async proxy
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 64 rows of D bf16 values (row r at src + r * row_stride) into the
// swizzled tile at dst by cp.async; rows at or past n_valid (>= 1) are
// zero. The NT threads t = 0 .. NT - 1 each copy 64 * D / 8 / NT chunks.
template <int D, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long row_stride, int n_valid,
                                                int t) {
  constexpr int CPR = D / 8;  // 16-byte chunks a row
  static_assert((64 * CPR) % NT == 0, "chunks must divide among threads");
#pragma unroll
  for (int it = 0; it < 64 * CPR / NT; ++it) {
    const int i = t + it * NT;
    const int r = i / CPR, cc = i % CPR;
    const bool ok = r < n_valid;
    cp_async16(dst + (cc >> 3) * PANEL_BYTES + r * 128 +
                   (((cc & 7) ^ (r & 7)) << 4),
               ok ? src + (long)r * row_stride + cc * 8 : src, ok);
  }
}

// x, opaque to the compiler: what a loop computes from it is recomputed
// in the loop (a few integer ops) instead of hoisted into registers that
// stay live across it, where the accumulators need them.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// A shared-memory matrix descriptor, 128-byte swizzle.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// k-step kk (16 columns) of a tile read K-major
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * PANEL_BYTES + (kk & 3) * 32, 16, 1024);
}

// k-step kk (16 rows) of a tile read MN-major
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return make_desc(tile + kk * 2048, PANEL_BYTES, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int N, int M>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][M]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// two floats -> one register of bf16 (lo in the low half), round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 A fragments of one m64n64 accumulator: k-step kk of 16 columns
// (chunks 2 kk, 2 kk + 1) as the 4 registers wgmma takes from registers.
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4],
                                           const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      a[kk][e] = pack_bf16(d[8 * kk + 2 * e], d[8 * kk + 2 * e + 1]);
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A and B from shared memory
// (transposed: A 0, B 0), float32 accumulate.
__device__ __forceinline__ void wgmma_ss_n64_t00(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A and B from shared memory
// (transposed: A 1, B 1), float32 accumulate.
__device__ __forceinline__ void wgmma_ss_n64_t11(float (&d)[32], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D[64 x 64] += A[64 x 16] B[16 x 64], A from registers (the
// accumulator layout, bf16 pairs), B from shared memory (transposed: 1).
__device__ __forceinline__ void wgmma_rs_n64_t1(float (&d)[32],
                                                const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D[64 x 128] += A[64 x 16] B[16 x 128], A from registers (the
// accumulator layout, bf16 pairs), B from shared memory (transposed: 1).
__device__ __forceinline__ void wgmma_rs_n128_t1(float (&d)[64],
                                                 const uint32_t (&a)[4], uint64_t db, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" 
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}


// As to_a_frags, split in two: hi = bf16(x) and lo = bf16(x - hi), so
// hi + lo carries x to about 16 significant bits; two products (hi, then
// lo) against one bf16 operand give a float32 sum that a single bf16
// rounding of x would miss by up to 2^-9 relative.
__device__ __forceinline__ void to_a_frags_split(uint32_t (&hi)[4][4],
                                                 uint32_t (&lo)[4][4],
                                                 const float (&d)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float x0 = d[8 * kk + 2 * e], x1 = d[8 * kk + 2 * e + 1];
      __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][e] = *reinterpret_cast<uint32_t*>(&h);
      lo[kk][e] = pack_bf16(x0 - hf.x, x1 - hf.y);
    }
}

// O[64 x N] += A B over k-step kk, A from registers, B MN-major: N = 64
// or 128 (the head dim).
template <int N>
__device__ __forceinline__ void wgmma_rs_t1(float (&d)[N / 2],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  if constexpr (N == 128)
    wgmma_rs_n128_t1(d, a, db, 1);
  else
    wgmma_rs_n64_t1(d, a, db, 1);
}

// ---- tf32 (the float32 bodies: 3xTF32) ----
//
// A float32 operand tile for the .tf32 products uses the same 128-byte
// swizzle, 32 values a 128-byte row: element (r, c) of a tile of ROWS rows
// sits in panel c / 32 (ROWS * 128 bytes apart), row r, 16-byte chunk
// ((c % 32) / 4) ^ (r % 8). A k-step of wgmma's .tf32 shapes is 8 values,
// 32 bytes, as the bf16 k-step of 16, so k-step kk starts (kk % 4) * 32
// bytes into panel kk / 4. The PTX ISA lets only 16-bit types be read
// MN-major: both operands of a .tf32 product are K-major, so the B operand
// of O += P V is V transposed (head-dim rows of keys).
//
// The register A operand of m64nNk8.tf32: thread t (warp w, lane l) holds
// rows 16 w + l / 4 (a0, a2) and that + 8 (a1, a3), columns l % 4 (a0, a1)
// and l % 4 + 4 (a2, a3) of the k-step. The accumulator holds columns
// 2 (l % 4) and that + 1 instead: to feed an accumulator (P) back as A
// without shuffles, a k-step's logical column c is key 2 c for c < 4 and
// key 2 (c - 4) + 1 above, and the B operand's keys are stored in that
// order (kperm).
//
// 3xTF32: x = hi + lo with hi = tf32(x) (round to nearest) and lo = x -
// hi (exact in float32; wgmma reads its top 19 bits, dropping about 2^-21
// of x); a b is taken as hi_a hi_b + hi_a lo_b + lo_a hi_b, the dropped lo
// lo term about 2^-22 of |a b|, against 2^-11 for one tf32 product.

// byte offset of float32 element (r, c) of a swizzled tile of ROWS rows
template <int ROWS>
__device__ __forceinline__ uint32_t tile_offset32(int r, int c) {
  return (c >> 5) * (ROWS * 128) + r * 128 + ((((c & 31) >> 2) ^ (r & 7)) << 4) +
         ((c & 3) << 2);
}

// the logical position within its 8-key k-step of key j (kperm's inverse)
__host__ __device__ constexpr int kpos(int j) {
  return (j & 1) * 4 + ((j & 7) >> 1);
}

// k-step kk (8 values) of a float32 tile of ROWS rows read K-major
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k32(uint32_t tile, int kk) {
  return make_desc(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16, 1024);
}

// finite x rounded to tf32 (the low 13 bits zero), to nearest, ties away
// from zero: cvt.rna.tf32.f32's result by two integer operations
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xFFFFE000u);
}

// x as hi = tf32(x) and lo = x - hi
__device__ __forceinline__ void split_tf32(float x, float& hi, float& lo) {
  hi = tf32_rna(x);
  lo = x - hi;
}

// D[64 x 32] += A[64 x 8] B[8 x 32], tf32 from shared memory (both
// K-major), float32 accumulate.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 8] B[8 x 64], tf32 from shared memory (both
// K-major), float32 accumulate.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t da,
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// D[64 x 64] += A[64 x 8] B[8 x 64], A tf32 from registers, B from shared
// memory (K-major), float32 accumulate.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 8] B[8 x 128], as wgmma_tf32_rs_n64.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O[64 x N] += A B over one k-step, A tf32 from registers, B K-major: N =
// 64 or 128 (the head dim).
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db) {
  if constexpr (N == 128)
    wgmma_tf32_rs_n128(d, a, db);
  else
    wgmma_tf32_rs_n64(d, a, db);
}

// k-step kk of an m64n32 accumulator (P over a 32-key chunk) as the tf32
// A operand in kperm order, split: hi and lo (see above)
__device__ __forceinline__ void to_a_frags_tf32(uint32_t (&hi)[4][4],
                                                uint32_t (&lo)[4][4],
                                                const float (&d)[16]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // a0 row r col kperm(t) = key 2t: d[4kk]; a1 row r + 8: d[4kk + 2];
    // a2 key 2t + 1: d[4kk + 1]; a3: d[4kk + 3]
    const float x[4] = {d[4 * kk], d[4 * kk + 2], d[4 * kk + 1], d[4 * kk + 3]};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float h, l;
      split_tf32(x[e], h, l);
      hi[kk][e] = __float_as_uint(h);
      lo[kk][e] = __float_as_uint(l);
    }
  }
}

}  // namespace tc
}  // namespace magi
