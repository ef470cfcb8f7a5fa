// The body shared by the three paged-decode kernels for Hopper (sm_90a):
// paged_decode.cu (B10, one query row per slot), paged_decode_spec.cu (B11,
// spec_k draft rows per slot, a causal horizon per row) and
// paged_decode_int8.cu (B12, int8 pages with a float32 scale per (page, kv
// head)).
//
// What it computes: for slot s, kv head h and CTA row r = t * g + j (draft
// token t of spec_k, query head h * g + j of the group), softmax attention
// of q[s, t, h * g + j] over k/v rows [0, limit) of that slot, where
// limit = lengths[s] - (spec_k - 1 - t) and row p lives in page
// page_table[s, p / ps] at row p % ps. A row with limit <= 0 gives out 0 and
// lse -inf; lse in natural log. With spec_k = 1 this is the one-row decode.
//
// Design. A CTA holds the spec_k * g rows of one kv head (at most RMAX),
// which share every K/V read, as the TPU kernels' q tile does, and walks
// its part of the slot's page table chunk by chunk: the rows x chunk
// scores, the running max and sum per row in the exp2 domain (q scaled by
// softmax_scale * log2(e) in float32 inside the kernel), and P V
// (probabilities stored token-major, so one 16-byte read brings four rows'
// values of a token). Lengths and the table are read on the device, so one
// launch serves every tick; the walk stops at the slot's length and never
// reads a dead page or table entry; a shorter row masks its columns past
// its own limit.
//
// The walk is split across CTAs (flash-decoding). The grid is (kv head,
// slot, split): split z owns tokens [z * split_len, (z + 1) * split_len) of
// the slot, a whole number of 64-token units fixed on the host from the
// table width, page size, kv-head count and SM count, never from the
// lengths or spec_k (kernels/paged_decode.py:decode_split_plan), so one
// launch serves every tick and spec_k = 1 is B10's instance and bits. A CTA
// whose range starts past its slot's length returns at once. 256 threads
// walk the range in 32-token chunks of raw page rows (float32, bf16 or int8
// codes, converted as they are read), double-buffered in shared memory by
// cp.async: chunk c is computed while chunk c + 1 is copied and the table
// entries of chunk c + 2 are read. Scores: a thread takes one token, a
// quarter of d and half of the rows, its K slice read once into registers;
// the four partial sums are added in order by the softmax (one warp per
// row). P V: a thread takes two output columns (one at 32 rows) of a
// quarter (d 128) or an eighth (d 64) of the chunk's tokens; the token
// groups' sums are added pairwise in a fixed order after the walk. A slot
// that fits in one split is written by its split 0 directly; otherwise each
// split writes its unnormalised accumulator, max and sum per row to a
// float32 workspace and merge_kernel combines them in split order (no
// atomics: two launches give the same bits). Shared memory at d 128 with
// float32 pages (K rows padded 16 bytes against bank conflicts, V rows not;
// the partial scores and the probabilities share one space): 73.1 KiB at
// RMAX 8, 81.3 at 16, 97.5 at 32; with ptxas's 80, 128 and 128 registers
// that is three, two and two CTAs an SM. bf16 pages halve the K/V buffers.
//
// int8 pages (B12). The codes stay raw in shared memory (16 a cp.async, K
// rows strided D + 16 bytes), and each stage also holds every token row's K
// and V scale (its page's (page, kv head) entries, copied by 4-byte
// cp.async in the chunk's commit group: a 32-token chunk spans two pages of
// 16). The scales are folded into the softmax warp, not into every element:
// a token's summed score is multiplied by its K scale before the limit
// mask, the running sum takes the unscaled probability, and the stored
// probability is multiplied by the token's V scale for P V. That is two
// multiplies per (token, row) where a dequantizing copy pays one per
// element; the rounding differs from the plain version's code * scale
// first, within the float32 gate.
//
// What bounds it on this card: bytes. Each live K/V row is read once (2 * D
// * itemsize per token and kv head: 1 byte an element for int8 pages, plus
// 8 bytes of scales per page and kv head) against 4 * rows * D flops, below
// the ~20 flops a byte at which float32 CUDA cores would be the limit even
// at 32 rows. The split spreads a long slot over hk * splits CTAs; what
// remains between it and the bytes bound is the work of each chunk on the
// CUDA cores and in shared memory (bf16 pages, half the bytes, are not
// twice as fast), three CTAs an SM at most, and the merge launch.
//
// Head dim 256: page rows twice as wide, the same walk. A score takes NSL =
// 8 d-slices of 32 values (so a thread's K slice stays 32 registers and a
// thread takes every row), P V two columns (one at 32 rows) of a half
// (the whole chunk's tokens at 32 rows), the int8 row scales unchanged.
// Shared memory at float32 pages: 152 KB at RMAX 8 to 197 KB at 32, one
// CTA an SM.
#pragma once

#include <type_traits>

#include "tc.cuh"  // cp.async

namespace magi {
namespace decode {
// Internal linkage: every kernel library includes this body, and an
// instance with external linkage would be bound across the libraries to
// the first one loaded, whose CUDA runtime does not know the others'
// kernels.
namespace {

constexpr int NTS = 256;   // threads per CTA of the walk
constexpr int NTM = 128;   // threads per CTA of merge_kernel
constexpr int TCS = 32;    // tokens per chunk (split_len % TCS == 0)
constexpr int STAGES = 2;  // K/V chunks in shared memory

// d-slices of a score: 32 or fewer values a slice
template <int D>
__host__ __device__ constexpr int nsl() {
  return D > 128 ? 8 : 4;
}

// output columns per P V thread (one at 32 rows, where two would hold 64
// accumulators a thread)
template <int RMAX>
__host__ __device__ constexpr int cpt() {
  return RMAX >= 32 ? 1 : 2;
}

// One CTA's shared memory: the q rows (float32), four arrays per row, then
// STAGES K and V chunks of TCS raw page rows of type TP (K rows strided D
// plus 16 bytes so the 16-byte reads of 8 neighbouring threads hit
// distinct banks, V rows not), the scores (token-major probabilities in
// the same space as the NSL x RMAX x TCS partial scores) and, for int8
// pages, each stage's K and V scale of every token row. After the walk
// the G / 2 x RMAX x D token-group sums reuse the chunks.
template <typename TP, int D, int RMAX>
struct Smem {
  static constexpr bool QUANT = sizeof(TP) == 1;
  static constexpr int DS = D + 16 / (int)sizeof(TP);  // K row stride
  static constexpr int KCH = TCS * DS;  // elements of one K chunk
  static constexpr int VCH = TCS * D;   // elements of one V chunk
  static constexpr int SR = RMAX + 4;   // token stride of the scores
  static constexpr int NSL = nsl<D>();
  static constexpr int SCR = NSL * RMAX * TCS > TCS * SR ? NSL * RMAX * TCS
                                                         : TCS * SR;
  static constexpr int SCALES = QUANT ? 2 * STAGES * TCS : 0;  // floats
  static constexpr int G = NTS / (D / cpt<RMAX>());
  static constexpr size_t walk = sizeof(TP) * STAGES * (KCH + VCH) +
                                 sizeof(float) * (SCR + SCALES);
  static constexpr size_t red = sizeof(float) * (G / 2) * RMAX * D;
  static constexpr size_t bytes =
      sizeof(float) * (RMAX * D + 4 * RMAX) + (walk > red ? walk : red);
};

// 16 / sizeof(T) consecutive values of a K row in shared memory as float32
// (int8: the codes, unscaled)
__device__ __forceinline__ void smem_vec(const float* p, float* x) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  x[0] = v.x;
  x[1] = v.y;
  x[2] = v.z;
  x[3] = v.w;
}
__device__ __forceinline__ void smem_vec(const __nv_bfloat16* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* b = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(b[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void smem_vec(const int8_t* p, float* x) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const int8_t* b = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = (float)b[i];
}
__device__ __forceinline__ float smem_f32(float x) { return x; }
__device__ __forceinline__ float smem_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float smem_f32(int8_t x) { return (float)x; }

// A chunk's scores as NSL partial dot products over d-slices of W = D /
// NSL values. Thread -> token j = tid % TCS, slice sl = (tid / TCS) % NSL,
// rows rh * RR .. rh * RR + RR - 1 of row half rh = tid / (TCS * NSL): its
// K slice read once into registers for all of its rows (q read by
// broadcast), each row's partial to Pp[sl][r][j]. int8 pages: the codes,
// unscaled (split_softmax applies the token row's scale).
template <typename TP, int D, int RMAX>
__device__ __forceinline__ void split_scores(const float* Qs, const TP* Ks,
                                             float* Pp, int rows) {
  constexpr int DS = D + 16 / (int)sizeof(TP);
  constexpr int VEC = 16 / (int)sizeof(TP);
  constexpr int NSL = nsl<D>();
  constexpr int RH = NTS / TCS / NSL;  // row halves (1 at NSL 8)
  constexpr int RR = RMAX / RH;        // rows per thread
  constexpr int W = D / NSL;
  static_assert(RH * NSL * TCS == NTS && RR * RH == RMAX && W % VEC == 0,
                "score geometry");
  const int j = threadIdx.x % TCS, sl = (threadIdx.x / TCS) % NSL;
  const int rh = threadIdx.x / (TCS * NSL);
  float kv[W];
#pragma unroll
  for (int e = 0; e < W; e += VEC) smem_vec(Ks + j * DS + sl * W + e, kv + e);
  const float* qs = Qs + sl * W;
#pragma unroll 8  // 16 rows at once would spill at 32 rows a CTA
  for (int k = 0; k < RR; ++k) {
    const int r = rh * RR + k;
    if (r < rows) {
      float a0 = 0.f, a1 = 0.f;
#pragma unroll
      for (int e = 0; e < W; e += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qs + r * D + e);
        a0 = fmaf(qv.x, kv[e], a0);
        a1 = fmaf(qv.y, kv[e + 1], a1);
        a0 = fmaf(qv.z, kv[e + 2], a0);
        a1 = fmaf(qv.w, kv[e + 3], a1);
      }
      Pp[(sl * RMAX + r) * TCS + j] = a0 + a1;
    }
  }
}

// Each row's score of token j = lane as the sum of its NSL partials in
// slice order (int8 pages: times the token row's K scale Sk[lane]), -inf
// past the row's limit, then the online-softmax update in the exp2 domain:
// one warp per row (the rows of a warp interleaved), the running max Ms
// and sum Ls updated and As given each row's rescale. The probabilities go
// to Ss (token-major; int8 pages: times the token row's V scale Sv[lane],
// while Ls sums them unscaled), which shares the partials' space: every
// warp has read its partials (a barrier) before any writes them.
template <int RMAX, bool QUANT, int NSL>
__device__ __forceinline__ void split_softmax(const float* Pp, float* Ss,
                                              float* Ms, float* Ls, float* As,
                                              const int* Lim, const float* Sk,
                                              const float* Sv, int rows,
                                              int c0) {
  constexpr int SR = RMAX + 4;
  constexpr int WARPS = NTS / 32;
  constexpr int RPW = RMAX / WARPS;  // rows per warp
  static_assert(TCS == 32 && RPW * WARPS == RMAX, "softmax geometry");
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float p[RPW];
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + k * WARPS;
    if (r >= rows) continue;  // warp-uniform
    float x = Pp[r * TCS + lane];
#pragma unroll
    for (int sl = 1; sl < NSL; ++sl) x += Pp[(sl * RMAX + r) * TCS + lane];
    if constexpr (QUANT) x *= Sk[lane];
    x = c0 + lane < Lim[r] ? x : -INFINITY;
    float mx = x;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_old = Ms[r];
    const float m_new = fmaxf(m_old, mx);
    // -inf only while a row has seen no live column: then p and the
    // rescale are 0 and the row stays empty
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    p[k] = exp2f(x - m_use);
    float sum = p[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0) {
      const float alpha = exp2f(m_old - m_use);
      As[r] = alpha;
      Ls[r] = Ls[r] * alpha + sum;
      Ms[r] = m_new;
    }
  }
  __syncthreads();
  const float sv = QUANT ? Sv[lane] : 1.f;
#pragma unroll
  for (int k = 0; k < RPW; ++k) {
    const int r = warp + k * WARPS;
    if (r < rows) Ss[lane * SR + r] = QUANT ? p[k] * sv : p[k];
  }
}

// acc[c][r] = acc[c][r] * As[r] + sum over tokens j in [j0, j0 + nj) of
// P[j, r] * V[j, col + c * cs] for c < NC (one 16-byte read of four rows'
// probabilities serves NC columns; V rows unpadded, a warp reads
// consecutive columns)
template <typename TP, int D, int RMAX, int NC>
__device__ __forceinline__ void split_pv(const TP* Vs, const float* Ss,
                                         const float* As, int rows, int col,
                                         int cs, int j0, int nj,
                                         float (&acc)[NC][RMAX]) {
  constexpr int SR = RMAX + 4;
#pragma unroll
  for (int r = 0; r < RMAX; ++r)
    if (r < rows) {
      const float a = As[r];
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[c][r] *= a;
    }
#pragma unroll 4
  for (int i = 0; i < nj; ++i) {
    const int j = j0 + i;
    float vv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) vv[c] = smem_f32(Vs[j * D + col + c * cs]);
#pragma unroll
    for (int r = 0; r < RMAX; r += 4)
      if (r < rows) {
        const float4 p = *reinterpret_cast<const float4*>(Ss + j * SR + r);
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc[c][r] = fmaf(p.x, vv[c], acc[c][r]);
          acc[c][r + 1] = fmaf(p.y, vv[c], acc[c][r + 1]);
          acc[c][r + 2] = fmaf(p.z, vv[c], acc[c][r + 2]);
          acc[c][r + 3] = fmaf(p.w, vv[c], acc[c][r + 3]);
        }
      }
  }
}

// pos / ps and pos % ps, by shift and mask where ps is a power of two
// (psh = log2 ps, else -1)
__device__ __forceinline__ int page_of(int pos, int ps, int psh) {
  return psh >= 0 ? pos >> psh : pos / ps;
}
__device__ __forceinline__ int row_of(int pos, int ps, int psh) {
  return psh >= 0 ? pos & (ps - 1) : pos % ps;
}

// 16-byte copies of one K (or V) chunk: CPR a page row, ITER a thread
// (int8 at d 64: half of the threads copy nothing)
template <typename TP, int D>
struct Copy {
  static constexpr int CPR = D / Vec<TP>::N;
  static constexpr int N = TCS * CPR;
  static constexpr int ITER = (N + NTS - 1) / NTS;
};

// The page of each token this thread copies in the chunk at c0 (0 past
// hi: never read), ahead of the chunk's copies.
template <typename TP, int D>
__device__ __forceinline__ void chunk_pages(int (&page)[Copy<TP, D>::ITER],
                                            const int* __restrict__ trow,
                                            int c0, int hi, int ps, int psh) {
  using C = Copy<TP, D>;
#pragma unroll
  for (int it = 0; it < C::ITER; ++it) {
    const int pos = c0 + (int)(threadIdx.x + it * NTS) / C::CPR;
    page[it] = pos < hi ? trow[page_of(pos, ps, psh)] : 0;
  }
}

// The K and V rows of the chunk at c0 (its pages from chunk_pages) into
// shared memory at kd (row stride D + 16 bytes) and vd (row stride D), raw,
// by cp.async; rows at or past hi are zero-filled. int8 pages: the thread
// that copies a row's first 16 bytes also copies its page's (page, kv head)
// scales into sk[j] and sv[j] (0 past hi), in the same commit group.
template <typename TP, int D>
__device__ __forceinline__ void chunk_copy(TP* kd, TP* vd, float* sk, float* sv,
                                           const TP* __restrict__ k_pages,
                                           const TP* __restrict__ v_pages,
                                           const float* __restrict__ k_scales,
                                           const float* __restrict__ v_scales,
                                           const int (&page)[Copy<TP, D>::ITER],
                                           int c0, int hi, int ps, int psh,
                                           long page_row, int hk, int h) {
  using C = Copy<TP, D>;
  constexpr int VEC = Vec<TP>::N;
  constexpr int DS = D + VEC;
#pragma unroll
  for (int it = 0; it < C::ITER; ++it) {
    const int i = threadIdx.x + it * NTS;
    if (C::N % NTS != 0 && i >= C::N) break;
    const int j = i / C::CPR, c = (i % C::CPR) * VEC;
    const bool ok = c0 + j < hi;
    const long base = ((long)page[it] * ps + row_of(c0 + j, ps, psh)) * page_row +
                      (long)h * D + c;
    tc::cp_async16(tc::smem_u32(kd + j * DS + c), ok ? k_pages + base : k_pages, ok);
    tc::cp_async16(tc::smem_u32(vd + j * D + c), ok ? v_pages + base : v_pages, ok);
    if constexpr (sizeof(TP) == 1) {
      if (c == 0) {
        const long si = (long)page[it] * hk + h;
        tc::cp_async4(tc::smem_u32(sk + j), ok ? k_scales + si : k_scales, ok);
        tc::cp_async4(tc::smem_u32(sv + j), ok ? v_scales + si : v_scales, ok);
      }
    }
  }
}

// Out row of CTA row r = t * g + j: (s * spec_k + t) * hq + h * g + j.
__device__ __forceinline__ long out_row(int s, int spec_k, int hq, int h,
                                        int g, int r) {
  return ((long)s * spec_k + r / g) * hq + (long)h * g + r % g;
}

// TQ: q and out (float or bf16); TP: the pages (TQ, or int8_t with float32
// scales per (page, kv head)). Grid (kv head, slot, split); the partials of
// multi-split slots go to part (splits x R rows of D accumulators, then
// splits x R rows of (max, sum); R = S * spec_k * hq, a row's index that of
// its out row).
template <typename TQ, typename TP, int D, int RMAX>
__global__ void __launch_bounds__(NTS, D > 128 ? 1 : RMAX <= 8 ? 3 : 2)
    decode_kernel(const TQ* __restrict__ q, const TP* __restrict__ k_pages,
                  const TP* __restrict__ v_pages,
                  const float* __restrict__ k_scales,
                  const float* __restrict__ v_scales,
                  const int* __restrict__ table,
                  const int* __restrict__ lengths, TQ* __restrict__ out,
                  float* __restrict__ lse, float* __restrict__ part, int hq,
                  int hk, int ps, int P, int spec_k, int split_len,
                  float scale_log2) {
  using SM = Smem<TP, D, RMAX>;
  constexpr bool QUANT = SM::QUANT;
  constexpr int CPT = cpt<RMAX>();
  constexpr int CS = D / CPT;  // P V threads per token group
  constexpr int G = SM::G;     // token groups of P V
  constexpr int QVEC = Vec<TQ>::N;
  constexpr int QCPR = D / QVEC;  // 16-byte chunks per q row
  static_assert(NTS % CS == 0, "output columns per thread");
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;        // rows x D, pre-scaled
  float* Ms = Qs + RMAX * D;  // running max per row (log2 domain)
  float* Ls = Ms + RMAX;   // running sum per row
  float* As = Ls + RMAX;   // this chunk's rescale factor per row
  int* Lim = reinterpret_cast<int*>(As + RMAX);  // live columns per row
  TP* Ks = reinterpret_cast<TP*>(Lim + RMAX);  // STAGES x TCS x DS
  TP* Vs = Ks + STAGES * SM::KCH;              // STAGES x TCS x D
  float* Ss = reinterpret_cast<float*>(Vs + STAGES * SM::VCH);
  float* Sks = Ss + SM::SCR;        // int8: STAGES x TCS K scales
  float* Svs = Sks + STAGES * TCS;  // int8: STAGES x TCS V scales

  const int g = hq / hk, rows = spec_k * g;
  const int h = blockIdx.x, s = blockIdx.y, tid = threadIdx.x;
  const int len = lengths[s];
  // this CTA's tokens [lo, hi): split blockIdx.z's range of the slot
  const int lo = (int)blockIdx.z * split_len;
  if (blockIdx.z > 0 && lo >= len) return;
  const int hi = min(len, lo + split_len);
  const int* trow = table + (long)s * P;
  const long page_row = (long)hk * D;  // elements between rows of a page

  for (int i = tid; i < rows * QCPR; i += NTS) {
    const int r = i / QCPR, c = (i % QCPR) * QVEC;
    const long qr = out_row(s, spec_k, hq, h, g, r);
    Vec<TQ>::to_f32(ldg16(q + qr * D + c), Qs + r * D + c, scale_log2);
  }
  if (tid < RMAX) {
    Ms[tid] = -INFINITY;
    Ls[tid] = 0.f;
    Lim[tid] = len - (spec_k - 1 - tid / g);
  }

  // chunk c0 is computed while chunk c0 + TCS is copied and the table
  // entries of chunk c0 + 2 TCS are read. P V: thread -> columns cp + c *
  // CS (c < CPT) of token group grp, tokens [grp * TCS / G, (grp + 1) *
  // TCS / G) of each chunk; the groups' sums are added after the walk.
  const int cp = tid % CS, grp = tid / CS;
  const int psh = (ps & (ps - 1)) == 0 ? __ffs(ps) - 1 : -1;
  float acc[CPT][RMAX];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int r = 0; r < RMAX; ++r) acc[c][r] = 0.f;
  int page[Copy<TP, D>::ITER];
  chunk_pages<TP, D>(page, trow, lo, hi, ps, psh);
  if (lo < hi)
    chunk_copy<TP, D>(Ks, Vs, Sks, Svs, k_pages, v_pages, k_scales, v_scales,
                      page, lo, hi, ps, psh, page_row, hk, h);
  tc::cp_async_commit();
  chunk_pages<TP, D>(page, trow, lo + TCS, hi, ps, psh);
  for (int c0 = lo, st = 0; c0 < hi; c0 += TCS, st ^= 1) {
    if (c0 + TCS < hi) {
      chunk_copy<TP, D>(Ks + (st ^ 1) * SM::KCH, Vs + (st ^ 1) * SM::VCH,
                        Sks + (st ^ 1) * TCS, Svs + (st ^ 1) * TCS, k_pages,
                        v_pages, k_scales, v_scales, page, c0 + TCS, hi, ps,
                        psh, page_row, hk, h);
      chunk_pages<TP, D>(page, trow, c0 + 2 * TCS, hi, ps, psh);
    }
    tc::cp_async_commit();   // empty at the last chunk
    tc::cp_async_wait<1>();  // this thread's copies of chunk c0 landed
    __syncthreads();         // everyone's, and Qs and Lim at the first
    split_scores<TP, D, RMAX>(Qs, Ks + st * SM::KCH, Ss, rows);
    __syncthreads();
    split_softmax<RMAX, QUANT, SM::NSL>(Ss, Ss, Ms, Ls, As, Lim,
                                        Sks + st * TCS, Svs + st * TCS, rows,
                                        c0);
    __syncthreads();
    // a token past hi has probability 0 and a zero-filled V row
    split_pv<TP, D, RMAX, CPT>(Vs + st * SM::VCH, Ss, As, rows, cp, CS,
                               grp * (TCS / G), TCS / G, acc);
    __syncthreads();  // stage st and Ss are free for the next chunk
  }
  // the token groups' accumulators, added pairwise (group k + half into
  // group k, half = G / 2, G / 4, ..., 1): a fixed order
  float* red = reinterpret_cast<float*>(Ks);  // G / 2 x RMAX x D
#pragma unroll
  for (int half = G / 2; half > 0; half /= 2) {
    if (grp >= half && grp < 2 * half) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r < rows) red[((grp - half) * RMAX + r) * D + cp + c * CS] = acc[c][r];
    }
    __syncthreads();
    if (grp < half) {
#pragma unroll
      for (int c = 0; c < CPT; ++c)
#pragma unroll
        for (int r = 0; r < RMAX; ++r)
          if (r < rows) acc[c][r] += red[(grp * RMAX + r) * D + cp + c * CS];
    }
    __syncthreads();
  }
  const bool direct = len <= split_len;  // the row's whole walk
  const long R = (long)gridDim.y * spec_k * hq;
  if (grp == 0) {
#pragma unroll
    for (int r = 0; r < RMAX; ++r)
      if (r < rows) {
        const long orow = out_row(s, spec_k, hq, h, g, r);
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int col = cp + c * CS;
          if (direct)
            store_out(out + orow * D + col, Lim[r] > 0 ? acc[c][r] / Ls[r] : 0.f);
          else  // this split's partials (no live column: 0, -inf, 0)
            part[(blockIdx.z * R + orow) * D + col] = acc[c][r];
        }
      }
  }
  if (tid < rows) {
    const long orow = out_row(s, spec_k, hq, h, g, tid);
    if (direct) {
      lse[orow] = Lim[tid] > 0 ? (Ms[tid] + log2f(Ls[tid])) * LN2 : -INFINITY;
    } else {
      float* pml = part + gridDim.z * R * D + (blockIdx.z * R + orow) * 2;
      pml[0] = Ms[tid];
      pml[1] = Ls[tid];
    }
  }
}

// The splits' partials of one out row per warp, in split order: M = max
// m_i, L = sum l_i 2^(m_i - M), out = sum acc_i 2^(m_i - M) / L, lse =
// (M + log2 L) ln 2. Lane i reads split i's (m, l), so the reads of a row
// are in flight together; the sums then run over the splits in order. A
// split in which the row saw no live column (m_i = -inf) adds nothing; a
// row with none in any split gives (0, -inf). Rows of a slot that fits in
// one split were written by its split 0.
template <typename TQ, int D>
__global__ void __launch_bounds__(NTM)
    merge_kernel(const float* __restrict__ part,
                 const int* __restrict__ lengths, TQ* __restrict__ out,
                 float* __restrict__ lse, long R, int rows_per_slot,
                 int splits, int split_len) {
  constexpr int CPL = D / 32;  // columns per lane
  const int lane = threadIdx.x & 31;
  const long row = (long)blockIdx.x * (NTM / 32) + (threadIdx.x >> 5);
  if (row >= R) return;
  const int len = lengths[row / rows_per_slot];
  if (len <= split_len) return;
  const int n = (len + split_len - 1) / split_len;  // splits with tokens
  const float* ml = part + splits * R * D;
  float M = -INFINITY;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    if (i < n) M = fmaxf(M, ml[(i * R + row) * 2]);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
  float L = 0.f, o[CPL];
#pragma unroll
  for (int c = 0; c < CPL; ++c) o[c] = 0.f;
  for (int i0 = 0; i0 < n; i0 += 32) {
    const int i = i0 + lane;
    float w = 0.f, l = 0.f;  // this lane's split: weight and sum
    if (i < n) {
      const float m = ml[(i * R + row) * 2];
      l = ml[(i * R + row) * 2 + 1];
      w = m == -INFINITY ? 0.f : exp2f(m - M);
    }
    const int cnt = min(32, n - i0);
#pragma unroll 4
    for (int u = 0; u < cnt; ++u) {
      const float wu = __shfl_sync(0xffffffffu, w, u);
      L = fmaf(__shfl_sync(0xffffffffu, l, u), wu, L);
      const float* a = part + ((i0 + u) * R + row) * D;
#pragma unroll
      for (int c = 0; c < CPL; ++c) o[c] = fmaf(a[lane + 32 * c], wu, o[c]);
    }
  }
#pragma unroll
  for (int c = 0; c < CPL; ++c)
    store_out(out + row * D + lane + 32 * c, L > 0.f ? o[c] / L : 0.f);
  if (lane == 0) lse[row] = L > 0.f ? (M + log2f(L)) * LN2 : -INFINITY;
}

// One launch of decode_kernel over S slots x hk kv heads x splits, then
// merge_kernel where the plan has more than one split; 0 or the CUDA
// error.
template <typename TQ, typename TP, int D, int RMAX>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const float* k_scales, const float* v_scales, const int* table,
           const int* lengths, void* out, float* lse, float* part, int S,
           int hq, int hk, int ps, int P, int spec_k, int splits,
           int split_len, float softmax_scale, void* stream) {
  static bool smem_ok = false;
  const size_t smem = Smem<TP, D, RMAX>::bytes;
  auto* kernel = decode_kernel<TQ, TP, D, RMAX>;
  cudaError_t e = allow_smem(kernel, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t st = (cudaStream_t)stream;
  kernel<<<dim3(hk, S, splits), NTS, smem, st>>>(
      static_cast<const TQ*>(q), static_cast<const TP*>(k_pages),
      static_cast<const TP*>(v_pages), k_scales, v_scales, table, lengths,
      static_cast<TQ*>(out), lse, part, hq, hk, ps, P, spec_k, split_len,
      softmax_scale * LOG2E);
  e = cudaGetLastError();
  if (e != cudaSuccess || splits == 1) return (int)e;
  const long R = (long)S * spec_k * hq;
  const long warps = NTM / 32;
  merge_kernel<TQ, D><<<(unsigned)((R + warps - 1) / warps), NTM, 0, st>>>(
      part, lengths, static_cast<TQ*>(out), lse, R, spec_k * hq, splits,
      split_len);
  return (int)cudaGetLastError();
}

// head_dim 64, 128 or 256; rows = spec_k * hq / hk at most RMAX; splits >= 1
// ranges of split_len tokens (a multiple of TCS) that cover the table
// (splits * split_len >= P * ps) and, where splits > 1, a workspace part
// of splits * S * spec_k * hq * (D + 2) floats; int8 pages need their
// scales.
template <typename TQ, typename TP, int RMAX>
int dispatch(int d, const void* q, const void* k_pages, const void* v_pages,
             const float* k_scales, const float* v_scales, const int* table,
             const int* lengths, void* out, float* lse, float* part, int S,
             int hq, int hk, int ps, int P, int spec_k, int splits,
             int split_len, float softmax_scale, void* stream) {
  if (hk <= 0 || hq % hk != 0 || spec_k < 1 || spec_k * (hq / hk) > RMAX)
    return (int)cudaErrorInvalidValue;
  if (splits < 1 || split_len <= 0 || split_len % TCS != 0 ||
      (long)splits * split_len < (long)P * ps ||
      (splits > 1 && part == nullptr) ||
      (sizeof(TP) == 1 && (k_scales == nullptr || v_scales == nullptr)))
    return (int)cudaErrorInvalidValue;
  switch (d) {
    case 64:
      return launch<TQ, TP, 64, RMAX>(
          q, k_pages, v_pages, k_scales, v_scales, table, lengths, out, lse,
          part, S, hq, hk, ps, P, spec_k, splits, split_len, softmax_scale,
          stream);
    case 128:
      return launch<TQ, TP, 128, RMAX>(
          q, k_pages, v_pages, k_scales, v_scales, table, lengths, out, lse,
          part, S, hq, hk, ps, P, spec_k, splits, split_len, softmax_scale,
          stream);
    case 256:
      return launch<TQ, TP, 256, RMAX>(
          q, k_pages, v_pages, k_scales, v_scales, table, lengths, out, lse,
          part, S, hq, hk, ps, P, spec_k, splits, split_len, softmax_scale,
          stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace decode
}  // namespace magi
