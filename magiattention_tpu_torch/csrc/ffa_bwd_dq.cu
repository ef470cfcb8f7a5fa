// FFA backward, dq, over the host-built q-major work list, for Hopper
// (sm_90a).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_bwd_dq_kernel (wrapper
// _ffa_bwd_dq_pallas, pallas_call at ffa.py:931).
//
// What it computes: for every q head h and q row i,
//   dq[i] = scale * sum_j dS[i, j] k[j],   dS = P * (dP - delta[i]) (* dcap)
// over the k rows j that some slice covers (the forward's mask), with
// P = exp(s - lse[i]) recomputed from the forward's natural-log lse,
// s = scale * q.k (softcapped: s = cap * tanh(s / cap), and dcap = 1 -
// tanh^2 is the chain factor), dP = dO.v and delta = rowsum(dO * O)
// (csrc/ffa_bwd_delta.cu). A row no slice covers has lse = -inf: its P is
// exactly 0 and so is its dq. The result is float32.
//
// Design. The TPU kernel walks a sequential grid (hq, W) and carries a q
// tile's dq in VMEM scratch from its IS_FIRST item to its IS_LAST item.
// Here, as in csrc/ffa_fwd.cu, ONE CTA owns one (q tile, q head) and loops
// over that q tile's run of the SAME q-major plan (run_ptr), so dq stays in
// registers for the whole run, is written once, and needs no atomics: the
// result does not depend on the order in which CTAs run. CTAs take q tiles
// from the last to the first, so under a causal mask the longest runs
// start first.
//
// Q and dO of the tile go to shared memory once. Per work item the k and v
// tiles go to shared memory, each of the 256 threads computes a 4 x 4
// block of S and of dP with float32 FMAs (rows ty + 16 i, cols tx + 16 j),
// masks unless the item is IS_FULL, forms dS and writes it to shared
// memory; then acc += dS K, each thread owning 4 rows x D/16 columns. The
// scores are scaled in float32 inside the kernel: the TPU kernel rounds a
// pre-scaled copy of q back to the input type (ffa.py:901-902), this one
// does not. There is no finite MASK_VALUE: masked entries and dead rows
// get P = 0 by a select.
//
// What bounds it on this card: operations. Work is 6 * D flops per live
// (row, col) pair and head (S, dP and dS K), on the CUDA cores in float32
// (67 TFLOP/s peak on an H100 SXM) for bf16 inputs too; tensor cores and
// TMA are later work. Shared memory per CTA is 152 KB at D = 128 (Q, dO,
// K, V at stride D + 4 and the 64 x 80 dS tile), so one CTA runs per SM.
#include "common.cuh"

namespace {

using magi::LOG2E;
using magi::META_DIM;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D>
struct DqSmem {
  static constexpr int DS = D + 4;      // row stride of Q, dO, K, V
  static constexpr int PSTR = BK + 16;  // row stride of the dS tile
  static constexpr size_t bytes =
      sizeof(float) * (2 * BQ * DS + 2 * BK * DS + BQ * PSTR);
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    ffa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, float* __restrict__ dq,
                      const int* __restrict__ work_kt,
                      const int* __restrict__ meta,
                      const int* __restrict__ run_ptr, int sq, int sk, int hq,
                      int hk, int num_q_tiles, float scale, float softcap) {
  constexpr int DS = DqSmem<D>::DS;
  constexpr int PSTR = DqSmem<D>::PSTR;
  constexpr int CG = D / 64;  // float4 column groups a thread owns in dq
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + BQ * DS;
  float* Ks = dOs + BQ * DS;
  float* Vs = Ks + BK * DS;
  float* dSs = Vs + BK * DS;

  const int qt = num_q_tiles - 1 - (int)blockIdx.x;
  const int h = blockIdx.y;
  const int hkv = h / (hq / hk);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q0 = qt * BQ;
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;
  const int q_valid = min(BQ, sq - q0);

  magi::load_tile<T, D, NT>(Qs, q + ((long)q0 * hq + h) * D, q_rs, q_valid);
  magi::load_tile<T, D, NT>(dOs, dout + ((long)q0 * hq + h) * D, q_rs,
                            q_valid);

  // softcap-free scores go straight to the log2 domain, and lse with them;
  // with a softcap the tanh runs on the naturally scaled score
  const bool capped = softcap > 0.f;
  const float qk_scale = capped ? scale : scale * LOG2E;
  float lse_r[4], delta_r[4];
  bool dead[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const float l = row < sq ? lse[(long)row * hq + h] : -INFINITY;
    dead[i] = l == -INFINITY;  // no slice covers the row (or past sq)
    lse_r[i] = capped ? l : l * LOG2E;
    delta_r[i] = row < sq ? delta[(long)row * hq + h] : 0.f;
  }

  float acc[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) acc[i][c] = 0.f;

  const int w_end = run_ptr[qt + 1];
  for (int w = run_ptr[qt]; w < w_end; ++w) {
    const magi::Item item(meta + (long)w * META_DIM);
    if (item.empty()) continue;  // dummy item of an uncovered tile
    const int k0 = work_kt[w] * BK;
    const int k_valid = min(BK, sk - k0);

    __syncthreads();  // the previous item's dS K is done with Ks and dSs
    magi::load_tile<T, D, NT>(Ks, k + ((long)k0 * hk + hkv) * D, kv_rs,
                              k_valid);
    magi::load_tile<T, D, NT>(Vs, v + ((long)k0 * hk + hkv) * D, kv_rs,
                              k_valid);
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 2
    for (int dd = 0; dd < D; dd += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(Qs + (ty + 16 * i) * DS + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * DS + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(dOs + (ty + 16 * i) * DS + dd);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(Vs + (tx + 16 * j) * DS + dd);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], b[j], dp[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = s[i][j] * qk_scale, dcap = 1.f;
        if (capped) {
          const float t = tanhf(x / softcap);
          x = softcap * t;
          dcap = 1.f - t * t;
        }
        const bool live =
            !dead[i] &&
            (item.full || item.live(q0 + ty + 16 * i, k0 + tx + 16 * j));
        const float p =
            live ? (capped ? expf(x - lse_r[i]) : exp2f(x - lse_r[i])) : 0.f;
        dSs[(ty + 16 * i) * PSTR + tx + 16 * j] =
            p * (dp[i][j] - delta_r[i]) * dcap;
      }
    __syncthreads();  // dS is visible

#pragma unroll 2
    for (int kk = 0; kk < BK; kk += 4) {
      float4 dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        dsv[i] =
            *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * PSTR + kk);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int cg = 0; cg < CG; ++cg) {
          const float4 kv = *reinterpret_cast<const float4*>(
              Ks + (kk + e) * DS + cg * 64 + tx * 4);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float d = e == 0   ? dsv[i].x
                            : e == 1 ? dsv[i].y
                            : e == 2 ? dsv[i].z
                                     : dsv[i].w;
            acc[i][cg * 4 + 0] = fmaf(d, kv.x, acc[i][cg * 4 + 0]);
            acc[i][cg * 4 + 1] = fmaf(d, kv.y, acc[i][cg * 4 + 1]);
            acc[i][cg * 4 + 2] = fmaf(d, kv.z, acc[i][cg * 4 + 2]);
            acc[i][cg * 4 + 3] = fmaf(d, kv.w, acc[i][cg * 4 + 3]);
          }
        }
      }
    }
  }

  // the scale folds into the one write (dS carries none)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= sq) continue;
    float* o = dq + ((long)row * hq + h) * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg)
      *reinterpret_cast<float4*>(o + cg * 64 + tx * 4) = make_float4(
          acc[i][cg * 4 + 0] * scale, acc[i][cg * 4 + 1] * scale,
          acc[i][cg * 4 + 2] * scale, acc[i][cg * 4 + 3] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dq,
           const int* work_kt, const int* meta, const int* run_ptr, int sq,
           int sk, int hq, int hk, int num_q_tiles, float scale,
           float softcap, void* stream) {
  static bool smem_ok = false;
  const size_t smem = DqSmem<D>::bytes;
  cudaError_t e = magi::allow_smem(ffa_bwd_dq_kernel<T, D>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_q_tiles, hq);
  ffa_bwd_dq_kernel<T, D><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dq,
      work_kt, meta, run_ptr, sq, sk, hq, hk, num_q_tiles, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             float* dq, const int* work_kt, const int* meta,
             const int* run_ptr, int sq, int sk, int hq, int hk,
             int num_q_tiles, float scale, float softcap, void* stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dq, work_kt, meta,
                           run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                           softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dq, work_kt, meta,
                            run_ptr, sq, sk, hq, hk, num_q_tiles, scale,
                            softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/do [sq, hq, d], k/v [sk, hk, d] are contiguous rows of one dtype;
// lse/delta [sq, hq] and dq [sq, hq, d] float32. work_kt (W,), meta
// (W, 15) and run_ptr (num_q_tiles + 1,) are the plan's q-major int32
// arrays on the device, the forward's own.
extern "C" int ffa_bwd_dq_f32(const void* q, const void* k, const void* v,
                              const void* dout, const float* lse,
                              const float* delta, float* dq,
                              const int* work_kt, const int* meta,
                              const int* run_ptr, int sq, int sk, int hq,
                              int hk, int d, int num_q_tiles, float scale,
                              float softcap, void* stream) {
  return dispatch<float>(d, q, k, v, dout, lse, delta, dq, work_kt, meta,
                         run_ptr, sq, sk, hq, hk, num_q_tiles, scale, softcap,
                         stream);
}

extern "C" int ffa_bwd_dq_bf16(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, float* dq,
                               const int* work_kt, const int* meta,
                               const int* run_ptr, int sq, int sk, int hq,
                               int hk, int d, int num_q_tiles, float scale,
                               float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dq, work_kt,
                                 meta, run_ptr, sq, sk, hq, hk, num_q_tiles,
                                 scale, softcap, stream);
}
