// FFA backward, dk and dv, over the host-built k-major work list, for
// Hopper (sm_90a).
//
// Replaces: magiattention_tpu/kernels/ffa.py:_bwd_dkv_kernel (wrapper
// _ffa_bwd_dkv_pallas, pallas_call at ffa.py:1432) and its GQA-packed twin
// _bwd_dkv_kernel_gqa (wrapper _ffa_bwd_dkv_pallas_gqa, pallas_call at
// ffa.py:1657). One kernel does both: it always loops the query group.
//
// What it computes: for every kv head and k row j, over the q rows i that
// some slice lets see j, and over the g = hq / hk query heads h of that kv
// head,
//   dv[j] = sum_h sum_i P[h, i, j] dO[h, i]
//   dk[j] = scale * sum_h sum_i dS[h, i, j] q[h, i]
// with P = exp(s - lse[i]) recomputed from the forward's natural-log lse,
// dS = P * (dP - delta[i]) (* dcap under a softcap), as in
// csrc/ffa_bwd_dq.cu. A k tile that no slice reaches, and every k row no
// live pair touches, gets exact zeros. Results are float32.
//
// Design. The TPU kernel's grid (hk, W, g) carries a k tile's dk/dv in
// VMEM scratch from its IS_FIRST item to its IS_LAST item, with the group
// innermost. Here ONE CTA owns one (k tile, kv head) and loops over that k
// tile's run of the k-major plan (work_qt_t, meta_t, run_ptr_t); inside
// each work item it loops the g query heads, so K and V are read once per
// CTA and stay in shared memory while Q and dO are read per head. dk and
// dv stay in registers for the whole run (each thread owns 4 k rows x D/16
// columns of each) and are written once per (k tile, kv head): the packed
// semantics of the GQA twin, with no atomics and no host reshape-sum, so
// the result is deterministic. CTAs take k tiles from the first to the
// last, so under a causal mask the longest runs start first.
//
// Per (item, head): each of the 256 threads computes a 4 x 4 block of
// S^T = K Q^T and of dP^T = V dO^T (k rows ty + 16 i, q cols tx + 16 j)
// with float32 FMAs, masks unless the item is IS_FULL, writes P^T and dS^T
// to shared memory, then accumulates dv += P^T dO and dk += dS^T Q. No
// finite MASK_VALUE: masked entries and rows with lse = -inf get P = 0.
//
// What bounds it on this card: operations. Work is 8 * D flops per live
// (row, col) pair and q head (S, dP, P^T dO, dS^T Q), on the CUDA cores in
// float32 (67 TFLOP/s peak on an H100 SXM); tensor cores and TMA are later
// work. Shared memory per CTA is 173 KB at D = 128 (K, V, Q, dO at stride
// D + 4, the P^T and dS^T tiles, the tile's lse and delta) and a thread
// holds 64 accumulators, so one CTA runs per SM.
#include "common.cuh"

namespace {

using magi::LOG2E;
using magi::META_DIM;

constexpr int BQ = 64;
constexpr int BK = 64;
constexpr int NT = 256;

template <int D>
struct DkvSmem {
  static constexpr int DS = D + 4;      // row stride of K, V, Q, dO
  static constexpr int PSTR = BQ + 16;  // row stride of the P^T, dS^T tiles
  static constexpr size_t bytes =
      sizeof(float) * (2 * BK * DS + 2 * BQ * DS + 2 * BK * PSTR + 2 * BQ);
};

__device__ __forceinline__ float dot4(const float4& a, const float4& b,
                                      float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(const float4& a, int e) {
  return e == 0 ? a.x : e == 1 ? a.y : e == 2 ? a.z : a.w;
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    ffa_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const T* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta,
                       float* __restrict__ dk, float* __restrict__ dv,
                       const int* __restrict__ work_qt_t,
                       const int* __restrict__ meta_t,
                       const int* __restrict__ run_ptr_t, int sq, int sk,
                       int hq, int hk, float scale, float softcap) {
  constexpr int DS = DkvSmem<D>::DS;
  constexpr int PSTR = DkvSmem<D>::PSTR;
  constexpr int CG = D / 64;  // float4 column groups a thread owns
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + BK * DS;
  float* Qs = Vs + BK * DS;
  float* dOs = Qs + BQ * DS;
  float* Ps = dOs + BQ * DS;    // P^T: k rows x q cols
  float* dSs = Ps + BK * PSTR;  // dS^T
  float* Ls = dSs + BK * PSTR;  // the q tile's lse (exp domain of p)
  float* Dls = Ls + BQ;         // the q tile's delta

  const int kt = blockIdx.x;
  const int hkv = blockIdx.y;
  const int g = hq / hk;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k0 = kt * BK;
  const long q_rs = (long)hq * D, kv_rs = (long)hk * D;
  const int k_valid = min(BK, sk - k0);

  magi::load_tile<T, D, NT>(Ks, k + ((long)k0 * hk + hkv) * D, kv_rs,
                            k_valid);
  magi::load_tile<T, D, NT>(Vs, v + ((long)k0 * hk + hkv) * D, kv_rs,
                            k_valid);

  const bool capped = softcap > 0.f;
  const float qk_scale = capped ? scale : scale * LOG2E;

  float dk_acc[4][4 * CG], dv_acc[4][4 * CG];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * CG; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int w_end = run_ptr_t[kt + 1];
  for (int w = run_ptr_t[kt]; w < w_end; ++w) {
    const magi::Item item(meta_t + (long)w * META_DIM);
    if (item.empty()) continue;  // dummy item of a tile no slice reaches
    const int q0 = work_qt_t[w] * BQ;
    const int q_valid = min(BQ, sq - q0);

    for (int gi = 0; gi < g; ++gi) {
      const int h = hkv * g + gi;
      __syncthreads();  // the previous head's products are done with smem
      magi::load_tile<T, D, NT>(Qs, q + ((long)q0 * hq + h) * D, q_rs,
                                q_valid);
      magi::load_tile<T, D, NT>(dOs, dout + ((long)q0 * hq + h) * D, q_rs,
                                q_valid);
      if (tid < BQ) {
        const int row = q0 + tid;
        const float l = row < sq ? lse[(long)row * hq + h] : -INFINITY;
        Ls[tid] = capped ? l : l * LOG2E;
        Dls[tid] = row < sq ? delta[(long)row * hq + h] : 0.f;
      }
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
          a[i] = *reinterpret_cast<const float4*>(Ks + (ty + 16 * i) * DS + dd);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] = *reinterpret_cast<const float4*>(Qs + (tx + 16 * j) * DS + dd);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = dot4(a[i], b[j], s[i][j]);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(Vs + (ty + 16 * i) * DS + dd);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          b[j] =
              *reinterpret_cast<const float4*>(dOs + (tx + 16 * j) * DS + dd);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dp[i][j] = dot4(a[i], b[j], dp[i][j]);
      }

#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;  // q row of the tile
          const float l = Ls[c];
          float x = s[i][j] * qk_scale, dcap = 1.f;
          if (capped) {
            const float t = tanhf(x / softcap);
            x = softcap * t;
            dcap = 1.f - t * t;
          }
          const bool live = l != -INFINITY &&
                            (item.full || item.live(q0 + c, k0 + ty + 16 * i));
          const float p = live ? (capped ? expf(x - l) : exp2f(x - l)) : 0.f;
          Ps[(ty + 16 * i) * PSTR + c] = p;
          dSs[(ty + 16 * i) * PSTR + c] = p * (dp[i][j] - Dls[c]) * dcap;
        }
      __syncthreads();  // P^T and dS^T are visible

#pragma unroll 2
      for (int qq = 0; qq < BQ; qq += 4) {
        float4 pv[4], dsv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] =
              *reinterpret_cast<const float4*>(Ps + (ty + 16 * i) * PSTR + qq);
          dsv[i] =
              *reinterpret_cast<const float4*>(dSs + (ty + 16 * i) * PSTR + qq);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
#pragma unroll
          for (int cg = 0; cg < CG; ++cg) {
            const float4 ov = *reinterpret_cast<const float4*>(
                dOs + (qq + e) * DS + cg * 64 + tx * 4);
            const float4 qv = *reinterpret_cast<const float4*>(
                Qs + (qq + e) * DS + cg * 64 + tx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float p = lane(pv[i], e), d = lane(dsv[i], e);
              dv_acc[i][cg * 4 + 0] = fmaf(p, ov.x, dv_acc[i][cg * 4 + 0]);
              dv_acc[i][cg * 4 + 1] = fmaf(p, ov.y, dv_acc[i][cg * 4 + 1]);
              dv_acc[i][cg * 4 + 2] = fmaf(p, ov.z, dv_acc[i][cg * 4 + 2]);
              dv_acc[i][cg * 4 + 3] = fmaf(p, ov.w, dv_acc[i][cg * 4 + 3]);
              dk_acc[i][cg * 4 + 0] = fmaf(d, qv.x, dk_acc[i][cg * 4 + 0]);
              dk_acc[i][cg * 4 + 1] = fmaf(d, qv.y, dk_acc[i][cg * 4 + 1]);
              dk_acc[i][cg * 4 + 2] = fmaf(d, qv.z, dk_acc[i][cg * 4 + 2]);
              dk_acc[i][cg * 4 + 3] = fmaf(d, qv.w, dk_acc[i][cg * 4 + 3]);
            }
          }
        }
      }
    }
  }

  // one write per (k tile, kv head); the scale folds into dk here
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = k0 + ty + 16 * i;
    if (row >= sk) continue;
    float* ok = dk + ((long)row * hk + hkv) * D;
    float* ov = dv + ((long)row * hk + hkv) * D;
#pragma unroll
    for (int cg = 0; cg < CG; ++cg) {
      const int c = cg * 4;
      *reinterpret_cast<float4*>(ok + cg * 64 + tx * 4) = make_float4(
          dk_acc[i][c] * scale, dk_acc[i][c + 1] * scale,
          dk_acc[i][c + 2] * scale, dk_acc[i][c + 3] * scale);
      *reinterpret_cast<float4*>(ov + cg * 64 + tx * 4) = make_float4(
          dv_acc[i][c], dv_acc[i][c + 1], dv_acc[i][c + 2], dv_acc[i][c + 3]);
    }
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const float* lse, const float* delta, float* dk, float* dv,
           const int* work_qt_t, const int* meta_t, const int* run_ptr_t,
           int sq, int sk, int hq, int hk, int num_k_tiles, float scale,
           float softcap, void* stream) {
  static bool smem_ok = false;
  const size_t smem = DkvSmem<D>::bytes;
  cudaError_t e = magi::allow_smem(ffa_bwd_dkv_kernel<T, D>, smem, &smem_ok);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(num_k_tiles, hk);
  ffa_bwd_dkv_kernel<T, D><<<grid, NT, smem, (cudaStream_t)stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout), lse, delta, dk,
      dv, work_qt_t, meta_t, run_ptr_t, sq, sk, hq, hk, scale, softcap);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int d, const void* q, const void* k, const void* v,
             const void* dout, const float* lse, const float* delta,
             float* dk, float* dv, const int* work_qt_t, const int* meta_t,
             const int* run_ptr_t, int sq, int sk, int hq, int hk,
             int num_k_tiles, float scale, float softcap, void* stream) {
  switch (d) {
    case 64:
      return launch<T, 64>(q, k, v, dout, lse, delta, dk, dv, work_qt_t,
                           meta_t, run_ptr_t, sq, sk, hq, hk, num_k_tiles,
                           scale, softcap, stream);
    case 128:
      return launch<T, 128>(q, k, v, dout, lse, delta, dk, dv, work_qt_t,
                            meta_t, run_ptr_t, sq, sk, hq, hk, num_k_tiles,
                            scale, softcap, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q/do [sq, hq, d], k/v [sk, hk, d] are contiguous rows of one dtype;
// lse/delta [sq, hq] float32; dk/dv [sk, hk, d] float32, every row written.
// work_qt_t (W_t,), meta_t (W_t, 15) and run_ptr_t (num_k_tiles + 1,) are
// the plan's k-major int32 arrays on the device.
extern "C" int ffa_bwd_dkv_f32(const void* q, const void* k, const void* v,
                               const void* dout, const float* lse,
                               const float* delta, float* dk, float* dv,
                               const int* work_qt_t, const int* meta_t,
                               const int* run_ptr_t, int sq, int sk, int hq,
                               int hk, int d, int num_k_tiles, float scale,
                               float softcap, void* stream) {
  return dispatch<float>(d, q, k, v, dout, lse, delta, dk, dv, work_qt_t,
                         meta_t, run_ptr_t, sq, sk, hq, hk, num_k_tiles,
                         scale, softcap, stream);
}

extern "C" int ffa_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                const void* dout, const float* lse,
                                const float* delta, float* dk, float* dv,
                                const int* work_qt_t, const int* meta_t,
                                const int* run_ptr_t, int sq, int sk, int hq,
                                int hk, int d, int num_k_tiles, float scale,
                                float softcap, void* stream) {
  return dispatch<__nv_bfloat16>(d, q, k, v, dout, lse, delta, dk, dv,
                                 work_qt_t, meta_t, run_ptr_t, sq, sk, hq, hk,
                                 num_k_tiles, scale, softcap, stream);
}
