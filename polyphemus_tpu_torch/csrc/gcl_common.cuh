// Shared by the GCL kernels: the bar geometry, the aux channel layout that
// `ops/kernels/gcl.py::build_kernel_aux` writes, the per-bar statics decoded
// from it, the element-type helpers, and a column-sum reduction for per-CTA
// partials.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace gcl {

// Loads and stores of an element type E through fp32, and `rnd`, the
// rounding of an fp32 value to E (the identity for fp32). Vector accesses
// take 4 consecutive elements (16-byte aligned for fp32, 8 for bf16).
template <typename E>
struct Elem;

template <>
struct Elem<float> {
  static constexpr bool kExact = true;
  __device__ __forceinline__ static float rnd(float v) { return v; }
  __device__ __forceinline__ static float load1(const float* p) { return *p; }
  __device__ __forceinline__ static float4 load4(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
  __device__ __forceinline__ static void store1(float* p, float v) { *p = v; }
  __device__ __forceinline__ static void store4(float* p, float4 v) {
    *reinterpret_cast<float4*>(p) = v;
  }
};

template <>
struct Elem<__nv_bfloat16> {
  using B = __nv_bfloat16;
  static constexpr bool kExact = false;
  __device__ __forceinline__ static float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  __device__ __forceinline__ static float load1(const B* p) {
    return __bfloat162float(*p);
  }
  __device__ __forceinline__ static float4 load4(const B* p) {
    const uint2 u = *reinterpret_cast<const uint2*>(p);
    const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
    const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
  __device__ __forceinline__ static void store1(B* p, float v) {
    *p = __float2bfloat16_rn(v);
  }
  __device__ __forceinline__ static void store4(B* p, float4 v) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
    uint2 u;
    u.x = *reinterpret_cast<const unsigned*>(&lo);
    u.y = *reinterpret_cast<const unsigned*>(&hi);
    *reinterpret_cast<uint2*>(p) = u;
  }
};

constexpr int T = 4;             // tracks per bar
constexpr int S = 32;            // steps per bar
constexpr int N = T * S;         // cells per bar
constexpr int NBLK = 8;          // packed weight blocks [W_t0..t3 | W0 | W_on | W_next | root]

enum {
  PREV_SRC, OK_P, DIST_P, NEXT_SRC, OK_N, DIST_N, PN_SRC, OK_PN, MSRC,
  DIST_PN, CNT_ON, CNT_NX, MASK_CH, SINGLE, N_AUX
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return v < 0 ? 0 : (v > hi ? hi : v);
}

// The parts of one bar's GCL math that do not depend on x: source cells and
// gate distances of the three gathered relations (with their validity as
// 0/1 floats), the masked mean reciprocals, the mask and the single-node
// flag. 7168 bytes, a multiple of 16.
struct Statics {
  float okp[N], okn[N], rtr[N], m[N], single[N], ron[N], rnx[N], okpn[N];
  int ps[N], ns[N], pn[N], dp[N], dn[N], dpn[N];
};

// Decode one bar's aux block a (N_AUX x N int32) into st; every thread of the
// CTA takes part, the caller synchronises.
__device__ __forceinline__ void load_statics(Statics& st, const int* a,
                                             int tid, int nthreads) {
  for (int i = tid; i < N; i += nthreads) {
    const float m = a[MASK_CH * N + i] > 0 ? 1.f : 0.f;
    const int okp = a[OK_P * N + i] > 0, okn = a[OK_N * N + i] > 0;
    const int cnt = okp + okn;
    const int con = a[CNT_ON * N + i], cnx = a[CNT_NX * N + i];
    const bool okpn = a[OK_PN * N + i] > 0;
    st.ps[i] = clampi(a[PREV_SRC * N + i], N - 1);
    st.ns[i] = clampi(a[NEXT_SRC * N + i], N - 1);
    st.pn[i] = clampi(a[PN_SRC * N + i], N - 1);
    st.dp[i] = clampi(a[DIST_P * N + i], S - 1);
    st.dn[i] = clampi(a[DIST_N * N + i], S - 1);
    st.dpn[i] = clampi(a[DIST_PN * N + i], S - 1);
    st.okp[i] = okp ? 1.f : 0.f;
    st.okn[i] = okn ? 1.f : 0.f;
    st.rtr[i] = cnt > 0 ? (1.f / (float)cnt) * m : 0.f;
    st.ron[i] = con > 0 ? (1.f / (float)con) * m : 0.f;
    st.rnx[i] = (okpn && cnx > 0) ? (1.f / (float)cnx) * m : 0.f;
    st.okpn[i] = (okpn && a[MSRC * N + i] > 0) ? 1.f : 0.f;
    st.m[i] = m;
    st.single[i] = (float)a[SINGLE * N + i];
  }
}

// out[c] = sum_r part[r * ncols + c] for r = 0..nrows-1, in order: the
// second pass over per-CTA partials (deterministic, unlike global atomics).
__global__ void sum_rows_kernel(const float* __restrict__ part,
                                float* __restrict__ out, int nrows,
                                long long ncols) {
  const long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= ncols) return;
  float acc = 0.f;
  for (int r = 0; r < nrows; ++r) acc += part[(long long)r * ncols + c];
  out[c] = acc;
}

inline cudaError_t sum_rows(const float* part, float* out, int nrows,
                            long long ncols, cudaStream_t stream) {
  const int threads = 256;
  const long long blocks = (ncols + threads - 1) / threads;
  sum_rows_kernel<<<(unsigned)blocks, threads, 0, stream>>>(part, out, nrows,
                                                             ncols);
  return cudaGetLastError();
}

}  // namespace gcl
