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

// The statics of cell i of one bar's aux block a, decoded as load_statics
// decodes them, for a kernel that needs some cells only. (load_statics keeps
// its own text: built on this, its kernels compile to other code.)
struct CellStatics {
  float okp, okn, rtr, m, single, ron, rnx, okpn;
  int ps, ns, pn, dp, dn, dpn;
};

__device__ __forceinline__ CellStatics cell_statics(const int* a, int i) {
  CellStatics c;
  const float m = a[MASK_CH * N + i] > 0 ? 1.f : 0.f;
  const int okp = a[OK_P * N + i] > 0, okn = a[OK_N * N + i] > 0;
  const int cnt = okp + okn;
  const int con = a[CNT_ON * N + i], cnx = a[CNT_NX * N + i];
  const bool okpn = a[OK_PN * N + i] > 0;
  c.ps = clampi(a[PREV_SRC * N + i], N - 1);
  c.ns = clampi(a[NEXT_SRC * N + i], N - 1);
  c.pn = clampi(a[PN_SRC * N + i], N - 1);
  c.dp = clampi(a[DIST_P * N + i], S - 1);
  c.dn = clampi(a[DIST_N * N + i], S - 1);
  c.dpn = clampi(a[DIST_PN * N + i], S - 1);
  c.okp = okp ? 1.f : 0.f;
  c.okn = okn ? 1.f : 0.f;
  c.rtr = cnt > 0 ? (1.f / (float)cnt) * m : 0.f;
  c.ron = con > 0 ? (1.f / (float)con) * m : 0.f;
  c.rnx = (okpn && cnx > 0) ? (1.f / (float)cnx) * m : 0.f;
  c.okpn = (okpn && a[MSRC * N + i] > 0) ? 1.f : 0.f;
  c.m = m;
  c.single = (float)a[SINGLE * N + i];
  return c;
}

// cell_statics for one bar of n = T * s cells, s chosen by the caller (the
// training kernels of the `*_grid*.cu` sources).
__device__ __forceinline__ CellStatics cell_statics_grid(const int* a, int i,
                                                         int n, int s) {
  CellStatics c;
  const float m = a[MASK_CH * n + i] > 0 ? 1.f : 0.f;
  const int okp = a[OK_P * n + i] > 0, okn = a[OK_N * n + i] > 0;
  const int cnt = okp + okn;
  const int con = a[CNT_ON * n + i], cnx = a[CNT_NX * n + i];
  const bool okpn = a[OK_PN * n + i] > 0;
  c.ps = clampi(a[PREV_SRC * n + i], n - 1);
  c.ns = clampi(a[NEXT_SRC * n + i], n - 1);
  c.pn = clampi(a[PN_SRC * n + i], n - 1);
  c.dp = clampi(a[DIST_P * n + i], s - 1);
  c.dn = clampi(a[DIST_N * n + i], s - 1);
  c.dpn = clampi(a[DIST_PN * n + i], s - 1);
  c.okp = okp ? 1.f : 0.f;
  c.okn = okn ? 1.f : 0.f;
  c.rtr = cnt > 0 ? (1.f / (float)cnt) * m : 0.f;
  c.ron = con > 0 ? (1.f / (float)con) * m : 0.f;
  c.rnx = (okpn && cnx > 0) ? (1.f / (float)cnx) * m : 0.f;
  c.okpn = (okpn && a[MSRC * n + i] > 0) ? 1.f : 0.f;
  c.m = m;
  c.single = (float)a[SINGLE * n + i];
  return c;
}

// The steps a bar of the grid training kernels, S = 4 r for resolutions r
// = 1..12 but 8 (S = 32 has kernels of its own): X(S) for each, for the
// launchers' switch over their template instantiations.
#define GCL_GRID_STEPS(X) \
  X(4) X(8) X(12) X(16) X(20) X(24) X(28) X(36) X(40) X(44) X(48)

// The statics of up to C cells of consecutive bars of n = T * s cells, s
// chosen at run time (the eval kernels of `gcl_eval_grid_*.cu`), by local
// cell b * n + i of bar b; the source cells are local too.
template <int C>
struct GridStatics {
  float okp[C], okn[C], rtr[C], m[C], single[C], ron[C], rnx[C], okpn[C];
  int ps[C], ns[C], pn[C], dp[C], dn[C], dpn[C];
};

// Decode the aux blocks (N_AUX x n int32 a bar) of nb bars into st as
// load_statics decodes one bar, with the reciprocals rounded to E (a no-op
// for fp32); every thread of the CTA takes part, the caller synchronises.
template <typename E, int C>
__device__ __forceinline__ void load_grid_statics(GridStatics<C>& st,
                                                  const int* aux, int nb,
                                                  int s, int tid,
                                                  int nthreads) {
  const int n = T * s;
  for (int c = tid; c < nb * n; c += nthreads) {
    const int b = c / n, i = c - b * n, base = b * n;
    const int* a = aux + (size_t)b * N_AUX * n;
    const float m = a[MASK_CH * n + i] > 0 ? 1.f : 0.f;
    const int okp = a[OK_P * n + i] > 0, okn = a[OK_N * n + i] > 0;
    const int cnt = okp + okn;
    const int con = a[CNT_ON * n + i], cnx = a[CNT_NX * n + i];
    const bool okpn = a[OK_PN * n + i] > 0;
    st.ps[c] = base + clampi(a[PREV_SRC * n + i], n - 1);
    st.ns[c] = base + clampi(a[NEXT_SRC * n + i], n - 1);
    st.pn[c] = base + clampi(a[PN_SRC * n + i], n - 1);
    st.dp[c] = clampi(a[DIST_P * n + i], s - 1);
    st.dn[c] = clampi(a[DIST_N * n + i], s - 1);
    st.dpn[c] = clampi(a[DIST_PN * n + i], s - 1);
    st.okp[c] = okp ? 1.f : 0.f;
    st.okn[c] = okn ? 1.f : 0.f;
    st.rtr[c] = Elem<E>::rnd(cnt > 0 ? (1.f / (float)cnt) * m : 0.f);
    st.ron[c] = Elem<E>::rnd(con > 0 ? (1.f / (float)con) * m : 0.f);
    st.rnx[c] =
        Elem<E>::rnd((okpn && cnx > 0) ? (1.f / (float)cnx) * m : 0.f);
    st.okpn[c] = (okpn && a[MSRC * n + i] > 0) ? 1.f : 0.f;
    st.m[c] = m;
    st.single[c] = (float)a[SINGLE * n + i];
  }
}

// The statics of one tile of the long-bar eval kernels
// (`gcl_eval_long_*.cu`): the T x CW cells of columns c0 .. c0 + CW - 1 of
// one bar of n = T s cells, row r = t CW + cc for cell (t, c0 + cc); src[0
// .. 3] are the bar's cells that row r reads (itself, the previous and the
// next active cell of its track, its track's cell in the previous active
// column), dp, dn, dpn their gate distances. A row past the bar's last
// column (c0 + cc >= s) has every value 0.
template <int CW>
struct TileStatics {
  float okp[T * CW], okn[T * CW], rtr[T * CW], m[T * CW], single[T * CW],
      ron[T * CW], rnx[T * CW], okpn[T * CW];
  int src[4][T * CW], dp[T * CW], dn[T * CW], dpn[T * CW];
};

// Decode the tile's statics from one bar's aux block a (N_AUX x n int32),
// as cell_statics_grid decodes a cell, with the reciprocals rounded to E (a
// no-op for fp32); every thread of the CTA takes part, the caller
// synchronises.
template <typename E, int CW>
__device__ __forceinline__ void load_tile_statics(TileStatics<CW>& st,
                                                  const int* a, int s,
                                                  int c0, int tid,
                                                  int nthreads) {
  for (int r = tid; r < T * CW; r += nthreads) {
    const int t = r / CW, c = c0 + r % CW;
    CellStatics cs{};
    int self = 0;
    if (c < s) {
      self = t * s + c;
      cs = cell_statics_grid(a, self, T * s, s);
    }
    st.okp[r] = cs.okp;
    st.okn[r] = cs.okn;
    st.rtr[r] = Elem<E>::rnd(cs.rtr);
    st.m[r] = cs.m;
    st.single[r] = cs.single;
    st.ron[r] = Elem<E>::rnd(cs.ron);
    st.rnx[r] = Elem<E>::rnd(cs.rnx);
    st.okpn[r] = cs.okpn;
    st.src[0][r] = self;
    st.src[1][r] = cs.ps;
    st.src[2][r] = cs.ns;
    st.src[3][r] = cs.pn;
    st.dp[r] = cs.dp;
    st.dn[r] = cs.dn;
    st.dpn[r] = cs.dpn;
  }
}

// The bar grid of the `gcl_eval_grid_*.cu` kernels: S steps, N = T S cells
// a bar; in a CTA's padded rows a track takes SP rows (S rounded up to the
// kernel's row group), a bar BP = T SP; the CTA holds nb bars, M = nb BP
// padded rows. The row tile t0 .. t0 + mt - 1 touches bars blo .. bhi - 1.
struct Grid {
  int S, N, SP, BP, nb, M, blo, bhi;
  __device__ __forceinline__ Grid(int s, int rpad, int nbars)
      : S(s), N(T * s), SP((s + rpad - 1) / rpad * rpad), BP(T * SP),
        nb(nbars), M(nbars * BP), blo(0), bhi(0) {}
  __device__ __forceinline__ void tile(int t0, int mt) {
    blo = t0 / BP;
    bhi = min(nb, (t0 + mt + BP - 1) / BP);
  }
};

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
