// GCL training backward, weight half, in fp32 or bf16, for bars of 4 x S
// cells at any S that is a multiple of 4 above 48 (resolutions 13 and up:
// 24, the Lakh Pianoroll Dataset's grid, is S = 96): dWbig (8d, n), fp32.
// Up to S = 48 the port launches `gcl_bwd_weight_grid.cu` (and at S = 32
// `gcl_bwd_weight.cu`) in fp32 and the fused backward in bf16, which stage
// whole bars (1760 bytes a cell in fp32: 676 KB at S = 96); above that this
// source walks each bar in tiles.
//
// Replaces, at those grids, the Pallas kernel `_bwd_weight_kernel` of
// polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py (kernel B of
// `gcl_backward_pallas`, its pallas_call at :564, called by the custom VJP
// `gcl_fused` in both dtypes, gcl_pallas.py:493-516), which takes the steps
// a bar as `n_steps` (:204-215). It computes what `gcl_bwd_weight_grid.cu`
// computes:
//
//   dW_r = sum over bars and rows of h_r[row, :]^T gm[row, :]
//
// for the eight packed blocks; the four track blocks contract only their
// own track's S rows of each bar, the other four all N = 4 S. g is (nbar,
// N, n) and dWbig (8d, n): the square weights (n = d), or the column form
// of tensor parallelism, n of the d output columns (n % 64 == 0), whose
// dWbig is those columns of the square launch's. The element type E of x, g
// and the gate table is a template parameter (`gcl_bwd_weight_long_launch`
// fp32, `gcl_bwd_weight_long_bf16_launch` bf16). In bf16 the rebuilt
// messages are rounded (`rnd`) where `_bwd_weight_kernel` casts to its
// compute dtype (:227, :250-271): each product x[src] g before its relu,
// the track sum and its product by the rounded reciprocal, each column sum
// and its difference and product; every A value is then a bf16 value, and
// the FFMAs on bf16 operands widened to fp32 compute what the Pallas body's
// bf16 dots with fp32 sums compute (a bf16 x bf16 product is exact in
// fp32).
//
// What bounds it on an H100: operations, 2 N 5d d flops a bar (1.01 GFLOP
// at S = 96, d = 512), fp32 FFMA on the CUDA cores.
//
// Design: `gcl_bwd_weight_grid.cu`'s ownership and sums (a CTA owns rows
// [c0, c0 + 32) of all 8 blocks x columns [j0, j0 + 64) and walks every bar
// with its 96 sums a thread in registers; each element of dWbig written
// once, bitwise repeatable), with each bar walked in tiles of 4 tracks x 32
// columns, row r = 32 t + cc cell (t, tc0 + cc), as in
// `gcl_eval_long_fp32.cu`:
// - The tile's statics are `gcl::TileStatics` (the source cells that each
//   row reads: itself, the previous and the next active cell of its track,
//   its track's cell in the previous active column). The CTA gathers those
//   four rows' 32 features of x for every row, and the row's 64 columns of
//   g (zero past the bar's last column), from device memory (L2) by
//   cp.async; the gate rows are read by distance from the gate table.
// - It rebuilds the tile's 5 A tiles as the grid kernel rebuilds a bar's,
//   the four cells of a column (whose sums the onset and next messages
//   take) lying in the tile; warps 0-3 then take the rows of tracks 0-1,
//   warps 4-7 those of tracks 2-3, up to the bar's last column.
// - One stage: the next tile's copies start after this tile's product.
#include "gcl_common.cuh"
#include "mma_bf16.cuh"  // cp.async helpers

namespace {

using namespace gcl;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_all;

constexpr int THREADS = 256;
constexpr int CT = 32;           // input features (rows of each block) a CTA
constexpr int JT = 64;           // output features (columns) a CTA
constexpr int NA = 5;            // A tiles: track, self, onset, next, root
constexpr int CW = 32;           // bar columns of a tile
constexpr int MT = T * CW;       // rows of a tile
constexpr int NSRC = 4;          // gathered rows a cell: self, prev, next, pn

template <typename E>
struct Smem : TileStatics<CW> {
  alignas(16) E xs[NSRC][MT][CT];      // x[src, c0:c0+CT] by source, row
  alignas(16) E g[MT][JT];             // g[row, j0:j0+JT]
  alignas(16) float a[NA][MT][CT];     // the A tiles [tile][row][feature]
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float4 mul(float4 a, float s) {
  return make_float4(a.x * s, a.y * s, a.z * s, a.w * s);
}

// 4 consecutive elements of E at p through the read-only data cache, as
// fp32
template <typename E>
__device__ __forceinline__ float4 ldg4(const E* p);

template <>
__device__ __forceinline__ float4 ldg4<float>(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

template <>
__device__ __forceinline__ float4 ldg4<__nv_bfloat16>(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = tc::bf2(u.x), hi = tc::bf2(u.y);
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// relu(rnd(a * b)) * s: a message through a relation, s its 0/1 validity
template <typename E>
__device__ __forceinline__ float4 msg(float4 a, float4 b, float s) {
  using R = Elem<E>;
  return make_float4(fmaxf(R::rnd(a.x * b.x), 0.f) * s,
                     fmaxf(R::rnd(a.y * b.y), 0.f) * s,
                     fmaxf(R::rnd(a.z * b.z), 0.f) * s,
                     fmaxf(R::rnd(a.w * b.w), 0.f) * s);
}

// rnd(rnd(rnd(v0 + v1 + v2 + v3) - v[t]) * s)
template <typename E>
__device__ __forceinline__ float4 others(const float4 (&v)[T], int t,
                                         float s) {
  using R = Elem<E>;
  return make_float4(
      R::rnd(R::rnd(R::rnd(v[0].x + v[1].x + v[2].x + v[3].x) - v[t].x) * s),
      R::rnd(R::rnd(R::rnd(v[0].y + v[1].y + v[2].y + v[3].y) - v[t].y) * s),
      R::rnd(R::rnd(R::rnd(v[0].z + v[1].z + v[2].z + v[3].z) - v[t].z) * s),
      R::rnd(R::rnd(R::rnd(v[0].w + v[1].w + v[2].w + v[3].w) - v[t].w) * s));
}

// The tile's gathered x rows and g rows by 16-byte copies (xb, gb at the
// bar's first cell; x rows d wide, g rows n wide); the g rows past the
// bar's last column are zeroed.
template <typename E>
__device__ __forceinline__ void load_tile(Smem<E>& sm, const E* xb,
                                          const E* gb, int S, int d, int n,
                                          int tc0, int c0, int j0, int tid) {
  constexpr int EPC = 16 / (int)sizeof(E);  // elements a 16-byte copy
  constexpr int QX = CT / EPC, QG = JT / EPC;  // 16-byte chunks a row
  for (int c = tid; c < NSRC * MT * QX; c += THREADS) {
    const int q = (c % QX) * EPC, r = (c / QX) % MT, src = c / (QX * MT);
    cp_async16(&sm.xs[src][r][q], xb + (size_t)sm.src[src][r] * d + c0 + q);
  }
  for (int c = tid; c < MT * QG; c += THREADS) {
    const int q = (c % QG) * EPC, r = c / QG;
    const int t = r / CW, col = tc0 + r % CW;
    if (col < S)
      cp_async16(&sm.g[r][q], gb + (size_t)(t * S + col) * n + j0 + q);
    else
      *reinterpret_cast<uint4*>(&sm.g[r][q]) = make_uint4(0u, 0u, 0u, 0u);
  }
}

// The tile's A tiles: thread (column cc, features q..q+3) rebuilds rows cc,
// CW + cc, 2 CW + cc and 3 CW + cc of every tile, as `gcl_fwd` computes
// them (in bf16 with the Pallas body's roundings); g rows by distance from
// the gate table (gates at feature c0).
template <typename E>
__device__ __forceinline__ void rebuild(Smem<E>& sm, const E* gates, int d,
                                        int tid) {
  using R = Elem<E>;
  for (int it = tid; it < CW * CT / 4; it += THREADS) {
    const int cc = it / (CT / 4), q = (it % (CT / 4)) * 4;
    auto gate = [&](int s) { return ldg4<E>(gates + (size_t)s * d + q); };
    const float4 g0 = gate(0);
    float4 xk[T], y[T], z[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int r = t * CW + cc;
      xk[t] = R::load4(&sm.xs[0][r][q]);
      y[t] = msg<E>(xk[t], g0, sm.m[r]);
      z[t] = msg<E>(R::load4(&sm.xs[3][r][q]), gate(sm.dpn[r]), sm.okpn[r]);
    }
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int r = t * CW + cc;
      const float4 vp =
          msg<E>(R::load4(&sm.xs[1][r][q]), gate(sm.dp[r]), sm.okp[r]);
      const float4 vn =
          msg<E>(R::load4(&sm.xs[2][r][q]), gate(sm.dn[r]), sm.okn[r]);
      const float rtr = sm.rtr[r];
      st4(&sm.a[0][r][q], make_float4(R::rnd(R::rnd(vp.x + vn.x) * rtr),
                                      R::rnd(R::rnd(vp.y + vn.y) * rtr),
                                      R::rnd(R::rnd(vp.z + vn.z) * rtr),
                                      R::rnd(R::rnd(vp.w + vn.w) * rtr)));
      st4(&sm.a[1][r][q], mul(y[t], sm.single[r]));     // self
      st4(&sm.a[2][r][q], others<E>(y, t, sm.ron[r]));  // onset
      st4(&sm.a[3][r][q], others<E>(z, t, sm.rnx[r]));  // next
      st4(&sm.a[4][r][q], mul(xk[t], sm.m[r]));         // root: x * m
    }
  }
}

// One tile into this thread's sums: rows of tracks 2h and 2h + 1, columns
// 0..ncol-1; tr[tb] is track block 2h + tb, full[i] block T + i. The
// thread's features are 2 cg, 2 cg + 1, its columns 4 jg..4 jg + 3 and 32 +
// 4 jg..32 + 4 jg + 3.
template <typename E>
__device__ __forceinline__ void tile_ffma(float (&tr)[2][2][8],
                                          float (&full)[4][2][8],
                                          const Smem<E>& sm, int h, int cg,
                                          int jg, int ncol) {
#pragma unroll
  for (int tb = 0; tb < 2; ++tb) {
    const int k0 = (2 * h + tb) * CW;
#pragma unroll 4
    for (int kk = 0; kk < ncol; ++kk) {
      const int k = k0 + kk;
      const float4 b0 = Elem<E>::load4(&sm.g[k][4 * jg]);
      const float4 b1 = Elem<E>::load4(&sm.g[k][JT / 2 + 4 * jg]);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      float2 av[NA];
#pragma unroll
      for (int i = 0; i < NA; ++i)
        av[i] = *reinterpret_cast<const float2*>(&sm.a[i][k][2 * cg]);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        tr[tb][0][jj] = fmaf(av[0].x, b[jj], tr[tb][0][jj]);
        tr[tb][1][jj] = fmaf(av[0].y, b[jj], tr[tb][1][jj]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          full[i][0][jj] = fmaf(av[1 + i].x, b[jj], full[i][0][jj]);
          full[i][1][jj] = fmaf(av[1 + i].y, b[jj], full[i][1][jj]);
        }
      }
    }
  }
}

// Sums v, two rows (features 2 cg, 2 cg + 1) x 8 columns, into a 32 x 64
// tile at p whose rows are `pitch` floats apart; add_tile adds such a tile
// of pitch JT to them.
__device__ __forceinline__ void put_tile(float* p, size_t pitch,
                                         const float (&v)[2][8], int cg,
                                         int jg) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float* row = p + (2 * cg + r) * pitch + 4 * jg;
    st4(row, make_float4(v[r][0], v[r][1], v[r][2], v[r][3]));
    st4(row + JT / 2, make_float4(v[r][4], v[r][5], v[r][6], v[r][7]));
  }
}

__device__ __forceinline__ void add_tile(float (&v)[2][8], const float* p,
                                         int cg, int jg) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float* row = p + (2 * cg + r) * JT + 4 * jg;
    const float4 lo = ld4(row), hi = ld4(row + JT / 2);
    const float w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) v[r][jj] += w[jj];
  }
}

template <typename E>
__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_weight_long_kernel(const E* __restrict__ x, const E* __restrict__ g,
                           const int* __restrict__ aux,
                           const E* __restrict__ gates,
                           float* __restrict__ dwbig, int nbar, int S,
                           int d, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<E>& sm = *reinterpret_cast<Smem<E>*>(smem_raw);
  const int N = T * S;
  const int j0 = blockIdx.x * JT, c0 = blockIdx.y * CT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int h = warp >> 2;                        // tracks 2h, 2h + 1
  const int cg = (warp & 3) * 4 + (lane >> 3);    // features 2 cg, 2 cg + 1
  const int jg = lane & 7;
  float tr[2][2][8], full[4][2][8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      tr[0][r][jj] = tr[1][r][jj] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) full[i][r][jj] = 0.f;
    }

  for (int bar = 0; bar < nbar; ++bar) {
    const E* xb = x + (size_t)bar * N * d;
    const E* gb = g + (size_t)bar * N * n;
    const int* ab = aux + (size_t)bar * N_AUX * N;
    for (int tc0 = 0; tc0 < S; tc0 += CW) {
      // no warp still reads the previous tile's statics, rows or A tiles
      __syncthreads();
      load_tile_statics<E, CW>(sm, ab, S, tc0, tid, THREADS);
      __syncthreads();
      load_tile(sm, xb, gb, S, d, n, tc0, c0, j0, tid);
      cp_async_commit();
      cp_async_wait_all();
      __syncthreads();
      rebuild(sm, gates + c0, d, tid);
      __syncthreads();
      tile_ffma(tr, full, sm, h, cg, jg, min(CW, S - tc0));
    }
  }

  // half 1 hands its full-block sums to half 0, which adds them to its own
  __syncthreads();
  float* red = &sm.a[0][0][0];
  if (h == 1) {
#pragma unroll
    for (int i = 0; i < 4; ++i) put_tile(red + i * CT * JT, JT, full[i], cg, jg);
  }
  __syncthreads();
  const size_t pitch = (size_t)n;
  float* out = dwbig + (size_t)c0 * n + j0;
  if (h == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      add_tile(full[i], red + i * CT * JT, cg, jg);
      put_tile(out + (size_t)(T + i) * d * n, pitch, full[i], cg, jg);
    }
  }
#pragma unroll
  for (int tb = 0; tb < 2; ++tb)
    put_tile(out + (size_t)(2 * h + tb) * d * n, pitch, tr[tb], cg, jg);
}

// The launch, the elements of x, g and gates of type E; see
// `gcl_bwd_weight_long_launch`.
template <typename E>
int launch(const void* x, const void* g, const void* aux, const void* gates,
           void* dwbig, int nbar, int S, int d, int n, cudaStream_t st) {
  static_assert(sizeof(Smem<E>) <= 232448, "a CTA's shared memory");
  static_assert(4 * CT * JT <= NA * MT * CT,
                "half 1's full-block sums fit in the A tiles");
  if (d <= 0 || d % JT != 0 || n <= 0 || n % JT != 0 || n > d || S < 4 ||
      S % 4 != 0 || nbar < 0 || (long long)gcl::N_AUX * T * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (nbar == 0)
    return (int)cudaMemsetAsync(dwbig, 0, sizeof(float) * NBLK * d * n, st);
  const int smem = (int)sizeof(Smem<E>);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_bwd_weight_long_kernel<E>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  gcl_bwd_weight_long_kernel<E><<<dim3(n / JT, d / CT), THREADS, smem, st>>>(
      (const E*)x, (const E*)g, (const int*)aux, (const E*)gates,
      (float*)dwbig, nbar, S, d, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a CTA of the kernel takes, fp32 and bf16.
extern "C" int gcl_bwd_weight_long_smem_bytes() {
  return (int)sizeof(Smem<float>);
}

extern "C" int gcl_bwd_weight_long_bf16_smem_bytes() {
  return (int)sizeof(Smem<__nv_bfloat16>);
}

// x (nbar, 4 S, d), g (nbar, 4 S, n); aux (nbar, N_AUX, 4 S); gates (S,
// d); fp32, all 16-byte aligned, d % 64 == 0, n % 64 == 0, n <= d (n = d:
// the square weights; n < d: a column shard); S a multiple of 4. Writes
// dwbig (8d, n).
extern "C" int gcl_bwd_weight_long_launch(const void* x, const void* g,
                                          const void* aux, const void* gates,
                                          void* dwbig, int nbar, int S, int d,
                                          int n, void* stream) {
  return launch<float>(x, g, aux, gates, dwbig, nbar, S, d, n,
                       (cudaStream_t)stream);
}

// The same with x, g and gates in bf16; dwbig (8d, n) fp32.
extern "C" int gcl_bwd_weight_long_bf16_launch(const void* x, const void* g,
                                               const void* aux,
                                               const void* gates, void* dwbig,
                                               int nbar, int S, int d, int n,
                                               void* stream) {
  return launch<__nv_bfloat16>(x, g, aux, gates, dwbig, nbar, S, d, n,
                               (cudaStream_t)stream);
}
