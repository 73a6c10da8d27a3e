// One eval GCL layer, or one training-forward layer, in bf16, on the tensor
// cores, for bars of 4 x S cells at any S that is a multiple of 4 above 48
// (resolutions 13 and up: 24, the Lakh Pianoroll Dataset's grid, is S =
// 96). Up to S = 48 the port launches `gcl_eval_grid_bf16_tc.cu`, whose CTA
// owns whole bars; above that one bar no longer fits a CTA's shared memory,
// and this source takes the bar in tiles.
//
// Replaces, in bf16 and at those grids, the Pallas kernels `_kernel` (K =
// 1, polyphemus_tpu/ops/kernels/gcl_pallas.py:347) with its eval epilogue
// and without it (the forward of the custom VJP `gcl_fused`,
// gcl_pallas.py:466-467), and `_kernel_chain` (K >= 2, gcl_pallas.py:440),
// which read t, s and d from x's shape (`gcl_apply_pallas`,
// gcl_pallas.py:299-301). A chain is the same function as its layers one
// after the other: the wrapper (`ops/kernels/gcl.py::gcl_eval`) launches
// this kernel once a layer. Per bar of N = 4 S cells it computes what
// `gcl_eval_grid_bf16_tc.cu` computes, with the same roundings, cell by
// cell:
//
//   base = rnd(rnd([h_self | h_onset | h_next | x] @ [W0; W_on; W_next; root])
//              + bias)
//   v    = rnd(base + rnd(h_track @ W_t)) * m      (W_t: the row's own track)
//   out  = rnd(relu(rnd(rnd(v * ea) + eb) * m) + x)   (the eval form, EPI)
//   out  = v                                          (the training forward)
//
// The template flag EPI picks the form (`gcl_eval_long_bf16_launch`,
// `gcl_fwd_long_bf16_launch`), as in `gcl_eval_grid_bf16_tc.cu`; the
// training form reads neither ea, eb nor x's residual rows. The products
// take bf16 operands and sum in fp32 (mma.sync m16n8k16): only the
// summation order differs from the plain versions. Either form takes the
// column form of tensor parallelism: wbig (8d, n) holds n of the d output
// columns (n % 128 == 0: whole output tiles), bias, ea and eb their n
// entries, and the launch writes those n columns, the eval form's residual
// being x's columns c0 .. c0 + n - 1; the gathered source rows keep all d
// input features.
//
// What bounds it on an H100: operations, 2 N 5d d flops a bar and layer: a
// 512-bar layer at d = 512 needs 0.521 ms at S = 96 at 989 TFLOP/s of bf16
// tensor-core rate.
//
// Design. The grid kernel's CTA (8 warps, 128 x 128 output tiles, a warp
// 32 rows x 64 columns in two m16 tiles; the track product first, rounded
// and parked in shared memory, then the 4d-deep shared product; cp.async
// weight stages of 16 features, double-buffered; two CTAs an SM) is kept;
// what changes is which cells a CTA holds and where it reads their sources:
// - A CTA owns one tile of one bar: the 4 tracks x 32 columns of columns c0
//   .. c0 + 31 (the last tile of a bar holds S % 32 columns, the rows past
//   the bar computed and never stored). Row r = 32 t + cc is cell (t, c0 +
//   cc): a warp's two m16 tiles are 32 rows of one track, one weight block,
//   and the four cells of a column, whose sums the onset and next segments
//   take, lie in the tile.
// - It keeps the statics of its own 128 cells (`gcl::TileStatics`). The
//   rows a stage reads may lie anywhere in the bar: a track stage gathers
//   each cell's previous and next active cell of its track, a shared stage
//   the cell itself and its track's cell in the previous active column, 16
//   features a row, from device memory (L2) by cp.async while the stage
//   before multiplies, as the grid kernel stages its bars' x. The gate rows
//   are read by distance from the gate table (S x d, L1/L2-resident) with
//   __ldg.
// - No size depends on S: a bar of any length is ceil(S / 32) CTAs.
#include <stdint.h>

#include "gcl_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace tc;
using gcl::NBLK;
using gcl::T;

constexpr int THREADS = 256;     // 8 warps
constexpr int BN = 128;          // output columns per tile
constexpr int BK = 16;           // features per stage: one MMA k-step
constexpr int NSB = 4;           // weight blocks per stage (tracks, or shared)
constexpr int WROWS = NSB * BK;  // weight rows per stage
constexpr int NPARK = 32;        // parked bf16 pairs per thread
constexpr int CW = 32;           // bar columns of a tile
constexpr int MT = T * CW;       // rows of a tile

struct Smem : gcl::TileStatics<CW> {
  alignas(16) bf16 w[2][WROWS * BN];      // weight tiles [row][col], swizzled
  alignas(16) bf16 a[NSB][MT * BK];       // A chunk per segment [row][k], swizzled
  alignas(16) bf16 xs[2][MT * BK];        // two gathered source rows a cell
  alignas(16) uint32_t park[NPARK][THREADS];  // rounded track product
};

__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// Element offsets of 8-element chunk `ch` of row r. Weight tile: 16 chunks
// a row, chunk ch stored at ch ^ (r % 8). A chunk: 2 chunks a row, stored
// at ch ^ ((r / 4) % 2). An 8-row ldmatrix then touches 8 distinct
// 16-byte bank groups.
__device__ __forceinline__ int w_off(int r, int ch) {
  return r * BN + ((ch ^ (r & 7)) << 3);
}

__device__ __forceinline__ int a_off(int r, int ch) {
  return r * BK + ((ch ^ ((r >> 2) & 1)) << 3);
}

// Weight tile of one stage: row b * BK + kk is row f0 + kk of packed block
// blk0 + b (d rows of n columns each), columns n0 .. n0 + BN.
__device__ __forceinline__ void load_w(bf16* dst, const bf16* W, int d,
                                       int n, int blk0, int f0, int n0,
                                       int tid) {
#pragma unroll
  for (int j = 0; j < WROWS * BN / 8 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int r = c >> 4, ch = c & 15;
    const int blk = blk0 + r / BK, kk = r % BK;
    cp_async16(dst + w_off(r, ch),
               W + ((size_t)blk * d + f0 + kk) * n + n0 + ch * 8);
  }
}

// x[src, f0:f0+BK] of two source cells of every row of the tile (xb at the
// bar's first cell): sources s0 and s1 of `TileStatics::src`, into xs[0]
// and xs[1]; 16 bytes a thread and turn.
__device__ __forceinline__ void load_x(Smem& sm, const bf16* xb, int s0,
                                       int s1, int d, int f0, int tid) {
  for (int j = tid; j < 2 * MT * 2; j += THREADS) {
    const int h = j & 1, r = (j >> 1) % MT, k = (j >> 1) / MT;
    const int src = sm.src[k ? s1 : s0][r];
    cp_async16(sm.xs[k] + r * BK + h * 8, xb + (size_t)src * d + f0 + h * 8);
  }
}

__device__ __forceinline__ uint4 ldg16(const bf16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

// TRACK segment: rnd(rnd(vp + vn) * rtr), vp = relu(rnd(x[ps] * g[dp])) *
// okp and vn alike (xs[0] = x[ps], xs[1] = x[ns]; g = gates[:, f0:f0+BK]);
// thread tid builds features 8h..8h+7 of tile row tid / 2.
__device__ __forceinline__ void build_track(Smem& sm, const bf16* gates,
                                            int d, int f0, int tid) {
  const int row = tid >> 1, h = tid & 1;
  const uint4 xp = *reinterpret_cast<const uint4*>(sm.xs[0] + row * BK + h * 8);
  const uint4 xn = *reinterpret_cast<const uint4*>(sm.xs[1] + row * BK + h * 8);
  const bf16* g = gates + f0 + h * 8;
  const uint4 gp = ldg16(g + (size_t)sm.dp[row] * d);
  const uint4 gn = ldg16(g + (size_t)sm.dn[row] * d);
  const uint32_t uxp[4] = {xp.x, xp.y, xp.z, xp.w};
  const uint32_t ugp[4] = {gp.x, gp.y, gp.z, gp.w};
  const uint32_t uxn[4] = {xn.x, xn.y, xn.z, xn.w};
  const uint32_t ugn[4] = {gn.x, gn.y, gn.z, gn.w};
  const float okp = sm.okp[row], okn = sm.okn[row], rtr = sm.rtr[row];
  uint32_t o[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 a = bf2(uxp[e]), b = bf2(ugp[e]);
    const float2 c = bf2(uxn[e]), gg = bf2(ugn[e]);
    const float p0 = fmaxf(rnd(a.x * b.x), 0.f) * okp;
    const float p1 = fmaxf(rnd(a.y * b.y), 0.f) * okp;
    const float n0 = fmaxf(rnd(c.x * gg.x), 0.f) * okn;
    const float n1 = fmaxf(rnd(c.y * gg.y), 0.f) * okn;
    o[e] = pack2(rnd(p0 + n0) * rtr, rnd(p1 + n1) * rtr);
  }
  *reinterpret_cast<uint4*>(sm.a[0] + a_off(row, h)) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void load4(float (&v)[4], const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = bf2(u.x), hi = bf2(u.y);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void ldg4(float (&v)[4], const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 lo = bf2(u.x), hi = bf2(u.y);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}

// The shared segments of a stage: self, onset, next, root (A segments 0-3;
// xs[0] = x, xs[1] = x[pn]). Root: x itself, a row a thread. An item is
// features q0..q0+3 (q0 = 4 (tid % 4)) of column cc = (tid % 128) / 4 of
// the tile in all 4 tracks (rows r = 32 t + cc). Warps 0-3 take y0 =
// relu(rnd(x * g0)) * m -> self = y0 * single and onset = rnd(rnd(colsum(y0)
// - y0) * ron); warps 4-7 the NEXT-source messages z = relu(rnd(x[pn] *
// g[dpn])) * okpn -> next = rnd(rnd(colsum(z) - z) * rnx); colsum rounds
// the fp32 sum over the tracks, in track order.
__device__ __forceinline__ void build_shared(Smem& sm, const bf16* gates,
                                             int d, int f0, int tid) {
  {
    const int row = tid >> 1, h = tid & 1;
    *reinterpret_cast<uint4*>(sm.a[3] + a_off(row, h)) =
        *reinterpret_cast<const uint4*>(sm.xs[0] + row * BK + h * 8);
  }
  const int q0 = (tid & 3) * 4, ch = q0 >> 3, sub = q0 & 7;
  const int cc = (tid & (THREADS / 2 - 1)) >> 2;
  const bf16* g = gates + f0 + q0;
  float v[T][4], sum[4];
  if (tid < THREADS / 2) {
    float g0[4];
    ldg4(g0, g);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int r = t * CW + cc;
      float xv[4];
      load4(xv, sm.xs[0] + r * BK + q0);
      const float m = sm.m[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[t][e] = fmaxf(rnd(xv[e] * g0[e]), 0.f) * m;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] = rnd(v[0][e] + v[1][e] + v[2][e] + v[3][e]);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int r = t * CW + cc;
      const float single = sm.single[r], ron = sm.ron[r];
      float self[4], onset[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        self[e] = v[t][e] * single;
        onset[e] = rnd(rnd(sum[e] - v[t][e]) * ron);
      }
      store4(sm.a[0] + a_off(r, ch) + sub, self);
      store4(sm.a[1] + a_off(r, ch) + sub, onset);
    }
  } else {
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int r = t * CW + cc;
      float xv[4], gv[4];
      load4(xv, sm.xs[1] + r * BK + q0);
      ldg4(gv, g + (size_t)sm.dpn[r] * d);
      const float ok = sm.okpn[r];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[t][e] = fmaxf(rnd(xv[e] * gv[e]), 0.f) * ok;
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) sum[e] = rnd(v[0][e] + v[1][e] + v[2][e] + v[3][e]);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int r = t * CW + cc;
      const float rnx = sm.rnx[r];
      float nx[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) nx[e] = rnd(rnd(sum[e] - v[t][e]) * rnx);
      store4(sm.a[2] + a_off(r, ch) + sub, nx);
    }
  }
}

// acc += A rows row0..row0+31 (16 features of one segment, two m16 tiles)
// @ weight-tile rows wrow..wrow+15, columns col0..col0+63: 16 MMAs a warp.
__device__ __forceinline__ void mma_k16(float (&acc)[2][8][4], const bf16* a,
                                        const bf16* w, int wrow, int row0,
                                        int col0, int lane) {
  uint32_t af[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldsm_x4(af[mi], a + a_off(row0 + mi * 16 + (lane & 15), lane >> 4));
  const int r = wrow + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
    uint32_t b[4];
    ldsm_x4_t(b, w + w_off(r, ((col0 + jp * 16) >> 3) + (lane >> 4)));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      mma_bf16(acc[mi][2 * jp], af[mi], b[0], b[1]);
      mma_bf16(acc[mi][2 * jp + 1], af[mi], b[2], b[3]);
    }
  }
}

__device__ __forceinline__ void zero(float (&acc)[2][8][4]) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][nj][e] = 0.f;
}

// Accumulator element (mi, nj, e) of lane l sits at row row0 + 16 mi + l /
// 4 + 8 (e / 2), column col0 + 8 nj + 2 (l % 4) + e % 2; its bf16 pair (e =
// 0, 1 or 2, 3) is parked at park[16 mi + 2 nj + e / 2][tid].
__device__ __forceinline__ void park_track(Smem& sm, float (&acc)[2][8][4],
                                           int tid) {
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int nj = 0; nj < 8; ++nj)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        sm.park[mi * 16 + nj * 2 + hh][tid] =
            pack2(acc[mi][nj][2 * hh], acc[mi][nj][2 * hh + 1]);
}

// out = rnd(relu(rnd(rnd(v * ea) + eb) * m) + x) (EPI) or out = v, v =
// rnd(rnd(rnd(acc) + bias) + track) * m, for this thread's accumulators of
// output column tile n0; row[mi][hh] is the tile row of its rows in m16
// tile mi, half hh, cell [mi][hh] their cell in the bar (-1: past the bar,
// not stored); xb, ob at the bar's first cell (x rows d wide, out rows n),
// x's residual columns from oc0 on. Without EPI neither ea, eb nor the
// residual rows are read.
template <bool EPI>
__device__ __forceinline__ void epilogue(const Smem& sm,
                                         const float (&acc)[2][8][4],
                                         const bf16* xb, bf16* ob,
                                         const bf16* bias, const bf16* ea,
                                         const bf16* eb, int d, int n,
                                         int oc0, int n0,
                                         const int (&row)[2][2],
                                         const int (&cell)[2][2], int col0,
                                         int tid) {
  const int lane = tid & 31;
#pragma unroll
  for (int nj = 0; nj < 8; ++nj) {
    const int col = n0 + col0 + nj * 8 + 2 * (lane & 3);
    const float2 bb = bf2(*reinterpret_cast<const uint32_t*>(bias + col));
    if constexpr (!EPI) {
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int i = cell[mi][hh];
          if (i < 0) continue;
          const float m = sm.m[row[mi][hh]];
          const float2 tk = bf2(sm.park[mi * 16 + nj * 2 + hh][tid]);
          const float v0 = rnd(rnd(rnd(acc[mi][nj][2 * hh]) + bb.x) + tk.x) * m;
          const float v1 = rnd(rnd(rnd(acc[mi][nj][2 * hh + 1]) + bb.y) + tk.y) * m;
          *reinterpret_cast<uint32_t*>(ob + (size_t)i * n + col) = pack2(v0, v1);
        }
      continue;
    }
    const float2 aa = bf2(*reinterpret_cast<const uint32_t*>(ea + col));
    const float2 ee = bf2(*reinterpret_cast<const uint32_t*>(eb + col));
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int i = cell[mi][hh];
        if (i < 0) continue;
        const float m = sm.m[row[mi][hh]];
        const float2 tk = bf2(sm.park[mi * 16 + nj * 2 + hh][tid]);
        const float v0 = rnd(rnd(rnd(acc[mi][nj][2 * hh]) + bb.x) + tk.x) * m;
        const float v1 = rnd(rnd(rnd(acc[mi][nj][2 * hh + 1]) + bb.y) + tk.y) * m;
        const float2 xr = bf2(*reinterpret_cast<const uint32_t*>(
            xb + (size_t)i * d + oc0 + col));
        const float o0 = fmaxf(rnd(rnd(v0 * aa.x) + ee.x) * m, 0.f) + xr.x;
        const float o1 = fmaxf(rnd(rnd(v1 * aa.y) + ee.y) * m, 0.f) + xr.y;
        *reinterpret_cast<uint32_t*>(ob + (size_t)i * n + col) = pack2(o0, o1);
      }
  }
}

template <bool EPI>
__global__ void __launch_bounds__(THREADS, 2)
gcl_eval_long_bf16_tc_kernel(const bf16* x, const int* aux, const bf16* gates,
                             const bf16* W, const bf16* bias, const bf16* ea,
                             const bf16* eb, bf16* out, int S, int d, int n,
                             int oc0) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int ntile = (S + CW - 1) / CW, N = T * S;
  const int bar = blockIdx.x / ntile, c0 = (blockIdx.x % ntile) * CW;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = (warp & 1) * 64;   // the warp's 64 columns of each tile
  // and its 32 rows, all of track warp / 2: m16 tiles row0.. and row0 + 16..
  const int row0 = (warp >> 1) * 32, trow = (warp >> 1) * BK;
  int row[2][2], cell[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = row0 + mi * 16 + (lane >> 2) + hh * 8;
      const int c = c0 + r % CW;
      row[mi][hh] = r;
      cell[mi][hh] = c < S ? (r / CW) * S + c : -1;
    }

  gcl::load_tile_statics<bf16, CW>(sm, aux + (size_t)bar * gcl::N_AUX * N,
                                   S, c0, tid, THREADS);
  __syncthreads();

  // Stages: per output column tile (n / BN of them), nf stages of the track
  // product (weight blocks 0-3, sources prev and next) and then nf of the
  // shared product (blocks 4-7, sources self and pn).
  const int nf = d / BK;
  const int per_tile = 2 * nf;
  const int nstage = (n / BN) * per_tile;
  const bf16* xb = x + (size_t)bar * N * d;
  bf16* ob = out + (size_t)bar * N * n;

  auto fetch_w = [&](int s) {
    const int j = s % per_tile;
    load_w(sm.w[s & 1], W, d, n, j < nf ? 0 : T, (j % nf) * BK,
           s / per_tile * BN, tid);
  };
  auto fetch_x = [&](int s) {
    const int j = s % per_tile;
    if (j < nf)
      load_x(sm, xb, 1, 2, d, j * BK, tid);
    else
      load_x(sm, xb, 0, 3, d, (j - nf) * BK, tid);
  };

  fetch_w(0);
  fetch_x(0);
  cp_async_commit();
  float acc[2][8][4];
  for (int s = 0; s < nstage; ++s) {
    const int j = s % per_tile;
    const bool track = j < nf;
    if (j == 0) zero(acc);
    cp_async_wait_all();
    __syncthreads();  // stage s is in; every warp is done with stage s-1
    if (s + 1 < nstage) fetch_w(s + 1);
    if (track)
      build_track(sm, gates, d, j * BK, tid);
    else
      build_shared(sm, gates, d, (j - nf) * BK, tid);
    __syncthreads();  // the A chunk is built; xs is free
    if (s + 1 < nstage) fetch_x(s + 1);
    cp_async_commit();
    const bf16* wt = sm.w[s & 1];
    if (track) {
      mma_k16(acc, sm.a[0], wt, trow, row0, col0, lane);
      if (j == nf - 1) {
        park_track(sm, acc, tid);
        zero(acc);
      }
    } else {
#pragma unroll
      for (int seg = 0; seg < NSB; ++seg)
        mma_k16(acc, sm.a[seg], wt, seg * BK, row0, col0, lane);
      if (j == per_tile - 1)
        epilogue<EPI>(sm, acc, xb, ob, bias, ea, eb, d, n, oc0,
                      s / per_tile * BN, row, cell, col0, tid);
    }
  }
}

}  // namespace

// One layer of the kernel's EPI form over bars of 4 x S cells, every float
// tensor in bf16: x (nbar, 4 S, d), out (nbar, 4 S, n), gates (S, d), wbig
// (8d, n), bias, ea, eb (n,) (without EPI ea and eb are not read); aux
// (nbar, 14, 4 S) int32. S % 4 == 0, S > 0; d % 128 == 0 and n % 128 == 0
// with c0 + n <= d, c0 the first output column (x's residual columns);
// without EPI c0 = 0. The CTAs (nbar ceil(S / 32)) and every cell, feature
// and aux index within int32.
template <bool EPI>
static int launch(const void* x, const void* aux, const void* gates,
                  const void* wbig, const void* bias, const void* ea,
                  const void* eb, void* out, int nbar, int S, int d, int n,
                  int c0, void* stream) {
  if (nbar <= 0) return 0;
  const long long ctas = (long long)nbar * ((S + CW - 1) / CW);
  if (S < 4 || S % 4 != 0 || d <= 0 || d % BN != 0 || n <= 0 ||
      n % BN != 0 || c0 < 0 || c0 % 2 != 0 || c0 + n > d ||
      (!EPI && c0 != 0) ||
      ctas > 0x7fffffffLL || (long long)S * d > 0x7fffffffLL ||
      (long long)gcl::N_AUX * T * S > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_eval_long_bf16_tc_kernel<EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gcl_eval_long_bf16_tc_kernel<EPI>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return (int)err;
  gcl_eval_long_bf16_tc_kernel<EPI><<<(unsigned)ctas, THREADS, smem,
                                      (cudaStream_t)stream>>>(
      (const bf16*)x, (const int*)aux, (const bf16*)gates, (const bf16*)wbig,
      (const bf16*)bias, (const bf16*)ea, (const bf16*)eb, (bf16*)out, S, d,
      n, c0);
  return (int)cudaGetLastError();
}

// One eval layer (folded batch-norm, relu, residual): output columns c0 ..
// c0 + n - 1 of the layer; see `launch`.
extern "C" int gcl_eval_long_bf16_launch(const void* x, const void* aux,
                                         const void* gates, const void* wbig,
                                         const void* bias, const void* ea,
                                         const void* eb, void* out, int nbar,
                                         int S, int d, int n, int c0,
                                         void* stream) {
  return launch<true>(x, aux, gates, wbig, bias, ea, eb, out, nbar, S, d, n,
                      c0, stream);
}

// One training-forward layer, out = v (the bf16 rounding of (gcl(x) +
// bias) * m above): wbig (8d, n), bias (n,), out (nbar, 4 S, n); see
// `launch`.
extern "C" int gcl_fwd_long_bf16_launch(const void* x, const void* aux,
                                        const void* gates, const void* wbig,
                                        const void* bias, void* out, int nbar,
                                        int S, int d, int n, void* stream) {
  return launch<false>(x, aux, gates, wbig, bias, nullptr, nullptr, out,
                       nbar, S, d, n, 0, stream);
}

// Dynamic shared memory a CTA takes, in either form.
extern "C" int gcl_eval_long_bf16_smem_bytes() { return (int)sizeof(Smem); }
