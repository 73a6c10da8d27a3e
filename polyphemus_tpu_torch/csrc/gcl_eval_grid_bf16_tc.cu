// GCL layers in bf16, on the tensor cores, for bars of 4 x S cells at any
// S that is a multiple of 4 up to 48 (resolutions 1-12): K chained eval
// layers, or one training-forward layer. At S = 32 the port launches
// `gcl_eval_bf16_tc.cu`, whose CTA is one 128-cell bar; this source takes
// the other grids.
//
// Replaces, in bf16 and at those grids, the Pallas kernels `_kernel_chain`
// (K >= 2, polyphemus_tpu/ops/kernels/gcl_pallas.py:440) and `_kernel` (K =
// 1, gcl_pallas.py:347) with its eval epilogue and without it (the forward
// of the training layer `gcl_fused`, gcl_pallas.py:467-529), which read t,
// s and d from x's shape (`gcl_apply_pallas`, gcl_pallas.py:299-301). Per
// layer and bar of N = 4 S cells it computes what `gcl_eval_bf16_tc.cu`
// computes, with the same roundings, cell by cell:
//
//   base = rnd(rnd([h_self | h_onset | h_next | x] @ [W0; W_on; W_next; root])
//              + bias)
//   v    = rnd(base + rnd(h_track @ W_t)) * m      (W_t: the row's own track)
//   out  = rnd(relu(rnd(rnd(v * ea) + eb) * m) + x)   (the eval form, EPI)
//   out  = v                                          (the training forward)
//
// with the column-shard form (n of d output columns, K = 1) as there. The
// template flag EPI picks the form (`gcl_eval_grid_bf16_launch`,
// `gcl_fwd_grid_bf16_launch`), as in `gcl_eval_bf16_tc.cu`. The
// products take bf16 operands and sum in fp32 (mma.sync m16n8k16): only the
// summation order differs from the plain versions.
//
// What bounds it on an H100: operations, 2 N 5d d flops a bar and layer:
// a 512-bar launch at K = 2, d = 512 needs 0.174 ms at S = 16 and 0.521 ms
// at S = 48 at 989 TFLOP/s of bf16 tensor-core rate.
//
// Design. The S = 32 kernel's CTA (8 warps, 128 x 128 output tiles, a warp
// 32 rows x 64 columns in two m16 tiles; the track product first, rounded
// and parked in shared memory, then the 4d-deep shared product; cp.async
// weight stages of 16 features, double-buffered; two CTAs an SM) is kept;
// what changes is which rows a tile holds:
// - A CTA owns `bpc` whole bars (chosen by the launcher, at most 256 cells),
//   so chained layers still meet only at a __syncthreads(), and walks them in
//   row tiles of 128. Each track of a bar takes SP = S rounded up to 16 rows,
//   so an m16 tile lies in one track and multiplies one track block. Where
//   SP = 16 a warp takes m16 tiles i and i + 4 of a row tile, which lie in
//   one track, else 2i and 2i + 1 (a warp whose two m16 tiles lie in two
//   tracks reads two B fragments in the track product). Padding rows are
//   zero in the track and root segments and are never stored. At S = 16 a
//   tile is two bars; at S = 12 a bar is 64 rows, 48 of them cells; at S =
//   48 a bar is a tile and a half.
// - The launcher picks bpc to minimise the waves of CTAs (two an SM) times
//   the tiles a CTA walks, then the tiles in all.
// - The statics and each stage's x chunk are kept for every cell of the bars
//   that the tile touches. The track and root segments are built a row a
//   thread; the self, onset and next segments by (bar, column, 4 features)
//   items over those bars, at most two a thread, decoded once a tile
//   (`shared_items`), writing the cells that lie in the tile, with the S =
//   32 kernel's arithmetic.
#include <stdint.h>

#include "gcl_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace tc;
using gcl::Grid;
using gcl::GridStatics;
using gcl::NBLK;
using gcl::T;

constexpr int THREADS = 256;     // 8 warps
constexpr int BN = 128;          // output columns per tile
constexpr int BK = 16;           // features per stage: one MMA k-step
constexpr int NSB = 4;           // weight blocks per stage (tracks, or shared)
constexpr int WROWS = NSB * BK;  // weight rows per stage
constexpr int NPARK = 32;        // parked bf16 pairs per thread
constexpr int MT = 128;          // rows of a tile
constexpr int MAXC = 256;        // cells of a CTA's bars
constexpr int MAXS = 48;         // steps a bar
constexpr int RPAD = 16;         // a track's rows are padded to this multiple

struct Smem : GridStatics<MAXC> {
  alignas(16) bf16 w[2][WROWS * BN];      // weight tiles [row][col], swizzled
  alignas(16) bf16 a[NSB][MT * BK];       // A chunk per segment [row][k], swizzled
  alignas(16) bf16 xs[MAXC * BK];         // x[:, f0:f0+BK] by local cell
  alignas(16) bf16 gs[MAXS * BK];         // gate_table[:, f0:f0+BK]
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

// The local cell of padded row p of the CTA, or -1 for a padding row
__device__ __forceinline__ int cell_of(const Grid& gd, int p) {
  if (p >= gd.M) return -1;
  const int b = p / gd.BP, r = p - b * gd.BP, t = r / gd.SP, w = r - t * gd.SP;
  return w < gd.S ? b * gd.N + t * gd.S + w : -1;
}

// Weight tile of one stage: row b * BK + kk is row f0 + kk of packed block
// blk0 + b (rows n wide), columns n0 .. n0 + BN.
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

// x[:, f0:f0+BK] of the cells of bars blo..bhi-1 (xin at the CTA's first
// cell) and gate_table[:, f0:f0+BK], 16 bytes a thread and turn
__device__ __forceinline__ void load_x(Smem& sm, const bf16* xin,
                                       const bf16* gates, int S, int N,
                                       int blo, int bhi, int d, int f0,
                                       int tid) {
  const int c0 = blo * N, nchunk = 2 * (bhi - blo) * N;
  for (int j = tid; j < nchunk; j += THREADS) {
    const int c = c0 + (j >> 1), h = j & 1;
    cp_async16(sm.xs + c * BK + h * 8, xin + (size_t)c * d + f0 + h * 8);
  }
  if (tid < 2 * S) {
    const int i = tid >> 1, h = tid & 1;
    cp_async16(sm.gs + i * BK + h * 8, gates + (size_t)i * d + f0 + h * 8);
  }
}

// TRACK segment: rnd(rnd(vp + vn) * rtr), vp = relu(rnd(x[ps] * g[dp])) *
// okp and vn alike; thread tid builds features 8h..8h+7 of tile row tid / 2
// (cell i, or zeros for a padding row).
__device__ __forceinline__ void build_track(Smem& sm, int i, int tid) {
  const int row = tid >> 1, h = tid & 1;
  uint32_t o[4] = {0u, 0u, 0u, 0u};
  if (i >= 0) {
    const uint4 xp = *reinterpret_cast<const uint4*>(sm.xs + sm.ps[i] * BK + h * 8);
    const uint4 gp = *reinterpret_cast<const uint4*>(sm.gs + sm.dp[i] * BK + h * 8);
    const uint4 xn = *reinterpret_cast<const uint4*>(sm.xs + sm.ns[i] * BK + h * 8);
    const uint4 gn = *reinterpret_cast<const uint4*>(sm.gs + sm.dn[i] * BK + h * 8);
    const uint32_t uxp[4] = {xp.x, xp.y, xp.z, xp.w};
    const uint32_t ugp[4] = {gp.x, gp.y, gp.z, gp.w};
    const uint32_t uxn[4] = {xn.x, xn.y, xn.z, xn.w};
    const uint32_t ugn[4] = {gn.x, gn.y, gn.z, gn.w};
    const float okp = sm.okp[i], okn = sm.okn[i], rtr = sm.rtr[i];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float2 a = bf2(uxp[e]), b = bf2(ugp[e]);
      const float2 c = bf2(uxn[e]), g = bf2(ugn[e]);
      const float p0 = fmaxf(rnd(a.x * b.x), 0.f) * okp;
      const float p1 = fmaxf(rnd(a.y * b.y), 0.f) * okp;
      const float n0 = fmaxf(rnd(c.x * g.x), 0.f) * okn;
      const float n1 = fmaxf(rnd(c.y * g.y), 0.f) * okn;
      o[e] = pack2(rnd(p0 + n0) * rtr, rnd(p1 + n1) * rtr);
    }
  }
  *reinterpret_cast<uint4*>(sm.a[0] + a_off(row, h)) =
      make_uint4(o[0], o[1], o[2], o[3]);
}

__device__ __forceinline__ void load4(float (&v)[4], const bf16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  const float2 lo = bf2(u.x), hi = bf2(u.y);
  v[0] = lo.x; v[1] = lo.y; v[2] = hi.x; v[3] = hi.y;
}

__device__ __forceinline__ void store4(bf16* p, const float (&v)[4]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
}

// The items of the shared segments' build that thread tid takes in the
// tile at padded row t0 (at most two: a tile touches at most MAXC cells):
// item k is features q0..q0+3 (q0 = 4 (tid % 4)) of column c of bar b
// (blo <= b < bhi) in all 4 tracks, item number tid % 128 + 128 k. Packed
// as base | mask << 9 | (rbase + 512) << 16: base = b N + c its track-0
// cell, rbase = b BP + c - t0 its track-0 row in the tile, and mask has bit
// t set where track t's row lies in the tile (0: no item, or nothing to
// write).
__device__ __forceinline__ void shared_items(const Grid& gd, int t0, int tid,
                                             int (&item)[2]) {
  const int nitems = (gd.bhi - gd.blo) * gd.S * 4;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int it = (tid & (THREADS / 2 - 1)) + k * (THREADS / 2);
    item[k] = 0;
    if (it >= nitems) continue;
    const int col = it >> 2, bq = col / gd.S, c = col - bq * gd.S;
    const int b = gd.blo + bq, rbase = b * gd.BP + c - t0;
    int mask = 0;
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int r = rbase + t * gd.SP;
      if (r >= 0 && r < MT) mask |= 1 << t;
    }
    item[k] = (b * gd.N + c) | (mask << 9) | ((rbase + 512) << 16);
  }
}

// The shared segments of a tile: self, onset, next, root (A segments 0-3).
// Root: x itself, a row a thread (i: its cell, or -1 for zeros). Warps 0-3
// take y0 = relu(rnd(x * g0)) * m -> self = y0 * single and onset =
// rnd(rnd(colsum(y0) - y0) * ron); warps 4-7 the NEXT-source messages z =
// relu(rnd(x[pn] * g[dpn])) * okpn -> next = rnd(rnd(colsum(z) - z) * rnx),
// for the thread's items (`shared_items`); colsum rounds the fp32 sum over
// the tracks, in track order. Only the cells that lie in the tile are
// written.
__device__ __forceinline__ void build_shared(Smem& sm, const Grid& gd,
                                             const int (&item)[2], int i,
                                             int tid) {
  {
    const int row = tid >> 1, h = tid & 1;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (i >= 0) v = *reinterpret_cast<const uint4*>(sm.xs + i * BK + h * 8);
    *reinterpret_cast<uint4*>(sm.a[3] + a_off(row, h)) = v;
  }
  const int q0 = (tid & 3) * 4, ch = q0 >> 3, sub = q0 & 7;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int mask = (item[k] >> 9) & 15;
    if (mask == 0) continue;
    const int base = item[k] & 511, rbase = (item[k] >> 16) - 512;
    float v[T][4], sum[4];
    if (tid < THREADS / 2) {
      float g0[4];
      load4(g0, sm.gs + q0);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int j = base + t * gd.S;
        float xv[4];
        load4(xv, sm.xs + j * BK + q0);
        const float m = sm.m[j];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[t][e] = fmaxf(rnd(xv[e] * g0[e]), 0.f) * m;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] = rnd(v[0][e] + v[1][e] + v[2][e] + v[3][e]);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int j = base + t * gd.S, r = rbase + t * gd.SP;
        if (!((mask >> t) & 1)) continue;
        const float single = sm.single[j], ron = sm.ron[j];
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
        const int j = base + t * gd.S;
        float xv[4], gv[4];
        load4(xv, sm.xs + sm.pn[j] * BK + q0);
        load4(gv, sm.gs + sm.dpn[j] * BK + q0);
        const float ok = sm.okpn[j];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[t][e] = fmaxf(rnd(xv[e] * gv[e]), 0.f) * ok;
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) sum[e] = rnd(v[0][e] + v[1][e] + v[2][e] + v[3][e]);
#pragma unroll
      for (int t = 0; t < T; ++t) {
        const int j = base + t * gd.S, r = rbase + t * gd.SP;
        if (!((mask >> t) & 1)) continue;
        const float rnx = sm.rnx[j];
        float nx[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) nx[e] = rnd(rnd(sum[e] - v[t][e]) * rnx);
        store4(sm.a[2] + a_off(r, ch) + sub, nx);
      }
    }
  }
}

// acc += A rows row0..row0+15 and row0+rstep..+15 (16 features of one
// segment) @ weight-tile rows wrow..wrow+15, columns col0..col0+63: 16 MMAs
// a warp.
__device__ __forceinline__ void mma_k16(float (&acc)[2][8][4], const bf16* a,
                                        const bf16* w, int wrow, int row0,
                                        int rstep, int col0, int lane) {
  uint32_t af[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldsm_x4(af[mi], a + a_off(row0 + mi * rstep + (lane & 15), lane >> 4));
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

// The same with m16 tile mi multiplying weight-tile rows wrow[mi]..+15 (the
// track product of a warp whose two m16 tiles lie in two tracks).
__device__ __forceinline__ void mma_k16_split(float (&acc)[2][8][4],
                                              const bf16* a, const bf16* w,
                                              const int (&wrow)[2], int row0,
                                              int rstep, int col0, int lane) {
  uint32_t af[2][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
    ldsm_x4(af[mi], a + a_off(row0 + mi * rstep + (lane & 15), lane >> 4));
#pragma unroll
  for (int jp = 0; jp < 4; ++jp) {
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const int r = wrow[mi] + (lane & 7) + ((lane >> 3) & 1) * 8;
      uint32_t b[4];
      ldsm_x4_t(b, w + w_off(r, ((col0 + jp * 16) >> 3) + (lane >> 4)));
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

// Accumulator element (mi, nj, e) of lane l sits at row row0 + rstep mi +
// l / 4 + 8 (e / 2), column col0 + 8 nj + 2 (l % 4) + e % 2; its bf16 pair
// (e = 0, 1 or 2, 3) is parked at park[16 mi + 2 nj + e / 2][tid].
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
// column tile n0; cell[mi][hh] is the local cell of its row in m16 tile mi,
// half hh (-1: a padding row, not stored). Without EPI neither ea, eb nor
// the residual rows are read. out rows are n wide; the residual is xin's
// column c0 + col of rows d wide.
template <bool EPI>
__device__ __forceinline__ void epilogue(const Smem& sm,
                                         const float (&acc)[2][8][4],
                                         const bf16* xin, bf16* xo,
                                         const bf16* bias, const bf16* ea,
                                         const bf16* eb, int d, int n, int c0,
                                         int n0, const int (&cell)[2][2],
                                         int col0, int tid) {
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
          const float m = sm.m[i];
          const float2 tk = bf2(sm.park[mi * 16 + nj * 2 + hh][tid]);
          const float v0 = rnd(rnd(rnd(acc[mi][nj][2 * hh]) + bb.x) + tk.x) * m;
          const float v1 = rnd(rnd(rnd(acc[mi][nj][2 * hh + 1]) + bb.y) + tk.y) * m;
          *reinterpret_cast<uint32_t*>(xo + (size_t)i * n + col) = pack2(v0, v1);
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
        const float m = sm.m[i];
        const float2 tk = bf2(sm.park[mi * 16 + nj * 2 + hh][tid]);
        const float v0 = rnd(rnd(rnd(acc[mi][nj][2 * hh]) + bb.x) + tk.x) * m;
        const float v1 = rnd(rnd(rnd(acc[mi][nj][2 * hh + 1]) + bb.y) + tk.y) * m;
        const float2 xr =
            bf2(*reinterpret_cast<const uint32_t*>(xin + (size_t)i * d + c0 + col));
        const float o0 = fmaxf(rnd(rnd(v0 * aa.x) + ee.x) * m, 0.f) + xr.x;
        const float o1 = fmaxf(rnd(rnd(v1 * aa.y) + ee.y) * m, 0.f) + xr.y;
        *reinterpret_cast<uint32_t*>(xo + (size_t)i * n + col) =
            pack2(o0, o1);
      }
  }
}

template <bool EPI>
__global__ void __launch_bounds__(THREADS, 2)
gcl_eval_grid_bf16_tc_kernel(const bf16* x, const int* aux,
                             const bf16* gates, const bf16* wbigs,
                             const bf16* biases, const bf16* eas,
                             const bf16* ebs, bf16* out, bf16* scratch,
                             int nbar, int S, int bpc, int d, int n, int c0,
                             int K) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  const int bar0 = blockIdx.x * bpc;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col0 = (warp & 1) * 64;   // the warp's 64 columns of each tile
  Grid gd(S, RPAD, min(bpc, nbar - bar0));
  const int N = gd.N;
  // and its two m16 tiles of a row tile, rows row0.. and row0 + rstep..: m16
  // tiles i and i + 4 where a track is 16 rows (both of one track), else 2i
  // and 2i + 1
  const int rstep = gd.SP == 16 ? 64 : 16;
  const int row0 = (warp >> 1) * (gd.SP == 16 ? 16 : 32);

  // ---- the statics of the CTA's bars, shared by every layer ----
  gcl::load_grid_statics<bf16>(sm, aux + (size_t)bar0 * gcl::N_AUX * N,
                               gd.nb, S, tid, THREADS);
  __syncthreads();

  // Stages of a layer: per row tile and output column tile, nf stages of
  // the track product (weight blocks 0-3) and then nf of the shared product
  // (blocks 4-7).
  const int nf = d / BK;
  const int per_tile = 2 * nf;
  const int per_rows = (n / BN) * per_tile;
  const int nstage = (gd.M + MT - 1) / MT * per_rows;
  // n < d only at K = 1, so a chained layer's rows are d = n wide
  const size_t bar_off = (size_t)bar0 * N * d, out_off = (size_t)bar0 * N * n;

  for (int k = 0; k < K; ++k) {
    // ping-pong: layer K-1 writes `out`, layer K-2 `scratch`, and so on
    const bf16* xin = (k == 0) ? x + bar_off
                               : (((K - k) % 2 == 0) ? out : scratch) + out_off;
    bf16* xo = (((K - 1 - k) % 2 == 0) ? out : scratch) + out_off;
    const bf16* W = wbigs + (size_t)k * NBLK * d * n;
    const bf16* bias = biases + (size_t)k * n;
    const bf16* ea = EPI ? eas + (size_t)k * n : nullptr;
    const bf16* eb = EPI ? ebs + (size_t)k * n : nullptr;

    auto fetch_w = [&](int s) {
      const int j = s % per_tile;
      load_w(sm.w[s & 1], W, d, n, j < nf ? 0 : T, (j % nf) * BK,
             (s % per_rows / per_tile) * BN, tid);
    };
    auto fetch_x = [&](int s) {
      const int t0 = s / per_rows * MT;
      load_x(sm, xin, gates, S, N, t0 / gd.BP,
             min(gd.nb, (t0 + MT + gd.BP - 1) / gd.BP), d,
             (s % per_tile % nf) * BK, tid);
    };

    fetch_w(0);
    fetch_x(0);
    cp_async_commit();
    float acc[2][8][4];
    int t0 = -1, ibuild = -1, trow[2] = {0, 0}, cell[2][2] = {{-1, -1}, {-1, -1}};
    int item[2] = {0, 0};
    for (int s = 0; s < nstage; ++s) {
      const int j = s % per_tile;
      const bool track = j < nf;
      if (s / per_rows * MT != t0) {
        // a new row tile: the bars it touches, the cell of the row this
        // thread builds, the track block of each of the warp's m16 tiles
        // and the cells of this thread's accumulator rows
        t0 = s / per_rows * MT;
        gd.tile(t0, MT);
        ibuild = cell_of(gd, t0 + (tid >> 1));
        shared_items(gd, t0, tid, item);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          const int p = t0 + row0 + mi * rstep;
          trow[mi] = p < gd.M ? (p % gd.BP) / gd.SP * BK : 0;
#pragma unroll
          for (int hh = 0; hh < 2; ++hh)
            cell[mi][hh] = cell_of(gd, p + (lane >> 2) + hh * 8);
        }
      }
      if (j == 0) zero(acc);
      cp_async_wait_all();
      __syncthreads();  // stage s is in; every warp is done with stage s-1
      if (s + 1 < nstage) fetch_w(s + 1);
      if (track)
        build_track(sm, ibuild, tid);
      else
        build_shared(sm, gd, item, ibuild, tid);
      __syncthreads();  // the A chunk is built; xs and gs are free
      if (s + 1 < nstage) fetch_x(s + 1);
      cp_async_commit();
      const bf16* wt = sm.w[s & 1];
      if (track) {
        if (trow[0] == trow[1])
          mma_k16(acc, sm.a[0], wt, trow[0], row0, rstep, col0, lane);
        else
          mma_k16_split(acc, sm.a[0], wt, trow, row0, rstep, col0, lane);
        if (j == nf - 1) {
          park_track(sm, acc, tid);
          zero(acc);
        }
      } else {
#pragma unroll
        for (int seg = 0; seg < NSB; ++seg)
          mma_k16(acc, sm.a[seg], wt, seg * BK, row0, rstep, col0, lane);
        if (j == per_tile - 1)
          epilogue<EPI>(sm, acc, xin, xo, bias, ea, eb, d, n, c0,
                        (s % per_rows / per_tile) * BN, cell, col0, tid);
      }
    }
    // the next layer reads this layer's output rows written by other threads
    __syncthreads();
  }
}

}  // namespace

// Bars per CTA for nbar bars of 4 x S cells on `sms` SMs (two CTAs each):
// the fewest waves of CTAs times row tiles a CTA, then the fewest tiles in
// all, then the fewest bars a CTA; at most MAXC cells a CTA.
static int bars_per_cta(int nbar, int S, int sms) {
  const int bp = 4 * ((S + RPAD - 1) / RPAD * RPAD);
  long long best_cost = -1, best_work = 0;
  int best = 1;
  for (int bpc = 1; bpc <= nbar && bpc * 4 * S <= MAXC; ++bpc) {
    const long long ctas = (nbar + bpc - 1) / bpc;
    const long long tiles = (bpc * bp + MT - 1) / MT;
    const long long cost = (ctas + 2 * sms - 1) / (2 * sms) * tiles;
    const long long work = ctas * tiles;
    if (best_cost < 0 || cost < best_cost ||
        (cost == best_cost && work < best_work)) {
      best_cost = cost;
      best_work = work;
      best = bpc;
    }
  }
  return best;
}

// Layers of the kernel's EPI form over bars of 4 x S cells, every float
// tensor in bf16: x (nbar, 4 S, d), out, scratch (nbar, 4 S, n), gates (S,
// d), wbigs (K, 8d, n), biases, eas, ebs (K, n); aux (nbar, 14, 4 S) int32.
// S % 4 == 0 up to 48; d % 128 == 0 and n % 128 == 0 with c0 + n <= d; a
// chain (K > 1) takes n = d, c0 = 0. At K = 1 the launch writes output
// columns c0..c0+n-1 of the layer, and scratch may be out. Without EPI, K
// = 1, c0 = 0 and eas, ebs are not read.
template <bool EPI>
static int launch(const void* x, const void* aux, const void* gates,
                  const void* wbigs, const void* biases, const void* eas,
                  const void* ebs, void* out, void* scratch, int nbar, int S,
                  int d, int n, int c0, int K, void* stream) {
  if (nbar <= 0) return 0;
  if (S < 4 || S % 4 != 0 || S > MAXS || d <= 0 || d % BN != 0 || n <= 0 ||
      n % BN != 0 || c0 < 0 || c0 % 2 != 0 || c0 + n > d || K < 1 ||
      (!EPI && (K != 1 || c0 != 0)) || (K > 1 && n != d))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_eval_grid_bf16_tc_kernel<EPI>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(gcl_eval_grid_bf16_tc_kernel<EPI>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  int dev = 0, sms = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int bpc = bars_per_cta(nbar, S, sms);
  gcl_eval_grid_bf16_tc_kernel<EPI>
      <<<(nbar + bpc - 1) / bpc, THREADS, smem, (cudaStream_t)stream>>>(
          (const bf16*)x, (const int*)aux, (const bf16*)gates,
          (const bf16*)wbigs, (const bf16*)biases, (const bf16*)eas,
          (const bf16*)ebs, (bf16*)out, (bf16*)scratch, nbar, S, bpc, d, n,
          c0, K);
  return (int)cudaGetLastError();
}

// K chained eval layers (folded batch-norm, relu, residual); at K = 1
// output columns c0..c0+n-1 of the layer.
extern "C" int gcl_eval_grid_bf16_launch(const void* x, const void* aux,
                                         const void* gates, const void* wbigs,
                                         const void* biases, const void* eas,
                                         const void* ebs, void* out,
                                         void* scratch, int nbar, int S,
                                         int d, int n, int c0, int K,
                                         void* stream) {
  return launch<true>(x, aux, gates, wbigs, biases, eas, ebs, out, scratch,
                      nbar, S, d, n, c0, K, stream);
}

// One training-forward layer: out = v, wbig (8d, n), bias (n,), out (nbar,
// 4 S, n).
extern "C" int gcl_fwd_grid_bf16_launch(const void* x, const void* aux,
                                        const void* gates, const void* wbig,
                                        const void* bias, void* out, int nbar,
                                        int S, int d, int n, void* stream) {
  return launch<false>(x, aux, gates, wbig, bias, nullptr, nullptr, out, out,
                       nbar, S, d, n, 0, 1, stream);
}

// Dynamic shared memory a CTA takes.
extern "C" int gcl_eval_grid_bf16_smem_bytes() { return (int)sizeof(Smem); }
