// GCL training backward in bf16 for bars of 4 x S cells at any S that is a
// multiple of 4 above 48 (resolutions 13 and up: 24, the Lakh Pianoroll
// Dataset's grid, is S = 96): dx, d(gate_table) (S, d), dbias and dWbig,
// the products on the tensor cores. Up to S = 48 the port launches
// `gcl_bwd_fused_grid_bf16_tc.cu` (and at S = 32 `gcl_bwd_fused_bf16_tc.cu`),
// whose CTAs hold whole bars; above that one bar no longer fits a CTA's
// shared memory, and this source walks each bar in tiles of 4 tracks x 32
// columns.
//
// Replaces, in bf16 and at those grids, the Pallas kernel `_bwd_fused_kernel`
// of polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py:289 (`gcl_backward_fused`,
// its pallas_call at :453), the backward of the bf16 training layer, which
// takes the steps a bar as `n_steps` (:289-297). Per bar of N = 4 S cells
// it computes what the two other bf16 fused sources compute, with the same
// roundings:
//
//   dH_r  = gm @ W_r^T               (track blocks: each track's S rows only)
//   dx    = dH_root m + the scatters; dgate, dbias summed over every bar
//   dW_r += h_r^T @ gm               (h_root = x m; track blocks: own rows)
//
// for Wbig (8d, n) and g (nbar, N, n): the square weights (n = d), or the
// column form of tensor parallelism, n of the d output columns (n % 128 ==
// 0 dividing d), where dH, dx and dgate are partial sums over the shard's n
// columns (their sum over the shards is the square launch's) and dbias and
// dWbig are n wide. x, g, gates, wbig and dx are bf16; every product sums
// in fp32; values are rounded to bf16 where the Pallas body casts to its
// compute dtype (the reciprocals, dcol and dnx before their column sums,
// the relu tests' pre-activations, the scatter shares, the rebuilt messages
// and their sums, and dx).
//
// What bounds it on an H100: operations, 4 N 5d d flops a bar of useful
// work (the dH and dW products): 2.03 GFLOP a bar at S = 96, d = 512, 0.53
// ms at 256 bars on the dense bf16 tensor cores. The scratch between the
// dH product and the gather (4 fp32 planes, 805 MB at 256 bars) is traffic
// of this design, not of the function.
//
// Design: three kernels, the long-bar tiling of `gcl_bwd_data_long.cu` and
// `gcl_bwd_weight_long.cu` with the tensor-core products of the bf16 fused
// sources.
// - dH product (`gcl_bwd_fused_long_bf16_tc_kernel`). A CTA of 8 warps owns
//   32 dH features (c0..c0+31 of each of the 5 segments) and walks the
//   items (bar, tile of 4 tracks x 32 columns) chunk, chunk + nchunks, ...;
//   row r = 32 t + cc of an item is cell (t, tc0 + cc). Warp w owns rows
//   16 w..16 w + 15, all in track w / 2, so an m16 tile needs no padding
//   rows: the g rows past the bar's last column are zero-filled copies. It
//   contracts g's n columns against the 8 blocks' W rows (segment 0 the
//   warp's own track block, 1-4 blocks 4-7) with mma.sync m16n8k16 on
//   cp.async stages of 32 features, two of them, swizzled for ldmatrix;
//   80 fp32 sums a thread. It writes dH_root m into dr and the three
//   upstream planes (dmsg, dz, dy0) into the scratch exactly as the split
//   data backward's product kernel does, the column sums of dcol and dnx
//   over the item's four tracks through shared memory.
// - Gather (`gcl_bwd_gather_long.cuh`, the split data backward's): dx,
//   dgate and dbias from the scratch, a CTA a bar x 128 features, per-bar
//   partial rows summed in bar order. No atomics.
// - dW (`gcl_bwd_dw_long_bf16_tc_kernel`). `gcl_bwd_dw_bf16_tc_kernel`'s
//   ownership: a CTA owns rows [c0, c0 + 32) of all 8 blocks x columns [j0,
//   j0 + 64), 64 fp32 sums a thread in registers, each element of dWbig
//   written once after the last bar (no partials in device memory). It
//   walks every bar in tiles of 4 x 32 cells: the tile's statics
//   (`gcl::TileStatics`: the source cells each row reads), then the four
//   source rows' 32 features of x and the row's 64 columns of g gathered
//   from L2 by cp.async; the CTA rebuilds the 5 A tiles (h_track, h_self,
//   h_onset, h_next, x m) in bf16x2 arithmetic with the Pallas body's
//   roundings and multiplies them on mma.sync (warp w: track block w / 2
//   over its own track's 32 rows, block 4 + w / 2 over all 128). Two
//   stages: the next tile's statics and copies are issued before this
//   tile's MMAs, so the copies run under them.
// dgate, dbias and dWbig are bitwise repeatable.
#include <cuda_bf16.h>

#include "gcl_bwd_gather_long.cuh"
#include "gcl_common.cuh"
#include "gcl_dw_bf16.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace gcl;
using namespace tc;
using V = Elem<bf16>;
using bf162 = __nv_bfloat162;

constexpr int THREADS = 256;     // 8 warps, every kernel but the gather
constexpr int CW = 32;           // bar columns of an item / tile
constexpr int MT = T * CW;       // rows of an item / tile
constexpr int NSEG = 5;          // segments: track, self, onset, next, root
constexpr int BC = 32;           // dH kernel: dH features a CTA
constexpr int BK = 32;           // dH kernel: contracted features a stage
constexpr int WR = 32;           // dW kernel: dW rows (h features) a CTA
constexpr int WJ = 64;           // dW kernel: dW columns (g features) a CTA
constexpr int NSRC = 4;          // gathered rows a cell: self, prev, next, pn

// A 16-byte copy that writes zeros when !valid (src is then not read).
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src,
                                                 bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

// ---------------------------------------------------------- the dH kernel

// Features f0..f0+BK-1 of the item's g rows and of the W rows of the CTA's
// features in all 8 blocks (row blk * BC + c).
struct DhStage {
  alignas(16) bf16 g[MT * BK];
  alignas(16) bf16 w[NBLK * BC * BK];
};

struct DhSmem {
  DhStage st[2];                          // stage u in st[u % 2]
  alignas(16) float col[2][MT][BC];       // dcol, dnx of the item
  float m[MT], rtr[MT], single[MT], ron[MT], rnx[MT];
};

// Stage buffer st: features f0.. of g rows (gb: the item's bar, rows n
// wide; zero past the bar's last column) and of the W rows (rows n wide).
__device__ __forceinline__ void dh_load_stage(DhStage& st, const bf16* gb,
                                              const bf16* wbig, int S, int d,
                                              int n, int tc0, int c0, int f0,
                                              int tid) {
#pragma unroll
  for (int j = 0; j < MT * BK / 8 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int r = c >> 2, ch = c & 3;
    const int col = tc0 + r % CW;
    const bool valid = col < S;
    const size_t at = valid ? (size_t)(r / CW * S + col) * n + f0 + ch * 8 : 0;
    cp_async16_zfill(st.g + s_off(r, ch), gb + at, valid);
  }
#pragma unroll
  for (int j = 0; j < NBLK * BC * BK / 8 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int r = c >> 2, ch = c & 3;
    const int blk = r / BC, nn = r % BC;
    cp_async16(st.w + s_off(r, ch),
               wbig + ((size_t)blk * d + c0 + nn) * n + f0 + ch * 8);
  }
}

// dr: dH_root m, fp32 (nbar, N, d); up: the scratch planes (nbar,
// UP_PLANES, N, d).
__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_fused_long_bf16_tc_kernel(const bf16* __restrict__ g,
                                  const int* __restrict__ aux,
                                  const bf16* __restrict__ wbig,
                                  float* __restrict__ up,
                                  float* __restrict__ dr, int nbar, int S,
                                  int d, int n, int nchunks) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DhSmem& sm = *reinterpret_cast<DhSmem*>(smem_raw);
  const int N = T * S, ntile = (S + CW - 1) / CW, nitem = nbar * ntile;
  const int c0 = blockIdx.x * BC, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = warp * 16, trk = warp >> 1;  // 16 rows of track trk
  const int nstage = n / BK;  // the product's reduction: g's n columns
  if (chunk >= nitem) return;

  dh_load_stage(sm.st[0], g + (size_t)(chunk / ntile) * N * n, wbig, S, d, n,
                chunk % ntile * CW, c0, 0, tid);
  cp_async_commit();
  float acc[NSEG][4][4];
#pragma unroll
  for (int s = 0; s < NSEG; ++s)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;

  unsigned u = 0;  // stages multiplied so far
  for (int it = chunk; it < nitem; it += nchunks) {
    const int bar = it / ntile, tc0 = it % ntile * CW;
    const int nx = it + nchunks;
    const bf16* gb = g + (size_t)bar * N * n;
    // a row of the warp's lies in the bar (else its g rows are all zero)
    const bool live = tc0 + row0 % CW < S;
    for (int st = 0; st < nstage; ++st, ++u) {
      cp_async_wait_all();
      // stage u has landed; no warp still reads the buffer that stage u + 1
      // takes (nor, at st 0, the previous item's statics or column tiles)
      __syncthreads();
      if (st + 1 < nstage)
        dh_load_stage(sm.st[(u + 1) & 1], gb, wbig, S, d, n, tc0, c0,
                      (st + 1) * BK, tid);
      else if (nx < nitem)
        dh_load_stage(sm.st[(u + 1) & 1], g + (size_t)(nx / ntile) * N * n,
                      wbig, S, d, n, nx % ntile * CW, c0, 0, tid);
      cp_async_commit();
      if (st == 0 && tid < MT) {
        const int t = tid / CW, c = tc0 + tid % CW;
        CellStatics cs{};
        if (c < S)
          cs = cell_statics_grid(aux + (size_t)bar * N_AUX * N, t * S + c, N,
                                 S);
        sm.m[tid] = cs.m;
        sm.rtr[tid] = V::rnd(cs.rtr);
        sm.single[tid] = cs.single;
        sm.ron[tid] = V::rnd(cs.ron);
        sm.rnx[tid] = V::rnd(cs.rnx);
      }
      if (!live) continue;
      const bf16* ga = sm.st[u & 1].g;
      const bf16* wa = sm.st[u & 1].w;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        uint32_t a[4];
        ldsm_x4(a, ga + s_off(row0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
        for (int s = 0; s < NSEG; ++s) {
          const int blk = s == 0 ? trk : T - 1 + s;
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            // n8 tiles 2 jp and 2 jp + 1: k halves 0, 1 of each
            uint32_t b[4];
            ldsm_x4(b, wa + s_off(blk * BC + jp * 16 + (lane & 7)
                                  + ((lane >> 4) << 3),
                                  2 * kk + ((lane >> 3) & 1)));
            mma_bf16(acc[s][2 * jp], a, b[0], b[1]);
            mma_bf16(acc[s][2 * jp + 1], a, b[2], b[3]);
          }
        }
      }
    }

    // accumulator (s, j, e) of lane l: row row0 + l / 4 + 8 (e / 2), column
    // 8 j + 2 (l % 4) + e % 2. In place: dmsg (segment 0), dself (1) and
    // dH_root m (4); dcol and dnx to shared memory for the column sums
    __syncthreads();  // the item's statics
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + (lane >> 2) + 8 * hh;
      const float m = sm.m[row], rtr = sm.rtr[row], single = sm.single[row];
      const float ron = sm.ron[row], rnx = sm.rnx[row];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 8 * j + 2 * (lane & 3);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int i = 2 * hh + e;
          acc[0][j][i] = acc[0][j][i] * m * rtr;
          acc[1][j][i] = acc[1][j][i] * m * single;
          sm.col[0][row][q + e] = V::rnd(acc[2][j][i] * m * ron);
          sm.col[1][row][q + e] = V::rnd(acc[3][j][i] * m * rnx);
          acc[4][j][i] = acc[4][j][i] * m;
        }
      }
    }
    __syncthreads();
    const size_t plane = (size_t)N * d;
    float* upb = up + (size_t)bar * UP_PLANES * plane;
    float* drb = dr + (size_t)bar * plane;
    const float (*dcol)[BC] = sm.col[0];
    const float (*dnx)[BC] = sm.col[1];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int row = row0 + (lane >> 2) + 8 * hh, cc = row % CW;
      if (tc0 + cc >= S) continue;  // past the bar's last column
      const size_t cell = (size_t)(trk * S + tc0 + cc) * d + c0;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q = 8 * j + 2 * (lane & 3);
        float dz[2], dy0[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qq = q + e;
          dy0[e] = (dcol[cc][qq] + dcol[CW + cc][qq] + dcol[2 * CW + cc][qq]
                    + dcol[3 * CW + cc][qq]) - dcol[row][qq]
                   + acc[1][j][2 * hh + e];
          dz[e] = (dnx[cc][qq] + dnx[CW + cc][qq] + dnx[2 * CW + cc][qq]
                   + dnx[3 * CW + cc][qq]) - dnx[row][qq];
        }
        *reinterpret_cast<float2*>(upb + cell + q) =
            make_float2(acc[0][j][2 * hh], acc[0][j][2 * hh + 1]);
        *reinterpret_cast<float2*>(upb + plane + cell + q) =
            make_float2(dz[0], dz[1]);
        *reinterpret_cast<float2*>(upb + 2 * plane + cell + q) =
            make_float2(dy0[0], dy0[1]);
        *reinterpret_cast<float2*>(drb + cell + q) =
            make_float2(acc[4][j][2 * hh], acc[4][j][2 * hh + 1]);
      }
    }
#pragma unroll
    for (int s = 0; s < NSEG; ++s)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;
  }
}

// ---------------------------------------------------------- the dW kernel

// One tile's inputs: its statics, the four source rows' 32 features of x
// for every row (rows of 64 bytes), and the row's 64 columns of g (rows of
// 128 bytes, g_off; zero past the bar's last column).
struct DwStage : TileStatics<CW> {
  alignas(16) bf16 xs[NSRC][MT][WR];
  alignas(16) bf16 g[MT * WJ];
};

struct DwSmem {
  DwStage st[2];                          // tile u in st[u % 2]
  // the A tiles of the tile, k-major (row = cell), swizzled as s_off:
  // h_track, h_self, h_onset, h_next and x m, the CTA's 32 features each
  alignas(16) bf16 h[NSEG][MT * WR];
};

static_assert(WR == BK && BK == TILE_K && WJ == TILE_G,
              "the A tiles share s_off with the dH stages, the rows of gcl_dw_bf16.cuh's layouts");

// the same through the read-only data cache (the gate table)
__device__ __forceinline__ H4 ldg4(const bf16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return {*reinterpret_cast<const bf162*>(&u.x),
          *reinterpret_cast<const bf162*>(&u.y)};
}

// a 0/1 flag or a reciprocal already rounded to bf16, as a bf16 pair
__device__ __forceinline__ bf162 pair(float v) {
  return __float2bfloat162_rn(v);
}

// The tile's gathered x rows and g rows into st by 16-byte copies (xb, gb
// at the bar's first cell; x rows d wide, g rows n wide), after its
// statics.
__device__ __forceinline__ void dw_load_tile(DwStage& st, const bf16* xb,
                                             const bf16* gb, int S, int d,
                                             int n, int tc0, int c0, int j0,
                                             int tid) {
#pragma unroll
  for (int j = 0; j < NSRC * MT * WR / 8 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int ch = c & 3, r = (c >> 2) % MT, src = c / (4 * MT);
    cp_async16(&st.xs[src][r][ch * 8],
               xb + (size_t)st.src[src][r] * d + c0 + ch * 8);
  }
#pragma unroll
  for (int j = 0; j < MT * WJ / 8 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int ch = c & 7, r = c >> 3;
    const int col = tc0 + r % CW;
    const bool valid = col < S;
    const size_t at = valid ? (size_t)(r / CW * S + col) * n + j0 + ch * 8 : 0;
    cp_async16_zfill(st.g + g_off(r, ch), gb + at, valid);
  }
}

// The tile's A tiles into sm.h from its stage: thread (column cc, features
// q..q+3) rebuilds rows cc, CW + cc, 2 CW + cc and 3 CW + cc of each, every
// rounding as `rounded_weight` (gates at the CTA's first feature, rows d
// wide).
__device__ __forceinline__ void dw_build(DwSmem& sm, const DwStage& st,
                                         const bf16* gates, int d, int tid) {
  const int cc = tid / (WR / 4), q = (tid % (WR / 4)) * 4;
  static_assert(CW * WR / 4 == THREADS, "one (column, 4 features) a thread");
  auto gate = [&](int s) { return ldg4(gates + (size_t)s * d + q); };
  const H4 g0 = gate(0);
  H4 xk[T], y[T], z[T];
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int r = t * CW + cc;
    xk[t] = ld4(&st.xs[0][r][q]);
    y[t] = msg(xk[t], g0, pair(st.m[r]));
    z[t] = msg(ld4(&st.xs[3][r][q]), gate(st.dpn[r]), pair(st.okpn[r]));
  }
  const H4 ysum = col_sum(y), zsum = col_sum(z);
#pragma unroll
  for (int t = 0; t < T; ++t) {
    const int r = t * CW + cc;
    const H4 vp = msg(ld4(&st.xs[1][r][q]), gate(st.dp[r]), pair(st.okp[r]));
    const H4 vn = msg(ld4(&st.xs[2][r][q]), gate(st.dn[r]), pair(st.okn[r]));
    const int o = s_off(r, q >> 3) + (q & 7);
    st4(sm.h[0] + o, mul(add(vp, vn), pair(st.rtr[r])));      // track
    st4(sm.h[1] + o, mul(y[t], pair(st.single[r])));          // self
    st4(sm.h[2] + o, mul(sub(ysum, y[t]), pair(st.ron[r])));  // onset
    st4(sm.h[3] + o, mul(sub(zsum, z[t]), pair(st.rnx[r])));  // next
    st4(sm.h[4] + o, mul(xk[t], pair(st.m[r])));              // root: x m
  }
}

// One tile into the warp's sums: track block p over its own track's rows
// and block T + p over all MT, columns jn..jn+31, 16 rows a k-step; the
// k-steps past the bar's last column (ncol columns in the tile) skipped.
__device__ __forceinline__ void dw_tile(float (&acc)[2][2][4][4],
                                        const DwSmem& sm, const bf16* gt,
                                        int p, int jn, int ncol, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < MT; k0 += 16) {
    if (k0 % CW >= ncol) continue;
    uint32_t b[2][4];
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldsm_x4_t(b[np], gt + g_off(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  (jn >> 3) + 2 * np + (lane >> 4)));
    if (k0 / CW == p) dw_mma(acc[0], sm.h[0], k0, b, lane);  // own track
    dw_mma(acc[1], sm.h[1 + p], k0, b, lane);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_dw_long_bf16_tc_kernel(const bf16* __restrict__ x,
                               const bf16* __restrict__ g,
                               const int* __restrict__ aux,
                               const bf16* __restrict__ gates,
                               float* __restrict__ dwbig, int nbar, int S,
                               int d, int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DwSmem& sm = *reinterpret_cast<DwSmem*>(smem_raw);
  const int N = T * S, ntile = (S + CW - 1) / CW, nt = nbar * ntile;
  const int j0 = blockIdx.x * WJ, c0 = blockIdx.y * WR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = warp >> 1;             // track block p and block T + p
  const int jn = (warp & 1) * 32;      // the warp's 32 of the 64 columns
  const bf16* gc = gates + c0;
  // tile u's statics, a barrier, then its copies into st[u % 2]
  auto prep = [&](int u) {
    DwStage& st = sm.st[u & 1];
    const int bar = u / ntile, tc0 = u % ntile * CW;
    load_tile_statics<bf16, CW>(st, aux + (size_t)bar * N_AUX * N, S, tc0,
                                tid, THREADS);
    __syncthreads();
    dw_load_tile(st, x + (size_t)bar * N * d, g + (size_t)bar * N * n, S, d,
                 n, tc0, c0, j0, tid);
    cp_async_commit();
  };

  // [0]: track block p, [1]: block T + p
  float acc[2][2][4][4];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][mt][i][e] = 0.f;
  if (nt > 0) {
    prep(0);
    cp_async_wait_all();
    __syncthreads();
    dw_build(sm, sm.st[0], gc, d, tid);
    __syncthreads();
  }
  // Tile u: tile u + 1's statics and copies issued, tile u's MMAs; after a
  // barrier (tile u + 1 has landed, no warp still reads the A tiles),
  // tile u + 1's rebuild.
  for (int u = 0; u < nt; ++u) {
    if (u + 1 < nt) prep(u + 1);
    dw_tile(acc, sm, sm.st[u & 1].g, p, jn, min(CW, S - u % ntile * CW),
            lane);
    if (u + 1 == nt) break;
    cp_async_wait_all();
    __syncthreads();
    dw_build(sm, sm.st[(u + 1) & 1], gc, d, tid);
    __syncthreads();
  }

  // accumulator (b, mt, i, e) of lane l: row 16 mt + l / 4 + 8 (e / 2),
  // column jn + 8 i + 2 (l % 4) + e % 2 of block b ? T + p : p
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float* out = dwbig + ((size_t)(b ? T + p : p) * d + c0) * n + j0 + jn;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * mt + (lane >> 2) + 8 * hh;
#pragma unroll
        for (int i = 0; i < 4; ++i)
          *reinterpret_cast<float2*>(out + (size_t)row * n + 8 * i
                                     + 2 * (lane & 3)) =
              make_float2(acc[b][mt][i][2 * hh], acc[b][mt][i][2 * hh + 1]);
      }
  }
}

}  // namespace

// Bytes of dynamic shared memory a CTA of the dH kernel (dw = 0) or of the
// dW kernel (dw = 1) takes.
extern "C" int gcl_bwd_fused_long_bf16_smem_bytes(int dw) {
  return dw ? (int)sizeof(DwSmem) : (int)sizeof(DhSmem);
}

// x (nbar, 4 S, d), g (nbar, 4 S, n); aux (nbar, N_AUX, 4 S); gates (S, d);
// wbig (8d, n), the float tensors in bf16, all 16-byte aligned; d % 128 ==
// 0, n % 128 == 0 dividing d (n = d: the square weights; n < d: a column
// shard, dx and dgate partial over its columns); S a multiple of 4, 4 S <
// 65536. Writes dx (nbar, 4 S, d) in bf16, and dwbig (8d, n) and out =
// [dgate (S, d) | dbias (n)] in fp32, using up (4 nbar, 4 S, d) floats as
// the scratch between the dH product and the gather (the planes dmsg, dz,
// dy0 of every bar, (nbar, UP_PLANES, 4 S, d), then dH_root m of every bar,
// (nbar, 4 S, d)) and part (nbar, S * d + n) for the per-bar partials.
extern "C" int gcl_bwd_fused_long_bf16_launch(const void* x, const void* g,
                                              const void* aux,
                                              const void* gates,
                                              const void* wbig, void* dx,
                                              void* part, void* dwbig,
                                              void* out, void* up, int nbar,
                                              int S, int d, int n,
                                              void* stream) {
  static_assert(sizeof(DhSmem) <= 232448 && sizeof(DwSmem) <= 232448,
                "a CTA's shared memory");
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 0 || d % 128 != 0 || n <= 0 || n % 128 != 0 || d % n != 0 ||
      S < 4 || S % 4 != 0 || T * S >= 65536 || nbar < 0)
    return (int)cudaErrorInvalidValue;
  const long long row = (long long)S * d + n;  // a partial row
  cudaError_t err;
  if (nbar == 0) {
    if ((err = cudaMemsetAsync(dwbig, 0, sizeof(float) * NBLK * d * n,
                               st)) != cudaSuccess)
      return (int)err;
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * row, st);
  }
  const int ntile = (S + CW - 1) / CW;
  const long long nitem = (long long)nbar * ntile;
  if (nitem > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  const int smem = (int)sizeof(DhSmem), dw_smem = (int)sizeof(DwSmem);
  if ((err = cudaFuncSetAttribute(gcl_bwd_fused_long_bf16_tc_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(gcl_bwd_dw_long_bf16_tc_kernel,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  dw_smem)) != cudaSuccess)
    return (int)err;
  // the scratch planes, then dH_root m
  float* upf = (float*)up;
  float* dr = upf + (size_t)nbar * UP_PLANES * T * S * d;
  const int tiles = d / BC;
  const int per_tile = sms / tiles > 1 ? sms / tiles : 1;
  const int nchunks = nitem < per_tile ? (int)nitem : per_tile;
  gcl_bwd_fused_long_bf16_tc_kernel<<<dim3(tiles, nchunks), THREADS, smem,
                                      st>>>((const bf16*)g, (const int*)aux,
                                            (const bf16*)wbig, upf, dr, nbar,
                                            S, d, n, nchunks);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = gather_long<bf16>((const bf16*)x, (const bf16*)g,
                               (const int*)aux, (const bf16*)gates, upf, dr,
                               (bf16*)dx, (float*)part, (float*)out, nbar, S,
                               d, n, st)) != cudaSuccess)
    return (int)err;
  gcl_bwd_dw_long_bf16_tc_kernel<<<dim3(n / WJ, d / WR), THREADS, dw_smem,
                                   st>>>((const bf16*)x, (const bf16*)g,
                                         (const int*)aux, (const bf16*)gates,
                                         (float*)dwbig, nbar, S, d, n);
  return (int)cudaGetLastError();
}
