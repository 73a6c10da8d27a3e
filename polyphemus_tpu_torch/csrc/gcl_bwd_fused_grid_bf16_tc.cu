// GCL training backward in bf16 for bars of 4 x S cells at any S that is a
// multiple of 4 up to 48 but 32 (resolutions 1-12 but 8): dx, d(gate_table)
// (S, d), dbias and dWbig, by two kernels on the tensor cores. At S = 32 the
// port launches `gcl_bwd_fused_bf16_tc.cu`; this source takes the other
// grids.
//
// Replaces, in bf16 and at those grids, the Pallas kernel `_bwd_fused_kernel`
// of polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py:289 (`gcl_backward_fused`,
// its pallas_call at :453), the backward of the bf16 training layer, which
// takes the steps a bar as `n_steps` (:289-297). Per bar of N = 4 S cells
// it computes what `gcl_bwd_fused_bf16_tc.cu` computes, with the same
// roundings:
//
//   dH_r  = gm @ W_r^T               (track blocks: each track's S rows only)
//   dx    = dH_root + the scatters; dgate, dbias summed over every bar
//   dW_r += h_r^T @ gm               (h_root = x; track blocks: own rows)
//
// with the column-shard form (Wbig (8d, n), g (nbar, N, n)) as there.
//
// What bounds it on an H100: operations, 4 N 5d d flops a bar of useful
// work (the dH and dW products), 126 MFLOP at S = 12 and 503 MFLOP at S =
// 48, d = 512: 0.033 and 0.13 ms at 256 bars on the dense bf16 tensor cores.
//
// Design: the two kernels of `gcl_bwd_fused_bf16_tc.cu`, templated on S.
// An m16 tile of `mma.sync` must lie in one track (its rows multiply one
// track block), so in both products a track takes SP = S rounded up to 16
// padded rows (BP = 4 SP a bar: 64 at S <= 16, 128 at S <= 32, 192 above);
// the padding rows of the staged g and of the rebuilt A tiles are zero,
// written once, and their sums are never stored. What changes with S:
// - dH kernel (dx, dgate, dbias): g is staged in padded rows (the W stages
//   as at S = 32). The bar's BP / 16 m16 tiles go to the 8 warps: at BP =
//   64 two warps share a tile (16 columns each), at 128 a warp owns one (as
//   at S = 32), at 192 the warps take tiles 0-7 and then 8-11 in two passes
//   over the stages (warps 4-7 idle in the second). The dH tiles, phases 2-4
//   (upstreams, scatters by shared-memory atomics, dx) and the partials are
//   in cell rows, as at S = 32. 223 KB of shared memory at S = 48.
// - dW kernel (dWbig): the A tiles are rebuilt in padded rows and the k
//   steps of 16 cells walk BP rows, a track block taking its own track's
//   SP / 16 steps. The three bar stages and two A buffers of S = 32 would
//   take 278 KB at S = 48; here two stages and one A buffer (165 KB), so a
//   bar's MMAs and the next bar's rebuild no longer overlap: a bar is its
//   MMAs, a barrier, the next bar's copies started, its statics decoded by
//   the CTA, a barrier, its rebuild, a barrier. The copies still run one
//   bar ahead. No dW partials; bitwise repeatable.
#include "gcl_common.cuh"
#include "gcl_dw_bf16.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace gcl;
using namespace tc;
using E = bf16;
using V = Elem<bf16>;
using bf162 = __nv_bfloat162;

constexpr int BC = 32;           // dH kernel: feature columns per CTA
constexpr int BK = 32;           // dH kernel: contracted features a stage
constexpr int NSEG = 5;          // dH segments: track, self, onset, next, root
constexpr int WR = 32;           // dW kernel: dW rows (h features) per CTA
constexpr int WJ = 64;           // dW kernel: dW columns (g features) per CTA
constexpr int THREADS = 256;     // 8 warps, both kernels

// The bar grid at S steps a bar, in cell rows and in padded rows.
template <int S_>
struct Cfg {
  static constexpr int S = S_;
  static constexpr int N = T * S;              // cells a bar
  static constexpr int SP = (S + 15) / 16 * 16;  // padded rows a track
  static constexpr int BP = T * SP;            // padded rows a bar
  static constexpr int MT = BP / 16;           // m16 tiles a bar: 4, 8, 12
  static constexpr int SPLIT = MT < 8 ? 8 / MT : 1;  // warps a tile
  static constexpr int NJP = 2 / SPLIT;        // 16-column pairs a warp
  static constexpr int NPASS = (MT * SPLIT + 7) / 8;  // passes over a bar
};

// The padded row of cell r (track r / S, step r % S).
template <class C>
__device__ __forceinline__ int prow(int r) {
  return r / C::S * C::SP + r % C::S;
}

template <class C>
struct Smem : GridStatics<C::N> {
  // dH tiles; segment 4 becomes dx
  alignas(16) float dh[NSEG][C::N][BC];
  float xs[C::N][BC];            // x[:, tile]
  float gts[C::S][BC];           // gate_table[:, tile]
  float dgs[C::S][BC];           // dgate partial of this CTA's chunk
  float dbs[BC];                 // dbias partial of this CTA's chunk
  alignas(16) bf16 g[2][C::BP * BK];      // g[:, stage] [padded row][k]
  alignas(16) bf16 w[2][NBLK * BC * BK];  // W[blk*d + c0 + n, stage]
};

// Features f0..f0+BK of g (N cells, into their padded rows) and of the W
// rows of this CTA's columns in all 8 blocks (rows n wide).
template <class C>
__device__ __forceinline__ void load_stage(Smem<C>& sm, int buf,
                                           const bf16* gb, const bf16* wbig,
                                           int d, int n, int c0, int f0,
                                           int tid) {
  for (int c = tid; c < C::N * BK / 8; c += THREADS) {
    const int r = c >> 2, ch = c & 3;
    cp_async16(sm.g[buf] + s_off(prow<C>(r), ch),
               gb + (size_t)r * n + f0 + ch * 8);
  }
#pragma unroll
  for (int j = 0; j < NBLK * BC * BK / 8 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int r = c >> 2, ch = c & 3;          // r = blk * BC + n
    const int blk = r / BC, nn = r % BC;
    cp_async16(sm.w[buf] + s_off(r, ch),
               wbig + ((size_t)blk * d + c0 + nn) * n + f0 + ch * 8);
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_fused_grid_bf16_tc_kernel(const E* __restrict__ x,
                                  const E* __restrict__ g,
                                  const int* __restrict__ aux,
                                  const E* __restrict__ gates,
                                  const E* __restrict__ wbig,
                                  E* __restrict__ dx,
                                  float* __restrict__ part_gb, int nbar,
                                  int d, int n, int bars_per_chunk) {
  using C = Cfg<S>;
  constexpr int N = C::N, SP = C::SP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<C>& sm = *reinterpret_cast<Smem<C>*>(smem_raw);
  const int c0 = blockIdx.x * BC;
  const int chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b_lo = chunk * bars_per_chunk;
  const int b_hi = min(nbar, b_lo + bars_per_chunk);
  const int nstage = n / BK;
  const bool has_bias = c0 < n;  // the tile's columns of dbias

  for (int e = tid; e < S * BC; e += THREADS) {
    const int s = e / BC, q = e % BC;
    sm.gts[s][q] = V::load1(gates + (size_t)s * d + c0 + q);
    sm.dgs[s][q] = 0.f;
  }
  if (tid < BC) sm.dbs[tid] = 0.f;
  // the padding rows of both g stage buffers: zero, never copied into
  if constexpr (SP > S) {
    constexpr int PAD = T * (SP - S);
    for (int e = tid; e < 2 * PAD * 4; e += THREADS) {
      const int b = e / (PAD * 4), r = e % (PAD * 4) / 4, ch = e % 4;
      const int pr = r / (SP - S) * SP + S + r % (SP - S);
      *reinterpret_cast<uint4*>(sm.g[b] + s_off(pr, ch)) =
          make_uint4(0, 0, 0, 0);
    }
  }

  float (*dtr)[BC] = sm.dh[0];
  float (*dself)[BC] = sm.dh[1];
  float (*dcol)[BC] = sm.dh[2];
  float (*dnx)[BC] = sm.dh[3];
  float (*dxs)[BC] = sm.dh[4];

  for (int bar = b_lo; bar < b_hi; ++bar) {
    const E* xb = x + (size_t)bar * N * d;
    const E* gb = g + (size_t)bar * N * n;
    __syncthreads();  // the previous bar's tiles are consumed
    load_stage(sm, 0, gb, wbig, d, n, c0, 0, tid);
    cp_async_commit();
    load_grid_statics<float, N>(sm, aux + (size_t)bar * N_AUX * N, 1, S,
                                tid, THREADS);
    for (int e = tid; e < N * BC; e += THREADS) {
      const int i = e / BC, q = e % BC;
      sm.xs[i][q] = V::load1(xb + (size_t)i * d + c0 + q);
    }

    // ---- 1. dH[seg][:, tile] = gm @ W_blk[tile rows]^T, and dbias ----
    for (int p = 0; p < C::NPASS; ++p) {
      // this warp's m16 tile and its 16-column pairs jp0.. of the tile
      const int unit = p * 8 + warp;
      const int mt = unit / C::SPLIT, jp0 = unit % C::SPLIT * C::NJP;
      const bool active = mt < C::MT;
      const int row0 = mt * 16;
      const int trk = row0 / SP;         // the track of all 16 rows
      float acc[NSEG][2 * C::NJP][4];
#pragma unroll
      for (int s = 0; s < NSEG; ++s)
#pragma unroll
        for (int j = 0; j < 2 * C::NJP; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;

      for (int st = 0; st < nstage; ++st) {
        const int u = p * nstage + st;  // stages of the bar so far
        cp_async_wait_all();
        __syncthreads();  // stage u is in; every warp is done with u - 1
        if (st + 1 < nstage || p + 1 < C::NPASS)
          load_stage(sm, (u + 1) & 1, gb, wbig, d, n, c0,
                     (st + 1) % nstage * BK, tid);
        cp_async_commit();
        if (!active) continue;
        const bf16* ga = sm.g[u & 1];
        const bf16* wa = sm.w[u & 1];
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, ga + s_off(row0 + (lane & 15), 2 * kk + (lane >> 4)));
#pragma unroll
          for (int s = 0; s < NSEG; ++s) {
            const int blk = s == 0 ? trk : T - 1 + s;
#pragma unroll
            for (int jq = 0; jq < C::NJP; ++jq) {
              // n8 tiles 2 jp and 2 jp + 1: k halves 0, 1 of each
              const int jp = jp0 + jq;
              uint32_t b[4];
              ldsm_x4(b, wa + s_off(blk * BC + jp * 16 + (lane & 7)
                                    + ((lane >> 4) << 3),
                                    2 * kk + ((lane >> 3) & 1)));
              mma_bf16(acc[s][2 * jq], a, b[0], b[1]);
              mma_bf16(acc[s][2 * jq + 1], a, b[2], b[3]);
            }
          }
        }
      }
      // accumulator (s, j, e) of lane l: padded row row0 + l / 4 + 8 (e /
      // 2), column 8 (2 jp0 + j) + 2 (l % 4) + e % 2; padding rows dropped
      if (active) {
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int pr = row0 + (lane >> 2) + 8 * hh;
          const int c = pr % SP;
          if (c >= S) continue;
          const int row = pr / SP * S + c;
          const float m = sm.m[row];
#pragma unroll
          for (int s = 0; s < NSEG; ++s)
#pragma unroll
            for (int j = 0; j < 2 * C::NJP; ++j)
              *reinterpret_cast<float2*>(
                  &sm.dh[s][row][8 * (2 * jp0 + j) + 2 * (lane & 3)]) =
                  make_float2(acc[s][j][2 * hh] * m, acc[s][j][2 * hh + 1] * m);
        }
      }
    }
    if (has_bias && tid < BC) {
      float sb = 0.f;
      for (int i = 0; i < N; ++i) sb += V::load1(gb + (size_t)i * n + c0 + tid) * sm.m[i];
      sm.dbs[tid] += sb;
    }
    __syncthreads();

    // ---- 2. the masked mean upstreams of the onset and next relations ----
    for (int e = tid; e < N * BC; e += THREADS) {
      const int i = e / BC, q = e % BC;
      dcol[i][q] = V::rnd(dcol[i][q] * V::rnd(sm.ron[i]));
      dnx[i][q] = V::rnd(dnx[i][q] * V::rnd(sm.rnx[i]));
    }
    __syncthreads();

    // ---- 3. relu masks from the recomputed pre-activations, scatters ----
    for (int e = tid; e < N * BC; e += THREADS) {
      const int i = e / BC, q = e % BC;
      const int c = i % S;
      const float dmsg = dtr[i][q] * V::rnd(sm.rtr[i]);
      if (sm.okp[i] > 0.f) {
        const int src = sm.ps[i], dist = sm.dp[i];
        const float xv = sm.xs[src][q], gv = sm.gts[dist][q];
        if (V::rnd(xv * gv) > 0.f) {
          atomicAdd(&dxs[src][q], V::rnd(dmsg * gv));
          atomicAdd(&sm.dgs[dist][q], V::rnd(dmsg * xv));
        }
      }
      if (sm.okn[i] > 0.f) {
        const int src = sm.ns[i], dist = sm.dn[i];
        const float xv = sm.xs[src][q], gv = sm.gts[dist][q];
        if (V::rnd(xv * gv) > 0.f) {
          atomicAdd(&dxs[src][q], V::rnd(dmsg * gv));
          atomicAdd(&sm.dgs[dist][q], V::rnd(dmsg * xv));
        }
      }
      if (sm.okpn[i] > 0.f) {
        const int src = sm.pn[i], dist = sm.dpn[i];
        const float xv = sm.xs[src][q], gv = sm.gts[dist][q];
        if (V::rnd(xv * gv) > 0.f) {
          const float dz = (dnx[c][q] + dnx[S + c][q] + dnx[2 * S + c][q]
                            + dnx[3 * S + c][q]) - dnx[i][q];
          atomicAdd(&dxs[src][q], V::rnd(dz * gv));
          atomicAdd(&sm.dgs[dist][q], V::rnd(dz * xv));
        }
      }
      const float xv = sm.xs[i][q], g0 = sm.gts[0][q];
      if (sm.m[i] > 0.f && V::rnd(xv * g0) > 0.f) {
        const float dy0 = (dcol[c][q] + dcol[S + c][q] + dcol[2 * S + c][q]
                           + dcol[3 * S + c][q]) - dcol[i][q]
                          + dself[i][q] * sm.single[i];
        atomicAdd(&dxs[i][q], dy0 * g0);
        atomicAdd(&sm.dgs[0][q], dy0 * xv);
      }
    }
    __syncthreads();

    // ---- 4. the dx tile ----
    E* dxb = dx + (size_t)bar * N * d;
    for (int e = tid; e < N * BC; e += THREADS) {
      const int i = e / BC, q = e % BC;
      V::store1(dxb + (size_t)i * d + c0 + q, dxs[i][q]);
    }
  }

  // ---- 5. this CTA's dgate / dbias partial of the chunk ----
  __syncthreads();
  float* pg = part_gb + (size_t)chunk * ((size_t)S * d + n);
  for (int e = tid; e < S * BC; e += THREADS) {
    const int s = e / BC, q = e % BC;
    pg[(size_t)s * d + c0 + q] = sm.dgs[s][q];
  }
  if (has_bias && tid < BC) pg[(size_t)S * d + c0 + tid] = sm.dbs[tid];
}

// ------------------------------------------------------------ the dW kernel

// One bar's inputs of the dW kernel, by cp.async: x in cell rows, g in
// padded rows.
template <class C>
struct DwStage {
  alignas(16) bf16 x[C::N * WR];   // x[:, c tile], rows of 64 bytes
  alignas(16) bf16 g[C::BP * WJ];  // g[:, j tile], rows of 128 bytes, swizzled
  alignas(16) int aux[N_AUX * C::N];
};

// One cell's statics for the rebuild, packed in three 16-byte words; each
// factor as a bf16 pair (both halves equal).
struct DwRow {
  int4 idx;                      // ps, ns, pn, dp | dn << 8 | dpn << 16
  bf162 okp, okn, okpn, m;
  bf162 rtr, ron, rnx, single;   // the reciprocals rounded to bf16
};

template <class C>
struct DwSmem {
  DwRow rows[C::N];              // the statics of the bar being rebuilt
  DwStage<C> st[2];              // bar b in st[b % 2]
  // the A tiles of the bar, k-major in padded rows, swizzled as s_off:
  // h_track, h_self, h_onset, h_next and x * m, the CTA's 32 features each
  alignas(16) bf16 h[NSEG][C::BP * WR];
  alignas(16) bf16 gts[C::S][WR];  // gate_table[:, c tile]
};

static_assert(WR == BK && BK == TILE_K && WJ == TILE_G,
              "the A tiles share s_off with the dH stages, the rows of gcl_dw_bf16.cuh's layouts");

// x[bar][:, c0..c0+31], g[bar][:, j0..j0+63] and aux[bar] by 16-byte
// copies; x rows d wide, g rows n wide.
template <class C>
__device__ __forceinline__ void dw_load_stage(DwStage<C>& st, const bf16* xb,
                                              const bf16* gb, const int* ab,
                                              int d, int n, int c0, int j0,
                                              int tid) {
  for (int c = tid; c < C::N * WR / 8; c += THREADS) {
    const int r = c >> 2, ch = c & 3;
    cp_async16(st.x + r * WR + ch * 8, xb + (size_t)r * d + c0 + ch * 8);
  }
  for (int c = tid; c < C::N * WJ / 8; c += THREADS) {
    const int r = c >> 3, ch = c & 7;
    cp_async16(st.g + g_off(prow<C>(r), ch), gb + (size_t)r * n + j0 + ch * 8);
  }
  for (int c = tid; c < N_AUX * C::N / 4; c += THREADS)
    cp_async16(st.aux + c * 4, ab + c * 4);
}

// The statics of the bar's N cells into sm.rows; the caller synchronises.
template <class C>
__device__ __forceinline__ void dw_decode(DwSmem<C>& sm,
                                          const DwStage<C>& st, int tid) {
  for (int k = tid; k < C::N; k += THREADS) {
    const CellStatics cs = cell_statics_grid(st.aux, k, C::N, C::S);
    DwRow& r = sm.rows[k];
    r.idx = make_int4(cs.ps, cs.ns, cs.pn, cs.dp | cs.dn << 8 | cs.dpn << 16);
    r.okp = __float2bfloat162_rn(cs.okp);
    r.okn = __float2bfloat162_rn(cs.okn);
    r.okpn = __float2bfloat162_rn(cs.okpn);
    r.m = __float2bfloat162_rn(cs.m);
    r.rtr = __float2bfloat162_rn(cs.rtr);
    r.ron = __float2bfloat162_rn(cs.ron);
    r.rnx = __float2bfloat162_rn(cs.rnx);
    r.single = __float2bfloat162_rn(cs.single);
  }
}

// The bar's A tiles into sm.h from its stage and decoded statics: thread
// (step c, 4 columns q..q+3) rebuilds the padded rows of cells c, S + c,
// 2S + c and 3S + c, every rounding as in `gcl_bwd_fused_bf16_tc.cu`.
template <class C>
__device__ __forceinline__ void dw_build(DwSmem<C>& sm, const DwStage<C>& st,
                                         int tid) {
  constexpr int S = C::S;
  for (int it = tid; it < S * WR / 4; it += THREADS) {
    const int c = it >> 3, q = (it & 7) * 4;
    auto ldx = [&](int r) { return ld4(st.x + r * WR + q); };
    auto gate = [&](int s) { return ld4(&sm.gts[s][q]); };
    const H4 g0 = gate(0);
    H4 xk[T], y[T], z[T];
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const DwRow& r = sm.rows[t * S + c];
      xk[t] = ldx(t * S + c);
      y[t] = msg(xk[t], g0, r.m);
      z[t] = msg(ldx(r.idx.z), gate(r.idx.w >> 16), r.okpn);
    }
    const H4 ysum = col_sum(y), zsum = col_sum(z);
#pragma unroll
    for (int t = 0; t < T; ++t) {
      const int k = t * S + c;
      const DwRow& r = sm.rows[k];
      const H4 vp = msg(ldx(r.idx.x), gate(r.idx.w & 255), r.okp);
      const H4 vn = msg(ldx(r.idx.y), gate((r.idx.w >> 8) & 255), r.okn);
      const int o = s_off(t * C::SP + c, q >> 3) + (q & 7);
      st4(sm.h[0] + o, mul(add(vp, vn), r.rtr));        // track
      st4(sm.h[1] + o, mul(y[t], r.single));            // self
      st4(sm.h[2] + o, mul(sub(ysum, y[t]), r.ron));    // onset
      st4(sm.h[3] + o, mul(sub(zsum, z[t]), r.rnx));    // next
      st4(sm.h[4] + o, mul(xk[t], r.m));                // root: x * m
    }
  }
}

// One bar into the warp's sums: dW[blk][c tile, j tile] += A_blk^T @ g for
// track block p (its own SP padded rows) and block T + p (all BP), columns
// jn..jn+31, 16 rows a k-step.
template <class C>
__device__ __forceinline__ void dw_bar(float (&acc)[2][2][4][4],
                                       const DwSmem<C>& sm, const bf16* gt,
                                       int p, int jn, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < C::BP; k0 += 16) {
    uint32_t b[2][4];
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldsm_x4_t(b[np], gt + g_off(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  (jn >> 3) + 2 * np + (lane >> 4)));
    if (k0 / C::SP == p) dw_mma(acc[0], sm.h[0], k0, b, lane);  // own track
    dw_mma(acc[1], sm.h[1 + p], k0, b, lane);
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_dw_grid_bf16_tc_kernel(const E* __restrict__ x,
                               const E* __restrict__ g,
                               const int* __restrict__ aux,
                               const E* __restrict__ gates,
                               float* __restrict__ dwbig, int nbar, int d,
                               int n) {
  using C = Cfg<S>;
  constexpr int N = C::N, SP = C::SP;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DwSmem<C>& sm = *reinterpret_cast<DwSmem<C>*>(smem_raw);
  const int j0 = blockIdx.x * WJ, c0 = blockIdx.y * WR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = warp >> 1;             // track block p and block T + p
  const int jn = (warp & 1) * 32;      // the warp's 32 of the 64 columns
  auto stage = [&](int b) {
    dw_load_stage(sm.st[b % 2], x + (size_t)b * N * d, g + (size_t)b * N * n,
                  aux + (size_t)b * N_AUX * N, d, n, c0, j0, tid);
    cp_async_commit();
  };

  stage(0);
  for (int e = tid; e < S * WR; e += THREADS) {
    const int s = e / WR, q = e % WR;
    sm.gts[s][q] = gates[(size_t)s * d + c0 + q];
  }
  // the padding rows of the A tiles and of both g stages: zero, never
  // written again
  if constexpr (SP > S) {
    constexpr int PAD = T * (SP - S);
    for (int e = tid; e < PAD * (NSEG * 4 + 2 * 8); e += THREADS) {
      const int r = e % PAD, k = e / PAD;
      const int pr = r / (SP - S) * SP + S + r % (SP - S);
      bf16* dst = k < NSEG * 4
                      ? sm.h[k / 4] + s_off(pr, k % 4)
                      : sm.st[(k - NSEG * 4) / 8].g + g_off(pr, (k - NSEG * 4) % 8);
      *reinterpret_cast<uint4*>(dst) = make_uint4(0, 0, 0, 0);
    }
  }
  // [0]: track block p, [1]: block T + p
  float acc[2][2][4][4];
#pragma unroll
  for (int b = 0; b < 2; ++b)
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[b][mt][nt][e] = 0.f;
  cp_async_wait_all();
  __syncthreads();
  if (nbar > 1) stage(1);
  dw_decode(sm, sm.st[0], tid);
  __syncthreads();
  dw_build(sm, sm.st[0], tid);
  __syncthreads();

  // Bar b: its MMAs; then, after a barrier (bar b + 1's stage has landed,
  // no warp still reads the A tiles or bar b's stage), bar b + 2's copies
  // into bar b's stage, bar b + 1's statics and its rebuild.
  for (int bar = 0; bar < nbar; ++bar) {
    dw_bar(acc, sm, sm.st[bar % 2].g, p, jn, lane);
    if (bar + 1 == nbar) break;
    cp_async_wait_all();
    __syncthreads();
    if (bar + 2 < nbar) stage(bar + 2);
    const DwStage<C>& nx = sm.st[(bar + 1) % 2];
    dw_decode(sm, nx, tid);
    __syncthreads();
    dw_build(sm, nx, tid);
    __syncthreads();
  }

  // accumulator (b, mt, nt, e) of lane l: row 16 mt + l / 4 + 8 (e / 2),
  // column jn + 8 nt + 2 (l % 4) + e % 2 of block b ? T + p : p
#pragma unroll
  for (int b = 0; b < 2; ++b) {
    float* out = dwbig + ((size_t)(b ? T + p : p) * d + c0) * n + j0 + jn;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = 16 * mt + (lane >> 2) + 8 * hh;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(out + (size_t)row * n + 8 * nt + 2 * (lane & 3)) =
              make_float2(acc[b][mt][nt][2 * hh], acc[b][mt][nt][2 * hh + 1]);
      }
  }
}

template <int S>
int launch(const void* x, const void* g, const void* aux, const void* gates,
           const void* wbig, void* dx, void* part_gb, void* dwbig,
           void* out_gb, int nbar, int d, int n, int nchunks,
           cudaStream_t st) {
  using C = Cfg<S>;
  static_assert(sizeof(Smem<C>) <= 232448 && sizeof(DwSmem<C>) <= 232448,
                "a CTA's shared memory");
  const long long row = (long long)S * d + n;  // a partial row
  if (nbar <= 0) {
    cudaError_t err = cudaMemsetAsync(dwbig, 0, sizeof(float) * NBLK * d * n, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(out_gb, 0, sizeof(float) * row, st);
  }
  const int bars_per_chunk = (nbar + nchunks - 1) / nchunks;
  const int used = (nbar + bars_per_chunk - 1) / bars_per_chunk;  // none empty
  const int smem = (int)sizeof(Smem<C>), dw_smem = (int)sizeof(DwSmem<C>);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_bwd_fused_grid_bf16_tc_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gcl_bwd_dw_grid_bf16_tc_kernel<S>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return (int)err;
  gcl_bwd_fused_grid_bf16_tc_kernel<S><<<dim3(d / BC, used), THREADS, smem, st>>>(
      (const E*)x, (const E*)g, (const int*)aux, (const E*)gates,
      (const E*)wbig, (E*)dx, (float*)part_gb, nbar, d, n, bars_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sum_rows((const float*)part_gb, (float*)out_gb, used, row, st);
  if (err != cudaSuccess) return (int)err;
  gcl_bwd_dw_grid_bf16_tc_kernel<S><<<dim3(n / WJ, d / WR), THREADS, dw_smem, st>>>(
      (const E*)x, (const E*)g, (const int*)aux, (const E*)gates,
      (float*)dwbig, nbar, d, n);
  return (int)cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory a CTA of the dH kernel (dw = 0) or of the
// dW kernel (dw = 1) takes at S steps a bar (0 for a grid it does not take).
extern "C" int gcl_bwd_fused_grid_bf16_smem_bytes(int S, int dw) {
  switch (S) {
#define GCL_SMEM(s)                                     \
  case s:                                               \
    return dw ? (int)sizeof(DwSmem<Cfg<s>>) : (int)sizeof(Smem<Cfg<s>>);
    GCL_GRID_STEPS(GCL_SMEM)
#undef GCL_SMEM
  }
  return 0;
}

// x (nbar, 4 S, d), g (nbar, 4 S, n); aux (nbar, N_AUX, 4 S); gates (S, d);
// wbig (8d, n), the float tensors in bf16; S a multiple of 4 up to 48 but
// 32. Writes dx (nbar, 4 S, d) in bf16, and dwbig (8d, n) and out_gb =
// [dgate (S, d) | dbias (n)] in fp32, using part_gb (nchunks, S * d + n) as
// fp32 scratch: chunk c of the dH kernel sums bars [c * bpc, (c + 1) *
// bpc), bpc = ceil(nbar / nchunks). d % 128 == 0, n % 128 == 0, d % n == 0.
extern "C" int gcl_bwd_fused_grid_bf16_launch(const void* x, const void* g,
                                              const void* aux,
                                              const void* gates,
                                              const void* wbig, void* dx,
                                              void* part_gb, void* dwbig,
                                              void* out_gb, int nbar, int S,
                                              int d, int n, int nchunks,
                                              void* stream) {
  if (d <= 0 || d % 128 != 0 || n <= 0 || n % 128 != 0 || d % n != 0 ||
      nchunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
#define GCL_LAUNCH(s)                                                   \
  case s:                                                               \
    return launch<s>(x, g, aux, gates, wbig, dx, part_gb, dwbig, out_gb, \
                     nbar, d, n, nchunks, st);
    GCL_GRID_STEPS(GCL_LAUNCH)
#undef GCL_LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}
