// GCL training backward in bf16: dx, d(gate_table), dbias and dWbig, by two
// kernels on the tensor cores.
//
// Replaces, in bf16, the Pallas kernel `_bwd_fused_kernel` of
// polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py:289 (`gcl_backward_fused`,
// its pallas_call at :453), the backward of the bf16 training layer. With
// gm = g * m and the forward `gcl.gcl_fwd` (no epilogue), per bar:
//
//   dH_r  = gm @ W_r^T               (track blocks: each track's 32 rows only)
//   dx    = dH_root + the scatters of `gcl_bwd_data.cu`
//   dgate, dbias as there, summed over every bar
//   dW_r += h_r^T @ gm               (h_root = x; track blocks: own rows)
//
// The weights and g may hold only n of the d output columns (a column shard
// under tensor parallelism, Wbig (8d, n), g (nbar, 128, n)): dH then
// contracts those n columns only, so dx and dgate are this shard's partial
// sums (the M shards' sum is the square launch's), dbias is the shard's n
// columns and dWbig is (8d, n).
//
// x, g, gates, wbig and dx are bf16; every product sums in fp32, and values
// are rounded to bf16 where the Pallas body casts to its compute dtype: the
// elementwise products, the mean reciprocals, the same-column sums, the
// masked-mean upstreams of the onset and next relations, each scatter
// contribution of the gathered relations, the messages h_r, and dx. The
// self/onset path's dx and dgate contributions and every sum stay fp32.
//
// What bounds it on an H100: operations. The JAX kernel's CostEstimate is
// 4 * nbar * 128 * 8d * d flops, 2.75e11 at 256 bars and d = 512: 0.28 ms
// on the dense bf16 tensor cores, 4.1 ms on the CUDA cores at 67 TFLOP/s in
// fp32; its bytes (x, g, dx, Wbig, dWbig) need 0.034 ms.
//
// The dW product reads nothing that the dH product makes (the messages are
// rebuilt from x, the gate table and the bar's statics; gm needs only g and
// m), so the two run as two kernels, each tiled over its own output:
//
// `gcl_bwd_fused_bf16_tc_kernel` (dx, dgate, dbias): one CTA of 8 warps owns
// (a chunk of bars, a 32-column tile c); one CTA per SM. Per bar:
// 1. dH[seg][:, tile] = g @ W_blk[tile rows]^T on the tensor cores
//    (mma.sync m16n8k16, bf16 -> fp32). Warp w owns rows 16w..16w+15 (all in
//    track w / 2) and the 5 segments x 32 columns: 20 n8 tiles, 80 fp32
//    accumulators a thread. Segment 0 takes the warp's own track block,
//    segments 1-4 blocks 4-7. g (128 x 32 features, 8 KB) and the 8 blocks'
//    W rows (8 x 32 x 32 features, 16 KB) come in by cp.async in stages of
//    32 features, double-buffered, XOR-swizzled so that an 8-row ldmatrix
//    touches 8 bank groups. W's rows are already the `.col` layout of B, so
//    neither operand is transposed. g is staged raw; each accumulator row
//    is multiplied by m (0 or 1, exact) where it is stored, in fp32, into
//    the dH tiles that phases 2-4 read. Only the summation order differs
//    from fp32 FMAs: a product of two bf16 values is exact in fp32.
// 2-4. dx, dgate and dbias for the tile's columns as `gcl_bwd_data.cu`
//    computes them (scatters by shared-memory atomics).
// A second launch sums the chunks' dgate/dbias rows in a fixed order.
//
// `gcl_bwd_dw_bf16_tc_kernel` (dWbig): one CTA of 8 warps owns rows
// [c0, c0 + 32) of all 8 blocks x columns [j0, j0 + 64) (128 CTAs at d =
// 512, one wave) and walks every bar in order, its 16,384 fp32 sums in
// registers (64 a thread); each element of dWbig is written once, after the
// last bar, so no partial goes to device memory and the result does not
// depend on the order CTAs run in. Per bar, three bars deep by cp.async:
// x[:, c tile], g[:, j tile] and the bar's aux words. The CTA rebuilds
// h_track, h_self, h_onset, h_next and x * m for its 32 features as bf16
// tiles (rounded where the Pallas body rounds, in bf16x2 arithmetic; each
// value is a bf16 value, so the tiles hold them exactly), then multiplies
// them into the sums with mma.sync, both operands k-major in shared memory
// (ldmatrix .trans). m is folded into the A tiles (the messages are 0 on
// inactive rows, the root tile is x * m), so g is staged raw. Warp w takes
// track block w / 2 (its 32 rows) and block 4 + w / 2 (all 128 rows) for
// columns 32 (w % 2)..+31: 80 MMAs a warp per bar, the same for every warp.
// The A tiles are double-buffered: while some warps multiply bar b, the
// others rebuild bar b + 1 (each warp decodes the statics of the rows it
// rebuilds itself), one barrier a bar.
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

struct Smem : Statics {
  // dH tiles; segment 4 becomes dx
  alignas(16) float dh[NSEG][N][BC];
  float xs[N][BC];               // x[:, tile]
  float gts[S][BC];              // gate_table[:, tile]
  float dgs[S][BC];              // dgate partial of this CTA's chunk
  float dbs[BC];                 // dbias partial of this CTA's chunk
  alignas(16) bf16 g[2][N * BK];          // g[:, stage] [row][k], swizzled
  alignas(16) bf16 w[2][NBLK * BC * BK];  // W[blk*d + c0 + n, stage], swizzled
};

// Features f0..f0+BK of g (128 rows) and of the W rows of this CTA's
// columns in all 8 blocks (rows n wide): 2 + 4 16-byte copies a thread.
__device__ __forceinline__ void load_stage(Smem& sm, int buf, const bf16* gb,
                                           const bf16* wbig, int d, int n,
                                           int c0, int f0, int tid) {
#pragma unroll
  for (int j = 0; j < N * BK / 8 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int r = c >> 2, ch = c & 3;
    cp_async16(sm.g[buf] + s_off(r, ch), gb + (size_t)r * n + f0 + ch * 8);
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

__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_fused_bf16_tc_kernel(const E* __restrict__ x, const E* __restrict__ g,
                             const int* __restrict__ aux,
                             const E* __restrict__ gates,
                             const E* __restrict__ wbig, E* __restrict__ dx,
                             float* __restrict__ part_gb, int nbar, int d,
                             int n, int bars_per_chunk) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
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
    load_statics(sm, aux + (size_t)bar * N_AUX * N, tid, THREADS);
    for (int e = tid; e < N * BC; e += THREADS) {
      const int i = e / BC, q = e % BC;
      sm.xs[i][q] = V::load1(xb + (size_t)i * d + c0 + q);
    }

    // ---- 1. dH[seg][:, tile] = gm @ W_blk[tile rows]^T, and dbias ----
    {
      const int row0 = warp * 16;
      const int trk = row0 / S;          // the track of all 16 rows
      float acc[NSEG][4][4];
#pragma unroll
      for (int s = 0; s < NSEG; ++s)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[s][j][e] = 0.f;

      for (int st = 0; st < nstage; ++st) {
        cp_async_wait_all();
        __syncthreads();  // stage st is in; every warp is done with st - 1
        if (st + 1 < nstage)
          load_stage(sm, (st + 1) & 1, gb, wbig, d, n, c0, (st + 1) * BK, tid);
        cp_async_commit();
        const bf16* ga = sm.g[st & 1];
        const bf16* wa = sm.w[st & 1];
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
      // accumulator (s, j, e) of lane l: row row0 + l / 4 + 8 (e / 2),
      // column 8 j + 2 (l % 4) + e % 2
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int row = row0 + (lane >> 2) + 8 * hh;
        const float m = sm.m[row];
#pragma unroll
        for (int s = 0; s < NSEG; ++s)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            *reinterpret_cast<float2*>(&sm.dh[s][row][8 * j + 2 * (lane & 3)]) =
                make_float2(acc[s][j][2 * hh] * m, acc[s][j][2 * hh + 1] * m);
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

// One bar's inputs of the dW kernel, by cp.async.
struct DwStage {
  alignas(16) bf16 x[N * WR];    // x[:, c tile], rows of 64 bytes
  alignas(16) bf16 g[N * WJ];    // g[:, j tile], rows of 128 bytes, swizzled
  alignas(16) int aux[N_AUX * N];
};

static_assert(WR == BK && BK == TILE_K && WJ == TILE_G,
              "the stage, A and g tiles take gcl_dw_bf16.cuh's layouts");

// One cell's statics for the rebuild, packed in three 16-byte words; each
// factor as a bf16 pair (both halves equal).
struct DwRow {
  int4 idx;                      // ps, ns, pn, dp | dn << 8 | dpn << 16
  bf162 okp, okn, okpn, m;
  bf162 rtr, ron, rnx, single;   // the reciprocals rounded to bf16
};

constexpr int NSTAGE = 3;        // dW kernel: bars in shared memory at once

struct DwSmem {
  DwRow rows[N];                 // the statics of the bar being rebuilt
  DwStage st[NSTAGE];            // bar b in st[b % 3]
  // the A tiles of bar b in h[b % 2], k-major, swizzled as s_off: h_track,
  // h_self, h_onset, h_next and x * m, each 128 cells x the CTA's 32
  // features
  alignas(16) bf16 h[2][NSEG][N * WR];
  alignas(16) bf16 gts[S][WR];   // gate_table[:, c tile]
};

// x[bar][:, c0..c0+31], g[bar][:, j0..j0+63] and aux[bar]: 2 + 4 + 1.75
// 16-byte copies a thread; x rows d wide, g rows n wide.
__device__ __forceinline__ void dw_load_stage(DwStage& st, const bf16* xb,
                                              const bf16* gb, const int* ab,
                                              int d, int n, int c0, int j0,
                                              int tid) {
#pragma unroll
  for (int j = 0; j < N * WR / 8 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int r = c >> 2, ch = c & 3;
    cp_async16(st.x + r * WR + ch * 8, xb + (size_t)r * d + c0 + ch * 8);
  }
#pragma unroll
  for (int j = 0; j < N * WJ / 8 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int r = c >> 3, ch = c & 7;
    cp_async16(st.g + g_off(r, ch), gb + (size_t)r * n + j0 + ch * 8);
  }
  for (int c = tid; c < N_AUX * N / 4; c += THREADS)
    cp_async16(st.aux + c * 4, ab + c * 4);
}

// Bar b's A tiles into h, for the rows of this warp's 4 c (4 w..4 w + 3, in
// each track): the warp decodes those 16 cells' statics into sm.rows, then
// thread (c, 4 columns q..q+3) rebuilds rows c, S + c, 2S + c and 3S + c as
// phase 5 of the single-kernel form does, every rounding in place. Only
// this warp reads the rows it writes, so no CTA barrier is needed.
__device__ __forceinline__ void dw_build(DwSmem& sm, const DwStage& st,
                                         bf16 (*h)[N * WR], int tid) {
  const int lane = tid & 31, warp = tid >> 5;
  if (lane < 16) {
    const int k = (lane >> 2) * S + 4 * warp + (lane & 3);
    const CellStatics cs = cell_statics(st.aux, k);
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
  __syncwarp();
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
      const int o = s_off(k, q >> 3) + (q & 7);
      st4(h[0] + o, mul(add(vp, vn), r.rtr));        // track
      st4(h[1] + o, mul(y[t], r.single));            // self
      st4(h[2] + o, mul(sub(ysum, y[t]), r.ron));    // onset
      st4(h[3] + o, mul(sub(zsum, z[t]), r.rnx));    // next
      st4(h[4] + o, mul(xk[t], r.m));                // root: x * m
    }
  }
}

// One bar into the warp's sums: dW[blk][c tile, j tile] += A_blk^T @ g for
// track block p (its own 32 rows) and block T + p (all 128), columns
// jn..jn+31, 16 cells a k-step.
__device__ __forceinline__ void dw_bar(float (&acc)[2][2][4][4],
                                       bf16 (*h)[N * WR], const bf16* gt,
                                       int p, int jn, int lane) {
#pragma unroll
  for (int k0 = 0; k0 < N; k0 += 16) {
    // matrices: (k 0-7, j 0-7), (k 8-15, j 0-7), (k 0-7, j 8-15), (k 8-15,
    // j 8-15) of each 16 columns, transposed: b0, b1 of two n8 tiles
    uint32_t b[2][4];
#pragma unroll
    for (int np = 0; np < 2; ++np)
      ldsm_x4_t(b[np], gt + g_off(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                                  (jn >> 3) + 2 * np + (lane >> 4)));
    if (k0 / S == p) dw_mma(acc[0], h[0], k0, b, lane);  // own track rows
    dw_mma(acc[1], h[1 + p], k0, b, lane);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_dw_bf16_tc_kernel(const E* __restrict__ x, const E* __restrict__ g,
                          const int* __restrict__ aux,
                          const E* __restrict__ gates,
                          float* __restrict__ dwbig, int nbar, int d,
                          int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DwSmem& sm = *reinterpret_cast<DwSmem*>(smem_raw);
  const int j0 = blockIdx.x * WJ, c0 = blockIdx.y * WR;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int p = warp >> 1;             // track block p and block T + p
  const int jn = (warp & 1) * 32;      // the warp's 32 of the 64 columns
  auto stage = [&](int b) {
    dw_load_stage(sm.st[b % NSTAGE], x + (size_t)b * N * d,
                  g + (size_t)b * N * n, aux + (size_t)b * N_AUX * N, d, n,
                  c0, j0, tid);
    cp_async_commit();
  };

  stage(0);
  if (nbar > 1) stage(1);
  for (int e = tid; e < S * WR; e += THREADS) {
    const int s = e / WR, q = e % WR;
    sm.gts[s][q] = gates[(size_t)s * d + c0 + q];
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
  dw_build(sm, sm.st[0], sm.h[0], tid);

  // Bar b: its MMAs and the rebuild of bar b + 1, the two in either order
  // by warp parity so the tensor cores work while other warps rebuild; one
  // barrier a bar, after which bar b + 1's tiles are whole, its stage has
  // landed and no warp still reads the buffers that bar b + 2 takes.
  for (int bar = 0; bar < nbar; ++bar) {
    cp_async_wait_all();
    __syncthreads();
    if (bar + 2 < nbar) stage(bar + 2);
    const bool next = bar + 1 < nbar;
    const bf16* gt = sm.st[bar % NSTAGE].g;
    if (warp & 1) dw_bar(acc, sm.h[bar & 1], gt, p, jn, lane);
    if (next) dw_build(sm, sm.st[(bar + 1) % NSTAGE], sm.h[(bar + 1) & 1], tid);
    if (!(warp & 1)) dw_bar(acc, sm.h[bar & 1], gt, p, jn, lane);
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

}  // namespace

// x (nbar, N, d), g (nbar, N, n); aux (nbar, N_AUX, N); gates (S, d); wbig
// (8d, n), the float tensors in bf16. Writes dx (nbar, N, d) in bf16, and
// dwbig (8d, n) and out_gb = [dgate (S, d) | dbias (n)] in fp32, using
// part_gb (nchunks, S * d + n) as fp32 scratch: chunk c of the dH kernel
// sums bars [c * bpc, (c + 1) * bpc), bpc = ceil(nbar / nchunks). d % 128
// == 0, n % 128 == 0, d % n == 0.
extern "C" int gcl_bwd_fused_bf16_launch(const void* x, const void* g,
                                         const void* aux, const void* gates,
                                         const void* wbig, void* dx,
                                         void* part_gb, void* dwbig,
                                         void* out_gb, int nbar, int d, int n,
                                         int nchunks, void* stream) {
  if (d <= 0 || d % 128 != 0 || n <= 0 || n % 128 != 0 || d % n != 0 ||
      nchunks < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long row = (long long)S * d + n;  // a partial row
  if (nbar <= 0) {
    cudaError_t err = cudaMemsetAsync(dwbig, 0, sizeof(float) * NBLK * d * n, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaMemsetAsync(out_gb, 0, sizeof(float) * row, st);
  }
  const int bars_per_chunk = (nbar + nchunks - 1) / nchunks;
  const int used = (nbar + bars_per_chunk - 1) / bars_per_chunk;  // none empty
  const int smem = (int)sizeof(Smem), dw_smem = (int)sizeof(DwSmem);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_bwd_fused_bf16_tc_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(gcl_bwd_dw_bf16_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, dw_smem);
  if (err != cudaSuccess) return (int)err;
  gcl_bwd_fused_bf16_tc_kernel<<<dim3(d / BC, used), THREADS, smem, st>>>(
      (const E*)x, (const E*)g, (const int*)aux, (const E*)gates,
      (const E*)wbig, (E*)dx, (float*)part_gb, nbar, d, n, bars_per_chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = sum_rows((const float*)part_gb, (float*)out_gb, used, row, st);
  if (err != cudaSuccess) return (int)err;
  gcl_bwd_dw_bf16_tc_kernel<<<dim3(n / WJ, d / WR), THREADS, dw_smem, st>>>(
      (const E*)x, (const E*)g, (const int*)aux, (const E*)gates,
      (float*)dwbig, nbar, d, n);
  return (int)cudaGetLastError();
}
