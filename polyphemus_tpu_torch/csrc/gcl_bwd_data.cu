// GCL training backward, data half: dx, d(gate_table) and dbias, fp32.
//
// Replaces the Pallas kernel `_bwd_data_kernel` of
// polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py (kernel A of
// `gcl_backward_pallas`, its pallas_call at :528, called by the custom VJP
// `gcl_fused`). With gm = g * m and the forward `gcl.gcl_fwd` (no
// epilogue), per bar:
//
//   dH_r     = gm @ W_r^T            (track blocks: each track's 32 rows only)
//   dx       = dH_root
//            + scatter of relu'(pre) * dmsg * gate over the track sources
//            + scatter of relu'(pre) * dz * gate over the NEXT sources
//            + relu'(x * g0) * dy0 * g0
//   dgate[s] = sum of relu'(pre) * upstream * x[src] over the cells at
//              distance s (dy0 * x for s = 0), summed over every bar
//   dbias    = sum of gm over every cell of every bar
//
// where dmsg = dH_track * r_track, dz = colsum(dH_next * r_next) - itself,
// dy0 = colsum(dH_onset * r_onset) - itself + dH_self * single.
//
// The weights and g may hold only n of the d output columns (a column shard
// under tensor parallelism, Wbig (8d, n), g (nbar, 128, n)): the products
// then contract those n columns only, so dx and dgate are this shard's
// partial sums (the M shards' sum is the square launch's), and dbias is the
// shard's n columns.
//
// What bounds it on an H100: operations, the product (2 * 128 * 5d * d
// flops per bar, 335 MFLOP at d = 512) in fp32 FFMA on the CUDA cores: fp32
// keeps fp32 rounding, so no tensor core multiplies here.
//
// Design: the product is the only step that mixes feature columns;
// everything after it is elementwise in the column. So a CTA of 8 warps
// owns a 32-column tile (a bar's 128 x d state would not fit in shared
// memory, a tile does) and walks the bars chunk, chunk + nchunks, ... in
// order, one CTA per SM (nchunks = SMs / column tiles: 128 CTAs at d =
// 512). Per bar:
// 1. dH[seg][:, tile] = g @ W_blk[tile rows]^T over the n contracted
//    features, in stages of 32: g (128 x 32) and the tile's W rows in all 8
//    blocks (8 x 32 x 32) come in by one TMA box each, swizzled in 128-byte
//    rows, into two stage buffers that complete on mbarriers; one barrier
//    a stage. The stages run on from one bar into the next, so the next
//    bar's first stage lands while this bar scatters; x[:, tile] and the
//    bar's aux words come in by cp.async with its first stage. A bar's
//    stages start after the tile's own features, so its last stage holds
//    g[:, tile] and dbias sums from it (the tiles c0 < n, the columns of
//    dbias). A thread holds 8 rows (all in one
//    track) x 2 columns of the 5 segments: 80 sums, 320 FFMAs for 18 float4
//    reads of shared memory. Segment 0 takes the warp's own track block,
//    segments 1-4 blocks 4-7.
// 2. g is staged raw: each row of sums is multiplied by m (0 or 1, exact)
//    where it is stored, and by its upstream's factor, so the tiles hold
//    dmsg, dH_self * single, dH_onset * r_onset, dH_next * r_next and
//    dH_root.
// 3. The scatters as gathers: among the cells whose share is not 0, each
//    cell is the source of at most one cell through each relation (the
//    previous and next active cell of a track, the same track at the
//    previous active column: `build_kernel_aux`), so the statics' decode
//    inverts the three maps and the thread of (cell j, column q) sums dx[j]
//    itself: dH_root, the shares of the cells that read j, its own onset
//    and self share, in that order, stored straight to device memory. No
//    atomics: a thread adds its dgate shares into its own column of its
//    warp's dgate tile (in the stage buffer that is free while the bar
//    scatters), and the 8 warps' tiles are added into the CTA's in order.
// After its last bar the CTA writes one dgate/dbias partial row, and a
// second launch sums the rows in a fixed order: every output is bitwise
// repeatable.
#include <cuda.h>

#include "gcl_common.cuh"
#include "mma_bf16.cuh"  // cp.async helpers

namespace {

using namespace gcl;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::smem_u32;

constexpr int BC = 32;           // feature columns per CTA
constexpr int BK = 32;           // contracted features a stage
constexpr int NSEG = 5;          // dH segments: track, self, onset, next, root
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;

// Features f0..f0+31 of g (128 rows) and of the tile's W rows in all 8
// blocks (row blk * BC + n): rows of 128 bytes, the TMA's 128-byte swizzle.
struct alignas(1024) Stage {
  float g[N * BK];
  float w[NBLK * BC * BK];
};

// The statics of one bar that the kernel reads: the factors of the
// upstream tiles, and the three relations inverted: src[r][j] = i | dist
// << 8 for the cell i that reads cell j through relation r (previous and
// next active cell of the track, the track's cell at the previous active
// column) and whose share is not 0, or -1.
struct Cells {
  float m[N], rtr[N], single[N], ron[N], rnx[N];
  int src[3][N];
};

struct Smem {
  Stage st[2];                       // stage u in st[u % 2]
  // the upstream tiles: dmsg, dself * single, dcol, dnx, dH_root
  alignas(16) float up[NSEG][N][BC];
  alignas(16) float xs[N][BC];       // x[bar][:, tile]
  alignas(16) int aux[N_AUX * N];    // aux[bar]
  Cells cells;
  float gts[S][BC];                  // gate_table[:, tile]
  float dgs[S][BC];                  // dgate partial of this CTA
  float dbs[NWARP][BC];              // dbias partials of the warps
  unsigned long long full[2];        // stage buffer b has landed
};

// the warps' dgate tiles of one bar, in the free stage buffer
static_assert(sizeof(float) * NWARP * S * BC <= sizeof(Stage),
              "the warps' dgate tiles fit in a stage");

// Float offset of chunk ch (16 bytes) of row r of a stage buffer, as the
// TMA's 128-byte swizzle stores it (the buffer 1024-byte aligned).
__device__ __forceinline__ int sw_off(int r, int ch) {
  return r * BK + ((ch ^ (r & 7)) << 2);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

// One arrival that also expects `bytes` of copies to complete on bar.
__device__ __forceinline__ void mbar_expect(unsigned long long* bar,
                                            unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra LAB_WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)), "r"(parity) : "memory");
}

// The box at (c0, c1) of a 2-d tensor map into dst, completing on bar.
__device__ __forceinline__ void load_2d(void* dst, const CUtensorMap* map,
                                        int c0, int c1,
                                        unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<unsigned long long>(map)),
        "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// The box at (c0, c1, c2) of a 3-d tensor map into dst, completing on bar.
__device__ __forceinline__ void load_3d(void* dst, const CUtensorMap* map,
                                        int c0, int c1, int c2,
                                        unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<unsigned long long>(map)),
        "r"(c0), "r"(c1), "r"(c2), "r"(smem_u32(bar))
      : "memory");
}

// Stage buffer b: features f0..f0+31 of g[bar] and of the tile's W rows,
// one TMA box each; thread 0 starts it.
__device__ __forceinline__ void load_stage(Smem& sm, int b,
                                           const CUtensorMap* gmap,
                                           const CUtensorMap* wmap, int bar,
                                           int c0, int f0) {
  mbar_expect(&sm.full[b], sizeof(Stage));
  load_2d(sm.st[b].g, gmap, f0, bar * N, &sm.full[b]);
  load_3d(sm.st[b].w, wmap, f0, c0, 0, &sm.full[b]);
}

// x[bar][:, tile] and aux[bar]: 4 + 1.75 16-byte copies a thread.
__device__ __forceinline__ void load_bar(Smem& sm, const float* xb,
                                         const int* ab, int d, int c0,
                                         int tid) {
#pragma unroll
  for (int j = 0; j < N * BC / 4 / THREADS; ++j) {
    const int c = tid + j * THREADS;
    const int r = c / (BC / 4), q = (c % (BC / 4)) * 4;
    cp_async16(&sm.xs[r][q], xb + (size_t)r * d + c0 + q);
  }
  for (int c = tid; c < N_AUX * N / 4; c += THREADS)
    cp_async16(sm.aux + c * 4, ab + c * 4);
}

// One stage into this thread's sums: rows r0 + 4 r (r < 8, track trk),
// columns cg and cg + 16 of every segment. The 8 lanes that read at once
// take rows (columns) in distinct 16-byte bank groups.
__device__ __forceinline__ void stage_ffma(float (&acc)[NSEG][8][2],
                                           const Stage& s, int trk, int r0,
                                           int cg) {
#pragma unroll 4
  for (int kc = 0; kc < BK / 4; ++kc) {
    float4 a[8];
#pragma unroll
    for (int r = 0; r < 8; ++r) a[r] = ld4(s.g + sw_off(r0 + 4 * r, kc));
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      const int row = (sg == 0 ? trk : T - 1 + sg) * BC + cg;
      const float4 b[2] = {ld4(s.w + sw_off(row, kc)),
                           ld4(s.w + sw_off(row + 16, kc))};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float v = acc[sg][r][c];
          v = fmaf(a[r].x, b[c].x, v);
          v = fmaf(a[r].y, b[c].y, v);
          v = fmaf(a[r].z, b[c].z, v);
          acc[sg][r][c] = fmaf(a[r].w, b[c].w, v);
        }
    }
  }
}

// Cell i's statics from the bar's aux words; src[*][*] must be -1 before.
__device__ __forceinline__ void decode_cell(Cells& cl, const int* a, int i) {
  const CellStatics c = cell_statics(a, i);
  cl.m[i] = c.m;
  cl.rtr[i] = c.rtr;
  cl.single[i] = c.single;
  cl.ron[i] = c.ron;
  cl.rnx[i] = c.rnx;
  // an inactive cell's track shares are 0 (r_track carries m), and so are
  // the next-relation shares of a column without an active cell
  if (c.m > 0.f && c.okp > 0.f) cl.src[0][c.ps] = i | c.dp << 8;
  if (c.m > 0.f && c.okn > 0.f) cl.src[1][c.ns] = i | c.dn << 8;
  if (c.okpn > 0.f && a[CNT_ON * N + i] + (c.m > 0.f) > 0)
    cl.src[2][c.pn] = i | c.dpn << 8;
}

// What cell j, column q takes from the bar: dx[j] (dH_root, the shares of
// the cells that read j, relu'(pre) by the recomputed pre-activation
// x[j] * gate[dist], then j's onset and self share) and up to 4 dgate
// shares, share[k] at distance dist[k] (-1: none).
struct Taken {
  float dx, share[4];
  int dist[4];
};

__device__ __forceinline__ Taken take(const Smem& sm, int j, int q,
                                      float g0) {
  const Cells& cl = sm.cells;
  const float (*dnx)[BC] = sm.up[3];
  const float (*dcol)[BC] = sm.up[2];
  const float xv = sm.xs[j][q];
  Taken t;
  t.dx = sm.up[4][j][q];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    t.dist[r] = -1;
    const int e = cl.src[r][j];
    if (e < 0) continue;
    const int i = e & 255, dist = e >> 8;
    const float gv = sm.gts[dist][q];
    if (!(xv * gv > 0.f)) continue;
    const int c = i % S;
    const float u = r < 2 ? sm.up[0][i][q]
                          : (dnx[c][q] + dnx[S + c][q] + dnx[2 * S + c][q]
                             + dnx[3 * S + c][q]) - dnx[i][q];
    t.dx += u * gv;
    t.share[r] = u * xv;
    t.dist[r] = dist;
  }
  t.dist[3] = -1;
  if (cl.m[j] > 0.f && xv * g0 > 0.f) {
    const int c = j % S;
    const float dy0 = (dcol[c][q] + dcol[S + c][q] + dcol[2 * S + c][q]
                       + dcol[3 * S + c][q]) - dcol[j][q] + sm.up[1][j][q];
    t.dx += dy0 * g0;
    t.share[3] = dy0 * xv;
    t.dist[3] = 0;
  }
  return t;
}

__device__ __forceinline__ void add_shares(float (*dg)[BC], const Taken& t,
                                           int q) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (t.dist[k] >= 0) dg[t.dist[k]][q] += t.share[k];
}

// The bar's dx rows of the tile, cells j = warp, warp + 8, ... at column q
// = lane, and their dgate shares into column q of the warp's tile dg.
__device__ __forceinline__ void gather_bar(const Smem& sm, float (*dg)[BC],
                                           float* dxb, int d, int c0,
                                           int warp, int q) {
  const float g0 = sm.gts[0][q];
  for (int j = warp; j < N; j += NWARP) {
    const Taken t = take(sm, j, q, g0);
    dxb[(size_t)j * d + c0 + q] = t.dx;
    add_shares(dg, t, q);
  }
}

__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_data_kernel(const float* __restrict__ x, const int* __restrict__ aux,
                    const float* __restrict__ gates, float* __restrict__ dx,
                    float* __restrict__ part, int nbar, int d, int n,
                    int nchunks,
                    const __grid_constant__ CUtensorMap gmap,
                    const __grid_constant__ CUtensorMap wmap) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);
  Cells& cl = sm.cells;
  const int c0 = blockIdx.x * BC, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int trk = warp >> 1;                    // the track of the rows
  const int r0 = trk * S + (lane >> 3);         // rows r0 + 4 r
  const int cg = (warp & 1) * 8 + (lane & 7);   // columns cg, cg + 16
  const int nstage = n / BK;
  const bool has_bias = c0 < n;  // the tile's columns of dbias
  const size_t bar_size = (size_t)N * d;
  // the features of stage st of a bar: the tile's own come last
  auto feat = [&](int st) { return (c0 / BK + 1 + st) % nstage * BK; };

  if (tid == 0) {
    // the swizzle of sw_off needs 1024-byte aligned stage buffers
    if (smem_u32(smem_raw) & 1023) __trap();
    mbar_init(&sm.full[0]);
    mbar_init(&sm.full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = tid; e < S * BC; e += THREADS) {
    sm.gts[e / BC][e % BC] = gates[(size_t)(e / BC) * d + c0 + e % BC];
    sm.dgs[e / BC][e % BC] = 0.f;
  }
  __syncthreads();
  if (tid == 0 && chunk < nbar)
    load_stage(sm, 0, &gmap, &wmap, chunk, c0, feat(0));
  float acc[NSEG][8][2];
#pragma unroll
  for (int sg = 0; sg < NSEG; ++sg)
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[sg][r][0] = acc[sg][r][1] = 0.f;
  float db = 0.f;  // dbias of column `lane`, rows 16 warp..16 warp + 15

  unsigned u = 0;  // stages multiplied so far
  for (int bar = chunk; bar < nbar; bar += nchunks) {
    for (int st = 0; st < nstage; ++st, ++u) {
      if (st == 1) cp_async_wait_all();  // the bar's x tile and aux words
      // no warp still reads the buffer that stage u + 1 takes (nor, at st
      // 0, the previous bar's tiles and statics)
      __syncthreads();
      // the next stage: this bar's, or the first of the CTA's next bar
      if (tid == 0 && (st + 1 < nstage || bar + nchunks < nbar))
        load_stage(sm, (u + 1) & 1, &gmap, &wmap,
                   st + 1 < nstage ? bar : bar + nchunks, c0, feat(st + 1));
      if (st == 0) {
        load_bar(sm, x + bar * bar_size, aux + (size_t)bar * N_AUX * N, d,
                 c0, tid);
        cp_async_commit();
        if (tid < N) cl.src[0][tid] = cl.src[1][tid] = cl.src[2][tid] = -1;
      }
      if (st == 1 && tid < N) decode_cell(cl, sm.aux, tid);
      mbar_wait(&sm.full[u & 1], (u >> 1) & 1);  // stage u has landed
      stage_ffma(acc, sm.st[u & 1], trk, r0, cg);
    }

    // dbias from the last stage, g[bar][:, tile]
    if (has_bias) {
      const float* gl = sm.st[(u - 1) & 1].g;
#pragma unroll
      for (int i = 0; i < N / NWARP; ++i) {
        const int row = warp * (N / NWARP) + i;
        db += gl[sw_off(row, lane >> 2) + (lane & 3)] * cl.m[row];
      }
    }
    // the upstream tiles
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int row = r0 + 4 * r;
      const float m = cl.m[row];
      const float f[NSEG] = {cl.rtr[row], cl.single[row], cl.ron[row],
                             cl.rnx[row], 1.f};
#pragma unroll
      for (int sg = 0; sg < NSEG; ++sg) {
        sm.up[sg][row][cg] = acc[sg][r][0] * m * f[sg];
        sm.up[sg][row][cg + 16] = acc[sg][r][1] * m * f[sg];
        acc[sg][r][0] = acc[sg][r][1] = 0.f;
      }
    }
    __syncthreads();
    // the last stage is read: its buffer takes the warps' dgate tiles
    float (*dgw)[S][BC] = reinterpret_cast<float (*)[S][BC]>(
        &sm.st[(u - 1) & 1]);
#pragma unroll
    for (int s = 0; s < S; ++s) dgw[warp][s][lane] = 0.f;
    gather_bar(sm, dgw[warp], dx + bar * bar_size, d, c0, warp, lane);
    __syncthreads();
    for (int e = tid; e < S * BC; e += THREADS) {
      float v = sm.dgs[e / BC][e % BC];
#pragma unroll
      for (int w = 0; w < NWARP; ++w) v += dgw[w][e / BC][e % BC];
      sm.dgs[e / BC][e % BC] = v;
    }
    // the buffer takes a TMA copy again after the next barrier: order
    // these generic writes before it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }

  // this CTA's dgate / dbias partial row
  sm.dbs[warp][lane] = db;
  __syncthreads();
  float* pb = part + (size_t)chunk * ((size_t)S * d + n);
  for (int e = tid; e < S * BC; e += THREADS)
    pb[(size_t)(e / BC) * d + c0 + e % BC] = sm.dgs[e / BC][e % BC];
  if (has_bias && tid < BC) {
    float sb = 0.f;
    for (int w = 0; w < NWARP; ++w) sb += sm.dbs[w][tid];
    pb[(size_t)S * d + c0 + tid] = sb;
  }
}

}  // namespace

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  // the encode needs a current context, which a thread that has made no
  // CUDA call yet lacks (the autograd engine's at its first op: the encode
  // then fails with CUDA_ERROR_INVALID_CONTEXT); cudaSetDevice makes the
  // device's primary context current
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || cudaSetDevice(dev) != cudaSuccess)
    return nullptr;
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A rank-dimensional fp32 tensor at base, dims[0] the contiguous one,
// strides[i] the bytes between steps of dimension i + 1, read in boxes of
// box[0..rank-1] elements with the TMA's 128-byte swizzle.
static bool fp32_map(CUtensorMap* map, const void* base, int rank,
                     const cuuint64_t* dims, const cuuint64_t* strides,
                     const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t estr[3] = {1, 1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Bytes of dynamic shared memory a CTA of the kernel takes.
extern "C" int gcl_bwd_data_smem_bytes() { return (int)sizeof(Smem); }

// x (nbar, N, d), g (nbar, N, n); aux (nbar, N_AUX, N); gates (S, d); wbig
// (8d, n); all 16-byte aligned, d % 128 == 0, n % 128 == 0, d % n == 0.
// Writes dx (nbar, N, d) and out = [dgate (S, d) | dbias (n)], using the
// first min(nbar, SMs / (d / 32)) rows of part (nbar, S * d + n) as scratch
// for the per-CTA partials.
extern "C" int gcl_bwd_data_launch(const void* x, const void* g,
                                   const void* aux, const void* gates,
                                   const void* wbig, void* dx, void* part,
                                   void* out, int nbar, int d, int n,
                                   void* stream) {
  if (d <= 0 || d % 128 != 0 || n <= 0 || n % 128 != 0 || d % n != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long row = (long long)S * d + n;  // a partial row
  if (nbar <= 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * row, st);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_bwd_data_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)sizeof(Smem));
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  // g as (nbar N rows, n features) in boxes of [N][BK]; wbig as [8 blocks]
  // [d rows][n features] in boxes of [8][BC][BK]
  CUtensorMap gmap, wmap;
  const cuuint64_t gdims[2] = {(cuuint64_t)n, (cuuint64_t)nbar * N};
  const cuuint64_t gstrides[1] = {(cuuint64_t)n * 4};
  const cuuint32_t gbox[2] = {BK, N};
  const cuuint64_t wdims[3] = {(cuuint64_t)n, (cuuint64_t)d, NBLK};
  const cuuint64_t wstrides[2] = {(cuuint64_t)n * 4, (cuuint64_t)d * n * 4};
  const cuuint32_t wbox[3] = {BK, BC, NBLK};
  if (!fp32_map(&gmap, g, 2, gdims, gstrides, gbox) ||
      !fp32_map(&wmap, wbig, 3, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const int tiles = d / BC;
  const int nchunks = max(1, min(nbar, sms / tiles));
  gcl_bwd_data_kernel<<<dim3(tiles, nchunks), THREADS, sizeof(Smem), st>>>(
      (const float*)x, (const int*)aux, (const float*)gates, (float*)dx,
      (float*)part, nbar, d, n, nchunks, gmap, wmap);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sum_rows((const float*)part, (float*)out, nchunks, row, st);
}
