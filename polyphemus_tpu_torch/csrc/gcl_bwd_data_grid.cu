// GCL training backward, data half, fp32, for bars of 4 x S cells at any S
// that is a multiple of 4 up to 48 but 32 (resolutions 1-12 but 8): dx,
// d(gate_table) (S, d) and dbias. At S = 32 the port launches
// `gcl_bwd_data.cu`; this source takes the other grids.
//
// Replaces, in fp32 and at those grids, the Pallas kernel `_bwd_data_kernel`
// of polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py (kernel A of
// `gcl_backward_pallas`, its pallas_call at :528, called by the custom VJP
// `gcl_fused`), which takes the steps a bar as `n_steps` (:91-95). It
// computes what `gcl_bwd_data.cu` computes, per bar of N = 4 S cells:
//
//   dH_r     = gm @ W_r^T            (track blocks: each track's S rows only)
//   dx       = dH_root + the scatters of the track and next relations
//            + relu'(x * g0) * dy0 * g0
//   dgate[s] = sum of relu'(pre) * upstream * x[src] at distance s
//   dbias    = sum of gm over every cell of every bar
//
// with the column-shard form (Wbig (8d, n), g (nbar, N, n): dx and dgate
// partial over the n columns) as there.
//
// What bounds it on an H100: operations, the product (2 N 5d d flops a bar:
// 126 MFLOP at S = 12, 503 MFLOP at S = 48, d = 512) in fp32 FFMA on the
// CUDA cores.
//
// Design: `gcl_bwd_data.cu`'s, templated on S (a CTA owns a column tile and
// walks the bars chunk, chunk + nchunks, ...; g and the tile's W rows of the
// 8 blocks by one TMA box each, 128-byte swizzle, two stages on mbarriers
// running on from bar to bar; the scatters as gathers over the relations
// inverted at the statics' decode, no atomics; dgate through per-warp tiles
// in the free stage buffer; bitwise repeatable). What changes with S:
// - A thread holds S / 4 rows of its warp pair's track (rows r0 + 4 r), so
//   its rows lie in one track at every S and no track row is padded. Its
//   product takes 5 x S / 4 x CPT sums (CPT columns).
// - The bar's tiles grow with N: up to S = 32 the tile is BC = 32 columns
//   (CPT = 2, as at S = 32: 198 KB of shared memory at S = 28), above it 16
//   (CPT = 1: 32 KB of W rows a stage pair instead of 64, the upstream
//   tiles and x half as wide; 176 KB at S = 48 where 32 columns would take
//   292 KB), with twice the column tiles and half the chunks.
// - With BC = 16 the last stage holds the tile's 16 features at column c0 %
//   32 of its 32, the gathers take lanes 0-15 of a warp (the warp's dgate
//   tile has one column per lane) and dbias sums two rows a step.
#include <cuda.h>

#include "gcl_common.cuh"
#include "mma_bf16.cuh"  // cp.async helpers

namespace {

using namespace gcl;
using tc::cp_async16;
using tc::cp_async_commit;
using tc::cp_async_wait_all;
using tc::smem_u32;

constexpr int BK = 32;           // contracted features a stage
constexpr int NSEG = 5;          // dH segments: track, self, onset, next, root
constexpr int THREADS = 256;
constexpr int NWARP = THREADS / 32;

// The bar grid and tiling at S steps a bar.
template <int S_>
struct Cfg {
  static constexpr int S = S_;
  static constexpr int N = T * S;            // cells a bar
  static constexpr int BC = S > 32 ? 16 : 32;  // feature columns per CTA
  static constexpr int CPT = BC / 16;        // columns a thread: cg + 16 c
  static constexpr int RPT = S / 4;          // rows a thread: r0 + 4 r
  static constexpr int CPW = 32 / BC;        // dbias rows a warp step
};

// Features f0..f0+31 of g (N rows) and of the tile's W rows in all 8 blocks
// (row blk * BC + n): rows of 128 bytes, the TMA's 128-byte swizzle.
template <class C>
struct alignas(1024) Stage {
  float g[C::N * BK];
  float w[NBLK * C::BC * BK];
};

// The statics of one bar that the kernel reads, as in `gcl_bwd_data.cu`:
// src[r][j] = i | dist << 8 for the cell i that reads cell j through
// relation r and whose share is not 0, or -1.
template <class C>
struct Cells {
  float m[C::N], rtr[C::N], single[C::N], ron[C::N], rnx[C::N];
  int src[3][C::N];
};

template <class C>
struct Smem {
  Stage<C> st[2];                          // stage u in st[u % 2]
  // the upstream tiles: dmsg, dself * single, dcol, dnx, dH_root
  alignas(16) float up[NSEG][C::N][C::BC];
  alignas(16) float xs[C::N][C::BC];       // x[bar][:, tile]
  alignas(16) int aux[N_AUX * C::N];       // aux[bar]
  Cells<C> cells;
  float gts[C::S][C::BC];                  // gate_table[:, tile]
  float dgs[C::S][C::BC];                  // dgate partial of this CTA
  float dbs[NWARP][32];                    // dbias partials of the lanes
  unsigned long long full[2];              // stage buffer b has landed
};

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
template <class C>
__device__ __forceinline__ void load_stage(Smem<C>& sm, int b,
                                           const CUtensorMap* gmap,
                                           const CUtensorMap* wmap, int bar,
                                           int c0, int f0) {
  mbar_expect(&sm.full[b], sizeof(Stage<C>));
  load_2d(sm.st[b].g, gmap, f0, bar * C::N, &sm.full[b]);
  load_3d(sm.st[b].w, wmap, f0, c0, 0, &sm.full[b]);
}

// x[bar][:, tile] and aux[bar] by 16-byte copies.
template <class C>
__device__ __forceinline__ void load_bar(Smem<C>& sm, const float* xb,
                                         const int* ab, int d, int c0,
                                         int tid) {
  constexpr int Q = C::BC / 4;  // 16-byte chunks a row
  for (int c = tid; c < C::N * Q; c += THREADS) {
    const int r = c / Q, q = (c % Q) * 4;
    cp_async16(&sm.xs[r][q], xb + (size_t)r * d + c0 + q);
  }
  for (int c = tid; c < N_AUX * C::N / 4; c += THREADS)
    cp_async16(sm.aux + c * 4, ab + c * 4);
}

// One stage into this thread's sums: rows r0 + 4 r (r < S / 4, track trk),
// columns cg + 16 c (c < CPT) of every segment.
template <class C>
__device__ __forceinline__ void stage_ffma(
    float (&acc)[NSEG][C::RPT][C::CPT], const Stage<C>& s, int trk, int r0,
    int cg) {
#pragma unroll 2
  for (int kc = 0; kc < BK / 4; ++kc) {
    float4 a[C::RPT];
#pragma unroll
    for (int r = 0; r < C::RPT; ++r) a[r] = ld4(s.g + sw_off(r0 + 4 * r, kc));
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      const int row = (sg == 0 ? trk : T - 1 + sg) * C::BC + cg;
      float4 b[C::CPT];
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) b[c] = ld4(s.w + sw_off(row + 16 * c, kc));
#pragma unroll
      for (int r = 0; r < C::RPT; ++r)
#pragma unroll
        for (int c = 0; c < C::CPT; ++c) {
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
template <class C>
__device__ __forceinline__ void decode_cell(Cells<C>& cl, const int* a,
                                            int i) {
  const CellStatics c = cell_statics_grid(a, i, C::N, C::S);
  cl.m[i] = c.m;
  cl.rtr[i] = c.rtr;
  cl.single[i] = c.single;
  cl.ron[i] = c.ron;
  cl.rnx[i] = c.rnx;
  if (c.m > 0.f && c.okp > 0.f) cl.src[0][c.ps] = i | c.dp << 8;
  if (c.m > 0.f && c.okn > 0.f) cl.src[1][c.ns] = i | c.dn << 8;
  if (c.okpn > 0.f && a[CNT_ON * C::N + i] + (c.m > 0.f) > 0)
    cl.src[2][c.pn] = i | c.dpn << 8;
}

// What cell j, column q takes from the bar, as in `gcl_bwd_data.cu`.
struct Taken {
  float dx, share[4];
  int dist[4];
};

template <class C>
__device__ __forceinline__ Taken take(const Smem<C>& sm, int j, int q,
                                      float g0) {
  constexpr int S = C::S;
  const Cells<C>& cl = sm.cells;
  const float (*dnx)[C::BC] = sm.up[3];
  const float (*dcol)[C::BC] = sm.up[2];
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

// The bar's dx rows of the tile, cells j = warp, warp + 8, ... at column q
// = lane (lanes < BC), and their dgate shares into column q of the warp's
// tile dg.
template <class C>
__device__ __forceinline__ void gather_bar(const Smem<C>& sm,
                                           float (*dg)[C::BC], float* dxb,
                                           int d, int c0, int warp, int q) {
  if (q >= C::BC) return;
  const float g0 = sm.gts[0][q];
  for (int j = warp; j < C::N; j += NWARP) {
    const Taken t = take(sm, j, q, g0);
    dxb[(size_t)j * d + c0 + q] = t.dx;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (t.dist[k] >= 0) dg[t.dist[k]][q] += t.share[k];
  }
}

template <int S>
__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_data_grid_kernel(const float* __restrict__ x,
                         const int* __restrict__ aux,
                         const float* __restrict__ gates,
                         float* __restrict__ dx, float* __restrict__ part,
                         int nbar, int d, int n, int nchunks,
                         const __grid_constant__ CUtensorMap gmap,
                         const __grid_constant__ CUtensorMap wmap) {
  using C = Cfg<S>;
  constexpr int N = C::N, BC = C::BC;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem<C>& sm = *reinterpret_cast<Smem<C>*>(smem_raw);
  Cells<C>& cl = sm.cells;
  const int c0 = blockIdx.x * BC, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int trk = warp >> 1;                    // the track of the rows
  const int r0 = trk * S + (lane >> 3);         // rows r0 + 4 r
  const int cg = (warp & 1) * 8 + (lane & 7);   // columns cg + 16 c
  const int nstage = n / BK;
  const bool has_bias = c0 < n;  // the tile's columns of dbias
  const int fb = c0 % BK;        // the tile's first feature in its stage
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
  float acc[NSEG][C::RPT][C::CPT];
#pragma unroll
  for (int sg = 0; sg < NSEG; ++sg)
#pragma unroll
    for (int r = 0; r < C::RPT; ++r)
#pragma unroll
      for (int c = 0; c < C::CPT; ++c) acc[sg][r][c] = 0.f;
  // dbias of column lane % BC over the warp's rows lane / BC, + CPW, ...
  float db = 0.f;

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
      stage_ffma<C>(acc, sm.st[u & 1], trk, r0, cg);
    }

    // dbias from the last stage, g[bar][:, stage features]
    if (has_bias) {
      const float* gl = sm.st[(u - 1) & 1].g;
      const int f = fb + lane % BC;
      for (int i = lane / BC; i < N / NWARP; i += C::CPW) {
        const int row = warp * (N / NWARP) + i;
        db += gl[sw_off(row, f >> 2) + (f & 3)] * cl.m[row];
      }
    }
    // the upstream tiles
#pragma unroll
    for (int r = 0; r < C::RPT; ++r) {
      const int row = r0 + 4 * r;
      const float m = cl.m[row];
      const float f[NSEG] = {cl.rtr[row], cl.single[row], cl.ron[row],
                             cl.rnx[row], 1.f};
#pragma unroll
      for (int sg = 0; sg < NSEG; ++sg)
#pragma unroll
        for (int c = 0; c < C::CPT; ++c) {
          sm.up[sg][row][cg + 16 * c] = acc[sg][r][c] * m * f[sg];
          acc[sg][r][c] = 0.f;
        }
    }
    __syncthreads();
    // the last stage is read: its buffer takes the warps' dgate tiles
    float (*dgw)[S][BC] = reinterpret_cast<float (*)[S][BC]>(
        &sm.st[(u - 1) & 1]);
    if (lane < BC) {
#pragma unroll
      for (int s = 0; s < S; ++s) dgw[warp][s][lane] = 0.f;
    }
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
    for (int w = 0; w < NWARP; ++w)
      for (int h = 0; h < C::CPW; ++h) sb += sm.dbs[w][h * BC + tid];
    pb[(size_t)S * d + c0 + tid] = sb;
  }
}

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// link against libcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
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
bool fp32_map(CUtensorMap* map, const void* base, int rank,
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

template <int S>
int launch(const void* x, const void* g, const void* aux, const void* gates,
           const void* wbig, void* dx, void* part, void* out, int nbar, int d,
           int n, cudaStream_t st) {
  using C = Cfg<S>;
  static_assert(sizeof(Stage<C>) == sizeof(float) * (C::N + NBLK * C::BC) * BK,
                "a stage is exactly its two TMA boxes");
  static_assert(sizeof(float) * NWARP * S * C::BC <= sizeof(Stage<C>),
                "the warps' dgate tiles fit in a stage");
  static_assert(sizeof(Smem<C>) <= 232448, "a CTA's shared memory");
  constexpr int N = C::N, BC = C::BC;
  const long long row = (long long)S * d + n;  // a partial row
  if (nbar <= 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * row, st);
  const int smem = (int)sizeof(Smem<C>);
  cudaError_t err = cudaFuncSetAttribute(
      gcl_bwd_data_grid_kernel<S>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
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
  gcl_bwd_data_grid_kernel<S><<<dim3(tiles, nchunks), THREADS, smem, st>>>(
      (const float*)x, (const int*)aux, (const float*)gates, (float*)dx,
      (float*)part, nbar, d, n, nchunks, gmap, wmap);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sum_rows((const float*)part, (float*)out, nchunks, row, st);
}

}  // namespace

// Bytes of dynamic shared memory a CTA of the kernel takes at S steps a
// bar (0 for a grid it does not take).
extern "C" int gcl_bwd_data_grid_smem_bytes(int S) {
  switch (S) {
#define GCL_SMEM(s) \
  case s:           \
    return (int)sizeof(Smem<Cfg<s>>);
    GCL_GRID_STEPS(GCL_SMEM)
#undef GCL_SMEM
  }
  return 0;
}

// x (nbar, 4 S, d), g (nbar, 4 S, n); aux (nbar, N_AUX, 4 S); gates (S, d);
// wbig (8d, n); all 16-byte aligned, d % 128 == 0, n % 128 == 0, d % n ==
// 0; S a multiple of 4 up to 48 but 32. Writes dx (nbar, 4 S, d) and out =
// [dgate (S, d) | dbias (n)], using the first min(nbar, SMs / (d / BC))
// rows of part (nbar, S * d + n) as scratch for the per-CTA partials.
extern "C" int gcl_bwd_data_grid_launch(const void* x, const void* g,
                                        const void* aux, const void* gates,
                                        const void* wbig, void* dx, void* part,
                                        void* out, int nbar, int S, int d,
                                        int n, void* stream) {
  if (d <= 0 || d % 128 != 0 || n <= 0 || n % 128 != 0 || d % n != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (S) {
#define GCL_LAUNCH(s) \
  case s:             \
    return launch<s>(x, g, aux, gates, wbig, dx, part, out, nbar, d, n, st);
    GCL_GRID_STEPS(GCL_LAUNCH)
#undef GCL_LAUNCH
  }
  return (int)cudaErrorInvalidValue;
}
