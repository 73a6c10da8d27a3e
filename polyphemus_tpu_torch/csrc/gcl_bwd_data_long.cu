// GCL training backward, data half, in fp32 or bf16, for bars of 4 x S
// cells at any S that is a multiple of 4 above 48 (resolutions 13 and up:
// 24, the Lakh Pianoroll Dataset's grid, is S = 96): dx, d(gate_table) (S,
// d) and dbias. Up to S = 48 the port launches `gcl_bwd_data_grid.cu` (and
// at S = 32 `gcl_bwd_data.cu`) in fp32 and the fused backward in bf16,
// whose CTAs hold whole bars; above that one bar no longer fits a CTA's
// shared memory, and this source takes it in two launches.
//
// Replaces, at those grids, the Pallas kernel `_bwd_data_kernel` of
// polyphemus_tpu/ops/kernels/gcl_pallas_bwd.py (kernel A of
// `gcl_backward_pallas`, :494, its pallas_call at :528, called by the
// custom VJP `gcl_fused` in both dtypes, gcl_pallas.py:493-516), which
// takes the steps a bar as `n_steps` (:91-95). Per bar of N = 4 S cells it
// computes what `gcl_bwd_data_grid.cu` computes:
//
//   dH_r     = gm @ W_r^T            (track blocks: each track's S rows only)
//   dx       = dH_root + the gathers of the track, onset and next relations
//            + relu'(x * g0) * dy0 * g0
//   dgate[s] = sum of relu'(pre) * upstream * x[src] at distance s
//   dbias    = sum of gm over every cell of every bar
//
// for Wbig (8d, n) and g (nbar, N, n): the square weights (n = d), or the
// column form of tensor parallelism, n of the d output columns (n % 128 ==
// 0), where dH, dx and dgate are partial sums over the shard's n columns
// (their sum over the shards is the square launch's) and dbias is n wide.
// The element
// type E of x, g, the gate table, Wbig and dx is a template parameter
// (`gcl_bwd_data_long_launch` fp32, `gcl_bwd_data_long_bf16_launch` bf16);
// dgate and dbias are fp32 sums. In bf16 the operands are widened to fp32
// in registers (a bf16 x bf16 product is exact in fp32, so the FFMAs
// compute what the Pallas body's bf16 dots with fp32 sums compute), and
// values are rounded to bf16 (`rnd`) where `_bwd_data_kernel` casts to its
// compute dtype: the mean reciprocals (`recip`, :84-86), dnx and dcol
// before their column sums (:174, :190), pre = x[src] g (:165) and pre0 =
// x g0 (:195) before their relu' tests, the shares relu'(pre) up g and
// relu'(pre) up x[src] before the scatters into dx and dgate (:183-185),
// and dx at the end; dmsg, dz and dy0 stay fp32, as there.
//
// What bounds it on an H100: operations, the product (2 N 5d d flops a bar:
// 1.01 GFLOP at S = 96, d = 512) in fp32 FFMA on the CUDA cores.
//
// Design. A cell's dx needs the upstream of the cells that read it as their
// source: the next active cell of its track, its track's cell in the next
// active column; those may lie anywhere in the bar. So the bar is taken in
// two launches, with the upstream in a scratch buffer between them:
// - The product kernel. A CTA owns a tile of 32 dx features and walks the
//   items (bar, tile of 4 tracks x 32 columns) chunk, chunk + nchunks, ...:
//   row r = 32 t + cc of an item is cell (t, c0 + cc), as in
//   `gcl_eval_long_fp32.cu`, so the four cells of a column lie in the item.
//   Its product is `gcl_bwd_data.cu`'s (8 rows x 2 columns x 5 segments a
//   thread; the item's g rows, one TMA box of [4 tracks][32 columns][128
//   bytes of g's n columns: 32 fp32, 64 bf16] from g seen as (nbar 4, S, n),
//   zero past the bar's last column, and the tile's W rows of the 8 blocks,
//   128-byte swizzle, two stages on mbarriers running on from item to
//   item). It writes dH_root m, fp32, into dr (dx itself in fp32, a plane
//   after the scratch in bf16, where dx holds bf16) and three fp32 upstream
//   planes into the scratch (nbar, 3, N, d):
//   dmsg = dH_track m r_tr (read by the track relations), dz = colsum(dnx)
//   - dnx with dnx = dH_next m r_nx (read by the next relation), dy0 =
//   colsum(dcol) - dcol + dH_self m single with dcol = dH_onset m r_on (read
//   by the cell itself); the column sums through shared memory.
// - The gather kernel. A CTA owns one bar and 128 features, a warp 32 (a
//   feature a lane); it inverts the bar's relations at the statics' decode
//   (no atomics) and walks the cells in order, adding to dH_root m the
//   shares gathered from the scratch (then writing dx), and to this bar's
//   row of dgate partials in `part` (each element owned by one thread)
//   their dgate shares; dbias by the same walk. The launcher sums the rows
//   of `part` in bar order (`gcl::sum_rows`): no float atomics, bitwise
//   repeatable.
// - No shared-memory size depends on S but the gather kernel's statics (16
//   bytes a cell).
#include <cuda.h>

#include <type_traits>

#include "gcl_common.cuh"

namespace {

using namespace gcl;

constexpr int NSEG = 5;          // dH segments: track, self, onset, next, root
constexpr int THREADS = 256;     // product kernel
constexpr int CW = 32;           // bar columns of an item
constexpr int MT = T * CW;       // rows of an item
constexpr int BC = 32;           // dx features a CTA of the product kernel
constexpr int RPT = 8;           // rows a thread: r0 + 4 r
constexpr int CPT = 2;           // columns a thread: cg + 16 c
constexpr int NUP = 3;           // scratch planes: dmsg, dz, dy0
constexpr int GATHER_THREADS = 128;  // gather kernel: 4 warps x 32 features

// Contracted features a stage: rows of 128 bytes of element type E, 8
// chunks of 16 bytes.
template <typename E>
__host__ __device__ constexpr int bk() { return 128 / (int)sizeof(E); }

// Features f0..f0+bk-1 of the item's g rows and of the tile's W rows in all
// 8 blocks (row blk * BC + n): rows of 128 bytes, the TMA's 128-byte
// swizzle. 48 KB in either element type.
template <typename E>
struct alignas(1024) Stage {
  E g[MT * bk<E>()];
  E w[NBLK * BC * bk<E>()];
};

template <typename E>
struct ProdSmem {
  Stage<E> st[2];                          // stage u in st[u % 2]
  alignas(16) float col[2][MT][BC];        // dcol, dnx of the item
  float m[MT], rtr[MT], single[MT], ron[MT], rnx[MT];
  unsigned long long full[2];              // stage buffer b has landed
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Element offset of quad q (4 elements) of row r of a stage buffer, as the
// TMA's 128-byte swizzle stores its 16-byte chunks (the buffer 1024-byte
// aligned): chunk q / QPC at chunk (q / QPC) ^ (r % 8), QPC = the quads a
// chunk (1 fp32, 2 bf16).
template <typename E>
__device__ __forceinline__ int sw_off(int r, int q) {
  constexpr int QPC = 4 / (int)sizeof(E);
  constexpr int EPC = 16 / (int)sizeof(E);
  return r * bk<E>() + (((q / QPC) ^ (r & 7)) * EPC) + (q % QPC) * 4;
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

// Stage buffer b: features f0..f0+bk-1 of the g rows of item (bar, columns
// tc0..) and of the tile's W rows, one TMA box each; thread 0 starts it.
template <typename E>
__device__ __forceinline__ void load_stage(ProdSmem<E>& sm, int b,
                                           const CUtensorMap* gmap,
                                           const CUtensorMap* wmap, int bar,
                                           int tc0, int c0, int f0) {
  mbar_expect(&sm.full[b], sizeof(Stage<E>));
  load_3d(sm.st[b].g, gmap, f0, tc0, bar * T, &sm.full[b]);
  load_3d(sm.st[b].w, wmap, f0, c0, 0, &sm.full[b]);
}

// One stage into this thread's sums: rows r0 + 4 r (track trk), columns cg
// + 16 c of every segment; bf16 operands widened to fp32 as they load.
template <typename E>
__device__ __forceinline__ void stage_ffma(float (&acc)[NSEG][RPT][CPT],
                                           const Stage<E>& s, int trk, int r0,
                                           int cg) {
#pragma unroll 2
  for (int kc = 0; kc < bk<E>() / 4; ++kc) {
    float4 a[RPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r)
      a[r] = Elem<E>::load4(s.g + sw_off<E>(r0 + 4 * r, kc));
#pragma unroll
    for (int sg = 0; sg < NSEG; ++sg) {
      const int row = (sg == 0 ? trk : T - 1 + sg) * BC + cg;
      float4 b[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c)
        b[c] = Elem<E>::load4(s.w + sw_off<E>(row + 16 * c, kc));
#pragma unroll
      for (int r = 0; r < RPT; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          float v = acc[sg][r][c];
          v = fmaf(a[r].x, b[c].x, v);
          v = fmaf(a[r].y, b[c].y, v);
          v = fmaf(a[r].z, b[c].z, v);
          acc[sg][r][c] = fmaf(a[r].w, b[c].w, v);
        }
    }
  }
}

// dr: dH_root m, fp32 (nbar, N, d); up: the scratch planes.
template <typename E>
__global__ void __launch_bounds__(THREADS, 1)
gcl_bwd_data_long_kernel(const int* __restrict__ aux, float* __restrict__ dr,
                         float* __restrict__ up, int nbar, int S, int d,
                         int n, int nchunks,
                         const __grid_constant__ CUtensorMap gmap,
                         const __grid_constant__ CUtensorMap wmap) {
  using R = Elem<E>;
  constexpr int BK = bk<E>();
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  ProdSmem<E>& sm = *reinterpret_cast<ProdSmem<E>*>(smem_raw);
  const int N = T * S, ntile = (S + CW - 1) / CW, nitem = nbar * ntile;
  const int c0 = blockIdx.x * BC, chunk = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int trk = warp >> 1;                   // the track of the rows
  const int r0 = trk * CW + (lane >> 3);       // rows r0 + 4 r
  const int cg = (warp & 1) * 8 + (lane & 7);  // columns cg + 16 c
  const int nstage = n / BK;  // the product's reduction: g's n columns

  if (tid == 0) {
    // the swizzle of sw_off needs 1024-byte aligned stage buffers
    if (smem_u32(smem_raw) & 1023) __trap();
    mbar_init(&sm.full[0]);
    mbar_init(&sm.full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (tid == 0 && chunk < nitem)
    load_stage(sm, 0, &gmap, &wmap, chunk / ntile, chunk % ntile * CW, c0, 0);
  float acc[NSEG][RPT][CPT];
#pragma unroll
  for (int sg = 0; sg < NSEG; ++sg)
#pragma unroll
    for (int r = 0; r < RPT; ++r)
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[sg][r][c] = 0.f;

  unsigned u = 0;  // stages multiplied so far
  for (int it = chunk; it < nitem; it += nchunks) {
    const int bar = it / ntile, tc0 = it % ntile * CW;
    const int nx = it + nchunks;
    for (int st = 0; st < nstage; ++st, ++u) {
      // no warp still reads the buffer that stage u + 1 takes (nor, at st
      // 0, the previous item's statics and column tiles)
      __syncthreads();
      // the next stage: this item's, or the first of the CTA's next item
      if (tid == 0 && (st + 1 < nstage || nx < nitem)) {
        if (st + 1 < nstage)
          load_stage(sm, (u + 1) & 1, &gmap, &wmap, bar, tc0, c0,
                     (st + 1) * BK);
        else
          load_stage(sm, (u + 1) & 1, &gmap, &wmap, nx / ntile,
                     nx % ntile * CW, c0, 0);
      }
      if (st == 0 && tid < MT) {
        const int t = tid / CW, c = tc0 + tid % CW;
        CellStatics cs{};
        if (c < S)
          cs = cell_statics_grid(aux + (size_t)bar * N_AUX * N, t * S + c, N,
                                 S);
        sm.m[tid] = cs.m;
        sm.rtr[tid] = R::rnd(cs.rtr);
        sm.single[tid] = cs.single;
        sm.ron[tid] = R::rnd(cs.ron);
        sm.rnx[tid] = R::rnd(cs.rnx);
      }
      mbar_wait(&sm.full[u & 1], (u >> 1) & 1);  // stage u has landed
      stage_ffma(acc, sm.st[u & 1], trk, r0, cg);
    }

    // the upstream of this thread's rows; dcol and dnx to shared memory for
    // the column sums
    __syncthreads();  // the item's statics
    float dmsg[RPT][CPT], dself[RPT][CPT], droot[RPT][CPT];
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = r0 + 4 * r;
      const float m = sm.m[row];
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        dmsg[r][c] = acc[0][r][c] * m * sm.rtr[row];
        dself[r][c] = acc[1][r][c] * m * sm.single[row];
        sm.col[0][row][cg + 16 * c] = R::rnd(acc[2][r][c] * m * sm.ron[row]);
        sm.col[1][row][cg + 16 * c] = R::rnd(acc[3][r][c] * m * sm.rnx[row]);
        droot[r][c] = acc[4][r][c] * m;
#pragma unroll
        for (int sg = 0; sg < NSEG; ++sg) acc[sg][r][c] = 0.f;
      }
    }
    __syncthreads();
    const size_t plane = (size_t)N * d;
    float* upb = up + (size_t)bar * NUP * plane;
    float* drb = dr + (size_t)bar * plane;
#pragma unroll
    for (int r = 0; r < RPT; ++r) {
      const int row = r0 + 4 * r, cc = row % CW;
      if (tc0 + cc >= S) continue;  // past the bar's last column
      const size_t cell = (size_t)(trk * S + tc0 + cc) * d + c0;
#pragma unroll
      for (int c = 0; c < CPT; ++c) {
        const int q = cg + 16 * c;
        const float (*dcol)[BC] = sm.col[0];
        const float (*dnx)[BC] = sm.col[1];
        const float dy0 = (dcol[cc][q] + dcol[CW + cc][q] + dcol[2 * CW + cc][q]
                           + dcol[3 * CW + cc][q]) - dcol[row][q] + dself[r][c];
        const float dz = (dnx[cc][q] + dnx[CW + cc][q] + dnx[2 * CW + cc][q]
                          + dnx[3 * CW + cc][q]) - dnx[row][q];
        upb[cell + q] = dmsg[r][c];
        upb[plane + cell + q] = dz;
        upb[2 * plane + cell + q] = dy0;
        drb[cell + q] = droot[r][c];
      }
    }
  }
}

// The gather kernel: dx = dH_root m (dr; in fp32 dx itself, updated in
// place) + the shares the bar's cells take through the relations and the
// self term, and this bar's row of dgate / dbias partials, part[bar] =
// [dgate (S, d) | dbias (n)] (zero before); g rows n wide, the CTAs of
// features f < n also sum dbias.
template <typename E>
__global__ void __launch_bounds__(GATHER_THREADS)
gcl_bwd_gather_long_kernel(const E* __restrict__ x,
                           const E* __restrict__ g,
                           const int* __restrict__ aux,
                           const E* __restrict__ gates,
                           const float* __restrict__ up,
                           const float* __restrict__ dr,
                           E* __restrict__ dx, float* __restrict__ part,
                           int S, int d, int n) {
  using R = Elem<E>;
  constexpr bool kInPlace = std::is_same<E, float>::value;
  // src[r][j] = i | dist << 16 for the cell i that reads cell j through
  // relation r (0 previous, 1 next in the track, 2 previous column) and
  // whose share is not 0, or -1; m[j] the mask
  extern __shared__ int gsm[];
  const int N = T * S;
  int* src = gsm;
  float* m = reinterpret_cast<float*>(gsm + 3 * N);
  const int bar = blockIdx.x, tid = threadIdx.x;
  const int* a = aux + (size_t)bar * N_AUX * N;
  for (int i = tid; i < 3 * N; i += GATHER_THREADS) src[i] = -1;
  __syncthreads();
  for (int i = tid; i < N; i += GATHER_THREADS) {
    const CellStatics c = cell_statics_grid(a, i, N, S);
    m[i] = c.m;
    if (c.m > 0.f && c.okp > 0.f) src[c.ps] = i | c.dp << 16;
    if (c.m > 0.f && c.okn > 0.f) src[N + c.ns] = i | c.dn << 16;
    if (c.okpn > 0.f && a[CNT_ON * N + i] + (c.m > 0.f) > 0)
      src[2 * N + c.pn] = i | c.dpn << 16;
  }
  __syncthreads();
  const int f = blockIdx.y * GATHER_THREADS + tid;
  const size_t plane = (size_t)N * d;
  const E* xb = x + (size_t)bar * plane + f;
  const bool has_bias = f < n;
  const E* gb = g + (size_t)bar * N * n + f;
  const float* upb = up + (size_t)bar * NUP * plane + f;
  const float* drb = dr + (size_t)bar * plane + f;
  E* dxb = dx + (size_t)bar * plane + f;
  float* pb = part + (size_t)bar * ((size_t)S * d + n) + f;
  const float g0 = R::load1(gates + f);
  float db = 0.f;
  for (int j = 0; j < N; ++j) {
    const size_t jd = (size_t)j * d;
    const float xv = R::load1(xb + jd);
    float dxv;
    if constexpr (kInPlace)
      dxv = dxb[jd];
    else
      dxv = drb[jd];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int e = src[r * N + j];
      if (e < 0) continue;
      const int i = e & 0xffff, dist = e >> 16;
      const float gv = R::load1(gates + (size_t)dist * d + f);
      if (!(R::rnd(xv * gv) > 0.f)) continue;
      const float u = upb[(r < 2 ? 0 : plane) + (size_t)i * d];
      dxv += R::rnd(u * gv);
      pb[(size_t)dist * d] += R::rnd(u * xv);
    }
    const float mj = m[j];
    if (mj > 0.f && R::rnd(xv * g0) > 0.f) {
      const float dy0 = upb[2 * plane + jd];
      dxv += dy0 * g0;
      pb[0] += dy0 * xv;
    }
    R::store1(dxb + jd, dxv);
    if (has_bias) db += R::load1(gb + (size_t)j * n) * mj;
  }
  if (has_bias) pb[(size_t)S * d] = db;
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

// A 3-d tensor of element type E at base, dims[0] the contiguous one,
// strides[i] the bytes between steps of dimension i + 1, read in boxes of
// box[0..2] elements with the TMA's 128-byte swizzle (zero past its
// edges).
template <typename E>
bool tensor_map(CUtensorMap* map, const void* base, const cuuint64_t* dims,
                const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint32_t estr[3] = {1, 1, 1};
  const CUtensorMapDataType type = std::is_same<E, float>::value
                                       ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  return enc(map, type, 3, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The two launches, the elements of x, g, gates, wbig and dx of type E;
// see `gcl_bwd_data_long_launch`. dr takes dH_root m (fp32): dx in fp32.
template <typename E>
int launch(const void* x, const void* g, const void* aux, const void* gates,
           const void* wbig, void* dx, void* part, void* out, void* up,
           float* dr, int nbar, int S, int d, int n, cudaStream_t st) {
  constexpr int BK = bk<E>(), ES = (int)sizeof(E);
  static_assert(sizeof(Stage<E>) == (size_t)ES * (MT + NBLK * BC) * BK,
                "a stage is exactly its two TMA boxes");
  static_assert(sizeof(ProdSmem<E>) <= 232448, "a CTA's shared memory");
  if (d <= 0 || d % 128 != 0 || n <= 0 || n % 128 != 0 || n > d || S < 4 ||
      S % 4 != 0 || T * S >= 65536 || nbar < 0)
    return (int)cudaErrorInvalidValue;
  const long long row = (long long)S * d + n;  // a partial row
  if (nbar == 0)
    return (int)cudaMemsetAsync(out, 0, sizeof(float) * row, st);
  const int N = T * S, ntile = (S + CW - 1) / CW;
  const long long nitem = (long long)nbar * ntile;
  if (nitem > 0x7fffffffLL || (long long)nbar * T > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  // g as [nbar 4 tracks][S steps][n columns] in boxes of [4][CW][BK] (zero
  // past a track's last step); wbig as [8 blocks][d rows][n columns] in
  // boxes of [8][BC][BK]
  CUtensorMap gmap, wmap;
  const cuuint64_t gdims[3] = {(cuuint64_t)n, (cuuint64_t)S,
                               (cuuint64_t)nbar * T};
  const cuuint64_t gstrides[2] = {(cuuint64_t)n * ES, (cuuint64_t)S * n * ES};
  const cuuint32_t gbox[3] = {BK, CW, T};
  const cuuint64_t wdims[3] = {(cuuint64_t)n, (cuuint64_t)d, NBLK};
  const cuuint64_t wstrides[2] = {(cuuint64_t)n * ES, (cuuint64_t)d * n * ES};
  const cuuint32_t wbox[3] = {BK, BC, NBLK};
  if (!tensor_map<E>(&gmap, g, gdims, gstrides, gbox) ||
      !tensor_map<E>(&wmap, wbig, wdims, wstrides, wbox))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(ProdSmem<E>);
  if ((err = cudaFuncSetAttribute(gcl_bwd_data_long_kernel<E>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  smem)) != cudaSuccess)
    return (int)err;
  const int tiles = d / BC;
  const int per_tile = sms / tiles > 1 ? sms / tiles : 1;
  const int nchunks = nitem < per_tile ? (int)nitem : per_tile;
  gcl_bwd_data_long_kernel<E><<<dim3(tiles, nchunks), THREADS, smem, st>>>(
      (const int*)aux, dr, (float*)up, nbar, S, d, n, nchunks, gmap, wmap);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  if ((err = cudaMemsetAsync(part, 0, sizeof(float) * row * nbar, st)) !=
      cudaSuccess)
    return (int)err;
  const int gsmem = (int)(sizeof(int) * 4 * N);
  if ((err = cudaFuncSetAttribute(gcl_bwd_gather_long_kernel<E>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  gsmem)) != cudaSuccess)
    return (int)err;
  gcl_bwd_gather_long_kernel<E><<<dim3(nbar, d / GATHER_THREADS),
                                  GATHER_THREADS, gsmem, st>>>(
      (const E*)x, (const E*)g, (const int*)aux, (const E*)gates,
      (const float*)up, dr, (E*)dx, (float*)part, S, d, n);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  return (int)sum_rows((const float*)part, (float*)out, nbar, row, st);
}

}  // namespace

// Bytes of dynamic shared memory a CTA of the product kernel takes, fp32
// and bf16.
extern "C" int gcl_bwd_data_long_smem_bytes() {
  return (int)sizeof(ProdSmem<float>);
}

extern "C" int gcl_bwd_data_long_bf16_smem_bytes() {
  return (int)sizeof(ProdSmem<__nv_bfloat16>);
}

// x (nbar, 4 S, d), g (nbar, 4 S, n); aux (nbar, N_AUX, 4 S); gates (S,
// d); wbig (8d, n); fp32, all 16-byte aligned, d % 128 == 0, n % 128 == 0,
// n <= d (n = d: the square weights; n < d: a column shard, dx and dgate
// partial over its columns); S a multiple of 4, 4 S < 65536. Writes dx
// (nbar, 4 S, d) and out = [dgate (S, d) | dbias (n)], using up (nbar, 3,
// 4 S, d) as the upstream scratch and part (nbar, S * d + n) for the
// per-bar partials.
extern "C" int gcl_bwd_data_long_launch(const void* x, const void* g,
                                        const void* aux, const void* gates,
                                        const void* wbig, void* dx, void* part,
                                        void* out, void* up, int nbar, int S,
                                        int d, int n, void* stream) {
  return launch<float>(x, g, aux, gates, wbig, dx, part, out, up,
                       (float*)dx, nbar, S, d, n, (cudaStream_t)stream);
}

// The same in bf16: x, g, gates, wbig and dx bf16, out and part fp32; up
// holds (nbar, 4, 4 S, d) floats, its last nbar x 4 S x d the fp32 dH_root
// m that the gather kernel adds its shares to before it rounds dx.
extern "C" int gcl_bwd_data_long_bf16_launch(const void* x, const void* g,
                                             const void* aux,
                                             const void* gates,
                                             const void* wbig, void* dx,
                                             void* part, void* out, void* up,
                                             int nbar, int S, int d, int n,
                                             void* stream) {
  float* dr = (float*)up + (size_t)nbar * NUP * T * S * d;
  return launch<__nv_bfloat16>(x, g, aux, gates, wbig, dx, part, out, up, dr,
                               nbar, S, d, n, (cudaStream_t)stream);
}
