// Chord tail in fp32: chord decode -> unembed -> argmax, token ids only.
//
// Replaces, in fp32, the Pallas kernel `_kernel` of
// polyphemus_tpu/ops/kernels/chord_tail.py (its pallas_call at :101, reached
// through `chord_tail_tokens`). For each cell of each bar and each of the 15
// note slots:
//
//   h     = x @ W_slot + b_slot          (d values; W_slot = ck[:, sd:(s+1)d])
//   pitch = h[:d/2] @ P + pb             (P: the drum unembed on track 0, the
//                                         melodic one on tracks 1-3)
//   dur   = h[d/2:] @ D + db
//   ids   = (argmax pitch, argmax dur)   first index among equal maxima
//
// Only the int32 ids reach device memory, in the (bar, 4, S, 15, 2) layout of
// the JAX function, for bars of 4 x S cells at any S that is a multiple of 4
// (the JAX kernel reads t, s and d from x's shape, chord_tail.py:65-69).
// Every cell is computed, as in the JAX kernel. The products
// are fp32 FMAs on the CUDA cores (no TF32, no tensor cores); only the order
// of the fp32 sums differs from the plain version
// (`ops/kernels/chord_tail.py::chord_tail_plain`).
//
// What bounds it on an H100: operations. Per cell and slot it does
// 2 d^2 + 2 (d/2) (131 + 99) flops (0.64 MFLOP at d = 512) against d * 4 bytes
// of state, so a 512-bar launch needs 631 GFLOP: 9.42 ms at the CUDA cores'
// 67 TFLOP/s. Each CTA also streams its slot's d x d weights (1 MiB at
// d = 512) and the unembeds from L2.
//
// Design, one CTA of 8 warps per SM (up to 255 registers a thread), each
// walking the items (tile, slot) in a grid stride; the ring of stages runs on
// from one item to the next, so the next item's first copies land under this
// one's last products:
// - An item is one tile of ROWS rows and one slot. The tiles cut the flat
//   axis of the nbar x 4S cells (128 rows for d <= 512, 64 for d = 640-1024,
//   32 for d = 1152-1536), the last one padded: its x rows past the cells
//   come in as zeros (the TMA's fill) and its ids are not stored, so a tile
//   needs no whole bar and any S works. A tile computes a half-width of 64, 128, 192, 256, 384, 512
//   or 768 columns; a width whose half lies between two of them runs in the
//   next one up, on weights the wrapper zero-pads to it (`chord_tail.pack`): the
//   padded columns of h are exact zeros and meet zero unembed rows, so the
//   sums of the real columns are the unpadded ones. Items are tile-major with the
//   slot as the fast axis, so the 15 items of a tile run together on 15 SMs:
//   x is read from device memory about once, and the 15 slot weights (15.7
//   MB at d = 512) stay in the 50 MB L2.
// - The projection goes in two passes, one per half of h that an unembed
//   reads. A pass holds ROWS x d/2 of h in registers (at d = 512 a thread
//   holds 8 consecutive rows x 16 columns: 128 accumulators), adds b_slot,
//   and parks the half in shared memory, k-major and XOR-swizzled (`swz`);
//   that half's unembed and argmax run from there. h never leaves the chip,
//   and no tile holds all of it.
// - Every operand comes by TMA through one ring of 3 stages in shared memory,
//   one mbarrier a stage, in one sequence per item: the first pass's stages
//   (BK features of W_slot, and of x, which the wrapper hands over k-major,
//   so a thread reads its 8 rows at one feature as two float4), the pitch
//   unembed's (16 features of the drum and the melodic unembed), the second
//   pass's, the duration unembed's. Two stages are in flight while one
//   multiplies; a stage has one barrier.
// - The unembed is a register-tiled SIMT product over the parked half: a warp
//   owns ROWS / 8 rows and every vocabulary column (144 pitch, 112 duration; the wrapper packs
//   the unembeds zero-padded to 144 columns each). A thread holds ROWS / 32
//   consecutive rows x 18 (pitch) or 14 (duration) columns; its rows lie in
//   one track (S % 4 == 0), whose pitch unembed (the drum one on track 0)
//   it reads. The argmax takes
//   a thread's columns below the vocabulary edge, then the 8 threads of a row
//   through shuffles, the first index on ties.
#include <cuda.h>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;     // 8 warps
constexpr int NS = 15;           // note slots
constexpr int NSTAGE = 3;        // ring stages
constexpr int BKU = 16;          // features per unembed stage
constexpr int UW = 144;          // columns of each packed unembed
constexpr int NVP = 9;           // pitch columns in steps of 16 (144)
constexpr int NVD = 7;           // duration columns in steps of 16 (112)
constexpr int NU = 3 * UW;       // packed unembed: drums | melodic | duration

// The widest TMA box that divides w and holds at most 256 columns
constexpr int box_width(int w) { return w <= 256 ? w : box_width(w / 2); }

// The compile-time geometry of a tile of ROWS rows at half-width 32 NJ CW.
// The input features (d) are a run-time multiple of BK.
template <int ROWS_, int NJ_>
struct Geo {
  static constexpr int ROWS = ROWS_;
  static constexpr int NJ = NJ_;                 // a thread's float4 columns
  static constexpr int RW = ROWS / 32;           // projection warps along rows
  static constexpr int CW = 8 / RW;              // and along columns
  static constexpr int H = 32 * NJ * CW;         // d / 2, or its padded width
  static constexpr int D = 2 * H;                // a slot's (padded) columns
  static constexpr int BK = ROWS == 128 ? 16 : 8;  // features per stage
  static constexpr int BW = box_width(H);        // TMA box width
  static constexpr int RP = ROWS;                // k-row stride of x and h
  static constexpr int UR = ROWS / 32;           // unembed rows a thread
  static constexpr int WF = BK * H;              // a stage's weight floats
  static constexpr int XF = BK * RP;             // and its x floats
  static constexpr int PF = WF + XF;             // a projection stage
  static constexpr int UF = 2 * BKU * UW;        // a pitch unembed stage
  static constexpr int SF = ((PF > UF ? PF : UF) + 31) / 32 * 32;
  static constexpr int NB = H / BKU;             // stages of an unembed
  static constexpr int SMEM = 128 + (NSTAGE * SF + H * RP) * 4;
  static_assert(H % BW == 0 && BW % (32 * NJ) == 0,
                "a warp's columns lie in one TMA box");
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar))
               : "memory");
}

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
__device__ __forceinline__ void tma2d(float* dst, const CUtensorMap* map,
                                      int c0, int c1,
                                      unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<unsigned long long>(map)),
        "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Everything a CTA's stages need. The CTA takes the items (tile, slot)
// blockIdx.x, blockIdx.x + gridDim.x, ... of tile * 15 + slot < nitems.
// Each item takes nq stages: na of the first projection pass (d / BK), NB
// of the pitch unembed, as many again for the second pass and the duration.
struct Ctx {
  float* ring;                    // [NSTAGE][SF]
  unsigned long long* bars;       // [NSTAGE]
  const CUtensorMap* xmap;        // x k-major: (d rows, nbar 4S columns)
  const CUtensorMap* wmap;        // ck: (d rows, 15 D columns)
  const CUtensorMap* umap;        // packed unembeds: (H rows, NU columns)
  int nitems, d, na, nq, tid;
};

// Where stage q of the CTA's sequence lies: its item (tile, slot), and in
// the item's stages (pass 0, pitch, pass 1, duration) its pass and its index
// r in the pass (r < na: projection, else the unembed's stage r - na).
template <class G>
struct Stage {
  int item, pass, r;
  __device__ __forceinline__ Stage(const Ctx& cx, int q) {
    item = blockIdx.x + (q / cx.nq) * gridDim.x;
    const int ql = q % cx.nq;
    pass = ql >= cx.na + G::NB;
    r = ql - pass * (cx.na + G::NB);
  }
  __device__ __forceinline__ int tile() const { return item / NS; }
  __device__ __forceinline__ int slot() const { return item % NS; }
};

// Start the TMA copies of stage q into ring slot q % NSTAGE (thread 0): the
// projection's W_slot rows k0.. of this pass's half and the tile's x at
// features k0.. (k-major, as the products read it), or the unembed's rows
// k0.. of the drum and melodic unembeds (pass 0) or of the duration one.
template <class G>
__device__ __forceinline__ void issue(const Ctx& cx, int q) {
  const Stage<G> sg(cx, q);
  if (cx.tid != 0 || sg.item >= cx.nitems) return;
  float* st = cx.ring + (q % NSTAGE) * G::SF;
  unsigned long long* bar = cx.bars + q % NSTAGE;
  if (sg.r < cx.na) {
    const int k0 = sg.r * G::BK;
    mbar_expect(bar, (G::WF + G::XF) * 4);
#pragma unroll
    for (int i = 0; i < G::H / G::BW; ++i)
      tma2d(st + i * G::BK * G::BW, cx.wmap,
            sg.slot() * G::D + sg.pass * G::H + i * G::BW, k0, bar);
    tma2d(st + G::WF, cx.xmap, sg.tile() * G::ROWS, k0, bar);
  } else {
    const int k0 = (sg.r - cx.na) * BKU;
    if (sg.pass == 0) {
      mbar_expect(bar, 2 * BKU * UW * 4);
      tma2d(st, cx.umap, 0, k0, bar);
      tma2d(st + BKU * UW, cx.umap, UW, k0, bar);
    } else {
      mbar_expect(bar, BKU * UW * 4);
      tma2d(st, cx.umap, 2 * UW, k0, bar);
    }
  }
}

// Wait for stage q, then (everyone being past stage q - 1, whose slot is the
// next to fill) start stage q + NSTAGE - 1. Returns stage q's slot.
template <class G>
__device__ __forceinline__ const float* begin(const Ctx& cx, int q) {
  mbar_wait(cx.bars + q % NSTAGE, (q / NSTAGE) & 1);
  __syncthreads();
  issue<G>(cx, q + NSTAGE - 1);
  return cx.ring + (q % NSTAGE) * G::SF;
}

// The parked half is k-major, hbuf[k][row ^ swz(k)]: the XOR moves the
// float4 groups of rows by the column group k / 4, so the 8 threads that store
// 8 neighbouring column groups of the same rows hit 8 different bank groups
// (a thread's rows, 8 or 4 from a multiple of 4, stay together).
__device__ __forceinline__ int swz(int k) { return ((k >> 2) & 7) << 2; }

// One projection pass (q0: its first stage): acc = x_tile @ W_slot[:, half]
// for the thread's rows r0 .. r0 + 7 and columns c0 + 32 j .. + 3 (j < NJ),
// then h = acc + b_slot parked in hbuf [H][RP], swizzled.
template <class G>
__device__ __forceinline__ void project(const Ctx& cx, int q0, float* hbuf,
                                        const float* bslot, int r0, int c0) {
  constexpr int NC = 4 * G::NJ;
  float acc[8][NC];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[r][c] = 0.f;
  // the thread's columns in a stage's weights [H / BW boxes][BK][BW]
  const int woff = (c0 / G::BW) * G::BK * G::BW + c0 % G::BW;
#pragma unroll 1
  for (int s = 0; s < cx.na; ++s) {
    const float* st = begin<G>(cx, q0 + s);
    const float* ws = st + woff;
    const float* xs = st + G::WF + r0;
#pragma unroll 8
    for (int k = 0; k < G::BK; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(xs + k * G::RP);
      const float4 a1 = *reinterpret_cast<const float4*>(xs + k * G::RP + 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float bv[NC];
#pragma unroll
      for (int j = 0; j < G::NJ; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(ws + k * G::BW + 32 * j);
        bv[4 * j] = b.x; bv[4 * j + 1] = b.y;
        bv[4 * j + 2] = b.z; bv[4 * j + 3] = b.w;
      }
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(av[r], bv[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int j = 0; j < G::NJ; ++j) {
    const float4 bb = __ldg(reinterpret_cast<const float4*>(bslot + c0 + 32 * j));
    const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = c0 + 32 * j + e, c = 4 * j + e;
      float* hp = hbuf + col * G::RP;
      *reinterpret_cast<float4*>(hp + (r0 ^ swz(col))) =
          make_float4(acc[0][c] + bv[e], acc[1][c] + bv[e],
                      acc[2][c] + bv[e], acc[3][c] + bv[e]);
      *reinterpret_cast<float4*>(hp + ((r0 + 4) ^ swz(col))) =
          make_float4(acc[4][c] + bv[e], acc[5][c] + bv[e],
                      acc[6][c] + bv[e], acc[7][c] + bv[e]);
    }
  }
}

// UR consecutive rows (from a multiple of UR) of feature k of the parked half
template <class G>
__device__ __forceinline__ void load_rows(float (&a)[G::UR], const float* hbuf,
                                          int k, int r0) {
  const float* p = hbuf + k * G::RP + (r0 ^ swz(k));
  if constexpr (G::UR == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    a[0] = v.x; a[1] = v.y; a[2] = v.z; a[3] = v.w;
  } else if constexpr (G::UR == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    a[0] = v.x; a[1] = v.y;
  } else {
    a[0] = *p;
  }
}

// One unembed (q0: its first stage) over the parked half: logits for the
// thread's rows r0 .. r0 + UR - 1 and columns c2 + 16 j + e (j < NV, e < 2)
// of box `box` of each stage, plus bias; the argmax of each row over the
// columns below v goes to ids[row * NS * 2 + kind] (ids at the tile's first
// cell, this slot) for the rows below nrow, the tile's cells.
template <class G, int NV>
__device__ __forceinline__ void unembed(const Ctx& cx, int q0,
                                        const float* hbuf, int box,
                                        const float* bias, int v, int r0,
                                        int c2, int* ids, int kind,
                                        int nrow) {
  constexpr int UR = G::UR;
  float acc[UR][2 * NV];
#pragma unroll
  for (int r = 0; r < UR; ++r)
#pragma unroll
    for (int c = 0; c < 2 * NV; ++c) acc[r][c] = 0.f;
#pragma unroll 1
  for (int s = 0; s < G::NB; ++s) {
    const float* us = begin<G>(cx, q0 + s) + box * BKU * UW + c2;
#pragma unroll
    for (int k = 0; k < BKU; ++k) {
      float a[UR];
      load_rows<G>(a, hbuf, s * BKU + k, r0);
      float bv[2 * NV];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float2 b = *reinterpret_cast<const float2*>(us + k * UW + 16 * j);
        bv[2 * j] = b.x; bv[2 * j + 1] = b.y;
      }
#pragma unroll
      for (int r = 0; r < UR; ++r)
#pragma unroll
        for (int c = 0; c < 2 * NV; ++c) acc[r][c] = fmaf(a[r], bv[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < UR; ++r) {
    float best = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int c = 0; c < 2 * NV; ++c) {  // the thread's columns, ascending
      const int col = c2 + 16 * (c >> 1) + (c & 1);
      if (col < v) {
        const float val = acc[r][c] + __ldg(bias + col);
        if (val > best) { best = val; bi = col; }
      }
    }
#pragma unroll
    for (int off = 1; off < 8; off <<= 1) {  // the 8 lanes of the row
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    if (c2 == 0 && r0 + r < nrow) ids[(size_t)(r0 + r) * NS * 2 + kind] = bi;
  }
}

template <int ROWS, int NJ>
__global__ void __launch_bounds__(THREADS, 1)
chord_tail_fp32_kernel(const float* __restrict__ cb,
                       const float* __restrict__ ub, int* __restrict__ ids,
                       int nitems, int ncells, int S, int d, int vp, int vd,
                       const __grid_constant__ CUtensorMap xmap,
                       const __grid_constant__ CUtensorMap wmap,
                       const __grid_constant__ CUtensorMap umap) {
  using G = Geo<ROWS, NJ>;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem_raw);
  float* ring = reinterpret_cast<float*>(smem_raw + 128);
  float* hbuf = ring + NSTAGE * G::SF;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 3, c = lane & 7;
  const int na = d / G::BK;
  const Ctx cx{ring, bars, &xmap, &wmap, &umap, nitems, d, na,
               2 * (na + G::NB), tid};
  if (tid == 0) {
    for (int i = 0; i < NSTAGE; ++i) mbar_init(&bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int q = 0; q < NSTAGE - 1; ++q) issue<G>(cx, q);

  // projection: warp (rw, wc) owns rows rw*32 + g*8 .. + 7 and columns
  // wc*32NJ + c*4 + 32j of each half
  const int pr0 = (warp / G::CW) * 32 + g * 8;
  const int pc0 = (warp % G::CW) * 32 * NJ + c * 4;
  // unembed: warp w owns rows w*4UR + g*UR .. + UR - 1, all of one track
  const int ur0 = warp * 4 * G::UR + g * G::UR;
  const int N = 4 * S;
  // the items of this CTA, one after the other; the ring runs on across
  // them, so the next item's first stages load under this one's last
  for (int q0 = 0;; q0 += cx.nq) {
    const Stage<G> it(cx, q0);
    if (it.item >= nitems) break;
    const int tile = it.tile(), slot = it.slot();
    const int trk = (int)(((long long)tile * ROWS + ur0) % N) / S;
    const int nrow = ncells - tile * ROWS;
    int* out = ids + ((size_t)tile * ROWS * NS + slot) * 2;
    const float* bslot = cb + (size_t)slot * G::D;
    project<G>(cx, q0, hbuf, bslot, pr0, pc0);
    unembed<G, NVP>(cx, q0 + na, hbuf, trk == 0 ? 0 : 1,
                    ub + (trk == 0 ? 0 : UW), vp, ur0, 2 * c, out, 0, nrow);
    project<G>(cx, q0 + na + G::NB, hbuf, bslot + G::H, pr0, pc0);
    unembed<G, NVD>(cx, q0 + 2 * na + G::NB, hbuf, 0, ub + 2 * UW, vd,
                    ur0, 2 * c, out, 1, nrow);
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

// A row-major fp32 matrix (rows x cols) read in boxes of [box_rows][box_cols].
static bool matrix_map(CUtensorMap* map, const void* base, int rows,
                       long long cols, int box_rows, int box_cols) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base),
             dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int ROWS, int NJ>
static int launch(const void* x, const void* ck, const void* cb,
                  const void* u, const void* ub, void* ids, int ncells,
                  int S, int d, int vp, int vd, cudaStream_t stream) {
  using G = Geo<ROWS, NJ>;
  auto kernel = chord_tail_fp32_kernel<ROWS, NJ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap = {}, wmap = {}, umap = {};
  if (!matrix_map(&xmap, x, d, ncells, G::BK, ROWS) ||
      !matrix_map(&wmap, ck, d, NS * G::D, G::BK, G::BW) ||
      !matrix_map(&umap, u, G::H, NU, BKU, UW))
    return (int)cudaErrorInvalidValue;
  // one CTA per SM, each walking the items (tile, slot) in a stride
  const int nitems = (ncells + ROWS - 1) / ROWS * NS;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  kernel<<<nitems < sms ? nitems : sms, THREADS, G::SMEM, stream>>>(
      (const float*)cb, (const float*)ub, (int*)ids, nitems, ncells, S, d, vp,
      vd, xmap, wmap, umap);
  return (int)cudaGetLastError();
}

// Every tensor fp32 and contiguous: x k-major, (d, nbar 4 S) (the flat
// (nbar 4 S, d) cells transposed); ck (d, 15 D) and cb (15 D), each slot's
// columns zero-padded from d to D = 2 H, the tile's width; u (H, 432) the
// drum, melodic and duration unembeds, each zero-padded to 144 columns and
// to H rows; ub (432) their biases, padded alike; ids (nbar, 4, S, 15, 2)
// int32. S % 4 == 0 and 15 nbar 4 S < 2^31; d is a multiple of 128 up to
// 1536; H is 64, 128, 192, 256 for
// d <= 512, 384 for d = 640, 768, 512 for d = 896, 1024 and 768 above
// (`chord_tail.HALF_WIDTHS`); vp <= 144, vd <= 112.
extern "C" int chord_tail_fp32_launch(const void* x, const void* ck,
                                      const void* cb, const void* u,
                                      const void* ub, void* ids, int nbar,
                                      int S, int d, int n_slots, int vp,
                                      int vd, void* stream) {
  if (nbar <= 0) return 0;
  if (n_slots != NS || vp < 1 || vp > 2 * 8 * NVP || vd < 1 ||
      vd > 2 * 8 * NVD || d % 128 != 0 || d < 128 || d > 1536 || S < 4 ||
      S % 4 != 0 || (long long)nbar * 4 * S * NS > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
#define LAUNCH(ROWS, NJ) \
  launch<ROWS, NJ>(x, ck, cb, u, ub, ids, nbar * 4 * S, S, d, vp, vd, s)
  switch (d) {
    case 128: return LAUNCH(128, 1);
    case 256: return LAUNCH(128, 2);
    case 384: return LAUNCH(128, 3);
    case 512: return LAUNCH(128, 4);
    case 640: case 768: return LAUNCH(64, 3);
    case 896: case 1024: return LAUNCH(64, 4);
    default: return LAUNCH(32, 3);
  }
#undef LAUNCH
}
