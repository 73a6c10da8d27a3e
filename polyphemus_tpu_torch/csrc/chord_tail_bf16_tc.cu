// Chord tail in bf16 on the tensor cores: chord decode -> unembed -> argmax,
// token ids only.
//
// Replaces, in bf16, the Pallas kernel `_kernel` of
// polyphemus_tpu/ops/kernels/chord_tail.py (its pallas_call at :101, the body
// at :27-50, reached through `chord_tail_tokens`); the fp32 form is
// `chord_tail_fp32.cu`. For each cell of each bar and each of the 15 note
// slots:
//
//   h     = x @ W_slot + b_slot          (d values; W_slot = ck[:, sd:(s+1)d])
//   pitch = h[:d/2] @ P + pb             (P: the drum unembed on track 0, the
//                                         melodic one on tracks 1-3)
//   dur   = h[d/2:] @ D + db
//   ids   = (argmax pitch, argmax dur)   first index among equal maxima
//
// Only the int32 ids reach device memory, in the (bar, 4, S, 15, 2) layout of
// the JAX function, for bars of 4 x S cells at any S that is a multiple of 4
// (the JAX kernel reads t, s and d from x's shape, chord_tail.py:65-69). It computes what the Pallas body computes for a bf16 x:
// the projection multiplies bf16 x by bf16 W_slot and sums in fp32, plus the
// fp32 bias; h stays fp32 and is never rounded to bf16; the unembeds take that
// fp32 h against bf16-valued weights, summed in fp32, plus fp32 biases. On the
// tensor cores (mma.sync m16n8k16, bf16 -> fp32) the unembeds take h as three
// bf16 parts, h = h1 + h2 + h3, each the bf16 rounding of what the parts
// before it leave: exact for a normal fp32 h, so every product is exact and
// only the order of the fp32 sums differs from the plain version
// (`ops/kernels/chord_tail.py::chord_tail_plain`). No TF32.
//
// What bounds it on an H100: operations. Per cell and slot the function is
// 2 d^2 + 2 (d/2) (131 + 99) flops (0.64 MFLOP at d = 512), so a 512-bar
// launch needs 631 GFLOP counted once: 0.638 ms at the bf16 tensor cores'
// 989 TFLOP/s. With the three-part unembed it is 863 GFLOP, 0.87 ms. Each
// item also streams its slot's d x d weights (0.5 MiB at d = 512) and the
// unembeds through shared memory from L2; the 15 slot weights (7.5 MiB) stay
// there.
//
// Design, one persistent CTA of 8 warps per SM (up to 255 registers a
// thread), walking the items (tile, slot) with the slot as the fast axis, so
// the 15 items of a tile run together on 15 SMs and its x is read from device
// memory about once:
// - A tile is ROWS rows of the flat axis of the nbar x 4S cells: 128 for
//   d <= 512, 64 for d = 640-1024, 32 above; the last one is padded (its x
//   rows past the cells come in as zeros, the TMA's fill, and their ids are
//   not stored), so a tile needs no whole bar and any S works. It computes a half-width H of 64, 128, 192, 256, 384,
//   512 or 768 columns; a width whose half lies between two of them runs in
//   the next one up, on weights the wrapper zero-pads (`chord_tail.pack`): a padded
//   column of h is an exact zero and meets zero unembed rows.
// - Each half of h that an unembed reads is one pass. Its projection is a
//   tensor-core GEMM of ROWS x H, warps of 64 x 64 (2 x 4 warps; 64-row and
//   32-row tiles: 1 x 8) with 4 x 8 m16n8 accumulators a thread. h = acc +
//   b_slot is parked in shared memory in fp32 (135 KB at d = 512), so the
//   accumulators and the logits are never live together.
// - The unembed: each warp takes 16 rows of the parked half and every
//   vocabulary column (144 pitch or 112 duration, the
//   wrapper's zero-padded packing), 72 or 56 fp32 accumulators a thread. Its
//   A fragments are the parked h, read as fp32 and split into the three bf16
//   parts in registers; each part meets the same B fragment. The argmax takes
//   a thread's columns below the vocabulary edge, then the 4 threads of a row
//   through shuffles, the first index on ties. A warp's pitch unembed is its
//   rows' track's (the drum one on track 0). Where S % 16 != 0 (the MIX form)
//   16 rows may hold drum and melodic cells: such a warp multiplies the
//   drum unembed by A with its melodic rows zeroed, and the melodic one by A
//   with its drum rows zeroed, into the same sums; a zeroed row adds exact
//   zeros, so every row's logits are the ones a warp of its own track gets.
// - Every operand comes by TMA through one ring of 3 stages in shared memory,
//   one mbarrier a stage, in one sequence per item: per pass, d / BK
//   projection stages (BK = 32 features of the tile's x, row-major, and of
//   W_slot's H columns; 16 in 64- and 32-row tiles), then H / 32 stages of the
//   unembed rows. The ring runs on from one item to the next. The boxes land
//   with the TMA's 32-, 64- or 128-byte swizzle, so the 8 rows that an
//   ldmatrix (.trans for the row-major weights) reads touch 8 bank groups.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int THREADS = 256;   // 8 warps
constexpr int NS = 15;         // note slots
constexpr int NSTAGE = 3;      // ring stages
constexpr int BKU = 32;        // unembed rows (features of h) per stage
constexpr int BOX = 64;        // columns of a weight box: 128 bytes
constexpr int UW = 144;        // columns of each packed unembed
constexpr int UCOLS = 3 * UW;  // packed unembed row: drums | melodic | duration
constexpr int NVP = 18;        // pitch columns in 8-column tiles (144)
constexpr int NVD = 14;        // duration columns in 8-column tiles (112)
// an unembed stage's boxes: columns 0-319 of the packed unembed (the drum
// and melodic ones) or 288-415 (the duration one)
constexpr int UBP = 5, UBD = 2;

// The compile-time geometry of a tile of ROWS rows at (padded) half-width H.
// The input features (d) are a run-time multiple of BK. Byte offsets in
// shared memory: the mbarriers, the ring of stages (each the tile's x box,
// then H / 64 W_slot boxes; or an unembed stage's boxes), the parked half.
template <int ROWS_, int H_>
struct Geo {
  static constexpr int ROWS = ROWS_;
  static constexpr int H = H_;
  // projection: warps PWR along rows x PWC along columns, each PM x PN
  // m16n8 tiles
  static constexpr int PWR = ROWS == 128 ? 2 : 1;
  static constexpr int PWC = 8 / PWR;
  static constexpr int PM = ROWS / PWR / 16;
  static constexpr int PN = H / PWC / 8;
  static constexpr int BK = ROWS == 128 ? 32 : 16;  // features per stage
  static constexpr int HLD = H + 8;    // row stride of the parked half
  static constexpr int NB = H / BKU;             // unembed stages a half
  static constexpr int XB = ROWS * BK * 2;       // x box bytes
  static constexpr int PB = XB + H * BK * 2;     // projection stage bytes
  static constexpr int UB = UBP * BKU * BOX * 2;  // largest unembed stage
  static constexpr int SB = ((PB > UB ? PB : UB) + 1023) / 1024 * 1024;
  static constexpr int RING = 1024;
  static constexpr int HBUF = RING + NSTAGE * SB;
  static constexpr int SMEM = HBUF + ROWS * HLD * 4;
  static_assert(PN % 2 == 0 && H % BOX == 0 && H % BKU == 0, "tile shape");
  static_assert(XB % 1024 == 0, "W boxes start 1024-byte aligned");
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// The box at (c0 columns, c1 rows) of a 2-d tensor map into dst,
// completing on bar.
__device__ __forceinline__ void tma2d(void* dst, const CUtensorMap* map,
                                      int c0, int c1,
                                      unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<unsigned long long>(map)),
        "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) @ b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Element offsets in the boxes the TMA writes with its 32-, 64- or 128-byte
// swizzle (row bytes RB, boxes 1024-byte aligned): 16-byte chunk ch of row r
// lies at chunk ch ^ ((r / (128 / RB)) % (RB / 16)), so the 8 rows an
// ldmatrix reads touch 8 bank groups.
template <int RB>
__device__ __forceinline__ int swz(int r, int ch) {
  return r * (RB / 2) + ((ch ^ ((r / (128 / RB)) & (RB / 16 - 1))) << 3);
}

// Element (k, n) of a stage of 64-column boxes of `rows` rows each (W_slot
// or an unembed stage), at the start of n's 8-column chunk.
__device__ __forceinline__ int box_off(int k, int n, int rows) {
  return (n / BOX) * rows * BOX + swz<128>(k, (n % BOX) >> 3);
}

// Everything a CTA's stages need. The CTA takes the items (tile, slot)
// blockIdx.x, blockIdx.x + gridDim.x, ... of tile * 15 + slot < nitems.
// Each item takes nq = 2 (na + NB) stages: per half of h, na = d / BK
// projection stages, then NB unembed stages.
struct Ctx {
  unsigned char* ring;           // [NSTAGE][SB] bytes
  unsigned long long* bars;      // [NSTAGE]
  const CUtensorMap* xmap;       // x: (nbar 4 S rows, d), boxes ROWS x BK
  const CUtensorMap* wmap;       // ck: (d rows, 15 * 2H), boxes BK x 64
  const CUtensorMap* umap;       // u: (H rows, 432), boxes 32 x 64
  int nitems, na, nq, tid;
};

// Start the TMA copies of stage q into ring slot q % NSTAGE (thread 0),
// completing on the slot's mbarrier: a projection stage's BK features of
// the tile's x and of this half's H columns of W_slot, or an unembed
// stage's BKU rows of the drum and melodic unembeds (first half) or of the
// duration one.
template <class G>
__device__ __forceinline__ void issue(const Ctx& cx, int q) {
  const int item = blockIdx.x + (q / cx.nq) * gridDim.x;
  if (cx.tid != 0 || item >= cx.nitems) return;
  const int ql = q % cx.nq, per = cx.na + G::NB;
  const int half = ql >= per, r = ql - half * per;
  const int tile = item / NS, slot = item % NS;
  unsigned char* st = cx.ring + (q % NSTAGE) * G::SB;
  unsigned long long* bar = cx.bars + q % NSTAGE;
  if (r < cx.na) {
    const int k0 = r * G::BK;
    mbar_expect(bar, G::PB);
    tma2d(st, cx.xmap, k0, tile * G::ROWS, bar);
#pragma unroll
    for (int b = 0; b < G::H / BOX; ++b)
      tma2d(st + G::XB + b * G::BK * BOX * 2, cx.wmap,
            (2 * slot + half) * G::H + b * BOX, k0, bar);
  } else {
    const int k0 = (r - cx.na) * BKU, nbox = half ? UBD : UBP;
    mbar_expect(bar, nbox * BKU * BOX * 2);
    for (int b = 0; b < nbox; ++b)
      tma2d(st + b * BKU * BOX * 2, cx.umap, half * 2 * UW + b * BOX, k0,
            bar);
  }
}

// Wait for stage q, then (everyone being past stage q - 1, whose slot is the
// next to fill) start stage q + NSTAGE - 1. Returns stage q's slot.
template <class G>
__device__ __forceinline__ const bf16* begin(const Ctx& cx, int q) {
  mbar_wait(cx.bars + q % NSTAGE, (q / NSTAGE) & 1);
  __syncthreads();
  issue<G>(cx, q + NSTAGE - 1);
  return reinterpret_cast<const bf16*>(cx.ring + (q % NSTAGE) * G::SB);
}

// The three bf16 parts of 8 fp32 values, as the A fragments of a 16-deep
// product: c0 and c1 hold columns k .. k+7 and k+8 .. k+15 of 16 rows in
// the m16n8 accumulator layout. Part p + 1 is the bf16 rounding of what
// parts 0 .. p leave (exact differences), so the parts sum to the value.
__device__ __forceinline__ void split3(uint32_t (&a)[3][4],
                                       const float (&c0)[4],
                                       const float (&c1)[4]) {
  const float v[8] = {c0[0], c0[1], c0[2], c0[3], c1[0], c1[1], c1[2], c1[3]};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lo = v[2 * i], hi = v[2 * i + 1];
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      const __nv_bfloat162 b = __floats2bfloat162_rn(lo, hi);
      a[p][i] = *reinterpret_cast<const uint32_t*>(&b);
      const float2 f = __bfloat1622float2(b);
      lo -= f.x;
      hi -= f.y;
    }
  }
}

// One half of h (q: its first stage, advanced past it). The projection: the
// warp's PM x PN tiles at rows m0, columns n0 of x_tile @ W_slot[:, half],
// plus bias, parked in hbuf [ROWS][HLD] in fp32. The unembed (warps with
// um0 < ROWS): the 16 rows um0 .. against the NV 8-column tiles of the
// packed unembed at column ucol of each unembed stage, the parked half split
// into three bf16 parts as A; with `mixed` (MIX only), against the drum
// unembed (column 0) for the rows whose `drum` flag is set (the lane's rows
// g and g + 8) and the melodic one (column UW) for the others. Then per row
// the argmax over the columns below v plus that row's bias (ubias for row g,
// ubias8 for row g + 8), to out[row * 30 + kind] for the rows below nrow.
template <class G, int NV, bool MIX>
__device__ __forceinline__ void half_pass(const Ctx& cx, int& q, float* hbuf,
                                          const float* bias, int m0, int n0,
                                          int um0, int ucol,
                                          const float* ubias,
                                          const float* ubias8, int v,
                                          int* out, int kind, int nrow,
                                          bool mixed, const bool (&drum)[2]) {
  const int lane = cx.tid & 31, g = lane >> 2, t = lane & 3;
  {
    float acc[G::PM][G::PN][4];
#pragma unroll
    for (int mi = 0; mi < G::PM; ++mi)
#pragma unroll
      for (int j = 0; j < G::PN; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
#pragma unroll 1
    for (int s = 0; s < cx.na; ++s, ++q) {
      const bf16* xs = begin<G>(cx, q);
      const bf16* ws = xs + G::XB / 2;
#pragma unroll
      for (int kk = 0; kk < G::BK / 16; ++kk) {
        uint32_t a[G::PM][4];
#pragma unroll
        for (int mi = 0; mi < G::PM; ++mi)
          ldsm_x4(a[mi], xs + swz<G::BK * 2>(m0 + mi * 16 + (lane & 15),
                                             kk * 2 + (lane >> 4)));
        const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
        for (int jp = 0; jp < G::PN / 2; ++jp) {
          uint32_t b[4];
          ldsm_x4_t(b, ws + box_off(r, n0 + jp * 16 + (lane >> 4) * 8, G::BK));
#pragma unroll
          for (int mi = 0; mi < G::PM; ++mi) {
            mma_bf16(acc[mi][2 * jp], a[mi], b[0], b[1]);
            mma_bf16(acc[mi][2 * jp + 1], a[mi], b[2], b[3]);
          }
        }
      }
    }
    // h = acc + b_slot: element (mi, j, e) is row m0 + 16 mi + g + 8 (e / 2),
    // column n0 + 8 j + 2 t + e % 2
#pragma unroll
    for (int j = 0; j < G::PN; ++j) {
      const int col = n0 + 8 * j + 2 * t;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
#pragma unroll
      for (int mi = 0; mi < G::PM; ++mi)
#pragma unroll
        for (int hr = 0; hr < 2; ++hr)
          *reinterpret_cast<float2*>(
              hbuf + (m0 + mi * 16 + g + 8 * hr) * G::HLD + col) =
              make_float2(acc[mi][j][2 * hr] + bb.x,
                          acc[mi][j][2 * hr + 1] + bb.y);
    }
  }
  const bool active = um0 < G::ROWS;
  float lg[NV][4];
#pragma unroll
  for (int j = 0; j < NV; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) lg[j][e] = 0.f;
#pragma unroll 1
  for (int s = 0; s < G::NB; ++s, ++q) {
    const bf16* us = begin<G>(cx, q);
    if (!active) continue;
#pragma unroll
    for (int k2 = 0; k2 < BKU / 16; ++k2) {
      // A: rows g, g + 8 x columns 2 t, 2 t + 1 and 8 more of the parked
      // half, split into three bf16 parts
      const float* hp = hbuf + (um0 + g) * G::HLD + s * BKU + k2 * 16 + 2 * t;
      const float2 v0 = *reinterpret_cast<const float2*>(hp);
      const float2 v1 = *reinterpret_cast<const float2*>(hp + 8 * G::HLD);
      const float2 v2 = *reinterpret_cast<const float2*>(hp + 8);
      const float2 v3 = *reinterpret_cast<const float2*>(hp + 8 * G::HLD + 8);
      const float c0[4] = {v0.x, v0.y, v1.x, v1.y};
      const float c1[4] = {v2.x, v2.y, v3.x, v3.y};
      uint32_t a[3][4];
      split3(a, c0, c1);
      const int r = k2 * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
      if constexpr (MIX) {
        if (mixed) {
          // A fragment words 0, 2 hold row g, words 1, 3 row g + 8
          const uint32_t md = drum[0] ? ~0u : 0u, md8 = drum[1] ? ~0u : 0u;
#pragma unroll
          for (int jp = 0; jp < NV / 2; ++jp) {
#pragma unroll
            for (int u = 0; u < 2; ++u) {
              const uint32_t k = u == 0 ? md : ~md, k8 = u == 0 ? md8 : ~md8;
              uint32_t b[4];
              ldsm_x4_t(b, us + box_off(r, u * UW + (2 * jp + (lane >> 4)) * 8,
                                        BKU));
#pragma unroll
              for (int p = 0; p < 3; ++p) {
                const uint32_t am[4] = {a[p][0] & k, a[p][1] & k8,
                                        a[p][2] & k, a[p][3] & k8};
                mma_bf16(lg[2 * jp], am, b[0], b[1]);
                mma_bf16(lg[2 * jp + 1], am, b[2], b[3]);
              }
            }
          }
          continue;
        }
      }
#pragma unroll
      for (int jp = 0; jp < NV / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4_t(b, us + box_off(r, ucol + (2 * jp + (lane >> 4)) * 8, BKU));
#pragma unroll
        for (int p = 0; p < 3; ++p) {
          mma_bf16(lg[2 * jp], a[p], b[0], b[1]);
          mma_bf16(lg[2 * jp + 1], a[p], b[2], b[3]);
        }
      }
    }
  }
  if (!active) return;
  // argmax: a thread's columns (ascending), then the 4 threads of a row;
  // the first index among equal maxima
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {  // rows g and g + 8
    const float* ub = hr == 0 ? ubias : ubias8;
    float best = -CUDART_INF_F;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        if (col < v) {
          const float val = lg[j][2 * hr + e] + __ldg(ub + col);
          if (val > best) { best = val; bi = col; }
        }
      }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
    }
    if (t == 0 && um0 + g + 8 * hr < nrow)
      out[(size_t)(um0 + g + 8 * hr) * NS * 2 + kind] = bi;
  }
}

template <int ROWS, int H, bool MIX>
__global__ void __launch_bounds__(THREADS, 1)
chord_tail_bf16_tc_kernel(const float* __restrict__ cb,
                          const float* __restrict__ ub, int* __restrict__ ids,
                          int nitems, int ncells, int S, int d, int vp, int vd,
                          const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap wmap,
                          const __grid_constant__ CUtensorMap umap) {
  using G = Geo<ROWS, H>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  float* hbuf = reinterpret_cast<float*>(smem_raw + G::HBUF);
  const int tid = threadIdx.x, warp = tid >> 5;
  const int na = d / G::BK;
  const Ctx cx{smem_raw + G::RING,
               reinterpret_cast<unsigned long long*>(smem_raw), &xmap, &wmap,
               &umap, nitems, na, 2 * (na + G::NB), tid};
  if (tid == 0) {
    for (int i = 0; i < NSTAGE; ++i) mbar_init(&cx.bars[i]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int q = 0; q < NSTAGE - 1; ++q) issue<G>(cx, q);
  // projection: warp (warp / PWC, warp % PWC)
  const int m0 = (warp / G::PWC) * G::PM * 16;
  const int n0 = (warp % G::PWC) * G::PN * 8;
  // unembed: rows warp * 16 .. (warps past the tile's rows idle)
  const int um0 = warp * 16, g = (tid & 31) >> 2;
  const int N = 4 * S;
  for (int q = 0;;) {
    const int item = blockIdx.x + (q / cx.nq) * gridDim.x;
    if (item >= nitems) break;
    const int tile = item / NS, slot = item % NS;
    const int nrow = ncells - tile * ROWS;
    // the pitch unembed of the lane's rows g and g + 8: the drum one on
    // track 0; a MIX warp whose rows hold both kinds takes both
    const long long row = (long long)tile * ROWS + um0 + g;
    const bool drum[2] = {row % N < S, (row + 8) % N < S};
    const bool mixed =
        MIX && __any_sync(0xffffffffu, drum[0] || drum[1]) &&
        __any_sync(0xffffffffu, !drum[0] || !drum[1]);
    int* out = ids + ((size_t)tile * ROWS * NS + slot) * 2;
    const float* bslot = cb + (size_t)slot * 2 * H;
    const int ucol = drum[0] ? 0 : UW;
    half_pass<G, NVP, MIX>(cx, q, hbuf, bslot, m0, n0, um0, ucol,
                           ub + (drum[0] ? 0 : UW), ub + (drum[1] ? 0 : UW),
                           vp, out, 0, nrow, mixed, drum);
    half_pass<G, NVD, false>(cx, q, hbuf, bslot + H, m0, n0, um0, 0,
                             ub + 2 * UW, ub + 2 * UW, vd, out, 1, nrow,
                             false, drum);
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

// A row-major bf16 matrix (rows x cols) read in boxes of [box_rows]
// [box_cols], swizzled in shared memory by the box's row bytes (32, 64 or
// 128).
static bool matrix_map(CUtensorMap* map, const void* base, long long rows,
                       int cols, int box_rows, int box_cols) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t estr[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      box_cols == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
      : box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                       : CU_TENSOR_MAP_SWIZZLE_32B;
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, estr,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int ROWS, int H, bool MIX>
static int launch(const void* x, const void* ck, const void* cb,
                  const void* u, const void* ub, void* ids, int ncells, int S,
                  int d, int vp, int vd, cudaStream_t stream) {
  using G = Geo<ROWS, H>;
  auto kernel = chord_tail_bf16_tc_kernel<ROWS, H, MIX>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, G::SMEM);
  if (err != cudaSuccess) return (int)err;
  CUtensorMap xmap = {}, wmap = {}, umap = {};
  if (!matrix_map(&xmap, x, ncells, d, ROWS, G::BK) ||
      !matrix_map(&wmap, ck, d, NS * 2 * H, G::BK, BOX) ||
      !matrix_map(&umap, u, H, UCOLS, BKU, BOX))
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

// x (nbar, 4, S, d) bf16, contiguous; ck (d, 15 * 2H) bf16 and cb (15 * 2H)
// fp32, each half of each slot's columns zero-padded from d / 2 to H, the
// tile's half-width; u (H, 432) bf16: the drum, melodic and duration
// unembeds side by side, each zero-padded to 144 columns and to H rows; ub
// (432) fp32, their biases padded alike (`chord_tail.pack`); ids (nbar,
// 4, S, 15, 2) int32. S % 4 == 0 and 15 nbar 4 S < 2^31 (S % 16 != 0 takes
// the MIX form); d is a multiple of 128 up to 1536; H is 64, 128, 192,
// 256 for d <= 512, 384 for d = 640, 768, 512 for d = 896, 1024 and 768
// above (`chord_tail.HALF_WIDTHS`); vp <= 144, vd <= 112.
extern "C" int chord_tail_bf16_launch(const void* x, const void* ck,
                                      const void* cb, const void* u,
                                      const void* ub, void* ids, int nbar,
                                      int S, int d, int n_slots, int vp,
                                      int vd, void* stream) {
  if (nbar <= 0) return 0;
  if (n_slots != NS || vp < 1 || vp > 8 * NVP || vd < 1 || vd > 8 * NVD ||
      d % 128 != 0 || d < 128 || d > 1536 || S < 4 || S % 4 != 0 ||
      (long long)nbar * 4 * S * NS > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  const int nc = nbar * 4 * S;
#define LAUNCH(ROWS, H)                                                     \
  (S % 16 == 0                                                             \
       ? launch<ROWS, H, false>(x, ck, cb, u, ub, ids, nc, S, d, vp, vd, s) \
       : launch<ROWS, H, true>(x, ck, cb, u, ub, ids, nc, S, d, vp, vd, s))
  switch (d) {
    case 128: return LAUNCH(128, 64);
    case 256: return LAUNCH(128, 128);
    case 384: return LAUNCH(128, 192);
    case 512: return LAUNCH(128, 256);
    case 640: case 768: return LAUNCH(64, 384);
    case 896: case 1024: return LAUNCH(64, 512);
    default: return LAUNCH(32, 768);
  }
#undef LAUNCH
}
