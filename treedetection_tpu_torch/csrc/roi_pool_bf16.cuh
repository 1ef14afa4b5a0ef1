// One box's pooling in bfloat16 on Hopper's tensor cores, shared by the flat
// pooler (roi_pool_flat.cu, K1), the per-level pooler (roi_pool_levels.cu,
// K5) and the image-resident pooler (roi_pool_resident.cu, K6):
//
//     out = A_y . window . A_x^T,   window = base[row0 : row0+P, col0 : col0+P+8, c]
//
// for the kSlice channels from c0 on.  The three kernels differ only in where
// `base` points (K1: the level-concatenated buffer; K5: the box's level
// buffer; K6: the image's section of it) and how far it may be read; every
// instruction below is the same in all three, so on the same boxes, hats and
// cells they give the same bits.
// Rounding is the TPU kernels' (treedetection_tpu/ops/pallas/
// roi_align_kernel.py): hats and the intermediate t = A_y . window rounded to
// bf16, both contractions accumulated in fp32, the output rounded once.
//
// What bounds it: memory.  At the example geometry (1024^2 input, batch 10,
// C=256) the box pool (N=5120, R=7) and the mask pool (N=1000, R=14) touch
// about 1 GB of features between them; the arithmetic is under 10 GFLOP on
// the hats' spans, a few microseconds of the tensor cores.  What the design
// does about it:
//   * Span.  A box's hats are nonzero on a span of about 17 x 20 of the
//     48 x 56 window (synthetic crowns), so the block first reduces the
//     nonzero row span [y_lo, y_hi] of A_y and column span [x_lo, x_hi] of
//     A_x and reads and contracts only that.  Zero weights add exactly
//     nothing to a finite sum, so the result is the whole window's; but a
//     non-finite feature outside the span no longer reaches the output.
//     A box whose hats are all zero (padding) writes zeros.
//   * Staging.  The span is cut into items of 16 window rows x 16 columns x
//     32 channels, copied to shared memory with cp.async, 16 bytes (8
//     channels) per copy, coalesced along C, in a ring of kStages slots with
//     two items in flight while one is contracted.  Cells outside the span
//     or outside [0, buf_rows) x [0, width) of the buffer are zero-filled
//     (src-size 0), never read.
//   * Phase 1 on tensor cores: t[r, (x, c)] = sum_y A_y[r, y] W[y, x, c] as
//     mma.sync m16n8k16 (bf16 in, fp32 accumulate) with the window on the M
//     side (16 channels of one column per m-tile) and R on the N side, so
//     R = 7 fills 7 of 8 columns and R = 14 fills 14 of 16; K = the 16
//     window rows of an item.  A comes from the stage by ldmatrix.trans, B
//     from the bf16 hats by ldmatrix.  After the last row chunk of a column
//     group, t is rounded to bf16 into shared memory.
//   * Phase 2 on tensor cores: out[i, j, c] = sum_x t[i, x, c] A_x[j, x] per
//     16-column group, with the channels on the M side and j on the N side,
//     accumulated in registers across column groups; rounded once at the end
//     and written through shared memory as 16-byte stores along C.
//   * Grid (K1's and K5's): one block of 8 warps per (box, 32-channel
//     slice), boxes fastest, so that one slice of the features (1/8 of them
//     at C = 256) is L2's working set at a time.  K6 keeps its own
//     image-ordered grid and calls this for a few boxes per block in turn,
//     with a barrier between calls.  About 63 KB (R = 7) or 72 KB
//     (R = 14) of shared memory and at most 128 registers a thread
//     (__launch_bounds__(kBf16Threads, 2)): two blocks per SM at any span.
//
// wgmma (64-row tiles, larger than one box's R) and TMA (a tensor map built on
// the host) are not used.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstddef>
#include <cstdint>

namespace roi_pool {

using bf16 = __nv_bfloat16;

constexpr int kSlice = 32;                  // channels per block
constexpr int kWarps = 8;
constexpr int kBf16Threads = 32 * kWarps;
constexpr int kStages = 3;                  // ring slots: two items in flight
constexpr int kTile = 16;                   // window rows (mma k) and columns per item
constexpr int kMaxPatch = 48;               // rows of the largest window
constexpr int kHatPitch = 72;               // hat row: 64 columns + 8 pad (elements)
constexpr int kStageRow = kTile * kSlice + 8;       // one window row of an item, padded
constexpr int kStageElems = kTile * kStageRow;
constexpr int kTCol = kSlice + 8;           // one column of t, padded
constexpr int kTRow = kTile * kTCol;        // one row r of t (a column group)
// The paddings put the 8 rows an ldmatrix reads 16 bytes apart in the bank
// space (1040, 80 and 144 bytes of pitch), so no read conflicts.

template <int R>
struct Plan {
  static constexpr int kNT = R <= 8 ? 1 : 2;                // n-tiles of 8
  static constexpr int kMTiles = kTile * (kSlice / 16);     // phase 1 m-tiles
  static constexpr int kMPerWarp = kMTiles / kWarps;
  static constexpr int kPairs = R * (kSlice / 16);          // phase 2 (i, c16)
  static constexpr int kPPerWarp = (kPairs + kWarps - 1) / kWarps;
  static_assert(kMTiles % kWarps == 0, "phase 1 m-tiles split over the warps");
  static_assert(R * R * kSlice <= kStages * kStageElems,
                "the output tile reuses the stage ring");
};

// Dynamic shared memory of one block of pool_box_bf16<R>, in bytes.
template <int R>
constexpr size_t bf16_smem_bytes() {
  return sizeof(bf16) * (static_cast<size_t>(kStages) * kStageElems +
                         static_cast<size_t>(R) * kTRow + 2 * 16 * kHatPitch) +
         4 * sizeof(int);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}
__device__ __forceinline__ void ldmatrix_x2(unsigned (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// d += a . b, m16n8k16, bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The B fragments of the kNT n-tiles for k = [k0, k0+16) from bf16 hats
// stored [n][k] (pitch kHatPitch): b[nt] = {k 0-7, k 8-15} of n-tile nt.
template <int NT>
__device__ __forceinline__ void load_b(unsigned (&b)[NT][2], const bf16* hats,
                                       int k0, int lane) {
  if constexpr (NT == 1) {
    ldmatrix_x2(b[0], hats + (lane & 7) * kHatPitch + k0 + ((lane >> 3) & 1) * 8);
  } else {
    unsigned r[4];
    ldmatrix_x4(r, hats + ((lane & 7) + ((lane >> 4) << 3)) * kHatPitch + k0 +
                       ((lane >> 3) & 1) * 8);
    b[0][0] = r[0];
    b[0][1] = r[1];
    b[1][0] = r[2];
    b[1][1] = r[3];
  }
}

// The A fragment of a 16 (m) x 16 (k) tile stored k-major: `base` points at
// (k 0, m 0), `pitch` is the distance between k rows (elements).
__device__ __forceinline__ void load_a_trans(unsigned (&a)[4], const bf16* base,
                                             int pitch, int lane) {
  ldmatrix_x4_trans(a, base + ((lane & 7) + ((lane >> 4) << 3)) * pitch +
                           ((lane >> 3) & 1) * 8);
}

__device__ __forceinline__ bool nonzero_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v)) != 0.f;
}

// Pool one box for channels [c0, min(c0 + kSlice, channels)).  `base` is a
// (buf_rows, width, channels) NHWC buffer; the window's origin in it is
// (row0, col0), and cells outside the buffer read as zeros.  `ay_box`
// (R, patch) and `ax_box` (R, patch + 8) are the box's float32 hats,
// `out_box` its (R, R, channels) output; `smem` holds bf16_smem_bytes<R>()
// bytes, 16-byte aligned.  Every thread of a block of kBf16Threads calls it;
// a block that calls it again for another box puts a barrier between the
// calls (it writes its span before its first barrier and may return without
// one).  `base` and C must keep every 8-channel vector 16-byte aligned, and
// patch is at most kMaxPatch (the caller checks both).
template <int R>
__device__ __forceinline__ void pool_box_bf16(
    const bf16* __restrict__ base, int buf_rows, int width, int channels,
    int c0, int row0, int col0, const float* __restrict__ ay_box,
    const float* __restrict__ ax_box, bf16* __restrict__ out_box, int patch,
    unsigned char* smem) {
  using P = Plan<R>;
  constexpr int NT = P::kNT;
  bf16* s_stage = reinterpret_cast<bf16*>(smem);  // [kStages][16][kStageRow]
  bf16* s_t = s_stage + kStages * kStageElems;      // [R][16][kTCol]
  bf16* s_ay = s_t + R * kTRow;                     // [16][kHatPitch]
  bf16* s_ax = s_ay + 16 * kHatPitch;               // [16][kHatPitch]
  int* s_span = reinterpret_cast<int*>(s_ax + 16 * kHatPitch);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int cpatch = patch + 8;
  constexpr int kVec = kSlice / 8;  // 16-byte vectors per (cell, slice)

  // 1. the nonzero spans of the bf16-rounded hats
  if (tid < 4) s_span[tid] = (tid & 1) ? -1 : INT_MAX;
  __syncthreads();
  int ylo = INT_MAX, yhi = -1, xlo = INT_MAX, xhi = -1;
  for (int i = tid; i < R * patch; i += kBf16Threads) {
    if (nonzero_bf16(ay_box[i])) {
      const int y = i % patch;
      ylo = min(ylo, y);
      yhi = max(yhi, y);
    }
  }
  for (int i = tid; i < R * cpatch; i += kBf16Threads) {
    if (nonzero_bf16(ax_box[i])) {
      const int x = i % cpatch;
      xlo = min(xlo, x);
      xhi = max(xhi, x);
    }
  }
  ylo = __reduce_min_sync(0xffffffffu, ylo);
  yhi = __reduce_max_sync(0xffffffffu, yhi);
  xlo = __reduce_min_sync(0xffffffffu, xlo);
  xhi = __reduce_max_sync(0xffffffffu, xhi);
  if (lane == 0) {
    atomicMin(&s_span[0], ylo);
    atomicMax(&s_span[1], yhi);
    atomicMin(&s_span[2], xlo);
    atomicMax(&s_span[3], xhi);
  }
  __syncthreads();
  ylo = s_span[0];
  yhi = s_span[1];
  xlo = s_span[2];
  xhi = s_span[3];
  if (yhi < 0 || xhi < 0) {  // all-zero hats: the output is zero
    for (int i = tid; i < R * R * kVec; i += kBf16Threads) {
      const int c = c0 + (i % kVec) * 8;
      if (c < channels)
        *reinterpret_cast<uint4*>(out_box + (i / kVec) * channels + c) =
            make_uint4(0, 0, 0, 0);
    }
    return;
  }
  const int kchunks = (yhi - ylo + kTile) / kTile;
  const int items = ((xhi - xlo + kTile) / kTile) * kchunks;

  // 2. the hats from the span's corner on, rounded to bf16, zero elsewhere
  for (int i = tid; i < 16 * kHatPitch; i += kBf16Threads) {
    const int r = i / kHatPitch;
    const int k = i - r * kHatPitch;
    const bool live = r < R;
    s_ay[i] = __float2bfloat16(live && ylo + k <= yhi ? ay_box[r * patch + ylo + k]
                                                      : 0.f);
    s_ax[i] = __float2bfloat16(live && xlo + k <= xhi ? ax_box[r * cpatch + xlo + k]
                                                      : 0.f);
  }

  // item = (column group g, row chunk k): 16 rows x 16 columns x kSlice
  // channels of the window from (ylo + 16k, xlo + 16g) on
  auto issue = [&](int item) {
    const int g = item / kchunks;
    const int k = item - g * kchunks;
    bf16* dst = s_stage + (item % kStages) * kStageElems;
    const int wy0 = ylo + kTile * k;
    const int wx0 = xlo + kTile * g;
#pragma unroll
    for (int j = 0; j < kTile * kTile * kVec / kBf16Threads; ++j) {
      const int idx = tid + j * kBf16Threads;
      const int q = idx % kVec;
      const int x = (idx / kVec) % kTile;
      const int y = idx / (kVec * kTile);
      const int gy = row0 + wy0 + y;
      const int gx = col0 + wx0 + x;
      const int c = c0 + q * 8;
      const bool real = wy0 + y <= yhi && wx0 + x <= xhi && gy >= 0 &&
                        gy < buf_rows && gx >= 0 && gx < width && c < channels;
      const bf16* src =
          real ? base + (static_cast<size_t>(gy) * width + gx) * channels + c
               : base;
      cp_async16(dst + y * kStageRow + x * kSlice + q * 8, src, real ? 16 : 0);
    }
  };

  float acc1[P::kMPerWarp][NT][4];
  float acc2[P::kPPerWarp][NT][4];
#pragma unroll
  for (int m = 0; m < P::kMPerWarp; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc1[m][n][e] = 0.f;
#pragma unroll
  for (int p = 0; p < P::kPPerWarp; ++p)
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[p][n][e] = 0.f;

  // fragment coordinates of this lane in a 16 x 8 accumulator tile
  const int frag_m = lane >> 2;
  const int frag_n = 2 * (lane & 3);

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < items) issue(s);
    cp_async_commit();
  }
  for (int item = 0; item < items; ++item) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // item's stage landed for every thread; its slot's
                      // previous contents are consumed
    if (item + kStages - 1 < items) issue(item + kStages - 1);
    cp_async_commit();

    const int g = item / kchunks;
    const int k = item - g * kchunks;
    const bf16* st = s_stage + (item % kStages) * kStageElems;

    // phase 1: t[r, (x, c)] += A_y[r, 16k : 16k+16] . W[16 rows, x, c]
    unsigned b[NT][2];
    load_b<NT>(b, s_ay, kTile * k, lane);
#pragma unroll
    for (int mi = 0; mi < P::kMPerWarp; ++mi) {
      const int m = warp * P::kMPerWarp + mi;
      const int x = m / (kSlice / 16);
      const int ct = m % (kSlice / 16);
      unsigned a[4];
      load_a_trans(a, st + x * kSlice + ct * 16, kStageRow, lane);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) mma_bf16(acc1[mi][nt], a, b[nt]);
    }
    if (k != kchunks - 1) continue;

    // the column group is complete: round t to bf16 into shared memory
#pragma unroll
    for (int mi = 0; mi < P::kMPerWarp; ++mi) {
      const int m = warp * P::kMPerWarp + mi;
      const int x = m / (kSlice / 16);
      const int c = (m % (kSlice / 16)) * 16 + frag_m;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int r = nt * 8 + frag_n + e;
          if (r < R) {
            s_t[r * kTRow + x * kTCol + c] = __float2bfloat16(acc1[mi][nt][e]);
            s_t[r * kTRow + x * kTCol + c + 8] =
                __float2bfloat16(acc1[mi][nt][e + 2]);
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc1[mi][nt][e] = 0.f;
      }
    }
    __syncthreads();

    // phase 2: out[i, j, c] += sum_x t[i, x, c] A_x[j, 16g + x]
    load_b<NT>(b, s_ax, kTile * g, lane);
#pragma unroll
    for (int pi = 0; pi < P::kPPerWarp; ++pi) {
      const int p = warp + pi * kWarps;
      if (p < P::kPairs) {
        const int i = p / (kSlice / 16);
        const int ct = p % (kSlice / 16);
        unsigned a[4];
        load_a_trans(a, s_t + i * kTRow + ct * 16, kTCol, lane);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc2[pi][nt], a, b[nt]);
      }
    }
    // s_t is written again only after the next item's barrier
  }

  // 3. round the output once; out through shared memory (the stage ring)
  cp_async_wait<0>();
  __syncthreads();
  bf16* s_out = s_stage;  // [R][R][kSlice]
#pragma unroll
  for (int pi = 0; pi < P::kPPerWarp; ++pi) {
    const int p = warp + pi * kWarps;
    if (p < P::kPairs) {
      const int i = p / (kSlice / 16);
      const int c = (p % (kSlice / 16)) * 16 + frag_m;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = nt * 8 + frag_n + e;
          if (j < R) {
            s_out[(i * R + j) * kSlice + c] = __float2bfloat16(acc2[pi][nt][e]);
            s_out[(i * R + j) * kSlice + c + 8] =
                __float2bfloat16(acc2[pi][nt][e + 2]);
          }
        }
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < R * R * kVec; i += kBf16Threads) {
    const int ij = i / kVec;
    const int q = i % kVec;
    const int c = c0 + q * 8;
    if (c < channels)
      *reinterpret_cast<uint4*>(out_box + ij * channels + c) =
          *reinterpret_cast<const uint4*>(s_out + ij * kSlice + q * 8);
  }
}

// Checks a bf16 launcher makes before launching: C a multiple of 8 (16-byte
// copies) and at most a kMaxPatch-row window (the hat tiles hold 64 columns
// from the span's corner on).
inline bool bf16_shape_ok(int channels, int patch) {
  return channels % 8 == 0 && patch >= 1 && patch <= kMaxPatch;
}

}  // namespace roi_pool
