// Pairwise box relations for Hopper (sm_90a): the relation as a mask or
// bit-packed, and the bit-packed relation compacted to its (i, j) pairs.
//
// Replaces the three TPU tile kernels of
// treedetection_tpu/ops/pallas/iou_kernel.py (`_iou_tile_kernel`,
// `_containment_tile_kernel`, `_dedupe_tile_kernel`, all run through
// `_run_tiled`): for row boxes a (R, W) and column boxes b (N, W), float32
// rows [x0, y0, x1, y1(, polygon area)], the relation
//
//   iou          rel[i][j] = IoU(a_i, b_j) > t0                    (0 where the union is 0)
//   containment  rel[i][j] = inter(a_i, b_j) / area(b_j) >= t0     (0 where area(b_j) is 0)
//   dedupe       rel[i][j] = IoU(a_i, b_j) > t0  AND
//                            |pa_i - pb_j| / max(pa_i, pb_j, 1e-9) < t1
//
// The result is a threshold test, so rounding decides entries.  The
// arithmetic keeps the order of operations of `_iou_terms` and of each tile
// kernel, every operation is a separately rounded IEEE float32 operation, and
// the file must be compiled with -fmad=false (no FMA contraction) and without
// -use_fast_math, so that the relation equals the one the plain PyTorch
// version computes with separate elementwise operations, bit for bit.
//
// What bounds it.  The caller (the crown filter's dedupe and containment
// relations, one row block of R = 8192 rows against all N columns at a time)
// keeps a few pairs per row: at N = 32768 synthetic crowns 0.07% of the pairs
// have a nonzero intersection and ~10^4 of the 2.7 * 10^8 are in the
// relation.  Written as a uint8 mask the block is 268 MB (0.08 ms at
// 3.35 TB/s) and the host's nonzero over it costs ~1 s; divided out for every
// pair, IEEE `div.rn` sets the time.  So:
//
// * `relation_kernel<MODE, FORM>` (K4 iou, K3 containment, K2 dedupe) first
//   asks whether a pair can meet at all.  Where inter == 0 the quotient (IoU
//   or inter / area_b) is exactly +-0 or the `where` branch's 0, so the hit
//   is `0 > t0` (IoU) or `0 >= t0` (containment) with no arithmetic; that
//   holds for every threshold, also t0 <= 0, where every non-meeting pair is
//   a hit.  For boxes whose coordinates are all below 2^126 in magnitude
//   (`safe_box`: differences stay finite) a pair that fails one of four
//   comparisons (ax1 > bx0, bx1 > ax0, ay1 > by0, by1 > ay0) has iw or ih 0
//   and so inter == 0 * finite == 0; a warp whose strip or columns hold
//   another box takes the whole formula for every pair.  The test is
//   warp-uniform (`__any_sync`): a warp computes the intersection and pays
//   for `div.rn` only when one of its 32 pairs may meet, and then every lane
//   takes the whole formula.  Dedupe's relative-area term is evaluated only
//   where the IoU test passes (the AND makes that exact).  A thread keeps
//   kWords column boxes in registers at a stride of 32 columns; each row of
//   the block's strip (staged in shared memory, read as broadcasts) gives
//   the warp kWords 32-column words (`__ballot_sync`), and a row none of
//   whose 256 pairs may meet costs 32 comparisons per lane and one vote.
//   What is left bounds it: those comparisons run at half the float32 rate,
//   so rows of 64 per block and three blocks per SM (at most 85 registers)
//   keep enough warps in flight.
//   FORM kBits writes the relation bit-packed, (R, pitch) uint8 with numpy's
//   `packbits` bit order (MSB first within each byte; `__brev` and a byte
//   swap turn a ballot word into it), zero-filled past N up to the pitch
//   (a multiple of 16 bytes): two lanes hold one row's eight words, so after
//   16 rows every lane stores 16 bytes and the warp 16 whole 32-byte
//   sectors.  FORM kBytes writes the (R, N) uint8 mask at a row pitch: the
//   ballot words already hold every bit of a row, so each lane keeps 16 bits
//   of one row of a pair of rows (lanes 0-15 the first, 16-31 the second),
//   expands them to 16 bytes in registers (`nibble_bytes`) and stores them
//   as one uint4: per pair of rows the warp writes two runs of 256
//   contiguous bytes, 16 whole sectors per store instruction, where a byte
//   per lane and column took 16 store instructions.  A row pitch or base
//   that is not a multiple of 16 bytes, and the chunk that N cuts, take
//   byte stores.
// * `row_count_kernel` and `row_pairs_kernel` compact a bit-packed block to
//   its pairs: a warp per row counts its bits (`__popc`, the bits past N and
//   the diagonal j == row_offset + i masked off); the caller scans the R
//   counts and reads the total once to size the output; then each row with
//   pairs places them at its offset in row-major order (np.nonzero's), each
//   lane by the warp's prefix sum of its word's count.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
enum Mode { kIou = 0, kContainment = 1, kDedupe = 2 };

__device__ __forceinline__ float box_area(float x0, float y0, float x1, float y1) {
  return fmaxf(x1 - x0, 0.0f) * fmaxf(y1 - y0, 0.0f);
}

// --- K2, K3, K4: the relation kernel ---------------------------------------

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = kThreads / 32;
constexpr int kWords = 8;                         // 32-column words per warp
constexpr int kRelSpan = kWarps * kWords * 32;    // columns per block (2048)
constexpr int kGroup = 16;                        // rows per packed store
constexpr int kRelStrip = 64;                     // rows per block
constexpr int kRelMinBlocks = 3;                  // blocks per SM (<= 85 regs)
// the packed store: two lanes per row, four words (16 bytes) each
static_assert(kWords == 8 && kGroup == 16, "kBits stores assume 8 x 16");

enum Form { kBytes = 0, kBits = 1 };

// A ballot word (bit l = column l) in numpy's packbits order as it lies in
// memory: column 8k + m at bit 7 - m of byte k.
__device__ __forceinline__ uint32_t packbits_order(uint32_t word) {
  return __byte_perm(__brev(word), 0, 0x0123);
}

__device__ __forceinline__ bool area_term_below(float pa, float pb, float t1) {
  return fabsf(pa - pb) / fmaxf(fmaxf(pa, pb), 1e-9f) < t1;
}

// The whole formula of one pair, divisions included, in the tile kernels'
// order of operations.
template <int MODE>
__device__ __forceinline__ bool full_hit(float inter, float aarea, float barea,
                                         float apoly, float bpoly, float t0,
                                         float t1) {
  if (MODE == kContainment) {
    const float ratio = barea > 0.0f ? inter / barea : 0.0f;
    return ratio >= t0;
  }
  const float uni = (aarea + barea) - inter;
  const float iou = uni > 0.0f ? inter / uni : 0.0f;
  bool hit = iou > t0;
  if (MODE == kDedupe && hit) hit = area_term_below(apoly, bpoly, t1);
  return hit;
}

// Every coordinate of the box below 2^126 in magnitude (so not NaN or
// infinite): differences of two such coordinates are finite, so a pair of
// such boxes that does not overlap on one axis has inter == 0 * finite == 0.
__device__ __forceinline__ bool safe_box(float x0, float y0, float x1,
                                         float y1) {
  constexpr float kSafe = 0x1p126f;
  return fabsf(x0) < kSafe && fabsf(y0) < kSafe && fabsf(x1) < kSafe &&
         fabsf(y1) < kSafe;
}

// Whether the pair may meet: it overlaps on both axes.  For safe boxes a
// superset of the pairs whose intersection is not 0 (four comparisons, no
// arithmetic).
__device__ __forceinline__ bool may_meet(const float* ra, float bx0, float by0,
                                         float bx1, float by1) {
  return (ra[2] > bx0) & (bx1 > ra[0]) & (ra[3] > by0) & (by1 > ra[1]);
}

// One 32-column word of the relation of one row box `ra` (x0, y0, x1, y1,
// box area, polygon area) against the lanes' column boxes: bit l is lane l's
// pair, bits outside `valid` (columns past N) are 0.  SAFE: the row and all
// the warp's columns are safe_box, so may_meet decides which pairs can have
// an intersection that is not 0; else every pair takes the whole formula.
template <int MODE, bool SAFE>
__device__ __forceinline__ uint32_t relation_word(
    const float* ra, float bx0, float by0, float bx1, float by1, float barea,
    float bpoly, uint32_t valid, bool zero_hit, float t0, float t1) {
  const bool meet = !SAFE || may_meet(ra, bx0, by0, bx1, by1);
  if (__any_sync(kFull, meet)) {
    const float iw = fmaxf(fminf(ra[2], bx1) - fmaxf(ra[0], bx0), 0.0f);
    const float ih = fmaxf(fminf(ra[3], by1) - fmaxf(ra[1], by0), 0.0f);
    const bool hit =
        full_hit<MODE>(iw * ih, ra[4], barea, ra[5], bpoly, t0, t1);
    return __ballot_sync(kFull, hit) & valid;
  }
  // no lane's pair meets: every quotient is exactly +-0
  if (MODE == kDedupe && zero_hit)
    return __ballot_sync(kFull, area_term_below(ra[5], bpoly, t1)) & valid;
  return zero_hit ? valid : 0u;
}

// Four bits (bit j = column j) as four bytes of 0 or 1 in column order: the
// shifted copies of the nibble (bits 0-3, 7-10, 14-17, 21-24) do not
// overlap, so bit j lands alone at bit 8j.
__device__ __forceinline__ uint32_t nibble_bytes(uint32_t nibble) {
  return (nibble * 0x00204081u) & 0x01010101u;
}

// Columns c .. c + 15 of one uint8 row from their 16 bits (bit j = column
// c + j), none at or past n_cols: one 16-byte store where `vec` (the row
// and c are 16-byte aligned) and all 16 are inside, else a byte each.
__device__ __forceinline__ void store_bytes16(uint8_t* __restrict__ row,
                                              int c, int n_cols,
                                              uint32_t bits, bool vec) {
  if (c >= n_cols) return;
  if (vec && c + 16 <= n_cols) {
    *reinterpret_cast<uint4*>(row + c) = make_uint4(
        nibble_bytes(bits & 15u), nibble_bytes((bits >> 4) & 15u),
        nibble_bytes((bits >> 8) & 15u), nibble_bytes((bits >> 12) & 15u));
    return;
  }
  const int n = min(16, n_cols - c);
  for (int j = 0; j < n; ++j) row[c + j] = (bits >> j) & 1u;
}

// The warp's part of one block: the strip's rows (s_a, six floats each)
// against its kWords words of columns (registers), written as FORM.  A row
// none of whose kWords * 32 pairs may meet (most rows: 0.07% of the
// production block's pairs meet) costs four comparisons per pair and one
// vote: its words are the zero-intersection hits.
template <int MODE, int FORM, bool SAFE>
__device__ __forceinline__ void relation_strip(
    const float* s_a, int rows, int row0, int wcol0, int lane,
    const float (&bx0)[kWords], const float (&by0)[kWords],
    const float (&bx1)[kWords], const float (&by1)[kWords],
    const float (&barea)[kWords], const float (&bpoly)[kWords],
    const uint32_t (&valid)[kWords], uint8_t* __restrict__ out, int n_cols,
    int pitch, float t0, float t1, int clear_diag, bool vec) {
  // the hit of a pair whose intersection is 0: the quotient is exactly +-0
  // (or the `where` branch's 0), whatever the threshold
  const bool zero_hit = MODE == kContainment ? (0.0f >= t0) : (0.0f > t0);
  // every row goes word by word: unsafe boxes, or dedupe's area term
  // decides the pairs that do not meet
  const bool by_word = !SAFE || (MODE == kDedupe && zero_hit);
  // kBytes: lane l stores columns 16 (l % 16) .. +15 of the warp's 256, bits
  // 16 (l % 2) .. +15 of word (l % 16) / 2, of the first (l < 16) or the
  // second row of each pair of rows
  const int my_word = (lane & 15) >> 1;
  const int my_shift = 16 * (lane & 1);
  uint32_t my_valid = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k)
    if (k == my_word) my_valid = (valid[k] >> my_shift) & 0xffffu;
  for (int g = 0; g < rows; g += kGroup) {
    const int n_in = min(kGroup, rows - g);
    uint32_t acc[4];  // kBits, lane l: words 4 (l % 2) .. +3 of row g + l / 2
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      acc[kk] = zero_hit ? ((lane & 1) ? valid[4 + kk] : valid[kk]) : 0u;
    uint32_t half = 0;  // kBytes: this lane's 16 bits of its row of the pair
    for (int r = 0; r < n_in; ++r) {
      const int i = g + r;
      float ra[6];
#pragma unroll
      for (int q = 0; q < 6; ++q) ra[q] = s_a[6 * i + q];
      bool meet = by_word;
      if (!by_word) {
#pragma unroll
        for (int k = 0; k < kWords; ++k)
          meet |= may_meet(ra, bx0[k], by0[k], bx1[k], by1[k]);
      }
      uint32_t bits16 = zero_hit ? my_valid : 0u;  // a row that meets nowhere
      if (__any_sync(kFull, meet)) {
#pragma unroll
        for (int k = 0; k < kWords; ++k) {
          const uint32_t word = relation_word<MODE, SAFE>(
              ra, bx0[k], by0[k], bx1[k], by1[k], barea[k], bpoly[k],
              valid[k], zero_hit, t0, t1);
          if (FORM == kBits) {
            if (r == (lane >> 1) && (k >> 2) == (lane & 1)) acc[k & 3] = word;
          } else if (k == my_word) {
            bits16 = (word >> my_shift) & 0xffffu;
          }
        }
      }
      if (FORM == kBytes) {
        if (((r ^ (lane >> 4)) & 1) == 0) half = bits16;
        if ((r & 1) || r == n_in - 1) {  // the pair is complete
          const int pr = (r & ~1) + (lane >> 4);
          if (pr <= r)
            store_bytes16(out + static_cast<size_t>(row0 + g + pr) * pitch,
                          wcol0 + 16 * (lane & 15), n_cols, half, vec);
        }
      }
    }
    if (FORM == kBits && (lane >> 1) < n_in) {
      const int row = row0 + g + (lane >> 1);
      const int col = wcol0 + 128 * (lane & 1);  // the first of its 4 words
      const int byte = col >> 3;                 // a multiple of 16
      if (byte < pitch) {
        const int d = clear_diag ? row - col : -1;
        uint32_t v[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          uint32_t word = acc[kk];
          if (d >= 32 * kk && d < 32 * kk + 32) word &= ~(1u << (d - 32 * kk));
          v[kk] = packbits_order(word);
        }
        uint8_t* dst = out + static_cast<size_t>(row) * pitch + byte;
        *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      }
    }
  }
}

// One block: kRelStrip rows against kRelSpan columns; warp w owns kWords
// words of 32 columns, lane l column 32k + l of word k.  out is (n_rows,
// pitch) bytes: FORM kBits the packed rows, FORM kBytes the mask's n_cols
// bytes per row (16-byte stores where `vec`).  With clear_diag (kBits only)
// column i of row i is cleared.
template <int MODE, int FORM>
__global__ void __launch_bounds__(kThreads, kRelMinBlocks)
relation_kernel(const float* __restrict__ a, const float* __restrict__ b,
                uint8_t* __restrict__ out, int n_rows, int n_cols, int pitch,
                float t0, float t1, int clear_diag, int vec) {
  constexpr int W = MODE == kDedupe ? 5 : 4;
  // x0, y0, x1, y1, box area, polygon area
  __shared__ float s_a[kRelStrip][6];

  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int row0 = static_cast<int>(blockIdx.x) * kRelStrip;
  const int rows = min(kRelStrip, n_rows - row0);
  const int wcol0 = static_cast<int>(blockIdx.y) * kRelSpan +
                    (tid >> 5) * (kWords * 32);

  bool unsafe = false;
  if (tid < rows) {
    const float* p = a + static_cast<size_t>(row0 + tid) * W;
    const float x0 = p[0], y0 = p[1], x1 = p[2], y1 = p[3];
    s_a[tid][0] = x0;
    s_a[tid][1] = y0;
    s_a[tid][2] = x1;
    s_a[tid][3] = y1;
    s_a[tid][4] = box_area(x0, y0, x1, y1);
    s_a[tid][5] = MODE == kDedupe ? p[W - 1] : 0.0f;
    unsafe = !safe_box(x0, y0, x1, y1);
  }

  float bx0[kWords], by0[kWords], bx1[kWords], by1[kWords];
  float barea[kWords], bpoly[kWords];
  uint32_t valid[kWords];
  bool unsafe_col = false;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    const int c = wcol0 + 32 * k + lane;
    if (c < n_cols) {
      const float* p = b + static_cast<size_t>(c) * W;
      bx0[k] = p[0];
      by0[k] = p[1];
      bx1[k] = p[2];
      by1[k] = p[3];
      bpoly[k] = MODE == kDedupe ? p[W - 1] : 0.0f;
      unsafe_col = unsafe_col || !safe_box(bx0[k], by0[k], bx1[k], by1[k]);
    } else {
      bx0[k] = by0[k] = bx1[k] = by1[k] = bpoly[k] = 0.0f;
    }
    barea[k] = box_area(bx0[k], by0[k], bx1[k], by1[k]);
    valid[k] = __ballot_sync(kFull, c < n_cols);
  }
  unsafe = __syncthreads_or(unsafe) != 0;  // any row of the strip
  if (wcol0 >= n_cols) return;  // the whole warp is past the last column
  unsafe = unsafe || __any_sync(kFull, unsafe_col);

  if (unsafe)
    relation_strip<MODE, FORM, false>(&s_a[0][0], rows, row0, wcol0, lane,
                                      bx0, by0, bx1, by1, barea, bpoly, valid,
                                      out, n_cols, pitch, t0, t1, clear_diag,
                                      vec != 0);
  else
    relation_strip<MODE, FORM, true>(&s_a[0][0], rows, row0, wcol0, lane,
                                     bx0, by0, bx1, by1, barea, bpoly, valid,
                                     out, n_cols, pitch, t0, t1, clear_diag,
                                     vec != 0);
}

template <int MODE, int FORM>
cudaError_t launch_relation(const float* a, const float* b, uint8_t* out,
                            int n_rows, int n_cols, int pitch, float t0,
                            float t1, int clear_diag, cudaStream_t stream) {
  const unsigned strips =
      (static_cast<unsigned>(n_rows) + kRelStrip - 1) / kRelStrip;
  const unsigned spans =
      (static_cast<unsigned>(n_cols) + kRelSpan - 1) / kRelSpan;
  if (spans > 65535u) return cudaErrorInvalidValue;
  // the uint8 form's 16-byte stores need 16-byte aligned rows
  const int vec =
      pitch % 16 == 0 && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  relation_kernel<MODE, FORM><<<dim3(strips, spans), kThreads, 0, stream>>>(
      a, b, out, n_rows, n_cols, pitch, t0, t1, clear_diag, vec);
  return cudaGetLastError();
}

// --- compaction of a bit-packed block to its (i, j) pairs -----------------

// Word w of a bit-packed row in column order (bit l = column 32w + l),
// without the bits at or past n_cols and without column diag_col (-1: none).
// w < ceil(n_cols / 32).
__device__ __forceinline__ uint32_t column_word(const uint8_t* row, int w,
                                                int n_cols, int diag_col) {
  uint32_t x = *reinterpret_cast<const uint32_t*>(row + 4 * w);
  x = __brev(__byte_perm(x, 0, 0x0123));
  const int c0 = 32 * w;
  if (n_cols - c0 < 32) x &= (1u << (n_cols - c0)) - 1u;
  const int d = diag_col - c0;
  if (d >= 0 && d < 32) x &= ~(1u << d);
  return x;
}

// One warp per row: counts[i] = the row's pairs.
__global__ void __launch_bounds__(kThreads)
row_count_kernel(const uint8_t* __restrict__ bits, long long stride,
                 int n_rows, int n_cols, int row_offset, int drop_diag,
                 long long* __restrict__ counts) {
  const int i = static_cast<int>(blockIdx.x) * kWarps +
                static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  if (i >= n_rows) return;
  const uint8_t* row = bits + static_cast<size_t>(i) * stride;
  const int n_words = (n_cols + 31) / 32;
  const int diag = drop_diag ? row_offset + i : -1;
  unsigned c = 0;
  for (int w = lane; w < n_words; w += 32)
    c += __popc(column_word(row, w, n_cols, diag));
  c = __reduce_add_sync(kFull, c);
  if (lane == 0) counts[i] = c;
}

// One warp per row: the row's pairs (row_offset + i, j) in column order at
// [ends[i - 1], ends[i]) of out_i / out_j (ends: the inclusive scan of the
// counts).
__global__ void __launch_bounds__(kThreads)
row_pairs_kernel(const uint8_t* __restrict__ bits, long long stride,
                 int n_rows, int n_cols, int row_offset, int drop_diag,
                 const long long* __restrict__ ends, int* __restrict__ out_i,
                 int* __restrict__ out_j) {
  const int i = static_cast<int>(blockIdx.x) * kWarps +
                static_cast<int>(threadIdx.x >> 5);
  const int lane = static_cast<int>(threadIdx.x & 31);
  if (i >= n_rows) return;
  long long pos = i == 0 ? 0 : ends[i - 1];
  const long long end = ends[i];
  if (pos == end) return;  // a row with no pair
  const uint8_t* row = bits + static_cast<size_t>(i) * stride;
  const int n_words = (n_cols + 31) / 32;
  const int diag = drop_diag ? row_offset + i : -1;
  for (int w0 = 0; w0 < n_words && pos < end; w0 += 32) {
    const int w = w0 + lane;
    uint32_t x = w < n_words ? column_word(row, w, n_cols, diag) : 0u;
    const int c = __popc(x);
    int incl = c;  // the warp's inclusive prefix sum of the words' counts
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += y;
    }
    long long p = pos + incl - c;
    while (x) {
      out_i[p] = row_offset + i;
      out_j[p] = 32 * w + __ffs(x) - 1;
      ++p;
      x &= x - 1u;
    }
    pos += __shfl_sync(kFull, incl, 31);
  }
}

}  // namespace

extern "C" {

// mode: 0 = iou, 1 = containment, 2 = dedupe (a and b then have 5 columns).
// `out` is (n_rows, n_cols) uint8 and contiguous; every mode runs
// relation_kernel (FORM kBytes), with 16-byte stores where `out` is 16-byte
// aligned and n_cols a multiple of 16.  Returns a cudaError_t (0 on
// success); cudaErrorInvalidValue for an unknown mode or more than
// 65535 * 2048 columns.
int td_pairwise_boxes(const void* a, const void* b, void* out, int n_rows,
                      int n_cols, int mode, float t0, float t1, void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  uint8_t* o = static_cast<uint8_t*>(out);
  switch (mode) {
    case kIou:
      return launch_relation<kIou, kBytes>(fa, fb, o, n_rows, n_cols, n_cols,
                                           t0, t1, 0, s);
    case kContainment:
      return launch_relation<kContainment, kBytes>(fa, fb, o, n_rows, n_cols,
                                                   n_cols, t0, t1, 0, s);
    case kDedupe:
      return launch_relation<kDedupe, kBytes>(fa, fb, o, n_rows, n_cols,
                                              n_cols, t0, t1, 0, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The relation bit-packed: `out` is (n_rows, pitch) uint8, 16-byte aligned,
// pitch a multiple of 16 and >= ceil(n_cols / 8); row i's bits in numpy's
// packbits order, zero past n_cols.  mode 1 = containment, 2 = dedupe.  With
// clear_diag (the square case), column i of row i is 0.
int td_pairwise_relation_bits(const void* a, const void* b, void* out,
                              int n_rows, int n_cols, int pitch, int mode,
                              float t0, float t1, int clear_diag,
                              void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  if (pitch % 16 != 0 || pitch < (n_cols + 7) / 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  uint8_t* o = static_cast<uint8_t*>(out);
  switch (mode) {
    case kContainment:
      return launch_relation<kContainment, kBits>(
          fa, fb, o, n_rows, n_cols, pitch, t0, t1, clear_diag, s);
    case kDedupe:
      return launch_relation<kDedupe, kBits>(
          fa, fb, o, n_rows, n_cols, pitch, t0, t1, clear_diag, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// counts[i] (int64) = the set bits of row i of a bit-packed block below
// n_cols, less column row_offset + i with drop_diag.  `bits` rows lie
// `stride` bytes apart (a multiple of 4, >= 4 * ceil(n_cols / 32)), 4-byte
// aligned.
int td_relation_row_counts(const void* bits, long long stride, int n_rows,
                           int n_cols, int row_offset, int drop_diag,
                           void* counts, void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  row_count_kernel<<<(n_rows + kWarps - 1) / kWarps, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), stride, n_rows, n_cols, row_offset,
      drop_diag, static_cast<long long*>(counts));
  return static_cast<int>(cudaGetLastError());
}

// The pairs of the same block in row-major order: out_i[p] = row_offset + i,
// out_j[p] = j (int32), row i's at [ends[i - 1], ends[i]), `ends` the
// inclusive scan (int64) of td_relation_row_counts' counts.
int td_relation_pairs(const void* bits, long long stride, int n_rows,
                      int n_cols, int row_offset, int drop_diag,
                      const void* ends, void* out_i, void* out_j,
                      void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  row_pairs_kernel<<<(n_rows + kWarps - 1) / kWarps, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bits), stride, n_rows, n_cols, row_offset,
      drop_diag, static_cast<const long long*>(ends),
      static_cast<int*>(out_i), static_cast<int*>(out_j));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
