// Pairwise box-relation masks for Hopper (sm_90a).
//
// Replaces the three TPU tile kernels of
// treedetection_tpu/ops/pallas/iou_kernel.py (`_iou_tile_kernel`,
// `_containment_tile_kernel`, `_dedupe_tile_kernel`, all run through
// `_run_tiled`): for row boxes a (R, W) and column boxes b (N, W), float32
// rows [x0, y0, x1, y1(, polygon area)], write the (R, N) uint8 relation
//
//   iou          out[i][j] = IoU(a_i, b_j) > t0                    (0 where the union is 0)
//   containment  out[i][j] = inter(a_i, b_j) / area(b_j) >= t0     (0 where area(b_j) is 0)
//   dedupe       out[i][j] = IoU(a_i, b_j) > t0  AND
//                            |pa_i - pb_j| / max(pa_i, pb_j, 1e-9) < t1
//
// The result is a threshold test, so rounding decides entries.  The
// arithmetic keeps the order of operations of `_iou_terms` and of each tile
// kernel, every operation is a separately rounded IEEE float32 operation, and
// the file must be compiled with -fmad=false (no FMA contraction) and without
// -use_fast_math, so that the mask equals the one the plain PyTorch version
// computes with separate elementwise operations, bit for bit.
//
// What bounds it: at one production row block (R = 8192 rows against
// N = 32768 columns) the inputs are < 1 MB and the output is 268 MB, which
// is 0.08 ms at 3.35 TB/s; the ~25 float32 operations per pair (one of them
// a division) come to about the same time at 67 TFLOP/s.  So the kernel has to
// write coalesced bytes and do nothing per pair beyond the arithmetic.
//
// Design (not the TPU's 128x128 VMEM tiles): a block takes a strip of
// kStrip rows and a span of kThreads*4 columns.  Each thread loads its 4
// consecutive b columns into registers once; the strip's a rows (with their
// box areas) are staged in shared memory and read as broadcasts; per row a
// thread computes 4 entries and writes them as one 4-byte store when the row
// pitch allows it (N % 4 == 0), else as guarded bytes.  Ragged edges are
// guarded, nothing is padded.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;
constexpr int kSpan = kThreads * kPerThread;  // columns per block
constexpr int kStrip = 32;                    // rows per block

enum Mode { kIou = 0, kContainment = 1, kDedupe = 2 };

__device__ __forceinline__ float box_area(float x0, float y0, float x1, float y1) {
  return fmaxf(x1 - x0, 0.0f) * fmaxf(y1 - y0, 0.0f);
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
pairwise_boxes_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      uint8_t* __restrict__ out, int n_rows, int n_cols,
                      float t0, float t1) {
  constexpr int W = MODE == kDedupe ? 5 : 4;
  __shared__ float s_a[kStrip][6];  // x0, y0, x1, y1, box area, polygon area

  const int row0 = static_cast<int>(blockIdx.x) * kStrip;
  const int col0 = static_cast<int>(blockIdx.y) * kSpan +
                   static_cast<int>(threadIdx.x) * kPerThread;
  const int rows = min(kStrip, n_rows - row0);

  const int tid = static_cast<int>(threadIdx.x);
  if (tid < rows) {
    const float* p = a + static_cast<size_t>(row0 + tid) * W;
    const float x0 = p[0], y0 = p[1], x1 = p[2], y1 = p[3];
    s_a[tid][0] = x0;
    s_a[tid][1] = y0;
    s_a[tid][2] = x1;
    s_a[tid][3] = y1;
    s_a[tid][4] = box_area(x0, y0, x1, y1);
    s_a[tid][5] = MODE == kDedupe ? p[W - 1] : 0.0f;
  }

  float bx0[kPerThread], by0[kPerThread], bx1[kPerThread], by1[kPerThread];
  float barea[kPerThread], bpoly[kPerThread];
#pragma unroll
  for (int k = 0; k < kPerThread; ++k) {
    const int c = col0 + k;
    if (c < n_cols) {
      const float* p = b + static_cast<size_t>(c) * W;
      bx0[k] = p[0];
      by0[k] = p[1];
      bx1[k] = p[2];
      by1[k] = p[3];
      bpoly[k] = MODE == kDedupe ? p[W - 1] : 0.0f;
    } else {
      bx0[k] = by0[k] = bx1[k] = by1[k] = bpoly[k] = 0.0f;
    }
    barea[k] = box_area(bx0[k], by0[k], bx1[k], by1[k]);
  }
  __syncthreads();
  if (col0 >= n_cols) return;

  const bool vector_store = (n_cols % kPerThread == 0);  // col0 + 3 < n_cols then
  for (int i = 0; i < rows; ++i) {
    const float ax0 = s_a[i][0], ay0 = s_a[i][1], ax1 = s_a[i][2], ay1 = s_a[i][3];
    const float aarea = s_a[i][4], apoly = s_a[i][5];
    uint8_t r[kPerThread];
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const float iw = fmaxf(fminf(ax1, bx1[k]) - fmaxf(ax0, bx0[k]), 0.0f);
      const float ih = fmaxf(fminf(ay1, by1[k]) - fmaxf(ay0, by0[k]), 0.0f);
      const float inter = iw * ih;
      bool hit;
      if (MODE == kContainment) {
        const float ratio = barea[k] > 0.0f ? inter / barea[k] : 0.0f;
        hit = ratio >= t0;
      } else {
        const float uni = (aarea + barea[k]) - inter;
        const float iou = uni > 0.0f ? inter / uni : 0.0f;
        hit = iou > t0;
        if (MODE == kDedupe) {
          const float rel = fabsf(apoly - bpoly[k]) /
                            fmaxf(fmaxf(apoly, bpoly[k]), 1e-9f);
          hit = hit && (rel < t1);
        }
      }
      r[k] = hit ? 1 : 0;
    }
    uint8_t* dst = out + static_cast<size_t>(row0 + i) * n_cols + col0;
    if (vector_store) {
      *reinterpret_cast<uchar4*>(dst) = make_uchar4(r[0], r[1], r[2], r[3]);
    } else {
#pragma unroll
      for (int k = 0; k < kPerThread; ++k)
        if (col0 + k < n_cols) dst[k] = r[k];
    }
  }
}

template <int MODE>
cudaError_t launch(const float* a, const float* b, uint8_t* out, int n_rows,
                   int n_cols, float t0, float t1, cudaStream_t stream) {
  const unsigned strips = (static_cast<unsigned>(n_rows) + kStrip - 1) / kStrip;
  const unsigned spans = (static_cast<unsigned>(n_cols) + kSpan - 1) / kSpan;
  if (spans > 65535u) return cudaErrorInvalidValue;
  pairwise_boxes_kernel<MODE><<<dim3(strips, spans), kThreads, 0, stream>>>(
      a, b, out, n_rows, n_cols, t0, t1);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 = iou, 1 = containment, 2 = dedupe (a and b then have 5 columns).
// `out` is (n_rows, n_cols) uint8, contiguous, and 4-byte aligned.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for an unknown
// mode or more than 65535 * 1024 columns.
int td_pairwise_boxes(const void* a, const void* b, void* out, int n_rows,
                      int n_cols, int mode, float t0, float t1, void* stream) {
  if (n_rows <= 0 || n_cols <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* fa = static_cast<const float*>(a);
  const float* fb = static_cast<const float*>(b);
  uint8_t* o = static_cast<uint8_t*>(out);
  switch (mode) {
    case kIou:
      return launch<kIou>(fa, fb, o, n_rows, n_cols, t0, t1, s);
    case kContainment:
      return launch<kContainment>(fa, fb, o, n_rows, n_cols, t0, t1, s);
    case kDedupe:
      return launch<kDedupe>(fa, fb, o, n_rows, n_cols, t0, t1, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
