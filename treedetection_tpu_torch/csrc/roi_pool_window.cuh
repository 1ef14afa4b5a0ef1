// One box's pooling in float32, shared by the three ROIAlign patch poolers
// (roi_pool_flat.cu, roi_pool_levels.cu, roi_pool_resident.cu; their bfloat16
// kernels share roi_pool_bf16.cuh):
//
//     out = A_y . window . A_x^T,   window = src[row0 : row0+P, col0 : col0+P+8, c]
//
// for the kCSlice channels a block owns.  The three kernels differ only in
// where `src` points and how far it may be read; the arithmetic and its order
// are the same in all of them, so they are bit-equal:
//   stage  : the box's hat matrices A_y (R, P) and A_x (R, P+8) into shared
//            memory;
//   phase 1: t[r][x][c] = sum_y A_y[r][y] * window[y][x][c]   (in smem)
//   phase 2: out[r][j][c] = sum_x A_x[j][x] * t[r][x][c]
// Consecutive threads own consecutive channels, so window reads and output
// writes are coalesced along C.  Cells outside [0, rows) x [0, cols) of the
// source read as zeros.  Both contractions accumulate in fp32, which for
// float32 features is the TPU kernels' rounding
// (treedetection_tpu/ops/pallas/roi_align_kernel.py).

#pragma once

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace roi_pool {

constexpr int kThreads = 256;
constexpr int kCSlice = 32;

// Dynamic shared memory one block needs, in bytes.
template <int R>
inline size_t smem_bytes(int patch) {
  const int cpatch = patch + 8;
  return sizeof(float) * (static_cast<size_t>(R) * patch + R * cpatch +
                          static_cast<size_t>(R) * cpatch * kCSlice);
}

// Pool one box for channels [c0, min(c0 + kCSlice, c_end)).  `src` is the
// (rows, cols) region the window may read, `pitch` its row pitch in pixels
// and `channels` its pixel pitch in elements; `out_box` is the box's
// (R, R, channels) output.  Every thread of the block must call it; it ends
// with a barrier, so a block may call it again for its next box.
template <int R>
__device__ __forceinline__ void pool_box(
    const float* __restrict__ src, int rows, int cols, int pitch, int channels,
    int c0, int c_end, int row0, int col0, const float* __restrict__ ay_box,
    const float* __restrict__ ax_box, float* __restrict__ out_box, int patch,
    float* smem) {
  const int cpatch = patch + 8;
  float* s_ay = smem;                   // (R, patch)
  float* s_ax = s_ay + R * patch;       // (R, cpatch)
  float* s_t = s_ax + R * cpatch;       // (R, cpatch, kCSlice)

  for (int i = threadIdx.x; i < R * patch; i += blockDim.x)
    s_ay[i] = ay_box[i];
  for (int i = threadIdx.x; i < R * cpatch; i += blockDim.x)
    s_ax[i] = ax_box[i];
  __syncthreads();

  // phase 1: contract the window rows with A_y
  for (int p = threadIdx.x; p < cpatch * kCSlice; p += blockDim.x) {
    const int x = p / kCSlice;
    const int cl = p % kCSlice;
    const int c = c0 + cl;
    const int gx = col0 + x;
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.f;
    if (c < c_end && gx >= 0 && gx < cols) {
      for (int y = 0; y < patch; ++y) {
        const int gy = row0 + y;
        if (gy < 0 || gy >= rows) continue;
        const float v =
            __ldg(src + (static_cast<size_t>(gy) * pitch + gx) * channels + c);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_ay[r * patch + y], v, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      s_t[(r * cpatch + x) * kCSlice + cl] = acc[r];
  }
  __syncthreads();

  // phase 2: contract the window columns with A_x
  for (int q = threadIdx.x; q < R * R * kCSlice; q += blockDim.x) {
    const int cl = q % kCSlice;
    const int rj = q / kCSlice;
    const int j = rj % R;
    const int r = rj / R;
    const int c = c0 + cl;
    if (c >= c_end) continue;
    const float* t_row = s_t + r * cpatch * kCSlice + cl;
    const float* ax_row = s_ax + j * cpatch;
    float acc = 0.f;
    for (int x = 0; x < cpatch; ++x) acc = fmaf(ax_row[x], t_row[x * kCSlice], acc);
    out_box[(static_cast<size_t>(r) * R + j) * channels + c] = acc;
  }
  __syncthreads();
}

}  // namespace roi_pool
