// One box's pooling, shared by the ROIAlign patch pooler roi_pool_resident.cu,
// and by roi_pool_flat.cu and roi_pool_levels.cu for float32 features (their
// bfloat16 kernels share roi_pool_bf16.cuh):
//
//     out = A_y . window . A_x^T,   window = src[row0 : row0+P, col0 : col0+P+8, c]
//
// for the kSlice channels a block owns.  The three kernels differ only in
// where `src` points and how far it may be read; the arithmetic, its order
// and its rounding are the same in all of them:
//   stage  : the box's hat matrices A_y (R, P) and A_x (R, P+8) into shared
//            memory;
//   phase 1: t[r][x][c] = sum_y A_y[r][y] * window[y][x][c]   (in smem)
//   phase 2: out[r][j][c] = sum_x A_x[j][x] * t[r][x][c]
// Consecutive threads own consecutive channels, so window reads and output
// writes are coalesced along C.  Cells outside [0, rows) x [0, cols) of the
// source read as zeros.  Rounding follows the TPU kernels
// (treedetection_tpu/ops/pallas/roi_align_kernel.py): the hats are rounded to
// the feature dtype when they are staged, t is accumulated in fp32 and rounded
// to the feature dtype when it is stored, and the output is accumulated in
// fp32 and rounded once.  For float32 features every rounding is the
// identity.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace roi_pool {

constexpr int kThreads = 256;
constexpr int kCSlice = 32;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
// v rounded to T and widened back: the identity for float.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

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
template <typename T, int R>
__device__ __forceinline__ void pool_box(
    const T* __restrict__ src, int rows, int cols, int pitch, int channels,
    int c0, int c_end, int row0, int col0, const float* __restrict__ ay_box,
    const float* __restrict__ ax_box, T* __restrict__ out_box, int patch,
    float* smem) {
  const int cpatch = patch + 8;
  float* s_ay = smem;                   // (R, patch)
  float* s_ax = s_ay + R * patch;       // (R, cpatch)
  float* s_t = s_ax + R * cpatch;       // (R, cpatch, kCSlice)

  for (int i = threadIdx.x; i < R * patch; i += blockDim.x)
    s_ay[i] = round_to<T>(ay_box[i]);
  for (int i = threadIdx.x; i < R * cpatch; i += blockDim.x)
    s_ax[i] = round_to<T>(ax_box[i]);
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
        const float v = load_f32(
            src + (static_cast<size_t>(gy) * pitch + gx) * channels + c);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_ay[r * patch + y], v, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
      s_t[(r * cpatch + x) * kCSlice + cl] = round_to<T>(acc[r]);
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
    store_as(out_box + (static_cast<size_t>(r) * R + j) * channels + c, acc);
  }
  __syncthreads();
}

// Dispatch a launcher template over (dtype, resolution): dtype 0 = float32,
// 1 = bfloat16; resolution 7 or 14.  Anything else is cudaErrorInvalidValue.
#define ROI_POOL_DISPATCH(LAUNCH, dtype, resolution, ...)                  \
  do {                                                                     \
    if ((dtype) == 0 && (resolution) == 7)                                 \
      return static_cast<int>(LAUNCH<float, 7>(__VA_ARGS__));              \
    if ((dtype) == 0 && (resolution) == 14)                                \
      return static_cast<int>(LAUNCH<float, 14>(__VA_ARGS__));             \
    if ((dtype) == 1 && (resolution) == 7)                                 \
      return static_cast<int>(LAUNCH<__nv_bfloat16, 7>(__VA_ARGS__));      \
    if ((dtype) == 1 && (resolution) == 14)                                \
      return static_cast<int>(LAUNCH<__nv_bfloat16, 14>(__VA_ARGS__));     \
    return static_cast<int>(cudaErrorInvalidValue);                        \
  } while (0)

}  // namespace roi_pool
