// Flat ROIAlign patch pooler for Hopper (sm_90a).
//
// Replaces the TPU kernel `roi_pool_patches_flat`
// (treedetection_tpu/ops/pallas/roi_align_kernel.py): for every box i
//
//     out[i] = A_y[i] . fcat[rows[i] : rows[i]+P, cols[i] : cols[i]+P+8, :] . A_x[i]^T
//
// where A_y (R, P) and A_x (R, P+8) are the "hat" matrices that fold the
// bilinear weights and the 2x2-sample bin average (built by the caller), and
// fcat is the level- and image-concatenated NHWC feature buffer.  The output
// is (N, R, R, C) in the feature dtype, accumulated in fp32.
//
// What bounds it: memory, not arithmetic.  At the production geometry (1024^2
// input, batch 10, C=256 bf16) the box pool (N=5120, R=7) does ~56 GFLOP but
// each box's 48x56xC window is 1.38 MB, so a design that streams every window
// from DRAM moves ~7 GB (~2.1 ms at 3.35 TB/s), while the compulsory read of
// the touched part of fcat is ~1.07 GB (~0.32 ms).  Crowns are dense and their
// windows overlap heavily; that reuse is what a faster design exploits.
//
// This design is the simple one: one block per (box, 32-channel slice).  The
// block stages its box's hat matrices in shared memory, then
//   phase 1: t[r][x][c] = sum_y A_y[r][y] * window[y][x][c]   (fp32, in smem)
//   phase 2: out[r][j][c] = sum_x A_x[j][x] * t[r][x][c]
// Consecutive threads own consecutive channels, so window reads and output
// writes are coalesced along C; overlapping windows of neighbouring boxes are
// served from L2 when their blocks run close together.  Reads outside fcat are
// treated as zeros (the caller's padding keeps valid boxes inside it).
// Hat matrices and the intermediate t stay fp32; only the output is rounded
// to the feature dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kCSlice = 32;

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
roi_pool_flat_kernel(const T* __restrict__ fcat, const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ cols, const float* __restrict__ ay,
                     const float* __restrict__ ax, T* __restrict__ out,
                     int total_rows, int width, int channels, int patch) {
  extern __shared__ float smem[];
  const int cpatch = patch + 8;
  float* s_ay = smem;                   // (R, patch)
  float* s_ax = s_ay + R * patch;       // (R, cpatch)
  float* s_t = s_ax + R * cpatch;       // (R, cpatch, kCSlice)

  const int box = blockIdx.x;
  const int c0 = blockIdx.y * kCSlice;
  const int row0 = rows[box];
  const int col0 = cols[box];

  const float* ay_box = ay + static_cast<size_t>(box) * R * patch;
  const float* ax_box = ax + static_cast<size_t>(box) * R * cpatch;
  for (int i = threadIdx.x; i < R * patch; i += blockDim.x) s_ay[i] = ay_box[i];
  for (int i = threadIdx.x; i < R * cpatch; i += blockDim.x) s_ax[i] = ax_box[i];
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
    if (c < channels && gx >= 0 && gx < width) {
      for (int y = 0; y < patch; ++y) {
        const int gy = row0 + y;
        if (gy < 0 || gy >= total_rows) continue;
        const float v = load_f32(
            fcat + (static_cast<size_t>(gy) * width + gx) * channels + c);
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = fmaf(s_ay[r * patch + y], v, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r) s_t[(r * cpatch + x) * kCSlice + cl] = acc[r];
  }
  __syncthreads();

  // phase 2: contract the window columns with A_x
  for (int q = threadIdx.x; q < R * R * kCSlice; q += blockDim.x) {
    const int cl = q % kCSlice;
    const int rj = q / kCSlice;
    const int j = rj % R;
    const int r = rj / R;
    const int c = c0 + cl;
    if (c >= channels) continue;
    const float* t_row = s_t + r * cpatch * kCSlice + cl;
    const float* ax_row = s_ax + j * cpatch;
    float acc = 0.f;
    for (int x = 0; x < cpatch; ++x) acc = fmaf(ax_row[x], t_row[x * kCSlice], acc);
    store_as(out + ((static_cast<size_t>(box) * R + r) * R + j) * channels + c, acc);
  }
}

template <typename T, int R>
cudaError_t launch(const void* fcat, const void* rows, const void* cols,
                   const void* ay, const void* ax, void* out, int n,
                   int patch, int total_rows, int width, int channels,
                   cudaStream_t stream) {
  const int cpatch = patch + 8;
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(R) * patch + R * cpatch +
                       static_cast<size_t>(R) * cpatch * kCSlice);
  auto kernel = roi_pool_flat_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (channels + kCSlice - 1) / kCSlice);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(fcat), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(cols), static_cast<const float*>(ay),
      static_cast<const float*>(ax), static_cast<T*>(out), total_rows, width,
      channels, patch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  resolution: 7 or 14.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for an
// unsupported dtype or resolution.
int td_roi_pool_flat(const void* fcat, const void* rows, const void* cols,
                     const void* ay, const void* ax, void* out, int n,
                     int resolution, int patch, int total_rows, int width,
                     int channels, int dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && resolution == 7)
    return launch<float, 7>(fcat, rows, cols, ay, ax, out, n, patch, total_rows,
                            width, channels, s);
  if (dtype == 0 && resolution == 14)
    return launch<float, 14>(fcat, rows, cols, ay, ax, out, n, patch, total_rows,
                             width, channels, s);
  if (dtype == 1 && resolution == 7)
    return launch<__nv_bfloat16, 7>(fcat, rows, cols, ay, ax, out, n, patch,
                                    total_rows, width, channels, s);
  if (dtype == 1 && resolution == 14)
    return launch<__nv_bfloat16, 14>(fcat, rows, cols, ay, ax, out, n, patch,
                                     total_rows, width, channels, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
