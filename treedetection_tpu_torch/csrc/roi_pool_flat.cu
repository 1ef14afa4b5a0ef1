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
// This design is the simple one: one block per (box, 32-channel slice), which
// stages the box's hat matrices in shared memory and runs the two contraction
// phases of roi_pool_window.cuh.  Overlapping windows of neighbouring boxes
// are served from L2 when their blocks run close together.  Reads outside
// fcat are treated as zeros (the caller's padding keeps valid boxes inside
// it).

#include "roi_pool_window.cuh"

namespace {

using namespace roi_pool;

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
roi_pool_flat_kernel(const T* __restrict__ fcat, const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ cols, const float* __restrict__ ay,
                     const float* __restrict__ ax, T* __restrict__ out,
                     int total_rows, int width, int channels, int patch) {
  extern __shared__ float smem[];
  const int cpatch = patch + 8;
  const int box = blockIdx.x;
  pool_box<T, R>(fcat, total_rows, width, width, channels,
                 blockIdx.y * kCSlice, channels, rows[box], cols[box],
                 ay + static_cast<size_t>(box) * R * patch,
                 ax + static_cast<size_t>(box) * R * cpatch,
                 out + static_cast<size_t>(box) * R * R * channels, patch, smem);
}

template <typename T, int R>
cudaError_t launch(const void* fcat, const void* rows, const void* cols,
                   const void* ay, const void* ax, void* out, int n,
                   int patch, int total_rows, int width, int channels,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes<R>(patch);
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
  ROI_POOL_DISPATCH(launch, dtype, resolution, fcat, rows, cols, ay, ax, out, n,
                    patch, total_rows, width, channels, s);
}

}  // extern "C"
