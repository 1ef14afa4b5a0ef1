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
// is (N, R, R, C) in the feature dtype.  Rounding is the TPU kernel's: hats
// and the intermediate t = A_y . window rounded to the feature dtype, both
// contractions accumulated in fp32, the output rounded once.
//
// float32 features take `pool_box` (roi_pool_window.cuh), one block per
// (box, 32-channel slice), the same device function as K5 and K6, so that the
// three poolers are bit-equal in float32.
//
// bfloat16 features (the production dtype) take roi_pool_flat_bf16_kernel,
// which reads the box's window origin and calls `pool_box_bf16`
// (roi_pool_bf16.cuh: what bounds it and its design are noted there: the
// hats' span only, cp.async staging, mma.sync), the same device function as
// K5's bfloat16 kernel, so that K1 and K5 are bit-equal in bfloat16 too.

#include "roi_pool_bf16.cuh"
#include "roi_pool_window.cuh"

namespace {

using namespace roi_pool;

// --- float32: pool_box ---------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kThreads)
roi_pool_flat_kernel(const float* __restrict__ fcat,
                     const int32_t* __restrict__ rows,
                     const int32_t* __restrict__ cols,
                     const float* __restrict__ ay, const float* __restrict__ ax,
                     float* __restrict__ out, int total_rows, int width,
                     int channels, int patch) {
  extern __shared__ float smem[];
  const int cpatch = patch + 8;
  const int box = blockIdx.x;
  pool_box<R>(fcat, total_rows, width, width, channels,
              blockIdx.y * kCSlice, channels, rows[box], cols[box],
              ay + static_cast<size_t>(box) * R * patch,
              ax + static_cast<size_t>(box) * R * cpatch,
              out + static_cast<size_t>(box) * R * R * channels, patch,
              smem);
}

template <int R>
cudaError_t launch_f32(const void* fcat, const void* rows, const void* cols,
                       const void* ay, const void* ax, void* out, int n,
                       int patch, int total_rows, int width, int channels,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes<R>(patch);
  auto kernel = roi_pool_flat_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (channels + kCSlice - 1) / kCSlice);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(fcat), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(cols), static_cast<const float*>(ay),
      static_cast<const float*>(ax), static_cast<float*>(out), total_rows, width,
      channels, patch);
  return cudaGetLastError();
}

// --- bfloat16: pool_box_bf16 ------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kBf16Threads, 2)
roi_pool_flat_bf16_kernel(const bf16* __restrict__ fcat,
                          const int32_t* __restrict__ rows,
                          const int32_t* __restrict__ cols,
                          const float* __restrict__ ay,
                          const float* __restrict__ ax, bf16* __restrict__ out,
                          int total_rows, int width, int channels, int patch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int box = blockIdx.x;
  pool_box_bf16<R>(fcat, total_rows, width, channels, blockIdx.y * kSlice,
                   rows[box], cols[box],
                   ay + static_cast<size_t>(box) * R * patch,
                   ax + static_cast<size_t>(box) * R * (patch + 8),
                   out + static_cast<size_t>(box) * R * R * channels, patch,
                   smem_raw);
}

template <int R>
cudaError_t launch_bf16(const void* fcat, const void* rows, const void* cols,
                        const void* ay, const void* ax, void* out, int n,
                        int patch, int total_rows, int width, int channels,
                        cudaStream_t stream) {
  if (!bf16_shape_ok(channels, patch)) return cudaErrorInvalidValue;
  constexpr size_t smem = bf16_smem_bytes<R>();
  auto kernel = roi_pool_flat_bf16_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (channels + kSlice - 1) / kSlice);
  kernel<<<grid, kBf16Threads, smem, stream>>>(
      static_cast<const bf16*>(fcat), static_cast<const int32_t*>(rows),
      static_cast<const int32_t*>(cols), static_cast<const float*>(ay),
      static_cast<const float*>(ax), static_cast<bf16*>(out), total_rows, width,
      channels, patch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  resolution: 7 or 14.
// Returns a cudaError_t (0 on success); cudaErrorInvalidValue for an
// unsupported dtype or resolution, and in bfloat16 for C not a multiple of 8
// or a patch above 48.
int td_roi_pool_flat(const void* fcat, const void* rows, const void* cols,
                     const void* ay, const void* ax, void* out, int n,
                     int resolution, int patch, int total_rows, int width,
                     int channels, int dtype, void* stream) {
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && resolution == 7)
    return static_cast<int>(launch_f32<7>(fcat, rows, cols, ay, ax, out, n, patch,
                                          total_rows, width, channels, s));
  if (dtype == 0 && resolution == 14)
    return static_cast<int>(launch_f32<14>(fcat, rows, cols, ay, ax, out, n, patch,
                                           total_rows, width, channels, s));
  if (dtype == 1 && resolution == 7)
    return static_cast<int>(launch_bf16<7>(fcat, rows, cols, ay, ax, out, n,
                                           patch, total_rows, width, channels, s));
  if (dtype == 1 && resolution == 14)
    return static_cast<int>(launch_bf16<14>(fcat, rows, cols, ay, ax, out, n,
                                            patch, total_rows, width, channels, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
