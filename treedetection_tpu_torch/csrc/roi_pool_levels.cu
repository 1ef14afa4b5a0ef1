// Per-level ROIAlign patch pooler for Hopper (sm_90a).
//
// Replaces the TPU kernel `roi_pool_patches`
// (treedetection_tpu/ops/pallas/roi_align_kernel.py): for every box i
//
//     l = meta[i][0]
//     out[i] = A_y[i] . f_l[meta[i][1] : +P, meta[i][2] : +P+8, :] . A_x[i]^T
//
// where f_l is the box's FPN level buffer, (B*(H_l+P), W_l+P+8, C) NHWC with
// every image's section row-concatenated, meta[i] = [level, row0, col0] the
// window origin in that buffer (col0 a multiple of 8, as the TPU kernel's DMA
// needs; kept so that both take the same inputs), and A_y (R, P), A_x
// (R, P+8) the caller's hat matrices.  Output (N, R, R, C) in the feature
// dtype, accumulated in fp32.
//
// The flat pooler (roi_pool_flat.cu) takes all levels in one buffer padded to
// the widest level; this one takes the up to four buffers as they are, so the
// caller's buffer build skips the width padding.  The base pointers, row
// counts and widths travel by value in a small struct (a __grid_constant__
// parameter, so that indexing it by the level needs no per-thread copy) and
// each block picks its buffer by the box's level.
//
// float32 features take `pool_box` (roi_pool_window.cuh), one block per
// (box, 32-channel slice), the device function of K1's and K6's float32
// kernels: the three poolers are bit-equal in float32.
//
// bfloat16 features (the production dtype) take roi_pool_levels_bf16_kernel:
// K1's grid and K1's device function `pool_box_bf16` (roi_pool_bf16.cuh: what
// bounds it and its design are noted there: the hats' span only, cp.async
// staging, mma.sync), called with the box's level buffer and its own row
// count and width.  Every cell of a box's window holds the same value here as
// in K1's buffer (the level's feature, or zero: padding of either layout, or
// zero-fill past a buffer), so on the same boxes and hats K5 gives K1's bits.

#include "roi_pool_bf16.cuh"
#include "roi_pool_window.cuh"

namespace {

using namespace roi_pool;

constexpr int kMaxLevels = 4;

struct LevelBuffers {
  const void* base[kMaxLevels];
  int rows[kMaxLevels];
  int width[kMaxLevels];
};

// the box's level, clamped: the wrapper checks the range, and the clamp keeps
// a bad level from indexing outside the struct
__device__ __forceinline__ int box_level(const int32_t* meta, int box,
                                         int n_levels) {
  return min(max(meta[3 * box], 0), n_levels - 1);
}

// --- float32: pool_box ---------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kThreads)
roi_pool_levels_kernel(const __grid_constant__ LevelBuffers bufs,
                       const int32_t* __restrict__ meta,
                       const float* __restrict__ ay, const float* __restrict__ ax,
                       float* __restrict__ out, int n_levels, int channels,
                       int patch) {
  extern __shared__ float smem[];
  const int cpatch = patch + 8;
  const int box = blockIdx.x;
  const int level = box_level(meta, box, n_levels);
  pool_box<R>(static_cast<const float*>(bufs.base[level]),
              bufs.rows[level], bufs.width[level], bufs.width[level],
              channels, blockIdx.y * kCSlice, channels, meta[3 * box + 1],
              meta[3 * box + 2],
              ay + static_cast<size_t>(box) * R * patch,
              ax + static_cast<size_t>(box) * R * cpatch,
              out + static_cast<size_t>(box) * R * R * channels, patch,
              smem);
}

template <int R>
cudaError_t launch_f32(const LevelBuffers& bufs, const void* meta,
                       const void* ay, const void* ax, void* out, int n,
                       int patch, int n_levels, int channels,
                       cudaStream_t stream) {
  const size_t smem = smem_bytes<R>(patch);
  auto kernel = roi_pool_levels_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (channels + kCSlice - 1) / kCSlice);
  kernel<<<grid, kThreads, smem, stream>>>(
      bufs, static_cast<const int32_t*>(meta), static_cast<const float*>(ay),
      static_cast<const float*>(ax), static_cast<float*>(out), n_levels,
      channels, patch);
  return cudaGetLastError();
}

// --- bfloat16: pool_box_bf16 ------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kBf16Threads, 2)
roi_pool_levels_bf16_kernel(const __grid_constant__ LevelBuffers bufs,
                            const int32_t* __restrict__ meta,
                            const float* __restrict__ ay,
                            const float* __restrict__ ax, bf16* __restrict__ out,
                            int n_levels, int channels, int patch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int box = blockIdx.x;
  const int level = box_level(meta, box, n_levels);
  pool_box_bf16<R>(static_cast<const bf16*>(bufs.base[level]), bufs.rows[level],
                   bufs.width[level], channels, blockIdx.y * kSlice,
                   meta[3 * box + 1], meta[3 * box + 2],
                   ay + static_cast<size_t>(box) * R * patch,
                   ax + static_cast<size_t>(box) * R * (patch + 8),
                   out + static_cast<size_t>(box) * R * R * channels, patch,
                   smem_raw);
}

template <int R>
cudaError_t launch_bf16(const LevelBuffers& bufs, const void* meta,
                        const void* ay, const void* ax, void* out, int n,
                        int patch, int n_levels, int channels,
                        cudaStream_t stream) {
  if (!bf16_shape_ok(channels, patch)) return cudaErrorInvalidValue;
  constexpr size_t smem = bf16_smem_bytes<R>();
  auto kernel = roi_pool_levels_bf16_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (channels + kSlice - 1) / kSlice);
  kernel<<<grid, kBf16Threads, smem, stream>>>(
      bufs, static_cast<const int32_t*>(meta), static_cast<const float*>(ay),
      static_cast<const float*>(ax), static_cast<bf16*>(out), n_levels,
      channels, patch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bases / rows / widths: n_levels entries each (1..4), host arrays.
// meta: (N, 3) int32 on the device.  dtype: 0 = float32, 1 = bfloat16.
// resolution: 7 or 14.  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for an unsupported dtype, resolution or level count,
// and in bfloat16 for C not a multiple of 8 or a patch above 48.
int td_roi_pool_levels(const void* const* bases, const int* rows,
                       const int* widths, int n_levels, const void* meta,
                       const void* ay, const void* ax, void* out, int n,
                       int resolution, int patch, int channels, int dtype,
                       void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  LevelBuffers bufs = {};
  for (int l = 0; l < n_levels; ++l) {
    bufs.base[l] = bases[l];
    bufs.rows[l] = rows[l];
    bufs.width[l] = widths[l];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && resolution == 7)
    return static_cast<int>(launch_f32<7>(bufs, meta, ay, ax, out, n, patch,
                                          n_levels, channels, s));
  if (dtype == 0 && resolution == 14)
    return static_cast<int>(launch_f32<14>(bufs, meta, ay, ax, out, n, patch,
                                           n_levels, channels, s));
  if (dtype == 1 && resolution == 7)
    return static_cast<int>(launch_bf16<7>(bufs, meta, ay, ax, out, n, patch,
                                           n_levels, channels, s));
  if (dtype == 1 && resolution == 14)
    return static_cast<int>(launch_bf16<14>(bufs, meta, ay, ax, out, n, patch,
                                            n_levels, channels, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory of one block of the bfloat16 kernels (K1's, K5's and
// K6's, all pool_box_bf16) at this resolution, in bytes; 0 for another.
int td_roi_pool_bf16_smem_bytes(int resolution) {
  if (resolution == 7) return static_cast<int>(bf16_smem_bytes<7>());
  if (resolution == 14) return static_cast<int>(bf16_smem_bytes<14>());
  return 0;
}

}  // extern "C"
