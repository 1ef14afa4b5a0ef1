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
// What bounds it: memory, as the flat pooler (see the note there); the bytes
// it must move are the flat pooler's less the width padding.  Same simple
// design: one block per (box, 32-channel slice), the two contraction phases
// of roi_pool_window.cuh, overlapping windows served from L2.  Reads outside
// a buffer are zeros.

#include "roi_pool_window.cuh"

namespace {

using namespace roi_pool;

constexpr int kMaxLevels = 4;

struct LevelBuffers {
  const void* base[kMaxLevels];
  int rows[kMaxLevels];
  int width[kMaxLevels];
};

template <typename T, int R>
__global__ void __launch_bounds__(kThreads)
roi_pool_levels_kernel(const __grid_constant__ LevelBuffers bufs,
                       const int32_t* __restrict__ meta,
                       const float* __restrict__ ay, const float* __restrict__ ax,
                       T* __restrict__ out, int n_levels, int channels, int patch) {
  extern __shared__ float smem[];
  const int cpatch = patch + 8;
  const int box = blockIdx.x;
  int level = meta[3 * box];
  // the wrapper checks the range; clamp so that a bad level cannot index
  // outside the struct
  level = min(max(level, 0), n_levels - 1);
  pool_box<T, R>(static_cast<const T*>(bufs.base[level]), bufs.rows[level],
                 bufs.width[level], bufs.width[level], channels,
                 blockIdx.y * kCSlice, channels, meta[3 * box + 1],
                 meta[3 * box + 2],
                 ay + static_cast<size_t>(box) * R * patch,
                 ax + static_cast<size_t>(box) * R * cpatch,
                 out + static_cast<size_t>(box) * R * R * channels, patch, smem);
}

template <typename T, int R>
cudaError_t launch(const LevelBuffers& bufs, const void* meta, const void* ay,
                   const void* ax, void* out, int n, int patch, int n_levels,
                   int channels, cudaStream_t stream) {
  const size_t smem = smem_bytes<R>(patch);
  auto kernel = roi_pool_levels_kernel<T, R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const dim3 grid(n, (channels + kCSlice - 1) / kCSlice);
  kernel<<<grid, kThreads, smem, stream>>>(
      bufs, static_cast<const int32_t*>(meta), static_cast<const float*>(ay),
      static_cast<const float*>(ax), static_cast<T*>(out), n_levels, channels,
      patch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bases / rows / widths: n_levels entries each (1..4), host arrays.
// meta: (N, 3) int32 on the device.  dtype: 0 = float32, 1 = bfloat16.
// resolution: 7 or 14.  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for an unsupported dtype, resolution or level count.
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
  ROI_POOL_DISPATCH(launch, dtype, resolution, bufs, meta, ay, ax, out, n, patch,
                    n_levels, channels, s);
}

}  // extern "C"
