// Image-resident ROIAlign patch pooler for Hopper (sm_90a).
//
// Replaces the TPU kernel `roi_pool_resident`
// (treedetection_tpu/ops/pallas/roi_align_kernel.py).  Same inputs and
// output as the per-level pooler (roi_pool_levels.cu), with the TPU kernel's
// contract on top: the N = n_images * n_per boxes are grouped by image (box i
// belongs to image i / n_per, n_per a multiple of `chunk`), meta[i] =
// [level, row0, col0] has row0 relative to the image's section, and the
// origins are clamped by the caller into the UNPADDED corner of the section,
// (max(H_l, P), max(W_l, P+8)), with the hat matrices shifted to match.  The
// channels are processed in c_split blocks of c_blk = C / c_split.
//
// What the TPU kernel does with that contract: it copies an image's four
// sections (one C-block of them) into VMEM once and cuts every box of the
// image from the staged copy, so device memory is read once per image and
// C-block instead of once per box.  The staged set is 45.4 MB per image at
// the production geometry (1024^2 input, C=256 bf16; 22.7 MB per C-block at
// c_split=2).  No block's shared memory (227 KB) can hold that.  The level
// of this card that can is the L2 cache (50 MB), and L2 is not staged by
// hand: it holds what was read last.  So the design makes one (image,
// C-block)'s sections the working set of the blocks that run together:
//
//   grid = (chunks_per_image * slices_per_C_block, c_split, n_images)
//
// Blocks are handed out in linear order, x fastest, so all blocks of one
// (image, C-block) start before the next one's: the same order as the
// TPU kernel's grid (image, C-block, chunk).  A block serves one chunk of
// its image's boxes for one 32-channel slice of its C-block, in a loop: per
// box one call of the dtype's device function (below), reading the window
// straight from the unpadded corner of the image's section with the channel
// offset cb * c_blk.  The first box that touches a cell brings it in from
// device memory; the image's other boxes find it in L2.
//
// L2 share: the caller picks the smallest c_split whose sections
// (resident_section_bytes in ops/kernels/roi_align.py) fit HALF of the
// card's L2.  Half, because the hat matrices and the output stream through
// the same cache, the blocks of two neighbouring (image, C-block) sets
// overlap in time at the boundary, and the H100's L2 is built as two
// partitions.  No persisting access window is set.
//
// What bounds it: memory.  The bytes the function must move are the cells of
// the sections that the clamped windows touch (each once), the hat matrices,
// the indices and the output; this design reads the hat matrices once per
// 32-channel slice on top of that.  Reads outside a section are zeros (the
// clamp keeps every window inside it).  Padding boxes (zero hats, meta 0)
// pool level 0 at the origin into zeros; the caller cuts them off.
//
// float32 features take `pool_box` (roi_pool_window.cuh), the device function
// of K1's and K5's float32 kernels, on the whole window: the three poolers
// are bit-equal in float32.
//
// bfloat16 features (the production dtype) take roi_pool_resident_bf16_kernel:
// this grid, and per box K1's device function `pool_box_bf16`
// (roi_pool_bf16.cuh: the hats' span only, cp.async staging, mma.sync),
// called with the image's section as the buffer, the section's unpadded rows
// as its row bound and the buffer's width as its pitch and column bound.  A
// box's hats, refolded for its clamped origin, are K1's shifted by the clamp,
// so the span starts on the same cells of the image and every instruction
// sees K1's operands: on the same boxes K6 gives K1's bits.  The clamp keeps
// every window inside the section's unpadded corner (max(H_l, P),
// max(W_l, P+8)), so the buffer width reads nothing past it.  A block's boxes
// run one after the other: each call reduces its span and loads its hats
// before its first copy is in flight, so few boxes per block keep more
// loads in flight than many.  pool_box_bf16 bounds its 32-channel slice by C,
// so the C-block must be a whole number of slices.

#include "roi_pool_bf16.cuh"
#include "roi_pool_window.cuh"

namespace {

using namespace roi_pool;

constexpr int kMaxLevels = 4;

struct Sections {
  const void* base[kMaxLevels];
  int src_h[kMaxLevels];   // rows of one image's section in the buffer
  int width[kMaxLevels];   // buffer width (row pitch in pixels)
  int sec_h[kMaxLevels];   // unpadded corner that may be read
  int sec_w[kMaxLevels];
};

// the box's level, clamped: the wrapper checks the range, and the clamp
// keeps a bad level from indexing outside the struct
__device__ __forceinline__ int box_level(const int32_t* meta, size_t box,
                                         int n_levels) {
  return min(max(meta[3 * box], 0), n_levels - 1);
}

// the first cell of `image`'s section of a level buffer
template <typename T>
__device__ __forceinline__ const T* section(const Sections& secs, int level,
                                            int image, int channels) {
  return static_cast<const T*>(secs.base[level]) +
         static_cast<size_t>(image) * secs.src_h[level] * secs.width[level] *
             channels;
}

// --- float32: pool_box ---------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kThreads)
roi_pool_resident_kernel(const __grid_constant__ Sections secs,
                         const int32_t* __restrict__ meta,
                         const float* __restrict__ ay,
                         const float* __restrict__ ax, float* __restrict__ out,
                         int n_levels, int channels, int c_blk, int chunk,
                         int chunks_per_image, int patch) {
  extern __shared__ float smem[];
  const int cpatch = patch + 8;
  const int slices = (c_blk + kCSlice - 1) / kCSlice;
  const int image = blockIdx.z;
  const int c_base = blockIdx.y * c_blk;
  const int j = blockIdx.x / slices;
  const int c0 = c_base + (blockIdx.x % slices) * kCSlice;
  const int c_end = min(c_base + c_blk, channels);
  const size_t first = (static_cast<size_t>(image) * chunks_per_image + j) * chunk;
  for (int k = 0; k < chunk; ++k) {
    const size_t i = first + k;
    const int level = box_level(meta, i, n_levels);
    pool_box<R>(section<float>(secs, level, image, channels),
                secs.sec_h[level], secs.sec_w[level], secs.width[level],
                channels, c0, c_end, meta[3 * i + 1], meta[3 * i + 2],
                ay + i * R * patch, ax + i * R * cpatch,
                out + i * R * R * channels, patch, smem);
  }
}

template <int R>
cudaError_t launch_f32(const Sections& secs, const void* meta, const void* ay,
                       const void* ax, void* out, int n_images, int n_per,
                       int chunk, int c_split, int patch, int n_levels,
                       int channels, cudaStream_t stream) {
  const size_t smem = smem_bytes<R>(patch);
  auto kernel = roi_pool_resident_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int c_blk = channels / c_split;
  const int slices = (c_blk + kCSlice - 1) / kCSlice;
  const int chunks_per_image = n_per / chunk;
  const dim3 grid(chunks_per_image * slices, c_split, n_images);
  kernel<<<grid, kThreads, smem, stream>>>(
      secs, static_cast<const int32_t*>(meta), static_cast<const float*>(ay),
      static_cast<const float*>(ax), static_cast<float*>(out), n_levels,
      channels, c_blk, chunk, chunks_per_image, patch);
  return cudaGetLastError();
}

// --- bfloat16: pool_box_bf16 ------------------------------------------------------

template <int R>
__global__ void __launch_bounds__(kBf16Threads, 2)
roi_pool_resident_bf16_kernel(const __grid_constant__ Sections secs,
                              const int32_t* __restrict__ meta,
                              const float* __restrict__ ay,
                              const float* __restrict__ ax,
                              bf16* __restrict__ out, int n_levels,
                              int channels, int c_blk, int chunk,
                              int chunks_per_image, int patch) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int slices = c_blk / kSlice;
  const int image = blockIdx.z;
  const int j = blockIdx.x / slices;
  const int c0 = blockIdx.y * c_blk + (blockIdx.x % slices) * kSlice;
  const size_t first = (static_cast<size_t>(image) * chunks_per_image + j) * chunk;
  for (int k = 0; k < chunk; ++k) {
    // pool_box_bf16 resets its span before its first barrier and may return
    // without one (all-zero hats): the previous box must be done with both
    if (k) __syncthreads();
    const size_t i = first + k;
    const int level = box_level(meta, i, n_levels);
    pool_box_bf16<R>(section<bf16>(secs, level, image, channels),
                     secs.sec_h[level], secs.width[level], channels, c0,
                     meta[3 * i + 1], meta[3 * i + 2], ay + i * R * patch,
                     ax + i * R * (patch + 8), out + i * R * R * channels,
                     patch, smem_raw);
  }
}

template <int R>
cudaError_t launch_bf16(const Sections& secs, const void* meta, const void* ay,
                        const void* ax, void* out, int n_images, int n_per,
                        int chunk, int c_split, int patch, int n_levels,
                        int channels, cudaStream_t stream) {
  const int c_blk = channels / c_split;
  if (!bf16_shape_ok(channels, patch) || c_blk % kSlice != 0)
    return cudaErrorInvalidValue;
  constexpr size_t smem = bf16_smem_bytes<R>();
  auto kernel = roi_pool_resident_bf16_kernel<R>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  const int chunks_per_image = n_per / chunk;
  const dim3 grid(chunks_per_image * (c_blk / kSlice), c_split, n_images);
  kernel<<<grid, kBf16Threads, smem, stream>>>(
      secs, static_cast<const int32_t*>(meta), static_cast<const float*>(ay),
      static_cast<const float*>(ax), static_cast<bf16*>(out), n_levels,
      channels, c_blk, chunk, chunks_per_image, patch);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// bases / rows / widths: n_levels entries each (1..4), host arrays; rows[l]
// is the whole buffer's row count, n_images * (H_l + patch).  meta: (N, 3)
// int32 on the device with N = n_images * n_per.  dtype: 0 = float32, 1 =
// bfloat16.  resolution: 7 or 14.  Returns a cudaError_t (0 on success);
// cudaErrorInvalidValue for an unsupported dtype, resolution, level count,
// or a chunk / c_split / n_images that does not divide its dimension, and in
// bfloat16 for C not a multiple of 8, a patch above 48 or a C-block
// (C / c_split) that is not a multiple of 32.
int td_roi_pool_resident(const void* const* bases, const int* rows,
                         const int* widths, int n_levels, const void* meta,
                         const void* ay, const void* ax, void* out,
                         int n_images, int n_per, int chunk, int c_split,
                         int resolution, int patch, int channels, int dtype,
                         void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_images < 1 || chunk < 1 ||
      c_split < 1 || channels % c_split != 0 || n_per % chunk != 0 ||
      c_split > 65535 || n_images > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_per == 0) return 0;
  const int cpatch = patch + 8;
  Sections secs = {};
  for (int l = 0; l < n_levels; ++l) {
    if (rows[l] % n_images != 0) return static_cast<int>(cudaErrorInvalidValue);
    secs.base[l] = bases[l];
    secs.src_h[l] = rows[l] / n_images;
    secs.width[l] = widths[l];
    const int h = secs.src_h[l] - patch;
    const int w = widths[l] - cpatch;
    secs.sec_h[l] = h > patch ? h : patch;
    secs.sec_w[l] = w > cpatch ? w : cpatch;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && resolution == 7)
    return static_cast<int>(launch_f32<7>(secs, meta, ay, ax, out, n_images,
                                          n_per, chunk, c_split, patch,
                                          n_levels, channels, s));
  if (dtype == 0 && resolution == 14)
    return static_cast<int>(launch_f32<14>(secs, meta, ay, ax, out, n_images,
                                           n_per, chunk, c_split, patch,
                                           n_levels, channels, s));
  if (dtype == 1 && resolution == 7)
    return static_cast<int>(launch_bf16<7>(secs, meta, ay, ax, out, n_images,
                                           n_per, chunk, c_split, patch,
                                           n_levels, channels, s));
  if (dtype == 1 && resolution == 14)
    return static_cast<int>(launch_bf16<14>(secs, meta, ay, ax, out, n_images,
                                            n_per, chunk, c_split, patch,
                                            n_levels, channels, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
