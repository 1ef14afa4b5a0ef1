// The batched ROI pooler's work around its patch kernels, on Hopper (sm_90a):
// every box's geometry, and the exact gather tail.
//
// Replaces no TPU kernel.  The JAX package computes both with XLA inside its
// jitted forward (treedetection_tpu/ops/roi_align.py); run as eager PyTorch
// operations (ops/roi_align.py: _box_geometry, _gather_rows_core, kept as the
// plain versions) they cost some 290 launches per pooling call, each issued by
// the host thread that also feeds the rest of the forward.  Both kernels are
// bound by that host, not by the card: a few hundred KB to a few MB move per
// call, microseconds of device time.
//
// box_geometry_kernel: one block per box.  FPN level, window origin, the R*S
// sample coordinates of each axis relative to the window, their validity, the
// hat matrices A_y (R, P) and A_x (R, P+8) that K1, K5 and K6 contract with,
// the overflow flag, the exact tail's priority and K1's or K5's window index.
// Every value is bit-equal to the plain version run by PyTorch on the card:
// the same operations in the same order, each rounded on its own (__fadd_rn,
// __fmul_rn, ... never contract into a multiply-add), and a division by a
// Python number done as PyTorch's CUDA division does it, as a multiply by the
// float reciprocal.  So the patch kernels get the hats and origins they got
// from the plain version, and K1, K5 and K6 stay bit-equal to each other.
//
// exact_tail_kernel: one block per (picked box, image) of a per-image top-k;
// a block whose flag is 0 returns at once.  The box's R*S sample rows and
// columns (their two corners, weights and validity) go to shared memory, then
// each thread pools its channels: aligned bilinear sampling at S x S samples a
// bin, zero outside (-1, H), float32 accumulation in the plain version's
// order, one rounding to the output dtype.  It reads the features where the
// patch kernel read them: K1's level-concatenated buffer, or the up to four
// per-level buffers of K5 and K6.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// Columns of the level table (ops/kernels/roi_align.py TABLE_COLUMNS).
enum Col { kH, kW, kHp, kLvlBase, kFlatPitch, kLevelPitch, kStride, kMaxR0,
           kMaxC0, kCols };

constexpr int kMaxLevels = 4;
constexpr int kGeomThreads = 128;
constexpr int kTailThreads = 256;

// torch.clamp(v, min=0.0) and torch.minimum on the card: NaN propagates.
__device__ __forceinline__ float clamp_min0(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}
__device__ __forceinline__ float minimum(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return fminf(a, b);
}

// What both kernels need of one box: its level's row of the table and the
// box in the level's coordinates (x0, y0 half-pixel shifted; bin sizes).
struct Box {
  int level;
  const long long* cols;
  float x0, y0, bin_w, bin_h;
};

// assign_fpn_levels, then _patch_pool_prep's / _sample_grid's scaled box.
__device__ __forceinline__ Box load_box(const float* __restrict__ box,
                                        const long long* __restrict__ table,
                                        int n_levels, int resolution) {
  const float bx0 = box[0], by0 = box[1], bx1 = box[2], by1 = box[3];
  const float area = __fmul_rn(clamp_min0(__fsub_rn(bx1, bx0)),
                               clamp_min0(__fsub_rn(by1, by0)));
  // size / 224 + 1e-8: a multiply by the float reciprocal of 224
  const float t = __fadd_rn(__fmul_rn(__fsqrt_rn(area), 1.0f / 224.0f),
                            static_cast<float>(1e-8));
  float lvl = floorf(__fadd_rn(log2f(t), 4.0f));
  if (!isnan(lvl)) lvl = fminf(fmaxf(lvl, 2.f), static_cast<float>(1 + n_levels));
  long long level = static_cast<long long>(lvl) - 2;
  // a NaN box has no level: keep its reads inside the table
  level = level < 0 ? 0 : (level >= n_levels ? n_levels - 1 : level);
  Box b;
  b.level = static_cast<int>(level);
  b.cols = table + level * kCols;
  // 1.0 / stride, then the box scaled by it
  const float scale =
      __fdiv_rn(1.0f, static_cast<float>(b.cols[kStride]));
  const float sx0 = __fmul_rn(bx0, scale), sy0 = __fmul_rn(by0, scale);
  const float sx1 = __fmul_rn(bx1, scale), sy1 = __fmul_rn(by1, scale);
  b.x0 = __fsub_rn(sx0, 0.5f);
  b.y0 = __fsub_rn(sy0, 0.5f);
  const float inv_r = __fdiv_rn(1.0f, static_cast<float>(resolution));
  b.bin_w = __fmul_rn(__fsub_rn(sx1, sx0), inv_r);
  b.bin_h = __fmul_rn(__fsub_rn(sy1, sy0), inv_r);
  return b;
}

// Offset of sample k (bin k / S, sample k % S) in bins:
// arange(R)[:, None] + (arange(S) + 0.5) / S.
__device__ __forceinline__ float sample_offset(int k, int s, float inv_s) {
  const float sv = __fmul_rn(__fadd_rn(static_cast<float>(k % s), 0.5f), inv_s);
  return __fadd_rn(static_cast<float>(k / s), sv);
}

// One axis of a box's geometry: origin (clamped window start) and its size.
struct Axis {
  float start, bin, lim;   // y0 or x0, bin size, the level's h or w as float
  long long origin;        // oy or ox (before the column snap)
};

__device__ __forceinline__ long long window_origin(float start, long long n) {
  long long o = static_cast<long long>(floorf(start));
  o = o < 0 ? 0 : o;
  const long long hi = n - 1 < 0 ? 0 : n - 1;
  return o < hi ? o : hi;
}

// Sample k of an axis: its absolute coordinate and validity, and the
// coordinate relative to the window origin (before the column snap).
__device__ __forceinline__ float axis_sample(const Axis& a, int k, int s,
                                             float inv_s, bool* valid) {
  const float v = __fadd_rn(a.start, __fmul_rn(sample_offset(k, s, inv_s), a.bin));
  *valid = v > -1.f && v < a.lim;
  return __fsub_rn(minimum(clamp_min0(v), __fsub_rn(a.lim, 1.f)),
                   static_cast<float>(a.origin));
}

// One row of a hat matrix: mean over the bin's S samples of
// clamp(1 - |s - k|, 0) * valid.
__device__ __forceinline__ float hat(const Axis& a, int r, int k, int s,
                                     float inv_s, float shift) {
  float acc = 0.f;
  for (int j = 0; j < s; ++j) {
    bool valid;
    float c = axis_sample(a, r * s + j, s, inv_s, &valid);
    c = __fadd_rn(c, shift);
    const float h = clamp_min0(
        __fsub_rn(1.f, fabsf(__fsub_rn(c, static_cast<float>(k)))));
    acc = __fadd_rn(acc, __fmul_rn(h, valid ? 1.f : 0.f));
  }
  return __fmul_rn(acc, inv_s);
}

struct GeomOut {
  long long *img, *levels, *oy, *ox_al;
  float *sy, *sx_al;
  bool *valid_y, *valid_x;
  float *ay, *ax;
  bool* overflow;
  float* prio;
  int32_t* index;
};

__global__ void __launch_bounds__(kGeomThreads)
box_geometry_kernel(const float* __restrict__ boxes,
                    const long long* __restrict__ table, int n_levels, int n,
                    int n_per_image, int resolution, int s, int patch,
                    int flat_layout, GeomOut o) {
  const int i = blockIdx.x;
  const Box b = load_box(boxes + 4 * static_cast<size_t>(i), table, n_levels,
                         resolution);
  const long long h = b.cols[kH], w = b.cols[kW];
  Axis ya{b.y0, b.bin_h, static_cast<float>(h), window_origin(b.y0, h)};
  Axis xa{b.x0, b.bin_w, static_cast<float>(w), window_origin(b.x0, w)};
  const long long ox_al = (xa.origin / 8) * 8;   // ox >= 0
  const float shift = static_cast<float>(xa.origin - ox_al);
  const float inv_s = __fdiv_rn(1.0f, static_cast<float>(s));
  const int rs = resolution * s;
  const int cpatch = patch + 8;
  const size_t row = static_cast<size_t>(i) * rs;

  for (int k = threadIdx.x; k < rs; k += blockDim.x) {
    bool vy, vx;
    o.sy[row + k] = axis_sample(ya, k, s, inv_s, &vy);
    o.sx_al[row + k] = __fadd_rn(axis_sample(xa, k, s, inv_s, &vx), shift);
    o.valid_y[row + k] = vy;
    o.valid_x[row + k] = vx;
  }
  float* ay = o.ay + static_cast<size_t>(i) * resolution * patch;
  for (int e = threadIdx.x; e < resolution * patch; e += blockDim.x)
    ay[e] = hat(ya, e / patch, e % patch, s, inv_s, 0.f);
  float* ax = o.ax + static_cast<size_t>(i) * resolution * cpatch;
  for (int e = threadIdx.x; e < resolution * cpatch; e += blockDim.x)
    ax[e] = hat(xa, e / cpatch, e % cpatch, s, inv_s, shift);

  if (threadIdx.x == 0) {
    // overflow: the samples' largest window coordinate past the patch
    float my = __int_as_float(0xff800000), mx = my;   // -inf
    bool nan_y = false, nan_x = false;
    for (int k = 0; k < rs; ++k) {
      bool v;
      const float cy = axis_sample(ya, k, s, inv_s, &v);
      const float cx = __fadd_rn(axis_sample(xa, k, s, inv_s, &v), shift);
      nan_y |= isnan(cy);
      nan_x |= isnan(cx);
      my = fmaxf(my, cy);
      mx = fmaxf(mx, cx);
    }
    // amax propagates NaN, and NaN > bound is false
    const bool over = (!nan_y && my > static_cast<float>(patch - 1)) ||
                      (!nan_x && mx > static_cast<float>(cpatch - 1));
    const long long img = i / n_per_image;
    const long long r0 = img * b.cols[kHp] + ya.origin;
    o.img[i] = img;
    o.levels[i] = b.level;
    o.oy[i] = ya.origin;
    o.ox_al[i] = ox_al;
    o.overflow[i] = over;
    o.prio[i] = over ? 2.f : 0.f;
    if (flat_layout) {   // (2, n): [rows; cols]
      o.index[i] = static_cast<int32_t>(b.cols[kLvlBase] + r0);
      o.index[n + i] = static_cast<int32_t>(ox_al);
    } else {             // (n, 3): [level, row, col]
      o.index[3 * i] = b.level;
      o.index[3 * i + 1] = static_cast<int32_t>(r0);
      o.index[3 * i + 2] = static_cast<int32_t>(ox_al);
    }
  }
}

struct Sources {
  const void* level[kMaxLevels];
};

template <typename T>
__device__ __forceinline__ float load(const T* p);
template <>
__device__ __forceinline__ float load<float>(const float* p) {
  return __ldg(p);
}
template <>
__device__ __forceinline__ float load<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
template <typename T>
__device__ __forceinline__ T store(float v);
template <>
__device__ __forceinline__ float store<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 store<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// _gather_rows_core for the picked boxes, written where the plain version's
// torch.where scatter writes.
template <typename T>
__global__ void __launch_bounds__(kTailThreads)
exact_tail_kernel(Sources src, const long long* __restrict__ table,
                  int n_levels, int flat_layout,
                  const float* __restrict__ boxes,
                  const long long* __restrict__ idx, long long idx_pitch,
                  const float* __restrict__ flag, long long flag_pitch,
                  int n_per_image, int resolution, int s, int channels,
                  T* __restrict__ out, bool* __restrict__ sel) {
  const int j = blockIdx.x, img = blockIdx.y;
  if (!(flag[img * flag_pitch + j] > 0.f)) return;   // the whole block
  const long long box =
      static_cast<long long>(img) * n_per_image + idx[img * idx_pitch + j];
  const Box b = load_box(boxes + 4 * box, table, n_levels, resolution);
  const long long* cols = b.cols;
  const long long h = cols[kH], w = cols[kW];
  const int rs = resolution * s;
  const float inv_s = __fdiv_rn(1.0f, static_cast<float>(s));

  // per sample of each axis: first and second corner, the weight of the
  // second, validity
  extern __shared__ unsigned char smem[];
  int* corner0 = reinterpret_cast<int*>(smem);       // (2, rs)
  int* corner1 = corner0 + 2 * rs;                   // (2, rs)
  float* frac = reinterpret_cast<float*>(corner1 + 2 * rs);
  unsigned char* valid = reinterpret_cast<unsigned char*>(frac + 2 * rs);
  for (int k = threadIdx.x; k < 2 * rs; k += blockDim.x) {
    const bool is_x = k >= rs;
    const int kk = is_x ? k - rs : k;
    const long long n = is_x ? w : h;
    const float lim = static_cast<float>(n);
    const float v = __fadd_rn(is_x ? b.x0 : b.y0,
                              __fmul_rn(sample_offset(kk, s, inv_s),
                                        is_x ? b.bin_w : b.bin_h));
    valid[k] = v > -1.f && v < lim;
    const float c = minimum(clamp_min0(v), __fsub_rn(lim, 1.f));
    const long long c0 = static_cast<long long>(floorf(c));
    const long long c1 = c0 + 1 < n - 1 ? c0 + 1 : n - 1;
    corner0[k] = static_cast<int>(c0);
    corner1[k] = static_cast<int>(c1);
    frac[k] = __fsub_rn(c, static_cast<float>(c0));
  }
  __syncthreads();

  const T* base = static_cast<const T*>(src.level[flat_layout ? 0 : b.level]);
  const long long row0 =
      (flat_layout ? cols[kLvlBase] : 0) + img * cols[kHp];
  const long long pitch = flat_layout ? cols[kFlatPitch] : cols[kLevelPitch];
  const float inv_ss = __fdiv_rn(1.0f, static_cast<float>(s * s));
  T* out_box = out + box * resolution * resolution * channels;
  for (int c = threadIdx.x; c < channels; c += blockDim.x) {
    auto at = [&](int y, int x) {
      return load<T>(base + ((row0 + y) * pitch + x) * channels + c);
    };
    for (int ry = 0; ry < resolution; ++ry) {
      for (int rx = 0; rx < resolution; ++rx) {
        float acc = 0.f;
        for (int sy = 0; sy < s; ++sy) {
          const int ky = ry * s + sy;
          for (int sx = 0; sx < s; ++sx) {
            const int kx = rs + rx * s + sx;
            if (!(valid[ky] && valid[kx])) continue;   // adds 0
            const float ly = frac[ky], lx = frac[kx];
            const float hy = __fsub_rn(1.f, ly), hx = __fsub_rn(1.f, lx);
            const int y0 = corner0[ky], y1 = corner1[ky];
            const int x0 = corner0[kx], x1 = corner1[kx];
            float v = __fmul_rn(__fmul_rn(at(y0, x0), hy), hx);
            v = __fadd_rn(v, __fmul_rn(__fmul_rn(at(y0, x1), hy), lx));
            v = __fadd_rn(v, __fmul_rn(__fmul_rn(at(y1, x0), ly), hx));
            v = __fadd_rn(v, __fmul_rn(__fmul_rn(at(y1, x1), ly), lx));
            acc = __fadd_rn(acc, v);
          }
        }
        out_box[(ry * resolution + rx) * channels + c] =
            store<T>(__fmul_rn(acc, inv_ss));
      }
    }
  }
  if (sel != nullptr && threadIdx.x == 0) sel[box] = true;
}

template <typename T>
cudaError_t launch_tail(const Sources& src, const long long* table,
                        int n_levels, int flat_layout, const float* boxes,
                        const long long* idx,
                        long long idx_pitch, const float* flag,
                        long long flag_pitch, int n_images, int m,
                        int n_per_image, int resolution, int s, int channels,
                        void* out, bool* sel, cudaStream_t stream) {
  const int rs = resolution * s;
  const size_t smem = static_cast<size_t>(2 * rs) *
                      (2 * sizeof(int) + sizeof(float) + 1);
  const dim3 grid(m, n_images);
  exact_tail_kernel<T><<<grid, kTailThreads, smem, stream>>>(
      src, table, n_levels, flat_layout, boxes, idx, idx_pitch, flag,
      flag_pitch, n_per_image, resolution, s, channels, static_cast<T*>(out),
      sel);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Outputs, each allocated by the caller: img, levels, oy, ox_al (n) int64;
// sy, sx_al (n, R*S) float32; valid_y, valid_x (n, R*S) bool; ay (n, R, P)
// and ax (n, R, P+8) float32; overflow (n) bool; prio (n) float32; index
// (2, n) int32 with flat_layout, else (n, 3) int32.  Returns a cudaError_t.
int td_roi_geometry(const void* boxes, const void* table, int n_levels, int n,
                    int n_per_image, int resolution, int sampling_ratio,
                    int patch, int flat_layout, void* img, void* levels,
                    void* oy, void* ox_al, void* sy, void* sx_al,
                    void* valid_y, void* valid_x, void* ay, void* ax,
                    void* overflow, void* prio, void* index, void* stream) {
  if (n == 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || n_per_image < 1 ||
      sampling_ratio < 1 || resolution < 1 || patch < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  GeomOut o{static_cast<long long*>(img), static_cast<long long*>(levels),
            static_cast<long long*>(oy), static_cast<long long*>(ox_al),
            static_cast<float*>(sy), static_cast<float*>(sx_al),
            static_cast<bool*>(valid_y), static_cast<bool*>(valid_x),
            static_cast<float*>(ay), static_cast<float*>(ax),
            static_cast<bool*>(overflow), static_cast<float*>(prio),
            static_cast<int32_t*>(index)};
  box_geometry_kernel<<<n, kGeomThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(boxes), static_cast<const long long*>(table),
      n_levels, n, n_per_image, resolution, sampling_ratio, patch, flat_layout,
      o);
  return static_cast<int>(cudaGetLastError());
}

// buffers: kMaxLevels pointers (K1's buffer first with flat_layout, else one
// per level).  dtype: 0 = float32, 1 = bfloat16.  sel may be null.  Returns a
// cudaError_t.
int td_roi_exact_tail(const void* const* buffers, const void* table,
                      int n_levels, int flat_layout, const void* boxes,
                      const void* idx, long long idx_pitch,
                      const void* flag, long long flag_pitch, int n_images,
                      int m, int n_per_image, int resolution,
                      int sampling_ratio, int channels, int dtype, void* out,
                      void* sel, void* stream) {
  if (n_images == 0 || m == 0) return 0;
  if (n_levels < 1 || n_levels > kMaxLevels || sampling_ratio < 1 ||
      resolution < 1 || n_images > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Sources src;
  for (int l = 0; l < kMaxLevels; ++l) src.level[l] = buffers[l];
  const auto* t = static_cast<const long long*>(table);
  const auto* bx = static_cast<const float*>(boxes);
  const auto* ix = static_cast<const long long*>(idx);
  const auto* fl = static_cast<const float*>(flag);
  auto* sl = static_cast<bool*>(sel);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(launch_tail<float>(
        src, t, n_levels, flat_layout, bx, ix, idx_pitch, fl, flag_pitch,
        n_images, m, n_per_image, resolution, sampling_ratio, channels, out,
        sl, s));
  if (dtype == 1)
    return static_cast<int>(launch_tail<__nv_bfloat16>(
        src, t, n_levels, flat_layout, bx, ix, idx_pitch, fl, flag_pitch,
        n_images, m, n_per_image, resolution, sampling_ratio, channels, out,
        sl, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
