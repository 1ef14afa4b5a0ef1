// The ResNet backbone's frozen norms, shortcut adds and ReLUs as one
// elementwise pass per conv, on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these to XLA, which fuses
// them into the convolutions.  Run as eager PyTorch operations
// (models/resnet.py: FrozenBN, ConvBN, Bottleneck, kept as the plain
// versions), a conv's output is read and written once for the multiply by
// the norm's scale, once for the add of its bias and once for the ReLU; a
// bottleneck's last conv adds one more pass for the shortcut add and its
// ReLU, and a projection shortcut two for its own norm.  The two broadcast
// passes over a channels_last map take PyTorch's non-vectorised
// elementwise kernel.
//
// Two forms of one kernel, chosen by what the launch is given:
//
//   ReLU form  (the stem, conv1 and conv2 of a bottleneck):
//     out = relu(rnd(rnd(y * s) + b))
//   tail form  (a bottleneck's conv3 with its shortcut):
//     out = relu(rnd(rnd(rnd(y * s) + b) + sc)),
//     sc = x (the block's input), or rnd(rnd(ysc * ssc) + bsc) from the
//     projection shortcut conv's raw output
//
// with rnd the rounding to the tensor's dtype.  Each product and sum is
// taken in float32 and rounded on its own (__fmul_rn, __fadd_rn: never
// contracted into a multiply-add), and rounded to bf16 to nearest even where
// PyTorch rounds its bf16 operations' float results; the ReLU is PyTorch's
// clamp_min(v, 0): a NaN passes as it is.  So the output is bit-equal to the
// plain path, in bf16 and in float32 (where rnd does nothing).
//
// What bounds it: memory.  No arithmetic to speak of against 4 bytes an
// element in bf16 (the ReLU form: y read, out written in place) or 6 (the
// tail: y and the shortcut read, out written in place): 15.6 GB a batch of
// 10 tiles of 1024^2 through R101, 4.66 ms at 3.35 TB/s.  The design moves
// each byte once, at the full width of a load: the maps are NHWC, channels
// innermost, so a thread takes 16 bytes (8 bf16 or 4 float32 channels) of y,
// of the shortcut and of out at a time, four such vectors in flight per
// thread, in a grid-stride loop over as many blocks as the card holds at
// once.  The grid's stride is a multiple of the channel count, so each thread
// sees the same channels in every iteration and keeps their scale and bias
// in registers, loaded once.  Every ResNet channel count (64 to 2048) is a
// multiple of the vector, and the caching allocator aligns each map: a
// channel count the vector does not divide, or a pointer off a 16-byte
// boundary, is refused (the wrapper raises first).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;         // vectors in flight per thread
constexpr int kMaxDevices = 64;

enum Form { kRelu, kTail, kTailProjected };

// One element type's loads, roundings and stores, all through float32.
template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float get(float v) { return v; }
  static __device__ __forceinline__ float rnd(float v) { return v; }
  static __device__ __forceinline__ float put(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float get(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  // float -> bf16, to nearest even, as PyTorch's bf16 operations round
  static __device__ __forceinline__ float rnd(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 put(float v) {
    return __float2bfloat16_rn(v);
  }
};

// the elements of T in one 16-byte load or store
template <typename T>
constexpr int kVec = 16 / sizeof(T);

template <typename T>
struct alignas(16) Pack {
  T v[kVec<T>];
};

// torch.relu (clamp_min(v, 0)) on the card: a NaN passes
__device__ __forceinline__ float relu(float v) {
  return isnan(v) ? v : fmaxf(v, 0.f);
}

template <typename T>
struct Args {
  T* out;
  const T* y;
  const T* scale;
  const T* bias;
  const T* shortcut;        // kTail: x; kTailProjected: the projection's y
  const T* shortcut_scale;  // kTailProjected only
  const T* shortcut_bias;
};

// rnd(rnd(v * s) + b): FrozenBN.forward
template <typename T>
__device__ __forceinline__ float norm(float v, float s, float b) {
  return Num<T>::rnd(__fadd_rn(Num<T>::rnd(__fmul_rn(v, s)), b));
}

// The grid's stride in packs is a multiple of channel_packs (the launch
// sees to it), so a thread's channels are the same in every iteration.
template <typename T, int kForm>
__global__ void __launch_bounds__(kThreads)
frozen_norm_kernel(Args<T> a, long long packs, int channel_packs) {
  constexpr int N = kVec<T>;
  using P = Pack<T>;
  using R = Num<T>;
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long first =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const int c = static_cast<int>(first % channel_packs);
  float s[N], b[N], ss[N], sb[N];
  {
    const P sv = reinterpret_cast<const P*>(a.scale)[c];
    const P bv = reinterpret_cast<const P*>(a.bias)[c];
#pragma unroll
    for (int j = 0; j < N; ++j) {
      s[j] = R::get(sv.v[j]);
      b[j] = R::get(bv.v[j]);
    }
    if (kForm == kTailProjected) {
      const P ssv = reinterpret_cast<const P*>(a.shortcut_scale)[c];
      const P sbv = reinterpret_cast<const P*>(a.shortcut_bias)[c];
#pragma unroll
      for (int j = 0; j < N; ++j) {
        ss[j] = R::get(ssv.v[j]);
        sb[j] = R::get(sbv.v[j]);
      }
    }
  }
  const P* y = reinterpret_cast<const P*>(a.y);
  const P* sc = reinterpret_cast<const P*>(a.shortcut);
  P* out = reinterpret_cast<P*>(a.out);
  for (long long base = first; base < packs; base += kUnroll * stride) {
    P yv[kUnroll], scv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i < packs) {
        yv[u] = y[i];
        if (kForm != kRelu) scv[u] = sc[i];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long i = base + u * stride;
      if (i >= packs) continue;
      P o;
#pragma unroll
      for (int j = 0; j < N; ++j) {
        float v = norm<T>(R::get(yv[u].v[j]), s[j], b[j]);
        if (kForm != kRelu) {
          float r = R::get(scv[u].v[j]);
          if (kForm == kTailProjected) r = norm<T>(r, ss[j], sb[j]);
          v = R::rnd(__fadd_rn(v, r));
        }
        o.v[j] = R::put(relu(v));
      }
      out[i] = o;
    }
  }
}

int gcd(int a, int b) {
  while (b) {
    const int t = a % b;
    a = b;
    b = t;
  }
  return a;
}

// The grid: enough blocks for every pack, at most as many as the card holds
// at once (`resident` a multiprocessor), a multiple of
// channel_packs / gcd(channel_packs, kThreads) so that the stride is a
// multiple of channel_packs.
int grid_size(long long packs, int channel_packs, int sms, int resident) {
  const long long step = channel_packs / gcd(channel_packs, kThreads);
  long long blocks = (packs + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * resident;
  if (blocks > most) blocks = most;
  blocks = blocks / step * step;
  if (blocks < step) blocks = step;
  return blocks > 0x7fffffff ? -1 : static_cast<int>(blocks);
}

template <typename T, int kForm>
cudaError_t launch_kernel(const Args<T>& a, long long packs, int channel_packs,
                          int sms, cudaStream_t stream) {
  // the blocks a multiprocessor holds at once (registers decide), asked once
  static int resident = 0;
  if (resident == 0) {
    int count = 0;
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &count, frozen_norm_kernel<T, kForm>, kThreads, 0);
    if (err != cudaSuccess) return err;
    resident = count < 1 ? 1 : count;
  }
  const int blocks = grid_size(packs, channel_packs, sms, resident);
  if (blocks < 0) return cudaErrorInvalidValue;
  frozen_norm_kernel<T, kForm><<<blocks, kThreads, 0, stream>>>(
      a, packs, channel_packs);
  return cudaGetLastError();
}

bool aligned(const void* p) {
  return p == nullptr || reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

template <typename T>
cudaError_t launch(const Args<T>& a, long long n, int channels, int sms,
                   cudaStream_t stream) {
  if (channels % kVec<T> != 0 || !aligned(a.out) || !aligned(a.y) ||
      !aligned(a.scale) || !aligned(a.bias) || !aligned(a.shortcut) ||
      !aligned(a.shortcut_scale) || !aligned(a.shortcut_bias))
    return cudaErrorInvalidValue;
  const long long packs = n / kVec<T>;
  const int channel_packs = channels / kVec<T>;
  if (a.shortcut == nullptr)
    return launch_kernel<T, kRelu>(a, packs, channel_packs, sms, stream);
  if (a.shortcut_scale == nullptr)
    return launch_kernel<T, kTail>(a, packs, channel_packs, sms, stream);
  return launch_kernel<T, kTailProjected>(a, packs, channel_packs, sms,
                                          stream);
}

}  // namespace

extern "C" {

// out, y and shortcut: n elements of dense NHWC maps (channels innermost) of
// the same shape, bf16 (bf16 != 0) or float32; scale, bias, shortcut_scale and
// shortcut_bias: `channels` elements of the same type, a multiple of 16
// bytes; every pointer on a 16-byte boundary.  out may be y.  The ReLU form
// without a shortcut; the tail form with it, whose own norm is applied where
// shortcut_scale is given (shortcut_bias then too).  Returns a cudaError_t.
int td_frozen_norm(void* out, const void* y, const void* scale,
                   const void* bias, const void* shortcut,
                   const void* shortcut_scale, const void* shortcut_bias,
                   long long n, int channels, int bf16, void* stream) {
  if (n == 0) return 0;
  if (n < 0 || channels < 1 || n % channels != 0 ||
      (shortcut_scale == nullptr) != (shortcut_bias == nullptr) ||
      (shortcut == nullptr && shortcut_scale != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  // the multiprocessors of each device, asked once
  static int sms[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (sms[device] == 0) {
    int count = 0;
    err = cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms[device] = count;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    using T = __nv_bfloat16;
    const Args<T> a{static_cast<T*>(out), static_cast<const T*>(y),
                    static_cast<const T*>(scale), static_cast<const T*>(bias),
                    static_cast<const T*>(shortcut),
                    static_cast<const T*>(shortcut_scale),
                    static_cast<const T*>(shortcut_bias)};
    err = launch(a, n, channels, sms[device], s);
  } else {
    const Args<float> a{static_cast<float*>(out), static_cast<const float*>(y),
                        static_cast<const float*>(scale),
                        static_cast<const float*>(bias),
                        static_cast<const float*>(shortcut),
                        static_cast<const float*>(shortcut_scale),
                        static_cast<const float*>(shortcut_bias)};
    err = launch(a, n, channels, sms[device], s);
  }
  return static_cast<int>(err);
}

}  // extern "C"
