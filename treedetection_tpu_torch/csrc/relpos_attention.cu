// Fused attention with decomposed relative positions, on Hopper (sm_90a):
// the attention of a ViTDet block, windowed or global, in one launch.
//
// Replaces no TPU kernel: the JAX package has no transformer backbone.  It was
// added for the ViT-L backbone of Mask R-CNN ViTDet (models/vit.py), whose 24
// blocks attend either within 14 x 14 windows of the 64 x 64 token map (20
// blocks) or over the whole map (4 blocks), with detectron2's decomposed
// relative-position bias in every block:
//
//   logit(q, k) = scale * q.k + q.Rh[qh - kh + Sh - 1]
//                             + q.Rw[qw - kw + Sw - 1]
//
// with q unscaled in the two bias terms.  No PyTorch operator takes that bias
// without materialising it (the global blocks' logits alone would be
// 10 * 16 * 4096^2 floats a block at batch 10), so the kernel adds it inside
// an online softmax, flash-attention style.
//
// What bounds it.  A global block is bound by the tensor cores: per (image,
// head) 2 * 4096^2 * 64 multiply-adds against about 2 MB of q, k, v and
// output, some 2000 operations a byte.  A windowed block is bound by memory:
// 196 keys a query, about 110 operations a byte, below the card's ~295.  So
// the design keeps every intermediate on the chip and reads each of q, k and
// v once per query tile, straight from where the qkv projection wrote them:
//
// * q, k and v are read through strides from the projection's (B, H, W, 3C)
//   output over the unpadded map (C = heads * 64, channel order (3, heads,
//   64) as detectron2's), and the output is written to (B, H, W, C), the
//   projection's input: no window partition, pad, permute or unpartition copy.
//   A key of a window that lies outside the map is one of detectron2's zero
//   pads after the norm: its k and v are the qkv bias, read from the bias.
//   Those keys are not masked, as in detectron2; the tile's ragged edge (keys
//   past the window's Sh * Sw) is.  Queries outside the map are not written.
// * Per query tile (64 queries, 16 per warp) the block loads the two tables
//   once and computes q . Rh^T and q . Rw^T for every table row with
//   mma.sync, in fp32 (times log2 e), and scatters each product where a key
//   row or column will read it: G_h[q][kh] = q . Rh[qh - kh + Sh - 1] and
//   G_w[q][kw] = q . Rw[qw - kw + Sw - 1], (Sh + Sw) floats a query in
//   shared memory (the query tile is staged in the same place before).  A
//   logit's bias is then two shared-memory reads, G_h[q][kh] + G_w[q][kw].
//   At 68 KB a block for the global blocks, three blocks share an SM.
// * The block walks the window's keys in tiles of 64 (cp.async, two stages,
//   zero-filled past the ragged edge), q.k and p.v by mma.sync m16n8k16 in
//   bf16 with fp32 accumulators, and an fp32 online softmax in base 2.
//   The output is rounded to bf16 once.
//
// Grid: (query tiles of a window, heads, images * windows), 128 threads.
// Head size 64; window sides up to 64 (tables of at most 127 rows), the
// tables either shared by the heads or one per head.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kD = 64;             // head size
constexpr int kBM = 64;            // queries of a block, 16 per warp
constexpr int kBN = 64;            // keys of a tile
constexpr int kThreads = 128;
constexpr int kStride = kD + 8;    // shared row stride (bf16): 144 bytes, so
                                   // that ldmatrix's 8 rows hit 8 bank groups
constexpr int kMaxSide = 64;       // largest window side
constexpr float kLog2e = 1.4426950408889634f;

constexpr int kTileElems = kBN * kStride;
// shared memory: the key and value tiles (two stages each), then the
// gathered bias rows G (one row of Sh + Sw + 1 floats a query), which hold
// the query tile until its fragments are in registers
constexpr int kKVBytes = 4 * kTileElems * 2;
__host__ __device__ constexpr int g_stride(int sh, int sw) {
  return sh + sw + 1;   // odd: the 8 rows a warp reads at once hit 8 banks
}
__host__ __device__ constexpr int g_bytes(int sh, int sw) {
  return kBM * g_stride(sh, sw) * 4 > kBM * kStride * 2
             ? kBM * g_stride(sh, sw) * 4
             : kBM * kStride * 2;
}
constexpr int kSmemMax = kKVBytes + g_bytes(kMaxSide, kMaxSide);

struct Params {
  const __nv_bfloat16* qkv;   // (B, H, W, 3C)
  const __nv_bfloat16* bias;  // (3C): the k and v of a pad token
  const __nv_bfloat16* rel_h;  // (2Sh - 1, 64), or per head
  const __nv_bfloat16* rel_w;  // (2Sw - 1, 64), or per head
  long long rel_h_head, rel_w_head;  // elements between two heads' tables
  __nv_bfloat16* out;          // (B, H, W, C)
  int hm, wm, c, sh, sw, nwh, nww;
  int rows_h, rows_w;          // 2Sh - 1, 2Sw - 1
  int pad_h, pad_w;            // rounded up to 16
  float scale_log2;            // scale * log2 e
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled where !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// One window of one image: where its tokens' q, k and v rows lie.
struct Window {
  const __nv_bfloat16* qkv;
  const __nv_bfloat16* bias;
  long long img_base;  // first token of the image
  int hm, wm, c, sw;
  int y0, x0;          // the window's first pixel
  int n;               // tokens of a window

  // window-local token t -> its pixel; false where it lies off the map
  __device__ __forceinline__ bool pixel(int t, int& y, int& x) const {
    const int ty = t / sw;
    y = y0 + ty;
    x = x0 + (t - ty * sw);
    return y < hm && x < wm;
  }
  // token t's q (part 0), k (1) or v (2) of `head`: its row of the qkv
  // output, or the bias for a pad token; `valid` false past the window
  __device__ __forceinline__ const __nv_bfloat16* src(int t, int part,
                                                      int head,
                                                      bool& valid) const {
    valid = t < n;
    const long long off = static_cast<long long>(part) * c + head * kD;
    if (!valid) return bias;
    int y, x;
    if (!pixel(t, y, x)) return bias + off;
    return qkv + (img_base + static_cast<long long>(y) * wm + x) * (3LL * c) +
           off;
  }
};

// Rows [0, rows) of a table into shared memory (rows up to pad zero-filled).
__device__ __forceinline__ void load_table(__nv_bfloat16* dst,
                                           const __nv_bfloat16* src, int rows,
                                           int pad, int tid) {
  for (int i = tid; i < pad * 8; i += kThreads) {
    const int r = i >> 3, ch = i & 7;
    const bool ok = r < rows;
    cp_async16(dst + r * kStride + ch * 8, ok ? src + r * kD + ch * 8 : src,
               ok);
  }
}

// 64 tokens' (q, k or v) rows from token t0 on into shared memory.
__device__ __forceinline__ void load_tokens(__nv_bfloat16* dst,
                                            const Window& w, int t0, int part,
                                            int head, int tid) {
#pragma unroll
  for (int i = 0; i < kBN * 8 / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx >> 3, ch = idx & 7;
    bool valid;
    const __nv_bfloat16* s = w.src(t0 + r, part, head, valid);
    cp_async16(dst + r * kStride + ch * 8, valid ? s + ch * 8 : s, valid);
  }
}

// log2(e) * q . R[r] for the warp's 16 queries and every table row r (up
// to `pad`), each scattered to g[q][side - 1 + coord(q) - r], the key row or
// column it biases, where that lies in the window.
__device__ __forceinline__ void table_products(const uint32_t (&qf)[4][4],
                                               const __nv_bfloat16* rs,
                                               int pad, int side,
                                               const int (&coord)[2],
                                               float* g, int gs, int warp,
                                               int lane) {
  const int row = warp * 16 + (lane >> 2);
  for (int np = 0; np < pad / 16; ++np) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t b[4];
      ldsm_x4(b, rs + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride +
                     kk * 16 + ((lane >> 3) & 1) * 8);
      mma16816(acc[0], qf[kk], b[0], b[1]);
      mma16816(acc[1], qf[kk], b[2], b[3]);
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int r = np * 16 + j * 8 + 2 * (lane & 3) + (e & 1);
        const int k = side - 1 + coord[i] - r;
        if (k >= 0 && k < side)
          g[(row + 8 * i) * gs + k] = acc[j][e] * kLog2e;
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 3)
    relpos_attention_kernel(const Params p) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem);  // [2][kBN][.]
  __nv_bfloat16* vs = ks + 2 * kTileElems;                       // [2][kBN][.]
  float* g = reinterpret_cast<float*>(vs + 2 * kTileElems);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(g);  // staged first
  const int gs = g_stride(p.sh, p.sw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int head = blockIdx.y;
  const int windows = p.nwh * p.nww;
  const int img = blockIdx.z / windows, win = blockIdx.z - img * windows;
  const int wy = win / p.nww, wx = win - wy * p.nww;
  const Window w{p.qkv, p.bias, static_cast<long long>(img) * p.hm * p.wm,
                 p.hm, p.wm, p.c, p.sw, wy * p.sh, wx * p.sw, p.sh * p.sw};
  const int q0 = blockIdx.x * kBM;

  // this thread's two query rows: their window coordinates, clamped into the
  // window (a row past the window is computed and not written)
  const int r0 = warp * 16 + (lane >> 2);
  int qh[2], qw[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = min(q0 + r0 + 8 * i, w.n - 1);
    qh[i] = t / p.sw;
    qw[i] = t - qh[i] * p.sw;
  }

  // -- the query tile and both tables, then G_h and G_w ---------------------
  load_tokens(qs, w, q0, 0, head, tid);
  load_table(ks, p.rel_h + head * p.rel_h_head, p.rows_h, p.pad_h, tid);
  load_table(vs, p.rel_w + head * p.rel_w_head, p.rows_w, p.pad_w, tid);
  cp_commit();
  cp_wait<0>();
  __syncthreads();

  uint32_t qf[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    ldsm_x4(qf[kk], qs + (warp * 16 + (lane & 15)) * kStride + kk * 16 +
                        (lane >> 4) * 8);
  __syncthreads();   // the query tile's place takes G next
  table_products(qf, ks, p.pad_h, p.sh, qh, g, gs, warp, lane);
  table_products(qf, vs, p.pad_w, p.sw, qw, g + p.sh, gs, warp, lane);
  __syncthreads();   // the tables' buffers take the first keys next

  const float* gh[2] = {g + r0 * gs, g + (r0 + 8) * gs};
  const float* gw[2] = {g + r0 * gs + p.sh, g + (r0 + 8) * gs + p.sh};

  float o[8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int n_tiles = (w.n + kBN - 1) / kBN;

  load_tokens(ks, w, 0, 1, head, tid);
  load_tokens(vs, w, 0, 2, head, tid);
  cp_commit();

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile & 1;
    if (tile + 1 < n_tiles) {
      const int next = (tile + 1) * kBN;
      load_tokens(ks + (stage ^ 1) * kTileElems, w, next, 1, head, tid);
      load_tokens(vs + (stage ^ 1) * kTileElems, w, next, 2, head, tid);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* kt = ks + stage * kTileElems;
    const __nv_bfloat16* vt = vs + stage * kTileElems;

    // s = q . k^T: 16 queries x 64 keys a warp
    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t b[4];
        ldsm_x4(b, kt + (np * 16 + (lane & 7) + (lane >> 4) * 8) * kStride +
                       kk * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * np], qf[kk], b[0], b[1]);
        mma16816(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // the logits in base 2, with the bias; keys past the window at -inf.
    // (kh, kw) of the thread's first key of the tile, then stepped.
    const int key0 = tile * kBN + 2 * (lane & 3);
    int kh = key0 / p.sw, kw = key0 - kh * p.sw;
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        int h = kh, x = kw + e;
        if (x >= p.sw) { x -= p.sw; ++h; }
        const bool ok = key0 + j * 8 + e < w.n;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float v = -INFINITY;
          if (ok)
            v = s[j][2 * i + e] * p.scale_log2 + gh[i][h] + gw[i][x];
          s[j][2 * i + e] = v;
          mx[i] = fmaxf(mx[i], v);
        }
      }
      kw += 8;
      while (kw >= p.sw) { kw -= p.sw; ++kh; }
    }

    // online softmax: the row maxima over the quad, rescale, exponentiate
    float corr[2], mu[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      mu[i] = mn == -INFINITY ? 0.f : mn;
      corr[i] = fast_exp2(m[i] - mu[i]);
      m[i] = mn;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float pv = fast_exp2(s[j][e] - mu[i]);
        s[j][e] = pv;
        l[i] += pv;
        o[j][e] *= corr[i];
      }
    }

    // o += p . v: p from the logits' registers, v by transposed ldmatrix
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                       pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                       pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                       pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < 4; ++dp) {
        uint32_t b[4];
        ldsm_x4_t(b, vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                              kStride +
                         dp * 16 + (lane >> 4) * 8);
        mma16816(o[2 * dp], a, b[0], b[1]);
        mma16816(o[2 * dp + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();   // both stages free for the next loads
  }

  // -- normalise and write the queries that lie on the map ------------------
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    const int t = q0 + r0 + 8 * i;
    int y, x;
    if (t >= w.n || !w.pixel(t, y, x)) continue;
    const float inv = 1.f / l[i];
    __nv_bfloat16* dst = p.out + (w.img_base + static_cast<long long>(y) *
                                                   p.wm + x) * p.c +
                         head * kD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + j * 8) =
          pack_bf16(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
  }
}

}  // namespace

extern "C" {

// qkv (B, H, W, 3 * heads * 64) bf16 contiguous; bias (3 * heads * 64);
// rel_h (2Sh - 1, 64) and rel_w (2Sw - 1, 64) bf16, or one per head with
// the given element strides between heads (0: shared); out (B, H, W,
// heads * 64).  Windows of Sh x Sw tile the map padded up to their multiple
// (Sh = H and Sw = W: global attention).  Returns a cudaError_t.
int td_relpos_attention(const void* qkv, const void* bias, const void* rel_h,
                        const void* rel_w, long long rel_h_head,
                        long long rel_w_head, void* out, int batch, int h,
                        int w, int heads, int sh, int sw, float scale,
                        void* stream) {
  if (batch == 0 || h == 0 || w == 0) return 0;
  if (batch < 0 || h < 0 || w < 0 || heads < 1 || sh < 1 || sw < 1 ||
      sh > kMaxSide || sw > kMaxSide)
    return static_cast<int>(cudaErrorInvalidValue);
  // the shared-memory limit above 48 KB, once per device
  static bool configured[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {
    err = cudaFuncSetAttribute(relpos_attention_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return static_cast<int>(err);
    configured[device] = true;
  }
  Params p;
  p.qkv = static_cast<const __nv_bfloat16*>(qkv);
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.rel_h = static_cast<const __nv_bfloat16*>(rel_h);
  p.rel_w = static_cast<const __nv_bfloat16*>(rel_w);
  p.rel_h_head = rel_h_head;
  p.rel_w_head = rel_w_head;
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hm = h;
  p.wm = w;
  p.c = heads * kD;
  p.sh = sh;
  p.sw = sw;
  p.nwh = (h + sh - 1) / sh;
  p.nww = (w + sw - 1) / sw;
  p.rows_h = 2 * sh - 1;
  p.rows_w = 2 * sw - 1;
  p.pad_h = (p.rows_h + 15) / 16 * 16;
  p.pad_w = (p.rows_w + 15) / 16 * 16;
  p.scale_log2 = scale * kLog2e;
  const long long blocks_z = static_cast<long long>(batch) * p.nwh * p.nww;
  if (blocks_z > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = kKVBytes + g_bytes(sh, sw);
  const dim3 grid((sh * sw + kBM - 1) / kBM, heads,
                  static_cast<unsigned>(blocks_z));
  relpos_attention_kernel<<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
