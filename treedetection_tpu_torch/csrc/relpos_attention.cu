// Fused attention with decomposed relative positions, on Hopper (sm_90a):
// the attention of a ViTDet block, windowed or global, in one launch; and,
// in the pooled form at the end of this file, that of an MViTv2 block.
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
// the softmax, flash-attention style.
//
// What bounds it.  A global block is bound by the tensor cores: per (image,
// head) 2 * 4096^2 * 64 multiply-adds against about 2 MB of q, k, v and
// output, some 2000 operations a byte.  At head size 64 the softmax is as
// costly as the products, though: an exponential and a handful of fp32
// instructions a logit against 256 tensor-core operations, so the design
// runs it beside the products.  A windowed block is bound by memory: 196
// keys a query, about 110 operations a byte, below the card's ~295, so
// every byte is read once.
//
// One algorithm, two tilings, chosen by the window's sides (the shape the
// launch sees):
//
// * Whole window (Sh, Sw <= 16; ViTDet's 14 x 14 windows): one block, one
//   warpgroup, per (image, window, head) holds all of the window's queries
//   and keys.  TMA brings q, k, v and both tables once, so K, V and the
//   tables are read once a window and head.  The block walks its queries in
//   64-row tiles: G = q . R^T, s = q . k^T over all the keys (one wgmma of
//   224 columns: 14 rows of 16), the bias and an exact softmax (one key
//   tile), o = p . v with p from registers.  Two blocks an SM overlap one's
//   loads with the other's products.  Bound here: the chain of products,
//   softmax and waits of each query tile, at two blocks an SM.
// * Streaming (larger windows and the global blocks): 128 queries a block in
//   two consumer warpgroups of 64 rows; a producer warpgroup, its registers
//   handed to the consumers by setmaxnreg, whose one thread keeps a ring of
//   three 128-key tiles in flight by TMA, completion on mbarriers, stages
//   released by the consumers.  fp32 online softmax in base 2.  A warpgroup
//   issues tile k's q . k^T with tile k - 1's p . v and runs tile k's softmax
//   while p . v finishes (p of the previous tile waits in registers as
//   bf16); the two warpgroups take turns at the tensor cores (named
//   barriers), so that one's softmax runs under the other's products.
//   Bound here: the softmax's instructions.
//
// Tiles of whole rows: why the bias lives in registers.  Both tilings read a
// window in TMA boxes of whole rows of kW tokens, its Sw padded up: kW 16 for
// whole windows, 64 streaming (a 128-key tile is two map rows of the global
// 64 x 64 blocks).  The key of accumulator column c then lies in tile row
// c / kW and column c % kW, the same for a given thread and register in
// every tile.  So G_w[q][kw] of the thread's columns is loaded into
// registers once per query tile, and G_h[q][kh] is one register a tile row:
// a logit costs one FMA and, with G_h folded into the row maximum and the
// exponent's offset, no more adds than the softmax needs; no shared-memory
// gather, no division, no branch.  A padded column (kw >= Sw) or row
// (kh >= Sh) reads -inf from those registers and is masked at no cost.
// (Gathered from shared memory with a division-and-wrap walk, the bias cost
// more than half of a windowed launch.)  A width that fills no row of kW
// tokens is padded up and masked: correct, and slower by the padding.
//
// Pad keys.  q, k and v are read straight from the projection's (B, H, W,
// 3C) output over the unpadded map (C = heads * 64, channel order (3, heads,
// 64) as detectron2's), and the output is written to (B, H, W, C), the
// projection's input: no window partition, pad, permute or unpartition copy.
// TMA zero-fills what lies off the map.  A window's key off the map is one
// of detectron2's zero pads after the norm: its k and v are the qkv bias,
// which the kernel writes over those rows after the tile lands (edge
// windows only: 9 of the 25 a map at 64 / 14).  Those keys are not masked,
// as in detectron2; keys past the window (padding of the tile) are.
// Queries off the map or past the window are not written.
//
// Numerics: bf16 q, k, v and tables, fp32 accumulators; the bias products
// in fp32 (times log2 e); the softmax in fp32, base 2, ex2.approx; p rounded
// to bf16 once before p . v; the output rounded to bf16 once.  The TMA
// descriptors are encoded on the host from the pointers and shapes; nothing
// is read back.
//
// Grid: whole windows (heads, images * windows) of 128 threads; streaming
// (query tiles of a window, heads, images * windows) of 384.  Head size 64;
// window sides up to 64 (tables of at most 127 rows), the tables either
// shared by the heads or one per head.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kD = 64;              // head size: a token's q, k or v row
constexpr int kRow = kD * 2;        // bytes of such a row (one swizzle row)
constexpr int kWG = 128;            // threads of a warpgroup
constexpr int kMaxSide = 64;        // largest window side
constexpr int kStreamKeys = 128;    // tokens of a streaming tile
constexpr int kStages = 3;          // key and value tiles in flight
constexpr int kWholeTable = 32;     // table rows read by the whole-window path
constexpr int kStreamTable = 128;   // ... and by the streaming path
constexpr int kWholeWidth = 16;     // tokens of a tile row: Sw padded up
constexpr int kStreamWidth = 64;
// floats of a query's row of G in shared memory (odd: no bank conflicts)
constexpr int kWholeGs = 2 * kWholeWidth + 1;   // G_h, then G_w
constexpr int kStreamGs = kStreamWidth + 1;     // G_w, then G_h in its place
constexpr int kStreamThreads = 3 * kWG;   // two consumers, one producer
constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  CUtensorMap qkv;     // (B, H, W, 3 * heads, 64): boxes of rows of kW tokens
  CUtensorMap rel_h;   // (heads | 1, 2Sh - 1, 64): a box of table rows
  CUtensorMap rel_w;   // (heads | 1, 2Sw - 1, 64)
  const __nv_bfloat16* bias;   // (3C): the k and v of a pad token
  __nv_bfloat16* out;          // (B, H, W, C)
  int hm, wm, c, heads, sh, sw, nwh, nww;
  int rel_h_per_head, rel_w_per_head;
  float scale_log2;    // scale * log2 e
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// -- mbarriers, TMA and fences ----------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}
// arrive once and expect `bytes` of TMA transfers in this phase
__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// The box's rows of kW tokens: their q, k or v rows of one head from map
// pixel (x, y) of image img on; part_head = part * heads + head.  Off the
// map: zeros.
__device__ __forceinline__ void tma_tokens(void* dst, const CUtensorMap* map,
                                           uint64_t* bar, int part_head,
                                           int x, int y, int img) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0),
      "r"(part_head), "r"(x), "r"(y), "r"(img), "r"(smem_addr(bar))
      : "memory");
}
// a head's table rows (past the table: zeros)
__device__ __forceinline__ void tma_table(void* dst, const CUtensorMap* map,
                                          uint64_t* bar, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(0),
      "r"(0), "r"(head), "r"(smem_addr(bar))
      : "memory");
}

// generic-proxy writes to shared memory, visible to wgmma and TMA after
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
// named barriers: `threads` in all, some waiting (sync), some not (arrive)
__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// -- wgmma -------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// until at most `pending` committed groups are in flight
template <int pending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(pending)
               : "memory");
}
// keeps the compiler from touching the accumulators across the wait
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Descriptors of a tile of 128-byte rows as TMA's 128-byte swizzle leaves
// it (1024-byte aligned; 8-row groups 1024 bytes apart).  K-major: the rows
// are the operand's M or N, the 64 values of a row its K (q, k, tables);
// a k16 slice lies 32 bytes on.  MN-major: the rows are K (v: keys), a row's
// 64 values N; a k16 slice lies 16 rows on.
__device__ __forceinline__ uint64_t desc_k_major(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (1ull << 16) | (64ull << 32) | (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_mn_major(const void* p) {
  return static_cast<uint64_t>((smem_addr(p) & 0x3FFFF) >> 4) |
         (64ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (+)= a (64 x 16 from the descriptor a) . b (16 x N from the descriptor
// b), both K-major; accumulate 0 overwrites d.  Generated operand lists.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t a,
                                         uint64_t b, int accumulate);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15},\n"
      " %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63},\n"
      " %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<224>(float (&d)[112], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %114, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n224k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111},\n"
      " %112, %113, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111])
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma_ss<256>(float (&d)[128], uint64_t a,
                                             uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, "
      "%67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, "
      "%93, %94, %95, %96, %97, %98, %99, %100, %101, %102, %103, %104, "
      "%105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, "
      "%116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, "
      "%127},\n"
      " %128, %129, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]),
        "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]),
        "+f"(d[95]), "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]), "+f"(d[104]),
        "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]),
        "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]),
        "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(accumulate));
}

// d += a (64 x 16 bf16 from registers) . b (16 x 64, value rows: the
// descriptor of an MN-major tile, so imm-trans-b 1)
__device__ __forceinline__ void wgmma_rs64(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31},\n"
      " {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// -- the shared steps of both tilings ----------------------------------------

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// s = q . k^T for the warpgroup's 64 queries (qs) and N keys (ks), fp32,
// issued as one group.  Accumulator layout: s[4j + 2i + e] is query row
// r + 8i (r = 16 * warp + lane / 4) against key 8j + 2 (lane % 4) + e.
template <int N>
__device__ __forceinline__ void qk_issue(float (&s)[N / 2],
                                         const __nv_bfloat16* qs,
                                         const __nv_bfloat16* ks) {
  const uint64_t a = desc_k_major(qs), b = desc_k_major(ks);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kD / 16; ++kk)
    wgmma_ss<N>(s, a + 2 * kk, b + 2 * kk, kk);
  wgmma_commit();
}
template <int N>
__device__ __forceinline__ void qk(float (&s)[N / 2],
                                   const __nv_bfloat16* qs,
                                   const __nv_bfloat16* ks) {
  qk_issue<N>(s, qs, ks);
  wgmma_wait<0>();
  fence_regs(s);
}

// log2(e) * q . R[r] for the warpgroup's 64 queries and each table row r,
// scattered to g[q][side - 1 + coord(q) - r], the key row or column it
// biases, where that lies in the window.  Each thread writes only its own
// two query rows, so the warp alone reads them back.
template <int NT>
__device__ __forceinline__ void table_products(const __nv_bfloat16* qs,
                                               const __nv_bfloat16* table,
                                               int side, const int (&coord)[2],
                                               float* g, int gs, int row,
                                               int lane) {
  float acc[NT / 2];
  qk<NT>(acc, qs, table);
#pragma unroll
  for (int j = 0; j < NT / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = e >> 1;
      const int k = side - 1 + coord[i] - (8 * j + 2 * (lane & 3) + (e & 1));
      if (k >= 0 && k < side)
        g[(row + 8 * i) * gs + k] = acc[4 * j + e] * kLog2e;
    }
  }
}

// The bias in registers.  A tile's keys are whole rows of kW tokens (the
// window's Sw padded up by the TMA box), so the key of accumulator column
// c = 8j + 2 (lane % 4) + e lies in tile row j / (kW / 8) and column
// 8 (j % (kW / 8)) + 2 (lane % 4) + e in every tile: G_w of those columns
// is loaded once, G_h once a tile row; -inf entries mask the columns past
// Sw and the rows past Sh.
template <int kW>
__device__ __forceinline__ void load_gw(float (&gw)[2][kW / 8][2],
                                        const float* g0, const float* g1,
                                        int sw, int lane) {
#pragma unroll
  for (int j = 0; j < kW / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int x = 8 * j + 2 * (lane & 3) + e;
      gw[0][j][e] = x < sw ? g0[x] : -INFINITY;
      gw[1][j][e] = x < sw ? g1[x] : -INFINITY;
    }
}
template <int R>
__device__ __forceinline__ void load_gh(float (&gh)[2][R], const float* g0,
                                        const float* g1, int kh0, int sh) {
#pragma unroll
  for (int h = 0; h < R; ++h) {
    gh[0][h] = kh0 + h < sh ? g0[kh0 + h] : -INFINITY;
    gh[1][h] = kh0 + h < sh ? g1[kh0 + h] : -INFINITY;
  }
}

// The online softmax over one key tile with the bias: the logit in base 2
// is v + G_h with v = scale * q.k + G_w, and G_h one value a tile row, so
// the row maximum is taken over v a tile row and G_h added once, and
// exp2(v + G_h - max) is exp2(v - c) with c = max - G_h one value a tile
// row.  Updates the rows' running maxima m and sums l and gives corr, the
// factor that takes the output so far to the new maxima; p left in s.
// Partial maxima and sums keep the dependent chains short.
template <int N, int kW>
__device__ __forceinline__ void softmax_step(float (&s)[N / 2], float scale,
                                             const float (&gw)[2][kW / 8][2],
                                             const float (&gh)[2][N / kW],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2]) {
  constexpr int kJ = kW / 8;   // accumulator column groups a tile row
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int r = 0; r < N / kW; ++r) {
    float part[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& v = s[4 * (r * kJ + jj) + e];
        v = fmaf(v, scale, gw[e >> 1][jj][e & 1]);
        part[e >> 1][e & 1] = fmaxf(part[e >> 1][e & 1], v);
      }
#pragma unroll
    for (int i = 0; i < 2; ++i)
      mx[i] = fmaxf(mx[i], fmaxf(part[i][0], part[i][1]) + gh[i][r]);
  }
  float mu[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    mu[i] = mx[i] == -INFINITY ? 0.f : mx[i];
    corr[i] = fast_exp2(m[i] - mu[i]);
    m[i] = mx[i];
    l[i] *= corr[i];
  }
  float sum[2][4] = {};
#pragma unroll
  for (int r = 0; r < N / kW; ++r) {
    const float c[2] = {mu[0] - gh[0][r], mu[1] - gh[1][r]};
#pragma unroll
    for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float& v = s[4 * (r * kJ + jj) + e];
        v = fast_exp2(v - c[e >> 1]);
        sum[e >> 1][(jj & 1) * 2 + (e & 1)] += v;
      }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i)
    l[i] += (sum[i][0] + sum[i][1]) + (sum[i][2] + sum[i][3]);
}

// o taken to the new row maxima
__device__ __forceinline__ void rescale(float (&o)[32],
                                        const float (&corr)[2]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[4 * j + e] *= corr[e >> 1];
}

// p rounded to bf16 once, as the A fragments of p . v: k16 slice kk of the
// keys in pk[4kk .. 4kk + 3]
template <int N>
__device__ __forceinline__ void pack_p(uint32_t (&pk)[N / 4],
                                       const float (&s)[N / 2]) {
#pragma unroll
  for (int i = 0; i < N / 4; ++i)
    pk[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
}

// o += p . v over N keys, v the tile's value rows; issued as one group
template <int N>
__device__ __forceinline__ void pv_issue(float (&o)[32],
                                         const uint32_t (&pk)[N / 4],
                                         const __nv_bfloat16* vs) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    const uint32_t a[4] = {pk[4 * kk], pk[4 * kk + 1], pk[4 * kk + 2],
                           pk[4 * kk + 3]};
    wgmma_rs64(o, a, desc_mn_major(vs + kk * 16 * kD));
  }
  wgmma_commit();
}

// Rows [0, rows * kW) of a key or value tile hold window rows from map row
// y on, kW tokens each, as TMA left them: zeros where a token lies off the
// map.  Such a token of the window (column below Sw) is one of detectron2's
// zero pads after the norm; its k or v is the qkv bias, written here into
// the swizzled rows.  Not masked.
template <int kW>
__device__ __forceinline__ void fill_pads(__nv_bfloat16* tile,
                                          const Params& p, int part,
                                          int head, int x0, int y, int rows,
                                          int tid, int threads) {
  const uint4* src =
      reinterpret_cast<const uint4*>(p.bias + part * p.c + head * kD);
  unsigned char* dst = reinterpret_cast<unsigned char*>(tile);
  for (int i = tid; i < rows * kW * 8; i += threads) {
    const int r = i >> 3, ch = i & 7;
    const int ty = r / kW, tx = r % kW;
    if (tx >= p.sw || (y + ty < p.hm && x0 + tx < p.wm)) continue;
    *reinterpret_cast<uint4*>(dst + r * kRow + ((ch ^ (r & 7)) << 4)) =
        __ldg(src + ch);
  }
}

// rows [from, to) of a tile: zeros (key and value rows no TMA box covers,
// so that their masked logits and p . v stay finite)
__device__ __forceinline__ void zero_rows(__nv_bfloat16* tile, int from,
                                          int to, int tid, int threads) {
  uint4* dst = reinterpret_cast<uint4*>(tile + from * kD);
  for (int i = tid; i < (to - from) * 8; i += threads)
    dst[i] = make_uint4(0, 0, 0, 0);
}

// o / l in bf16 for the thread's two query rows, whose window tokens are
// (ty, tx): written where ok and the token lies on the map.
__device__ __forceinline__ void store_rows(const float (&o)[32],
                                           float (&l)[2], const Params& p,
                                           const int (&ty)[2],
                                           const int (&tx)[2],
                                           const bool (&ok)[2], int img,
                                           int head, int y0, int x0,
                                           int lane) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int y = y0 + ty[i], x = x0 + tx[i];
    if (!ok[i] || y >= p.hm || x >= p.wm) continue;
    const float inv = 1.f / l[i];
    __nv_bfloat16* dst =
        p.out + ((static_cast<long long>(img) * p.hm + y) * p.wm + x) * p.c +
        head * kD + 2 * (lane & 3);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
  }
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(p) + 1023) & ~static_cast<uintptr_t>(1023));
}

// -- whole-window tiling: one block per (image, window, head) -----------------

template <int N>
__global__ void __launch_bounds__(kWG, 2)
    relpos_attention_kernel_window(const __grid_constant__ Params p) {
  constexpr int kW = kWholeWidth;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  const int keys = p.sh * kW;   // the box: Sh rows of kW tokens
  const int q_bytes = (keys * kRow + 1023) / 1024 * 1024;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base);
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(base + q_bytes);
  __nv_bfloat16* vs = ks + N * kD;
  __nv_bfloat16* rh = vs + N * kD;
  __nv_bfloat16* rw = rh + kWholeTable * kD;
  float* g = reinterpret_cast<float*>(rw + kWholeTable * kD);
  uint64_t* bar = reinterpret_cast<uint64_t*>(g + 64 * kWholeGs);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int head = blockIdx.x;
  const int windows = p.nwh * p.nww;
  const int img = blockIdx.y / windows, win = blockIdx.y - img * windows;
  const int wy = win / p.nww, wx = win - wy * p.nww;
  const int y0 = wy * p.sh, x0 = wx * p.sw;
  const bool pads = y0 + p.sh > p.hm || x0 + p.sw > p.wm;

  if (tid == 0) {
    for (int i = 0; i < 3; ++i) mbar_init(&bar[i], 1);
    fence_barrier_init();
  }
  // key and value rows past the box: zeros, so that every logit and p . v
  // stay finite (those keys are masked)
  zero_rows(ks, keys, N, tid, kWG);
  zero_rows(vs, keys, N, tid, kWG);
  fence_async_smem();
  __syncthreads();
  if (tid == 0) {
    mbar_expect(&bar[0], keys * kRow + 2 * kWholeTable * kRow);
    tma_tokens(qs, &p.qkv, &bar[0], head, x0, y0, img);
    tma_table(rh, &p.rel_h, &bar[0], p.rel_h_per_head ? head : 0);
    tma_table(rw, &p.rel_w, &bar[0], p.rel_w_per_head ? head : 0);
    mbar_expect(&bar[1], keys * kRow);
    tma_tokens(ks, &p.qkv, &bar[1], p.heads + head, x0, y0, img);
    mbar_expect(&bar[2], keys * kRow);
    tma_tokens(vs, &p.qkv, &bar[2], 2 * p.heads + head, x0, y0, img);
  }

  // g: this query tile's G_h at [0, kW), G_w at [kW, 2 kW)
  const int row = warp * 16 + (lane >> 2);
  const float* g0 = g + row * kWholeGs;
  const float* g1 = g0 + 8 * kWholeGs;
  float s[N / 2], gw[2][kW / 8][2], gh[2][N / kW];
  mbar_wait(&bar[0], 0);
  for (int q0 = 0; q0 < keys; q0 += 64) {
    const __nv_bfloat16* qt = qs + q0 * kD;
    int ty[2], tx[2];
    bool ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int q = q0 + row + 8 * i;
      ty[i] = q / kW;
      tx[i] = q % kW;
      ok[i] = ty[i] < p.sh && tx[i] < p.sw;
    }
    __syncwarp();   // the previous query tile's G reads are done
    table_products<kWholeTable>(qt, rh, p.sh, ty, g, kWholeGs, row, lane);
    table_products<kWholeTable>(qt, rw, p.sw, tx, g + kW, kWholeGs, row,
                                lane);
    __syncwarp();
    load_gw<kW>(gw, g0 + kW, g1 + kW, p.sw, lane);
    load_gh<N / kW>(gh, g0, g1, 0, p.sh);
    if (q0 == 0) {
      mbar_wait(&bar[1], 0);
      if (pads) {
        fill_pads<kW>(ks, p, 1, head, x0, y0, p.sh, tid, kWG);
        fence_async_smem();
        __syncthreads();
      }
    }
    qk<N>(s, qt, ks);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, corr[2];
    // one tile: exact, nothing to rescale
    softmax_step<N, kW>(s, p.scale_log2, gw, gh, m, l, corr);
    uint32_t pk[N / 4];
    pack_p<N>(pk, s);
    if (q0 == 0) {
      mbar_wait(&bar[2], 0);
      if (pads) {
        fill_pads<kW>(vs, p, 2, head, x0, y0, p.sh, tid, kWG);
        fence_async_smem();
        __syncthreads();
      }
    }
    float o[32] = {};
    pv_issue<N>(o, pk, vs);
    wgmma_wait<0>();
    fence_regs(o);
    store_rows(o, l, p, ty, tx, ok, img, head, y0, x0, lane);
  }
}

// -- streaming tiling: 128 queries a block, key tiles through a TMA ring ------

// Named barriers of the streaming block: 1 and 2 each consumer warpgroup's
// own, 3 and 4 the turns of warpgroup 0 and 1 at the tensor cores.
constexpr int kTurnBar = 3;

__global__ void __launch_bounds__(kStreamThreads, 1)
    relpos_attention_kernel_stream(const __grid_constant__ Params p) {
  constexpr int kW = kStreamWidth;
  constexpr int kRows = kStreamKeys / kW;   // window rows of a tile
  constexpr int kTile = kStreamKeys * kD;   // elements of a 128-row tile
  extern __shared__ unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(align_1024(smem_raw));
  __nv_bfloat16* ks = qs + kTile;                // kStages stages
  __nv_bfloat16* vs = ks + kStages * kTile;      // kStages stages
  __nv_bfloat16* rh = vs + kStages * kTile;
  __nv_bfloat16* rw = rh + kTile;
  float* g = reinterpret_cast<float*>(rw + kTile);   // 64 rows a warpgroup
  uint64_t* bar = reinterpret_cast<uint64_t*>(g + 2 * 64 * kStreamGs);
  uint64_t* full = bar + 1;
  uint64_t* empty = full + kStages;

  const int tid = threadIdx.x, warp = tid >> 5;
  const int head = blockIdx.y;
  const int windows = p.nwh * p.nww;
  const int img = blockIdx.z / windows, win = blockIdx.z - img * windows;
  const int wy = win / p.nww, wx = win - wy * p.nww;
  const int y0 = wy * p.sh, x0 = wx * p.sw;
  const int n_tiles = (p.sh + kRows - 1) / kRows;
  const int qr0 = blockIdx.x * kRows;   // window row of the block's queries
  const bool pads = y0 + p.sh > p.hm || x0 + p.sw > p.wm;

  if (tid == 0) {
    mbar_init(bar, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 2);   // one arrival a consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (warp >= 8) {   // the producer warpgroup: one thread keeps the ring full
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (tid == 2 * kWG) {
      mbar_expect(bar, kStreamKeys * kRow + 2 * kStreamTable * kRow);
      tma_tokens(qs, &p.qkv, bar, head, x0, y0 + qr0, img);
      tma_table(rh, &p.rel_h, bar, p.rel_h_per_head ? head : 0);
      tma_table(rw, &p.rel_w, bar, p.rel_w_per_head ? head : 0);
      for (int kt = 0; kt < n_tiles; ++kt) {
        const int st = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[st], (kt / kStages - 1) & 1);
        mbar_expect(&full[st], 2 * kStreamKeys * kRow);
        tma_tokens(ks + st * kTile, &p.qkv, &full[st], p.heads + head, x0,
                   y0 + kt * kRows, img);
        tma_tokens(vs + st * kTile, &p.qkv, &full[st], 2 * p.heads + head,
                   x0, y0 + kt * kRows, img);
      }
    }
    return;
  }

  // a consumer warpgroup: 64 of the block's queries
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
  const int wg = warp >> 2, lane = tid & 31;
  const int row = (warp & 3) * 16 + (lane >> 2);
  float* g_wg = g + wg * 64 * kStreamGs;
  const float* g0 = g_wg + row * kStreamGs;
  const float* g1 = g0 + 8 * kStreamGs;
  const __nv_bfloat16* q_wg = qs + wg * 64 * kD;
  int ty[2], tx[2];
  bool ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int q = wg * 64 + row + 8 * i;
    ty[i] = qr0 + q / kW;
    tx[i] = q % kW;
    ok[i] = ty[i] < p.sh && tx[i] < p.sw;
  }

  // G_w into registers for the whole walk, then G_h in its place
  float gw[2][kW / 8][2], gh[2][kRows];
  mbar_wait(bar, 0);
  table_products<kStreamTable>(q_wg, rw, p.sw, tx, g_wg, kStreamGs, row,
                               lane);
  __syncwarp();
  load_gw<kW>(gw, g0, g1, p.sw, lane);
  __syncwarp();
  table_products<kStreamTable>(q_wg, rh, p.sh, ty, g_wg, kStreamGs, row,
                               lane);
  __syncwarp();

  // Tile kt's stage holds its keys and values; once it has landed (and its
  // pad rows are filled), wait for this warpgroup's turn at the tensor cores.
  auto arrive_tile = [&](int kt) {
    const int st = kt % kStages;
    mbar_wait(&full[st], (kt / kStages) & 1);
    if (pads) {   // each warpgroup fills the same values before its reads
      fill_pads<kW>(ks + st * kTile, p, 1, head, x0, y0 + kt * kRows, kRows,
                    tid & 127, kWG);
      fill_pads<kW>(vs + st * kTile, p, 2, head, x0, y0 + kt * kRows, kRows,
                    tid & 127, kWG);
      fence_async_smem();
      bar_sync(1 + wg, kWG);
    }
    bar_sync(kTurnBar + wg, 2 * kWG);
  };
  // The two warpgroups take turns: one issues its products while the other
  // runs its softmax.  Warpgroup 1 lets warpgroup 0 start.
  if (wg == 1) bar_arrive(kTurnBar, 2 * kWG);

  // Within a warpgroup tile kt's q . k^T runs beside tile kt - 1's p . v,
  // and its softmax while p . v finishes: p of the previous tile waits in
  // pk (bf16), and o takes the previous softmax's correction just before
  // its p . v is issued.
  float o[32] = {}, m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float corr[2], s[kStreamKeys / 2];
  uint32_t pk[kStreamKeys / 4];
  arrive_tile(0);
  qk_issue<kStreamKeys>(s, q_wg, ks);
  bar_arrive(kTurnBar + 1 - wg, 2 * kWG);
  wgmma_wait<0>();
  fence_regs(s);
  load_gh<kRows>(gh, g0, g1, 0, p.sh);
  softmax_step<kStreamKeys, kW>(s, p.scale_log2, gw, gh, m, l, corr);
  pack_p<kStreamKeys>(pk, s);
  for (int kt = 1; kt < n_tiles; ++kt) {
    const int st = kt % kStages, prev = (kt - 1) % kStages;
    arrive_tile(kt);
    qk_issue<kStreamKeys>(s, q_wg, ks + st * kTile);
    rescale(o, corr);
    pv_issue<kStreamKeys>(o, pk, vs + prev * kTile);
    bar_arrive(kTurnBar + 1 - wg, 2 * kWG);
    wgmma_wait<1>();   // q . k^T done
    fence_regs(s);
    load_gh<kRows>(gh, g0, g1, kt * kRows, p.sh);
    softmax_step<kStreamKeys, kW>(s, p.scale_log2, gw, gh, m, l, corr);
    wgmma_wait<0>();   // p . v done: the previous stage is free
    fence_regs(o);
    if ((tid & 127) == 0) mbar_arrive(&empty[prev]);
    pack_p<kStreamKeys>(pk, s);
  }
  bar_sync(kTurnBar + wg, 2 * kWG);
  rescale(o, corr);
  pv_issue<kStreamKeys>(o, pk, vs + (n_tiles - 1) % kStages * kTile);
  if (wg == 0) bar_arrive(kTurnBar + 1, 2 * kWG);   // its last turn
  wgmma_wait<0>();
  fence_regs(o);
  store_rows(o, l, p, ty, tx, ok, img, head, y0, x0, lane);
}

// -- host side ---------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the process has loaded
EncodeTiled encoder() {
  static const EncodeTiled fn = []() -> EncodeTiled {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib == nullptr) return nullptr;
    return reinterpret_cast<EncodeTiled>(
        dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// a bf16 tensor of `rank` dims (innermost first; strides in bytes of dims 1
// on), read in boxes of `box` with the 128-byte swizzle; zeros off the tensor
bool encode(CUtensorMap* map, const void* ptr, int rank,
            const cuuint64_t* dims, const cuuint64_t* strides,
            const cuuint32_t* box) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            static_cast<cuuint32_t>(rank), const_cast<void*>(ptr), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool encode_table(CUtensorMap* map, const void* ptr, int side,
                  long long head_stride, int heads, int box_rows) {
  const cuuint64_t rows = 2 * side - 1;
  const cuuint64_t dims[3] = {kD, rows,
                              head_stride ? static_cast<cuuint64_t>(heads) : 1};
  const cuuint64_t strides[2] = {
      kRow, head_stride ? static_cast<cuuint64_t>(head_stride) * 2
                        : rows * kRow};
  const cuuint32_t box[3] = {kD, static_cast<cuuint32_t>(box_rows), 1};
  return encode(map, ptr, 3, dims, strides, box);
}

// the keys a window's block holds: Sh rows of 16 tokens, rounded up
int window_keys(int sh) { return sh <= 14 ? 224 : 256; }

int window_smem(int sh, int keys) {
  return 1024 + (sh * kWholeWidth * kRow + 1023) / 1024 * 1024 +
         2 * keys * kRow + 2 * kWholeTable * kRow + 64 * kWholeGs * 4 + 3 * 8;
}
constexpr int kStreamSmem = 1024 + (3 + 2 * kStages) * kStreamKeys * kRow +
                            2 * 64 * kStreamGs * 4 + (1 + 2 * kStages) * 8;

// -- pooling attention (MViTv2): mma.sync, q and kv at their own strides -----
//
// The attention of an MViTv2 block (models/mvit.py): q, k and v each pooled
// by its own depthwise conv (q at stride 1 or 2, k and v at 1, 2 or 4) and
// normed, so that the query and key maps differ in size; windows of their
// own sides on each map (56 queries against 14 keys a side in MViTv2-T's
// first block) or the whole maps; the decomposed bias with detectron2's
// index scaling where the sides differ; the pooled q added to the output
// (residual pooling).  Kernel A's tilings take one map and head size 64.
//
// What bounds it.  The blocks whose windows hold 196 keys (blocks 0 and
// 4-8 of MViTv2-T) do about 100-185 operations a byte of q, k, v and
// output, below the card's ~295: memory.  The 784-key windows and the
// global blocks (up to 16384 queries against 1024 keys) do 390-960: the
// tensor cores.  At head size 96 the softmax and the bias reads cost about
// as many instructions a logit as the products, as in A.
//
// The design.  A block of 128 queries of one window and head, 16 a warp
// (warps whose queries all lie past the window only load); q, k and v read
// in place, a row of 96 channels as twelve 16-byte copies (cp.async, zeros
// off the map or past the window: detectron2's zero pads after the norm);
// q.k and p.v on mma.sync (m16n8k16, bf16, fp32 accumulators); fp32 online
// softmax in base 2; the residual q added to the output once, in fp32.
// Two blocks an SM where the key rows are of 16 tokens (128 registers a
// thread); one where they are of 32, whose G_w registers would spill at two.
//
// The bias.  G, each query's products with the table rows it reads, is
// computed once a block before the keys: the rows the block's queries
// read, staged in shared memory, against the queries on the tensor cores
// (16 rows a step), each product scattered to the (query, key row or
// column) it biases; G_w[q][kw] and G_h[q][kh] stay in shared memory.  Key
// tiles are whole rows of kW tokens (the key window's width padded up to
// 16 or 32: R = 64 / kW rows a tile), so the key of accumulator column
// c lies in tile row c / kW and column c % kW in every tile: G_w of the
// thread's columns is loaded into registers once, G_h is one value a tile
// row; a column past the window's width or a row past its height reads
// -inf and is masked at no cost, as in A.
//
// Head size 96; key sides up to 32, query sides up to 128 (tables of at
// most 255 rows); on each axis the larger side a multiple of the smaller.

constexpr int kPD = 96;              // head size
constexpr int kPRow = kPD + 8;       // bf16 of a row in shared memory: 208
                                     // bytes, so ldmatrix's 8 rows miss
                                     // each other's banks
constexpr int kPWarps = 8;
constexpr int kPQ = 16 * kPWarps;    // queries of a block
constexpr int kPK = 64;              // keys of a tile
constexpr int kPThreads = 32 * kPWarps;
constexpr int kPChunks = kPD / 8;    // 16-byte copies of a row
constexpr int kPStageRows = 4 * kPK; // rows of the two K and V stages,
                                     // where the tables are staged first
constexpr int kPMaxKey = 32;         // largest key side
constexpr int kPMaxQuery = 128;      // largest query side

struct PooledParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* rel_h;   // (lh, 96)
  const __nv_bfloat16* rel_w;   // (lw, 96)
  __nv_bfloat16* out;           // (B, Hq, Wq, heads * 96)
  int heads, hq, wq, hk, wk;
  int sqh, sqw, skh, skw, nww;  // window sides (global: the maps)
  int lh, lw;                   // table rows
  // table row of (q coordinate c, key coordinate j): c * a - j * b
  // + (K - 1) * b on each axis (detectron2's index scaling)
  int ah, bh, aw, bw;
  int n_tiles;                  // key tiles: ceil(skh / (64 / kW))
  int gs;                       // floats of a query's row of G (odd)
  float scale_log2;             // scale * log2 e
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool real) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(real ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(pending) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) . b (16 x 8, col), bf16 in, fp32 accumulators.
// Fragments (g = lane / 4, t = lane % 4): c[0..1] row g, columns 2t, 2t + 1;
// c[2..3] row g + 8.
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragments of the warp's 16 query rows (q0) for channels kk * 16 on
__device__ __forceinline__ void q_frag(uint32_t (&a)[4],
                                       const __nv_bfloat16* qs, int q0,
                                       int kk, int lane) {
  ldsm_x4(a, qs + (q0 + ((lane >> 3) & 1) * 8 + (lane & 7)) * kPRow +
                 kk * 16 + (lane >> 4) * 8);
}
// B fragments of two n8 tiles (rows r0 .. r0 + 15 of a row-major tile of
// 96-channel rows: keys or table rows) for channels kk * 16 on:
// b[0], b[1] the first tile's, b[2], b[3] the second's
__device__ __forceinline__ void kt_frag(uint32_t (&b)[4],
                                        const __nv_bfloat16* rows, int r0,
                                        int kk, int lane) {
  ldsm_x4(b, rows + (r0 + (lane >> 4) * 8 + (lane & 7)) * kPRow + kk * 16 +
                 ((lane >> 3) & 1) * 8);
}

// Rows [0, 128) of the query tile: tokens first, first + 1, ... of the
// window of sqh x sqw at (y0, x0) of image-head n's q map; zeros off the
// map or past the window.
__device__ __forceinline__ void load_queries(__nv_bfloat16* dst,
                                             const PooledParams& p, int n,
                                             int y0, int x0, int first,
                                             int tid) {
  for (int i = tid; i < kPQ * kPChunks; i += kPThreads) {
    const int r = i / kPChunks, ch = i - r * kPChunks;
    const int t = first + r;
    const int ty = t / p.sqw, tx = t - ty * p.sqw;
    const int y = y0 + ty, x = x0 + tx;
    const bool real = ty < p.sqh && y < p.hq && x < p.wq;
    const __nv_bfloat16* s =
        real ? p.q + ((static_cast<long long>(n) * p.hq + y) * p.wq + x) *
                         kPD +
                   ch * 8
             : p.q;
    cp_async16(dst + r * kPRow + ch * 8, s, real);
  }
}

// Key tile kt of the window at (y0, x0) of image-head n's kv map: key rows
// kt * R .. of kW tokens each, from src (k or v); zeros off the map or
// past the window.
template <int kW>
__device__ __forceinline__ void load_keys(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          const PooledParams& p, int n,
                                          int y0, int x0, int kt, int tid) {
  constexpr int kR = kPK / kW;
  for (int i = tid; i < kPK * kPChunks; i += kPThreads) {
    const int r = i / kPChunks, ch = i - r * kPChunks;
    const int ky = kt * kR + r / kW, kx = r % kW;
    const int y = y0 + ky, x = x0 + kx;
    const bool real = ky < p.skh && kx < p.skw && y < p.hk && x < p.wk;
    const __nv_bfloat16* s =
        real ? src + ((static_cast<long long>(n) * p.hk + y) * p.wk + x) *
                         kPD +
                   ch * 8
             : src;
    cp_async16(dst + r * kPRow + ch * 8, s, real);
  }
}

// Table rows [lo8, lo8 + rows) into dst (zeros past the table's end).
__device__ __forceinline__ void load_table(__nv_bfloat16* dst,
                                           const __nv_bfloat16* table,
                                           int length, int lo8, int rows,
                                           int tid) {
  for (int i = tid; i < rows * kPChunks; i += kPThreads) {
    const int r = i / kPChunks, ch = i - r * kPChunks;
    const bool real = lo8 + r < length;
    cp_async16(dst + r * kPRow + ch * 8,
               real ? table + (lo8 + r) * kPD + ch * 8 : table, real);
  }
}

// The table rows that queries of coordinates [cmin, cmax] on an axis read
struct RowRange {
  int lo8, hi;   // first row rounded down to 8, last row
};
__device__ __forceinline__ RowRange row_range(int cmin, int cmax, int K,
                                              int a, int b) {
  return {(cmin * a) & ~7, cmax * a + (K - 1) * b};
}

// G of one axis for the warp's 16 queries: g[row][off + j] = log2 e *
// q . R[c * a - j * b + (K - 1) * b] for each key coordinate j < K, c the
// query's coordinate on the axis; rows holds the table from row lo8 on.
// The warp's rows [wlo8, whi] in steps of 16, each product scattered to
// the (query, key coordinate) it biases.
__device__ __forceinline__ void table_bias(const __nv_bfloat16* qs, int q0,
                                           const __nv_bfloat16* rows,
                                           int lo8, int K, int a, int b,
                                           const int (&c)[2], float* g,
                                           int gs, int off, int lane) {
  const int gq = lane >> 2, tq = lane & 3;
  const int cmin = __reduce_min_sync(0xffffffffu, min(c[0], c[1]));
  const int cmax = __reduce_max_sync(0xffffffffu, max(c[0], c[1]));
  const RowRange w = row_range(cmin, cmax, K, a, b);
  for (int r0 = w.lo8; r0 <= w.hi; r0 += 16) {
    float acc[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < kPD / 16; ++kk) {
      uint32_t qa[4], bf[4];
      q_frag(qa, qs, q0, kk, lane);
      // rows past the staged ones read shared memory beyond them: their
      // products are never scattered
      kt_frag(bf, rows, r0 - lo8, kk, lane);
      mma16816(acc[0], qa, bf[0], bf[1]);
      mma16816(acc[1], qa, bf[2], bf[3]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int num =
            c[i] * a + (K - 1) * b - (r0 + 8 * u + 2 * tq + (e & 1));
        if (num >= 0 && num % b == 0 && num / b < K)
          g[(gq + 8 * i) * gs + off + num / b] = acc[u][e] * kLog2e;
      }
  }
}

template <int kW>
__global__ void __launch_bounds__(kPThreads, kW == 16 ? 2 : 1)
    relpos_attention_kernel_pooled(const __grid_constant__ PooledParams p) {
  constexpr int kR = kPK / kW;     // key rows of a tile
  constexpr int kJ = kW / 8;       // accumulator column groups a key row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + kPQ * kPRow;    // two stages, then
  __nv_bfloat16* vs = ks + 2 * kPK * kPRow;
  __nv_bfloat16* ts = ks;                  // the tables before them
  float* g_all = reinterpret_cast<float*>(vs + 2 * kPK * kPRow);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gq = lane >> 2, tq = lane & 3;
  const int n = blockIdx.z, img = n / p.heads, head = n - img * p.heads;
  const int wy = blockIdx.y / p.nww, wx = blockIdx.y - wy * p.nww;
  const int qy0 = wy * p.sqh, qx0 = wx * p.sqw;
  const int ky0 = wy * p.skh, kx0 = wx * p.skw;
  const int first = blockIdx.x * kPQ;
  const int nq = p.sqh * p.sqw;
  const int q0 = warp * 16;
  const bool active = first + q0 < nq;   // the warp has a query to answer
  float* g = g_all + q0 * p.gs;

  // the thread's two query rows: window coordinates (clamped into the
  // window for the rows past it, which are not written)
  int cy[2], cx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int t = min(first + q0 + gq + 8 * i, nq - 1);
    cy[i] = t / p.sqw;
    cx[i] = t - cy[i] * p.sqw;
  }
  // G's masked entries: columns past the width, rows past the height
  for (int i = lane; i < 16 * (kW - p.skw); i += 32) {
    const int r = i / (kW - p.skw);
    g[r * p.gs + p.skw + i - r * (kW - p.skw)] = -INFINITY;
  }
  const int h_pad = p.n_tiles * kR - p.skh;
  for (int i = lane; i < 16 * h_pad; i += 32) {
    const int r = i / h_pad;
    g[r * p.gs + kW + p.skh + i - r * h_pad] = -INFINITY;
  }

  // the block's table rows: w from the first query's row to the last's
  // (every column when the block spans a window row), h for its rows
  const int last = min(first + kPQ, nq) - 1;
  const int cy0 = first / p.sqw, cy1 = last / p.sqw;
  const bool full_rows = cy1 > cy0;
  const RowRange rw = row_range(full_rows ? 0 : first - cy0 * p.sqw,
                                full_rows ? p.sqw - 1 : last - cy0 * p.sqw,
                                p.skw, p.aw, p.bw);
  const RowRange rh = row_range(cy0, cy1, p.skh, p.ah, p.bh);
  const int rows_w = rw.hi - rw.lo8 + 1, rows_h = rh.hi - rh.lo8 + 1;
  const bool together = rows_w + rows_h <= kPStageRows;
  load_queries(qs, p, n, qy0, qx0, first, tid);
  load_table(ts, p.rel_w, p.lw, rw.lo8, rows_w, tid);
  if (together)
    load_table(ts + rows_w * kPRow, p.rel_h, p.lh, rh.lo8, rows_h, tid);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (active)
    table_bias(qs, q0, ts, rw.lo8, p.skw, p.aw, p.bw, cx, g, p.gs, 0, lane);
  if (!together) {
    __syncthreads();   // the w rows are read
    load_table(ts, p.rel_h, p.lh, rh.lo8, rows_h, tid);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
  }
  if (active)
    table_bias(qs, q0, together ? ts + rows_w * kPRow : ts, rh.lo8, p.skh,
               p.ah, p.bh, cy, g, p.gs, kW, lane);
  __syncthreads();   // the tables are read: the stages take the keys
  load_keys<kW>(ks, p.k, p, n, ky0, kx0, 0, tid);
  load_keys<kW>(vs, p.v, p, n, ky0, kx0, 0, tid);
  cp_async_commit();
  if (p.n_tiles > 1) {
    load_keys<kW>(ks + kPK * kPRow, p.k, p, n, ky0, kx0, 1, tid);
    load_keys<kW>(vs + kPK * kPRow, p.v, p, n, ky0, kx0, 1, tid);
  }
  cp_async_commit();

  // G_w of the thread's columns (c % kW = 8 jj + 2 tq + e), for the walk
  const float* g0 = g + gq * p.gs;
  const float* g1 = g0 + 8 * p.gs;
  float gw[2][kJ][2];
#pragma unroll
  for (int jj = 0; jj < kJ; ++jj)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      gw[0][jj][e] = g0[8 * jj + 2 * tq + e];
      gw[1][jj][e] = g1[8 * jj + 2 * tq + e];
    }

  float o[kPD / 8][4];
#pragma unroll
  for (int j = 0; j < kPD / 8; ++j)
    o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int kt = 0; kt < p.n_tiles; ++kt) {
    if (kt == 0) {
      cp_async_wait<1>();   // tile 0 (tile 1 may be in flight)
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();   // tile kt landed; every warp is done with kt - 1
    if (kt > 0 && kt + 1 < p.n_tiles) {
      const int st = (kt + 1) & 1;
      load_keys<kW>(ks + st * kPK * kPRow, p.k, p, n, ky0, kx0, kt + 1, tid);
      load_keys<kW>(vs + st * kPK * kPRow, p.v, p, n, ky0, kx0, kt + 1, tid);
      cp_async_commit();
    }
    if (!active) continue;
    const __nv_bfloat16* kst = ks + (kt & 1) * kPK * kPRow;
    const __nv_bfloat16* vst = vs + (kt & 1) * kPK * kPRow;

    // s = q . k^T over the tile's 64 keys
    float s[kPK / 8][4];
#pragma unroll
    for (int j = 0; j < kPK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kPD / 16; ++kk) {
      uint32_t qa[4];
      q_frag(qa, qs, q0, kk, lane);
#pragma unroll
      for (int np = 0; np < kPK / 16; ++np) {
        uint32_t b[4];
        kt_frag(b, kst, np * 16, kk, lane);
        mma16816(s[2 * np], qa, b[0], b[1]);
        mma16816(s[2 * np + 1], qa, b[2], b[3]);
      }
    }

    // logits in base 2: scale q.k + G_w (registers) + G_h (a value a key
    // row); -inf past the window
    float gh[2][kR];
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      gh[0][r] = g0[kW + kt * kR + r];
      gh[1][r] = g1[kW + kt * kR + r];
    }
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < kPK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float& v = s[j][e];
        v = fmaf(v, p.scale_log2, gw[i][j % kJ][e & 1]) + gh[i][j / kJ];
        mx[i] = fmaxf(mx[i], v);
      }
    float corr[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      // a row whose keys are all masked so far keeps a finite offset
      const float mu = mx[i] == -INFINITY ? 0.f : mx[i];
      corr[i] = fast_exp2(m[i] - mu);
      m[i] = mx[i];
      mx[i] = mu;
      l[i] *= corr[i];
    }
#pragma unroll
    for (int j = 0; j < kPK / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = fast_exp2(s[j][e] - mx[e >> 1]);
        l[e >> 1] += s[j][e];
      }
#pragma unroll
    for (int j = 0; j < kPD / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[j][e] *= corr[e >> 1];

    // o += p . v, p rounded to bf16 once, 16 keys at a time
#pragma unroll
    for (int kk = 0; kk < kPK / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < kPD / 16; ++np) {
        uint32_t b[4];
        ldsm_x4_trans(b, vst + (kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7)) *
                                   kPRow +
                             np * 16 + (lane >> 4) * 8);
        mma16816(o[2 * np], a, b[0], b[1]);
        mma16816(o[2 * np + 1], a, b[2], b[3]);
      }
    }
  }
  if (!active) return;

  // o / l + q, for the rows of the window that lie on the map
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = q0 + gq + 8 * i;
    const int t = first + r;
    const int y = qy0 + cy[i], x = qx0 + cx[i];
    if (t >= nq || y >= p.hq || x >= p.wq) continue;
    const float inv = 1.f / l[i];
    const __nv_bfloat16* qrow = qs + r * kPRow + 2 * tq;
    __nv_bfloat16* dst =
        p.out +
        ((static_cast<long long>(img) * p.hq + y) * p.wq + x) * p.heads * kPD +
        head * kPD + 2 * tq;
#pragma unroll
    for (int j = 0; j < kPD / 8; ++j) {
      const float2 qv = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(qrow + 8 * j));
      *reinterpret_cast<uint32_t*>(dst + 8 * j) =
          pack_bf16(o[j][2 * i] * inv + qv.x, o[j][2 * i + 1] * inv + qv.y);
    }
  }
}

}  // namespace

extern "C" {

// qkv (B, H, W, 3 * heads * 64) bf16 contiguous; bias (3 * heads * 64);
// rel_h (2Sh - 1, 64) and rel_w (2Sw - 1, 64) bf16, or one per head with
// the given element strides between heads (0: shared); out (B, H, W,
// heads * 64); every pointer 16-byte aligned.  Windows of Sh x Sw tile the
// map padded up to their multiple (Sh = H and Sw = W: global attention).
// Returns a cudaError_t.
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
    int most = 0;
    err = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                 device);
    if (err != cudaSuccess) return static_cast<int>(err);
    const void* kernels[] = {
        reinterpret_cast<const void*>(relpos_attention_kernel_window<224>),
        reinterpret_cast<const void*>(relpos_attention_kernel_window<256>),
        reinterpret_cast<const void*>(relpos_attention_kernel_stream)};
    for (const void* k : kernels) {
      err = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    configured[device] = true;
  }
  Params p{};
  p.bias = static_cast<const __nv_bfloat16*>(bias);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.hm = h;
  p.wm = w;
  p.c = heads * kD;
  p.heads = heads;
  p.sh = sh;
  p.sw = sw;
  p.nwh = (h + sh - 1) / sh;
  p.nww = (w + sw - 1) / sw;
  p.rel_h_per_head = rel_h_head != 0;
  p.rel_w_per_head = rel_w_head != 0;
  p.scale_log2 = scale * kLog2e;
  // whole windows up to 16 x 16, in rows of 16 tokens; all else streamed
  // in tiles of two rows of 64 tokens
  const bool whole = sh <= kWholeWidth && sw <= kWholeWidth;
  const long long blocks_z = static_cast<long long>(batch) * p.nwh * p.nww;
  if (blocks_z > 65535 || heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const cuuint64_t dims[5] = {kD, static_cast<cuuint64_t>(3 * heads),
                              static_cast<cuuint64_t>(w),
                              static_cast<cuuint64_t>(h),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row_bytes = 3ull * p.c * 2;
  const cuuint64_t strides[4] = {kRow, row_bytes, row_bytes * w,
                                 row_bytes * w * h};
  const cuuint32_t box[5] = {
      kD, 1, static_cast<cuuint32_t>(whole ? kWholeWidth : kStreamWidth),
      static_cast<cuuint32_t>(whole ? sh : kStreamKeys / kStreamWidth), 1};
  const int table_rows = whole ? kWholeTable : kStreamTable;
  if (!encode(&p.qkv, qkv, 5, dims, strides, box) ||
      !encode_table(&p.rel_h, rel_h, sh, rel_h_head, heads, table_rows) ||
      !encode_table(&p.rel_w, rel_w, sw, rel_w_head, heads, table_rows))
    return static_cast<int>(cudaErrorInvalidValue);

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (whole) {
    const int keys = window_keys(sh);
    const dim3 grid(heads, static_cast<unsigned>(blocks_z));
    const int smem = window_smem(sh, keys);
    if (keys == 224)
      relpos_attention_kernel_window<224><<<grid, kWG, smem, s>>>(p);
    else
      relpos_attention_kernel_window<256><<<grid, kWG, smem, s>>>(p);
  } else {
    const int rows = kStreamKeys / kStreamWidth;
    const dim3 grid((sh + rows - 1) / rows, heads,
                    static_cast<unsigned>(blocks_z));
    relpos_attention_kernel_stream<<<grid, kStreamThreads, kStreamSmem, s>>>(
        p);
  }
  return static_cast<int>(cudaGetLastError());
}

// q (B * heads, Hq, Wq, 96), k and v (B * heads, Hk, Wk, 96), bf16
// contiguous; rel_h (lh, 96) and rel_w (lw, 96) bf16, at the rows their
// axes read (2 max(q side, k side) - 1); out (B, Hq, Wq, heads * 96);
// every pointer 16-byte aligned.  Windows of sqh x sqw over the q map and
// skh x skw over the kv map, the maps padded up to their multiples, in the
// same grid (sq = Hq x Wq and sk = Hk x Wk: global attention).  Key sides
// up to 32, query sides up to 128; on each axis the larger of the q and key
// sides a multiple of the smaller.  Returns a cudaError_t.
int td_relpos_attention_pooled(const void* q, const void* k, const void* v,
                               const void* rel_h, const void* rel_w,
                               void* out, int maps, int heads, int hq, int wq,
                               int hk, int wk, int sqh, int sqw, int skh,
                               int skw, int lh, int lw, float scale,
                               void* stream) {
  if (maps == 0 || hq == 0 || wq == 0) return 0;
  if (maps < 0 || heads < 1 || maps % heads || hq < 0 || wq < 0 || hk < 1 ||
      wk < 1 || sqh < 1 || sqw < 1 || skh < 1 || skw < 1 || skh > kPMaxKey ||
      skw > kPMaxKey || sqh > kPMaxQuery || sqw > kPMaxQuery || maps > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int nwh = (hq + sqh - 1) / sqh, nww = (wq + sqw - 1) / sqw;
  if (nwh != (hk + skh - 1) / skh || nww != (wk + skw - 1) / skw ||
      static_cast<long long>(nwh) * nww > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  PooledParams p{};
  // each axis: c * a - j * b + (K - 1) * b, the larger side a multiple of
  // the smaller, the table at 2 max - 1 rows
  int scaling[2][2];
  const int sides[2][3] = {{sqh, skh, lh}, {sqw, skw, lw}};
  for (int ax = 0; ax < 2; ++ax) {
    const int qs = sides[ax][0], ks = sides[ax][1];
    const int hi = qs > ks ? qs : ks, lo = qs > ks ? ks : qs;
    if (hi % lo || sides[ax][2] != 2 * hi - 1)
      return static_cast<int>(cudaErrorInvalidValue);
    scaling[ax][0] = ks >= qs ? ks / qs : 1;
    scaling[ax][1] = qs >= ks ? qs / ks : 1;
  }
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.rel_h = static_cast<const __nv_bfloat16*>(rel_h);
  p.rel_w = static_cast<const __nv_bfloat16*>(rel_w);
  p.out = static_cast<__nv_bfloat16*>(out);
  p.heads = heads;
  p.hq = hq;
  p.wq = wq;
  p.hk = hk;
  p.wk = wk;
  p.sqh = sqh;
  p.sqw = sqw;
  p.skh = skh;
  p.skw = skw;
  p.nww = nww;
  p.lh = lh;
  p.lw = lw;
  p.ah = scaling[0][0];
  p.bh = scaling[0][1];
  p.aw = scaling[1][0];
  p.bw = scaling[1][1];
  p.scale_log2 = scale * kLog2e;
  // key tiles of whole rows: the key window's width padded up to kW
  const int kw = skw <= 16 ? 16 : 32;
  const int rows = kPK / kw;
  p.n_tiles = (skh + rows - 1) / rows;
  p.gs = (kw + p.n_tiles * rows) | 1;
  const int smem = (kPQ + kPStageRows) * kPRow * 2 + kPQ * p.gs * 4;
  static bool configured[64] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < 0 || device >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!configured[device]) {   // above 48 KB, once per device
    const void* kernels[] = {
        reinterpret_cast<const void*>(relpos_attention_kernel_pooled<16>),
        reinterpret_cast<const void*>(relpos_attention_kernel_pooled<32>)};
    const int most = (kPQ + kPStageRows) * kPRow * 2 +
                     kPQ * ((2 * kPMaxKey) | 1) * 4;
    for (const void* kern : kernels) {
      err = cudaFuncSetAttribute(kern,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 most);
      if (err != cudaSuccess) return static_cast<int>(err);
      err = cudaFuncSetAttribute(
          kern, cudaFuncAttributePreferredSharedMemoryCarveout,
          cudaSharedmemCarveoutMaxShared);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    configured[device] = true;
  }
  const long long q_tiles =
      (static_cast<long long>(sqh) * sqw + kPQ - 1) / kPQ;
  const dim3 grid(static_cast<unsigned>(q_tiles),
                  static_cast<unsigned>(nwh * nww),
                  static_cast<unsigned>(maps));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kw == 16)
    relpos_attention_kernel_pooled<16><<<grid, kPThreads, smem, s>>>(p);
  else
    relpos_attention_kernel_pooled<32><<<grid, kPThreads, smem, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
