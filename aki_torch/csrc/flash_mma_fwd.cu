// Flash attention forward under the modality-mutual (MMA) mask, for Hopper.
//
// Replaces the two TPU kernels of aki_tpu/ops/flash_mma.py:
//   _kernel_1kv (line 175): the whole KV sequence in one tile (S <= 1024);
//   _kernel     (line 79):  FA2 online softmax over several KV tiles.
// They differ only in the trip count of the KV loop, so one kernel with a
// KV loop inside the block covers both. A third entry point,
// flash_mma_fwd_flat, replaces
//   _kernel_1kv_flat (line 246): the same math over the flat padded-head
//   layout (B, T, H*128), real head dims in the low lanes, zeros in the
//   pad lanes.
// On the TPU that kernel existed because Mosaic slices heads only at 128
// lanes; here the flat tensor in memory IS the contiguous (B, T, H, 128)
// tensor, so it is this kernel at head width 128: zero pad lanes add
// nothing to q.k, P.V is written over every lane (as the TPU kernel writes
// it), and the softmax scale of the REAL head dim is passed in.
//
// What it computes, per (b, h, query row q):
//   allowed(q, k) = k < S && kv_valid[b, k] &&
//                   (!causal || k <= q_abs ||
//                    exists image n: img_start[n] <= q_abs < txt_start[n] &&
//                                    txt_start[n] <= k < txt_end[n])
//   with q_abs = q_offset[b] + q;
//   out = softmax2(scale*log2(e) * q.K^T over allowed keys) . V
// The scale multiplies the f32 scores; P is rounded to bf16 before the PV
// product (as the TPU kernel does), the row sum is kept in f32 from the
// unrounded p, and a row with no allowed key writes 0. exp2 flushes a p
// below 2^-126 to zero: such a term is under one f32 ulp of the row sum,
// whose largest term is 1.
//
// Optional output for the backward (csrc/flash_mma_bwd.cu): the row
// logsumexp lse (B, H, T) f32, written when its pointer is non-null, IN BASE
// 2 of the scaled scores: lse = m + log2(l) with m the running max of
// scale*log2(e)*q.k and l the f32 row sum, so that the backward's
// p = exp2(scale*log2(e)*q.k - lse). A row with no allowed key stores
// +inf, which makes every p of that row 0. This carries the function of the
// TPU's separate stats pass (flash_mma_bwd.py:68 _lse_kernel) at no extra
// pass over K: the forward already holds m and l in registers.
//
// Design (warp-specialised, TMA + wgmma):
// - A block owns NC x 64 query rows of one (head, batch row): NC consumer
//   warpgroups of 64 rows each and one producer warp. Large grids take
//   NC = 3 (192 rows; 2 at width 128, where 3 would spill), so that each
//   K/V tile read serves 192 rows, once B*H*ceil(T/rows) fills two waves
//   of the SMs; smaller ones NC = 1, two blocks to an SM, so that
//   one-request grids are not cut below a wave. The query tiles of one
//   (head, batch row) are launched next to each other, so that its K and V
//   are read from HBM about once and then from L2; in the causal case the
//   query tiles with the longest KV walk are scheduled first.
// - The producer issues TMA loads (cp.async.bulk.tensor from CUtensorMaps
//   built on the host for each call) into 128-byte-swizzled shared tiles:
//   Q once, then K and V tiles of 64 keys through a ring of 2-3 stages,
//   each with a "full" mbarrier (transaction bytes) and an "empty" one
//   (consumer arrivals). Tile j + 1 is in flight while tile j is computed.
//   Rows past T or S and head lanes past D arrive as zeros (TMA's
//   out-of-bounds fill); the head dim is stored as two 64-lane chunks.
// - Each consumer warpgroup computes S = Q K^T with wgmma (A and B from
//   shared memory, K-major, 64 keys wide, D/16 k-steps over the head dim
//   padded to DP = 80, 96 or 128), the online softmax in registers, and
//   O += P V with wgmma (P from registers as bf16 A fragments, V from
//   shared memory MN-major: one instruction over all DP lanes, the two
//   64-lane chunks one leading-byte offset apart).
// - Tile classes, per (64 query rows, 64 keys): *skip* (outside the causal
//   frontier and every MMA rectangle: the semantics of flash_mma.py:110-127;
//   never loaded when the whole block skips it, never computed by a
//   warpgroup that skips it), *full* (every key below the causal frontier
//   of the first row, or non-causal, and every key < S and valid: a warp
//   vote over the tile's kv_valid), *partial* (the rest). Only partial tiles
//   evaluate the predicate, in O(1) per score: a bitmask of the images whose
//   query span holds the row (per thread, once) against a bitmask of the
//   images whose text span holds the key (per tile). aki_torch/ops/
//   flash_mma_args.py:tile_classes mirrors the classification, and a
//   launch counts the tiles of each class it ran when a check asks it to
//   (flash_mma_count_tiles).
// GQA: the KV head of query head h is h / (H / Hkv).
//
// What bounds it on an H100 (SXM data-sheet peaks at 700 W: 989 TFLOP/s
// bf16, 3.35 TB/s), counting the pairs the mask allows and each tensor
// once: the tower (48 images x 729 patches x 16 heads x 72) and the flat
// tower are bound by operations (0.119 and 0.211 ms at peak); the serving
// admission (48 x 655 x 32 x 96, MMA, ragged) and its flat form by bytes
// (0.208 and 0.277 ms); one request (SigLIP 729 x 16; decoder prefill of
// 203 or 1,043 tokens over a 1,024- or 1,280-slot cache) needs 1.5-8.4 us
// at either peak, so there the kernel is bound by latency: a wave or less
// of blocks, each walking a handful of tiles. The design answers the large
// shapes with wgmma at up to 192 rows per K/V tile, loads that run ahead
// of the products, no per-score mask on full tiles and one MUFU
// instruction per exp2; the small ones with 64-row blocks, two to an SM,
// longest walk first. What is left (PERF.md): the softmax runs between
// the two products of a tile with no overlap inside a warpgroup (only
// across warpgroups). Variants that issued a tile's P V with the next
// tile's Q K^T made ptxas serialise or wait on the wgmma (notes C7513,
// C7517, C7518, C7520) and ran slower.
//
// Plain C interface (bound with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockN = 64;          // keys per KV tile
constexpr int kChunk = 64;           // bf16 lanes per 128-byte swizzled row chunk
constexpr int kTileBytes = 64 * 128; // one chunk of a 64-row tile
constexpr int kMaxImages = 16;
constexpr int kSkip = 0, kFull = 1, kPartial = 2;

template <int NC>
__host__ __device__ constexpr int threads() { return NC * 128 + 32; }

// K/V ring depth: three for the large blocks (one per SM); two for 64-row
// blocks, so that two blocks fit an SM.
template <int NC>
__host__ __device__ constexpr int stages() { return NC == 1 ? 2 : 3; }

// Consumer warpgroups of a large block: three (192 rows); two at width 128,
// where three would spill (the 64 x 128 f32 accumulator alone is 64
// registers a thread, and 416 threads leave 152).
template <int DP>
__host__ __device__ constexpr int big_nc() { return DP == 128 ? 2 : 3; }

// Shared layout from a 1024-byte-aligned base: Q [NC][2 chunks], K and V
// [stages][2 chunks], each chunk 64 rows x 128 bytes; then the mbarriers,
// each stage's key-validity mask and the image coordinates.
template <int NC>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + (NC * 2 + 4 * stages<NC>()) * kTileBytes + 8 * (1 + 3 * stages<NC>()) +
         3 * kMaxImages * 4;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 4-d (D, heads, rows, batch) map into shared memory; its
// bytes complete a transaction on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar,
                                         int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// wgmma matrix descriptor of a 128-byte-swizzled tile at shared address
// `addr`: 8-row groups 1024 bytes apart (SBO); `lbo`, the leading byte
// offset, is the distance between 64-lane chunks of an MN-major operand
// (V), and unused for a K-major one, whose 16-lane k-step lies inside one
// swizzle atom.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(1024 >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Keeps the compiler from touching accumulator registers across the
// asynchronous product: every later use depends on this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// D (+)= A B^T, m64n64k16: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db,
                                            int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D += A B, m64n80k16: A from registers (bf16 fragments), B from shared
// memory MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B, m64n96k16: A from registers (bf16 fragments), B from shared
// memory MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n96(float (&d)[48], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n96k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47}, "
      "{%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D += A B, m64n128k16: A from registers (bf16 fragments), B from shared
// memory MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (N == 128) wgmma_rs_n128(d, a, db);
  else if constexpr (N == 96) wgmma_rs_n96(d, a, db);
  else wgmma_rs_n80(d, a, db);
}

// 2^x in one MUFU.EX2 instruction; results below 2^-126 flush to zero.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Two floats -> one register of two bf16; the first lands in the low half
// (the lower column index of a fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// DP: head dim padded to 80, 96 or 128; NC: consumer warpgroups (64 query
// rows each).
template <int DP, int NC>
__global__ void __launch_bounds__(threads<NC>(), NC == 1 ? 2 : 1)
flash_mma_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse,            // (B, H, T) or null
                     const int* __restrict__ kv_valid,   // (B, S) or null
                     const int* __restrict__ q_offset,   // (B,)
                     const int* __restrict__ img_start,  // (B, n_img)
                     const int* __restrict__ txt_start,
                     const int* __restrict__ txt_end,
                     int* __restrict__ tile_counts,      // [skip, full, partial] or null
                     int n_img, int T, int S, int H, int Hkv, int D,
                     int causal, float scale_log2) {
  constexpr int BM = NC * 64;
  constexpr int KSTEPS = DP / 16;    // k-steps of the QK^T product
  constexpr int kStages = stages<NC>();

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;                              // [NC][2][64 x 128 B]
  unsigned char* Ks = Qs + NC * 2 * kTileBytes;          // [kStages][2][...]
  unsigned char* Vs = Ks + kStages * 2 * kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(Vs + kStages * 2 * kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* valid_s = empty + kStages;   // per stage, bit c: key k0 + c is < S and valid
  int* i0_s = reinterpret_cast<int*>(valid_s + kStages);
  int* t0_s = i0_s + kMaxImages;
  int* t1_s = t0_s + kMaxImages;

  // the query tiles of one (head, batch row) are launched next to each
  // other, so that they read its K and V from L2; causal: the last query
  // tiles walk the most KV tiles, start them first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BM;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  // broadcast so that the compiler knows the warp index, and so the
  // producer / consumer split and each warpgroup's branches, are uniform
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int off = q_offset[b];
  const int q_first = off + q0;                          // absolute position of row 0
  const int q_last = off + min(q0 + BM, T) - 1;

  if (tid < n_img) {
    i0_s[tid] = img_start[b * n_img + tid];
    t0_s[tid] = txt_start[b * n_img + tid];
    t1_s[tid] = txt_end[b * n_img + tid];
  }
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Does any row in [first, last] (absolute) attend a key of the tile at
  // k0: the causal frontier or one image's MMA rectangle
  auto visit = [&](int k0, int first, int last) {
    bool vis = !causal || k0 <= last;
    for (int n = 0; n < n_img && !vis; ++n)
      vis = first < t0_s[n] && last >= i0_s[n] && k0 < t1_s[n] && k0 + kBlockN > t0_s[n];
    return vis;
  };
  const int n_tiles = (S + kBlockN - 1) / kBlockN;

  if (warp == NC * 4) {
    // producer warp: lane 0 issues every load of the block; the warp votes
    // each tile's key validity ahead of the consumers
    if (lane == 0) {
      int q_bytes = 0;
      for (int w = 0; w < NC; ++w)
        if (q0 + 64 * w < T) q_bytes += 2 * kTileBytes;
      mbar_expect_tx(q_full, q_bytes);
      for (int w = 0; w < NC; ++w)
        if (q0 + 64 * w < T)
          for (int c = 0; c < 2; ++c)
            tma_load(Qs + (w * 2 + c) * kTileBytes, &tm_q, q_full, c * kChunk, h, q0 + 64 * w, b);
    }
    const int* valid_b = kv_valid == nullptr ? nullptr : kv_valid + (size_t)b * S;
    int stage = 0, phase = 0;
    for (int j = 0; j < n_tiles; ++j) {
      const int k0 = j * kBlockN;
      if (!visit(k0, q_first, q_last)) continue;
      const int ka = k0 + lane, kb = k0 + 32 + lane;
      const bool va = ka < S && (valid_b == nullptr || valid_b[ka] != 0);
      const bool vb = kb < S && (valid_b == nullptr || valid_b[kb] != 0);
      const uint64_t vmask = static_cast<uint64_t>(__ballot_sync(0xffffffffu, va)) |
                             (static_cast<uint64_t>(__ballot_sync(0xffffffffu, vb)) << 32);
      if (lane == 0) {
        mbar_wait(&empty[stage], phase ^ 1);   // the first use of a stage passes
        valid_s[stage] = vmask;                 // published by the arrival below
        mbar_expect_tx(&full[stage], 4 * kTileBytes);
        for (int c = 0; c < 2; ++c) {
          tma_load(Ks + (stage * 2 + c) * kTileBytes, &tm_k, &full[stage], c * kChunk, hk, k0, b);
          tma_load(Vs + (stage * 2 + c) * kTileBytes, &tm_v, &full[stage], c * kChunk, hk, k0, b);
        }
      }
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows r0 .. r0 + 63; warp wl of it rows
  // 16 wl .. 16 wl + 15, of which this thread holds g and g + 8
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + wg * 64;
  const bool has_rows = r0 < T;
  const int wg_first = off + r0, wg_last = off + min(r0 + 64, T) - 1;
  // with tile_counts: one count per (64 rows, 64 keys) tile of this
  // warpgroup's rows, by class (a check of the classification)
  const bool counter = tile_counts != nullptr && has_rows && (tid & 127) == 0;
  const int row_abs[2] = {wg_first + wl * 16 + g, wg_first + wl * 16 + g + 8};
  uint32_t row_img[2] = {0u, 0u};   // images whose query span holds the row
#pragma unroll
  for (int r = 0; r < 2; ++r)
    for (int n = 0; n < n_img; ++n)
      if (row_abs[r] >= i0_s[n] && row_abs[r] < t0_s[n]) row_img[r] |= 1u << n;

  float acc[DP / 2];   // O in the wgmma accumulator layout
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float m_run[2] = {-INFINITY, -INFINITY};   // rows g and g + 8
  float l_run[2] = {0.f, 0.f};

  const uint32_t q_base = smem_addr(Qs + wg * 2 * kTileBytes);
  const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);
  mbar_wait(q_full, 0);

  int stage = 0, phase = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    if (!visit(k0, q_first, q_last)) {
      if (counter) atomicAdd(&tile_counts[kSkip], 1);
      continue;
    }
    // this warpgroup's class of the tile (uniform over its four warps)
    int cls = has_rows && visit(k0, wg_first, wg_last) ? kPartial : kSkip;
    mbar_wait(&full[stage], phase);
    const uint64_t vmask = valid_s[stage];
    if (cls != kSkip && vmask == ~0ull && (!causal || k0 + kBlockN - 1 <= wg_first))
      cls = kFull;
    if (counter) atomicAdd(&tile_counts[cls], 1);

    if (cls != kSkip) {
      // S = Q K^T over the head dim's k-steps (both operands K-major)
      const uint32_t ks = k_base + stage * 2 * kTileBytes;
      float s[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const uint32_t at = (kk / 4) * kTileBytes + (kk % 4) * 32;
        wgmma_ss_n64(s, sw128_desc(q_base + at, 16), sw128_desc(ks + at, 16), kk > 0);
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // scale into base 2 and mask; s[4 jt + 2 r + e] is row g + 8 r,
      // key column 8 jt + 2 t4 + e
      float mx[2] = {-INFINITY, -INFINITY};
      if (cls == kFull) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          s[i] *= scale_log2;
          mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        }
      } else {
        // images whose text span holds key k0 + lane and k0 + 32 + lane
        uint32_t kimg_lo = 0u, kimg_hi = 0u;
        const bool rects = causal && n_img > 0;
        if (rects) {
          for (int n = 0; n < n_img; ++n) {
            const int a = k0 + lane, c = k0 + 32 + lane;
            kimg_lo |= static_cast<uint32_t>(a >= t0_s[n] && a < t1_s[n]) << n;
            kimg_hi |= static_cast<uint32_t>(c >= t0_s[n] && c < t1_s[n]) << n;
          }
        }
#pragma unroll
        for (int jt = 0; jt < 8; ++jt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kc = jt * 8 + 2 * t4 + e;
            const uint32_t kbits =
                rects ? __shfl_sync(0xffffffffu, jt < 4 ? kimg_lo : kimg_hi, kc & 31) : 0u;
            const bool kval = (vmask >> kc) & 1ull;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = jt * 4 + r * 2 + e;
              const bool ok = kval && (!causal || k0 + kc <= row_abs[r] ||
                                       (row_img[r] & kbits) != 0u);
              s[i] = ok ? s[i] * scale_log2 : -INFINITY;
              mx[r] = fmaxf(mx[r], s[i]);
            }
          }
        }
      }
      // row max over the quad that shares a row
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_run[r], mx[r]);
        // a row with nothing allowed yet keeps p == 0 and O == 0
        m_use[r] = m_new == -INFINITY ? 0.f : m_new;
        alpha[r] = exp2_ftz(m_run[r] - m_use[r]);
        m_run[r] = m_new;
      }

      // P = exp2(S - m) as bf16 A fragments (16 keys per k-step); the row
      // sum stays f32
      uint32_t pn[kBlockN / 16][4];
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        const float p0 = exp2_ftz(s[jt * 4 + 0] - m_use[0]);
        const float p1 = exp2_ftz(s[jt * 4 + 1] - m_use[0]);
        const float p2 = exp2_ftz(s[jt * 4 + 2] - m_use[1]);
        const float p3 = exp2_ftz(s[jt * 4 + 3] - m_use[1]);
        rs[0] += p0 + p1;
        rs[1] += p2 + p3;
        const int kk = jt >> 1, hi = (jt & 1) * 2;
        pn[kk][hi] = pack_bf16(p0, p1);
        pn[kk][hi + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
        rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
        l_run[r] = l_run[r] * alpha[r] + rs[r];
      }
#pragma unroll
      for (int i = 0; i < DP / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      // O += P V: V's 16-key k-steps, MN-major, one product per chunk
      const uint32_t vs = v_base + stage * 2 * kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        wgmma_rs<DP>(acc, pn[kk], sw128_desc(vs + kk * 2048, kTileBytes));
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    // this warp is done with the stage (wgmma.wait_group held every lane)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (!has_rows) return;

  // out = O / l; a row with no allowed key writes 0
  const size_t q_stride = (size_t)H * D;
  __nv_bfloat16* ob = o + ((size_t)b * T) * q_stride + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + wl * 16 + g + 8 * r;
    if (row >= T) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
    __nv_bfloat16* orow = ob + (size_t)row * q_stride;
#pragma unroll
    for (int jt = 0; jt < DP / 8; ++jt) {
      const int d = jt * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(acc[jt * 4 + 2 * r] * inv, acc[jt * 4 + 2 * r + 1] * inv);
    }
    // the four threads of a quad hold the same row stats
    if (lse != nullptr && t4 == 0)
      lse[((size_t)b * H + h) * T + row] =
          l_run[r] > 0.f ? m_run[r] + log2f(l_run[r]) : INFINITY;
  }
}

// cuTensorMapEncodeTiled, reached through the runtime so that the library
// needs no link against the driver.
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The TMA map of a contiguous (B, L, Hh, D) bf16 tensor as dims (D, Hh, L,
// B), boxes of 64 lanes x 1 head x 64 rows, 128-byte swizzle, zero fill
// out of bounds.
bool head_map(CUtensorMap* map, const void* ptr, int B, int L, int Hh, int D) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)Hh, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)Hh * D * 2,
                                 (cuuint64_t)L * Hh * D * 2};
  const cuuint32_t box[4] = {kChunk, 1, 64, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The tile counts that launches add to while a check has set them
// (flash_mma_count_tiles); null otherwise.
int* g_tile_counts = nullptr;

// Query rows per block: large blocks once they fill two waves of `sms`,
// else 64.
template <int DP>
int block_rows(int B, int T, int H, int sms) {
  constexpr int rows = 64 * big_nc<DP>();
  return (long)B * H * ((T + rows - 1) / rows) >= 2L * sms ? rows : 64;
}

cudaError_t sm_count(int* sms) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  return err != cudaSuccess ? err
                            : cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
}

template <int DP, int NC>
int launch_nc(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
              void* lse, const void* kv_valid, const void* q_offset, const void* img_start,
              const void* txt_start, const void* txt_end, int n_img, int B, int T, int S,
              int H, int Hkv, int D, int causal, float scale_log2, cudaStream_t stream) {
  constexpr int smem = smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(flash_mma_fwd_kernel<DP, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + NC * 64 - 1) / (NC * 64), H, B);
  flash_mma_fwd_kernel<DP, NC><<<grid, threads<NC>(), smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_valid), static_cast<const int*>(q_offset),
      static_cast<const int*>(img_start), static_cast<const int*>(txt_start),
      static_cast<const int*>(txt_end), g_tile_counts, n_img, T, S, H, Hkv, D, causal,
      scale_log2);
  return (int)cudaGetLastError();
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* kv_valid, const void* q_offset, const void* img_start,
           const void* txt_start, const void* txt_end, int n_img, int B, int T,
           int S, int H, int Hkv, int D, int causal, float scale_log2,
           cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, B, T, H, D) || !head_map(&tk, k, B, S, Hkv, D) ||
      !head_map(&tv, v, B, S, Hkv, D))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  if (block_rows<DP>(B, T, H, sms) > 64)
    return launch_nc<DP, big_nc<DP>()>(tq, tk, tv, o, lse, kv_valid, q_offset, img_start, txt_start,
                            txt_end, n_img, B, T, S, H, Hkv, D, causal, scale_log2, stream);
  return launch_nc<DP, 1>(tq, tk, tv, o, lse, kv_valid, q_offset, img_start, txt_start,
                          txt_end, n_img, B, T, S, H, Hkv, D, causal, scale_log2, stream);
}

}  // namespace

extern "C" const char* flash_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// For checks: from now on every launch of either entry adds, per
// consumer warpgroup with rows, the (64 rows x 64 keys) tiles it ran to
// counts[0..2] (skip, full, partial; int32 on the current device), one
// atomic per tile; null stops it. Not for concurrent callers.
extern "C" void flash_mma_count_tiles(void* counts) {
  g_tile_counts = static_cast<int*>(counts);
}

// The query rows per block that a launch of B x T rows and H heads at
// head dim D (72..96, or 128 for the flat entry) takes on the current
// device, or -1 when the device cannot be read.
extern "C" int flash_mma_fwd_block_rows(int B, int T, int H, int D) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return D > 96 ? block_rows<128>(B, T, H, sms) : block_rows<96>(B, T, H, sms);
}

// q (B,T,H,D), k/v (B,S,Hkv,D), o (B,T,H,D): contiguous bf16, 16-byte
// aligned, D % 8 == 0, D in 72..96 (padded to 80 or 96: SigLIP's 72,
// Phi-3's 96), H % Hkv == 0. kv_valid (B,S) int32 or null; q_offset (B,)
// int32; img_start/txt_start/txt_end (B,n_img) int32, n_img <= kMaxImages.
// lse (B,H,T) f32 or null (inference passes null).
extern "C" int flash_mma_fwd(const void* q, const void* k, const void* v, void* o,
                             void* lse, const void* kv_valid, const void* q_offset,
                             const void* img_start, const void* txt_start,
                             const void* txt_end, int n_img, int B, int T, int S,
                             int H, int Hkv, int D, int causal, float scale_log2,
                             void* stream) {
  if (D % 8 != 0 || D < 72 || D > 96 || Hkv <= 0 || H % Hkv != 0 ||
      n_img < 0 || n_img > kMaxImages || B <= 0 || T <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
#define AKI_CASE(DP)                                                             \
  case DP:                                                                       \
    return launch<DP>(q, k, v, o, lse, kv_valid, q_offset, img_start, txt_start, \
                      txt_end, n_img, B, T, S, H, Hkv, D, causal, scale_log2, st);
    AKI_CASE(80) AKI_CASE(96)
#undef AKI_CASE
  }
  return (int)cudaErrorInvalidValue;
}

// K6: q/k/v/o (B, T, H*128) contiguous bf16 (the flat padded-head layout),
// H % Hkv == 0, the rest as flash_mma_fwd; scale_log2 from the real head
// dim. Inference only: no lse.
extern "C" int flash_mma_fwd_flat(const void* q, const void* k, const void* v, void* o,
                                  const void* kv_valid, const void* q_offset,
                                  const void* img_start, const void* txt_start,
                                  const void* txt_end, int n_img, int B, int T, int S,
                                  int H, int Hkv, int causal, float scale_log2,
                                  void* stream) {
  if (Hkv <= 0 || H % Hkv != 0 || n_img < 0 || n_img > kMaxImages || B <= 0 || T <= 0 ||
      S <= 0)
    return (int)cudaErrorInvalidValue;
  return launch<128>(q, k, v, o, nullptr, kv_valid, q_offset, img_start, txt_start,
                     txt_end, n_img, B, T, S, H, Hkv, 128, causal, scale_log2,
                     static_cast<cudaStream_t>(stream));
}
