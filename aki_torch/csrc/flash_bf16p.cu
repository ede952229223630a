// Flash attention forward with bf16 probabilities, for Hopper: the
// attention of the quantized serving prefill (decoder and vision tower).
//
// Replaces no TPU kernel. The JAX package runs this attention as plain XLA
// (aki_tpu/ops/attention.py:decoder_attention_xla and
// :encoder_attention_xla), which materialises the (B, H, T, S) scores; the
// port's plain version (aki_torch/ops/attention.py:_bf16p_attention) did
// the same in f32 on the card, some five passes over that tensor. This
// kernel computes the same function tile by tile in shared memory and
// registers and never writes the scores to device memory.
//
// What it computes, per (b, h, query row q), with the allowed(q, k)
// predicate of flash_mma_fwd.cu (the MMA rectangles and the causal
// frontier when causal, kv_valid, k < S):
//   s(q, k) = (q . k in f32) * scale*log2(e)      bf16 products, f32 sums
//   m = max over allowed k of s                    the row's FINAL max
//   p = bf16(exp2(s - m))                          rounded once
//   l = sum of the rounded p in f32
//   out = bf16((sum_k p * v[k] in f32) / l),       0 for a row with no allowed key
// the steps of the JAX route, with exp in base 2 (log2(e) folded into the
// scale on the host) and exp2 as one MUFU.EX2 instruction that flushes a p
// below 2^-126 to zero (its bf16 would be a subnormal under one f32 ulp of
// l, whose largest term is 1).
//
// The rounding point fixes the design, as in flash_mma_q8.cu: p is rounded
// to bf16 relative to the row's final max, which an online softmax does not
// know when it rounds. So each consumer makes two passes over its KV tiles:
// the first computes the scores and keeps only the row max; the second
// computes them again, bit for bit (one code path, the scale applied with
// __fmul_rn and the max subtracted with __fsub_rn, so that nothing is
// contracted differently), rounds p against that max, sums l from the
// rounded values and accumulates P V. A row's max term gives p = 1 exactly,
// so a live row has l >= 1.
//
// Design (warp-specialised, TMA + wgmma, the plan of flash_mma_fwd.cu):
// - A block owns NC x 64 query rows of one (head, batch row): NC consumer
//   warpgroups of 64 rows each and one producer warp. NC = 3 (192 rows)
//   once B*H*ceil(T/192) fills two waves of the SMs, so that each K/V tile
//   read serves 192 rows; else NC = 1, two blocks to an SM. The query tiles
//   of one (head, batch row) are launched next to each other, so that its K
//   and V come from L2 after the first read; in the causal case the tiles
//   with the longest KV walk start first.
// - The producer starts TMA loads into 128-byte-swizzled shared tiles: Q
//   once, then the K tiles of pass 1 and the K and V tiles of pass 2
//   through one ring of 2-3 stages, each with a "full" mbarrier
//   (transaction bytes) and an "empty" one (consumer arrivals). Rows past
//   T or S and head lanes past D arrive as zeros.
// - Consumers: S = Q K^T on wgmma m64n64k16 (both operands from shared
//   memory, K-major, over the head padded to 80 or 96), the mask and the
//   max in registers; in pass 2 p packs straight into bf16 A fragments for
//   O += P V on wgmma m64n{80,96}k16 with V from shared memory (MN-major).
// - Tile classes per (64 query rows, 64 keys), as flash_mma_fwd.cu and its
//   mirror aki_torch/ops/flash_mma_args.py:tile_classes: skip (never loaded
//   when the whole block skips it, never computed by a warpgroup that skips
//   it), full (no mask), partial (the O(1) test: image bitmasks of the row
//   against those of the key).
// GQA: the KV head of query head h is h / (H / Hkv).
//
// What bounds it on an H100 (989 TFLOP/s bf16, 3.35 TB/s): the function
// needs the same operations and bytes as flash_mma_fwd.cu's at the same
// shapes, 0.208 ms (bytes) at the serving admission (48 x 655, 32 heads x
// 96, MMA, ragged) and 0.119 ms (operations) at the tower (48 x 729, 16 x
// 72); the kernel forms every score twice, so its own work is 1.5 times
// that kernel's products. What holds it back (PERF.md): as in
// flash_mma_fwd.cu, a warpgroup's steps of one tile run in sequence (its
// softmax between its two products; overlap only across warpgroups), and
// pass 1 re-reads K, mostly from L2.
//
// Plain C interface (bound with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include "hopper.cuh"

namespace {

template <int NC>
__host__ __device__ constexpr int threads() { return NC * 128 + 32; }

// K/V ring depth: three for the large blocks (one per SM); two for 64-row
// blocks, so that two blocks fit an SM.
template <int NC>
__host__ __device__ constexpr int stages() { return NC == 1 ? 2 : 3; }

// Shared layout from a 1024-byte-aligned base: Q [NC][2 chunks], K and V
// [stages][2 chunks], each chunk 64 rows x 128 bytes; then the mbarriers,
// each stage's key-validity mask and the image coordinates.
template <int NC>
__host__ __device__ constexpr int smem_bytes() {
  return 1024 + (NC * 2 + 4 * stages<NC>()) * kTileBytes + 8 * (1 + 3 * stages<NC>()) +
         3 * kMaxImages * 4;
}

// A register of two bf16 -> the two as floats (low half first), exactly.
__device__ __forceinline__ float bf16_lo(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }

// DP: head dim padded to 80 or 96; NC: consumer warpgroups (64 query rows
// each).
template <int DP, int NC>
__global__ void __launch_bounds__(threads<NC>(), NC == 1 ? 2 : 1)
flash_bf16p_kernel(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   __nv_bfloat16* __restrict__ o,      // (B, T, H, D)
                   const int* __restrict__ kv_valid,   // (B, S) or null
                   const int* __restrict__ q_offset,   // (B,)
                   const int* __restrict__ img_start,  // (B, n_img)
                   const int* __restrict__ txt_start,
                   const int* __restrict__ txt_end,
                   int n_img, int T, int S, int H, int Hkv, int D, int causal,
                   float scale_log2) {
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

  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BM;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
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
    // producer warp: lane 0 starts every load of the block, pass 1's K
    // tiles then pass 2's K and V tiles; the warp votes each tile's key
    // validity ahead of the consumers
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
    for (int pass = 0; pass < 2; ++pass) {
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
          mbar_expect_tx(&full[stage], (pass ? 4 : 2) * kTileBytes);
          for (int c = 0; c < 2; ++c) {
            tma_load(Ks + (stage * 2 + c) * kTileBytes, &tm_k, &full[stage], c * kChunk, hk, k0,
                     b);
            if (pass)
              tma_load(Vs + (stage * 2 + c) * kTileBytes, &tm_v, &full[stage], c * kChunk, hk,
                       k0, b);
          }
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
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
  const int row_abs[2] = {wg_first + wl * 16 + g, wg_first + wl * 16 + g + 8};
  uint32_t row_img[2] = {0u, 0u};   // images whose query span holds the row
#pragma unroll
  for (int r = 0; r < 2; ++r)
    for (int n = 0; n < n_img; ++n)
      if (row_abs[r] >= i0_s[n] && row_abs[r] < t0_s[n]) row_img[r] |= 1u << n;

  const uint32_t q_base = smem_addr(Qs + wg * 2 * kTileBytes);
  const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);
  mbar_wait(q_full, 0);

  // The scores of the K tile at k0 in `stage` (class cls, not skip): Q K^T
  // over the head dim's k-steps, scaled into base 2, masked to -inf on a
  // partial tile; s[4 jt + 2 r + e] is row g + 8 r, key column 8 jt + 2 t4
  // + e. The same instructions in both passes.
  auto scores = [&](int stage, int k0, int cls, uint64_t vmask, float (&s)[32]) {
    const uint32_t ks = k_base + stage * 2 * kTileBytes;
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
    if (cls == kFull) {
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], scale_log2);
      return;
    }
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
          s[i] = ok ? __fmul_rn(s[i], scale_log2) : -INFINITY;
        }
      }
    }
  };

  // this warpgroup's class of the tile at k0 that the block visits, once
  // its stage has landed
  auto classify = [&](int k0, uint64_t vmask) {
    if (!has_rows || !visit(k0, wg_first, wg_last)) return kSkip;
    return vmask == ~0ull && (!causal || k0 + kBlockN - 1 <= wg_first) ? kFull : kPartial;
  };

  int stage = 0, phase = 0;
  // pass 1: the row max over every allowed key
  float m_row[2] = {-INFINITY, -INFINITY};   // rows g and g + 8
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    if (!visit(k0, q_first, q_last)) continue;
    mbar_wait(&full[stage], phase);
    const uint64_t vmask = valid_s[stage];
    const int cls = classify(k0, vmask);
    if (cls != kSkip) {
      float s[32];
      scores(stage, k0, cls, vmask, s);
#pragma unroll
      for (int i = 0; i < 32; ++i) m_row[(i >> 1) & 1] = fmaxf(m_row[(i >> 1) & 1], s[i]);
    }
    // this warp is done with the stage (wgmma.wait_group held every lane)
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  float m_use[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 1));
    m_row[r] = fmaxf(m_row[r], __shfl_xor_sync(0xffffffffu, m_row[r], 2));
    // a row with no allowed key keeps p == 0 and writes 0
    m_use[r] = m_row[r] == -INFINITY ? 0.f : m_row[r];
  }

  // pass 2: p against the final max, rounded to bf16; l the f32 sum of the
  // rounded p; O += P V
  float acc[DP / 2];   // O in the wgmma accumulator layout
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float l_row[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    if (!visit(k0, q_first, q_last)) continue;
    mbar_wait(&full[stage], phase);
    const uint64_t vmask = valid_s[stage];
    const int cls = classify(k0, vmask);
    if (cls != kSkip) {
      float s[32];
      scores(stage, k0, cls, vmask, s);
      // P as bf16 A fragments (16 keys per k-step)
      uint32_t pn[kBlockN / 16][4];
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        const uint32_t w0 = pack_bf16(exp2_ftz(__fsub_rn(s[jt * 4 + 0], m_use[0])),
                                      exp2_ftz(__fsub_rn(s[jt * 4 + 1], m_use[0])));
        const uint32_t w1 = pack_bf16(exp2_ftz(__fsub_rn(s[jt * 4 + 2], m_use[1])),
                                      exp2_ftz(__fsub_rn(s[jt * 4 + 3], m_use[1])));
        l_row[0] += bf16_lo(w0) + bf16_hi(w0);
        l_row[1] += bf16_lo(w1) + bf16_hi(w1);
        const int kk = jt >> 1, hi = (jt & 1) * 2;
        pn[kk][hi] = w0;
        pn[kk][hi + 1] = w1;
      }
      // O += P V: V's 16-key k-steps, MN-major, one product over DP lanes
      const uint32_t vs = v_base + stage * 2 * kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs<DP>(acc, pn[kk], sw128_desc(vs + kk * 2048, kTileBytes));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[stage]);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }
  if (!has_rows) return;

  // out = O / l, divided after the product; a row with no allowed key
  // writes 0
  const size_t q_stride = (size_t)H * D;
  __nv_bfloat16* ob = o + ((size_t)b * T) * q_stride + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + wl * 16 + g + 8 * r;
    if (row >= T) continue;
    const bool live = m_row[r] != -INFINITY;
    __nv_bfloat16* orow = ob + (size_t)row * q_stride;
#pragma unroll
    for (int jt = 0; jt < DP / 8; ++jt) {
      const int d = jt * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(live ? acc[jt * 4 + 2 * r] / l : 0.f,
                                  live ? acc[jt * 4 + 2 * r + 1] / l : 0.f);
    }
  }
}

// Query rows per block: 192 once B*H*ceil(T/192) fills two waves of `sms`,
// else 64 (aki_torch/ops/flash_bf16p.py:bf16p_plan mirrors it).
int block_rows(int B, int T, int H, int sms) {
  return (long)B * H * ((T + 191) / 192) >= 2L * sms ? 192 : 64;
}

template <int DP, int NC>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv, void* o,
           const void* kv_valid, const void* q_offset, const void* img_start,
           const void* txt_start, const void* txt_end, int n_img, int B, int T, int S, int H,
           int Hkv, int D, int causal, float scale_log2, cudaStream_t stream) {
  constexpr int smem = smem_bytes<NC>();
  cudaError_t err = cudaFuncSetAttribute(flash_bf16p_kernel<DP, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + NC * 64 - 1) / (NC * 64), H, B);
  flash_bf16p_kernel<DP, NC><<<grid, threads<NC>(), smem, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_valid),
      static_cast<const int*>(q_offset), static_cast<const int*>(img_start),
      static_cast<const int*>(txt_start), static_cast<const int*>(txt_end), n_img, T, S, H,
      Hkv, D, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* flash_bf16p_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch plan of a B x T query rows, H heads call on the current
// device: out[0..2] = query rows per block, ring stages, dynamic shared
// bytes. Returns a cudaError_t.
extern "C" int flash_bf16p_plan(int B, int T, int H, int* out) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const bool big = block_rows(B, T, H, sms) > 64;
  out[0] = big ? 192 : 64;
  out[1] = big ? stages<3>() : stages<1>();
  out[2] = big ? smem_bytes<3>() : smem_bytes<1>();
  return 0;
}

// q (B,T,H,D), k/v (B,S,Hkv,D), o (B,T,H,D): contiguous bf16, 16-byte
// aligned, D % 8 == 0, D in 72..96 (padded to 80 or 96: SigLIP's 72,
// Phi-3's 96), H % Hkv == 0. kv_valid (B,S) int32 or null; q_offset (B,) int32;
// img_start/txt_start/txt_end (B,n_img) int32, n_img <= kMaxImages;
// scale_log2 = scale * log2(e).
extern "C" int flash_bf16p(const void* q, const void* k, const void* v, void* o,
                           const void* kv_valid, const void* q_offset, const void* img_start,
                           const void* txt_start, const void* txt_end, int n_img, int B, int T,
                           int S, int H, int Hkv, int D, int causal, float scale_log2,
                           void* stream) {
  if (D % 8 != 0 || D < 72 || D > 96 || Hkv <= 0 || H % Hkv != 0 || n_img < 0 ||
      n_img > kMaxImages || B <= 0 || T <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!head_map(&tq, q, B, T, H, D) || !head_map(&tk, k, B, S, Hkv, D) ||
      !head_map(&tv, v, B, S, Hkv, D))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const bool big = block_rows(B, T, H, sms) > 64;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AKI_LAUNCH(DP, NC)                                                                \
  return launch<DP, NC>(tq, tk, tv, o, kv_valid, q_offset, img_start, txt_start, txt_end, \
                        n_img, B, T, S, H, Hkv, D, causal, scale_log2, st)
  if (D > 80) {
    if (big) AKI_LAUNCH(96, 3);
    AKI_LAUNCH(96, 1);
  }
  if (big) AKI_LAUNCH(80, 3);
  AKI_LAUNCH(80, 1);
#undef AKI_LAUNCH
}
