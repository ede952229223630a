// Single-token attention over one layer of the stacked int8 KV cache, for
// Hopper (the decode step of int8-KV serving).
//
// Replaces the TPU kernel aki_tpu/ops/decode_attention.py:70 (_kernel,
// wrapper decode_attention_flat at line 254) and computes the function of
// that package's default for this step, decode_attention_flat_xla (line
// 359), not the TPU kernel's int8-q / int8-P scheme. Per (batch row b,
// query head h), with hk = h / (H / Hkv) and n = lengths[b]:
//   s_j = (q_bf16[h] . k[layer, b, j, hk]) * ks[layer, b, j, hk] * scale
//   p_j = softmax_j(s) over the live prefix j < n (f32)
//   out = sum_j bf16(p_j * vs[layer, b, j, hk]) * v[layer, b, j, hk]   (f32)
// The int8 values convert to f32 exactly, the score products are exact in
// f32, and p * vs is rounded to bf16 after the softmax is normalised, as
// the reference rounds it. A row with n == 0 writes zeros.
//
// Cache layout: k, v int8 (L, B, S, Hkv*D) (all heads of a token in one
// row); ks, vs f32 (L, B, S, Hkv), token-major. The layer is picked by the
// ``layer`` argument inside the kernel; the cache is never sliced.
//
// Work split: one block of 4 warps per (h, b). Both passes read the live
// prefix in tiles of 16 keys: each key belongs to 8 lanes of a warp, each
// lane converting one 16-byte chunk of the head's D values in registers.
// Pass 1 writes the n scores to shared memory and reduces their max and
// sum over the block; pass 2 normalises each p from shared memory, applies
// the V scale, rounds to bf16 and accumulates p * v in f32 registers, then
// the 16 key slots are summed through shared memory. Keeping the n scores
// (4 bytes each) in shared memory instead of an online softmax lets p be
// normalised before its bf16 rounding, exactly where the reference rounds.
//
// What bounds it on an H100: bytes. At the serving cache (48 rows of 704
// slots, 32 heads x 96) a full-length launch must read 48*704*3072*2 int8
// bytes and 48*704*32*2 f32 scales, 216 MB: 0.065 ms at 3.35 TB/s, against
// ~0.8 GFLOP. Each block reads its head's K and V rows once (96 contiguous
// bytes per key); the scale reads (4 bytes per key at a 128-byte stride)
// are shared with the other heads of the same token through L2. The grid
// has H * B blocks: 1536 at B = 48 fill the 132 SMs, 32 at B = 1 do not
// (no split over S yet).
//
// Plain C interface (bound with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLanesPerKey = 8;                        // 8 x 16 bytes: D <= 128
constexpr int kKeysPerTile = kThreads / kLanesPerKey;  // 16
constexpr int kMaxD = kLanesPerKey * 16;

__device__ __forceinline__ void int8x16_to_f32(const uint4 raw, float (&v)[16]) {
  const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) v[i] = (float)(int8_t)((w[i / 4] >> (8 * (i % 4))) & 0xffu);
}

template <bool kMax>
__device__ __forceinline__ float block_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = kMax ? fmaxf(r, red[i]) : r + red[i];
  __syncthreads();
  return r;
}

__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                        const float* __restrict__ ks, const int8_t* __restrict__ v,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int layer, int B, int S, int H,
                        int Hkv, int D, float scale) {
  extern __shared__ float scores[];                    // S floats
  __shared__ float red[kWarps];
  __shared__ float part[kKeysPerTile][kMaxD];

  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (H / Hkv);
  const int F = Hkv * D;
  const int n = min(max(lengths[b], 0), S);
  __nv_bfloat16* o = out + ((size_t)b * H + h) * D;
  if (n == 0) {
    for (int d = threadIdx.x; d < D; d += kThreads) o[d] = __float2bfloat16_rn(0.f);
    return;
  }
  const size_t tok0 = ((size_t)layer * B + b) * S;     // token row of key 0
  const int8_t* kr = k + tok0 * F + (size_t)hk * D;
  const int8_t* vr = v + tok0 * F + (size_t)hk * D;
  const float* ksr = ks + tok0 * Hkv + hk;
  const float* vsr = vs + tok0 * Hkv + hk;

  const int lane = threadIdx.x & 31;
  const int c = lane % kLanesPerKey;                   // 16-value chunk of the head
  const int slot = threadIdx.x / kLanesPerKey;         // key slot in a tile
  const bool has_chunk = c * 16 < D;

  float qf[16];
  {
    const __nv_bfloat16* qr = q + ((size_t)b * H + h) * D + c * 16;
#pragma unroll
    for (int i = 0; i < 16; ++i) qf[i] = has_chunk ? __bfloat162float(qr[i]) : 0.f;
  }

  // pass 1: scores of the live prefix into shared memory, and their max
  float m = -INFINITY;
  for (int j0 = 0; j0 < n; j0 += kKeysPerTile) {
    const int j = j0 + slot;
    float dot = 0.f;
    if (j < n && has_chunk) {
      float kf[16];
      int8x16_to_f32(*reinterpret_cast<const uint4*>(kr + (size_t)j * F + c * 16), kf);
#pragma unroll
      for (int i = 0; i < 16; ++i) dot += qf[i] * kf[i];
    }
#pragma unroll
    for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (c == 0 && j < n) {
      const float sj = dot * ksr[(size_t)j * Hkv] * scale;
      scores[j] = sj;
      m = fmaxf(m, sj);
    }
  }
  m = block_reduce<true>(m, red);                      // its barrier publishes scores[]
  float l = 0.f;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const float e = expf(scores[j] - m);
    scores[j] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);

  // pass 2: p = e / l, bf16(p * vs), accumulated against V in f32
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  for (int j0 = 0; j0 < n; j0 += kKeysPerTile) {
    const int j = j0 + slot;
    if (j < n && has_chunk) {
      const float p = scores[j] / l;
      const float pv = __bfloat162float(__float2bfloat16_rn(p * vsr[(size_t)j * Hkv]));
      float vf[16];
      int8x16_to_f32(*reinterpret_cast<const uint4*>(vr + (size_t)j * F + c * 16), vf);
#pragma unroll
      for (int i = 0; i < 16; ++i) acc[i] += pv * vf[i];
    }
  }
  if (has_chunk) {
#pragma unroll
    for (int i = 0; i < 16; ++i) part[slot][c * 16 + i] = acc[i];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kThreads) {
    float sum = 0.f;
#pragma unroll
    for (int sl = 0; sl < kKeysPerTile; ++sl) sum += part[sl][d];
    o[d] = __float2bfloat16_rn(sum);
  }
}

}  // namespace

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B, H, D) bf16; k, v (L, B, S, Hkv*D) int8; ks, vs (L, B, S, Hkv) f32;
// lengths (B,) int32; out (B, H, D) bf16, written for rows [0, n_rows).
// D % 16 == 0, D <= 128, H % Hkv == 0, 0 <= layer < L, 0 < n_rows <= B.
// All pointers 16-byte aligned.
extern "C" int decode_attention(const void* q, const void* k, const void* ks, const void* v,
                                const void* vs, const void* lengths, void* out, int layer,
                                int L, int B, int n_rows, int S, int H, int Hkv, int D,
                                float scale, void* stream) {
  if (D <= 0 || D % 16 != 0 || D > kMaxD || Hkv <= 0 || H % Hkv != 0 || layer < 0 ||
      layer >= L || n_rows <= 0 || n_rows > B || S <= 0 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)S * sizeof(float);
  const size_t static_smem = sizeof(float) * (kWarps + kKeysPerTile * kMaxD);
  if (smem + static_smem > 232448) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(H, n_rows);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const int8_t*>(k);
  const auto* vp = static_cast<const int8_t*>(v);
  const auto* ksp = static_cast<const float*>(ks);
  const auto* vsp = static_cast<const float*>(vs);
  const auto* lp = static_cast<const int*>(lengths);
  if (smem + static_smem > 48 * 1024)
    cudaFuncSetAttribute(decode_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)smem);
  decode_attention_kernel<<<grid, kThreads, smem, st>>>(qp, kp, ksp, vp, vsp, lp,
                                                        static_cast<__nv_bfloat16*>(out), layer,
                                                        B, S, H, Hkv, D, scale);
  return (int)cudaGetLastError();
}
