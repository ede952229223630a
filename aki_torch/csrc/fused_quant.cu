// Fused "elementwise op + per-row symmetric int8 quantize", for Hopper.
//
// Replaces the four TPU kernels of aki_tpu/ops/fused_quant.py, which share
// _quantize_rows (line 51) and the pallas_call wrapper _run (line 95):
//   _rms_quant_kernel      (line 66): h = x * rsqrt(mean(x^2) + eps) * g
//   _ln_quant_kernel       (line 73): h = (x - mu) * rsqrt(var + eps) * g + b
//   _silu_mul_quant_kernel (line 83): h = silu(gate) * up
//   _gelu_quant_kernel     (line 89): h = gelu_tanh(x + b)
// then, per row: s = max|h| / 127 (1 when the max is 0),
// q = clip(rint(h / s), -127, 127) as int8. All math is f32; h never leaves
// registers, so each input row is read once and q and s written once.
// One kernel body, templated on the op, serves the four entry points.
//
// Work split: one block of 256 threads per row. Each thread holds up to
// kMaxChunks chunks of 8 consecutive values of the row in registers (a
// 16-byte load of bf16), so a row of up to 256 * 8 * 4 = 8192 values is
// read once; the mean / variance (rms, ln) and the max are block
// reductions (warp shuffles, then one value per warp in shared memory).
//
// What bounds it on an H100: bytes. At the W8A8 serving prefill (48 rows of
// 655 tokens through the decoder, 48 images of 729 patches through the
// tower) one call reads 0.2-1.0 GB of bf16 and writes half that in int8, at
// ~2 FLOP per byte: 0.04-0.39 ms at 3.35 TB/s, against a few microseconds
// of arithmetic. The design keeps every row to one read and one write; the
// per-row block reductions add latency that the ~8 blocks resident on each
// SM hide. Vectorised 16-byte loads, no shared-memory staging of the row.
//
// Plain C interface (bound with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;          // values per chunk
constexpr int kMaxChunks = 4;    // chunks per thread: d <= 8192
enum Op { kRms = 0, kLn = 1, kSiluMul = 2, kGelu = 3 };

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&v)[kVec]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8(const float* p, float (&v)[kVec]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 4);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// Sum (or max) over the block; every thread gets the result. ``red`` holds
// one value per warp; the trailing barrier lets the next call reuse it.
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

template <int kOp, int kChunks>
__global__ void __launch_bounds__(kThreads)
fused_quant_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                   const float* __restrict__ g, const float* __restrict__ b,
                   int8_t* __restrict__ q, float* __restrict__ s, int d, int ldx, int ldy,
                   float eps) {
  __shared__ float red[kWarps];
  const size_t row = blockIdx.x;
  const int n_chunks = d / kVec;
  const __nv_bfloat16* xr = x + row * ldx;
  float h[kChunks][kVec];

  // the elementwise prologue, straight out of the loads
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int ci = threadIdx.x + c * kThreads;
#pragma unroll
    for (int e = 0; e < kVec; ++e) h[c][e] = 0.f;
    if (ci >= n_chunks) continue;
    load8(xr + ci * kVec, h[c]);
    if (kOp == kSiluMul) {
      float u[kVec];
      load8(y + row * ldy + ci * kVec, u);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float gt = h[c][e];
        h[c][e] = gt / (1.f + expf(-gt)) * u[e];
      }
    } else if (kOp == kGelu) {
      float bb[kVec];
      load8(b + ci * kVec, bb);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float v = h[c][e] + bb[e];
        const float inner = 0.7978845608028654f * (v + 0.044715f * (v * v * v));
        h[c][e] = v * (0.5f * (1.f + tanhf(inner)));
      }
    }
  }

  // the norms: row statistics, then scale (and shift)
  if (kOp == kRms || kOp == kLn) {
    float mu = 0.f;
    if (kOp == kLn) {
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
#pragma unroll
        for (int e = 0; e < kVec; ++e) part += h[c][e];
      mu = block_reduce<false>(part, red) / (float)d;
    }
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      if (threadIdx.x + c * kThreads >= n_chunks) continue;
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float xc = h[c][e] - mu;
        part += xc * xc;
      }
    }
    const float r = rsqrtf(block_reduce<false>(part, red) / (float)d + eps);
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      const int ci = threadIdx.x + c * kThreads;
      if (ci >= n_chunks) continue;
      float gg[kVec], bb[kVec];
      load8(g + ci * kVec, gg);
      if (kOp == kLn) load8(b + ci * kVec, bb);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float v = (h[c][e] - mu) * r * gg[e];
        h[c][e] = kOp == kLn ? v + bb[e] : v;
      }
    }
  }

  // per-row symmetric int8
  float amax = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    if (threadIdx.x + c * kThreads >= n_chunks) continue;
#pragma unroll
    for (int e = 0; e < kVec; ++e) amax = fmaxf(amax, fabsf(h[c][e]));
  }
  amax = block_reduce<true>(amax, red);
  const float sc = amax == 0.f ? 1.f : amax / 127.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    const int ci = threadIdx.x + c * kThreads;
    if (ci >= n_chunks) continue;
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < kVec; ++e) {
      const float v = fminf(fmaxf(rintf(h[c][e] / sc), -127.f), 127.f);
      packed[e / 4] |= (uint32_t)(uint8_t)(int8_t)v << (8 * (e % 4));
    }
    *reinterpret_cast<uint2*>(q + row * d + ci * kVec) = make_uint2(packed[0], packed[1]);
  }
  if (threadIdx.x == 0) s[row] = sc;
}

template <int kOp>
cudaError_t launch_op(const void* x, const void* y, const void* g, const void* b, void* q,
                      void* s, int rows, int d, int ldx, int ldy, float eps,
                      cudaStream_t st) {
  const int chunks = (d / kVec + kThreads - 1) / kThreads;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* yp = static_cast<const __nv_bfloat16*>(y);
  const float* gp = static_cast<const float*>(g);
  const float* bp = static_cast<const float*>(b);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(s);
  switch (chunks) {
#define AKI_CASE(C)                                                                   \
  case C:                                                                             \
    fused_quant_kernel<kOp, C><<<rows, kThreads, 0, st>>>(xp, yp, gp, bp, qp, sp, d, ldx, \
                                                          ldy, eps);                  \
    break;
    AKI_CASE(1) AKI_CASE(2) AKI_CASE(3) AKI_CASE(4)
#undef AKI_CASE
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" const char* fused_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// op: 0 rms (x, g), 1 ln (x, g, b), 2 silu*mul (x = gate, y = up), 3 gelu (x, b).
// x, y (rows, d) bf16 with unit column stride and row strides ldx, ldy >= d
// (multiples of 8); g, b (d,) f32; q (rows, d) int8 and s (rows,) f32,
// contiguous. d % 128 == 0, d <= 8192; all pointers 16-byte aligned.
extern "C" int fused_quant(int op, const void* x, const void* y, const void* g,
                           const void* b, void* q, void* s, int rows, int d, int ldx, int ldy,
                           float eps, void* stream) {
  if (d <= 0 || d % 128 != 0 || d > kThreads * kVec * kMaxChunks || rows < 0 || op < 0 ||
      ldx < d || ldy < d || ldx % 8 != 0 || ldy % 8 != 0 ||
      op > 3 || !x || !q || !s || (op == kSiluMul && !y) || ((op == kRms || op == kLn) && !g) ||
      ((op == kLn || op == kGelu) && !b))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (op) {
    case kRms: return (int)launch_op<kRms>(x, y, g, b, q, s, rows, d, ldx, ldy, eps, st);
    case kLn: return (int)launch_op<kLn>(x, y, g, b, q, s, rows, d, ldx, ldy, eps, st);
    case kSiluMul: return (int)launch_op<kSiluMul>(x, y, g, b, q, s, rows, d, ldx, ldy, eps, st);
    default: return (int)launch_op<kGelu>(x, y, g, b, q, s, rows, d, ldx, ldy, eps, st);
  }
}
