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
// One kernel body, templated on the op, serves the four entry points, for
// rows of bf16 or of f32 (serving with f32 activations over int8 weights,
// as the TPU kernels read any float dtype and compute in f32): the two
// differ only in the bytes a row takes in the ring and its load.
//
// What bounds it on an H100: bytes for rms, ln and silu*mul (0.036-0.38
// ms at 3.35 TB/s at the W8A8 serving prefill: 48 rows of 655 decoder
// tokens, 48 images of 729 patches), and nearly as much the issue slots of
// gelu's tanhf and silu's expf and division, which stay as PyTorch computes
// them so that h is the reference's h. The design keeps the bytes streaming
// and enough warps resident to hide that arithmetic:
// - A team of warps owns a row, its values in registers: one warp where a
//   lane holds at most 96 values (rms at 3072, ln at 1152: every reduction
//   is shuffles only, no barrier), four at gelu's 4352 (tanhf's registers:
//   34 values a lane, against 136 and two blocks an SM for one warp) and
//   silu*mul's 8192 (64), one named barrier of the team per reduction.
//   Each lane holds chunks tl, tl + 32 tw, ... of 4 values (8 bytes of
//   bf16); d % 128 == 0 gives every lane of a warp the same number (gelu's
//   team of four leaves half its lanes one chunk short).
// - A persistent grid: each team walks rows team, team + teams, ..., with
//   a two-stage shared-memory ring per team (16-byte cp.async): the next
//   row's loads are in flight while this row is reduced, quantized and
//   stored.
// - Few rows (one request's prefill: 203 to 1,043) are latency-bound: up
//   to 8 rows an SM a team of 8 warps takes a row, with a one-stage ring
//   when every team has one row (more blocks fit). The plan comes from
//   the row count and the SMs (fused_quant_plan, mirrored by
//   aki_torch/ops/fused_quant.py:row_plan).
// - h / s as RN(q0 + (h - q0 s) / s) with 1 / s correctly rounded (two FMA
//   on q0 = h * (1 / s): Markstein's correctly rounded quotient), and
//   rint, clip and the int8 cast as one FADD of 1.5 * 2^23 whose low byte
//   is the result: no division and no quarter-rate F2I per value.
//
// Plain C interface (bound with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <algorithm>

#include "cp_async.cuh"

namespace {

constexpr int kVec = 4;          // values per chunk: 8 bytes of bf16
constexpr int kMaxWidth = 8192;
constexpr int kBlockWarps = 4;   // warps per block, but for a team of 8
enum Op { kRms = 0, kLn = 1, kSiluMul = 2, kGelu = 3 };

// 4 values of a row from shared memory as f32: 8 bytes of bf16, or 16 of f32
template <bool kF32>
__device__ __forceinline__ void load4(const uint8_t* p, float (&v)[kVec]) {
  if constexpr (kF32) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    v[0] = __uint_as_float(raw.x << 16);
    v[1] = __uint_as_float(raw.x & 0xffff0000u);
    v[2] = __uint_as_float(raw.y << 16);
    v[3] = __uint_as_float(raw.y & 0xffff0000u);
  }
}

__device__ __forceinline__ void ldg4(const float* p, float (&v)[kVec]) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// A team of kTeam warps owns a row. A block of teams of more than one warp
// holds one team, which meets at named barrier 1 (an immediate: a barrier
// id in a register makes ptxas reserve all 16, and fewer blocks fit an
// SM); a warp alone needs no barrier.
template <int kTeam>
__device__ __forceinline__ void team_sync() {
  if (kTeam == 1)
    __syncwarp();
  else
    asm volatile("bar.sync 1, %0;\n" ::"n"(32 * kTeam) : "memory");
}

// Sum (or max) over the team; every thread of it gets the result: warp
// shuffles, then (teams of more than one warp) one barrier. ``red`` is this
// reduction's slot of the team, written once a row.
template <bool kMax, int kTeam>
__device__ __forceinline__ float team_reduce(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float w = __shfl_xor_sync(0xffffffffu, v, o);
    v = kMax ? fmaxf(v, w) : v + w;
  }
  if (kTeam == 1) return v;
  if ((threadIdx.x & 31) == 0) red[(threadIdx.x >> 5) % kTeam] = v;
  team_sync<kTeam>();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kTeam; ++i) r = kMax ? fmaxf(r, red[i]) : r + red[i];
  return r;
}

// clip(rint(h / sc), -127, 127) of 4 values packed as int8; rc = RN(1 / sc)
__device__ __forceinline__ uint32_t quant4(const float (&h)[kVec], float sc, float rc) {
  uint32_t b[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) {
    const float q0 = h[e] * rc;
    const float t = fmaf(fmaf(-q0, sc, h[e]), rc, q0);            // RN(h / sc)
    b[e] = __float_as_uint(fminf(fmaxf(t, -127.f), 127.f) + 12582912.f);
  }
  return __byte_perm(__byte_perm(b[0], b[1], 0x0040), __byte_perm(b[2], b[3], 0x0040), 0x5410);
}

// kMaxC: chunks of 4 values a lane holds at most; teams of kTeam warps,
// blockDim.x / (32 kTeam) to a block; team t of the grid takes rows t,
// t + n_teams, ...; a ring of ``stages`` rows a team (1 only when
// n_teams >= rows: each team has one row). x and y: rows of bf16, or of
// f32 (kF32), ldx and ldy elements apart.
template <int kOp, int kMaxC, int kTeam, bool kF32>
__global__ void __launch_bounds__(32 * kTeam * (kTeam > kBlockWarps ? 1 : kBlockWarps / kTeam))
fused_quant_kernel(const uint8_t* __restrict__ x, const uint8_t* __restrict__ y,
                   const float* __restrict__ g, const float* __restrict__ bias,
                   int8_t* __restrict__ q, float* __restrict__ s, int rows, int d, int ldx,
                   int ldy, float eps, int n_teams, int stages) {
  constexpr int kTT = 32 * kTeam;                  // threads of a team
  constexpr int kIn = kOp == kSiluMul ? 2 : 1;     // input rows (gate and up)
  constexpr int kEs = kF32 ? 4 : 2;                // bytes of a value
  constexpr int kChunk = kVec * kEs;               // bytes of a chunk
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[3][kBlockWarps][kTeam];     // per reduction of a row, team, warp
  const int tic = threadIdx.x / kTT;               // team in block
  const int tl = threadIdx.x % kTT;                // thread in team
  const int d4 = d / kVec;                         // chunks of a row
  const int row_bytes = d * kEs;
  const int stage_bytes = row_bytes * kIn;
  uint8_t* ring = smem + (size_t)tic * stages * stage_bytes;
  int row = blockIdx.x * (blockDim.x / kTT) + tic;

  // row r into stage i of the team's ring, one commit group (empty past the end)
  auto issue = [&](int r, int i) {
    if (r < rows) {
      uint8_t* stage = ring + i * stage_bytes;
      const uint8_t* src = x + (size_t)r * ldx * kEs;
      for (int c = tl; c < row_bytes / 16; c += kTT) cp_async16(stage + c * 16, src + c * 16);
      if (kOp == kSiluMul) {
        const uint8_t* up = y + (size_t)r * ldy * kEs;
        for (int c = tl; c < row_bytes / 16; c += kTT)
          cp_async16(stage + row_bytes + c * 16, up + c * 16);
      }
    }
    cp_async_commit();
  };

  issue(row, 0);
  for (int it = 0; row < rows; ++it, row += n_teams) {
    const uint8_t* stage = ring + (it & 1) * stage_bytes;
    // this row has landed for the team, and the team is done with the
    // previous row, whose stage takes the next one while this one is
    // computed
    cp_async_wait<0>();
    team_sync<kTeam>();
    issue(row + n_teams, (it + 1) & 1);

    // the elementwise prologue, straight out of shared memory
    float h[kMaxC][kVec];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int ci = tl + kTT * c;
#pragma unroll
      for (int e = 0; e < kVec; ++e) h[c][e] = 0.f;
      if (ci >= d4) continue;
      load4<kF32>(stage + ci * kChunk, h[c]);
      if (kOp == kSiluMul) {
        float u[kVec];
        load4<kF32>(stage + row_bytes + ci * kChunk, u);
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float gt = h[c][e];
          h[c][e] = gt / (1.f + expf(-gt)) * u[e];
        }
      } else if (kOp == kGelu) {
        float bb[kVec];
        ldg4(bias + ci * kVec, bb);
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
        for (int c = 0; c < kMaxC; ++c)
#pragma unroll
          for (int e = 0; e < kVec; ++e) part += h[c][e];
        mu = team_reduce<false, kTeam>(part, red[0][tic]) / (float)d;
      }
      float part = 0.f;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        if (tl + kTT * c >= d4) continue;
#pragma unroll
        for (int e = 0; e < kVec; ++e) {
          const float xc = h[c][e] - mu;
          part += xc * xc;
        }
      }
      const float r = rsqrtf(team_reduce<false, kTeam>(part, red[1][tic]) / (float)d + eps);
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) {
        const int ci = tl + kTT * c;
        if (ci >= d4) continue;
        float gg[kVec], bb[kVec];
        ldg4(g + ci * kVec, gg);
        if (kOp == kLn) ldg4(bias + ci * kVec, bb);
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
    for (int c = 0; c < kMaxC; ++c) {
      if (tl + kTT * c >= d4) continue;
#pragma unroll
      for (int e = 0; e < kVec; ++e) amax = fmaxf(amax, fabsf(h[c][e]));
    }
    amax = team_reduce<true, kTeam>(amax, red[2][tic]);
    const float sc = amax == 0.f ? 1.f : amax / 127.f;
    const float rc = __frcp_rn(sc);
    uint32_t* qr = reinterpret_cast<uint32_t*>(q + (size_t)row * d);
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      const int ci = tl + kTT * c;
      if (ci < d4) qr[ci] = quant4(h[c], sc, rc);
    }
    if (tl == 0) s[row] = sc;
  }
}

// values a lane may hold: enough for the op's registers to leave several
// blocks resident on an SM (gelu's tanhf needs the most)
constexpr int lane_values(int op) { return op == kGelu ? 36 : op == kSiluMul ? 64 : 96; }

// The warps of a row's team (aki_torch/ops/fused_quant.py:row_plan mirrors
// it): one where a lane holds the row in lane_values(op) values, else four,
// else eight; eight for few rows (up to 8 an SM: a row's latency is then
// the time), but never fewer than one chunk a lane.
int plan_team(int op, int rows, int d, int sms) {
  int team = d / 32 <= lane_values(op) ? 1 : d / 128 <= lane_values(op) ? 4 : 8;
  if (rows <= 8 * sms) team = 8;
  while (team > 1 && d / kVec < 32 * team) team = team == 8 ? 4 : 1;
  return team;
}

// ``tpb`` teams to a block of 4 warps (one team of 8); a ring of one stage
// where all blocks are resident at once and each team has one row, else
// two; blocks enough for every row but at most as many as are resident
// at once (a persistent grid).
struct Plan {
  int team, tpb, blocks, per_sm, stages;
  size_t smem;
};

template <int kOp, int kMaxC, int kTeam, bool kF32>
cudaError_t plan_op(int rows, int d, int sms, Plan* p) {
  auto kernel = fused_quant_kernel<kOp, kMaxC, kTeam, kF32>;
  // the largest dynamic shared memory set, and the last occupancy asked, so far
  static int smem_set = 0;
  static int last_threads = -1, last_per_sm = 0;
  static size_t last_smem = 0;
  p->team = kTeam;
  p->tpb = kTeam >= kBlockWarps ? 1 : kBlockWarps / kTeam;
  const int threads = p->tpb * 32 * kTeam;
  const size_t stage = (size_t)p->tpb * d * (kF32 ? 4 : 2) * (kOp == kSiluMul ? 2 : 1);
  const int blocks = (rows + p->tpb - 1) / p->tpb;
  for (p->stages = 1;; ++p->stages) {
    p->smem = p->stages * stage;
    cudaError_t e;
    if ((int)p->smem > smem_set) {
      e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p->smem);
      if (e != cudaSuccess) return e;
      smem_set = (int)p->smem;
    }
    if (threads != last_threads || p->smem != last_smem) {
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&last_per_sm, kernel, threads, p->smem);
      if (e != cudaSuccess) return e;
      last_threads = threads;
      last_smem = p->smem;
    }
    p->per_sm = last_per_sm;
    if (p->per_sm < 1) return cudaErrorInvalidConfiguration;
    if (p->stages == 2 || blocks <= sms * p->per_sm) break;
  }
  p->blocks = std::min(blocks, sms * p->per_sm);
  return cudaSuccess;
}

template <int kOp, int kMaxC, int kTeam, bool kF32>
cudaError_t launch_op(const void* x, const void* y, const void* g, const void* b, void* q,
                      void* s, int rows, int d, int ldx, int ldy, float eps, int sms,
                      cudaStream_t st, Plan* plan_only) {
  Plan p;
  cudaError_t e = plan_op<kOp, kMaxC, kTeam, kF32>(rows, d, sms, &p);
  if (e != cudaSuccess) return e;
  if (plan_only) {
    *plan_only = p;
    return cudaSuccess;
  }
  fused_quant_kernel<kOp, kMaxC, kTeam, kF32><<<p.blocks, p.tpb * 32 * kTeam, p.smem, st>>>(
      static_cast<const uint8_t*>(x), static_cast<const uint8_t*>(y),
      static_cast<const float*>(g), static_cast<const float*>(b), static_cast<int8_t*>(q),
      static_cast<float*>(s), rows, d, ldx, ldy, eps, p.blocks * p.tpb, p.stages);
  return cudaGetLastError();
}

// the team's instance, with the chunks a lane holds rounded up to one of
// the compiled counts
template <int kOp, bool kF32>
cudaError_t dispatch(const void* x, const void* y, const void* g, const void* b, void* q,
                     void* s, int rows, int d, int ldx, int ldy, float eps, cudaStream_t st,
                     Plan* plan_only) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int team = plan_team(kOp, rows, d, sms);
  const int nc = (d / kVec + 32 * team - 1) / (32 * team);
#define AKI_CASE(T, C)                                                                    \
  if (team == T && nc <= C)                                                               \
    return launch_op<kOp, C, T, kF32>(x, y, g, b, q, s, rows, d, ldx, ldy, eps, sms, st,  \
                                plan_only);
  AKI_CASE(1, 2) AKI_CASE(1, 3) AKI_CASE(1, 5) AKI_CASE(1, 9) AKI_CASE(1, 16) AKI_CASE(1, 24)
  AKI_CASE(4, 3) AKI_CASE(4, 5) AKI_CASE(4, 9) AKI_CASE(4, 16)
  AKI_CASE(8, 2) AKI_CASE(8, 3) AKI_CASE(8, 5) AKI_CASE(8, 9)
#undef AKI_CASE
  return cudaErrorInvalidValue;
}

template <bool kF32>
cudaError_t run_dtype(int op, const void* x, const void* y, const void* g, const void* b,
                      void* q, void* s, int rows, int d, int ldx, int ldy, float eps,
                      cudaStream_t st, Plan* plan_only) {
  switch (op) {
    case kRms:
      return dispatch<kRms, kF32>(x, y, g, b, q, s, rows, d, ldx, ldy, eps, st, plan_only);
    case kLn:
      return dispatch<kLn, kF32>(x, y, g, b, q, s, rows, d, ldx, ldy, eps, st, plan_only);
    case kSiluMul:
      return dispatch<kSiluMul, kF32>(x, y, g, b, q, s, rows, d, ldx, ldy, eps, st, plan_only);
    default:
      return dispatch<kGelu, kF32>(x, y, g, b, q, s, rows, d, ldx, ldy, eps, st, plan_only);
  }
}

cudaError_t run(int op, int f32, const void* x, const void* y, const void* g, const void* b,
                void* q, void* s, int rows, int d, int ldx, int ldy, float eps, cudaStream_t st,
                Plan* plan_only) {
  return f32 ? run_dtype<true>(op, x, y, g, b, q, s, rows, d, ldx, ldy, eps, st, plan_only)
             : run_dtype<false>(op, x, y, g, b, q, s, rows, d, ldx, ldy, eps, st, plan_only);
}

bool bad_width(int d) { return d <= 0 || d % 128 != 0 || d > kMaxWidth; }

}  // namespace

extern "C" const char* fused_quant_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The launch plan of op at (rows, d) of bf16 rows (f32 = 0) or f32 rows
// (f32 = 1) on the current device, as fused_quant would launch it: out =
// {warps per row, teams per block, blocks, blocks resident per SM, ring
// stages} (aki_torch/ops/fused_quant.py:row_plan mirrors the first three
// from the fourth; f32 rows take twice the ring's bytes, so fewer blocks
// may fit an SM).
extern "C" int fused_quant_plan(int op, int f32, int rows, int d, int* out) {
  if (bad_width(d) || rows <= 0 || op < 0 || op > 3 || !out) return (int)cudaErrorInvalidValue;
  Plan p;
  const cudaError_t e = run(op, f32, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, rows,
                            d, d, d, 0.f, nullptr, &p);
  if (e != cudaSuccess) return (int)e;
  out[0] = p.team;
  out[1] = p.tpb;
  out[2] = p.blocks;
  out[3] = p.per_sm;
  out[4] = p.stages;
  return 0;
}

// op: 0 rms (x, g), 1 ln (x, g, b), 2 silu*mul (x = gate, y = up), 3 gelu (x, b).
// x, y (rows, d) bf16 (f32 = 0) or f32 (f32 = 1) with unit column stride and
// row strides ldx, ldy >= d elements (16-byte multiples); g, b (d,) f32;
// q (rows, d) int8 and s (rows,) f32, contiguous. d % 128 == 0, d <= 8192;
// all pointers 16-byte aligned.
extern "C" int fused_quant(int op, int f32, const void* x, const void* y, const void* g,
                           const void* b, void* q, void* s, int rows, int d, int ldx, int ldy,
                           float eps, void* stream) {
  const int align = f32 ? 4 : 8;   // elements in 16 bytes
  if (bad_width(d) || rows < 0 || op < 0 || ldx < d || ldy < d || ldx % align != 0 ||
      ldy % align != 0 || op > 3 || !x || !q || !s || (op == kSiluMul && !y) ||
      ((op == kRms || op == kLn) && !g) || ((op == kLn || op == kGelu) && !b))
    return (int)cudaErrorInvalidValue;
  if (rows == 0) return 0;
  return (int)run(op, f32, x, y, g, b, q, s, rows, d, ldx, ldy, eps,
                  static_cast<cudaStream_t>(stream), nullptr);
}
