// Flash attention forward over int8 q/k/v under the modality-mutual (MMA)
// mask, for Hopper.
//
// Replaces the TPU kernel aki_tpu/ops/flash_mma.py:393 _kernel_1kv_q8
// (wrapper flash_mma_attention_q8, :468). The wrapper quantizes q, k and v
// per (token, head) row over the head dim (s = amax/127, q8 = round(x/s))
// and folds scale*log2(e) into q's scales; this kernel computes, per
// (b, h, query row q) with the allowed(q, k) predicate of flash_mma_fwd.cu:
//   s(q, k) = float(int32 q8[q] . k8[k]) * sq[q] * sk[k]    (that order)
//   m = max over allowed k of s;  p = exp2(s - m);  l = sum p (f32)
//   out = sum_k bf16(p * sv[k]) * v8[k] / l,   0 for a row with no allowed key
// exactly the TPU kernel's steps: the V scales fold into p, which is
// rounded to bf16 once, and l sums the unrounded p.
//
// The rounding point fixes the design. The TPU kernel held a row's whole
// KV sequence (S <= 1024) in one tile, so p * sv is rounded to bf16
// relative to the row's FINAL max. A single-pass online softmax would
// round relative to a running max and rescale afterwards: another number.
// So the block makes two passes over its KV tiles: the first computes the
// scores on the int8 tensor cores and keeps only the row max; the second
// computes them again, forms p against that max and accumulates P.V. The
// QK product is cheap in int8 (half the bytes and twice the rate of bf16),
// so the second pass costs one more read of K, from L2.
//
// Work split: one block of 4 warps per (query tile of 64 rows, head, batch
// row); each warp owns 16 query rows; KV tiles of 64 keys. A tile is
// visited only if it overlaps the causal frontier of the block's rows or an
// image's MMA rectangle (as in flash_mma_fwd.cu). The rectangles cost O(1)
// per score: each thread holds, for its two rows, the bitmask of images
// whose query span holds the row, each tile the bitmask of images whose
// text span holds each key, and a pair is in a rectangle when the two
// masks meet (flash_mma_fwd.cu uses the same test on its partial tiles).
// QK runs on mma.sync.m16n8k32 s8 x s8 -> s32 (exact, as the TPU's int8
// MXU was) over the head dim padded to 96 with zeros (72 is three k-steps
// too); V's int8 is converted to bf16 in shared memory (exact), and PV runs
// on mma.sync.m16n8k16 bf16 with f32 accumulation.
// Only H == Hkv: the wrapper routes GQA to flash_mma_fwd, as JAX does.
//
// What bounds it on an H100: at the serving admission shape (48 rows of 655
// tokens, 32 heads x 96, MMA) the function must move ~0.5 GB (int8 q, k, v,
// f32 scales, bf16 out): ~0.15 ms at 3.35 TB/s, while its int8 QK and bf16
// PV need ~0.04 ms at the tensor-core peaks, so the bytes are the bound.
// This first kernel is a simple one: synchronous 8-byte loads, mma.sync
// rather than wgmma, and K read twice.
//
// Plain C interface (bound with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per block (4 warps x 16)
constexpr int kBlockN = 64;   // keys per KV tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxImages = 16;
constexpr int kDQ = 96;           // int8 QK depth: head dim padded to 3 k-steps of 32
constexpr int kLDQ = kDQ + 16;    // bytes per shared int8 row: 28 words, conflict-free

__device__ __forceinline__ void mma_s8(int (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// One (token, head) int8 row of D bytes into a shared row of kDQ bytes,
// zero past D; 8 bytes a lane-step (D % 8 == 0, rows 8-byte aligned).
__device__ __forceinline__ void load_rows_s8(int8_t* dst, const int8_t* src, size_t stride,
                                             int first, int n_valid, int D, int tid) {
  constexpr int kChunks = kDQ / 8;
  for (int c = tid; c < kBlockM * kChunks; c += kThreads) {
    const int r = c / kChunks, d0 = (c % kChunks) * 8;
    uint2 val = make_uint2(0u, 0u);
    if (r < n_valid && d0 < D)
      val = *reinterpret_cast<const uint2*>(src + (size_t)(first + r) * stride + d0);
    *reinterpret_cast<uint2*>(dst + r * kLDQ + d0) = val;
  }
}

// DV: head dim padded to a multiple of 16 for the PV product (72 -> 80).
template <int DV>
__global__ void __launch_bounds__(kThreads)
flash_mma_q8_kernel(const int8_t* __restrict__ q8,       // (B, T, H, D)
                    const int8_t* __restrict__ k8,       // (B, S, H, D)
                    const int8_t* __restrict__ v8,       // (B, S, H, D)
                    const float* __restrict__ sq,        // (B, T, H), scale*log2e folded in
                    const float* __restrict__ sk,        // (B, S, H)
                    const float* __restrict__ sv,        // (B, S, H)
                    __nv_bfloat16* __restrict__ o,       // (B, T, H, D)
                    const int* __restrict__ kv_valid,    // (B, S) or null
                    const int* __restrict__ q_offset,    // (B,)
                    const int* __restrict__ img_start,   // (B, n_img)
                    const int* __restrict__ txt_start,
                    const int* __restrict__ txt_end,
                    int n_img, int T, int S, int H, int D, int causal) {
  constexpr int LDV = DV + 8;
  constexpr int KSTEPS = kDQ / 32;    // int8 k-steps of the QK product
  constexpr int DTILES = DV / 8;      // 8-wide output column tiles
  constexpr int NTILES = kBlockN / 8;
  constexpr int VCHUNKS = DV / 8;

  __shared__ __align__(16) int8_t Qs[kBlockM * kLDQ];
  __shared__ __align__(16) int8_t Ks[kBlockN * kLDQ];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBlockN * LDV];
  __shared__ float sk_s[kBlockN], sv_s[kBlockN];
  __shared__ int valid_s[kBlockN];
  __shared__ uint32_t key_img_s[kBlockN];   // images whose text span holds the key
  __shared__ int i0_s[kMaxImages], t0_s[kMaxImages], t1_s[kMaxImages];

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row group / column quad

  const int q_first = q_offset[b] + q0;
  const int q_last = q_offset[b] + min(q0 + kBlockM, T) - 1;
  const size_t row_stride = (size_t)H * D;   // between tokens, q and kv alike

  if (tid < n_img) {
    i0_s[tid] = img_start[b * n_img + tid];
    t0_s[tid] = txt_start[b * n_img + tid];
    t1_s[tid] = txt_end[b * n_img + tid];
  }
  load_rows_s8(Qs, q8 + (size_t)b * T * row_stride + (size_t)h * D, row_stride, q0,
               min(kBlockM, T - q0), D, tid);
  __syncthreads();

  // this warp's 16 query rows as s8 A fragments: the byte layout of the
  // bf16 m16n8k16 fragments, four int8 to a register
  const int rw = warp * 16;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int8_t* p = Qs + (rw + g) * kLDQ + kk * 32 + 4 * t4;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLDQ);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 16);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLDQ + 16);
  }
  const int row_abs[2] = {q_first + rw + g, q_first + rw + g + 8};
  float sq_r[2];
  uint32_t row_img[2] = {0u, 0u};   // images whose query span holds the row
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rw + g + 8 * r;
    sq_r[r] = row < T ? sq[((size_t)b * T + row) * H + h] : 0.f;
    for (int n = 0; n < n_img; ++n)
      if (row_abs[r] >= i0_s[n] && row_abs[r] < t0_s[n]) row_img[r] |= 1u << n;
  }

  const int8_t* kb = k8 + (size_t)b * S * row_stride + (size_t)h * D;
  const int8_t* vb = v8 + (size_t)b * S * row_stride + (size_t)h * D;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;

  // Scores of one visited tile, masked to -inf: the tile's K rows, key
  // scales and validity must be in shared memory.
  auto scores = [&](int k0, float (&s)[NTILES][4]) {
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      int acc[4] = {0, 0, 0, 0};
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const int8_t* p = Ks + (nt * 8 + g) * kLDQ + kk * 32 + 4 * t4;
        mma_s8(acc, qf[kk], *reinterpret_cast<const uint32_t*>(p),
               *reinterpret_cast<const uint32_t*>(p + 16));
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kc = nt * 8 + 2 * t4 + (e & 1);
        const bool ok = valid_s[kc] != 0 &&
                        (!causal || k0 + kc <= row_abs[r] || (row_img[r] & key_img_s[kc]) != 0);
        s[nt][e] = ok ? static_cast<float>(acc[e]) * sq_r[r] * sk_s[kc] : -INFINITY;
      }
    }
  };
  auto visit = [&](int k0) {
    bool vis = !causal || k0 <= q_last;
    for (int n = 0; n < n_img && !vis; ++n)
      vis = q_first < t0_s[n] && q_last >= i0_s[n] && k0 < t1_s[n] && k0 + kBlockN > t0_s[n];
    return vis;
  };
  // K rows, key scales (and V scales), validity and image bits of the tile at k0
  auto load_k = [&](int k0, bool with_v) {
    load_rows_s8(Ks, kb, row_stride, k0, min(kBlockN, S - k0), D, tid);
    if (tid < kBlockN) {
      const int key = k0 + tid;
      const bool in = key < S;
      valid_s[tid] = in && (kv_valid == nullptr || kv_valid[(size_t)b * S + key] != 0);
      uint32_t bits = 0u;
      for (int n = 0; n < n_img; ++n)
        if (key >= t0_s[n] && key < t1_s[n]) bits |= 1u << n;
      key_img_s[tid] = bits;
      sk_s[tid] = in ? sk[((size_t)b * S + key) * H + h] : 0.f;
      if (with_v) sv_s[tid] = in ? sv[((size_t)b * S + key) * H + h] : 0.f;
    }
  };

  // pass 1: the row max over every allowed key
  float m_row[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    if (!visit(k0)) continue;
    __syncthreads();   // every warp is done with the previous tile
    load_k(k0, false);
    __syncthreads();
    float s[NTILES][4];
    scores(k0, s);
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      m_row[0] = fmaxf(m_row[0], fmaxf(s[nt][0], s[nt][1]));
      m_row[1] = fmaxf(m_row[1], fmaxf(s[nt][2], s[nt][3]));
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

  // pass 2: p against the final max, l in f32, bf16(p * sv) . V
  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float l_row[2] = {0.f, 0.f};
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    if (!visit(k0)) continue;
    __syncthreads();
    load_k(k0, true);
    // V's int8 as bf16 (exact), zero past D and past S
    for (int c = tid; c < kBlockN * VCHUNKS; c += kThreads) {
      const int r = c / VCHUNKS, d0 = (c % VCHUNKS) * 8;
      uint2 raw = make_uint2(0u, 0u);
      if (k0 + r < S && d0 < D)
        raw = *reinterpret_cast<const uint2*>(vb + (size_t)(k0 + r) * row_stride + d0);
      const int8_t* x = reinterpret_cast<const int8_t*>(&raw);
      uint4 out;
      out.x = pack_bf16(x[0], x[1]);
      out.y = pack_bf16(x[2], x[3]);
      out.z = pack_bf16(x[4], x[5]);
      out.w = pack_bf16(x[6], x[7]);
      *reinterpret_cast<uint4*>(Vs + r * LDV + d0) = out;
    }
    __syncthreads();

    float s[NTILES][4];
    scores(k0, s);
    uint32_t pf[kBlockN / 16][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      const int kc = nt * 8 + 2 * t4;
      const float p0 = exp2f(s[nt][0] - m_use[0]);
      const float p1 = exp2f(s[nt][1] - m_use[0]);
      const float p2 = exp2f(s[nt][2] - m_use[1]);
      const float p3 = exp2f(s[nt][3] - m_use[1]);
      l_row[0] += p0 + p1;
      l_row[1] += p2 + p3;
      const float v0 = sv_s[kc], v1 = sv_s[kc + 1];
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      pf[kk][hi] = pack_bf16(p0 * v0, p1 * v1);
      pf[kk][hi + 1] = pack_bf16(p2 * v0, p3 * v1);
    }
    // O += bf16(P * sv) V: B fragments gather two keys of one column
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const __nv_bfloat16* p = Vs + (kk * 16 + 2 * t4) * LDV + g;
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const __nv_bfloat16* pc = p + dt * 8;
        mma_bf16(acc[dt], pf[kk], pack_raw(pc[0], pc[LDV]), pack_raw(pc[8 * LDV], pc[9 * LDV]));
      }
    }
  }

  // out = acc / l; a row with no allowed key writes 0
  __nv_bfloat16* ob = o + (size_t)b * T * row_stride + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float l = l_row[r];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = q0 + rw + g + 8 * r;
    if (row >= T) continue;
    const bool live = m_row[r] != -INFINITY;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int d = dt * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * row_stride + d) =
            __floats2bfloat162_rn(live ? acc[dt][2 * r] / l : 0.f,
                                  live ? acc[dt][2 * r + 1] / l : 0.f);
    }
  }
}

template <int DV>
int launch(const void* q8, const void* k8, const void* v8, const void* sq, const void* sk,
           const void* sv, void* o, const void* kv_valid, const void* q_offset,
           const void* img_start, const void* txt_start, const void* txt_end, int n_img,
           int B, int T, int S, int H, int D, int causal, cudaStream_t stream) {
  dim3 grid((T + kBlockM - 1) / kBlockM, H, B);
  flash_mma_q8_kernel<DV><<<grid, kThreads, 0, stream>>>(
      static_cast<const int8_t*>(q8), static_cast<const int8_t*>(k8),
      static_cast<const int8_t*>(v8), static_cast<const float*>(sq),
      static_cast<const float*>(sk), static_cast<const float*>(sv),
      static_cast<__nv_bfloat16*>(o), static_cast<const int*>(kv_valid),
      static_cast<const int*>(q_offset), static_cast<const int*>(img_start),
      static_cast<const int*>(txt_start), static_cast<const int*>(txt_end), n_img, T, S, H,
      D, causal);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* flash_mma_q8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q8 (B,T,H,D), k8/v8 (B,S,H,D) contiguous int8, D % 8 == 0, 72 <= D <= 96;
// sq (B,T,H), sk/sv (B,S,H) contiguous f32 (sq with scale*log2(e) folded
// in); o (B,T,H,D) bf16. kv_valid (B,S) int32 or null; q_offset (B,)
// int32; img_start/txt_start/txt_end (B,n_img) int32, n_img <= kMaxImages.
extern "C" int flash_mma_q8(const void* q8, const void* k8, const void* v8, const void* sq,
                            const void* sk, const void* sv, void* o, const void* kv_valid,
                            const void* q_offset, const void* img_start,
                            const void* txt_start, const void* txt_end, int n_img, int B,
                            int T, int S, int H, int D, int causal, void* stream) {
  if (D % 8 != 0 || D < 72 || D > kDQ || H <= 0 || n_img < 0 || n_img > kMaxImages ||
      B <= 0 || T <= 0 || S <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch ((D + 15) / 16 * 16) {
#define AKI_CASE(DV)                                                                    \
  case DV:                                                                              \
    return launch<DV>(q8, k8, v8, sq, sk, sv, o, kv_valid, q_offset, img_start, txt_start, \
                      txt_end, n_img, B, T, S, H, D, causal, st);
    AKI_CASE(80) AKI_CASE(96)
#undef AKI_CASE
  }
  return (int)cudaErrorInvalidValue;
}
