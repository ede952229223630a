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
// P is rounded to bf16 before the PV product (as the TPU kernel does), the
// row sum is kept in f32, and a row with no allowed key writes 0.
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
// Work split: one block of 4 warps per (query tile of 64 rows, head, batch
// row); each warp owns 16 query rows. The block walks KV tiles of 64 keys
// with an online softmax (running max, running sum, f32 accumulator in
// registers). A tile is visited only if it overlaps the causal frontier of
// the block's rows or one image's MMA rectangle (the semantics of
// flash_mma.py:110-127); in non-causal mode every tile up to S is visited.
// Decoder prefill attends over the whole max_len cache layer, so the skip
// keeps the empty cache slots from being read at all.
//
// Products are bf16 mma.sync.m16n8k16 with f32 accumulation; the head dim
// is padded in shared memory to a multiple of 16 (72 -> 80) with zeros.
// GQA: the KV head of query head h is h / (H / Hkv).
//
// What bounds it on an H100: at the main path's shapes (SigLIP 729 tokens x
// 16 heads x 72, decoder prefill ~200-1100 tokens x 32 heads x 96) the work
// the mask allows is 0.36-8.3 GFLOP over 5-26 MB, a few microseconds at the
// H100 SXM's data-sheet peaks (989 TFLOP/s bf16, 3.35 TB/s, at 700 W), so
// neither the tensor cores nor HBM is the limit: the kernel is bound by
// latency and issue rate — mma.sync instead of wgmma, synchronous tile
// loads with no copy/compute overlap, a per-element mask on every tile, and
// 64-row tiles that give only ~100-550 blocks. The design keeps the score
// matrix and the mask out of device memory and skips masked-out tiles;
// cp.async/TMA pipelining, ldmatrix and wgmma are the next steps.
// The flat instance (width 128) at the serving admission shape (48 rows of
// 655 tokens, 32 heads) must move ~1 GB, pad lanes included: ~0.3 ms at
// 3.35 TB/s, so there the bytes are the bound; its 64-register f32
// accumulator and 52.7 KB of shared memory (set above the 48 KB default at
// launch) cost occupancy, not correctness.
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

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one register of two bf16; the first lands in the low half
// (the lower column index of an mma fragment).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

template <int DP>
constexpr int smem_bytes() {
  return (kBlockM + 2 * kBlockN) * (DP + 8) * 2 + kBlockN * 4 + 3 * kMaxImages * 4;
}

// DP: head dim padded to a multiple of 16. Shared rows are DP + 8 wide so
// that the 32-bit fragment loads of a warp fall on distinct banks.
template <int DP>
__global__ void __launch_bounds__(kThreads)
flash_mma_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse,            // (B, H, T) or null
                     const int* __restrict__ kv_valid,   // (B, S) or null
                     const int* __restrict__ q_offset,   // (B,)
                     const int* __restrict__ img_start,  // (B, n_img)
                     const int* __restrict__ txt_start,
                     const int* __restrict__ txt_end,
                     int n_img, int T, int S, int H, int Hkv, int D,
                     int causal, float scale_log2) {
  constexpr int LD = DP + 8;
  constexpr int KSTEPS = DP / 16;   // k-steps of the QK^T product
  constexpr int DTILES = DP / 8;    // 8-wide output column tiles
  constexpr int NTILES = kBlockN / 8;
  constexpr int CHUNKS = DP / 8;    // 16-byte chunks per shared row

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Ks = Qs + kBlockM * LD;
  __nv_bfloat16* Vs = Ks + kBlockN * LD;
  int* valid_s = reinterpret_cast<int*>(Vs + kBlockN * LD);
  int* i0_s = valid_s + kBlockN;
  int* t0_s = i0_s + kMaxImages;
  int* t1_s = t0_s + kMaxImages;

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;   // mma fragment row group / column pair

  const int q_first = q_offset[b] + q0;                 // absolute position of row 0
  const int q_last = q_offset[b] + min(q0 + kBlockM, T) - 1;
  const size_t q_stride = (size_t)H * D;                // between query rows
  const size_t kv_stride = (size_t)Hkv * D;             // between key rows

  if (tid < n_img) {
    i0_s[tid] = img_start[b * n_img + tid];
    t0_s[tid] = txt_start[b * n_img + tid];
    t1_s[tid] = txt_end[b * n_img + tid];
  }
  // Q tile, zero-filled past T and past D
  const __nv_bfloat16* qb = q + ((size_t)b * T) * q_stride + (size_t)h * D;
  for (int c = tid; c < kBlockM * CHUNKS; c += kThreads) {
    const int r = c / CHUNKS, d0 = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (q0 + r < T && d0 < D)
      val = *reinterpret_cast<const uint4*>(qb + (size_t)(q0 + r) * q_stride + d0);
    *reinterpret_cast<uint4*>(Qs + r * LD + d0) = val;
  }
  __syncthreads();

  // this warp's 16 query rows as mma A fragments, kept in registers
  const int rw = warp * 16;
  uint32_t qf[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const __nv_bfloat16* p = Qs + (rw + g) * LD + kk * 16 + 2 * t4;
    qf[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    qf[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    qf[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    qf[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  // rows g and g + 8 of the warp's 16
  float m_run[2] = {-INFINITY, -INFINITY};
  float l_run[2] = {0.f, 0.f};
  const int row_abs[2] = {q_first + rw + g, q_first + rw + g + 8};

  const __nv_bfloat16* kb = k + ((size_t)b * S) * kv_stride + (size_t)hk * D;
  const __nv_bfloat16* vb = v + ((size_t)b * S) * kv_stride + (size_t)hk * D;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    // block-uniform tile relevance: causal frontier or an MMA rectangle
    bool visit = !causal || k0 <= q_last;
    for (int n = 0; n < n_img && !visit; ++n)
      visit = q_first < t0_s[n] && q_last >= i0_s[n] &&
              k0 < t1_s[n] && k0 + kBlockN > t0_s[n];
    if (!visit) continue;

    __syncthreads();   // every warp is done with the previous tile
    for (int c = tid; c < kBlockN * CHUNKS; c += kThreads) {
      const int r = c / CHUNKS, d0 = (c % CHUNKS) * 8;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = kv4;
      if (k0 + r < S && d0 < D) {
        kv4 = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + r) * kv_stride + d0);
        vv4 = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + r) * kv_stride + d0);
      }
      *reinterpret_cast<uint4*>(Ks + r * LD + d0) = kv4;
      *reinterpret_cast<uint4*>(Vs + r * LD + d0) = vv4;
    }
    if (tid < kBlockN) {
      const int key = k0 + tid;
      valid_s[tid] = key < S && (kv_valid == nullptr || kv_valid[(size_t)b * S + key] != 0);
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NTILES][4];
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        const __nv_bfloat16* p = Ks + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
        mma_16816(s[nt], qf[kk], *reinterpret_cast<const uint32_t*>(p),
                  *reinterpret_cast<const uint32_t*>(p + 8));
      }
    }

    // scale into base 2, mask, row max over the quad that shares a row
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        const int kc = nt * 8 + 2 * t4 + (e & 1);
        const int key = k0 + kc;
        bool ok = valid_s[kc] != 0;
        if (ok && causal && key > row_abs[r]) {
          bool mma = false;
          for (int n = 0; n < n_img; ++n)
            mma |= row_abs[r] >= i0_s[n] && row_abs[r] < t0_s[n] &&
                   key >= t0_s[n] && key < t1_s[n];
          ok = mma;
        }
        const float x = ok ? s[nt][e] * scale_log2 : -INFINITY;
        s[nt][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m_run[r], mx[r]);
      // a row with nothing allowed yet keeps p == 0 and acc == 0
      m_use[r] = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = exp2f(m_run[r] - m_use[r]);
      m_run[r] = m_new;
    }

    // P = exp2(S - m) as bf16 A fragments; the row sum stays f32
    uint32_t pf[kBlockN / 16][4];
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < NTILES; ++nt) {
      const float p0 = exp2f(s[nt][0] - m_use[0]);
      const float p1 = exp2f(s[nt][1] - m_use[0]);
      const float p2 = exp2f(s[nt][2] - m_use[1]);
      const float p3 = exp2f(s[nt][3] - m_use[1]);
      rs[0] += p0 + p1;
      rs[1] += p2 + p3;
      const int kk = nt >> 1, hi = (nt & 1) * 2;
      pf[kk][hi] = pack_bf16(p0, p1);
      pf[kk][hi + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
      rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
      l_run[r] = l_run[r] * alpha[r] + rs[r];
    }
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: B fragments gather two keys of one head-dim column
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const __nv_bfloat16* p = Vs + (kk * 16 + 2 * t4) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DTILES; ++dt) {
        const __nv_bfloat16* pc = p + dt * 8;
        const uint32_t b0 = pack_raw(pc[0], pc[LD]);
        const uint32_t b1 = pack_raw(pc[8 * LD], pc[9 * LD]);
        mma_16816(acc[dt], pf[kk], b0, b1);
      }
    }
  }

  // out = acc / l; a row with no allowed key writes 0
  __nv_bfloat16* ob = o + ((size_t)b * T) * q_stride + (size_t)h * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rw + g + 8 * r;
    if (row >= T) continue;
    const float inv = l_run[r] > 0.f ? 1.f / l_run[r] : 0.f;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int d = dt * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(ob + (size_t)row * q_stride + d) =
            __floats2bfloat162_rn(acc[dt][2 * r] * inv, acc[dt][2 * r + 1] * inv);
    }
    // the four threads of a quad hold the same row stats
    if (lse != nullptr && t4 == 0)
      lse[((size_t)b * H + h) * T + row] =
          l_run[r] > 0.f ? m_run[r] + log2f(l_run[r]) : INFINITY;
  }
}

template <int DP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* kv_valid, const void* q_offset, const void* img_start,
           const void* txt_start, const void* txt_end, int n_img, int B, int T,
           int S, int H, int Hkv, int D, int causal, float scale_log2,
           cudaStream_t stream) {
  constexpr int smem = smem_bytes<DP>();
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_mma_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((T + kBlockM - 1) / kBlockM, H, B);
  flash_mma_fwd_kernel<DP><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(kv_valid),
      static_cast<const int*>(q_offset),
      static_cast<const int*>(img_start), static_cast<const int*>(txt_start),
      static_cast<const int*>(txt_end), n_img, T, S, H, Hkv, D, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* flash_mma_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q (B,T,H,D), k/v (B,S,Hkv,D), o (B,T,H,D): contiguous bf16, D % 8 == 0,
// D in 72..96 (padded to 80 or 96: SigLIP's 72, Phi-3's 96), H % Hkv == 0. kv_valid (B,S) int32 or null; q_offset (B,) int32;
// img_start/txt_start/txt_end (B,n_img) int32, n_img <= kMaxImages.
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
