// Flash attention backward under the modality-mutual (MMA) mask, for Hopper.
//
// Replaces the three TPU kernels of aki_tpu/ops/flash_mma_bwd.py:
//   _lse_kernel (line 68):  the row logsumexp, a second pass over K on the
//                           TPU; here the forward kernel writes it
//                           (csrc/flash_mma_fwd.cu, its optional lse output);
//   _dq_kernel  (line 111): dq, one block per query tile -> flash_mma_dq_kernel;
//   _dkv_kernel (line 157): dk and dv, one block per key tile ->
//                           flash_mma_dkv_kernel.
//
// What it computes, per (b, h) with the forward's mask allowed(q, k) (see
// flash_mma_fwd.cu) and lse in base 2 of the scaled scores:
//   x     = scale*log2(e) * q.k            (f32 from bf16 products)
//   p     = allowed ? exp2(x - lse[q]) : 0 (f32; +inf lse of an empty row -> 0)
//   dp    = dO.v                           (f32)
//   ds    = p * (dp - delta[q]) * scale    (f32; delta = rowsum(dO*O), given)
//   dv[k] += bf16(p)  * dO[q]     dq[q] += bf16(ds) * k[k]
//   dk[k] += bf16(ds) * q[q]
// p and ds are rounded to bf16 before their products, every sum is f32, and
// dq, dk, dv are written in bf16: the rounding points of the TPU kernels.
//
// Work split. flash_mma_dq_kernel: one block of 4 warps per (64 query rows,
// head, batch row), Q and dO kept as mma A fragments in registers, a loop
// over 64-key tiles with the forward's tile skip (a tile is visited only if
// it overlaps the causal frontier of the block's rows or an image's MMA
// rectangle). flash_mma_dkv_kernel: one block per (64 keys, KV head, batch
// row); it loops over the query heads of its GQA group and over every q
// tile, visiting a (q tile, key tile) pair under the same predicate as dq
// and the forward, so a pair is either visited by all three or skipped by
// all three. The group sum of dk and dv happens in the block's f32
// registers: no K/V is repeated, no sum runs afterwards and no atomics are
// used, so the result is deterministic.
//
// Transposed products. dkv computes S^T = K Q^T and dP^T = V dO^T with the
// block's keys as the mma's M dimension, so that P^T and dS^T come out of
// the accumulators already in the A-fragment layout of dV += P^T dO and
// dK += dS^T Q; the B operand of those two products (queries along k) is
// gathered from shared memory two 16-bit values at a time, the forward's
// PV pattern. No ldmatrix.trans and no staged transpose is needed.
//
// What bounds it on an H100: at the training shape (2 x 655 tokens, 32
// heads of 96, MMA mask) the five products need 14.8 GFLOP under the mask,
// 15 us at the H100 SXM's 989 TFLOP/s bf16 peak (700 W), and the function
// moves 63 MB, 19 us at 3.35 TB/s (both counted by chip_smoke.py
// backward_work): on paper nearly balanced, bytes first. In practice it is
// bound by latency and instruction throughput, like the forward: mma.sync instead of
// wgmma, synchronous tile loads with no copy/compute overlap, scalar 16-bit
// B-fragment gathers, and a per-element mask. The design keeps P, dP and
// dS out of device memory (the score matrices never exist outside
// registers) and skips masked-out tiles; cp.async/TMA pipelining, ldmatrix
// and wgmma are the next steps.
//
// Head widths 72 and 96, padded with zeros in shared memory to 80 and 96
// exactly as the forward pads them. Plain C interface (bound with ctypes);
// launches on the caller's stream, never synchronises, allocates nothing,
// and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 64;   // query rows per dq block / per dkv q tile
constexpr int kBlockN = 64;   // keys per dq KV tile / per dkv block
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxImages = 16;
constexpr int kNTiles = 8;    // 8-wide column tiles of a 16 x 64 product

__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// 64 rows x DP of a (rows, stride) bf16 matrix into shared memory with row
// pitch DP + 8; rows at or past `limit` and columns at or past D are 0.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int row0, int limit, int D) {
  constexpr int LD = DP + 8, CHUNKS = DP / 8;
  for (int c = threadIdx.x; c < 64 * CHUNKS; c += kThreads) {
    const int r = c / CHUNKS, d0 = (c % CHUNKS) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit && d0 < D)
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * stride + d0);
    *reinterpret_cast<uint4*>(dst + r * LD + d0) = val;
  }
}

// A fragments of the 16 rows [rw, rw + 16) of a shared tile, all of DP.
template <int DP>
__device__ __forceinline__ void load_a(uint32_t (&f)[DP / 16][4],
                                       const __nv_bfloat16* tile, int rw, int g, int t4) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const __nv_bfloat16* p = tile + (rw + g) * LD + kk * 16 + 2 * t4;
    f[kk][0] = *reinterpret_cast<const uint32_t*>(p);
    f[kk][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LD);
    f[kk][2] = *reinterpret_cast<const uint32_t*>(p + 8);
    f[kk][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LD + 8);
  }
}

// c (16 x 64) = a (16 x DP) . tile^T, tile = 64 shared rows of DP.
template <int DP>
__device__ __forceinline__ void mma_abt(float (&c)[kNTiles][4], const uint32_t (&a)[DP / 16][4],
                                        const __nv_bfloat16* tile, int g, int t4) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    c[nt][0] = c[nt][1] = c[nt][2] = c[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DP / 16; ++kk) {
      const __nv_bfloat16* p = tile + (nt * 8 + g) * LD + kk * 16 + 2 * t4;
      mma_16816(c[nt], a[kk], *reinterpret_cast<const uint32_t*>(p),
                *reinterpret_cast<const uint32_t*>(p + 8));
    }
  }
}

// acc (16 x DP) += a (16 x 64, bf16 A fragments) . tile, tile = 64 shared
// rows (the k dimension) of DP; B fragments gather two rows of one column.
template <int DP>
__device__ __forceinline__ void mma_ab(float (&acc)[DP / 8][4], const uint32_t (&a)[4][4],
                                       const __nv_bfloat16* tile, int g, int t4) {
  constexpr int LD = DP + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const __nv_bfloat16* p = tile + (kk * 16 + 2 * t4) * LD + g;
#pragma unroll
    for (int dt = 0; dt < DP / 8; ++dt) {
      const __nv_bfloat16* pc = p + dt * 8;
      mma_16816(acc[dt], a[kk], pack_raw(pc[0], pc[LD]), pack_raw(pc[8 * LD], pc[9 * LD]));
    }
  }
}

// f32 accumulators of a 16 x 64 product -> bf16 A fragments over its 64 columns.
__device__ __forceinline__ void to_a(uint32_t (&f)[4][4], const float (&c)[kNTiles][4]) {
#pragma unroll
  for (int nt = 0; nt < kNTiles; ++nt) {
    const int kk = nt >> 1, hi = (nt & 1) * 2;
    f[kk][hi] = pack_bf16(c[nt][0], c[nt][1]);
    f[kk][hi + 1] = pack_bf16(c[nt][2], c[nt][3]);
  }
}

// The forward's per-element rule, key validity aside.
__device__ __forceinline__ bool pair_allowed(int q_abs, int key, int causal, int n_img,
                                             const int* i0, const int* t0, const int* t1) {
  if (!causal || key <= q_abs) return true;
  bool mma = false;
  for (int n = 0; n < n_img; ++n)
    mma |= q_abs >= i0[n] && q_abs < t0[n] && key >= t0[n] && key < t1[n];
  return mma;
}

// The forward's tile rule: may any row of [q_first, q_last] attend any key
// of [k0, k0 + 64)?
__device__ __forceinline__ bool tile_visited(int q_first, int q_last, int k0, int causal,
                                             int n_img, const int* i0, const int* t0,
                                             const int* t1) {
  if (!causal || k0 <= q_last) return true;
  for (int n = 0; n < n_img; ++n)
    if (q_first < t0[n] && q_last >= i0[n] && k0 < t1[n] && k0 + kBlockN > t0[n]) return true;
  return false;
}

template <int DP>
constexpr int dq_smem_bytes() {   // one Q/dO staging tile, K, V; key validity; images
  return 3 * 64 * (DP + 8) * 2 + kBlockN * 4 + 3 * kMaxImages * 4;
}

template <int DP>
constexpr int dkv_smem_bytes() {  // K, V, Q, dO tiles; lse, delta, key validity; images
  return 4 * 64 * (DP + 8) * 2 + 3 * 64 * 4 + 3 * kMaxImages * 4;
}

struct Args {
  const __nv_bfloat16 *q, *k, *v, *dout;
  const float *lse, *delta;                    // (B, H, T)
  __nv_bfloat16 *dq, *dk, *dv;
  const int *kv_valid, *q_offset, *img_start, *txt_start, *txt_end;
  int n_img, T, S, H, Hkv, D, causal;
  float scale_log2, scale;
};

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_mma_dq_kernel(Args a) {
  constexpr int LD = DP + 8;
  constexpr int DTILES = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ts = reinterpret_cast<__nv_bfloat16*>(smem_raw);   // Q, then dO
  __nv_bfloat16* Ks = Ts + 64 * LD;
  __nv_bfloat16* Vs = Ks + 64 * LD;
  int* valid_s = reinterpret_cast<int*>(Vs + 64 * LD);
  int* i0_s = valid_s + kBlockN;
  int* t0_s = i0_s + kMaxImages;
  int* t1_s = t0_s + kMaxImages;

  const int q0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, rw = warp * 16;
  const int T = a.T, S = a.S, D = a.D;
  const size_t q_stride = (size_t)a.H * D, kv_stride = (size_t)a.Hkv * D;
  const int q_first = a.q_offset[b] + q0;
  const int q_last = a.q_offset[b] + min(q0 + kBlockM, T) - 1;

  if (tid < a.n_img) {
    i0_s[tid] = a.img_start[b * a.n_img + tid];
    t0_s[tid] = a.txt_start[b * a.n_img + tid];
    t1_s[tid] = a.txt_end[b * a.n_img + tid];
  }
  const size_t qbase = (size_t)b * T * q_stride + (size_t)h * D;
  uint32_t qf[DP / 16][4], df[DP / 16][4];
  load_tile<DP>(Ts, a.q + qbase, q_stride, q0, T, D);
  __syncthreads();
  load_a<DP>(qf, Ts, rw, g, t4);
  __syncthreads();
  load_tile<DP>(Ts, a.dout + qbase, q_stride, q0, T, D);
  __syncthreads();
  load_a<DP>(df, Ts, rw, g, t4);

  // rows g and g + 8 of the warp's 16; rows past T get p = 0 through +inf
  int row_abs[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rw + g + 8 * r;
    row_abs[r] = q_first + rw + g + 8 * r;
    const size_t idx = ((size_t)b * a.H + h) * T + row;
    lse_r[r] = row < T ? a.lse[idx] : INFINITY;
    delta_r[r] = row < T ? a.delta[idx] : 0.f;
  }

  float acc[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  const __nv_bfloat16* kb = a.k + (size_t)b * S * kv_stride + (size_t)hk * D;
  const __nv_bfloat16* vb = a.v + (size_t)b * S * kv_stride + (size_t)hk * D;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    if (!tile_visited(q_first, q_last, k0, a.causal, a.n_img, i0_s, t0_s, t1_s)) continue;
    __syncthreads();   // every warp is done with the previous tile
    load_tile<DP>(Ks, kb, kv_stride, k0, S, D);
    load_tile<DP>(Vs, vb, kv_stride, k0, S, D);
    if (tid < kBlockN) {
      const int key = k0 + tid;
      valid_s[tid] = key < S && (a.kv_valid == nullptr || a.kv_valid[(size_t)b * S + key] != 0);
    }
    __syncthreads();

    float s[kNTiles][4], dp[kNTiles][4];
    mma_abt<DP>(s, qf, Ks, g, t4);    // S  = Q K^T
    mma_abt<DP>(dp, df, Vs, g, t4);   // dP = dO V^T
#pragma unroll
    for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kc = nt * 8 + 2 * t4 + (e & 1);
        const bool ok = valid_s[kc] != 0 &&
                        pair_allowed(row_abs[r], k0 + kc, a.causal, a.n_img, i0_s, t0_s, t1_s);
        const float p = ok ? exp2f(s[nt][e] * a.scale_log2 - lse_r[r]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - delta_r[r]) * a.scale;   // dS
      }
    }
    uint32_t dsf[4][4];
    to_a(dsf, s);
    mma_ab<DP>(acc, dsf, Ks, g, t4);  // dQ += bf16(dS) K
  }

  __nv_bfloat16* dqb = a.dq + qbase;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + rw + g + 8 * r;
    if (row >= T) continue;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int d = dt * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(dqb + (size_t)row * q_stride + d) =
            __floats2bfloat162_rn(acc[dt][2 * r], acc[dt][2 * r + 1]);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) flash_mma_dkv_kernel(Args a) {
  constexpr int LD = DP + 8;
  constexpr int DTILES = DP / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* Vs = Ks + 64 * LD;
  __nv_bfloat16* Qs = Vs + 64 * LD;
  __nv_bfloat16* Ds = Qs + 64 * LD;   // dO
  float* lse_s = reinterpret_cast<float*>(Ds + 64 * LD);
  float* delta_s = lse_s + kBlockM;
  int* valid_s = reinterpret_cast<int*>(delta_s + kBlockM);
  int* i0_s = valid_s + kBlockN;
  int* t0_s = i0_s + kMaxImages;
  int* t1_s = t0_s + kMaxImages;

  const int k0 = blockIdx.x * kBlockN, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.Hkv;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3, kw = warp * 16;
  const int T = a.T, S = a.S, D = a.D;
  const size_t q_stride = (size_t)a.H * D, kv_stride = (size_t)a.Hkv * D;
  const int qoff = a.q_offset[b];

  if (tid < a.n_img) {
    i0_s[tid] = a.img_start[b * a.n_img + tid];
    t0_s[tid] = a.txt_start[b * a.n_img + tid];
    t1_s[tid] = a.txt_end[b * a.n_img + tid];
  }
  const size_t kvbase = (size_t)b * S * kv_stride + (size_t)hk * D;
  load_tile<DP>(Ks, a.k + kvbase, kv_stride, k0, S, D);
  load_tile<DP>(Vs, a.v + kvbase, kv_stride, k0, S, D);
  if (tid < kBlockN) {
    const int key = k0 + tid;
    valid_s[tid] = key < S && (a.kv_valid == nullptr || a.kv_valid[(size_t)b * S + key] != 0);
  }
  __syncthreads();
  // keys g and g + 8 of the warp's 16
  const int key[2] = {k0 + kw + g, k0 + kw + g + 8};
  const bool key_ok[2] = {valid_s[kw + g] != 0, valid_s[kw + g + 8] != 0};

  float dk[DTILES][4], dv[DTILES][4];
#pragma unroll
  for (int i = 0; i < DTILES; ++i) {
    dk[i][0] = dk[i][1] = dk[i][2] = dk[i][3] = 0.f;
    dv[i][0] = dv[i][1] = dv[i][2] = dv[i][3] = 0.f;
  }

  const int n_qt = (T + kBlockM - 1) / kBlockM;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    const size_t qbase = (size_t)b * T * q_stride + (size_t)h * D;
    const float* lse_h = a.lse + ((size_t)b * a.H + h) * T;
    const float* delta_h = a.delta + ((size_t)b * a.H + h) * T;
    for (int qi = 0; qi < n_qt; ++qi) {
      const int q0 = qi * kBlockM;
      const int q_first = qoff + q0, q_last = qoff + min(q0 + kBlockM, T) - 1;
      if (!tile_visited(q_first, q_last, k0, a.causal, a.n_img, i0_s, t0_s, t1_s)) continue;
      __syncthreads();   // every warp is done with the previous q tile
      load_tile<DP>(Qs, a.q + qbase, q_stride, q0, T, D);
      load_tile<DP>(Ds, a.dout + qbase, q_stride, q0, T, D);
      if (tid < kBlockM) {
        const int row = q0 + tid;
        lse_s[tid] = row < T ? lse_h[row] : INFINITY;
        delta_s[tid] = row < T ? delta_h[row] : 0.f;
      }
      __syncthreads();

      float s[kNTiles][4], dp[kNTiles][4];
      {
        uint32_t af[DP / 16][4];
        load_a<DP>(af, Ks, kw, g, t4);
        mma_abt<DP>(s, af, Qs, g, t4);    // S^T  = K Q^T
        load_a<DP>(af, Vs, kw, g, t4);
        mma_abt<DP>(dp, af, Ds, g, t4);   // dP^T = V dO^T
      }
#pragma unroll
      for (int nt = 0; nt < kNTiles; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1, qc = nt * 8 + 2 * t4 + (e & 1);
          const bool ok = key_ok[r] && q0 + qc < T &&
                          pair_allowed(q_first + qc, key[r], a.causal, a.n_img, i0_s, t0_s, t1_s);
          const float p = ok ? exp2f(s[nt][e] * a.scale_log2 - lse_s[qc]) : 0.f;
          s[nt][e] = p;
          dp[nt][e] = p * (dp[nt][e] - delta_s[qc]) * a.scale;   // dS^T
        }
      }
      uint32_t f[4][4];
      to_a(f, s);
      mma_ab<DP>(dv, f, Ds, g, t4);   // dV += bf16(P)^T dO
      to_a(f, dp);
      mma_ab<DP>(dk, f, Qs, g, t4);   // dK += bf16(dS)^T Q
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= S) continue;
    const size_t base = kvbase + (size_t)key[r] * kv_stride;
#pragma unroll
    for (int dt = 0; dt < DTILES; ++dt) {
      const int d = dt * 8 + 2 * t4;
      if (d < D) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + base + d) =
            __floats2bfloat162_rn(dk[dt][2 * r], dk[dt][2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + base + d) =
            __floats2bfloat162_rn(dv[dt][2 * r], dv[dt][2 * r + 1]);
      }
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, int smem, dim3 grid, const Args& args, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args);
  return (int)cudaGetLastError();
}

bool bad_shape(int n_img, int B, int T, int S, int H, int Hkv, int D) {
  return D % 8 != 0 || D < 72 || D > 96 || Hkv <= 0 || H % Hkv != 0 || n_img < 0 ||
         n_img > kMaxImages || B <= 0 || T <= 0 || S <= 0;
}

Args make_args(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dq, void* dk, void* dv,
               const void* kv_valid, const void* q_offset, const void* img_start,
               const void* txt_start, const void* txt_end, int n_img, int T, int S, int H,
               int Hkv, int D, int causal, float scale_log2, float scale) {
  Args a;
  a.q = static_cast<const __nv_bfloat16*>(q);
  a.k = static_cast<const __nv_bfloat16*>(k);
  a.v = static_cast<const __nv_bfloat16*>(v);
  a.dout = static_cast<const __nv_bfloat16*>(dout);
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.dq = static_cast<__nv_bfloat16*>(dq);
  a.dk = static_cast<__nv_bfloat16*>(dk);
  a.dv = static_cast<__nv_bfloat16*>(dv);
  a.kv_valid = static_cast<const int*>(kv_valid);
  a.q_offset = static_cast<const int*>(q_offset);
  a.img_start = static_cast<const int*>(img_start);
  a.txt_start = static_cast<const int*>(txt_start);
  a.txt_end = static_cast<const int*>(txt_end);
  a.n_img = n_img; a.T = T; a.S = S; a.H = H; a.Hkv = Hkv; a.D = D; a.causal = causal;
  a.scale_log2 = scale_log2; a.scale = scale;
  return a;
}

}  // namespace

extern "C" const char* flash_mma_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// q, dout (B,T,H,D), k, v (B,S,Hkv,D): contiguous bf16, D % 8 == 0, D in
// 72..96, H % Hkv == 0. lse, delta (B,H,T) f32 (lse as the forward writes
// it). kv_valid (B,S) int32 or null; q_offset (B,) int32; img_start /
// txt_start / txt_end (B,n_img) int32, n_img <= kMaxImages. Writes dq
// (B,T,H,D) bf16.
extern "C" int flash_mma_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, const void* kv_valid, const void* q_offset,
                                const void* img_start, const void* txt_start,
                                const void* txt_end, int n_img, int B, int T, int S, int H,
                                int Hkv, int D, int causal, float scale_log2, float scale,
                                void* stream) {
  if (bad_shape(n_img, B, T, S, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Args args = make_args(q, k, v, dout, lse, delta, dq, nullptr, nullptr, kv_valid,
                              q_offset, img_start, txt_start, txt_end, n_img, T, S, H, Hkv,
                              D, causal, scale_log2, scale);
  const dim3 grid((T + kBlockM - 1) / kBlockM, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 80) return launch(flash_mma_dq_kernel<80>, dq_smem_bytes<80>(), grid, args, st);
  return launch(flash_mma_dq_kernel<96>, dq_smem_bytes<96>(), grid, args, st);
}

// Shapes as flash_mma_bwd_dq; writes dk, dv (B,S,Hkv,D) bf16, each the sum
// over the query heads of its group.
extern "C" int flash_mma_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse, const void* delta,
                                 void* dk, void* dv, const void* kv_valid,
                                 const void* q_offset, const void* img_start,
                                 const void* txt_start, const void* txt_end, int n_img, int B,
                                 int T, int S, int H, int Hkv, int D, int causal,
                                 float scale_log2, float scale, void* stream) {
  if (bad_shape(n_img, B, T, S, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Args args = make_args(q, k, v, dout, lse, delta, nullptr, dk, dv, kv_valid, q_offset,
                              img_start, txt_start, txt_end, n_img, T, S, H, Hkv, D, causal,
                              scale_log2, scale);
  const dim3 grid((S + kBlockN - 1) / kBlockN, Hkv, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 80) return launch(flash_mma_dkv_kernel<80>, dkv_smem_bytes<80>(), grid, args, st);
  return launch(flash_mma_dkv_kernel<96>, dkv_smem_bytes<96>(), grid, args, st);
}
