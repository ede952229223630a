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
// f32, and p * vs is rounded to bf16 after the softmax is normalised by the
// row's global max and sum, as the reference rounds it. A row with n == 0
// writes zeros.
//
// Cache layout: k, v int8 (L, B, S, Hkv*D) (all heads of a token in one
// row); ks, vs f32 (L, B, S, Hkv), token-major. The layer is picked by the
// ``layer`` argument inside the kernel; the cache is never sliced.
//
// What bounds it on an H100: bytes. At the serving cache (48 rows of 704
// slots, 32 heads x 96) a full-length launch must read 48*704*3072*2 int8
// bytes and 48*704*32*2 f32 scales, 216 MB: 0.065 ms at 3.35 TB/s, against
// ~0.8 GFLOP. One row of a one-request cache (1,075 keys) is 6.9 MB: 2 us.
//
// Design, and what it does about that:
// - A cluster of C blocks (C in 1, 2, 4, 8; the wrapper picks the least C
//   that gives two waves of blocks on the card, aki_torch/ops/
//   decode_attention.py:cluster_size) per (head, row), ranks fastest, then
//   heads, so the heads of one token run side by side and share its scale
//   sectors through L2. Block r takes keys [r * ceil(n/C), ...) of the
//   live prefix (key_range there), so one request's 32 heads still fill
//   the card (256 blocks at C = 8) and ragged rows split their own work.
// - Loads run ahead of use: each block streams its K tiles and then its V
//   tiles (64 keys of D bytes, 16-byte cp.async per thread) through a ring
//   of 4 stages; the K and V scales of a tile come with its K tile into
//   two arrays of the block's keys. V's first tiles are in flight while
//   the last K tiles are scored and while the cluster agrees on the
//   softmax statistics.
// - Pass 1: a pair of threads dots one key (48 bytes each at D = 96, q in
//   registers; every lane has work), the scores go to shared memory; the
//   block's max, then the cluster's through distributed shared memory
//   (cluster barrier, then each block reads every rank's value in rank
//   order); then exp, the block's sum, the cluster's sum. Every block of
//   the cluster reads the same values in the same order, so all normalise
//   by the same (max, sum) before p * vs is rounded: the rounding point of
//   the reference. bf16(p * vs) replaces each score in place.
// - Pass 2: each thread takes 32-bit words of the V tile in order (word i
//   of the tile to thread i % 128: every lane loads and converts), 4 f32
//   sums per word it meets; the block sums them in a fixed order, the
//   leader sums the C blocks' partials in rank order through distributed
//   shared memory and writes bf16. No global scratch, no second launch,
//   no atomics: the result is deterministic.
// - int8 -> f32 by a byte permute and one FADD (cp_async.cuh), not I2F.
//
// Plain C interface (bound with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError()
// (or kClusterRefused when no group of SMs can hold a cluster).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "cp_async.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kStages = 4;              // ring of key tiles
constexpr int kMaxD = 128;
constexpr int kMaxCluster = 8;          // portable cluster size
constexpr int kSmemLimit = 232448;      // per block, H100
constexpr int kStaticSmem = (kWarps + 2 + kMaxD) * 4;
constexpr int kClusterRefused = -1;

// threads that share one key's dot product in pass 1: two halves of the
// head row where each half is whole 16-byte chunks, else one thread
__host__ __device__ constexpr int threads_per_key(int d) { return d % 32 == 0 ? 2 : 1; }
__host__ __device__ constexpr int tile_keys(int d) { return kThreads / threads_per_key(d); }
__host__ __device__ constexpr int ceil_div(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ constexpr int gcd_c(int a, int b) { return b == 0 ? a : gcd_c(b, a % b); }

// keys of one block's share of an S-key row, rounded up to whole tiles
__host__ __device__ constexpr int share_capacity(int S, int C, int D) {
  return ceil_div(ceil_div(S, C), tile_keys(D)) * tile_keys(D);
}

// dynamic shared memory of a launch: the ring, then the block's scores
// (K scales, then scores, then bf16(p * vs)) and its V scales
size_t smem_bytes(int S, int C, int D) {
  return (size_t)kStages * tile_keys(D) * D + 2 * (size_t)share_capacity(S, C, D) * 4;
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

template <int kD>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const __nv_bfloat16* __restrict__ q, const int8_t* __restrict__ k,
                        const float* __restrict__ ks, const int8_t* __restrict__ v,
                        const float* __restrict__ vs, const int* __restrict__ lengths,
                        __nv_bfloat16* __restrict__ out, int layer, int B, int S, int H,
                        int Hkv, float scale) {
  constexpr int kTPK = threads_per_key(kD);
  constexpr int kTile = tile_keys(kD);
  constexpr int kW = kD / 4;                     // 32-bit words of a head row
  constexpr int kChunks = kD / 16;               // 16-byte chunks of a head row
  constexpr int kPart = kD / kTPK;               // values of a row one thread dots
  constexpr int kItems = kTile * kW / kThreads;  // V words per thread per tile
  constexpr int kNW = kW / gcd_c(kW, kThreads);  // distinct words a thread meets
  constexpr int kStageBytes = kTile * kD;
  static_assert(kPart % 16 == 0 && kItems * kThreads == kTile * kW, "tile shape");
  static_assert(kThreads * kNW * 16 <= kStages * kStageBytes, "reduction fits the ring");

  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ float red[kWarps];
  __shared__ float cta_stat[2];                  // this block's max and sum of exp
  __shared__ float part[kD];                     // this block's P V partial

  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int F = Hkv * kD;
  const int n = min(max(lengths[b], 0), S);
  __nv_bfloat16* o = out + ((size_t)b * H + h) * kD;
  if (n == 0) {                                  // the whole cluster leaves here
    if (rank == 0)
      for (int d = tid; d < kD; d += kThreads) o[d] = __float2bfloat16_rn(0.f);
    return;
  }
  // this block's keys: [j0, j0 + nk) of the live prefix
  const int share = ceil_div(n, C);
  const int j0 = min(rank * share, n);
  const int nk = min(j0 + share, n) - j0;
  const int nT = ceil_div(nk, kTile);
  uint8_t* ring = smem;
  float* sc = reinterpret_cast<float*>(smem + kStages * kStageBytes);
  float* vsv = sc + share_capacity(S, C, kD);

  const size_t tok0 = ((size_t)layer * B + b) * S + j0;   // token row of key j0
  const int8_t* kr = k + tok0 * F + (size_t)hk * kD;
  const int8_t* vr = v + tok0 * F + (size_t)hk * kD;
  const float* ksr = ks + tok0 * Hkv + hk;
  const float* vsr = vs + tok0 * Hkv + hk;

  // tile i of the stream K_0 .. K_{nT-1}, V_0 .. V_{nT-1} into stage i % kStages;
  // one commit group per tile, empty past the end
  auto issue = [&](int i) {
    if (i < 2 * nT) {
      const bool is_v = i >= nT;
      const int kb = (is_v ? i - nT : i) * kTile;
      const int keys = min(kTile, nk - kb);
      const int8_t* src = (is_v ? vr : kr) + (size_t)kb * F;
      uint8_t* dst = ring + (i % kStages) * kStageBytes;
      for (int c = tid; c < keys * kChunks; c += kThreads) {
        const int key = c / kChunks, ch = c - key * kChunks;
        cp_async16(dst + key * kD + ch * 16, src + (size_t)key * F + ch * 16);
      }
      if (!is_v)
        for (int key = tid; key < keys; key += kThreads) {
          cp_async4(sc + kb + key, ksr + (size_t)(kb + key) * Hkv);
          cp_async4(vsv + kb + key, vsr + (size_t)(kb + key) * Hkv);
        }
    }
    cp_async_commit();
  };
  // tile i has landed for every thread, and every thread is done with tile
  // i - 1, whose stage takes tile i + kStages - 1
  auto arrive = [&](int i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  const int key_in_tile = tid / kTPK, half = tid % kTPK;
  float qf[kPart];
  {
    const uint4* qr = reinterpret_cast<const uint4*>(q + ((size_t)b * H + h) * kD + half * kPart);
#pragma unroll
    for (int c = 0; c < kPart / 8; ++c) {
      const uint4 raw = qr[c];
      const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(p2[i]);
        qf[c * 8 + 2 * i] = f.x;
        qf[c * 8 + 2 * i + 1] = f.y;
      }
    }
  }

  // pass 1: scores of this block's keys into sc (over their K scales)
  float m = -INFINITY;
  for (int i = 0; i < nT; ++i) {
    arrive(i);
    const int j = i * kTile + key_in_tile;
    float dot[4] = {0.f, 0.f, 0.f, 0.f};
    if (j < nk) {
      const uint8_t* row = ring + (i % kStages) * kStageBytes + key_in_tile * kD + half * kPart;
#pragma unroll
      for (int c = 0; c < kPart / 16; ++c) {
        const uint4 raw = *reinterpret_cast<const uint4*>(row + c * 16);
        const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          float f[4];
          i8x4_to_f32(w[u], f);
#pragma unroll
          for (int e = 0; e < 4; ++e) dot[u] = fmaf(qf[c * 16 + u * 4 + e], f[e], dot[u]);
        }
      }
    }
    float s = (dot[0] + dot[1]) + (dot[2] + dot[3]);
    if (kTPK == 2) s += __shfl_xor_sync(0xffffffffu, s, 1);
    if (half == 0 && j < nk) {
      s = s * sc[j] * scale;
      sc[j] = s;
      m = fmaxf(m, s);
    }
  }

  // the cluster's max and sum of exp, the same in every block
  m = block_reduce<true>(m, red);
  if (tid == 0) cta_stat[0] = m;
  cluster.sync();
  float gm = -INFINITY;
  for (int r = 0; r < C; ++r) gm = fmaxf(gm, *cluster.map_shared_rank(&cta_stat[0], r));
  float l = 0.f;
  for (int j = tid; j < nk; j += kThreads) {
    const float e = expf(sc[j] - gm);
    sc[j] = e;
    l += e;
  }
  l = block_reduce<false>(l, red);
  if (tid == 0) cta_stat[1] = l;
  cluster.sync();
  float gl = 0.f;
  for (int r = 0; r < C; ++r) gl += *cluster.map_shared_rank(&cta_stat[1], r);
  for (int j = tid; j < nk; j += kThreads)
    sc[j] = __bfloat162float(__float2bfloat16_rn(sc[j] / gl * vsv[j]));

  // pass 2: bf16(p * vs) * v summed in f32; word i of a tile to thread i % 128
  float acc[kNW][4];
#pragma unroll
  for (int a = 0; a < kNW; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
  for (int i = nT; i < 2 * nT; ++i) {
    arrive(i);
    const uint8_t* stage = ring + (i % kStages) * kStageBytes;
    const int kb = (i - nT) * kTile;
#pragma unroll
    for (int it = 0; it < kItems; ++it) {
      const int item = tid + it * kThreads;
      const int j = kb + item / kW;
      if (j < nk) {
        const float pv = sc[j];
        float f[4];
        i8x4_to_f32(*reinterpret_cast<const uint32_t*>(stage + item * 4), f);
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[it % kNW][e] = fmaf(pv, f[e], acc[it % kNW][e]);
      }
    }
  }

  // the block's partial: slot a of thread t holds word (t + 128 a) % kW,
  // summed per word over (a, t) in order, through the now idle ring
  cp_async_wait<0>();
  __syncthreads();
  float* red2 = reinterpret_cast<float*>(ring);
#pragma unroll
  for (int a = 0; a < kNW; ++a)
#pragma unroll
    for (int e = 0; e < 4; ++e) red2[(tid * kNW + a) * 4 + e] = acc[a][e];
  __syncthreads();
  for (int d = tid; d < kD; d += kThreads) {
    const int w = d / 4, e = d % 4;
    float sum = 0.f;
    for (int a = 0; a < kNW; ++a) {
      const int t0 = ((w - (a * kThreads) % kW) % kW + kW) % kW;
      for (int t = t0; t < kThreads; t += kW) sum += red2[(t * kNW + a) * 4 + e];
    }
    part[d] = sum;
  }
  // the leader sums the blocks' partials in rank order; no block leaves
  // while the leader reads its shared memory
  cluster.sync();
  if (rank == 0)
    for (int d = tid; d < kD; d += kThreads) {
      float sum = 0.f;
      for (int r = 0; r < C; ++r) sum += cluster.map_shared_rank(part, r)[d];
      o[d] = __float2bfloat16_rn(sum);
    }
  cluster.sync();
}

template <int kD>
int launch(const void* q, const void* k, const void* ks, const void* v, const void* vs,
           const void* lengths, void* out, int layer, int B, int n_rows, int S, int H, int Hkv,
           float scale, int C, cudaStream_t st) {
  // the largest dynamic shared memory set, and checked for a cluster of
  // each size, so far (host calls only when a launch needs more)
  static int smem_set = 0;
  static int smem_checked[4] = {0, 0, 0, 0};
  const int smem = (int)smem_bytes(S, C, kD);
  auto kernel = decode_attention_kernel<kD>;
  if (smem > smem_set) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, H, n_rows);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const int ci = C == 1 ? 0 : C == 2 ? 1 : C == 4 ? 2 : 3;
  if (smem > smem_checked[ci]) {
    int clusters = 0;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (e != cudaSuccess) return (int)e;
    if (clusters < 1) return kClusterRefused;
    smem_checked[ci] = smem;
  }
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const __nv_bfloat16*>(q), static_cast<const int8_t*>(k),
      static_cast<const float*>(ks), static_cast<const int8_t*>(v), static_cast<const float*>(vs),
      static_cast<const int*>(lengths), static_cast<__nv_bfloat16*>(out), layer, B, S, H, Hkv,
      scale);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* decode_attention_error_string(int code) {
  if (code == kClusterRefused)
    return "cluster launch refused: no group of SMs can hold one cluster of this launch";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory of a launch over S slots with clusters of C blocks
// at head dim D (aki_torch/ops/decode_attention.py:smem_bytes mirrors it).
extern "C" long long decode_attention_smem_bytes(int S, int C, int D) {
  return (long long)smem_bytes(S, C, D);
}

// q (B, H, D) bf16; k, v (L, B, S, Hkv*D) int8; ks, vs (L, B, S, Hkv) f32;
// lengths (B,) int32; out (B, H, D) bf16, written for rows [0, n_rows).
// D % 16 == 0, D <= 128, H % Hkv == 0, 0 <= layer < L, 0 < n_rows <= B;
// cluster in {1, 2, 4, 8}: blocks per (head, row), each taking a
// contiguous share of the row's live keys. All pointers 16-byte aligned.
extern "C" int decode_attention(const void* q, const void* k, const void* ks, const void* v,
                                const void* vs, const void* lengths, void* out, int layer,
                                int L, int B, int n_rows, int S, int H, int Hkv, int D,
                                float scale, int cluster, void* stream) {
  if (D <= 0 || D % 16 != 0 || D > kMaxD || Hkv <= 0 || H % Hkv != 0 || layer < 0 ||
      layer >= L || n_rows <= 0 || n_rows > B || n_rows > 65535 || S <= 0 || H > 65535 ||
      (cluster != 1 && cluster != 2 && cluster != 4 && cluster != kMaxCluster))
    return (int)cudaErrorInvalidValue;
  if (smem_bytes(S, cluster, D) + kStaticSmem > (size_t)kSmemLimit)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (D) {
#define AKI_CASE(DD)                                                                      \
  case DD:                                                                                \
    return launch<DD>(q, k, ks, v, vs, lengths, out, layer, B, n_rows, S, H, Hkv, scale,  \
                      cluster, st);
    AKI_CASE(16) AKI_CASE(32) AKI_CASE(48) AKI_CASE(64)
    AKI_CASE(80) AKI_CASE(96) AKI_CASE(112) AKI_CASE(128)
#undef AKI_CASE
    default:
      return (int)cudaErrorInvalidValue;
  }
}
