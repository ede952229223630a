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
// exp2 is one ex2.approx.ftz, as in the forward: a p below 2^-126 becomes
// 0 (the plain version keeps it as a subnormal, under one f32 ulp of the
// row's largest p, which is 1 before the division by the row sum).
//
// Work split: two kernels, as the TPU package has them, and no atomics, so
// the result is deterministic and needs no f32 dq buffer. S and dP are
// computed in both (14*D FLOPs per allowed pair and head instead of 10*D).
// - flash_mma_dq_kernel: a block owns NC x 64 query rows of one (head,
//   batch row); Q and dO are loaded once, K and V tiles of 64 keys stream
//   through the ring. Per tile: S = Q K^T and dP = dO V^T (wgmma, A and B
//   from shared memory, K-major), p and ds in registers, dQ += bf16(dS) K
//   (wgmma, dS from registers as bf16 A fragments, K as an MN-major B: the
//   forward's P V).
// - flash_mma_dkv_kernel: a block owns NC x 64 keys of one (KV head, batch
//   row); K and V are loaded once, Q, dO and their rows' lse and delta
//   stream through the ring, over every query head of the GQA group. It
//   computes the transposed products S^T = K Q^T and dP^T = V dO^T with
//   the block's keys as M, so that P^T and dS^T come out of the
//   accumulators already in the A-fragment layout of dV += bf16(P^T) dO and
//   dK += bf16(dS^T) Q (dO and Q as MN-major B). No transpose in shared
//   memory. The group's dK and dV are summed in f32 registers and rounded
//   once.
// Both kernels are warp-specialised as the forward: one producer warp
// issues TMA loads (cp.async.bulk.tensor from CUtensorMaps built on the
// host per call) into 128-byte-swizzled two-chunk tiles, zero-filled past
// D, T and S, through a ring of 2-3 stages with "full" (transaction bytes)
// and "empty" (one arrival per consumer warp) mbarriers; NC consumer
// warpgroups of 64 rows each compute. NC is 2 once B * heads * ceil(rows /
// 128) fills two waves of the SMs, else 1 (two blocks to an SM). The tiles
// of one (head, batch row) are launched next to each other (its K and V,
// or Q and dO, are read from HBM about once), the longest walk first.
// dkv holds dK, dV, S^T, dP^T and two sets of fragments at once, about
// 200 registers a thread: its producer warp sits in a warpgroup of its
// own, which gives its registers to the consumers (setmaxnreg); with one
// warp it was held to 168, spilled and serialised its wgmma (ptxas C7512),
// and took 1.5x the time (exp_torch/bwd_ab.py on an H100).
//
// Tile classes, per (64 query rows, 64 keys), as the forward's and
// aki_torch/ops/flash_mma_args.py:tile_classes: *skip* (outside the causal
// frontier and every MMA rectangle: never loaded when the whole block skips
// it, never computed by a warpgroup that skips it), *full* (every key below
// the causal frontier of the first row, or non-causal, and every key < S
// and valid: computed with no mask), *partial* (the rest: each score tested
// in O(1), the row's image bitmask against the key's, and the producer's or
// the warp's vote of kv_valid). The producer and the consumers walk the
// same list of tiles. dkv starts each head's walk at the first query tile
// that the causal frontier or a rectangle lets reach its keys. Rows past T
// carry lse = +inf, so their p is 0 also in a full tile. With a counter
// set (flash_mma_bwd_count_tiles), each launch adds the tiles its
// warpgroups ran, by class: dq per (64 rows, KV tile), dkv per (group head,
// q tile, 64 keys).
//
// What bounds it on an H100 (SXM data-sheet peaks at 700 W: 989 TFLOP/s
// bf16, 3.35 TB/s) at the training shape (2 x 655 tokens, 32 heads of 96,
// MMA mask, row 1 padded), counting each tensor once and the pairs the
// mask allows (chip_smoke.py backward_work): dq needs 0.0117 ms (bytes),
// dkv 0.0141 ms (bytes); their products 6*D and 8*D FLOPs per pair are
// 9-12 us at peak, so the pair is nearly balanced, bytes first. A
// warpgroup computes ~7 tiles there, so what decides the time is how much
// of each tile's latency (two products, the exp2 and mask pass, one or two
// products, a barrier round trip) the design hides: TMA loads run ahead of
// the products, two warpgroups (or two blocks) share an SM, full tiles
// skip the mask, and each score costs one MUFU instruction.
//
// Head widths 72-96, padded to 80 and 96 in the tiles (TMA zero fill).
// Plain C interface (bound with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include "hopper.cuh"

namespace {

// dq: NC consumer warpgroups and one producer warp.
template <int NC>
__host__ __device__ constexpr int threads() { return NC * 128 + 32; }

// dkv: NC consumer warpgroups and a producer warpgroup, whose first warp
// loads while all four hand their registers to the consumers: dK and dV
// (2 x DP/2 f32 a thread), S^T and dP^T (2 x 32) and their bf16 fragments
// (2 x 16) are live at once, more than the 168 a thread that 384 threads
// get at launch. Per block (one per SM at NC = 2, two at NC = 1) the
// producers keep kProducerRegs and the consumers take the rest.
template <int NC>
__host__ __device__ constexpr int dkv_threads() { return NC * 128 + 128; }
constexpr int kProducerRegs = 40;
template <int NC>
__host__ __device__ constexpr int dkv_consumer_regs() { return NC == 1 ? 216 : 232; }

// Ring depth: three for two-warpgroup blocks (one per SM), two for 64-row
// blocks, so that two blocks fit an SM.
template <int NC>
__host__ __device__ constexpr int stages() { return NC == 1 ? 2 : 3; }

// dq: Q and dO [NC][2 chunks], K and V [stages][2 chunks] from a
// 1024-byte-aligned base; then the mbarriers, each stage's key-validity
// mask and the image coordinates.
template <int NC>
__host__ __device__ constexpr int dq_smem_bytes() {
  return 1024 + (NC * 4 + 4 * stages<NC>()) * kTileBytes + 8 * (1 + 3 * stages<NC>()) +
         3 * kMaxImages * 4;
}

// dkv: K and V [NC][2 chunks], Q and dO [stages][2 chunks]; then the
// mbarriers, each stage's 64 rows of lse and delta and the image
// coordinates.
template <int NC>
__host__ __device__ constexpr int dkv_smem_bytes() {
  return 1024 + (NC * 4 + 4 * stages<NC>()) * kTileBytes + 8 * (1 + 2 * stages<NC>()) +
         2 * 64 * 4 * stages<NC>() + 3 * kMaxImages * 4;
}

struct Args {
  const float *lse, *delta;                    // (B, H, T)
  __nv_bfloat16 *dq, *dk, *dv;
  const int *kv_valid, *q_offset, *img_start, *txt_start, *txt_end;
  int* tile_counts;                            // [skip, full, partial] or null
  int n_img, T, S, H, Hkv, D, causal;
  float scale_log2, scale;
};

// The 1024-byte-aligned base of the dynamic shared memory (the 128-byte
// swizzle of the TMA tiles repeats every 1024 bytes).
__device__ __forceinline__ unsigned char* smem_base() {
  extern __shared__ unsigned char smem_raw[];
  return smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
}

// Does any row in [first, last] (absolute) attend a key of [k0, k0 + n):
// the causal frontier or one image's MMA rectangle (the forward's visit).
__device__ __forceinline__ bool reaches(int k0, int n, int first, int last, int causal,
                                        int n_img, const int* i0, const int* t0,
                                        const int* t1) {
  bool vis = !causal || k0 <= last;
  for (int i = 0; i < n_img && !vis; ++i)
    vis = first < t0[i] && last >= i0[i] && k0 < t1[i] && k0 + n > t0[i];
  return vis;
}

// S (+)= A B^T over the head dim's k-steps, A and B K-major two-chunk tiles.
template <int DP>
__device__ __forceinline__ void qk_product(float (&s)[32], uint32_t a_base, uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    const uint32_t at = (kk / 4) * kTileBytes + (kk % 4) * 32;
    wgmma_ss_n64(s, sw128_desc(a_base + at, 16), sw128_desc(b_base + at, 16), kk > 0);
  }
}

// acc (64 x DP) += A (64 x 64, bf16 fragments) B, B an MN-major two-chunk
// tile of 64 rows (the k dimension).
template <int DP>
__device__ __forceinline__ void pv_product(float (&acc)[DP / 2], const uint32_t (&a)[4][4],
                                           uint32_t b_base) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_rs<DP>(acc, a[kk], sw128_desc(b_base + kk * 2048, kTileBytes));
}

// Accumulator i of a 64 x 64 product (row g + 8 r, column 8 jt + 2 t4 + e,
// i = 4 jt + 2 r + e) into the bf16 A fragments of 16-column k-steps.
__device__ __forceinline__ void to_frags(uint32_t (&f)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int jt = 0; jt < 8; ++jt) {
    const int kk = jt >> 1, hi = (jt & 1) * 2;
    f[kk][hi] = pack_bf16(x[jt * 4 + 0], x[jt * 4 + 1]);
    f[kk][hi + 1] = pack_bf16(x[jt * 4 + 2], x[jt * 4 + 3]);
  }
}

// DP: head dim padded to 80 or 96; NC: consumer warpgroups (64 query rows
// each).
template <int DP, int NC>
__global__ void __launch_bounds__(threads<NC>(), NC == 1 ? 2 : 1)
flash_mma_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_do,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const Args a) {
  constexpr int BM = NC * 64;
  constexpr int kStages = stages<NC>();
  unsigned char* base = smem_base();
  unsigned char* Qs = base;                              // [NC][2][64 x 128 B]
  unsigned char* Ds = Qs + NC * 2 * kTileBytes;          // dO, [NC][2]
  unsigned char* Ks = Ds + NC * 2 * kTileBytes;          // [kStages][2]
  unsigned char* Vs = Ks + kStages * 2 * kTileBytes;
  uint64_t* qd_full = reinterpret_cast<uint64_t*>(Vs + kStages * 2 * kTileBytes);
  uint64_t* full = qd_full + 1;
  uint64_t* empty = full + kStages;
  uint64_t* valid_s = empty + kStages;   // per stage, bit c: key k0 + c is < S and valid
  int* i0_s = reinterpret_cast<int*>(valid_s + kStages);
  int* t0_s = i0_s + kMaxImages;
  int* t1_s = t0_s + kMaxImages;

  const int T = a.T, S = a.S, causal = a.causal, n_img = a.n_img;
  // causal: the last query tiles walk the most KV tiles, start them first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BM;
  const int hk = h / (a.H / a.Hkv);
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int off = a.q_offset[b];
  const int q_first = off + q0, q_last = off + min(q0 + BM, T) - 1;

  if (tid < n_img) {
    i0_s[tid] = a.img_start[b * n_img + tid];
    t0_s[tid] = a.txt_start[b * n_img + tid];
    t1_s[tid] = a.txt_end[b * n_img + tid];
  }
  if (tid == 0) {
    mbar_init(qd_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  auto visit = [&](int k0, int first, int last) {
    return reaches(k0, kBlockN, first, last, causal, n_img, i0_s, t0_s, t1_s);
  };
  const int n_tiles = (S + kBlockN - 1) / kBlockN;

  if (warp == NC * 4) {
    // producer warp: lane 0 issues every load; the warp votes each KV
    // tile's key validity ahead of the consumers
    if (lane == 0) {
      int bytes = 0;
      for (int w = 0; w < NC; ++w)
        if (q0 + 64 * w < T) bytes += 4 * kTileBytes;
      mbar_expect_tx(qd_full, bytes);
      for (int w = 0; w < NC; ++w)
        if (q0 + 64 * w < T)
          for (int c = 0; c < 2; ++c) {
            tma_load(Qs + (w * 2 + c) * kTileBytes, &tm_q, qd_full, c * kChunk, h, q0 + 64 * w, b);
            tma_load(Ds + (w * 2 + c) * kTileBytes, &tm_do, qd_full, c * kChunk, h, q0 + 64 * w, b);
          }
    }
    const int* valid_b = a.kv_valid == nullptr ? nullptr : a.kv_valid + (size_t)b * S;
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
  const bool counter = a.tile_counts != nullptr && has_rows && (tid & 127) == 0;
  const int row_abs[2] = {wg_first + wl * 16 + g, wg_first + wl * 16 + g + 8};
  uint32_t row_img[2] = {0u, 0u};   // images whose query span holds the row
  float lse_r[2], delta_r[2];       // rows past T: p = 0 through +inf
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    for (int n = 0; n < n_img; ++n)
      if (row_abs[r] >= i0_s[n] && row_abs[r] < t0_s[n]) row_img[r] |= 1u << n;
    const int row = r0 + wl * 16 + g + 8 * r;
    const size_t idx = ((size_t)b * a.H + h) * T + row;
    lse_r[r] = row < T ? a.lse[idx] : INFINITY;
    delta_r[r] = row < T ? a.delta[idx] : 0.f;
  }

  float acc[DP / 2];   // dQ in the wgmma accumulator layout
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  const uint32_t q_base = smem_addr(Qs + wg * 2 * kTileBytes);
  const uint32_t d_base = smem_addr(Ds + wg * 2 * kTileBytes);
  const uint32_t k_base = smem_addr(Ks), v_base = smem_addr(Vs);
  const float sl2 = a.scale_log2, scale = a.scale;
  mbar_wait(qd_full, 0);

  int stage = 0, phase = 0;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    if (!visit(k0, q_first, q_last)) {
      if (counter) atomicAdd(&a.tile_counts[kSkip], 1);
      continue;
    }
    int cls = has_rows && visit(k0, wg_first, wg_last) ? kPartial : kSkip;
    mbar_wait(&full[stage], phase);
    const uint64_t vmask = valid_s[stage];
    if (cls != kSkip && vmask == ~0ull && (!causal || k0 + kBlockN - 1 <= wg_first))
      cls = kFull;
    if (counter) atomicAdd(&a.tile_counts[cls], 1);

    if (cls != kSkip) {
      const uint32_t ks = k_base + stage * 2 * kTileBytes;
      const uint32_t vs = v_base + stage * 2 * kTileBytes;
      float s[32], dp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;
      wgmma_fence();
      qk_product<DP>(s, q_base, ks);    // S  = Q K^T
      qk_product<DP>(dp, d_base, vs);   // dP = dO V^T
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);
      fence_regs(dp);

      // p and ds in place of dp; s[4 jt + 2 r + e] is row g + 8 r, key
      // column 8 jt + 2 t4 + e
      if (cls == kFull) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int r = (i >> 1) & 1;
          const float p = exp2_ftz(s[i] * sl2 - lse_r[r]);
          dp[i] = p * (dp[i] - delta_r[r]) * scale;
        }
      } else {
        // images whose text span holds key k0 + lane and k0 + 32 + lane
        uint32_t kimg_lo = 0u, kimg_hi = 0u;
        const bool rects = causal && n_img > 0;
        if (rects) {
          for (int n = 0; n < n_img; ++n) {
            const int ka = k0 + lane, kb = k0 + 32 + lane;
            kimg_lo |= static_cast<uint32_t>(ka >= t0_s[n] && ka < t1_s[n]) << n;
            kimg_hi |= static_cast<uint32_t>(kb >= t0_s[n] && kb < t1_s[n]) << n;
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
              const float p = ok ? exp2_ftz(s[i] * sl2 - lse_r[r]) : 0.f;
              dp[i] = p * (dp[i] - delta_r[r]) * scale;
            }
          }
        }
      }
      uint32_t dsf[4][4];
      to_frags(dsf, dp);
      wgmma_fence();
      pv_product<DP>(acc, dsf, ks);     // dQ += bf16(dS) K
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

  const size_t q_stride = (size_t)a.H * a.D;
  __nv_bfloat16* dqb = a.dq + ((size_t)b * T) * q_stride + (size_t)h * a.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r0 + wl * 16 + g + 8 * r;
    if (row >= T) continue;
    __nv_bfloat16* drow = dqb + (size_t)row * q_stride;
#pragma unroll
    for (int jt = 0; jt < DP / 8; ++jt) {
      const int d = jt * 8 + 2 * t4;
      if (d < a.D)
        *reinterpret_cast<__nv_bfloat162*>(drow + d) =
            __floats2bfloat162_rn(acc[jt * 4 + 2 * r], acc[jt * 4 + 2 * r + 1]);
    }
  }
}

// The walk of a dkv block over its (group head, query tile) pairs, the
// same for the producer and the consumers: per head, from the first query
// tile that the causal frontier or an MMA rectangle lets reach the block's
// keys [k0, k0 + n), every tile that reaches them.
struct DkvWalk {
  int k0, n, off, T, causal, n_img, n_qt;
  const int *i0, *t0, *t1;

  __device__ __forceinline__ int start() const {
    if (!causal) return 0;
    // causal frontier: the first tile whose last row is at or past k0
    const int x = k0 - off - 63;
    int qi = x <= 0 ? 0 : (x + 63) / 64;
    // an image whose text span meets the keys: the tile of its first row
    // (the same rectangle test as reaches, which a tile must also pass)
    for (int i = 0; i < n_img; ++i)
      if (k0 < t1[i] && k0 + n > t0[i]) qi = min(qi, max(i0[i] - off, 0) / 64);
    return min(qi, n_qt);
  }
  __device__ __forceinline__ bool visit(int qi) const {
    const int first = off + qi * 64, last = off + min(qi * 64 + 64, T) - 1;
    return reaches(k0, n, first, last, causal, n_img, i0, t0, t1);
  }
};

template <int DP, int NC>
__global__ void __launch_bounds__(dkv_threads<NC>(), NC == 1 ? 2 : 1)
flash_mma_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_do,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const Args a) {
  constexpr int BN = NC * 64;
  constexpr int kStages = stages<NC>();
  unsigned char* base = smem_base();
  unsigned char* Ks = base;                              // [NC][2][64 x 128 B]
  unsigned char* Vs = Ks + NC * 2 * kTileBytes;
  unsigned char* Qs = Vs + NC * 2 * kTileBytes;          // [kStages][2]
  unsigned char* Ds = Qs + kStages * 2 * kTileBytes;     // dO
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(Ds + kStages * 2 * kTileBytes);
  uint64_t* full = kv_full + 1;
  uint64_t* empty = full + kStages;
  float* lse_s = reinterpret_cast<float*>(empty + kStages);   // [kStages][64]
  float* delta_s = lse_s + kStages * 64;
  int* i0_s = reinterpret_cast<int*>(delta_s + kStages * 64);
  int* t0_s = i0_s + kMaxImages;
  int* t1_s = t0_s + kMaxImages;

  const int T = a.T, S = a.S, causal = a.causal, n_img = a.n_img;
  // causal: the first key tiles are reached by the most query tiles, and
  // blockIdx.x runs first
  const int k0 = blockIdx.x * BN, hk = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.Hkv;
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int off = a.q_offset[b];
  const int n_qt = (T + 63) / 64;

  if (tid < n_img) {
    i0_s[tid] = a.img_start[b * n_img + tid];
    t0_s[tid] = a.txt_start[b * n_img + tid];
    t1_s[tid] = a.txt_end[b * n_img + tid];
  }
  if (tid == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NC * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const DkvWalk block{k0, BN, off, T, causal, n_img, n_qt, i0_s, t0_s, t1_s};
  const int qi_start = block.start();

  if (warp >= NC * 4) {
    // producer warpgroup: its first warp works, lane 0 issuing the loads
    // and the warp reading each q tile's lse and delta (rows past T: +inf,
    // 0) into the stage
    regs_dec<kProducerRegs>();
    if (warp != NC * 4) return;
    if (lane == 0) {
      int bytes = 0;
      for (int w = 0; w < NC; ++w)
        if (k0 + 64 * w < S) bytes += 4 * kTileBytes;
      mbar_expect_tx(kv_full, bytes);
      for (int w = 0; w < NC; ++w)
        if (k0 + 64 * w < S)
          for (int c = 0; c < 2; ++c) {
            tma_load(Ks + (w * 2 + c) * kTileBytes, &tm_k, kv_full, c * kChunk, hk, k0 + 64 * w, b);
            tma_load(Vs + (w * 2 + c) * kTileBytes, &tm_v, kv_full, c * kChunk, hk, k0 + 64 * w, b);
          }
    }
    int stage = 0, phase = 0;
    for (int h = hk * group; h < (hk + 1) * group; ++h) {
      const size_t row0 = ((size_t)b * a.H + h) * T;
      for (int qi = qi_start; qi < n_qt; ++qi) {
        if (!block.visit(qi)) continue;
        const int q0 = qi * 64;
        float lse_v[2], delta_v[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = q0 + 32 * r + lane;
          lse_v[r] = row < T ? a.lse[row0 + row] : INFINITY;
          delta_v[r] = row < T ? a.delta[row0 + row] : 0.f;
        }
        if (lane == 0) mbar_wait(&empty[stage], phase ^ 1);
        __syncwarp();
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          lse_s[stage * 64 + 32 * r + lane] = lse_v[r];
          delta_s[stage * 64 + 32 * r + lane] = delta_v[r];
        }
        __syncwarp();   // the lanes' writes before lane 0's arrival publishes them
        if (lane == 0) {
          mbar_expect_tx(&full[stage], 4 * kTileBytes);
          for (int c = 0; c < 2; ++c) {
            tma_load(Qs + (stage * 2 + c) * kTileBytes, &tm_q, &full[stage], c * kChunk, h, q0, b);
            tma_load(Ds + (stage * 2 + c) * kTileBytes, &tm_do, &full[stage], c * kChunk, h, q0, b);
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

  // consumers: warpgroup wg owns keys kw0 .. kw0 + 63; warp wl of it keys
  // 16 wl .. 16 wl + 15, of which this thread holds g and g + 8 (the rows
  // of S^T); the columns are the q tile's rows
  regs_inc<dkv_consumer_regs<NC>()>();
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw0 = k0 + wg * 64;
  const bool has_keys = kw0 < S;
  const bool counter = a.tile_counts != nullptr && has_keys && (tid & 127) == 0;
  const int key[2] = {kw0 + wl * 16 + g, kw0 + wl * 16 + g + 8};
  // the warpgroup's key validity, voted by each warp alike
  const int* valid_b = a.kv_valid == nullptr ? nullptr : a.kv_valid + (size_t)b * S;
  const int ka = kw0 + lane, kb = kw0 + 32 + lane;
  const bool va = ka < S && (valid_b == nullptr || valid_b[ka] != 0);
  const bool vb = kb < S && (valid_b == nullptr || valid_b[kb] != 0);
  const uint64_t vmask = static_cast<uint64_t>(__ballot_sync(0xffffffffu, va)) |
                         (static_cast<uint64_t>(__ballot_sync(0xffffffffu, vb)) << 32);
  bool key_ok[2];
  uint32_t key_img[2] = {0u, 0u};   // images whose text span holds the key
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    key_ok[r] = (vmask >> (wl * 16 + g + 8 * r)) & 1ull;
    for (int n = 0; n < n_img; ++n)
      if (key[r] >= t0_s[n] && key[r] < t1_s[n]) key_img[r] |= 1u << n;
  }
  const DkvWalk mine{kw0, kBlockN, off, T, causal, n_img, n_qt, i0_s, t0_s, t1_s};

  float dk[DP / 2], dv[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  const uint32_t k_base = smem_addr(Ks + wg * 2 * kTileBytes);
  const uint32_t v_base = smem_addr(Vs + wg * 2 * kTileBytes);
  const uint32_t q_ring = smem_addr(Qs), d_ring = smem_addr(Ds);
  const float sl2 = a.scale_log2, scale = a.scale;
  mbar_wait(kv_full, 0);

  int stage = 0, phase = 0, walked = 0;
  for (int h = hk * group; h < (hk + 1) * group; ++h) {
    for (int qi = qi_start; qi < n_qt; ++qi) {
      if (!block.visit(qi)) continue;
      const int q_first = off + qi * 64;
      int cls = has_keys && mine.visit(qi) ? kPartial : kSkip;
      mbar_wait(&full[stage], phase);
      if (cls != kSkip && vmask == ~0ull && (!causal || kw0 + kBlockN - 1 <= q_first))
        cls = kFull;
      if (counter) atomicAdd(&a.tile_counts[cls], 1);
      ++walked;

      if (cls != kSkip) {
        const uint32_t qs = q_ring + stage * 2 * kTileBytes;
        const uint32_t ds = d_ring + stage * 2 * kTileBytes;
        const float* lse_t = lse_s + stage * 64;
        const float* delta_t = delta_s + stage * 64;
        float st[32], dpt[32];
#pragma unroll
        for (int i = 0; i < 32; ++i) st[i] = dpt[i] = 0.f;
        wgmma_fence();
        qk_product<DP>(st, k_base, qs);    // S^T  = K Q^T
        qk_product<DP>(dpt, v_base, ds);   // dP^T = V dO^T
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(st);
        fence_regs(dpt);

        // st[4 jt + 2 r + e] is key g + 8 r, q column 8 jt + 2 t4 + e:
        // p^T in place of st, ds^T in place of dpt
        // images whose query span holds rows q_first + lane, + 32 + lane
        uint32_t qimg_lo = 0u, qimg_hi = 0u;
        const bool rects = cls == kPartial && causal && n_img > 0;
        if (rects) {
          for (int n = 0; n < n_img; ++n) {
            const int ra = q_first + lane, rb = q_first + 32 + lane;
            qimg_lo |= static_cast<uint32_t>(ra >= i0_s[n] && ra < t0_s[n]) << n;
            qimg_hi |= static_cast<uint32_t>(rb >= i0_s[n] && rb < t0_s[n]) << n;
          }
        }
#pragma unroll
        for (int jt = 0; jt < 8; ++jt) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qc = jt * 8 + 2 * t4 + e;
            const float lse_c = lse_t[qc], delta_c = delta_t[qc];
            const uint32_t qbits =
                rects ? __shfl_sync(0xffffffffu, jt < 4 ? qimg_lo : qimg_hi, qc & 31) : 0u;
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int i = jt * 4 + r * 2 + e;
              const bool ok = cls == kFull ||
                              (key_ok[r] && (!causal || key[r] <= q_first + qc ||
                                             (key_img[r] & qbits) != 0u));
              const float p = ok ? exp2_ftz(st[i] * sl2 - lse_c) : 0.f;
              st[i] = p;
              dpt[i] = p * (dpt[i] - delta_c) * scale;
            }
          }
        }
        uint32_t pf[4][4], sf[4][4];
        to_frags(pf, st);
        to_frags(sf, dpt);
        wgmma_fence();
        pv_product<DP>(dv, pf, ds);   // dV += bf16(P^T) dO
        pv_product<DP>(dk, sf, qs);   // dK += bf16(dS^T) Q
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[stage]);
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  // the (head, q tile) pairs this block never walked are skip tiles
  if (counter) atomicAdd(&a.tile_counts[kSkip], group * n_qt - walked);
  if (!has_keys) return;

  const size_t kv_stride = (size_t)a.Hkv * a.D;
  const size_t kvbase = ((size_t)b * S) * kv_stride + (size_t)hk * a.D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= S) continue;
    const size_t rowb = kvbase + (size_t)key[r] * kv_stride;
#pragma unroll
    for (int jt = 0; jt < DP / 8; ++jt) {
      const int d = jt * 8 + 2 * t4;
      if (d < a.D) {
        *reinterpret_cast<__nv_bfloat162*>(a.dk + rowb + d) =
            __floats2bfloat162_rn(dk[jt * 4 + 2 * r], dk[jt * 4 + 2 * r + 1]);
        *reinterpret_cast<__nv_bfloat162*>(a.dv + rowb + d) =
            __floats2bfloat162_rn(dv[jt * 4 + 2 * r], dv[jt * 4 + 2 * r + 1]);
      }
    }
  }
}

// The tile counts that launches add to while a check has set them
// (flash_mma_bwd_count_tiles); null otherwise.
int* g_dq_counts = nullptr;
int* g_dkv_counts = nullptr;

// Rows (dq) or keys (dkv) per block: 128 once the grid of B * heads *
// ceil(n / 128) blocks fills two waves of `sms`, else 64.
int block_rows(int B, int n, int heads, int sms) {
  return (long)B * heads * ((n + 127) / 128) >= 2L * sms ? 128 : 64;
}

bool bad_shape(int n_img, int B, int T, int S, int H, int Hkv, int D) {
  return D % 8 != 0 || D < 72 || D > 96 || Hkv <= 0 || H % Hkv != 0 || n_img < 0 ||
         n_img > kMaxImages || B <= 0 || T <= 0 || S <= 0;
}

template <int DP, int NC, bool DQ>
int launch_nc(const CUtensorMap (&maps)[4], const Args& args, int B, int n, int heads,
              cudaStream_t stream) {
  constexpr int smem = DQ ? dq_smem_bytes<NC>() : dkv_smem_bytes<NC>();
  auto kernel = DQ ? flash_mma_dq_kernel<DP, NC> : flash_mma_dkv_kernel<DP, NC>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + NC * 64 - 1) / (NC * 64), heads, B);
  kernel<<<grid, DQ ? threads<NC>() : dkv_threads<NC>(), smem, stream>>>(
      maps[0], maps[1], maps[2], maps[3], args);
  return (int)cudaGetLastError();
}

// One of the two kernels (dq when DQ) over the n query rows (dq) or keys
// (dkv) of B x heads.
template <bool DQ>
int launch(const void* q, const void* k, const void* v, const void* dout, const Args& args,
           int B, int T, int S, int H, int Hkv, int D, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap maps[4];
  if (!head_map(&maps[0], q, B, T, H, D) || !head_map(&maps[1], dout, B, T, H, D) ||
      !head_map(&maps[2], k, B, S, Hkv, D) || !head_map(&maps[3], v, B, S, Hkv, D))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const int n = DQ ? T : S, heads = DQ ? H : Hkv;
  const bool big = block_rows(B, n, heads, sms) > 64;
  if (D <= 80)
    return big ? launch_nc<80, 2, DQ>(maps, args, B, n, heads, stream)
               : launch_nc<80, 1, DQ>(maps, args, B, n, heads, stream);
  return big ? launch_nc<96, 2, DQ>(maps, args, B, n, heads, stream)
             : launch_nc<96, 1, DQ>(maps, args, B, n, heads, stream);
}

Args make_args(const void* lse, const void* delta, void* dq, void* dk, void* dv,
               const void* kv_valid, const void* q_offset, const void* img_start,
               const void* txt_start, const void* txt_end, int* tile_counts, int n_img,
               int T, int S, int H, int Hkv, int D, int causal, float scale_log2,
               float scale) {
  Args a;
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
  a.tile_counts = tile_counts;
  a.n_img = n_img; a.T = T; a.S = S; a.H = H; a.Hkv = Hkv; a.D = D; a.causal = causal;
  a.scale_log2 = scale_log2; a.scale = scale;
  return a;
}

}  // namespace

extern "C" const char* flash_mma_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// For checks: from now on every launch adds the tiles its consumer
// warpgroups ran, by class, to dq_counts[0..2] (dq: per 64 rows with rows
// < T and KV tile) and dkv_counts[0..2] (dkv: per 64 keys with keys < S,
// query tile and head of the group): skip, full, partial, int32 on the
// current device, one atomic per tile. Nulls stop it. Not for concurrent
// callers.
extern "C" void flash_mma_bwd_count_tiles(void* dq_counts, void* dkv_counts) {
  g_dq_counts = static_cast<int*>(dq_counts);
  g_dkv_counts = static_cast<int*>(dkv_counts);
}

// The query rows (dkv: keys) per block that the dq (dkv) kernel takes for
// B x T query rows of H heads over S keys of Hkv heads on the current
// device, or -1 when the device cannot be read.
extern "C" int flash_mma_bwd_block_rows(int B, int T, int S, int H, int Hkv, int dkv) {
  int sms = 0;
  if (sm_count(&sms) != cudaSuccess) return -1;
  return dkv ? block_rows(B, S, Hkv, sms) : block_rows(B, T, H, sms);
}

// q, dout (B,T,H,D), k, v (B,S,Hkv,D): contiguous bf16, 16-byte aligned,
// D % 8 == 0, D in 72..96, H % Hkv == 0. lse, delta (B,H,T) f32 (lse as
// the forward writes it). kv_valid (B,S) int32 or null; q_offset (B,)
// int32; img_start / txt_start / txt_end (B,n_img) int32, n_img <=
// kMaxImages. Writes dq (B,T,H,D) bf16.
extern "C" int flash_mma_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse, const void* delta,
                                void* dq, const void* kv_valid, const void* q_offset,
                                const void* img_start, const void* txt_start,
                                const void* txt_end, int n_img, int B, int T, int S, int H,
                                int Hkv, int D, int causal, float scale_log2, float scale,
                                void* stream) {
  if (bad_shape(n_img, B, T, S, H, Hkv, D)) return (int)cudaErrorInvalidValue;
  const Args args = make_args(lse, delta, dq, nullptr, nullptr, kv_valid, q_offset,
                              img_start, txt_start, txt_end, g_dq_counts, n_img, T, S, H,
                              Hkv, D, causal, scale_log2, scale);
  return launch<true>(q, k, v, dout, args, B, T, S, H, Hkv, D,
                      static_cast<cudaStream_t>(stream));
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
  const Args args = make_args(lse, delta, nullptr, dk, dv, kv_valid, q_offset, img_start,
                              txt_start, txt_end, g_dkv_counts, n_img, T, S, H, Hkv, D,
                              causal, scale_log2, scale);
  return launch<false>(q, k, v, dout, args, B, T, S, H, Hkv, D,
                       static_cast<cudaStream_t>(stream));
}
