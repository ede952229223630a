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
// So every consumer makes two passes over its KV tiles: the first computes
// the scores and keeps only the row max; the second computes them again,
// bit for bit (one code path, every product __fmul_rn so that nothing is
// contracted differently), forms p against that max and accumulates P.V.
//
// Design (warp-specialised, TMA + wgmma, the plan of flash_mma_fwd.cu):
// - A block owns NC x 64 query rows of one (head, batch row): NC consumer
//   warpgroups of 64 rows and three producer warps. NC = 3 once
//   B*H*ceil(T/192) fills two waves of the SMs, else 1. The query tiles of
//   one (head, batch row) are launched next to each other, and in the
//   causal case the ones with the longest KV walk first.
// - Producer warp A issues every TMA load. int8 rows are not addressable
//   per head at the tower's D = 72 (a map's strides are multiples of 16
//   bytes), so each map views its tensor as B x L rows of `ld` bytes
//   (ld = H*D, or the wrapper's padded copy when H*D is not a multiple of
//   16) and a box is 128 bytes x 64 rows starting at h*D rounded down to 16
//   bytes (a box starts on a 16-byte boundary; odd heads at D = 72 or 88
//   start 8 bytes in): it reads a neighbour head's bytes, or past the row
//   (zero fill) at the last head. Q's box bytes [0, 96) outside the head
//   are zeroed in shared memory, so K's extra bytes multiply zeros (exact,
//   in int32); V's conversion starts at the head's first byte, and its
//   extra columns land in output columns that are never written.
// - K stays resident: every KV tile the block visits is loaded once, into
//   its own slot, at the start, and serves both passes (at most 16 tiles of
//   8 KB). Streaming K through the ring in both passes instead (re-read
//   from L2) measured 3-7% slower (PERF.md). V streams through a ring of
//   2-3 stages in pass 2 only.
// - The consumers load the block's key scales sk, sv and key validity into
//   shared memory once, together, while Q and K are in flight ((B, S, H)
//   f32: 4 bytes per key and head, below TMA's 16-byte box).
// - Producer warps B and C relay each ring stage: they wait for the TMA
//   bytes, convert V's int8 to bf16 into a 128-byte-swizzled MN-major tile
//   (exact; the only conversion; one warp alone held the tower's consumers
//   back), fence the async proxy and release the stage to the consumers.
// - Consumers: S = Q K^T on wgmma m64n64k32 s8.s8 -> s32 (A and B from
//   shared memory, K-major), 3 k-steps over the head padded to 96 bytes;
//   the s32 accumulator has the f32 layout, so scaling, masking and the max
//   run in registers. Pass 2 packs bf16(p * sv) straight into A fragments
//   for O += P V on wgmma m64n{80,96}k16 with V from shared memory. Within
//   a warpgroup each tile's steps run in sequence (overlapping the next
//   tile's product with this one's max or P V made ptxas serialise the
//   wgmma: notes C7517, C7518, PERF.md); the three warpgroups overlap.
// - Tile classes per (64 query rows, 64 keys), as flash_mma_fwd.cu and the
//   mirror aki_torch/ops/flash_mma_args.py:tile_classes: skip (never loaded
//   when the whole block skips it), full (no mask), partial (the O(1)
//   rectangle test: image bitmasks of the row against those of the key).
//   A launch counts the tiles each pass ran by class when a check asks it
//   to (flash_mma_q8_count_tiles).
// Only H == Hkv: the wrapper routes GQA to flash_mma_fwd, as JAX does.
// exp2 is exp2f (no flush), as in the TPU kernel's steps.
//
// What bounds it on an H100: at the serving admission shape (48 rows of 655
// tokens, 32 heads x 96, MMA, ragged) the function must move ~0.45 GB (int8
// q, k, v, f32 scales, bf16 out): 0.136 ms at 3.35 TB/s, while its int8 QK
// and bf16 PV need ~0.04 ms at the tensor-core peaks, so the bytes are the
// bound; at the tower (48 x 729, 16 x 72, full) the operations are
// (0.089 ms). What holds it back (PERF.md): inside a warpgroup each tile's
// steps run in sequence, latency-bound; pass 2 costs about one
// flash_mma_fwd.cu tile per tile and pass 1 over half that again (the
// scores are formed twice, each with two f32 products), so it runs at
// 2.1-2.7x K1's time on the same tensors; a block's start (K landing) is
// not overlapped with any work.
//
// Plain C interface (bound with ctypes); launches on the caller's stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#include "hopper.cuh"

namespace {

constexpr int kDQ = 96;          // int8 depth of the QK product: 3 k-steps of 32 bytes
constexpr int kMaxTiles = 16;    // KV tiles of S <= 1024
constexpr int kMaxSmem = 232448; // dynamic shared memory a block may use
constexpr int kStageBytes = 3 * kTileBytes;   // ring stage: V's int8 tile, its bf16 tile

// Shared layout from a 1024-byte-aligned base: Q [NC tiles], resident K
// [n_tiles], the ring [stages], the key scales sk and sv and the key
// validity bits of every tile, the mbarriers, the image coordinates.
struct Layout {
  int k, ring, sk, sv, vbits, bars, coords, total;
};

__host__ __device__ inline Layout layout(int nc, int n_tiles, int stages) {
  Layout m;
  m.k = nc * kTileBytes;
  m.ring = m.k + n_tiles * kTileBytes;
  m.sk = m.ring + stages * kStageBytes;
  m.sv = m.sk + n_tiles * kBlockN * 4;
  m.vbits = m.sv + n_tiles * kBlockN * 4;
  m.bars = m.vbits + n_tiles * 8;
  m.coords = m.bars + (1 + kMaxTiles + 3 * stages) * 8;
  m.total = 1024 + m.coords + 3 * kMaxImages * 4;
  return m;
}

// Four int8 (one register) -> four bf16 (two registers), exactly:
// 2^23 + (x + 128) is a float whose low byte is x + 128.
__device__ __forceinline__ uint2 s8x4_to_bf16(uint32_t w) {
  const uint32_t u = w ^ 0x80808080u;
  const float bias = 8388736.f;   // 2^23 + 128
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
    f[i] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7650 + i)), bias);
  return make_uint2(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]));
}

// An int32 of magnitude below 2^22 as a float, exactly, in two full-rate
// instructions: 1.5 * 2^23 + x has x in its low mantissa bits.
__device__ __forceinline__ float s32_to_f32(int x) {
  return __fsub_rn(__int_as_float(x + 0x4B400000), 12582912.f);
}

// DP: head dim padded to 80 or 96 for the PV product; NC: consumer
// warpgroups (64 query rows each).
template <int DP, int NC>
__global__ void __launch_bounds__(NC * 128 + 96, NC == 1 ? 2 : 1)
flash_mma_q8_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const float* __restrict__ sq,        // (B, T, H), scale*log2e folded in
                    const float* __restrict__ sk,        // (B, S, H)
                    const float* __restrict__ sv,        // (B, S, H)
                    __nv_bfloat16* __restrict__ o,       // (B, T, H, D)
                    const int* __restrict__ kv_valid,    // (B, S) or null
                    const int* __restrict__ q_offset,    // (B,)
                    const int* __restrict__ img_start,   // (B, n_img)
                    const int* __restrict__ txt_start,
                    const int* __restrict__ txt_end,
                    int* __restrict__ tile_counts,       // [pass][skip, full, partial] or null
                    int n_img, int T, int S, int H, int D, int causal, int stages) {
  constexpr int BM = NC * 64;
  constexpr int kConsumers = NC * 128;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;
  const Layout L = layout(NC, n_tiles, stages);

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Qs = base;
  unsigned char* Ks = base + L.k;
  unsigned char* ring = base + L.ring;
  float* sk_s = reinterpret_cast<float*>(base + L.sk);
  float* sv_s = reinterpret_cast<float*>(base + L.sv);
  uint64_t* vbits = reinterpret_cast<uint64_t*>(base + L.vbits);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(base + L.bars);
  uint64_t* kbar = q_full + 1;             // K tile j landed
  uint64_t* loaded = kbar + kMaxTiles;     // a stage's TMA bytes landed
  uint64_t* full = loaded + stages;        // a stage's V is ready for the consumers
  uint64_t* empty = full + stages;         // the consumers are done with a stage
  int* i0_s = reinterpret_cast<int*>(base + L.coords);
  int* t0_s = i0_s + kMaxImages;
  int* t1_s = t0_s + kMaxImages;

  // the query tiles of one (head, batch row) are launched next to each
  // other; causal: the last query tiles walk the most KV tiles, start them
  // first
  const int qt = causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = qt * BM;
  const int tid = threadIdx.x;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0), lane = tid & 31;
  const int off = q_offset[b];
  const int q_first = off + q0;
  const int q_last = off + min(q0 + BM, T) - 1;
  // a box starts at a 16-byte boundary: the head's bytes sit at byte hb of
  // every box row (8 for odd heads at D = 72 or 88, else 0)
  const int c0 = (h * D) & ~15, hb = h * D - c0;

  if (tid < n_img) {
    i0_s[tid] = img_start[b * n_img + tid];
    t0_s[tid] = txt_start[b * n_img + tid];
    t1_s[tid] = txt_end[b * n_img + tid];
  }
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int j = 0; j < n_tiles; ++j) mbar_init(&kbar[j], 1);
    for (int s = 0; s < stages; ++s) {
      mbar_init(&loaded[s], 1);
      mbar_init(&full[s], 64);
      mbar_init(&empty[s], NC * 4);
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

  if (warp == NC * 4) {
    // producer A: lane 0 issues every TMA load of the block: Q, the K tiles
    // it visits, then V through the ring
    if (lane == 0) {
      int q_bytes = 0;
      for (int w = 0; w < NC; ++w)
        if (q0 + 64 * w < T) q_bytes += kTileBytes;
      mbar_expect_tx(q_full, q_bytes);
      for (int w = 0; w < NC; ++w)
        if (q0 + 64 * w < T) tma_load3(Qs + w * kTileBytes, &tm_q, q_full, c0, q0 + 64 * w, b);
      for (int j = 0; j < n_tiles; ++j) {
        if (!visit(j * kBlockN, q_first, q_last)) continue;
        mbar_expect_tx(&kbar[j], kTileBytes);
        tma_load3(Ks + j * kTileBytes, &tm_k, &kbar[j], c0, j * kBlockN, b);
      }
      int r = 0;   // ring uses so far: stage r % stages, phase (r / stages) & 1
      for (int j = 0; j < n_tiles; ++j) {
        if (!visit(j * kBlockN, q_first, q_last)) continue;
        const int st = r % stages;
        mbar_wait(&empty[st], ((r / stages) & 1) ^ 1);   // the first use of a stage passes
        mbar_expect_tx(&loaded[st], kTileBytes);
        tma_load3(ring + st * kStageBytes, &tm_v, &loaded[st], c0, j * kBlockN, b);
        ++r;
      }
    }
    return;
  }

  if (warp >= NC * 4 + 1) {
    const int half = warp - (NC * 4 + 1);
    // producers B and C: each stage's V int8 row bytes hb + [0, DP)
    // (128-byte swizzled) -> bf16 in two 64-lane chunks, 128-byte
    // swizzled, 8 values a step, half the steps each (eight lanes in a row
    // touch eight rows), then its release
    int r = 0;
    for (int j = 0; j < n_tiles; ++j) {
      if (!visit(j * kBlockN, q_first, q_last)) continue;
      const int st = r % stages;
      mbar_wait(&loaded[st], (r / stages) & 1);
      unsigned char* sb = ring + st * kStageBytes;
      for (int i = lane + 32 * half; i < (DP / 8) * 64; i += 64) {
        const int u = i >> 6, row = i & 63, sw = row & 7, byte = hb + 8 * u;
        const uint2 raw = *reinterpret_cast<const uint2*>(
            sb + row * 128 + (((byte >> 4) ^ sw) << 4) + (byte & 15));
        const uint2 lo = s8x4_to_bf16(raw.x), hi = s8x4_to_bf16(raw.y);
        *reinterpret_cast<uint4*>(sb + kTileBytes * (1 + (u >> 3)) + row * 128 +
                                  (((u & 7) ^ sw) << 4)) = make_uint4(lo.x, lo.y, hi.x, hi.y);
      }
      fence_proxy_async();
      mbar_arrive(&full[st]);
      ++r;
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
  const bool counter = tile_counts != nullptr && has_rows && (tid & 127) == 0;

  // the key scales and validity of every tile the block visits, the
  // loads of all consumers in flight together
  {
    constexpr int kPer = (kMaxTiles * kBlockN + kConsumers - 1) / kConsumers;
    const float* skb = sk + (size_t)b * S * H + h;
    const float* svb = sv + (size_t)b * S * H + h;
    const int* vb = kv_valid == nullptr ? nullptr : kv_valid + (size_t)b * S;
    float a[kPer], c[kPer];
    bool ok[kPer];
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int key = tid + u * kConsumers;
      const bool in = key < S && visit(key & ~(kBlockN - 1), q_first, q_last);
      a[u] = in ? skb[(size_t)key * H] : 0.f;
      c[u] = in ? svb[(size_t)key * H] : 0.f;
      ok[u] = in && (vb == nullptr || vb[key] != 0);
    }
#pragma unroll
    for (int u = 0; u < kPer; ++u) {
      const int key = tid + u * kConsumers;   // a warp holds 32 keys of one tile
      if (key < n_tiles * kBlockN) {
        sk_s[key] = a[u];
        sv_s[key] = c[u];
        const uint32_t bits = __ballot_sync(0xffffffffu, ok[u]);
        if (lane == 0) reinterpret_cast<uint32_t*>(vbits)[key >> 5] = bits;
      }
    }
  }
  const int row_abs[2] = {wg_first + wl * 16 + g, wg_first + wl * 16 + g + 8};
  uint32_t row_img[2] = {0u, 0u};   // images whose query span holds the row
  float sq_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = r0 + wl * 16 + g + 8 * i;
    sq_r[i] = row < T ? sq[((size_t)b * T + row) * H + h] : 0.f;
    for (int n = 0; n < n_img; ++n)
      if (row_abs[i] >= i0_s[n] && row_abs[i] < t0_s[n]) row_img[i] |= 1u << n;
  }
  // whether a row of this warp lies in an image's query span: the
  // rectangle test of partial tiles is needed only then
  const bool any_img = __any_sync(0xffffffffu, (row_img[0] | row_img[1]) != 0u);
  unsigned char* q_tile = Qs + wg * kTileBytes;
  const uint32_t q_base = smem_addr(q_tile);
  mbar_wait(q_full, 0);
  if (has_rows && D < kDQ) {
    // Q's box bytes [0, 96) outside the head's [hb, hb + D) hold a
    // neighbour head's (or zeros): zero them, so that the product over 96
    // bytes is the product over the head
    const int units = (kDQ - D) / 8, before = hb / 8;
    for (int u = tid & 127; u < 64 * units; u += 128) {
      const int row = u / units, k = u % units;
      const int byte = k < before ? 8 * k : hb + D + 8 * (k - before);
      *reinterpret_cast<uint2*>(q_tile + row * 128 + (((byte >> 4) ^ (row & 7)) << 4) +
                                (byte & 15)) = make_uint2(0u, 0u);
    }
    fence_proxy_async();
  }
  // the consumers' scales and Q writes are done
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");

  // this warpgroup's class of a tile the block visits, from its key validity
  auto classify = [&](int k0, uint64_t vmask) {
    if (!has_rows || !visit(k0, wg_first, wg_last)) return kSkip;
    return vmask == ~0ull && (!causal || k0 + kBlockN - 1 <= wg_first) ? kFull : kPartial;
  };
  // Issue S = Q K^T of K tile j (one committed group)
  auto issue_qk = [&](int j, int (&si)[32]) {
    const uint32_t kaddr = smem_addr(Ks + j * kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kDQ / 32; ++kk)
      wgmma_s8_n64(si, sw128_desc(q_base + kk * 32, 16), sw128_desc(kaddr + kk * 32, 16),
                   kk > 0);
    wgmma_commit();
  };
  // The scores of tile j (class cls) from its product, masked to -inf on a
  // partial tile; s[4 jt + 2 r + e] is row g + 8 r, key column 8 jt + 2 t4
  // + e. The same instructions in both passes.
  auto scores = [&](int j, int cls, const int (&si)[32], float (&s)[32]) {
    const int k0 = j * kBlockN;
    const uint64_t vmask = vbits[j];
    uint32_t kimg_lo = 0u, kimg_hi = 0u;   // images whose text span holds key k0 + lane, + 32
    const bool rects = cls == kPartial && causal && any_img;
    if (rects) {
      for (int n = 0; n < n_img; ++n) {
        const int a = k0 + lane, c = k0 + 32 + lane;
        kimg_lo |= static_cast<uint32_t>(a >= t0_s[n] && a < t1_s[n]) << n;
        kimg_hi |= static_cast<uint32_t>(c >= t0_s[n] && c < t1_s[n]) << n;
      }
    }
#pragma unroll
    for (int jt = 0; jt < 8; ++jt) {
      const float2 sk2 = *reinterpret_cast<const float2*>(sk_s + k0 + jt * 8 + 2 * t4);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kc = jt * 8 + 2 * t4 + e;
        const float skv = e ? sk2.y : sk2.x;
        const uint32_t kbits =
            rects ? __shfl_sync(0xffffffffu, jt < 4 ? kimg_lo : kimg_hi, kc & 31) : 0u;
        const bool kval = (vmask >> kc) & 1ull;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int i = jt * 4 + r * 2 + e;
          const float x = __fmul_rn(__fmul_rn(s32_to_f32(si[i]), sq_r[r]), skv);
          const bool ok = cls == kFull || (kval && (!causal || k0 + kc <= row_abs[r] ||
                                                    (row_img[r] & kbits) != 0u));
          s[i] = ok ? x : -INFINITY;
        }
      }
    }
  };

  // the tiles the block visits, those this warpgroup computes, and which
  // of them are full
  uint32_t vis = 0u, todo = 0u, full_bits = 0u;
  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kBlockN;
    if (!visit(k0, q_first, q_last)) continue;
    vis |= 1u << j;
    const int cls = classify(k0, vbits[j]);
    if (cls != kSkip) todo |= 1u << j;
    if (cls == kFull) full_bits |= 1u << j;
  }
  auto class_of = [&](int j) {
    return !((todo >> j) & 1u) ? kSkip : ((full_bits >> j) & 1u ? kFull : kPartial);
  };
  int si[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) si[i] = 0;

  // pass 1: the row max over every allowed key, each tile as its K lands
  float m_row[2] = {-INFINITY, -INFINITY};
  for (int j = 0; j < n_tiles; ++j) {
    const int cls = class_of(j);
    if (counter) atomicAdd(&tile_counts[cls], 1);
    if (cls == kSkip) continue;
    mbar_wait(&kbar[j], 0);
    issue_qk(j, si);
    wgmma_wait_all();
    fence_regs(si);
    float s[32];
    scores(j, cls, si, s);
#pragma unroll
    for (int i = 0; i < 32; ++i) m_row[(i >> 1) & 1] = fmaxf(m_row[(i >> 1) & 1], s[i]);
  }
  float m_use[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    m_row[i] = fmaxf(m_row[i], __shfl_xor_sync(0xffffffffu, m_row[i], 1));
    m_row[i] = fmaxf(m_row[i], __shfl_xor_sync(0xffffffffu, m_row[i], 2));
    // a row with no allowed key keeps p == 0 and writes 0
    m_use[i] = m_row[i] == -INFINITY ? 0.f : m_row[i];
  }

  // pass 2: p against the final max, l in f32, O += bf16(p * sv) V
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float l_row[2] = {0.f, 0.f};
  int r = 0;   // ring uses so far, as the producers count them
  for (int j = 0; j < n_tiles; ++j) {
    const int cls = class_of(j);
    if (counter) atomicAdd(&tile_counts[3 + cls], 1);
    if (!((vis >> j) & 1u)) continue;
    const int st = r % stages;
    mbar_wait(&full[st], (r / stages) & 1);
    if (cls != kSkip) {
      issue_qk(j, si);
      wgmma_wait_all();
      fence_regs(si);
      float s[32];
      scores(j, cls, si, s);
      uint32_t pn[kBlockN / 16][4];
#pragma unroll
      for (int jt = 0; jt < 8; ++jt) {
        const int kc = j * kBlockN + jt * 8 + 2 * t4;
        const float2 v = *reinterpret_cast<const float2*>(sv_s + kc);
        const float v0 = v.x, v1 = v.y;
        const float p0 = exp2f(__fsub_rn(s[jt * 4 + 0], m_use[0]));
        const float p1 = exp2f(__fsub_rn(s[jt * 4 + 1], m_use[0]));
        const float p2 = exp2f(__fsub_rn(s[jt * 4 + 2], m_use[1]));
        const float p3 = exp2f(__fsub_rn(s[jt * 4 + 3], m_use[1]));
        l_row[0] += p0 + p1;
        l_row[1] += p2 + p3;
        const int kk = jt >> 1, hi = (jt & 1) * 2;
        pn[kk][hi] = pack_bf16(__fmul_rn(p0, v0), __fmul_rn(p1, v1));
        pn[kk][hi + 1] = pack_bf16(__fmul_rn(p2, v0), __fmul_rn(p3, v1));
      }
      // O += P V: V's 16-key k-steps, MN-major, one product over DP lanes
      const uint32_t vs = smem_addr(ring + st * kStageBytes + kTileBytes);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs<DP>(acc, pn[kk], sw128_desc(vs + kk * 2048, kTileBytes));
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
    ++r;
  }
  if (!has_rows) return;

  // out = acc / l; a row with no allowed key writes 0
  const size_t q_stride = (size_t)H * D;
  __nv_bfloat16* ob = o + ((size_t)b * T) * q_stride + (size_t)h * D;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_row[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const int row = r0 + wl * 16 + g + 8 * i;
    if (row >= T) continue;
    const bool live = m_row[i] != -INFINITY;
    __nv_bfloat16* orow = ob + (size_t)row * q_stride;
#pragma unroll
    for (int jt = 0; jt < DP / 8; ++jt) {
      const int d = jt * 8 + 2 * t4;
      if (d < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + d) =
            __floats2bfloat162_rn(live ? acc[jt * 4 + 2 * i] / l : 0.f,
                                  live ? acc[jt * 4 + 2 * i + 1] / l : 0.f);
    }
  }
}

// The tile counts that launches add to while a check has set them
// (flash_mma_q8_count_tiles); null otherwise.
int* g_tile_counts = nullptr;

// The launch plan of a B x T x S x H call (aki_torch/ops/flash_mma_q8.py:
// q8_plan mirrors it): query rows per block, ring stages, shared bytes.
struct Plan {
  int rows, stages, smem;
};

Plan plan(int B, int T, int S, int H, int sms) {
  Plan p;
  const int nc = (long)B * H * ((T + 191) / 192) >= 2L * sms ? 3 : 1;
  const int n_tiles = (S + kBlockN - 1) / kBlockN;
  p.rows = 64 * nc;
  p.stages = layout(nc, n_tiles, 3).total <= kMaxSmem ? 3 : 2;
  p.smem = layout(nc, n_tiles, p.stages).total;
  return p;
}

// The TMA map of an int8 tensor of B x L rows of `ld` bytes as dims (ld,
// L, B), boxes of 128 bytes x 64 rows, 128-byte swizzle, zero fill out of
// bounds.
bool row_map(CUtensorMap* map, const void* ptr, int B, int L, int ld) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)ld, (cuuint64_t)L, (cuuint64_t)B};
  const cuuint64_t strides[2] = {(cuuint64_t)ld, (cuuint64_t)L * ld};
  const cuuint32_t box[3] = {128, 64, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NC>
int launch(const CUtensorMap& tq, const CUtensorMap& tk, const CUtensorMap& tv,
           const void* sq, const void* sk, const void* sv, void* o, const void* kv_valid,
           const void* q_offset, const void* img_start, const void* txt_start,
           const void* txt_end, int n_img, int B, int T, int S, int H, int D, int causal,
           const Plan& p, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(flash_mma_q8_kernel<DP, NC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((T + p.rows - 1) / p.rows, H, B);
  flash_mma_q8_kernel<DP, NC><<<grid, NC * 128 + 96, p.smem, stream>>>(
      tq, tk, tv, static_cast<const float*>(sq), static_cast<const float*>(sk),
      static_cast<const float*>(sv), static_cast<__nv_bfloat16*>(o),
      static_cast<const int*>(kv_valid), static_cast<const int*>(q_offset),
      static_cast<const int*>(img_start), static_cast<const int*>(txt_start),
      static_cast<const int*>(txt_end), g_tile_counts, n_img, T, S, H, D, causal, p.stages);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" const char* flash_mma_q8_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// For checks: from now on every launch adds, per consumer warpgroup with
// rows and per pass, the (64 rows x 64 keys) tiles it ran to counts[3 *
// pass + class] (skip, full, partial; int32 on the current device), one
// atomic per tile; null stops it. Not for concurrent callers.
extern "C" void flash_mma_q8_count_tiles(void* counts) {
  g_tile_counts = static_cast<int*>(counts);
}

// The launch plan on the current device: out[0..2] = query rows per block,
// ring stages, dynamic shared bytes. Returns a cudaError_t.
extern "C" int flash_mma_q8_plan(int B, int T, int S, int H, int* out) {
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan(B, T, S, H, sms);
  out[0] = p.rows;
  out[1] = p.stages;
  out[2] = p.smem;
  return 0;
}

// q8 (B,T,H,D), k8/v8 (B,S,H,D) int8, each token's H*D bytes at a stride
// of `ld` bytes (ld % 16 == 0, ld >= max(H*D, 128); ld > H*D: the wrapper's
// zero-padded copy), 16-byte aligned; D % 8 == 0, 72 <= D <= 96; S <= 1024.
// sq (B,T,H), sk/sv (B,S,H) contiguous f32 (sq with scale*log2(e) folded
// in); o (B,T,H,D) contiguous bf16. kv_valid (B,S) int32 or null; q_offset
// (B,) int32; img_start/txt_start/txt_end (B,n_img) int32, n_img <=
// kMaxImages.
extern "C" int flash_mma_q8(const void* q8, const void* k8, const void* v8, const void* sq,
                            const void* sk, const void* sv, void* o, const void* kv_valid,
                            const void* q_offset, const void* img_start,
                            const void* txt_start, const void* txt_end, int n_img, int B,
                            int T, int S, int H, int D, int ld, int causal, void* stream) {
  if (D % 8 != 0 || D < 72 || D > kDQ || H <= 0 || n_img < 0 || n_img > kMaxImages ||
      B <= 0 || T <= 0 || S <= 0 || S > kMaxTiles * kBlockN || ld % 16 != 0 ||
      ld < H * D || ld < 128)
    return (int)cudaErrorInvalidValue;
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap tq, tk, tv;
  if (!row_map(&tq, q8, B, T, ld) || !row_map(&tk, k8, B, S, ld) ||
      !row_map(&tv, v8, B, S, ld))
    return (int)cudaErrorInvalidValue;
  int sms = 0;
  cudaError_t err = sm_count(&sms);
  if (err != cudaSuccess) return (int)err;
  const Plan p = plan(B, T, S, H, sms);
  if (p.smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define AKI_LAUNCH(DP, NC)                                                                \
  return launch<DP, NC>(tq, tk, tv, sq, sk, sv, o, kv_valid, q_offset, img_start, txt_start, \
                        txt_end, n_img, B, T, S, H, D, causal, p, st)
  if (D > 80) {
    if (p.rows == 192) AKI_LAUNCH(96, 3);
    AKI_LAUNCH(96, 1);
  }
  if (p.rows == 192) AKI_LAUNCH(80, 3);
  AKI_LAUNCH(80, 1);
#undef AKI_LAUNCH
}
