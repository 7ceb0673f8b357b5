// FlashAttention forward for Hopper (sm_90a): causal (or full) GQA
// attention of a batch of sequences over their own keys.
//
// Replaces the TPU kernel `flash_attention` (kernels/flash_attention.py:97,
// body `_flash_kernel` :30) of the JAX package. Query i of a sequence sits at
// position i and attends keys j < Sk with j <= i (causal) and, with a window
// w, j > i - w. GQA: query head h = kv*G + g reads KV head kv. Softcap before
// the mask, fp32 online softmax, NEG_INF -1e30, guard l >= 1e-37: the TPU
// kernel's semantics.
//
// What bounds it on an H100: a long causal prompt does 4 H d Sq Sk / 2
// operations against (Sq + 2 Sk) KV d + Sq H d elements moved, so from a few
// hundred tokens on it is the tensor cores' 989 TFLOP/s (bf16) that bound it,
// and only wgmma, issued by a warpgroup from shared memory, reaches that
// rate. One CTA per (q tile, KV head, batch row) holds the tile's queries of
// all G heads of that KV head (so one staged K/V block serves G heads),
// keeps the softmax state and the output accumulator in registers, and never
// writes the scores out. Key blocks wholly above the tile's diagonal or left
// of its window are never visited, and the most expensive (last) causal tiles
// start first. Three paths:
//
//   bf16, d in {64, 128, 256} (the serving path): warp-specialised wgmma. A
//     producer warp keeps a ring of two K/V stages full with TMA loads that
//     complete on mbarriers (the tensor maps are built on the host per call
//     from the cache view's strides, so a prefix view of a (B, max_len, KV,
//     d) cache is read in place, and keys past Sk come back zero); two
//     consumer warpgroups of 64 query vectors each run S = Q K^T as wgmma
//     m64nNk16 with Q and K from shared memory (N = 128 keys, 64 at d = 256)
//     and O += P V as wgmma m64n{d}k16 with P from registers. setmaxnreg
//     moves registers from the producer to the consumers: at d = 256 O alone
//     is 64 x 256 / 128 = 128 fp32 registers a thread.
//   bf16, d in {16, 32}: mma.sync m16n8k16 (attn::MmaRows, 8 warps x 16
//     query vectors) on K/V blocks of 64 keys copied by cp.async,
//     double-buffered: at these widths a 64-wide swizzled TMA box does not
//     fit the row.
//   fp32 (the exactness checks): the CUDA cores, 64 query vectors per CTA.
//
// The kernel reads the model's layouts in place: q and out (B, Sq, H, d)
// contiguous, k and v (B, Sk, KV, d) with any element strides of batch, key
// and head (d contiguous). Sq need not be a multiple of the tile: the last
// tile is short.
#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;

constexpr int NT = 256;     // threads per CTA
constexpr int BK = 64;      // keys per block
constexpr int M_F32 = 64;   // query vectors per CTA, fp32
constexpr int M_MMA = 128;  // query vectors per CTA, bf16 (8 warps x 16 rows; 2 x 64 for wgmma)
constexpr int PAD = 4;      // fp32 row padding of K and the scores
constexpr int MMA_PAD = 8;  // bf16 row padding of the staged K and V

struct Tile {
  int p0;    // first query position
  int m_eff; // live query vectors: positions x G
  int k_lo;  // keys [k_lo, k_hi) any row of the tile may read
  int k_hi;
};

// the CTA's tile; blocks run in reverse so the longest causal tiles go first
__device__ __forceinline__ Tile tile_of(int qt, int g, int sq, int sk, int causal, int window) {
  Tile t;
  t.p0 = int(gridDim.x - 1 - blockIdx.x) * qt;
  const int nq = min(qt, sq - t.p0);
  t.m_eff = nq * g;
  t.k_hi = causal ? min(sk, t.p0 + nq) : sk;
  t.k_lo = window > 0 ? max(0, t.p0 - window + 1) : 0;
  return t;
}

__device__ __forceinline__ bool visible(int kp, int qp, int k_hi, int causal, int window) {
  return kp < k_hi && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
}

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores
// ---------------------------------------------------------------------------

template <int D>
constexpr size_t f32_smem_bytes() {
  return sizeof(float) * (M_F32 * D + BK * (D + PAD) + BK * D + M_F32 * (BK + PAD) + 3 * M_F32);
}

// one CTA per SM at the least: ptxas may use up to 255 registers rather
// than spill to fit more
template <int D>
__global__ void __launch_bounds__(NT, 1) flash_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
    float* __restrict__ out, int sq, int sk, int n_kv, int g, int qt, long long sb,
    long long ss, long long sh, float scale, float softcap, int window, int causal) {
  constexpr int SRG = NT / BK;       // row groups in the score product
  constexpr int SRPT = M_F32 / SRG;  // rows per thread there
  constexpr int RG = NT / D;         // row groups in the value product
  constexpr int RPT = M_F32 / RG;    // rows per thread there
  constexpr int KS = D + PAD, SS = BK + PAD;
  static_assert(D % 4 == 0 && NT % D == 0 && NT % BK == 0 && BK == 64, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;            // [M_F32][D]
  float* ks = qs + M_F32 * D;  // [BK][KS]
  float* vs = ks + BK * KS;    // [BK][D]
  float* sc = vs + BK * D;     // [M_F32][SS] scores, then probabilities
  float* m_s = sc + M_F32 * SS;
  float* l_s = m_s + M_F32;
  float* a_s = l_s + M_F32;

  const int tid = threadIdx.x;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const Tile t = tile_of(qt, g, sq, sk, causal, window);
  const long long H = (long long)n_kv * g;
  const float* k_head = k + b * sb + kvh * sh;  // this CTA's KV head
  const float* v_head = v + b * sb + kvh * sh;

  // query vector r is head kvh * g + r % g at position p0 + r / g
  for (int e = tid * 4; e < t.m_eff * D; e += NT * 4) {
    const int r = e / D, x = e % D;
    const long long src = (((long long)b * sq + t.p0 + r / g) * H + kvh * g + r % g) * D + x;
    *reinterpret_cast<float4*>(qs + r * D + x) = __ldg(reinterpret_cast<const float4*>(q + src));
  }
  for (int r = tid; r < M_F32; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  const int dcol = tid % D, prg = tid / D;
  const int scol = tid % BK, srg = tid / BK;
  const int n_s = (t.m_eff - srg + SRG - 1) / SRG;
  const int n_o = (t.m_eff - prg + RG - 1) / RG;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int kb = t.k_lo; kb < t.k_hi; kb += BK) {
    // 1. K and V of the block; keys past k_hi are never loaded
    for (int e = tid * 4; e < BK * D; e += NT * 4) {
      const int c = e / D, x = e % D;
      float4 kt = make_float4(0.f, 0.f, 0.f, 0.f), vt = kt;
      if (kb + c < t.k_hi) {
        const long long off = (kb + c) * ss + x;
        kt = __ldg(reinterpret_cast<const float4*>(k_head + off));
        vt = __ldg(reinterpret_cast<const float4*>(v_head + off));
      }
      *reinterpret_cast<float4*>(ks + c * KS + x) = kt;
      *reinterpret_cast<float4*>(vs + c * D + x) = vt;
    }
    __syncthreads();
    // 2. scores: thread owns key column scol for rows srg, srg + SRG, ...
    {
      float sacc[SRPT];
#pragma unroll
      for (int i = 0; i < SRPT; ++i) sacc[i] = 0.f;
      if (n_s == SRPT)
        dot_rows<SRPT, D, true>(sacc, qs, ks + scol * KS, srg, SRG, n_s);
      else
        dot_rows<SRPT, D, false>(sacc, qs, ks + scol * KS, srg, SRG, n_s);
      const int kp = kb + scol;
#pragma unroll
      for (int i = 0; i < SRPT; ++i) {
        if (i >= n_s) break;
        const int r = srg + SRG * i;
        float s = sacc[i] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        sc[r * SS + scol] = visible(kp, t.p0 + r / g, t.k_hi, causal, window) ? s : -INFINITY;
      }
    }
    __syncthreads();
    // 3. online softmax, one warp per row; masked keys get p = 0 exactly
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < t.m_eff; r += NT / 32) {
        float* srow = sc + r * SS;
        const float s0 = srow[lane], s1 = srow[lane + 32];
        const bool ok0 = s0 != -INFINITY, ok1 = s1 != -INFINITY;
        float mx = NEG_INF;
        if (ok0) mx = fmaxf(mx, s0);
        if (ok1) mx = fmaxf(mx, s1);
        mx = warp_max(mx);
        const float m_old = m_s[r];
        const float m_new = fmaxf(m_old, mx);
        const float p0 = ok0 ? expf(s0 - m_new) : 0.f;
        const float p1 = ok1 ? expf(s1 - m_new) : 0.f;
        const float sum = warp_sum(p0 + p1);
        srow[lane] = p0;
        srow[lane + 32] = p1;
        __syncwarp();
        if (lane == 0) {
          const float alpha = expf(m_old - m_new);
          a_s[r] = alpha;
          l_s[r] = alpha * l_s[r] + sum;
          m_s[r] = m_new;
        }
      }
    }
    __syncthreads();
    // 4. acc = alpha * acc + P V: thread owns output column dcol
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (i >= n_o) break;
      acc[i] *= a_s[prg + RG * i];
    }
    if (n_o == RPT)
      pv_rows<RPT, D, SS, BK, true>(acc, sc, vs, dcol, prg, RG, n_o);
    else
      pv_rows<RPT, D, SS, BK, false>(acc, sc, vs, dcol, prg, RG, n_o);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (i >= n_o) break;
    const int r = prg + RG * i;
    const long long dst = (((long long)b * sq + t.p0 + r / g) * H + kvh * g + r % g) * D + dcol;
    out[dst] = acc[i] / fmaxf(l_s[r], 1e-37f);
  }
}

// ---------------------------------------------------------------------------
// bf16, d <= 32: mma.sync
// ---------------------------------------------------------------------------
//
// FlashAttention-2's register layout (attn::MmaRows): warp w owns the tile's
// query vectors 16w..16w+15, its Q fragments in registers.

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 4 * BK * (D + MMA_PAD);  // 2 stages x (K, V)
}

template <int D>
__global__ void __launch_bounds__(NT) flash_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out, int sq, int sk,
    int n_kv, int g, int qt, long long sb, long long ss, long long sh, float scale,
    float softcap, int window, int causal) {
  constexpr int KSTR = D + MMA_PAD;  // staged row stride (bf16); rows stay 16-byte aligned
  constexpr int VEC = 8;             // bf16 per 16-byte copy
  using Rows = MmaRows<D, KSTR>;
  static_assert(BK == MMA_BK && M_MMA == 16 * (NT / 32) && !Rows::Q_SMEM, "mma tile shape");

  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [stage][K, V][BK][KSTR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const Tile t = tile_of(qt, g, sq, sk, causal, window);
  const long long H = (long long)n_kv * g;
  const __nv_bfloat16* k_head = k + b * sb + kvh * sh;  // this CTA's KV head
  const __nv_bfloat16* v_head = v + b * sb + kvh * sh;
  const bool active = warp * 16 < t.m_eff;  // owns a live row

  // this thread's two tile rows (the mma's rows gid and gid + 8), their query
  // positions and their offsets in q / out; rows at or past m_eff are zero
  // and never written
  const int ra = warp * 16 + gid, rb = ra + 8;
  const int qpa = t.p0 + ra / g, qpb = t.p0 + rb / g;
  const long long base_a = (((long long)b * sq + qpa) * H + kvh * g + ra % g) * D;
  const long long base_b = (((long long)b * sq + qpb) * H + kvh * g + rb % g) * D;
  Rows rows;
  rows.init();
  rows.load_q(q, base_a, base_b, ra < t.m_eff, rb < t.m_eff);
  // the keys each row reads: below k_hi, at or before its position when
  // causal, inside its window
  const int hi_a = causal ? min(qpa + 1, t.k_hi) : t.k_hi;
  const int hi_b = causal ? min(qpb + 1, t.k_hi) : t.k_hi;
  const int lo_a = window > 0 ? qpa - window + 1 : 0, lo_b = window > 0 ? qpb - window + 1 : 0;

  // copy keys [kb, kb + BK) of K and V into stage buf; keys >= k_hi zero-filled
  auto stage = [&](int buf, int kb) {
    __nv_bfloat16* ks = kv_s + buf * 2 * BK * KSTR;
    __nv_bfloat16* vs = ks + BK * KSTR;
    for (int e = tid * VEC; e < BK * D; e += NT * VEC) {
      const int c = e / D, x = e % D;
      const bool ok = kb + c < t.k_hi;
      const long long off = ok ? (kb + c) * ss + x : 0;
      cp_async16(ks + c * KSTR + x, k_head + off, ok);
      cp_async16(vs + c * KSTR + x, v_head + off, ok);
    }
    cp_async_commit();
  };

  if (t.k_lo < t.k_hi) stage(0, t.k_lo);
  int buf = 0;
  for (int kb = t.k_lo; kb < t.k_hi; kb += BK) {
    if (kb + BK < t.k_hi) {
      stage(buf ^ 1, kb + BK);  // the next block's copy runs under this block
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kv_s + buf * 2 * BK * KSTR;
    if (active) rows.block(ks, ks + BK * KSTR, kb, lo_a, hi_a, lo_b, hi_b, scale, softcap);
    __syncthreads();  // the next iteration's copy reuses this stage
    buf ^= 1;
  }
  if (active) rows.store(out, base_a, base_b, ra < t.m_eff, rb < t.m_eff);
}

// ---------------------------------------------------------------------------
// bf16, d in {64, 128, 256}: warp-specialised wgmma on TMA-fed K/V
// ---------------------------------------------------------------------------
//
// Warpgroup 0 produces (one thread issues the TMA loads; setmaxnreg gives
// up all but 24 of its registers); warpgroups 1 and 2 consume (setmaxnreg:
// 240 registers a thread, which O, S and P fit at d = 256), each owning 64
// of the tile's 128 query vectors. The role comes from a warp-uniform
// warpgroup index, so that ptxas allocates each branch its own registers.
// Shared memory, 1024-byte aligned, in 128-byte swizzled regions of 64
// columns (hopper.cuh): Q [consumer][d / 64][64][64],
// then per stage K and V [d / 64][keys][64], then the full and empty
// barriers of each stage. A stage's full barrier completes when its TMA
// bytes land; its empty barrier when all 256 consumer threads are done with
// it, and the producer waits for that before reusing the stage.

constexpr int WG_THREADS = 384;     // the producer warpgroup, then 2 consumer warpgroups
constexpr int WG_STAGES = 2;        // K/V stages in the ring (a third gains nothing)
constexpr int PRODUCER_REGS = 24;   // registers a producer thread keeps (setmaxnreg)
constexpr int CONSUMER_REGS = 240;  // and a consumer thread: 128 x 24 + 256 x 240 = 384 x 168

template <int D>
__host__ __device__ constexpr int wg_keys() {
  return D > 128 ? 64 : 128;  // keys per block: N of S = Q K^T
}

template <int D>
constexpr size_t wg_smem_bytes() {
  return 1024 + sizeof(__nv_bfloat16) * (M_MMA * D + WG_STAGES * 2 * wg_keys<D>() * D) +
         sizeof(uint64_t) * 2 * WG_STAGES;
}

template <int N>
__device__ __forceinline__ void wgmma_s(float (&s)[N / 2], uint64_t a, uint64_t b, int acc) {
  if constexpr (N == 64) hop::wgmma_ss_n64(s, a, b, acc);
  else hop::wgmma_ss_n128(s, a, b, acc);
}

template <int N>
__device__ __forceinline__ void wgmma_o(float (&o)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) hop::wgmma_rs_n64(o, a, b, 1);
  else if constexpr (N == 128) hop::wgmma_rs_n128(o, a, b, 1);
  else hop::wgmma_rs_n256(o, a, b, 1);
}

// scores x (S's accumulators: the row a of key tile j is x[4j], x[4j + 1],
// row b x[4j + 2], x[4j + 3], at keys k0 + 8j and k0 + 8j + 1) into base 2:
// x * mul, or cap2 * tanh(x * mul) with CAP; with MASK, keys outside
// [lo, hi) of their row to -inf; and each row's maximum
template <int N, bool CAP, bool MASK>
__device__ __forceinline__ void scale_mask(float (&x)[N / 2], float& mx_a, float& mx_b, int k0,
                                           int lo_a, int hi_a, int lo_b, int hi_b, float mul,
                                           float cap2) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float v = x[4 * j + e] * mul;
      if constexpr (CAP) v = cap2 * tanh_fast(v);
      if constexpr (MASK) {
        const int kp = k0 + j * 8 + (e & 1);
        if (e < 2 ? kp < lo_a || kp >= hi_a : kp < lo_b || kp >= hi_b) v = -INFINITY;
      }
      x[4 * j + e] = v;
      if (e < 2) mx_a = fmaxf(mx_a, v);
      else mx_b = fmaxf(mx_b, v);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, 1) flash_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, __nv_bfloat16* __restrict__ out,
    const __grid_constant__ CUtensorMap kmap, const __grid_constant__ CUtensorMap vmap, int sq,
    int sk, int n_kv, int g, int qt, float scale, float softcap, int window, int causal) {
  constexpr int KEYS = wg_keys<D>();
  constexpr int REG = 64 * 64;     // bf16 of one region of 64 rows (Q)
  constexpr int KREG = KEYS * 64;  // bf16 of one region of a K or V block
  constexpr int NC = D / 64;       // regions per row
  constexpr uint32_t STAGE_BYTES = 2 * KEYS * D * sizeof(__nv_bfloat16);
  constexpr float LOG2E = 1.4426950408889634f;
  static_assert(D % 64 == 0 && D <= 256 && M_MMA == 128, "wgmma tile shape");

  extern __shared__ unsigned char wg_smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* ks = qs + M_MMA * D;              // [stage][NC][KEYS][64]
  __nv_bfloat16* vs = ks + WG_STAGES * NC * KREG;  // [stage][NC][KEYS][64]
  uint64_t* full = reinterpret_cast<uint64_t*>(vs + WG_STAGES * NC * KREG);
  uint64_t* empty = full + WG_STAGES;

  const int kvh = blockIdx.y, b = blockIdx.z;
  const Tile t = tile_of(qt, g, sq, sk, causal, window);
  const int n_blocks = t.k_lo < t.k_hi ? (t.k_hi - t.k_lo + KEYS - 1) / KEYS : 0;
  if (threadIdx.x == 0) {
    for (int i = 0; i < WG_STAGES; ++i) {
      hop::mbar_init(&full[i], 1);
      hop::mbar_init(&empty[i], 256);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  const int role = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);  // warpgroup, warp-uniform
  if (role == 0) {
    // producer: fill stage i % 2 with block i once its last use is released
    hop::setmaxnreg_dec<PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (int i = 0; i < n_blocks; ++i) {
        const int st = i % WG_STAGES, round = i / WG_STAGES;
        if (round > 0) hop::mbar_wait(&empty[st], (round - 1) & 1);
        hop::mbar_arrive_expect_tx(&full[st], STAGE_BYTES);
        const int kb = t.k_lo + i * KEYS;
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          hop::tma_load_4d(ks + (st * NC + c) * KREG, &kmap, &full[st], 64 * c, kvh, kb, b);
          hop::tma_load_4d(vs + (st * NC + c) * KREG, &vmap, &full[st], 64 * c, kvh, kb, b);
        }
      }
    }
  } else {
    hop::setmaxnreg_inc<CONSUMER_REGS>();
    const int wg = role - 1;  // consumer 0 or 1
    const int tw = threadIdx.x % 128, warp = tw / 32, lane = tw % 32;
    const int gid = lane / 4, tig = lane % 4;
    const long long H = (long long)n_kv * g;
    __nv_bfloat16* qw = qs + wg * NC * REG;  // this warpgroup's 64 query vectors

    // Q, 128-byte swizzled: vector r = 64 wg + rr is head kvh * g + r % g at
    // position p0 + r / g; vectors at or past m_eff are zero. Every load is
    // issued before the first store, so a thread waits out one memory
    // latency, not one for each of its D / 16 chunks.
    constexpr int QCH = 64 * D / 8 / 128;  // 16-byte chunks a thread moves
    uint4 qv[QCH];
#pragma unroll
    for (int u = 0; u < QCH; ++u) {
      const int e = tw + 128 * u, rr = e / (D / 8), j = e % (D / 8), r = wg * 64 + rr;
      qv[u] = r < t.m_eff ? __ldg(reinterpret_cast<const uint4*>(
                                q + (((long long)b * sq + t.p0 + r / g) * H + kvh * g + r % g) * D +
                                j * 8))
                          : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < QCH; ++u) {
      const int e = tw + 128 * u, rr = e / (D / 8), j = e % (D / 8);
      *reinterpret_cast<uint4*>(qw + (j / 8) * REG + rr * 64 + (((j % 8) ^ (rr % 8)) * 8)) = qv[u];
    }
    hop::fence_proxy_async();
    hop::named_barrier(1 + wg, 128);

    // this thread's rows of the accumulators: gid and gid + 8 of its warp's 16
    const int ra = wg * 64 + warp * 16 + gid, rb = ra + 8;
    const int qpa = t.p0 + ra / g, qpb = t.p0 + rb / g;
    // the keys each row reads: below k_hi, at or before its position when
    // causal, inside its window
    const int hi_a = causal ? min(qpa + 1, t.k_hi) : t.k_hi;
    const int hi_b = causal ? min(qpb + 1, t.k_hi) : t.k_hi;
    const int lo_a = window > 0 ? qpa - window + 1 : 0, lo_b = window > 0 ? qpb - window + 1 : 0;
    const bool live = wg * 64 < t.m_eff;
    // the positions of this warpgroup's first and last live query vectors
    const int qp_lo = t.p0 + wg * 64 / g, qp_hi = t.p0 + (min(wg * 64 + 63, t.m_eff - 1)) / g;
    const float scale2 = scale * LOG2E;  // without a softcap
    const float cap_in = scale / softcap, cap2 = softcap * LOG2E;  // with one
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

    for (int i = 0; i < n_blocks; ++i) {
      const int st = i % WG_STAGES;
      const int kb = t.k_lo + i * KEYS;
      hop::mbar_wait(&full[st], (i / WG_STAGES) & 1);
      if (live) {
        // S = Q K^T: 64 vectors x KEYS keys, K-major Q and K from shared memory
        float s[KEYS / 2];
#pragma unroll
        for (int x = 0; x < KEYS / 2; ++x) s[x] = 0.f;
        // descriptors advance in 16-byte units: k-step kk is column 16 (kk %
        // 4) of region kk / 4
        const uint64_t dq = hop::desc_sw128(qw, 16, 1024);
        const uint64_t dk = hop::desc_sw128(ks + st * NC * KREG, 16, 1024);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 4, w = (kk % 4) * 16;
          wgmma_s<KEYS>(s, dq + (c * REG + w) / 8, dk + (c * KREG + w) / 8, 1);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(s);
        // scale and cap into base 2, then mask, but only in a block that
        // straddles the diagonal, the window's edge or the end of the keys
        // for some row of this warpgroup; online softmax in base 2
        // (each branch taken once a block: inside the loop the compiler would
        // predicate the softcap and issue the tanh of every score either way)
        const bool interior = kb + KEYS <= t.k_hi && (!causal || kb + KEYS - 1 <= qp_lo) &&
                              (window <= 0 || kb > qp_hi - window);
        float mx_a = NEG_INF, mx_b = NEG_INF;
        const int k0 = kb + 2 * tig;
        if (softcap > 0.f) {
          if (interior)
            scale_mask<KEYS, true, false>(s, mx_a, mx_b, k0, lo_a, hi_a, lo_b, hi_b, cap_in, cap2);
          else
            scale_mask<KEYS, true, true>(s, mx_a, mx_b, k0, lo_a, hi_a, lo_b, hi_b, cap_in, cap2);
        } else {
          if (interior)
            scale_mask<KEYS, false, false>(s, mx_a, mx_b, k0, lo_a, hi_a, lo_b, hi_b, scale2, 0.f);
          else
            scale_mask<KEYS, false, true>(s, mx_a, mx_b, k0, lo_a, hi_a, lo_b, hi_b, scale2, 0.f);
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            // a masked score (-inf) gives exactly 0
            const float pe = exp2_fast(s[4 * j + e] - (e < 2 ? mn_a : mn_b));
            s[4 * j + e] = pe;
            if (e < 2) sum_a += pe;
            else sum_b += pe;
          }
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          sum_a += __shfl_xor_sync(0xffffffffu, sum_a, sh);
          sum_b += __shfl_xor_sync(0xffffffffu, sum_b, sh);
        }
        const float al_a = exp2_fast(m_a - mn_a), al_b = exp2_fast(m_b - mn_b);
        l_a = al_a * l_a + sum_a;
        l_b = al_b * l_b + sum_b;
        m_a = mn_a;
        m_b = mn_b;
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          o[4 * j] *= al_a;
          o[4 * j + 1] *= al_a;
          o[4 * j + 2] *= al_b;
          o[4 * j + 3] *= al_b;
        }
        // O += P V: P's accumulators of key tiles 2k and 2k + 1, rounded to
        // bf16, are the A fragment of key step k; V is MN-major (d
        // contiguous), its regions of 64 columns KREG apart
        uint32_t pa[KEYS / 16][4];
#pragma unroll
        for (int k2 = 0; k2 < KEYS / 16; ++k2) {
          pa[k2][0] = pack_bf16(s[8 * k2], s[8 * k2 + 1]);
          pa[k2][1] = pack_bf16(s[8 * k2 + 2], s[8 * k2 + 3]);
          pa[k2][2] = pack_bf16(s[8 * k2 + 4], s[8 * k2 + 5]);
          pa[k2][3] = pack_bf16(s[8 * k2 + 6], s[8 * k2 + 7]);
        }
        const uint64_t dv = hop::desc_sw128(vs + st * NC * KREG, KREG * 2, 1024);
        hop::wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < KEYS / 16; ++k2) wgmma_o<D>(o, pa[k2], dv + k2 * 16 * 64 / 8);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(o);
#pragma unroll
        for (int k2 = 0; k2 < KEYS / 16; ++k2) hop::fence_regs(pa[k2]);
      }
      hop::mbar_arrive(&empty[st]);
    }

    if (live) {
      const float inv_a = 1.f / fmaxf(l_a, 1e-37f), inv_b = 1.f / fmaxf(l_b, 1e-37f);
      const long long base_a = (((long long)b * sq + qpa) * H + kvh * g + ra % g) * D;
      const long long base_b = (((long long)b * sq + qpb) * H + kvh * g + rb % g) * D;
      uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        const int x = j * 8 + 2 * tig;
        if (ra < t.m_eff) o32[(base_a + x) / 2] = pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
        if (rb < t.m_eff)
          o32[(base_b + x) / 2] = pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
      }
    }
  }
}

// The tensor map of K or V, (B, Sk, KV, d) with element strides sb, ss, sh:
// dimensions innermost first (d, KV, Sk, B); boxes of 64 columns x one head
// x ``keys`` keys x one batch row, 128-byte swizzled; keys past Sk read zero.
inline CUresult encode_kv_map(CUtensorMap* map, const void* base, int d, int n_kv, int sk,
                              int batch, long long sb, long long ss, long long sh, int keys) {
  const cuuint64_t dims[4] = {cuuint64_t(d), cuuint64_t(n_kv), cuuint64_t(sk), cuuint64_t(batch)};
  const cuuint64_t strides[3] = {cuuint64_t(sh) * 2, cuuint64_t(ss) * 2, cuuint64_t(sb) * 2};
  const cuuint32_t box[4] = {64, 1, cuuint32_t(keys), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return cuTensorMapEncodeTiled(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
                                dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

template <int D>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* out, int batch,
                         int sq, int sk, int n_kv, int g, long long sb, long long ss,
                         long long sh, float scale, float softcap, int window, int causal,
                         cudaStream_t stream) {
  CUtensorMap kmap, vmap;
  if (encode_kv_map(&kmap, k, D, n_kv, sk, batch, sb, ss, sh, wg_keys<D>()) != CUDA_SUCCESS ||
      encode_kv_map(&vmap, v, D, n_kv, sk, batch, sb, ss, sh, wg_keys<D>()) != CUDA_SUCCESS)
    return cudaErrorInvalidValue;
  const int qt = M_MMA / g;  // query positions per tile
  const size_t smem = wg_smem_bytes<D>();
  auto kernel = flash_wgmma_kernel<D>;
  static bool opted_in = false;
  const cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((sq + qt - 1) / qt, n_kv, batch), WG_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<__nv_bfloat16*>(out), kmap, vmap, sq, sk,
      n_kv, g, qt, scale, softcap, window, causal);
  return cudaGetLastError();
}

// bf16 at d >= 64 on wgmma, at d <= 32 on mma.sync; fp32 on the CUDA cores
template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out, int batch,
                         int sq, int sk, int n_kv, int g, long long sb, long long ss,
                         long long sh, float scale, float softcap, int window, int causal,
                         cudaStream_t stream) {
  constexpr bool MMA = sizeof(T) == 2;
  const int qt = (MMA ? M_MMA : M_F32) / g;  // query positions per tile
  if (qt < 1) return cudaErrorInvalidValue;
  if constexpr (MMA && D >= 64) {
    return launch_wgmma<D>(q, k, v, out, batch, sq, sk, n_kv, g, sb, ss, sh, scale, softcap,
                           window, causal, stream);
  } else {
    const dim3 grid((sq + qt - 1) / qt, n_kv, batch);
    static bool opted_in = false;
    if constexpr (MMA) {
      const size_t smem = mma_smem_bytes<D>();
      auto kernel = flash_mma_kernel<D>;
      const cudaError_t err = opt_in_smem(kernel, smem, opted_in);
      if (err != cudaSuccess) return err;
      kernel<<<grid, NT, smem, stream>>>(
          static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
          static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, n_kv,
          g, qt, sb, ss, sh, scale, softcap, window, causal);
    } else {
      const size_t smem = f32_smem_bytes<D>();
      auto kernel = flash_f32_kernel<D>;
      const cudaError_t err = opt_in_smem(kernel, smem, opted_in);
      if (err != cudaSuccess) return err;
      kernel<<<grid, NT, smem, stream>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), static_cast<float*>(out), sq, sk, n_kv, g, qt, sb, ss,
          sh, scale, softcap, window, causal);
    }
    return cudaGetLastError();
  }
}

}  // namespace

// q, out: (B, Sq, KV * g, d) contiguous; k, v: (B, Sk, KV, d) with element
// strides sb, ss, sh (d contiguous), the same for both. dtype: 0 = float32,
// 1 = bfloat16. softcap <= 0 and window <= 0 mean none; causal 0 or 1.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int flash_attention_launch(const void* q, const void* k, const void* v, void* out,
                                      int batch, int sq, int sk, int n_kv, int g, int head_dim,
                                      long long sb, long long ss, long long sh, float scale,
                                      float softcap, int window, int causal, int dtype,
                                      void* stream) {
  if (batch < 1 || sq < 1 || g < 1) return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define FA_CASE(T, D)                                                                       \
  case D:                                                                                   \
    return int(launch_typed<T, D>(q, k, v, out, batch, sq, sk, n_kv, g, sb, ss, sh, scale, \
                                  softcap, window, causal, s));
  if (dtype == 0) {
    switch (head_dim) {
      FA_CASE(float, 16)
      FA_CASE(float, 32)
      FA_CASE(float, 64)
      FA_CASE(float, 128)
      FA_CASE(float, 256)
      default:
        return int(cudaErrorInvalidValue);
    }
  }
  if (dtype == 1) {
    switch (head_dim) {
      FA_CASE(__nv_bfloat16, 16)
      FA_CASE(__nv_bfloat16, 32)
      FA_CASE(__nv_bfloat16, 64)
      FA_CASE(__nv_bfloat16, 128)
      FA_CASE(__nv_bfloat16, 256)
      default:
        return int(cudaErrorInvalidValue);
    }
  }
#undef FA_CASE
  return int(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
