// FlashAttention-2 forward for Hopper (sm_90a): causal (or full) GQA
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
// hundred tokens on it is the tensor cores' 989 TFLOP/s (bf16) that bound it.
// The design is FlashAttention-2's: one CTA per (q tile, KV head, batch) row
// holds the tile's queries of all G heads of that KV head (so one staged K/V
// block serves G heads), keeps the softmax state and the output accumulator
// in registers, and never writes the scores out. bf16 inputs run both
// products on the tensor cores (mma.sync m16n8k16, fp32 accumulation; 8 warps
// x 16 rows = 128 query vectors per CTA) with K/V blocks of 64 keys copied by
// cp.async, double-buffered, under the previous block's products; fp32 inputs
// (the exactness checks) run them on the CUDA cores (64 query vectors per
// CTA). Key blocks wholly above the tile's diagonal or left of its window are
// never visited, and the most expensive (last) causal tiles start first.
// Not yet: wgmma, TMA, warp specialisation.
//
// The kernel reads the model's layouts in place: q and out (B, Sq, H, d)
// contiguous, k and v (B, Sk, KV, d) with any element strides of batch, key
// and head (d contiguous; a prefix view of a (B, max_len, KV, d) cache
// works). Sq need not be a multiple of the tile: the last tile is short.
#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int NT = 256;     // threads per CTA
constexpr int BK = 64;      // keys per block
constexpr int M_F32 = 64;   // query vectors per CTA, fp32
constexpr int M_MMA = 128;  // query vectors per CTA, bf16 (8 warps x 16 rows)
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

template <int D>
__global__ void __launch_bounds__(NT) flash_f32_kernel(
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
// bf16: the products on the tensor cores
// ---------------------------------------------------------------------------
//
// FlashAttention-2's register layout, as in mixed_paged_attention.cu: warp w
// owns the tile's query vectors 16w..16w+15; its Q fragments stay in
// registers for the whole key loop, S = Q K^T lands in mma accumulators, the
// online softmax runs on them in fp32 (a row's 64 scores spread over the 4
// lanes of a quad), and the probabilities, rounded to bf16, are reused in
// place as the A operand of P V. K and V are staged as [key][d]: a K fragment
// is one 32-bit read, a V fragment one ldmatrix.trans.

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
  constexpr int KSTEPS = D / 16;     // k-steps of S = Q K^T
  constexpr int NT_S = BK / 8;       // 8-key tiles of S
  constexpr int NT_O = D / 8;        // 8-dim tiles of O
  constexpr int VEC = 8;             // bf16 per 16-byte copy
  static_assert(D % 16 == 0 && BK % 16 == 0 && M_MMA == 16 * (NT / 32), "mma tile shape");

  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [stage][K, V][BK][KSTR]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;  // mma groupID / thread-in-group
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
  uint32_t qa[KSTEPS][4];
  {
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int x = kk * 16 + 2 * tig;
      qa[kk][0] = ra < t.m_eff ? q32[(base_a + x) / 2] : 0u;
      qa[kk][1] = rb < t.m_eff ? q32[(base_b + x) / 2] : 0u;
      qa[kk][2] = ra < t.m_eff ? q32[(base_a + x + 8) / 2] : 0u;
      qa[kk][3] = rb < t.m_eff ? q32[(base_b + x + 8) / 2] : 0u;
    }
  }
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

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
    const __nv_bfloat16* vs = ks + BK * KSTR;
    if (active) {
      // S = Q K^T for the warp's 16 rows x BK keys
      float s[NT_S][4];
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const __nv_bfloat16* krow = ks + (j * 8 + gid) * KSTR + 2 * tig;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk) {
          const uint32_t b0 = *reinterpret_cast<const uint32_t*>(krow + kk * 16);
          const uint32_t b1 = *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8);
          mma_bf16(s[j], qa[kk], b0, b1);
        }
      }
      // scale, softcap, mask; the block's row maxima over each quad
      float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kb + j * 8 + 2 * tig + (e & 1);
          const bool ok = visible(kp, e < 2 ? qpa : qpb, t.k_hi, causal, window);
          float x = s[j][e] * scale;
          if (softcap > 0.f) x = softcap * tanhf(x / softcap);
          s[j][e] = ok ? x : -INFINITY;
          if (ok) {
            if (e < 2) mx_a = fmaxf(mx_a, x);
            else mx_b = fmaxf(mx_b, x);
          }
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, o));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, o));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float x = s[j][e];
          const float pe = x == -INFINITY ? 0.f : expf(x - (e < 2 ? mn_a : mn_b));
          s[j][e] = pe;
          if (e < 2) sum_a += pe;
          else sum_b += pe;
        }
      }
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        sum_a += __shfl_xor_sync(0xffffffffu, sum_a, o);
        sum_b += __shfl_xor_sync(0xffffffffu, sum_b, o);
      }
      const float al_a = expf(m_a - mn_a), al_b = expf(m_b - mn_b);
      l_a = al_a * l_a + sum_a;
      l_b = al_b * l_b + sum_b;
      m_a = mn_a;
      m_b = mn_b;
#pragma unroll
      for (int n = 0; n < NT_O; ++n) {
        acc[n][0] *= al_a;
        acc[n][1] *= al_a;
        acc[n][2] *= al_b;
        acc[n][3] *= al_b;
      }
      // O += P V: the S accumulators of key tiles 2k and 2k+1 are, rounded
      // to bf16, exactly the A fragment of key step k
#pragma unroll
      for (int k2 = 0; k2 < BK / 16; ++k2) {
        const uint32_t pa[4] = {pack_bf16(s[2 * k2][0], s[2 * k2][1]),
                                pack_bf16(s[2 * k2][2], s[2 * k2][3]),
                                pack_bf16(s[2 * k2 + 1][0], s[2 * k2 + 1][1]),
                                pack_bf16(s[2 * k2 + 1][2], s[2 * k2 + 1][3])};
        // lanes 0..15 name the 16 key rows of the two 8x8 matrices
        const __nv_bfloat16* vrow = vs + (k2 * 16 + (lane & 15)) * KSTR;
#pragma unroll
        for (int n = 0; n < NT_O; ++n) {
          uint32_t b0, b1;
          ldmatrix_x2_trans(b0, b1, vrow + n * 8);
          mma_bf16(acc[n], pa, b0, b1);
        }
      }
    }
    __syncthreads();  // the next iteration's copy reuses this stage
    buf ^= 1;
  }

  if (!active) return;
  const float inv_a = 1.f / fmaxf(l_a, 1e-37f), inv_b = 1.f / fmaxf(l_b, 1e-37f);
  uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int x = n * 8 + 2 * tig;
    if (ra < t.m_eff) o32[(base_a + x) / 2] = pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    if (rb < t.m_eff) o32[(base_b + x) / 2] = pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
  }
}

template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k, const void* v, void* out, int batch,
                         int sq, int sk, int n_kv, int g, long long sb, long long ss,
                         long long sh, float scale, float softcap, int window, int causal,
                         cudaStream_t stream) {
  constexpr bool MMA = sizeof(T) == 2;
  const int qt = (MMA ? M_MMA : M_F32) / g;  // query positions per tile
  if (qt < 1) return cudaErrorInvalidValue;
  const dim3 grid((sq + qt - 1) / qt, n_kv, batch);
  static bool opted_in = false;
  if constexpr (MMA) {
    const size_t smem = mma_smem_bytes<D>();
    auto kernel = flash_mma_kernel<D>;
    const cudaError_t err = opt_in_smem(kernel, smem, opted_in);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, stream>>>(
        static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
        static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out), sq, sk, n_kv, g,
        qt, sb, ss, sh, scale, softcap, window, causal);
  } else {
    const size_t smem = f32_smem_bytes<D>();
    auto kernel = flash_f32_kernel<D>;
    const cudaError_t err = opt_in_smem(kernel, smem, opted_in);
    if (err != cudaSuccess) return err;
    kernel<<<grid, NT, smem, stream>>>(static_cast<const float*>(q), static_cast<const float*>(k),
                                       static_cast<const float*>(v), static_cast<float*>(out), sq,
                                       sk, n_kv, g, qt, sb, ss, sh, scale, softcap, window,
                                       causal);
  }
  return cudaGetLastError();
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
