// Single-query attention over a KV cache for Hopper (sm_90a): one source,
// two entry points.
//
// Replaces two TPU kernels of the JAX package:
//   B3 `decode_attention` (kernels/decode_attention.py:92, body
//      `_decode_kernel` :34): each batch row's one new query over its dense
//      cache (B, S, KV, d), keys < lengths[b];
//   B2 `paged_attention` (kernels/paged_attention.py:119, body
//      `_paged_kernel` :62): each packed row's one query over a page pool
//      (P, page, KV, d) through its block table, keys < lengths[n].
// B3 is B2 with page = S and the table [[b]]: one kernel template, two key
// addressing policies (contiguous with a batch stride, or through a table).
// Row n's query sits at position lengths[n] - 1; GQA: query head h = kv*G + g
// reads KV head kv. Softcap before the mask, fp32 online softmax, NEG_INF
// -1e30, guard l >= 1e-37: the TPU kernels' semantics.
//
// What bounds it on an H100: the KV bytes, lengths x KV x d x 2 x sizeof(T),
// at 3.35 TB/s; it does 4 G d operations per key, far below the card's
// ridge. So the design is about bytes in flight: the keys of each (row, KV
// head) are split over n_split CTAs (flash-decoding), so that a serial decode
// (B = 1: 8 (row, head) pairs for Llama3.1-8B) still fills the 132 SMs; each
// CTA streams 64-key blocks of K and V into shared memory with cp.async,
// double-buffered, so one block's copy runs under the previous block's
// products, and keeps its G softmax states and outputs on chip. A second,
// small pass, one CTA per (row, KV head, query head), combines the splits'
// (m, l, acc). The products run in fp32 on the CUDA cores for both input
// types (bf16 is widened on load): at G <= 16 queries per key there is
// nothing for the tensor cores to amortise. d <= 128 runs 128 threads a CTA;
// d = 256 runs 256 (one output column each), with one K/V stage instead of
// two in fp32 so that the CTA fits in 227 KB.
//
// B2's rows can share keys: in the engine's dense fallback a prefill chunk
// is many rows of one slot at consecutive positions, and one CTA per row
// would stream the slot's prefix once per row, doing only 4 G d operations
// per key. So B2 takes a tile list built on the host (row_tiles: runs of
// rows with one table and consecutive lengths, up to 64 query vectors), and
// when any tile holds several rows (bf16) it runs tile_attention_kernel: one
// CTA per (tile, KV head, split) stages each key block once for all of the
// tile's rows and runs both products on the tensor cores (B1's warp tile,
// attn::MmaRows). What bounds it then is still bytes, now read once per tile
// rather than per row. A call whose tiles are all one row (decode rows of
// distinct slots, pages of 16) keeps the per-row design above.
//
// The split is sized on the host from the row count and the cache's
// capacity, and each CTA takes its share of its own row's live keys, so a
// short row leaves its later splits empty (they write m = NEG_INF, l = 0).
// Keys at or past lengths[n], or left of the window, are never loaded:
// cp.async zero-fills them, so NaN in a dead slot cannot reach a product.
//
// Layouts: q, out (N, KV, G, d) contiguous; K/V element (n, key, kv, x) at
//   dense: n * sb + key * ss + kv * sh + x                (B3; strided views)
//   paged: (table[n][key / page] * page + key % page) * ss + kv * sh + x
//                                                         (B2; contiguous pool)
// Workspace (n_split > 1): o_part (N, KV, n_split, G, d) fp32 and ml_part
// (N, KV, n_split, G, 2) fp32.
#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int NT = 128;    // threads per CTA (d <= 128) and of the combine pass
constexpr int BK = 64;     // keys per block
constexpr int G_MAX = 16;  // query heads per KV head
constexpr int MAX_SPLIT = 512;  // CTAs per (row, KV head)

struct DenseKeys {
  long long sb, ss, sh;  // element strides of batch, key and KV head
  int cap;               // keys a row holds (S)
  __device__ __forceinline__ long long offset(int n, int key, int kv) const {
    return n * sb + key * ss + kv * sh;
  }
};

struct PagedKeys {
  const int* tables;  // (N, nb) page ids
  int nb, page;
  long long ss, sh;  // element strides of a key (KV * d) and a KV head (d)
  int cap;           // nb * page
  __device__ __forceinline__ long long offset(int n, int key, int kv) const {
    const long long pg = tables[(long long)n * nb + key / page];
    return (pg * page + key % page) * ss + kv * sh;
  }
};

// d = 256 takes 256 threads (one output column each in the value product)
template <int D>
__host__ __device__ constexpr int row_threads() {
  return D > 128 ? 256 : NT;
}

// CTAs an SM must hold, for ptxas's register budget: d <= 128 keeps the
// occupancy its kernels reach (at most 73 registers a thread); d = 256 may
// take up to 255 registers rather than spill
template <int D>
__host__ __device__ constexpr int row_min_ctas() {
  return D > 128 ? 1 : 7;
}

// K/V stages in flight: two, but one for fp32 at d = 256, whose two stages
// (266,240 B) would not fit the 232,448 B a CTA may have
template <typename T, int D>
__host__ __device__ constexpr int row_stages() {
  return sizeof(T) == 4 && D > 128 ? 1 : 2;
}

template <typename T, int D>
__host__ __device__ constexpr int kv_stride() {
  return D + 16 / int(sizeof(T));  // staged K/V row (elements): 16 bytes of padding
}

template <typename T, int D>
constexpr size_t row_smem_bytes() {
  return sizeof(T) * row_stages<T, D>() * 2 * BK * kv_stride<T, D>()  // stages x (K, V)
         + sizeof(float) * (G_MAX * D + G_MAX * BK + 3 * G_MAX);
}

template <typename T, int D, typename Keys>
__global__ void __launch_bounds__(row_threads<D>(), row_min_ctas<D>()) row_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ out, float* __restrict__ o_part, float* __restrict__ ml_part,
    const int* __restrict__ lengths, Keys keys, int n_kv, int g, int n_split, float scale,
    float softcap, int window) {
  constexpr int NT = row_threads<D>();
  constexpr int STAGES = row_stages<T, D>();
  constexpr int KS = kv_stride<T, D>();
  constexpr int VEC = 16 / int(sizeof(T));  // elements per 16-byte copy
  constexpr int SRG = NT / BK;              // row groups in the score product
  constexpr int SRPT = G_MAX / SRG;         // score rows per thread
  constexpr int RG = NT / D;                // row groups in the value product
  constexpr int RPT = (G_MAX + RG - 1) / RG;  // output rows per thread
  static_assert(NT % D == 0 && D % VEC == 0 && NT % BK == 0 && BK == 64, "tile shape");

  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* kv_s = reinterpret_cast<T*>(smem_raw);  // [stage][K, V][BK][KS]
  float* qs = reinterpret_cast<float*>(kv_s + STAGES * 2 * BK * KS);  // [G][D]
  float* ss = qs + G_MAX * D;                                // [G][BK] scores, then p
  float* m_s = ss + G_MAX * BK;
  float* l_s = m_s + G_MAX;
  float* a_s = l_s + G_MAX;

  const int tid = threadIdx.x;
  const int n = blockIdx.x, h = blockIdx.y, split = blockIdx.z;
  const int length = lengths[n];
  // the row's live keys [k_lo, k_hi), then this CTA's share [lo, hi) of them
  const int k_hi = min(length, keys.cap);
  const int k_lo = window > 0 ? max(0, length - window) : 0;
  const int live = max(0, k_hi - k_lo);
  const int span = ((live + n_split - 1) / n_split + BK - 1) / BK * BK;
  const int lo = k_lo + split * span;
  const int hi = min(k_hi, lo + span);

  const long long qbase = ((long long)n * n_kv + h) * g * D;
  for (int e = tid; e < g * D; e += NT) qs[e] = to_float(q[qbase + e]);
  for (int r = tid; r < G_MAX; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  const int dcol = tid % D, prg = tid / D;
  const int scol = tid % BK, srg = tid / BK;
  const int n_s = (g - srg + SRG - 1) / SRG;  // score rows this thread owns
  const int n_o = (g - prg + RG - 1) / RG;    // output rows this thread owns
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;

  // copy keys [kb, kb + BK) of K and V into stage buf; keys >= hi zero-filled
  auto stage = [&](int buf, int kb) {
    T* ks = kv_s + buf * 2 * BK * KS;
    T* vs = ks + BK * KS;
    for (int e = tid * VEC; e < BK * D; e += NT * VEC) {
      const int c = e / D, x = e % D;
      const bool ok = kb + c < hi;
      const long long off = ok ? keys.offset(n, kb + c, h) + x : 0;
      cp_async16(ks + c * KS + x, k + off, ok);
      cp_async16(vs + c * KS + x, v + off, ok);
    }
    cp_async_commit();
  };

  __syncthreads();
  if (STAGES == 2 && lo < hi) stage(0, lo);
  int buf = 0;
  for (int kb = lo; kb < hi; kb += BK) {
    if (STAGES == 1) {
      stage(0, kb);  // one stage: the copy waits for the previous block's products
      cp_async_wait<0>();
    } else if (kb + BK < hi) {
      stage(buf ^ 1, kb + BK);  // the next block's copy runs under this block
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = kv_s + buf * 2 * BK * KS;
    const T* vs = ks + BK * KS;
    // 1. scores: thread owns key scol for query rows srg, srg + SRG, ...
    {
      float sacc[SRPT];
#pragma unroll
      for (int i = 0; i < SRPT; ++i) sacc[i] = 0.f;
      const T* kr = ks + scol * KS;
      for (int x = 0; x < D; x += VEC) {
        float kx[VEC];
        if constexpr (sizeof(T) == 4) {
          const float4 t = *reinterpret_cast<const float4*>(kr + x);
          kx[0] = t.x;
          kx[1] = t.y;
          kx[2] = t.z;
          kx[3] = t.w;
        } else {
          const uint4 t = *reinterpret_cast<const uint4*>(kr + x);
          const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(&t);
#pragma unroll
          for (int j = 0; j < VEC / 2; ++j) {
            const float2 f = __bfloat1622float2(p2[j]);
            kx[2 * j] = f.x;
            kx[2 * j + 1] = f.y;
          }
        }
#pragma unroll
        for (int i = 0; i < SRPT; ++i) {
          if (i >= n_s) break;
          const float* qr = qs + (srg + SRG * i) * D + x;
          float s = sacc[i];
#pragma unroll
          for (int j = 0; j < VEC; j += 4) {  // four query dims per shared-memory read
            const float4 qx = *reinterpret_cast<const float4*>(qr + j);
            s = fmaf(qx.x, kx[j], s);
            s = fmaf(qx.y, kx[j + 1], s);
            s = fmaf(qx.z, kx[j + 2], s);
            s = fmaf(qx.w, kx[j + 3], s);
          }
          sacc[i] = s;
        }
      }
      const bool ok = kb + scol < hi;
#pragma unroll
      for (int i = 0; i < SRPT; ++i) {
        if (i >= n_s) break;
        float s = sacc[i] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ss[(srg + SRG * i) * BK + scol] = ok ? s : -INFINITY;
      }
    }
    __syncthreads();
    // 2. online softmax, one warp per query row; masked keys get p = 0
    {
      const int warp = tid / 32, lane = tid % 32;
      for (int r = warp; r < g; r += NT / 32) {
        float* srow = ss + r * BK;
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
    // 3. acc = alpha * acc + P V: thread owns output column dcol
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (i >= n_o) break;
      acc[i] *= a_s[prg + RG * i];
    }
    for (int c = 0; c < BK; c += 4) {  // four keys per shared-memory read of P
      const float v0 = to_float(vs[c * KS + dcol]), v1 = to_float(vs[(c + 1) * KS + dcol]);
      const float v2 = to_float(vs[(c + 2) * KS + dcol]), v3 = to_float(vs[(c + 3) * KS + dcol]);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i >= n_o) break;
        const float4 p = *reinterpret_cast<const float4*>(ss + (prg + RG * i) * BK + c);
        float a = acc[i];
        a = fmaf(p.x, v0, a);
        a = fmaf(p.y, v1, a);
        a = fmaf(p.z, v2, a);
        acc[i] = fmaf(p.w, v3, a);
      }
    }
    __syncthreads();  // the next iteration's copy reuses this stage
    if (STAGES == 2) buf ^= 1;
  }

  if (n_split == 1) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (i >= n_o) break;
      const int r = prg + RG * i;
      out[qbase + r * D + dcol] = from_float<T>(acc[i] / fmaxf(l_s[r], 1e-37f));
    }
    return;
  }
  const long long pbase = (((long long)n * n_kv + h) * n_split + split) * g;
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (i >= n_o) break;
    const int r = prg + RG * i;
    o_part[(pbase + r) * D + dcol] = acc[i];
  }
  if (tid < g) {
    ml_part[2 * (pbase + tid)] = m_s[tid];
    ml_part[2 * (pbase + tid) + 1] = l_s[tid];
  }
}

// out[pair, r, x] = sum_s e^(m_s - m) acc_s / sum_s e^(m_s - m) l_s over the
// splits s, for (row, KV head) pair = blockIdx.x and query head r =
// blockIdx.y; all-empty rows give 0. One warp computes the splits' weights
// and l once; then each thread sums one output column over the splits.
template <typename T>
__global__ void __launch_bounds__(NT) combine_splits_kernel(const float* __restrict__ o_part,
                                                            const float* __restrict__ ml_part,
                                                            T* __restrict__ out, int g, int d,
                                                            int n_split) {
  __shared__ float w_s[MAX_SPLIT];  // e^(m_s - m) of each split
  __shared__ float l_all;
  const long long pair = blockIdx.x;
  const int r = blockIdx.y;
  const long long base = pair * n_split * g + r;  // split s's row: base + s * g
  if (threadIdx.x < 32) {
    float mx = NEG_INF;
    for (int s = threadIdx.x; s < n_split; s += 32)
      mx = fmaxf(mx, ml_part[2 * (base + (long long)s * g)]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = threadIdx.x; s < n_split; s += 32) {
      const long long idx = base + (long long)s * g;
      const float w = expf(ml_part[2 * idx] - mx);
      w_s[s] = w;
      l = fmaf(w, ml_part[2 * idx + 1], l);
    }
    l = warp_sum(l);
    if (threadIdx.x == 0) l_all = l;
  }
  __syncthreads();
  for (int x = threadIdx.x; x < d; x += NT) {
    float o = 0.f;
#pragma unroll 8
    for (int s = 0; s < n_split; ++s) o = fmaf(w_s[s], o_part[(base + (long long)s * g) * d + x], o);
    out[(pair * g + r) * d + x] = from_float<T>(o / fmaxf(l_all, 1e-37f));
  }
}

// ---------------------------------------------------------------------------
// B2's row tiles: the rows that share a block table, on the tensor cores
// ---------------------------------------------------------------------------
//
// A tile is up to 64 / G consecutive rows that read the same block-table row
// at consecutive lengths (``row_tiles`` on the host: a prefill chunk's rows
// in the dense engine). One CTA per (tile, KV head, split) stages each
// 64-key block of the tile's keys once, by cp.async, double-buffered, for
// all of its rows x G query vectors, and runs S = Q K^T and P V on the
// tensor cores in FlashAttention-2's register layout (attn::MmaRows, as B1):
// a chunk of 271 rows reads its slot's prefix 271 / 16 times instead of 271.
// Each row is masked by its own length and window. The tile's keys are the
// hull of its rows' live keys, which for consecutive lengths is their union,
// so no key that every row must skip is loaded. bf16 only; 8 warps copy, the
// first 4 compute.

constexpr int TILE_NT = 256;  // threads per CTA
constexpr int TILE_M = 64;    // query vectors per tile: rows x G
constexpr int TILE_PAD = 8;   // bf16 row padding of the staged Q, K and V

template <int D>
constexpr size_t tile_smem_bytes() {
  return sizeof(__nv_bfloat16) * (4 * BK + (D > 128 ? TILE_M : 0)) * (D + TILE_PAD);
}

template <int D>
__global__ void __launch_bounds__(TILE_NT, 1) tile_attention_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    float* __restrict__ o_part, float* __restrict__ ml_part, const int* __restrict__ lengths,
    const int* __restrict__ tiles, PagedKeys keys, int n_kv, int g, int n_split, float scale,
    float softcap, int window) {
  constexpr int KSTR = D + TILE_PAD;
  using Rows = MmaRows<D, KSTR>;
  static_assert(BK == MMA_BK, "mma tile shape");

  extern __shared__ __align__(16) unsigned char tile_smem[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(tile_smem);  // [stage][K, V][BK][KSTR]
  __nv_bfloat16* qs = kv_s + 4 * BK * KSTR;  // [TILE_M][KSTR] (d = 256 only)
  __shared__ int hull[2];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int first = tiles[2 * blockIdx.x], nrow = tiles[2 * blockIdx.x + 1];
  const int h = blockIdx.y, split = blockIdx.z;
  const int m_eff = nrow * g;
  const bool active = warp < 4 && warp * 16 < m_eff;  // owns a live query vector

  // each row's live keys [len - window, len) within the cache; the tile's
  // keys are their hull, this CTA's share [lo, hi) of it
  if (tid == 0) {
    hull[0] = keys.cap;
    hull[1] = 0;
  }
  __syncthreads();
  if (tid < nrow) {
    const int len = min(lengths[first + tid], keys.cap);
    atomicMin(&hull[0], window > 0 ? max(0, len - window) : 0);
    atomicMax(&hull[1], len);
  }
  __syncthreads();
  const int k_lo = min(hull[0], hull[1]), k_hi = hull[1];
  const int span = ((k_hi - k_lo + n_split - 1) / n_split + BK - 1) / BK * BK;
  const int lo = k_lo + split * span;
  const int hi = min(k_hi, lo + span);

  // this thread's two query vectors (the mma's rows gid and gid + 8): row
  // first + r / g, head r % g; vectors at or past m_eff are zero and unwritten
  const int ra = warp * 16 + gid, rb = ra + 8;
  const bool live_a = ra < m_eff, live_b = rb < m_eff;
  const int len_a = live_a ? min(lengths[first + ra / g], keys.cap) : 0;
  const int len_b = live_b ? min(lengths[first + rb / g], keys.cap) : 0;
  const long long base_a = (((long long)(first + ra / g) * n_kv + h) * g + ra % g) * D;
  const long long base_b = (((long long)(first + rb / g) * n_kv + h) * g + rb % g) * D;
  Rows rows;
  rows.init();
  if constexpr (Rows::Q_SMEM) {
    for (int e = tid * 8; e < TILE_M * D; e += TILE_NT * 8) {
      const int r = e / D, x = e % D;
      uint4 t = make_uint4(0u, 0u, 0u, 0u);
      if (r < m_eff)
        t = __ldg(reinterpret_cast<const uint4*>(
            q + (((long long)(first + r / g) * n_kv + h) * g + r % g) * D + x));
      *reinterpret_cast<uint4*>(qs + r * KSTR + x) = t;
    }
    rows.q_from_smem(qs + warp * 16 * KSTR, KSTR);
  } else if (active) {
    rows.load_q(q, base_a, base_b, live_a, live_b);
  }
  const int lo_a = window > 0 ? len_a - window : 0, lo_b = window > 0 ? len_b - window : 0;

  // copy keys [kb, kb + BK) of K and V into stage buf; keys >= hi zero-filled
  auto stage = [&](int buf, int kb) {
    __nv_bfloat16* ks = kv_s + buf * 2 * BK * KSTR;
    __nv_bfloat16* vs = ks + BK * KSTR;
    for (int e = tid * 8; e < BK * D; e += TILE_NT * 8) {
      const int c = e / D, x = e % D;
      const bool ok = kb + c < hi;
      const long long off = ok ? keys.offset(first, kb + c, h) + x : 0;
      cp_async16(ks + c * KSTR + x, k + off, ok);
      cp_async16(vs + c * KSTR + x, v + off, ok);
    }
    cp_async_commit();
  };

  if (lo < hi) stage(0, lo);
  int buf = 0;
  for (int kb = lo; kb < hi; kb += BK) {
    if (kb + BK < hi) {
      stage(buf ^ 1, kb + BK);  // the next block's copy runs under this block
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = kv_s + buf * 2 * BK * KSTR;
    if (active) rows.block(ks, ks + BK * KSTR, kb, lo_a, len_a, lo_b, len_b, scale, softcap);
    __syncthreads();  // the next iteration's copy reuses this stage
    buf ^= 1;
  }

  if (!active) return;
  if (n_split == 1) {
    rows.store(out, base_a, base_b, live_a, live_b);
    return;
  }
  // the split's unnormalised accumulator and (m, l) of each live vector
  const long long pa = (((long long)(first + ra / g) * n_kv + h) * n_split + split) * g + ra % g;
  const long long pb = (((long long)(first + rb / g) * n_kv + h) * n_split + split) * g + rb % g;
#pragma unroll
  for (int n = 0; n < Rows::NT_O; ++n) {
    const int x = n * 8 + 2 * tig;
    if (live_a) {
      o_part[pa * D + x] = rows.acc[n][0];
      o_part[pa * D + x + 1] = rows.acc[n][1];
    }
    if (live_b) {
      o_part[pb * D + x] = rows.acc[n][2];
      o_part[pb * D + x + 1] = rows.acc[n][3];
    }
  }
  if (tig == 0) {
    if (live_a) {
      ml_part[2 * pa] = rows.m_a;
      ml_part[2 * pa + 1] = rows.l_a;
    }
    if (live_b) {
      ml_part[2 * pb] = rows.m_b;
      ml_part[2 * pb + 1] = rows.l_b;
    }
  }
}

template <int D>
cudaError_t launch_tiles(const void* q, const void* k, const void* v, void* out, void* o_part,
                         void* ml_part, const void* lengths, const void* tiles, int n_tiles,
                         const PagedKeys& keys, int n_rows, int n_kv, int g, int n_split,
                         float scale, float softcap, int window, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes<D>();
  auto kernel = tile_attention_kernel<D>;
  static bool opted_in = false;
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_tiles, n_kv, n_split), TILE_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(o_part), static_cast<float*>(ml_part),
      static_cast<const int*>(lengths), static_cast<const int*>(tiles), keys, n_kv, g, n_split,
      scale, softcap, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  combine_splits_kernel<__nv_bfloat16><<<dim3(n_rows * n_kv, g), NT, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
      static_cast<__nv_bfloat16*>(out), g, D, n_split);
  return cudaGetLastError();
}

template <typename T, int D, typename Keys>
cudaError_t launch_rows(const void* q, const void* k, const void* v, void* out, void* o_part,
                        void* ml_part, const void* lengths, const Keys& keys, int n_rows,
                        int n_kv, int g, int n_split, float scale, float softcap, int window,
                        cudaStream_t stream) {
  const size_t smem = row_smem_bytes<T, D>();
  auto kernel = row_attention_kernel<T, D, Keys>;
  static bool opted_in = false;
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_rows, n_kv, n_split), row_threads<D>(), smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(o_part), static_cast<float*>(ml_part),
      static_cast<const int*>(lengths), keys, n_kv, g, n_split, scale, softcap, window);
  err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  combine_splits_kernel<T><<<dim3(n_rows * n_kv, g), NT, 0, stream>>>(
      static_cast<const float*>(o_part), static_cast<const float*>(ml_part),
      static_cast<T*>(out), g, D, n_split);
  return cudaGetLastError();
}

template <typename Keys>
cudaError_t launch_any(int dtype, int head_dim, const void* q, const void* k, const void* v,
                       void* out, void* o_part, void* ml_part, const void* lengths,
                       const Keys& keys, int n_rows, int n_kv, int g, int n_split, float scale,
                       float softcap, int window, cudaStream_t stream) {
  if (g < 1 || g > G_MAX || n_rows < 1 || n_split < 1 || n_split > MAX_SPLIT)
    return cudaErrorInvalidValue;
  if (n_split > 1 && (o_part == nullptr || ml_part == nullptr)) return cudaErrorInvalidValue;
#define ROWS_CASE(T, D)                                                                      \
  case D:                                                                                    \
    return launch_rows<T, D, Keys>(q, k, v, out, o_part, ml_part, lengths, keys, n_rows,     \
                                   n_kv, g, n_split, scale, softcap, window, stream);
  if (dtype == 0) {
    switch (head_dim) {
      ROWS_CASE(float, 16)
      ROWS_CASE(float, 32)
      ROWS_CASE(float, 64)
      ROWS_CASE(float, 128)
      ROWS_CASE(float, 256)
      default:
        return cudaErrorInvalidValue;
    }
  }
  if (dtype == 1) {
    switch (head_dim) {
      ROWS_CASE(__nv_bfloat16, 16)
      ROWS_CASE(__nv_bfloat16, 32)
      ROWS_CASE(__nv_bfloat16, 64)
      ROWS_CASE(__nv_bfloat16, 128)
      ROWS_CASE(__nv_bfloat16, 256)
      default:
        return cudaErrorInvalidValue;
    }
  }
#undef ROWS_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// B3. k/v: (B, S, KV, d) with element strides sb, ss, sh (d contiguous).
// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 and window <= 0 mean none.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       void* o_part, void* ml_part, const void* lengths,
                                       int batch, int seq, long long sb, long long ss,
                                       long long sh, int n_kv, int g, int head_dim,
                                       int n_split, float scale, float softcap, int window,
                                       int dtype, void* stream) {
  const DenseKeys keys{sb, ss, sh, seq};
  return int(launch_any(dtype, head_dim, q, k, v, out, o_part, ml_part, lengths, keys, batch,
                        n_kv, g, n_split, scale, softcap, window,
                        static_cast<cudaStream_t>(stream)));
}

// B2. k/v_pages: (P, page, KV, d) contiguous; block_tables (N, nb) int32.
// n_tiles > 0 (bf16 only): ``tiles`` (n_tiles, 2) int32 (first row, rows)
// run on the tensor cores, one CTA per (tile, KV head, split); n_tiles == 0:
// one CTA per (row, KV head, split) on the CUDA cores.
extern "C" int paged_attention_launch(const void* q, const void* k_pages, const void* v_pages,
                                      void* out, void* o_part, void* ml_part,
                                      const void* lengths, const void* block_tables,
                                      const void* tiles, int n_tiles, int n_rows, int nb,
                                      int page, int n_kv, int g, int head_dim, int n_split,
                                      float scale, float softcap, int window, int dtype,
                                      void* stream) {
  const PagedKeys keys{static_cast<const int*>(block_tables), nb, page,
                       (long long)n_kv * head_dim, head_dim, nb * page};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n_tiles == 0)
    return int(launch_any(dtype, head_dim, q, k_pages, v_pages, out, o_part, ml_part, lengths,
                          keys, n_rows, n_kv, g, n_split, scale, softcap, window, s));
  if (dtype != 1 || g < 1 || g > TILE_M || n_tiles < 0 || n_split < 1 || n_split > MAX_SPLIT ||
      (n_split > 1 && (o_part == nullptr || ml_part == nullptr)))
    return int(cudaErrorInvalidValue);
#define TILES_CASE(D)                                                                         \
  case D:                                                                                     \
    return int(launch_tiles<D>(q, k_pages, v_pages, out, o_part, ml_part, lengths, tiles,     \
                               n_tiles, keys, n_rows, n_kv, g, n_split, scale, softcap, window, \
                               s));
  switch (head_dim) {
    TILES_CASE(16)
    TILES_CASE(32)
    TILES_CASE(64)
    TILES_CASE(128)
    TILES_CASE(256)
    default:
      return int(cudaErrorInvalidValue);
  }
#undef TILES_CASE
}

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
