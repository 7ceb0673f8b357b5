// Single-query attention over a KV cache for Hopper (sm_90a): one source,
// three entry points.
//
// Replaces two TPU kernels of the JAX package:
//   B3 `decode_attention` (kernels/decode_attention.py:92, body
//      `_decode_kernel` :34): each batch row's one new query over its dense
//      cache (B, S, KV, d), keys < lengths[b];
//   B2 `paged_attention` (kernels/paged_attention.py:119, body
//      `_paged_kernel` :62): each packed row's one query over a page pool
//      (P, page, KV, d) through its block table, keys < lengths[n].
// Row n's query sits at position lengths[n] - 1; GQA: query head h = kv*G + g
// reads KV head kv. Softcap before the mask, fp32 online softmax, NEG_INF
// -1e30, guard l >= 1e-37: the TPU kernels' semantics.
//
// What bounds it on an H100: the KV bytes, lengths x KV x d x 2 x sizeof(T),
// at 3.35 TB/s; it does 4 G d operations per key, far below the card's
// ridge. So the design is about bytes in flight: the keys of each (row, KV
// head) are split over several CTAs (flash-decoding), so that a serial
// decode (B = 1: 8 (row, head) pairs for Llama3.1-8B) still fills the SMs.
//
// B3 in bf16 (cluster_decode_kernel, the serial decode): one launch. The C
// splits of a (row, KV head) are the CTAs of one thread-block cluster. Each
// takes its share of the row's live keys in 64-key blocks: it issues q's
// loads, then requests its whole share (up to a ring of `stages` blocks)
// by cp.async, so q arrives first and the keys stream behind it. Two
// groups of 4 warps take every other block, each warp 16 of its keys on
// the tensor cores with the keys on the M side of the mma (KeyRows: a
// row's G <= 16 query heads fill one or two n8 tiles, where on the M side
// they would leave most of a 16-row tile empty; tanhf in the softcap), and
// the 8 warps merge their states in shared memory. Each CTA then sends
// its merged (m, l, acc) through distributed shared memory to the ranks
// that combine them: rank r owns a 1/C slice of the G x d outputs, so
// after one cluster barrier it sums its slice over the C partials in its
// own shared memory and writes it in bf16. Every CTA arrives on a first
// barrier phase as it starts and waits on it before its first write to a
// peer. K/V are loaded under an L2 evict-first policy: each key is read
// once, and should not displace what L2 holds. No workspace, no combine
// kernel, no state that outlives the call (safe to capture in a CUDA
// graph). C and the ring depth are chosen on the host from B x KV, the
// cache's capacity and d (decode_attention.cluster_plan), never from the
// lengths.
//
// B3 in fp32 and B2's rows of distinct tables (row_attention_kernel): one
// CTA per (row, KV head, split), n_split from the host (split_count), each
// streaming 64-key blocks of K and V into shared memory with cp.async,
// double-buffered, its G softmax states and outputs on chip, the products in
// fp32 on the CUDA cores; a second, small pass, one CTA per (row, KV head,
// query head), combines the splits' (m, l, acc) from a workspace. d <= 128
// runs 128 threads a CTA; d = 256 runs 256 (one output column each), with
// one K/V stage instead of two in fp32 so that the CTA fits in 227 KB.
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
// Each CTA takes its share of its own row's live keys, so a short row leaves
// its later splits empty (they give m = NEG_INF, l = 0). Keys at or past
// lengths[n], or left of the window, are never loaded: cp.async zero-fills
// them, so NaN in a dead slot cannot reach a product.
//
// Layouts: q, out (N, KV, G, d) contiguous; K/V element (n, key, kv, x) at
//   dense: n * sb + key * ss + kv * sh + x                (B3; strided views)
//   paged: (table[n][key / page] * page + key % page) * ss + kv * sh + x
//                                                         (B2; contiguous pool)
// Workspace of the split row and tile kernels (n_split > 1): o_part (N, KV,
// n_split, G, d) fp32 and ml_part (N, KV, n_split, G, 2) fp32.
#include "attention_common.cuh"
#include "hopper.cuh"

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

// BF16: whether the row kernel takes bf16 (B2 does; B3's bf16 runs
// cluster_decode_kernel)
template <typename Keys, bool BF16>
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
  if constexpr (BF16) {
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
  }
#undef ROWS_CASE
  return cudaErrorInvalidValue;
}

// ---------------------------------------------------------------------------
// B3 in bf16: the splits of a (row, KV head) as one thread-block cluster
// ---------------------------------------------------------------------------
//
// Grid (C, KV, B), cluster (C, 1, 1): CTA rank r of the cluster of (row n,
// KV head h) takes keys [k_lo + r span, k_lo + (r + 1) span) of the row's
// live keys [k_lo, k_hi), span = ceil(live / C) rounded up to a block, so no
// share but the last non-empty one is shorter than the others. The ring
// holds `stages` blocks (2 or 4), half for each group of warps; each group
// requests its first blocks right after q's loads. PERF.md has the measurements at
// the serial decode's shapes that chose these constants.

constexpr int CL_GROUP = 128;              // a group of 4 warps takes a block
constexpr int CL_GROUPS = 2;               // groups a CTA: blocks 2t and 2t + 1 at once
constexpr int CL_NT = CL_GROUP * CL_GROUPS;
constexpr int CL_WARPS = CL_NT / 32;
constexpr int CL_KW = BK / (CL_GROUP / 32);  // keys of a block each warp of a group takes
constexpr int CL_PAD = 8;                  // bf16 padding of a staged row
constexpr int CL_MAX = 16;                 // CTAs a cluster (above 8: non-portable)
constexpr int CL_STAGES_MAX = 4;           // blocks the ring may hold: two a group
constexpr int CL_RING_BYTES = 212992;      // shared memory the ring may take

template <int D>
__host__ __device__ constexpr int cl_stage_bytes() {
  return int(sizeof(__nv_bfloat16)) * 2 * BK * (D + CL_PAD);  // K and V of one block
}

template <int D>
constexpr int cl_stages_max() {
  return CL_RING_BYTES / cl_stage_bytes<D>() < CL_STAGES_MAX ? CL_RING_BYTES / cl_stage_bytes<D>()
                                                             : CL_STAGES_MAX;
}

// the ring, Q (d = 256), then the peers' partials: C x ceil(g d / 4C)
// float4 and C x g (m, l)
template <int D>
constexpr size_t cl_smem_bytes(int stages, int cluster, int g) {
  return size_t(stages) * cl_stage_bytes<D>() +
         (D > 128 ? sizeof(__nv_bfloat16) * G_MAX * (D + CL_PAD) : 0) +
         16 * size_t(cluster) * ((g * D / 4 + cluster - 1) / cluster) + 8 * size_t(cluster) * g;
}

// cp.async.wait_group with a count known only at run time (0..2: a
// group's slots, and q's group)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  switch (n) {
    case 0: cp_async_wait<0>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<2>(); break;
  }
}

// One warp's 16 keys of a staged block against a row's query heads, keys on
// the M side of mma.sync m16n8k16 (a decode row has at most 16 query heads,
// so heads on the M side would leave most of its 16 rows empty): S^T = K Q^T
// (A: the 16 keys x 16 dims of K by ldmatrix; B: Q^T, from registers, or
// at d = 256 from shared memory per k-step by ldmatrix), then O^T += V^T P^T
// (A: V^T by ldmatrix.trans; B: P^T, S^T's accumulators rounded to bf16
// and transposed in registers by movmatrix). NQ n8 tiles of heads: G <= 8
// fills one, G <= 16 two. Lane (gid, tig) = (lane / 4, lane % 4) holds keys
// gid and gid + 8 and heads 8 j + 2 tig, 8 j + 2 tig + 1 of tile j: their
// online-softmax state (a head's sums run over the 8 lanes of one tig) and
// O^T's dims 16 t + gid and 16 t + gid + 8 of each 16. Softcap by tanhf.
template <int D, int KSTR, int NQ>
struct KeyRows {
  static constexpr int KSTEPS = D / 16;  // k-steps of S^T, m-tiles of O^T
  static constexpr bool Q_SMEM = D > 128;
  static_assert(D % 16 == 0 && NQ >= 1 && NQ <= 2, "key tile shape");

  uint32_t qb[Q_SMEM ? 1 : NQ][Q_SMEM ? 1 : KSTEPS][2];  // Q^T's B fragments
  const __nv_bfloat16* qrow;                             // Q_SMEM: this lane's ldmatrix row
  float acc[NQ][KSTEPS][4];
  float m[NQ][2], l[NQ][2];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int t = 0; t < KSTEPS; ++t)
        acc[j][t][0] = acc[j][t][1] = acc[j][t][2] = acc[j][t][3] = 0.f;
      m[j][0] = m[j][1] = NEG_INF;
      l[j][0] = l[j][1] = 0.f;
    }
  }

  // Q^T's fragments from global memory (d <= 128): head 8 j + gid of the
  // row's g at qbase, zero past g
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q, long long qbase, int g) {
    const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      const int r = 8 * j + gid;
      const long long base = qbase + (long long)r * D;
#pragma unroll
      for (int kk = 0; kk < (Q_SMEM ? 1 : KSTEPS); ++kk) {
        const int x = kk * 16 + 2 * tig;
        qb[j][kk][0] = r < g ? q32[(base + x) / 2] : 0u;
        qb[j][kk][1] = r < g ? q32[(base + x + 8) / 2] : 0u;
      }
    }
  }

  // Q read from shared memory per k-step (d = 256): heads [16][stride]
  __device__ __forceinline__ void q_from_smem(const __nv_bfloat16* rows, int stride) {
    const int lane = threadIdx.x % 32;
    qrow = rows + (lane & 7) * stride + ((lane >> 3) & 1) * 8 + (lane >> 4) * 8 * stride;
  }

  // keys [kb, kb + 16) staged at ks / vs (rows KSTR apart); keys outside
  // [lo, hi) are masked after the scale and softcap
  __device__ __forceinline__ void block(const __nv_bfloat16* ks, const __nv_bfloat16* vs, int kb,
                                        int lo, int hi, float scale, float softcap) {
    const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
    float s[NQ][2][4];  // two accumulators a tile: even and odd k-steps
#pragma unroll
    for (int j = 0; j < NQ; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) s[j][h][0] = s[j][h][1] = s[j][h][2] = s[j][h][3] = 0.f;
    const __nv_bfloat16* krow = ks + (lane & 15) * KSTR + (lane >> 4) * 8;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      uint32_t a[4];
      ldmatrix_x4(a, krow + kk * 16);
      if constexpr (Q_SMEM) {
        uint32_t b[4];  // Q^T's fragments of both tiles (the second unused at NQ 1)
        ldmatrix_x4(b, qrow + kk * 16);
#pragma unroll
        for (int j = 0; j < NQ; ++j) mma_bf16(s[j][kk & 1], a, b[2 * j], b[2 * j + 1]);
      } else {
#pragma unroll
        for (int j = 0; j < NQ; ++j) mma_bf16(s[j][kk & 1], a, qb[j][kk][0], qb[j][kk][1]);
      }
    }
    uint32_t pb[NQ][2];  // P^T's B fragments
    const bool ok_a = kb + gid >= lo && kb + gid < hi;
    const bool ok_b = kb + gid + 8 >= lo && kb + gid + 8 < hi;
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = (s[j][0][e] + s[j][1][e]) * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        v[e] = (e < 2 ? ok_a : ok_b) ? x : -INFINITY;
      }
      // each head's maximum and sum over the block's 16 keys: its two
      // values here, then the 8 lanes of this tig
      float mx[2], mn[2], sum[2], al[2];
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        mx[rr] = fmaxf(fmaxf(v[rr], v[2 + rr]), NEG_INF);
#pragma unroll
        for (int o = 4; o < 32; o <<= 1)
          mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], o));
        mn[rr] = fmaxf(m[j][rr], mx[rr]);
      }
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) p[e] = v[e] == -INFINITY ? 0.f : expf(v[e] - mn[e & 1]);
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        sum[rr] = p[rr] + p[2 + rr];
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) sum[rr] += __shfl_xor_sync(0xffffffffu, sum[rr], o);
        al[rr] = expf(m[j][rr] - mn[rr]);
        l[j][rr] = al[rr] * l[j][rr] + sum[rr];
        m[j][rr] = mn[rr];
      }
#pragma unroll
      for (int t = 0; t < KSTEPS; ++t) {
        acc[j][t][0] *= al[0];
        acc[j][t][1] *= al[1];
        acc[j][t][2] *= al[0];
        acc[j][t][3] *= al[1];
      }
      // P^T as the B fragment of O^T += V^T P^T: keys gid (then gid + 8) x
      // heads 2 tig, 2 tig + 1, transposed to keys 2 tig, 2 tig + 1 x head gid
      pb[j][0] = movmatrix_trans(pack_bf16(p[0], p[1]));
      pb[j][1] = movmatrix_trans(pack_bf16(p[2], p[3]));
    }
    // lanes 8i..8i+7 name stored rows (keys) 8 (i / 2) + 0..7 at dims 8 (i % 2)
    const __nv_bfloat16* vrow =
        vs + ((lane & 7) + (lane >> 4) * 8) * KSTR + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int t = 0; t < KSTEPS; ++t) {
      uint32_t a[4];
      ldmatrix_x4_trans(a, vrow + t * 16);
#pragma unroll
      for (int j = 0; j < NQ; ++j) mma_bf16(acc[j][t], a, pb[j][0], pb[j][1]);
    }
  }
};

// a barrier among the CL_GROUP threads of group j (named barrier 1 + j)
__device__ __forceinline__ void group_sync(int j) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(1 + j), "n"(CL_GROUP) : "memory");
}

template <int D, int NQ>
__global__ void __launch_bounds__(CL_NT, 1) cluster_decode_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ lengths, DenseKeys keys, int n_kv, int g, int stages, float scale,
    float softcap, int window) {
  constexpr int KSTR = D + CL_PAD;  // staged row stride (bf16)
  constexpr int OSTR = D + 4;       // fp32 row stride of the merge
  constexpr int VEC = 8, CPR = D / VEC;  // bf16 a 16-byte copy, copies a key row
  using Rows = KeyRows<D, KSTR, NQ>;
  static_assert(CL_KW == 16, "cluster tile shape");
  // the merge's [warp][16][OSTR] partials and [warp][16] (m, l) reuse the
  // ring: one stage a group
  static_assert(sizeof(float) * (CL_GROUP / 32) * G_MAX * (OSTR + 2) <= cl_stage_bytes<D>(),
                "the merge fits the ring");

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int C = gridDim.x, rank = hop::cluster_ctarank();
  const int h = blockIdx.y, n = blockIdx.z;
  hop::cluster_arrive_relaxed();  // this CTA has started: peers may write to it

  // group j of 4 warps takes blocks j, j + 2, ... of the share through its
  // own half of the ring (stages / 2 slots), with its own barrier
  const int grp = tid / CL_GROUP, gtid = tid % CL_GROUP, wg = warp % (CL_GROUP / 32);
  const int slots = stages / CL_GROUPS;

  extern __shared__ __align__(16) unsigned char cl_smem[];
  // [stages][K, V][BK][KSTR], then Q [16][KSTR] (d = 256 only), then what
  // the peers send: [C][per] float4 of outputs and [C][g] (m, l)
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(cl_smem);
  __nv_bfloat16* qs = kv_s + stages * 2 * BK * KSTR;
  const int per = (g * D / 4 + C - 1) / C;  // float4 outputs each rank combines
  float4* recv_o = reinterpret_cast<float4*>(qs + (Rows::Q_SMEM ? G_MAX * KSTR : 0));
  float2* recv_ml = reinterpret_cast<float2*>(recv_o + C * per);
  // after the loop: the warps' partials, in the ring (a stage holds a group's)
  float* ob = reinterpret_cast<float*>(cl_smem);
  float* ml = ob + CL_WARPS * G_MAX * OSTR;

  const int length = lengths[n];
  // the row's live keys [k_lo, k_hi), then this CTA's share [lo, hi) of them
  const int k_hi = min(length, keys.cap);
  const int k_lo = window > 0 ? max(0, length - window) : 0;
  const int live = max(0, k_hi - k_lo);
  const int span = ((live + C - 1) / C + BK - 1) / BK * BK;
  const int lo = k_lo + rank * span;
  const int hi = min(k_hi, lo + span);
  const int nblk = hi > lo ? (hi - lo + BK - 1) / BK : 0;
  const int mine = nblk > grp ? (nblk - grp + 1) / CL_GROUPS : 0;  // this group's blocks

  // q first: its loads are issued before any key's and waited for only at
  // the first product; heads at or past g are zero and never written
  const long long qbase = ((long long)n * n_kv + h) * g * D;
  Rows rows;
  rows.init();
  if constexpr (Rows::Q_SMEM) {
    for (int e = tid * VEC; e < G_MAX * D; e += CL_NT * VEC) {
      const int r = e / D, x = e % D;
      cp_async16(qs + r * KSTR + x, q + (r < g ? qbase + r * D + x : 0), r < g);
    }
    cp_async_commit();
    rows.q_from_smem(qs, KSTR);
  } else {
    rows.load_q(q, qbase, g);
  }

  // this group's t-th block (block grp + 2 t of the share) into its slot
  // t % slots, by the group's threads, keys >= hi zero-filled, each key
  // read once and marked first to leave L2; one group each call, empty
  // past the group's last block
  const uint64_t policy = l2_evict_first();
  auto copy = [&](int t) {
    if (t < mine) {
      __nv_bfloat16* ks = kv_s + (grp * slots + t % slots) * 2 * BK * KSTR;
      __nv_bfloat16* vs = ks + BK * KSTR;
      const int kb = lo + (grp + CL_GROUPS * t) * BK;
      for (int e = gtid; e < BK * CPR; e += CL_GROUP) {
        const int c = e / CPR, x = (e % CPR) * VEC;
        const bool ok = kb + c < hi;
        const long long off = ok ? keys.offset(n, kb + c, h) + x : 0;
        cp_async16_hint(ks + c * KSTR + x, k + off, ok, policy);
        cp_async16_hint(vs + c * KSTR + x, v + off, ok, policy);
      }
    }
    cp_async_commit();
  };
  for (int t = 0; t < slots; ++t) copy(t);  // the group's first blocks
  if constexpr (Rows::Q_SMEM) {  // q landed (only the blocks' groups may be pending), for all
    cp_async_wait_upto(slots);
    __syncthreads();
  }

  for (int t = 0; t < mine; ++t) {
    cp_async_wait_upto(slots - 1);  // this thread's pieces of the block have landed
    group_sync(grp);                // and the group's
    const int b = grp + CL_GROUPS * t;
    const __nv_bfloat16* ks =
        kv_s + (grp * slots + t % slots) * 2 * BK * KSTR + wg * CL_KW * KSTR;
    rows.block(ks, ks + BK * KSTR, lo + b * BK + wg * CL_KW, lo, hi, scale, softcap);
    if (t + slots < mine) {
      group_sync(grp);  // the group's warps are done with the slot
      copy(t + slots);
    } else {
      cp_async_commit();  // keeps one group an iteration
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: the merge reuses it

  // merge the warps: each leaves its heads' (m, l) and outputs; each
  // thread then sums four outputs over the warps, rescaled to the heads'
  // common maximum, and sends them to the rank that combines them; the
  // thread of a head's first outputs sends its (m, l) to every rank
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int r = 8 * j + 2 * tig + rr;
      if (gid == 0)
        *reinterpret_cast<float2*>(ml + 2 * (warp * G_MAX + r)) =
            make_float2(rows.m[j][rr], rows.l[j][rr]);
      if (r < g) {
#pragma unroll
        for (int t = 0; t < Rows::KSTEPS; ++t) {
          ob[(warp * G_MAX + r) * OSTR + 16 * t + gid] = rows.acc[j][t][rr];
          ob[(warp * G_MAX + r) * OSTR + 16 * t + gid + 8] = rows.acc[j][t][2 + rr];
        }
      }
    }
  }
  __syncthreads();
  hop::cluster_wait();  // every peer has started
  for (int e = tid; e < g * D / 4; e += CL_NT) {
    const int r = e * 4 / D, x = e * 4 % D;
    float2 mlw[CL_WARPS];
    float mx = NEG_INF;
#pragma unroll
    for (int w = 0; w < CL_WARPS; ++w) {
      mlw[w] = *reinterpret_cast<const float2*>(ml + 2 * (w * G_MAX + r));
      mx = fmaxf(mx, mlw[w].x);
    }
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < CL_WARPS; ++w) {
      const float sc = expf(mlw[w].x - mx);
      const float4 a = *reinterpret_cast<const float4*>(ob + (w * G_MAX + r) * OSTR + x);
      o.x = fmaf(sc, a.x, o.x);
      o.y = fmaf(sc, a.y, o.y);
      o.z = fmaf(sc, a.z, o.z);
      o.w = fmaf(sc, a.w, o.w);
      l = fmaf(sc, mlw[w].y, l);
    }
    hop::st_cluster4(hop::map_rank(recv_o + rank * per + e % per, e / per), o);
    if (x == 0)
      for (int c = 0; c < C; ++c)
        hop::st_cluster2(hop::map_rank(recv_ml + rank * g + r, c), make_float2(mx, l));
  }
  hop::cluster_sync();  // every CTA's partials are where they are combined

  // rank r: float4 outputs [r per, (r + 1) per) of the g x d over the C
  // partials: out = sum_c e^(m_c - m) acc_c / sum_c e^(m_c - m) l_c, m =
  // max_c m_c; a row with no live key gives 0. Thread u takes output u / C
  // and partial u % C (C a power of two, so an output's C lanes share a
  // warp), and the sums run over those lanes. No peer reads this CTA's
  // shared memory after the barrier, so it may exit when done
  const int e0 = rank * per, n_out = min(g * D / 4, e0 + per) - e0;
  const int log_c = __ffs(C) - 1;
  for (int u0 = 0; u0 < n_out * C; u0 += CL_NT) {
    const int u = u0 + tid, e = u >> log_c, c = u & (C - 1);
    const bool ok = e < n_out;
    const int r = (e0 + (ok ? e : 0)) * 4 / D;
    const float2 mlc = ok ? recv_ml[c * g + r] : make_float2(NEG_INF, 0.f);
    float4 a = ok ? recv_o[c * per + e] : make_float4(0.f, 0.f, 0.f, 0.f);
    float m = mlc.x;
#pragma unroll
    for (int o = 1; o < CL_MAX; o <<= 1)
      if (o < C) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    const float w = ok ? expf(mlc.x - m) : 0.f;
    float l = w * mlc.y;
    a.x *= w;
    a.y *= w;
    a.z *= w;
    a.w *= w;
#pragma unroll
    for (int o = 1; o < CL_MAX; o <<= 1) {
      if (o < C) {
        l += __shfl_xor_sync(0xffffffffu, l, o);
        a.x += __shfl_xor_sync(0xffffffffu, a.x, o);
        a.y += __shfl_xor_sync(0xffffffffu, a.y, o);
        a.z += __shfl_xor_sync(0xffffffffu, a.z, o);
        a.w += __shfl_xor_sync(0xffffffffu, a.w, o);
      }
    }
    if (ok && c == 0) {
      const float il = 1.f / fmaxf(l, 1e-37f);
      *reinterpret_cast<uint2*>(out + qbase + (e0 + e) * 4) =
          make_uint2(pack_bf16(a.x * il, a.y * il), pack_bf16(a.z * il, a.w * il));
    }
  }
}

// The launch's configuration: grid (C, KV, B), clusters of C along x, the
// shared memory of the ring and of the peers' partials.
template <int D>
cudaLaunchConfig_t cluster_config(cudaLaunchAttribute* attr, int batch, int n_kv, int g,
                                  int cluster, int stages, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_kv, batch);
  cfg.blockDim = dim3(CL_NT);
  cfg.dynamicSmemBytes = cl_smem_bytes<D>(stages, cluster, g);
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Clusters of ``cluster`` CTAs with a ring of ``stages`` (G query heads)
// that the card holds at once (cudaOccupancyMaxActiveClusters); the first
// call per instantiation also opts in to the most shared memory a CTA may
// take and to clusters above 8 CTAs (non-portable).
template <int D, int NQ>
cudaError_t cluster_occupancy(int g, int cluster, int stages, int* max_clusters) {
  auto kernel = cluster_decode_kernel<D, NQ>;
  static bool opted_in = false;
  cudaError_t err =
      opt_in_smem(kernel, cl_smem_bytes<D>(cl_stages_max<D>(), CL_MAX, G_MAX), opted_in);
  if (err != cudaSuccess) return err;
  static bool wide = false;
  if (!wide) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    wide = true;
  }
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<D>(attr, 1, 1, g, cluster, stages, 0);
  return cudaOccupancyMaxActiveClusters(max_clusters, kernel, &cfg);
}

template <int D, int NQ>
cudaError_t launch_cluster(const void* q, const void* k, const void* v, void* out,
                           const void* lengths, const DenseKeys& keys, int batch, int n_kv, int g,
                           int cluster, int stages, float scale, float softcap, int window,
                           cudaStream_t stream) {
  if (stages > cl_stages_max<D>()) return cudaErrorInvalidValue;
  // checked once per (G, C, stages): a cluster the card cannot hold is refused
  static signed char fits[G_MAX + 1][CL_MAX + 1][CL_STAGES_MAX + 1] = {};
  signed char& fit = fits[g][cluster][stages];
  if (fit == 0) {
    int active = 0;
    const cudaError_t err = cluster_occupancy<D, NQ>(g, cluster, stages, &active);
    if (err != cudaSuccess) return err;
    fit = active >= 1 ? 1 : -1;
  }
  if (fit < 0) return cudaErrorInvalidConfiguration;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = cluster_config<D>(attr, batch, n_kv, g, cluster, stages, stream);
  void (*kernel)(const __nv_bfloat16*, const __nv_bfloat16*, const __nv_bfloat16*,
                 __nv_bfloat16*, const int*, DenseKeys, int, int, int, float, float, int) =
      cluster_decode_kernel<D, NQ>;
  return cudaLaunchKernelEx(&cfg, kernel, static_cast<const __nv_bfloat16*>(q),
                            static_cast<const __nv_bfloat16*>(k),
                            static_cast<const __nv_bfloat16*>(v),
                            static_cast<__nv_bfloat16*>(out), static_cast<const int*>(lengths),
                            keys, n_kv, g, stages, scale, softcap, window);
}

}  // namespace

// B3 in fp32. k/v: (B, S, KV, d) with element strides sb, ss, sh (d
// contiguous). dtype: 0 = float32 (bf16 goes to decode_cluster_launch).
// softcap <= 0 and window <= 0 mean none. Returns the cudaError_t of the
// launches (0 = success).
extern "C" int decode_attention_launch(const void* q, const void* k, const void* v, void* out,
                                       void* o_part, void* ml_part, const void* lengths,
                                       int batch, int seq, long long sb, long long ss,
                                       long long sh, int n_kv, int g, int head_dim,
                                       int n_split, float scale, float softcap, int window,
                                       int dtype, void* stream) {
  const DenseKeys keys{sb, ss, sh, seq};
  return int(launch_any<DenseKeys, false>(dtype, head_dim, q, k, v, out, o_part, ml_part,
                                          lengths, keys, batch, n_kv, g, n_split, scale,
                                          softcap, window, static_cast<cudaStream_t>(stream)));
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
    return int(launch_any<PagedKeys, true>(dtype, head_dim, q, k_pages, v_pages, out, o_part,
                                           ml_part, lengths, keys, n_rows, n_kv, g, n_split,
                                           scale, softcap, window, s));
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

#define CLUSTER_CASES(CALL) \
  switch (head_dim) {        \
    case 16: return int(CALL(16)); \
    case 32: return int(CALL(32)); \
    case 64: return int(CALL(64)); \
    case 128: return int(CALL(128)); \
    case 256: return int(CALL(256)); \
    default: return int(cudaErrorInvalidValue); \
  }

// B3 in bf16: one launch, the splits of a (row, KV head) a cluster of
// ``cluster`` CTAs (a power of two up to 16), each with a ring of
// ``stages`` 64-key blocks (2 or 4; decode_attention.cluster_plan). k/v: (B, S, KV, d) with element strides
// sb, ss, sh (d contiguous). softcap <= 0 and window <= 0 mean none.
extern "C" int decode_cluster_launch(const void* q, const void* k, const void* v, void* out,
                                     const void* lengths, int batch, int seq, long long sb,
                                     long long ss, long long sh, int n_kv, int g, int head_dim,
                                     int cluster, int stages, float scale, float softcap,
                                     int window, void* stream) {
  if (g < 1 || g > G_MAX || batch < 1 || cluster < 1 || cluster > CL_MAX ||
      (cluster & (cluster - 1)) || stages < 2 || stages > CL_STAGES_MAX || stages % 2)
    return int(cudaErrorInvalidValue);
  const DenseKeys keys{sb, ss, sh, seq};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#define CALL(D)                                                                             \
  (g > 8 ? launch_cluster<D, 2>(q, k, v, out, lengths, keys, batch, n_kv, g, cluster, stages, \
                                scale, softcap, window, s)                                   \
         : launch_cluster<D, 1>(q, k, v, out, lengths, keys, batch, n_kv, g, cluster, stages, \
                                scale, softcap, window, s))
  CLUSTER_CASES(CALL)
#undef CALL
}

// Clusters of the B3 bf16 kernel at ``head_dim`` and ``g`` query heads the
// card holds at once, for ``cluster`` CTAs with a ring of ``stages`` blocks,
// into *max_clusters.
extern "C" int decode_cluster_occupancy(int head_dim, int g, int cluster, int stages,
                                        int* max_clusters) {
  if (g < 1 || g > G_MAX || cluster < 1 || cluster > CL_MAX || stages < 2 ||
      stages > CL_STAGES_MAX || stages % 2)
    return int(cudaErrorInvalidValue);
#define CALL(D)                                                          \
  (g > 8 ? cluster_occupancy<D, 2>(g, cluster, stages, max_clusters) \
         : cluster_occupancy<D, 1>(g, cluster, stages, max_clusters))
  CLUSTER_CASES(CALL)
#undef CALL
}
#undef CLUSTER_CASES

extern "C" const char* decode_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
