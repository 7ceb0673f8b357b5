// Mixed-batch ragged paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `mixed_paged_attention` (src/repro/kernels/
// paged_attention.py:268, body `_mixed_kernel` :199) of the JAX package. One
// call serves a whole packed serving step: every segment, a decode row or a
// prefill chunk, is a causal block of queries over its own paged KV prefix.
// Row j of segment s sits at position kv_len[s] - q_len[s] + j and attends
// the keys at or before it (and, with a window w, above position - w). GQA:
// query head h = kv * G + g reads KV head kv. Softcap before the mask, fp32
// online softmax, NEG_INF -1e30, guard l >= 1e-37: the TPU kernel's
// semantics.
//
// What bounds it on an H100: a step of decode rows reads its KV once, about
// sum_seg kv_len * KV * d * 2 * sizeof(T) bytes at 3.35 TB/s; a prefill
// chunk does 4 * q_len * kv_len * H * d operations at 989 TFLOP/s (bf16).
// What the design does about each:
//
// * Split over keys. A CTA's rows take their keys in spans, one work item per
//   (CTA rows, KV head, span), so one long row is read by many SMs at once.
//   A light CTA (at most 16 query vectors: a decode row) takes spans of
//   span_keys keys a row, span_keys from the host (paged_attention.
//   key_splits: 256, more past 64 spans); the heavier CTAs (a chunk's
//   tiles) are split only when there are too few of them to fill half the
//   card, into spans of their keys' share of one CTA an SM. A plan pass (one
//   CTA) lists the items on the card from q_tiles and kv_lens, so the host
//   needs no lengths; the producers run a persistent grid that takes items
//   from a queue (an atomic counter), so short and long items share the
//   SMs; a combine pass rescales each split's partial by e^(m_s - m) and
//   sums. A CTA whose keys fit one span writes its output directly.
// * Pipelined staging. K and V come through a ring of 3 stages (2 at d 256)
//   of 64-key blocks by 16-byte cp.async, page by page through the table
//   (page 1 works); each block's page offsets are read while earlier blocks
//   are in flight, and the next blocks' copies run under this block's
//   products. Keys at or past kv_len, or left of the window, are never
//   loaded (zero-filled): dead table entries name a scratch page holding
//   garbage, even NaN.
// * Every warp computes. bf16 CTAs take two consecutive q-tiles of a
//   segment (128 query vectors), so a chunk reads its prefix once per 128
//   vectors, not per 64. Light CTAs (128 threads, 2 or more an SM) share
//   each block's keys among their 4 warps, 16 keys a warp on mma.sync, and
//   merge the warps' softmax states at the end. The others run on wgmma at
//   d >= 64 (two warpgroups of 64 vectors, K and V in the 128-byte swizzle
//   wgmma reads) and on mma.sync at d <= 32 (8 warps of 16 vectors). fp32
//   (the exactness checks) runs 64-vector tiles on the CUDA cores, with
//   the same split and staging.
//
// Layouts (all contiguous):
//   q, out        (N, KV, G, d)        T
//   k/v_pages     (P, page, KV, d)     T
//   cu_q_lens     (S + 1,)             int32
//   kv_lens       (S,)                 int32
//   block_tables  (S, nb)              int32 physical page ids
//   q_tiles       (n_tiles, 2)         int32 (segment, first packed row):
//                                      q_tiles(cu_q_lens, G), in order
//   o_part        (slots, KV, d)       fp32 partial outputs (unnormalised)
//   ml_part       (slots, KV, 2)       fp32 (m, l) of each partial
//   items         (2, cap_items)       int2 (tile, split) of each kind
//   tile_slot     (n_tiles,)           int32 first partial slot of a split CTA
//   counts        (3,)                 int32 items of each kind, slots used
//   next          (2,)                 int32 the queue of each kind
//   heavy_span    (1,)                 int32 keys per split of a heavy CTA
// A CTA of m vectors cut into n splits owns slots [base, base + n m): split
// s's vector r is slot base + s m + r. Rows of out that no tile covers
// (padding) are left as the caller made them.
#include "attention_common.cuh"
#include "hopper.cuh"

namespace {

using namespace attn;

constexpr int NT = 256;     // threads per CTA of the fp32 producer
constexpr int M_MAX = 64;   // query vectors per q-tile (rows x G)
constexpr int BK = 64;      // keys per block
constexpr int PAD = 4;      // row padding of K and the scores: keeps 16-byte
                            // alignment and spreads a warp's rows over the banks
constexpr int LIGHT_M = 16;      // a CTA of at most this many query vectors is light
constexpr int NO_SPLIT = 1 << 30;  // a span no CTA's keys reach

// ---------------------------------------------------------------------------
// the plan: which rows a CTA takes, and its keys cut into spans
// ---------------------------------------------------------------------------

struct Args {
  const int* cu_q_lens;
  const int* kv_lens;
  const int* block_tables;
  const int* q_tiles;
  const int2* items;     // (2, cap_items) (tile, split) of each kind
  const int* counts;     // (3,) items of each kind, slots used
  const int* tile_slot;  // (n_tiles,) a split leader's first slot
  int* next;             // (2,) the next item of each kind a CTA takes
  int* heavy_span;       // (1,) keys per split of a CTA of more than LIGHT_M vectors
  float* o_part;
  float* ml_part;
  int n_tiles, n_kv, g, page, nb, qt, n_split, span_keys, cap_items, sms;
  int slot_cap;  // partial slots the scratch holds (a slot: one vector, every KV head)
  float scale, softcap;
  int window;
  int pair;  // 1: a CTA takes two consecutive tiles of a segment
};

struct TilePlan {
  int seg;
  int tile_row0, tile_nrow;  // the tile's own rows
  int row0, nrow;            // the CTA's rows: the tile, or its pair
  int pos0;                  // row0's position
  int k_lo, k_hi;            // keys any of the CTA's rows reads
  int span;                  // keys per split
  int n_live;                // splits that hold keys (at least 1)
  bool leader;               // the CTA that runs these rows (a pair's first tile)
};

// the CTA's rows and keys; its spans come from plan_spans
__device__ __forceinline__ TilePlan plan_rows(const Args& a, int t) {
  TilePlan p;
  p.seg = a.q_tiles[2 * t];
  const int row0 = a.q_tiles[2 * t + 1];
  const int seg_lo = a.cu_q_lens[p.seg], seg_hi = a.cu_q_lens[p.seg + 1];
  const int kv_len = a.kv_lens[p.seg];
  p.tile_row0 = row0;
  p.tile_nrow = min(a.qt, seg_hi - row0);
  const int odd = a.pair ? ((row0 - seg_lo) / a.qt) & 1 : 0;
  p.leader = odd == 0;
  p.row0 = row0 - odd * a.qt;
  p.nrow = min(a.pair ? 2 * a.qt : a.qt, seg_hi - p.row0);
  p.pos0 = kv_len - (seg_hi - seg_lo) + (p.row0 - seg_lo);
  p.k_hi = p.pos0 + p.nrow;  // one past the last row's position; <= kv_len
  p.k_lo = a.window > 0 ? max(0, p.pos0 - a.window + 1) : 0;
  return p;
}

// A light CTA (a decode row) takes span_keys keys a row, so a long row runs
// as many CTAs; a heavier one (a chunk's tiles) the span the plan chose.
// The plan's plain version is ref.mixed_split_plan (src/repro_torch/kernels/
// ref.py); chip_smoke.py holds the plan this file runs to it, and the CPU
// tests hold that version to the split's rules. A change here changes it
// and scratch_layout's bound below.
__device__ __forceinline__ void plan_spans(TilePlan& p, const Args& a, int heavy_span) {
  p.span = p.nrow * a.g <= LIGHT_M ? a.span_keys * p.nrow : heavy_span;
  p.n_live = max(1, (p.k_hi - p.k_lo + p.span - 1) / p.span);
}

__device__ __forceinline__ TilePlan plan_tile(const Args& a, int t) {
  TilePlan p = plan_rows(a, t);
  plan_spans(p, a, *a.heavy_span);
  return p;
}

// query vector r of a CTA whose rows start at row0 is head r % g of packed
// row row0 + r / g: its first element in q and out
__device__ __forceinline__ long long vec_offset(const Args& a, int row0, int h, int r, int d) {
  return (((long long)(row0 + r / a.g) * a.n_kv + h) * a.g + r % a.g) * d;
}

// One CTA lists the work: every leading tile's live splits, as items of kind
// 1 (or of kind 0 when its CTA holds at most light_max query vectors), and
// the partial slots of each split CTA. The heavy CTAs are split only when
// there are too few of them to fill half the card, then into spans of about
// their keys' share of one CTA an SM.
__global__ void __launch_bounds__(256) mixed_paged_attention_plan_kernel(Args a, int2* items,
                                                                        int* tile_slot,
                                                                        int* counts,
                                                                        int light_max) {
  __shared__ int count[3], n_heavy, span_h;
  __shared__ unsigned long long heavy_keys;
  if (threadIdx.x < 3) count[threadIdx.x] = 0;
  if (threadIdx.x < 2) a.next[threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    n_heavy = 0;
    heavy_keys = 0;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < a.n_tiles; t += blockDim.x) {
    const TilePlan p = plan_rows(a, t);
    if (!p.leader || p.nrow * a.g <= LIGHT_M) continue;
    atomicAdd(&n_heavy, 1);
    atomicAdd(&heavy_keys, (unsigned long long)(p.k_hi - p.k_lo));
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const long long share = ((long long)heavy_keys * a.n_kv + a.sms - 1) / a.sms;
    span_h = 2 * n_heavy * a.n_kv >= a.sms
                 ? NO_SPLIT
                 : (int)max((long long)a.span_keys, (share + BK - 1) / BK * BK);
    *a.heavy_span = span_h;
  }
  __syncthreads();
  for (int t = threadIdx.x; t < a.n_tiles; t += blockDim.x) {
    TilePlan p = plan_rows(a, t);
    if (!p.leader) continue;
    plan_spans(p, a, span_h);
    const int m_eff = p.nrow * a.g;
    const int kind = m_eff <= light_max ? 0 : 1;
    if (p.n_live > a.n_split) __trap();  // past the work list's room: keys past the table
    const int at = atomicAdd(&count[kind], p.n_live);
    for (int s = 0; s < p.n_live; ++s) items[kind * a.cap_items + at + s] = make_int2(t, s);
    if (p.n_live > 1) tile_slot[t] = atomicAdd(&count[2], p.n_live * m_eff);
  }
  __syncthreads();
  // more slots than scratch_layout allows: stop before a producer writes past them
  if (threadIdx.x == 0 && count[2] > a.slot_cap) __trap();
  if (threadIdx.x < 3) counts[threadIdx.x] = count[threadIdx.x];
}

// One launch's scratch, in 4-byte elements from its start: the plan's work
// list (2 kinds x cap_items int2 (tile, split)), each split CTA's first slot
// (n_tiles int32), counts (3), the queues (2) and the heavy span (1); then,
// 16-byte aligned and only when tiles can split, the fp32 partial outputs
// (slot_cap x n_kv x d) and their (m, l) (slot_cap x n_kv x 2). The bound
// follows plan_spans: a light CTA of m <= LIGHT_M vectors cut into spans of
// span_keys * rows keys owns at most n_split * g + LIGHT_M slots; the heavy
// CTAs split only when fewer than sms / (2 n_kv), each into spans of at
// least their keys' share of sms / n_kv CTAs, so together at most
// 2 M_MAX (ceil(sms / n_kv) + 1) slots a CTA.
struct ScratchLayout {
  long long tile_slot, counts, o_part, ml_part, total, slot_cap;
};

ScratchLayout scratch_layout(int n_tiles, int n_kv, int g, int head_dim, int n_split, int sms) {
  ScratchLayout l;
  l.tile_slot = 4LL * n_tiles * n_split;
  l.counts = l.tile_slot + n_tiles;
  l.o_part = (l.counts + 3 + 2 + 1 + 3) / 4 * 4;
  l.slot_cap = n_split > 1 ? (long long)n_tiles * (n_split * g + 2 * M_MAX + LIGHT_M) +
                                 2LL * M_MAX * ((sms + n_kv - 1) / n_kv)
                           : 0;
  l.ml_part = l.o_part + l.slot_cap * n_kv * head_dim;
  l.total = l.ml_part + l.slot_cap * n_kv * 2;
  return l;
}

// One item of a producer: the CTA's rows, its KV head, its keys [lo, hi)
// and (split CTAs) its first partial slot
struct Work {
  TilePlan p;
  int h, split, lo, hi, slot0;
  const int* tab;  // the segment's block-table row
};

__device__ __forceinline__ Work work_item(const Args& a, int kind, int it) {
  Work w;
  const int2 item = a.items[kind * a.cap_items + it / a.n_kv];
  w.h = it % a.n_kv;
  w.p = plan_tile(a, item.x);
  w.split = item.y;
  w.lo = w.p.k_lo + w.split * w.p.span;
  w.hi = min(w.p.k_hi, w.lo + w.p.span);
  w.slot0 = w.p.n_live > 1 ? a.tile_slot[item.x] + w.split * w.p.nrow * a.g : 0;
  w.tab = a.block_tables + (long long)w.p.seg * a.nb;
  return w;
}

// The item a CTA of a persistent producer takes next: CTAs that finish
// early take more (one atomicAdd an item), so short and long items share
// the card. Every item ends in a barrier, so s_it is free again here.
__device__ __forceinline__ int next_item(const Args& a, int kind, int* s_it) {
  if (threadIdx.x == 0) *s_it = atomicAdd(a.next + kind, 1);
  __syncthreads();
  return *s_it;
}

// the partial (o at slot * d, (m, l) at 2 * slot) of vector r of a split
// whose first vector is slot0, for KV head h
__device__ __forceinline__ long long part_slot(const Args& a, int slot0, int r, int h) {
  return (long long)(slot0 + r) * a.n_kv + h;
}

// key kp's first element in the pool (KV head h), through the table
__device__ __forceinline__ long long key_offset(const Args& a, const int* tab, int kp, int h,
                                                int d) {
  const long long pg = tab[kp / a.page];
  return ((pg * a.page + kp % a.page) * a.n_kv + h) * d;
}

// ---------------------------------------------------------------------------
// staging: a ring of STAGES blocks of BK keys, copied by cp.async
// ---------------------------------------------------------------------------
//
// Block b of a split holds keys [lo + b BK, lo + (b + 1) BK) and lives in
// stage b % STAGES; koff[b % STAGES][c] is its key c's first element in the
// pool (-1: past the split's end, never loaded), computed by BK threads while
// earlier blocks are in flight. A copy moves each key's K and V rows in
// 16-byte pieces (zero-filled where not loaded) and commits one group.

// key offsets of block b (of nblk) into koff
__device__ __forceinline__ void block_offsets(long long* koff, const Args& a, const Work& w,
                                              int b, int nblk, int d) {
  if (threadIdx.x < BK) {
    const int kp = w.lo + b * BK + threadIdx.x;
    koff[threadIdx.x] = b < nblk && kp < w.hi ? key_offset(a, w.tab, kp, w.h, d) : -1;
  }
}

// block b's K and V rows (D elements of T) into the stage at dst(c, j), the
// address of key c's 16-byte piece j; an empty group past the last block
template <typename T, int D, int NTHREADS, class Dst>
__device__ __forceinline__ void copy_block(const T* __restrict__ k, const T* __restrict__ v,
                                           const long long* koff, int b, int nblk, Dst dst) {
  constexpr int VEC = 16 / int(sizeof(T)), CPR = D / VEC;  // pieces per key row
  if (b < nblk) {
    for (int e = threadIdx.x; e < BK * CPR; e += NTHREADS) {
      const int c = e / CPR, j = e % CPR;
      const long long off = koff[c];
      const long long src = off >= 0 ? off + j * VEC : 0;
      T* kd;
      T* vd;
      dst(c, j, kd, vd);
      cp_async16(kd, k + src, off >= 0);
      cp_async16(vd, v + src, off >= 0);
    }
  }
  cp_async_commit();
}

// The block loop: offsets and copies run STAGES - 1 blocks ahead of the
// products (compute(i, stage)). With one stage, each block is copied and
// then computed in turn. Every block starts with a barrier after the last
// one's products, so compute may leave shared scratch for the next block.
// ASYNC: the products read shared memory through the async proxy (wgmma),
// which must see the copies' writes.
template <int STAGES, bool ASYNC, class Offsets, class Copy, class Compute>
__device__ __forceinline__ void block_loop(int nblk, Offsets offsets, Copy copy,
                                           Compute compute) {
  if constexpr (STAGES == 1) {
    for (int i = 0; i < nblk; ++i) {
      offsets(i, 0);
      __syncthreads();
      copy(i, 0);
      cp_async_wait<0>();
      __syncthreads();
      compute(i, 0);
      __syncthreads();
    }
  } else {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) offsets(s, s);
    __syncthreads();
#pragma unroll
    for (int s = 0; s < STAGES - 1; ++s) copy(s, s);
    for (int i = 0; i < nblk; ++i) {
      cp_async_wait<STAGES - 2>();  // this thread's pieces of block i have landed
      if constexpr (ASYNC) hop::fence_proxy_async();
      __syncthreads();  // and everyone's; block i - 1's stage is free
      copy(i + STAGES - 1, (i + STAGES - 1) % STAGES);
      compute(i, i % STAGES);
      offsets(i + STAGES, i % STAGES);
    }
    cp_async_wait<0>();
    __syncthreads();
  }
}

// out[r] = sum_s e^(m_s - m) o_s / sum_s e^(m_s - m) l_s over a split tile's
// partials. One CTA per (tile, KV head, 16 of the tile's vectors); tiles of
// one split return at once. A warp finds two vectors' split maxima and
// weights; then each thread sums four output columns of one vector over the
// splits, 16 bytes a load, several loads in flight.
constexpr int COMBINE_NT = 256;
constexpr int COMBINE_V = 16;  // query vectors a combine CTA takes
constexpr int MAX_SPLIT = 64;  // splits per tile (paged_attention.MAX_KEY_SPLITS)

__device__ __forceinline__ void store4(float* dst, float4 v) {
  *reinterpret_cast<float4*>(dst) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* dst, float4 v) {
  *reinterpret_cast<uint2*>(dst) = make_uint2(pack_bf16(v.x, v.y), pack_bf16(v.z, v.w));
}

template <typename T>
__global__ void __launch_bounds__(COMBINE_NT) mixed_paged_attention_combine_kernel(
    Args a, T* __restrict__ out, int d) {
  __shared__ float w_s[COMBINE_V][MAX_SPLIT];
  __shared__ float inv_s[COMBINE_V];
  const TilePlan p = plan_tile(a, blockIdx.x);
  const int v0 = blockIdx.z * COMBINE_V;  // this CTA's first vector of the tile
  const int nv = min(COMBINE_V, p.tile_nrow * a.g - v0);
  if (p.n_live <= 1 || nv <= 0) return;
  const int h = blockIdx.y, warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  // the CTA that ran these rows: this tile, or the pair it leads; vector r
  // of this tile is vector r0 + r of that CTA
  const int slot0 = a.tile_slot[blockIdx.x - (p.leader ? 0 : 1)];
  const int r0 = (p.tile_row0 - p.row0) * a.g + v0;
  const long long step = (long long)p.nrow * a.g * a.n_kv;  // from one split to the next
  for (int r = warp; r < nv; r += COMBINE_NT / 32) {
    const long long base = part_slot(a, slot0, r0 + r, h);  // split s at base + s * step
    float mx = NEG_INF;
    for (int s = lane; s < p.n_live; s += 32) mx = fmaxf(mx, a.ml_part[2 * (base + s * step)]);
    mx = warp_max(mx);
    float l = 0.f;
    for (int s = lane; s < p.n_live; s += 32) {
      const float2 ml = *reinterpret_cast<const float2*>(a.ml_part + 2 * (base + s * step));
      const float wt = expf(ml.x - mx);
      w_s[r][s] = wt;
      l = fmaf(wt, ml.y, l);
    }
    l = warp_sum(l);
    if (lane == 0) inv_s[r] = 1.f / fmaxf(l, 1e-37f);
  }
  __syncthreads();
  const int q4 = d / 4;  // 16-byte pieces of a vector
  for (int e = threadIdx.x; e < nv * q4; e += COMBINE_NT) {
    const int r = e / q4, x = 4 * (e % q4);
    const float* src = a.o_part + part_slot(a, slot0, r0 + r, h) * d + x;
    float4 o = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 8
    for (int s = 0; s < p.n_live; ++s) {
      const float4 t = __ldg(reinterpret_cast<const float4*>(src + s * step * d));
      const float wt = w_s[r][s];
      o.x = fmaf(wt, t.x, o.x);
      o.y = fmaf(wt, t.y, o.y);
      o.z = fmaf(wt, t.z, o.z);
      o.w = fmaf(wt, t.w, o.w);
    }
    const float inv = inv_s[r];
    store4(out + vec_offset(a, p.tile_row0, h, v0 + r, d) + x,
           make_float4(o.x * inv, o.y * inv, o.z * inv, o.w * inv));
  }
}

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores
// ---------------------------------------------------------------------------

// K/V stages: two, but one at d = 256, where a second would not fit 227 KB
template <int D>
__host__ __device__ constexpr int f32_stages() {
  return D > 128 ? 1 : 2;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (M_MAX * D + f32_stages<D>() * BK * (2 * D + PAD) + M_MAX * (BK + PAD) +
                          3 * M_MAX) +
         sizeof(long long) * f32_stages<D>() * BK;
}

// one CTA per SM at the least: ptxas may use up to 255 registers rather
// than spill to fit more
template <int D>
__global__ void __launch_bounds__(NT, 1) mixed_paged_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, float* __restrict__ out, Args a) {
  constexpr int STAGES = f32_stages<D>();
  constexpr int SRG = NT / BK;      // row groups in the score product
  constexpr int SRPT = M_MAX / SRG; // rows per thread there
  constexpr int RG = NT / D;        // row groups in the value product
  constexpr int RPT = M_MAX / RG;   // rows per thread there
  constexpr int KS = D + PAD, SS = BK + PAD;  // row strides of ks and ss
  static_assert(D % 4 == 0 && NT % D == 0 && NT % BK == 0 && BK == 64, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                      // [M_MAX][D]
  float* ks = qs + M_MAX * D;            // [STAGES][BK][KS]
  float* vs = ks + STAGES * BK * KS;     // [STAGES][BK][D]
  float* ss = vs + STAGES * BK * D;      // [M_MAX][SS] scores, then probabilities
  float* m_s = ss + M_MAX * SS;
  float* l_s = m_s + M_MAX;
  float* a_s = l_s + M_MAX;
  long long* koff = reinterpret_cast<long long*>(a_s + M_MAX);  // [STAGES][BK]

  __shared__ int s_it;
  const int tid = threadIdx.x;
  const int g = a.g;
  const int dcol = tid % D, prg = tid / D;
  const int scol = tid % BK, srg = tid / BK;
  const int n_items = a.counts[1] * a.n_kv;
  for (int it = next_item(a, 1, &s_it); it < n_items; it = next_item(a, 1, &s_it)) {
    const Work w = work_item(a, 1, it);
    const TilePlan& p = w.p;
    const int h = w.h;
    const int m_eff = p.nrow * g;

    // the tile's queries: row r is query head r % g of packed row row0 + r / g
    for (int e = tid * 4; e < m_eff * D; e += NT * 4) {
      const int r = e / D, x = e % D;
      *reinterpret_cast<float4*>(qs + r * D + x) =
          __ldg(reinterpret_cast<const float4*>(q + vec_offset(a, p.row0, h, r, D) + x));
    }
    for (int r = tid; r < M_MAX; r += NT) {
      m_s[r] = NEG_INF;
      l_s[r] = 0.f;
    }
    // live rows this thread owns in each product (rows r = group + groups * i
    // with r < m_eff); the loops stop there, so a decode tile of G rows does
    // G rows' work, not M_MAX's
    const int n_s = (m_eff - srg + SRG - 1) / SRG;
    const int n_o = (m_eff - prg + RG - 1) / RG;
    float acc[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
    __syncthreads();

    const int nblk = (w.hi - w.lo + BK - 1) / BK;
    auto offsets = [&](int b, int st) { block_offsets(koff + st * BK, a, w, b, nblk, D); };
    auto copy = [&](int b, int st) {
      copy_block<float, D, NT>(k_pages, v_pages, koff + st * BK, b, nblk,
                               [&](int c, int j, float*& kd, float*& vd) {
                                 kd = ks + (st * BK + c) * KS + 4 * j;
                                 vd = vs + (st * BK + c) * D + 4 * j;
                               });
    };
    auto compute = [&](int blk, int st) {
      const int kb = w.lo + blk * BK;
      const float* kst = ks + st * BK * KS;
      const float* vst = vs + st * BK * D;
      // scores: thread owns key column scol for rows srg, srg + SRG, ...;
      // four dims per shared-memory read
      {
        float sacc[SRPT];
#pragma unroll
        for (int i = 0; i < SRPT; ++i) sacc[i] = 0.f;
        if (n_s == SRPT)
          dot_rows<SRPT, D, true>(sacc, qs, kst + scol * KS, srg, SRG, n_s);
        else
          dot_rows<SRPT, D, false>(sacc, qs, kst + scol * KS, srg, SRG, n_s);
        const int kp = kb + scol;
#pragma unroll
        for (int i = 0; i < SRPT; ++i) {
          if (i >= n_s) break;
          const int r = srg + SRG * i;
          const int qp = p.pos0 + r / g;
          const bool ok = kp < w.hi && kp <= qp && (a.window <= 0 || kp > qp - a.window);
          float sc = sacc[i] * a.scale;
          if (a.softcap > 0.f) sc = a.softcap * tanhf(sc / a.softcap);
          ss[r * SS + scol] = ok ? sc : -INFINITY;
        }
      }
      __syncthreads();
      // online softmax, one warp per row; masked keys get p = 0 exactly
      {
        const int warp = tid / 32, lane = tid % 32;
        for (int r = warp; r < m_eff; r += NT / 32) {
          float* srow = ss + r * SS;
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
      // acc = alpha * acc + P V: thread owns output column dcol; four keys
      // per shared-memory read of P
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i >= n_o) break;
        acc[i] *= a_s[prg + RG * i];
      }
      if (n_o == RPT)
        pv_rows<RPT, D, SS, BK, true>(acc, ss, vst, dcol, prg, RG, n_o);
      else
        pv_rows<RPT, D, SS, BK, false>(acc, ss, vst, dcol, prg, RG, n_o);
    };
    block_loop<STAGES, false>(nblk, offsets, copy, compute);

    // one split: the output; several: this split's partial and its (m, l)
    if (p.n_live == 1) {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i >= n_o) break;
        const int r = prg + RG * i;
        out[vec_offset(a, p.row0, h, r, D) + dcol] = acc[i] / fmaxf(l_s[r], 1e-37f);
      }
    } else {
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        if (i >= n_o) break;
        const int r = prg + RG * i;
        a.o_part[part_slot(a, w.slot0, r, h) * D + dcol] = acc[i];
      }
      for (int r = tid; r < m_eff; r += NT) {
        const long long pi = part_slot(a, w.slot0, r, h);
        a.ml_part[2 * pi] = m_s[r];
        a.ml_part[2 * pi + 1] = l_s[r];
      }
    }
    __syncthreads();  // the next item reuses shared memory
  }
}

// ---------------------------------------------------------------------------
// bf16: three producers on the tensor cores, chosen per CTA by its rows
// ---------------------------------------------------------------------------
//
// A bf16 CTA takes two consecutive q-tiles of a segment (up to 128 query
// vectors), so a prefill chunk streams its prefix once per 128 vectors. A
// CTA of at most 16 vectors (a decode row at G <= 16, a chunk's short last
// tile) is a light item; the rest run on wgmma at d >= 64 and on mma.sync at
// d <= 32, where a 64-wide swizzled row does not fit.

constexpr int MMA_PAD = 8;  // bf16 row padding of the staged Q, K and V
constexpr int PAIR_M = 2 * M_MAX;  // query vectors of a bf16 CTA

template <int D>
__host__ __device__ constexpr int bf16_stages() {
  return D > 128 ? 2 : 3;  // K/V stages in the ring
}

// the split's unnormalised accumulator and (m, l) of rows a and b
template <class Rows>
__device__ __forceinline__ void store_partial(const Rows& rows, const Args& a, long long pa,
                                              long long pb, bool live_a, bool live_b, int d) {
  const int tig = threadIdx.x % 4;
#pragma unroll
  for (int n = 0; n < Rows::NT_O; ++n) {
    const int x = n * 8 + 2 * tig;
    if (live_a)
      *reinterpret_cast<float2*>(a.o_part + pa * d + x) = make_float2(rows.acc[n][0], rows.acc[n][1]);
    if (live_b)
      *reinterpret_cast<float2*>(a.o_part + pb * d + x) = make_float2(rows.acc[n][2], rows.acc[n][3]);
  }
  if (tig == 0) {
    if (live_a) *reinterpret_cast<float2*>(a.ml_part + 2 * pa) = make_float2(rows.m_a, rows.l_a);
    if (live_b) *reinterpret_cast<float2*>(a.ml_part + 2 * pb) = make_float2(rows.m_b, rows.l_b);
  }
}

// --- light items: at most 16 query vectors, the keys shared among 4 warps ---
//
// A decode row at G 4 fills 4 of an mma's 16 rows, so a warp per 16 vectors
// would leave the other warps idle while the row streams its keys. Here all
// four warps hold the same 16 vectors and each takes 16 of every staged
// block's 64 keys (attn::MmaRows over 16 keys), with its own online softmax;
// at the end the four states are merged in shared memory. 128 threads and a
// ring of 3 stages (2 at d 256) leave room for two or more CTAs an SM.

constexpr int LIGHT_NT = 128;
constexpr int LIGHT_WARPS = LIGHT_NT / 32;

template <int D>
constexpr size_t light_smem_bytes() {
  return sizeof(__nv_bfloat16) * (bf16_stages<D>() * 2 * BK + (D > 128 ? LIGHT_M : 0)) *
             (D + MMA_PAD) +
         sizeof(long long) * bf16_stages<D>() * BK;
}

// one CTA an SM at the least: with (128) alone ptxas spilled at d 16
template <int D>
__global__ void __launch_bounds__(LIGHT_NT, 1) mixed_paged_attention_light_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, __nv_bfloat16* __restrict__ out, Args a) {
  constexpr int STAGES = bf16_stages<D>();
  constexpr int KSTR = D + MMA_PAD;       // staged row stride (bf16)
  constexpr int KW = BK / LIGHT_WARPS;    // keys of a block each warp takes
  constexpr int OSTR = D + 4;             // fp32 row stride of the merge
  using Rows = MmaRows<D, KSTR, KW>;
  static_assert(KW == 16, "light tile shape");
  // the merge's [warp][16][OSTR] fp32 partials and [warp][16] (m, l) reuse
  // the stages
  static_assert(sizeof(float) * LIGHT_WARPS * LIGHT_M * (OSTR + 2) <=
                    sizeof(__nv_bfloat16) * STAGES * 2 * BK * KSTR,
                "light merge fits the stages");

  extern __shared__ __align__(16) unsigned char light_smem[];
  // [STAGES][K, V][BK][KSTR], then Q [16][KSTR] (d = 256 only)
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(light_smem);
  __nv_bfloat16* qs = kv_s + STAGES * 2 * BK * KSTR;
  long long* koff = reinterpret_cast<long long*>(qs + (Rows::Q_SMEM ? LIGHT_M * KSTR : 0));
  float* ob = reinterpret_cast<float*>(light_smem);  // the merge, after the loop
  float* ml = ob + LIGHT_WARPS * LIGHT_M * OSTR;
  __shared__ int s_it;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int g = a.g;
  const int n_items = a.counts[0] * a.n_kv;
  for (int it = next_item(a, 0, &s_it); it < n_items; it = next_item(a, 0, &s_it)) {
    const Work w = work_item(a, 0, it);
    const TilePlan& p = w.p;
    const int h = w.h;
    const int m_eff = p.nrow * g;  // <= 16
    // every warp holds vectors gid and gid + 8; those at or past m_eff are
    // zero and never written
    const int ra = gid, rb = gid + 8;
    const int qpa = p.pos0 + ra / g, qpb = p.pos0 + rb / g;
    Rows rows;
    rows.init();
    if constexpr (Rows::Q_SMEM) {
      for (int e = tid * 8; e < LIGHT_M * D; e += LIGHT_NT * 8) {
        const int r = e / D, x = e % D;
        uint4 t = make_uint4(0u, 0u, 0u, 0u);
        if (r < m_eff)
          t = __ldg(reinterpret_cast<const uint4*>(q + vec_offset(a, p.row0, h, r, D) + x));
        *reinterpret_cast<uint4*>(qs + r * KSTR + x) = t;
      }
      rows.q_from_smem(qs, KSTR);
    } else {
      rows.load_q(q, vec_offset(a, p.row0, h, ra, D), vec_offset(a, p.row0, h, rb, D),
                  ra < m_eff, rb < m_eff);
    }
    const int hi_a = min(qpa + 1, w.hi), hi_b = min(qpb + 1, w.hi);
    const int lo_a = a.window > 0 ? qpa - a.window + 1 : 0;
    const int lo_b = a.window > 0 ? qpb - a.window + 1 : 0;

    const int nblk = (w.hi - w.lo + BK - 1) / BK;
    auto offsets = [&](int b, int st) { block_offsets(koff + st * BK, a, w, b, nblk, D); };
    auto copy = [&](int b, int st) {
      __nv_bfloat16* kst = kv_s + st * 2 * BK * KSTR;
      copy_block<__nv_bfloat16, D, LIGHT_NT>(
          k_pages, v_pages, koff + st * BK, b, nblk,
          [&](int c, int j, __nv_bfloat16*& kd, __nv_bfloat16*& vd) {
            kd = kst + c * KSTR + 8 * j;
            vd = kd + BK * KSTR;
          });
    };
    auto compute = [&](int blk, int st) {  // warp w: keys 16w..16w+15 of the block
      const __nv_bfloat16* kst = kv_s + st * 2 * BK * KSTR + warp * KW * KSTR;
      rows.block(kst, kst + BK * KSTR, w.lo + blk * BK + warp * KW, lo_a, hi_a, lo_b, hi_b,
                 a.scale, a.softcap);
    };
    block_loop<STAGES, false>(nblk, offsets, copy, compute);

    // merge the warps: each rescales its accumulator to the rows' common
    // maximum; then every thread sums the warps' share of some outputs
    if (tig == 0) {
      ml[2 * (warp * LIGHT_M + ra)] = rows.m_a;
      ml[2 * (warp * LIGHT_M + ra) + 1] = rows.l_a;
      ml[2 * (warp * LIGHT_M + rb)] = rows.m_b;
      ml[2 * (warp * LIGHT_M + rb) + 1] = rows.l_b;
    }
    __syncthreads();
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int v = 0; v < LIGHT_WARPS; ++v) {
      mx_a = fmaxf(mx_a, ml[2 * (v * LIGHT_M + ra)]);
      mx_b = fmaxf(mx_b, ml[2 * (v * LIGHT_M + rb)]);
    }
    const float sa = expf(rows.m_a - mx_a), sb = expf(rows.m_b - mx_b);
#pragma unroll
    for (int n = 0; n < Rows::NT_O; ++n) {
      const int x = n * 8 + 2 * tig;
      *reinterpret_cast<float2*>(ob + (warp * LIGHT_M + ra) * OSTR + x) =
          make_float2(rows.acc[n][0] * sa, rows.acc[n][1] * sa);
      *reinterpret_cast<float2*>(ob + (warp * LIGHT_M + rb) * OSTR + x) =
          make_float2(rows.acc[n][2] * sb, rows.acc[n][3] * sb);
    }
    __syncthreads();
    for (int e = tid; e < m_eff * D; e += LIGHT_NT) {
      const int r = e / D, x = e % D;
      float mx = NEG_INF;
#pragma unroll
      for (int v = 0; v < LIGHT_WARPS; ++v) mx = fmaxf(mx, ml[2 * (v * LIGHT_M + r)]);
      float o = 0.f, l = 0.f;
#pragma unroll
      for (int v = 0; v < LIGHT_WARPS; ++v) {
        o += ob[(v * LIGHT_M + r) * OSTR + x];
        l = fmaf(expf(ml[2 * (v * LIGHT_M + r)] - mx), ml[2 * (v * LIGHT_M + r) + 1], l);
      }
      if (p.n_live == 1) {
        out[vec_offset(a, p.row0, h, r, D) + x] = __float2bfloat16(o / fmaxf(l, 1e-37f));
      } else {
        const long long pi = part_slot(a, w.slot0, r, h);
        a.o_part[pi * D + x] = o;
        if (x == 0) *reinterpret_cast<float2*>(a.ml_part + 2 * pi) = make_float2(mx, l);
      }
    }
    __syncthreads();  // the next item reuses shared memory
  }
}

// --- chunk items at d <= 32: mma.sync, 8 warps x 16 query vectors ---
//
// FlashAttention-2's register layout (attn::MmaRows): warp w owns the CTA's
// query vectors 16w..16w+15 (vectors past m_eff idle); K and V staged in
// shared memory as [key][d].

constexpr int MMA_NT = 256;  // 8 warps x 16 vectors = PAIR_M

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * bf16_stages<D>() * 2 * BK * (D + MMA_PAD) +
         sizeof(long long) * bf16_stages<D>() * BK;
}

template <int D>
__global__ void __launch_bounds__(MMA_NT) mixed_paged_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, __nv_bfloat16* __restrict__ out, Args a) {
  constexpr int STAGES = bf16_stages<D>();
  constexpr int KSTR = D + MMA_PAD;  // staged row stride (bf16); rows stay 16-byte aligned
  using Rows = MmaRows<D, KSTR>;
  static_assert(BK == MMA_BK && !Rows::Q_SMEM && MMA_NT / 32 * 16 == PAIR_M, "mma tile shape");

  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* kv_s = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [STAGES][K, V][BK][KSTR]
  long long* koff = reinterpret_cast<long long*>(kv_s + STAGES * 2 * BK * KSTR);
  __shared__ int s_it;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4;
  const int g = a.g;
  const int n_items = a.counts[1] * a.n_kv;
  for (int it = next_item(a, 1, &s_it); it < n_items; it = next_item(a, 1, &s_it)) {
    const Work w = work_item(a, 1, it);
    const TilePlan& p = w.p;
    const int h = w.h;
    const int m_eff = p.nrow * g;
    const bool active = warp * 16 < m_eff;  // owns a live vector

    // this thread's two vectors (the mma's rows gid and gid + 8), their
    // positions; vectors at or past m_eff are zero and never written
    const int ra = warp * 16 + gid, rb = ra + 8;
    const int qpa = p.pos0 + ra / g, qpb = p.pos0 + rb / g;
    Rows rows;
    rows.init();
    if (active)
      rows.load_q(q, vec_offset(a, p.row0, h, ra, D), vec_offset(a, p.row0, h, rb, D),
                  ra < m_eff, rb < m_eff);
    // the keys each row reads: at or before its position, inside its
    // window, inside this split
    const int hi_a = min(qpa + 1, w.hi), hi_b = min(qpb + 1, w.hi);
    const int lo_a = a.window > 0 ? qpa - a.window + 1 : 0;
    const int lo_b = a.window > 0 ? qpb - a.window + 1 : 0;

    const int nblk = (w.hi - w.lo + BK - 1) / BK;
    auto offsets = [&](int b, int st) { block_offsets(koff + st * BK, a, w, b, nblk, D); };
    auto copy = [&](int b, int st) {
      __nv_bfloat16* kst = kv_s + st * 2 * BK * KSTR;
      copy_block<__nv_bfloat16, D, MMA_NT>(
          k_pages, v_pages, koff + st * BK, b, nblk,
          [&](int c, int j, __nv_bfloat16*& kd, __nv_bfloat16*& vd) {
            kd = kst + c * KSTR + 8 * j;
            vd = kd + BK * KSTR;
          });
    };
    auto compute = [&](int blk, int st) {
      const __nv_bfloat16* kst = kv_s + st * 2 * BK * KSTR;
      if (active)
        rows.block(kst, kst + BK * KSTR, w.lo + blk * BK, lo_a, hi_a, lo_b, hi_b, a.scale,
                   a.softcap);
    };
    block_loop<STAGES, false>(nblk, offsets, copy, compute);

    if (active) {
      if (p.n_live == 1)
        rows.store(out, vec_offset(a, p.row0, h, ra, D), vec_offset(a, p.row0, h, rb, D),
                   ra < m_eff, rb < m_eff);
      else
        store_partial(rows, a, part_slot(a, w.slot0, ra, h), part_slot(a, w.slot0, rb, h),
                      ra < m_eff, rb < m_eff, D);
    }
    __syncthreads();  // the next item reuses shared memory
  }
}

// --- chunk items at d >= 64: wgmma, two warpgroups x 64 query vectors ---
//
// Each warpgroup owns 64 of the CTA's 128 vectors and runs S = Q K^T as
// wgmma m64n64k16 (Q and K from shared memory; m64n32k16 over each half of
// a block at d 256, where O alone is 128 registers a thread) and O += P V as
// wgmma m64n{d}k16 (P from registers, V from shared memory), with the
// softmax in base 2 on the accumulators, as B4 does. The operands sit in 128-byte
// swizzled regions of 64 columns (hopper.cuh): Q [warpgroup][d / 64][64][64]
// written by the threads, K and V [stage][d / 64][BK][64] written by
// cp.async in that layout; both then pass through the async proxy fence
// before wgmma reads them.

constexpr int WG_NT = 256;  // two warpgroups
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
constexpr size_t wg_smem_bytes() {
  return 1024 + sizeof(__nv_bfloat16) * (PAIR_M * D + bf16_stages<D>() * 2 * BK * D) +
         sizeof(long long) * bf16_stages<D>() * BK;
}

// keys of one S = Q K^T product: a block, or half of one at d 256
template <int D>
__host__ __device__ constexpr int s_keys() {
  return D > 128 ? 32 : 64;
}

template <int N>
__device__ __forceinline__ void wgmma_s(float (&s)[N / 2], uint64_t a, uint64_t b) {
  if constexpr (N == 32) hop::wgmma_ss_n32(s, a, b, 1);
  else hop::wgmma_ss_n64(s, a, b, 1);
}

template <int N>
__device__ __forceinline__ void wgmma_o(float (&o)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (N == 64) hop::wgmma_rs_n64(o, a, b, 1);
  else if constexpr (N == 128) hop::wgmma_rs_n128(o, a, b, 1);
  else hop::wgmma_rs_n256(o, a, b, 1);
}

// scores x (S's accumulators for N keys: row a of key tile j is x[4j],
// x[4j + 1], row b x[4j + 2], x[4j + 3], at keys k0 + 8j and k0 + 8j + 1)
// into base 2: x * mul, or cap2 * tanh(x * mul) with CAP; with MASK, keys
// outside [lo, hi) of their row to -inf; and each row's maximum
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
__global__ void __launch_bounds__(WG_NT, 1) mixed_paged_attention_wgmma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, __nv_bfloat16* __restrict__ out, Args a) {
  constexpr int STAGES = bf16_stages<D>();
  constexpr int NC = D / 64;     // 64-column regions of a row
  constexpr int REG = 64 * 64;   // bf16 of one region of 64 rows (Q, K or V)
  constexpr int KS = s_keys<D>();
  static_assert(D % 64 == 0 && D <= 256 && BK == 64 && WG_NT / 128 * 64 == PAIR_M,
                "wgmma tile shape");

  extern __shared__ unsigned char wg_smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(
      (reinterpret_cast<uintptr_t>(wg_smem_raw) + 1023) & ~uintptr_t(1023));
  __nv_bfloat16* ks = qs + PAIR_M * D;            // [STAGES][NC][BK][64]
  __nv_bfloat16* vs = ks + STAGES * NC * REG;     // [STAGES][NC][BK][64]
  long long* koff = reinterpret_cast<long long*>(vs + STAGES * NC * REG);  // [STAGES][BK]
  __shared__ int s_it;

  const int tid = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warpgroup, warp-uniform
  const int tw = tid % 128, warp = tw / 32, lane = tw % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int g = a.g;
  __nv_bfloat16* qw = qs + wg * NC * REG;  // this warpgroup's 64 query vectors
  const float scale2 = a.scale * LOG2E;   // without a softcap
  const float cap_in = a.scale / a.softcap, cap2 = a.softcap * LOG2E;  // with one
  const int n_items = a.counts[1] * a.n_kv;
  for (int it = next_item(a, 1, &s_it); it < n_items; it = next_item(a, 1, &s_it)) {
    const Work w = work_item(a, 1, it);
    const TilePlan& p = w.p;
    const int h = w.h;
    const int m_eff = p.nrow * g;
    const bool live = wg * 64 < m_eff;  // the warpgroup owns a live vector

    // Q, swizzled: vector r = 64 wg + rr; vectors at or past m_eff are zero.
    // Every load is issued before the first store.
    constexpr int QCH = 64 * D / 8 / 128;  // 16-byte pieces a thread moves
    uint4 qv[QCH];
#pragma unroll
    for (int u = 0; u < QCH; ++u) {
      const int e = tw + 128 * u, rr = e / (D / 8), j = e % (D / 8), r = wg * 64 + rr;
      qv[u] = r < m_eff ? __ldg(reinterpret_cast<const uint4*>(
                              q + vec_offset(a, p.row0, h, r, D) + j * 8))
                        : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int u = 0; u < QCH; ++u) {
      const int e = tw + 128 * u, rr = e / (D / 8), j = e % (D / 8);
      *reinterpret_cast<uint4*>(qw + (j / 8) * REG + rr * 64 + (((j % 8) ^ (rr % 8)) * 8)) = qv[u];
    }
    hop::fence_proxy_async();  // the block loop's first barrier publishes Q to wgmma

    // this thread's rows of the accumulators: gid and gid + 8 of its warp's 16
    const int ra = wg * 64 + warp * 16 + gid, rb = ra + 8;
    const int qpa = p.pos0 + ra / g, qpb = p.pos0 + rb / g;
    const int hi_a = min(qpa + 1, w.hi), hi_b = min(qpb + 1, w.hi);
    const int lo_a = a.window > 0 ? qpa - a.window + 1 : 0;
    const int lo_b = a.window > 0 ? qpb - a.window + 1 : 0;
    // the positions of this warpgroup's first and last live vectors
    const int qp_lo = p.pos0 + wg * 64 / g;
    const int qp_hi = p.pos0 + min(wg * 64 + 63, m_eff - 1) / g;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

    const int nblk = (w.hi - w.lo + BK - 1) / BK;
    auto offsets = [&](int b, int st) { block_offsets(koff + st * BK, a, w, b, nblk, D); };
    auto copy = [&](int b, int st) {
      copy_block<__nv_bfloat16, D, WG_NT>(
          k_pages, v_pages, koff + st * BK, b, nblk,
          [&](int c, int j, __nv_bfloat16*& kd, __nv_bfloat16*& vd) {
            const int at = (st * NC + j / 8) * REG + c * 64 + (((j % 8) ^ (c % 8)) * 8);
            kd = ks + at;
            vd = vs + at;
          });
    };
    auto compute = [&](int blk, int st) {
      if (!live) return;
#pragma unroll
      for (int sub = 0; sub < BK / KS; ++sub) {
        const int kb = w.lo + blk * BK + sub * KS;
        // S = Q K^T: 64 vectors x KS keys (rows sub KS.. of each K region);
        // descriptors advance in 16-byte units: k-step kk is column 16 (kk %
        // 4) of region kk / 4
        float s[KS / 2];
#pragma unroll
        for (int x = 0; x < KS / 2; ++x) s[x] = 0.f;
        const uint64_t dq = hop::desc_sw128(qw, 16, 1024);
        const uint64_t dk = hop::desc_sw128(ks + st * NC * REG + sub * KS * 64, 16, 1024);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          const int c = kk / 4, wo = (kk % 4) * 16;
          wgmma_s<KS>(s, dq + (c * REG + wo) / 8, dk + (c * REG + wo) / 8);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(s);
        // scale and cap into base 2, then mask, but only where the keys
        // straddle a diagonal, the window's edge or the split's end for some
        // row of this warpgroup
        const bool interior = kb + KS <= w.hi && kb + KS - 1 <= qp_lo &&
                              (a.window <= 0 || kb > qp_hi - a.window);
        float mx_a = NEG_INF, mx_b = NEG_INF;
        const int k0 = kb + 2 * tig;
        if (a.softcap > 0.f) {
          if (interior)
            scale_mask<KS, true, false>(s, mx_a, mx_b, k0, lo_a, hi_a, lo_b, hi_b, cap_in, cap2);
          else
            scale_mask<KS, true, true>(s, mx_a, mx_b, k0, lo_a, hi_a, lo_b, hi_b, cap_in, cap2);
        } else {
          if (interior)
            scale_mask<KS, false, false>(s, mx_a, mx_b, k0, lo_a, hi_a, lo_b, hi_b, scale2, 0.f);
          else
            scale_mask<KS, false, true>(s, mx_a, mx_b, k0, lo_a, hi_a, lo_b, hi_b, scale2, 0.f);
        }
#pragma unroll
        for (int sh = 1; sh <= 2; sh <<= 1) {
          mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, sh));
          mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, sh));
        }
        const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
        float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
        for (int j = 0; j < KS / 8; ++j) {
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
        // contiguous), its regions of 64 columns REG apart, 16 keys a step
        uint32_t pa[KS / 16][4];
#pragma unroll
        for (int k2 = 0; k2 < KS / 16; ++k2) {
          pa[k2][0] = pack_bf16(s[8 * k2], s[8 * k2 + 1]);
          pa[k2][1] = pack_bf16(s[8 * k2 + 2], s[8 * k2 + 3]);
          pa[k2][2] = pack_bf16(s[8 * k2 + 4], s[8 * k2 + 5]);
          pa[k2][3] = pack_bf16(s[8 * k2 + 6], s[8 * k2 + 7]);
        }
        const uint64_t dv = hop::desc_sw128(vs + st * NC * REG, REG * 2, 1024);
        hop::wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < KS / 16; ++k2)
          wgmma_o<D>(o, pa[k2], dv + (sub * KS / 16 + k2) * 16 * 64 / 8);
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(o);
#pragma unroll
        for (int k2 = 0; k2 < KS / 16; ++k2) hop::fence_regs(pa[k2]);
      }
    };
    block_loop<STAGES, true>(nblk, offsets, copy, compute);

    if (live) {
      const bool live_a = ra < m_eff, live_b = rb < m_eff;
      if (p.n_live == 1) {
        const float inv_a = 1.f / fmaxf(l_a, 1e-37f), inv_b = 1.f / fmaxf(l_b, 1e-37f);
        uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
        const long long base_a = vec_offset(a, p.row0, h, ra, D);
        const long long base_b = vec_offset(a, p.row0, h, rb, D);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int x = j * 8 + 2 * tig;
          if (live_a) o32[(base_a + x) / 2] = pack_bf16(o[4 * j] * inv_a, o[4 * j + 1] * inv_a);
          if (live_b)
            o32[(base_b + x) / 2] = pack_bf16(o[4 * j + 2] * inv_b, o[4 * j + 3] * inv_b);
        }
      } else {
        // the partial, its maximum back in natural-log units
        const long long pa_ = part_slot(a, w.slot0, ra, h), pb_ = part_slot(a, w.slot0, rb, h);
#pragma unroll
        for (int j = 0; j < D / 8; ++j) {
          const int x = j * 8 + 2 * tig;
          if (live_a)
            *reinterpret_cast<float2*>(a.o_part + pa_ * D + x) = make_float2(o[4 * j], o[4 * j + 1]);
          if (live_b)
            *reinterpret_cast<float2*>(a.o_part + pb_ * D + x) =
                make_float2(o[4 * j + 2], o[4 * j + 3]);
        }
        if (tig == 0) {
          if (live_a)
            *reinterpret_cast<float2*>(a.ml_part + 2 * pa_) = make_float2(m_a / LOG2E, l_a);
          if (live_b)
            *reinterpret_cast<float2*>(a.ml_part + 2 * pb_) = make_float2(m_b / LOG2E, l_b);
        }
      }
    }
    __syncthreads();  // the next item reuses shared memory
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// CTAs of ``kernel`` the card holds at once: the persistent grid
template <typename Kernel>
int resident_ctas(Kernel kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem) !=
          cudaSuccess)
    return 0;
  return sms * per_sm;
}

// a persistent producer: as many CTAs as the card holds at once, at most one
// per item; ``opted_in`` and ``resident`` are the caller's, once per kernel
template <typename T, typename Kernel>
cudaError_t launch_persistent(Kernel kernel, int threads, size_t smem, bool& opted_in,
                              int& resident, int max_items, const void* q, const void* k_pages,
                              const void* v_pages, void* out, const Args& a,
                              cudaStream_t stream) {
  const cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  if (resident == 0) resident = resident_ctas(kernel, threads, smem);
  if (resident == 0) return cudaErrorInvalidConfiguration;
  kernel<<<resident < max_items ? resident : max_items, threads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_pages), static_cast<const T*>(v_pages),
      static_cast<T*>(out), a);
  return cudaGetLastError();
}

// fp32: one producer on the CUDA cores; bf16: the light items, then the
// others on wgmma (d >= 64) or mma.sync (d <= 32)
template <typename T, int D>
cudaError_t launch_producers(const void* q, const void* k_pages, const void* v_pages,
                             void* out, const Args& a, int max_items, cudaStream_t stream) {
  if constexpr (sizeof(T) == 4) {
    static bool opted_in = false;
    static int resident = 0;
    return launch_persistent<float>(mixed_paged_attention_f32_kernel<D>, NT, smem_bytes<D>(),
                                    opted_in, resident, max_items, q, k_pages, v_pages, out, a,
                                    stream);
  } else {
    static bool light_in = false, heavy_in = false;
    static int light_res = 0, heavy_res = 0;
    const cudaError_t err = launch_persistent<__nv_bfloat16>(
        mixed_paged_attention_light_kernel<D>, LIGHT_NT, light_smem_bytes<D>(), light_in,
        light_res, max_items, q, k_pages, v_pages, out, a, stream);
    if (err != cudaSuccess) return err;
    if constexpr (D >= 64)
      return launch_persistent<__nv_bfloat16>(mixed_paged_attention_wgmma_kernel<D>, WG_NT,
                                              wg_smem_bytes<D>(), heavy_in, heavy_res,
                                              max_items, q, k_pages, v_pages, out, a, stream);
    else
      return launch_persistent<__nv_bfloat16>(mixed_paged_attention_mma_kernel<D>, MMA_NT,
                                              mma_smem_bytes<D>(), heavy_in, heavy_res,
                                              max_items, q, k_pages, v_pages, out, a, stream);
  }
}

// plan, producer, and (with splits) combine, in stream order
template <typename T>
cudaError_t launch_all(int head_dim, const void* q, const void* k_pages, const void* v_pages,
                       void* out, Args a, int2* items, int* tile_slot, int* counts, int* next,
                       cudaStream_t stream) {
  constexpr bool BF16 = sizeof(T) == 2;
  a.pair = BF16;  // a bf16 CTA takes two tiles
  a.next = next;
  mixed_paged_attention_plan_kernel<<<1, 256, 0, stream>>>(a, items, tile_slot, counts,
                                                           BF16 ? LIGHT_M : 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  a.items = items;
  a.tile_slot = tile_slot;
  a.counts = counts;
  const int max_items = a.n_tiles * a.n_split * a.n_kv;
  switch (head_dim) {
    case 16: err = launch_producers<T, 16>(q, k_pages, v_pages, out, a, max_items, stream); break;
    case 32: err = launch_producers<T, 32>(q, k_pages, v_pages, out, a, max_items, stream); break;
    case 64: err = launch_producers<T, 64>(q, k_pages, v_pages, out, a, max_items, stream); break;
    case 128: err = launch_producers<T, 128>(q, k_pages, v_pages, out, a, max_items, stream); break;
    case 256: err = launch_producers<T, 256>(q, k_pages, v_pages, out, a, max_items, stream); break;
    default: return cudaErrorInvalidValue;
  }
  if (err != cudaSuccess || a.n_split == 1) return err;
  mixed_paged_attention_combine_kernel<T>
      <<<dim3(a.n_tiles, a.n_kv, M_MAX / COMBINE_V), COMBINE_NT, 0, stream>>>(
          a, static_cast<T*>(out), head_dim);
  return cudaGetLastError();
}

}  // namespace

// The scratch one launch needs, in 4-byte elements (scratch_layout): the
// caller allocates it, 16-byte aligned, and passes it with its size. at[0..3]
// receive the offsets of tile_slot, counts, o_part and ml_part (the work
// list starts at 0), so that a caller may read the plan back.
extern "C" long long mixed_paged_attention_scratch_layout(int n_tiles, int n_kv, int g,
                                                          int head_dim, int n_split, int sms,
                                                          long long* at) {
  const ScratchLayout l = scratch_layout(n_tiles, n_kv, g, head_dim, n_split, sms);
  if (at) {
    at[0] = l.tile_slot;
    at[1] = l.counts;
    at[2] = l.o_part;
    at[3] = l.ml_part;
  }
  return l.total;
}

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 and window <= 0 mean none.
// span_keys: keys per split of a one-row CTA (a multiple of 64); n_split:
// the most splits any CTA can have (ceil(nb * page / span_keys)); sms: the
// card's SMs; scratch: scratch_elems fp32-sized elements, at least what
// mixed_paged_attention_scratch_layout asks for, or the call is refused.
// Returns the cudaError_t of the launches (0 = success).
extern "C" int mixed_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, void* out, void* scratch,
    long long scratch_elems, const void* cu_q_lens, const void* kv_lens,
    const void* block_tables, const void* q_tiles, int n_tiles, int n_kv, int g, int head_dim,
    int page, int nb, int qt, int n_split, int span_keys, int sms, float scale, float softcap,
    int window, int dtype, void* stream) {
  if (qt * g > M_MAX || qt < 1 || n_tiles < 1 || n_split < 1 || n_split > MAX_SPLIT ||
      span_keys < BK || span_keys % BK || sms < 1 || !scratch ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return int(cudaErrorInvalidValue);
  const ScratchLayout l = scratch_layout(n_tiles, n_kv, g, head_dim, n_split, sms);
  if (scratch_elems < l.total || l.slot_cap > (1LL << 30)) return int(cudaErrorInvalidValue);
  float* base = static_cast<float*>(scratch);
  Args a{static_cast<const int*>(cu_q_lens), static_cast<const int*>(kv_lens),
         static_cast<const int*>(block_tables), static_cast<const int*>(q_tiles), nullptr,
         nullptr, nullptr, nullptr, nullptr, base + l.o_part, base + l.ml_part, n_tiles, n_kv,
         g, page, nb, qt, n_split, span_keys, n_tiles * n_split, sms, int(l.slot_cap), scale,
         softcap, window, 0};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int2* it = static_cast<int2*>(scratch);
  int* slot = reinterpret_cast<int*>(base + l.tile_slot);
  int* ct = reinterpret_cast<int*>(base + l.counts);
  int* next = ct + 3;
  a.heavy_span = next + 2;
  if (dtype == 0)
    return int(launch_all<float>(head_dim, q, k_pages, v_pages, out, a, it, slot, ct, next, s));
  if (dtype == 1)
    return int(launch_all<__nv_bfloat16>(head_dim, q, k_pages, v_pages, out, a, it, slot, ct,
                                         next, s));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* mixed_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
