// Mixed-batch ragged paged attention for Hopper (sm_90a).
//
// Replaces the TPU kernel `mixed_paged_attention` (body `_mixed_kernel`) of
// the JAX package's kernels/paged_attention.py. One call serves a whole
// packed serving step: every segment, a decode row or a prefill chunk, is a
// causal block of queries over its own paged KV prefix. Row j of segment s
// sits at position kv_len[s] - q_len[s] + j and attends the keys at or
// before it (and, with a window w, above position - w). GQA: query head
// h = kv * G + g reads KV head kv. Softcap before the mask, fp32 online
// softmax, NEG_INF -1e30, guard l >= 1e-37 -- the TPU kernel's semantics.
//
// What bounds it on an H100: the KV bytes it must read, about
//   sum_seg roundup(kv_len, page) * KV * d * 2 * sizeof(T),
// at 3.35 TB/s for decode-heavy steps, and for a long prefill chunk the
// 4 * sum q * kv * H * d FLOPs of its two products. This first design reads
// each segment's KV once per q-tile (a q-tile holds up to 64 / G rows of one
// segment, i.e. 64 query vectors), keeps the softmax state and the output
// accumulator on chip, and writes each output row once. bf16 inputs (the
// serving path) run the products on the tensor cores with mma.sync
// (FlashAttention-2's register layout, fp32 accumulation); fp32 inputs (the
// exactness checks) run them on the CUDA cores in fp32. Head dims 16 to 256;
// at 256 the bf16 tile reads Q's fragments from shared memory per k-step
// (O alone is 128 fp32 registers a thread). Not yet: wgmma and TMA, a
// pipelined gather, and a split over keys for long decode rows, whose
// single CTA per (row, KV head) streams the whole context alone.
//
// Layouts (all contiguous):
//   q, out        (N, KV, G, d)        T
//   k/v_pages     (P, page, KV, d)     T
//   cu_q_lens     (S + 1,)             int32
//   kv_lens       (S,)                 int32
//   block_tables  (S, nb)              int32 physical page ids
//   q_tiles       (n_tiles, 2)         int32 (segment, first packed row)
// Grid (n_tiles, KV). Keys are gathered one at a time through
// the table (page size 1 works), and keys at or past kv_len, or below the
// window of the tile's first row, are never loaded: dead table entries name a
// scratch page holding garbage (even NaN), so they are skipped, not masked.
// Rows of out that no tile covers (padding) are left as the caller made them.
#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int NT = 256;     // threads per CTA
constexpr int M_MAX = 64;   // query vectors per CTA (q-tile rows x G)
constexpr int BK = 64;      // keys per block
constexpr int PAD = 4;      // row padding of K and the scores: keeps 16-byte
                            // alignment and spreads a warp's rows over the banks

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores
// ---------------------------------------------------------------------------

// four floats from 16-byte-aligned global memory
__device__ __forceinline__ float4 load4(const float* src) {
  return __ldg(reinterpret_cast<const float4*>(src));
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (M_MAX * D + BK * (D + PAD) + BK * D + M_MAX * (BK + PAD) + 3 * M_MAX) +
         sizeof(long long) * BK;
}

// one CTA per SM at the least: ptxas may use up to 255 registers rather
// than spill to fit more
template <int D>
__global__ void __launch_bounds__(NT, 1) mixed_paged_attention_f32_kernel(
    const float* __restrict__ q, const float* __restrict__ k_pages,
    const float* __restrict__ v_pages, float* __restrict__ out,
    const int* __restrict__ cu_q_lens, const int* __restrict__ kv_lens,
    const int* __restrict__ block_tables, const int* __restrict__ q_tiles, int n_kv, int g,
    int page, int nb, int qt, float scale, float softcap, int window) {
  constexpr int SRG = NT / BK;      // row groups in the score product
  constexpr int SRPT = M_MAX / SRG; // rows per thread there
  constexpr int RG = NT / D;        // row groups in the value product
  constexpr int RPT = M_MAX / RG;   // rows per thread there
  constexpr int KS = D + PAD, SS = BK + PAD;  // row strides of ks and ss
  static_assert(D % 4 == 0 && NT % D == 0 && NT % BK == 0 && BK == 64, "tile shape");

  extern __shared__ __align__(16) float smem[];
  float* qs = smem;                  // [M_MAX][D]
  float* ks = qs + M_MAX * D;        // [BK][KS]
  float* vs = ks + BK * KS;          // [BK][D]
  float* ss = vs + BK * D;           // [M_MAX][SS] scores, then probabilities
  float* m_s = ss + M_MAX * SS;
  float* l_s = m_s + M_MAX;
  float* a_s = l_s + M_MAX;
  long long* koff = reinterpret_cast<long long*>(a_s + M_MAX);  // [BK] element offsets

  const int tid = threadIdx.x;
  const int h = blockIdx.y;
  const int seg = q_tiles[2 * blockIdx.x];
  const int row0 = q_tiles[2 * blockIdx.x + 1];
  const int seg_lo = cu_q_lens[seg];
  const int seg_hi = cu_q_lens[seg + 1];
  const int kv_len = kv_lens[seg];
  const int nrow = min(qt, seg_hi - row0);
  const int m_eff = nrow * g;
  const int pos0 = kv_len - (seg_hi - seg_lo) + (row0 - seg_lo);  // first row's position
  const int k_hi = pos0 + nrow;  // one past the last row's position; <= kv_len
  const int k_lo = window > 0 ? max(0, pos0 - window + 1) : 0;
  const int* tab = block_tables + (long long)seg * nb;

  // the tile's queries: row r is query head g_i = r % g of packed row row0 + r / g
  for (int e = tid * 4; e < m_eff * D; e += NT * 4) {
    const int r = e / D, x = e % D;
    const long long src = (((long long)(row0 + r / g) * n_kv + h) * g + r % g) * D + x;
    *reinterpret_cast<float4*>(qs + r * D + x) = load4(q + src);
  }
  for (int r = tid; r < M_MAX; r += NT) {
    m_s[r] = NEG_INF;
    l_s[r] = 0.f;
  }
  const int dcol = tid % D, prg = tid / D;
  const int scol = tid % BK, srg = tid / BK;
  // live rows this thread owns in each product (rows r = group + groups * i
  // with r < m_eff); the loops stop there, so a decode tile of G rows does
  // G rows' work, not M_MAX's
  const int n_s = (m_eff - srg + SRG - 1) / SRG;
  const int n_o = (m_eff - prg + RG - 1) / RG;
  float acc[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) acc[i] = 0.f;
  __syncthreads();

  for (int kb = k_lo; kb < k_hi; kb += BK) {
    // 1. where each live key of the block lives in the pool (-1: not loaded)
    if (tid < BK) {
      const int kp = kb + tid;
      long long off = -1;
      if (kp < k_hi) {
        const long long pg = tab[kp / page];
        off = ((pg * page + kp % page) * n_kv + h) * D;
      }
      koff[tid] = off;
    }
    __syncthreads();
    // 2. gather K and V of the block into shared memory
    for (int e = tid * 4; e < BK * D; e += NT * 4) {
      const int c = e / D, x = e % D;
      const long long off = koff[c];
      float4 kt = make_float4(0.f, 0.f, 0.f, 0.f), vt = kt;
      if (off >= 0) {
        kt = load4(k_pages + off + x);
        vt = load4(v_pages + off + x);
      }
      *reinterpret_cast<float4*>(ks + c * KS + x) = kt;
      *reinterpret_cast<float4*>(vs + c * D + x) = vt;
    }
    __syncthreads();
    // 3. scores: thread owns key column scol for rows srg, srg + SRG, ...;
    //    four dims per shared-memory read
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
        const int qp = pos0 + r / g;
        const bool ok = kp < k_hi && kp <= qp && (window <= 0 || kp > qp - window);
        float s = sacc[i] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ss[r * SS + scol] = ok ? s : -INFINITY;
      }
    }
    __syncthreads();
    // 4. online softmax, one warp per row; masked keys get p = 0 exactly
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
    // 5. acc = alpha * acc + P V: thread owns output column dcol; four keys
    //    per shared-memory read of P
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (i >= n_o) break;
      acc[i] *= a_s[prg + RG * i];
    }
    if (n_o == RPT)
      pv_rows<RPT, D, SS, BK, true>(acc, ss, vs, dcol, prg, RG, n_o);
    else
      pv_rows<RPT, D, SS, BK, false>(acc, ss, vs, dcol, prg, RG, n_o);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (i >= n_o) break;
    const int r = prg + RG * i;
    const long long dst = (((long long)(row0 + r / g) * n_kv + h) * g + r % g) * D + dcol;
    out[dst] = acc[i] / fmaxf(l_s[r], 1e-37f);
  }
}

// ---------------------------------------------------------------------------
// bf16: the same tile on the tensor cores (mma.sync m16n8k16, fp32 accumulate)
// ---------------------------------------------------------------------------
//
// FlashAttention-2's register layout (attn::MmaRows): warp w < 4 owns the
// tile's query rows 16w..16w+15 (rows past m_eff idle). K and V are staged
// in shared memory as [key][d]. Warps 4..7 only help gather, which is all a
// decode tile does at length. At d = 256 the tile's queries are staged in
// shared memory too, and read per k-step, so that O's 128 accumulators a
// thread fit in registers without a spill.

constexpr int MMA_NT = 256;     // 8 warps gather; the first 4 compute
constexpr int MMA_WARPS_C = 4;  // compute warps: 4 x 16 rows = M_MAX
constexpr int MMA_PAD = 8;      // bf16 row padding of the staged Q, K and V

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * BK + (D > 128 ? M_MAX : 0)) * (D + MMA_PAD) +
         sizeof(long long) * BK;
}

template <int D>
__global__ void __launch_bounds__(MMA_NT, 1) mixed_paged_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ cu_q_lens, const int* __restrict__ kv_lens,
    const int* __restrict__ block_tables, const int* __restrict__ q_tiles, int n_kv, int g,
    int page, int nb, int qt, float scale, float softcap, int window) {
  constexpr int KSTR = D + MMA_PAD;  // staged row stride (bf16); rows stay 16-byte aligned
  using Rows = MmaRows<D, KSTR>;
  static_assert(BK == MMA_BK, "mma tile shape");

  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [BK][KSTR]
  __nv_bfloat16* vs = ks + BK * KSTR;                                 // [BK][KSTR]
  __nv_bfloat16* qs = vs + BK * KSTR;  // [M_MAX][KSTR] (d = 256 only)
  long long* koff = reinterpret_cast<long long*>(qs + (Rows::Q_SMEM ? M_MAX * KSTR : 0));

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4;
  const int h = blockIdx.y;
  const int seg = q_tiles[2 * blockIdx.x];
  const int row0 = q_tiles[2 * blockIdx.x + 1];
  const int seg_lo = cu_q_lens[seg];
  const int seg_hi = cu_q_lens[seg + 1];
  const int kv_len = kv_lens[seg];
  const int nrow = min(qt, seg_hi - row0);
  const int m_eff = nrow * g;
  const int pos0 = kv_len - (seg_hi - seg_lo) + (row0 - seg_lo);
  const int k_hi = pos0 + nrow;
  const int k_lo = window > 0 ? max(0, pos0 - window + 1) : 0;
  const int* tab = block_tables + (long long)seg * nb;
  const bool active = warp < MMA_WARPS_C && warp * 16 < m_eff;  // owns a live row

  // this thread's two tile rows (the mma's rows gid and gid + 8), their query
  // positions and offsets; rows at or past m_eff are zero and never written
  const int ra = warp * 16 + gid, rb = ra + 8;
  const int qpa = pos0 + ra / g, qpb = pos0 + rb / g;
  auto offset = [&](int r) {  // query vector r's first element in q and out
    return (((long long)(row0 + r / g) * n_kv + h) * g + r % g) * D;
  };
  Rows rows;
  rows.init();
  if constexpr (Rows::Q_SMEM) {
    // query vector r is head r % g of packed row row0 + r / g; rows past
    // m_eff are zero
    for (int e = tid * 8; e < M_MAX * D; e += MMA_NT * 8) {
      const int r = e / D, x = e % D;
      uint4 t = make_uint4(0u, 0u, 0u, 0u);
      if (r < m_eff)
        t = __ldg(reinterpret_cast<const uint4*>(
            q + offset(r) + x));
      *reinterpret_cast<uint4*>(qs + r * KSTR + x) = t;
    }
    rows.q_from_smem(qs + warp * 16 * KSTR, KSTR);
  } else {
    rows.load_q(q, offset(ra), offset(rb), ra < m_eff, rb < m_eff);
  }
  // the keys each row reads: at or before its position, inside its window
  const int hi_a = min(qpa + 1, k_hi), hi_b = min(qpb + 1, k_hi);
  const int lo_a = window > 0 ? qpa - window + 1 : 0, lo_b = window > 0 ? qpb - window + 1 : 0;

  for (int kb = k_lo; kb < k_hi; kb += BK) {
    if (tid < BK) {
      const int kp = kb + tid;
      long long off = -1;
      if (kp < k_hi) {
        const long long pg = tab[kp / page];
        off = ((pg * page + kp % page) * n_kv + h) * D;
      }
      koff[tid] = off;
    }
    __syncthreads();
    // stage K and V as [key][d]; keys not loaded are zero
    for (int e = tid * 8; e < BK * D; e += MMA_NT * 8) {
      const int c = e / D, x = e % D;
      const long long off = koff[c];
      uint4 kr = make_uint4(0u, 0u, 0u, 0u), vr = kr;
      if (off >= 0) {
        kr = __ldg(reinterpret_cast<const uint4*>(k_pages + off + x));
        vr = __ldg(reinterpret_cast<const uint4*>(v_pages + off + x));
      }
      *reinterpret_cast<uint4*>(ks + c * KSTR + x) = kr;
      *reinterpret_cast<uint4*>(vs + c * KSTR + x) = vr;
    }
    __syncthreads();
    if (active) rows.block(ks, vs, kb, lo_a, hi_a, lo_b, hi_b, scale, softcap);
    __syncthreads();
  }

  if (active) rows.store(out, offset(ra), offset(rb), ra < m_eff, rb < m_eff);
}

template <int D>
cudaError_t launch_mma(const void* q, const void* k_pages, const void* v_pages, void* out,
                       const void* cu_q_lens, const void* kv_lens, const void* block_tables,
                       const void* q_tiles, int n_tiles, int n_kv, int g, int page, int nb,
                       int qt, float scale, float softcap, int window, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes<D>();
  auto kernel = mixed_paged_attention_mma_kernel<D>;
  static bool opted_in = false;
  const cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_tiles, n_kv), MMA_NT, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k_pages),
      static_cast<const __nv_bfloat16*>(v_pages), static_cast<__nv_bfloat16*>(out),
      static_cast<const int*>(cu_q_lens), static_cast<const int*>(kv_lens),
      static_cast<const int*>(block_tables), static_cast<const int*>(q_tiles), n_kv, g, page, nb,
      qt, scale, softcap, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_f32(const void* q, const void* k_pages, const void* v_pages, void* out,
                       const void* cu_q_lens, const void* kv_lens, const void* block_tables,
                       const void* q_tiles, int n_tiles, int n_kv, int g, int page, int nb,
                       int qt, float scale, float softcap, int window, cudaStream_t stream) {
  const size_t smem = smem_bytes<D>();
  auto kernel = mixed_paged_attention_f32_kernel<D>;
  static bool opted_in = false;
  const cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  kernel<<<dim3(n_tiles, n_kv), NT, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pages),
      static_cast<const float*>(v_pages), static_cast<float*>(out),
      static_cast<const int*>(cu_q_lens), static_cast<const int*>(kv_lens),
      static_cast<const int*>(block_tables), static_cast<const int*>(q_tiles), n_kv, g, page, nb,
      qt, scale, softcap, window);
  return cudaGetLastError();
}

// fp32 runs on the CUDA cores, bf16 on the tensor cores
template <typename T, int D>
cudaError_t launch_typed(const void* q, const void* k_pages, const void* v_pages, void* out,
                         const void* cu_q_lens, const void* kv_lens, const void* block_tables,
                         const void* q_tiles, int n_tiles, int n_kv, int g, int page, int nb,
                         int qt, float scale, float softcap, int window, cudaStream_t stream) {
  if constexpr (sizeof(T) == 2)
    return launch_mma<D>(q, k_pages, v_pages, out, cu_q_lens, kv_lens, block_tables, q_tiles,
                         n_tiles, n_kv, g, page, nb, qt, scale, softcap, window, stream);
  else
    return launch_f32<D>(q, k_pages, v_pages, out, cu_q_lens, kv_lens, block_tables, q_tiles,
                         n_tiles, n_kv, g, page, nb, qt, scale, softcap, window, stream);
}

template <typename T>
cudaError_t launch_dim(int head_dim, const void* q, const void* k_pages, const void* v_pages,
                       void* out, const void* cu_q_lens, const void* kv_lens,
                       const void* block_tables, const void* q_tiles, int n_tiles, int n_kv,
                       int g, int page, int nb, int qt, float scale, float softcap, int window,
                       cudaStream_t stream) {
#define MPA_CASE(D)                                                                          \
  case D:                                                                                    \
    return launch_typed<T, D>(q, k_pages, v_pages, out, cu_q_lens, kv_lens, block_tables,    \
                              q_tiles, n_tiles, n_kv, g, page, nb, qt, scale, softcap, window, \
                              stream);
  switch (head_dim) {
    MPA_CASE(16)
    MPA_CASE(32)
    MPA_CASE(64)
    MPA_CASE(128)
    MPA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef MPA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. softcap <= 0 and window <= 0 mean none.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int mixed_paged_attention_launch(
    const void* q, const void* k_pages, const void* v_pages, void* out, const void* cu_q_lens,
    const void* kv_lens, const void* block_tables, const void* q_tiles, int n_tiles, int n_kv,
    int g, int head_dim, int page, int nb, int qt, float scale, float softcap, int window,
    int dtype, void* stream) {
  if (qt * g > M_MAX || qt < 1 || n_tiles < 1) return int(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return int(launch_dim<float>(head_dim, q, k_pages, v_pages, out, cu_q_lens, kv_lens,
                                 block_tables, q_tiles, n_tiles, n_kv, g, page, nb, qt, scale,
                                 softcap, window, s));
  if (dtype == 1)
    return int(launch_dim<__nv_bfloat16>(head_dim, q, k_pages, v_pages, out, cu_q_lens, kv_lens,
                                         block_tables, q_tiles, n_tiles, n_kv, g, page, nb, qt,
                                         scale, softcap, window, s));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* mixed_paged_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
