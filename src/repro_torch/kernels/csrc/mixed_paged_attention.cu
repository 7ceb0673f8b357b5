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
// exactness checks) run them on the CUDA cores in fp32. Not yet: wgmma and
// TMA, a pipelined gather, and a split over keys for long decode rows, whose
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

template <int D>
__global__ void __launch_bounds__(NT) mixed_paged_attention_f32_kernel(
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
// FlashAttention-2's register layout: warp w < 4 owns the tile's query rows
// 16w..16w+15 (rows past m_eff idle). Its Q fragments stay in registers for
// the whole key loop; S = Q K^T lands in mma accumulators, the online softmax
// runs on them in fp32 (each row's 64 scores spread over the 4 lanes of a
// quad), and the probabilities, rounded to bf16, are reused in place as the A
// operand of P V. K and V are staged in shared memory as [key][d]: a K
// fragment is one 32-bit read, a V fragment one ldmatrix.trans. Warps 4..7
// only help gather, which is all a decode tile does at length.

constexpr int MMA_NT = 256;     // 8 warps gather; the first 4 compute
constexpr int MMA_WARPS_C = 4;  // compute warps: 4 x 16 rows = M_MAX
constexpr int MMA_PAD = 8;      // bf16 row padding of the staged K and V

template <int D>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * 2 * BK * (D + MMA_PAD) + sizeof(long long) * BK;
}

template <int D>
__global__ void __launch_bounds__(MMA_NT) mixed_paged_attention_mma_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k_pages,
    const __nv_bfloat16* __restrict__ v_pages, __nv_bfloat16* __restrict__ out,
    const int* __restrict__ cu_q_lens, const int* __restrict__ kv_lens,
    const int* __restrict__ block_tables, const int* __restrict__ q_tiles, int n_kv, int g,
    int page, int nb, int qt, float scale, float softcap, int window) {
  constexpr int KSTR = D + MMA_PAD;  // staged K and V row stride (bf16); rows stay 16-byte aligned
  constexpr int KSTEPS = D / 16;      // k-steps of S = Q K^T
  constexpr int NT_S = BK / 8;        // 8-key tiles of S
  constexpr int NT_O = D / 8;         // 8-dim tiles of O
  static_assert(D % 16 == 0 && BK % 16 == 0, "mma tile shape");

  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [BK][KSTR]
  __nv_bfloat16* vs = ks + BK * KSTR;                                 // [BK][KSTR]
  long long* koff = reinterpret_cast<long long*>(vs + BK * KSTR);    // [BK]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;  // mma groupID / thread-in-group
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

  // this thread's two tile rows (the mma's rows gid and gid + 8) and their
  // query positions; rows at or past m_eff compute garbage-free zeros and are
  // never written
  const int ra = warp * 16 + gid, rb = ra + 8;
  const int qpa = pos0 + ra / g, qpb = pos0 + rb / g;
  uint32_t qa[KSTEPS][4];
  {
    const long long base_a = (((long long)(row0 + ra / g) * n_kv + h) * g + ra % g) * D;
    const long long base_b = (((long long)(row0 + rb / g) * n_kv + h) * g + rb % g) * D;
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
      const int x = kk * 16 + 2 * tig;
      qa[kk][0] = ra < m_eff ? q32[(base_a + x) / 2] : 0u;
      qa[kk][1] = rb < m_eff ? q32[(base_b + x) / 2] : 0u;
      qa[kk][2] = ra < m_eff ? q32[(base_a + x + 8) / 2] : 0u;
      qa[kk][3] = rb < m_eff ? q32[(base_b + x + 8) / 2] : 0u;
    }
  }
  float acc[NT_O][4];
#pragma unroll
  for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m_a = NEG_INF, m_b = NEG_INF, l_a = 0.f, l_b = 0.f;

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
          const int qp = e < 2 ? qpa : qpb;
          const bool ok = kp < k_hi && kp <= qp && (window <= 0 || kp > qp - window);
          float v = s[j][e] * scale;
          if (softcap > 0.f) v = softcap * tanhf(v / softcap);
          s[j][e] = ok ? v : -INFINITY;
          if (ok) {
            if (e < 2) mx_a = fmaxf(mx_a, v);
            else mx_b = fmaxf(mx_b, v);
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
          const float v = s[j][e];
          const float pe = v == -INFINITY ? 0.f : expf(v - (e < 2 ? mn_a : mn_b));
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
    __syncthreads();
  }

  if (!active) return;
  const float inv_a = 1.f / fmaxf(l_a, 1e-37f), inv_b = 1.f / fmaxf(l_b, 1e-37f);
  uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
  const long long base_a = (((long long)(row0 + ra / g) * n_kv + h) * g + ra % g) * D;
  const long long base_b = (((long long)(row0 + rb / g) * n_kv + h) * g + rb % g) * D;
#pragma unroll
  for (int n = 0; n < NT_O; ++n) {
    const int x = n * 8 + 2 * tig;
    if (ra < m_eff) o32[(base_a + x) / 2] = pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
    if (rb < m_eff) o32[(base_b + x) / 2] = pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
  }
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
