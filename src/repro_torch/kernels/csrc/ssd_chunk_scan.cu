// Mamba2 SSD (state-space duality) chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_chunk_scan` (kernels/ssd.py:81, body
// `_ssd_kernel` :35; model-layout wrapper `ops.ssd`, kernels/ops.py:106) of
// the JAX package. For each (batch, head) it walks the sequence in chunks of
// L = 64 tokens, carrying the state h (hd x ds, fp32) from chunk to chunk:
//
//   cum_i = sum_{t<=i} dt_t A                     (within the chunk)
//   y_i   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j
//           + exp(cum_i) C_i . h                  (h at the chunk's start)
//   h'    = exp(cum_L) h + sum_j exp(cum_L - cum_j) dt_j x_j^T B_j
//
// and returns y and the final state hT. The TPU kernel walks chunks as the
// sequential axis of its grid with h in VMEM scratch; here one CTA loops over
// the chunks itself with h in shared memory.
//
// The decay exp(cum_i - cum_j) is evaluated only for j <= i. Above the
// diagonal the exponent is positive and, with Mamba2-2.7B's own decay rates
// (A down to -80, dt up to 0.1), overflows to inf; the TPU kernel masks it
// with `where`, and a product with it would give NaN.
//
// What bounds it on an H100: the function reads x, B, C, dt and h0 once and
// writes y and hT once; at a 512-token bf16 segment of Mamba2-2.7B that is
// 16 MB (4.8 us at 3.35 TB/s) against about 1.5e9 operations (1.5 us at the
// bf16 tensor rate), so bytes bound it. What holds the kernel back is the
// sequence: each (batch, head) walks its chunks one after another.
// The design:
//   * one CTA per (32 columns of hd, head, batch): Mamba2-2.7B's 80 heads of
//     hd 64 give 160 CTAs for one sequence, two resident per SM; each loops
//     over the chunks with its slice of the state on chip;
//   * per chunk, B, C and the CTA's x columns are staged in shared memory
//     through the model's strides (x, B and C are column slices of the conv
//     output: no copies), and warp 0 scans dt A into cum;
//   * bf16 inputs (serving): the chunk's four products -- C B^T, W x, C h and
//     the state update (x w)^T B -- run on the tensor cores (mma.sync), with
//     W, h and x w split into two bf16 parts so the sums stay near fp32; the
//     state lives in accumulator registers from chunk to chunk;
//   * fp32 inputs (the exactness checks): the same steps on the CUDA cores,
//     by 4 x 4 register tiles over operands staged as fp32;
//   * a ragged last chunk is masked (dt = 0, x = B = C = 0 past the end),
//     which leaves hT exact, and y is written only for live tokens.
// Not yet: a pipelined load of the next chunk, sharing C B^T between the
// heads of one group, chunks in parallel (a state-passing pass between two
// chunk-parallel kernels) for long prompts.
//
// Layouts: x (B, S, nh, hd), B and C (B, S, G, ds) with any element strides
// of batch, token and head/group (last axis contiguous); dt (B, S, nh) fp32
// with any strides; A (nh,) fp32; h0 and hT (B, nh, hd, ds) fp32 contiguous
// (h0 may be null: zeros; hT may alias h0: each CTA reads its slice of h0
// before it writes the same slice of hT); y (B, S, nh, hd) contiguous in x's
// dtype.
#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int NT = 256;      // threads per CTA
constexpr int L = 64;        // tokens per chunk
constexpr int HS = 32;       // columns of hd per CTA
constexpr int DS_MAX = 128;  // largest state width
constexpr int XP = HS + 1;   // padded row of the staged x
constexpr int WP = L + 1;    // padded row of W

size_t smem_bytes(int ds) {
  const int dp = ds + 1;
  return sizeof(float) * (2 * L * dp + HS * dp + L * XP + L * WP + 3 * L);
}

// Warp 0 of a CTA: dt of the chunk's tokens [t0, t0 + n) (0 past them) into
// dts and the inclusive cumulative log-decay sum dt A into cum, two tokens
// a lane, by a shuffle scan.
__device__ __forceinline__ void scan_chunk(const float* dtb, long long dt_ss, int t0, int n,
                                           float a_h, int lane, float* cum, float* dts) {
  const int t = 2 * lane;
  const float dt0 = t < n ? dtb[(long long)(t0 + t) * dt_ss] : 0.f;
  const float dt1 = t + 1 < n ? dtb[(long long)(t0 + t + 1) * dt_ss] : 0.f;
  const float s0 = dt0 * a_h, s1 = s0 + dt1 * a_h;
  float incl = s1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  cum[t] = excl + s0;
  cum[t + 1] = incl;
  dts[t] = dt0;
  dts[t + 1] = dt1;
}

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NT, 2) ssd_chunk_scan_f32_kernel(
    const float* __restrict__ x, const float* __restrict__ dt, const float* __restrict__ A,
    const float* __restrict__ bm, const float* __restrict__ cm, const float* h0,
    float* __restrict__ y, float* hT, int seq, int nh, int hd, int rep, int ds, long long x_sb,
    long long x_ss, long long x_sh, long long bc_sb, long long bc_ss, long long bc_sg,
    long long dt_sb, long long dt_ss, long long dt_sh) {
  extern __shared__ __align__(16) float smem[];
  const int dp = ds + 1;
  float* bs = smem;          // [L][dp]  B of the chunk
  float* cs = bs + L * dp;   // [L][dp]  C of the chunk
  float* hs = cs + L * dp;   // [HS][dp] the state's rows d0 .. d0 + HS
  float* xs = hs + HS * dp;  // [L][XP]  x's columns d0 .. d0 + HS
  float* ws = xs + L * XP;   // [L][WP]  intra-chunk weights
  float* cum = ws + L * WP;  // [L]
  float* dts = cum + L;      // [L]
  float* wj = dts + L;       // [L]      exp(cum_L - cum_j) dt_j

  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * HS, h = blockIdx.y, b = blockIdx.z;
  const int nd = min(HS, hd - d0);  // live columns of this CTA
  const float a_h = A[h];
  const float* xb = x + b * x_sb + h * x_sh + d0;
  const float* bb = bm + b * bc_sb + (h / rep) * bc_sg;
  const float* cb = cm + b * bc_sb + (h / rep) * bc_sg;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const long long state = ((long long)b * nh + h) * hd + d0;  // first state row

  for (int e = tid; e < HS * ds; e += NT) {
    const int r = e / ds, k = e % ds;
    hs[r * dp + k] = (h0 != nullptr && r < nd) ? h0[(state + r) * ds + k] : 0.f;
  }

  for (int t0 = 0; t0 < seq; t0 += L) {
    const int n = min(L, seq - t0);  // live tokens of the chunk
    __syncthreads();  // the previous chunk is done with the staged operands
    // 1. stage the chunk; nothing past the sequence is read
    for (int e = tid; e < L * ds; e += NT) {
      const int t = e / ds, k = e % ds;
      const bool live = t < n;
      const long long off = (long long)(t0 + t) * bc_ss + k;
      bs[t * dp + k] = live ? bb[off] : 0.f;
      cs[t * dp + k] = live ? cb[off] : 0.f;
    }
    for (int e = tid; e < L * HS; e += NT) {
      const int t = e / HS, d = e % HS;
      xs[t * XP + d] = (t < n && d < nd) ? xb[(long long)(t0 + t) * x_ss + d] : 0.f;
    }
    if (tid < 32) scan_chunk(dtb, dt_ss, t0, n, a_h, tid, cum, dts);
    __syncthreads();
    const float total = cum[L - 1];
    if (tid < L) wj[tid] = expf(total - cum[tid]) * dts[tid];

    // 2. W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0;
    //    rows ti + 16 r, columns tj + 16 c
    {
      const int ti = tid / 16, tj = tid % 16;
      float acc[4][4] = {};
      for (int k = 0; k < ds; ++k) {
        float cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = cs[(ti + 16 * r) * dp + k];
#pragma unroll
        for (int c = 0; c < 4; ++c) bv[c] = bs[(tj + 16 * c) * dp + k];
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(cv[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int i = ti + 16 * r, j = tj + 16 * c;
          ws[i * WP + j] = j <= i ? acc[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
        }
    }
    __syncthreads();

    // 3. y_i = W_i . x + exp(cum_i) C_i . h: column d, rows i0 + 8 r
    {
      const int d = tid % 32, i0 = tid / 32;
      float intra[8] = {}, inter[8] = {};
      for (int j = 0; j < L; ++j) {
        const float xv = xs[j * XP + d];
#pragma unroll
        for (int r = 0; r < 8; ++r) intra[r] = fmaf(ws[(i0 + 8 * r) * WP + j], xv, intra[r]);
      }
      for (int k = 0; k < ds; ++k) {
        const float hv = hs[d * dp + k];
#pragma unroll
        for (int r = 0; r < 8; ++r) inter[r] = fmaf(cs[(i0 + 8 * r) * dp + k], hv, inter[r]);
      }
      if (d < nd) {
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          const int i = i0 + 8 * r;
          if (i < n)
            y[(((long long)b * seq + t0 + i) * nh + h) * hd + d0 + d] =
                intra[r] + expf(cum[i]) * inter[r];
        }
      }
    }
    __syncthreads();  // step 4 overwrites the state step 3 read

    // 4. h' = exp(cum_L) h + sum_j wj_j x_j^T B_j: rows r0 + 8 r, columns kc + 32 c
    {
      const float decay = expf(total);
      const int kc = tid % 32, r0 = tid / 32;
      float acc[4][4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = kc + 32 * c;
          acc[r][c] = k < ds ? hs[(r0 + 8 * r) * dp + k] * decay : 0.f;
        }
      for (int j = 0; j < L; ++j) {
        const float w = wj[j];
        float xw[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) xw[r] = xs[j * XP + r0 + 8 * r] * w;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = kc + 32 * c;
          bv[c] = k < ds ? bs[j * dp + k] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xw[r], bv[c], acc[r][c]);
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = kc + 32 * c;
          if (k < ds) hs[(r0 + 8 * r) * dp + k] = acc[r][c];
        }
    }
  }
  __syncthreads();
  for (int e = tid; e < nd * ds; e += NT) {
    const int r = e / ds, k = e % ds;
    hT[(state + r) * ds + k] = hs[r * dp + k];
  }
}

// ---------------------------------------------------------------------------
// bf16: the four products of a chunk on the tensor cores
// ---------------------------------------------------------------------------
//
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), 8 warps. x, B and C are
// exact in bf16; W, the state h and x_j w_j are not, so each is split into
// a bf16 high part and the bf16 rounding of the rest and enters two
// products: the sums keep about 16 bits more than one bf16 rounding would.
// The CTA's slice of the state (32 x ds) lives in the G4 accumulators of
// its threads for the whole scan; a bf16 hi/lo copy in shared memory feeds
// the next chunk's C h. Every operand is staged with its reduction axis
// contiguous, so an A fragment is one 32-bit read; where the reduction runs
// over tokens (W x, the state update) the B or A fragment pairs two 16-bit
// reads. Rows are padded by 8 bf16 so the fragment reads hit 32 banks.

constexpr int DSP = 128;     // staged state dims (a multiple of 16, >= ds)
constexpr int CS = DSP + 8;  // row of the staged B, C and the state copy [.][k]
constexpr int XS = HS + 8;   // row of the staged x and x w [t][d]
constexpr int WS = L + 8;    // row of W [i][j]

constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * L * CS + 3 * L * XS + 2 * L * WS + 2 * HS * CS) +
         sizeof(float) * 2 * L;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 along a column (p[0] and p[stride]) as one fragment register
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p, int stride) {
  const uint32_t lo = *reinterpret_cast<const unsigned short*>(p);
  const uint32_t hi = *reinterpret_cast<const unsigned short*>(p + stride);
  return lo | (hi << 16);
}

// v = hi + lo with hi = bf16(v) and lo = bf16(v - hi), written as bf16 pairs
__device__ __forceinline__ void store_split(__nv_bfloat16* hi, __nv_bfloat16* lo, float v0,
                                            float v1) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  *reinterpret_cast<__nv_bfloat162*>(hi) = h;
  *reinterpret_cast<__nv_bfloat162*>(lo) =
      __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
}

__global__ void __launch_bounds__(NT, 2) ssd_chunk_scan_mma_kernel(
    const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const __nv_bfloat16* __restrict__ bm,
    const __nv_bfloat16* __restrict__ cm, const float* h0, __nv_bfloat16* __restrict__ y,
    float* hT, int seq, int nh, int hd, int rep, int ds, long long x_sb, long long x_ss,
    long long x_sh, long long bc_sb, long long bc_ss, long long bc_sg, long long dt_sb,
    long long dt_ss, long long dt_sh) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [L][CS]  C
  __nv_bfloat16* bs = cs + L * CS;                                  // [L][CS]  B
  __nv_bfloat16* xs = bs + L * CS;                                  // [L][XS]  x
  __nv_bfloat16* xw_hi = xs + L * XS;                               // [L][XS]  x_j w_j
  __nv_bfloat16* xw_lo = xw_hi + L * XS;
  __nv_bfloat16* w_hi = xw_lo + L * XS;                             // [L][WS]  W
  __nv_bfloat16* w_lo = w_hi + L * WS;
  __nv_bfloat16* h_hi = w_lo + L * WS;                              // [HS][CS] state
  __nv_bfloat16* h_lo = h_hi + HS * CS;
  float* cum = reinterpret_cast<float*>(h_lo + HS * CS);            // [L]
  float* dts = cum + L;                                             // [L]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;  // mma groupID / thread-in-group
  const int d0 = blockIdx.x * HS, h = blockIdx.y, b = blockIdx.z;
  const int nd = min(HS, hd - d0);
  const int ksteps = (ds + 15) / 16;  // 16-wide steps over the state dims
  const float a_h = A[h];
  const __nv_bfloat16* xb = x + b * x_sb + h * x_sh + d0;
  const __nv_bfloat16* bb = bm + b * bc_sb + (h / rep) * bc_sg;
  const __nv_bfloat16* cb = cm + b * bc_sb + (h / rep) * bc_sg;
  const float* dtb = dt + b * dt_sb + h * dt_sh;
  const long long state = ((long long)b * nh + h) * hd + d0;

  // G4's tile: state rows hr + {gid, gid + 8}, columns hc + 8 n + 2 tig (+1)
  const int hr = 16 * (warp & 1), hc = 32 * (warp >> 1);
  float hacc[4][4];
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = hr + gid + 8 * (e >> 1), k = hc + 8 * n + 2 * tig + (e & 1);
      hacc[n][e] = (h0 != nullptr && d < nd && k < ds) ? h0[(state + d) * ds + k] : 0.f;
    }
  auto store_state = [&]() {
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; e += 2) {
        const int d = hr + gid + 8 * (e >> 1), k = hc + 8 * n + 2 * tig;
        store_split(h_hi + d * CS + k, h_lo + d * CS + k, hacc[n][e], hacc[n][e + 1]);
      }
  };
  store_state();

  for (int t0 = 0; t0 < seq; t0 += L) {
    const int n = min(L, seq - t0);
    __syncthreads();  // the previous chunk is done with every staged operand
    // 1. stage B, C (state dims past ds zero) and x (columns past nd zero)
    //    by cp.async; rows past the sequence are zero-filled, never read
    const int kpad = 16 * ksteps;
    for (int e = tid; e < L * (kpad / 8); e += NT) {  // 16-byte copies
      const int t = e / (kpad / 8), k = 8 * (e % (kpad / 8));
      const bool ok = t < n && k < ds;
      const long long off = ok ? (long long)(t0 + t) * bc_ss + k : 0;
      cp_async16(bs + t * CS + k, bb + off, ok);
      cp_async16(cs + t * CS + k, cb + off, ok);
    }
    for (int e = tid; e < L * (HS / 8); e += NT) {
      const int t = e / (HS / 8), d = 8 * (e % (HS / 8));
      const bool ok = t < n && d < nd;
      cp_async16(xs + t * XS + d, xb + (ok ? (long long)(t0 + t) * x_ss + d : 0), ok);
    }
    cp_async_commit();
    if (warp == 0) scan_chunk(dtb, dt_ss, t0, n, a_h, lane, cum, dts);
    cp_async_wait<0>();
    __syncthreads();
    const float total = cum[L - 1];

    // 2a. G1: W = mask(C B^T . exp(cum_i - cum_j) . dt_j), rows 16 rb + ...,
    //     columns 32 ch + 8 nt + ...; tiles wholly above the diagonal skipped
    {
      const int rb = warp >> 1, ch = warp & 1;
      const int r0 = 16 * rb + gid;
      float acc[4][4] = {};
      for (int ks = 0; ks < ksteps; ++ks) {
        const int k0 = 16 * ks + 2 * tig;
        const uint32_t a[4] = {ld32(cs + r0 * CS + k0), ld32(cs + (r0 + 8) * CS + k0),
                               ld32(cs + r0 * CS + k0 + 8), ld32(cs + (r0 + 8) * CS + k0 + 8)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (32 * ch + 8 * nt > 16 * rb + 15) continue;
          const __nv_bfloat16* brow = bs + (32 * ch + 8 * nt + gid) * CS + k0;
          mma_bf16(acc[nt], a, ld32(brow), ld32(brow + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int j = 32 * ch + 8 * nt + 2 * tig;
        if (32 * ch + 8 * nt > 16 * rb + 15) continue;  // never read by G2
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r0 + 8 * half;
          float w[2];
#pragma unroll
          for (int c = 0; c < 2; ++c)
            w[c] = j + c <= i ? acc[nt][2 * half + c] * expf(cum[i] - cum[j + c]) * dts[j + c]
                              : 0.f;
          store_split(w_hi + i * WS + j, w_lo + i * WS + j, w[0], w[1]);
        }
      }
    }
    // 2b. x_j w_j with w_j = exp(cum_L - cum_j) dt_j, for the state update
    for (int e = tid; e < L * (HS / 2); e += NT) {
      const int t = e / (HS / 2), d = 2 * (e % (HS / 2));
      const float wt = expf(total - cum[t]) * dts[t];
      const __nv_bfloat162 xv = *reinterpret_cast<const __nv_bfloat162*>(xs + t * XS + d);
      store_split(xw_hi + t * XS + d, xw_lo + t * XS + d, __low2float(xv) * wt,
                  __high2float(xv) * wt);
    }
    __syncthreads();

    // 3. G2 + G3: y = W x + exp(cum_i) C h for rows 16 rb + ..., columns
    //    16 dh + 8 nt + ...
    {
      const int rb = warp >> 1, dh = warp & 1;
      const int r0 = 16 * rb + gid;
      float intra[2][4] = {}, inter[2][4] = {};
      for (int ks = 0; ks <= rb; ++ks) {  // W is zero right of the diagonal block
        const int k0 = 16 * ks + 2 * tig;
        const uint32_t ahi[4] = {ld32(w_hi + r0 * WS + k0), ld32(w_hi + (r0 + 8) * WS + k0),
                                 ld32(w_hi + r0 * WS + k0 + 8),
                                 ld32(w_hi + (r0 + 8) * WS + k0 + 8)};
        const uint32_t alo[4] = {ld32(w_lo + r0 * WS + k0), ld32(w_lo + (r0 + 8) * WS + k0),
                                 ld32(w_lo + r0 * WS + k0 + 8),
                                 ld32(w_lo + (r0 + 8) * WS + k0 + 8)};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* xcol = xs + k0 * XS + 16 * dh + 8 * nt + gid;
          const uint32_t b0 = ld_pair(xcol, XS), b1 = ld_pair(xcol + 8 * XS, XS);
          mma_bf16(intra[nt], ahi, b0, b1);
          mma_bf16(intra[nt], alo, b0, b1);
        }
      }
      for (int ks = 0; ks < ksteps; ++ks) {
        const int k0 = 16 * ks + 2 * tig;
        const uint32_t a[4] = {ld32(cs + r0 * CS + k0), ld32(cs + (r0 + 8) * CS + k0),
                               ld32(cs + r0 * CS + k0 + 8), ld32(cs + (r0 + 8) * CS + k0 + 8)};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int d = 16 * dh + 8 * nt + gid;
          mma_bf16(inter[nt], a, ld32(h_hi + d * CS + k0), ld32(h_hi + d * CS + k0 + 8));
          mma_bf16(inter[nt], a, ld32(h_lo + d * CS + k0), ld32(h_lo + d * CS + k0 + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int d = 16 * dh + 8 * nt + 2 * tig;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = r0 + 8 * (e >> 1), dd = d + (e & 1);
          if (i < n && dd < nd)
            y[(((long long)b * seq + t0 + i) * nh + h) * hd + d0 + dd] =
                __float2bfloat16(intra[nt][e] + expf(cum[i]) * inter[nt][e]);
        }
      }
    }
    // 4. G4: h' = exp(cum_L) h + (x w)^T B, in the accumulators
    {
      const float decay = expf(total);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) hacc[nt][e] *= decay;
#pragma unroll
      for (int ks = 0; ks < L / 16; ++ks) {
        const int k0 = 16 * ks + 2 * tig;
        const int dr = hr + gid;
        const uint32_t ahi[4] = {ld_pair(xw_hi + k0 * XS + dr, XS),
                                 ld_pair(xw_hi + k0 * XS + dr + 8, XS),
                                 ld_pair(xw_hi + (k0 + 8) * XS + dr, XS),
                                 ld_pair(xw_hi + (k0 + 8) * XS + dr + 8, XS)};
        const uint32_t alo[4] = {ld_pair(xw_lo + k0 * XS + dr, XS),
                                 ld_pair(xw_lo + k0 * XS + dr + 8, XS),
                                 ld_pair(xw_lo + (k0 + 8) * XS + dr, XS),
                                 ld_pair(xw_lo + (k0 + 8) * XS + dr + 8, XS)};
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (hc + 8 * nt >= 16 * ksteps) continue;  // state dims past ds stay zero
          const __nv_bfloat16* bcol = bs + k0 * CS + hc + 8 * nt + gid;
          const uint32_t b0 = ld_pair(bcol, CS), b1 = ld_pair(bcol + 8 * CS, CS);
          mma_bf16(hacc[nt], ahi, b0, b1);
          mma_bf16(hacc[nt], alo, b0, b1);
        }
      }
    }
    __syncthreads();  // every warp's G3 has read the state the copy below replaces
    store_state();
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = hr + gid + 8 * (e >> 1), k = hc + 8 * nt + 2 * tig + (e & 1);
      if (d < nd && k < ds) hT[(state + d) * ds + k] = hacc[nt][e];
    }
}

cudaError_t launch_mma(const void* x, const float* dt, const float* A, const void* bm,
                       const void* cm, const float* h0, void* y, float* hT, int batch, int seq,
                       int nh, int hd, int groups, int ds, long long x_sb, long long x_ss,
                       long long x_sh, long long bc_sb, long long bc_ss, long long bc_sg,
                       long long dt_sb, long long dt_ss, long long dt_sh, cudaStream_t stream) {
  static bool opted_in = false;
  const cudaError_t err = opt_in_smem(ssd_chunk_scan_mma_kernel, mma_smem_bytes(), opted_in);
  if (err != cudaSuccess) return err;
  // the 16-byte staging copies need 8-element multiples and 16-byte bases
  const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
  if (ds % 8 || hd % 8 || x_sb % 8 || x_ss % 8 || x_sh % 8 || bc_sb % 8 || bc_ss % 8 ||
      bc_sg % 8 || !al(x) || !al(bm) || !al(cm))
    return cudaErrorInvalidValue;
  const dim3 grid((hd + HS - 1) / HS, nh, batch);
  ssd_chunk_scan_mma_kernel<<<grid, NT, mma_smem_bytes(), stream>>>(
      static_cast<const __nv_bfloat16*>(x), dt, A, static_cast<const __nv_bfloat16*>(bm),
      static_cast<const __nv_bfloat16*>(cm), h0, static_cast<__nv_bfloat16*>(y), hT, seq, nh, hd,
      nh / groups, ds, x_sb, x_ss, x_sh, bc_sb, bc_ss, bc_sg, dt_sb, dt_ss, dt_sh);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* x, const float* dt, const float* A, const void* bm,
                       const void* cm, const float* h0, void* y, float* hT, int batch, int seq,
                       int nh, int hd, int groups, int ds, long long x_sb, long long x_ss,
                       long long x_sh, long long bc_sb, long long bc_ss, long long bc_sg,
                       long long dt_sb, long long dt_ss, long long dt_sh, cudaStream_t stream) {
  static bool opted_in = false;
  const size_t smem = smem_bytes(DS_MAX);  // opt in once, for the largest state
  auto kernel = ssd_chunk_scan_f32_kernel;
  cudaError_t err = opt_in_smem(kernel, smem, opted_in);
  if (err != cudaSuccess) return err;
  const dim3 grid((hd + HS - 1) / HS, nh, batch);
  kernel<<<grid, NT, smem_bytes(ds), stream>>>(
      static_cast<const float*>(x), dt, A, static_cast<const float*>(bm),
      static_cast<const float*>(cm), h0, static_cast<float*>(y), hT, seq, nh, hd, nh / groups,
      ds, x_sb, x_ss, x_sh, bc_sb, bc_ss, bc_sg, dt_sb, dt_ss, dt_sh);
  return cudaGetLastError();
}

}  // namespace

// x: (B, S, nh, hd) with element strides x_sb, x_ss, x_sh; B and C: (B, S, G,
// ds) sharing strides bc_sb, bc_ss, bc_sg; last axes contiguous. dt: (B, S,
// nh) fp32, strides dt_sb, dt_ss, dt_sh. A: (nh,) fp32. h0 (or null) and hT:
// (B, nh, hd, ds) fp32 contiguous. y: (B, S, nh, hd) contiguous. dtype: 0 =
// float32, 1 = bfloat16 (x, B, C and y). Returns the cudaError_t of the
// launch (0 = success).
extern "C" int ssd_chunk_scan_launch(const void* x, const void* dt, const void* A, const void* bm,
                                     const void* cm, const void* h0, void* y, void* hT, int batch,
                                     int seq, int nh, int hd, int groups, int ds, long long x_sb,
                                     long long x_ss, long long x_sh, long long bc_sb,
                                     long long bc_ss, long long bc_sg, long long dt_sb,
                                     long long dt_ss, long long dt_sh, int dtype, void* stream) {
  if (batch < 1 || seq < 1 || nh < 1 || hd < 1 || groups < 1 || nh % groups || ds < 1 ||
      ds > DS_MAX)
    return int(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* dtf = static_cast<const float*>(dt);
  const float* af = static_cast<const float*>(A);
  const float* h0f = static_cast<const float*>(h0);
  float* hTf = static_cast<float*>(hT);
  if (dtype == 0)
    return int(launch_f32(x, dtf, af, bm, cm, h0f, y, hTf, batch, seq, nh, hd, groups, ds, x_sb,
                          x_ss, x_sh, bc_sb, bc_ss, bc_sg, dt_sb, dt_ss, dt_sh, s));
  if (dtype == 1)
    return int(launch_mma(x, dtf, af, bm, cm, h0f, y, hTf, batch, seq, nh, hd, groups, ds, x_sb,
                          x_ss, x_sh, bc_sb, bc_ss, bc_sg, dt_sb, dt_ss, dt_sh, s));
  return int(cudaErrorInvalidValue);
}

extern "C" const char* ssd_chunk_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
