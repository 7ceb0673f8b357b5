// Device helpers shared by the port's attention kernels (sm_90a).
//
// Warp reductions, the bf16 tensor-core fragments of FlashAttention-2's
// register layout (mma.sync m16n8k16 with fp32 accumulation, V fragments by
// ldmatrix.trans), the fp32 CUDA-core row products, 16-byte cp.async copies
// that zero-fill what they must not read, and the one-time opt-in to more
// than 48 KB of dynamic shared memory.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace attn {

constexpr float NEG_INF = -1.0e30f;  // the TPU kernels' running-max start

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// 16 bytes from global to shared memory, asynchronously; when !valid nothing
// is read and the 16 bytes are zero-filled (src-size 0), so a key that must
// not be loaded (NaN garbage past a length) never is.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem), "r"(n));
}

// An L2 policy that marks what it loads first to go: data read once (a KV
// stream) then replaces itself rather than what L2 holds for others, and
// evicts no dirty line that would have to be written back on the way.
__device__ __forceinline__ uint64_t l2_evict_first() {
  uint64_t policy;
  asm volatile("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\n" : "=l"(policy));
  return policy;
}

// cp_async16 under an L2 policy (l2_evict_first)
__device__ __forceinline__ void cp_async16_hint(void* smem, const void* gmem, bool valid,
                                                uint64_t policy) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\n" ::"r"(dst),
               "l"(gmem), "r"(n), "l"(policy));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N committed groups are still in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// fp32 products on the CUDA cores
// ---------------------------------------------------------------------------

// acc[i] += q[first + step * i] . k for the thread's rows i < n (all ROWS when
// FULL: no per-row test, so the compiler can interleave the rows' loads and
// FMAs). q rows are D floats apart, k is one key's D floats.
template <int ROWS, int D, bool FULL>
__device__ __forceinline__ void dot_rows(float (&acc)[ROWS], const float* qs, const float* kr,
                                         int first, int step, int n) {
  for (int x = 0; x < D; x += 4) {
    const float4 kx = *reinterpret_cast<const float4*>(kr + x);
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (!FULL && i >= n) break;
      const float4 qx = *reinterpret_cast<const float4*>(qs + (first + step * i) * D + x);
      float s = acc[i];
      s = fmaf(qx.x, kx.x, s);
      s = fmaf(qx.y, kx.y, s);
      s = fmaf(qx.z, kx.z, s);
      acc[i] = fmaf(qx.w, kx.w, s);
    }
  }
}

// acc[i] += sum_c p[first + step * i][c] * v[c][dcol] over the BK keys of a
// block, for the thread's rows i < n (all ROWS when FULL). Rows of p are SS
// floats apart.
template <int ROWS, int D, int SS, int BK, bool FULL>
__device__ __forceinline__ void pv_rows(float (&acc)[ROWS], const float* ss, const float* vs,
                                        int dcol, int first, int step, int n) {
  for (int c = 0; c < BK; c += 4) {
    const float v0 = vs[c * D + dcol], v1 = vs[(c + 1) * D + dcol];
    const float v2 = vs[(c + 2) * D + dcol], v3 = vs[(c + 3) * D + dcol];
#pragma unroll
    for (int i = 0; i < ROWS; ++i) {
      if (!FULL && i >= n) break;
      const float4 p = *reinterpret_cast<const float4*>(ss + (first + step * i) * SS + c);
      float a = acc[i];
      a = fmaf(p.x, v0, a);
      a = fmaf(p.y, v1, a);
      a = fmaf(p.z, v2, a);
      acc[i] = fmaf(p.w, v3, a);
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 products on the tensor cores
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, "
      "{%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B fragment (16 keys x 8 dims) of P V from V staged as [key][d]: the
// two 8x8 matrices of keys k0..k0+7 and k0+8..k0+15, transposed on load.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t& b0, uint32_t& b1,
                                                  const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b0), "=r"(b1)
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The A fragment (16 rows x 16 k) of a row-major bf16 tile in shared memory:
// lane l gives the address of row l % 16 at column (l / 16) * 8.
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&a)[4], const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// The A fragment (16 x 16) of the transpose of a row-major bf16 tile in
// shared memory: lane l gives the address of stored row (l % 8) + 8 (l / 16)
// at column 8 ((l / 8) % 2); each 8x8 matrix is transposed on load.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&a)[4], const __nv_bfloat16* row) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(addr));
}

// the transpose of an 8x8 bf16 matrix held in a warp's fragment layout
// (lane (g, t) holds row g, columns 2t and 2t + 1)
__device__ __forceinline__ uint32_t movmatrix_trans(uint32_t x) {
  uint32_t y;
  asm volatile("movmatrix.sync.aligned.m8n8.trans.b16 %0, %1;\n" : "=r"(y) : "r"(x));
  return y;
}

constexpr int MMA_BK = 64;  // keys per staged block of the mma.sync kernels

// 2^x on the special-function unit (ex2.approx, flushing denormals to 0):
// one instruction, where exp2f adds range handling around it
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// tanh from one exponential and one fast division, for the softcap of the
// bf16 kernels: absolute error about 1e-7, where CUDA's tanhf costs some 40
// instructions a score
__device__ __forceinline__ float tanh_fast(float x) {
  return 1.f - __fdividef(2.f, __expf(2.f * x) + 1.f);
}

// One warp's 16 query vectors in FlashAttention-2's register layout, shared
// by the mma.sync kernels (B1, B2's row tiles, B4 at d <= 32). Lane
// (gid, tig) = (lane / 4, lane % 4) owns rows gid ("a") and gid + 8 ("b")
// of the 16: their online-softmax state and their accumulator columns
// 8n + 2 tig, 8n + 2 tig + 1. Per block of BK keys ([key][KSTR] bf16 in
// shared memory; MMA_BK keys, or fewer where warps share a staged block's
// keys), S = Q K^T lands in mma accumulators, the softmax
// runs on them in fp32 (a row's scores spread over the 4 lanes of a quad),
// and the probabilities, rounded to bf16, are reused in place as the A
// operand of P V; a K fragment is one 32-bit read, a V fragment one
// ldmatrix.trans. Q's fragments are held in registers at d <= 128; at
// d = 256 they are read from shared memory per k-step (ldmatrix), since
// holding them beside O's 128 accumulators would spill.
template <int D, int KSTR, int BK = MMA_BK>
struct MmaRows {
  static constexpr int KSTEPS = D / 16;  // k-steps of S = Q K^T
  static constexpr int NT_S = BK / 8;    // 8-key tiles of S
  static constexpr int NT_O = D / 8;     // 8-dim tiles of O
  static constexpr bool Q_SMEM = D > 128;
  static_assert(D % 16 == 0 && BK % 16 == 0, "mma tile shape");

  uint32_t qa[Q_SMEM ? 1 : KSTEPS][4];
  const __nv_bfloat16* qrow;  // Q_SMEM: this lane's ldmatrix row
  float acc[NT_O][4];
  float m_a, m_b, l_a, l_b;

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int n = 0; n < NT_O; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    m_a = m_b = NEG_INF;
    l_a = l_b = 0.f;
  }

  // Q from global memory into registers (d <= 128): rows a and b start at
  // elements base_a and base_b of q; a row that is not live is zero
  __device__ __forceinline__ void load_q(const __nv_bfloat16* q, long long base_a,
                                         long long base_b, bool live_a, bool live_b) {
    const int tig = threadIdx.x % 4;
    const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q);
#pragma unroll
    for (int kk = 0; kk < (Q_SMEM ? 1 : KSTEPS); ++kk) {
      const int x = kk * 16 + 2 * tig;
      qa[kk][0] = live_a ? q32[(base_a + x) / 2] : 0u;
      qa[kk][1] = live_b ? q32[(base_b + x) / 2] : 0u;
      qa[kk][2] = live_a ? q32[(base_a + x + 8) / 2] : 0u;
      qa[kk][3] = live_b ? q32[(base_b + x + 8) / 2] : 0u;
    }
  }

  // Q read from shared memory per k-step (d = 256): the warp's 16 rows start
  // at ``rows``, ``stride`` bf16 apart
  __device__ __forceinline__ void q_from_smem(const __nv_bfloat16* rows, int stride) {
    const int lane = threadIdx.x % 32;
    qrow = rows + (lane & 15) * stride + (lane >> 4) * 8;
  }

  // keys [kb, kb + BK) staged at ks / vs; row a reads keys [lo_a,
  // hi_a), row b [lo_b, hi_b); scores are scaled, capped, then masked
  __device__ __forceinline__ void block(const __nv_bfloat16* ks, const __nv_bfloat16* vs, int kb,
                                        int lo_a, int hi_a, int lo_b, int hi_b, float scale,
                                        float softcap) {
    const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
    float s[NT_S][4];
#pragma unroll
    for (int j = 0; j < NT_S; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    if constexpr (Q_SMEM) {  // each k-step's Q fragment read once, for all key tiles
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, qrow + kk * 16);
#pragma unroll
        for (int j = 0; j < NT_S; ++j) {
          const __nv_bfloat16* krow = ks + (j * 8 + gid) * KSTR + kk * 16 + 2 * tig;
          mma_bf16(s[j], a, *reinterpret_cast<const uint32_t*>(krow),
                   *reinterpret_cast<const uint32_t*>(krow + 8));
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < NT_S; ++j) {
        const __nv_bfloat16* krow = ks + (j * 8 + gid) * KSTR + 2 * tig;
#pragma unroll
        for (int kk = 0; kk < KSTEPS; ++kk)
          mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(krow + kk * 16),
                   *reinterpret_cast<const uint32_t*>(krow + kk * 16 + 8));
      }
    }
    // scale, softcap, mask; the block's row maxima over each quad
    const float inv_cap = 1.f / softcap;
    float mx_a = NEG_INF, mx_b = NEG_INF;
#pragma unroll
    for (int j = 0; j < NT_S; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kb + j * 8 + 2 * tig + (e & 1);
        const bool ok = e < 2 ? kp >= lo_a && kp < hi_a : kp >= lo_b && kp < hi_b;
        float v = s[j][e] * scale;
        if (softcap > 0.f) v = softcap * tanh_fast(v * inv_cap);
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
    // O += P V: the S accumulators of key tiles 2k and 2k+1 are, rounded to
    // bf16, exactly the A fragment of key step k
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

  // O / l in bf16 to rows a and b of ``out`` (starting at elements base_a,
  // base_b), each only if live
  __device__ __forceinline__ void store(__nv_bfloat16* out, long long base_a, long long base_b,
                                        bool live_a, bool live_b) const {
    const int tig = threadIdx.x % 4;
    const float inv_a = 1.f / fmaxf(l_a, 1e-37f), inv_b = 1.f / fmaxf(l_b, 1e-37f);
    uint32_t* o32 = reinterpret_cast<uint32_t*>(out);
#pragma unroll
    for (int n = 0; n < NT_O; ++n) {
      const int x = n * 8 + 2 * tig;
      if (live_a) o32[(base_a + x) / 2] = pack_bf16(acc[n][0] * inv_a, acc[n][1] * inv_a);
      if (live_b) o32[(base_b + x) / 2] = pack_bf16(acc[n][2] * inv_b, acc[n][3] * inv_b);
    }
  }
};

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// Above 48 KB of dynamic shared memory a kernel needs an opt-in, once.
// ``done`` is a static of the caller's own launch template: kernels of one
// signature share a function-pointer type, so a static here would be shared.
template <typename Kernel>
cudaError_t opt_in_smem(Kernel kernel, size_t bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(bytes));
  if (err == cudaSuccess) done = true;
  return err;
}

}  // namespace attn
