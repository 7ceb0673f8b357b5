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
