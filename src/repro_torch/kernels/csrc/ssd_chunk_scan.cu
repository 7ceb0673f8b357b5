// Mamba2 SSD (state-space duality) chunk scan for Hopper (sm_90a).
//
// Replaces the TPU kernel `ssd_chunk_scan` (src/repro/kernels/ssd.py:81, body
// `_ssd_kernel` :35; model-layout wrapper `ops.ssd`, kernels/ops.py:106) of
// the JAX package. The sequence is cut into chunks of L = 64 tokens; with
// cum_i = sum_{t<=i} dt_t A within a chunk and h the state (hd x ds, fp32) at
// the chunk's start:
//
//   y_i  = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j + exp(cum_i) C_i . h
//   h'   = d_c h + S_c,   d_c = exp(cum_L),   S_c = sum_j exp(cum_L - cum_j) dt_j x_j^T B_j
//
// and the call returns y and the final state hT. The TPU kernel walks the
// chunks as the sequential axis of its grid with h in VMEM scratch.
//
// What bounds it on an H100: the function reads x, B, C, dt and h0 once and
// writes y and hT once; at a 512-token bf16 segment of Mamba2-2.7B that is
// 16 MB (4.8 us at 3.35 TB/s) against about 1.5e9 operations (1.5 us at the
// bf16 tensor rate), so bytes bound it. What holds a kernel back is the
// sequence: one CTA that walks a head's chunks one after another pays a
// chain of dependent phases per chunk. Here the chunks run in parallel:
//   * work items (chunk c, head, hs columns of hd) are taken from an atomic
//     ticket in chunk-major order by a grid of at most CTAS_PER_SM CTAs an
//     SM; a CTA takes its next ticket while it works on the current item;
//   * an item first does all that needs no carried state: it stages the
//     chunk (B, C and x by 16-byte cp.async; the next item's x and dt are
//     prefetched into L2 meanwhile), every warp scans dt A into its own copy
//     of cum, and it forms C B^T, W (in registers), the intra-chunk W x and
//     the chunk's own contribution to the state S_c;
//   * only then does each warp wait for the same warp's part of chunk c-1's
//     end state (a flag with acquire semantics), load it (every load in
//     flight at once), form its part of h_c = d_c h_{c-1} + S_c, store it and
//     publish it (a flag with release semantics): the chain between chunks
//     passes no CTA barrier and no shared memory. Then exp(cum_i) C_i .
//     h_{c-1} is added to y. Chunk 0 starts from h0 (or zeros); the last
//     chunk writes hT;
//   * chunk-end states go through a ring of `ring` slots in a scratch that
//     persists on the device (laid out and bounded by `schedule` below):
//     one slot per chunk would write and read back nc x nh x hd x ds x 4
//     bytes (168 MB at 4096 tokens); the ring, sized to the chunks in
//     flight, stays in the 50 MB L2. A slot is overwritten only after the
//     item that reads its previous tenant says so (`consumed`). Flags carry
//     the call's epoch, so nothing is reset between calls. The epoch is a
//     word of the scratch, not an argument: every CTA reads it when it
//     starts, and the last CTA to finish (every item done) zeroes the
//     ticket and moves the word on. A launch captured in a CUDA graph thus
//     tags its flags anew on every replay and never takes a flag of the
//     replay before; at the wrap of its 32 bits that CTA zeroes the flags
//     and starts again from 1;
//   * bf16 inputs (serving): the products (C B^T, W x, S_c, C h) run on the
//     tensor cores (mma.sync m16n8k16), with W, x w and h split into two
//     bf16 parts so the sums stay near fp32; fp32 inputs (the exactness
//     checks) take the same items with the products on the CUDA cores;
//   * the decay exp(cum_i - cum_j) is evaluated only for j <= i: above the
//     diagonal the exponent is positive and, with Mamba2-2.7B's own decay
//     rates (A down to -80, dt up to 0.1), overflows to inf (the TPU kernel
//     masks it with `where`); a ragged last chunk is masked (dt = 0, x = B =
//     C = 0 past the end), which leaves hT exact, and y is written only for
//     live tokens.
// An item is latency-bound (about 11 us on an idle card at Mamba2-2.7B's
// widths: staging, the products, the carry's round trips through L2), and
// the card holds two an SM, so at 512 tokens the items, not the chain,
// set the time. Tried and dropped: two heads an item sharing C B^T (the
// second head's carry waits behind the first's), staging the next item
// into a second C buffer under this one's last step (slower at 512 tokens,
// registers spill), one CTA an SM.
//
// Layouts: x (B, S, nh, hd), B and C (B, S, G, ds) with any element strides
// of batch, token and head/group (last axis contiguous); dt (B, S, nh) fp32
// with any strides; A (nh,) fp32; h0 and hT (B, nh, hd, ds) fp32 contiguous,
// h0 may be null (zeros) and must not alias hT (another item may still read
// h0 when the last chunk's item writes hT); y (B, S, nh, hd) contiguous in
// x's dtype.
#include <algorithm>

#include "attention_common.cuh"

namespace {

using namespace attn;

constexpr int NT = 256;          // threads per CTA
constexpr int L = 64;            // tokens per chunk
constexpr int DS_MAX = 128;      // largest state width
constexpr int CTAS_PER_SM = 2;   // both kernels' launch bounds
constexpr int HS_MMA = 64;       // hd columns of a bf16 item
constexpr int HS_F32 = 32;       // hd columns of an fp32 item
constexpr int WARPS = NT / 32;   // a warp carries its own part of the state

// ---------------------------------------------------------------------------
// The schedule: items, tickets and the ring
// ---------------------------------------------------------------------------
//
// Item t (a ticket) is chunk c = t / ipc, and u = t % ipc names its batch,
// head block and column slice; item (c, u) reads the end state of item
// (c - 1, u), whose ticket is smaller by ipc. Tickets are taken in order by
// running CTAs, and an item waits only on items with smaller tickets, which
// running CTAs hold or have finished: by induction from the smallest ticket
// not yet done, every wait ends, whatever the grid and however many CTAs the
// card holds at once. The ring: chunk c's end state goes to slot c % ring
// (the last chunk's to hT), and the item that writes slot c % ring waits
// until chunk c - ring's state has been read by item (c - ring + 1, u),
// whose ticket is smaller still. ring >= 2 whenever a slot is reused, so no
// item waits on itself; ring = nc - 1 (no reuse) when the chunks are few,
// else the chunks a full grid holds at once plus two. The Python copy of
// this schedule is `ssd_chunk_schedule` in src/repro_torch/kernels/ref.py.
struct Schedule {
  int nc, hs, slices, ipc, grid, ring;
  long long n_items;
  long long ready, consumed, states, total;  // byte offsets in the scratch, its size
};

Schedule schedule(int batch, int seq, int nh, int groups, int hd, int ds, int dtype, int sms) {
  Schedule s;
  s.nc = (seq + L - 1) / L;
  s.hs = dtype == 1 ? HS_MMA : HS_F32;
  s.slices = (hd + s.hs - 1) / s.hs;
  s.ipc = batch * nh * s.slices;
  s.n_items = (long long)s.nc * s.ipc;
  s.grid = (int)std::min<long long>(s.n_items, (long long)CTAS_PER_SM * sms);
  s.ring = s.nc < 2 ? 0 : std::min(s.nc - 1, std::max(2, (s.grid + s.ipc - 1) / s.ipc + 2));
  // the scratch: the ticket, the count of finished CTAs and the epoch (3 x
  // u32 in 16 bytes; the epoch is nonzero, 1 when the scratch is made), then
  // the ready flags (u64, one per slot, item and warp) and the consumed
  // flags (one per slot and item), then the states (fp32, hs x DS_MAX per
  // slot and item, in the order the warps hold them), 16-byte aligned
  const long long slots = (long long)s.ring * s.ipc;
  s.ready = 16;
  s.consumed = s.ready + 8 * slots * WARPS;
  s.states = (s.consumed + 8 * slots + 15) / 16 * 16;
  s.total = s.states + 4 * slots * s.hs * DS_MAX;
  return s;
}

struct Args {
  const void* x;
  const float* dt;
  const float* A;
  const void* bm;
  const void* cm;
  const float* h0;
  void* y;
  float* hT;
  int batch, seq, nh, hd, rep, ds;
  long long x_sb, x_ss, x_sh, bc_sb, bc_ss, bc_sg, dt_sb, dt_ss, dt_sh;
  int nc, hs, slices, ipc, ring, n_items;
  long long scratch_bytes;
  unsigned* counters;  // [0] the ticket, [1] CTAs finished, [2] the epoch
  unsigned long long* ready;
  unsigned long long* consumed;
  float* states;
};

struct Item {
  int c, u, b, h, d0, nd, t0, n;
};

__device__ __forceinline__ Item item_of(const Args& a, int t) {
  Item it;
  it.c = t / a.ipc;
  it.u = t % a.ipc;
  const int slice = it.u % a.slices, rest = it.u / a.slices;
  it.b = rest / a.nh;
  it.h = rest % a.nh;
  it.d0 = slice * a.hs;
  it.nd = min(a.hs, a.hd - it.d0);
  it.t0 = it.c * L;
  it.n = min(L, a.seq - it.t0);
  return it;
}

// The call's epoch << 32 (a flag's value is epoch | chunk), read from the
// scratch by thread 0 of each CTA before its first ticket (`start_call`).
__shared__ unsigned long long s_epoch;

// Thread 0 takes the CTA's next ticket; -1 when none is left. A CTA takes
// its next ticket while it works on the current item (s_tk[2],
// alternating), which the schedule's argument allows: that item's ticket is
// the larger.
__device__ __forceinline__ int take_ticket(const Args& a) {
  const unsigned t = atomicAdd(a.counters, 1u);
  return t < (unsigned)a.n_items ? int(t) : -1;
}

// Thread 0, as the CTA starts: the call's epoch, then the first ticket. The
// last CTA to finish moves the epoch word on only after every CTA has
// counted itself finished, which each does after this read.
__device__ __forceinline__ int start_call(const Args& a) {
  const unsigned epoch = *(volatile unsigned*)(a.counters + 2);
  if (epoch == 0u) __trap();  // a scratch the wrapper did not make: flags of 0 would match
  s_epoch = (unsigned long long)epoch << 32;
  return take_ticket(a);
}

// Every thread, after the CTA's last item. The CTA that finishes last (all
// others have left their loops, so no item is running) readies the scratch
// for the next call: the ticket and the count to 0, the epoch word to the
// next epoch. The flags hold 32 bits of the epoch: where it would wrap to 0,
// the CTA zeroes every flag and state first (no flag of this epoch may
// match one 2^32 calls on) and the next epoch is 1.
__device__ void finish_call(const Args& a) {
  __shared__ int s_last;
  __syncthreads();  // the CTA's warps are done
  if (threadIdx.x == 0) {
    __threadfence();
    s_last = atomicAdd(a.counters + 1, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const unsigned next = unsigned(s_epoch >> 32) + 1u;
  if (next == 0u) {
    uint4* body = reinterpret_cast<uint4*>(a.counters) + 1;  // past the 16-byte header
    for (long long i = threadIdx.x; i < a.scratch_bytes / 16 - 1; i += blockDim.x)
      body[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    a.counters[0] = 0;
    a.counters[1] = 0;
    a.counters[2] = next == 0u ? 1u : next;
  }
}

__device__ __forceinline__ unsigned long long ld_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];\n" : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned long long* p, unsigned long long v) {
  asm volatile("st.release.gpu.global.u64 [%0], %1;\n" ::"l"(p), "l"(v) : "memory");
}

// A wait ends within the call (see the schedule above); one that has not
// after 2^26 polls (seconds) means a broken flag, and traps rather than hang.
__device__ __forceinline__ void spin(const unsigned long long* p, unsigned long long want) {
  for (unsigned polls = 0; ld_acquire(p) != want; __nanosleep(32))
    if (++polls == (1u << 26)) __trap();
}

// chunk c's slot of item u: its index among the flags
__device__ __forceinline__ long long slot_of(const Args& a, int c, int u) {
  return (long long)(c % a.ring) * a.ipc + u;
}

// Lane 0 of each warp, before the warp forms its part of item `it`'s end
// state: chunk c - 1's same warp has published its part, and the slot this
// chunk writes has been read.
__device__ __forceinline__ void wait_carry(const Args& a, const Item& it, int warp) {
  if (it.c > 0)
    spin(a.ready + slot_of(a, it.c - 1, it.u) * WARPS + warp, s_epoch | unsigned(it.c - 1));
  if (it.c < a.nc - 1 && it.c >= a.ring)
    spin(a.consumed + slot_of(a, it.c, it.u), s_epoch | unsigned(it.c - a.ring));
}

// Lane 0 of a warp, after __syncwarp follows the warp's stores of its part
// of the end state: publish it. The warp barrier orders the lanes' stores
// before lane 0's release, which is cumulative, so a reader that acquires
// the flag (and then passes its own warp barrier) sees every one.
__device__ __forceinline__ void publish_ready(const Args& a, const Item& it, int warp) {
  if (it.c < a.nc - 1)
    st_release(a.ready + slot_of(a, it.c, it.u) * WARPS + warp, s_epoch | unsigned(it.c));
}

// Thread 0, after a barrier that follows every warp's loads of the start
// state: its slot may be written again.
__device__ __forceinline__ void publish_consumed(const Args& a, const Item& it) {
  if (it.c > 0) st_release(a.consumed + slot_of(a, it.c - 1, it.u), s_epoch | unsigned(it.c - 1));
}

// A ring slot, in the order the warps hold the state: thread (w, l)'s j-th
// fp32 pair (bf16) or value (fp32) at [(w * J + j) * 32 + l], so that a warp
// moves 32 consecutive elements an instruction.
__device__ __forceinline__ float* ring_slot(const Args& a, int c, int u) {
  return a.states + slot_of(a, c, u) * a.hs * DS_MAX;
}

// Item `it`'s rows of h0 (element [r * ds + kk] of its columns), or null;
// and of hT.
__device__ __forceinline__ const float* h0_rows(const Args& a, const Item& it) {
  if (a.h0 == nullptr) return nullptr;
  return a.h0 + (((long long)it.b * a.nh + it.h) * a.hd + it.d0) * a.ds;
}

__device__ __forceinline__ float* hT_rows(const Args& a, const Item& it) {
  return a.hT + (((long long)it.b * a.nh + it.h) * a.hd + it.d0) * a.ds;
}

__device__ __forceinline__ void prefetch_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];\n" ::"l"(p));
}

// Threads 0 .. 2 L - 1: the first line of each bf16 row of x (tid < L) and
// each dt (tid >= L) of item `it`, into L2, while the CTA works on the one
// before.
__device__ __forceinline__ void prefetch_item(const Args& a, const Item& it) {
  const int row = threadIdx.x % L;
  if (threadIdx.x >= 2 * L || row >= it.n) return;
  if (threadIdx.x < L)
    prefetch_l2(static_cast<const __nv_bfloat16*>(a.x) + it.b * a.x_sb + it.h * a.x_sh + it.d0 +
                (long long)(it.t0 + row) * a.x_ss);
  else
    prefetch_l2(a.dt + it.b * a.dt_sb + it.h * a.dt_sh + (long long)(it.t0 + row) * a.dt_ss);
}

// dt of the chunk's tokens 2 lane and 2 lane + 1 (0 past the sequence)
__device__ __forceinline__ float2 load_dt(const Args& a, const Item& it, int h, int lane) {
  const float* p = a.dt + it.b * a.dt_sb + h * a.dt_sh + (long long)it.t0 * a.dt_ss;
  const int t = 2 * lane;
  return make_float2(t < it.n ? p[t * a.dt_ss] : 0.f, t + 1 < it.n ? p[(t + 1) * a.dt_ss] : 0.f);
}

// One warp: the inclusive cumulative log-decay cum of dt A over the chunk,
// dt itself and w_j = exp(cum_L - cum_j) dt_j into cum, dts and wj (L each),
// two tokens a lane, by a shuffle scan.
__device__ __forceinline__ void scan_chunk(float2 dt, float a_h, int lane, float* cum, float* dts,
                                           float* wj) {
  const float s0 = dt.x * a_h, s1 = s0 + dt.y * a_h;
  float incl = s1;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const float v = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += v;
  }
  float excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.f;
  const float total = __shfl_sync(0xffffffffu, incl, 31);
  const int t = 2 * lane;
  cum[t] = excl + s0;
  cum[t + 1] = incl;
  dts[t] = dt.x;
  dts[t + 1] = dt.y;
  wj[t] = expf(total - (excl + s0)) * dt.x;
  wj[t + 1] = expf(total - incl) * dt.y;
}

// ---------------------------------------------------------------------------
// fp32: the products on the CUDA cores (exactness checks; right, not fast)
// ---------------------------------------------------------------------------

constexpr int HS = HS_F32;
constexpr int XP = HS + 1;  // padded row of the staged x
constexpr int WP = L + 1;   // padded row of W

size_t f32_smem_bytes(int ds) {
  const int dp = ds + 1;
  return sizeof(float) * (2 * L * dp + HS * dp + L * XP + L * WP + 3 * L);
}

__global__ void __launch_bounds__(NT, CTAS_PER_SM) ssd_chunk_scan_f32_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_tk[2];
  const int ds = a.ds, dp = ds + 1;
  float* bs = smem;          // [L][dp]  B of the chunk
  float* cs = bs + L * dp;   // [L][dp]  C of the chunk
  float* hs = cs + L * dp;   // [HS][dp] the start state's rows d0 .. d0 + HS
  float* xs = hs + HS * dp;  // [L][XP]  x's columns d0 .. d0 + HS
  float* ws = xs + L * XP;   // [L][WP]  intra-chunk weights
  float* cum = ws + L * WP;  // [L]
  float* dts = cum + L;      // [L]
  float* wj = dts + L;       // [L]      exp(cum_L - cum_j) dt_j
  const int tid = threadIdx.x;
  const float* xg = static_cast<const float*>(a.x);
  const float* bg = static_cast<const float*>(a.bm);
  const float* cg = static_cast<const float*>(a.cm);
  float* yg = static_cast<float*>(a.y);

  if (tid == 0) s_tk[0] = start_call(a);
  __syncthreads();
  for (int t = s_tk[0], iter = 0; t >= 0; ++iter) {
    if (tid == 0) s_tk[(iter + 1) & 1] = take_ticket(a);
    const Item it = item_of(a, t);
    const int h = it.h, n = it.n, nd = it.nd;
    const float* xb = xg + it.b * a.x_sb + h * a.x_sh + it.d0 + (long long)it.t0 * a.x_ss;
    const long long bc = it.b * a.bc_sb + (h / a.rep) * a.bc_sg + (long long)it.t0 * a.bc_ss;
    // 1. stage the chunk; nothing past the sequence is read
    for (int e = tid; e < L * ds; e += NT) {
      const int t = e / ds, k = e % ds;
      const bool live = t < n;
      bs[t * dp + k] = live ? bg[bc + (long long)t * a.bc_ss + k] : 0.f;
      cs[t * dp + k] = live ? cg[bc + (long long)t * a.bc_ss + k] : 0.f;
    }
    for (int e = tid; e < L * HS; e += NT) {
      const int t = e / HS, d = e % HS;
      xs[t * XP + d] = (t < n && d < nd) ? xb[(long long)t * a.x_ss + d] : 0.f;
    }
    if (tid < 32) scan_chunk(load_dt(a, it, h, tid), a.A[h], tid, cum, dts, wj);
    __syncthreads();
    const int t_next = s_tk[(iter + 1) & 1];

    // 2. W[i][j] = (C_i . B_j) exp(cum_i - cum_j) dt_j for j <= i, else 0
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

    // 3. S_c = sum_j wj_j x_j^T B_j: rows r0 + 8 r, columns kc + 32 c
    const int kc = tid % 32, r0 = tid / 32;
    float acc[4][4] = {};
    for (int j = 0; j < L; ++j) {
      const float w = wj[j];
      float xw[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) xw[r] = xs[j * XP + r0 + 8 * r] * w;
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = kc + 32 * c < ds ? bs[j * dp + kc + 32 * c] : 0.f;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(xw[r], bv[c], acc[r][c]);
    }

    // 4. the carry, warp by warp (warp r0 holds state rows r0 + 8 r): h_c =
    //    d_c h_{c-1} + S_c, the start state kept for step 5
    if (kc == 0) wait_carry(a, it, r0);
    __syncwarp();
    {
      const float decay = expf(cum[L - 1]);
      const int at = r0 * 16 * 32 + kc;  // this thread's first element in a ring slot
      const float* in = it.c > 0 ? ring_slot(a, it.c - 1, it.u) + at : nullptr;
      float* out = it.c < a.nc - 1 ? ring_slot(a, it.c, it.u) + at : nullptr;
      const float* h0r = h0_rows(a, it);
      float* hTr = hT_rows(a, it);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int d = r0 + 8 * r, k = kc + 32 * c, j = 4 * r + c;
          const bool live = d < nd && k < ds;
          const float hp = in != nullptr ? __ldcg(in + j * 32)
                                         : (h0r != nullptr && live ? h0r[d * ds + k] : 0.f);
          const float hv = decay * hp + acc[r][c];
          if (out != nullptr)
            out[j * 32] = hv;
          else if (live)
            hTr[d * ds + k] = hv;
          if (k < ds) hs[d * dp + k] = hp;
        }
    }
    __syncwarp();
    if (kc == 0) publish_ready(a, it, r0);
    __syncthreads();
    if (tid == 0) publish_consumed(a, it);

    // 5. y_i = W_i . x + exp(cum_i) C_i . h_{c-1}: column d, rows i0 + 8 r
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
            yg[(((long long)it.b * a.seq + it.t0 + i) * a.nh + h) * a.hd + it.d0 + d] =
                intra[r] + expf(cum[i]) * inter[r];
        }
      }
    }
    __syncthreads();  // the next item restages every operand
    t = t_next;
  }
  finish_call(a);
}

// ---------------------------------------------------------------------------
// bf16: the products on the tensor cores
// ---------------------------------------------------------------------------
//
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), 8 warps. x, B and C are
// exact in bf16; W, x_j w_j and the state h are not, so each is split into
// a bf16 high part and the bf16 rounding of the rest and enters two
// products: the sums keep about 16 bits more than one bf16 rounding would.
// Only B, C, x and the start state pass through shared memory: W is formed
// in the registers that computed C B^T (accumulator tiles are A fragments),
// x_j w_j is formed from x's fragments as they are loaded, and the state's
// B fragments are split as they are read. Fragments of staged bf16 come by
// ldmatrix, transposed where the reduction runs over the staged rows (W x,
// S_c); rows are padded by 8 bf16 so a matrix's eight rows hit distinct
// banks. A warp's tiles: C B^T and W rows 16 (w / 2) + [0, 16), all columns
// up to the diagonal; y the same rows, columns 32 (w % 2) + [0, 32) of the
// item's 64; S_c and the state rows 16 (w % 4) + [0, 16), columns 64 (w /
// 4) + [0, 64).

constexpr int DSP = 128;        // staged state dims (a multiple of 16, >= ds)
constexpr int CS = DSP + 8;     // row of the staged B and C [t][k]
constexpr int XS = HS_MMA + 8;  // row of the staged x [t][d]
constexpr int HFP = DSP + 8;    // row of the staged fp32 start state [d][k]

constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * (2 * L * CS + L * XS) +
         sizeof(float) * (HS_MMA * HFP + 3 * (NT / 32) * L);
}

// Four 8x8 bf16 matrices from shared memory (ldmatrix): lanes 8 m .. 8 m + 7
// give the addresses of matrix m's rows; with TRANS each is transposed. A
// row-major 16 x 16 A tile at (r, k): lane l names row r + a_row(l), column
// k + a_col(l). A pair of B tiles (n and n + 8) stored [n][k]: row n +
// b_row(l), column k + b_col(l); stored [k][n], transposed: row k + a_row(l),
// column n + a_col(l). An A tile stored [k][m], transposed: row k + b_row(l),
// column m + b_col(l).
template <bool TRANS>
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(p));
  if (TRANS)
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
  else
    asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                 : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
                 : "r"(addr));
}

__device__ __forceinline__ int a_row(int lane) { return lane & 15; }
__device__ __forceinline__ int a_col(int lane) { return (lane >> 4) * 8; }
__device__ __forceinline__ int b_row(int lane) { return (lane & 7) + ((lane >> 4) << 3); }
__device__ __forceinline__ int b_col(int lane) { return ((lane >> 3) & 1) * 8; }

// (v0, v1) = hi + lo with hi = bf16(v) and lo = bf16(v - hi), as bf16 pairs
__device__ __forceinline__ void split_pair(float v0, float v1, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const __nv_bfloat162 l = __floats2bfloat162_rn(v0 - __low2float(h), v1 - __high2float(h));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// a bf16 pair scaled by (w0, w1) in fp32, then split
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1, uint32_t& hi,
                                            uint32_t& lo) {
  const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&v);
  split_pair(__low2float(b) * w0, __high2float(b) * w1, hi, lo);
}

__global__ void __launch_bounds__(NT, CTAS_PER_SM) ssd_chunk_scan_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __shared__ int s_tk[2];
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(mma_smem);  // [L][CS]  C
  __nv_bfloat16* bs = cs + L * CS;                                  // [L][CS]  B
  __nv_bfloat16* xs = bs + L * CS;                                  // [L][XS]  x
  float* hf = reinterpret_cast<float*>(xs + L * XS);                // [HS_MMA][HFP] state
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;  // mma groupID / thread-in-group
  float* cum = hf + HS_MMA * HFP + warp * 3 * L;  // this warp's copy
  float* dts = cum + L;
  float* wj = dts + L;
  const int ds = a.ds;
  const int ksteps = (ds + 15) / 16;  // 16-wide steps over the state dims
  const __nv_bfloat16* xg = static_cast<const __nv_bfloat16*>(a.x);
  const __nv_bfloat16* bg = static_cast<const __nv_bfloat16*>(a.bm);
  const __nv_bfloat16* cg = static_cast<const __nv_bfloat16*>(a.cm);
  __nv_bfloat16* yg = static_cast<__nv_bfloat16*>(a.y);
  const int rb = warp >> 1, ch = warp & 1, r0 = 16 * rb + gid;  // W and y tiles
  const int hr = 16 * (warp & 3), hc = 64 * (warp >> 2);         // S_c and state tiles

  if (tid == 0) s_tk[0] = start_call(a);
  __syncthreads();
  for (int t = s_tk[0], iter = 0; t >= 0; ++iter) {
    if (tid == 0) s_tk[(iter + 1) & 1] = take_ticket(a);
    const Item it = item_of(a, t);
    const int h = it.h, n = it.n, nd = it.nd;
    // 1. stage B, C (state dims past ds zero) and x (columns past nd zero)
    //    by cp.async; rows past the sequence are zero-filled, never read
    {
      const long long bc = it.b * a.bc_sb + (h / a.rep) * a.bc_sg + (long long)it.t0 * a.bc_ss;
      const int kpad = 16 * ksteps;
      for (int e = tid; e < L * (kpad / 8); e += NT) {  // 16-byte copies
        const int t = e / (kpad / 8), k = 8 * (e % (kpad / 8));
        const bool ok = t < n && k < ds;
        const long long off = ok ? bc + (long long)t * a.bc_ss + k : 0;
        cp_async16(bs + t * CS + k, bg + off, ok);
        cp_async16(cs + t * CS + k, cg + off, ok);
      }
      const __nv_bfloat16* xb =
          xg + it.b * a.x_sb + h * a.x_sh + it.d0 + (long long)it.t0 * a.x_ss;
      for (int e = tid; e < L * (HS_MMA / 8); e += NT) {
        const int t = e / (HS_MMA / 8), d = 8 * (e % (HS_MMA / 8));
        const bool ok = t < n && d < nd;
        cp_async16(xs + t * XS + d, xb + (ok ? (long long)t * a.x_ss + d : 0), ok);
      }
      cp_async_commit();
    }
    scan_chunk(load_dt(a, it, h, lane), a.A[h], lane, cum, dts, wj);
    cp_async_wait<0>();
    __syncthreads();
    const int t_next = s_tk[(iter + 1) & 1];
    if (t_next >= 0) prefetch_item(a, item_of(a, t_next));

    // 2. C B^T, rows 16 rb + ..., columns 8 nt + ... up to the diagonal block
    float cb[8][4] = {};
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[4];
      ldsm4<false>(af, cs + (16 * rb + a_row(lane)) * CS + 16 * ks + a_col(lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (np > rb) break;
        uint32_t bf[4];
        ldsm4<false>(bf, bs + (16 * np + b_row(lane)) * CS + 16 * ks + b_col(lane));
        mma_bf16(cb[2 * np], af, bf[0], bf[1]);
        mma_bf16(cb[2 * np + 1], af, bf[2], bf[3]);
      }
    }

    // 3. y = W x with W = mask(C B^T . exp(cum_i - cum_j) . dt_j), formed
    //    and split in registers, one 16-column step of j at a time
    float yacc[4][4] = {};
    const float cum_r[2] = {cum[r0], cum[r0 + 8]};
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      if (ks > rb) break;  // W is zero right of the diagonal block
      uint32_t whi[4], wlo[4];
#pragma unroll
      for (int q = 0; q < 2; ++q) {  // n-tile 2 ks + q gives A registers q * 2 + half
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = r0 + 8 * half, j = 16 * ks + 8 * q + 2 * tig;
          float w[2];
#pragma unroll
          for (int c = 0; c < 2; ++c)
            w[c] = j + c <= i
                       ? cb[2 * ks + q][2 * half + c] * __expf(cum_r[half] - cum[j + c]) * dts[j + c]
                       : 0.f;
          split_pair(w[0], w[1], whi[2 * q + half], wlo[2 * q + half]);
        }
      }
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t bf[4];
        ldsm4<true>(bf, xs + (16 * ks + a_row(lane)) * XS + 32 * ch + 16 * np + a_col(lane));
        mma_bf16(yacc[2 * np], whi, bf[0], bf[1]);
        mma_bf16(yacc[2 * np], wlo, bf[0], bf[1]);
        mma_bf16(yacc[2 * np + 1], whi, bf[2], bf[3]);
        mma_bf16(yacc[2 * np + 1], wlo, bf[2], bf[3]);
      }
    }

    // 4. S_c = (x w)^T B: state rows hr + ..., columns hc + 8 nt + ...; the
    //    A fragments are x's, scaled by w_j and split as they are loaded
    float sacc[8][4] = {};
#pragma unroll
    for (int ks = 0; ks < L / 16; ++ks) {
      uint32_t xr[4], ahi[4], alo[4];
      ldsm4<true>(xr, xs + (16 * ks + b_row(lane)) * XS + hr + b_col(lane));
      const int tk = 16 * ks + 2 * tig;
      scale_split(xr[0], wj[tk], wj[tk + 1], ahi[0], alo[0]);
      scale_split(xr[1], wj[tk], wj[tk + 1], ahi[1], alo[1]);
      scale_split(xr[2], wj[tk + 8], wj[tk + 9], ahi[2], alo[2]);
      scale_split(xr[3], wj[tk + 8], wj[tk + 9], ahi[3], alo[3]);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (hc + 16 * np >= 16 * ksteps) continue;  // state dims past ds stay zero
        uint32_t bf[4];
        ldsm4<true>(bf, bs + (16 * ks + a_row(lane)) * CS + hc + 16 * np + a_col(lane));
        mma_bf16(sacc[2 * np], ahi, bf[0], bf[1]);
        mma_bf16(sacc[2 * np], alo, bf[0], bf[1]);
        mma_bf16(sacc[2 * np + 1], ahi, bf[2], bf[3]);
        mma_bf16(sacc[2 * np + 1], alo, bf[2], bf[3]);
      }
    }

    // 5. the carry, warp by warp: wait for the same warp of chunk c - 1,
    //    load its part of the end state (every load in flight at once),
    //    h_c = d_c h_{c-1} + S_c, publish; the start state goes to shared
    //    memory for step 6
    if (lane == 0) wait_carry(a, it, warp);
    __syncwarp();
    {
      const float decay = expf(cum[L - 1]);
      const int at = warp * 16 * 64 + 2 * lane;  // this thread's first pair in a ring slot
      const float* in = it.c > 0 ? ring_slot(a, it.c - 1, it.u) + at : nullptr;
      float* out = it.c < a.nc - 1 ? ring_slot(a, it.c, it.u) + at : nullptr;
      const float* h0r = h0_rows(a, it);
      float* hTr = hT_rows(a, it);
#pragma unroll
      for (int part = 0; part < 2; ++part) {  // 8 pairs in flight at a time
        float2 hp[8];
#pragma unroll
        for (int q = 0; q < 8; ++q) {  // pair j = 8 part + q: n-tile j / 2, rows + 8 (j % 2)
          const int j = 8 * part + q;
          const int d = hr + gid + 8 * (j & 1), kk = hc + 8 * (j >> 1) + 2 * tig;
          if (in != nullptr)
            hp[q] = __ldcg(reinterpret_cast<const float2*>(in + j * 64));
          else if (h0r != nullptr && d < nd && kk < ds)  // h0: any alignment
            hp[q] = make_float2(h0r[d * ds + kk], h0r[d * ds + kk + 1]);
          else
            hp[q] = make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int j = 8 * part + q, nt = j >> 1, half = j & 1;
          const int d = hr + gid + 8 * half, kk = hc + 8 * nt + 2 * tig;
          const float2 hv = make_float2(decay * hp[q].x + sacc[nt][2 * half],
                                        decay * hp[q].y + sacc[nt][2 * half + 1]);
          if (out != nullptr)
            *reinterpret_cast<float2*>(out + j * 64) = hv;
          else if (d < nd && kk < ds)
            *reinterpret_cast<float2*>(hTr + d * ds + kk) = hv;
          *reinterpret_cast<float2*>(hf + d * HFP + kk) = hp[q];
        }
      }
    }
    __syncwarp();
    if (lane == 0) publish_ready(a, it, warp);
    __syncthreads();  // every warp's part of the start state is in

    // 6. y += exp(cum_i) C h_{c-1}, the tiles of step 3 (the state's B
    //    fragments split as they are read)
    float inter[4][4] = {};
    for (int ks = 0; ks < ksteps; ++ks) {
      uint32_t af[4];
      ldsm4<false>(af, cs + (16 * rb + a_row(lane)) * CS + 16 * ks + a_col(lane));
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* hrow = hf + (32 * ch + 8 * nt + gid) * HFP + 16 * ks + 2 * tig;
        const float2 v0 = *reinterpret_cast<const float2*>(hrow);
        const float2 v1 = *reinterpret_cast<const float2*>(hrow + 8);
        uint32_t hi[2], lo[2];
        split_pair(v0.x, v0.y, hi[0], lo[0]);
        split_pair(v1.x, v1.y, hi[1], lo[1]);
        mma_bf16(inter[nt], af, hi[0], hi[1]);
        mma_bf16(inter[nt], af, lo[0], lo[1]);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = r0 + 8 * half;
      if (i >= n) continue;
      const float decay_i = __expf(cum_r[half]);
      __nv_bfloat16* yrow = yg + (((long long)it.b * a.seq + it.t0 + i) * a.nh + h) * a.hd + it.d0;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int d = 32 * ch + 8 * nt + 2 * tig;
        if (d < nd)
          *reinterpret_cast<__nv_bfloat162*>(yrow + d) = __floats2bfloat162_rn(
              yacc[nt][2 * half] + decay_i * inter[nt][2 * half],
              yacc[nt][2 * half + 1] + decay_i * inter[nt][2 * half + 1]);
      }
    }
    __syncthreads();  // the next item restages every operand
    // the slot this item read may be written again (its fence overlaps the
    // next item's copies)
    if (tid == 0) publish_consumed(a, it);
    t = t_next;
  }
  finish_call(a);
}

cudaError_t launch(const Args& a, int dtype, int grid, cudaStream_t stream) {
  if (dtype == 1) {
    static bool opted_in = false;
    const cudaError_t err = opt_in_smem(ssd_chunk_scan_mma_kernel, mma_smem_bytes(), opted_in);
    if (err != cudaSuccess) return err;
    ssd_chunk_scan_mma_kernel<<<grid, NT, mma_smem_bytes(), stream>>>(a);
  } else {
    static bool opted_in = false;
    const cudaError_t err = opt_in_smem(ssd_chunk_scan_f32_kernel, f32_smem_bytes(DS_MAX),
                                        opted_in);  // once, for the largest state
    if (err != cudaSuccess) return err;
    ssd_chunk_scan_f32_kernel<<<grid, NT, f32_smem_bytes(a.ds), stream>>>(a);
  }
  return cudaGetLastError();
}

bool valid_shape(int batch, int seq, int nh, int hd, int groups, int ds, int dtype, int sms) {
  if (batch < 1 || seq < 1 || nh < 1 || hd < 1 || groups < 1 || nh % groups || ds < 1 ||
      ds > DS_MAX || sms < 1 || (dtype != 0 && dtype != 1))
    return false;
  const Schedule s = schedule(batch, seq, nh, groups, hd, ds, dtype, sms);
  return s.n_items < (1LL << 31) - NT * sms && s.nc < (1 << 30);
}

}  // namespace

// The schedule of one call on a card of `sms` SMs, as `schedule` makes it:
// out = {grid, hd columns an item, items a chunk, ring slots, chunks, scratch
// bytes}. Returns the cudaError_t (0 = success).
extern "C" int ssd_chunk_scan_scratch_layout(int batch, int seq, int nh, int hd, int groups, int ds,
                                             int dtype, int sms, long long* out) {
  if (!valid_shape(batch, seq, nh, hd, groups, ds, dtype, sms)) return int(cudaErrorInvalidValue);
  const Schedule s = schedule(batch, seq, nh, groups, hd, ds, dtype, sms);
  const long long v[6] = {s.grid, s.hs, s.ipc, s.ring, s.nc, s.total};
  for (int i = 0; i < 6; ++i) out[i] = v[i];
  return 0;
}

// x: (B, S, nh, hd) with element strides x_sb, x_ss, x_sh; B and C: (B, S, G,
// ds) sharing strides bc_sb, bc_ss, bc_sg; last axes contiguous. dt: (B, S,
// nh) fp32, strides dt_sb, dt_ss, dt_sh. A: (nh,) fp32. h0 (or null) and hT:
// (B, nh, hd, ds) fp32 contiguous, not aliased. y: (B, S, nh, hd) contiguous.
// scratch: at least the layout's bytes, made zero but for its epoch word
// (the third u32), which is 1, then left to the kernel, and used by one
// stream only: the calls that share it run one at a time. dtype: 0 =
// float32, 1 = bfloat16 (x, B, C and y). One launch.
// Returns the cudaError_t of the launch (0 = success).
extern "C" int ssd_chunk_scan_launch(const void* x, const void* dt, const void* A, const void* bm,
                                     const void* cm, const void* h0, void* y, void* hT, int batch,
                                     int seq, int nh, int hd, int groups, int ds, long long x_sb,
                                     long long x_ss, long long x_sh, long long bc_sb,
                                     long long bc_ss, long long bc_sg, long long dt_sb,
                                     long long dt_ss, long long dt_sh, void* scratch,
                                     long long scratch_bytes, int sms, int dtype, void* stream) {
  if (!valid_shape(batch, seq, nh, hd, groups, ds, dtype, sms)) return int(cudaErrorInvalidValue);
  const Schedule s = schedule(batch, seq, nh, groups, hd, ds, dtype, sms);
  if (scratch == nullptr || scratch_bytes < s.total ||
      reinterpret_cast<uintptr_t>(scratch) % 16)
    return int(cudaErrorInvalidValue);
  if (dtype == 1) {
    // the 16-byte staging copies need 8-element multiples and 16-byte bases
    const auto al = [](const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; };
    if (ds % 8 || hd % 8 || x_sb % 8 || x_ss % 8 || x_sh % 8 || bc_sb % 8 || bc_ss % 8 ||
        bc_sg % 8 || !al(x) || !al(bm) || !al(cm))
      return int(cudaErrorInvalidValue);
  }
  unsigned char* base = static_cast<unsigned char*>(scratch);
  Args a;
  a.x = x;
  a.dt = static_cast<const float*>(dt);
  a.A = static_cast<const float*>(A);
  a.bm = bm;
  a.cm = cm;
  a.h0 = static_cast<const float*>(h0);
  a.y = y;
  a.hT = static_cast<float*>(hT);
  a.batch = batch;
  a.seq = seq;
  a.nh = nh;
  a.hd = hd;
  a.rep = nh / groups;
  a.ds = ds;
  a.x_sb = x_sb;
  a.x_ss = x_ss;
  a.x_sh = x_sh;
  a.bc_sb = bc_sb;
  a.bc_ss = bc_ss;
  a.bc_sg = bc_sg;
  a.dt_sb = dt_sb;
  a.dt_ss = dt_ss;
  a.dt_sh = dt_sh;
  a.nc = s.nc;
  a.hs = s.hs;
  a.slices = s.slices;
  a.ipc = s.ipc;
  a.ring = s.ring;
  a.n_items = int(s.n_items);
  a.scratch_bytes = scratch_bytes;
  a.counters = reinterpret_cast<unsigned*>(base);
  a.ready = reinterpret_cast<unsigned long long*>(base + s.ready);
  a.consumed = reinterpret_cast<unsigned long long*>(base + s.consumed);
  a.states = reinterpret_cast<float*>(base + s.states);
  return int(launch(a, dtype, s.grid, static_cast<cudaStream_t>(stream)));
}

extern "C" const char* ssd_chunk_scan_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
