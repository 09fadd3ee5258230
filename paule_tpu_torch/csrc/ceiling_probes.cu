// Ceiling probes of the LSTM recurrence for Hopper (sm_90a): B1's function
// (the forward recurrence) and B2's (the reverse recurrence) in two layouts
// each, the counterparts of the Pallas probes in
// tools/kernel_ceiling_probes.py.
//
//   paule_probe_fwd_wide    replaces run_fwd + fwd_kernel_wide   (:79, :12)
//   paule_probe_fwd_split   replaces run_fwd + fwd_kernel_split  (:79, :44)
//   paule_probe_bwd_wide    replaces run_bwd + bwd_kernel_wide   (:219, :111)
//   paule_probe_bwd_split   replaces run_bwd + bwd_kernel_split  (:219, :162)
//
// The TPU probes compare one matrix product over all 4H gate columns per
// step ("wide") against four per-gate products ("split").  On this card a
// step's product is spread over every SM, so the layouts differ in what
// crosses the grid between steps, and that is what the probes measure:
//
//   probe        exchanged per step   recomputed by every block
//   fwd_wide     pre_t (B, 4H)        the cell step of all B x H units
//   fwd_split    h_t (B, H)           -
//   bwd_wide     dh (B, H)            the gate gradients of all B x H units
//   bwd_split    dgates_t (B, 4H)     -   (B2's owner layout)
//
// * fwd_wide: a block owns `cols` gate columns (22 at H=720 on 132 SMs),
//   two a warp, and forms pre_t = gx_t + h_{t-1} @ W_hh for them.  After
//   the barrier every block copies all of pre_t and runs the cell step of
//   every unit, keeping c and h of all units in its shared memory; only the
//   unit's owner (block u % gridDim.x) writes hs and cs.
// * fwd_split: B1's layout.  A block owns `units` hidden units, a warp each,
//   forms their four gate products and runs their cell step; it copies h_t.
// * bwd_wide: a block owns `units` rows of W_hh (the units of dh it
//   produces).  After the barrier every block copies dh_rec_t and, a thread
//   per unit, computes the four gate gradients of every unit and row from
//   the step's own inputs (acts_t, copied into shared memory during the
//   barrier, and cs_prev_t, ghs_t, loaded into registers during it) and the
//   cell-gradient carry of all units, which it keeps in shared memory; it
//   uses each gradient at once in its rows' products, dh_rec_{t-1}[b, k] =
//   W_hh[k, :] . dgates_t[b, :], so no dgates row is staged.  A block's
//   partial products meet in a fixed order (warp reduce-scatter, then the
//   warps in order through shared memory).  The unit's owner writes dgates
//   and dc0; step 0's products are dh0, so no barrier follows it.
// * bwd_split: B2's layout.  A block owns `units` units, a warp each, whose
//   recurrent cotangent is a dot of its W_hh row with each staged dgates_{t+1}
//   row; it copies dgates_{t+1}, and one more barrier after step 0 gives
//   dh0 = dgates_0 . W_hh^T.
//
// What bounds them: each step is a matrix-vector product of B*H*4H
// multiply-adds inside a sequential dependency, so the latency of one step,
// T times over, bounds them, not bytes or FLOPs.  The design:
// * One persistent cooperative launch per call (cudaLaunchCooperativeKernel
//   after an occupancy check, so that every block is co-resident; a grid
//   that cannot be returns cudaErrorCooperativeLaunchTooLarge), looping over
//   time inside the kernel.  Earlier each probe launched once per step and
//   the kernel boundary was the grid barrier: 10.6-19.7 us per step at
//   (1024, 1) on an H100, launch latency and not the layout.
// * Each block's share of W_hh stays in (opt-in, dynamic) shared memory for
//   the whole sequence: 63 KB (fwd_wide) or 69 KB (the others) at H=720.
// * A split arrive/wait grid barrier in place of cooperative_groups' grid
//   sync: thread 0 arrives with red.release.gpu on a counter, the block
//   then issues the next step's own inputs (which do not depend on the
//   exchange), and thread 0 waits with an ld.acquire.gpu spin while the
//   rest of warp 0 waits for it (warp0_load) and the other warps wait for
//   the exchanged data.  The counter
//   is cooperative_groups' scheme: per barrier block 0 adds 2^31 - (n - 1)
//   and every other block 1, so bit 31 flips once all n have arrived and the
//   low bits return to 0; the counter (one per device, from the wrapper)
//   is therefore ready for the next launch without a reset.
// * The exchanged vector is brought into shared memory by one thread's bulk
//   asynchronous copy (cp.async.bulk, completing on an mbarrier that every
//   thread waits on), not by every thread's loads.  Data that other blocks
//   wrote with ordinary stores and published by the release is acquired by
//   thread 0, which then fences to the async proxy (fence.proxy.async.global)
//   before the copy reads it.  Nothing written during the launch is read
//   through L1.
// * Bit-identical recomputation: the cell step and the gate gradients that
//   every block recomputes run one code path on the same bits in every
//   block; all sums run in a fixed order, with no atomics, so runs are
//   bit-reproducible.
// * Spins (the grid barrier, an mbarrier) trap after 10 s instead of
//   hanging the card.
// The launch plan (blocks, columns or units per block, rows per pass, row
// chunk, dynamic shared bytes) comes from the Python wrapper
// (tools/kernel_ceiling_probes.py: probe_plan); the kernels allocate
// nothing.  Each entry point launches on the given stream and returns the
// CUDA error of its launch.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarp = 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxUnits = 8;                   // units a block owns
constexpr int kWideWarps = 12;                 // warps of a wide-form block
constexpr int kWideThreads = kWideWarps * kWarp;
constexpr int kMaxCols = 2 * kWideWarps;       // fwd_wide: two columns a warp
constexpr int kUnitsPerThread = 2;             // bwd_wide: H <= 2 * 384
constexpr int kMaxThreads = kWideThreads;      // every kernel's launch bound
constexpr unsigned kPiece = 32768;             // bytes per bulk copy
constexpr unsigned long long kTimeoutNs = 10000000000ull;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ------------------------------------------------------- warp reductions
// One reduce-scatter stage at xor distance OFF over the 2 * half values
// still held: the lanes with bit OFF set keep the upper half, the others the
// lower, each adding its partner's copy.
template <int N, int OFF>
__device__ __forceinline__ void scatter_stage(float (&v)[N], int lane) {
  constexpr int half = N / kWarp * OFF;
  const bool upper = lane & OFF;
#pragma unroll
  for (int i = 0; i < half; ++i) {
    const float send = upper ? v[i] : v[i + half];
    const float keep = upper ? v[i + half] : v[i];
    v[i] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
  if constexpr (OFF > 1) scatter_stage<N, OFF / 2>(v, lane);
}

// Warp sums of N per-lane values.  N >= 32 (a multiple of 32):
// reduce-scatter, after which v[0 : N/32) of lane L hold the sums of values
// N/32 * L + j.  N < 32: the butterfly, every lane ends with every sum.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N], int lane) {
  if constexpr (N >= kWarp) {
    static_assert(N % kWarp == 0, "reduce-scatter of a multiple of 32");
    scatter_stage<N, kWarp / 2>(v, lane);
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i)
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        v[i] += __shfl_xor_sync(kFull, v[i], off);
  }
}

// After warp_sums<4R> of acc[q * R + r]: the sum of gate q for row r = lane
// (lanes >= R get an unused value).
template <int R>
__device__ __forceinline__ float gate_sum(const float (&acc)[4 * R], int q,
                                          int lane) {
  constexpr int N = 4 * R;
  float out = 0.0f;
  if constexpr (N >= kWarp) {
    constexpr int S = N / kWarp;
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float got = __shfl_sync(kFull, acc[s], q * (R / S) + lane / S);
      if (lane % S == s) out = got;
    }
  } else {
#pragma unroll
    for (int i = 0; i < R; ++i)
      if (i == lane) out = acc[q * R + i];
  }
  return out;
}

// v[i] for a runtime i < N, by a branch-free select (0 for i >= N).
template <int N>
__device__ __forceinline__ float pick(const float (&v)[N], int i) {
  float out = 0.0f;
#pragma unroll
  for (int j = 0; j < N; ++j)
    if (j == i) out = v[j];
  return out;
}

__device__ __forceinline__ float dot4(float a, float4 w, float4 x) {
  a += w.x * x.x;
  a += w.y * x.y;
  a += w.z * x.z;
  a += w.w * x.w;
  return a;
}

// ------------------------------------------- grid barrier, bulk copies
__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

// Split grid barrier; only thread 0 of a block touches the counter.
struct GridBarrier {
  unsigned* count;
  unsigned add;     // 2^31 - (n - 1) for block 0, else 1
  unsigned phase;   // bit 31 of the counter before this barrier's arrivals
};

// Bit 31 cannot flip before this block has arrived, so thread 0 may read
// the phase at the start while other blocks already arrive.
__device__ __forceinline__ GridBarrier grid_barrier(unsigned* count) {
  GridBarrier g;
  g.count = count;
  g.add = blockIdx.x == 0 ? 0x80000000u - (gridDim.x - 1) : 1u;
  g.phase = threadIdx.x == 0 ? ld_acquire(count) & 0x80000000u : 0u;
  return g;
}

// The block's stores of this step, then thread 0's release.
__device__ __forceinline__ void grid_arrive(const GridBarrier& g) {
  __syncthreads();
  if (threadIdx.x == 0)
    asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(g.count),
                 "r"(g.add)
                 : "memory");
}

// Thread 0: until every block has arrived.
__device__ __forceinline__ void grid_spin(GridBarrier& g) {
  if (((ld_acquire(g.count) ^ g.phase) & 0x80000000u) == 0) {
    const unsigned long long t0 = global_ns();
    while (((ld_acquire(g.count) ^ g.phase) & 0x80000000u) == 0)
      if (global_ns() - t0 > kTimeoutNs) __trap();
  }
  g.phase ^= 0x80000000u;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// Thread 0: what this thread acquired (other blocks' stores) and what the
// block's threads wrote or read in shared memory, ordered before the async
// proxy's next copy.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.global;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Thread 0: `bytes` (a multiple of 16, both addresses 16-byte aligned) from
// global to shared memory, in pieces, completing on `bar`.
__device__ __forceinline__ void bulk_load(float* dst, const float* src,
                                          unsigned bytes, uint64_t* bar) {
  const unsigned b = smem_u32(bar);
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   b),
               "r"(bytes)
               : "memory");
  const unsigned d = smem_u32(dst);
  const char* s = reinterpret_cast<const char*>(src);
  for (unsigned off = 0; off < bytes; off += kPiece) {
    const unsigned n = min(kPiece, bytes - off);
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
        "[%0], [%1], %2, [%3];" ::"r"(d + off),
        "l"(s + off), "r"(n), "r"(b)
        : "memory");
  }
}

__device__ __forceinline__ bool mbar_try(unsigned b, unsigned parity) {
  unsigned done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done)
      : "r"(b), "r"(parity)
      : "memory");
  return done;
}

// Warp 0: thread 0 issues a bulk copy (after grid_spin, when `spin`), and the
// warp's other lanes wait for it here.  Were they to go on to mbar_wait, a
// wait that may suspend the warp, thread 0's spin and issue would stall
// until the suspension ends (on an H100, fwd_split at B=1 took 4.9 us per
// step so, 2.8 with this reconvergence; PERF.md).  Other warps return at
// once and wait on `bar`.
__device__ __forceinline__ void warp0_load(GridBarrier* spin, float* dst,
                                           const float* src, unsigned bytes,
                                           uint64_t* bar) {
  if (threadIdx.x >= kWarp) return;
  if (threadIdx.x == 0) {
    if (spin) grid_spin(*spin);
    fence_async();
    bulk_load(dst, src, bytes, bar);
  }
  __syncwarp();
}

// Every thread: until the phase `parity` of `bar` has completed; flips it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned& parity) {
  const unsigned b = smem_u32(bar);
  if (!mbar_try(b, parity)) {
    const unsigned long long t0 = global_ns();
    while (!mbar_try(b, parity))
      if (global_ns() - t0 > kTimeoutNs) __trap();
  }
  parity ^= 1u;
}

// ------------------------------------------------------------ P1 wide
// Dynamic shared memory: bar (8 B, padded to 16), w_s (cols rows of H:
// W_hh column col0 + j as row j, zero past 4H), pre_s (B x 4H), c_s (B x H),
// h_s (R x H, rows >= B zero).  Warp w owns columns col0 + w and col0 + w +
// kWideWarps; after warp_sums<32> lane L holds the sum of value L = m * R +
// r (column m, row r) and writes pre for it.
template <int R>
__global__ void __launch_bounds__(kWideThreads, 1)
probe_fwd_wide(int T, int B, int H, int cols, const float* __restrict__ gx,
               const float* __restrict__ w, const float* __restrict__ h0,
               const float* __restrict__ c0, float* pre, float* hs, float* cs,
               unsigned* bar_count) {
  static_assert(2 * R <= kWarp, "a lane per (column, row)");
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  const int G = 4 * H;
  float* w_s = reinterpret_cast<float*>(smem4) + 4;
  float* pre_s = w_s + (size_t)cols * H;
  float* c_s = pre_s + (size_t)B * G;
  float* h_s = c_s + (size_t)B * H;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int col0 = blockIdx.x * cols;
  for (int i = tid; i < cols * H; i += blockDim.x) {
    const int k = i / cols, j = i - k * cols;
    const int col = col0 + j;
    w_s[(size_t)j * H + k] = col < G ? w[(size_t)k * G + col] : 0.0f;
  }
  for (int i = tid; i < B * H; i += blockDim.x) c_s[i] = c0[i];
  for (int i = tid; i < R * H; i += blockDim.x)
    h_s[i] = i < B * H ? h0[i] : 0.0f;
  if (tid == 0) {
    mbar_init(bar);
    fence_mbar_init();
  }
  GridBarrier g = grid_barrier(bar_count);
  unsigned parity = 0;
  const size_t BH = (size_t)B * H, BG = (size_t)B * G;
  // the lane's output: column m, row r
  const int m = lane / R, r = lane % R;
  const int j_out = warp + m * kWideWarps;
  const int col_out = col0 + j_out;
  const bool writes = lane < 2 * R && r < B && j_out < cols && col_out < G;
  const bool has[2] = {warp < cols, warp + kWideWarps < cols};
  float g_next = writes ? gx[(size_t)r * G + col_out] : 0.0f;
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    float acc[kWarp];
#pragma unroll
    for (int i = 0; i < kWarp; ++i) acc[i] = 0.0f;
    for (int k = 4 * lane; k < H; k += 4 * kWarp) {
      float4 wv[2];
#pragma unroll
      for (int mm = 0; mm < 2; ++mm)
        wv[mm] = has[mm] ? *reinterpret_cast<const float4*>(
                               w_s + (size_t)(warp + mm * kWideWarps) * H + k)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float4 xv =
            *reinterpret_cast<const float4*>(h_s + (size_t)rr * H + k);
#pragma unroll
        for (int mm = 0; mm < 2; ++mm)
          acc[mm * R + rr] = dot4(acc[mm * R + rr], wv[mm], xv);
      }
    }
    warp_sums<kWarp>(acc, lane);
    if (writes) pre[(t & 1) * BG + (size_t)r * G + col_out] = acc[0] + g_next;
    grid_arrive(g);
    if (writes && t + 1 < T)
      g_next = gx[(size_t)(t + 1) * BG + (size_t)r * G + col_out];
    warp0_load(&g, pre_s, pre + (t & 1) * BG,
               (unsigned)(BG * sizeof(float)), bar);
    mbar_wait(bar, parity);
    for (int i = tid; i < B * H; i += blockDim.x) {
      const int b = i / H, u = i - b * H;
      const float* p = pre_s + (size_t)b * G + u;
      const float gi = sigmoid_f(p[0]);
      const float gf = sigmoid_f(p[H]);
      const float gg = tanhf(p[2 * H]);
      const float go = sigmoid_f(p[3 * H]);
      const float c = gf * c_s[i] + gi * gg;
      const float h = go * tanhf(c);
      c_s[i] = c;
      h_s[i] = h;
      if (u % gridDim.x == blockIdx.x) {
        hs[t * BH + i] = h;
        cs[t * BH + i] = c;
      }
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ P1 split
// B1's layout.  Dynamic shared memory: bar, w_s (units x 4 rows of H: W_hh
// column qH + u0 + j as row 4j + q), x_s (chunk rounded up to R rows of H:
// staged h_{t-1}), c_s (units x B).  Warp j owns unit u0 + j.
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
probe_fwd_split(int T, int B, int H, int units, int chunk,
                const float* __restrict__ gx, const float* __restrict__ w,
                const float* h0, const float* __restrict__ c0, float* hs,
                float* cs, unsigned* bar_count) {
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  const int G = 4 * H;
  const int x_rows = (chunk + R - 1) / R * R;
  float* w_s = reinterpret_cast<float*>(smem4) + 4;
  float* x_s = w_s + (size_t)units * 4 * H;
  float* c_s = x_s + (size_t)x_rows * H;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int u0 = blockIdx.x * units, u = u0 + warp;
  for (int row = warp; row < 4 * units; row += n_warps) {
    const int uj = u0 + row / 4, q = row % 4;
    for (int k = lane; k < H; k += kWarp)
      w_s[(size_t)row * H + k] = uj < H ? w[(size_t)k * G + q * H + uj] : 0.0f;
  }
  for (int i = tid; i < x_rows * H; i += blockDim.x) x_s[i] = 0.0f;
  for (int i = tid; i < units * B; i += blockDim.x) {
    const int j = i / B, b = i % B;
    c_s[i] = u0 + j < H ? c0[(size_t)b * H + u0 + j] : 0.0f;
  }
  if (tid == 0) {
    mbar_init(bar);
    fence_mbar_init();
  }
  GridBarrier g = grid_barrier(bar_count);
  unsigned parity = 0;
  const size_t BH = (size_t)B * H, BG = (size_t)B * G;
  // the first pass's input gates of the next step, lane r < first rows
  const int first = min(R, min(chunk, B));
  float g_next[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  if (u < H && lane < first)
#pragma unroll
    for (int q = 0; q < 4; ++q) g_next[q] = gx[(size_t)lane * G + q * H + u];
  __syncthreads();
  warp0_load(nullptr, x_s, h0, (unsigned)(min(chunk, B) * H * sizeof(float)),
             bar);
  for (int t = 0; t < T; ++t) {
    const float* hp = t ? hs + (t - 1) * BH : h0;
    for (int b0 = 0; b0 < B; b0 += chunk) {
      const int n = min(chunk, B - b0);
      if (b0 > 0) {
        __syncthreads();                 // the last chunk's reads are done
        warp0_load(nullptr, x_s, hp + (size_t)b0 * H,
                   (unsigned)(n * H * sizeof(float)), bar);
      }
      mbar_wait(bar, parity);
      if (u >= H) continue;
      const float* wu = w_s + (size_t)warp * 4 * H;
      for (int p0 = 0; p0 < n; p0 += R) {
        const int nr = min(R, n - p0);
        const float* xp = x_s + (size_t)p0 * H;
        float base[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        if (lane < nr) {
#pragma unroll
          for (int q = 0; q < 4; ++q)
            base[q] = b0 == 0 && p0 == 0
                          ? g_next[q]
                          : gx[t * BG + (size_t)(b0 + p0 + lane) * G + q * H +
                               u];
        }
        float acc[4 * R];
#pragma unroll
        for (int i = 0; i < 4 * R; ++i) acc[i] = 0.0f;
        for (int k = 4 * lane; k < H; k += 4 * kWarp) {
          float4 wv[4];
#pragma unroll
          for (int q = 0; q < 4; ++q)
            wv[q] = *reinterpret_cast<const float4*>(wu + (size_t)q * H + k);
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {
            const float4 xv =
                *reinterpret_cast<const float4*>(xp + (size_t)rr * H + k);
#pragma unroll
            for (int q = 0; q < 4; ++q)
              acc[q * R + rr] = dot4(acc[q * R + rr], wv[q], xv);
          }
        }
        warp_sums<4 * R>(acc, lane);
        float a[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) a[q] = gate_sum<R>(acc, q, lane) + base[q];
        if (lane < nr) {
          const int b = b0 + p0 + lane;
          const float gi = sigmoid_f(a[0]);
          const float gf = sigmoid_f(a[1]);
          const float gg = tanhf(a[2]);
          const float go = sigmoid_f(a[3]);
          const float c = gf * c_s[warp * B + b] + gi * gg;
          c_s[warp * B + b] = c;
          const size_t i = (size_t)b * H + u;
          cs[t * BH + i] = c;
          hs[t * BH + i] = go * tanhf(c);
        }
      }
    }
    if (t + 1 < T) {
      grid_arrive(g);
      if (u < H && lane < first)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          g_next[q] = gx[(t + 1) * BG + (size_t)lane * G + q * H + u];
      warp0_load(&g, x_s, hs + t * BH,
                 (unsigned)(min(chunk, B) * H * sizeof(float)), bar);
    }
  }
}

// One reverse cell step (B2's arithmetic): in = (activated gates i, f, g, o,
// previous cell state), dh the hidden cotangent, dc_in the carry from the
// step after; the four gate gradients to d[0..3]; returns the carry for the
// step before.
__device__ __forceinline__ float cell_bwd(const float (&in)[5], float dh,
                                          float dc_in, float (&d)[4]) {
  const float gi = in[0], gf = in[1], gg = in[2], go = in[3], cp = in[4];
  const float tc = tanhf(gf * cp + gi * gg);
  const float d_o = dh * tc;
  const float dc = dc_in + dh * go * (1.0f - tc * tc);
  d[0] = dc * gg * gi * (1.0f - gi);
  d[1] = dc * cp * gf * (1.0f - gf);
  d[2] = dc * gi * (1.0f - gg * gg);
  d[3] = d_o * go * (1.0f - go);
  return dc * gf;
}

// ------------------------------------------------------------ P2 wide
// Dynamic shared memory: bars[2] (0: the exchanged dh, 1: acts), w_s (units
// x 4H: W_hh rows u0 .. u0 + units), a_s (B x 4H: acts_t), dh_s (B x H:
// dh_rec_t), dc_s (B x H: the carries of all units), red_s (kWideWarps x
// 8R: the warps' partial products).  Thread i takes units i and i + 384;
// value k * R + r of its partial products is W_hh[u0 + k, :] . dgates_t[r,
// :] over its units.
template <int R>
__global__ void __launch_bounds__(kWideThreads, 1)
probe_bwd_wide(int T, int B, int H, int units,
               const float* __restrict__ acts,
               const float* __restrict__ cs_prev,
               const float* __restrict__ ghs, const float* __restrict__ w,
               float* dh_buf, float* __restrict__ dgates,
               float* __restrict__ dh0, float* __restrict__ dc0,
               unsigned* bar_count) {
  constexpr int N = kMaxUnits * R;
  extern __shared__ float4 smem4[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem4);
  const int G = 4 * H;
  float* w_s = reinterpret_cast<float*>(smem4) + 4;
  float* a_s = w_s + (size_t)units * G;
  float* dh_s = a_s + (size_t)B * G;
  float* dc_s = dh_s + (size_t)B * H;
  float* red_s = dc_s + (size_t)B * H;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int u0 = blockIdx.x * units;
  const size_t BH = (size_t)B * H, BG = (size_t)B * G;
  for (int i = tid; i < units * G / 4; i += blockDim.x) {
    const int k = i / (G / 4);
    reinterpret_cast<float4*>(w_s)[i] =
        u0 + k < H ? reinterpret_cast<const float4*>(w + (size_t)u0 * G)[i]
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int i = tid; i < B * H; i += blockDim.x) dc_s[i] = 0.0f;
  if (tid == 0) {
    mbar_init(&bars[0]);
    mbar_init(&bars[1]);
    fence_mbar_init();
  }
  GridBarrier g = grid_barrier(bar_count);
  unsigned par_x = 0, par_a = 0;
  __syncthreads();
  warp0_load(nullptr, a_s, acts + (T - 1) * BG,
             (unsigned)(BG * sizeof(float)), &bars[1]);
  // the step's cs_prev and ghs of the thread's units, loaded ahead
  float cp_r[kUnitsPerThread][R], gh_r[kUnitsPerThread][R];
  auto load_inputs = [&](int t) {
#pragma unroll
    for (int j = 0; j < kUnitsPerThread; ++j) {
      const int u = tid + j * kWideThreads;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const bool in = u < H && r < B;
        const size_t i = t * BH + (size_t)r * H + u;
        cp_r[j][r] = in ? cs_prev[i] : 0.0f;
        gh_r[j][r] = in ? ghs[i] : 0.0f;
      }
    }
  };
  load_inputs(T - 1);
  for (int t = T - 1; t >= 0; --t) {
    const bool rec = t + 1 < T;          // a cotangent from step t + 1
    mbar_wait(&bars[1], par_a);
    if (rec) mbar_wait(&bars[0], par_x);
    float acc[N];
#pragma unroll
    for (int i = 0; i < N; ++i) acc[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < kUnitsPerThread; ++j) {
      const int u = tid + j * kWideThreads;
      if (u >= H) continue;
      const bool owner = u % gridDim.x == blockIdx.x;
      // the unit's column of the block's W_hh rows, held for all rows (in
      // registers: the stores to dc_s below would make the compiler reload
      // them from shared memory per row)
      float wr[kMaxUnits][4];
#pragma unroll
      for (int k = 0; k < kMaxUnits; ++k)
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wr[k][q] = k < units ? w_s[(size_t)k * G + q * H + u] : 0.0f;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        if (r >= B) continue;
        const float* a = a_s + (size_t)r * G + u;
        const float in[5] = {a[0], a[H], a[2 * H], a[3 * H], cp_r[j][r]};
        const int i = r * H + u;
        const float dh = gh_r[j][r] + (rec ? dh_s[i] : 0.0f);
        float d[4];
        const float carry = cell_bwd(in, dh, dc_s[i], d);
        dc_s[i] = carry;
        if (owner) {
          float* o = dgates + t * BG + (size_t)r * G + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) o[q * H] = d[q];
          if (t == 0) dc0[i] = carry;
        }
#pragma unroll
        for (int k = 0; k < kMaxUnits; ++k) {
          if (k >= units) continue;
          float s = acc[k * R + r];
#pragma unroll
          for (int q = 0; q < 4; ++q) s += wr[k][q] * d[q];
          acc[k * R + r] = s;
        }
      }
    }
    warp_sums<N>(acc, lane);
    if constexpr (N >= kWarp) {
      constexpr int S = N / kWarp;
#pragma unroll
      for (int s = 0; s < S; ++s) red_s[warp * N + S * lane + s] = acc[s];
    } else {
      if (lane < N) red_s[warp * N + lane] = pick<N>(acc, lane);
    }
    __syncthreads();
    if (tid < units * R) {
      const int k = tid / R, r = tid % R;
      if (r < B && u0 + k < H) {
        float s = 0.0f;
        for (int ww = 0; ww < kWideWarps; ++ww) s += red_s[ww * N + tid];
        float* out = t ? dh_buf + (t & 1) * BH : dh0;
        out[(size_t)r * H + u0 + k] = s;
      }
    }
    if (t == 0) break;
    grid_arrive(g);
    warp0_load(nullptr, a_s, acts + (t - 1) * BG,
               (unsigned)(BG * sizeof(float)), &bars[1]);
    load_inputs(t - 1);
    warp0_load(&g, dh_s, dh_buf + (t & 1) * BH,
               (unsigned)(BH * sizeof(float)), &bars[0]);
  }
}

// ------------------------------------------------------------ P2 split
// B2's layout.  Dynamic shared memory: bar, w_s (units x 4H: W_hh rows),
// x_s (chunk rounded up to R rows of 4H: staged dgates_{t+1}), c_s (units x
// B: carries).  Warp j owns unit u0 + j; steps t = T-1 .. 0, then dh0.
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
probe_bwd_split(int T, int B, int H, int units, int chunk,
                const float* __restrict__ acts,
                const float* __restrict__ cs_prev,
                const float* __restrict__ ghs, const float* __restrict__ w,
                float* dgates, float* __restrict__ dh0,
                float* __restrict__ dc0, unsigned* bar_count) {
  extern __shared__ float4 smem4[];
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem4);
  const int G = 4 * H;
  const int x_rows = (chunk + R - 1) / R * R;
  float* w_s = reinterpret_cast<float*>(smem4) + 4;
  float* x_s = w_s + (size_t)units * G;
  float* c_s = x_s + (size_t)x_rows * G;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int u0 = blockIdx.x * units, u = u0 + warp;
  const size_t BH = (size_t)B * H, BG = (size_t)B * G;
  for (int i = tid; i < units * G / 4; i += blockDim.x) {
    const int k = i / (G / 4);
    reinterpret_cast<float4*>(w_s)[i] =
        u0 + k < H ? reinterpret_cast<const float4*>(w + (size_t)u0 * G)[i]
                   : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  for (int i = tid; i < x_rows * G; i += blockDim.x) x_s[i] = 0.0f;
  for (int i = tid; i < units * B; i += blockDim.x) c_s[i] = 0.0f;
  if (tid == 0) {
    mbar_init(bar);
    fence_mbar_init();
  }
  GridBarrier g = grid_barrier(bar_count);
  unsigned parity = 0;
  const float* wu = w_s + (size_t)warp * G;
  // the first pass's inputs of the next step, lane r < first rows
  const int first = min(R, min(chunk, B));
  float nin[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  auto load_inputs = [&](int t) {
    if (u < H && lane < first) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        nin[q] = acts[t * BG + (size_t)lane * G + q * H + u];
      nin[4] = cs_prev[t * BH + (size_t)lane * H + u];
      nin[5] = ghs[t * BH + (size_t)lane * H + u];
    }
  };
  load_inputs(T - 1);
  __syncthreads();
  // dh of rows [b0 + p0, b0 + p0 + R) of unit u against the staged rows
  auto row_dots = [&](float (&acc)[R], int p0) {
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    const float* xp = x_s + (size_t)p0 * G;
    for (int k = 4 * lane; k < G; k += 4 * kWarp) {
      const float4 wv = *reinterpret_cast<const float4*>(wu + k);
#pragma unroll
      for (int r = 0; r < R; ++r)
        acc[r] = dot4(acc[r], wv,
                      *reinterpret_cast<const float4*>(xp + (size_t)r * G + k));
    }
    warp_sums<R>(acc, lane);
  };
  auto stage = [&](GridBarrier* spin, const float* src, int b0, int n) {
    warp0_load(spin, x_s, src + (size_t)b0 * G,
               (unsigned)(n * G * sizeof(float)), bar);
  };
  for (int t = T - 1; t >= 0; --t) {
    const bool rec = t + 1 < T;
    for (int b0 = 0; b0 < B; b0 += chunk) {
      const int n = min(chunk, B - b0);
      if (rec) {
        if (b0 > 0) {
          __syncthreads();
          stage(nullptr, dgates + (t + 1) * BG, b0, n);
        }
        mbar_wait(bar, parity);
      }
      if (u >= H) continue;
      for (int p0 = 0; p0 < n; p0 += R) {
        const int nr = min(R, n - p0);
        const int b = b0 + p0 + lane;
        float in[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
        float gh = 0.0f;
        if (lane < nr) {
          if (b0 == 0 && p0 == 0) {
#pragma unroll
            for (int j = 0; j < 5; ++j) in[j] = nin[j];
            gh = nin[5];
          } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
              in[q] = acts[t * BG + (size_t)b * G + q * H + u];
            in[4] = cs_prev[t * BH + (size_t)b * H + u];
            gh = ghs[t * BH + (size_t)b * H + u];
          }
        }
        float acc[R];
        if (rec) {
          row_dots(acc, p0);
        } else {
#pragma unroll
          for (int r = 0; r < R; ++r) acc[r] = 0.0f;
        }
        const float dh_rec = pick<R>(acc, lane);
        if (lane < nr) {
          float d[4];
          const float carry = cell_bwd(in, gh + dh_rec, c_s[warp * B + b], d);
          c_s[warp * B + b] = carry;
          float* o = dgates + t * BG + (size_t)b * G + u;
#pragma unroll
          for (int q = 0; q < 4; ++q) o[q * H] = d[q];
          if (t == 0) dc0[(size_t)b * H + u] = carry;
        }
      }
    }
    grid_arrive(g);                      // after step 0: dgates_0 complete
    if (t > 0) load_inputs(t - 1);
    stage(&g, dgates + t * BG, 0, min(chunk, B));
  }
  // dh0 = dgates_0 . W_hh^T
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int n = min(chunk, B - b0);
    if (b0 > 0) {
      __syncthreads();
      stage(nullptr, dgates, b0, n);
    }
    mbar_wait(bar, parity);
    if (u >= H) continue;
    for (int p0 = 0; p0 < n; p0 += R) {
      float acc[R];
      row_dots(acc, p0);
      const float v = pick<R>(acc, lane);
      if (lane < min(R, n - p0)) dh0[(size_t)(b0 + p0 + lane) * H + u] = v;
    }
  }
}

// A cooperative launch of `kernel` on `blocks` blocks of `threads`, or the
// reason it cannot run: every block must be co-resident.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int blocks, int threads, int smem,
                       void** args, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      (const void*)kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, n_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if ((long long)per_sm * n_sm < blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                    dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan's own consistency: rows per pass the kernels are built for
// (the wide forms hold the whole batch in one pass), a chunk the staging
// buffer holds, every column (fwd_wide, of 4H) or unit (of H) owned by
// exactly one of the blocks, at most `most` a block, and `smem` at least
// the kernel's layout (`floats` after the 16-byte mbarrier header).
bool plan_ok(int T, int B, int H, int blocks, int per_block, int most,
             int of, int rows, int chunk, bool wide, long long floats,
             int smem) {
  const bool rows_ok = rows == 1 || rows == 4 || rows == 8;
  return T >= 1 && B >= 1 && H >= 1 && H % 4 == 0 && rows_ok &&
         16 + 4 * floats <= (long long)smem &&
         per_block >= 1 && per_block <= most &&
         (wide ? B <= rows && chunk == B : chunk >= 1 && chunk <= B) &&
         (long long)blocks * per_block >= of &&
         (long long)(blocks - 1) * per_block < of;
}

template <typename F>
int by_rows(int rows, F f) {
  switch (rows) {
    case 1: return f(std::integral_constant<int, 1>());
    case 4: return f(std::integral_constant<int, 4>());
    default: return f(std::integral_constant<int, 8>());
  }
}

}  // namespace

// Every entry point takes its launch plan from probe_plan
// (tools/kernel_ceiling_probes.py): one cooperative launch of `blocks`
// blocks of `per_block` columns (fwd_wide) or units, `rows` batch rows per
// pass, `chunk` rows staged at a time and `smem` dynamic shared bytes; `bar`
// is the device's grid-barrier counter (low 31 bits 0 between launches).
extern "C" {

// hs, cs (T, B, H) <- gx (T, B, 4H), w = W_hh (H, 4H), h0, c0 (B, H);
// pre (2, B, 4H) is the exchange buffer.
int paule_probe_fwd_wide(const float* gx, const float* w, const float* h0,
                         const float* c0, float* pre, float* hs, float* cs,
                         unsigned* bar, int T, int B, int H, int blocks,
                         int per_block, int rows, int chunk, int smem,
                         void* stream) {
  const long long floats = (long long)per_block * H + 5LL * B * H +
                           (long long)rows * H;
  if (!plan_ok(T, B, H, blocks, per_block, kMaxCols, 4 * H, rows, chunk,
               true, floats, smem))
    return cudaErrorInvalidValue;
  return by_rows(rows, [&](auto r) {
    void* args[] = {&T, &B, &H, &per_block, &gx, &w, &h0, &c0, &pre, &hs,
                    &cs, &bar};
    return launch_cooperative(probe_fwd_wide<decltype(r)::value>, blocks,
                              kWideThreads, smem, args, stream);
  });
}

// hs, cs (T, B, H) <- gx (T, B, 4H), w = W_hh (H, 4H), h0, c0 (B, H).
int paule_probe_fwd_split(const float* gx, const float* w, const float* h0,
                          const float* c0, float* hs, float* cs,
                          unsigned* bar, int T, int B, int H, int blocks,
                          int per_block, int rows, int chunk, int smem,
                          void* stream) {
  const long long floats = 4LL * per_block * H +
                           (long long)(chunk + rows - 1) / rows * rows * H +
                           (long long)per_block * B;
  if (!plan_ok(T, B, H, blocks, per_block, kMaxUnits, H, rows, chunk, false,
               floats, smem))
    return cudaErrorInvalidValue;
  return by_rows(rows, [&](auto r) {
    void* args[] = {&T, &B, &H, &per_block, &chunk, &gx, &w, &h0, &c0, &hs,
                    &cs, &bar};
    return launch_cooperative(probe_fwd_split<decltype(r)::value>, blocks,
                              per_block * kWarp, smem, args, stream);
  });
}

// dgates (T, B, 4H), dh0, dc0 (B, H) <- acts (T, B, 4H), cs_prev, ghs
// (T, B, H), w = W_hh (H, 4H); dh_buf (2, B, H) is the exchange buffer.
int paule_probe_bwd_wide(const float* acts, const float* cs_prev,
                         const float* ghs, const float* w, float* dh_buf,
                         float* dgates, float* dh0, float* dc0, unsigned* bar,
                         int T, int B, int H, int blocks, int per_block,
                         int rows, int chunk, int smem, void* stream) {
  const long long floats = 4LL * per_block * H + 6LL * B * H +
                           (long long)kWideWarps * kMaxUnits * rows;
  if (!plan_ok(T, B, H, blocks, per_block, kMaxUnits, H, rows, chunk, true,
               floats, smem) ||
      H > kUnitsPerThread * kWideThreads)
    return cudaErrorInvalidValue;
  return by_rows(rows, [&](auto r) {
    void* args[] = {&T,   &B,      &H,      &per_block, &acts, &cs_prev,
                    &ghs, &w,      &dh_buf, &dgates,    &dh0,  &dc0,
                    &bar};
    return launch_cooperative(probe_bwd_wide<decltype(r)::value>, blocks,
                              kWideThreads, smem, args, stream);
  });
}

// dgates (T, B, 4H), dh0, dc0 (B, H) <- acts (T, B, 4H), cs_prev, ghs
// (T, B, H), w = W_hh (H, 4H).
int paule_probe_bwd_split(const float* acts, const float* cs_prev,
                          const float* ghs, const float* w, float* dgates,
                          float* dh0, float* dc0, unsigned* bar, int T, int B,
                          int H, int blocks, int per_block, int rows,
                          int chunk, int smem, void* stream) {
  const long long floats =
      4LL * per_block * H +
      (long long)(chunk + rows - 1) / rows * rows * 4 * H +
      (long long)per_block * B;
  if (!plan_ok(T, B, H, blocks, per_block, kMaxUnits, H, rows, chunk, false,
               floats, smem))
    return cudaErrorInvalidValue;
  return by_rows(rows, [&](auto r) {
    void* args[] = {&T,       &B,   &H,   &per_block, &chunk, &acts,
                    &cs_prev, &ghs, &w,   &dgates,    &dh0,   &dc0,
                    &bar};
    return launch_cooperative(probe_bwd_split<decltype(r)::value>, blocks,
                              per_block * kWarp, smem, args, stream);
  });
}

}  // extern "C"
