// LSTM recurrences for Hopper (sm_90a): the four kernels that replace the
// Pallas TPU kernels of paule_tpu/ops/pallas_lstm.py.
//
//   paule_lstm_fwd          replaces _lstm_core_fwd_impl (pallas_lstm.py:214)
//   paule_lstm_bwd          replaces _lstm_core_bwd      (pallas_lstm.py:264)
//   paule_lstm_stack2_fwd   replaces _stack2_fwd_impl    (pallas_lstm.py:554)
//   paule_lstm_stack2_bwd   replaces _stack2_bwd         (pallas_lstm.py:601)
//
// What bounds them on this card.  Each time step is a matrix-vector product
// against W_hh (H x 4H f32, 8.3 MB at H=720) inside a sequential dependency.
// The work of one step is tiny (B*H*4H multiply-adds), so the kernels are
// bound by the latency of one step, T times over, not by bytes or FLOPs.
// The TPU kernels keep W_hh resident in one core's VMEM and loop over time
// inside one program; a Hopper block has at most 227 KB of shared memory, so
// here the hidden units are tiled across blocks.  In every kernel a block
// owns a few hidden units, one warp per unit, and computes all four gate
// columns (i, f, g, o) of its units, so the gate math stays in the warp that
// produced the pre-activations.  Sums run in a fixed order (strided per-lane
// partial sums, then an xor butterfly or its reduce-scatter form, whose
// partners add the same two values), with no atomics, so runs are
// bit-reproducible.
//
// The forward kernels (B1, B3) are persistent: one cooperative launch per
// call, with every block co-resident, loops over time inside the kernel and
// meets the other blocks at a grid barrier (cooperative_groups' grid sync)
// after each step, as the TPU kernel loops inside its program.  This removes
// the per-step launch, which set their pace when the kernel boundary was the
// barrier (~11.6 us per step at B=1 on an H100, against ~3.1 us as one
// launch).  Per step a block stages the previous hidden rows it needs
// (h_{t-1}; for layer 2 of B3 [h1_t; h2_{t-1}]) in shared memory, in row
// chunks, and one device routine (cell_rows) runs the cell step of each
// unit over every staged row: a lane takes its own
// float4 of each 128-column tile of the unit's four weight rows and uses it
// on R batch rows held in registers (R = 1, 4, 8, 16 or 24 by batch), reads
// h from shared memory only, as float4, and keeps its units' cell states in
// shared memory for the whole sequence (cs is still written: the backward
// kernels read it).  Rows are zero-padded to a multiple of 4 columns.
//
// Measured on an H100: with one or two warps per scheduler the step is
// latency-bound, so what sets B3's time per batch row is how many weight
// loads are in flight; prefetching them into registers competes with the
// rows' accumulators (spills at R >= 16), hence the ring below.
//
// * B1 holds its units' W_hh columns in dynamic shared memory for the whole
//   sequence (6 units x 4 gates x 720 x 4 B = 69 KB at H=720 on 132 SMs),
//   loaded once from W_hh in its (H, 4H) layout.
// * B3's weights (W_hh1 and [w_ih2; w_hh2], 25 MB at H=720) do not fit the
//   card's shared memory, so they are read every step from the 50 MB L2: the
//   kernel first copies its units' columns into transposed scratch rows that
//   the wrapper allocates, so that each step reads whole rows, coalesced,
//   and each warp streams its unit's rows through a ring of `stages` tiles in
//   shared memory with cp.async (stages - 1 tiles in flight, no registers
//   held); each lane reads back only the float4s it copied.
//   Blocks [0, nb) run layer 1 at step s and blocks [nb, 2nb) layer 2 at step
//   s - 1, a wavefront of T + 1 steps between T grid barriers.
// * Vectors that other blocks wrote during the launch (hs, hs1, hs2, and
//   B3's scratch rows) are read with __ldcg, through L2, never through the
//   non-coherent or L1 path: a row of hs (4H bytes) need not end on a cache
//   line, so a stale L1 line could hold the next step's first values.
// * The launch plan (blocks, units per block, rows per pass, row-chunk size,
//   dynamic shared bytes) comes from the Python wrapper
//   (ops/lstm_kernels.py: fwd_plan, stack2_plan); the entry point checks with
//   the occupancy API that the grid can be co-resident and returns
//   cudaErrorCooperativeLaunchTooLarge if not, before anything is launched.
//
// The backward kernels (B2, B4) still launch once per time step, looped
// inside the C entry point: the kernel boundary is their grid barrier.  They
// fuse the recurrent product into the start of the next step: each warp
// forms its unit's slice of dgates_{t+1} @ W_hh^T from the full previous
// dgates (W_hh as is, H x 4H, one contiguous row per dot product), then
// writes its own dgates_t columns; B4 runs the two-layer wavefront, T + 1
// launches.
//
// Kernels allocate nothing: every buffer, including the per-unit cell-state
// carries of the backward kernels and B3's scratch rows, comes from the
// Python wrapper.  Each entry point launches on the given stream and returns
// the CUDA error of its launch (cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kUnits = 4;                // backward: hidden units per block
constexpr int kWarp = 32;
constexpr int kThreads = kUnits * kWarp;
constexpr int kRows = 4;                 // backward: batch rows per pass
constexpr int kMaxUnits = 12;            // forward: most units (warps) a block
constexpr int kMaxThreads = kMaxUnits * kWarp;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// acc[r] += row[0:n1] . v1[r*ld1 + 0:n1] + row[n1:n1+n2] . v2[r*ld2 + 0:n2]
// for r < nr, computed by one warp; every lane ends with the same sums.
__device__ __forceinline__ void warp_dot(const float* __restrict__ row,
                                         const float* __restrict__ v1,
                                         int ld1, int n1,
                                         const float* __restrict__ v2,
                                         int ld2, int n2, int nr, int lane,
                                         float acc[kRows]) {
  float part[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) part[r] = 0.0f;
  for (int k = lane; k < n1; k += kWarp) {
    const float w = row[k];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) part[r] += w * v1[(size_t)r * ld1 + k];
  }
  for (int k = lane; k < n2; k += kWarp) {
    const float w = row[n1 + k];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
      if (r < nr) part[r] += w * v2[(size_t)r * ld2 + k];
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
#pragma unroll
    for (int off = kWarp / 2; off > 0; off >>= 1)
      part[r] += __shfl_xor_sync(kFull, part[r], off);
    acc[r] += part[r];
  }
}

__device__ __forceinline__ float pick(const float v[kRows], int r) {
  float out = 0.0f;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i == r) out = v[i];
  return out;
}

// ------------------------------------------------- forward: shared routine
constexpr int kTile = 4 * kWarp;         // reduction-axis columns per tile
constexpr int kMinStages = 2;            // B3's weight ring, tiles per warp
constexpr int kMaxStages = 8;

// One reduce-scatter stage at xor distance OFF over the 2 * half values
// still held: the lanes with bit OFF set keep the upper half, the others
// the lower, each adding its partner's copy.
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

// Warp sums of N per-lane values.  N >= 32: reduce-scatter, after which
// v[0 : N/32) of lane L hold the sums of values N/32 * L + j (the same tree
// as the butterfly, with 31 * N/32 shuffles instead of 5 * N).  N < 32: the
// butterfly, every lane ends with every sum.
template <int N>
__device__ __forceinline__ void warp_sums(float (&v)[N], int lane) {
  if constexpr (N >= kWarp) {
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
    constexpr int S = N / kWarp;             // sums held per lane
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

// 16-byte asynchronous copy global -> shared through L2 (cp.async.cg).
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

// 4-byte asynchronous copy global -> shared (cp.async.ca).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` (0 .. kMaxStages - 2) of this thread's
// copy groups are in flight.
__device__ __forceinline__ void cp_async_wait(int pending) {
  switch (pending) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
  }
}

// B3's weight ring of one warp: tile j of the unit's four gate rows into
// slot j % stages (4 x kTile floats), one float4 per lane and gate, always
// one commit so that the group count stays in step with the tiles.
__device__ __forceinline__ void ring_issue(float* ring, int stages, int j,
                                           int n_tiles, int Kp, int lane,
                                           const float* w,
                                           size_t w_gate_stride) {
  const int k = j * kTile + 4 * lane;
  if (j < n_tiles && k < Kp) {
    float* slot = ring + (j % stages) * 4 * kTile + 4 * lane;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async16(slot + q * kTile, w + q * w_gate_stride + k);
  }
  cp_async_commit();
}

// Lane r < rows copies row r's four input gates of unit u (gx[r * gx_ld +
// qH + u], q < 4) into slot[4r + q], asynchronously: issued before a grid
// barrier, the copy of the next step's gates overlaps it.
__device__ __forceinline__ void prefetch_gates(float* slot, const float* gx,
                                               size_t gx_ld, int H, int u,
                                               int rows, int lane) {
  if (lane < rows) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async4(slot + 4 * lane + q, gx + lane * gx_ld + (size_t)q * H + u);
  }
}

// One forward cell step of hidden unit u, by one warp, over the n rows of a
// chunk staged in shared memory (x: n rows of Kp inputs, Kp a multiple of
// 4, zero-padded; allocated for n rounded up to a multiple of R).  Gate q's
// weight row (Kp floats, zero-padded) is at w + q * w_gate_stride: in
// shared memory, read in place (B1, kRing false),
// or in global memory, streamed tile by tile through the warp's ring of
// `stages` slots in shared memory (B3, kRing true).  Each lane reads its own
// float4 of every tile (columns tile * 128 + 4 * lane + 0..3) of the weights
// and of every row, so it reads in the ring only what it copied there.
// Pre-activation of gate q, row b: (gx ? gx[b * gx_ld + qH + u]
//   : bias[qH + u]) + w_q . x[b]; where `pre` is given, the first pass's
// input gates are already in pre[4 * lane + q] (prefetch_gates).
// c_state[b] holds the row's cell state; the outputs of row b go to
// h_out[b * H + u], c_out[b * H + u].
template <int R, bool kRing>
__device__ __forceinline__ void cell_rows(int u, int lane, int H, int Kp,
                                          int n, const float* w,
                                          size_t w_gate_stride, float* ring,
                                          int stages, const float* x,
                                          const float* gx, size_t gx_ld,
                                          const float* pre, const float* bias,
                                          float* c_state, float* h_out,
                                          float* c_out) {
  const int n_tiles = (Kp + kTile - 1) / kTile;
  for (int p0 = 0; p0 < n; p0 += R) {
    const int nr = min(R, n - p0);
    const float* xp = x + (size_t)p0 * Kp;
    // the row's input gates (or the bias), loaded before the product so
    // that their latency overlaps it
    float base[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (lane < nr) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t col = (size_t)q * H + u;
        base[q] = p0 == 0 && pre ? pre[4 * lane + q]
                  : gx           ? gx[(p0 + lane) * gx_ld + col]
                                 : bias[col];
      }
    }
    float acc[4 * R];
#pragma unroll
    for (int i = 0; i < 4 * R; ++i) acc[i] = 0.0f;
    if constexpr (kRing) {
      for (int j = 0; j < stages - 1; ++j)
        ring_issue(ring, stages, j, n_tiles, Kp, lane, w, w_gate_stride);
    }
    for (int i = 0; i < n_tiles; ++i) {
      const int k = i * kTile + 4 * lane;
      float4 wv[4];
      if constexpr (kRing) {
        // tile i has landed; refill the slot this lane read one tile ago,
        // so that stages - 1 tiles stay in flight during the product
        cp_async_wait(stages - 2);
        ring_issue(ring, stages, i + stages - 1, n_tiles, Kp, lane, w,
                   w_gate_stride);
      }
      if (k < Kp) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          wv[q] = kRing ? reinterpret_cast<const float4*>(
                              ring + (i % stages) * 4 * kTile +
                              q * kTile)[lane]
                        : *reinterpret_cast<const float4*>(
                              w + q * w_gate_stride + k);
        // every row of the pass, with no branch between rows, so that the
        // loads and multiply-adds of all rows interleave; rows past n hold
        // finite stale values and their sums are dropped
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 xv =
              *reinterpret_cast<const float4*>(xp + (size_t)r * Kp + k);
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            float a = acc[q * R + r];
            a += wv[q].x * xv.x;
            a += wv[q].y * xv.y;
            a += wv[q].z * xv.z;
            a += wv[q].w * xv.w;
            acc[q * R + r] = a;
          }
        }
      }
    }
    if constexpr (kRing) cp_async_wait(0);
    warp_sums<4 * R>(acc, lane);
    float a[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) a[q] = gate_sum<R>(acc, q, lane) + base[q];
    if (lane < nr) {
      const int b = p0 + lane;
      const float gi = sigmoid_f(a[0]);
      const float gf = sigmoid_f(a[1]);
      const float gg = tanhf(a[2]);
      const float go = sigmoid_f(a[3]);
      const float c = gf * c_state[b] + gi * gg;
      c_state[b] = c;
      const size_t i = (size_t)b * H + u;
      c_out[i] = c;
      h_out[i] = go * tanhf(c);
    }
  }
}

// dst[r * dst_ld + k] = src[r * src_ld + k] for r < n, k < len, by the
// whole block, through L2 (other blocks wrote src during the launch): as
// 16-byte cp.async.cg copies where the sizes and addresses allow (complete
// after cp_async_wait_all), else with __ldcg.
__device__ __forceinline__ void stage_rows(float* dst, int dst_ld,
                                           const float* src, int src_ld,
                                           int n, int len) {
  const bool vec = len % 4 == 0 && src_ld % 4 == 0 && dst_ld % 4 == 0 &&
                   reinterpret_cast<uintptr_t>(src) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(dst) % 16 == 0;
  const int per_row = vec ? len / 4 : len;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int r = i / per_row, c = i - r * per_row;
    if (vec)
      cp_async16(dst + (size_t)r * dst_ld + 4 * c,
                 src + (size_t)r * src_ld + 4 * c);
    else
      dst[(size_t)r * dst_ld + c] = __ldcg(src + (size_t)r * src_ld + c);
  }
}

// Cell states of a block's units (u0 + j, j < units) for all B rows, into
// shared memory: c_s[j * B + b] = c0[b, u0 + j]; and the staging buffer
// x_s (n floats) zeroed, so that its padding columns stay zero.
__device__ __forceinline__ void init_shared(const float* c0, int B, int H,
                                            int u0, int units, float* c_s,
                                            float* x_s, size_t n) {
  for (int i = threadIdx.x; i < units * B; i += blockDim.x) {
    const int j = i / B, b = i % B;
    c_s[i] = u0 + j < H ? c0[(size_t)b * H + u0 + j] : 0.0f;
  }
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) x_s[i] = 0.0f;
}

inline __host__ __device__ int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

inline __host__ __device__ int pad4(int n) { return round_up(n, 4); }

// ---------------------------------------------------------------- B1
// Hp = H rounded up to a multiple of 4.  Dynamic shared memory: w_s (units
// x 4 rows of Hp: W_hh column qH + u0 + j as row 4j + q, zero-padded), x_s
// (chunk rounded up to a multiple of R, x Hp), g_s (units x 4R: the next
// step's input gates of the first pass, prefetched), c_s (units x B).
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_fwd_persistent(int T, int B, int H, int units, int chunk,
                    const float* __restrict__ gx,
                    const float* __restrict__ w_hh, const float* h0,
                    const float* __restrict__ c0, float* hs, float* cs) {
  extern __shared__ float4 smem4[];
  const int Hp = pad4(H);
  float* w_s = reinterpret_cast<float*>(smem4);
  float* x_s = w_s + (size_t)units * 4 * Hp;
  const int x_rows = round_up(chunk, R);
  float* g_s = x_s + (size_t)x_rows * Hp;
  float* c_s = g_s + (size_t)units * 4 * R;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  const int u0 = blockIdx.x * units;
  const int u = u0 + warp;
  const size_t G = (size_t)4 * H;
  for (int row = warp; row < 4 * units; row += n_warps) {
    const int uj = u0 + row / 4, q = row % 4;
    for (int k = lane; k < Hp; k += kWarp)
      w_s[(size_t)row * Hp + k] =
          uj < H && k < H ? w_hh[k * G + q * H + uj] : 0.0f;
  }
  init_shared(c0, B, H, u0, units, c_s, x_s, (size_t)x_rows * Hp);
  float* pre = g_s + warp * 4 * R;
  const int pre_rows = min(R, min(chunk, B));
  if (u < H) prefetch_gates(pre, gx, G, H, u, pre_rows, lane);
  cg::grid_group grid = cg::this_grid();
  const size_t BH = (size_t)B * H;
  for (int t = 0; t < T; ++t) {
    const float* hp = t ? hs + (t - 1) * BH : h0;
    for (int b0 = 0; b0 < B; b0 += chunk) {
      const int n = min(chunk, B - b0);
      __syncthreads();                   // x_s free, w_s and c_s written
      stage_rows(x_s, Hp, hp + (size_t)b0 * H, H, n, H);
      cp_async_wait_all();
      __syncthreads();
      if (u < H)
        cell_rows<R, false>(u, lane, H, Hp, n, w_s + (size_t)warp * 4 * Hp,
                            Hp, nullptr, 0, x_s, gx + t * B * G + b0 * G, G,
                            b0 == 0 ? pre : nullptr, nullptr,
                            c_s + warp * B + b0, hs + t * BH + b0 * H,
                            cs + t * BH + b0 * H);
    }
    if (t + 1 < T) {
      if (u < H)
        prefetch_gates(pre, gx + (t + 1) * B * G, G, H, u, pre_rows, lane);
      grid.sync();
    }
  }
}

// ---------------------------------------------------------------- B3
// Blocks [0, nb) run layer 1 at step s, blocks [nb, 2nb) layer 2 at step
// s - 1, whose input h1_{s-1} layer 1 wrote before the last barrier.  Layer
// 1 reads w1 = W_hh1 (H, 4H), layer 2 w2 = [w_ih2; w_hh2] (2H, 4H); each
// block first copies its units' columns into the zero-padded scratch rows
// w1T (4H, Hp) or w2T (4H, 2Hp: the h1 half, then the h2 half), which the
// steps stream through each warp's ring.  Dynamic shared memory: the rings
// (units x stages x 4 x kTile), x_s (chunk rounded up to a multiple of R,
// x 2Hp: [h1 | pad | h2 | pad]), g_s (units x 4R: layer 1's prefetched
// input gates), c_s (units x B).
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_stack2_fwd_persistent(int T, int B, int H, int units, int chunk,
                           int stages, const float* __restrict__ gates1,
                           const float* __restrict__ w1,
                           const float* __restrict__ w2,
                           const float* __restrict__ b2, const float* h01,
                           const float* __restrict__ c01, const float* h02,
                           const float* __restrict__ c02, float* w1T,
                           float* w2T, float* hs1, float* cs1, float* hs2,
                           float* cs2) {
  extern __shared__ float4 smem4[];
  const int nb = gridDim.x / 2;
  const bool layer2 = blockIdx.x >= nb;
  const int Hp = pad4(H);
  const int Kp = layer2 ? 2 * Hp : Hp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_warps = blockDim.x / kWarp;
  float* rings = reinterpret_cast<float*>(smem4);
  float* x_s = rings + (size_t)units * stages * 4 * kTile;
  const int x_rows = round_up(chunk, R);
  float* g_s = x_s + (size_t)x_rows * 2 * Hp;
  float* c_s = g_s + (size_t)units * 4 * R;
  float* ring = rings + (size_t)warp * stages * 4 * kTile;
  const int u0 = (layer2 ? blockIdx.x - nb : blockIdx.x) * units;
  const int u = u0 + warp;
  const size_t G = (size_t)4 * H;
  const float* w = layer2 ? w2 : w1;
  float* wT = layer2 ? w2T : w1T;
  for (int row = warp; row < 4 * units; row += n_warps) {
    const int uj = u0 + row / 4, q = row % 4;
    if (uj >= H) continue;
    float* dst = wT + ((size_t)q * H + uj) * Kp;
    for (int k = lane; k < Kp; k += kWarp) {
      const int half = k / Hp, kk = k - half * Hp;   // h1 or h2 part
      dst[k] = kk < H ? w[(half * H + kk) * G + q * H + uj] : 0.0f;
    }
  }
  init_shared(layer2 ? c02 : c01, B, H, u0, units, c_s, x_s,
              (size_t)x_rows * 2 * Hp);
  float* pre = layer2 ? nullptr : g_s + warp * 4 * R;
  const int pre_rows = min(R, min(chunk, B));
  if (pre && u < H) prefetch_gates(pre, gates1, G, H, u, pre_rows, lane);
  cg::grid_group grid = cg::this_grid();
  const size_t BH = (size_t)B * H;
  for (int s = 0; s <= T; ++s) {
    const int t = layer2 ? s - 1 : s;
    if (t >= 0 && t < T) {
      for (int b0 = 0; b0 < B; b0 += chunk) {
        const int n = min(chunk, B - b0);
        __syncthreads();                 // x_s free, scratch rows written
        if (!layer2) {
          const float* h1 = t ? hs1 + (t - 1) * BH : h01;
          stage_rows(x_s, Hp, h1 + (size_t)b0 * H, H, n, H);
        } else {
          const float* h2 = t ? hs2 + (t - 1) * BH : h02;
          stage_rows(x_s, Kp, hs1 + t * BH + (size_t)b0 * H, H, n, H);
          stage_rows(x_s + Hp, Kp, h2 + (size_t)b0 * H, H, n, H);
        }
        cp_async_wait_all();
        __syncthreads();
        if (u < H) {
          if (!layer2)
            cell_rows<R, true>(u, lane, H, Hp, n, w1T + (size_t)u * Hp,
                               (size_t)H * Hp, ring, stages, x_s,
                               gates1 + t * B * G + b0 * G, G,
                               b0 == 0 ? pre : nullptr, nullptr,
                               c_s + warp * B + b0, hs1 + t * BH + b0 * H,
                               cs1 + t * BH + b0 * H);
          else
            cell_rows<R, true>(u, lane, H, Kp, n, w2T + (size_t)u * Kp,
                               (size_t)H * Kp, ring, stages, x_s, nullptr, 0,
                               nullptr, b2, c_s + warp * B + b0,
                               hs2 + t * BH + b0 * H, cs2 + t * BH + b0 * H);
        }
      }
    }
    if (s < T) {
      if (pre && u < H && s + 1 < T)
        prefetch_gates(pre, gates1 + (s + 1) * B * G, G, H, u, pre_rows,
                       lane);
      grid.sync();
    }
  }
}

// A cooperative launch of `kernel` on `blocks` blocks of units warps, or
// the reason it cannot run: every block must be co-resident.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int blocks, int units, int smem,
                       void** args, cudaStream_t st) {
  const int threads = units * kWarp;
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
                                    dim3(threads), args, smem, st);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan's own consistency: units per block and rows per pass the kernels
// are built for, and every unit of a layer owned by one of its nb blocks.
bool plan_ok(int T, int B, int H, int nb, int units, int rows, int chunk) {
  const bool rows_ok =
      rows == 1 || rows == 4 || rows == 8 || rows == 16 || rows == 24;
  return T >= 1 && B >= 1 && H >= 1 && units >= 1 && units <= kMaxUnits &&
         rows_ok && chunk >= 1 && (long long)nb * units >= H &&
         (long long)(nb - 1) * units < H;
}

template <int R>
int fwd_launch(const float* gx, const float* w_hh, const float* h0,
               const float* c0, float* hs, float* cs, int T, int B, int H,
               int blocks, int units, int chunk, int smem, cudaStream_t st) {
  void* args[] = {&T, &B, &H, &units, &chunk, &gx, &w_hh, &h0, &c0, &hs,
                  &cs};
  return launch_cooperative(lstm_fwd_persistent<R>, blocks, units, smem,
                            args, st);
}

template <int R>
int stack2_launch(const float* gates1, const float* w1, const float* w2,
                  const float* b2, const float* h01, const float* c01,
                  const float* h02, const float* c02, float* w1T, float* w2T,
                  float* hs1, float* cs1, float* hs2, float* cs2, int T,
                  int B, int H, int blocks, int units, int chunk, int stages,
                  int smem, cudaStream_t st) {
  void* args[] = {&T,   &B,   &H,   &units, &chunk, &stages, &gates1,
                  &w1,  &w2,  &b2,  &h01,   &c01,   &h02,    &c02,
                  &w1T, &w2T, &hs1, &cs1,   &hs2,   &cs2};
  return launch_cooperative(lstm_stack2_fwd_persistent<R>, blocks, units,
                            smem, args, st);
}

// ---------------------------------------------------------------- B2
// The gate-gradient step shared by both backward kernels, for one unit and
// one batch row b: reads the activated gates acts[b, :], the previous cell
// state, the incoming hidden cotangent dh and the cell carry; writes
// dgates[b, :] and the carry for the step before.
__device__ __forceinline__ void cell_bwd(int unit, int b, int H,
                                         const float* __restrict__ acts,
                                         const float* __restrict__ c_prev,
                                         float dh, float* dc_carry,
                                         bool first, float* dgates) {
  const size_t G = (size_t)4 * H;
  const float* a = acts + b * G;
  const float gi = a[unit];
  const float gf = a[H + unit];
  const float gg = a[2 * H + unit];
  const float go = a[3 * H + unit];
  const size_t i = (size_t)b * H + unit;
  const float cp = c_prev[i];
  const float tc = tanhf(gf * cp + gi * gg);
  const float d_o = dh * tc;
  const float dc = (first ? 0.0f : dc_carry[i]) + dh * go * (1.0f - tc * tc);
  float* d = dgates + b * G;
  d[unit] = dc * gg * gi * (1.0f - gi);
  d[H + unit] = dc * cp * gf * (1.0f - gf);
  d[2 * H + unit] = dc * gi * (1.0f - gg * gg);
  d[3 * H + unit] = d_o * go * (1.0f - go);
  dc_carry[i] = dc * gf;
}

// dg_next == nullptr marks the last time step (no recurrent cotangent yet).
__global__ void __launch_bounds__(kThreads)
lstm_bwd_step(int B, int H, const float* acts, const float* c_prev,
              const float* ghs, const float* w, const float* dg_next,
              float* dc_carry, float* dgates) {
  const int lane = threadIdx.x % kWarp;
  const int unit = blockIdx.x * kUnits + threadIdx.x / kWarp;
  if (unit >= H) return;
  const int G = 4 * H;
  for (int b0 = 0; b0 < B; b0 += kRows) {
    const int nr = min(kRows, B - b0);
    float rec[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) rec[r] = 0.0f;
    if (dg_next)
      warp_dot(w + (size_t)unit * G, dg_next + (size_t)b0 * G, G, G, nullptr,
               0, 0, nr, lane, rec);
    if (lane < nr) {
      const int b = b0 + lane;
      const float dh = ghs[(size_t)b * H + unit] + pick(rec, lane);
      cell_bwd(unit, b, H, acts, c_prev, dh, dc_carry, dg_next == nullptr,
               dgates);
    }
  }
}

// out[b, unit] = w[unit, :] . dg[b, :]  (the cotangent of h0)
__global__ void __launch_bounds__(kThreads)
recurrent_product(int B, int H, const float* w, const float* dg, float* out) {
  const int lane = threadIdx.x % kWarp;
  const int unit = blockIdx.x * kUnits + threadIdx.x / kWarp;
  if (unit >= H) return;
  const int G = 4 * H;
  for (int b0 = 0; b0 < B; b0 += kRows) {
    const int nr = min(kRows, B - b0);
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
    warp_dot(w + (size_t)unit * G, dg + (size_t)b0 * G, G, G, nullptr, 0, 0,
             nr, lane, acc);
    if (lane < nr) out[(size_t)(b0 + lane) * H + unit] = pick(acc, lane);
  }
}

// ---------------------------------------------------------------- B4
// Launch s: blocks [0, nb) run layer 2 at step T-1-s, blocks [nb, 2nb) run
// layer 1 at step T-s, whose layer-2 cotangent dgates2_{T-s} the previous
// launch wrote.  w2 = [w_ih2; w_hh2] (2H x 4H): its row u gives the
// cotangent flowing into h1, its row H+u layer 2's own recurrent carry.
__global__ void __launch_bounds__(kThreads)
stack2_bwd_step(int s, int T, int B, int H, const float* acts1,
                const float* acts2, const float* cs1_prev,
                const float* cs2_prev, const float* ghs2, const float* w1,
                const float* w2, float* dc1, float* dc2, float* dgates1,
                float* dgates2) {
  const int nb = gridDim.x / 2;
  const bool layer1 = blockIdx.x >= nb;
  const int blk = layer1 ? blockIdx.x - nb : blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int unit = blk * kUnits + threadIdx.x / kWarp;
  const int t = layer1 ? T - s : T - 1 - s;
  if (unit >= H || t < 0 || t >= T) return;
  const int G = 4 * H;
  const size_t TG = (size_t)B * G;       // one time step of gates
  const size_t BH = (size_t)B * H;
  const bool first = t == T - 1;
  for (int b0 = 0; b0 < B; b0 += kRows) {
    const int nr = min(kRows, B - b0);
    float dh[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) dh[r] = 0.0f;
    if (!layer1) {
      if (!first)
        warp_dot(w2 + ((size_t)H + unit) * G, dgates2 + (t + 1) * TG + b0 * G,
                 G, G, nullptr, 0, 0, nr, lane, dh);
      if (lane < nr) {
        const int b = b0 + lane;
        const float d = ghs2[t * BH + (size_t)b * H + unit] + pick(dh, lane);
        cell_bwd(unit, b, H, acts2 + t * TG, cs2_prev + t * BH, d, dc2, first,
                 dgates2 + t * TG);
      }
    } else {
      float rec[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) rec[r] = 0.0f;
      warp_dot(w2 + (size_t)unit * G, dgates2 + t * TG + b0 * G, G, G,
               nullptr, 0, 0, nr, lane, dh);
      if (!first)
        warp_dot(w1 + (size_t)unit * G, dgates1 + (t + 1) * TG + b0 * G, G,
                 G, nullptr, 0, 0, nr, lane, rec);
      if (lane < nr) {
        const int b = b0 + lane;
        const float d = pick(dh, lane) + pick(rec, lane);
        cell_bwd(unit, b, H, acts1 + t * TG, cs1_prev + t * BH, d, dc1, first,
                 dgates1 + t * TG);
      }
    }
  }
}

inline int n_blocks(int H) { return (H + kUnits - 1) / kUnits; }

}  // namespace

extern "C" {

// hs, cs (T, B, H) <- gx (T, B, 4H), w_hh (H, 4H), h0, c0 (B, H); one
// cooperative launch of `blocks` blocks of `units` hidden units, `rows`
// batch rows per pass, `chunk` rows staged at a time, `smem` dynamic shared
// bytes (ops/lstm_kernels.py: fwd_plan); `stages` must be 0 (B1 has no
// weight ring).
int paule_lstm_fwd(const float* gx, const float* w_hh, const float* h0,
                   const float* c0, float* hs, float* cs, int T, int B, int H,
                   int blocks, int units, int rows, int chunk, int stages,
                   int smem, void* stream) {
  if (stages != 0 || !plan_ok(T, B, H, blocks, units, rows, chunk))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return fwd_launch<1>(gx, w_hh, h0, c0, hs, cs, T, B, H, blocks,
                                 units, chunk, smem, st);
    case 4: return fwd_launch<4>(gx, w_hh, h0, c0, hs, cs, T, B, H, blocks,
                                 units, chunk, smem, st);
    case 8: return fwd_launch<8>(gx, w_hh, h0, c0, hs, cs, T, B, H, blocks,
                                 units, chunk, smem, st);
    case 16: return fwd_launch<16>(gx, w_hh, h0, c0, hs, cs, T, B, H,
                                   blocks, units, chunk, smem, st);
    default: return fwd_launch<24>(gx, w_hh, h0, c0, hs, cs, T, B, H,
                                   blocks, units, chunk, smem, st);
  }
}

// dgates (T, B, 4H), dh0, dc0 (B, H) <- acts (T, B, 4H), cs_prev, ghs
// (T, B, H), w = W_hh (H, 4H).  dc0 doubles as the cell-state carry.
int paule_lstm_bwd(const float* acts, const float* cs_prev, const float* ghs,
                   const float* w, float* dgates, float* dh0, float* dc0,
                   int T, int B, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t BH = (size_t)B * H, BG = (size_t)B * 4 * H;
  for (int t = T - 1; t >= 0; --t) {
    lstm_bwd_step<<<n_blocks(H), kThreads, 0, st>>>(
        B, H, acts + t * BG, cs_prev + t * BH, ghs + t * BH, w,
        t == T - 1 ? nullptr : dgates + (t + 1) * BG, dc0, dgates + t * BG);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  recurrent_product<<<n_blocks(H), kThreads, 0, st>>>(B, H, w, dgates, dh0);
  return cudaGetLastError();
}

// hs1, cs1, hs2, cs2 (T, B, H) <- gates1 (T, B, 4H), w1 = W_hh1 (H, 4H),
// w2 = [w_ih2; w_hh2] (2H, 4H), b2 (4H), initial carries (B, H); w1T
// (4H, Hp) and w2T (4H, 2Hp) are scratch (Hp: H rounded up to a multiple of
// 4).  One cooperative launch of `blocks` blocks (half per layer), as
// paule_lstm_fwd, with a weight ring of `stages` tiles per warp
// (ops/lstm_kernels.py: stack2_plan).
int paule_lstm_stack2_fwd(const float* gates1, const float* w1,
                          const float* w2, const float* b2, const float* h01,
                          const float* c01, const float* h02,
                          const float* c02, float* w1T, float* w2T,
                          float* hs1, float* cs1, float* hs2, float* cs2,
                          int T, int B, int H, int blocks, int units,
                          int rows, int chunk, int stages, int smem,
                          void* stream) {
  if (blocks % 2 || stages < kMinStages || stages > kMaxStages ||
      !plan_ok(T, B, H, blocks / 2, units, rows, chunk))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows) {
    case 1: return stack2_launch<1>(gates1, w1, w2, b2, h01, c01, h02, c02,
                                    w1T, w2T, hs1, cs1, hs2, cs2, T, B, H,
                                    blocks, units, chunk, stages, smem, st);
    case 4: return stack2_launch<4>(gates1, w1, w2, b2, h01, c01, h02, c02,
                                    w1T, w2T, hs1, cs1, hs2, cs2, T, B, H,
                                    blocks, units, chunk, stages, smem, st);
    case 8: return stack2_launch<8>(gates1, w1, w2, b2, h01, c01, h02, c02,
                                    w1T, w2T, hs1, cs1, hs2, cs2, T, B, H,
                                    blocks, units, chunk, stages, smem, st);
    case 16: return stack2_launch<16>(gates1, w1, w2, b2, h01, c01, h02,
                                      c02, w1T, w2T, hs1, cs1, hs2, cs2, T,
                                      B, H, blocks, units, chunk, stages,
                                      smem, st);
    default: return stack2_launch<24>(gates1, w1, w2, b2, h01, c01, h02,
                                      c02, w1T, w2T, hs1, cs1, hs2, cs2, T,
                                      B, H, blocks, units, chunk, stages,
                                      smem, st);
  }
}

// dgates1, dgates2 (T, B, 4H) <- acts1, acts2 (T, B, 4H), cs1_prev,
// cs2_prev, ghs2 (T, B, H), w1 = W_hh1 (H, 4H), w2 (2H, 4H);
// dc1, dc2 (B, H) are the cell-state carries
int paule_lstm_stack2_bwd(const float* acts1, const float* acts2,
                          const float* cs1_prev, const float* cs2_prev,
                          const float* ghs2, const float* w1, const float* w2,
                          float* dc1, float* dc2, float* dgates1,
                          float* dgates2, int T, int B, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s = 0; s <= T; ++s) {
    stack2_bwd_step<<<2 * n_blocks(H), kThreads, 0, st>>>(
        s, T, B, H, acts1, acts2, cs1_prev, cs2_prev, ghs2, w1, w2, dc1, dc2,
        dgates1, dgates2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
