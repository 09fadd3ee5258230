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
// All four kernels are persistent: one cooperative launch per call, with
// every block co-resident, loops over time inside the kernel and meets the
// other blocks at a grid barrier (cooperative_groups' grid sync) after each
// step, as the TPU kernel loops inside its program.  This removes the
// per-step launch, which set their pace when the kernel boundary was the
// barrier (B1: ~11.6 us per step at B=1 on an H100, against ~3.1 us as one
// launch).
//
// Forward (B1, B3).  Per step a block stages the previous hidden rows it
// needs (h_{t-1}; for layer 2 of B3 [h1_t; h2_{t-1}]) in shared memory, in
// row chunks, and one device routine (cell_rows) runs the cell step of each
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
//   (ops/lstm_kernels.py: fwd_plan, stack2_plan, bwd_plan, stack2_bwd_plan);
//   the entry point checks with the occupancy API that the grid can be
//   co-resident and returns cudaErrorCooperativeLaunchTooLarge if not,
//   before anything is launched.
//
// Backward (B2, B4): the reverse recurrence, t = T-1 down to 0.  A warp owns
// hidden unit u; its recurrent cotangent is one dot product per batch row
// against row u of the weights in their (H, 4H) layout, which is contiguous,
// so no transposed scratch is needed: dh[b] = extra[b] + W[u, :] .
// dgates_{t+1}[b, :].  One device routine (bwd_rows, the counterpart of
// cell_rows) runs it over the staged dgates rows: a lane takes its own float4
// of each 128-column tile of the weight row and of R batch rows, with no
// branch between rows; warp_sums adds the lanes' sums in a fixed order; the
// lane of row b then runs the gate-gradient step (cell_bwd) and writes
// dgates[b, qH + u], q < 4.  Each unit's cell-gradient carry stays in shared
// memory for the whole sequence, the step's own inputs (acts, cs_prev, ghs)
// are prefetched across the barrier, and dgates_{t+1}, which other blocks
// wrote, is staged through L2.  This is the owner layout: it stages a whole
// dgates row (4H floats) per batch row after each barrier.  It was taken
// over P2's wide layout (csrc/ceiling_probes.cu), which exchanges only dh
// (H floats) but makes every block recompute every unit's gate gradients
// from all of acts, because it needs no recomputation and at B=1 runs at
// B1's ~3 us per step on an H100; at B=8 its staging (92 KB per block and
// step) is what bounds it, and what the wide layout would cut.
// * B2 holds its units' W_hh rows in shared memory for the whole sequence
//   (6 units x 2880 x 4 B = 69 KB per block at H=720 on 132 SMs).  After
//   step 0, one more barrier, then dh0 = dgates_0 . W_hh^T in the same
//   launch; dc0 is the carry.
// * B4 runs B3's wavefront backwards, T + 1 steps between T barriers:
//   blocks [0, nb) run layer 2 at t = T-1-s, blocks [nb, 2nb) layer 1 at
//   t = T-s.  Layer 2's dot is w2[H+u, :] . dgates2_{t+1}, layer 1's one dot
//   of 8H, [w2[u, :] | w1[u, :]] . [dgates2_t | dgates1_{t+1}].  Like B3's,
//   the weights (25 MB at H=720) stream every step from L2 through a
//   per-warp cp.async ring, of 512-column tiles (2 KB, as B3's four-row
//   tiles).  Measured on an H100: keeping the block's w2 rows resident
//   instead (127 KB at 11 units) left room for only a 128-column ring and
//   three staged 8H rows, so the stream had too few bytes in flight and a
//   batch of 4 or more ran one row per pass (PERF.md).
//
// Kernels allocate nothing: every buffer, including B3's scratch rows, comes
// from the Python wrapper.  Each entry point launches on the given stream
// and returns the CUDA error of its launch (cudaGetLastError()).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kWarp = 32;
constexpr int kMaxUnits = 12;            // most units (warps) a block owns
constexpr int kMaxThreads = kMaxUnits * kWarp;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// ------------------------------------------------- forward: shared routine
constexpr int kTile = 4 * kWarp;         // reduction-axis columns per tile
constexpr int kMinStages = 2;            // weight ring (B3, B4), tiles a warp
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

// ------------------------------------------------ backward: shared routine
constexpr int kIn = 6;   // floats per batch row in a warp's prefetch slot

// Lane r < rows copies row r's inputs of one backward step of unit u into
// slot[kIn r + j], asynchronously (issued before a grid barrier, the copy
// overlaps it): j < 4 the activated gates acts[r, qH + u], 4 the previous
// cell state, 5 the incoming hidden cotangent ghs[r, u] (where ghs is given).
__device__ __forceinline__ void prefetch_inputs(float* slot, const float* acts,
                                                const float* c_prev,
                                                const float* ghs, int H,
                                                int u, int rows, int lane) {
  if (lane < rows) {
    const size_t G = (size_t)4 * H;
    float* s = slot + kIn * lane;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      cp_async4(s + q, acts + lane * G + (size_t)q * H + u);
    cp_async4(s + 4, c_prev + (size_t)lane * H + u);
    if (ghs) cp_async4(s + 5, ghs + (size_t)lane * H + u);
  }
}

// The gate-gradient step of one unit and one batch row, shared by both
// backward kernels: in = (activated gates i, f, g, o, previous cell state),
// dh the hidden cotangent, dc_in the cell carry from the step after.  Writes
// the four gate gradients d[qH], returns the carry for the step before.
__device__ __forceinline__ float cell_bwd(const float (&in)[6], float dh,
                                          float dc_in, float* d, int H) {
  const float gi = in[0], gf = in[1], gg = in[2], go = in[3], cp = in[4];
  const float tc = tanhf(gf * cp + gi * gg);
  const float d_o = dh * tc;
  const float dc = dc_in + dh * go * (1.0f - tc * tc);
  d[0] = dc * gg * gi * (1.0f - gi);
  d[H] = dc * cp * gf * (1.0f - gf);
  d[2 * H] = dc * gi * (1.0f - gg * gg);
  d[3 * H] = d_o * go * (1.0f - go);
  return dc * gf;
}

// acc[r] += wv . x[r * x_ld + 0:4] for the R rows of a pass, with no branch
// between rows (rows past the chunk hold finite stale values, whose sums the
// caller drops).
template <int R>
__device__ __forceinline__ void fma_rows(float (&acc)[R], float4 wv,
                                         const float* x, int x_ld) {
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const float4 xv = *reinterpret_cast<const float4*>(x + (size_t)r * x_ld);
    float a = acc[r];
    a += wv.x * xv.x;
    a += wv.y * xv.y;
    a += wv.z * xv.z;
    a += wv.w * xv.w;
    acc[r] = a;
  }
}

constexpr int kWide = 4 * kTile;         // B4's ring: columns per tile

// B4's weight ring of one warp: tile j (kWide columns) of the unit's weight
// row, the concatenation [row_a (Ka floats) | row_b] cut at K, into slot
// j % stages, four float4 per lane; always one commit, as ring_issue.
__device__ __forceinline__ void wide_ring_issue(float* ring, int stages,
                                                int j, int n_tiles, int K,
                                                int lane, const float* row_a,
                                                int Ka, const float* row_b) {
  if (j < n_tiles) {
    float* slot = ring + (j % stages) * kWide + 4 * lane;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = j * kWide + q * kTile + 4 * lane;
      if (c < K)
        cp_async16(slot + q * kTile, c < Ka ? row_a + c : row_b + (c - Ka));
    }
  }
  cp_async_commit();
}

// Per-lane partial sums, by one warp, of the unit's weight row w against
// each of the R staged rows of a pass (x: rows of x_ld floats in shared
// memory): acc[r] += w[0:K] . x[r, 0:K].  kRing false (B2): w = row_a, in
// shared memory, read in place.  kRing true (B4): w = [row_a (Ka floats) |
// row_b], in global memory, streamed tile by tile through the warp's ring
// of `stages` slots of kWide floats (stages - 1 tiles in flight).  Either
// way lane L takes columns 128 i + 4 L + 0..3 of every 128-column tile i,
// in order.  K, Ka and x_ld are multiples of 4.
template <int R, bool kRing>
__device__ __forceinline__ void row_dots(float (&acc)[R], int lane,
                                         const float* row_a, int Ka,
                                         const float* row_b, int K,
                                         float* ring, int stages,
                                         const float* x, int x_ld) {
  if constexpr (!kRing) {
    for (int k = 4 * lane; k < K; k += kTile)
      fma_rows<R>(acc, *reinterpret_cast<const float4*>(row_a + k), x + k,
                  x_ld);
  } else {
    const int n_tiles = (K + kWide - 1) / kWide;
    for (int j = 0; j < stages - 1; ++j)
      wide_ring_issue(ring, stages, j, n_tiles, K, lane, row_a, Ka, row_b);
    for (int i = 0; i < n_tiles; ++i) {
      // tile i has landed; refill the slot this lane read one tile ago
      cp_async_wait(stages - 2);
      wide_ring_issue(ring, stages, i + stages - 1, n_tiles, K, lane, row_a,
                      Ka, row_b);
      const float* slot = ring + (i % stages) * kWide + 4 * lane;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = i * kWide + q * kTile + 4 * lane;
        if (c < K)
          fma_rows<R>(acc, *reinterpret_cast<const float4*>(slot + q * kTile),
                      x + c, x_ld);
      }
    }
    cp_async_wait(0);
  }
}

// v[lane] for lane < R, by a branch-free select (other lanes get 0).
template <int R>
__device__ __forceinline__ float lane_value(const float (&v)[R], int lane) {
  float out = 0.0f;
#pragma unroll
  for (int i = 0; i < R; ++i)
    if (i == lane) out = v[i];
  return out;
}

// One backward cell step of hidden unit u, by one warp, over the n rows of a
// chunk (x: the staged cotangent rows, allocated for n rounded up to a
// multiple of R).  Row b's hidden cotangent is (ghs ? ghs[b * H + u] : 0)
// plus the row_dots<R, kRing> of x[b]; the step reads acts[b * 4H + qH + u]
// and c_prev[b * H + u], or, where `pre` is given, finds the first pass's
// inputs there (prefetch_inputs).  dc_state[b] holds the row's cell carry;
// the step writes dgates[b * 4H + qH + u], q < 4, and, where dc_out is
// given, the new carry to dc_out[b * H + u].
template <int R, bool kRing>
__device__ __forceinline__ void bwd_rows(
    int u, int lane, int H, int n, const float* row_a, int Ka,
    const float* row_b, int K, float* ring, int stages, const float* x,
    int x_ld, const float* acts, const float* c_prev, const float* ghs,
    const float* pre, float* dc_state, float* dc_out, float* dgates) {
  const size_t G = (size_t)4 * H;
  for (int p0 = 0; p0 < n; p0 += R) {
    const int nr = min(R, n - p0);
    // the row's inputs, loaded before the product so that their latency
    // overlaps it
    float in[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
    if (lane < nr) {
      const int b = p0 + lane;
      if (p0 == 0 && pre) {
#pragma unroll
        for (int j = 0; j < 5; ++j) in[j] = pre[kIn * lane + j];
        if (ghs) in[5] = pre[kIn * lane + 5];
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) in[q] = acts[b * G + (size_t)q * H + u];
        in[4] = c_prev[(size_t)b * H + u];
        if (ghs) in[5] = ghs[(size_t)b * H + u];
      }
    }
    float acc[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = 0.0f;
    row_dots<R, kRing>(acc, lane, row_a, Ka, row_b, K, ring, stages,
                       x + (size_t)p0 * x_ld, x_ld);
    warp_sums<R>(acc, lane);
    const float rec = lane_value<R>(acc, lane);
    if (lane < nr) {
      const int b = p0 + lane;
      const float carry =
          cell_bwd(in, in[5] + rec, dc_state[b], dgates + b * G + u, H);
      dc_state[b] = carry;
      if (dc_out) dc_out[(size_t)b * H + u] = carry;
    }
  }
}

// Rows [r0, r0 + n) of a row-major matrix of K columns (K a multiple of 4)
// into shared memory by the whole block, rows from `limit` on as zeros.
__device__ __forceinline__ void load_rows(float* dst, const float* src, int K,
                                          int r0, int n, int limit) {
  const int per_row = K / 4;
  for (int i = threadIdx.x; i < n * per_row; i += blockDim.x) {
    const int r = i / per_row, c = i - r * per_row;
    reinterpret_cast<float4*>(dst)[i] =
        r0 + r < limit ? reinterpret_cast<const float4*>(
                             src + (size_t)(r0 + r) * K)[c]
                       : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

// The cell carries (units x B) and the staging buffer (n floats) zeroed:
// the padding rows of a pass must hold finite values.
__device__ __forceinline__ void zero_shared(float* c_s, int n_c, float* x_s,
                                            size_t n) {
  for (int i = threadIdx.x; i < n_c; i += blockDim.x) c_s[i] = 0.0f;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) x_s[i] = 0.0f;
}

// ---------------------------------------------------------------- B2
// Steps t = T-1 .. 0, then dh0.  Warp j of block blk owns unit u = blk *
// units + j; its dot is against row u of W_hh.  Dynamic shared memory: w_s
// (units x 4H: the block's W_hh rows), x_s (chunk rounded up to a multiple
// of R, x 4H: staged dgates_{t+1} rows), p_s (units x kIn x R: the next
// step's inputs of the first pass, prefetched), c_s (units x B: carries).
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_bwd_persistent(int T, int B, int H, int units, int chunk,
                    const float* __restrict__ acts,
                    const float* __restrict__ cs_prev,
                    const float* __restrict__ ghs,
                    const float* __restrict__ w_hh, float* dgates,
                    float* __restrict__ dh0, float* __restrict__ dc0) {
  extern __shared__ float4 smem4[];
  const int G = 4 * H;
  const int x_rows = round_up(chunk, R);
  float* w_s = reinterpret_cast<float*>(smem4);
  float* x_s = w_s + (size_t)units * G;
  float* p_s = x_s + (size_t)x_rows * G;
  float* c_s = p_s + (size_t)units * kIn * R;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int u = blockIdx.x * units + warp;
  const size_t BH = (size_t)B * H, BG = (size_t)B * G;
  load_rows(w_s, w_hh, G, blockIdx.x * units, units, H);
  zero_shared(c_s, units * B, x_s, (size_t)x_rows * G);
  float* pre = p_s + warp * kIn * R;
  const int pre_rows = min(R, min(chunk, B));
  if (u < H)
    prefetch_inputs(pre, acts + (T - 1) * BG, cs_prev + (T - 1) * BH,
                    ghs + (T - 1) * BH, H, u, pre_rows, lane);
  cg::grid_group grid = cg::this_grid();
  for (int t = T - 1; t >= 0; --t) {
    const bool rec = t + 1 < T;          // a cotangent from step t + 1
    for (int b0 = 0; b0 < B; b0 += chunk) {
      const int n = min(chunk, B - b0);
      __syncthreads();                   // x_s free, w_s and c_s written
      if (rec) stage_rows(x_s, G, dgates + (t + 1) * BG + b0 * G, G, n, G);
      cp_async_wait_all();
      __syncthreads();
      if (u < H)
        bwd_rows<R, false>(u, lane, H, n, w_s + (size_t)warp * G, G, nullptr,
                           rec ? G : 0, nullptr, 0, x_s, G,
                           acts + t * BG + b0 * G,
                           cs_prev + t * BH + b0 * H, ghs + t * BH + b0 * H,
                           b0 == 0 ? pre : nullptr, c_s + warp * B + b0,
                           t == 0 ? dc0 + b0 * H : nullptr,
                           dgates + t * BG + b0 * G);
    }
    if (t > 0 && u < H)
      prefetch_inputs(pre, acts + (t - 1) * BG, cs_prev + (t - 1) * BH,
                      ghs + (t - 1) * BH, H, u, pre_rows, lane);
    grid.sync();                         // after step 0: dgates_0 complete
  }
  // dh0 = dgates_0 . W_hh^T
  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int n = min(chunk, B - b0);
    __syncthreads();
    stage_rows(x_s, G, dgates + b0 * G, G, n, G);
    cp_async_wait_all();
    __syncthreads();
    if (u >= H) continue;
    for (int p0 = 0; p0 < n; p0 += R) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.0f;
      row_dots<R, false>(acc, lane, w_s + (size_t)warp * G, G, nullptr, G,
                         nullptr, 0, x_s + (size_t)p0 * G, G);
      warp_sums<R>(acc, lane);
      const float v = lane_value<R>(acc, lane);
      if (lane < min(R, n - p0)) dh0[(size_t)(b0 + p0 + lane) * H + u] = v;
    }
  }
}

// ---------------------------------------------------------------- B4
// Wavefront step s = 0..T: blocks [0, nb) run layer 2 at t = T-1-s, blocks
// [nb, 2nb) layer 1 at t = T-s, whose layer-2 cotangent dgates2_t the other
// half wrote before the last barrier.  w2 = [w_ih2; w_hh2] (2H x 4H): its
// row u gives the cotangent that flows into h1, its row H + u layer 2's own
// recurrent one.  Layer 2's weight row is w2[H+u, :] (4H), layer 1's
// [w2[u, :] | w1[u, :]] (8H); both stream from L2 through the warp's ring.
// Dynamic shared memory: the rings (units x stages x kWide), x_s (chunk
// rounded up to a multiple of R, x 8H: [dgates2_t | dgates1_{t+1}] for
// layer 1, dgates2_{t+1} in the first 4H for layer 2), p_s (units x kIn x
// R: the next step's inputs of the first pass), c_s (units x B: carries).
template <int R>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_stack2_bwd_persistent(int T, int B, int H, int units, int chunk,
                           int stages, const float* __restrict__ acts1,
                           const float* __restrict__ acts2,
                           const float* __restrict__ cs1_prev,
                           const float* __restrict__ cs2_prev,
                           const float* __restrict__ ghs2,
                           const float* __restrict__ w1,
                           const float* __restrict__ w2, float* dgates1,
                           float* dgates2) {
  extern __shared__ float4 smem4[];
  const int nb = gridDim.x / 2;
  const bool layer1 = blockIdx.x >= nb;
  const int G = 4 * H, x_ld = 2 * G;
  const int x_rows = round_up(chunk, R);
  float* rings = reinterpret_cast<float*>(smem4);
  float* x_s = rings + (size_t)units * stages * kWide;
  float* p_s = x_s + (size_t)x_rows * x_ld;
  float* c_s = p_s + (size_t)units * kIn * R;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int u = (layer1 ? blockIdx.x - nb : blockIdx.x) * units + warp;
  float* ring = rings + (size_t)warp * stages * kWide;
  const size_t BH = (size_t)B * H, BG = (size_t)B * G;
  zero_shared(c_s, units * B, x_s, (size_t)x_rows * x_ld);
  const float* row_a = w2 + (size_t)(layer1 ? u : H + u) * G;
  const float* row_b = w1 + (size_t)u * G;
  const float* acts = layer1 ? acts1 : acts2;
  const float* c_prev = layer1 ? cs1_prev : cs2_prev;
  const float* ghs = layer1 ? nullptr : ghs2;
  float* dgates = layer1 ? dgates1 : dgates2;
  float* pre = p_s + warp * kIn * R;
  const int pre_rows = min(R, min(chunk, B));
  if (!layer1 && u < H)
    prefetch_inputs(pre, acts + (T - 1) * BG, c_prev + (T - 1) * BH,
                    ghs + (T - 1) * BH, H, u, pre_rows, lane);
  cg::grid_group grid = cg::this_grid();
  for (int s = 0; s <= T; ++s) {
    const int t = layer1 ? T - s : T - 1 - s;
    const bool rec = t + 1 < T;          // a cotangent from step t + 1
    if (t >= 0 && t < T) {
      for (int b0 = 0; b0 < B; b0 += chunk) {
        const int n = min(chunk, B - b0);
        __syncthreads();                 // x_s free, c_s written
        if (layer1) {
          stage_rows(x_s, x_ld, dgates2 + t * BG + b0 * G, G, n, G);
          if (rec)
            stage_rows(x_s + G, x_ld, dgates1 + (t + 1) * BG + b0 * G, G, n,
                       G);
        } else if (rec) {
          stage_rows(x_s, x_ld, dgates2 + (t + 1) * BG + b0 * G, G, n, G);
        }
        cp_async_wait_all();
        __syncthreads();
        if (u < H)
          bwd_rows<R, true>(u, lane, H, n, row_a, G, row_b,
                            (layer1 ? G : 0) + (rec ? G : 0), ring, stages,
                            x_s, x_ld, acts + t * BG + b0 * G,
                            c_prev + t * BH + b0 * H,
                            ghs ? ghs + t * BH + b0 * H : nullptr,
                            b0 == 0 ? pre : nullptr, c_s + warp * B + b0,
                            nullptr, dgates + t * BG + b0 * G);
      }
    }
    if (s < T) {
      const int tn = t - 1;              // this half's step at s + 1
      if (u < H && tn >= 0 && tn < T)
        prefetch_inputs(pre, acts + tn * BG, c_prev + tn * BH,
                        ghs ? ghs + tn * BH : nullptr, H, u, pre_rows, lane);
      grid.sync();
    }
  }
}

// A cooperative launch of `kernel` on `blocks` blocks of units warps, or
// the reason it cannot run: every block must be co-resident.
template <typename Kernel>
int launch_cooperative(Kernel kernel, int blocks, int units, int smem,
                       void** args, void* stream) {
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
                                    dim3(threads), args, smem,
                                    static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The plan's own consistency: units per block and rows per pass the kernels
// are built for, and every unit of a layer owned by one of its nb blocks;
// `stages` 0 for a kernel without a weight ring (B1, B2), else in range.
bool plan_ok(int T, int B, int H, int nb, int units, int rows, int chunk,
             int stages, bool ring) {
  const bool rows_ok =
      rows == 1 || rows == 4 || rows == 8 || rows == 16 || rows == 24;
  const bool stages_ok =
      ring ? stages >= kMinStages && stages <= kMaxStages : stages == 0;
  return T >= 1 && B >= 1 && H >= 1 && units >= 1 && units <= kMaxUnits &&
         rows_ok && stages_ok && chunk >= 1 && (long long)nb * units >= H &&
         (long long)(nb - 1) * units < H;
}

// f(std::integral_constant<int, R>()) for the rows per pass R of the plan
// (one of those plan_ok accepts).
template <typename F>
int by_rows(int rows, F f) {
  switch (rows) {
    case 1: return f(std::integral_constant<int, 1>());
    case 4: return f(std::integral_constant<int, 4>());
    case 8: return f(std::integral_constant<int, 8>());
    case 16: return f(std::integral_constant<int, 16>());
    default: return f(std::integral_constant<int, 24>());
  }
}

}  // namespace

// Every entry point takes its launch plan from ops/lstm_kernels.py
// (fwd_plan, stack2_plan, bwd_plan, stack2_bwd_plan): one cooperative
// launch of `blocks` blocks of `units` hidden units (B3, B4: half the blocks
// per layer), `rows` batch rows per pass, `chunk` rows staged at a time,
// `stages` tiles in each warp's weight ring (B3, B4; 0 for B1, B2) and `smem`
// dynamic shared bytes.
extern "C" {

// hs, cs (T, B, H) <- gx (T, B, 4H), w_hh (H, 4H), h0, c0 (B, H).
int paule_lstm_fwd(const float* gx, const float* w_hh, const float* h0,
                   const float* c0, float* hs, float* cs, int T, int B, int H,
                   int blocks, int units, int rows, int chunk, int stages,
                   int smem, void* stream) {
  if (!plan_ok(T, B, H, blocks, units, rows, chunk, stages, false))
    return cudaErrorInvalidValue;
  return by_rows(rows, [&](auto r) {
    void* args[] = {&T, &B, &H, &units, &chunk, &gx, &w_hh, &h0, &c0, &hs,
                    &cs};
    return launch_cooperative(lstm_fwd_persistent<decltype(r)::value>,
                              blocks, units, smem, args, stream);
  });
}

// dgates (T, B, 4H), dh0, dc0 (B, H) <- acts (T, B, 4H), cs_prev, ghs
// (T, B, H), w = W_hh (H, 4H).
int paule_lstm_bwd(const float* acts, const float* cs_prev, const float* ghs,
                   const float* w, float* dgates, float* dh0, float* dc0,
                   int T, int B, int H, int blocks, int units, int rows,
                   int chunk, int stages, int smem, void* stream) {
  if (!plan_ok(T, B, H, blocks, units, rows, chunk, stages, false))
    return cudaErrorInvalidValue;
  return by_rows(rows, [&](auto r) {
    void* args[] = {&T,    &B, &H,      &units, &chunk, &acts, &cs_prev,
                    &ghs,  &w, &dgates, &dh0,   &dc0};
    return launch_cooperative(lstm_bwd_persistent<decltype(r)::value>,
                              blocks, units, smem, args, stream);
  });
}

// hs1, cs1, hs2, cs2 (T, B, H) <- gates1 (T, B, 4H), w1 = W_hh1 (H, 4H),
// w2 = [w_ih2; w_hh2] (2H, 4H), b2 (4H), initial carries (B, H); w1T
// (4H, Hp) and w2T (4H, 2Hp) are scratch (Hp: H rounded up to a multiple of
// 4).
int paule_lstm_stack2_fwd(const float* gates1, const float* w1,
                          const float* w2, const float* b2, const float* h01,
                          const float* c01, const float* h02,
                          const float* c02, float* w1T, float* w2T,
                          float* hs1, float* cs1, float* hs2, float* cs2,
                          int T, int B, int H, int blocks, int units,
                          int rows, int chunk, int stages, int smem,
                          void* stream) {
  if (blocks % 2 ||
      !plan_ok(T, B, H, blocks / 2, units, rows, chunk, stages, true))
    return cudaErrorInvalidValue;
  return by_rows(rows, [&](auto r) {
    void* args[] = {&T,   &B,   &H,   &units, &chunk, &stages, &gates1,
                    &w1,  &w2,  &b2,  &h01,   &c01,   &h02,    &c02,
                    &w1T, &w2T, &hs1, &cs1,   &hs2,   &cs2};
    return launch_cooperative(lstm_stack2_fwd_persistent<decltype(r)::value>,
                              blocks, units, smem, args, stream);
  });
}

// dgates1, dgates2 (T, B, 4H) <- acts1, acts2 (T, B, 4H), cs1_prev,
// cs2_prev, ghs2 (T, B, H), w1 = W_hh1 (H, 4H), w2 (2H, 4H).
int paule_lstm_stack2_bwd(const float* acts1, const float* acts2,
                          const float* cs1_prev, const float* cs2_prev,
                          const float* ghs2, const float* w1, const float* w2,
                          float* dgates1, float* dgates2, int T, int B, int H,
                          int blocks, int units, int rows, int chunk,
                          int stages, int smem, void* stream) {
  if (blocks % 2 ||
      !plan_ok(T, B, H, blocks / 2, units, rows, chunk, stages, true))
    return cudaErrorInvalidValue;
  return by_rows(rows, [&](auto r) {
    void* args[] = {&T,       &B,        &H,    &units, &chunk,
                    &stages,  &acts1,    &acts2, &cs1_prev, &cs2_prev,
                    &ghs2,    &w1,       &w2,   &dgates1, &dgates2};
    return launch_cooperative(
        lstm_stack2_bwd_persistent<decltype(r)::value>, blocks, units, smem,
        args, stream);
  });
}

}  // extern "C"
