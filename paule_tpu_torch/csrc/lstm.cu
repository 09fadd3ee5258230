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
// The TPU kernels keep W_hh resident in one core's VMEM; a Hopper block has
// at most 227 KB of shared memory, so here the hidden units are tiled across
// blocks instead:
//
// * a block owns kUnits hidden units, one warp per unit, and computes all
//   four gate columns (i, f, g, o) of its units, so the gate math stays in
//   the warp that produced the pre-activations;
// * every dot product is one warp reading one contiguous row of a weight
//   matrix (the forward kernels take W_hh transposed, 4H x H, the backward
//   ones W_hh as is, H x 4H), so loads are coalesced; the rows stay in the
//   50 MB L2 between steps;
// * one launch per time step, looped inside the C entry point: the kernel
//   boundary is the grid-wide barrier, and h_t (or dgates_t) is exchanged
//   through the output buffers in global memory;
// * the backward kernels fuse the recurrent product into the start of the
//   next step: each warp forms its unit's slice of dgates_{t+1} @ W_hh^T
//   from the full previous dgates, then writes its own dgates_t columns;
// * the two-layer kernels run a wavefront: launch s computes layer 1 at one
//   step and layer 2 at the neighbouring step, T + 1 launches in all;
// * sums run in a fixed order (strided per-lane partial sums, then an xor
//   butterfly whose partners add the same two values), with no atomics, so
//   runs are bit-reproducible.
//
// Kernels allocate nothing: every buffer, including the per-unit cell-state
// carries of the backward kernels, comes from the Python wrapper.  Each
// entry point launches on the given stream and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kUnits = 4;                // hidden units (warps) per block
constexpr int kWarp = 32;
constexpr int kThreads = kUnits * kWarp;
constexpr int kRows = 4;                 // batch rows per pass, in registers
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

// One forward cell step for one hidden unit, all batch rows.
// Pre-activation of gate q: (gx ? gx[b, qH+u] : 0) + (bias ? bias[qH+u] : 0)
//   + wT[qH+u, 0:n1] . v1[b] + wT[qH+u, n1:n1+n2] . v2[b].
__device__ void cell_fwd(int unit, int lane, int B, int H,
                         const float* __restrict__ gx,
                         const float* __restrict__ bias,
                         const float* __restrict__ wT,
                         const float* v1, int n1, const float* v2, int n2,
                         const float* c_prev, float* h_out, float* c_out) {
  const int K = n1 + n2;
  const size_t G = (size_t)4 * H;
  for (int b0 = 0; b0 < B; b0 += kRows) {
    const int nr = min(kRows, B - b0);
    float pre[4][kRows];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) pre[q][r] = 0.0f;
      warp_dot(wT + ((size_t)q * H + unit) * K, v1 + (size_t)b0 * n1, n1, n1,
               v2 ? v2 + (size_t)b0 * n2 : nullptr, n2, n2, nr, lane, pre[q]);
    }
    if (lane < nr) {
      const int b = b0 + lane;
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const size_t col = (size_t)q * H + unit;
        float base = 0.0f;
        if (gx) base = gx[b * G + col];
        if (bias) base = bias[col];
        a[q] = base + pick(pre[q], lane);
      }
      const float gi = sigmoid_f(a[0]);
      const float gf = sigmoid_f(a[1]);
      const float gg = tanhf(a[2]);
      const float go = sigmoid_f(a[3]);
      const size_t i = (size_t)b * H + unit;
      const float c = gf * c_prev[i] + gi * gg;
      c_out[i] = c;
      h_out[i] = go * tanhf(c);
    }
  }
}

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

// ---------------------------------------------------------------- B1
__global__ void __launch_bounds__(kThreads)
lstm_fwd_step(int B, int H, const float* gx, const float* wT,
              const float* h_prev, const float* c_prev, float* h_out,
              float* c_out) {
  const int lane = threadIdx.x % kWarp;
  const int unit = blockIdx.x * kUnits + threadIdx.x / kWarp;
  if (unit >= H) return;
  cell_fwd(unit, lane, B, H, gx, nullptr, wT, h_prev, H, nullptr, 0, c_prev,
           h_out, c_out);
}

// ---------------------------------------------------------------- B2
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

// ---------------------------------------------------------------- B3
// Launch s: blocks [0, nb) run layer 1 at step s, blocks [nb, 2nb) run
// layer 2 at step s - 1, whose input h1_{s-1} the previous launch wrote.
__global__ void __launch_bounds__(kThreads)
stack2_fwd_step(int s, int T, int B, int H, const float* gates1,
                const float* w1T, const float* w2T, const float* b2,
                const float* h01, const float* c01, const float* h02,
                const float* c02, float* hs1, float* cs1, float* hs2,
                float* cs2) {
  const int nb = gridDim.x / 2;
  const bool layer2 = blockIdx.x >= nb;
  const int blk = layer2 ? blockIdx.x - nb : blockIdx.x;
  const int lane = threadIdx.x % kWarp;
  const int unit = blk * kUnits + threadIdx.x / kWarp;
  const int t = layer2 ? s - 1 : s;
  if (unit >= H || t < 0 || t >= T) return;
  const size_t BH = (size_t)B * H;
  if (!layer2) {
    const float* hp = t ? hs1 + (t - 1) * BH : h01;
    const float* cp = t ? cs1 + (t - 1) * BH : c01;
    cell_fwd(unit, lane, B, H, gates1 + (size_t)t * B * 4 * H, nullptr, w1T,
             hp, H, nullptr, 0, cp, hs1 + t * BH, cs1 + t * BH);
  } else {
    const float* hp = t ? hs2 + (t - 1) * BH : h02;
    const float* cp = t ? cs2 + (t - 1) * BH : c02;
    cell_fwd(unit, lane, B, H, nullptr, b2, w2T, hs1 + t * BH, H, hp, H, cp,
             hs2 + t * BH, cs2 + t * BH);
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

// hs, cs (T, B, H) <- gx (T, B, 4H), wT = W_hh^T (4H, H), h0, c0 (B, H)
int paule_lstm_fwd(const float* gx, const float* wT, const float* h0,
                   const float* c0, float* hs, float* cs, int T, int B, int H,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t BH = (size_t)B * H, BG = (size_t)B * 4 * H;
  for (int t = 0; t < T; ++t) {
    lstm_fwd_step<<<n_blocks(H), kThreads, 0, st>>>(
        B, H, gx + t * BG, wT, t ? hs + (t - 1) * BH : h0,
        t ? cs + (t - 1) * BH : c0, hs + t * BH, cs + t * BH);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
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

// hs1, cs1, hs2, cs2 (T, B, H) <- gates1 (T, B, 4H), w1T = W_hh1^T (4H, H),
// w2T = [w_ih2; w_hh2]^T (4H, 2H), b2 (4H), initial carries (B, H)
int paule_lstm_stack2_fwd(const float* gates1, const float* w1T,
                          const float* w2T, const float* b2, const float* h01,
                          const float* c01, const float* h02,
                          const float* c02, float* hs1, float* cs1,
                          float* hs2, float* cs2, int T, int B, int H,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s = 0; s <= T; ++s) {
    stack2_fwd_step<<<2 * n_blocks(H), kThreads, 0, st>>>(
        s, T, B, H, gates1, w1T, w2T, b2, h01, c01, h02, c02, hs1, cs1, hs2,
        cs2);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
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
