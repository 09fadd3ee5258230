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
// step ("wide") against four per-gate products ("split").  Here the two
// forms differ in what crosses the grid between steps:
//
// * wide: the step's product runs over the whole concatenated gate axis,
//   spread over all blocks, and its result is exchanged through a small
//   global buffer; at the start of the next launch EVERY block recomputes
//   the cheap elementwise cell step for all B x H units from that buffer
//   (only the unit's owner, block u % gridDim.x, writes the outputs).
//   Forward: a thread per gate column forms gx_t + h_{t-1} @ W_hh into a
//   pre-activation buffer.  Backward: a warp per row of W_hh contracts the
//   concatenated dgates_t against W_hh^T into the recurrent cotangent.
// * split: a block owns a set of hidden units and forms their four gate
//   products (forward) or four per-gate partial contractions (backward)
//   itself; the partials meet in shared memory with the thread that owns
//   the unit, which runs the cell step, so the gates never leave the block.
//   What crosses the grid is the step's output (h_t, or dgates_t).
//
// Both forms take W_hh in its (H, 4H) layout (B1 takes W_hh^T): the forward
// products read consecutive gate columns of a row of W_hh with consecutive
// threads, the backward contractions read a row of W_hh along its 4H
// columns with the lanes of a warp, so every weight load is coalesced, and
// W_hh (8.3 MB at H=720) stays in the 50 MB L2 between steps.  The inputs
// of the product (h_{t-1} or dgates) are staged in shared memory.
//
// What bounds them: as for B1/B2, each step is a matrix-vector product of
// B*H*4H multiply-adds inside a sequential dependency, one launch per step
// (the kernel boundary is the grid-wide barrier), so the latency of T
// dependent launches bounds them, not bytes or FLOPs.  Sums run in a fixed
// order (strided partial sums, then shared memory or an xor butterfly), with
// no atomics.  Kernels allocate nothing: scratch buffers come from the
// Python wrapper.  Each entry point launches on the given stream and
// returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                 // warps per block
constexpr int kThreads = kWarps * kWarp;
constexpr int kRows = 4;                  // batch rows per pass, in registers
constexpr int kCols = 32;                 // forward: columns / units per block
constexpr int kUnits = 8;                 // backward: hidden units per block
constexpr unsigned kFull = 0xffffffffu;
constexpr size_t kDefaultSmem = 48 * 1024;

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.0f / (1.0f + expf(-x));
}

__device__ __forceinline__ float pick(const float v[kRows], int r) {
  float out = 0.0f;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
    if (i == r) out = v[i];
  return out;
}

// One reverse cell step of unit u, batch row b (B2's arithmetic): writes the
// four gate gradients to d (the row's 4H columns) and returns the carry
// dc * f for the step before.
__device__ __forceinline__ float gate_grads(const float* __restrict__ a,
                                            float cp, float dh, float dc_in,
                                            int u, int H, float* d) {
  const float gi = a[u];
  const float gf = a[H + u];
  const float gg = a[2 * H + u];
  const float go = a[3 * H + u];
  const float tc = tanhf(gf * cp + gi * gg);
  const float d_o = dh * tc;
  const float dc = dc_in + dh * go * (1.0f - tc * tc);
  d[u] = dc * gg * gi * (1.0f - gi);
  d[H + u] = dc * cp * gf * (1.0f - gf);
  d[2 * H + u] = dc * gi * (1.0f - gg * gg);
  d[3 * H + u] = d_o * go * (1.0f - go);
  return dc * gf;
}

// ------------------------------------------------------------- P1 wide
// Launch s = 0..T.  Phase 1 (s >= 1): the cell step s-1 for all units from
// pre_{s-1}, h_{s-1} kept in shared memory.  Phase 2 (s < T): this block's
// kCols columns of pre_s = gx_s + h_{s-1} @ W_hh, a thread per column, the
// warps splitting the H-long contraction.
__global__ void __launch_bounds__(kThreads)
fwd_wide_step(int s, int T, int B, int H, const float* __restrict__ gx,
              const float* __restrict__ w, const float* __restrict__ h0,
              const float* __restrict__ c0, float* __restrict__ pre,
              float* __restrict__ hs, float* __restrict__ cs) {
  extern __shared__ float h_s[];                 // B x H
  __shared__ float red[kWarps][kRows][kCols];
  const int G = 4 * H;
  const size_t BH = (size_t)B * H, BG = (size_t)B * G;
  const int tid = threadIdx.x;
  if (s == 0) {
    for (int i = tid; i < B * H; i += kThreads) h_s[i] = h0[i];
  } else {
    const float* p = pre + ((s - 1) & 1) * BG;
    const float* c_prev = s >= 2 ? cs + (size_t)(s - 2) * BH : c0;
    for (int i = tid; i < B * H; i += kThreads) {
      const int b = i / H, u = i - b * H;
      const float* pb = p + (size_t)b * G;
      const float gi = sigmoid_f(pb[u]);
      const float gf = sigmoid_f(pb[H + u]);
      const float gg = tanhf(pb[2 * H + u]);
      const float go = sigmoid_f(pb[3 * H + u]);
      const float c = gf * c_prev[i] + gi * gg;
      const float h = go * tanhf(c);
      h_s[i] = h;
      if (u % gridDim.x == blockIdx.x) {
        hs[(size_t)(s - 1) * BH + i] = h;
        cs[(size_t)(s - 1) * BH + i] = c;
      }
    }
  }
  if (s == T) return;
  __syncthreads();
  const int lane = tid % kWarp, warp = tid / kWarp;
  const int col = blockIdx.x * kCols + lane;
  const float* gxs = gx + (size_t)s * BG;
  float* out = pre + (s & 1) * BG;
  for (int b0 = 0; b0 < B; b0 += kRows) {
    const int nr = min(kRows, B - b0);
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.0f;
    if (col < G) {
      for (int k = warp; k < H; k += kWarps) {
        const float wk = w[(size_t)k * G + col];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          if (r < nr) part[r] += h_s[(b0 + r) * H + k] * wk;
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) red[warp][r][lane] = part[r];
    __syncthreads();
    if (warp < nr && col < G) {                  // warp r finishes row b0+r
      const size_t o = (size_t)(b0 + warp) * G + col;
      float acc = gxs[o];
      for (int j = 0; j < kWarps; ++j) acc += red[j][warp][lane];
      out[o] = acc;
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------ P1 split
// Launch t: the block owns kCols hidden units, a lane each; lane u forms
// the four gate columns q*H + u of gx_t + h_{t-1} @ W_hh (the warps split
// the contraction), and warp r sums the partials of batch row b0 + r and
// runs the cell update of its units.
__global__ void __launch_bounds__(kThreads)
fwd_split_step(int B, int H, const float* __restrict__ gx,
               const float* __restrict__ w, const float* __restrict__ h_prev,
               const float* __restrict__ c_prev, float* __restrict__ h_out,
               float* __restrict__ c_out) {
  extern __shared__ float h_s[];                 // B x H
  __shared__ float red[kWarps][4][kRows][kCols];
  const int G = 4 * H;
  const int tid = threadIdx.x;
  for (int i = tid; i < B * H; i += kThreads) h_s[i] = h_prev[i];
  __syncthreads();
  const int lane = tid % kWarp, warp = tid / kWarp;
  const int u = blockIdx.x * kCols + lane;
  for (int b0 = 0; b0 < B; b0 += kRows) {
    const int nr = min(kRows, B - b0);
    float part[4][kRows];
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[q][r] = 0.0f;
    if (u < H) {
      for (int k = warp; k < H; k += kWarps) {
        float hk[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          hk[r] = r < nr ? h_s[(b0 + r) * H + k] : 0.0f;
        const float* wk = w + (size_t)k * G + u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const float wq = wk[q * H];
#pragma unroll
          for (int r = 0; r < kRows; ++r) part[q][r] += hk[r] * wq;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
#pragma unroll
      for (int r = 0; r < kRows; ++r) red[warp][q][r][lane] = part[q][r];
    __syncthreads();
    if (warp < nr && u < H) {
      const int b = b0 + warp;
      float a[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        a[q] = gx[(size_t)b * G + q * H + u];
        for (int j = 0; j < kWarps; ++j) a[q] += red[j][q][warp][lane];
      }
      const float gi = sigmoid_f(a[0]);
      const float gf = sigmoid_f(a[1]);
      const float gg = tanhf(a[2]);
      const float go = sigmoid_f(a[3]);
      const size_t i = (size_t)b * H + u;
      const float c = gf * c_prev[i] + gi * gg;
      c_out[i] = c;
      h_out[i] = go * tanhf(c);
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- P2 wide
// Launch s = 0..T-1 runs step t = T-1-s.  Phase 1: the gate gradients of
// step t for all units into the concatenated dgates_t in shared memory;
// the recurrent cotangent and the cell carry come from the halves of two
// double buffers that launch s-1 wrote.  Phase 2: a warp per row k of
// W_hh forms dh_rec_{t-1}[:, k] = dgates_t . W_hh[k, :] (dh0 after step 0).
__global__ void __launch_bounds__(kThreads)
bwd_wide_step(int s, int T, int B, int H, const float* __restrict__ acts,
              const float* __restrict__ cs_prev,
              const float* __restrict__ ghs, const float* __restrict__ w,
              float* __restrict__ dh_buf, float* __restrict__ dc_buf,
              float* __restrict__ dgates, float* __restrict__ dh0,
              float* __restrict__ dc0) {
  extern __shared__ float dg_s[];                // B x 4H
  const int G = 4 * H;
  const size_t BH = (size_t)B * H, BG = (size_t)B * G;
  const int t = T - 1 - s;
  const int tid = threadIdx.x;
  const float* a_t = acts + (size_t)t * BG;
  const float* cp_t = cs_prev + (size_t)t * BH;
  const float* gh_t = ghs + (size_t)t * BH;
  const float* dh_in = dh_buf + ((s + 1) & 1) * BH;   // read when s > 0
  const float* dc_in = dc_buf + ((s + 1) & 1) * BH;
  float* dc_out = t == 0 ? dc0 : dc_buf + (s & 1) * BH;
  for (int i = tid; i < B * H; i += kThreads) {
    const int b = i / H, u = i - b * H;
    const float dh = gh_t[i] + (s ? dh_in[i] : 0.0f);
    float* d = dg_s + (size_t)b * G;
    const float carry = gate_grads(a_t + (size_t)b * G, cp_t[i], dh,
                                   s ? dc_in[i] : 0.0f, u, H, d);
    if (u % gridDim.x == blockIdx.x) {
      float* o = dgates + (size_t)t * BG + (size_t)b * G;
#pragma unroll
      for (int q = 0; q < 4; ++q) o[q * H + u] = d[q * H + u];
      dc_out[i] = carry;
    }
  }
  __syncthreads();
  const int lane = tid % kWarp, warp = tid / kWarp;
  const int k = blockIdx.x * kWarps + warp;
  if (k >= H) return;
  float* out = t == 0 ? dh0 : dh_buf + (s & 1) * BH;
  const float* row = w + (size_t)k * G;
  for (int b0 = 0; b0 < B; b0 += kRows) {
    const int nr = min(kRows, B - b0);
    float part[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) part[r] = 0.0f;
    for (int j = lane; j < G; j += kWarp) {
      const float wj = row[j];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        if (r < nr) part[r] += wj * dg_s[(size_t)(b0 + r) * G + j];
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int off = kWarp / 2; off > 0; off >>= 1)
        part[r] += __shfl_xor_sync(kFull, part[r], off);
    if (lane < nr) out[(size_t)(b0 + lane) * H + k] = pick(part, lane);
  }
}

// ------------------------------------------------------------ P2 split
// Launch for step t = T-1 .. 0, then t = -1 for dh0 alone.  The block owns
// kUnits hidden units.  Warp w takes gate q = w % 4 and half w / 4 of that
// gate's H columns and, for each owned unit u, the partial contraction of
// dgates_{t+1} (staged in shared memory) against W_hh[u, those columns];
// thread (m, r) sums unit m's eight partials for batch row b0 + r and runs
// the gate-gradient step, keeping the cell carry in dc_carry.
__global__ void __launch_bounds__(kThreads)
bwd_split_step(int t, int T, int B, int H, const float* __restrict__ acts,
               const float* __restrict__ cs_prev,
               const float* __restrict__ ghs, const float* __restrict__ w,
               float* __restrict__ dc_carry, float* __restrict__ dgates,
               float* __restrict__ dh0) {
  extern __shared__ float dg_s[];                // B x 4H: dgates_{t+1}
  __shared__ float red[kWarps][kUnits][kRows];
  const int G = 4 * H;
  const size_t BH = (size_t)B * H, BG = (size_t)B * G;
  const bool last = t == T - 1;                  // no recurrent cotangent yet
  const int tid = threadIdx.x;
  if (!last) {
    const float* src = dgates + (size_t)(t + 1) * BG;
    for (size_t i = tid; i < BG; i += kThreads) dg_s[i] = src[i];
  }
  __syncthreads();
  const int lane = tid % kWarp, warp = tid / kWarp;
  const int q = warp & 3, half = warp >> 2;
  const int n_half = (H + 1) / 2;
  const int j0 = q * H + half * n_half;
  const int j1 = q * H + min(H, (half + 1) * n_half);
  const int u_base = blockIdx.x * kUnits;
  for (int b0 = 0; b0 < B; b0 += kRows) {
    const int nr = min(kRows, B - b0);
    if (!last) {
      for (int m = 0; m < kUnits; ++m) {
        const int u = u_base + m;
        float part[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) part[r] = 0.0f;
        if (u < H) {
          const float* row = w + (size_t)u * G;
          for (int j = j0 + lane; j < j1; j += kWarp) {
            const float wj = row[j];
#pragma unroll
            for (int r = 0; r < kRows; ++r)
              if (r < nr) part[r] += wj * dg_s[(size_t)(b0 + r) * G + j];
          }
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
#pragma unroll
          for (int off = kWarp / 2; off > 0; off >>= 1)
            part[r] += __shfl_xor_sync(kFull, part[r], off);
          if (lane == 0) red[warp][m][r] = part[r];
        }
      }
    }
    __syncthreads();
    const int m = tid % kUnits, r = tid / kUnits;
    const int u = u_base + m;
    if (r < nr && u < H) {
      const int b = b0 + r;
      float rec = 0.0f;
      if (!last)
        for (int j = 0; j < kWarps; ++j) rec += red[j][m][r];
      const size_t i = (size_t)b * H + u;
      if (t < 0) {
        dh0[i] = rec;
      } else {
        const float dh = ghs[(size_t)t * BH + i] + rec;
        dc_carry[i] = gate_grads(acts + (size_t)t * BG + (size_t)b * G,
                                 cs_prev[(size_t)t * BH + i], dh,
                                 last ? 0.0f : dc_carry[i], u, H,
                                 dgates + (size_t)t * BG + (size_t)b * G);
      }
    }
    __syncthreads();
  }
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= kDefaultSmem) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

inline int blocks(int n, int per) { return (n + per - 1) / per; }

}  // namespace

extern "C" {

// hs, cs (T, B, H) <- gx (T, B, 4H), w = W_hh (H, 4H), h0, c0 (B, H);
// pre (2, B, 4H) is scratch.  T + 1 launches.
int paule_probe_fwd_wide(const float* gx, const float* w, const float* h0,
                         const float* c0, float* pre, float* hs, float* cs,
                         int T, int B, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)B * H * sizeof(float);
  cudaError_t err = allow_smem(fwd_wide_step, smem);
  if (err != cudaSuccess) return err;
  for (int s = 0; s <= T; ++s) {
    fwd_wide_step<<<blocks(4 * H, kCols), kThreads, smem, st>>>(
        s, T, B, H, gx, w, h0, c0, pre, hs, cs);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// hs, cs (T, B, H) <- gx (T, B, 4H), w = W_hh (H, 4H), h0, c0 (B, H).
// T launches.
int paule_probe_fwd_split(const float* gx, const float* w, const float* h0,
                          const float* c0, float* hs, float* cs, int T,
                          int B, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)B * H * sizeof(float);
  const size_t BH = (size_t)B * H, BG = (size_t)B * 4 * H;
  cudaError_t err = allow_smem(fwd_split_step, smem);
  if (err != cudaSuccess) return err;
  for (int t = 0; t < T; ++t) {
    fwd_split_step<<<blocks(H, kCols), kThreads, smem, st>>>(
        B, H, gx + t * BG, w, t ? hs + (t - 1) * BH : h0,
        t ? cs + (t - 1) * BH : c0, hs + t * BH, cs + t * BH);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// dgates (T, B, 4H), dh0, dc0 (B, H) <- acts (T, B, 4H), cs_prev, ghs
// (T, B, H), w = W_hh (H, 4H); dh_buf, dc_buf (2, B, H) are scratch.
// T launches.
int paule_probe_bwd_wide(const float* acts, const float* cs_prev,
                         const float* ghs, const float* w, float* dh_buf,
                         float* dc_buf, float* dgates, float* dh0,
                         float* dc0, int T, int B, int H, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)B * 4 * H * sizeof(float);
  cudaError_t err = allow_smem(bwd_wide_step, smem);
  if (err != cudaSuccess) return err;
  for (int s = 0; s < T; ++s) {
    bwd_wide_step<<<blocks(H, kWarps), kThreads, smem, st>>>(
        s, T, B, H, acts, cs_prev, ghs, w, dh_buf, dc_buf, dgates, dh0, dc0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

// dgates (T, B, 4H), dh0, dc0 (B, H) <- acts (T, B, 4H), cs_prev, ghs
// (T, B, H), w = W_hh (H, 4H).  dc0 doubles as the cell-state carry.
// T + 1 launches.
int paule_probe_bwd_split(const float* acts, const float* cs_prev,
                          const float* ghs, const float* w, float* dgates,
                          float* dh0, float* dc0, int T, int B, int H,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)B * 4 * H * sizeof(float);
  cudaError_t err = allow_smem(bwd_split_step, smem);
  if (err != cudaSuccess) return err;
  for (int t = T - 1; t >= -1; --t) {
    bwd_split_step<<<blocks(H, kUnits), kThreads, smem, st>>>(
        t, T, B, H, acts, cs_prev, ghs, w, dc0, dgates, dh0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaGetLastError();
}

}  // extern "C"
