// The LSTM recurrence of one layer, backward pass, over one or two
// directions in one launch: the cotangent scans that give the gate
// pre-activation gradients dxp.  The streamed-weight design, for the widths
// whose recurrent weights do not fit in one thread-block cluster's shared
// memory (H=512); the others take bilstm_bwd.cu (ops/bilstm.py
// `lstm_geometry` picks by size).
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bilstm.py
// `_bibwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_lstm.py `_bwd_kernel` (one direction) with
// ndir = 1.  Row maths: ops/pallas_lstm.py `_lstm_row_bwd`, with the
// held-frame rule of its masked branch: there dh_prev takes the whole dh
// and dc_prev = dc_next.  With ndir = 1 only lane 0 (the forward
// direction) runs and the _b pointers are unused.
//
// Inputs: the forward's bias-folded projections xp_f / xp_b [T, B, 4H], the
// mask [T, B], the recurrent weights wh [H, 4H] and their transposes
// wht [4H, H] (made contiguous outside, so that thread u reads row j of wht
// coalesced), the saved h and c of each direction [T, B, H], and the
// cotangents of the h outputs dh_f / dh_b [T, B, H].  Output dxp_f / dxp_b
// [T, B, 4H], zero on masked frames.  The weight gradient dwh = h_prev^T
// dxp over all T*B rows is one matmul per direction outside the kernel.
//
// Walk order: the forward direction's cotangent chain runs t = T-1 .. 0, the
// reversed direction's t = 0 .. T-1.  h_prev and c_prev are read straight
// from the saved sequences at t-1 (forward) or t+1 (reversed), zero past
// the ends.  A step, per block of kRows batch rows:
//
//   P1  gates = xp[t] + h_prev @ wh          (thread per gate column j)
//   P2  dh = dh_out[t] + dh_next; dc; dpre [rows, 4H], zero where masked;
//       dpre overwrites the gates in shared memory and goes to dxp[t];
//       dc_next = m ? dc*f : dc_next;  hold = m ? 0 : dh
//   P3  dh_rec = dpre @ wht, split over the 4H reduction into nsplit
//       partial sums per output unit (all threads busy although only H
//       units exist); h_prev of the next step is loaded here too
//
// and the next step's P2 forms dh_next = hold + sum of the partials.  Three
// barriers a step.
//
// What bounds it on the H100: like the forward kernel, each step streams
// the direction's wh (1 MB at H=256, 4 MB at H=512) from L2 through one
// SM, and here wht as well: two passes a step, so about twice the
// forward's time per step (measured 2.9x).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;         // batch rows per block
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_stream_bwd_kernel(const float* __restrict__ xp_f,
                       const float* __restrict__ xp_b,
                       const float* __restrict__ mask,
                       const float* __restrict__ wh_f,
                       const float* __restrict__ wh_b,
                       const float* __restrict__ wht_f,
                       const float* __restrict__ wht_b,
                       const float* __restrict__ h_f,
                       const float* __restrict__ c_f,
                       const float* __restrict__ h_b,
                       const float* __restrict__ c_b,
                       const float* __restrict__ dh_f,
                       const float* __restrict__ dh_b,
                       float* __restrict__ dxp_f, float* __restrict__ dxp_b,
                       int T, int B, int H, int nsplit) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int RH = kRows * H;
  float* hs = smem;                  // [kRows][H]  h_prev of this step
  float* hold = hs + RH;             // [kRows][H]  dh passed by held frames
  float* dcs = hold + RH;            // [kRows][H]  dc_next
  float* part = dcs + RH;            // [nsplit][kRows][H]  dh_rec partials
  float* gates = part + nsplit * RH; // [kRows][G]  gates, then dpre

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ wh = rev ? wh_b : wh_f;
  const float* __restrict__ wht = rev ? wht_b : wht_f;
  const float* __restrict__ h = rev ? h_b : h_f;
  const float* __restrict__ c = rev ? c_b : c_f;
  const float* __restrict__ dh_out = rev ? dh_b : dh_f;
  float* __restrict__ dxp = rev ? dxp_b : dxp_f;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  const int step_dir = rev ? 1 : -1;       // t_prev = t + step_dir
  const int chunk = (G + nsplit - 1) / nsplit;

  for (int i = threadIdx.x; i < RH; i += blockDim.x) {
    hold[i] = 0.f;
    dcs[i] = 0.f;
  }
  for (int i = threadIdx.x; i < nsplit * RH; i += blockDim.x) part[i] = 0.f;
  {
    const int t = rev ? 0 : T - 1;
    const int tp = t + step_dir;
    for (int i = threadIdx.x; i < RH; i += blockDim.x) {
      const int r = i / H;
      hs[i] = (r < rows && tp >= 0 && tp < T)
                  ? h[(static_cast<size_t>(tp) * B + b0) * H + i]
                  : 0.f;
    }
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    const int tp = t + step_dir;
    const bool has_prev = tp >= 0 && tp < T;
    const size_t row0 = static_cast<size_t>(t) * B + b0;

    // P1: gate pre-activations, recomputed
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = r < rows ? xp[(row0 + r) * G + j] : 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = __ldg(wh + static_cast<size_t>(k) * G + j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(hs[r * H + k], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) gates[r * G + j] = acc[r];
    }
    __syncthreads();

    // P2: the cell's reverse-mode maths, one (row, unit) per thread
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H;
      const int u = i - r * H;
      float* g = gates + r * G;
      const float ig = sigmoidf(g[u]);
      const float fg = sigmoidf(g[H + u]);
      const float gg = tanhf(g[2 * H + u]);
      const float og = sigmoidf(g[3 * H + u]);
      float dh = dh_out[(row0 + r) * H + u] + hold[i];
      for (int q = 0; q < nsplit; ++q) dh += part[q * RH + i];
      const float c_t = c[(row0 + r) * H + u];
      const float c_prev =
          has_prev ? c[(static_cast<size_t>(tp) * B + b0 + r) * H + u] : 0.f;
      const float tc = tanhf(c_t);
      const float d_o = dh * tc;
      const float dc = dcs[i] + dh * og * (1.f - tc * tc);
      const bool m = mask[row0 + r] > 0.f;
      const float p_i = m ? dc * gg * ig * (1.f - ig) : 0.f;
      const float p_f = m ? dc * c_prev * fg * (1.f - fg) : 0.f;
      const float p_g = m ? dc * ig * (1.f - gg * gg) : 0.f;
      const float p_o = m ? d_o * og * (1.f - og) : 0.f;
      g[u] = p_i;
      g[H + u] = p_f;
      g[2 * H + u] = p_g;
      g[3 * H + u] = p_o;
      float* out = dxp + (row0 + r) * G;
      out[u] = p_i;
      out[H + u] = p_f;
      out[2 * H + u] = p_g;
      out[3 * H + u] = p_o;
      // held frames pass h and c (and their cotangents) straight through
      hold[i] = m ? 0.f : dh;
      if (m) dcs[i] = dc * fg;
    }
    __syncthreads();

    // P3: dh_rec partial sums over the 4H reduction; next step's h_prev
    for (int i = threadIdx.x; i < nsplit * H; i += blockDim.x) {
      const int q = i / H;
      const int u = i - q * H;
      const int j1 = min(G, (q + 1) * chunk);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int j = q * chunk; j < j1; ++j) {
        const float w = __ldg(wht + static_cast<size_t>(j) * H + u);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(gates[r * G + j], w, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[q * RH + r * H + u] = acc[r];
    }
    {
      const int tn = tp;                    // the next step's t
      const int tpn = tn + step_dir;
      const bool ok = s + 1 < T && tpn >= 0 && tpn < T;
      for (int i = threadIdx.x; i < RH; i += blockDim.x) {
        const int r = i / H;
        hs[i] = (ok && r < rows)
                    ? h[(static_cast<size_t>(tpn) * B + b0) * H + i]
                    : 0.f;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int asr_lstm_stream_bwd(const float* xp_f, const float* xp_b,
                                   const float* mask, const float* wh_f,
                                   const float* wh_b, const float* wht_f,
                                   const float* wht_b, const float* h_f,
                                   const float* c_f, const float* h_b,
                                   const float* c_b, const float* dh_f,
                                   const float* dh_b, float* dxp_f,
                                   float* dxp_b, int T, int B, int H,
                                   int ndir, void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const int nsplit = threads / H > 1 ? threads / H : 1;
  const size_t smem = sizeof(float) * static_cast<size_t>(kRows) *
                      ((3 + nsplit) * static_cast<size_t>(H) + G);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_stream_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  lstm_stream_bwd_kernel<<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      xp_f, xp_b, mask, wh_f, wh_b, wht_f, wht_b, h_f, c_f, h_b, c_b, dh_f,
      dh_b, dxp_f, dxp_b, T, B, H, nsplit);
  return static_cast<int>(cudaGetLastError());
}
