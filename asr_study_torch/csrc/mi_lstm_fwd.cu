// The multiplicative-integration (MI) LSTM recurrence of one layer, forward
// pass, over one or two directions in one launch.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_mi_lstm.py
// `_bifwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_mi_lstm.py `_fwd_kernel` (one direction) with
// ndir = 1.  Cell maths: ops/pallas_mi_lstm.py `_mi_cell_math` and
// `_mi_pre`: the gate pre-activation is
//
//   pre = alpha * xp * hp + beta1 * xp + beta2 * hp + b,   hp = h_prev @ wh
//
// with xp = x @ wx the RAW input projection (the Hadamard term keeps the
// bias out of it), and alpha, beta1, beta2, b [4H] per direction.  Then the
// LSTM update, gate order i, f, g, o; a frame whose mask is 0 keeps h and c.
//
// The layout is csrc/bilstm_fwd.cu's (one block per direction and kRows
// batch rows, one gate column j per thread, h_prev in shared memory, the
// loop over time inside the kernel).  A thread's column accumulates hp from
// zero and then combines it with xp and the column's four vector entries,
// which it keeps in registers for the whole walk.
//
// Inputs: xp_f / xp_b [T, B, 4H], the mask [T, B], wh_* [H, 4H], alpha_*,
// beta1_*, beta2_*, b_* [4H].  Outputs h and c of each direction [T, B, H]
// in forward time order; lane 1 walks time backward (xp_b and the mask at
// T-1-s).  With ndir = 1 only lane 0 runs and the _b pointers are unused.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;         // batch rows per block
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads)
mi_lstm_fwd_kernel(const float* __restrict__ xp_f,
                   const float* __restrict__ xp_b,
                   const float* __restrict__ mask,
                   const float* __restrict__ wh_f,
                   const float* __restrict__ wh_b,
                   const float* __restrict__ al_f,
                   const float* __restrict__ al_b,
                   const float* __restrict__ b1_f,
                   const float* __restrict__ b1_b,
                   const float* __restrict__ b2_f,
                   const float* __restrict__ b2_b,
                   const float* __restrict__ bias_f,
                   const float* __restrict__ bias_b,
                   float* __restrict__ h_f, float* __restrict__ c_f,
                   float* __restrict__ h_b, float* __restrict__ c_b, int T,
                   int B, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* hs = smem;              // [kRows][H]  h of the previous step
  float* cs = hs + kRows * H;    // [kRows][H]  c of the previous step
  float* gates = cs + kRows * H; // [kRows][G]

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ wh = rev ? wh_b : wh_f;
  const float* __restrict__ al = rev ? al_b : al_f;
  const float* __restrict__ b1 = rev ? b1_b : b1_f;
  const float* __restrict__ b2 = rev ? b2_b : b2_f;
  const float* __restrict__ bias = rev ? bias_b : bias_f;
  float* __restrict__ h_out = rev ? h_b : h_f;
  float* __restrict__ c_out = rev ? c_b : c_f;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);

  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    hs[i] = 0.f;
    cs[i] = 0.f;
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s;
    const size_t row0 = static_cast<size_t>(t) * B + b0;

    // gate pre-activations: hp = h_prev @ wh per column, then the MI form
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < H; ++k) {
        const float w = __ldg(wh + static_cast<size_t>(k) * G + j);
#pragma unroll
        for (int r = 0; r < kRows; ++r) acc[r] = fmaf(hs[r * H + k], w, acc[r]);
      }
      const float a = __ldg(al + j);
      const float v1 = __ldg(b1 + j);
      const float v2 = __ldg(b2 + j);
      const float vb = __ldg(bias + j);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float x = r < rows ? xp[(row0 + r) * G + j] : 0.f;
        gates[r * G + j] = a * x * acc[r] + v1 * x + v2 * acc[r] + vb;
      }
    }
    __syncthreads();

    // state update, held where the frame is masked
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H;
      const int u = i - r * H;
      const float* g = gates + r * G;
      const float ig = sigmoidf(g[u]);
      const float fg = sigmoidf(g[H + u]);
      const float gg = tanhf(g[2 * H + u]);
      const float og = sigmoidf(g[3 * H + u]);
      const float c_prev = cs[i];
      const float h_prev = hs[i];
      float c = fg * c_prev + ig * gg;
      float h = og * tanhf(c);
      if (!(mask[row0 + r] > 0.f)) {
        c = c_prev;
        h = h_prev;
      }
      cs[i] = c;
      hs[i] = h;
      const size_t o = (row0 + r) * H + u;
      h_out[o] = h;
      c_out[o] = c;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int asr_mi_lstm_fwd(const float* xp_f, const float* xp_b,
                               const float* mask, const float* wh_f,
                               const float* wh_b, const float* al_f,
                               const float* al_b, const float* b1_f,
                               const float* b1_b, const float* b2_f,
                               const float* b2_b, const float* bias_f,
                               const float* bias_b, float* h_f, float* c_f,
                               float* h_b, float* c_b, int T, int B, int H,
                               int ndir, void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const size_t smem = sizeof(float) * static_cast<size_t>(kRows) * (2 * H + G);
  cudaError_t err = cudaFuncSetAttribute(
      mi_lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  mi_lstm_fwd_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      xp_f, xp_b, mask, wh_f, wh_b, al_f, al_b, b1_f, b1_b, b2_f, b2_b,
      bias_f, bias_b, h_f, c_f, h_b, c_b, T, B, H);
  return static_cast<int>(cudaGetLastError());
}
