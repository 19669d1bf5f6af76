// The LSTM recurrence of one layer, forward pass, over one or two
// directions in one launch: the streamed-weight design, for the widths whose
// recurrent weights do not fit in one thread-block cluster's shared memory
// (H=512, deep_speech's BLSTM).  The other widths take the cluster-resident
// design of bilstm_fwd.cu; ops/bilstm.py `lstm_geometry` picks between the
// two by size.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bilstm.py
// `_bifwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_lstm.py `_fwd_kernel` (one direction) with
// ndir = 1.  Cell maths: ops/pallas_lstm.py `_lstm_cell_math`.
//
// Inputs are the bias-folded input projections xp_f / xp_b [T, B, 4H]
// (x @ wx + b, computed outside by one matmul per direction), the frame
// mask [T, B] and the recurrent weights wh_f / wh_b [H, 4H], gate order
// i, f, g, o.  Outputs h and c of each direction, [T, B, H] in forward time
// order.  Lane 1 (the reverse direction) walks time backward: it reads xp_b
// and the mask at T-1-s.  Both lanes start from zero state, and a frame
// whose mask is 0 keeps the previous h and c, which makes the reverse lane
// exact on right-padded batches.  With ndir = 1 only lane 0 runs, walking
// forward time, and the _b pointers are unused.
//
// What bounds it on the H100: the recurrence is serial in time, and each
// step is a [rows, H] x [H, 4H] product whose weights (1 MB at H=256) do not
// fit in one SM.  In this simple design every block re-reads its
// direction's wh from L2 at every step, so a step costs about one pass of
// wh through one SM's L2 port.  The design amortises that read over
// kRows batch rows per block (one block per direction and kRows rows):
// each thread owns one gate column j and keeps kRows running sums, the
// h_prev rows sit in shared memory where every read is a broadcast, and the
// loop over time runs inside the kernel so there is one launch per layer.
// Any H works: gate columns and (row, unit) pairs are strided over the threads,
// and the launcher raises the block's dynamic shared memory limit to what
// H needs (48 KB, the default limit, at H=512).

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;         // batch rows per block
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads)
lstm_stream_fwd_kernel(const float* __restrict__ xp_f,
                       const float* __restrict__ xp_b,
                       const float* __restrict__ mask,
                       const float* __restrict__ wh_f,
                       const float* __restrict__ wh_b, float* __restrict__ h_f,
                       float* __restrict__ c_f, float* __restrict__ h_b,
                       float* __restrict__ c_b, int T, int B, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* hs = smem;              // [kRows][H]  h of the previous step
  float* cs = hs + kRows * H;    // [kRows][H]  c of the previous step
  float* gates = cs + kRows * H; // [kRows][G]

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ wh = rev ? wh_b : wh_f;
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

    // gate pre-activations: xp + h_prev @ wh, one column per thread
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

extern "C" int asr_lstm_stream_fwd(const float* xp_f, const float* xp_b,
                                   const float* mask, const float* wh_f,
                                   const float* wh_b, float* h_f, float* c_f,
                                   float* h_b, float* c_b, int T, int B, int H,
                                   int ndir, void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const size_t smem = sizeof(float) * static_cast<size_t>(kRows) * (2 * H + G);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_stream_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  lstm_stream_fwd_kernel<<<grid, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b, c_b, T, B, H);
  return static_cast<int>(cudaGetLastError());
}
