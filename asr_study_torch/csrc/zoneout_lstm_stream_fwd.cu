// The zoneout-LSTM recurrence of one layer, forward pass, over one or two
// directions in one launch: the streamed-weight design, for the widths
// whose recurrent weights do not fit in one thread-block cluster (H=300,
// H=512).  The other widths take the cluster-resident design of
// zoneout_lstm_fwd.cu, by the size rule ops/zoneout_lstm.py
// `zoneout_geometry`.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_zoneout_lstm.py
// `_bifwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_zoneout_lstm.py `_fwd_kernel` (one direction)
// with ndir = 1.  Cell maths: ops/pallas_zoneout_lstm.py `_zo_cell_math`.
//
// The layout is csrc/lstm_stream_fwd.cu's (one block per direction and kRows
// batch rows, one gate column per thread, h_prev in shared memory, the loop
// over time inside the kernel); two [T, B, H] tensors more are streamed in.
// zh and zc are the zoneout mix weights, the weight of the new state: {0, 1}
// samples in train mode, the constant 1 - rate in eval mode.  After the
// LSTM update
//
//   h = zh * h_new + (1 - zh) * h_prev,   c = zc * c_new + (1 - zc) * c_prev
//
// and then a frame whose mask is 0 keeps h_prev and c_prev.  The mixed h and
// c are stored (the backward kernel recomputes c_new).
//
// Inputs: the bias-folded projections xp_f / xp_b [T, B, 4H], the mask
// [T, B], each direction's zh and zc [T, B, H] and wh [H, 4H], gate order
// i, f, g, o.  Outputs h and c of each direction [T, B, H], all in forward
// time order: lane 1 walks time backward and reads xp_b, zh_b, zc_b and the
// mask at T-1-s.  With ndir = 1 only lane 0 runs and the _b pointers are
// unused.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;         // batch rows per block
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads)
zoneout_lstm_fwd_kernel(const float* __restrict__ xp_f,
                        const float* __restrict__ xp_b,
                        const float* __restrict__ mask,
                        const float* __restrict__ zh_f,
                        const float* __restrict__ zh_b,
                        const float* __restrict__ zc_f,
                        const float* __restrict__ zc_b,
                        const float* __restrict__ wh_f,
                        const float* __restrict__ wh_b,
                        float* __restrict__ h_f, float* __restrict__ c_f,
                        float* __restrict__ h_b, float* __restrict__ c_b,
                        int T, int B, int H) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  float* hs = smem;              // [kRows][H]  h of the previous step
  float* cs = hs + kRows * H;    // [kRows][H]  c of the previous step
  float* gates = cs + kRows * H; // [kRows][G]

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ zh = rev ? zh_b : zh_f;
  const float* __restrict__ zc = rev ? zc_b : zc_f;
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

    // LSTM update, zoneout mix, then the hold where the frame is masked
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
      const size_t o = (row0 + r) * H + u;
      const float c_new = fg * c_prev + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float mh = zh[o];
      const float mc = zc[o];
      float h = mh * h_new + (1.f - mh) * h_prev;
      float c = mc * c_new + (1.f - mc) * c_prev;
      if (!(mask[row0 + r] > 0.f)) {
        c = c_prev;
        h = h_prev;
      }
      cs[i] = c;
      hs[i] = h;
      h_out[o] = h;
      c_out[o] = c;
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int asr_zoneout_lstm_stream_fwd(
    const float* xp_f, const float* xp_b, const float* mask,
    const float* zh_f, const float* zh_b, const float* zc_f,
    const float* zc_b, const float* wh_f, const float* wh_b, float* h_f,
    float* c_f, float* h_b, float* c_b, int T, int B, int H, int ndir,
    void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const size_t smem = sizeof(float) * static_cast<size_t>(kRows) * (2 * H + G);
  cudaError_t err = cudaFuncSetAttribute(
      zoneout_lstm_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  zoneout_lstm_fwd_kernel<<<grid, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, h_f, c_f, h_b,
      c_b, T, B, H);
  return static_cast<int>(cudaGetLastError());
}
