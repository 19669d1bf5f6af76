// The zoneout-LSTM recurrence of one layer, backward pass, over one or two
// directions in one launch: the cotangent scans that give the gate
// pre-activation gradients dxp.  The streamed-weight design, for the
// widths whose recurrent weights do not fit in one thread-block cluster
// (H=300, H=512); the other widths take the cluster-resident design of
// zoneout_lstm_bwd.cu, by the size rule ops/zoneout_lstm.py
// `zoneout_geometry`.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_zoneout_lstm.py
// `_bibwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_zoneout_lstm.py `_bwd_kernel` (one direction)
// with ndir = 1.  Row maths: ops/pallas_zoneout_lstm.py `_zo_row_bwd`.
//
// The layout and the three phases a step are csrc/lstm_stream_bwd.cu's (one
// block per direction and kRows batch rows; P1 recomputes the gates, P2 the
// cell's reverse-mode maths, P3 the partial sums of dpre @ wht).  What
// zoneout changes is P2.  The stored h and c are the MIXED states, so the
// cell's own c_new = f * c_prev + i * g is recomputed from the gates and the
// stored c_prev, and tanh(c_new) (not tanh of the stored c) feeds the
// output gate.  On a real frame, with dh = dh_out + the carried cotangent:
//
//   dc_new  = dc_next * zc + dh * zh * o * (1 - tanh(c_new)^2)
//   dpre    = the LSTM's gate cotangents from dc_new and dh * zh
//   dh_prev = dpre @ wh^T + dh * (1 - zh)
//   dc_prev = dc_new * f + dc_next * (1 - zc)
//
// and a held frame (mask 0) has dpre = 0 and passes dh and dc_next straight
// on.  zh and zc [T, B, H] of each direction are in forward time order, as
// the forward kernel read them.
//
// Inputs: the forward's arguments (xp_f / xp_b [T, B, 4H], the mask [T, B],
// zh_* and zc_*, wh_* [H, 4H]), the transposes wht_* [4H, H] (contiguous),
// the forward's h and c of each direction [T, B, H], and the cotangents of
// the h outputs dh_f / dh_b [T, B, H].  Output dxp_f / dxp_b [T, B, 4H],
// zero on masked frames.  dwh = h_prev^T dxp is one matmul per direction
// outside the kernel.  With ndir = 1 only lane 0 runs.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;         // batch rows per block
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads)
zoneout_lstm_bwd_kernel(const float* __restrict__ xp_f,
                        const float* __restrict__ xp_b,
                        const float* __restrict__ mask,
                        const float* __restrict__ zh_f,
                        const float* __restrict__ zh_b,
                        const float* __restrict__ zc_f,
                        const float* __restrict__ zc_b,
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
  float* hold = hs + RH;             // [kRows][H]  dh passed straight back
  float* dcs = hold + RH;            // [kRows][H]  dc_next
  float* part = dcs + RH;            // [nsplit][kRows][H]  dh_rec partials
  float* gates = part + nsplit * RH; // [kRows][G]  gates, then dpre

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ zh = rev ? zh_b : zh_f;
  const float* __restrict__ zc = rev ? zc_b : zc_f;
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

    // P2: the zoneout cell's reverse-mode maths, one (row, unit) per thread
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H;
      const int u = i - r * H;
      float* g = gates + r * G;
      const float ig = sigmoidf(g[u]);
      const float fg = sigmoidf(g[H + u]);
      const float gg = tanhf(g[2 * H + u]);
      const float og = sigmoidf(g[3 * H + u]);
      const size_t o = (row0 + r) * H + u;
      float dh = dh_out[o] + hold[i];
      for (int q = 0; q < nsplit; ++q) dh += part[q * RH + i];
      const float c_prev =
          has_prev ? c[(static_cast<size_t>(tp) * B + b0 + r) * H + u] : 0.f;
      const float tc = tanhf(fg * c_prev + ig * gg);     // tanh(c_new)
      const float mh = zh[o];
      const float mc = zc[o];
      const float dh_new = dh * mh;
      const float dc_next = dcs[i];
      const float dc = dc_next * mc + dh_new * og * (1.f - tc * tc);
      const bool m = mask[row0 + r] > 0.f;
      const float p_i = m ? dc * gg * ig * (1.f - ig) : 0.f;
      const float p_f = m ? dc * c_prev * fg * (1.f - fg) : 0.f;
      const float p_g = m ? dc * ig * (1.f - gg * gg) : 0.f;
      const float p_o = m ? dh_new * tc * og * (1.f - og) : 0.f;
      g[u] = p_i;
      g[H + u] = p_f;
      g[2 * H + u] = p_g;
      g[3 * H + u] = p_o;
      float* out = dxp + (row0 + r) * G;
      out[u] = p_i;
      out[H + u] = p_f;
      out[2 * H + u] = p_g;
      out[3 * H + u] = p_o;
      // a real frame passes dh * (1 - zh) and dc_next * (1 - zc) past the
      // cell; a held frame passes dh and dc_next whole
      hold[i] = m ? dh * (1.f - mh) : dh;
      if (m) dcs[i] = dc * fg + dc_next * (1.f - mc);
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

extern "C" int asr_zoneout_lstm_stream_bwd(
    const float* xp_f, const float* xp_b, const float* mask,
    const float* zh_f, const float* zh_b, const float* zc_f,
    const float* zc_b, const float* wh_f, const float* wh_b,
    const float* wht_f, const float* wht_b, const float* h_f,
    const float* c_f, const float* h_b, const float* c_b, const float* dh_f,
    const float* dh_b, float* dxp_f, float* dxp_b, int T, int B, int H,
    int ndir, void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const int nsplit = threads / H > 1 ? threads / H : 1;
  const size_t smem = sizeof(float) * static_cast<size_t>(kRows) *
                      ((3 + nsplit) * static_cast<size_t>(H) + G);
  cudaError_t err = cudaFuncSetAttribute(
      zoneout_lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  zoneout_lstm_bwd_kernel<<<grid, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, wht_f, wht_b,
      h_f, c_f, h_b, c_b, dh_f, dh_b, dxp_f, dxp_b, T, B, H, nsplit);
  return static_cast<int>(cudaGetLastError());
}
