// The multiplicative-integration (MI) LSTM recurrence of one layer,
// backward pass, over one or two directions in one launch: the cotangent
// scans that give the gate pre-activation gradients dpre.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_mi_lstm.py
// `_bibwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_mi_lstm.py `_bwd_kernel` (one direction) with
// ndir = 1.  Row maths: ops/pallas_mi_lstm.py `_mi_row_bwd`.
//
// The layout and the three phases a step are csrc/bilstm_bwd.cu's (one
// block per direction and kRows batch rows; P1 recomputes the gates, P2 the
// cell's reverse-mode maths, P3 the partial sums of the recurrent cotangent
// through wht).  Two things differ from the LSTM:
//
// - P1 recomputes the MI pre-activation, alpha * xp * hp + beta1 * xp +
//   beta2 * hp + b with hp = h_prev @ wh (csrc/mi_lstm_fwd.cu);
// - the recurrent chain goes through hp, not through the pre-activation:
//   d pre / d hp = alpha * xp + beta2, so P2 keeps dhp = dpre * (alpha * xp
//   + beta2) in shared memory and P3 sums dhp @ wht.  dpre itself is the
//   output: dxp, dwh, dalpha, dbeta1, dbeta2 and db are sums over all T*B
//   rows outside the kernel (ops/mi_lstm.py `dir_grads`).
//
// The stored c is the cell's own (no mix), so tanh(c_t) reads it.  A held
// frame (mask 0) has dpre = 0 and passes dh and dc_next straight on.
//
// Inputs: the forward's arguments (xp_* [T, B, 4H] raw, the mask [T, B],
// wh_* [H, 4H], alpha_*, beta1_*, beta2_*, b_* [4H]), the transposes wht_*
// [4H, H] (contiguous), the forward's h and c of each direction [T, B, H]
// and the cotangents dh_f / dh_b [T, B, H] of the h outputs.  Output
// dpre_f / dpre_b [T, B, 4H], zero on masked frames.  With ndir = 1 only
// lane 0 runs.

#include <cuda_runtime.h>

namespace {

constexpr int kRows = 4;         // batch rows per block
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__global__ void __launch_bounds__(kMaxThreads)
mi_lstm_bwd_kernel(const float* __restrict__ xp_f,
                   const float* __restrict__ xp_b,
                   const float* __restrict__ mask,
                   const float* __restrict__ wh_f,
                   const float* __restrict__ wh_b,
                   const float* __restrict__ wht_f,
                   const float* __restrict__ wht_b,
                   const float* __restrict__ al_f,
                   const float* __restrict__ al_b,
                   const float* __restrict__ b1_f,
                   const float* __restrict__ b1_b,
                   const float* __restrict__ b2_f,
                   const float* __restrict__ b2_b,
                   const float* __restrict__ bias_f,
                   const float* __restrict__ bias_b,
                   const float* __restrict__ h_f,
                   const float* __restrict__ c_f,
                   const float* __restrict__ h_b,
                   const float* __restrict__ c_b,
                   const float* __restrict__ dh_f,
                   const float* __restrict__ dh_b,
                   float* __restrict__ dpre_f, float* __restrict__ dpre_b,
                   int T, int B, int H, int nsplit) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int RH = kRows * H;
  float* hs = smem;                  // [kRows][H]  h_prev of this step
  float* hold = hs + RH;             // [kRows][H]  dh passed by held frames
  float* dcs = hold + RH;            // [kRows][H]  dc_next
  float* part = dcs + RH;            // [nsplit][kRows][H]  dh_rec partials
  float* gates = part + nsplit * RH; // [kRows][G]  gates, then dhp

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ wh = rev ? wh_b : wh_f;
  const float* __restrict__ wht = rev ? wht_b : wht_f;
  const float* __restrict__ al = rev ? al_b : al_f;
  const float* __restrict__ b1 = rev ? b1_b : b1_f;
  const float* __restrict__ b2 = rev ? b2_b : b2_f;
  const float* __restrict__ bias = rev ? bias_b : bias_f;
  const float* __restrict__ h = rev ? h_b : h_f;
  const float* __restrict__ c = rev ? c_b : c_f;
  const float* __restrict__ dh_out = rev ? dh_b : dh_f;
  float* __restrict__ dpre = rev ? dpre_b : dpre_f;
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

    // P1: the MI gate pre-activations, recomputed
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

    // P2: the cell's reverse-mode maths, one (row, unit) per thread; dpre
    // goes out, dhp = dpre * (alpha * xp + beta2) replaces the gates
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
      const float p[4] = {m ? dc * gg * ig * (1.f - ig) : 0.f,
                          m ? dc * c_prev * fg * (1.f - fg) : 0.f,
                          m ? dc * ig * (1.f - gg * gg) : 0.f,
                          m ? d_o * og * (1.f - og) : 0.f};
      const float* x = xp + (row0 + r) * G;
      float* out = dpre + (row0 + r) * G;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = k * H + u;
        out[j] = p[k];
        g[j] = p[k] * (__ldg(al + j) * x[j] + __ldg(b2 + j));
      }
      // held frames pass h and c (and their cotangents) straight through
      hold[i] = m ? 0.f : dh;
      if (m) dcs[i] = dc * fg;
    }
    __syncthreads();

    // P3: dh_rec = dhp @ wht, partial sums over the 4H reduction; next
    // step's h_prev
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

extern "C" int asr_mi_lstm_bwd(
    const float* xp_f, const float* xp_b, const float* mask,
    const float* wh_f, const float* wh_b, const float* wht_f,
    const float* wht_b, const float* al_f, const float* al_b,
    const float* b1_f, const float* b1_b, const float* b2_f,
    const float* b2_b, const float* bias_f, const float* bias_b,
    const float* h_f, const float* c_f, const float* h_b, const float* c_b,
    const float* dh_f, const float* dh_b, float* dpre_f, float* dpre_b,
    int T, int B, int H, int ndir, void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const int nsplit = threads / H > 1 ? threads / H : 1;
  const size_t smem = sizeof(float) * static_cast<size_t>(kRows) *
                      ((3 + nsplit) * static_cast<size_t>(H) + G);
  cudaError_t err = cudaFuncSetAttribute(
      mi_lstm_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  mi_lstm_bwd_kernel<<<grid, threads, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      xp_f, xp_b, mask, wh_f, wh_b, wht_f, wht_b, al_f, al_b, b1_f, b1_b,
      b2_f, b2_b, bias_f, bias_b, h_f, c_f, h_b, c_b, dh_f, dh_b, dpre_f,
      dpre_b, T, B, H, nsplit);
  return static_cast<int>(cudaGetLastError());
}
