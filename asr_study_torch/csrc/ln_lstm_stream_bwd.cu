// The layer-norm LSTM recurrence of one layer, backward pass, over one or
// two directions in one launch: the cotangent scans that give dpre, the
// gate pre-activation gradients, and dcn, the gradient of the cell
// LayerNorm's output.  The streamed-weight design, for the widths whose
// recurrent weights do not fit in one thread-block cluster (H=300, H=512);
// the other widths take the cluster-resident design of ln_lstm_bwd.cu, by
// the size rule ops/ln_lstm.py `ln_geometry`.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_ln_lstm.py
// `_bibwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_ln_lstm.py `_ln_bwd_kernel` (one direction) with
// ndir = 1.  Row maths: ops/pallas_ln_lstm.py `_ln_row_bwd`, with the
// held-frame rule of its masked branch: there dh_prev takes the whole dh
// and dc_prev = dc_next.  With ndir = 1 only lane 0 (the forward direction)
// runs and the _b pointers are unused.
//
// Inputs: the forward's arguments (xpn [T, B, 4H], the mask [T, B], wh
// [H, 4H], gh [4H], gc and bc [H] of each direction), wht [4H, H] (wh
// transposed, made contiguous outside, so that thread u reads row j of wht
// coalesced), the forward's h and raw c of each direction [T, B, H], and the
// cotangents of the h outputs dh_f / dh_b [T, B, H].  Outputs dpre [T, B, 4H]
// and dcn [T, B, H] of each direction, zero on masked frames.  The
// parameter gradients (wh, the LayerNorm gains and bias) are one batched
// pass over these sequences outside the kernel.
//
// Walk order: the forward direction's cotangent chain runs t = T-1 .. 0, the
// reversed direction's t = 0 .. T-1.  h_prev and c_prev are read straight
// from the saved sequences at t-1 (forward) or t+1 (reversed), zero past
// the ends.  A step, per block of kRows batch rows (eight barriers):
//
//   P1  hp = h_prev @ wh                     (thread per gate column j)
//   P2  mean and rstd of hp per (row, gate block) and of c[t] per row, one
//       warp a pair
//   P3  recompute the gates and chat; dh = dh_out[t] + dh_next;
//       dcn = dh * o * (1 - tc^2); keep dcn*gc, chat and dh
//   P4  the two means over H of the cell LN's backward, per row
//   P5  dc = dc_next + LN-backward(dcn*gc); dpre; dpre and dcn zeroed on
//       masked frames (after dc used the unmasked dcn) and stored;
//       dq = dpre * gh; dc_next = m ? dc*f : dc_next; hold = m ? 0 : dh
//   P6  the two means of each gate block's LN backward
//   P7  dhp = rstd * (dq - mean(dq) - xhat * mean(dq*xhat)), in place
//   P8  dh_rec = dhp @ wht, split over the 4H reduction into nsplit partial
//       sums per unit; h_prev of the next step is loaded here too
//
// and the next step's P3 forms dh_next = hold + sum of the partials.
//
// What bounds it on the H100: as in lstm_stream_bwd.cu, each step streams the
// direction's wh and wht (1 MB each at H=256) from L2 through one SM, and
// the step is serial; the LayerNorm backward adds three reductions and
// five barriers a step but no traffic to device memory.  Shared memory is
// kRows * (6H + nsplit*H + 8H + 20) floats: 74,048 bytes at H=256, above
// the 48 KB default, so every launch raises the limit.
//
// The bfloat16-weight form (asr_ln_lstm_stream_bwd_bf16;
// ops/pallas_ln_lstm.py `_ln_bwd_kernel` with a bfloat16 wh) is the same
// kernel on the weight type W = __nv_bfloat16: wh and wht (the wrapper's
// transpose of the bfloat16 wh) are read as bfloat16, h_prev is rounded to
// bfloat16 where it is loaded into hs (P1 recomputes hp and its statistics
// from the rounded h_prev, as `_mm` does; hs feeds nothing else, and c_prev
// stays float32), and P7 writes dhp rounded to bfloat16, the operand of
// P8's `dhp @ wht` (JAX `_mm(dhp, wht)`).  The products are float32 fmaf
// on the converted weights, in the float32 form's order; dpre and dcn come
// out unrounded, and its shared memory is the float32 form's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kRows = 4;         // batch rows per block
constexpr int kMaxThreads = 1024;
constexpr float kEps = 1e-5f;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// (mean, 1/sqrt(var + eps)) of x[0..n) by one warp, in every lane
__device__ __forceinline__ float2 warp_stats(const float* x, int n,
                                             int lane) {
  float s = 0.f;
  for (int u = lane; u < n; u += 32) s += x[u];
  const float mu = warp_sum(s) / n;
  float s2 = 0.f;
  for (int u = lane; u < n; u += 32) {
    const float d = x[u] - mu;
    s2 += d * d;
  }
  return make_float2(mu, 1.f / sqrtf(warp_sum(s2) / n + kEps));
}

// x as it enters a product with weights of type W: itself, or rounded to
// the nearest bfloat16
template <typename W>
__device__ __forceinline__ float as_operand(float x) {
  if constexpr (std::is_same_v<W, __nv_bfloat16>)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// one weight, read through the read-only cache, as float32; a bfloat16
// by its 16 bits, the high half of the float32 of the same value
__device__ __forceinline__ float load_w(const float* w) { return __ldg(w); }

__device__ __forceinline__ float load_w(const __nv_bfloat16* w) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(w));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// acc[r] += x[r * ldx + k] * w[k * ldw] for k = k0 .. k1 - 1 in turn: the
// bfloat16-weight form's product, the weights of kAhead rows loaded ahead
// of their FMAs (zoneout_lstm_stream_fwd.cu says why); the sums are the
// float32 form's, in its order.
constexpr int kAhead = 8;

__device__ __forceinline__ void product_ahead(float (&acc)[kRows],
                                              const float* x, int ldx,
                                              const __nv_bfloat16* w,
                                              int ldw, int k0, int k1) {
  int k = k0;
  for (; k + kAhead <= k1; k += kAhead) {
    float wk[kAhead];
#pragma unroll
    for (int q = 0; q < kAhead; ++q)
      wk[q] = load_w(w + static_cast<size_t>(k + q) * ldw);
#pragma unroll
    for (int q = 0; q < kAhead; ++q) {
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = fmaf(x[r * ldx + k + q], wk[q], acc[r]);
    }
  }
  for (; k < k1; ++k) {
    const float wk = load_w(w + static_cast<size_t>(k) * ldw);
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = fmaf(x[r * ldx + k], wk, acc[r]);
  }
}

template <typename W>
__global__ void __launch_bounds__(kMaxThreads)
ln_lstm_bwd_kernel(const float* __restrict__ xpn_f,
                   const float* __restrict__ xpn_b,
                   const float* __restrict__ mask,
                   const W* __restrict__ wh_f,
                   const W* __restrict__ wh_b,
                   const W* __restrict__ wht_f,
                   const W* __restrict__ wht_b,
                   const float* __restrict__ gh_f,
                   const float* __restrict__ gh_b,
                   const float* __restrict__ gc_f,
                   const float* __restrict__ gc_b,
                   const float* __restrict__ bc_f,
                   const float* __restrict__ bc_b,
                   const float* __restrict__ h_f,
                   const float* __restrict__ c_f,
                   const float* __restrict__ h_b,
                   const float* __restrict__ c_b,
                   const float* __restrict__ dh_f,
                   const float* __restrict__ dh_b,
                   float* __restrict__ dpre_f, float* __restrict__ dcn_f,
                   float* __restrict__ dpre_b, float* __restrict__ dcn_b,
                   int T, int B, int H, int nsplit) {
  extern __shared__ float smem[];
  constexpr bool kRounded = std::is_same_v<W, __nv_bfloat16>;
  const int G = 4 * H;
  const int RH = kRows * H;
  float* hs = smem;                  // [kRows][H]  h_prev of this step,
                                     // as P1's operand
  float* hold = hs + RH;             // [kRows][H]  dh passed by held frames
  float* dcs = hold + RH;            // [kRows][H]  dc_next
  float* ys = dcs + RH;              // [kRows][H]  dcn * gc
  float* chs = ys + RH;              // [kRows][H]  chat
  float* dhs = chs + RH;             // [kRows][H]  dh
  float* part = dhs + RH;            // [nsplit][kRows][H]  dh_rec partials
  float* hp = part + nsplit * RH;    // [kRows][G]  h_prev @ wh
  float* dq = hp + kRows * G;        // [kRows][G]  dpre * gh, then dhp
  float* mu_h = dq + kRows * G;      // [kRows][4]
  float* rs_h = mu_h + 4 * kRows;    // [kRows][4]
  float* m1_h = rs_h + 4 * kRows;    // [kRows][4]
  float* m2_h = m1_h + 4 * kRows;    // [kRows][4]
  float* mu_c = m2_h + 4 * kRows;    // [kRows]
  float* rs_c = mu_c + kRows;        // [kRows]
  float* m1_c = rs_c + kRows;        // [kRows]
  float* m2_c = m1_c + kRows;        // [kRows]

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xpn = rev ? xpn_b : xpn_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
  const W* __restrict__ wht = rev ? wht_b : wht_f;
  const float* __restrict__ gh = rev ? gh_b : gh_f;
  const float* __restrict__ gc = rev ? gc_b : gc_f;
  const float* __restrict__ bc = rev ? bc_b : bc_f;
  const float* __restrict__ h = rev ? h_b : h_f;
  const float* __restrict__ c = rev ? c_b : c_f;
  const float* __restrict__ dh_out = rev ? dh_b : dh_f;
  float* __restrict__ dpre = rev ? dpre_b : dpre_f;
  float* __restrict__ dcn_out = rev ? dcn_b : dcn_f;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  const int step_dir = rev ? 1 : -1;       // t_prev = t + step_dir
  const int chunk = (G + nsplit - 1) / nsplit;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  // zero everything once: rows past B stay zero in hs and dq for good
  for (int i = threadIdx.x; i < (6 + nsplit) * RH + 2 * kRows * G;
       i += blockDim.x)
    smem[i] = 0.f;
  __syncthreads();
  {
    const int t = rev ? 0 : T - 1;
    const int tp = t + step_dir;
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x)
      if (tp >= 0 && tp < T)
        hs[i] = as_operand<W>(h[(static_cast<size_t>(tp) * B + b0) * H + i]);
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    const int tp = t + step_dir;
    const bool has_prev = tp >= 0 && tp < T;
    const size_t row0 = static_cast<size_t>(t) * B + b0;

    // P1: the h-side pre-activations, recomputed
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      if constexpr (kRounded) {
        product_ahead(acc, hs, H, wh + j, G, 0, H);
      } else {
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          const float w = load_w(wh + static_cast<size_t>(k) * G + j);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r] = fmaf(hs[r * H + k], w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) hp[r * G + j] = acc[r];
    }
    __syncthreads();

    // P2: statistics of each (row, gate block) of hp, then of each row's c
    for (int p = warp; p < 5 * kRows; p += nwarps) {
      const bool gate = p < 4 * kRows;
      const int r = gate ? p >> 2 : p - 4 * kRows;
      if (r >= rows) continue;
      const float2 st = warp_stats(
          gate ? hp + r * G + (p & 3) * H : c + (row0 + r) * H, H, lane);
      if (lane == 0) {
        (gate ? mu_h[p] : mu_c[r]) = st.x;
        (gate ? rs_h[p] : rs_c[r]) = st.y;
      }
    }
    __syncthreads();

    // P3: the forward recomputed, dh and dcn
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H;
      const int u = i - r * H;
      const float* hpr = hp + r * G;
      const float* x = xpn + (row0 + r) * G;
      const int j = 3 * H + u;
      const float o_pre = fmaf((hpr[j] - mu_h[4 * r + 3]) * rs_h[4 * r + 3],
                               gh[j], x[j]);
      const float og = sigmoidf(o_pre);
      const float chat = (c[(row0 + r) * H + u] - mu_c[r]) * rs_c[r];
      const float tc = tanhf(fmaf(chat, gc[u], bc[u]));
      float dh = dh_out[(row0 + r) * H + u] + hold[i];
      for (int q = 0; q < nsplit; ++q) dh += part[q * RH + i];
      ys[i] = dh * og * (1.f - tc * tc) * gc[u];
      chs[i] = chat;
      dhs[i] = dh;
    }
    __syncthreads();

    // P4: the means of the cell LayerNorm's backward, per row
    for (int r = warp; r < rows; r += nwarps) {
      float s1 = 0.f, s2 = 0.f;
      for (int u = lane; u < H; u += 32) {
        const float y = ys[r * H + u];
        s1 += y;
        s2 += y * chs[r * H + u];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        m1_c[r] = s1 / H;
        m2_c[r] = s2 / H;
      }
    }
    __syncthreads();

    // P5: dc, dpre and dcn; the carried cotangents
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H;
      const int u = i - r * H;
      const float* hpr = hp + r * G;
      const float* x = xpn + (row0 + r) * G;
      float g[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = k * H + u;
        const float xhat = (hpr[j] - mu_h[4 * r + k]) * rs_h[4 * r + k];
        g[k] = fmaf(xhat, gh[j], x[j]);
      }
      const float ig = sigmoidf(g[0]);
      const float fg = sigmoidf(g[1]);
      const float gg = tanhf(g[2]);
      const float og = sigmoidf(g[3]);
      const float chat = chs[i];
      const float tc = tanhf(fmaf(chat, gc[u], bc[u]));
      const float dh = dhs[i];
      const float dc = dcs[i] + rs_c[r] * (ys[i] - m1_c[r] - chat * m2_c[r]);
      const float c_prev =
          has_prev ? c[(static_cast<size_t>(tp) * B + b0 + r) * H + u] : 0.f;
      const bool m = mask[row0 + r] > 0.f;
      const float p[4] = {m ? dc * gg * ig * (1.f - ig) : 0.f,
                          m ? dc * c_prev * fg * (1.f - fg) : 0.f,
                          m ? dc * ig * (1.f - gg * gg) : 0.f,
                          m ? dh * tc * og * (1.f - og) : 0.f};
      float* out = dpre + (row0 + r) * G;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = k * H + u;
        out[j] = p[k];
        dq[r * G + j] = p[k] * gh[j];
      }
      dcn_out[(row0 + r) * H + u] = m ? dh * og * (1.f - tc * tc) : 0.f;
      // held frames pass h and c (and their cotangents) straight through
      hold[i] = m ? 0.f : dh;
      if (m) dcs[i] = dc * fg;
    }
    __syncthreads();

    // P6: the means of each gate block's LayerNorm backward
    for (int p = warp; p < 4 * rows; p += nwarps) {
      const float* hpr = hp + (p >> 2) * G + (p & 3) * H;
      const float* dqr = dq + (p >> 2) * G + (p & 3) * H;
      float s1 = 0.f, s2 = 0.f;
      for (int u = lane; u < H; u += 32) {
        const float y = dqr[u];
        s1 += y;
        s2 += y * (hpr[u] - mu_h[p]) * rs_h[p];
      }
      s1 = warp_sum(s1);
      s2 = warp_sum(s2);
      if (lane == 0) {
        m1_h[p] = s1 / H;
        m2_h[p] = s2 / H;
      }
    }
    __syncthreads();

    // P7: dhp, in place of dq
    for (int i = threadIdx.x; i < rows * G; i += blockDim.x) {
      const int r = i / G;
      const int p = 4 * r + (i - r * G) / H;
      const float xhat = (hp[i] - mu_h[p]) * rs_h[p];
      dq[i] = as_operand<W>(rs_h[p] * (dq[i] - m1_h[p] - xhat * m2_h[p]));
    }
    __syncthreads();

    // P8: dh_rec partial sums over the 4H reduction; next step's h_prev
    for (int i = threadIdx.x; i < nsplit * H; i += blockDim.x) {
      const int q = i / H;
      const int u = i - q * H;
      const int j1 = min(G, (q + 1) * chunk);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      if constexpr (kRounded) {
        product_ahead(acc, dq, G, wht + u, H, q * chunk, j1);
      } else {
#pragma unroll 4
        for (int j = q * chunk; j < j1; ++j) {
          const float w = load_w(wht + static_cast<size_t>(j) * H + u);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r] = fmaf(dq[r * G + j], w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[q * RH + r * H + u] = acc[r];
    }
    {
      const int tpn = tp + step_dir;        // the next step's t_prev
      const bool ok = s + 1 < T && tpn >= 0 && tpn < T;
      for (int i = threadIdx.x; i < rows * H; i += blockDim.x)
        hs[i] = ok ? as_operand<W>(
                         h[(static_cast<size_t>(tpn) * B + b0) * H + i])
                   : 0.f;
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const float* xpn_f, const float* xpn_b, const float* mask,
           const W* wh_f, const W* wh_b, const W* wht_f, const W* wht_b,
           const float* gh_f, const float* gh_b, const float* gc_f,
           const float* gc_b, const float* bc_f, const float* bc_b,
           const float* h_f, const float* c_f, const float* h_b,
           const float* c_b, const float* dh_f, const float* dh_b,
           float* dpre_f, float* dcn_f, float* dpre_b, float* dcn_b, int T,
           int B, int H, int ndir, void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const int nsplit = threads / H > 1 ? threads / H : 1;
  const size_t smem =
      sizeof(float) * static_cast<size_t>(kRows) *
      ((6 + nsplit) * static_cast<size_t>(H) + 2 * static_cast<size_t>(G) +
       20);
  cudaError_t err = cudaFuncSetAttribute(
      ln_lstm_bwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  ln_lstm_bwd_kernel<W><<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      xpn_f, xpn_b, mask, wh_f, wh_b, wht_f, wht_b, gh_f, gh_b, gc_f, gc_b,
      bc_f, bc_b, h_f, c_f, h_b, c_b, dh_f, dh_b, dpre_f, dcn_f, dpre_b,
      dcn_b, T, B, H, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int asr_ln_lstm_stream_bwd(
    const float* xpn_f, const float* xpn_b, const float* mask,
    const float* wh_f, const float* wh_b, const float* wht_f,
    const float* wht_b, const float* gh_f, const float* gh_b,
    const float* gc_f, const float* gc_b, const float* bc_f,
    const float* bc_b, const float* h_f, const float* c_f, const float* h_b,
    const float* c_b, const float* dh_f, const float* dh_b, float* dpre_f,
    float* dcn_f, float* dpre_b, float* dcn_b, int T, int B, int H, int ndir,
    void* stream) {
  return launch<float>(xpn_f, xpn_b, mask, wh_f, wh_b, wht_f, wht_b, gh_f,
                       gh_b, gc_f, gc_b, bc_f, bc_b, h_f, c_f, h_b, c_b, dh_f,
                       dh_b, dpre_f, dcn_f, dpre_b, dcn_b, T, B, H, ndir,
                       stream);
}

// The bfloat16-weight form: asr_ln_lstm_stream_bwd's arguments with wh_f /
// wh_b bfloat16 [H, 4H] and wht_f / wht_b bfloat16 [4H, H].
extern "C" int asr_ln_lstm_stream_bwd_bf16(
    const float* xpn_f, const float* xpn_b, const float* mask,
    const __nv_bfloat16* wh_f, const __nv_bfloat16* wh_b,
    const __nv_bfloat16* wht_f, const __nv_bfloat16* wht_b,
    const float* gh_f, const float* gh_b, const float* gc_f,
    const float* gc_b, const float* bc_f, const float* bc_b,
    const float* h_f, const float* c_f, const float* h_b, const float* c_b,
    const float* dh_f, const float* dh_b, float* dpre_f, float* dcn_f,
    float* dpre_b, float* dcn_b, int T, int B, int H, int ndir,
    void* stream) {
  return launch<__nv_bfloat16>(xpn_f, xpn_b, mask, wh_f, wh_b, wht_f, wht_b,
                               gh_f, gh_b, gc_f, gc_b, bc_f, bc_b, h_f, c_f,
                               h_b, c_b, dh_f, dh_b, dpre_f, dcn_f, dpre_b,
                               dcn_b, T, B, H, ndir, stream);
}
