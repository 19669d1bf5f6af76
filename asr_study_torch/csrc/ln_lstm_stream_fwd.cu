// The layer-norm LSTM recurrence of one layer, forward pass, over one or
// two directions in one launch: the streamed-weight design, for the widths
// whose recurrent weights do not fit in one thread-block cluster (H=300,
// H=512).  The other widths take the cluster-resident design of
// ln_lstm_fwd.cu; ops/ln_lstm.py `ln_geometry` picks between the two by
// size.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_ln_lstm.py
// `_bifwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_ln_lstm.py `_ln_fwd_kernel` (one direction) with
// ndir = 1.  Cell maths: ops/pallas_ln_lstm.py `_ln_cell_fwd_math`.
//
// Inputs are the streamed xpn_f / xpn_b [T, B, 4H] (LN of the input
// projections per gate block, with b and ln_h's bias folded in, computed
// outside), the frame mask [T, B], the recurrent weights wh_f / wh_b
// [H, 4H] (gate order i, f, g, o), the ln_h gains gh [4H] and the ln_c gain
// and bias gc, bc [H] of each direction.  Outputs h and c of each direction
// [T, B, H] in forward time order; c is the raw cell state (before its
// LayerNorm), which the backward reads.  Lane 1 (the reverse direction)
// walks time backward.  Each lane starts from the carried state h_init /
// c_init [ndir, B, H] or, where they are null, from zeros (bilstm_fwd.cu
// says what the carry is for), and a frame whose mask is 0 keeps the
// previous h and c.  With ndir = 1 only lane 0 runs and the _b pointers are
// unused.  LayerNorm statistics are over all H units,
// mean first and then the mean of the squared deviations, eps 1e-5.
//
// A step, per block of kRows batch rows (five barriers):
//
//   P1  hp = h_prev @ wh                     (thread per gate column j)
//   P2  mean and rstd of hp per (row, gate block): one warp a pair, the
//       lanes strided over the H units, two shuffle reductions
//   P3  pre = xpn + xhat * gh; gates; c = f*c_prev + i*g  (per (row, unit))
//   P4  mean and rstd of c per row, one warp a row
//   P5  h = o * tanh(chat * gc + bc); hold on masked frames; store
//
// What bounds it on the H100: as in lstm_stream_fwd.cu, each step streams the
// direction's wh (1 MB at H=256) from L2 through one SM, and the step is
// serial.  The LayerNorm adds two reductions and two barriers a step but no
// traffic: hp, the new c and the statistics stay in shared memory.  Any H
// works; the launcher raises the dynamic shared memory limit to what H
// needs.
//
// The bfloat16-weight form (asr_ln_lstm_stream_fwd_bf16; train --bf16, the
// JAX trainer's compute_dtype, under which the Pallas kernels run with a
// bfloat16 wh) is the same kernel on the weight type W = __nv_bfloat16: wh
// is read as bfloat16 and h_prev enters P1's product rounded to bfloat16
// (ops/pallas_ln_lstm.py `_mm(h_prev, wh)`).  P2 takes its statistics from
// that product of the rounded operands (JAX `_ln_stats(_mm(...))`).  The
// block keeps h unrounded in hs for the hold of a masked frame, and beside
// it the rounded copy hr that P1 reads, written where hs is; the products
// are float32 fmaf on the converted weights, summed in the float32 form's
// order, and xpn, the mask, the gains, hp, h and c stay float32.  In the
// float32 form hr is hs.

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

// dynamic shared memory of a block: hs, cs, cn, os, hp and the statistics,
// and for the bfloat16-weight form the rounded copy hr
template <typename W>
size_t smem_bytes(int H) {
  constexpr int kCopies = std::is_same_v<W, __nv_bfloat16> ? 5 : 4;
  return sizeof(float) * static_cast<size_t>(kRows) *
         (kCopies * static_cast<size_t>(H) + 4 * static_cast<size_t>(H) +
          10);
}

template <typename W>
__global__ void __launch_bounds__(kMaxThreads)
ln_lstm_fwd_kernel(const float* __restrict__ xpn_f,
                   const float* __restrict__ xpn_b,
                   const float* __restrict__ mask,
                   const W* __restrict__ wh_f,
                   const W* __restrict__ wh_b,
                   const float* __restrict__ gh_f,
                   const float* __restrict__ gh_b,
                   const float* __restrict__ gc_f,
                   const float* __restrict__ gc_b,
                   const float* __restrict__ bc_f,
                   const float* __restrict__ bc_b, float* __restrict__ h_f,
                   float* __restrict__ c_f, float* __restrict__ h_b,
                   float* __restrict__ c_b, const float* __restrict__ h_init,
                   const float* __restrict__ c_init, int T, int B, int H) {
  extern __shared__ float smem[];
  constexpr bool kRounded = std::is_same_v<W, __nv_bfloat16>;
  const int G = 4 * H;
  const int RH = kRows * H;
  float* hs = smem;                // [kRows][H]  h of the previous step
  float* cs = hs + RH;             // [kRows][H]  c of the previous step
  float* cn = cs + RH;             // [kRows][H]  this step's c
  float* os = cn + RH;             // [kRows][H]  this step's output gate
  float* hp = os + RH;             // [kRows][G]  h_prev @ wh
  float* mu_h = hp + kRows * G;    // [kRows][4]
  float* rs_h = mu_h + 4 * kRows;  // [kRows][4]
  float* mu_c = rs_h + 4 * kRows;  // [kRows]
  float* rs_c = mu_c + kRows;      // [kRows]
  // [kRows][H]  h as P1's operand: rounded, or hs itself
  float* hr = kRounded ? rs_c + kRows : hs;

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xpn = rev ? xpn_b : xpn_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
  const float* __restrict__ gh = rev ? gh_b : gh_f;
  const float* __restrict__ gc = rev ? gc_b : gc_f;
  const float* __restrict__ bc = rev ? bc_b : bc_f;
  float* __restrict__ h_out = rev ? h_b : h_f;
  float* __restrict__ c_out = rev ? c_b : c_f;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;

  // the carried state of the block's rows, zeros where none is given
  const size_t init0 = (static_cast<size_t>(blockIdx.y) * B + b0) * H;
  for (int i = threadIdx.x; i < RH; i += blockDim.x) {
    const bool ok = i < rows * H;
    hs[i] = (h_init != nullptr && ok) ? h_init[init0 + i] : 0.f;
    cs[i] = (c_init != nullptr && ok) ? c_init[init0 + i] : 0.f;
    if (kRounded) hr[i] = as_operand<W>(hs[i]);
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s;
    const size_t row0 = static_cast<size_t>(t) * B + b0;

    // P1: the h-side pre-activations, kept apart from xpn
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      if constexpr (kRounded) {
        product_ahead(acc, hr, H, wh + j, G, 0, H);
      } else {
#pragma unroll 4
        for (int k = 0; k < H; ++k) {
          const float w = load_w(wh + static_cast<size_t>(k) * G + j);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r] = fmaf(hr[r * H + k], w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) hp[r * G + j] = acc[r];
    }
    __syncthreads();

    // P2: statistics of each (row, gate block) of hp
    for (int p = warp; p < 4 * rows; p += nwarps) {
      const float2 st = warp_stats(hp + (p >> 2) * G + (p & 3) * H, H, lane);
      if (lane == 0) {
        mu_h[p] = st.x;
        rs_h[p] = st.y;
      }
    }
    __syncthreads();

    // P3: gates and the new c
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H;
      const int u = i - r * H;
      const float* x = xpn + (row0 + r) * G;
      float pre[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int j = k * H + u;
        const float xhat = (hp[r * G + j] - mu_h[4 * r + k]) * rs_h[4 * r + k];
        pre[k] = fmaf(xhat, gh[j], x[j]);
      }
      const float ig = sigmoidf(pre[0]);
      const float fg = sigmoidf(pre[1]);
      const float gg = tanhf(pre[2]);
      cn[i] = fg * cs[i] + ig * gg;
      os[i] = sigmoidf(pre[3]);
    }
    __syncthreads();

    // P4: statistics of each row's c
    for (int r = warp; r < rows; r += nwarps) {
      const float2 st = warp_stats(cn + r * H, H, lane);
      if (lane == 0) {
        mu_c[r] = st.x;
        rs_c[r] = st.y;
      }
    }
    __syncthreads();

    // P5: h from the normalised c, held where the frame is masked
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H;
      const int u = i - r * H;
      float c = cn[i];
      const float chat = (c - mu_c[r]) * rs_c[r];
      float h = os[i] * tanhf(fmaf(chat, gc[u], bc[u]));
      if (!(mask[row0 + r] > 0.f)) {
        c = cs[i];
        h = hs[i];
      }
      cs[i] = c;
      hs[i] = h;
      if (kRounded) hr[i] = as_operand<W>(h);
      const size_t o = (row0 + r) * H + u;
      h_out[o] = h;
      c_out[o] = c;
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const float* xpn_f, const float* xpn_b, const float* mask,
           const W* wh_f, const W* wh_b, const float* gh_f,
           const float* gh_b, const float* gc_f, const float* gc_b,
           const float* bc_f, const float* bc_b, float* h_f, float* c_f,
           float* h_b, float* c_b, const float* h_init, const float* c_init,
           int T, int B, int H, int ndir, void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const size_t smem = smem_bytes<W>(H);
  cudaError_t err = cudaFuncSetAttribute(
      ln_lstm_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  ln_lstm_fwd_kernel<W><<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f, bc_b,
      h_f, c_f, h_b, c_b, h_init, c_init, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h_init / c_init: the state each lane starts from, [ndir, B, H], or null
// for zeros.
extern "C" int asr_ln_lstm_stream_fwd(const float* xpn_f, const float* xpn_b,
                               const float* mask, const float* wh_f,
                               const float* wh_b, const float* gh_f,
                               const float* gh_b, const float* gc_f,
                               const float* gc_b, const float* bc_f,
                               const float* bc_b, float* h_f, float* c_f,
                               float* h_b, float* c_b, const float* h_init,
                               const float* c_init, int T, int B, int H,
                               int ndir, void* stream) {
  return launch<float>(xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f,
                       gc_b, bc_f, bc_b, h_f, c_f, h_b, c_b, h_init, c_init,
                       T, B, H, ndir, stream);
}

// The bfloat16-weight form: asr_ln_lstm_stream_fwd's arguments with wh_f /
// wh_b bfloat16 [H, 4H].
extern "C" int asr_ln_lstm_stream_fwd_bf16(
    const float* xpn_f, const float* xpn_b, const float* mask,
    const __nv_bfloat16* wh_f, const __nv_bfloat16* wh_b, const float* gh_f,
    const float* gh_b, const float* gc_f, const float* gc_b,
    const float* bc_f, const float* bc_b, float* h_f, float* c_f, float* h_b,
    float* c_b, const float* h_init, const float* c_init, int T, int B,
    int H, int ndir, void* stream) {
  return launch<__nv_bfloat16>(xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b,
                               gc_f, gc_b, bc_f, bc_b, h_f, c_f, h_b, c_b,
                               h_init, c_init, T, B, H, ndir, stream);
}
