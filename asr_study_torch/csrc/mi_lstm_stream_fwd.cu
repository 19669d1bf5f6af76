// The multiplicative-integration (MI) LSTM recurrence of one layer, forward
// pass, over one or two directions in one launch: the streamed-weight
// design, for the widths whose recurrent weights do not fit in one
// thread-block cluster (H=300, H=512).  The other widths take the
// cluster-resident design of mi_lstm_fwd.cu, by the size rule
// ops/mi_lstm.py `mi_geometry`.
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
// The layout is csrc/lstm_stream_fwd.cu's (one block per direction and kRows
// batch rows, one gate column j per thread, h_prev in shared memory, the
// loop over time inside the kernel).  A thread's column accumulates hp from
// zero and then combines it with xp and the column's four vector entries,
// which it keeps in registers for the whole walk.
//
// Inputs: xp_f / xp_b [T, B, 4H], the mask [T, B], wh_* [H, 4H], alpha_*,
// beta1_*, beta2_*, b_* [4H].  Outputs h and c of each direction [T, B, H]
// in forward time order; lane 1 walks time backward (xp_b and the mask at
// T-1-s).  Each lane starts from the carried state h_init / c_init [ndir,
// B, H] or, where they are null, from zeros (bilstm_fwd.cu says what the
// carry is for).  With ndir = 1 only lane 0 runs and the _b pointers are
// unused.
//
// The bfloat16-weight form (asr_mi_lstm_stream_fwd_bf16; train --bf16, the
// JAX trainer's compute_dtype, under which the Pallas kernels run with a
// bfloat16 wh) is the same kernel on the weight type W = __nv_bfloat16:
// wh is read as bfloat16 and h_prev enters hp = h_prev @ wh rounded to
// bfloat16 (ops/pallas_mi_lstm.py: `hp = _mm(h_prev, wh)`), while the MI
// form alpha * xp * hp + beta1 * xp + beta2 * hp + b is float32 on that
// hp and the vectors stay float32.  The block keeps h unrounded in hs for
// the hold of a masked frame, and beside it the rounded copy hr that the
// product reads, written where hs is; the products are float32 fmaf on
// the converted weights, summed in the float32 form's order.  In the
// float32 form hr is hs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace {

constexpr int kRows = 4;         // batch rows per block
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
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
// by its 16 bits, the high half of the float32 of the same value (a plain
// load the compiler schedules as it does the float32 form's)
__device__ __forceinline__ float load_w(const float* w) { return __ldg(w); }

__device__ __forceinline__ float load_w(const __nv_bfloat16* w) {
  const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(w));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// acc[r] += x[r * ldx + k] * w[k * ldw] for k = k0 .. k1 - 1 in turn: the
// bfloat16-weight form's product, the weights of kAhead rows loaded ahead
// of their FMAs.  Left to itself the compiler keeps two of the 2-byte
// loads in flight where it keeps four of the float32 form's, and the loop
// waits on L2; the sums are the float32 form's, in its order.
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

// dynamic shared memory of a block: hs, cs and the gates, and for the
// bfloat16-weight form the rounded copy hr
template <typename W>
size_t smem_bytes(int H) {
  constexpr int kCopies = std::is_same_v<W, __nv_bfloat16> ? 3 : 2;
  return sizeof(float) * static_cast<size_t>(kRows) * (kCopies * H + 4 * H);
}

template <typename W>
__global__ void __launch_bounds__(kMaxThreads)
mi_lstm_fwd_kernel(const float* __restrict__ xp_f,
                   const float* __restrict__ xp_b,
                   const float* __restrict__ mask,
                   const W* __restrict__ wh_f,
                   const W* __restrict__ wh_b,
                   const float* __restrict__ al_f,
                   const float* __restrict__ al_b,
                   const float* __restrict__ b1_f,
                   const float* __restrict__ b1_b,
                   const float* __restrict__ b2_f,
                   const float* __restrict__ b2_b,
                   const float* __restrict__ bias_f,
                   const float* __restrict__ bias_b,
                   float* __restrict__ h_f, float* __restrict__ c_f,
                   float* __restrict__ h_b, float* __restrict__ c_b,
                   const float* __restrict__ h_init,
                   const float* __restrict__ c_init, int T, int B, int H) {
  extern __shared__ float smem[];
  constexpr bool kRounded = std::is_same_v<W, __nv_bfloat16>;
  const int G = 4 * H;
  float* hs = smem;              // [kRows][H]  h of the previous step
  float* cs = hs + kRows * H;    // [kRows][H]  c of the previous step
  float* gates = cs + kRows * H; // [kRows][G]
  // [kRows][H]  h as the product's operand: rounded, or hs itself
  float* hr = kRounded ? gates + kRows * G : hs;

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
  const float* __restrict__ al = rev ? al_b : al_f;
  const float* __restrict__ b1 = rev ? b1_b : b1_f;
  const float* __restrict__ b2 = rev ? b2_b : b2_f;
  const float* __restrict__ bias = rev ? bias_b : bias_f;
  float* __restrict__ h_out = rev ? h_b : h_f;
  float* __restrict__ c_out = rev ? c_b : c_f;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);

  // the carried state of the block's rows, zeros where none is given
  const size_t init0 = (static_cast<size_t>(blockIdx.y) * B + b0) * H;
  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    const bool ok = i < rows * H;
    hs[i] = (h_init != nullptr && ok) ? h_init[init0 + i] : 0.f;
    cs[i] = (c_init != nullptr && ok) ? c_init[init0 + i] : 0.f;
    if (kRounded) hr[i] = as_operand<W>(hs[i]);
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
      if (kRounded) hr[i] = as_operand<W>(h);
      const size_t o = (row0 + r) * H + u;
      h_out[o] = h;
      c_out[o] = c;
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const float* xp_f, const float* xp_b, const float* mask,
           const W* wh_f, const W* wh_b, const float* al_f,
           const float* al_b, const float* b1_f, const float* b1_b,
           const float* b2_f, const float* b2_b, const float* bias_f,
           const float* bias_b, float* h_f, float* c_f, float* h_b,
           float* c_b, const float* h_init, const float* c_init, int T,
           int B, int H, int ndir, void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const size_t smem = smem_bytes<W>(H);
  cudaError_t err = cudaFuncSetAttribute(
      mi_lstm_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  mi_lstm_fwd_kernel<W><<<grid, threads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      xp_f, xp_b, mask, wh_f, wh_b, al_f, al_b, b1_f, b1_b, b2_f, b2_b,
      bias_f, bias_b, h_f, c_f, h_b, c_b, h_init, c_init, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h_init / c_init: the state each lane starts from, [ndir, B, H], or null
// for zeros.
extern "C" int asr_mi_lstm_stream_fwd(const float* xp_f, const float* xp_b,
                               const float* mask, const float* wh_f,
                               const float* wh_b, const float* al_f,
                               const float* al_b, const float* b1_f,
                               const float* b1_b, const float* b2_f,
                               const float* b2_b, const float* bias_f,
                               const float* bias_b, float* h_f, float* c_f,
                               float* h_b, float* c_b, const float* h_init,
                               const float* c_init, int T, int B, int H,
                               int ndir, void* stream) {
  return launch<float>(xp_f, xp_b, mask, wh_f, wh_b, al_f, al_b, b1_f, b1_b,
                       b2_f, b2_b, bias_f, bias_b, h_f, c_f, h_b, c_b, h_init,
                       c_init, T, B, H, ndir, stream);
}

// The bfloat16-weight form: asr_mi_lstm_stream_fwd's arguments with wh_f /
// wh_b bfloat16 [H, 4H]; the vectors stay float32.
extern "C" int asr_mi_lstm_stream_fwd_bf16(
    const float* xp_f, const float* xp_b, const float* mask,
    const __nv_bfloat16* wh_f, const __nv_bfloat16* wh_b, const float* al_f,
    const float* al_b, const float* b1_f, const float* b1_b,
    const float* b2_f, const float* b2_b, const float* bias_f,
    const float* bias_b, float* h_f, float* c_f, float* h_b, float* c_b,
    const float* h_init, const float* c_init, int T, int B, int H, int ndir,
    void* stream) {
  return launch<__nv_bfloat16>(xp_f, xp_b, mask, wh_f, wh_b, al_f, al_b,
                               b1_f, b1_b, b2_f, b2_b, bias_f, bias_b, h_f,
                               c_f, h_b, c_b, h_init, c_init, T, B, H, ndir,
                               stream);
}
