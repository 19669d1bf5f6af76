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
// mask at T-1-s.  Each lane starts from the carried state h_init / c_init
// [ndir, B, H] or, where they are null, from zeros (bilstm_fwd.cu says what
// the carry is for).  With ndir = 1 only lane 0 runs and the _b pointers
// are unused.
//
// The bfloat16-weight form (asr_zoneout_lstm_stream_fwd_bf16; train --bf16,
// the JAX trainer's compute_dtype, under which the Pallas kernels run with
// a bfloat16 wh) is the same kernel on the weight type W = __nv_bfloat16:
// wh is read as bfloat16 and h_prev enters the product rounded to bfloat16
// (ops/pallas_zoneout_lstm.py `_zo_cell_math`: only `_mm(h_prev, wh)`
// sees the rounded h_prev).  The block keeps h unrounded in hs for the
// zoneout mix and the hold of a masked frame, and beside it the rounded
// copy hr that the product reads, written where hs is; the products are
// float32 fmaf on the converted weights, summed in the float32 form's
// order, and xp, the mask, zh, zc, h and c stay float32.  In the float32
// form hr is hs.

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
zoneout_lstm_fwd_kernel(const float* __restrict__ xp_f,
                        const float* __restrict__ xp_b,
                        const float* __restrict__ mask,
                        const float* __restrict__ zh_f,
                        const float* __restrict__ zh_b,
                        const float* __restrict__ zc_f,
                        const float* __restrict__ zc_b,
                        const W* __restrict__ wh_f,
                        const W* __restrict__ wh_b,
                        float* __restrict__ h_f, float* __restrict__ c_f,
                        float* __restrict__ h_b, float* __restrict__ c_b,
                        const float* __restrict__ h_init,
                        const float* __restrict__ c_init, int T, int B,
                        int H) {
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
  const float* __restrict__ zh = rev ? zh_b : zh_f;
  const float* __restrict__ zc = rev ? zc_b : zc_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
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

    // gate pre-activations: xp + h_prev @ wh, one column per thread
    for (int j = threadIdx.x; j < G; j += blockDim.x) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        acc[r] = r < rows ? xp[(row0 + r) * G + j] : 0.f;
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
      if (kRounded) hr[i] = as_operand<W>(h);
      h_out[o] = h;
      c_out[o] = c;
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const float* xp_f, const float* xp_b, const float* mask,
           const float* zh_f, const float* zh_b, const float* zc_f,
           const float* zc_b, const W* wh_f, const W* wh_b, float* h_f,
           float* c_f, float* h_b, float* c_b, const float* h_init,
           const float* c_init, int T, int B, int H, int ndir,
           void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 4 * H;
  const size_t smem = smem_bytes<W>(H);
  cudaError_t err = cudaFuncSetAttribute(
      zoneout_lstm_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  zoneout_lstm_fwd_kernel<W><<<grid, threads, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, h_f, c_f, h_b,
      c_b, h_init, c_init, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h_init / c_init: the state each lane starts from, [ndir, B, H], or null
// for zeros.
extern "C" int asr_zoneout_lstm_stream_fwd(
    const float* xp_f, const float* xp_b, const float* mask,
    const float* zh_f, const float* zh_b, const float* zc_f,
    const float* zc_b, const float* wh_f, const float* wh_b, float* h_f,
    float* c_f, float* h_b, float* c_b, const float* h_init,
    const float* c_init, int T, int B, int H, int ndir, void* stream) {
  return launch<float>(xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b,
                       h_f, c_f, h_b, c_b, h_init, c_init, T, B, H, ndir,
                       stream);
}

// The bfloat16-weight form: asr_zoneout_lstm_stream_fwd's arguments with
// wh_f / wh_b bfloat16 [H, 4H].
extern "C" int asr_zoneout_lstm_stream_fwd_bf16(
    const float* xp_f, const float* xp_b, const float* mask,
    const float* zh_f, const float* zh_b, const float* zc_f,
    const float* zc_b, const __nv_bfloat16* wh_f, const __nv_bfloat16* wh_b,
    float* h_f, float* c_f, float* h_b, float* c_b, const float* h_init,
    const float* c_init, int T, int B, int H, int ndir, void* stream) {
  return launch<__nv_bfloat16>(xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b,
                               wh_f, wh_b, h_f, c_f, h_b, c_b, h_init,
                               c_init, T, B, H, ndir, stream);
}
