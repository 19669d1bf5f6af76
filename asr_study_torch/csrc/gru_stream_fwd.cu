// The GRU recurrence of one layer, forward pass, over one or two
// directions in one launch: the streamed-weight design, for the shapes that
// neither cluster-resident design takes (H > 512, or at H=512 a batch
// beyond the clusters of gru_wide_fwd.cu, e.g. B > 48 in two directions).
// The other shapes take gru_fwd.cu (H <= 256) or gru_wide_fwd.cu (256 < H
// <= 512); ops/gru.py `gru_geometry` picks between the three by size.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bigru.py
// `_bifwd_kernel` (both directions, row maths `_gru_row_fwd`) with
// ndir = 2, and asr_study_tpu/ops/pallas_gru.py `_fwd_kernel` (one
// direction) with ndir = 1.  Gate maths: ops/pallas_gru.py `_gru_gates`.
//
// Inputs are the bias-folded input projections xp_f / xp_b [T, B, 3H]
// (x @ wx + b, computed outside by one matmul per direction; gate order
// r, z, n), the frame mask [T, B] and the recurrent weights wh_f / wh_b
// [H, 3H].  Output h of each direction, [T, B, H] in forward time order.
// Lane 1 (the reverse direction) walks time backward: it reads xp_b and the
// mask at T-1-s.  Each lane starts from the carried h_init [ndir, B, H] or,
// where it is null, from h = 0 (gru_fwd.cu says what the carry is for), and
// a frame whose mask is 0 keeps the previous h, which makes the reverse
// lane exact on right-padded batches.  With ndir = 1 only lane 0 runs and
// the _b pointers are unused.
//
//   r = sigmoid(xr + hr),  z = sigmoid(xz + hz),  n = tanh(xn + r * hn),
//   h = (1 - z) * n + z * h_prev,   where [hr, hz, hn] = h_prev @ wh.
//
// The h-side n pre-activation hn is kept apart from xn: r multiplies hn
// alone, so the two halves of n cannot be summed before the gate, as r and
// z's are.
//
// What bounds it on the H100.  The work is the [B, H] x [H, 3H] product of
// every step: 2 * B * H * 3H flops a step and direction, at T=805, B=32,
// H=256 and both directions 20.3 GFLOP, 0.30 ms at the 67 TFLOP/s of fp32
// outside the tensor cores; the bytes (xp, mask, wh in, h out: 212 MB) take
// 0.06 ms at 3.35 TB/s, so the bound is the operations.  The recurrence is
// serial in time and each step's product is too small to spread over the
// card, so this simple design stays far above that bound: one block per
// (direction, kRows batch rows) with the time loop inside the kernel (one
// launch per layer), each thread owning gate columns j of the 3H (a strided
// loop, so any H works) with kRows running sums, the h_prev rows in shared
// memory where every read is a broadcast, and the direction's wh (768 KB at
// H=256) read from L2 at every step.
//
// The bfloat16-weight form (asr_gru_stream_fwd_bf16; train --bf16, under
// which the Pallas kernels run with a bfloat16 wh) is the same kernel on
// the weight type W = __nv_bfloat16: wh is read as bfloat16 (half the
// bytes a step streams from L2) and h enters h_prev @ wh rounded to
// bfloat16 (ops/pallas_gru.py `_mm`: h_prev.astype(wh.dtype)), and only
// there: the blend (1 - z) * n + z * h_prev and the hold of a masked frame
// take the unrounded h_prev.  The block keeps h unrounded in hs and beside
// it the rounded copy hr that the product reads, written by the state
// update; the products are float32 fmaf on the converted weights, summed
// in the float32 form's order, and xp, the mask and h stay float32.  In
// the float32 form hr is hs.

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

// dynamic shared memory of a block: hs and h_prev @ wh, and for the
// bfloat16-weight form the rounded copy hr
template <typename W>
size_t smem_bytes(int H) {
  constexpr int kCopies = std::is_same_v<W, __nv_bfloat16> ? 2 : 1;
  return sizeof(float) * static_cast<size_t>(kRows) * (kCopies * H + 3 * H);
}

template <typename W>
__global__ void __launch_bounds__(kMaxThreads)
gru_stream_fwd_kernel(const float* __restrict__ xp_f,
                      const float* __restrict__ xp_b,
                      const float* __restrict__ mask,
                      const W* __restrict__ wh_f,
                      const W* __restrict__ wh_b, float* __restrict__ h_f,
                      float* __restrict__ h_b,
                      const float* __restrict__ h_init, int T, int B, int H) {
  extern __shared__ float smem[];
  constexpr bool kRounded = std::is_same_v<W, __nv_bfloat16>;
  const int G = 3 * H;
  float* hs = smem;              // [kRows][H]  h of the previous step
  float* hp = hs + kRows * H;    // [kRows][G]  h_prev @ wh
  // [kRows][H]  h as the product's operand: rounded, or hs itself
  float* hr = kRounded ? hp + kRows * G : hs;

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
  float* __restrict__ h_out = rev ? h_b : h_f;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);

  // the carried h of the block's rows, zeros where none is given
  const size_t init0 = (static_cast<size_t>(blockIdx.y) * B + b0) * H;
  for (int i = threadIdx.x; i < kRows * H; i += blockDim.x) {
    hs[i] = (h_init != nullptr && i < rows * H) ? h_init[init0 + i] : 0.f;
    if (kRounded) hr[i] = as_operand<W>(hs[i]);
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = rev ? T - 1 - s : s;
    const size_t row0 = static_cast<size_t>(t) * B + b0;

    // h-side pre-activations h_prev @ wh, gate columns strided over threads
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

    // state update, held where the frame is masked
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H;
      const int u = i - r * H;
      const float* x = xp + (row0 + r) * G;
      const float* g = hp + r * G;
      const float rg = sigmoidf(x[u] + g[u]);
      const float zg = sigmoidf(x[H + u] + g[H + u]);
      const float ng = tanhf(x[2 * H + u] + rg * g[2 * H + u]);
      const float h_prev = hs[i];
      float h = (1.f - zg) * ng + zg * h_prev;
      if (!(mask[row0 + r] > 0.f)) h = h_prev;
      hs[i] = h;
      if (kRounded) hr[i] = as_operand<W>(h);
      h_out[(row0 + r) * H + u] = h;
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const float* xp_f, const float* xp_b, const float* mask,
           const W* wh_f, const W* wh_b, float* h_f, float* h_b,
           const float* h_init, int T, int B, int H, int ndir, void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 3 * H;
  const size_t smem = smem_bytes<W>(H);
  cudaError_t err = cudaFuncSetAttribute(
      gru_stream_fwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  gru_stream_fwd_kernel<W><<<grid, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, h_init, T, B, H);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h_init: the h each lane starts from, [ndir, B, H], or null for zeros.
extern "C" int asr_gru_stream_fwd(const float* xp_f, const float* xp_b,
                                  const float* mask, const float* wh_f,
                                  const float* wh_b, float* h_f, float* h_b,
                                  const float* h_init, int T, int B, int H,
                                  int ndir, void* stream) {
  return launch<float>(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, h_init, T, B,
                       H, ndir, stream);
}

// The bfloat16-weight form: asr_gru_stream_fwd's arguments with wh_f /
// wh_b bfloat16 [H, 3H].
extern "C" int asr_gru_stream_fwd_bf16(const float* xp_f, const float* xp_b,
                                       const float* mask,
                                       const __nv_bfloat16* wh_f,
                                       const __nv_bfloat16* wh_b, float* h_f,
                                       float* h_b, const float* h_init, int T,
                                       int B, int H, int ndir, void* stream) {
  return launch<__nv_bfloat16>(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b,
                               h_init, T, B, H, ndir, stream);
}
