// The GRU recurrence of one layer, backward pass, over one or two
// directions in one launch: the cotangent walks that give the
// pre-activation gradients dxp and dhp, in the streamed-weight design, for
// the shapes that neither cluster-resident design takes (H > 512, or at
// H=512 a batch beyond the clusters of gru_wide_bwd.cu).  The other shapes
// take gru_bwd.cu (H <= 256) or gru_wide_bwd.cu (256 < H <= 512);
// ops/gru.py `gru_geometry` picks between the three by size.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bigru.py
// `_bibwd_kernel` (both walks, in opposite time directions) with ndir = 2,
// and asr_study_tpu/ops/pallas_gru.py `_bwd_kernel` (one walk) with
// ndir = 1.  Row maths: pallas_bigru.py `_gru_row_bwd` (the same as
// pallas_gru.py's kernel body).
//
// Inputs: the forward's bias-folded projections xp_f / xp_b [T, B, 3H], the
// mask [T, B], the recurrent weights wh [H, 3H] and their transposes
// wht [3H, H] (made contiguous outside, so that thread u reads row j of wht
// coalesced), the saved h of each direction [T, B, H] and the cotangents of
// the h outputs dh_f / dh_b [T, B, H].  Outputs, each [T, B, 3H] and zero
// on masked frames:
//
//   dxp = [dpre_r, dpre_z, dpre_n]        the x-side pre-activation grads
//   dhp = [dpre_r, dpre_z, dpre_n * r]    the h-side ones (r scales hn)
//
// The weight gradient dwh = h_prev^T dhp (dhp, not dxp) over all T*B rows
// is one matmul per direction outside the kernel.
//
// Walk order: lane 0's cotangent chain runs t = T-1 .. 0, lane 1's (the
// reverse direction) t = 0 .. T-1.  h_prev is read straight from the saved
// h at t-1 (lane 0) or t+1 (lane 1), zero past the ends.  A step, per block
// of kRows batch rows:
//
//   P1  hp = h_prev @ wh                       (gate columns j over threads)
//   P2  r, z, n from xp and hp; dh = dh_out[t] + dh_next;
//       dz = dh (h_prev - n), dn = dh (1 - z), dpre_n = dn (1 - n^2),
//       dr = dpre_n hn, dpre_r = dr r (1 - r), dpre_z = dz z (1 - z);
//       dhp overwrites hp in shared memory, dxp and dhp go out;
//       hold = m ? dh z : dh
//   P3  dh_rec = dhp @ wht, split over the 3H reduction into nsplit partial
//       sums per output unit (all threads busy although only H units
//       exist); h_prev of the next step is loaded here too
//
// and the next step's P2 forms dh_next = hold + sum of the partials, which
// is dh_prev = dhp @ wh^T + (m ? dh z : dh).  Three barriers a step.
//
// What bounds it on the H100.  The work is two [B, H] x [H, 3H]-sized
// products a step (the recomputed hp and dh_rec): 4 * B * H * 3H flops a
// step and direction, at T=512, B=32, H=256 and both directions 25.8
// GFLOP, 0.385 ms at 67 TFLOP/s of fp32 outside the tensor cores; the bytes
// (xp, h, dh, mask, wh, wht in, dxp and dhp out: 372 MB) take 0.11 ms at
// 3.35 TB/s, so the bound is the operations.  As in the forward kernel the
// serial walk keeps each step's products on one SM, and here both wh and
// wht (768 KB each at H=256) stream from L2 at every step.
//
// The bfloat16-weight form (asr_gru_stream_bwd_bf16; ops/pallas_gru.py's
// and pallas_bigru.py's backward with a bfloat16 wh) is the same kernel on
// the weight type W = __nv_bfloat16: wh and wht (the wrapper's transpose of
// the bfloat16 wh) are read as bfloat16; h_prev is rounded to bfloat16
// where it is loaded for P1 (hp recomputed from the rounded h_prev, as
// `_mm` does), and P2 reads the unrounded h_prev of dz = dh (h_prev - n)
// from the saved h; P2 writes dxp and dhp unrounded and dhp to shared
// memory rounded, the operand of P3's `dhp @ wht` (`_mm(dhp, wht)`).  The
// products are float32 fmaf on the converted weights, in the float32
// form's order; its shared memory is the float32 form's.

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

template <typename W>
__global__ void __launch_bounds__(kMaxThreads)
gru_stream_bwd_kernel(const float* __restrict__ xp_f,
                      const float* __restrict__ xp_b,
                      const float* __restrict__ mask,
                      const W* __restrict__ wh_f,
                      const W* __restrict__ wh_b,
                      const W* __restrict__ wht_f,
                      const W* __restrict__ wht_b,
                      const float* __restrict__ h_f,
                      const float* __restrict__ h_b,
                      const float* __restrict__ dh_f,
                      const float* __restrict__ dh_b,
                      float* __restrict__ dxp_f, float* __restrict__ dhp_f,
                      float* __restrict__ dxp_b, float* __restrict__ dhp_b,
                      int T, int B, int H, int nsplit) {
  extern __shared__ float smem[];
  constexpr bool kRounded = std::is_same_v<W, __nv_bfloat16>;
  const int G = 3 * H;
  const int RH = kRows * H;
  float* hs = smem;                  // [kRows][H]  h_prev of this step,
                                     // as the product's operand
  float* hold = hs + RH;             // [kRows][H]  m ? dh*z : dh
  float* part = hold + RH;           // [nsplit][kRows][H]  dh_rec partials
  float* g = part + nsplit * RH;     // [kRows][G]  hp, then dhp

  const bool rev = blockIdx.y == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
  const W* __restrict__ wht = rev ? wht_b : wht_f;
  const float* __restrict__ h = rev ? h_b : h_f;
  const float* __restrict__ dh_out = rev ? dh_b : dh_f;
  float* __restrict__ dxp = rev ? dxp_b : dxp_f;
  float* __restrict__ dhp = rev ? dhp_b : dhp_f;
  const int b0 = blockIdx.x * kRows;
  const int rows = min(kRows, B - b0);
  const int step_dir = rev ? 1 : -1;       // t_prev = t + step_dir
  const int chunk = (G + nsplit - 1) / nsplit;

  for (int i = threadIdx.x; i < RH; i += blockDim.x) hold[i] = 0.f;
  for (int i = threadIdx.x; i < nsplit * RH; i += blockDim.x) part[i] = 0.f;
  {
    const int tp = (rev ? 0 : T - 1) + step_dir;
    for (int i = threadIdx.x; i < RH; i += blockDim.x) {
      const int r = i / H;
      hs[i] = (r < rows && tp >= 0 && tp < T)
                  ? as_operand<W>(
                        h[(static_cast<size_t>(tp) * B + b0) * H + i])
                  : 0.f;
    }
  }
  __syncthreads();

  for (int s = 0; s < T; ++s) {
    const int t = rev ? s : T - 1 - s;
    const int tp = t + step_dir;
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
      for (int r = 0; r < kRows; ++r) g[r * G + j] = acc[r];
    }
    __syncthreads();

    // P2: the cell's reverse-mode maths, one (row, unit) per thread
    for (int i = threadIdx.x; i < rows * H; i += blockDim.x) {
      const int r = i / H;
      const int u = i - r * H;
      const float* x = xp + (row0 + r) * G;
      float* gr = g + r * G;
      const float hn = gr[2 * H + u];
      const float rg = sigmoidf(x[u] + gr[u]);
      const float zg = sigmoidf(x[H + u] + gr[H + u]);
      const float ng = tanhf(x[2 * H + u] + rg * hn);
      float dh = dh_out[(row0 + r) * H + u] + hold[i];
      for (int q = 0; q < nsplit; ++q) dh += part[q * RH + i];
      const bool m = mask[row0 + r] > 0.f;
      // the blend's h_prev, unrounded (hs holds the product's operand)
      float h_prev = hs[i];
      if (kRounded)
        h_prev = tp >= 0 && tp < T
                     ? h[(static_cast<size_t>(tp) * B + b0 + r) * H + u]
                     : 0.f;
      const float dpre_n = m ? dh * (1.f - zg) * (1.f - ng * ng) : 0.f;
      const float dpre_r = m ? dpre_n * hn * rg * (1.f - rg) : 0.f;
      const float dpre_z = m ? dh * (h_prev - ng) * zg * (1.f - zg) : 0.f;
      const float dhp_n = dpre_n * rg;
      gr[u] = as_operand<W>(dpre_r);        // P3's operands
      gr[H + u] = as_operand<W>(dpre_z);
      gr[2 * H + u] = as_operand<W>(dhp_n);
      float* ox = dxp + (row0 + r) * G;
      float* oh = dhp + (row0 + r) * G;
      ox[u] = dpre_r;
      ox[H + u] = dpre_z;
      ox[2 * H + u] = dpre_n;
      oh[u] = dpre_r;
      oh[H + u] = dpre_z;
      oh[2 * H + u] = dhp_n;
      // a held frame passes its h (and the cotangent) straight through
      hold[i] = m ? dh * zg : dh;
    }
    __syncthreads();

    // P3: dh_rec partial sums over the 3H reduction; next step's h_prev
    for (int i = threadIdx.x; i < nsplit * H; i += blockDim.x) {
      const int q = i / H;
      const int u = i - q * H;
      const int j1 = min(G, (q + 1) * chunk);
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      if constexpr (kRounded) {
        product_ahead(acc, g, G, wht + u, H, q * chunk, j1);
      } else {
#pragma unroll 4
        for (int j = q * chunk; j < j1; ++j) {
          const float w = load_w(wht + static_cast<size_t>(j) * H + u);
#pragma unroll
          for (int r = 0; r < kRows; ++r)
            acc[r] = fmaf(g[r * G + j], w, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) part[q * RH + r * H + u] = acc[r];
    }
    {
      const int tpn = tp + step_dir;        // h_prev of the next step's t
      const bool ok = s + 1 < T && tpn >= 0 && tpn < T;
      for (int i = threadIdx.x; i < RH; i += blockDim.x) {
        const int r = i / H;
        hs[i] = (ok && r < rows)
                    ? as_operand<W>(
                          h[(static_cast<size_t>(tpn) * B + b0) * H + i])
                    : 0.f;
      }
    }
    __syncthreads();
  }
}

template <typename W>
int launch(const float* xp_f, const float* xp_b, const float* mask,
           const W* wh_f, const W* wh_b, const W* wht_f, const W* wht_b,
           const float* h_f, const float* h_b, const float* dh_f,
           const float* dh_b, float* dxp_f, float* dhp_f, float* dxp_b,
           float* dhp_b, int T, int B, int H, int ndir, void* stream) {
  if (ndir < 1 || ndir > 2) return static_cast<int>(cudaErrorInvalidValue);
  const int G = 3 * H;
  const int warps_g = ((G + 31) / 32) * 32;
  const int threads = warps_g < kMaxThreads ? warps_g : kMaxThreads;
  const int nsplit = threads / H > 1 ? threads / H : 1;
  const size_t smem = sizeof(float) * static_cast<size_t>(kRows) *
                      ((2 + nsplit) * static_cast<size_t>(H) + G);
  cudaError_t err = cudaFuncSetAttribute(
      gru_stream_bwd_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((B + kRows - 1) / kRows, ndir);
  gru_stream_bwd_kernel<W><<<grid, threads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      xp_f, xp_b, mask, wh_f, wh_b, wht_f, wht_b, h_f, h_b, dh_f, dh_b, dxp_f,
      dhp_f, dxp_b, dhp_b, T, B, H, nsplit);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int asr_gru_stream_bwd(const float* xp_f, const float* xp_b,
                                  const float* mask, const float* wh_f,
                                  const float* wh_b, const float* wht_f,
                                  const float* wht_b, const float* h_f,
                                  const float* h_b, const float* dh_f,
                                  const float* dh_b, float* dxp_f,
                                  float* dhp_f, float* dxp_b, float* dhp_b,
                                  int T, int B, int H, int ndir,
                                  void* stream) {
  return launch<float>(xp_f, xp_b, mask, wh_f, wh_b, wht_f, wht_b, h_f, h_b,
                       dh_f, dh_b, dxp_f, dhp_f, dxp_b, dhp_b, T, B, H, ndir,
                       stream);
}

// The bfloat16-weight form: asr_gru_stream_bwd's arguments with wh_f /
// wh_b bfloat16 [H, 3H] and wht_f / wht_b bfloat16 [3H, H].
extern "C" int asr_gru_stream_bwd_bf16(
    const float* xp_f, const float* xp_b, const float* mask,
    const __nv_bfloat16* wh_f, const __nv_bfloat16* wh_b,
    const __nv_bfloat16* wht_f, const __nv_bfloat16* wht_b, const float* h_f,
    const float* h_b, const float* dh_f, const float* dh_b, float* dxp_f,
    float* dhp_f, float* dxp_b, float* dhp_b, int T, int B, int H, int ndir,
    void* stream) {
  return launch<__nv_bfloat16>(xp_f, xp_b, mask, wh_f, wh_b, wht_f, wht_b,
                               h_f, h_b, dh_f, dh_b, dxp_f, dhp_f, dxp_b,
                               dhp_b, T, B, H, ndir, stream);
}
