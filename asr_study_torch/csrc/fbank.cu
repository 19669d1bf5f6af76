// MFCC / log-mel / mel chain for a batch of pre-emphasised signals, with
// the spectrum as a direct DFT (the DFT design).
//
// Replaces the TPU kernel asr_study_tpu/features/pallas_fbank.py
// `_fbank_kernel` for the shapes the FFT design (csrc/fbank_fft.cu) does
// not take: nfft outside {256, 512, 1024, 2048}, frame_len > nfft, or a
// tile of frames too long for the FFT design's shared memory
// (features/fbank.py `fbank_design`).  No zoo featurizer reaches it at its
// defaults.  One block takes one utterance and a tile of kTile
// frames and runs the whole per-frame chain without writing any
// intermediate to device memory:
//
//   framing at t*hop, window  ->  DFT against the cos and sin tables
//   ->  pspec = (re^2 + im^2) / nfft  ->  mel  ->  log(max(., floor))
//   ->  DCT and lifter  ->  c0 replaced by log(max(sum pspec, floor))
//
// What bounds it on the H100: the DFT is ~97% of the arithmetic (frame_len
// x n_bins x 2 FMAs a frame, 400 x 257 x 2 at 16 kHz), all fp32 on the CUDA
// cores, so the kernel is bound by FMA issue and by the shared-memory reads
// that feed it.  The design keeps each thread on one frequency bin for all
// kTile frames of the tile: the frame samples are stored sample-major in
// shared memory, so one 16-byte shared load feeds 8 FMAs (4 frames x re/im)
// and the cos/sin table reads are coalesced across the warp (they stay in
// L2: each block reads the 0.8 MB of tables once).  The bins left over when
// n_bins is not a multiple of the block (the Nyquist bin at nfft=512) are
// split by (bin, frame) so that no thread does a second full pass.
// Tables stay fp32 and the output is [B, T, n_out] with no lane padding.

#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 16;       // frames per block
constexpr int kThreads = 256;

enum Mode { kMfcc = 0, kLogFbank = 1, kFbank = 2 };

__global__ void __launch_bounds__(kThreads)
fbank_kernel(const float* __restrict__ pre, int n_sig,
             const float* __restrict__ win, const float* __restrict__ cosm,
             const float* __restrict__ sinm, const float* __restrict__ mel,
             const float* __restrict__ dct, const float* __restrict__ lift,
             float* __restrict__ out, int n_frames, int frame_len, int hop,
             int n_bins, int n_mel, int n_cep, int n_out, float inv_nfft,
             float floor_, int mode, int append_energy) {
  extern __shared__ float4 smem4[];
  float* frames = reinterpret_cast<float*>(smem4);  // [frame_len][kTile]
  float* pspec = frames + frame_len * kTile;        // [kTile][n_bins]
  float* melv = pspec + kTile * n_bins;             // [kTile][n_mel]
  float* log_e = melv + kTile * n_mel;              // [kTile]

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const float* sig = pre + static_cast<size_t>(b) * n_sig;

  // 1. framing and window; frames past n_frames are zeros
  for (int i = threadIdx.x; i < kTile * frame_len; i += blockDim.x) {
    const int f = i / frame_len;
    const int l = i - f * frame_len;
    const int t = t0 + f;
    float v = 0.f;
    if (t < n_frames) v = sig[static_cast<size_t>(t) * hop + l] * win[l];
    frames[l * kTile + f] = v;
  }
  __syncthreads();

  // 2. DFT and power spectrum: one bin, all kTile frames per thread
  const int n_main = (n_bins / blockDim.x) * blockDim.x;
  for (int k = threadIdx.x; k < n_main; k += blockDim.x) {
    float re[kTile], im[kTile];
#pragma unroll
    for (int f = 0; f < kTile; ++f) re[f] = im[f] = 0.f;
    for (int l = 0; l < frame_len; ++l) {
      const float c = cosm[l * n_bins + k];
      const float s = sinm[l * n_bins + k];
      const float4* x4 = reinterpret_cast<const float4*>(frames + l * kTile);
#pragma unroll
      for (int q = 0; q < kTile / 4; ++q) {
        const float4 x = x4[q];
        re[4 * q + 0] = fmaf(x.x, c, re[4 * q + 0]);
        im[4 * q + 0] = fmaf(x.x, s, im[4 * q + 0]);
        re[4 * q + 1] = fmaf(x.y, c, re[4 * q + 1]);
        im[4 * q + 1] = fmaf(x.y, s, im[4 * q + 1]);
        re[4 * q + 2] = fmaf(x.z, c, re[4 * q + 2]);
        im[4 * q + 2] = fmaf(x.z, s, im[4 * q + 2]);
        re[4 * q + 3] = fmaf(x.w, c, re[4 * q + 3]);
        im[4 * q + 3] = fmaf(x.w, s, im[4 * q + 3]);
      }
    }
#pragma unroll
    for (int f = 0; f < kTile; ++f)
      pspec[f * n_bins + k] = (re[f] * re[f] + im[f] * im[f]) * inv_nfft;
  }
  // leftover bins: one (bin, frame) pair per thread
  for (int i = threadIdx.x; i < (n_bins - n_main) * kTile; i += blockDim.x) {
    const int k = n_main + i / kTile;
    const int f = i % kTile;
    float re = 0.f, im = 0.f;
    for (int l = 0; l < frame_len; ++l) {
      const float x = frames[l * kTile + f];
      re = fmaf(x, cosm[l * n_bins + k], re);
      im = fmaf(x, sinm[l * n_bins + k], im);
    }
    pspec[f * n_bins + k] = (re * re + im * im) * inv_nfft;
  }
  __syncthreads();

  // 3. mel energies (log unless linear fbank) and the frame's log energy
  for (int i = threadIdx.x; i < kTile * n_mel; i += blockDim.x) {
    const int f = i / n_mel;
    const int m = i - f * n_mel;
    const float* p = pspec + f * n_bins;
    float acc = 0.f;
    for (int k = 0; k < n_bins; ++k) acc = fmaf(p[k], mel[k * n_mel + m], acc);
    acc = fmaxf(acc, FLT_EPSILON);
    melv[i] = mode == kFbank ? acc : logf(fmaxf(acc, floor_));
  }
  if (threadIdx.x < kTile) {
    const float* p = pspec + threadIdx.x * n_bins;
    float e = 0.f;
    for (int k = 0; k < n_bins; ++k) e += p[k];
    log_e[threadIdx.x] = logf(fmaxf(fmaxf(e, FLT_EPSILON), floor_));
  }
  __syncthreads();

  // 4. DCT + lifter (MFCC) or the mel columns, plus the energy column
  for (int i = threadIdx.x; i < kTile * n_out; i += blockDim.x) {
    const int f = i / n_out;
    const int j = i - f * n_out;
    const int t = t0 + f;
    if (t >= n_frames) continue;
    float v;
    if (mode == kMfcc) {
      if (append_energy && j == 0) {
        v = log_e[f];
      } else {
        const float* lm = melv + f * n_mel;
        float acc = 0.f;
        for (int m = 0; m < n_mel; ++m) acc = fmaf(lm[m], dct[m * n_cep + j], acc);
        v = acc * lift[j];
      }
    } else {
      v = j < n_mel ? melv[f * n_mel + j] : log_e[f];
    }
    out[(static_cast<size_t>(b) * n_frames + t) * n_out + j] = v;
  }
}

}  // namespace

extern "C" int asr_fbank(const float* pre, int n_sig, const float* win,
                         const float* cosm, const float* sinm,
                         const float* mel, const float* dct,
                         const float* lift, float* out, int batch,
                         int n_frames, int frame_len, int hop, int n_bins,
                         int n_mel, int n_cep, int n_out, float inv_nfft,
                         float floor_, int mode, int append_energy,
                         void* stream) {
  const size_t smem =
      sizeof(float) * (static_cast<size_t>(kTile) *
                           (frame_len + n_bins + n_mel) + kTile);
  cudaError_t err = cudaFuncSetAttribute(
      fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  fbank_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pre, n_sig, win, cosm, sinm, mel, dct, lift, out, n_frames, frame_len,
      hop, n_bins, n_mel, n_cep, n_out, inv_nfft, floor_, mode,
      append_energy);
  return static_cast<int>(cudaGetLastError());
}
