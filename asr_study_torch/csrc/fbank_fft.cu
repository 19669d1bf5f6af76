// MFCC / log-mel / mel chain for a batch of pre-emphasised signals, with
// the spectrum from a real FFT (the FFT design).
//
// Replaces the TPU kernel asr_study_tpu/features/pallas_fbank.py
// `_fbank_kernel`, for nfft in {256, 512, 1024, 2048} and frame_len <= nfft
// (features/fbank.py `fbank_design`; other shapes take csrc/fbank.cu, the
// DFT design).  It computes the function of features/device.py
// `spectral_plain`:
//
//   framing at t*hop, window  ->  |rfft(frame, nfft)|^2 / nfft  ->  mel
//   ->  log(max(., floor))  ->  DCT and lifter  ->  c0 replaced by
//   log(max(sum pspec, floor))      (or the log-mel / mel columns)
//
// The TPU form computes the spectrum as a product with 400 x 257 cos and
// sin tables, cheap on a matrix unit; here that product is 95% of the
// arithmetic on the CUDA cores.  A 512-point real FFT does ~36x fewer
// operations, so the design is built around it:
//
// - A CTA takes a tile of consecutive frames of one utterance and copies
//   their contiguous span of `pre`, (F-1)*hop + frame_len samples, into
//   shared memory once, with 16-byte cp.async copies; samples past the row
//   (the last frame may run past n_sig) read as zeros, so the wrapper pads
//   nothing.
// - One warp computes one frame's spectrum.  The nfft-point real FFT is an
//   M = nfft/2 point complex FFT of z[n] = x[2n] + i x[2n+1] (samples at or
//   past frame_len are zeros and are never loaded; the others are read as
//   8-byte pairs with the window's), in Stockham radix-8 passes (then one
//   radix-4 or radix-2 pass): each lane holds its butterflies' M/32 points
//   in registers, and the passes exchange them through the warp's padded
//   row in shared memory.  Each pass after the first reads its own twiddle
//   table, laid out so that a warp reads it free of bank conflicts.  Then
//   the split step gives the M+1 bins, and the power row goes to the tile's
//   [F, M+1] spectra (an odd row stride); the energy is a warp reduction.
//   The twiddles are the host's table of e^{-2 pi i k / nfft}, computed in
//   float64 and rounded to fp32; no sincos runs here.
// - Then a frame a lane, over the tile's spectra: each mel filter is
//   summed over its band of nonzero bins only, in ascending bin order (the
//   order of the dense sum, so the result equals the dense product with its
//   zeros left out; the weights, packed filter by filter on the host, are
//   broadcast to the lanes), then the DCT and lifter.  The logs are IEEE
//   logf (no fast math) after the floors of spectral_plain.
// - The tile's [F, n_out] output is staged in shared memory and written
//   with coalesced stores.
//
// What bounds it on the H100: the card's bound is operations, ~15k fp32 a
// frame at nfft=512 (FFT ~11.5k, power, banded mel, DCT, window) against
// ~640 bytes of samples and 52 of output a frame.  What sets the pace is
// shared memory and the CTA's fixed costs: the passes' exchanges, the
// tile's copy and tables, the first pass, the stores (PERF.md §6).

#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Mode { kMfcc = 0, kLogFbank = 1, kFbank = 2 };

// The CTA shape: warps a CTA and frames a tile (a divisor of 32).  8 x 16
// was the fastest of 4 and 8 warps and 16 and 32 frames at the serving
// shape on an H100 (lstm_step_split.py fbank_fft, PERF.md §6).  The
// shared-memory size rule of features/fbank.py mirrors both.
constexpr int kWarps = 8;
constexpr int kTile = 16;

// padded slot of complex point i in a warp's FFT row: one pad word every 8
// points keeps the passes' stride-8 stores free of bank conflicts
__device__ __forceinline__ int pad(int i) { return i + (i >> 3); }

template <int M>
__host__ __device__ constexpr int row_floats() { return M + M / 8; }

// the radix of the pass that starts at stride ns: 8 while it divides and
// a lane holds 8 points, then 4, then 2
__host__ __device__ constexpr int radix(int m, int ns) {
  return ((m / ns) % 8 == 0 && m / 32 >= 8) ? 8
         : ((m / ns) % 4 == 0 && m / 32 >= 4) ? 4 : 2;
}

__device__ __forceinline__ float2 cadd(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}
__device__ __forceinline__ float2 csub(float2 a, float2 b) {
  return make_float2(a.x - b.x, a.y - b.y);
}
__device__ __forceinline__ float2 cmul(float2 a, float2 w) {
  return make_float2(a.x * w.x - a.y * w.y, a.x * w.y + a.y * w.x);
}
// a * (-i)
__device__ __forceinline__ float2 mul_mi(float2 a) {
  return make_float2(a.y, -a.x);
}

// in-register DFT of R points, natural order in and out
template <int R> __device__ __forceinline__ void dft(float2* v);

template <> __device__ __forceinline__ void dft<2>(float2* v) {
  const float2 a = v[0], b = v[1];
  v[0] = cadd(a, b);
  v[1] = csub(a, b);
}

template <> __device__ __forceinline__ void dft<4>(float2* v) {
  const float2 s0 = cadd(v[0], v[2]), d0 = csub(v[0], v[2]);
  const float2 s1 = cadd(v[1], v[3]), d1 = mul_mi(csub(v[1], v[3]));
  v[0] = cadd(s0, s1);
  v[2] = csub(s0, s1);
  v[1] = cadd(d0, d1);
  v[3] = csub(d0, d1);
}

template <> __device__ __forceinline__ void dft<8>(float2* v) {
  constexpr float kR = 0.70710678118654752f;
  float2 e[4] = {v[0], v[2], v[4], v[6]};
  float2 o[4] = {v[1], v[3], v[5], v[7]};
  dft<4>(e);
  dft<4>(o);
  o[1] = make_float2(kR * (o[1].x + o[1].y), kR * (o[1].y - o[1].x));
  o[2] = mul_mi(o[2]);
  o[3] = make_float2(kR * (o[3].y - o[3].x), -kR * (o[3].x + o[3].y));
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    v[q] = cadd(e[q], o[q]);
    v[q + 4] = csub(e[q], o[q]);
  }
}

// One Stockham pass at stride NS, after its inputs are in v: butterfly
// j = lane + 32 b takes points j + q M/R, is twiddled by W_M^(q (j % NS)
// M / (NS R)), and writes its outputs at (j / NS) NS R + j % NS + q NS.
// ptw is the pass's own twiddle table, ptw[k (R-1) + q-1] = W_M^(q k M /
// (NS R)) for k < NS: the lanes of a warp read it free of bank conflicts.
template <int M, int NS, int R>
__device__ __forceinline__ void pass_store(float2 (&v)[M / R / 32][R],
                                           float* re, float* im,
                                           const float2* ptw, int lane) {
#pragma unroll
  for (int b = 0; b < M / R / 32; ++b) {
    const int j = lane + 32 * b;
    const int k = j % NS;
    if (NS > 1) {
#pragma unroll
      for (int q = 1; q < R; ++q)
        v[b][q] = cmul(v[b][q], ptw[k * (R - 1) + q - 1]);
    }
    dft<R>(v[b]);
    const int base = (j / NS) * NS * R + k;
#pragma unroll
    for (int q = 0; q < R; ++q) {
      const int i = pad(base + q * NS);
      re[i] = v[b][q].x;
      im[i] = v[b][q].y;
    }
  }
}

// the passes after the first, from the warp's row back into it; ptw holds
// their twiddle tables one after the other
template <int M, int NS>
__device__ __forceinline__ void fft_rest(float* re, float* im,
                                         const float2* ptw, int lane) {
  if constexpr (NS < M) {
    constexpr int R = radix(M, NS);
    float2 v[M / R / 32][R];
#pragma unroll
    for (int b = 0; b < M / R / 32; ++b)
#pragma unroll
      for (int q = 0; q < R; ++q) {
        const int i = pad(lane + 32 * b + q * (M / R));
        v[b][q] = make_float2(re[i], im[i]);
      }
    __syncwarp();
    pass_store<M, NS, R>(v, re, im, ptw, lane);
    __syncwarp();
    fft_rest<M, NS * R>(re, im, ptw + NS * (R - 1), lane);
  }
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// The dynamic shared memory of a CTA, in floats; the kernel and the host
// carve it the same way (each part a multiple of 4 floats).
// The FFT rows of the warps are dead once the tile's spectra are in ps, so
// the mel values and the staged output reuse them.
struct Layout {
  int sig, tw, win, melw, dct, lift, bands, log_e, ps, warp_row, melv, out,
      total;
  __host__ __device__ Layout(int m, int frame_len, int hop, int n_packed,
                             int n_mel, int n_cep, int n_out) {
    sig = 0;
    tw = sig + round4((kTile - 1) * hop + frame_len + 4);
    win = tw + 2 * m;                             // < m complex
    melw = win + round4(frame_len);
    dct = melw + round4(n_packed);
    lift = dct + round4(n_mel * n_cep);
    bands = lift + round4(n_cep);                 // lo, count, offset
    log_e = bands + round4(3 * n_mel);
    ps = log_e + round4(kTile);
    warp_row = ps + round4(kTile * (m + 1));      // [tile][m+1], odd rows
    melv = warp_row;                              // [tile][n_mel | 1]
    out = melv + round4(kTile * (n_mel | 1));
    const int rows = warp_row + kWarps * 2 * (m + m / 8);
    const int staged = out + round4(kTile * n_out);
    total = rows > staged ? rows : staged;
  }
};

template <int M>
__global__ void __launch_bounds__(32 * kWarps)
fbank_fft_kernel(const float* __restrict__ pre, int n_sig,
                 const float* __restrict__ win,
                 const float2* __restrict__ twiddle,
                 const float* __restrict__ mel_packed, int n_packed,
                 const int* __restrict__ bands,
                 const float* __restrict__ dct,
                 const float* __restrict__ lift, float* __restrict__ out,
                 int n_frames, int frame_len, int hop, int n_mel, int n_cep,
                 int n_out, float floor_, int mode, int append_energy) {
  constexpr int kN = 2 * M;
  constexpr int kRow = row_floats<M>();
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout lay(M, frame_len, hop, n_packed, n_mel, n_cep, n_out);
  float* sig = smem + lay.sig;
  float2* ptw = reinterpret_cast<float2*>(smem + lay.tw);  // the passes'
  float* w_s = smem + lay.win;
  float* melw = smem + lay.melw;
  float* dct_s = smem + lay.dct;
  float* lift_s = smem + lay.lift;
  int* band_lo = reinterpret_cast<int*>(smem + lay.bands);
  int* band_n = band_lo + n_mel;
  int* band_off = band_n + n_mel;

  const int b = blockIdx.y;
  const int t0 = blockIdx.x * kTile;
  const int n_tile = min(kTile, n_frames - t0);
  const int span = (n_tile - 1) * hop + frame_len;

  // 1. the tile's samples: 16-byte async copies of the aligned body,
  //    scalar head and tail, zeros past the row.  Span sample e lands at
  //    sig[shift + e], so that the aligned body lands on 16-byte slots.
  const long long first = static_cast<long long>(t0) * hop;
  const float* src = pre + static_cast<size_t>(b) * n_sig + first;
  const int avail = static_cast<int>(
      max(0LL, min(static_cast<long long>(span), n_sig - first)));
  const int head = min(avail, static_cast<int>(
      ((16 - (reinterpret_cast<uintptr_t>(src) & 15)) & 15) >> 2));
  const int shift = (4 - head) & 3;      // (shift + head) % 4 == 0
  const float* frames = sig + shift;     // frame f's sample n: f * hop + n
  {
    float* dst = sig + shift;
    const int n_vec = (avail - head) >> 2;
    const int tail = head + 4 * n_vec;
    for (int v = threadIdx.x; v < n_vec; v += blockDim.x)
      cp_async16(dst + head + 4 * v, src + head + 4 * v);
    asm volatile("cp.async.commit_group;\n" ::);
    if (threadIdx.x < head) dst[threadIdx.x] = src[threadIdx.x];
    if (tail + static_cast<int>(threadIdx.x) < avail)
      dst[tail + threadIdx.x] = src[tail + threadIdx.x];
    for (int e = avail + threadIdx.x; e < span; e += blockDim.x)
      dst[e] = 0.f;
  }
  // 2. the tables, while the copies fly
  {
    // each pass's table, W_M^e = W_N^(2e) gathered from the host's table
    float2* dst = ptw;
    for (int ns = radix(M, 1); ns < M; ns *= radix(M, ns)) {
      const int r = radix(M, ns);
      for (int i = threadIdx.x; i < ns * (r - 1); i += blockDim.x) {
        const int k = i / (r - 1), q = i % (r - 1) + 1;
        dst[i] = twiddle[2 * q * k * (M / (ns * r))];
      }
      dst += ns * (r - 1);
    }
  }
  for (int i = threadIdx.x; i < frame_len; i += blockDim.x) w_s[i] = win[i];
  for (int i = threadIdx.x; i < n_packed; i += blockDim.x)
    melw[i] = mel_packed[i];
  if (mode == kMfcc) {
    for (int i = threadIdx.x; i < n_mel * n_cep; i += blockDim.x)
      dct_s[i] = dct[i];
    for (int i = threadIdx.x; i < n_cep; i += blockDim.x) lift_s[i] = lift[i];
  }
  if (threadIdx.x < 32) {
    // each band's offset in mel_packed: a warp scan of the widths
    int carry = 0;
    for (int m0 = 0; m0 < n_mel; m0 += 32) {
      const int m = m0 + threadIdx.x;
      int lo = 0, n = 0;
      if (m < n_mel) {
        lo = bands[2 * m];
        n = max(0, bands[2 * m + 1] - lo + 1);
      }
      int incl = n;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int up = __shfl_up_sync(~0u, incl, off);
        if (static_cast<int>(threadIdx.x) >= off) incl += up;
      }
      if (m < n_mel) {
        band_lo[m] = lo;
        band_n[m] = n;
        band_off[m] = carry + incl - n;
      }
      carry += __shfl_sync(~0u, incl, 31);
    }
  }
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* re = smem + lay.warp_row + warp * 2 * kRow;
  float* im = re + kRow;
  float* ps_tile = smem + lay.ps;
  float* log_e_s = smem + lay.log_e;
  const float inv_nfft = 1.0f / static_cast<float>(kN);
  // every frame starts on an even sample and has an even length
  const bool pairs = ((shift | hop | frame_len) & 1) == 0;

  for (int f = warp; f < n_tile; f += kWarps) {
    const float* x = frames + f * hop;
    // 3. the first pass, its points straight from the windowed samples
    {
      constexpr int R = radix(M, 1);
      float2 v[M / R / 32][R];
      if (pairs) {       // 8-byte loads of (x[n], x[n+1]) and the window's
#pragma unroll
        for (int bb = 0; bb < M / R / 32; ++bb)
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int n = 2 * (lane + 32 * bb + q * (M / R));
            v[bb][q] = make_float2(0.f, 0.f);
            if (n < frame_len) {
              const float2 xv = *reinterpret_cast<const float2*>(x + n);
              const float2 wv = *reinterpret_cast<const float2*>(w_s + n);
              v[bb][q] = make_float2(xv.x * wv.x, xv.y * wv.y);
            }
          }
      } else {
#pragma unroll
        for (int bb = 0; bb < M / R / 32; ++bb)
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int n = 2 * (lane + 32 * bb + q * (M / R));
            v[bb][q] = make_float2(n < frame_len ? x[n] * w_s[n] : 0.f,
                                   n + 1 < frame_len ? x[n + 1] * w_s[n + 1]
                                                     : 0.f);
          }
      }
      pass_store<M, 1, R>(v, re, im, ptw, lane);
      __syncwarp();
      fft_rest<M, R>(re, im, ptw, lane);
    }
    // 4. the split step into bins 0..M, and the power spectrum
    constexpr int kBins = M / 32 + 1;
    float p[kBins];
    float e_sum = 0.f;
#pragma unroll
    for (int r = 0; r < kBins; ++r) {
      const int k = lane + 32 * r;
      p[r] = 0.f;
      if (k <= M) {
        const int ik = pad(k & (M - 1)), jk = pad((M - k) & (M - 1));
        const float a = re[ik], bq = im[ik], c = re[jk], d = im[jk];
        const float2 w = __ldg(twiddle + k);     // coalesced, L1-resident
        const float xr = 0.5f * ((a + c) + w.x * (bq + d) + w.y * (a - c));
        const float xi = 0.5f * ((bq - d) + w.y * (bq + d) - w.x * (a - c));
        p[r] = (xr * xr + xi * xi) * inv_nfft;
        e_sum += p[r];
      }
    }
    // the frame's power row, odd-strided: a frame a lane reads it free of
    // bank conflicts in the mel sums
    float* ps = ps_tile + f * (M + 1);
#pragma unroll
    for (int r = 0; r < kBins; ++r) {
      const int k = lane + 32 * r;
      if (k <= M) ps[k] = p[r];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      e_sum += __shfl_xor_sync(~0u, e_sum, off);
    if (lane == 0)
      log_e_s[f] = logf(fmaxf(fmaxf(e_sum, FLT_EPSILON), floor_));
    __syncwarp();                          // the row is the next frame's
  }
  __syncthreads();

  // 5. mel over each filter's band, ascending, a frame a lane: the tile's
  //    frames are the lanes of 32 / tile filters at a time (the band
  //    weights are broadcast); log unless linear fbank
  constexpr int per_warp = 32 / kTile;     // filters a warp takes at once
  const int f = lane % kTile;
  const int ms = n_mel | 1;
  float* melv = smem + lay.melv;
  for (int m = warp * per_warp + lane / kTile; m < n_mel;
       m += kWarps * per_warp) {
    if (f >= n_tile) continue;
    const float* ps = ps_tile + f * (M + 1) + band_lo[m];
    const float* wm = melw + band_off[m];
    const int n = band_n[m];
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc = fmaf(ps[k], wm[k], acc);
    acc = fmaxf(acc, FLT_EPSILON);
    melv[f * ms + m] = mode == kFbank ? acc : logf(fmaxf(acc, floor_));
  }
  __syncthreads();

  // 6. DCT + lifter (MFCC) or the mel columns, plus the energy column, a
  //    frame a lane
  float* sout = smem + lay.out;
  for (int j = warp * per_warp + lane / kTile; j < n_out;
       j += kWarps * per_warp) {
    if (f >= n_tile) continue;
    const float* lm = melv + f * ms;
    float v;
    if (mode == kMfcc) {
      if (append_energy && j == 0) {
        v = log_e_s[f];
      } else {
        float acc = 0.f;
        for (int m = 0; m < n_mel; ++m)
          acc = fmaf(lm[m], dct_s[m * n_cep + j], acc);
        v = acc * lift_s[j];
      }
    } else {
      v = j < n_mel ? lm[j] : log_e_s[f];
    }
    sout[f * n_out + j] = v;
  }
  __syncthreads();
  // 7. the tile's rows are contiguous in out: coalesced stores
  float* dst = out + (static_cast<size_t>(b) * n_frames + t0) * n_out;
  for (int i = threadIdx.x; i < n_tile * n_out; i += blockDim.x)
    dst[i] = sout[i];
}

template <int M>
int launch(const float* pre, int n_sig, const float* win,
           const float* twiddle, const float* mel_packed, int n_packed,
           const int* bands, const float* dct, const float* lift, float* out,
           int batch, int n_frames, int frame_len, int hop, int n_mel,
           int n_cep, int n_out, float floor_, int mode, int append_energy,
           cudaStream_t stream) {
  const Layout lay(M, frame_len, hop, n_packed, n_mel, n_cep, n_out);
  const size_t smem = sizeof(float) * static_cast<size_t>(lay.total);
  auto kernel = fbank_fft_kernel<M>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((n_frames + kTile - 1) / kTile, batch);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      pre, n_sig, win, reinterpret_cast<const float2*>(twiddle), mel_packed,
      n_packed, bands, dct, lift, out, n_frames, frame_len, hop, n_mel,
      n_cep, n_out, floor_, mode, append_energy);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pre: [batch, n_sig] (frames past the row read zeros); win: [frame_len];
// twiddle: [nfft, 2] e^{-2 pi i k / nfft}; mel_packed: [n_packed] the band
// weights, filter by filter; bands: [n_mel, 2] each filter's first and last
// nonzero bin (last < first: an empty band); dct: [n_mel, n_cep]; lift:
// [n_cep]; out: [batch, n_frames, n_out].  Returns the CUDA error of the
// launch (0 on success).
extern "C" int asr_fbank_fft(const float* pre, int n_sig, const float* win,
                             const float* twiddle, const float* mel_packed,
                             int n_packed, const int* bands,
                             const float* dct, const float* lift, float* out,
                             int batch, int n_frames, int frame_len, int hop,
                             int nfft, int n_mel, int n_cep, int n_out,
                             float floor_, int mode, int append_energy,
                             void* stream) {
  if (frame_len > nfft || frame_len < 1 || n_mel < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0 || n_frames == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (nfft) {
    case 256:
      return launch<128>(pre, n_sig, win, twiddle, mel_packed, n_packed,
                bands, dct, lift, out, batch, n_frames, frame_len, hop,
                n_mel, n_cep, n_out, floor_, mode, append_energy, s);
    case 512:
      return launch<256>(pre, n_sig, win, twiddle, mel_packed, n_packed,
                bands, dct, lift, out, batch, n_frames, frame_len, hop,
                n_mel, n_cep, n_out, floor_, mode, append_energy, s);
    case 1024:
      return launch<512>(pre, n_sig, win, twiddle, mel_packed, n_packed,
                bands, dct, lift, out, batch, n_frames, frame_len, hop,
                n_mel, n_cep, n_out, floor_, mode, append_energy, s);
    case 2048:
      return launch<1024>(pre, n_sig, win, twiddle, mel_packed, n_packed,
                bands, dct, lift, out, batch, n_frames, frame_len, hop,
                n_mel, n_cep, n_out, floor_, mode, append_energy, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
