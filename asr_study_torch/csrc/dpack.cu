// The dpack wire decode in two launches: payload bit planes -> float32
// samples.  Retired: ops/dpack.py `dpack_decode` launches the one-launch
// design, csrc/dpack_onepass.cu; no route reaches this one, which stays as
// the yardstick that chip_smoke.py times in turns against it (and the GPU
// tests hold bit for bit against it).
//
// It replaced the TPU kernel asr_study_tpu/ops/pallas_dpack.py `_kernel`
// (via `dpack_decode`); the format is asr_study_tpu/data/wire.py's dpack v2.
// Block j of the stream owns the payload plane rows
// [row_start[j], row_start[j] + w_j), each 256 int16 words; plane p, word m,
// bit i = bit p of the block's sample 256*i + m.  The samples are the
// inclusive prefix sum, over the WHOLE concatenated stream, of the
// un-zigzagged deltas, wrapped to int16 and scaled by 1/32768.
//
// Two launches, one thread block of 256 threads per dpack block:
//   1. dpack_totals_kernel: each block's delta total;
//   2. dpack_decode_kernel: each block sums the totals before it (its
//      carry), decodes its 4096 deltas into shared memory in sample order,
//      scans them, adds the carry, wraps and writes.
// Thread m reads word m of each plane (512 B a plane, coalesced) and
// expands its 16 samples 256*i + m in registers.  Planes p >= w_j, and words
// outside the payload, read as 0.  Every sum is unsigned 32-bit: it wraps
// without undefined behaviour, and only the low 16 bits matter.
//
// What bounds it on the H100: the launches.  A batch reads its payload
// (~14 bits a sample) and writes 4 bytes a sample, a few microseconds at
// HBM rate, but two launches and the host's gap between them cost more
// (device 0.0123 ms against 0.0542 ms by CUDA events at a serving batch).
// The expansion is 16 shifts and masks a word and plane; the carry sum is
// quadratic in the block count (each block reads the totals before it,
// from L2), small at the serving shapes' ~690 blocks.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWords = 256;     // payload words a plane == threads a block
constexpr int kPlanes = 16;     // planes at most == samples a thread
constexpr int kBlock = kWords * kPlanes;   // 4096 samples a dpack block
constexpr int kWarps = kWords / 32;

// shared-memory slot of block sample x: one pad word every 32, so that
// thread t reading samples 16t..16t+15 and thread m reading 256i+m are both
// free of bank conflicts
__device__ __forceinline__ int slot(int x) { return x + (x >> 5); }
constexpr int kSlots = kBlock + kBlock / 32;

// Thread m's 16 zigzag-decoded deltas of block j: d[i] is the delta of
// block sample 256*i + m, as an unsigned two's-complement value.
__device__ __forceinline__ void block_deltas(
    const uint16_t* __restrict__ payload, long long n_words,
    const int* __restrict__ row_start, const int* __restrict__ widths, int j,
    int m, uint32_t d[kPlanes]) {
  const int w = min(max(widths[j], 0), kPlanes);
  const long long base = static_cast<long long>(row_start[j]) * kWords + m;
  uint32_t word[kPlanes];
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const long long at = base + static_cast<long long>(p) * kWords;
    word[p] = (p < w && at >= 0 && at < n_words) ? payload[at] : 0u;
  }
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) {
    uint32_t u = 0;
#pragma unroll
    for (int p = 0; p < kPlanes; ++p) u |= ((word[p] >> i) & 1u) << p;
    d[i] = (u >> 1) ^ (0u - (u & 1u));       // un-zigzag
  }
}

// Sum of v over the block's 256 threads, returned to every thread.
__device__ __forceinline__ uint32_t block_sum(uint32_t v, uint32_t* warp_sum) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(~0u, v, off);
  if ((threadIdx.x & 31) == 0) warp_sum[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t total = 0;
#pragma unroll
  for (int k = 0; k < kWarps; ++k) total += warp_sum[k];
  __syncthreads();                 // warp_sum may be reused after this
  return total;
}

__global__ void __launch_bounds__(kWords)
dpack_totals_kernel(const uint16_t* __restrict__ payload, long long n_words,
                    const int* __restrict__ row_start,
                    const int* __restrict__ widths,
                    uint32_t* __restrict__ totals) {
  __shared__ uint32_t warp_sum[kWarps];
  const int j = blockIdx.x;
  uint32_t d[kPlanes];
  block_deltas(payload, n_words, row_start, widths, j, threadIdx.x, d);
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) s += d[i];
  s = block_sum(s, warp_sum);
  if (threadIdx.x == 0) totals[j] = s;
}

__global__ void __launch_bounds__(kWords)
dpack_decode_kernel(const uint16_t* __restrict__ payload, long long n_words,
                    const int* __restrict__ row_start,
                    const int* __restrict__ widths,
                    const uint32_t* __restrict__ totals,
                    float* __restrict__ out) {
  __shared__ uint32_t buf[kSlots];
  __shared__ uint32_t warp_sum[kWarps];
  const int j = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;

  // the carry: every sample of the blocks before this one
  uint32_t c = 0;
  for (int k = t; k < j; k += kWords) c += totals[k];
  const uint32_t carry = block_sum(c, warp_sum);

  // deltas into shared memory in block sample order
  uint32_t d[kPlanes];
  block_deltas(payload, n_words, row_start, widths, j, t, d);
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) buf[slot(kWords * i + t)] = d[i];
  __syncthreads();

  // thread t scans its 16 consecutive samples 16t..16t+15
  uint32_t v[kPlanes];
  uint32_t run = 0;
#pragma unroll
  for (int k = 0; k < kPlanes; ++k) {
    run += buf[slot(kPlanes * t + k)];
    v[k] = run;
  }
  // exclusive scan of the 256 thread totals: within the warp, then across
  uint32_t incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const uint32_t up = __shfl_up_sync(~0u, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) warp_sum[warp] = incl;
  __syncthreads();
  uint32_t before = carry + incl - run;
  for (int k = 0; k < warp; ++k) before += warp_sum[k];
#pragma unroll
  for (int k = 0; k < kPlanes; ++k)
    buf[slot(kPlanes * t + k)] = before + v[k];
  __syncthreads();

  // wrap to int16, scale, write coalesced in sample order
  float* dst = out + static_cast<size_t>(j) * kBlock;
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) {
    const uint32_t x = buf[slot(kWords * i + t)];
    const int s = static_cast<int>((x + 32768u) & 0xFFFFu) - 32768;
    dst[kWords * i + t] = static_cast<float>(s) * (1.0f / 32768.0f);
  }
}

}  // namespace

// payload: int16 [n_words]; row_start, widths: int32 [nbcap]; totals: int32
// scratch [nbcap]; out: float32 [nbcap * 4096].  Returns the CUDA error of
// the launches (0 on success).
extern "C" int asr_dpack_decode(const int16_t* payload, long long n_words,
                                const int* row_start, const int* widths,
                                int* totals, float* out, int nbcap,
                                void* stream) {
  if (nbcap <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint16_t* words = reinterpret_cast<const uint16_t*>(payload);
  uint32_t* tot = reinterpret_cast<uint32_t*>(totals);
  dpack_totals_kernel<<<nbcap, kWords, 0, s>>>(words, n_words, row_start,
                                               widths, tot);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dpack_decode_kernel<<<nbcap, kWords, 0, s>>>(words, n_words, row_start,
                                               widths, tot, out);
  return static_cast<int>(cudaGetLastError());
}
