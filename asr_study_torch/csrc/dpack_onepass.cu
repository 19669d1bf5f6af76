// The dpack wire decode in one launch: payload bit planes -> float32
// samples.
//
// Replaces the TPU kernel asr_study_tpu/ops/pallas_dpack.py `_kernel` (via
// `dpack_decode`); the format is asr_study_tpu/data/wire.py's dpack v2.
// Block j of the stream owns the payload plane rows
// [row_start[j], row_start[j] + w_j), each 256 int16 words; plane p, word m,
// bit i = bit p of the block's sample 256*i + m.  The samples are the
// inclusive prefix sum, over the WHOLE concatenated stream, of the
// un-zigzagged deltas, wrapped to int16 and scaled by 1/32768.
//
// One cooperative launch (cudaLaunchCooperativeKernel): the grid holds only
// CTAs that are resident together (the occupancy calculator's CTAs an SM
// times the SMs), each of 256 threads, and CTA c owns the contiguous dpack
// blocks [c*nb/G, (c+1)*nb/G).
//   1. Each CTA expands its blocks' deltas once (the first block's stay in
//      registers) and writes its delta total to the scratch.
//   2. grid.sync().
//   3. Each CTA sums the totals of the CTAs before it (its carry), then
//      scans its blocks in order, in shared memory, adds the running carry,
//      wraps and writes.  Blocks past a CTA's first re-read the payload.
// Thread m reads word m of each plane (512 B a plane, coalesced) and turns
// its 16 plane words into its 16 samples 256*i + m with a 16x16 bit-matrix
// transpose: 4 rounds of masked swaps in place of 256 shift-and-or steps.
// Planes p >= w_j, and words outside the payload, read as 0.  Every sum is
// unsigned 32-bit: it wraps without undefined behaviour, only the low 16
// bits matter, and any order of the sums gives the same bits.
//
// What bounds it on the H100: the launch.  A serving batch reads ~1.4 MB of
// payload and writes ~11 MB of samples, a few microseconds at HBM rate; the
// two-launch design (csrc/dpack.cu) paid a second launch and a per-block
// carry sum for it, this one a grid barrier.  The scratch holds one total a
// CTA and persists across calls (the wrapper keeps one for each device and
// stream, so the decodes that share it run one after another), so a call
// allocates nothing.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kWords = 256;     // payload words a plane == threads a CTA
constexpr int kPlanes = 16;     // planes at most == samples a thread
constexpr int kBlock = kWords * kPlanes;   // 4096 samples a dpack block
constexpr int kWarps = kWords / 32;

// shared-memory slot of block sample x: one pad word every 32, so that
// thread t reading samples 16t..16t+15 and thread m reading 256i+m are both
// free of bank conflicts
__device__ __forceinline__ int slot(int x) { return x + (x >> 5); }
constexpr int kSlots = kBlock + kBlock / 32;

// One round of the bit-matrix transpose: for each row pair (p, p + S), p
// with bit S clear, swap row p's columns i + S with row p + S's columns i
// (i with bit S clear; `mask` selects them).
template <int S>
__device__ __forceinline__ void swap_blocks(uint32_t d[kPlanes],
                                            uint32_t mask) {
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    if (p & S) continue;
    const uint32_t t = ((d[p] >> S) ^ d[p + S]) & mask;
    d[p + S] ^= t;
    d[p] ^= t << S;
  }
}

// Thread m's 16 zigzag-decoded deltas of block j: d[i] is the delta of
// block sample 256*i + m, as an unsigned two's-complement value.
__device__ __forceinline__ void block_deltas(
    const uint16_t* __restrict__ payload, long long n_words,
    const int* __restrict__ row_start, const int* __restrict__ widths, int j,
    int m, uint32_t d[kPlanes]) {
  const int w = min(max(widths[j], 0), kPlanes);
  const long long base = static_cast<long long>(row_start[j]) * kWords + m;
#pragma unroll
  for (int p = 0; p < kPlanes; ++p) {
    const long long at = base + static_cast<long long>(p) * kWords;
    d[p] = (p < w && at >= 0 && at < n_words) ? payload[at] : 0u;
  }
  // transpose the 16x16 bit matrix d[p] bit i -> d[i] bit p: swap the
  // off-diagonal s x s blocks, s = 8, 4, 2, 1
  swap_blocks<8>(d, 0x00FFu);
  swap_blocks<4>(d, 0x0F0Fu);
  swap_blocks<2>(d, 0x3333u);
  swap_blocks<1>(d, 0x5555u);
#pragma unroll
  for (int i = 0; i < kPlanes; ++i)
    d[i] = (d[i] >> 1) ^ (0u - (d[i] & 1u));       // un-zigzag
}

// Sum of v over the CTA's 256 threads, returned to every thread.
__device__ __forceinline__ uint32_t cta_sum(uint32_t v, uint32_t* warp_sum) {
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
dpack_onepass_kernel(const uint16_t* __restrict__ payload, long long n_words,
                     const int* __restrict__ row_start,
                     const int* __restrict__ widths, uint32_t* cta_total,
                     float* __restrict__ out, int nbcap) {
  __shared__ uint32_t buf[kSlots];
  __shared__ uint32_t warp_sum[kWarps];
  const int t = threadIdx.x;
  const int lane = t & 31, warp = t >> 5;
  const int c = blockIdx.x;
  const int j0 = static_cast<int>(static_cast<long long>(nbcap) * c /
                                  gridDim.x);
  const int j1 = static_cast<int>(static_cast<long long>(nbcap) * (c + 1) /
                                  gridDim.x);

  // 1. the CTA's delta total; the first block's deltas stay in registers
  uint32_t d[kPlanes];
  block_deltas(payload, n_words, row_start, widths, j0, t, d);
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < kPlanes; ++i) s += d[i];
  for (int j = j0 + 1; j < j1; ++j) {
    uint32_t e[kPlanes];
    block_deltas(payload, n_words, row_start, widths, j, t, e);
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) s += e[i];
  }
  s = cta_sum(s, warp_sum);
  if (t == 0) cta_total[c] = s;
  __threadfence();
  cg::this_grid().sync();

  // 2. the carry: every sample of the CTAs before this one
  uint32_t cc = 0;
  for (int k = t; k < c; k += kWords) cc += __ldcg(cta_total + k);
  uint32_t carry = cta_sum(cc, warp_sum);

  // 3. scan each block in order, from the running carry
  for (int j = j0; j < j1; ++j) {
    if (j > j0) block_deltas(payload, n_words, row_start, widths, j, t, d);
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
    uint32_t block_total = 0;
#pragma unroll
    for (int k = 0; k < kWarps; ++k) {
      if (k < warp) before += warp_sum[k];
      block_total += warp_sum[k];
    }
#pragma unroll
    for (int k = 0; k < kPlanes; ++k)
      buf[slot(kPlanes * t + k)] = before + v[k];
    __syncthreads();
    // wrap to int16, scale, write coalesced in sample order
    float* dst = out + static_cast<size_t>(j) * kBlock;
#pragma unroll
    for (int i = 0; i < kPlanes; ++i) {
      const uint32_t x = buf[slot(kWords * i + t)];
      const int smp = static_cast<int>((x + 32768u) & 0xFFFFu) - 32768;
      dst[kWords * i + t] = static_cast<float>(smp) * (1.0f / 32768.0f);
    }
    carry += block_total;
    __syncthreads();               // buf and warp_sum are reused
  }
}

// CTAs of the kernel resident together on the current device (cached by
// device)
int max_ctas() {
  static int cached[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (cached[dev] > 0) return cached[dev];
  int per_sm = 0, sms = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, dpack_onepass_kernel, kWords, 0) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  cached[dev] = per_sm * sms;
  return cached[dev];
}

}  // namespace

// payload: int16 [n_words]; row_start, widths: int32 [nbcap]; scratch:
// int32 [scratch_cap], one total a CTA; out: float32 [nbcap * 4096].
// Returns the CUDA error of the launch (0 on success).
extern "C" int asr_dpack_decode_onepass(const int16_t* payload,
                                        long long n_words,
                                        const int* row_start,
                                        const int* widths, int* scratch,
                                        int scratch_cap, float* out,
                                        int nbcap, void* stream) {
  if (nbcap <= 0) return 0;
  const int resident = max_ctas();
  if (resident <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  int grid = nbcap < resident ? nbcap : resident;
  if (grid > scratch_cap) grid = scratch_cap;
  if (grid <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const uint16_t* words = reinterpret_cast<const uint16_t*>(payload);
  uint32_t* tot = reinterpret_cast<uint32_t*>(scratch);
  void* args[] = {&words, &n_words, &row_start, &widths, &tot, &out, &nbcap};
  cudaError_t err = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(dpack_onepass_kernel), dim3(grid),
      dim3(kWords), args, 0, static_cast<cudaStream_t>(stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}
