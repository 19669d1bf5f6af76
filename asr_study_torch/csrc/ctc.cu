// CTC lattice recursions: the log-space alpha walk (forward) and the beta
// walk that gives the state posteriors gamma = alpha + beta (backward).
//
// Replaces the TPU kernels asr_study_tpu/ops/pallas_ctc.py `_fwd_kernel`
// (alpha) and `_bwd_kernel` (beta); the maths of both is
// asr_study_tpu/ops/ctc.py (`_logadd3`, the LOG_EPS floor, the virtual
// pre-start state, pass-through on padded frames).
//
// Layout: lp_ext, alpha_seq and gamma are [T, B, S] (S = 2L+1 lattice
// states, the real S: no lane padding), valid is [T, B], the skip gates
// [B, S].  One block per batch row, one thread per lattice state (strided
// when S exceeds the block), the loop over time inside the block.
//
// Its role: the route for lattices beyond the warp design of ctc_warp.cu
// (S > 544 states, ops/ctc.py CTC_WARP_MAX_S and `ctc_design`); the main
// paths' lattices (S = 97 at L = 48) take the warp design.
//
// What bounds it on the H100: the walk is serial in time and each step is a
// handful of transcendental ops on S values, so a step costs one
// shared-memory exchange and one barrier, plus the latency of the frame's
// emission load, which alpha issues after the barrier and beta needs a few
// instructions after its load.  The lattice neighbours (s-1, s-2 forward;
// s+1, s+2 backward) come from a double-buffered row in shared memory, so
// each step needs one __syncthreads only.  Only B blocks run (32 at the
// main path's shapes): the card is far from full, and the kernel is
// latency bound.  Both use IEEE expf/logf (no fast math): LOG_EPS
// arithmetic and 512-step log-sums need them.

#include <cuda_runtime.h>

namespace {

constexpr float kLogEps = -1e30f;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float logadd3(float a, float b, float c) {
  float mx = fmaxf(fmaxf(a, b), c);
  mx = fmaxf(mx, kLogEps);
  return mx + logf(expf(a - mx) + expf(b - mx) + expf(c - mx));
}

// alpha[t] = max(logadd3(alpha[s], alpha[s-1], alpha[s-2] + skip[s])
//                + lp[t, s], LOG_EPS), held where frame t is padded.
__global__ void __launch_bounds__(kMaxThreads)
ctc_alpha_kernel(const float* __restrict__ lp, const float* __restrict__ valid,
                 const float* __restrict__ skip, float* __restrict__ alpha_seq,
                 int T, int B, int S) {
  extern __shared__ float smem[];
  float* buf[2] = {smem, smem + S};   // alpha of the previous step, twice
  const int b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    buf[0][s] = s == 0 ? 0.f : kLogEps;   // virtual pre-start state
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* cur = buf[t & 1];
    float* nxt = buf[(t + 1) & 1];
    const size_t row = (static_cast<size_t>(t) * B + b) * S;
    const bool v = valid[static_cast<size_t>(t) * B + b] > 0.f;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float a0 = cur[s];
      const float a1 = s >= 1 ? cur[s - 1] : kLogEps;
      const float a2 = (s >= 2 ? cur[s - 2] : kLogEps) + skip[b * S + s];
      float a = fmaxf(logadd3(a0, a1, a2) + lp[row + s], kLogEps);
      if (!v) a = a0;
      nxt[s] = a;
      alpha_seq[row + s] = a;
    }
    __syncthreads();
  }
}

// The reverse walk.  beta_t is the completion log-prob from each state after
// frame t's emission; the carry holds frame t+1's emissions and validity.
__global__ void __launch_bounds__(kMaxThreads)
ctc_beta_kernel(const float* __restrict__ lp, const float* __restrict__ valid,
                const float* __restrict__ alpha_seq,
                const float* __restrict__ skip2,
                const float* __restrict__ end_ind, float* __restrict__ gamma,
                int T, int B, int S) {
  extern __shared__ float smem[];
  float* beta = smem;                       // [S], each thread its own states
  float* lp_next = smem + S;                // [S], ditto
  float* buf[2] = {smem + 2 * S, smem + 3 * S};  // beta + lp_next, shared
  const int b = blockIdx.x;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    beta[s] = end_ind[b * S + s];
    lp_next[s] = 0.f;
  }
  bool v_next = false;                      // frame T is past the end

  for (int k = 0; k < T; ++k) {
    const int t = T - 1 - k;
    float* be = buf[k & 1];
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      be[s] = beta[s] + lp_next[s];
    __syncthreads();
    const size_t row = (static_cast<size_t>(t) * B + b) * S;
    const bool v = valid[static_cast<size_t>(t) * B + b] > 0.f;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float b0 = be[s];
      const float b1 = s + 1 < S ? be[s + 1] : kLogEps;
      const float b2 = (s + 2 < S ? be[s + 2] : kLogEps) + skip2[b * S + s];
      if (v_next) beta[s] = fmaxf(logadd3(b0, b1, b2), kLogEps);
      gamma[row + s] = v ? alpha_seq[row + s] + beta[s] : kLogEps;
      lp_next[s] = lp[row + s];
    }
    v_next = v;
  }
}

int threads_for(int S) {
  const int warps = ((S + 31) / 32) * 32;
  return warps < kMaxThreads ? warps : kMaxThreads;
}

}  // namespace

extern "C" int asr_ctc_alpha(const float* lp, const float* valid,
                             const float* skip, float* alpha_seq, int T,
                             int B, int S, void* stream) {
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(S);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_alpha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_alpha_kernel<<<B, threads_for(S), smem,
                     static_cast<cudaStream_t>(stream)>>>(lp, valid, skip,
                                                          alpha_seq, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int asr_ctc_beta(const float* lp, const float* valid,
                            const float* alpha_seq, const float* skip2,
                            const float* end_ind, float* gamma, int T, int B,
                            int S, void* stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(S);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_beta_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_beta_kernel<<<B, threads_for(S), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      lp, valid, alpha_seq, skip2, end_ind, gamma, T, B, S);
  return static_cast<int>(cudaGetLastError());
}
