// CTC lattice recursions, the warp design: the log-space alpha walk
// (forward) and the beta walk that gives the state posteriors
// gamma = alpha + beta (backward), for lattices of up to kMaxJ * 32 = 544
// states (ops/ctc.py CTC_WARP_MAX_S; longer ones take the block design of
// ctc.cu).
//
// Replaces the TPU kernels asr_study_tpu/ops/pallas_ctc.py `_fwd_kernel`
// (alpha) and `_bwd_kernel` (beta); the maths of both is
// asr_study_tpu/ops/ctc.py (`_logadd3`, the LOG_EPS floor, the virtual
// pre-start state, pass-through on padded frames).  Each entry point takes
// the arguments of its ctc.cu twin and computes the same function with the
// same per-state arithmetic.
//
// Layout: lp_ext, alpha_seq and gamma are [T, B, S] (S = 2L+1 lattice
// states), valid is [T, B], the skip gates and end_ind [B, S].
//
// What bounds it on the H100: the walk is serial in time and only B rows
// wide (32 on the main path), so its time is T times the latency of one
// step; the bytes (a few MB) and the operations are far below the card's
// rates.  A step is one logadd3 chain (three IEEE expf, one logf: some 35
// dependent instructions) on each state, fed by the states' lattice
// neighbours and the frame's emissions.  The design keeps everything else
// off that chain:
//
// - J = ceil(S / 32) warps walk one batch row (one block), lane l of warp
//   j holding the state s = l + 32 j in registers, so a frame's row load
//   and store are coalesced and each warp runs one chain a step, the J
//   warps on the SM's sub-partitions side by side.  The neighbours s-1
//   and s-2 (alpha) or s+1 and s+2 (beta) come by one __shfl_sync each;
//   the two lanes at a warp's edge take the neighbouring warp's two edge
//   states through a double-buffered row in shared memory behind one
//   named barrier of the row's warps.
// - The skip gates (and end_ind) are read once into registers.  Each
//   frame's lp row and valid flag (beta: also its alpha row) are loaded
//   kDepth frames ahead into a ring of registers: the time loop is
//   unrolled kDepth times, slot u of the ring is read at step u of an
//   unrolled round and refilled right after with the frame kDepth steps
//   on, so a load's latency lies under kDepth steps of the walk, and no
//   wait, shared-memory read or fence sits in the step.  Beta's carried
//   lp_next is the previous frame's slot.
// - The step has no branch (see the kernels).
//
// kSplitRow = false selects the other thread shape, measured against this
// one (lstm_step_split.py): one warp a row, J states a lane (s = l + 32 j),
// all neighbours by shuffles and no barrier, but the row's J chains issued
// by one warp.  Both use IEEE expf/logf (no fast math): LOG_EPS arithmetic
// and 512-step log-sums need them.

#include <cuda_runtime.h>

namespace {

constexpr float kLogEps = -1e30f;
constexpr int kMaxJ = 17;          // chunks of 32 states: S <= 544
constexpr int kDepth = 16;         // frames fetched ahead
constexpr int kRingFloats = 144;   // registers a lane the ring may take
constexpr bool kSplitRow = true;   // J warps a row, not one
constexpr unsigned kFull = 0xffffffffu;

// The ring's depth for `per` floats a frame: kDepth, fewer for the widest
// lattices, whose ring would crowd out the states' registers.
__host__ __device__ constexpr int ring_depth(int per) {
  return kDepth * per <= kRingFloats ? kDepth
         : kRingFloats / per < 2     ? 2
                                     : kRingFloats / per;
}

__device__ __forceinline__ float logadd3(float a, float b, float c) {
  float mx = fmaxf(fmaxf(a, b), c);
  mx = fmaxf(mx, kLogEps);
  return mx + logf(expf(a - mx) + expf(b - mx) + expf(c - mx));
}

// A store under a predicate, not a branch around one: the step stays one
// block of straight-line code that the compiler can schedule as a whole.
__device__ __forceinline__ void store_if(bool p, float* at, float x) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %0, 0;\n"
      " @p st.global.f32 [%1], %2;\n}\n" ::"r"(static_cast<int>(p)),
      "l"(at), "f"(x));
}

template <int kThreads>
__device__ __forceinline__ void row_barrier() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kThreads) : "memory");
}

// alpha[t] = max(logadd3(alpha[s], alpha[s-1], alpha[s-2] + skip[s])
//                + lp[t, s], LOG_EPS), held where frame t is padded.
// JW states a lane, W warps a row (lane l of warp w holds chunks
// w*JW .. w*JW + JW - 1); the split shape's chunk edges go through
// __shared__ xrow [2][W][2].  The step has no branch: the walk runs whole
// rounds of D steps, a step past T being a held frame whose row is not
// stored, and a fetch past T reads frame T - 1 again, and the addresses are
// pointers stepped a frame at a time, so that the compiler can spread the
// loads, stores and their addresses over the chain's stalls.
template <int JW, int W>
__global__ void __launch_bounds__(32 * W)
ctc_alpha_warp_kernel(const float* __restrict__ lp,
                      const float* __restrict__ valid,
                      const float* __restrict__ skip,
                      float* __restrict__ alpha_seq, int T, int B, int S) {
  constexpr int kThreads = 32 * W, D = ring_depth(JW + 1);
  [[maybe_unused]] __shared__ float xrow[W > 1 ? 4 * W : 1];
  const int b = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t frame = static_cast<size_t>(B) * S;  // one frame's stride
  int s_of[JW];
  bool in[JW];
  float skp[JW], cur[JW];
#pragma unroll
  for (int i = 0; i < JW; ++i) {
    s_of[i] = 32 * (w * JW + i) + lane;
    in[i] = s_of[i] < S;
    skp[i] = in[i] ? skip[b * S + s_of[i]] : kLogEps;
    cur[i] = s_of[i] == 0 ? 0.f : kLogEps;  // virtual pre-start state
  }
  // this row's frames by pointers that step a frame at a time: the next
  // fetch's (it stays on frame T - 1 once there) and the next store's
  const float* lp_at = lp + static_cast<size_t>(b) * S;
  const float* valid_at = valid + b;
  float* out_at[JW];
#pragma unroll
  for (int i = 0; i < JW; ++i)
    out_at[i] = alpha_seq + static_cast<size_t>(b) * S + s_of[i];
  // the ring: frame t's emissions (0 past the lattice) and valid flag in
  // slot t % D, loaded D frames before their step
  float ring_lp[D][JW], ring_v[D];
  auto fetch = [&](int u, int f) {
#pragma unroll
    for (int i = 0; i < JW; ++i) ring_lp[u][i] = in[i] ? lp_at[s_of[i]] : 0.f;
    ring_v[u] = *valid_at;
    if (f + 1 < T) {
      lp_at += frame;
      valid_at += B;
    }
  };
#pragma unroll
  for (int u = 0; u < D; ++u) fetch(u, u);

  for (int t0 = 0; t0 < T; t0 += D) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int t = t0 + u;
      const bool live = t < T;
      // chunk 0's lanes 0 and 1: the warp below, or nothing
      float lo1 = kLogEps, lo2 = kLogEps;
      if constexpr (W > 1) {
        float* x = xrow + (t & 1) * 2 * W;
        if (lane >= 30) x[2 * w + lane - 30] = cur[JW - 1];
        row_barrier<kThreads>();
        if (w > 0 && lane < 2) {
          lo1 = x[2 * w - 1];
          lo2 = x[2 * (w - 1) + lane];
        }
      }
      float a1[JW], a2[JW];
#pragma unroll
      for (int i = 0; i < JW; ++i) {
        const float below = i > 0 ? cur[i - 1] : cur[i];
        a1[i] = __shfl_sync(kFull, lane == 31 ? below : cur[i],
                            (lane + 31) & 31);
        a2[i] = __shfl_sync(kFull, lane >= 30 ? below : cur[i],
                            (lane + 30) & 31);
      }
      if (lane == 0) a1[0] = lo1;
      if (lane < 2) a2[0] = lo2;
      const bool v = live && ring_v[u] > 0.f;
#pragma unroll
      for (int i = 0; i < JW; ++i) {
        const float a = fmaxf(logadd3(cur[i], a1[i], a2[i] + skp[i])
                              + ring_lp[u][i], kLogEps);
        cur[i] = v ? a : cur[i];
        store_if(in[i] && live, out_at[i], cur[i]);
        out_at[i] += frame;
      }
      fetch(u, t + D);
    }
  }
}

// The reverse walk.  beta_t is the completion log-prob from each state after
// frame t's emission; the carry holds frame t+1's emissions and validity.
// States past the lattice stay at LOG_EPS (their logadd3 of three floors is
// the floor), so they feed s+1 and s+2 as the block design's fill does.
// Branch-free as alpha: a step past T reads frame 0 again and stores
// nothing.
template <int JW, int W>
__global__ void __launch_bounds__(32 * W)
ctc_beta_warp_kernel(const float* __restrict__ lp,
                     const float* __restrict__ valid,
                     const float* __restrict__ alpha_seq,
                     const float* __restrict__ skip2,
                     const float* __restrict__ end_ind,
                     float* __restrict__ gamma, int T, int B, int S) {
  constexpr int kThreads = 32 * W, D = ring_depth(2 * JW + 1);
  [[maybe_unused]] __shared__ float xrow[W > 1 ? 4 * W : 1];
  const int b = blockIdx.x, lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const size_t frame = static_cast<size_t>(B) * S;
  int s_of[JW];
  bool in[JW];
  float skp2[JW], beta[JW], lp_next[JW];
#pragma unroll
  for (int i = 0; i < JW; ++i) {
    s_of[i] = 32 * (w * JW + i) + lane;
    in[i] = s_of[i] < S;
    skp2[i] = in[i] ? skip2[b * S + s_of[i]] : kLogEps;
    beta[i] = in[i] ? end_ind[b * S + s_of[i]] : kLogEps;
    lp_next[i] = 0.f;
  }
  // pointers from frame T - 1 down, a frame a step: the next fetch's (it
  // stays on frame 0 once there) and the next store's
  const size_t last = static_cast<size_t>(T - 1) * frame +
                      static_cast<size_t>(b) * S;
  const float* lp_at = lp + last;
  const float* alpha_at = alpha_seq + last;
  const float* valid_at = valid + static_cast<size_t>(T - 1) * B + b;
  float* out_at[JW];
#pragma unroll
  for (int i = 0; i < JW; ++i) out_at[i] = gamma + last + s_of[i];
  // the ring: walk step k's frame (T - 1 - k) in slot k % D, its
  // emissions, alpha row and valid flag
  float ring_lp[D][JW], ring_a[D][JW], ring_v[D];
  auto fetch = [&](int u, int k) {
#pragma unroll
    for (int i = 0; i < JW; ++i) {
      ring_lp[u][i] = in[i] ? lp_at[s_of[i]] : 0.f;
      ring_a[u][i] = in[i] ? alpha_at[s_of[i]] : 0.f;
    }
    ring_v[u] = *valid_at;
    if (k + 1 < T) {
      lp_at -= frame;
      alpha_at -= frame;
      valid_at -= B;
    }
  };
#pragma unroll
  for (int u = 0; u < D; ++u) fetch(u, u);
  bool v_next = false;  // frame T is past the end

  for (int k0 = 0; k0 < T; k0 += D) {
#pragma unroll
    for (int u = 0; u < D; ++u) {
      const int k = k0 + u;
      const bool live = k < T;
      float be[JW];
#pragma unroll
      for (int i = 0; i < JW; ++i) be[i] = beta[i] + lp_next[i];
      // the last chunk's lanes 30 and 31: the warp above, or nothing
      float hi1 = kLogEps, hi2 = kLogEps;
      if constexpr (W > 1) {
        float* x = xrow + (k & 1) * 2 * W;
        if (lane < 2) x[2 * w + lane] = be[0];
        row_barrier<kThreads>();
        if (w + 1 < W && lane >= 30) {
          hi1 = x[2 * (w + 1)];
          hi2 = x[2 * (w + 1) + lane - 30];
        }
      }
      float b1[JW], b2[JW];
#pragma unroll
      for (int i = 0; i < JW; ++i) {
        const float above = i + 1 < JW ? be[i + 1] : be[i];
        b1[i] = __shfl_sync(kFull, lane == 0 ? above : be[i],
                            (lane + 1) & 31);
        b2[i] = __shfl_sync(kFull, lane < 2 ? above : be[i],
                            (lane + 2) & 31);
      }
      if (lane == 31) b1[JW - 1] = hi1;
      if (lane >= 30) b2[JW - 1] = hi2;
      const bool v = ring_v[u] > 0.f;
#pragma unroll
      for (int i = 0; i < JW; ++i) {
        const float upd = fmaxf(logadd3(be[i], b1[i], b2[i] + skp2[i]),
                                kLogEps);
        beta[i] = v_next ? upd : beta[i];
        store_if(in[i] && live, out_at[i],
                 v ? ring_a[u][i] + beta[i] : kLogEps);
        out_at[i] -= frame;
        lp_next[i] = ring_lp[u][i];
      }
      v_next = v;
      fetch(u, k + D);
    }
  }
}

// J = ceil(S / 32) as a template argument: the launch of one shape.
template <int J>
int launch_alpha(const float* lp, const float* valid, const float* skip,
                 float* alpha_seq, int T, int B, int S, cudaStream_t stream) {
  constexpr int JW = kSplitRow ? 1 : J, W = kSplitRow ? J : 1;
  ctc_alpha_warp_kernel<JW, W><<<B, 32 * W, 0, stream>>>(
      lp, valid, skip, alpha_seq, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

template <int J>
int launch_beta(const float* lp, const float* valid, const float* alpha_seq,
                const float* skip2, const float* end_ind, float* gamma,
                int T, int B, int S, cudaStream_t stream) {
  constexpr int JW = kSplitRow ? 1 : J, W = kSplitRow ? J : 1;
  ctc_beta_warp_kernel<JW, W><<<B, 32 * W, 0, stream>>>(
      lp, valid, alpha_seq, skip2, end_ind, gamma, T, B, S);
  return static_cast<int>(cudaGetLastError());
}

template <int J = 1, typename... Args>
int dispatch_alpha(int j, Args... args) {
  if (j == J) return launch_alpha<J>(args...);
  if constexpr (J < kMaxJ) return dispatch_alpha<J + 1>(j, args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int J = 1, typename... Args>
int dispatch_beta(int j, Args... args) {
  if (j == J) return launch_beta<J>(args...);
  if constexpr (J < kMaxJ) return dispatch_beta<J + 1>(j, args...);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// S beyond kMaxJ * 32 is refused (cudaErrorInvalidValue): the block design
// of ctc.cu takes it.
extern "C" int asr_ctc_alpha_warp(const float* lp, const float* valid,
                                  const float* skip, float* alpha_seq, int T,
                                  int B, int S, void* stream) {
  return dispatch_alpha((S + 31) / 32, lp, valid, skip, alpha_seq, T, B, S,
                        static_cast<cudaStream_t>(stream));
}

extern "C" int asr_ctc_beta_warp(const float* lp, const float* valid,
                                 const float* alpha_seq, const float* skip2,
                                 const float* end_ind, float* gamma, int T,
                                 int B, int S, void* stream) {
  return dispatch_beta((S + 31) / 32, lp, valid, alpha_seq, skip2, end_ind,
                       gamma, T, B, S, static_cast<cudaStream_t>(stream));
}
