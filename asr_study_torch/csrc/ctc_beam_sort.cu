// The beam decode's first design (the sort design), kept for timing only:
// no route reaches it and asr_study_torch/_build.py leaves it out of the
// kernel library.  `python3 lstm_step_split.py ctc_beam` builds it on its
// own and times it in turns against csrc/ctc_beam.cu, which computes the
// same function with a merge by one lookup a (stay, parent) pair and a
// top-W selection in place of this file's W*E compares a stay and its
// full bitonic sort a frame.  Its entry point keeps the name and the
// arguments of csrc/ctc_beam.cu's.
//
// CTC prefix beam search with optional char n-gram LM shallow fusion: the
// whole time loop of a batch's decode in one launch, one CTA per
// utterance.
//
// The counterpart of asr_study_tpu/ops/beam.py `_make_step` (its gather
// form), `_materialize` and `_decode_single`, which the JAX package runs as
// one XLA scan; the plain twin is ops/beam.py `beam_search_plain`.  Each
// frame, with the beam state in shared memory:
//
// 1. load the frame's row of V log-probs;
// 2. pick the extension characters: all V-1, or with prune the top E by
//    (value descending, index ascending), each character's rank counted
//    against the others, which is jax.lax.top_k's order;
// 3. score the W stays and the W*E extensions, the LM term added to each
//    extension as (x + alpha*lm) + beta rounded step by step (no FMA: torch
//    rounds the product and the sums apart);
// 4. merge: a warp per stay w compares w's two uint32 hash lanes with every
//    extension's (recomputed from its parent's), takes the largest matched
//    extension score into w's p_nonblank and kills the matched extensions
//    (their score becomes LOG_EPS);
// 5. keep the top W of the W + W*E candidates: a bitonic sort of 64-bit
//    keys (score descending in the high word, candidate index in the low),
//    padded to a power of two, so the ranking is exact and ties go to the
//    lower index, as jax.lax.top_k breaks them;
// 6. gather the winners' state into the other buffer and write the frame's
//    backpointers, parent | (char + 1) << 16, to bp [B, T, W].
//
// Frames past an utterance's length are not walked (the reference carries
// the state through them and writes identity backpointers, which the walk
// back passes through unchanged).  After the last frame the W final scores
// are sorted the same way and a thread per kept path walks the
// backpointers back, writing the emitted characters at their positions.
//
// The arithmetic is the twin's: _logadd as ops/ctc.py does it (max, clamp
// at LOG_EPS, expf of min minus max, log1pf, add), IEEE expf and log1pf
// (no fast math), uint32 hashes that wrap natively.
//
// Limits (the select design's route, ops/beam.py SELECT_MAX_WIDTH and
// SELECT_MAX_VOCAB): W <= 128, V <= 64;
// the keys and extension scores take (npad * 8 + W*E*4) bytes of dynamic
// shared memory, npad = the power of two >= W + W*E (at most 97,792 B).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLogEps = -1e30f;
constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxW = 128;
constexpr int kMaxV = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float logadd(float a, float b) {
  const float mx = fmaxf(fmaxf(a, b), kLogEps);
  return mx + log1pf(expf(fminf(a, b) - mx));
}

// Sort key: ascending keys order the scores descending, then the candidate
// index ascending.  -0 ranks as +0 (they compare equal).
__device__ __forceinline__ uint64_t make_key(float score, int index) {
  uint32_t u = __float_as_uint(score);
  if (u == 0x80000000u) u = 0;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);   // ascending in score
  return (static_cast<uint64_t>(~u) << 32) | static_cast<uint32_t>(index);
}

__device__ __forceinline__ int key_index(uint64_t key) {
  return static_cast<int>(static_cast<uint32_t>(key));
}

// Ascending bitonic sort of keys[0, n), n a power of two, by the whole
// block; ends with a barrier.
__device__ void bitonic_sort(uint64_t* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += kThreads) {
        const int i = 2 * p - (p & (j - 1));    // bit j of i is clear
        const int l = i + j;
        const uint64_t a = keys[i], c = keys[l];
        if ((a > c) == ((i & k) == 0)) {
          keys[i] = c;
          keys[l] = a;
        }
      }
      __syncthreads();
    }
  }
}

__global__ void __launch_bounds__(kThreads)
ctc_beam_kernel(const float* __restrict__ log_probs,
                const int* __restrict__ lengths,
                const float* __restrict__ lm_logp, int* __restrict__ bp,
                int* __restrict__ prefixes, int* __restrict__ out_len,
                float* __restrict__ out_score, int T, int V, int W, int P,
                int E, int pad_id, int lm_order, int lm_mod, int lm_state0,
                float alpha, float beta, uint32_t mult1, uint32_t mult2,
                int npad) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* keys = reinterpret_cast<uint64_t*>(smem);       // [npad]
  float* ext_pnb = reinterpret_cast<float*>(keys + npad);   // [W * E]

  // the beam state, two buffers: lengths, last char, p_blank, p_nonblank,
  // the hash lanes, the LM context
  __shared__ int s_len[2][kMaxW], s_last[2][kMaxW], s_lm[2][kMaxW];
  __shared__ float s_pb[2][kMaxW], s_pnb[2][kMaxW];
  __shared__ uint32_t s_h1[2][kMaxW], s_h2[2][kMaxW];
  // a frame's per-beam terms, its row and extension characters
  __shared__ float s_ptot[kMaxW], s_stay_pb[kMaxW], s_stay_pnb[kMaxW];
  __shared__ float s_lp[kMaxV], s_lpc[kMaxV];
  __shared__ int s_chars[kMaxV];

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int n_char = V - 1, blank = V - 1;
  const int n_ext = W * E;
  const int len = min(max(lengths[b], 0), T);
  const float* lp_row = log_probs + static_cast<size_t>(b) * T * V;
  int* bp_b = bp + static_cast<size_t>(b) * T * W;

  for (int w = tid; w < W; w += kThreads) {
    s_len[0][w] = 0;
    s_last[0][w] = -1;
    s_pb[0][w] = w == 0 ? 0.0f : kLogEps;
    s_pnb[0][w] = kLogEps;
    s_h1[0][w] = w == 0 ? 1u : 0xDEAD0000u + w;
    s_h2[0][w] = w == 0 ? 1u : 0xBEEF0000u + w;
    s_lm[0][w] = lm_state0;
  }
  int cur = 0;
  __syncthreads();

  for (int t = 0; t < len; ++t, lp_row += V) {
    // 1. the frame's row
    for (int v = tid; v < V; v += kThreads) s_lp[v] = lp_row[v];
    __syncthreads();

    // 2. the extension characters; the stays' terms
    if (tid < n_char) {
      const float x = s_lp[tid];
      int rank = tid;
      if (E < n_char) {
        rank = 0;
        for (int c = 0; c < n_char; ++c) {
          const float y = s_lp[c];
          rank += (y > x) || (y == x && c < tid);
        }
      }
      if (rank < E) {
        s_chars[rank] = tid;
        s_lpc[rank] = x;
      }
    }
    for (int w = tid; w < W; w += kThreads) {
      const float pnb = s_pnb[cur][w];
      const float ptot = logadd(s_pb[cur][w], pnb);
      const int last = s_last[cur][w];
      s_ptot[w] = ptot;
      s_stay_pb[w] = ptot + s_lp[blank];
      s_stay_pnb[w] = pnb + (last >= 0 ? s_lp[last] : kLogEps);
    }
    __syncthreads();

    // 3. the extensions' p_nonblank, the LM fused
    for (int j = tid; j < n_ext; j += kThreads) {
      const int w = j / E;
      const int c = s_chars[j - w * E];
      float x = (c == s_last[cur][w] ? s_pb[cur][w] : s_ptot[w])
          + s_lpc[j - w * E];
      if (lm_logp != nullptr) {
        const float l =
            __ldg(lm_logp + static_cast<size_t>(s_lm[cur][w]) * n_char + c);
        x = __fadd_rn(__fadd_rn(x, __fmul_rn(alpha, l)), beta);
      }
      ext_pnb[j] = x;
      keys[W + j] = make_key(x, W + j);
    }
    __syncthreads();

    // 4. merge each stay with the extension that denotes its prefix
    for (int w = warp; w < W; w += kWarps) {
      const uint32_t g1 = s_h1[cur][w], g2 = s_h2[cur][w];
      float best = kLogEps;
      for (int p = 0; p < W; ++p) {
        const uint32_t m1 = s_h1[cur][p] * mult1, m2 = s_h2[cur][p] * mult2;
        for (int e = lane; e < E; e += 32) {
          const uint32_t step = static_cast<uint32_t>(s_chars[e] + 1);
          if (m1 + step == g1 && m2 + step == g2) {
            const int j = p * E + e;
            best = fmaxf(best, ext_pnb[j]);
            keys[W + j] = make_key(kLogEps, W + j);
          }
        }
      }
      for (int o = 16; o > 0; o >>= 1)
        best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
      if (lane == 0) {
        const float pnb = logadd(s_stay_pnb[w], best);
        s_stay_pnb[w] = pnb;
        keys[w] = make_key(logadd(s_stay_pb[w], pnb), w);
      }
    }
    for (int i = W + n_ext + tid; i < npad; i += kThreads) keys[i] = ~0ull;
    __syncthreads();

    // 5. the top W candidates
    bitonic_sort(keys, npad);

    // 6. the winners' state, the backpointers
    const int nxt = cur ^ 1;
    for (int k = tid; k < W; k += kThreads) {
      const int sel = key_index(keys[k]);
      int parent, ch;
      if (sel < W) {
        parent = sel;
        ch = -1;
        s_len[nxt][k] = s_len[cur][parent];
        s_last[nxt][k] = s_last[cur][parent];
        s_pb[nxt][k] = s_stay_pb[parent];
        s_pnb[nxt][k] = s_stay_pnb[parent];
        s_h1[nxt][k] = s_h1[cur][parent];
        s_h2[nxt][k] = s_h2[cur][parent];
        s_lm[nxt][k] = s_lm[cur][parent];
      } else {
        const int j = sel - W;
        parent = j / E;
        ch = s_chars[j - parent * E];
        const uint32_t step = static_cast<uint32_t>(ch + 1);
        const int ctx = s_lm[cur][parent];
        s_len[nxt][k] = s_len[cur][parent] + 1;
        s_last[nxt][k] = ch;
        s_pb[nxt][k] = kLogEps;
        s_pnb[nxt][k] = ext_pnb[j];
        s_h1[nxt][k] = s_h1[cur][parent] * mult1 + step;
        s_h2[nxt][k] = s_h2[cur][parent] * mult2 + step;
        s_lm[nxt][k] = lm_order >= 2 ? (ctx % lm_mod) * n_char + ch : ctx;
      }
      bp_b[static_cast<size_t>(t) * W + k] = parent | ((ch + 1) << 16);
    }
    cur = nxt;
    __syncthreads();
  }

  // the final order of the W beams
  int wpad = 1;
  while (wpad < W) wpad <<= 1;
  for (int w = tid; w < wpad; w += kThreads)
    keys[w] = w < W ? make_key(logadd(s_pb[cur][w], s_pnb[cur][w]), w)
                    : ~0ull;
  int* rows = prefixes + static_cast<size_t>(b) * P * T;
  for (int i = tid; i < P * T; i += kThreads) rows[i] = pad_id;
  __syncthreads();
  bitonic_sort(keys, wpad);

  // each kept path walks its backpointers back
  for (int p = tid; p < P; p += kThreads) {
    const int w = key_index(keys[p]);
    const int n = s_len[cur][w];
    out_len[b * P + p] = n;
    out_score[b * P + p] = logadd(s_pb[cur][w], s_pnb[cur][w]);
    int* row = rows + static_cast<size_t>(p) * T;
    int slot = w, pos = n;
    for (int t = len - 1; t >= 0; --t) {
      const int v = bp_b[static_cast<size_t>(t) * W + slot];
      const int ch = (v >> 16) - 1;
      if (ch >= 0) row[--pos] = ch;
      slot = v & 0xFFFF;
    }
  }
}

}  // namespace

// log_probs [B, T, V] float32 (log-softmax, blank = V-1), lengths [B]
// int32, lm_logp [S, V-1] float32 or null, bp [B, T, W] int32 scratch ->
// prefixes [B, P, T] int32 (pad_id past each length), out_len [B, P] int32,
// out_score [B, P] float32, best first.  E extension characters a frame
// (V-1, or the prune width); lm_mod = (V-1)^(order-2), lm_state0 the LM's
// start context; mult1 and mult2 the hash lanes' multipliers.
extern "C" int asr_ctc_beam(const float* log_probs, const int* lengths,
                            const float* lm_logp, int* bp, int* prefixes,
                            int* out_len, float* out_score, int B, int T,
                            int V, int W, int P, int E, int pad_id,
                            int lm_order, int lm_mod, int lm_state0,
                            float alpha, float beta, unsigned mult1,
                            unsigned mult2, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > kMaxW || V < 2 || V > kMaxV || E < 1 || E > V - 1 ||
      P < 1 || P > W)
    return static_cast<int>(cudaErrorInvalidValue);
  int npad = 1;
  while (npad < W + W * E) npad <<= 1;
  const size_t smem = static_cast<size_t>(npad) * sizeof(uint64_t) +
                      static_cast<size_t>(W) * E * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ctc_beam_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ctc_beam_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      log_probs, lengths, lm_logp, bp, prefixes, out_len, out_score, T, V, W,
      P, E, pad_id, lm_order, lm_mod, lm_state0, alpha, beta, mult1, mult2,
      npad);
  return static_cast<int>(cudaGetLastError());
}
