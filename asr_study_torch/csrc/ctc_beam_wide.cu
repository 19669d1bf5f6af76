// CTC prefix beam search with optional char n-gram LM shallow fusion, the
// wide design: the route of every beam width and vocabulary the select
// design (ctc_beam.cu, W <= 128 and V <= 64) does not take.  The whole time
// loop of a batch's decode in one launch, one CTA of 1024 threads per
// utterance.
//
// The counterpart of asr_study_tpu/ops/beam.py `_make_step` (its gather
// form), `_materialize`, `_decode_single` and `beam_stream_chunk`, which
// have no limit on W or V; the plain twins are ops/beam.py
// `beam_search_plain` and `beam_stream_plain`, and the function computed is
// theirs bit for bit, as the select design's is: the same hash lanes and
// merge, jax.lax.top_k's order (scores descending, ties to the lower
// candidate index), the extension chars as the frame's top E by (value
// descending, index ascending), each extension's score (x + alpha*lm) +
// beta rounded step by step (no FMA), _logadd as ops/ctc.py does it (IEEE
// expf and log1pf), frames past a row's length not walked.
//
// What bounds it: as the select design, no rate of the card but the
// latency of a serial chain of frames.  This design is the simple one that
// takes any size: the beam state, the frame's chars, the kill stamps and
// the candidates' keys live in global-memory scratch sized from W, V and E
// (ops/beam.py `wide_scratch_bytes`; the entry points refuse a smaller
// stride), so W and V are bounded
// only by the card's memory and by the fields below.  A frame:
//
// A. merge (G lanes a stay, G*W <= 1024): a stay w can absorb only its
//    parent p's extension by the step s = h1[w] - h1[p] * mult1 (mod 2^32)
//    that lane 1 allows; the pair matches iff 1 <= s <= V-1, char s-1 is
//    one of the frame's E chars and h2[p] * mult2 + s == h2[w] (W*W pair
//    checks, exactly the matches of comparing both lanes with every
//    extension, collisions and dead placeholders included).  A matched
//    extension is killed by stamping the frame into its slot of `kill`.
//    Each stay's key goes to the candidate list, and the worst of them
//    bounds the top W (all W stays are candidates).
// B. the W*E extensions' keys (the score, descending, above the candidate
//    index: unique 64-bit keys), those below the bound appended to the list
//    (warp-aggregated atomics).
// C. select: the W-th smallest key of the list by a block-wide radix
//    select (8 passes of 8 bits, histograms in shared memory), the W keys
//    up to it compacted and sorted (bitonic, in scratch): slot k of the
//    next frame is the k-th best candidate.
// D. each slot's state gathered into the other state buffer with its stay
//    terms for the next frame; its backpointer parent | (char + 1) << 32
//    (64 bits: W and V-1 below 2^31) written to bp [B, T, W]; the next
//    frame's chars picked.
//
// The stream form (asr_ctc_beam_wide_stream) starts from a carried [B, W]
// state in slot order and writes it back after the chunk's last valid
// frame, unsorted, each slot's chars of the chunk walked back to the slot
// it started from, as ctc_beam.cu's stream form.
//
// Limits, each refused by the wrapper as ValueError with its numbers:
// W*(E+1) < 2^31 (the candidate index in the key's low 32 bits, int
// loops), V - 1 < 2^31, and the scratch that B utterances need.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr float kLogEps = -1e30f;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kPad = ~0ull;
constexpr int kStateFields = 10;

struct Carry {
  int* len;
  int* last;
  float* pb;
  float* pnb;
  uint32_t* h1;
  uint32_t* h2;
  int* lm;
  int* emits;
  int* start;
};

struct Params {
  const float* log_probs;   // [B, T, V]
  const int* lengths;       // [B]
  const float* lm_logp;     // [S, V-1] or null
  long long* bp;            // [B, T, W]
  unsigned char* scratch;   // [B, stride]
  long long stride;         // scratch bytes an utterance
  int* prefixes;            // [B, P, T]
  int* out_len;             // [B, P]
  float* out_score;         // [B, P]
  int T, V, W, P, E, pad_id, lm_order, lm_mod, lm_state0;
  float alpha, beta;
  uint32_t mult1, mult2;
  Carry carry;
};

// An utterance's scratch, carved in this order (8-byte arrays first).
struct Scratch {
  uint64_t* cand;           // [W + W*E] the frame's candidate keys
  uint64_t* win;            // [Wp] the top W, sorted; kPad past W
  int* ibuf;                // [2][5][W]: len, last, lm, h1, h2
  float* fbuf;              // [2][5][W]: pb, pnb, ptot, spb, spnb
  float* mpnb;              // [W] each stay's merged p_nonblank
  int* kill;                // [W*E] the frame (+1) that killed it
  int* chars;               // [2][E] by frame parity
  float* lpc;               // [2][E]
  int* slot;                // [2][V-1] each char's rank (-1: pruned)
};

__host__ __device__ inline int pow2_at_least(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

__host__ __device__ inline long long scratch_bytes(int W, int V, int E) {
  const long long w = W, e = E, n_char = V - 1;
  return 8 * (w + w * e + pow2_at_least(W)) +
         4 * (2 * kStateFields * w + w + w * e + 4 * e + 2 * n_char);
}

__device__ inline Scratch carve(unsigned char* base, int W, int E) {
  const size_t w = W, e = E;
  Scratch s;
  s.cand = reinterpret_cast<uint64_t*>(base);
  s.win = s.cand + w + w * e;
  s.ibuf = reinterpret_cast<int*>(s.win + pow2_at_least(W));
  s.fbuf = reinterpret_cast<float*>(s.ibuf + 2 * 5 * w);
  s.mpnb = s.fbuf + 2 * 5 * w;
  s.kill = reinterpret_cast<int*>(s.mpnb + w);
  s.chars = s.kill + w * e;
  s.lpc = reinterpret_cast<float*>(s.chars + 2 * e);
  s.slot = reinterpret_cast<int*>(s.lpc + 2 * e);
  return s;
}

// The state fields of buffer b: ints len, last, lm, h1, h2; floats pb,
// pnb, ptot (logadd(pb, pnb)), spb and spnb (the stay's terms for the
// frame the beam enters).
struct View {
  int *len, *last, *lm;
  uint32_t *h1, *h2;
  float *pb, *pnb, *ptot, *spb, *spnb;
};

__device__ inline View view(const Scratch& s, int b, int W) {
  int* i = s.ibuf + static_cast<size_t>(b) * 5 * W;
  float* f = s.fbuf + static_cast<size_t>(b) * 5 * W;
  return View{i, i + W, i + 2 * W,
              reinterpret_cast<uint32_t*>(i + 3 * W),
              reinterpret_cast<uint32_t*>(i + 4 * W),
              f, f + W, f + 2 * W, f + 3 * W, f + 4 * W};
}

__device__ __forceinline__ float logadd(float a, float b) {
  const float mx = fmaxf(fmaxf(a, b), kLogEps);
  return mx + log1pf(expf(fminf(a, b) - mx));
}

// Ascending keys order the scores descending, then the candidate index
// ascending.  -0 ranks as +0.
__device__ __forceinline__ uint64_t make_key(float score, int index) {
  uint32_t u = __float_as_uint(score);
  if (u == 0x80000000u) u = 0;
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<uint64_t>(~u) << 32) | static_cast<uint32_t>(index);
}

__device__ __forceinline__ int key_index(uint64_t key) {
  return static_cast<int>(static_cast<uint32_t>(key));
}

// An extension's p_nonblank, the LM fused: parent p by char c of log-prob
// lpc.
__device__ __forceinline__ float ext_score(const Params& a, const View& st,
                                           int p, int c, float lpc) {
  float x = (c == st.last[p] ? st.pb[p] : st.ptot[p]) + lpc;
  if (a.lm_logp != nullptr) {
    const float l = __ldg(a.lm_logp +
                          static_cast<size_t>(st.lm[p]) * (a.V - 1) + c);
    x = __fadd_rn(__fadd_rn(x, __fmul_rn(a.alpha, l)), a.beta);
  }
  return x;
}

// The frame's extension chars from its row lp (parity q): all V-1, or the
// top E by (value descending, index ascending).
__device__ void pick_chars(const Params& a, const float* lp,
                           const Scratch& s, int q) {
  const int n_char = a.V - 1;
  int* chars = s.chars + static_cast<size_t>(q) * a.E;
  float* lpc = s.lpc + static_cast<size_t>(q) * a.E;
  int* slot = s.slot + static_cast<size_t>(q) * n_char;
  for (int c = threadIdx.x; c < n_char; c += kThreads) {
    const float x = __ldg(lp + c);
    int rank = c;
    if (a.E < n_char) {
      rank = 0;
      for (int d = 0; d < n_char; ++d) {
        const float y = __ldg(lp + d);
        rank += (y > x) || (y == x && d < c);
      }
    }
    slot[c] = rank < a.E ? rank : -1;
    if (rank < a.E) {
      chars[rank] = c;
      lpc[rank] = x;
    }
  }
}

// Beam k's p_blank and p_nonblank and its stay terms for the row lp (null
// for a row of no frames: no terms).
__device__ __forceinline__ void set_terms(const View& st, int k, float pb,
                                          float pnb, int last,
                                          const float* lp, int blank) {
  const float ptot = logadd(pb, pnb);
  st.pb[k] = pb;
  st.pnb[k] = pnb;
  st.ptot[k] = ptot;
  if (lp == nullptr) return;
  st.spb[k] = ptot + __ldg(lp + blank);
  st.spnb[k] = pnb + (last >= 0 ? __ldg(lp + last) : kLogEps);
}

// Appends `key` where `keep`, warp-aggregated, to list[*count ...].  Every
// lane of the warp calls it.
__device__ __forceinline__ void append(bool keep, uint64_t key,
                                       uint64_t* list, int* count,
                                       int lane) {
  const unsigned mask = __ballot_sync(kFull, keep);
  if (mask == 0) return;
  int base = 0;
  if (lane == 0) base = atomicAdd(count, __popc(mask));
  base = __shfl_sync(kFull, base, 0);
  if (keep) list[base + __popc(mask & ((1u << lane) - 1u))] = key;
}

// Ascending bitonic sort of keys[0, n), n a power of two, by the whole
// block; ends with a barrier.
__device__ void block_sort(uint64_t* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += kThreads) {
        const int i = 2 * p - (p & (j - 1));
        const int l = i + j;
        const uint64_t x = keys[i], y = keys[l];
        if ((x > y) == ((i & k) == 0)) {
          keys[i] = y;
          keys[l] = x;
        }
      }
      __syncthreads();
    }
  }
}

// The need-th smallest (1-based) of the m unique keys in list, by radix
// select over 8-bit digits from the top.  Block-wide; ends with a barrier.
__device__ uint64_t radix_select(const uint64_t* list, int m, int need,
                                 int* hist, int* s_pick) {
  const int tid = threadIdx.x, lane = tid & 31;
  uint64_t prefix = 0;
  for (int shift = 56; shift >= 0; shift -= 8) {
    const uint64_t high = shift == 56 ? 0 : (~0ull << (shift + 8));
    if (tid < 256) hist[tid] = 0;
    __syncthreads();
    for (int base = 0; base < m; base += kThreads) {
      const int i = base + tid;
      int bin = 256;
      if (i < m) {
        const uint64_t key = list[i];
        if ((key & high) == prefix) bin = static_cast<int>((key >> shift) &
                                                           255);
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin < 256 && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], __popc(peers));
    }
    __syncthreads();
    if (tid < 32) {
      // lane l owns bins 8l .. 8l+7
      int c[8], sum = 0;
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        c[q] = hist[8 * lane + q];
        sum += c[q];
      }
      int incl = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += y;
      }
      int acc = incl - sum;
      if (acc < need && need <= incl) {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (acc + c[q] >= need) {
            s_pick[0] = 8 * lane + q;
            s_pick[1] = need - acc;
            break;
          }
          acc += c[q];
        }
      }
    }
    __syncthreads();
    prefix |= static_cast<uint64_t>(s_pick[0]) << shift;
    need = s_pick[1];
    __syncthreads();
  }
  return prefix;
}

__global__ void __launch_bounds__(kThreads, 1)
ctc_beam_wide_kernel(const Params a) {
  __shared__ int s_hist[256];
  __shared__ int s_pick[2];
  __shared__ int s_count, s_win;
  __shared__ unsigned long long s_bound;

  const int b = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int T = a.T, V = a.V, W = a.W, E = a.E;
  const int n_char = V - 1, blank = V - 1;
  const int n_ext = W * E;
  const int wp = pow2_at_least(W);
  // the merge's lanes a stay: a power of two, G * W <= kThreads, G <= 32
  int G = 32;
  while (G > 1 && static_cast<long long>(G) * W > kThreads) G >>= 1;
  const int len = min(max(a.lengths[b], 0), T);
  const float* lp_b = a.log_probs + static_cast<size_t>(b) * T * V;
  long long* bp_b = a.bp + static_cast<size_t>(b) * T * W;
  const Scratch s = carve(a.scratch + static_cast<size_t>(b) * a.stride, W,
                          E);

  for (int j = tid; j < n_ext; j += kThreads) s.kill[j] = 0;
  // frame 0's chars and the starting beams: the empty prefix and the dead
  // placeholders, or the stream form's carried state
  const Carry& cy = a.carry;
  const bool carried = cy.len != nullptr;
  const float* lp0 = len > 0 ? lp_b : nullptr;
  if (len > 0) pick_chars(a, lp_b, s, 0);
  {
    const View st = view(s, 0, W);
    for (int w = tid; w < W; w += kThreads) {
      if (carried) {
        const size_t o = static_cast<size_t>(b) * W + w;
        st.len[w] = cy.len[o];
        st.last[w] = cy.last[o];
        st.h1[w] = cy.h1[o];
        st.h2[w] = cy.h2[o];
        st.lm[w] = cy.lm[o];
        set_terms(st, w, cy.pb[o], cy.pnb[o], cy.last[o], lp0, blank);
        continue;
      }
      st.len[w] = 0;
      st.last[w] = -1;
      st.h1[w] = w == 0 ? 1u : 0xDEAD0000u + w;
      st.h2[w] = w == 0 ? 1u : 0xBEEF0000u + w;
      st.lm[w] = a.lm_state0;
      set_terms(st, w, w == 0 ? 0.0f : kLogEps, kLogEps, -1, lp0, blank);
    }
  }
  if (tid == 0) {
    s_count = W;
    s_win = 0;
    s_bound = 0;
  }
  int cur = 0;
  __syncthreads();

  for (int t = 0; t < len; ++t) {
    const View st = view(s, cur, W), nx = view(s, cur ^ 1, W);
    const int q = t & 1;
    const int* chars = s.chars + static_cast<size_t>(q) * E;
    const float* lpc = s.lpc + static_cast<size_t>(q) * E;
    const int* slot = s.slot + static_cast<size_t>(q) * n_char;

    // A. merge: G lanes a stay, each over every G-th parent; the stays'
    // keys and their worst
    for (int base = 0; base < W * G; base += kThreads) {
      const int idx = base + tid, w = idx / G, sub = idx - w * G;
      float best = kLogEps;
      if (w < W) {
        const uint32_t g1 = st.h1[w], g2 = st.h2[w];
        for (int p = sub; p < W; p += G) {
          const uint32_t step = g1 - st.h1[p] * a.mult1;
          if (step - 1u < static_cast<uint32_t>(n_char)) {
            const int e = slot[step - 1];
            if (e >= 0 && st.h2[p] * a.mult2 + step == g2) {
              best = fmaxf(best, ext_score(a, st, p, step - 1, lpc[e]));
              s.kill[static_cast<size_t>(p) * E + e] = t + 1;
            }
          }
        }
      }
      for (int o = G >> 1; o > 0; o >>= 1)
        best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
      if (w < W && sub == 0) {
        const float pnb = logadd(st.spnb[w], best);
        const uint64_t key = make_key(logadd(st.spb[w], pnb), w);
        s.mpnb[w] = pnb;
        s.cand[w] = key;
        atomicMax(&s_bound, static_cast<unsigned long long>(key));
      }
    }
    __syncthreads();

    // B. the extensions' keys below the bound, appended after the stays'
    const uint64_t bound = s_bound;
    for (int base = 0; base < n_ext; base += kThreads) {
      const int j = base + tid;
      uint64_t key = kPad;
      if (j < n_ext) {
        const int p = j / E, e = j - p * E;
        key = make_key(s.kill[j] == t + 1 ? kLogEps
                       : ext_score(a, st, p, chars[e], lpc[e]), W + j);
      }
      append(key < bound, key, s.cand, &s_count, lane);
    }
    __syncthreads();

    // C. the top W: radix select of the W-th key, the W keys up to it
    // compacted and sorted
    const int m = s_count;
    const uint64_t thr = m > W ? radix_select(s.cand, m, W, s_hist, s_pick)
                               : kPad;
    for (int base = 0; base < m; base += kThreads) {
      const int i = base + tid;
      const uint64_t key = i < m ? s.cand[i] : kPad;
      append(i < m && key <= thr, key, s.win, &s_win, lane);
    }
    for (int i = W + tid; i < wp; i += kThreads) s.win[i] = kPad;
    __syncthreads();
    block_sort(s.win, wp);

    // D. each slot's winner gathered, its backpointer and next stay
    // terms; the next frame's chars
    const float* lp_next = lp_b + static_cast<size_t>(min(t + 1, len - 1)) *
                                      V;
    for (int k = tid; k < W; k += kThreads) {
      const int sel = key_index(s.win[k]);
      int parent, c, len_k, last_k, lm_k;
      float pb_k, pnb_k;
      uint32_t h1_k, h2_k;
      if (sel < W) {
        parent = sel;
        c = -1;
        len_k = st.len[parent];
        last_k = st.last[parent];
        lm_k = st.lm[parent];
        pb_k = st.spb[parent];
        pnb_k = s.mpnb[parent];
        h1_k = st.h1[parent];
        h2_k = st.h2[parent];
      } else {
        const int j = sel - W;
        parent = j / E;
        const int e = j - parent * E;
        c = chars[e];
        const uint32_t step = static_cast<uint32_t>(c + 1);
        const int ctx = st.lm[parent];
        len_k = st.len[parent] + 1;
        last_k = c;
        lm_k = a.lm_order >= 2 ? (ctx % a.lm_mod) * n_char + c : ctx;
        pb_k = kLogEps;
        pnb_k = ext_score(a, st, parent, c, lpc[e]);
        h1_k = st.h1[parent] * a.mult1 + step;
        h2_k = st.h2[parent] * a.mult2 + step;
      }
      nx.len[k] = len_k;
      nx.last[k] = last_k;
      nx.lm[k] = lm_k;
      nx.h1[k] = h1_k;
      nx.h2[k] = h2_k;
      set_terms(nx, k, pb_k, pnb_k, last_k, lp_next, blank);
      bp_b[static_cast<size_t>(t) * W + k] =
          static_cast<long long>(parent) |
          (static_cast<long long>(c + 1) << 32);
    }
    if (t + 1 < len) pick_chars(a, lp_next, s, q ^ 1);
    if (tid == 0) {
      s_count = W;
      s_win = 0;
      s_bound = 0;
    }
    cur ^= 1;
    __syncthreads();
  }

  const View st = view(s, cur, W);
  if (carried) {
    // the stream form: the state back in slot order; a thread a slot walks
    // back to the chunk's first frame to count its chars and find its
    // start slot, then again to place the chars
    int* rows = a.prefixes + static_cast<size_t>(b) * W * T;
    for (size_t i = tid; i < static_cast<size_t>(W) * T; i += kThreads)
      rows[i] = a.pad_id;
    for (int w = tid; w < W; w += kThreads) {
      const size_t o = static_cast<size_t>(b) * W + w;
      cy.len[o] = st.len[w];
      cy.last[o] = st.last[w];
      cy.pb[o] = st.pb[w];
      cy.pnb[o] = st.pnb[w];
      cy.h1[o] = st.h1[w];
      cy.h2[o] = st.h2[w];
      cy.lm[o] = st.lm[w];
      a.out_score[o] = st.ptot[w];
    }
    __syncthreads();
    for (int w = tid; w < W; w += kThreads) {
      int sl = w, n = 0;
      for (int t = len - 1; t >= 0; --t) {
        const long long v = bp_b[static_cast<size_t>(t) * W + sl];
        n += (v >> 32) != 0;
        sl = static_cast<int>(v & 0xFFFFFFFFll);
      }
      const size_t o = static_cast<size_t>(b) * W + w;
      cy.emits[o] = n;
      cy.start[o] = sl;
      int* row = rows + static_cast<size_t>(w) * T;
      sl = w;
      for (int t = len - 1; t >= 0; --t) {
        const long long v = bp_b[static_cast<size_t>(t) * W + sl];
        if (v >> 32) row[--n] = static_cast<int>(v >> 32) - 1;
        sl = static_cast<int>(v & 0xFFFFFFFFll);
      }
    }
    return;
  }

  // the final order of the W beams, then a thread a kept path walks back
  for (int w = tid; w < wp; w += kThreads)
    s.win[w] = w < W ? make_key(st.ptot[w], w) : kPad;
  int* rows = a.prefixes + static_cast<size_t>(b) * a.P * T;
  for (size_t i = tid; i < static_cast<size_t>(a.P) * T; i += kThreads)
    rows[i] = a.pad_id;
  __syncthreads();
  block_sort(s.win, wp);
  for (int p = tid; p < a.P; p += kThreads) {
    const int w = key_index(s.win[p]);
    const int n = st.len[w];
    a.out_len[static_cast<size_t>(b) * a.P + p] = n;
    a.out_score[static_cast<size_t>(b) * a.P + p] = st.ptot[w];
    int* row = rows + static_cast<size_t>(p) * T;
    int sl = w, pos = n;
    for (int t = len - 1; t >= 0; --t) {
      const long long v = bp_b[static_cast<size_t>(t) * W + sl];
      if (v >> 32) row[--pos] = static_cast<int>(v >> 32) - 1;
      sl = static_cast<int>(v & 0xFFFFFFFFll);
    }
  }
}

bool valid(int B, int T, int V, int W, int E, long long stride) {
  return B > 0 && T >= 0 && W >= 1 && V >= 2 && E >= 1 && E <= V - 1 &&
         static_cast<long long>(W) * (E + 1) < (1ll << 31) &&
         stride >= scratch_bytes(W, V, E) && stride % 8 == 0;
}

int launch(const Params& a, int B, void* stream) {
  ctc_beam_wide_kernel<<<B, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// log_probs [B, T, V] float32 (log-softmax, blank = V-1), lengths [B]
// int32, lm_logp [S, V-1] float32 or null, bp [B, T, W] int64 and scratch
// [B, stride] bytes -> prefixes [B, P, T] int32 (pad_id past each length),
// out_len [B, P] int32, out_score [B, P] float32, best first.  The other
// arguments as asr_ctc_beam's.
extern "C" int asr_ctc_beam_wide(
    const float* log_probs, const int* lengths, const float* lm_logp,
    long long* bp, unsigned char* scratch, long long stride, int* prefixes,
    int* out_len, float* out_score, int B, int T, int V, int W, int P, int E,
    int pad_id, int lm_order, int lm_mod, int lm_state0, float alpha,
    float beta, unsigned mult1, unsigned mult2, void* stream) {
  if (B <= 0) return 0;
  if (!valid(B, T, V, W, E, stride) || P < 1 || P > W)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params a{log_probs, lengths, lm_logp, bp, scratch, stride, prefixes,
                 out_len, out_score, T, V, W, P, E, pad_id, lm_order, lm_mod,
                 lm_state0, alpha, beta, mult1, mult2, Carry{}};
  return launch(a, B, stream);
}

// The stream form: one chunk of B streams, the beam state [B, W] (len,
// last, pb, pnb, h1, h2, lm, slot order) read and written in place ->
// prefixes [B, W, T], emits [B, W], start [B, W], scores [B, W], unsorted,
// as asr_ctc_beam_stream.
extern "C" int asr_ctc_beam_wide_stream(
    const float* log_probs, const int* lengths, const float* lm_logp,
    long long* bp, unsigned char* scratch, long long stride, int* len,
    int* last, float* pb, float* pnb, unsigned* h1, unsigned* h2, int* lm,
    int* prefixes, int* emits, int* start, float* scores, int B, int T,
    int V, int W, int E, int pad_id, int lm_order, int lm_mod, float alpha,
    float beta, unsigned mult1, unsigned mult2, void* stream) {
  if (B <= 0) return 0;
  if (!valid(B, T, V, W, E, stride))
    return static_cast<int>(cudaErrorInvalidValue);
  const Params a{log_probs, lengths, lm_logp, bp, scratch, stride, prefixes,
                 nullptr, scores, T, V, W, W, E, pad_id, lm_order, lm_mod, 0,
                 alpha, beta, mult1, mult2,
                 Carry{len, last, pb, pnb, h1, h2, lm, emits, start}};
  return launch(a, B, stream);
}
