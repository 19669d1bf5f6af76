// CTC prefix beam search with optional char n-gram LM shallow fusion: the
// whole time loop of a batch's decode in one launch, one CTA per
// utterance (the select design).
//
// The counterpart of asr_study_tpu/ops/beam.py `_make_step` (its gather
// form), `_materialize` and `_decode_single`, which the JAX package runs as
// one XLA scan; the plain twin is ops/beam.py `beam_search_plain`.
//
// What bounds it on the H100: none of the card's rates.  A frame reads V
// floats and does O(W*E) arithmetic, but each frame's selection needs the
// one before, so the time is the latency of a serial chain of frames:
// block barriers, shared-memory round trips, shuffles and the logadds'
// expf and log1pf.  The design keeps each frame's chain short, three block
// barriers a frame:
//
// A. merge (G lanes a stay, a lane per G-th parent): a stay w can absorb only
//    its parent p's extension by the one step that lane 1 of the hash
//    allows, s = h1[w] - h1[p] * mult1 (mod 2^32).  The pair matches iff
//    1 <= s <= V-1, the char s-1 is one of the frame's E extension chars
//    (its slot, the inverse of the frame's char list, is >= 0) and
//    h2[p] * mult2 + s == h2[w]: W*W pair checks a frame.  These are
//    exactly the matches of comparing both lanes with all W*E extensions,
//    hash collisions and the dead placeholders included.  The matched
//    extension's score is recomputed where it is needed (never stored),
//    and it is killed by stamping the frame into its slot of `kill`.
// B. select: the W + W*E candidates have unique 64-bit keys (the score,
//    descending, above the candidate index), so the top W are one definite
//    list.  The worst stay's key bounds it (the W stays are at or below),
//    so every candidate above is dropped.  Each warp takes 32-key chunks,
//    sorts each that keeps a key in registers (bitonic by shuffles, no
//    barrier) and merges it into its running first 32*R keys (R = 1, 2, 4
//    keys a lane); the lists and their lengths go to shared memory.
// C. rank: a list entry's place is its place in its own list plus, in each
//    other list, the number of keys below it (a binary search); an entry
//    placed below W is the winner of that slot.  Its thread gathers the
//    winner into the other state buffer, writes its backpointer, and its
//    stay terms for the next frame from the next frame's row, which was
//    loaded into registers at this frame's start.  The next frame's
//    extension chars are picked in the same phase.
//
// The ranking is jax.lax.top_k's: scores descending, ties to the lower
// candidate index (dead beams and killed extensions tie at LOG_EPS).  The
// extension chars are the frame's top E by (value descending, index
// ascending), each character's rank counted against the others.  Each
// extension's score is (x + alpha*lm) + beta rounded step by step (no FMA:
// torch rounds the product and the sums apart); _logadd as ops/ctc.py does
// it (max, clamp at LOG_EPS, expf of min minus max, log1pf, add), IEEE
// expf and log1pf (no fast math), uint32 hashes that wrap natively.
//
// Frames past an utterance's length are not walked (the reference carries
// the state through them and writes identity backpointers, which the walk
// back passes through unchanged).  Each frame writes its backpointers,
// parent | (char + 1) << 16, to bp [B, T, W].  After the last frame the W
// final scores are sorted and a thread per kept path walks the
// backpointers back, writing the emitted characters at their positions.
//
// The stream form (asr_ctc_beam_stream; asr_study_tpu/ops/beam.py
// `beam_stream_chunk`, the plain twin ops/beam.py `beam_stream_plain`)
// decodes one chunk of a stream: it starts from the beam state a previous
// chunk left ([B, W] lengths, last chars, p_blank, p_nonblank, both hash
// lanes and LM contexts, in slot order) in place of the empty prefix, and
// writes the state back after the chunk's last valid frame.  Nothing is
// sorted: a thread per slot walks its backpointers back to the chunk's
// first frame, counting the characters the chunk emitted and the slot it
// started from, then writes them, so the caller splices each slot's chunk
// onto that start slot's prefix.
//
// The select design's route (ops/beam.py beam_design, SELECT_MAX_WIDTH and
// SELECT_MAX_VOCAB): W <= 128, V <= 64; W*E*4 bytes of dynamic shared
// memory for the kill stamps.  Every other (W, V) goes to the wide design,
// ctc_beam_wide.cu.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kLogEps = -1e30f;
constexpr int kMaxW = 128;
constexpr int kMaxV = 64;
constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kPad = ~0ull;

// The beam state of the stream form, [B, W] each, read before the first
// frame and written after the last; all null in the one-shot form.
struct Carry {
  int* len;
  int* last;
  float* pb;
  float* pnb;
  uint32_t* h1;
  uint32_t* h2;
  int* lm;
  int* emits;               // [B, W] the chars each slot's chunk emitted
  int* start;               // [B, W] the slot each began the chunk in
};

struct Params {
  const float* log_probs;   // [B, T, V]
  const int* lengths;       // [B]
  const float* lm_logp;     // [S, V-1] or null
  int* bp;                  // [B, T, W]
  int* prefixes;            // [B, P, T]
  int* out_len;             // [B, P] (the one-shot form)
  float* out_score;         // [B, P]
  int T, V, W, P, E, pad_id, lm_order, lm_mod, lm_state0;
  float alpha, beta;
  uint32_t mult1, mult2;
  Carry carry;
};

// the beam state, two buffers: length, last char, LM context, p_blank,
// p_nonblank, the hash lanes; and the beam's terms for the frame it enters:
// logadd(p_blank, p_nonblank), and the stay's p_blank and p_nonblank before
// the merge
struct State {
  int len[2][kMaxW], last[2][kMaxW], lm[2][kMaxW];
  float pb[2][kMaxW], pnb[2][kMaxW], ptot[2][kMaxW], spb[2][kMaxW],
      spnb[2][kMaxW];
  uint32_t h1[2][kMaxW], h2[2][kMaxW];
};

// a frame's extension chars (by rank), their log-probs, and each char's
// rank among them (-1: pruned)
struct Chars {
  int chars[kMaxV], slot[kMaxV];
  float lpc[kMaxV];
};

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

__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// An extension's p_nonblank, the LM fused: parent p (buffer cur) by char c
// of log-prob lpc.
__device__ __forceinline__ float ext_score(const Params& a, const State& st,
                                           int cur, int p, int c,
                                           float lpc) {
  float x = (c == st.last[cur][p] ? st.pb[cur][p] : st.ptot[cur][p]) + lpc;
  if (a.lm_logp != nullptr) {
    const float l = __ldg(a.lm_logp +
                          static_cast<size_t>(st.lm[cur][p]) * (a.V - 1) + c);
    x = __fadd_rn(__fadd_rn(x, __fmul_rn(a.alpha, l)), a.beta);
  }
  return x;
}

// The frame's extension chars from its row lp: all V-1, or with prune the
// top E by (value descending, index ascending).
__device__ __forceinline__ void pick_chars(const Params& a, const float* lp,
                                           Chars& ch, int tid,
                                           int n_threads) {
  const int n_char = a.V - 1;
  for (int c = tid; c < n_char; c += n_threads) {
    const float x = lp[c];
    int rank = c;
    if (a.E < n_char) {
      rank = 0;
      for (int d = 0; d < n_char; ++d) {
        const float y = lp[d];
        rank += (y > x) || (y == x && d < c);
      }
    }
    ch.slot[c] = rank < a.E ? rank : -1;
    if (rank < a.E) {
      ch.chars[rank] = c;
      ch.lpc[rank] = x;
    }
  }
}

// The stay terms of beam k (buffer buf) for the frame of row lp.
__device__ __forceinline__ void set_terms(State& st, int buf, int k,
                                          float pb, float pnb, int last,
                                          const float* lp, int blank) {
  const float ptot = logadd(pb, pnb);
  st.pb[buf][k] = pb;
  st.pnb[buf][k] = pnb;
  st.ptot[buf][k] = ptot;
  st.spb[buf][k] = ptot + lp[blank];
  st.spnb[buf][k] = pnb + (last >= 0 ? lp[last] : kLogEps);
}

// Ascending bitonic sort of one key a lane across the warp.
__device__ __forceinline__ uint64_t warp_sort(uint64_t x, int lane) {
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      const uint64_t o = __shfl_xor_sync(kFull, x, j);
      x = (((lane & j) == 0) == ((lane & k) == 0)) ? kmin(x, o) : kmax(x, o);
    }
  }
  return x;
}

// The first 32*R keys of list (ascending, element r*32 + lane in l[r]) and
// the ascending chunk c: the minima of l's last 32 and c reversed make the
// whole bitonic, and a bitonic merge sorts it.
template <int R>
__device__ __forceinline__ void merge_chunk(uint64_t (&l)[R], uint64_t c,
                                            int lane) {
  l[R - 1] = kmin(l[R - 1], __shfl_sync(kFull, c, 31 - lane));
#pragma unroll
  for (int jr = R / 2; jr > 0; jr >>= 1) {
#pragma unroll
    for (int q = 0; q < R / 2; ++q) {
      const int r = (q / jr) * 2 * jr + q % jr;
      const uint64_t lo = kmin(l[r], l[r + jr]), hi = kmax(l[r], l[r + jr]);
      l[r] = lo;
      l[r + jr] = hi;
    }
  }
#pragma unroll
  for (int j = 16; j > 0; j >>= 1) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const uint64_t o = __shfl_xor_sync(kFull, l[r], j);
      l[r] = (lane & j) ? kmax(l[r], o) : kmin(l[r], o);
    }
  }
}

// The number of keys below key in list[0, N), ascending; N a power of two.
template <int N>
__device__ __forceinline__ int count_below(const uint64_t* list,
                                           uint64_t key) {
  int pos = 0;
#pragma unroll
  for (int s = N >> 1; s > 0; s >>= 1)
    if (list[pos + s - 1] < key) pos += s;
  return pos + (list[pos] < key);
}

// Ascending bitonic sort of keys[0, n), n a power of two, by the whole
// block; ends with a barrier.
template <int kThreads>
__device__ void block_sort(uint64_t* keys, int n) {
  for (int k = 2; k <= n; k <<= 1) {
    for (int j = k >> 1; j > 0; j >>= 1) {
      for (int p = threadIdx.x; p < (n >> 1); p += kThreads) {
        const int i = 2 * p - (p & (j - 1));    // bit j of i is clear
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

template <int kWarps, int R>
__global__ void __launch_bounds__(kWarps * 32)
ctc_beam_kernel(const Params a) {
  constexpr int kThreads = kWarps * 32;
  constexpr int kList = 32 * R;
  // a thread (at least) a stay in the merge, a class in the row's load
  static_assert(kThreads >= kMaxW && kThreads >= kMaxV, "CTA too small");
  extern __shared__ __align__(16) unsigned char smem[];
  int* kill = reinterpret_cast<int*>(smem);                   // [W * E]

  __shared__ State st;
  __shared__ Chars s_ch[2];                 // by frame parity
  __shared__ float s_lp[kMaxV];             // the next frame's row
  __shared__ float s_mpnb[kMaxW];           // the stays' merged p_nonblank
  __shared__ uint64_t s_skey[kMaxW];        // the stays' keys
  __shared__ uint64_t s_list[kWarps][kList];
  __shared__ int s_kept[kWarps];            // the keys in each list

  const int b = blockIdx.x, tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int T = a.T, V = a.V, W = a.W, E = a.E;
  const int n_char = V - 1, blank = V - 1;
  const int n_ext = W * E, n_cand = W + n_ext;
  const int n_chunks = (n_cand + 31) >> 5;
  // the merge's lanes a stay: a power of two, G * W <= kThreads, G <= 32
  int G = 32;
  while (G * W > kThreads) G >>= 1;
  const int len = min(max(a.lengths[b], 0), T);
  const float* lp_b = a.log_probs + static_cast<size_t>(b) * T * V;
  int* bp_b = a.bp + static_cast<size_t>(b) * T * W;

  for (int j = tid; j < n_ext; j += kThreads) kill[j] = 0;
  if (len > 0)
    for (int v = tid; v < V; v += kThreads) s_lp[v] = lp_b[v];
  __syncthreads();
  // frame 0's extension chars; the empty prefix and the dead placeholders,
  // or the stream form's carried beams
  const Carry& cy = a.carry;
  const bool carried = cy.len != nullptr;
  pick_chars(a, s_lp, s_ch[0], tid, kThreads);
  for (int w = tid; w < W; w += kThreads) {
    if (carried) {
      const size_t o = static_cast<size_t>(b) * W + w;
      st.len[0][w] = cy.len[o];
      st.last[0][w] = cy.last[o];
      st.h1[0][w] = cy.h1[o];
      st.h2[0][w] = cy.h2[o];
      st.lm[0][w] = cy.lm[o];
      set_terms(st, 0, w, cy.pb[o], cy.pnb[o], cy.last[o], s_lp, blank);
      continue;
    }
    st.len[0][w] = 0;
    st.last[0][w] = -1;
    st.h1[0][w] = w == 0 ? 1u : 0xDEAD0000u + w;
    st.h2[0][w] = w == 0 ? 1u : 0xBEEF0000u + w;
    st.lm[0][w] = a.lm_state0;
    set_terms(st, 0, w, w == 0 ? 0.0f : kLogEps, kLogEps, -1, s_lp, blank);
  }
  int cur = 0;
  __syncthreads();

  for (int t = 0; t < len; ++t) {
    const Chars& ch = s_ch[t & 1];
    const int nxt = cur ^ 1;
    // the next frame's row, off the frame's chain
    float lp_next = 0.0f;
    if (tid < V && t + 1 < len)
      lp_next = __ldg(lp_b + static_cast<size_t>(t + 1) * V + tid);

    // A. merge: G lanes a stay, each over every G-th parent
    {
      const int w = tid / G, sub = tid - w * G;
      float best = kLogEps;
      if (w < W) {
        const uint32_t g1 = st.h1[cur][w], g2 = st.h2[cur][w];
        for (int p = sub; p < W; p += G) {
          const uint32_t s = g1 - st.h1[cur][p] * a.mult1;
          if (s - 1u < static_cast<uint32_t>(n_char)) {
            const int e = ch.slot[s - 1];
            if (e >= 0 && st.h2[cur][p] * a.mult2 + s == g2) {
              best = fmaxf(best, ext_score(a, st, cur, p, s - 1, ch.lpc[e]));
              kill[p * E + e] = t + 1;
            }
          }
        }
      }
      for (int o = G >> 1; o > 0; o >>= 1)
        best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
      if (w < W && sub == 0) {
        const float pnb = logadd(st.spnb[cur][w], best);
        s_mpnb[w] = pnb;
        s_skey[w] = make_key(logadd(st.spb[cur][w], pnb), w);
      }
    }
    __syncthreads();

    // B. each warp's first 32*R keys of its chunks.  The worst stay's key
    // bounds the top W (all W stays are at or below it), so a candidate
    // above it is dropped, and a chunk left empty is neither sorted nor
    // merged.
    {
      uint64_t bound = 0;
      for (int w = lane; w < W; w += 32) bound = kmax(bound, s_skey[w]);
      for (int o = 16; o > 0; o >>= 1)
        bound = kmax(bound, __shfl_xor_sync(kFull, bound, o));
      uint64_t l[R];
#pragma unroll
      for (int r = 0; r < R; ++r) l[r] = kPad;
      bool empty = true;
      for (int c = warp; c < n_chunks; c += kWarps) {
        const int i = c * 32 + lane;
        uint64_t key = kPad;
        if (i < W) {
          key = s_skey[i];
        } else if (i < n_cand) {
          const int j = i - W, p = j / E, e = j - p * E;
          key = make_key(kill[j] == t + 1 ? kLogEps
                         : ext_score(a, st, cur, p, ch.chars[e], ch.lpc[e]),
                         i);
          if (key > bound) key = kPad;
        }
        if (!__any_sync(kFull, key != kPad)) continue;
        key = warp_sort(key, lane);
        if (empty)
          l[0] = key;
        else
          merge_chunk<R>(l, key, lane);
        empty = false;
      }
      int kept = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        s_list[warp][r * 32 + lane] = l[r];
        kept += __popc(__ballot_sync(kFull, l[r] != kPad));
      }
      if (lane == 0) s_kept[warp] = kept;
    }
    if (tid < V) s_lp[tid] = lp_next;
    __syncthreads();

    // C. rank each list's first W keys; each winner's gather, backpointer
    // and next stay terms; the next frame's chars
    for (int idx = tid; idx < kWarps * W; idx += kThreads) {
      const int li = idx / W, q = idx - li * W;
      if (q >= s_kept[li]) continue;
      const uint64_t key = s_list[li][q];
      int k = q;
#pragma unroll
      for (int j = 0; j < kWarps; ++j)
        if (j != li && s_kept[j] > 0) k += count_below<kList>(s_list[j], key);
      if (k >= W) continue;
      const int sel = key_index(key);
      int parent, c, len_k, last_k, lm_k;
      float pb_k, pnb_k;
      uint32_t h1_k, h2_k;
      if (sel < W) {
        parent = sel;
        c = -1;
        len_k = st.len[cur][parent];
        last_k = st.last[cur][parent];
        lm_k = st.lm[cur][parent];
        pb_k = st.spb[cur][parent];
        pnb_k = s_mpnb[parent];
        h1_k = st.h1[cur][parent];
        h2_k = st.h2[cur][parent];
      } else {
        const int j = sel - W;
        parent = j / E;
        const int e = j - parent * E;
        c = ch.chars[e];
        const uint32_t step = static_cast<uint32_t>(c + 1);
        const int ctx = st.lm[cur][parent];
        len_k = st.len[cur][parent] + 1;
        last_k = c;
        lm_k = a.lm_order >= 2 ? (ctx % a.lm_mod) * n_char + c : ctx;
        pb_k = kLogEps;
        pnb_k = ext_score(a, st, cur, parent, c, ch.lpc[e]);
        h1_k = st.h1[cur][parent] * a.mult1 + step;
        h2_k = st.h2[cur][parent] * a.mult2 + step;
      }
      st.len[nxt][k] = len_k;
      st.last[nxt][k] = last_k;
      st.lm[nxt][k] = lm_k;
      st.h1[nxt][k] = h1_k;
      st.h2[nxt][k] = h2_k;
      set_terms(st, nxt, k, pb_k, pnb_k, last_k, s_lp, blank);
      bp_b[static_cast<size_t>(t) * W + k] = parent | ((c + 1) << 16);
    }
    if (t + 1 < len) pick_chars(a, s_lp, s_ch[(t + 1) & 1], tid, kThreads);
    cur = nxt;
    __syncthreads();
  }

  if (carried) {
    // the stream form: the state back in slot order, then a thread a slot
    // walks back to the chunk's first frame twice, to count its chars and
    // find its start slot, then to place the chars
    int* rows = a.prefixes + static_cast<size_t>(b) * W * T;
    for (int i = tid; i < W * T; i += kThreads) rows[i] = a.pad_id;
    for (int w = tid; w < W; w += kThreads) {
      const size_t o = static_cast<size_t>(b) * W + w;
      cy.len[o] = st.len[cur][w];
      cy.last[o] = st.last[cur][w];
      cy.pb[o] = st.pb[cur][w];
      cy.pnb[o] = st.pnb[cur][w];
      cy.h1[o] = st.h1[cur][w];
      cy.h2[o] = st.h2[cur][w];
      cy.lm[o] = st.lm[cur][w];
      a.out_score[o] = st.ptot[cur][w];
    }
    __syncthreads();
    for (int w = tid; w < W; w += kThreads) {
      int slot = w, n = 0;
      for (int t = len - 1; t >= 0; --t) {
        const int v = bp_b[static_cast<size_t>(t) * W + slot];
        n += (v >> 16) != 0;
        slot = v & 0xFFFF;
      }
      const size_t o = static_cast<size_t>(b) * W + w;
      cy.emits[o] = n;
      cy.start[o] = slot;
      int* row = rows + static_cast<size_t>(w) * T;
      slot = w;
      for (int t = len - 1; t >= 0; --t) {
        const int v = bp_b[static_cast<size_t>(t) * W + slot];
        if (v >> 16) row[--n] = (v >> 16) - 1;
        slot = v & 0xFFFF;
      }
    }
    return;
  }

  // the final order of the W beams
  int span = 1;
  while (span < W) span <<= 1;
  uint64_t* keys = &s_list[0][0];
  for (int w = tid; w < span; w += kThreads)
    keys[w] = w < W ? make_key(st.ptot[cur][w], w) : kPad;
  int* rows = a.prefixes + static_cast<size_t>(b) * a.P * T;
  for (int i = tid; i < a.P * T; i += kThreads) rows[i] = a.pad_id;
  __syncthreads();
  block_sort<kThreads>(keys, span);

  // each kept path walks its backpointers back
  for (int p = tid; p < a.P; p += kThreads) {
    const int w = key_index(keys[p]);
    const int n = st.len[cur][w];
    a.out_len[b * a.P + p] = n;
    a.out_score[b * a.P + p] = st.ptot[cur][w];
    int* row = rows + static_cast<size_t>(p) * T;
    int slot = w, pos = n;
    for (int t = len - 1; t >= 0; --t) {
      const int v = bp_b[static_cast<size_t>(t) * W + slot];
      if (v >> 16) row[--pos] = (v >> 16) - 1;
      slot = v & 0xFFFF;
    }
  }
}

template <int kWarps, int R>
cudaError_t launch(const Params& a, int B, cudaStream_t stream) {
  auto kernel = ctc_beam_kernel<kWarps, R>;
  const int smem = a.W * a.E * static_cast<int>(sizeof(int));   // kill
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kernel<<<B, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// The CTA's warps for a beam width: fewer warps, cheaper barriers; more
// warps, shorter lists and more lanes for the ranks
// (`lstm_step_split.py ctc_beam` times the other shapes).
int warps_for(int W) {
  return W <= 8 ? 4 : W <= 64 ? 8 : 16;
}

template <int kWarps>
cudaError_t launch_r(const Params& a, int B, cudaStream_t stream) {
  // the lists keep 32*R >= W keys
  if (a.W <= 32) return launch<kWarps, 1>(a, B, stream);
  if (a.W <= 64) return launch<kWarps, 2>(a, B, stream);
  return launch<kWarps, 4>(a, B, stream);
}

int launch_w(const Params& a, int B, cudaStream_t s) {
  switch (warps_for(a.W)) {
    case 4: return static_cast<int>(launch_r<4>(a, B, s));
    case 8: return static_cast<int>(launch_r<8>(a, B, s));
    default: return static_cast<int>(launch_r<16>(a, B, s));
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
      P < 1 || P > W || T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params a{log_probs, lengths, lm_logp, bp, prefixes, out_len,
                 out_score, T, V, W, P, E, pad_id, lm_order, lm_mod,
                 lm_state0, alpha, beta, mult1, mult2, Carry{}};
  return launch_w(a, B, static_cast<cudaStream_t>(stream));
}

// The stream form: one chunk of B streams.  log_probs [B, T, V] and
// lengths [B] (the chunk's valid frames) as above; the beam state [B, W]
// (len, last, pb, pnb, h1, h2, lm, in slot order) read and written in
// place -> prefixes [B, W, T] (each slot's chars of the chunk, pad_id past
// them), emits [B, W] (their count), start [B, W] (the slot it began the
// chunk in), scores [B, W] (logadd(p_blank, p_nonblank)), unsorted.
extern "C" int asr_ctc_beam_stream(
    const float* log_probs, const int* lengths, const float* lm_logp,
    int* bp, int* len, int* last, float* pb, float* pnb, unsigned* h1,
    unsigned* h2, int* lm, int* prefixes, int* emits, int* start,
    float* scores, int B, int T, int V, int W, int E, int pad_id,
    int lm_order, int lm_mod, float alpha, float beta, unsigned mult1,
    unsigned mult2, void* stream) {
  if (B <= 0) return 0;
  if (W < 1 || W > kMaxW || V < 2 || V > kMaxV || E < 1 || E > V - 1 ||
      T < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const Params a{log_probs, lengths, lm_logp, bp, prefixes, nullptr,
                 scores, T, V, W, W, E, pad_id, lm_order, lm_mod, 0, alpha,
                 beta, mult1, mult2,
                 Carry{len, last, pb, pnb, h1, h2, lm, emits, start}};
  return launch_w(a, B, static_cast<cudaStream_t>(stream));
}
