// The layer-norm LSTM recurrence of one layer, backward pass, over one or
// two directions in one launch: the cotangent scans that give dpre, the
// gate pre-activation gradients, and dcn, the gradient of the cell
// LayerNorm's output, with the recurrent weights resident in a thread-block
// cluster for the whole sequence and every LayerNorm reduction taken across
// the cluster through distributed shared memory.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_ln_lstm.py
// `_bibwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_ln_lstm.py `_ln_bwd_kernel` (one direction) with
// ndir = 1.  Row maths: ops/pallas_ln_lstm.py `_ln_row_bwd`, with the
// held-frame rule of its masked branch: there dh_prev takes the whole dh
// and dc_prev = dc_next.  With ndir = 1 only lane 0 (the forward direction)
// runs and the _b pointers are unused.
//
// Inputs: the forward's arguments (xpn [T, B, 4H], the mask [T, B], wh
// [H, 4H], gh [4H], gc and bc [H] of each direction), the forward's h and
// raw c of each direction [T, B, H], and the cotangents of the h outputs
// dh_f / dh_b [T, B, H].  Outputs dpre [T, B, 4H] and dcn [T, B, H] of each
// direction, zero on masked frames.  The parameter gradients (wh, the
// LayerNorm gains and bias) are one batched pass over these sequences
// outside the kernel.  The forward direction's cotangent chain runs
// t = T-1 .. 0, the reversed direction's t = 0 .. T-1; h_prev and c_prev are
// the saved sequences at t-1 (forward) or t+1 (reversed), zero past the
// ends.
//
// What bounds it on the H100: the chain is serial in time, and each step
// has two [R, H] x [H, 4H]-sized products through wh (the recomputed h side
// of the gates and the recurrent cotangent dhp @ wh^T) and, between them,
// the backward of five LayerNorms over H.  The design is bilstm_bwd.cu's:
// one cluster of C CTAs per (direction, group of R batch rows), CTA k owning
// the U units [kU, kU + U) and their four gate columns, its slice of wh held
// in the registers of its threads (for the first product) and in shared
// memory as ws [H][4U + 1] (for the second, whose thread j reads row j).
// Warp r runs the cell of batch row r, lane u unit kU + u, and keeps that
// unit's carried cotangents (dc_next and the held dh) in registers.  A step:
//
//   a. hp[R, 4U] = h[t_prev] @ slice from the saved h, which needs no
//      exchange (h, c, dh_out, xpn and the mask of the next step are fetched
//      by cp.async while this one runs);
//   b. the local (mean, M2) of each gate block of hp and of c[t] over the
//      CTA's units, to every CTA in one round;
//   c. the statistics combined (Chan et al., as the forward);
//      the gates and chat recomputed; dh = dh_out[t] + hold + the C partial
//      sums of the recurrent cotangent received last step, added in rank
//      order; dcn = dh * o * (1 - tc^2); the local sums of dcn * gc and
//      dcn * gc * chat, to every CTA (cluster barrier);
//   d. dc = dc_next + the cell LayerNorm's backward; dpre and dcn stored,
//      zero on masked frames; dq = dpre * gh and the local sums of dq and
//      dq * xhat per gate block, to every CTA (cluster barrier);
//   e. dhp = rstd * (dq - mean(dq) - xhat * mean(dq * xhat)) into shared
//      memory;
//   f. partial[R, H] = dhp[R, own columns] @ ws^T, thread j taking unit j;
//      each unit's part sent to the CTA that owns it (its slot for this
//      sender, alternating on s & 1).
//
// Steps a and b do not depend on the cotangent chain, so they run one step
// ahead: the loop's iteration s runs c to f of step s - 1 and then a and b
// of step s, whose statistics reach every CTA under the same cluster
// barrier as the partials.  A step so has three cluster barriers (after b
// and f, after c, after d).
//
// The bfloat16-weight form (asr_ln_lstm_bwd_bf16) is the same kernel on the
// weight type W = __nv_bfloat16 (ops/pallas_ln_lstm.py `_ln_row_bwd` with a
// bfloat16 wh), as zoneout_lstm_bwd.cu's: the slice is held as bfloat16 in
// the registers (64 pairs a thread) and in ws ([H][4U + 2] bfloat16, whose
// odd row stride in words keeps step f's pair reads free of bank
// conflicts).  The saved h_prev is rounded to bfloat16 in shared memory by
// the thread whose cp.async fetched it, after its copy lands and before the
// barrier that opens the iteration, so step a (the product of the step one
// ahead of the chain, whose row that slot holds) recomputes the forward's
// hp from the forward's operands, and the statistics of b are those of the
// rounded product.  That slot is this CTA's own and step a is its only
// reader (the LN backward takes h_prev nowhere but in the product; c_prev,
// for df, is a buffer of its own), so no unrounded copy is kept.  dhp is
// rounded as step e writes it (`_mm(dhp, wht)`), while dpre and dcn are
// written unrounded.  Products are float32 fmaf on the converted values in
// the float32 form's order.
//
// Every sum that crosses CTAs runs in a fixed order (the partials in rank
// order, the statistics by an 8-lane shuffle butterfly over the senders), so
// the backward, and the train steps, repeat bit for bit.  The launcher
// refuses a grid whose clusters are not all resident at once
// (cudaOccupancyMaxActiveClusters);
// ops/ln_lstm.py `ln_geometry` picks C, U and R and sends the widths whose
// slice does not fit (H=300, H=512) to ln_lstm_stream_bwd.cu.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 128;      // k rows of the weights a thread holds
constexpr int kMaxCluster = 8;   // the portable cluster size
constexpr float kEps = 1e-5f;

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Offsets (in floats) of the dynamic shared memory of one CTA; mirrored by
// ops/ln_lstm.py `ln_cluster_smem` for the float32 form.  ws holds `half`
// (bfloat16) weights in the bfloat16 form, in rows of gcs elements.
struct BwdLayout {
  int hp, gcs, ks, hs, ws, hpb, xs, ct, cp, dho, mk, red, dhp, recv, sta,
      stb, stq, total;
  __host__ __device__ BwdLayout(int H, int U, int R, int C, bool half) {
    const int gc = 4 * U;
    hp = round4(H);
    gcs = half ? gc + 2 : gc + 1;    // an odd number of words a row
    ks = (H + kSlice - 1) / kSlice;  // slices of the H reduction
    hs = ks * kSlice;                // h rows, zero-padded to whole slices
    ws = 0;                          // [hp][gcs]   wh[:, own columns]
    hpb = ws + round4(half ? hp * gcs / 2 : hp * gcs);
    //                                  [2][R][hs]  saved h at t_prev
    xs = hpb + 2 * R * hs;           // [2][R][gc]  xpn of own columns
    ct = xs + 2 * R * gc;            // [2][R][U]   c at t, own units
    cp = ct + round4(2 * R * U);     // [2][R][U]   c at t_prev
    dho = cp + round4(2 * R * U);    // [2][R][U]   dh_out at t
    mk = dho + round4(2 * R * U);    // [2][R]      mask
    red = mk + round4(2 * R);        // [ks][R][gc] partial gate products
    dhp = red + ks * R * gc;         // [R][gc]     dhp of own columns
    recv = dhp + R * gc;             // [2][C][R][U] received partials
    sta = recv + round4(2 * C * R * U);  // [2][C][R][12] (mean, M2) of
                                     //   hp's gate blocks and of c
    stb = sta + 2 * C * R * 12;      // [2][C][R][2] sums of dcn*gc and
                                     //   dcn*gc*chat
    stq = stb + 4 * C * R;           // [2][C][R][8] sums of dq and dq*xhat
    total = stq + 16 * C * R;
  }
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the sum over each 8-lane group of a warp, by a butterfly in a fixed
// order: x + y == y + x bit for bit, so every lane ends with the same bits
__device__ __forceinline__ float group8_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 4);
  v += __shfl_xor_sync(0xffffffffu, v, 2);
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

// Chan et al.'s combine of NQ statistics over H units from the C senders'
// (mean_k, M2_k) pairs at st[k * stride + 2q]: mean = sum n_k mean_k / H,
// M2 = sum (M2_k + n_k (mean_k - mean)^2), rstd = 1 / sqrt(M2 / H + eps).
// Lane l reads sender snd = l & 7, which holds n_snd units (0 past C).
template <int NQ>
__device__ __forceinline__ void combine(const float* st, int stride, int snd,
                                        float n_snd, float inv_h,
                                        float* mean, float* rstd) {
  const float* src = st + snd * stride;
  float mk[NQ], m2k[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    mk[q] = n_snd > 0.f ? src[2 * q] : 0.f;
    m2k[q] = n_snd > 0.f ? src[2 * q + 1] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < NQ; ++q) mean[q] = group8_sum(n_snd * mk[q]) * inv_h;
#pragma unroll
  for (int q = 0; q < NQ; ++q) {
    const float d = mk[q] - mean[q];
    rstd[q] = rsqrtf(group8_sum(fmaf(n_snd * d, d, m2k[q])) * inv_h + kEps);
  }
}

// the means over H of NQ sums from the C senders' parts at
// st[k * stride + q], lane l reading sender l & 7 (none past C)
template <int NQ>
__device__ __forceinline__ void means(const float* st, int stride, int snd,
                                      float n_snd, float inv_h, float* out) {
  const float* src = st + snd * stride;
  float part[NQ];
#pragma unroll
  for (int q = 0; q < NQ; ++q) part[q] = n_snd > 0.f ? src[q] : 0.f;
#pragma unroll
  for (int q = 0; q < NQ; ++q) out[q] = group8_sum(part[q]) * inv_h;
}

// A thread's kSlice weights of one column, in registers: float32, or
// bfloat16 pairs for the bfloat16-weight form.  quad(kk) gives rows kk ..
// kk + 3 as float32.
template <typename W>
struct Slice {
  float w[kSlice];
  __device__ __forceinline__ void set2(int kk, W a, W b) {
    w[kk] = a;
    w[kk + 1] = b;
  }
  __device__ __forceinline__ float4 quad(int kk) const {
    return make_float4(w[kk], w[kk + 1], w[kk + 2], w[kk + 3]);
  }
};

template <>
struct Slice<__nv_bfloat16> {
  __nv_bfloat162 w[kSlice / 2];
  __device__ __forceinline__ void set2(int kk, __nv_bfloat16 a,
                                       __nv_bfloat16 b) {
    w[kk / 2] = __halves2bfloat162(a, b);
  }
  __device__ __forceinline__ float4 quad(int kk) const {
    const float2 lo = __bfloat1622float2(w[kk / 2]);
    const float2 hi = __bfloat1622float2(w[kk / 2 + 1]);
    return make_float4(lo.x, lo.y, hi.x, hi.y);
  }
};

// x as it enters a product with weights of type W: itself, or rounded to
// the nearest bfloat16
template <typename W>
__device__ __forceinline__ float as_operand(float x) {
  if constexpr (std::is_same_v<W, __nv_bfloat16>)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

// four consecutive weights of a ws row as float32 (k even)
__device__ __forceinline__ float4 row4(const float* w) {
  return make_float4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ float4 row4(const __nv_bfloat16* w) {
  const float2 lo =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w));
  const float2 hi =
      __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(w + 2));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

// 4-byte asynchronous copy global -> shared; zero-fills when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <typename W, int R>
__global__ void __launch_bounds__(kThreads, 1)
ln_lstm_bwd_kernel(const float* __restrict__ xpn_f,
                   const float* __restrict__ xpn_b,
                   const float* __restrict__ mask,
                   const W* __restrict__ wh_f,
                   const W* __restrict__ wh_b,
                   const float* __restrict__ gh_f,
                   const float* __restrict__ gh_b,
                   const float* __restrict__ gc_f,
                   const float* __restrict__ gc_b,
                   const float* __restrict__ bc_f,
                   const float* __restrict__ bc_b,
                   const float* __restrict__ h_f,
                   const float* __restrict__ c_f,
                   const float* __restrict__ h_b,
                   const float* __restrict__ c_b,
                   const float* __restrict__ dh_f,
                   const float* __restrict__ dh_b,
                   float* __restrict__ dpre_f, float* __restrict__ dcn_f,
                   float* __restrict__ dpre_b, float* __restrict__ dcn_b,
                   int T, int B, int H, int U) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr bool kRounded = std::is_same_v<W, __nv_bfloat16>;
  const BwdLayout L(H, U, R, C, kRounded);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  W* ws = reinterpret_cast<W*>(smem + L.ws);
  float* hpb = smem + L.hpb;
  float* xs = smem + L.xs;
  float* cts = smem + L.ct;
  float* cps = smem + L.cp;
  float* dho = smem + L.dho;
  float* mk = smem + L.mk;
  float* red = smem + L.red;
  float* dhp = smem + L.dhp;
  float* recv = smem + L.recv;
  const int G = 4 * H, GC = 4 * U, HP = L.hp, GCS = L.gcs, HS = L.hs;
  const int RU = R * U;

  const bool rev = blockIdx.z == 1;
  const float* __restrict__ xpn = rev ? xpn_b : xpn_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
  const float* __restrict__ gh = rev ? gh_b : gh_f;
  const float* __restrict__ gc = rev ? gc_b : gc_f;
  const float* __restrict__ bc = rev ? bc_b : bc_f;
  const float* __restrict__ h = rev ? h_b : h_f;
  const float* __restrict__ c = rev ? c_b : c_f;
  const float* __restrict__ dh_out = rev ? dh_b : dh_f;
  float* __restrict__ dpre = rev ? dpre_b : dpre_f;
  float* __restrict__ dcn_out = rev ? dcn_b : dcn_f;
  const int b0 = blockIdx.y * R;
  const int u0 = rank * U;
  const int step_dir = rev ? 1 : -1;       // t_prev = t + step_dir
  const int tid = threadIdx.x;

  // the resident slice twice: in shared memory, ws[k][q*U + u] =
  // wh[k][q*H + u0 + u], for step f's row reads; in registers, thread
  // (col, ks) holding w[kk] = ws[ks*kSlice + kk][col], for step a
  for (int i = tid; i < HP * GC; i += kThreads) {
    const int k = i / GC, cl = i - k * GC;
    const int q = cl / U, un = u0 + cl - q * U;
    ws[k * GCS + cl] =
        (k < H && un < H) ? wh[static_cast<size_t>(k) * G + q * H + un]
                          : W{};
  }
  const int col = tid % GC, ks = tid / GC;
  const bool active = ks < L.ks;
  Slice<W> w;
  {
    const int q = col / U, un = u0 + col - q * U;
    auto at = [&](int kk) {
      const int k = ks * kSlice + kk;
      return (active && k < H && un < H)
                 ? wh[static_cast<size_t>(k) * G + q * H + un]
                 : W{};
    };
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 2) w.set2(kk, at(kk), at(kk + 1));
  }
  for (int i = tid; i < R * GC; i += kThreads) dhp[i] = 0.f;
  for (int i = tid; i < 2 * C * RU; i += kThreads) recv[i] = 0.f;

  // the cell: warp r takes batch row b0 + r, lane u unit u0 + u; that
  // unit's gains and carried cotangents stay in registers
  const int row = tid >> 5, lane = tid & 31, unit = u0 + lane;
  const bool cell = row < R;                   // uniform over the warp
  const bool own = cell && lane < U && unit < H;
  const int ru = row * U + lane;               // (row, unit) in [R][U]
  const float inv_n = 1.f / static_cast<float>(min(U, H - u0));
  const float inv_h = 1.f / static_cast<float>(H);
  // the combines over senders: lane l reads sender l & 7
  const int snd = lane & 7;
  const float n_snd =
      snd < C ? static_cast<float>(min(U, H - snd * U)) : 0.f;
  float ghq[4], gcu = 0.f, bcu = 0.f, hold = 0.f, dc_next = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) ghq[q] = own ? gh[q * H + unit] : 0.f;
  if (own) {
    gcu = gc[unit];
    bcu = bc[unit];
  }

  // what the statistics of step s read (h at t_prev and c at t) and what
  // its cotangent chain reads (xpn, dh_out, c at t_prev and the mask), each
  // into slot s & 1
  auto fetch_stats = [&](int s) {
    const int t = rev ? s : T - 1 - s;
    const int tp = t + step_dir;
    const bool has_prev = tp >= 0 && tp < T;
    const int slot = s & 1;
    for (int i = tid; i < R * HS; i += kThreads) {
      const int r = i / HS, k = i - r * HS;
      const int b = b0 + r;
      const bool ok = has_prev && b < B && k < H;
      cp_async4(hpb + slot * R * HS + i,
                ok ? h + (static_cast<size_t>(tp) * B + b) * H + k : h, ok);
    }
    for (int i = tid; i < RU; i += kThreads) {
      const int r = i / U, un = u0 + i - r * U;
      const int b = b0 + r;
      const bool ok = b < B && un < H;
      cp_async4(cts + slot * RU + i,
                ok ? c + (static_cast<size_t>(t) * B + b) * H + un : c, ok);
    }
  };
  auto fetch_chain = [&](int s) {
    const int t = rev ? s : T - 1 - s;
    const int tp = t + step_dir;
    const bool has_prev = tp >= 0 && tp < T;
    const int slot = s & 1;
    for (int i = tid; i < R * GC; i += kThreads) {
      const int r = i / GC, cl = i - r * GC;
      const int q = cl / U, un = u0 + cl - q * U;
      const int b = b0 + r;
      const bool ok = b < B && un < H;
      cp_async4(xs + slot * R * GC + i,
                ok ? xpn + (static_cast<size_t>(t) * B + b) * G + q * H + un
                   : xpn,
                ok);
    }
    for (int i = tid; i < RU; i += kThreads) {
      const int r = i / U, un = u0 + i - r * U;
      const int b = b0 + r;
      const bool ok = b < B && un < H;
      cp_async4(dho + slot * RU + i,
                ok ? dh_out + (static_cast<size_t>(t) * B + b) * H + un
                   : dh_out,
                ok);
      const bool okp = ok && has_prev;
      cp_async4(cps + slot * RU + i,
                okp ? c + (static_cast<size_t>(tp) * B + b) * H + un : c,
                okp);
    }
    for (int r = tid; r < R; r += kThreads) {
      const bool ok = b0 + r < B;
      cp_async4(mk + slot * R + r,
                ok ? mask + static_cast<size_t>(t) * B + b0 + r : mask, ok);
    }
  };

  fetch_stats(0);
  cp_async_commit();
  // every CTA of the cluster is running and initialised before any peer
  // writes into its shared memory
  cluster.sync();

  // Iteration it runs the cotangent chain of step it - 1 (c to f), then
  // the statistics of step it (a, b), which do not depend on the chain:
  // they reach every CTA with the partials, under one cluster barrier.
  // The copies of each iteration's group land by the next.
  float v[4], c_t = 0.f;
  for (int it = 0; it <= T; ++it) {
    if (it < T) fetch_chain(it);
    if (it + 1 < T) fetch_stats(it + 1);
    cp_async_commit();
    cp_async_wait_prev();
    if (kRounded && it < T) {
      // the h_prev of step it, which step a below multiplies, as the
      // forward's product took it: each element rounded by the thread
      // whose copy brought it (fetch_stats' mapping)
      float* hr = hpb + (it & 1) * R * HS;
      for (int i = tid; i < R * HS; i += kThreads)
        hr[i] = as_operand<W>(hr[i]);
    }
    __syncthreads();

    if (it > 0) {
      const int s = it - 1, cur = s & 1;
      const int t = rev ? s : T - 1 - s;
      float* sta = smem + L.sta + cur * C * R * 12;
      float* stb = smem + L.stb + cur * C * R * 2;
      float* stq = smem + L.stq + cur * C * R * 8;

      // c. the forward recomputed; dh and dcn; the sums of the cell
      // LayerNorm's backward, to every CTA
      float xhat[4], rs[4], ig = 0.f, fg = 0.f, gg = 0.f, og = 0.f;
      float chat = 0.f, rs_c = 0.f, tc = 0.f, dh = 0.f, y = 0.f;
      if (cell) {
        const float* x = xs + cur * R * GC + row * GC;
        float mu[5], rsv[5], pre[4];
        combine<5>(sta + row * 12, R * 12, snd, n_snd, inv_h, mu, rsv);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          xhat[q] = own ? (v[q] - mu[q]) * rsv[q] : 0.f;
          rs[q] = rsv[q];
          pre[q] = own ? fmaf(xhat[q], ghq[q], x[q * U + lane]) : 0.f;
        }
        ig = sigmoidf(pre[0]);
        fg = sigmoidf(pre[1]);
        gg = tanhf(pre[2]);
        og = sigmoidf(pre[3]);
        rs_c = rsv[4];
        chat = own ? (c_t - mu[4]) * rs_c : 0.f;
        tc = tanhf(fmaf(chat, gcu, bcu));
        if (own) {
          dh = dho[cur * RU + ru] + hold;
          const float* got = recv + (cur ^ 1) * C * RU + ru;
#pragma unroll
          for (int p = 0; p < kMaxCluster; ++p)
            if (p < C) dh += got[p * RU];
        }
        y = dh * og * (1.f - tc * tc) * gcu;
        const float s1 = warp_sum(y), s2 = warp_sum(y * chat);
        if (lane < C)
          *reinterpret_cast<float2*>(cluster.map_shared_rank(
              stb + (rank * R + row) * 2, lane)) = make_float2(s1, s2);
      }
      cluster.sync();

      // d. dc, dpre and dcn; the carried cotangents; the sums of each gate
      // block's LayerNorm backward, to every CTA
      float dq[4];
      if (cell) {
        float m12[2];
        means<2>(stb + row * 2, R * 2, snd, n_snd, inv_h, m12);
        const float dc = dc_next + rs_c * (y - m12[0] - chat * m12[1]);
        const float c_prev = own ? cps[cur * RU + ru] : 0.f;
        const bool m = mk[cur * R + row] > 0.f;
        const float p[4] = {m ? dc * gg * ig * (1.f - ig) : 0.f,
                            m ? dc * c_prev * fg * (1.f - fg) : 0.f,
                            m ? dc * ig * (1.f - gg * gg) : 0.f,
                            m ? dh * tc * og * (1.f - og) : 0.f};
        const int b = b0 + row;
        if (own && b < B) {
          const size_t o = static_cast<size_t>(t) * B + b;
          float* out = dpre + o * G + unit;
#pragma unroll
          for (int q = 0; q < 4; ++q) out[q * H] = p[q];
          dcn_out[o * H + unit] = m ? dh * og * (1.f - tc * tc) : 0.f;
        }
        // held frames pass h and c (and their cotangents) straight through
        hold = m ? 0.f : dh;
        if (m) dc_next = dc * fg;
        float st[8];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          dq[q] = own ? p[q] * ghq[q] : 0.f;
          st[2 * q] = warp_sum(dq[q]);
          st[2 * q + 1] = warp_sum(dq[q] * xhat[q]);
        }
        if (lane < C) {
          float4* dst = reinterpret_cast<float4*>(
              cluster.map_shared_rank(stq + (rank * R + row) * 8, lane));
          dst[0] = make_float4(st[0], st[1], st[2], st[3]);
          dst[1] = make_float4(st[4], st[5], st[6], st[7]);
        }
      }
      cluster.sync();

      // e. dhp of own columns, into shared memory for step f
      if (cell) {
        float mq[8];
        means<8>(stq + row * 8, R * 8, snd, n_snd, inv_h, mq);
        if (lane < U) {
          // step f's operands (rounded in the bfloat16 form)
#pragma unroll
          for (int q = 0; q < 4; ++q)
            dhp[row * GC + q * U + lane] = as_operand<W>(
                own ? rs[q] * (dq[q] - mq[2 * q] - xhat[q] * mq[2 * q + 1])
                    : 0.f);
        }
      }
      __syncthreads();

      // f. dhp[R, own columns] @ ws^T, each unit's part to its owner
      for (int j = tid; j < H; j += kThreads) {
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
        const W* wrow = ws + j * GCS;
#pragma unroll 2
        for (int k = 0; k < GC; k += 4) {
          const float4 wv = row4(wrow + k);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 dv =
                *reinterpret_cast<const float4*>(dhp + r * GC + k);
            acc[r] = fmaf(dv.x, wv.x, acc[r]);
            acc[r] = fmaf(dv.y, wv.y, acc[r]);
            acc[r] = fmaf(dv.z, wv.z, acc[r]);
            acc[r] = fmaf(dv.w, wv.w, acc[r]);
          }
        }
        const int owner = j / U;
        float* dst = cluster.map_shared_rank(recv + (cur * C + rank) * RU,
                                             owner);
#pragma unroll
        for (int r = 0; r < R; ++r) dst[r * U + j - owner * U] = acc[r];
      }
    }

    if (it < T) {
      const int cur = it & 1;
      float* sta = smem + L.sta + cur * C * R * 12;

      // a. the h side of the gates, recomputed from the saved h_prev, the
      // weights from registers
      if (active) {
        const float* hk = hpb + cur * R * HS + ks * kSlice;
        float acc[R];
#pragma unroll
        for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kSlice; kk += 4) {
          const float4 wv = w.quad(kk);
#pragma unroll
          for (int r = 0; r < R; ++r) {
            const float4 hv =
                *reinterpret_cast<const float4*>(hk + r * HS + kk);
            acc[r] = fmaf(hv.x, wv.x, acc[r]);
            acc[r] = fmaf(hv.y, wv.y, acc[r]);
            acc[r] = fmaf(hv.z, wv.z, acc[r]);
            acc[r] = fmaf(hv.w, wv.w, acc[r]);
          }
        }
#pragma unroll
        for (int r = 0; r < R; ++r) red[(ks * R + r) * GC + col] = acc[r];
      }
      __syncthreads();

      // b. the local statistics of hp's gate blocks and of c[t], to every CTA
      if (cell) {
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          v[q] = 0.f;
          if (own)
            for (int p = 0; p < L.ks; ++p)
              v[q] += red[(p * R + row) * GC + q * U + lane];
        }
        if (own) c_t = cts[cur * RU + ru];
        float st[10];
#pragma unroll
        for (int q = 0; q < 5; ++q) {
          const float x = q < 4 ? v[q] : c_t;
          const float mean = warp_sum(x) * inv_n;
          const float d = own ? x - mean : 0.f;
          st[2 * q] = mean;
          st[2 * q + 1] = warp_sum(d * d);
        }
        if (lane < C) {
          float4* dst = reinterpret_cast<float4*>(
              cluster.map_shared_rank(sta + (rank * R + row) * 12, lane));
          dst[0] = make_float4(st[0], st[1], st[2], st[3]);
          dst[1] = make_float4(st[4], st[5], st[6], st[7]);
          dst[2] = make_float4(st[8], st[9], 0.f, 0.f);
        }
      }
    }
    cluster.sync();
  }
}

// The launch configuration of the cluster grid -> its dynamic shared memory
// and how many of its clusters the card holds at once.
template <typename W, int R>
cudaError_t configure(int B, int H, int ndir, int C, int U,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int* max_clusters) {
  const size_t smem =
      sizeof(float) *
      static_cast<size_t>(
          BwdLayout(H, U, R, C, std::is_same_v<W, __nv_bfloat16>).total);
  cudaError_t err = cudaFuncSetAttribute(
      ln_lstm_bwd_kernel<W, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(C, (B + R - 1) / R, ndir);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaOccupancyMaxActiveClusters(max_clusters,
                                        ln_lstm_bwd_kernel<W, R>, cfg);
}

// p: the float32 inputs in the kernel's order without wh (xpn_f, xpn_b,
// mask, then gh_f .. dh_b)
template <typename W, int R>
cudaError_t launch(const float* const* p, const W* wh_f, const W* wh_b,
                   float* const* out, int T, int B, int H, int ndir, int C,
                   int U, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  cudaError_t err = configure<W, R>(B, H, ndir, C, U, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  // all clusters in one wave, or no launch
  if (fit < static_cast<int>(cfg.gridDim.y * cfg.gridDim.z))
    return cudaErrorCooperativeLaunchTooLarge;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, ln_lstm_bwd_kernel<W, R>, p[0], p[1], p[2],
                           wh_f, wh_b, p[3], p[4], p[5], p[6], p[7], p[8],
                           p[9], p[10], p[11], p[12], p[13], p[14], out[0],
                           out[1], out[2], out[3], T, B, H, U);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// a warp a batch row and a lane a unit: U <= 32 follows from the slice fit
bool valid_geometry(int H, int ndir, int C, int U) {
  return ndir >= 1 && ndir <= 2 && C >= 1 && C <= kMaxCluster && U >= 1 &&
         U <= 32 && 4 * U * ((H + kSlice - 1) / kSlice) <= kThreads &&
         C * U >= H && (C - 1) * U < H;
}

// f(std::integral_constant<int, R>) for the row counts the kernel is built
// for (at most one a warp)
template <typename F>
cudaError_t by_rows(int R, F&& f) {
  switch (R) {
    case 1: return f(std::integral_constant<int, 1>{});
    case 2: return f(std::integral_constant<int, 2>{});
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    default: return cudaErrorInvalidValue;
  }
}

template <typename W>
int launch_form(const float* xpn_f, const float* xpn_b, const float* mask,
                const W* wh_f, const W* wh_b, const float* gh_f,
                const float* gh_b, const float* gc_f, const float* gc_b,
                const float* bc_f, const float* bc_b, const float* h_f,
                const float* c_f, const float* h_b, const float* c_b,
                const float* dh_f, const float* dh_b, float* dpre_f,
                float* dcn_f, float* dpre_b, float* dcn_b, int T, int B,
                int H, int ndir, int C, int U, int R, void* stream) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  const float* const in[] = {xpn_f, xpn_b, mask, gh_f, gh_b, gc_f, gc_b,
                             bc_f,  bc_b,  h_f,  c_f,  h_b,  c_b,  dh_f,
                             dh_b};
  float* const out[] = {dpre_f, dcn_f, dpre_b, dcn_b};
  return static_cast<int>(by_rows(R, [&](auto rows) {
    return launch<W, decltype(rows)::value>(
        in, wh_f, wh_b, out, T, B, H, ndir, C, U,
        static_cast<cudaStream_t>(stream));
  }));
}

}  // namespace

// Launch the backward over ndir directions: clusters of C CTAs of U units
// each, R (1, 2, 4 or 8) batch rows a cluster.
extern "C" int asr_ln_lstm_bwd(
    const float* xpn_f, const float* xpn_b, const float* mask,
    const float* wh_f, const float* wh_b, const float* gh_f,
    const float* gh_b, const float* gc_f, const float* gc_b,
    const float* bc_f, const float* bc_b, const float* h_f, const float* c_f,
    const float* h_b, const float* c_b, const float* dh_f, const float* dh_b,
    float* dpre_f, float* dcn_f, float* dpre_b, float* dcn_b, int T, int B,
    int H, int ndir, int C, int U, int R, void* stream) {
  return launch_form<float>(xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f,
                            gc_b, bc_f, bc_b, h_f, c_f, h_b, c_b, dh_f, dh_b,
                            dpre_f, dcn_f, dpre_b, dcn_b, T, B, H, ndir, C, U,
                            R, stream);
}

// The bfloat16-weight form: asr_ln_lstm_bwd's arguments with wh_f / wh_b
// bfloat16 [H, 4H].
extern "C" int asr_ln_lstm_bwd_bf16(
    const float* xpn_f, const float* xpn_b, const float* mask,
    const __nv_bfloat16* wh_f, const __nv_bfloat16* wh_b, const float* gh_f,
    const float* gh_b, const float* gc_f, const float* gc_b,
    const float* bc_f, const float* bc_b, const float* h_f, const float* c_f,
    const float* h_b, const float* c_b, const float* dh_f, const float* dh_b,
    float* dpre_f, float* dcn_f, float* dpre_b, float* dcn_b, int T, int B,
    int H, int ndir, int C, int U, int R, void* stream) {
  return launch_form<__nv_bfloat16>(
      xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f, bc_b,
      h_f, c_f, h_b, c_b, dh_f, dh_b, dpre_f, dcn_f, dpre_b, dcn_b, T, B, H,
      ndir, C, U, R, stream);
}

// The backward's dynamic shared memory per CTA and the clusters the card
// holds at once for that launch, without launching.
extern "C" int asr_ln_lstm_bwd_info(int B, int H, int ndir, int C, int U,
                                    int R, int* smem_bytes,
                                    int* max_clusters) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = by_rows(R, [&](auto rows) {
    return configure<float, decltype(rows)::value>(B, H, ndir, C, U, &cfg,
                                                   attr, max_clusters);
  });
  if (err == cudaSuccess) *smem_bytes = static_cast<int>(cfg.dynamicSmemBytes);
  return static_cast<int>(err);
}
