// The layer-norm LSTM recurrence of one layer, forward pass, over one or two
// directions in one launch, with the recurrent weights resident in a
// thread-block cluster for the whole sequence and the LayerNorm statistics
// reduced across the cluster through distributed shared memory.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_ln_lstm.py
// `_bifwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_ln_lstm.py `_ln_fwd_kernel` (one direction) with
// ndir = 1.  Cell maths: ops/pallas_ln_lstm.py `_ln_cell_fwd_math`.
//
// Inputs are the streamed xpn_f / xpn_b [T, B, 4H] (LN of the input
// projections per gate block, with b and ln_h's bias folded in, computed
// outside), the frame mask [T, B], the recurrent weights wh_f / wh_b
// [H, 4H] (gate order i, f, g, o), the ln_h gains gh [4H] and the ln_c gain
// and bias gc, bc [H] of each direction.  Outputs h and c of each direction
// [T, B, H] in forward time order; c is the raw cell state (before its
// LayerNorm), which the backward reads.  Lane 1 (the reverse direction)
// walks time backward.  Both lanes start from zero state, and a frame whose
// mask is 0 keeps the previous h and c.  With ndir = 1 only lane 0 runs and
// the _b pointers are unused.  LayerNorm statistics are over all H units,
// eps 1e-5.
//
// What bounds it on the H100: the recurrence is serial in time, and a step
// is a [R, H] x [H, 4H] product whose weights (1 MB at H=256) do not fit in
// one SM, followed by five LayerNorms over H (the four gate blocks of
// h_prev @ wh, then c) that each need every unit of a row.  The weights are
// read from device memory once, as in bilstm_fwd.cu: one cluster of C CTAs
// per (direction, group of R batch rows), grid (C, ceil(B/R), ndir); CTA k
// owns the U units [kU, kU + U) with their four gate columns and holds
// wh[:, those columns] in the registers of its 256 threads (128 rows of one
// column a thread).  So a step costs the FMAs of one CTA's slice and three
// rounds of exchange through distributed shared memory, each closed by a
// cluster barrier: the h-side statistics, the c statistics, and h.
//
// Warp r of a CTA runs the cell of batch row r (R <= 8 warps), lane u its
// unit kU + u (U <= 32), and keeps that unit's h and c in registers.  A step:
//
//   1. hp[R, 4U] = h_prev[R, H] @ slice, kept apart from xpn; the row
//      slices' sums added in a fixed order;
//   2. per (row, gate block), the CTA's local mean and M2 (sum of squared
//      deviations from that mean) over its n_k units, by two warp
//      reductions; lanes 0..C-1 write the pair into slot k of CTA lane's
//      statistics buffer (cluster.map_shared_rank); cluster barrier;
//   3. every CTA combines the C pairs (Chan et al.): mean = sum n_k mean_k
//      / H, M2 = sum M2_k + sum n_k (mean_k - mean)^2, rstd = 1 / sqrt(M2 /
//      H + eps), lane l of the warp taking sender l & 7 and the sums over
//      senders by an 8-lane shuffle butterfly; pre = xpn + xhat * gh; the
//      gates; the
//      new c; its local (mean, M2) per row, exchanged the same way; cluster
//      barrier;
//   4. combine; h = o * tanh(chat * gc + bc), held on masked frames; h and
//      c stored; h pushed into every CTA's h_prev buffer for the next step
//      (alternating on s & 1); cluster barrier.
//
// Not a one-pass sum of x and x^2: it cancels when the mean is large against
// the spread, and this recurrence amplifies every rounding difference
// (ROADMAP C2).  Every sum runs in a fixed order, so all CTAs of a cluster
// hold the same statistics and a launch repeats bit for bit.
//
// The launcher checks with cudaOccupancyMaxActiveClusters that every
// cluster of the grid is resident at once and refuses the launch otherwise.
// ops/ln_lstm.py `ln_geometry` picks C, U and R, and sends the widths whose
// slice does not fit (H=300, H=512) to ln_lstm_stream_fwd.cu.

#include <cooperative_groups.h>
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
// ops/ln_lstm.py `ln_cluster_smem`.
struct FwdLayout {
  int ks, hs, hbuf, xs, mk, red, sth, stc, total;
  __host__ __device__ FwdLayout(int H, int U, int R, int C) {
    const int gc = 4 * U;
    ks = (H + kSlice - 1) / kSlice;  // slices of the H reduction
    hs = ks * kSlice;             // h rows, zero-padded to whole slices
    hbuf = 0;                     // [2][R][hs]  h_prev, alternating
    xs = hbuf + 2 * R * hs;       // [2][R][gc]  xpn of own columns
    mk = xs + 2 * R * gc;         // [2][R]      mask
    red = mk + round4(2 * R);     // [ks][R][gc] partial products
    sth = red + ks * R * gc;      // [2][C][R][8] (mean, M2) of hp's gate
                                  //              blocks, by sender
    stc = sth + 2 * C * R * 8;    // [2][C][R][2] (mean, M2) of c, by sender
    total = stc + 4 * C * R;
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

template <int R>
__global__ void __launch_bounds__(kThreads, 1)
ln_lstm_fwd_kernel(const float* __restrict__ xpn_f,
                   const float* __restrict__ xpn_b,
                   const float* __restrict__ mask,
                   const float* __restrict__ wh_f,
                   const float* __restrict__ wh_b,
                   const float* __restrict__ gh_f,
                   const float* __restrict__ gh_b,
                   const float* __restrict__ gc_f,
                   const float* __restrict__ gc_b,
                   const float* __restrict__ bc_f,
                   const float* __restrict__ bc_b, float* __restrict__ h_f,
                   float* __restrict__ c_f, float* __restrict__ h_b,
                   float* __restrict__ c_b, int T, int B, int H, int U) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const FwdLayout L(H, U, R, C);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hbuf = smem + L.hbuf;
  float* xs = smem + L.xs;
  float* mk = smem + L.mk;
  float* red = smem + L.red;
  const int G = 4 * H, GC = 4 * U, HS = L.hs;

  const bool rev = blockIdx.z == 1;
  const float* __restrict__ xpn = rev ? xpn_b : xpn_f;
  const float* __restrict__ wh = rev ? wh_b : wh_f;
  const float* __restrict__ gh = rev ? gh_b : gh_f;
  const float* __restrict__ gc = rev ? gc_b : gc_f;
  const float* __restrict__ bc = rev ? bc_b : bc_f;
  float* __restrict__ h_out = rev ? h_b : h_f;
  float* __restrict__ c_out = rev ? c_b : c_f;
  const int b0 = blockIdx.y * R;
  const int u0 = rank * U;
  const int tid = threadIdx.x;

  // the resident slice, in registers: thread (col, ks) holds
  // w[kk] = wh[ks*kSlice + kk][q*H + u0 + u] for col = q*U + u, zero past H
  const int col = tid % GC, ks = tid / GC;
  const bool active = ks < L.ks;
  float w[kSlice];
  {
    const int q = col / U, unit = u0 + col - q * U;
#pragma unroll
    for (int kk = 0; kk < kSlice; ++kk) {
      const int k = ks * kSlice + kk;
      w[kk] = (active && k < H && unit < H)
                  ? wh[static_cast<size_t>(k) * G + q * H + unit]
                  : 0.f;
    }
  }

  // the cell: warp r takes batch row b0 + r, lane u unit u0 + u; that
  // unit's gains and state stay in registers
  const int row = tid >> 5, lane = tid & 31, unit = u0 + lane;
  const bool cell = row < R;                   // uniform over the warp
  const bool own = cell && lane < U && unit < H;
  const float inv_n = 1.f / static_cast<float>(min(U, H - u0));
  const float inv_h = 1.f / static_cast<float>(H);
  // the statistics' combine: lane l reads sender l & 7
  const int snd = lane & 7;
  const float n_snd =
      snd < C ? static_cast<float>(min(U, H - snd * U)) : 0.f;
  float ghq[4], gcu = 0.f, bcu = 0.f, c_state = 0.f, h_state = 0.f;
#pragma unroll
  for (int q = 0; q < 4; ++q) ghq[q] = own ? gh[q * H + unit] : 0.f;
  if (own) {
    gcu = gc[unit];
    bcu = bc[unit];
  }
  for (int i = tid; i < 2 * R * HS; i += kThreads) hbuf[i] = 0.f;

  // xpn of own columns and the mask of step s, into slot s & 1
  auto prefetch = [&](int s) {
    const int t = rev ? T - 1 - s : s;
    float* xd = xs + (s & 1) * R * GC;
    for (int i = tid; i < R * GC; i += kThreads) {
      const int r = i / GC, c = i - r * GC;
      const int q = c / U, un = u0 + c - q * U;
      const int b = b0 + r;
      const bool ok = b < B && un < H;
      cp_async4(xd + i,
                ok ? xpn + (static_cast<size_t>(t) * B + b) * G + q * H + un
                   : xpn,
                ok);
    }
    for (int r = tid; r < R; r += kThreads) {
      const bool ok = b0 + r < B;
      cp_async4(mk + (s & 1) * R + r,
                ok ? mask + static_cast<size_t>(t) * B + b0 + r : mask, ok);
    }
    cp_async_commit();
  };

  prefetch(0);
  // every CTA of the cluster is running and initialised before any peer
  // writes into its shared memory
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    const int cur = s & 1;
    const int t = rev ? T - 1 - s : s;
    if (s + 1 < T)
      prefetch(s + 1);
    else
      cp_async_commit();
    float* sth = smem + L.sth + cur * C * R * 8;
    float* stc = smem + L.stc + cur * C * R * 2;

    // 1. h_prev @ w, one column and one slice of the reduction a thread,
    // the weights from registers and h broadcast from shared memory
    if (active) {
      const float* hk = hbuf + cur * R * HS + ks * kSlice;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 4) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv =
              *reinterpret_cast<const float4*>(hk + r * HS + kk);
          acc[r] = fmaf(hv.x, w[kk], acc[r]);
          acc[r] = fmaf(hv.y, w[kk + 1], acc[r]);
          acc[r] = fmaf(hv.z, w[kk + 2], acc[r]);
          acc[r] = fmaf(hv.w, w[kk + 3], acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) red[(ks * R + r) * GC + col] = acc[r];
    }
    cp_async_wait_prev();
    __syncthreads();

    // 2. the local statistics of each gate block of hp, to every CTA
    float v[4];
    if (cell) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        v[q] = 0.f;
        if (own)
          for (int p = 0; p < L.ks; ++p)
            v[q] += red[(p * R + row) * GC + q * U + lane];
      }
      float st[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float mean = warp_sum(v[q]) * inv_n;
        const float d = own ? v[q] - mean : 0.f;
        st[2 * q] = mean;
        st[2 * q + 1] = warp_sum(d * d);
      }
      if (lane < C) {
        float4* dst = reinterpret_cast<float4*>(
            cluster.map_shared_rank(sth + (rank * R + row) * 8, lane));
        dst[0] = make_float4(st[0], st[1], st[2], st[3]);
        dst[1] = make_float4(st[4], st[5], st[6], st[7]);
      }
    }
    cluster.sync();

    // 3. the gates and the new c; the local statistics of c, to every CTA
    float cn = 0.f, og = 0.f;
    if (cell) {
      const float* x = xs + cur * R * GC + row * GC;
      float mu[4], rs[4], pre[4];
      combine<4>(sth + row * 8, R * 8, snd, n_snd, inv_h, mu, rs);
#pragma unroll
      for (int q = 0; q < 4; ++q)
        pre[q] = own ? fmaf((v[q] - mu[q]) * rs[q], ghq[q], x[q * U + lane])
                     : 0.f;
      const float ig = sigmoidf(pre[0]);
      const float fg = sigmoidf(pre[1]);
      const float gg = tanhf(pre[2]);
      og = sigmoidf(pre[3]);
      cn = own ? fg * c_state + ig * gg : 0.f;
      const float mean = warp_sum(cn) * inv_n;
      const float d = own ? cn - mean : 0.f;
      const float m2 = warp_sum(d * d);
      if (lane < C)
        *reinterpret_cast<float2*>(cluster.map_shared_rank(
            stc + (rank * R + row) * 2, lane)) = make_float2(mean, m2);
    }
    cluster.sync();

    // 4. h from the normalised c, held on masked frames; h to every CTA's
    // next buffer
    if (cell) {
      float mu_c, rs_c;
      combine<1>(stc + row * 2, R * 2, snd, n_snd, inv_h, &mu_c, &rs_c);
      float hn = og * tanhf(fmaf((cn - mu_c) * rs_c, gcu, bcu));
      if (!(mk[cur * R + row] > 0.f)) {
        cn = c_state;
        hn = h_state;
      }
      c_state = cn;
      h_state = hn;
      if (own) {
        const int b = b0 + row;
        if (b < B) {
          const size_t o = (static_cast<size_t>(t) * B + b) * H + unit;
          h_out[o] = hn;
          c_out[o] = cn;
        }
        float* hn_buf = hbuf + (cur ^ 1) * R * HS + row * HS + unit;
        for (int p = 0; p < C; ++p) *cluster.map_shared_rank(hn_buf, p) = hn;
      }
    }
    cluster.sync();
  }
}

// The launch configuration of the cluster grid -> its dynamic shared memory
// and how many of its clusters the card holds at once.
template <int R>
cudaError_t configure(int B, int H, int ndir, int C, int U,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                      int* max_clusters) {
  const size_t smem =
      sizeof(float) * static_cast<size_t>(FwdLayout(H, U, R, C).total);
  cudaError_t err = cudaFuncSetAttribute(
      ln_lstm_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  return cudaOccupancyMaxActiveClusters(max_clusters, ln_lstm_fwd_kernel<R>,
                                        cfg);
}

template <int R>
cudaError_t launch(const float* xpn_f, const float* xpn_b, const float* mask,
                   const float* wh_f, const float* wh_b, const float* gh_f,
                   const float* gh_b, const float* gc_f, const float* gc_b,
                   const float* bc_f, const float* bc_b, float* h_f,
                   float* c_f, float* h_b, float* c_b, int T, int B, int H,
                   int ndir, int C, int U, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  cudaError_t err = configure<R>(B, H, ndir, C, U, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  // all clusters in one wave, or no launch
  if (fit < static_cast<int>(cfg.gridDim.y * cfg.gridDim.z))
    return cudaErrorCooperativeLaunchTooLarge;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, ln_lstm_fwd_kernel<R>, xpn_f, xpn_b, mask,
                           wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f, bc_b,
                           h_f, c_f, h_b, c_b, T, B, H, U);
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

}  // namespace

// Launch the forward over ndir directions: clusters of C CTAs of U units
// each, R (1, 2, 4 or 8) batch rows a cluster.
extern "C" int asr_ln_lstm_fwd(const float* xpn_f, const float* xpn_b,
                               const float* mask, const float* wh_f,
                               const float* wh_b, const float* gh_f,
                               const float* gh_b, const float* gc_f,
                               const float* gc_b, const float* bc_f,
                               const float* bc_b, float* h_f, float* c_f,
                               float* h_b, float* c_b, int T, int B, int H,
                               int ndir, int C, int U, int R, void* stream) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_rows(R, [&](auto rows) {
    return launch<decltype(rows)::value>(
        xpn_f, xpn_b, mask, wh_f, wh_b, gh_f, gh_b, gc_f, gc_b, bc_f, bc_b,
        h_f, c_f, h_b, c_b, T, B, H, ndir, C, U,
        static_cast<cudaStream_t>(stream));
  }));
}

// The forward's dynamic shared memory per CTA and the clusters the card
// holds at once for that launch, without launching.
extern "C" int asr_ln_lstm_fwd_info(int B, int H, int ndir, int C, int U,
                                    int R, int* smem_bytes,
                                    int* max_clusters) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = by_rows(R, [&](auto rows) {
    return configure<decltype(rows)::value>(B, H, ndir, C, U, &cfg, attr,
                                            max_clusters);
  });
  if (err == cudaSuccess) *smem_bytes = static_cast<int>(cfg.dynamicSmemBytes);
  return static_cast<int>(err);
}
