// The zoneout-LSTM recurrence of one layer, forward pass, over one or two
// directions in one launch, with the recurrent weights resident in a
// thread-block cluster for the whole sequence.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_zoneout_lstm.py
// `_bifwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_zoneout_lstm.py `_fwd_kernel` (one direction)
// with ndir = 1.  Cell maths: ops/pallas_zoneout_lstm.py `_zo_cell_math`.
// zh and zc are the zoneout mix weights, the weight of the new state: {0, 1}
// samples in train mode, the constant 1 - rate in eval mode.  After the
// LSTM update (gate order i, f, g, o, the bias folded into xp)
//
//   h = zh * h_new + (1 - zh) * h_prev,   c = zc * c_new + (1 - zc) * c_prev
//
// and then a frame whose mask is 0 keeps h_prev and c_prev.  The mixed h and
// c are stored and carried (the backward recomputes c_new from them).
//
// Inputs: the bias-folded projections xp_f / xp_b [T, B, 4H], the mask
// [T, B], each direction's zh and zc [T, B, H] and wh [H, 4H].  Outputs h
// and c of each direction [T, B, H], all in forward time order: lane 1 (the
// reverse direction) walks time backward and reads xp_b, zh_b, zc_b and the
// mask at T-1-s.  Both lanes start from zero state.  With ndir = 1 only lane
// 0 runs and the _b pointers are unused.
//
// What bounds it on the H100: as for the LSTM (bilstm_fwd.cu), a serial
// chain of [R, H] x [H, 4H] products whose weights (1 MB at H=256) do not
// fit in one SM; the mix is elementwise on a CTA's own units.  So the design
// is bilstm_fwd.cu's: one cluster of C CTAs per (direction, group of R
// batch rows), grid (C, ceil(B/R), ndir); CTA k owns the U units [kU, kU +
// U) and all four gate columns of each, and holds wh[:, those columns] in
// the registers of its 256 threads, 128 rows of one column a thread, read
// from device memory once.  A step:
//
//   1. gates[R, 4U] = h_prev[R, H] @ slice, h_prev broadcast from shared
//      memory as float4; the row slices' sums added in a fixed order;
//   2. xp[t] of own columns, zh[t] and zc[t] of own (row, unit) pairs and
//      the mask, fetched one step ahead by cp.async, complete the
//      pre-activations and the mix; the cell runs for the CTA's (row, unit)
//      pairs, h_prev of an own unit read from the h buffer and c_prev from
//      the CTA's c, and writes the mixed h and c;
//   3. each h goes into every CTA's h_prev buffer for the next step through
//      distributed shared memory (cluster.map_shared_rank); the buffers
//      alternate on s & 1, so one cluster barrier a step suffices.
//
// The launcher checks with cudaOccupancyMaxActiveClusters that every
// cluster of the grid is resident at once and refuses the launch otherwise.
// ops/zoneout_lstm.py `zoneout_geometry` picks C, U and R, and sends the
// widths whose slice does not fit (H=300, H=512) to
// zoneout_lstm_stream_fwd.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 128;      // k rows of the weights a thread holds
constexpr int kMaxCluster = 8;   // the portable cluster size

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Offsets (in floats) of the dynamic shared memory of one CTA; mirrored by
// ops/zoneout_lstm.py `zoneout_cluster_smem`.
struct FwdLayout {
  int ks, hs, hbuf, xs, mk, red, cs, zh, zc, total;
  __host__ __device__ FwdLayout(int H, int U, int R) {
    const int gc = 4 * U;
    ks = (H + kSlice - 1) / kSlice;  // slices of the H reduction
    hs = ks * kSlice;             // h rows, zero-padded to whole slices
    hbuf = 0;                     // [2][R][hs]  h_prev, alternating
    xs = hbuf + 2 * R * hs;       // [2][R][gc]  xp of own columns
    mk = xs + 2 * R * gc;         // [2][R]      mask
    red = mk + round4(2 * R);     // [ks][R][gc] partial products
    cs = red + ks * R * gc;       // [R][U]      c of own units
    zh = cs + round4(R * U);      // [2][R][U]   zh of own units
    zc = zh + round4(2 * R * U);  // [2][R][U]   zc of own units
    total = zc + round4(2 * R * U);
  }
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
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
zoneout_lstm_fwd_kernel(const float* __restrict__ xp_f,
                        const float* __restrict__ xp_b,
                        const float* __restrict__ mask,
                        const float* __restrict__ zh_f,
                        const float* __restrict__ zh_b,
                        const float* __restrict__ zc_f,
                        const float* __restrict__ zc_b,
                        const float* __restrict__ wh_f,
                        const float* __restrict__ wh_b,
                        float* __restrict__ h_f, float* __restrict__ c_f,
                        float* __restrict__ h_b, float* __restrict__ c_b,
                        int T, int B, int H, int U) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const FwdLayout L(H, U, R);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* hbuf = smem + L.hbuf;
  float* xs = smem + L.xs;
  float* mk = smem + L.mk;
  float* red = smem + L.red;
  float* cs = smem + L.cs;
  float* zhs = smem + L.zh;
  float* zcs = smem + L.zc;
  const int G = 4 * H, GC = 4 * U, HS = L.hs, RU = R * U;

  const bool rev = blockIdx.z == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ zh = rev ? zh_b : zh_f;
  const float* __restrict__ zc = rev ? zc_b : zc_f;
  const float* __restrict__ wh = rev ? wh_b : wh_f;
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
  for (int i = tid; i < 2 * R * HS; i += kThreads) hbuf[i] = 0.f;
  for (int i = tid; i < RU; i += kThreads) cs[i] = 0.f;

  // xp of own columns, zh and zc of own units and the mask of step s, into
  // slot s & 1
  auto prefetch = [&](int s) {
    const int t = rev ? T - 1 - s : s;
    const int slot = s & 1;
    float* xd = xs + slot * R * GC;
    for (int i = tid; i < R * GC; i += kThreads) {
      const int r = i / GC, col = i - r * GC;
      const int q = col / U, unit = u0 + col - q * U;
      const int b = b0 + r;
      const bool ok = b < B && unit < H;
      cp_async4(xd + i,
                ok ? xp + (static_cast<size_t>(t) * B + b) * G + q * H + unit
                   : xp,
                ok);
    }
    for (int i = tid; i < RU; i += kThreads) {
      const int r = i / U, unit = u0 + i - r * U;
      const int b = b0 + r;
      const bool ok = b < B && unit < H;
      const size_t o = (static_cast<size_t>(t) * B + b) * H + unit;
      cp_async4(zhs + slot * RU + i, ok ? zh + o : zh, ok);
      cp_async4(zcs + slot * RU + i, ok ? zc + o : zc, ok);
    }
    for (int r = tid; r < R; r += kThreads) {
      const bool ok = b0 + r < B;
      cp_async4(mk + slot * R + r,
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
    const float* hp = hbuf + cur * R * HS;

    // 1. h_prev @ w, one column and one slice of the reduction a thread,
    // the weights from registers and h broadcast from shared memory
    if (active) {
      const float* hk = hp + ks * kSlice;
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

    // 2. the cell and the mix on own (row, unit) pairs; 3. h to every CTA's
    // next buffer
    float* hn = hbuf + (cur ^ 1) * R * HS;
    const float* x = xs + cur * R * GC;
    for (int i = tid; i < RU; i += kThreads) {
      const int r = i / U, u = i - r * U, unit = u0 + u;
      if (unit >= H) continue;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = q * U + u;
        float v = x[r * GC + j];
        for (int p = 0; p < L.ks; ++p) v += red[(p * R + r) * GC + j];
        pre[q] = v;
      }
      const float ig = sigmoidf(pre[0]);
      const float fg = sigmoidf(pre[1]);
      const float gg = tanhf(pre[2]);
      const float og = sigmoidf(pre[3]);
      const float c_prev = cs[i];
      const float h_prev = hp[r * HS + unit];
      const float c_new = fg * c_prev + ig * gg;
      const float h_new = og * tanhf(c_new);
      const float mh = zhs[cur * RU + i];
      const float mc = zcs[cur * RU + i];
      float h = mh * h_new + (1.f - mh) * h_prev;
      float c = mc * c_new + (1.f - mc) * c_prev;
      if (!(mk[cur * R + r] > 0.f)) {
        c = c_prev;
        h = h_prev;
      }
      cs[i] = c;
      const int b = b0 + r;
      if (b < B) {
        const size_t o = (static_cast<size_t>(t) * B + b) * H + unit;
        h_out[o] = h;
        c_out[o] = c;
      }
      for (int p = 0; p < C; ++p)
        cluster.map_shared_rank(hn, p)[r * HS + unit] = h;
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
      sizeof(float) * static_cast<size_t>(FwdLayout(H, U, R).total);
  cudaError_t err = cudaFuncSetAttribute(
      zoneout_lstm_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
                                        zoneout_lstm_fwd_kernel<R>, cfg);
}

template <int R>
cudaError_t launch(const float* xp_f, const float* xp_b, const float* mask,
                   const float* zh_f, const float* zh_b, const float* zc_f,
                   const float* zc_b, const float* wh_f, const float* wh_b,
                   float* h_f, float* c_f, float* h_b, float* c_b, int T,
                   int B, int H, int ndir, int C, int U,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  cudaError_t err = configure<R>(B, H, ndir, C, U, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  // all clusters in one wave, or no launch
  if (fit < static_cast<int>(cfg.gridDim.y * cfg.gridDim.z))
    return cudaErrorCooperativeLaunchTooLarge;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, zoneout_lstm_fwd_kernel<R>, xp_f, xp_b,
                           mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, h_f,
                           c_f, h_b, c_b, T, B, H, U);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid_geometry(int H, int ndir, int C, int U) {
  return ndir >= 1 && ndir <= 2 && C >= 1 && C <= kMaxCluster && U >= 1 &&
         4 * U * ((H + kSlice - 1) / kSlice) <= kThreads && C * U >= H &&
         (C - 1) * U < H;
}

// f(std::integral_constant<int, R>) for the row counts the kernel is built
// for
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
extern "C" int asr_zoneout_lstm_fwd(const float* xp_f, const float* xp_b,
                                    const float* mask, const float* zh_f,
                                    const float* zh_b, const float* zc_f,
                                    const float* zc_b, const float* wh_f,
                                    const float* wh_b, float* h_f,
                                    float* c_f, float* h_b, float* c_b,
                                    int T, int B, int H, int ndir, int C,
                                    int U, int R, void* stream) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_rows(R, [&](auto rows) {
    return launch<decltype(rows)::value>(
        xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, h_f, c_f, h_b,
        c_b, T, B, H, ndir, C, U, static_cast<cudaStream_t>(stream));
  }));
}

// The forward's dynamic shared memory per CTA and the clusters the card
// holds at once for that launch, without launching.
extern "C" int asr_zoneout_lstm_fwd_info(int B, int H, int ndir, int C,
                                         int U, int R, int* smem_bytes,
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
