// The LSTM recurrence of one layer, forward pass, over one or two
// directions in one launch, for the widths 256 < H <= 512 (deep_speech's
// 512-unit BLSTM): the recurrent weights resident in a non-portable
// thread-block cluster of up to 16 CTAs for the whole sequence.
//
// Replaces two TPU kernels at those widths: asr_study_tpu/ops/
// pallas_bilstm.py `_bifwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_lstm.py `_fwd_kernel` (one direction) with
// ndir = 1.  Cell maths: ops/pallas_lstm.py `_lstm_cell_math`.
//
// Inputs and outputs are bilstm_fwd.cu's: xp_f / xp_b [T, B, 4H] (x @ wx +
// b), the mask [T, B], wh_f / wh_b [H, 4H] (gate order i, f, g, o) -> h and
// c of each direction [T, B, H] in forward time order, lane 1 walking time
// backward, held frames repeating the previous state.  When training, the
// caller also passes g_f / g_b [T, B, 4H] and the kernel writes there the
// four activated gates (sigmoid i, f, o and tanh g) of every frame, which
// the backward (lstm_wide_bwd.cu) reads in place of recomputing them.  For
// serving both are null and nothing more is written.
//
// What bounds it on the H100: one direction's wh at H=512 is 4 MiB, and a
// step is a [R, 512] x [512, 2048] product.  Streamed from L2 every step
// through one SM (lstm_stream_fwd.cu) it costs 76 us a step.  Split over
// the portable 8 CTAs, a CTA's slice (256 columns x 512 rows, 512 KiB)
// fits neither its registers nor its shared memory.  So the cluster here
// has C = ceil(H / 32) CTAs (16 at H=512, past the portable 8:
// cudaFuncAttributeNonPortableClusterSizeAllowed), and CTA k owns the 32
// units [32k, 32k + 32) with their i, f, g, o columns: 128 columns x 512
// rows = 256 KiB, half in registers and half in shared memory.
//
// The layout of a CTA (256 threads; thread (col, half), col = tid % 128):
//
//   registers  w[128] = wh[128 half + kk][col], rows 0..255 of the slice
//              (the 128 weight registers of a bilstm_fwd.cu thread);
//   ws         [256][128] fp32, rows 256..511 of the slice, ws[128 half +
//              kk][col]: a warp reads 32 consecutive columns of one row,
//              free of bank conflicts; 131,072 B;
//   hbuf       [2][R][512] h_prev, alternating on s & 1 (one cluster
//              barrier a step), rows past H zero;
//   xs, mk     [2][R][128] xp of own columns and [2][R] the mask, fetched
//              a step ahead by cp.async;
//   red        [2][R][128] the two halves' partial sums.
//
// At R=16 that is 229,504 B of the 232,448 a block may have (mirrored by
// ops/bilstm.py `wide_smem`).  A step:
//
//   1. gates[R, 128] = h_prev[R, 512] @ slice: thread (col, half) sums rows
//      [128 half, +128) from its registers, then rows [256 + 128 half,
//      +128) from ws, into one accumulator a row, h broadcast as float4;
//   2. the cell, thread i < 8R owning row i / 8 and the four units 4 (i %
//      8) .. +3 (c in its registers): pre = xp + red[0] + red[1], in that
//      order; h, c (and the gates) to device memory;
//   3. its four h as one float4 into every CTA's next h buffer through
//      distributed shared memory; one cluster barrier.
//
// The launcher refuses a grid whose clusters are not all resident at once
// (cudaOccupancyMaxActiveClusters); ops/bilstm.py `lstm_geometry` picks R
// and sends this width range here.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 32;           // hidden units a CTA owns
constexpr int kCols = 4 * kUnits;    // their gate columns
constexpr int kSlice = 128;          // rows of a column a thread holds
constexpr int kRows = 4 * kSlice;    // rows of the slice: the widest H
constexpr int kQuads = kUnits / 4;   // cell threads a batch row
constexpr int kMaxCluster = 16;      // Hopper's non-portable maximum

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Offsets (in floats) of the dynamic shared memory of one CTA; mirrored by
// ops/bilstm.py `wide_smem`.
struct FwdLayout {
  int ws, hbuf, xs, mk, red, total;
  __host__ __device__ explicit FwdLayout(int R) {
    ws = 0;                          // [2 * kSlice][kCols] rows 256..511
    hbuf = ws + 2 * kSlice * kCols;  // [2][R][kRows]  h_prev, alternating
    xs = hbuf + 2 * R * kRows;       // [2][R][kCols]  xp of own columns
    mk = xs + 2 * R * kCols;         // [2][R]         mask
    red = mk + round4(2 * R);        // [2][R][kCols]  partial products
    total = red + 2 * R * kCols;
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
lstm_wide_fwd_kernel(const float* __restrict__ xp_f,
                     const float* __restrict__ xp_b,
                     const float* __restrict__ mask,
                     const float* __restrict__ wh_f,
                     const float* __restrict__ wh_b, float* __restrict__ h_f,
                     float* __restrict__ c_f, float* __restrict__ h_b,
                     float* __restrict__ c_b, float* __restrict__ g_f,
                     float* __restrict__ g_b, int T, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const FwdLayout L(R);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ws = smem + L.ws;
  float* hbuf = smem + L.hbuf;
  float* xs = smem + L.xs;
  float* mk = smem + L.mk;
  float* red = smem + L.red;
  const int G = 4 * H;

  const bool rev = blockIdx.z == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ wh = rev ? wh_b : wh_f;
  float* __restrict__ h_out = rev ? h_b : h_f;
  float* __restrict__ c_out = rev ? c_b : c_f;
  float* __restrict__ g_out = rev ? g_b : g_f;
  const int b0 = blockIdx.y * R;
  const int u0 = rank * kUnits;
  const int tid = threadIdx.x;

  // the resident slice: thread (col, half) holds rows [128 half, +128) of
  // column col in registers and writes rows [256 + 128 half, +128) of it
  // into ws; col = q * kUnits + u is wh's column q * H + u0 + u, zero past H
  const int col = tid % kCols, half = tid / kCols;
  const int q_col = col / kUnits, unit_col = u0 + col % kUnits;
  const float* __restrict__ wcol = wh + q_col * H + unit_col;
  const bool live = unit_col < H;
  float w[kSlice];
#pragma unroll
  for (int kk = 0; kk < kSlice; ++kk) {
    const int k = half * kSlice + kk;
    w[kk] = (live && k < H) ? wcol[static_cast<size_t>(k) * G] : 0.f;
  }
  for (int kk = 0; kk < kSlice; ++kk) {
    const int k = 2 * kSlice + half * kSlice + kk;
    ws[(half * kSlice + kk) * kCols + col] =
        (live && k < H) ? wcol[static_cast<size_t>(k) * G] : 0.f;
  }
  for (int i = tid; i < 2 * R * kRows; i += kThreads) hbuf[i] = 0.f;

  // xp of own columns and the mask of step s, into slot s & 1
  auto prefetch = [&](int s) {
    const int t = rev ? T - 1 - s : s;
    float* xd = xs + (s & 1) * R * kCols;
    for (int i = tid; i < R * kCols; i += kThreads) {
      const int r = i / kCols, c = i - r * kCols;
      const int q = c / kUnits, unit = u0 + c - q * kUnits;
      const int b = b0 + r;
      const bool ok = b < B && unit < H;
      cp_async4(xd + i,
                ok ? xp + (static_cast<size_t>(t) * B + b) * G + q * H + unit
                   : xp,
                ok);
    }
    for (int r = tid; r < R; r += kThreads) {
      const bool ok = b0 + r < B;
      cp_async4(mk + (s & 1) * R + r,
                ok ? mask + static_cast<size_t>(t) * B + b0 + r : mask, ok);
    }
    cp_async_commit();
  };

  // the cell's (row, four units) of this thread, and their c
  const bool cell = tid < R * kQuads;
  const int cr = tid / kQuads, cu = 4 * (tid % kQuads);
  float cst[4] = {0.f, 0.f, 0.f, 0.f};

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
    const float* hp = hbuf + cur * R * kRows;

    // 1. h_prev @ slice: the register half, then the shared-memory half
    {
      const float* h0 = hp + half * kSlice;
      const float* h1 = hp + 2 * kSlice + half * kSlice;
      const float* wsc = ws + half * kSlice * kCols + col;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 4) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv =
              *reinterpret_cast<const float4*>(h0 + r * kRows + kk);
          acc[r] = fmaf(hv.x, w[kk], acc[r]);
          acc[r] = fmaf(hv.y, w[kk + 1], acc[r]);
          acc[r] = fmaf(hv.z, w[kk + 2], acc[r]);
          acc[r] = fmaf(hv.w, w[kk + 3], acc[r]);
        }
      }
#pragma unroll 4
      for (int kk = 0; kk < kSlice; kk += 4) {
        const float w0 = wsc[kk * kCols], w1 = wsc[(kk + 1) * kCols],
                    w2 = wsc[(kk + 2) * kCols], w3 = wsc[(kk + 3) * kCols];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv =
              *reinterpret_cast<const float4*>(h1 + r * kRows + kk);
          acc[r] = fmaf(hv.x, w0, acc[r]);
          acc[r] = fmaf(hv.y, w1, acc[r]);
          acc[r] = fmaf(hv.z, w2, acc[r]);
          acc[r] = fmaf(hv.w, w3, acc[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < R; ++r) red[(half * R + r) * kCols + col] = acc[r];
    }
    cp_async_wait_prev();
    __syncthreads();

    // 2. the cell on own (row, four units); 3. h to every CTA's next buffer
    if (cell) {
      const float* x = xs + (cur * R + cr) * kCols + cu;
      const float* p0 = red + cr * kCols + cu;
      const float* p1 = red + (R + cr) * kCols + cu;
      float pre[4][4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 xv = *reinterpret_cast<const float4*>(x + q * kUnits);
        const float4 a = *reinterpret_cast<const float4*>(p0 + q * kUnits);
        const float4 b = *reinterpret_cast<const float4*>(p1 + q * kUnits);
        pre[q][0] = xv.x + a.x + b.x;
        pre[q][1] = xv.y + a.y + b.y;
        pre[q][2] = xv.z + a.z + b.z;
        pre[q][3] = xv.w + a.w + b.w;
      }
      const bool m = mk[cur * R + cr] > 0.f;
      const int b = b0 + cr;
      float hv[4];
#pragma unroll
      for (int uu = 0; uu < 4; ++uu) {
        const int unit = u0 + cu + uu;
        const float ig = sigmoidf(pre[0][uu]);
        const float fg = sigmoidf(pre[1][uu]);
        const float gg = tanhf(pre[2][uu]);
        const float og = sigmoidf(pre[3][uu]);
        float c = fg * cst[uu] + ig * gg;
        float h = og * tanhf(c);
        if (!m) {
          c = cst[uu];
          h = hp[cr * kRows + unit];
        }
        const bool valid = unit < H;
        cst[uu] = valid ? c : 0.f;
        hv[uu] = valid ? h : 0.f;
        if (valid && b < B) {
          const size_t o = static_cast<size_t>(t) * B + b;
          h_out[o * H + unit] = h;
          c_out[o * H + unit] = c;
          if (g_out != nullptr) {
            float* g = g_out + o * G + unit;
            g[0] = ig;
            g[H] = fg;
            g[2 * H] = gg;
            g[3 * H] = og;
          }
        }
      }
      const float4 h4 = make_float4(hv[0], hv[1], hv[2], hv[3]);
      float* hn = hbuf + (cur ^ 1) * R * kRows + cr * kRows + u0 + cu;
      for (int p = 0; p < C; ++p)
        *reinterpret_cast<float4*>(cluster.map_shared_rank(hn, p)) = h4;
    }
    cluster.sync();
  }
}

// The launch configuration of the cluster grid -> its dynamic shared memory
// and how many of its clusters the card holds at once.
template <int R>
cudaError_t configure(int B, int ndir, int C, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, int* max_clusters) {
  const size_t smem = sizeof(float) * static_cast<size_t>(FwdLayout(R).total);
  cudaError_t err = cudaFuncSetAttribute(
      lstm_wide_fwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(lstm_wide_fwd_kernel<R>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
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
                                        lstm_wide_fwd_kernel<R>, cfg);
}

template <int R>
cudaError_t launch(const float* xp_f, const float* xp_b, const float* mask,
                   const float* wh_f, const float* wh_b, float* h_f,
                   float* c_f, float* h_b, float* c_b, float* g_f, float* g_b,
                   int T, int B, int H, int ndir, int C,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  cudaError_t err = configure<R>(B, ndir, C, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  // all clusters in one wave, or no launch
  if (fit < static_cast<int>(cfg.gridDim.y * cfg.gridDim.z))
    return cudaErrorCooperativeLaunchTooLarge;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, lstm_wide_fwd_kernel<R>, xp_f, xp_b, mask,
                           wh_f, wh_b, h_f, c_f, h_b, c_b, g_f, g_b, T, B,
                           H);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// 32 units a CTA, C = ceil(H / 32) CTAs, the slice's 512 rows covering H
bool valid_geometry(int H, int ndir, int C, int U) {
  return ndir >= 1 && ndir <= 2 && U == kUnits && H <= kRows &&
         C == (H + kUnits - 1) / kUnits && C <= kMaxCluster;
}

// f(std::integral_constant<int, R>) for the row counts the kernel is built
// for
template <typename F>
cudaError_t by_rows(int R, F&& f) {
  switch (R) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// Launch the forward over ndir directions: clusters of C CTAs of U = 32
// units each, R (4, 8 or 16) batch rows a cluster.  g_f / g_b: the
// activated gates [T, B, 4H] to write, or both null.
extern "C" int asr_lstm_wide_fwd(const float* xp_f, const float* xp_b,
                                 const float* mask, const float* wh_f,
                                 const float* wh_b, float* h_f, float* c_f,
                                 float* h_b, float* c_b, float* g_f,
                                 float* g_b, int T, int B, int H, int ndir,
                                 int C, int U, int R, void* stream) {
  if (!valid_geometry(H, ndir, C, U) || ((g_f == nullptr) != (g_b == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_rows(R, [&](auto rows) {
    return launch<decltype(rows)::value>(
        xp_f, xp_b, mask, wh_f, wh_b, h_f, c_f, h_b, c_b, g_f, g_b, T, B, H,
        ndir, C, static_cast<cudaStream_t>(stream));
  }));
}

// The forward's dynamic shared memory per CTA and the clusters the card
// holds at once for that launch, without launching.
extern "C" int asr_lstm_wide_fwd_info(int B, int H, int ndir, int C, int U,
                                      int R, int* smem_bytes,
                                      int* max_clusters) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = by_rows(R, [&](auto rows) {
    return configure<decltype(rows)::value>(B, ndir, C, &cfg, attr,
                                            max_clusters);
  });
  if (err == cudaSuccess) *smem_bytes = static_cast<int>(cfg.dynamicSmemBytes);
  return static_cast<int>(err);
}
