// The GRU recurrence of one layer, backward pass, over one or two
// directions in one launch, for the widths 256 < H <= 512 (deep_gru at 512
// units): the cotangent walks that give the pre-activation gradients dxp
// and dhp, with the recurrent weights resident in a non-portable
// thread-block cluster of up to 16 CTAs for the whole sequence.
//
// Replaces two TPU kernels at those widths: asr_study_tpu/ops/
// pallas_bigru.py `_bibwd_kernel` (both walks, in opposite time
// directions) with ndir = 2, and asr_study_tpu/ops/pallas_gru.py
// `_bwd_kernel` (one walk) with ndir = 1.  Row maths: pallas_bigru.py
// `_gru_row_bwd`, with its held-frame rule (a masked frame passes dh
// straight on and gets no gradient).  Only what the kernel reads differs:
// the h side of every frame's pre-activations, [hr, hz, hn] = h_prev @ wh,
// which the forward (gru_wide_fwd.cu) wrote when the layer trains, in
// place of recomputing that product.
//
// Inputs: the bias-folded projections xp_f / xp_b [T, B, 3H], the
// forward's hg_f / hg_b [T, B, 3H], the mask [T, B], wh [H, 3H], the saved
// h of each direction [T, B, H] (for h_prev) and the cotangents of the h
// outputs dh_f / dh_b [T, B, H].  Outputs, each [T, B, 3H] and zero on
// masked frames:
//
//   dxp = [dpre_r, dpre_z, dpre_n]        the x-side pre-activation grads
//   dhp = [dpre_r, dpre_z, dpre_n * r]    the h-side ones (r scales hn)
//
// The weight gradient dwh = h_prev^T dhp is one matmul per direction
// outside the kernel.  The forward direction's chain runs t = T-1 .. 0, the
// reversed one's t = 0 .. T-1; h_prev is the saved h at t-1 (forward) or
// t+1 (reversed), zero past the ends.
//
// What bounds it on the H100: the chain is serial, and with hg saved a step
// is one [R, 3H] x [3H, H] product, the recurrent cotangent dhp @ wh^T (3
// MiB of wh a direction at H=512); gru_stream_bwd.cu did two a step (the
// recomputed h_prev @ wh too) from L2.  CTA k owns the 32 units [32k, 32k +
// 32) and their 96 gate columns; thread j (256 threads) takes the rows j
// and 256 + j of wh[:, own columns]:
//
//   registers  w[96] = wh[j][own columns];
//   ws         [96][256] fp32 = wh[256 + j][own column] at [col][j]: a warp
//              reads 32 consecutive j of one column, free of bank
//              conflicts; 98,304 B;
//   dpre       [96][R] dhp of own columns, row index fastest, so that a
//              thread reads R of them as R / 4 broadcast float4;
//   recv       [2][C][32][R] the partial sums the C CTAs sent for own
//              units, alternating on s & 1 (one cluster barrier a step).
//
// At R=16, C=16 that is 169,984 B (mirrored by ops/gru.py `gru_wide_smem`).
// The cell's inputs (xp and hg of three gates, h_prev, dh_out, the mask)
// go to registers, each loaded one step ahead into the thread that owns
// its (row, unit).  A step:
//
//   a. the cell's reverse maths for own (row, unit) pairs (row fastest over
//      threads): r, z, n from xp and hg; dh = dh_out + hold + the C
//      partials received last step, added in rank order; dxp and dhp to
//      device memory, dhp to shared memory; hold = m ? dh z : dh;
//   b. partial[R, j] = dhp[R, own columns] @ wh[j, own columns]^T for j and
//      256 + j; each row's R partials as float4 to the CTA that owns unit
//      j (its slot for this sender);
//   c. one cluster barrier.
//
// The bfloat16-weight form (asr_gru_wide_bwd_bf16) is the same kernel on
// the weight type W = __nv_bfloat16: the slice's rows held as bfloat16, in
// registers (48 pairs a thread) and in ws ([96][256] bfloat16, 49,152 B),
// dhp rounded to bfloat16 in shared memory before the product
// (ops/pallas_gru.py `_mm(dhp, wht)`) and written to dxp and dhp
// unrounded, the products float32 fmaf on the converted values in the
// float32 form's order.  The h side it reads is the bfloat16 forward's,
// bf16(h_prev) @ wh; h_prev enters the cell's dz unrounded.
//
// The fixed order of every sum keeps the backward, and so the train steps,
// bit-reproducible.  The launcher refuses a grid whose clusters are not
// all resident at once (cudaOccupancyMaxActiveClusters).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kUnits = 32;           // hidden units a CTA owns
constexpr int kCols = 3 * kUnits;    // their gate columns
constexpr int kRows = 2 * kThreads;  // rows of wh covered: the widest H
constexpr int kMaxCluster = 16;      // Hopper's non-portable maximum

// Offsets (in floats) of the dynamic shared memory of one CTA; mirrored by
// ops/gru.py `gru_wide_smem` for the float32 form (ws holds `half`, i.e.
// bfloat16, weights in the bfloat16 form).
struct BwdLayout {
  int ws, dpre, recv, total;
  __host__ __device__ BwdLayout(int R, int C, bool half) {
    ws = 0;                          // [kCols][kThreads] wh rows 256..511
    dpre = ws + (half ? kCols * kThreads / 2 : kCols * kThreads);
    //                                  [kCols][R]
    recv = dpre + kCols * R;         // [2][C][kUnits][R]
    total = recv + 2 * C * kUnits * R;
  }
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
}

// One (row, unit) pair's inputs of a step
struct CellIn {
  float x[3], g[3], hp, dh, m;
};

// A thread's kCols weights of one row of wh, in registers: float32, or
// bfloat16 pairs for the bfloat16-weight form.  get(col) gives column col
// as float32 (col a constant of the unrolled loop).
template <typename W>
struct Row {
  float w[kCols];
  __device__ __forceinline__ void set2(int col, W a, W b) {
    w[col] = a;
    w[col + 1] = b;
  }
  __device__ __forceinline__ float get(int col) const { return w[col]; }
};

template <>
struct Row<__nv_bfloat16> {
  __nv_bfloat162 w[kCols / 2];
  __device__ __forceinline__ void set2(int col, __nv_bfloat16 a,
                                       __nv_bfloat16 b) {
    w[col / 2] = __halves2bfloat162(a, b);
  }
  __device__ __forceinline__ float get(int col) const {
    return (col & 1) ? __high2float(w[col / 2]) : __low2float(w[col / 2]);
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// x as it enters a product with weights of type W: itself, or rounded to
// the nearest bfloat16
template <typename W>
__device__ __forceinline__ float as_operand(float x) {
  if constexpr (std::is_same_v<W, __nv_bfloat16>)
    return __bfloat162float(__float2bfloat16_rn(x));
  else
    return x;
}

template <typename W, int R>
__global__ void __launch_bounds__(kThreads, 1)
gru_wide_bwd_kernel(const float* __restrict__ xp_f,
                    const float* __restrict__ xp_b,
                    const float* __restrict__ hg_f,
                    const float* __restrict__ hg_b,
                    const float* __restrict__ mask,
                    const W* __restrict__ wh_f,
                    const W* __restrict__ wh_b,
                    const float* __restrict__ h_f,
                    const float* __restrict__ h_b,
                    const float* __restrict__ dh_f,
                    const float* __restrict__ dh_b,
                    float* __restrict__ dxp_f, float* __restrict__ dhp_f,
                    float* __restrict__ dxp_b, float* __restrict__ dhp_b,
                    int T, int B, int H) {
  constexpr int kPairs = (R * kUnits + kThreads - 1) / kThreads;
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const BwdLayout L(R, C, std::is_same_v<W, __nv_bfloat16>);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  W* ws = reinterpret_cast<W*>(smem + L.ws);
  float* dpre = smem + L.dpre;
  float* recv = smem + L.recv;
  const int G = 3 * H;

  const bool rev = blockIdx.z == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ hg = rev ? hg_b : hg_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
  const float* __restrict__ h = rev ? h_b : h_f;
  const float* __restrict__ dh_out = rev ? dh_b : dh_f;
  float* __restrict__ dxp = rev ? dxp_b : dxp_f;
  float* __restrict__ dhp = rev ? dhp_b : dhp_f;
  const int b0 = blockIdx.y * R;
  const int u0 = rank * kUnits;
  const int step_dir = rev ? 1 : -1;       // t_prev = t + step_dir
  const int tid = threadIdx.x;

  // the resident slice: rows tid (registers) and 256 + tid (ws) of
  // wh[:, own columns], col = q * kUnits + u being wh's column q*H + u0 + u
  Row<W> w;
  {
    auto at = [&](int col) {
      const int unit = u0 + col % kUnits;
      return (tid < H && unit < H)
                 ? wh[static_cast<size_t>(tid) * G + (col / kUnits) * H +
                      unit]
                 : W{};
    };
#pragma unroll
    for (int col = 0; col < kCols; col += 2)
      w.set2(col, at(col), at(col + 1));
  }
  for (int col = 0; col < kCols; ++col) {
    const int unit = u0 + col % kUnits, k = kThreads + tid;
    ws[col * kThreads + tid] =
        (k < H && unit < H)
            ? wh[static_cast<size_t>(k) * G + (col / kUnits) * H + unit]
            : W{};
  }
  for (int i = tid; i < 2 * C * kUnits * R; i += kThreads) recv[i] = 0.f;

  // the pairs of this thread: i = tid + p * kThreads, r = i % R, u = i / R
  auto pair_ok = [&](int p) {
    const int i = tid + p * kThreads;
    return i < R * kUnits && b0 + i % R < B && u0 + i / R < H;
  };
  auto load = [&](int s, CellIn* in) {
    const int t = rev ? s : T - 1 - s;
    const int tp = t + step_dir;
    const bool has_prev = tp >= 0 && tp < T;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int i = tid + p * kThreads;
      const int b = b0 + i % R, unit = u0 + i / R;
      const bool ok = pair_ok(p);
      const size_t o = static_cast<size_t>(t) * B + b;
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        in[p].x[q] = ok ? xp[o * G + q * H + unit] : 0.f;
        in[p].g[q] = ok ? hg[o * G + q * H + unit] : 0.f;
      }
      in[p].hp = (ok && has_prev)
                     ? h[(static_cast<size_t>(tp) * B + b) * H + unit]
                     : 0.f;
      in[p].dh = ok ? dh_out[o * H + unit] : 0.f;
      in[p].m = ok ? mask[o] : 0.f;
    }
  };

  CellIn nxt[kPairs];
  float hold[kPairs];
#pragma unroll
  for (int p = 0; p < kPairs; ++p) hold[p] = 0.f;
  load(0, nxt);
  // every CTA of the cluster is running and initialised before any peer
  // writes into its shared memory
  cluster.sync();

  for (int s = 0; s < T; ++s) {
    const int cur = s & 1;
    const int t = rev ? s : T - 1 - s;
    CellIn in[kPairs];
#pragma unroll
    for (int p = 0; p < kPairs; ++p) in[p] = nxt[p];
    if (s + 1 < T) load(s + 1, nxt);

    // a. the cell's reverse-mode maths on own pairs
    const float* got = recv + (cur ^ 1) * C * kUnits * R;
#pragma unroll
    for (int p = 0; p < kPairs; ++p) {
      const int i = tid + p * kThreads;
      if (i >= R * kUnits) continue;
      const int r = i % R, u = i / R;
      const float hn = in[p].g[2];
      const float rg = sigmoidf(in[p].x[0] + in[p].g[0]);
      const float zg = sigmoidf(in[p].x[1] + in[p].g[1]);
      const float ng = tanhf(in[p].x[2] + rg * hn);
      float dh = in[p].dh + hold[p];
      for (int k = 0; k < C; ++k) dh += got[(k * kUnits + u) * R + r];
      const bool m = in[p].m > 0.f;
      const float dpre_n = m ? dh * (1.f - zg) * (1.f - ng * ng) : 0.f;
      const float dpre_r = m ? dpre_n * hn * rg * (1.f - rg) : 0.f;
      const float dpre_z = m ? dh * (in[p].hp - ng) * zg * (1.f - zg) : 0.f;
      const float dhp_n = dpre_n * rg;
      // the product's operands (rounded in the bfloat16 form); dxp and dhp
      // unrounded
      float* dp = dpre + u * R + r;
      dp[0] = as_operand<W>(dpre_r);
      dp[kUnits * R] = as_operand<W>(dpre_z);
      dp[2 * kUnits * R] = as_operand<W>(dhp_n);
      if (pair_ok(p)) {
        const size_t o = (static_cast<size_t>(t) * B + b0 + r) * G + u0 + u;
        dxp[o] = dpre_r;
        dxp[o + H] = dpre_z;
        dxp[o + 2 * H] = dpre_n;
        dhp[o] = dpre_r;
        dhp[o + H] = dpre_z;
        dhp[o + 2 * H] = dhp_n;
      }
      // a held frame passes its h (and the cotangent) straight through
      hold[p] = m ? dh * zg : dh;
    }
    __syncthreads();

    // b. dhp[R, own columns] @ wh[{j, 256 + j}, own columns]^T
    {
      float acc0[R], acc1[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        acc0[r] = 0.f;
        acc1[r] = 0.f;
      }
#pragma unroll
      for (int col = 0; col < kCols; ++col) {
        const float wa = w.get(col),
                    wb = to_float(ws[col * kThreads + tid]);
#pragma unroll
        for (int r = 0; r < R; r += 4) {
          const float4 d =
              *reinterpret_cast<const float4*>(dpre + col * R + r);
          acc0[r] = fmaf(d.x, wa, acc0[r]);
          acc0[r + 1] = fmaf(d.y, wa, acc0[r + 1]);
          acc0[r + 2] = fmaf(d.z, wa, acc0[r + 2]);
          acc0[r + 3] = fmaf(d.w, wa, acc0[r + 3]);
          acc1[r] = fmaf(d.x, wb, acc1[r]);
          acc1[r + 1] = fmaf(d.y, wb, acc1[r + 1]);
          acc1[r + 2] = fmaf(d.z, wb, acc1[r + 2]);
          acc1[r + 3] = fmaf(d.w, wb, acc1[r + 3]);
        }
      }
      // row j's R partials to the CTA that owns unit j, as float4
      float* slot = recv + (cur * C + rank) * kUnits * R;
      auto send = [&](const float(&acc)[R], int j) {
        if (j >= H) return;
        const int owner = j / kUnits;
        float4* dst = reinterpret_cast<float4*>(cluster.map_shared_rank(
            slot + (j - owner * kUnits) * R, owner));
#pragma unroll
        for (int r = 0; r < R; r += 4)
          dst[r / 4] = make_float4(acc[r], acc[r + 1], acc[r + 2],
                                   acc[r + 3]);
      };
      send(acc0, tid);
      send(acc1, kThreads + tid);
    }
    // c.
    cluster.sync();
  }
}

// The launch configuration of the cluster grid -> its dynamic shared memory
// and how many of its clusters the card holds at once.
template <typename W, int R>
cudaError_t configure(int B, int ndir, int C, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, int* max_clusters) {
  const size_t smem =
      sizeof(float) *
      static_cast<size_t>(
          BwdLayout(R, C, std::is_same_v<W, __nv_bfloat16>).total);
  cudaError_t err = cudaFuncSetAttribute(
      gru_wide_bwd_kernel<W, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gru_wide_bwd_kernel<W, R>,
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
                                        gru_wide_bwd_kernel<W, R>, cfg);
}

template <typename W, int R>
cudaError_t launch(const float* xp_f, const float* xp_b, const float* hg_f,
                   const float* hg_b, const float* mask, const W* wh_f,
                   const W* wh_b, const float* h_f, const float* h_b,
                   const float* dh_f, const float* dh_b, float* dxp_f,
                   float* dhp_f, float* dxp_b, float* dhp_b, int T, int B,
                   int H, int ndir, int C, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  cudaError_t err = configure<W, R>(B, ndir, C, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  // all clusters in one wave, or no launch
  if (fit < static_cast<int>(cfg.gridDim.y * cfg.gridDim.z))
    return cudaErrorCooperativeLaunchTooLarge;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, gru_wide_bwd_kernel<W, R>, xp_f, xp_b, hg_f,
                           hg_b, mask, wh_f, wh_b, h_f, h_b, dh_f, dh_b,
                           dxp_f, dhp_f, dxp_b, dhp_b, T, B, H);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// 32 units a CTA, C = ceil(H / 32) CTAs, the 512 rows covering H
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

template <typename W>
int launch_form(const float* xp_f, const float* xp_b, const float* hg_f,
                const float* hg_b, const float* mask, const W* wh_f,
                const W* wh_b, const float* h_f, const float* h_b,
                const float* dh_f, const float* dh_b, float* dxp_f,
                float* dhp_f, float* dxp_b, float* dhp_b, int T, int B,
                int H, int ndir, int C, int U, int R, void* stream) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_rows(R, [&](auto rows) {
    return launch<W, decltype(rows)::value>(
        xp_f, xp_b, hg_f, hg_b, mask, wh_f, wh_b, h_f, h_b, dh_f, dh_b,
        dxp_f, dhp_f, dxp_b, dhp_b, T, B, H, ndir, C,
        static_cast<cudaStream_t>(stream));
  }));
}

}  // namespace

// Launch the backward over ndir directions from the forward's saved h side
// of the pre-activations hg: clusters of C CTAs of U = 32 units each, R (4,
// 8 or 16) batch rows a cluster.
extern "C" int asr_gru_wide_bwd(const float* xp_f, const float* xp_b,
                                const float* hg_f, const float* hg_b,
                                const float* mask, const float* wh_f,
                                const float* wh_b, const float* h_f,
                                const float* h_b, const float* dh_f,
                                const float* dh_b, float* dxp_f,
                                float* dhp_f, float* dxp_b, float* dhp_b,
                                int T, int B, int H, int ndir, int C, int U,
                                int R, void* stream) {
  return launch_form<float>(xp_f, xp_b, hg_f, hg_b, mask, wh_f, wh_b, h_f,
                            h_b, dh_f, dh_b, dxp_f, dhp_f, dxp_b, dhp_b, T, B,
                            H, ndir, C, U, R, stream);
}

// The bfloat16-weight form: asr_gru_wide_bwd's arguments with wh_f / wh_b
// bfloat16 [H, 3H] (and the h side of asr_gru_wide_fwd_bf16).
extern "C" int asr_gru_wide_bwd_bf16(
    const float* xp_f, const float* xp_b, const float* hg_f,
    const float* hg_b, const float* mask, const __nv_bfloat16* wh_f,
    const __nv_bfloat16* wh_b, const float* h_f, const float* h_b,
    const float* dh_f, const float* dh_b, float* dxp_f, float* dhp_f,
    float* dxp_b, float* dhp_b, int T, int B, int H, int ndir, int C, int U,
    int R, void* stream) {
  return launch_form<__nv_bfloat16>(xp_f, xp_b, hg_f, hg_b, mask, wh_f, wh_b,
                                    h_f, h_b, dh_f, dh_b, dxp_f, dhp_f, dxp_b,
                                    dhp_b, T, B, H, ndir, C, U, R, stream);
}

// The backward's dynamic shared memory per CTA and the clusters the card
// holds at once for that launch, without launching.
extern "C" int asr_gru_wide_bwd_info(int B, int H, int ndir, int C, int U,
                                     int R, int* smem_bytes,
                                     int* max_clusters) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  const cudaError_t err = by_rows(R, [&](auto rows) {
    return configure<float, decltype(rows)::value>(B, ndir, C, &cfg, attr,
                                                   max_clusters);
  });
  if (err == cudaSuccess) *smem_bytes = static_cast<int>(cfg.dynamicSmemBytes);
  return static_cast<int>(err);
}
