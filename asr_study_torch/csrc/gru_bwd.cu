// The GRU recurrence of one layer, backward pass, over one or two
// directions in one launch: the cotangent walks that give the
// pre-activation gradients dxp and dhp, with the recurrent weights resident
// in a thread-block cluster for the whole sequence.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bigru.py
// `_bibwd_kernel` (both walks, in opposite time directions) with ndir = 2,
// and asr_study_tpu/ops/pallas_gru.py `_bwd_kernel` (one walk) with
// ndir = 1.  Row maths: pallas_bigru.py `_gru_row_bwd` (the same as
// pallas_gru.py's kernel body), with its held-frame rule: a masked frame
// passes its whole dh to the previous step.
//
// Inputs: the forward's bias-folded projections xp_f / xp_b [T, B, 3H], the
// mask [T, B], the recurrent weights wh [H, 3H], the saved h of each
// direction [T, B, H] and the cotangents of the h outputs dh_f / dh_b
// [T, B, H].  Outputs, each [T, B, 3H] and zero on masked frames:
//
//   dxp = [dpre_r, dpre_z, dpre_n]        the x-side pre-activation grads
//   dhp = [dpre_r, dpre_z, dpre_n * r]    the h-side ones (r scales hn)
//
// The weight gradient dwh = h_prev^T dhp (dhp, not dxp) over all T*B rows
// is one matmul per direction outside the kernel.  Lane 0's cotangent chain
// runs t = T-1 .. 0, lane 1's (the reverse direction) t = 0 .. T-1; h_prev
// is the saved h at t-1 (lane 0) or t+1 (lane 1), zero past the ends.
//
// What bounds it on the H100: the chain is serial in time, and each step
// has two [R, H] x [H, 3H]-sized products through wh: the recomputed hp and
// the recurrent cotangent dhp @ wh^T.  A design that reads wh and a
// transposed copy from L2 every step pays two passes of 768 KB through one
// SM a step at H=256 (40 us: gru_stream_bwd.cu).  Here both products read
// one slice of wh held on chip for the whole sequence, so a step costs the
// FMAs of one CTA's slice, one reduce-scatter through distributed shared
// memory and one cluster barrier.
//
// The design is gru_fwd.cu's (and bilstm_bwd.cu's): one cluster of C CTAs
// per (direction, group of R batch rows), CTA k owning the U units
// [kU, kU + U) with their three gate columns.  Its slice wh[:, own columns]
// is held twice, in the registers of its threads as in the forward, for
// step a, and in shared memory as ws [H][3U'+1] (3U' = 3U rounded up to 4,
// the extra columns zero), for step c, whose thread j reads row j: the odd
// row stride keeps those reads free of bank conflicts.  A step:
//
//   a. hp[R, 3U] = h[t_prev] @ slice from the saved h, which needs no
//      exchange (h, dh_out, xp and the mask of the next step are fetched by
//      cp.async while this one runs);
//   b. the cell's reverse maths for own units: dh = dh_out[t] + hold + the
//      C partial sums of the recurrent cotangent received last step, added
//      in rank order; dxp and dhp go out, dhp to shared memory too, and
//      hold = m ? dh z : dh;
//   c. partial[R, H] = dhp[R, own columns] @ ws^T, thread j taking unit j,
//      dhp broadcast as float4; each unit's part sent to the CTA that owns
//      it (its slot for this sender, alternating on s & 1);
//   d. one cluster barrier.
//
// The fixed order of every sum keeps the backward, and so the train steps,
// bit-reproducible.  The launcher refuses a grid whose clusters are not all
// resident at once (cudaOccupancyMaxActiveClusters); ops/gru.py
// `gru_geometry` picks C, U and R and sends the widths whose slice does not
// fit (H=512) to gru_stream_bwd.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 384;
constexpr int kSlice = 64;       // k rows of the weights a thread holds
constexpr int kMaxCluster = 8;   // the portable cluster size

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Offsets (in floats) of the dynamic shared memory of one CTA; mirrored by
// ops/gru.py `gru_cluster_smem`.  Every region starts on 16 bytes.
struct BwdLayout {
  int hp, gcp, gcs, ks, hs, ws, hpb, xs, dho, mk, red, dhp, recv, hold,
      total;
  __host__ __device__ BwdLayout(int H, int U, int R, int C) {
    const int gc = 3 * U;
    hp = round4(H);
    gcp = round4(gc);                // own columns, padded to float4
    gcs = gcp + 1;
    ks = (H + kSlice - 1) / kSlice;  // slices of the H reduction
    hs = ks * kSlice;                // h rows, zero-padded to whole slices
    ws = 0;                          // [hp][gcs]   wh[:, own columns]
    hpb = ws + round4(hp * gcs);     // [2][R][hs]  saved h at t_prev
    xs = hpb + 2 * R * hs;           // [2][R][gc]  xp of own columns
    dho = xs + round4(2 * R * gc);   // [2][R][U]   dh_out at t
    mk = dho + round4(2 * R * U);    // [2][R]      mask
    red = mk + round4(2 * R);        // [ks][R][gc] partial gate products
    dhp = red + round4(ks * R * gc); // [R][gcp]    dhp of own columns
    recv = dhp + R * gcp;            // [2][C][R][U] received partials
    hold = recv + round4(2 * C * R * U);  // [R][U] dh passed on
    total = hold + round4(R * U);
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
gru_bwd_kernel(const float* __restrict__ xp_f, const float* __restrict__ xp_b,
               const float* __restrict__ mask,
               const float* __restrict__ wh_f,
               const float* __restrict__ wh_b,
               const float* __restrict__ h_f, const float* __restrict__ h_b,
               const float* __restrict__ dh_f,
               const float* __restrict__ dh_b, float* __restrict__ dxp_f,
               float* __restrict__ dhp_f, float* __restrict__ dxp_b,
               float* __restrict__ dhp_b, int T, int B, int H, int U) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const BwdLayout L(H, U, R, C);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* ws = smem + L.ws;
  float* hpb = smem + L.hpb;
  float* xs = smem + L.xs;
  float* dho = smem + L.dho;
  float* mk = smem + L.mk;
  float* red = smem + L.red;
  float* dhs = smem + L.dhp;
  float* recv = smem + L.recv;
  float* hold = smem + L.hold;
  const int G = 3 * H, GC = 3 * U, GCP = L.gcp, GCS = L.gcs, HS = L.hs;
  const int RU = R * U;

  const bool rev = blockIdx.z == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ wh = rev ? wh_b : wh_f;
  const float* __restrict__ h = rev ? h_b : h_f;
  const float* __restrict__ dh_out = rev ? dh_b : dh_f;
  float* __restrict__ dxp = rev ? dxp_b : dxp_f;
  float* __restrict__ dhp = rev ? dhp_b : dhp_f;
  const int b0 = blockIdx.y * R;
  const int u0 = rank * U;
  const int step_dir = rev ? 1 : -1;       // t_prev = t + step_dir
  const int tid = threadIdx.x;

  // the resident slice twice: in shared memory, ws[k][q*U + u] =
  // wh[k][q*H + u0 + u] (zero past H and in the padding columns), for step
  // c's row reads; in registers, thread (col, ks) holding
  // w[kk] = ws[ks*kSlice + kk][col], for step a
  for (int i = tid; i < L.hp * GCS; i += kThreads) {
    const int k = i / GCS, col = i - k * GCS;
    const int q = col / U, unit = u0 + col - q * U;
    ws[i] = (k < H && col < GC && unit < H)
                ? wh[static_cast<size_t>(k) * G + q * H + unit]
                : 0.f;
  }
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
  for (int i = tid; i < R * GCP; i += kThreads) dhs[i] = 0.f;
  for (int i = tid; i < 2 * C * RU; i += kThreads) recv[i] = 0.f;
  for (int i = tid; i < RU; i += kThreads) hold[i] = 0.f;

  // everything step s reads from device memory, into slot s & 1
  auto prefetch = [&](int s) {
    const int t = rev ? s : T - 1 - s;
    const int tp = t + step_dir;
    const bool has_prev = tp >= 0 && tp < T;
    const int slot = s & 1;
    for (int i = tid; i < R * GC; i += kThreads) {
      const int r = i / GC, col = i - r * GC;
      const int q = col / U, unit = u0 + col - q * U;
      const int b = b0 + r;
      const bool ok = b < B && unit < H;
      cp_async4(xs + slot * R * GC + i,
                ok ? xp + (static_cast<size_t>(t) * B + b) * G + q * H + unit
                   : xp,
                ok);
    }
    for (int i = tid; i < R * HS; i += kThreads) {
      const int r = i / HS, k = i - r * HS;
      const int b = b0 + r;
      const bool ok = has_prev && b < B && k < H;
      cp_async4(hpb + slot * R * HS + i,
                ok ? h + (static_cast<size_t>(tp) * B + b) * H + k : h, ok);
    }
    for (int i = tid; i < RU; i += kThreads) {
      const int r = i / U, unit = u0 + i - r * U;
      const int b = b0 + r;
      const bool ok = b < B && unit < H;
      cp_async4(dho + slot * RU + i,
                ok ? dh_out + (static_cast<size_t>(t) * B + b) * H + unit
                   : dh_out,
                ok);
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
    const int t = rev ? s : T - 1 - s;
    if (s + 1 < T)
      prefetch(s + 1);
    else
      cp_async_commit();
    cp_async_wait_prev();
    __syncthreads();
    const float* hprev = hpb + cur * R * HS;

    // a. hp recomputed from the saved h_prev, the weights from registers
    if (active) {
      const float* hk = hprev + ks * kSlice;
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
    __syncthreads();

    // b. the cell's reverse-mode maths, one (row, own unit) per thread
    const float* x = xs + cur * R * GC;
    const float* got = recv + (cur ^ 1) * C * RU;
    for (int i = tid; i < RU; i += kThreads) {
      const int r = i / U, u = i - r * U, unit = u0 + u;
      if (unit >= H) continue;
      float hsum[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const int j = q * U + u;
        float v = red[r * GC + j];
        for (int p = 1; p < L.ks; ++p) v += red[(p * R + r) * GC + j];
        hsum[q] = v;
      }
      const float* xr = x + r * GC;
      const float rg = sigmoidf(xr[u] + hsum[0]);
      const float zg = sigmoidf(xr[U + u] + hsum[1]);
      const float ng = tanhf(xr[2 * U + u] + rg * hsum[2]);
      float dh = dho[cur * RU + i] + hold[i];
      for (int p = 0; p < C; ++p) dh += got[p * RU + i];
      const bool m = mk[cur * R + r] > 0.f;
      const float h_prev = hprev[r * HS + unit];
      const float dpre_n = m ? dh * (1.f - zg) * (1.f - ng * ng) : 0.f;
      const float dpre_r = m ? dpre_n * hsum[2] * rg * (1.f - rg) : 0.f;
      const float dpre_z = m ? dh * (h_prev - ng) * zg * (1.f - zg) : 0.f;
      const float dhp_n = dpre_n * rg;
      float* dp = dhs + r * GCP + u;
      dp[0] = dpre_r;
      dp[U] = dpre_z;
      dp[2 * U] = dhp_n;
      const int b = b0 + r;
      if (b < B) {
        const size_t o = (static_cast<size_t>(t) * B + b) * G + unit;
        dxp[o] = dpre_r;
        dxp[o + H] = dpre_z;
        dxp[o + 2 * H] = dpre_n;
        dhp[o] = dpre_r;
        dhp[o + H] = dpre_z;
        dhp[o + 2 * H] = dhp_n;
      }
      // a held frame passes its h (and the cotangent) straight through
      hold[i] = m ? dh * zg : dh;
    }
    __syncthreads();

    // c. dhp[R, own columns] @ ws^T, each unit's part to its owner
    for (int j = tid; j < H; j += kThreads) {
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
      const float* wrow = ws + j * GCS;
#pragma unroll 2
      for (int k = 0; k < GCP; k += 4) {
        const float w0 = wrow[k], w1 = wrow[k + 1], w2 = wrow[k + 2],
                    w3 = wrow[k + 3];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 dv =
              *reinterpret_cast<const float4*>(dhs + r * GCP + k);
          acc[r] = fmaf(dv.x, w0, acc[r]);
          acc[r] = fmaf(dv.y, w1, acc[r]);
          acc[r] = fmaf(dv.z, w2, acc[r]);
          acc[r] = fmaf(dv.w, w3, acc[r]);
        }
      }
      const int owner = j / U;
      float* dst = cluster.map_shared_rank(recv + (cur * C + rank) * RU,
                                           owner);
#pragma unroll
      for (int r = 0; r < R; ++r) dst[r * U + j - owner * U] = acc[r];
    }
    // d.
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
      sizeof(float) * static_cast<size_t>(BwdLayout(H, U, R, C).total);
  cudaError_t err = cudaFuncSetAttribute(
      gru_bwd_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
  return cudaOccupancyMaxActiveClusters(max_clusters, gru_bwd_kernel<R>,
                                        cfg);
}

template <int R>
cudaError_t launch(const float* xp_f, const float* xp_b, const float* mask,
                   const float* wh_f, const float* wh_b, const float* h_f,
                   const float* h_b, const float* dh_f, const float* dh_b,
                   float* dxp_f, float* dhp_f, float* dxp_b, float* dhp_b,
                   int T, int B, int H, int ndir, int C, int U,
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
  err = cudaLaunchKernelEx(&cfg, gru_bwd_kernel<R>, xp_f, xp_b, mask, wh_f,
                           wh_b, h_f, h_b, dh_f, dh_b, dxp_f, dhp_f, dxp_b,
                           dhp_b, T, B, H, U);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid_geometry(int H, int ndir, int C, int U) {
  return ndir >= 1 && ndir <= 2 && C >= 1 && C <= kMaxCluster && U >= 1 &&
         3 * U * ((H + kSlice - 1) / kSlice) <= kThreads && C * U >= H &&
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

// Launch the backward over ndir directions: clusters of C CTAs of U units
// each, R (1, 2, 4 or 8) batch rows a cluster.
extern "C" int asr_gru_bwd(const float* xp_f, const float* xp_b,
                           const float* mask, const float* wh_f,
                           const float* wh_b, const float* h_f,
                           const float* h_b, const float* dh_f,
                           const float* dh_b, float* dxp_f, float* dhp_f,
                           float* dxp_b, float* dhp_b, int T, int B, int H,
                           int ndir, int C, int U, int R, void* stream) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_rows(R, [&](auto rows) {
    return launch<decltype(rows)::value>(
        xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, dh_f, dh_b, dxp_f, dhp_f,
        dxp_b, dhp_b, T, B, H, ndir, C, U, static_cast<cudaStream_t>(stream));
  }));
}

// The backward's dynamic shared memory per CTA and the clusters the card
// holds at once for that launch, without launching.
extern "C" int asr_gru_bwd_info(int B, int H, int ndir, int C, int U, int R,
                                int* smem_bytes, int* max_clusters) {
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
