// The zoneout-LSTM recurrence of one layer, backward pass, over one or two
// directions in one launch: the cotangent scans that give the gate
// pre-activation gradients dxp, with the recurrent weights resident in a
// thread-block cluster for the whole sequence.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_zoneout_lstm.py
// `_bibwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_zoneout_lstm.py `_bwd_kernel` (one direction)
// with ndir = 1.  Row maths: ops/pallas_zoneout_lstm.py `_zo_row_bwd`.  The
// stored h and c are the MIXED states, so the cell's own c_new = f * c_prev
// + i * g is recomputed from the gates and the stored c_prev, and
// tanh(c_new) (not tanh of the stored c) feeds the output gate.  On a real
// frame, with dh = dh_out + the carried cotangent:
//
//   dc_new  = dc_next * zc + dh * zh * o * (1 - tanh(c_new)^2)
//   dpre    = the LSTM's gate cotangents from dc_new and dh * zh
//   dh_prev = dpre @ wh^T + dh * (1 - zh)
//   dc_prev = dc_new * f + dc_next * (1 - zc)
//
// and a held frame (mask 0) has dpre = 0 and passes dh and dc_next straight
// on.  zh and zc [T, B, H] of each direction are in forward time order, as
// the forward kernel read them.  With ndir = 1 only lane 0 (the forward
// direction) runs and the _b pointers are unused.
//
// Inputs: the forward's arguments (xp_f / xp_b [T, B, 4H], the mask [T, B],
// zh_* and zc_*, wh_* [H, 4H]), the forward's h and c of each direction
// [T, B, H], and the cotangents of the h outputs dh_f / dh_b [T, B, H].
// Output dxp_f / dxp_b [T, B, 4H], zero on masked frames.  dwh = h_prev^T
// dxp is one matmul per direction outside the kernel.  The forward
// direction's chain runs t = T-1 .. 0, the reversed direction's t = 0 ..
// T-1; h_prev and c_prev are the saved sequences at t-1 (forward) or t+1
// (reversed), zero past the ends.  c is read at t_prev only.
//
// What bounds it on the H100: the chain is serial in time, with two [R, H]
// x [H, 4H]-sized products a step through wh: the recomputed gates and the
// recurrent cotangent dpre @ wh^T.  Both read one slice held on chip for
// the whole sequence, where zoneout_lstm_stream_bwd.cu reads wh and a
// transposed copy from L2 every step.  The mix's terms are elementwise on a
// CTA's own units, so the design is bilstm_bwd.cu's, with one cluster
// barrier a step: one cluster of C CTAs per (direction, group of R batch
// rows), CTA k owning the U units [kU, kU + U) with their four gate
// columns.  Its slice wh[:, own columns] is held twice, in the registers of
// its threads as in the forward, for step a, and in shared memory as ws
// [H][4U + 1], for step c, whose thread j reads row j: the odd row stride
// keeps those reads free of bank conflicts.  A step:
//
//   a. gates[R, 4U] = xp[t] + h[t_prev] @ slice from the saved h, which
//      needs no exchange (h, c_prev, dh_out, zh, zc, xp and the mask of the
//      next step are fetched by cp.async while this one runs);
//   b. the cell's reverse maths for own units: dh = dh_out[t] + hold + the
//      C partial sums of the recurrent cotangent received last step, added
//      in rank order; dpre goes to dxp[t] and to shared memory; the
//      owner-local dh * (1 - zh) and dc_next * (1 - zc) are carried;
//   c. partial[R, H] = dpre[R, own columns] @ ws^T, thread j taking unit j,
//      dpre broadcast as float4; each unit's part sent to the CTA that owns
//      it (its slot for this sender, alternating on s & 1);
//   d. one cluster barrier.
//
// The bfloat16-weight form (asr_zoneout_lstm_bwd_bf16) is the same kernel
// on the weight type W = __nv_bfloat16 (ops/pallas_zoneout_lstm.py
// `_zo_row_bwd` with a bfloat16 wh), as bilstm_bwd.cu's: the slice is held
// as bfloat16 in the registers (64 pairs a thread) and in ws ([H][4U + 2]
// bfloat16, whose odd row stride in words keeps step c's pair reads free of
// bank conflicts); the saved h_prev is rounded to bfloat16 in shared memory
// by the thread whose cp.async fetched it, so step a recomputes the
// forward's gates from the forward's operands.  That slot is this CTA's
// own (no peer reads it: the exchange carries only step c's partials) and
// step a is its only reader (the backward takes h_prev nowhere but in the
// product), so no unrounded copy is kept.  dpre is rounded to bfloat16
// before step c (`_mm(dpre, wht)`), while dxp is written unrounded.
// Products are float32 fmaf on the converted values in the float32 form's
// order.
//
// The fixed order of every sum keeps the backward, and so the train steps,
// bit-reproducible.  The launcher refuses a grid whose clusters are not all
// resident at once (cudaOccupancyMaxActiveClusters); ops/zoneout_lstm.py
// `zoneout_geometry` picks C, U and R and sends the widths whose slice does
// not fit (H=300, H=512) to zoneout_lstm_stream_bwd.cu.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kSlice = 128;      // k rows of the weights a thread holds
constexpr int kMaxCluster = 8;   // the portable cluster size

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Offsets (in floats) of the dynamic shared memory of one CTA; mirrored by
// ops/zoneout_lstm.py `zoneout_cluster_smem` for the float32 form.  ws
// holds `half` (bfloat16) weights in the bfloat16 form, in rows of gcs
// elements.
struct BwdLayout {
  int hp, gcs, ks, hs, ws, hpb, xs, cp, dho, zh, zc, mk, red, dpre, recv,
      hold, dcs, total;
  __host__ __device__ BwdLayout(int H, int U, int R, int C, bool half) {
    const int gc = 4 * U;
    hp = round4(H);
    gcs = half ? gc + 2 : gc + 1;    // an odd number of words a row
    ks = (H + kSlice - 1) / kSlice;  // slices of the H reduction
    hs = ks * kSlice;                // h rows, zero-padded to whole slices
    ws = 0;                          // [hp][gcs]   wh[:, own columns]
    hpb = ws + round4(half ? hp * gcs / 2 : hp * gcs);
    //                                  [2][R][hs]  saved h at t_prev
    xs = hpb + 2 * R * hs;           // [2][R][gc]  xp of own columns
    cp = xs + 2 * R * gc;            // [2][R][U]   c at t_prev, own units
    dho = cp + round4(2 * R * U);    // [2][R][U]   dh_out at t
    zh = dho + round4(2 * R * U);    // [2][R][U]   zh at t
    zc = zh + round4(2 * R * U);     // [2][R][U]   zc at t
    mk = zc + round4(2 * R * U);     // [2][R]      mask
    red = mk + round4(2 * R);        // [ks][R][gc] partial gate products
    dpre = red + ks * R * gc;        // [R][gc]     dpre of own columns
    recv = dpre + R * gc;            // [2][C][R][U] received partials
    hold = recv + round4(2 * C * R * U);  // [R][U] dh carried past the cell
    dcs = hold + round4(R * U);      // [R][U]      dc_next
    total = dcs + round4(R * U);
  }
};

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.f / (1.f + expf(-x));
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
zoneout_lstm_bwd_kernel(const float* __restrict__ xp_f,
                        const float* __restrict__ xp_b,
                        const float* __restrict__ mask,
                        const float* __restrict__ zh_f,
                        const float* __restrict__ zh_b,
                        const float* __restrict__ zc_f,
                        const float* __restrict__ zc_b,
                        const W* __restrict__ wh_f,
                        const W* __restrict__ wh_b,
                        const float* __restrict__ h_f,
                        const float* __restrict__ c_f,
                        const float* __restrict__ h_b,
                        const float* __restrict__ c_b,
                        const float* __restrict__ dh_f,
                        const float* __restrict__ dh_b,
                        float* __restrict__ dxp_f, float* __restrict__ dxp_b,
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
  float* cps = smem + L.cp;
  float* dho = smem + L.dho;
  float* zhs = smem + L.zh;
  float* zcs = smem + L.zc;
  float* mk = smem + L.mk;
  float* red = smem + L.red;
  float* dpre = smem + L.dpre;
  float* recv = smem + L.recv;
  float* hold = smem + L.hold;
  float* dcs = smem + L.dcs;
  const int G = 4 * H, GC = 4 * U, HP = L.hp, GCS = L.gcs, HS = L.hs;
  const int RU = R * U;

  const bool rev = blockIdx.z == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const float* __restrict__ zh = rev ? zh_b : zh_f;
  const float* __restrict__ zc = rev ? zc_b : zc_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
  const float* __restrict__ h = rev ? h_b : h_f;
  const float* __restrict__ c = rev ? c_b : c_f;
  const float* __restrict__ dh_out = rev ? dh_b : dh_f;
  float* __restrict__ dxp = rev ? dxp_b : dxp_f;
  const int b0 = blockIdx.y * R;
  const int u0 = rank * U;
  const int step_dir = rev ? 1 : -1;       // t_prev = t + step_dir
  const int tid = threadIdx.x;

  // the resident slice twice: in shared memory, ws[k][q*U + u] =
  // wh[k][q*H + u0 + u], for step c's row reads; in registers, thread
  // (col, ks) holding w[kk] = ws[ks*kSlice + kk][col], for step a
  for (int i = tid; i < HP * GC; i += kThreads) {
    const int k = i / GC, col = i - k * GC;
    const int q = col / U, unit = u0 + col - q * U;
    ws[k * GCS + col] =
        (k < H && unit < H) ? wh[static_cast<size_t>(k) * G + q * H + unit]
                            : W{};
  }
  const int col = tid % GC, ks = tid / GC;
  const bool active = ks < L.ks;
  Slice<W> w;
  {
    const int q = col / U, unit = u0 + col - q * U;
    auto at = [&](int kk) {
      const int k = ks * kSlice + kk;
      return (active && k < H && unit < H)
                 ? wh[static_cast<size_t>(k) * G + q * H + unit]
                 : W{};
    };
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 2) w.set2(kk, at(kk), at(kk + 1));
  }
  for (int i = tid; i < R * GC; i += kThreads) dpre[i] = 0.f;
  for (int i = tid; i < 2 * C * RU; i += kThreads) recv[i] = 0.f;
  for (int i = tid; i < RU; i += kThreads) {
    hold[i] = 0.f;
    dcs[i] = 0.f;
  }

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
      const size_t o = (static_cast<size_t>(t) * B + b) * H + unit;
      cp_async4(dho + slot * RU + i, ok ? dh_out + o : dh_out, ok);
      cp_async4(zhs + slot * RU + i, ok ? zh + o : zh, ok);
      cp_async4(zcs + slot * RU + i, ok ? zc + o : zc, ok);
      const bool okp = ok && has_prev;
      cp_async4(cps + slot * RU + i,
                okp ? c + (static_cast<size_t>(tp) * B + b) * H + unit : c,
                okp);
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
    if constexpr (kRounded) {
      // h_prev as the forward's product took it, each element rounded by
      // the thread whose copy brought it (prefetch's mapping)
      float* hr = hpb + cur * R * HS;
      for (int i = tid; i < R * HS; i += kThreads)
        hr[i] = as_operand<W>(hr[i]);
    }
    __syncthreads();

    // a. the gates, recomputed from the saved h_prev, the weights from
    // registers
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

    // b. the zoneout cell's reverse-mode maths, one (row, own unit) per
    // thread
    const float* x = xs + cur * R * GC;
    const float* got = recv + (cur ^ 1) * C * RU;
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
      float dh = dho[cur * RU + i] + hold[i];
      for (int p = 0; p < C; ++p) dh += got[p * RU + i];
      const float c_prev = cps[cur * RU + i];
      const float tc = tanhf(fg * c_prev + ig * gg);     // tanh(c_new)
      const float mh = zhs[cur * RU + i];
      const float mc = zcs[cur * RU + i];
      const float dh_new = dh * mh;
      const float dc_next = dcs[i];
      const float dc = dc_next * mc + dh_new * og * (1.f - tc * tc);
      const bool m = mk[cur * R + r] > 0.f;
      const float p_i = m ? dc * gg * ig * (1.f - ig) : 0.f;
      const float p_f = m ? dc * c_prev * fg * (1.f - fg) : 0.f;
      const float p_g = m ? dc * ig * (1.f - gg * gg) : 0.f;
      const float p_o = m ? dh_new * tc * og * (1.f - og) : 0.f;
      // step c's operands (rounded in the bfloat16 form); dxp unrounded
      float* dp = dpre + r * GC + u;
      dp[0] = as_operand<W>(p_i);
      dp[U] = as_operand<W>(p_f);
      dp[2 * U] = as_operand<W>(p_g);
      dp[3 * U] = as_operand<W>(p_o);
      const int b = b0 + r;
      if (b < B) {
        float* out = dxp + (static_cast<size_t>(t) * B + b) * G + unit;
        out[0] = p_i;
        out[H] = p_f;
        out[2 * H] = p_g;
        out[3 * H] = p_o;
      }
      // a real frame passes dh * (1 - zh) and dc_next * (1 - zc) past the
      // cell; a held frame passes dh and dc_next whole
      hold[i] = m ? dh * (1.f - mh) : dh;
      if (m) dcs[i] = dc * fg + dc_next * (1.f - mc);
    }
    __syncthreads();

    // c. dpre[R, own columns] @ ws^T, each unit's part to its owner
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
              *reinterpret_cast<const float4*>(dpre + r * GC + k);
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
    // d.
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
      zoneout_lstm_bwd_kernel<W, R>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
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
                                        zoneout_lstm_bwd_kernel<W, R>, cfg);
}

template <typename W, int R>
cudaError_t launch(const float* xp_f, const float* xp_b, const float* mask,
                   const float* zh_f, const float* zh_b, const float* zc_f,
                   const float* zc_b, const W* wh_f, const W* wh_b,
                   const float* h_f, const float* c_f, const float* h_b,
                   const float* c_b, const float* dh_f, const float* dh_b,
                   float* dxp_f, float* dxp_b, int T, int B, int H, int ndir,
                   int C, int U, cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  cudaError_t err = configure<W, R>(B, H, ndir, C, U, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  // all clusters in one wave, or no launch
  if (fit < static_cast<int>(cfg.gridDim.y * cfg.gridDim.z))
    return cudaErrorCooperativeLaunchTooLarge;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, zoneout_lstm_bwd_kernel<W, R>, xp_f, xp_b,
                           mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, h_f,
                           c_f, h_b, c_b, dh_f, dh_b, dxp_f, dxp_b, T, B, H,
                           U);
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

template <typename W>
int launch_form(const float* xp_f, const float* xp_b, const float* mask,
                const float* zh_f, const float* zh_b, const float* zc_f,
                const float* zc_b, const W* wh_f, const W* wh_b,
                const float* h_f, const float* c_f, const float* h_b,
                const float* c_b, const float* dh_f, const float* dh_b,
                float* dxp_f, float* dxp_b, int T, int B, int H, int ndir,
                int C, int U, int R, void* stream) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_rows(R, [&](auto rows) {
    return launch<W, decltype(rows)::value>(
        xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f, wh_b, h_f, c_f, h_b,
        c_b, dh_f, dh_b, dxp_f, dxp_b, T, B, H, ndir, C, U,
        static_cast<cudaStream_t>(stream));
  }));
}

}  // namespace

// Launch the backward over ndir directions: clusters of C CTAs of U units
// each, R (1, 2, 4 or 8) batch rows a cluster.
extern "C" int asr_zoneout_lstm_bwd(
    const float* xp_f, const float* xp_b, const float* mask,
    const float* zh_f, const float* zh_b, const float* zc_f,
    const float* zc_b, const float* wh_f, const float* wh_b,
    const float* h_f, const float* c_f, const float* h_b, const float* c_b,
    const float* dh_f, const float* dh_b, float* dxp_f, float* dxp_b, int T,
    int B, int H, int ndir, int C, int U, int R, void* stream) {
  return launch_form<float>(xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b, wh_f,
                            wh_b, h_f, c_f, h_b, c_b, dh_f, dh_b, dxp_f,
                            dxp_b, T, B, H, ndir, C, U, R, stream);
}

// The bfloat16-weight form: asr_zoneout_lstm_bwd's arguments with wh_f /
// wh_b bfloat16 [H, 4H].
extern "C" int asr_zoneout_lstm_bwd_bf16(
    const float* xp_f, const float* xp_b, const float* mask,
    const float* zh_f, const float* zh_b, const float* zc_f,
    const float* zc_b, const __nv_bfloat16* wh_f, const __nv_bfloat16* wh_b,
    const float* h_f, const float* c_f, const float* h_b, const float* c_b,
    const float* dh_f, const float* dh_b, float* dxp_f, float* dxp_b, int T,
    int B, int H, int ndir, int C, int U, int R, void* stream) {
  return launch_form<__nv_bfloat16>(xp_f, xp_b, mask, zh_f, zh_b, zc_f, zc_b,
                                    wh_f, wh_b, h_f, c_f, h_b, c_b, dh_f,
                                    dh_b, dxp_f, dxp_b, T, B, H, ndir, C, U,
                                    R, stream);
}

// The backward's dynamic shared memory per CTA and the clusters the card
// holds at once for that launch, without launching.
extern "C" int asr_zoneout_lstm_bwd_info(int B, int H, int ndir, int C,
                                         int U, int R, int* smem_bytes,
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
