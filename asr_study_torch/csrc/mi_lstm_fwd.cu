// The multiplicative-integration (MI) LSTM recurrence of one layer, forward
// pass, over one or two directions in one launch, with the recurrent
// weights resident in a thread-block cluster for the whole sequence.
//
// Replaces two TPU kernels: asr_study_tpu/ops/pallas_bi_mi_lstm.py
// `_bifwd_kernel` (both directions) with ndir = 2, and
// asr_study_tpu/ops/pallas_mi_lstm.py `_fwd_kernel` (one direction) with
// ndir = 1.  Cell maths: ops/pallas_mi_lstm.py `_mi_cell_math` and
// `_mi_pre`: the gate pre-activation is
//
//   pre = alpha * xp * hp + beta1 * xp + beta2 * hp + b,   hp = h_prev @ wh
//
// with xp = x @ wx the RAW input projection (the Hadamard term keeps the
// bias out of it), and alpha, beta1, beta2, b [4H] per direction.  Then the
// LSTM update, gate order i, f, g, o.
//
// Inputs: xp_f / xp_b [T, B, 4H], the mask [T, B], wh_* [H, 4H], alpha_*,
// beta1_*, beta2_*, b_* [4H].  Outputs h and c of each direction [T, B, H]
// in forward time order.  Lane 1 (the reverse direction) walks time
// backward: it reads xp_b and the mask at T-1-s.  Each lane starts from
// the carried state h_init / c_init [ndir, B, H] (lane d at row d * B), or
// from zeros where they are null (bilstm_fwd.cu says what the carry is
// for), and a frame whose mask is 0 keeps the previous h and c.  With
// ndir = 1 only lane 0 runs and the _b pointers are unused.
//
// What bounds it on the H100: as for the LSTM (bilstm_fwd.cu), a serial
// chain of [R, H] x [H, 4H] products whose weights (1 MB at H=256) do not
// fit in one SM; the MI terms are elementwise on a CTA's own columns.  So
// the design is bilstm_fwd.cu's: one cluster of C CTAs per (direction,
// group of R batch rows), grid (C, ceil(B/R), ndir); CTA k owns the U units
// [kU, kU + U) and all four gate columns of each, and holds wh[:, those
// columns] in the registers of its 256 threads, 128 rows of one column a
// thread, read from device memory once.  The column's four MI entries sit
// in shared memory for the whole walk.  A step:
//
//   1. hp[R, 4U] = h_prev[R, H] @ slice, h_prev broadcast from shared
//      memory as float4; the row slices' sums added in a fixed order, kept
//      apart from the raw xp;
//   2. xp[t] and the mask, fetched one step ahead by cp.async, and the MI
//      vectors form the pre-activations; the cell runs for the CTA's (row,
//      unit) pairs and writes h and c;
//   3. each h goes into every CTA's h_prev buffer for the next step through
//      distributed shared memory (cluster.map_shared_rank); the buffers
//      alternate on s & 1, so one cluster barrier a step suffices.
//
// The bfloat16-weight form (asr_mi_lstm_fwd_bf16; train --bf16, the JAX
// trainer's compute_dtype, under which the Pallas kernels run with a
// bfloat16 wh) is the same kernel on the weight type W = __nv_bfloat16, as
// bilstm_fwd.cu's: each thread holds its slice as 64 bfloat16 pairs, and h
// enters hp rounded to bfloat16 (ops/pallas_lstm.py `_mm`:
// h_prev.astype(wh.dtype)), the exchanged copy rounded by its writer,
// while the hold of a masked frame takes h_prev unrounded
// (`_mi_cell_math`), so the cell keeps its own units' h in a register.
// The products are float32 fmaf on the converted pairs, summed in the
// float32 form's order; xp, the mask, the MI vectors (float32 copies of
// the bfloat16 parameters), h and c stay float32.  Its shared memory is
// the float32 form's.
//
// The launcher checks with cudaOccupancyMaxActiveClusters that every
// cluster of the grid is resident at once and refuses the launch otherwise.
// ops/mi_lstm.py `mi_geometry` picks C, U and R, and sends the widths whose
// slice does not fit (H=300, H=512) to mi_lstm_stream_fwd.cu.

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
// ops/mi_lstm.py `mi_cluster_smem`.
struct FwdLayout {
  int ks, hs, hbuf, xs, mk, red, vec, cs, total;
  __host__ __device__ FwdLayout(int H, int U, int R) {
    const int gc = 4 * U;
    ks = (H + kSlice - 1) / kSlice;  // slices of the H reduction
    hs = ks * kSlice;             // h rows, zero-padded to whole slices
    hbuf = 0;                     // [2][R][hs]  h_prev, alternating
    xs = hbuf + 2 * R * hs;       // [2][R][gc]  xp of own columns
    mk = xs + 2 * R * gc;         // [2][R]      mask
    red = mk + round4(2 * R);     // [ks][R][gc] partial products
    vec = red + ks * R * gc;      // [4][gc]     alpha, beta1, beta2, b
    cs = vec + 4 * gc;            // [R][U]      c of own units
    total = cs + round4(R * U);
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
mi_lstm_fwd_kernel(const float* __restrict__ xp_f,
                   const float* __restrict__ xp_b,
                   const float* __restrict__ mask,
                   const W* __restrict__ wh_f,
                   const W* __restrict__ wh_b,
                   const float* __restrict__ al_f,
                   const float* __restrict__ al_b,
                   const float* __restrict__ b1_f,
                   const float* __restrict__ b1_b,
                   const float* __restrict__ b2_f,
                   const float* __restrict__ b2_b,
                   const float* __restrict__ bias_f,
                   const float* __restrict__ bias_b,
                   float* __restrict__ h_f, float* __restrict__ c_f,
                   float* __restrict__ h_b, float* __restrict__ c_b,
                   const float* __restrict__ h_init,
                   const float* __restrict__ c_init, int T, int B, int H,
                   int U) {
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
  float* vec = smem + L.vec;
  float* cs = smem + L.cs;
  const int G = 4 * H, GC = 4 * U, HS = L.hs;

  const bool rev = blockIdx.z == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
  const float* vsrc[4] = {rev ? al_b : al_f, rev ? b1_b : b1_f,
                          rev ? b2_b : b2_f, rev ? bias_b : bias_f};
  float* __restrict__ h_out = rev ? h_b : h_f;
  float* __restrict__ c_out = rev ? c_b : c_f;
  const int b0 = blockIdx.y * R;
  const int u0 = rank * U;
  const int tid = threadIdx.x;

  // the resident slice, in registers: thread (col, ks) holds
  // w[kk] = wh[ks*kSlice + kk][q*H + u0 + u] for col = q*U + u, zero past H
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
  // the MI vectors of own columns: vec[v][q*U + u] = vsrc[v][q*H + u0 + u]
  for (int i = tid; i < 4 * GC; i += kThreads) {
    const int v = i / GC, j = i - v * GC;
    const int q = j / U, unit = u0 + j - q * U;
    vec[i] = unit < H ? vsrc[v][q * H + unit] : 0.f;
  }
  // the carried state, zeros where none is given: the full h rows into
  // slot 0 of every CTA's h buffer (as product operands), the CTA's own
  // units' c into cs, and in the bfloat16 form their unrounded h into
  // h_own (its (row, unit) pair: R * U <= kThreads there)
  const size_t lane_row = static_cast<size_t>(blockIdx.z) * B;
  for (int i = tid; i < 2 * R * HS; i += kThreads) {
    const int r = i / HS, k = i - r * HS, b = b0 + r;
    hbuf[i] = (h_init != nullptr && r < R && b < B && k < H)
                  ? as_operand<W>(h_init[(lane_row + b) * H + k])
                  : 0.f;
  }
  float h_own = 0.f;
  for (int i = tid; i < R * U; i += kThreads) {
    const int r = i / U, unit = u0 + i - r * U, b = b0 + r;
    const bool given = b < B && unit < H;
    cs[i] = (c_init != nullptr && given) ? c_init[(lane_row + b) * H + unit]
                                         : 0.f;
    h_own = (h_init != nullptr && given) ? h_init[(lane_row + b) * H + unit]
                                         : 0.f;
  }

  // xp of own columns and the mask of step s, into slot s & 1
  auto prefetch = [&](int s) {
    const int t = rev ? T - 1 - s : s;
    float* xd = xs + (s & 1) * R * GC;
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
    cp_async_wait_prev();
    __syncthreads();

    // 2. the cell on own (row, unit) pairs; 3. h to every CTA's next buffer
    float* hn = hbuf + (cur ^ 1) * R * HS;
    const float* x = xs + cur * R * GC;
    for (int i = tid; i < R * U; i += kThreads) {
      const int r = i / U, u = i - r * U, unit = u0 + u;
      if (unit >= H) continue;
      float pre[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = q * U + u;
        const float xv = x[r * GC + j];
        float hpj = 0.f;
        for (int p = 0; p < L.ks; ++p) hpj += red[(p * R + r) * GC + j];
        pre[q] = vec[j] * xv * hpj + vec[GC + j] * xv +
                 vec[2 * GC + j] * hpj + vec[3 * GC + j];
      }
      const float ig = sigmoidf(pre[0]);
      const float fg = sigmoidf(pre[1]);
      const float gg = tanhf(pre[2]);
      const float og = sigmoidf(pre[3]);
      const float c_prev = cs[i];
      constexpr bool kRounded = std::is_same_v<W, __nv_bfloat16>;
      const float h_prev = kRounded ? h_own : hp[r * HS + unit];
      float c = fg * c_prev + ig * gg;
      float h = og * tanhf(c);
      if (!(mk[cur * R + r] > 0.f)) {
        c = c_prev;
        h = h_prev;
      }
      cs[i] = c;
      h_own = h;
      const int b = b0 + r;
      if (b < B) {
        const size_t o = (static_cast<size_t>(t) * B + b) * H + unit;
        h_out[o] = h;
        c_out[o] = c;
      }
      h = as_operand<W>(h);      // the exchanged copy: a product operand
      for (int p = 0; p < C; ++p)
        cluster.map_shared_rank(hn, p)[r * HS + unit] = h;
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
      sizeof(float) * static_cast<size_t>(FwdLayout(H, U, R).total);
  cudaError_t err = cudaFuncSetAttribute(
      mi_lstm_fwd_kernel<W, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
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
                                        mi_lstm_fwd_kernel<W, R>, cfg);
}

template <typename W, int R>
cudaError_t launch(const float* xp_f, const float* xp_b, const float* mask,
                   const W* wh_f, const W* wh_b, const float* al_f,
                   const float* al_b, const float* b1_f, const float* b1_b,
                   const float* b2_f, const float* b2_b,
                   const float* bias_f, const float* bias_b, float* h_f,
                   float* c_f, float* h_b, float* c_b, const float* h_init,
                   const float* c_init, int T, int B, int H, int ndir, int C,
                   int U, cudaStream_t stream) {
  // the bfloat16 form keeps a thread's one (row, unit) pair's h in a
  // register
  if (std::is_same_v<W, __nv_bfloat16> && R * U > kThreads)
    return cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  cudaError_t err = configure<W, R>(B, H, ndir, C, U, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  // all clusters in one wave, or no launch
  if (fit < static_cast<int>(cfg.gridDim.y * cfg.gridDim.z))
    return cudaErrorCooperativeLaunchTooLarge;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, mi_lstm_fwd_kernel<W, R>, xp_f, xp_b, mask,
                           wh_f, wh_b, al_f, al_b, b1_f, b1_b, b2_f, b2_b,
                           bias_f, bias_b, h_f, c_f, h_b, c_b, h_init, c_init,
                           T, B, H, U);
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
                const W* wh_f, const W* wh_b, const float* al_f,
                const float* al_b, const float* b1_f, const float* b1_b,
                const float* b2_f, const float* b2_b, const float* bias_f,
                const float* bias_b, float* h_f, float* c_f, float* h_b,
                float* c_b, const float* h_init, const float* c_init, int T,
                int B, int H, int ndir, int C, int U, int R, void* stream) {
  if (!valid_geometry(H, ndir, C, U))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_rows(R, [&](auto rows) {
    return launch<W, decltype(rows)::value>(
        xp_f, xp_b, mask, wh_f, wh_b, al_f, al_b, b1_f, b1_b, b2_f, b2_b,
        bias_f, bias_b, h_f, c_f, h_b, c_b, h_init, c_init, T, B, H, ndir, C,
        U, static_cast<cudaStream_t>(stream));
  }));
}

}  // namespace

// Launch the forward over ndir directions: clusters of C CTAs of U units
// each, R (1, 2, 4 or 8) batch rows a cluster.  h_init / c_init: the state
// each lane starts from, [ndir, B, H], or null for zeros.
extern "C" int asr_mi_lstm_fwd(const float* xp_f, const float* xp_b,
                               const float* mask, const float* wh_f,
                               const float* wh_b, const float* al_f,
                               const float* al_b, const float* b1_f,
                               const float* b1_b, const float* b2_f,
                               const float* b2_b, const float* bias_f,
                               const float* bias_b, float* h_f, float* c_f,
                               float* h_b, float* c_b, const float* h_init,
                               const float* c_init, int T, int B, int H,
                               int ndir, int C, int U, int R, void* stream) {
  return launch_form<float>(xp_f, xp_b, mask, wh_f, wh_b, al_f, al_b, b1_f,
                            b1_b, b2_f, b2_b, bias_f, bias_b, h_f, c_f, h_b,
                            c_b, h_init, c_init, T, B, H, ndir, C, U, R,
                            stream);
}

// The bfloat16-weight form: asr_mi_lstm_fwd's arguments with wh_f / wh_b
// bfloat16 [H, 4H].
extern "C" int asr_mi_lstm_fwd_bf16(
    const float* xp_f, const float* xp_b, const float* mask,
    const __nv_bfloat16* wh_f, const __nv_bfloat16* wh_b, const float* al_f,
    const float* al_b, const float* b1_f, const float* b1_b,
    const float* b2_f, const float* b2_b, const float* bias_f,
    const float* bias_b, float* h_f, float* c_f, float* h_b, float* c_b,
    const float* h_init, const float* c_init, int T, int B, int H, int ndir,
    int C, int U, int R, void* stream) {
  return launch_form<__nv_bfloat16>(
      xp_f, xp_b, mask, wh_f, wh_b, al_f, al_b, b1_f, b1_b, b2_f, b2_b,
      bias_f, bias_b, h_f, c_f, h_b, c_b, h_init, c_init, T, B, H, ndir, C,
      U, R, stream);
}

// The forward's dynamic shared memory per CTA and the clusters the card
// holds at once for that launch, without launching.
extern "C" int asr_mi_lstm_fwd_info(int B, int H, int ndir, int C, int U,
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
