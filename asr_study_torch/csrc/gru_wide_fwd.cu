// The GRU recurrence of one layer, forward pass, over one or two directions
// in one launch, for the widths 256 < H <= 512 (deep_gru at 512 units):
// the recurrent weights resident in a non-portable thread-block cluster of
// up to 16 CTAs for the whole sequence.
//
// Replaces two TPU kernels at those widths: asr_study_tpu/ops/
// pallas_bigru.py `_bifwd_kernel` (both directions, row maths
// `_gru_row_fwd`) with ndir = 2, and asr_study_tpu/ops/pallas_gru.py
// `_fwd_kernel` (one direction) with ndir = 1.  Gate maths:
// ops/pallas_gru.py `_gru_gates`.
//
// Inputs and outputs are gru_fwd.cu's: xp_f / xp_b [T, B, 3H] (x @ wx + b,
// every bias folded in; gate order r, z, n), the mask [T, B], wh_f / wh_b
// [H, 3H] -> h of each direction [T, B, H] in forward time order, lane 1
// walking time backward, held frames repeating the previous h, each lane
// starting from the carried h_init [ndir, B, H] or, where it is null, from
// zeros (gru_fwd.cu says what the carry is for).
//
//   r = sigmoid(xr + hr),  z = sigmoid(xz + hz),  n = tanh(xn + r * hn),
//   h = (1 - z) * n + z * h_prev,   where [hr, hz, hn] = h_prev @ wh.
//
// When training, the caller also passes hg_f / hg_b [T, B, 3H] and the
// kernel writes there the h side of every frame's pre-activations, [hr, hz,
// hn] = h_prev @ wh, exactly as the cell used them; the backward
// (gru_wide_bwd.cu) reads them in place of recomputing the product.  The
// h side and not the activated [r, z, n]: hn is needed apart from xn (dr =
// dpre_n * hn), so activated gates alone would not do, and [hr, hz, hn]
// with xp gives r, z and n back with the forward's own arithmetic.  For
// serving both are null and nothing more is written.
//
// What bounds it on the H100: one direction's wh at H=512 is 3 MiB, and a
// step is a [R, 512] x [512, 1536] product.  Streamed from L2 every step
// through one SM (gru_stream_fwd.cu) it costs 67 us a step.  Split over the
// portable 8 CTAs, a CTA's slice (192 columns x 512 rows, 384 KiB) fits
// neither its registers nor its shared memory.  So the cluster here has
// C = ceil(H / 32) CTAs (16 at H=512, past the portable 8:
// cudaFuncAttributeNonPortableClusterSizeAllowed), and CTA k owns the 32
// units [32k, 32k + 32) with their r, z, n columns: 96 columns x 512 rows
// = 192 KiB.
//
// The layout of a CTA: kSplit x 96 threads, thread (col, part), col = tid %
// 96, part = tid / 96.  Two thread shapes, by kSplit:
//
//   kSplit = 4 (384 threads): registers w[128] = wh[128 part + kk][col], the
//              whole slice in registers (49,152 of the SM's 65,536);
//   kSplit = 2 (192 threads): registers w[128] = rows 0..255 of the slice,
//              ws [256][96] fp32 = rows 256..511, ws[128 part + kk][col]: a
//              warp reads 32 consecutive columns of one row, free of bank
//              conflicts; 98,304 B;
//
// and in both
//
//   hbuf       [2][R][512] h_prev, alternating on s & 1 (one cluster
//              barrier a step), rows past H zero;
//   xs, mk     [2][R][96] xp of own columns and [2][R] the mask, fetched a
//              step ahead by cp.async;
//   red        [kSplit][R][96] the parts' partial sums.
//
// The faster shape is the one built: kSplit = 2, 9.66 ms against 11.67 ms
// for both directions at T=805, B=32 (lstm_step_split.py `split4`; at 384
// threads ptxas caps a thread at 168 registers and spills; PERF.md).
// ops/gru.py `gru_wide_smem` mirrors its shared memory: 188,544 B at R=16.
// A step:
//
//   1. hg[R, 96] = h_prev[R, 512] @ slice: thread (col, part) sums its rows
//      from its registers (and, at kSplit = 2, from ws) into one
//      accumulator a row, h broadcast as float4;
//   2. the cell, thread i < 8R owning row i / 8 and the four units 4 (i %
//      8) .. +3: hg = red[0] + ... + red[kSplit - 1], in that order; r, z,
//      n and h; h (and hg) to device memory;
//   3. its four h as one float4 into every CTA's next h buffer through
//      distributed shared memory; one cluster barrier.
//
// The bfloat16-weight form (asr_gru_wide_fwd_bf16) is the same kernel on
// the weight type W = __nv_bfloat16: the slice's rows are held as bfloat16
// in the registers (64 pairs a thread) and in ws ([256][96] bfloat16,
// 49,152 B), h enters the product rounded to bfloat16 (ops/pallas_gru.py
// `_mm`), the exchanged copy rounded by its writer while the cell thread
// keeps its units' h unrounded for z * h_prev and the hold, and the
// products are float32 fmaf on the converted values in the float32 form's
// order.  h and the h side hg written out stay float32 (hg is then
// bf16(h_prev) @ wh, what the backward would recompute).
//
// The launcher refuses a grid whose clusters are not all resident at once
// (cudaOccupancyMaxActiveClusters); ops/gru.py `gru_geometry` picks R and
// sends this width range here.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

namespace cg = cooperative_groups;

namespace {

constexpr int kSplit = 2;            // threads a column: the thread shape
constexpr int kUnits = 32;           // hidden units a CTA owns
constexpr int kCols = 3 * kUnits;    // their gate columns
constexpr int kThreads = kSplit * kCols;
constexpr int kSlice = 128;          // rows of a column in registers
constexpr int kRows = 4 * kSlice;    // rows of the slice: the widest H
constexpr int kShared = kRows - kSplit * kSlice;  // rows of the slice in ws
constexpr int kPerShared = kShared / kSplit;      // ws rows a thread sums
constexpr int kQuads = kUnits / 4;   // cell threads a batch row
constexpr int kMaxCluster = 16;      // Hopper's non-portable maximum

__host__ __device__ constexpr int round4(int n) { return (n + 3) & ~3; }

// Offsets (in floats) of the dynamic shared memory of one CTA; mirrored by
// ops/gru.py `gru_wide_smem` for the float32 form (ws holds `half`, i.e.
// bfloat16, weights in the bfloat16 form).
struct FwdLayout {
  int ws, hbuf, xs, mk, red, total;
  __host__ __device__ FwdLayout(int R, bool half) {
    ws = 0;                          // [kShared][kCols] rows 256..511
    hbuf = ws + (half ? kShared * kCols / 2 : kShared * kCols);
    //                                  [2][R][kRows]  h_prev, alternating
    xs = hbuf + 2 * R * kRows;       // [2][R][kCols]  xp of own columns
    mk = xs + 2 * R * kCols;         // [2][R]         mask
    red = mk + round4(2 * R);        // [kSplit][R][kCols] partial products
    total = red + kSplit * R * kCols;
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
gru_wide_fwd_kernel(const float* __restrict__ xp_f,
                    const float* __restrict__ xp_b,
                    const float* __restrict__ mask,
                    const W* __restrict__ wh_f,
                    const W* __restrict__ wh_b, float* __restrict__ h_f,
                    float* __restrict__ h_b, float* __restrict__ hg_f,
                    float* __restrict__ hg_b,
                    const float* __restrict__ h_init, int T, int B, int H) {
  cg::cluster_group cluster = cg::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  constexpr bool kRounded = std::is_same_v<W, __nv_bfloat16>;
  const FwdLayout L(R, kRounded);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  W* ws = reinterpret_cast<W*>(smem + L.ws);
  float* hbuf = smem + L.hbuf;
  float* xs = smem + L.xs;
  float* mk = smem + L.mk;
  float* red = smem + L.red;
  const int G = 3 * H;

  const bool rev = blockIdx.z == 1;
  const float* __restrict__ xp = rev ? xp_b : xp_f;
  const W* __restrict__ wh = rev ? wh_b : wh_f;
  float* __restrict__ h_out = rev ? h_b : h_f;
  float* __restrict__ hg_out = rev ? hg_b : hg_f;
  const int b0 = blockIdx.y * R;
  const int u0 = rank * kUnits;
  const int tid = threadIdx.x;

  // the resident slice: thread (col, part) holds rows [128 part, +128) of
  // column col in registers and writes rows [kSplit * 128 + kPerShared
  // part, +kPerShared) of it into ws; col = q * kUnits + u is wh's column
  // q * H + u0 + u, zero past H
  const int col = tid % kCols, part = tid / kCols;
  const int q_col = col / kUnits, unit_col = u0 + col % kUnits;
  const W* __restrict__ wcol = wh + q_col * H + unit_col;
  const bool live = unit_col < H;
  Slice<W> w;
  {
    auto at = [&](int kk) {
      const int k = part * kSlice + kk;
      return (live && k < H) ? wcol[static_cast<size_t>(k) * G] : W{};
    };
#pragma unroll
    for (int kk = 0; kk < kSlice; kk += 2) w.set2(kk, at(kk), at(kk + 1));
  }
  for (int kk = 0; kk < kPerShared; ++kk) {
    const int k = kSplit * kSlice + part * kPerShared + kk;
    ws[(part * kPerShared + kk) * kCols + col] =
        (live && k < H) ? wcol[static_cast<size_t>(k) * G] : W{};
  }
  // the carried h, zeros where none is given: the full rows into slot 0,
  // as product operands
  const size_t lane_row = static_cast<size_t>(blockIdx.z) * B;
  for (int i = tid; i < 2 * R * kRows; i += kThreads) {
    const int r = i / kRows, k = i - r * kRows, b = b0 + r;
    hbuf[i] = (h_init != nullptr && r < R && b < B && k < H)
                  ? as_operand<W>(h_init[(lane_row + b) * H + k])
                  : 0.f;
  }

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

  // the cell's (row, four units) of this thread, and in the bfloat16 form
  // their unrounded h, carried in or zeros
  const bool cell = tid < R * kQuads;
  const int cr = tid / kQuads, cu = 4 * (tid % kQuads);
  float hst[4];
#pragma unroll
  for (int uu = 0; uu < 4; ++uu) {
    const int unit = u0 + cu + uu, b = b0 + cr;
    hst[uu] = (h_init != nullptr && cell && b < B && unit < H)
                  ? h_init[(lane_row + b) * H + unit]
                  : 0.f;
  }

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

    // 1. h_prev @ slice: the register rows, then the shared-memory ones
    {
      const float* h0 = hp + part * kSlice;
      const float* h1 = hp + kSplit * kSlice + part * kPerShared;
      const W* wsc = ws + part * kPerShared * kCols + col;
      float acc[R];
#pragma unroll
      for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kSlice; kk += 4) {
        const float4 wv = w.quad(kk);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv =
              *reinterpret_cast<const float4*>(h0 + r * kRows + kk);
          acc[r] = fmaf(hv.x, wv.x, acc[r]);
          acc[r] = fmaf(hv.y, wv.y, acc[r]);
          acc[r] = fmaf(hv.z, wv.z, acc[r]);
          acc[r] = fmaf(hv.w, wv.w, acc[r]);
        }
      }
#pragma unroll 4
      for (int kk = 0; kk < kPerShared; kk += 4) {
        const float w0 = to_float(wsc[kk * kCols]),
                    w1 = to_float(wsc[(kk + 1) * kCols]),
                    w2 = to_float(wsc[(kk + 2) * kCols]),
                    w3 = to_float(wsc[(kk + 3) * kCols]);
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
      for (int r = 0; r < R; ++r) red[(part * R + r) * kCols + col] = acc[r];
    }
    cp_async_wait_prev();
    __syncthreads();

    // 2. the cell on own (row, four units); 3. h to every CTA's next buffer
    if (cell) {
      const float* x = xs + (cur * R + cr) * kCols + cu;
      float xq[3][4], hq[3][4];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        const float4 xv = *reinterpret_cast<const float4*>(x + q * kUnits);
        float4 a = *reinterpret_cast<const float4*>(red + cr * kCols + cu +
                                                    q * kUnits);
#pragma unroll
        for (int p = 1; p < kSplit; ++p) {
          const float4 b = *reinterpret_cast<const float4*>(
              red + (p * R + cr) * kCols + cu + q * kUnits);
          a.x += b.x;
          a.y += b.y;
          a.z += b.z;
          a.w += b.w;
        }
        xq[q][0] = xv.x;
        xq[q][1] = xv.y;
        xq[q][2] = xv.z;
        xq[q][3] = xv.w;
        hq[q][0] = a.x;
        hq[q][1] = a.y;
        hq[q][2] = a.z;
        hq[q][3] = a.w;
      }
      const bool m = mk[cur * R + cr] > 0.f;
      const int b = b0 + cr;
      float hv[4];
#pragma unroll
      for (int uu = 0; uu < 4; ++uu) {
        const int unit = u0 + cu + uu;
        const float h_prev = kRounded ? hst[uu] : hp[cr * kRows + unit];
        const float rg = sigmoidf(xq[0][uu] + hq[0][uu]);
        const float zg = sigmoidf(xq[1][uu] + hq[1][uu]);
        const float ng = tanhf(xq[2][uu] + rg * hq[2][uu]);
        float h = (1.f - zg) * ng + zg * h_prev;
        if (!m) h = h_prev;
        const bool valid = unit < H;
        hst[uu] = valid ? h : 0.f;
        hv[uu] = valid ? as_operand<W>(h) : 0.f;
        if (valid && b < B) {
          const size_t o = static_cast<size_t>(t) * B + b;
          h_out[o * H + unit] = h;
          if (hg_out != nullptr) {
            float* g = hg_out + o * G + unit;
            g[0] = hq[0][uu];
            g[H] = hq[1][uu];
            g[2 * H] = hq[2][uu];
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
template <typename W, int R>
cudaError_t configure(int B, int ndir, int C, cudaLaunchConfig_t* cfg,
                      cudaLaunchAttribute* attr, int* max_clusters) {
  const size_t smem =
      sizeof(float) *
      static_cast<size_t>(
          FwdLayout(R, std::is_same_v<W, __nv_bfloat16>).total);
  cudaError_t err = cudaFuncSetAttribute(
      gru_wide_fwd_kernel<W, R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(gru_wide_fwd_kernel<W, R>,
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
                                        gru_wide_fwd_kernel<W, R>, cfg);
}

template <typename W, int R>
cudaError_t launch(const float* xp_f, const float* xp_b, const float* mask,
                   const W* wh_f, const W* wh_b, float* h_f,
                   float* h_b, float* hg_f, float* hg_b, const float* h_init,
                   int T, int B, int H, int ndir, int C,
                   cudaStream_t stream) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int fit = 0;
  cudaError_t err = configure<W, R>(B, ndir, C, &cfg, attr, &fit);
  if (err != cudaSuccess) return err;
  // all clusters in one wave, or no launch
  if (fit < static_cast<int>(cfg.gridDim.y * cfg.gridDim.z))
    return cudaErrorCooperativeLaunchTooLarge;
  cfg.stream = stream;
  err = cudaLaunchKernelEx(&cfg, gru_wide_fwd_kernel<W, R>, xp_f, xp_b, mask,
                           wh_f, wh_b, h_f, h_b, hg_f, hg_b, h_init, T, B,
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

template <typename W>
int launch_form(const float* xp_f, const float* xp_b, const float* mask,
                const W* wh_f, const W* wh_b, float* h_f, float* h_b,
                float* hg_f, float* hg_b, const float* h_init, int T, int B,
                int H, int ndir, int C, int U, int R, void* stream) {
  if (!valid_geometry(H, ndir, C, U) ||
      ((hg_f == nullptr) != (hg_b == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(by_rows(R, [&](auto rows) {
    return launch<W, decltype(rows)::value>(
        xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, hg_f, hg_b, h_init, T, B, H,
        ndir, C, static_cast<cudaStream_t>(stream));
  }));
}

}  // namespace

// Launch the forward over ndir directions: clusters of C CTAs of U = 32
// units each, R (4, 8 or 16) batch rows a cluster.  hg_f / hg_b: the h
// side of the pre-activations [T, B, 3H] to write, or both null.  h_init:
// the h each lane starts from, [ndir, B, H], or null for zeros.
extern "C" int asr_gru_wide_fwd(const float* xp_f, const float* xp_b,
                                const float* mask, const float* wh_f,
                                const float* wh_b, float* h_f, float* h_b,
                                float* hg_f, float* hg_b, const float* h_init,
                                int T, int B, int H, int ndir, int C, int U,
                                int R, void* stream) {
  return launch_form<float>(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b, hg_f,
                            hg_b, h_init, T, B, H, ndir, C, U, R, stream);
}

// The bfloat16-weight form: asr_gru_wide_fwd's arguments with wh_f / wh_b
// bfloat16 [H, 3H].
extern "C" int asr_gru_wide_fwd_bf16(
    const float* xp_f, const float* xp_b, const float* mask,
    const __nv_bfloat16* wh_f, const __nv_bfloat16* wh_b, float* h_f,
    float* h_b, float* hg_f, float* hg_b, const float* h_init, int T, int B,
    int H, int ndir, int C, int U, int R, void* stream) {
  return launch_form<__nv_bfloat16>(xp_f, xp_b, mask, wh_f, wh_b, h_f, h_b,
                                    hg_f, hg_b, h_init, T, B, H, ndir, C, U,
                                    R, stream);
}

// The forward's dynamic shared memory per CTA and the clusters the card
// holds at once for that launch, without launching.
extern "C" int asr_gru_wide_fwd_info(int B, int H, int ndir, int C, int U,
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
