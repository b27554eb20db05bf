// Depthwise convolution with the per-channel batch moments of its output,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel lss_carla_tpu/ops/mbconv_pallas.py::_dw_stats_kernel
// (driven by _dw_conv_stats_impl; public dw_conv_stats / fused_dw_bn_swish).
// In the port's NCHW layout, for a k x k kernel at stride s:
//
//     acc[n,c,oh,ow] = sum over kh, kw of
//                      x[n, c, oh*s - pad_h + kh, ow*s - pad_w + kw] * w[c, kh, kw]
//     y = acc rounded to x's dtype
//     sum[c]   = sum over n, oh, ow of acc
//     sumsq[c] = sum over n, oh, ow of acc * acc
//
// with x read as 0 outside its H x W plane (XLA "SAME" padding: the caller
// passes the low-side pads total // 2) and w rounded to x's dtype. acc is
// f32 for f32 and bf16 inputs alike, and the moments come from acc before
// y is rounded, as the TPU kernel takes them. The taps add in (kh, kw)
// order with fmaf, as there.
//
// Bound on this card: bytes. The function reads x once and writes y once
// (at the largest B0 launch, N 24 x 96 x 64 x 176 in, 32 x 88 out, f32:
// 104 MB + 26 MB, 0.039 ms at 3.35 TB/s) against 2*k*k + 3 f32 operations
// an output (0.002 ms at 67 TFLOP/s).
//
// The TPU design keeps one image's padded slab in VMEM, walks row chunks in
// order and carries the moments across grid steps. Here, one launch a call:
//
// * Tiles. Block (t, c) takes tile t of channel c: a band of TH output rows
//   x a column tile of TW outputs, of PB consecutive images n. Large planes
//   take several bands an image (PB = 1); small ones (8 x 22, 4 x 11 in B0)
//   put several images in one block, and at the late stages one block holds
//   a channel's whole N*Ho*Wo outputs. The host-side planner
//   (ops/mbconv_cuda.py::plan_tiles) picks TH, TW, PB.
// * Staging. The PB input bands, (TH - 1)*s + k rows each, end in shared
//   memory as f32 with the zero halo written in place, so the inner loop
//   has no bounds checks. f32: one 4-byte cp.async an element straight
//   into place (a source size of 0 writes the halo's zeros). bf16 must
//   widen: each image's input rows are one contiguous run of x, copied by
//   one TMA bulk copy (cp.async.bulk on an mbarrier) into a raw slot, then
//   widened into the band. Groups of lanes take rows, stepping by
//   constants. At stride 2 a band row holds its even columns, then its odd
//   ones, so a thread's strided window is two contiguous float4 runs and
//   neighbouring lanes read neighbouring words (no bank conflicts).
// * Work a thread. Thread (row, strip) computes kStrip = 4 adjacent outputs
//   of one row. For each kernel row it reads the strip's inputs as float4s
//   into registers and reuses them across the 4 outputs. The thread's row
//   and strip are decoded from threadIdx once a block and advance by
//   constant steps: no division an output. At most 48 registers a thread,
//   for 5 blocks an SM.
// * Moments. Each thread sums acc and acc^2 in f32; the block reduces them
//   with warp shuffles, then across warps, in a fixed order, and writes one
//   partial per (channel, tile). The last block of each channel (a ticket
//   on an int counter after __threadfence) adds the channel's partials in
//   tile order, writes sum and sumsq, and resets the counter. No second
//   launch and no float atomics: y, sum and sumsq are bit-reproducible.
//
// What holds it back (PERF.md, PR 3): the late stages (8 x 22 and 4 x 11
// planes) take 3-7x their byte bound; their time goes to staging latency
// (many small 4-byte copies, one band per block) and to each block's serial
// load-compute-reduce phases. A persistent double-buffered grid, and TMA
// staging of f32 through a widening pass, were both slower on the card.

#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kStrip = 4;        // outputs a thread computes side by side
constexpr int kMaxThreads = 256;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kMaxSmem = 232448;  // 227 KB a block on the H100


// 4 bytes into shared `dst`, asynchronously: the first `bytes` (0 or 4)
// from `src`, zeros after them
__device__ __forceinline__ void copy4_async(void* dst, const void* src,
                                            int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Arrive on `bar` expecting `bytes`, then bulk-copy `bytes` from global
// `src` into shared `dst` (both 16-byte aligned, bytes a multiple of 16);
// the copy's bytes complete the phase.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// N float4s from 16-byte aligned shared `p` into v[0 .. 4N)
template <int N>
__device__ __forceinline__ void load_window(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < N; ++q) {
    const float4 f = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = f.x;
    v[4 * q + 1] = f.y;
    v[4 * q + 2] = f.z;
    v[4 * q + 3] = f.w;
  }
}

__device__ __forceinline__ void store_strip(float* p, const float v[kStrip],
                                            int n, bool vec) {
  if (vec) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int o = 0; o < kStrip; ++o) {
      if (o < n) p[o] = v[o];
    }
  }
}
__device__ __forceinline__ void store_strip(__nv_bfloat16* p,
                                            const float v[kStrip], int n,
                                            bool vec) {
  if (vec) {
    __nv_bfloat162 lo = __floats2bfloat162_rn(v[0], v[1]);
    __nv_bfloat162 hi = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<uint32_t*>(&lo);
    raw.y = *reinterpret_cast<uint32_t*>(&hi);
    *reinterpret_cast<uint2*>(p) = raw;
  } else {
#pragma unroll
    for (int o = 0; o < kStrip; ++o) {
      if (o < n) p[o] = __float2bfloat16_rn(v[o]);
    }
  }
}

struct Plan {
  int N, C, H, W, Ho, Wo, pad_h, pad_w;
  int tw, tiles_w;  // column tile (outputs) and column tiles a row
  int sw, rg;       // strips across a column tile; rows a block pass covers
  int th, bands;    // band rows and bands a plane
  int pb;           // images a block
  int pitch;        // floats a staged row
  int rawstride;    // bytes of raw rows an image, a multiple of 16
};

// partial: (2, C, tiles) f32; tickets: (C,) zero on entry, zero on exit.
// at least 5 blocks an SM: <= 48 registers a thread
template <typename T, int K, int S>
__global__ void __launch_bounds__(kMaxThreads, 5)
    dw_conv_stats_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         T* __restrict__ y, float* __restrict__ partial,
                         unsigned* __restrict__ tickets,
                         float* __restrict__ sums, float* __restrict__ sumsq,
                         const Plan pl) {
  // float4s of a thread's window: stride 1, its (4 - 1) + k columns;
  // stride 2, its 4 + (k - 1) / 2 even and 4 + (k - 2) / 2 odd ones
  constexpr int kWin4 = S == 1 ? (kStrip - 1 + K + 3) / 4 : (kStrip + (K - 1) / 2 + 3) / 4;
  constexpr int kOdd4 = S == 1 ? 1 : (kStrip + (K - 2) / 2 + 3) / 4;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[2][kMaxWarps];
  __shared__ bool is_last;
  __shared__ int lead[kMaxThreads];  // byte offset of each image's rows
  __shared__ bool bulk[kMaxThreads];
  __shared__ __align__(8) unsigned long long bar_storage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int nwarps = blockDim.x >> 5;
  const int c = blockIdx.y;
  const int tiles = gridDim.x;

  // this block's tile: one decode a block
  int t = blockIdx.x;
  const int tile_w = t % pl.tiles_w;
  t /= pl.tiles_w;
  const int band_i = t % pl.bands;
  const int n0 = (t / pl.bands) * pl.pb;
  const int planes = min(pl.pb, pl.N - n0);
  const int oh0 = band_i * pl.th;
  const int rows = min(pl.th, pl.Ho - oh0);
  const int ow0 = tile_w * pl.tw;
  const int cols = min(pl.tw, pl.Wo - ow0);
  const int ihb = (pl.th - 1) * S + K;
  const int ih0 = oh0 * S - pl.pad_h;
  const int iw0 = ow0 * S - pl.pad_w;

  // The f32 bands, zero halo included, in shared memory. Groups of L
  // lanes (L = 32, or the least power of two >= pitch for narrow rows)
  // take band rows g, g + G, ..., stepping (image p, band row i) by
  // constants; a group's lanes take the row's padded columns. At stride 2
  // a band row holds its even columns, then its odd ones, hp floats each,
  // so that a thread's strided window is two contiguous ones.
  float* band = reinterpret_cast<float*>(smem);
  const int lanes_log2 = pl.pitch >= 32 ? 5 : 32 - __clz(pl.pitch - 1);
  const int L = 1 << lanes_log2;
  const int G = blockDim.x >> lanes_log2;
  const int g = tid >> lanes_log2;
  const int col = tid & (L - 1);
  const int step_p = G / ihb;
  const int step_i = G - step_p * ihb;
  const int hp = pl.pitch / 2;
  float wk[K * K];

  if constexpr (std::is_same<T, float>::value) {
    // f32: one asynchronous 4-byte copy an element, straight into place (a
    // source size of 0 writes the halo's zeros)
    for (int p = g / ihb, i = g % ihb; p < planes;) {
      const int ih = ih0 + i;
      const bool row_in = ih >= 0 && ih < pl.H;
      const float* src =
          x + (((int64_t)(n0 + p) * pl.C + c) * pl.H + (row_in ? ih : 0)) * pl.W;
      float* dst = band + (p * ihb + i) * pl.pitch;
      for (int j = col; j < pl.pitch; j += L) {
        const int iw = iw0 + j;
        const bool in = row_in && iw >= 0 && iw < pl.W;
        copy4_async(dst + (S == 1 ? j : (j >> 1) + (j & 1) * hp), src + (in ? iw : 0),
                    in ? 4 : 0);
      }
      i += step_i;
      p += step_p;
      if (i >= ihb) {
        i -= ihb;
        ++p;
      }
    }
#pragma unroll
    for (int i = 0; i < K * K; ++i) wk[i] = __ldg(w + (int64_t)c * K * K + i);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
  } else {
    // bf16 widens on the way. Each image's input rows [r_lo, r_hi) are one
    // contiguous run of x: thread p copies image p's run into its raw slot
    // with one TMA bulk copy (the run's 16-byte aligned cover, completing
    // on an mbarrier) when that cover lies inside x; otherwise the block
    // copies the run itself. Then the rows are widened into the bands.
    unsigned char* raw = smem + (size_t)pl.pb * ihb * pl.pitch * sizeof(float);
    const int r_lo = max(ih0, 0);
    const int r_hi = min(ih0 + ihb, pl.H);
    const int run = r_hi > r_lo ? (r_hi - r_lo) * pl.W : 0;  // elements
    const uint32_t bar = static_cast<uint32_t>(__cvta_generic_to_shared(&bar_storage));
    if (tid == 0) mbar_init(bar, planes);
    __syncthreads();
    if (tid < planes) {
      const T* first = x + (((int64_t)(n0 + tid) * pl.C + c) * pl.H + r_lo) * pl.W;
      const uintptr_t a = reinterpret_cast<uintptr_t>(first);
      const uintptr_t a0 = a & ~(uintptr_t)15;
      const uint32_t bytes =
          (uint32_t)(((a - a0) + (uintptr_t)run * sizeof(T) + 15) & ~(uintptr_t)15);
      const uintptr_t x_end = reinterpret_cast<uintptr_t>(x) +
                              (uintptr_t)pl.N * pl.C * pl.H * pl.W * sizeof(T);
      const bool ok = run > 0 && a0 >= reinterpret_cast<uintptr_t>(x) && a0 + bytes <= x_end;
      lead[tid] = (int)(a - a0);
      bulk[tid] = ok;
      if (ok) {
        bulk_load(static_cast<uint32_t>(__cvta_generic_to_shared(raw + tid * pl.rawstride)),
                  reinterpret_cast<const void*>(a0), bytes, bar);
      } else {
        mbar_arrive(bar);
      }
    }
#pragma unroll
    for (int i = 0; i < K * K; ++i) {
      wk[i] = __bfloat162float(__float2bfloat16_rn(__ldg(w + (int64_t)c * K * K + i)));
    }
    __syncthreads();  // lead[] and bulk[]
    for (int p = 0; p < planes; ++p) {  // the runs no bulk copy took
      if (bulk[p]) continue;
      const T* first = x + (((int64_t)(n0 + p) * pl.C + c) * pl.H + r_lo) * pl.W;
      T* dst = reinterpret_cast<T*>(raw + p * pl.rawstride + lead[p]);
      for (int e = tid; e < run; e += blockDim.x) dst[e] = first[e];
    }
    mbar_wait(bar, 0);
    __syncthreads();
    for (int p = g / ihb, i = g % ihb; p < planes;) {
      const int ih = ih0 + i;
      const bool row_in = ih >= r_lo && ih < r_hi;
      const T* src = reinterpret_cast<const T*>(raw + p * pl.rawstride + lead[p]) +
                     (row_in ? (ih - r_lo) * pl.W : 0);
      float* dst = band + (p * ihb + i) * pl.pitch;
      for (int j = col; j < pl.pitch; j += L) {
        const int iw = iw0 + j;
        const float v = row_in && iw >= 0 && iw < pl.W ? __bfloat162float(src[iw]) : 0.f;
        dst[S == 1 ? j : (j >> 1) + (j & 1) * hp] = v;
      }
      i += step_i;
      p += step_p;
      if (i >= ihb) {
        i -= ihb;
        ++p;
      }
    }
  }
  __syncthreads();

  float s1 = 0.f, s2 = 0.f;
  if (tid < pl.rg * pl.sw) {
    // (image, row) of the first strip row, and the constant step rg
    const int strip = tid % pl.sw;
    const int cr = tid / pl.sw;
    int p = cr / pl.th;
    int r = cr - p * pl.th;
    const int dp = pl.rg / pl.th;
    const int dr = pl.rg - dp * pl.th;
    const int ow_rel = strip * kStrip;
    const int nout = min(kStrip, cols - ow_rel);
    for (; p < planes;) {
      if (r < rows && nout > 0) {
        // stride 1: one window of (4 - 1) + k columns from ow_rel. Stride
        // 2: the even columns ow_rel ... and the odd ones hp + ow_rel ...
        const float* base = band + (p * ihb + r * S) * pl.pitch + ow_rel;
        float acc[kStrip];
#pragma unroll
        for (int o = 0; o < kStrip; ++o) acc[o] = 0.f;
#pragma unroll
        for (int kh = 0; kh < K; ++kh) {
          float win[kWin4 * 4];
          float odd[kOdd4 * 4];
          const float* row = base + kh * pl.pitch;
          load_window<kWin4>(row, win);
          if (S == 2) load_window<kOdd4>(row + pl.pitch / 2, odd);
#pragma unroll
          for (int o = 0; o < kStrip; ++o) {
#pragma unroll
            for (int kw = 0; kw < K; ++kw) {
              const float v = S == 1 ? win[o + kw]
                              : (kw & 1) ? odd[o + kw / 2] : win[o + kw / 2];
              acc[o] = fmaf(v, wk[kh * K + kw], acc[o]);
            }
          }
        }
        const int64_t out =
            (((int64_t)(n0 + p) * pl.C + c) * pl.Ho + oh0 + r) * pl.Wo + ow0 +
            ow_rel;
        store_strip(y + out, acc, nout, nout == kStrip && (out & 3) == 0);
#pragma unroll
        for (int o = 0; o < kStrip; ++o) {
          if (o < nout) {
            s1 += acc[o];
            s2 = fmaf(acc[o], acc[o], s2);
          }
        }
      }
      r += dr;
      p += dp;
      if (r >= pl.th) {
        r -= pl.th;
        ++p;
      }
    }
  }

  // fixed-order block reduction: shuffles within each warp, then warp 0
  // over the warps' results
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, o);
    s2 += __shfl_down_sync(0xffffffffu, s2, o);
  }
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < nwarps ? red[0][lane] : 0.f;
    s2 = lane < nwarps ? red[1][lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_down_sync(0xffffffffu, s1, o);
      s2 += __shfl_down_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      if (tiles == 1) {  // the block holds the whole channel
        sums[c] = s1;
        sumsq[c] = s2;
      } else {
        partial[(int64_t)c * tiles + blockIdx.x] = s1;
        partial[((int64_t)pl.C + c) * tiles + blockIdx.x] = s2;
        __threadfence();  // the partial is visible before the ticket
        is_last = atomicAdd(tickets + c, 1u) == (unsigned)(tiles - 1);
      }
    }
  }
  if (tiles == 1) return;
  __syncthreads();
  if (!is_last || warp != 0) return;
  // the channel's last block: its partials, lane j taking tiles j, j + 32,
  // ... in order, then a fixed shuffle tree
  __threadfence();
  float a = 0.f, b = 0.f;
  for (int j = lane; j < tiles; j += 32) {
    a += __ldcg(partial + (int64_t)c * tiles + j);
    b += __ldcg(partial + ((int64_t)pl.C + c) * tiles + j);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if (lane == 0) {
    sums[c] = a;
    sumsq[c] = b;
    tickets[c] = 0u;  // ready for the next call on this stream
  }
}

template <typename T, int K, int S>
cudaError_t launch(const void* x, const float* w, void* y, float* partial,
                   unsigned* tickets, float* sums, float* sumsq,
                   const Plan& pl, int tiles, int threads, int smem,
                   cudaStream_t stream) {
  auto kernel = dw_conv_stats_kernel<T, K, S>;
  static int smem_allowed = 48 * 1024;  // per instance, raised as needed
  if (smem > smem_allowed) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    smem_allowed = kMaxSmem;
  }
  kernel<<<dim3(tiles, pl.C), threads, smem, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), partial, tickets, sums,
      sumsq, pl);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int k, int s, const void* x, const float* w, void* y,
                     float* partial, unsigned* tickets, float* sums,
                     float* sumsq, const Plan& pl, int tiles, int threads,
                     int smem, cudaStream_t st) {
  if (k == 3 && s == 1)
    return launch<T, 3, 1>(x, w, y, partial, tickets, sums, sumsq, pl, tiles,
                           threads, smem, st);
  if (k == 3 && s == 2)
    return launch<T, 3, 2>(x, w, y, partial, tickets, sums, sumsq, pl, tiles,
                           threads, smem, st);
  if (k == 5 && s == 1)
    return launch<T, 5, 1>(x, w, y, partial, tickets, sums, sumsq, pl, tiles,
                           threads, smem, st);
  return launch<T, 5, 2>(x, w, y, partial, tickets, sums, sumsq, pl, tiles,
                         threads, smem, st);
}

int64_t ceil_div(int64_t a, int64_t b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// x: (N, C, H, W) f32 (dtype 0) or bf16 (dtype 1), contiguous, any
// alignment. w: (C, k, k) f32, rounded to x's dtype inside. y: (N, C, Ho, Wo) in x's
// dtype. partial: (2, C, tiles) f32 scratch; tickets: (C,) int32 scratch,
// zero on entry and left zero. sums, sumsq: (C,) f32 out. k in {3, 5},
// s in {1, 2}, N*Ho*Wo < 2^31. The tile plan (tw, tiles_w, sw, rg, th,
// bands, pb, pitch, rawstride, threads) comes from
// ops/mbconv_cuda.py::plan_tiles and
// is checked here. Launches once on `stream` and returns the launch's
// cudaError_t (0 on success).
int lss_dw_conv_stats(const void* x, int dtype, const void* w, void* y,
                      void* partial, void* tickets, void* sums, void* sumsq,
                      int N, int C, int H, int W, int k, int s, int Ho, int Wo,
                      int pad_h, int pad_w, int tw, int tiles_w, int sw,
                      int rg, int th, int bands, int pb, int pitch,
                      int rawstride, int threads, void* stream) {
  if (N <= 0 || C <= 0 || C > 65535 || H <= 0 || W <= 0 || Ho <= 0 ||
      Wo <= 0 || (k != 3 && k != 5) || (s != 1 && s != 2) ||
      (dtype != 0 && dtype != 1) ||
      (int64_t)N * Ho * Wo > (int64_t)0x7fffffff) {
    return (int)cudaErrorInvalidValue;
  }
  // the plan must cover every output once and fit the block: stride 1
  // rows hold a thread's (4 - 1) + k window from any strip; stride 2 rows
  // two halves of hp >= (sw - 1) * 4 + 8 floats
  const int64_t ihb = (int64_t)(th - 1) * s + k;
  const int64_t groups = pb > 0 ? ceil_div(N, pb) : 0;
  const int64_t tiles = groups * bands * tiles_w;
  const int64_t need = s == 1 ? (int64_t)(sw - 1) * kStrip + (kStrip - 1 + k + 3) / 4 * 4
                              : 2 * ((int64_t)(sw - 1) * kStrip + 8);
  const int64_t raw_need = dtype == 0 ? 0 : ihb * W * 2 + 32;  // bf16's raw rows
  const int64_t smem = (int64_t)pb * (ihb * pitch * (int64_t)sizeof(float) + rawstride);
  if (tw <= 0 || tiles_w != ceil_div(Wo, tw) || sw != ceil_div(tw, kStrip) ||
      rg <= 0 || th <= 0 || bands != ceil_div(Ho, th) || pb <= 0 ||
      threads % 32 != 0 || threads > kMaxThreads || pb > threads ||
      (int64_t)rg * sw > threads || pitch % (s == 1 ? 4 : 8) != 0 ||
      pitch < need || rawstride % 16 != 0 || rawstride < raw_need ||
      tiles <= 0 || tiles > 0x7fffffff || smem > kMaxSmem) {
    return (int)cudaErrorInvalidValue;
  }
  const Plan pl{N, C, H, W, Ho, Wo, pad_h, pad_w, tw, tiles_w,
                sw, rg, th, bands, pb, pitch, rawstride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* part = static_cast<float*>(partial);
  unsigned* tick = static_cast<unsigned*>(tickets);
  float* s1 = static_cast<float*>(sums);
  float* s2 = static_cast<float*>(sumsq);
  if (dtype == 0) {
    return (int)dispatch<float>(k, s, x, wf, y, part, tick, s1, s2, pl,
                                (int)tiles, threads, (int)smem, st);
  }
  return (int)dispatch<__nv_bfloat16>(k, s, x, wf, y, part, tick, s1, s2, pl,
                                      (int)tiles, threads, (int)smem, st);
}

const char* lss_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
