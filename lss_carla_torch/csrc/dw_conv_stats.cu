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
// passes the low-side pads total // 2). acc is f32 for f32 and bf16 inputs
// alike, and the moments come from acc before y is rounded, as the TPU
// kernel takes them. The taps add in (kh, kw) order, as there.
//
// The TPU design keeps one image's padded slab in VMEM, walks row chunks in
// order, and carries the moments across grid steps in its output blocks;
// it splits stride 2 into polyphase slabs because Mosaic cannot slice with
// a stride. None of that carries over. Here:
//
// * One block of 256 threads works on one channel c and one contiguous
//   slice of that channel's N*Ho*Wo outputs (grid = C x slices). Thread t
//   takes outputs t, t + 256, ... of the slice, so neighbouring threads
//   write neighbouring outputs of a row and read overlapping windows of x
//   (coalesced loads; the k*k reuse is served by L1). The channel's k*k
//   weights sit in registers. Padding is a bounds check per tap, so no
//   padded copy of x is ever written. The wrapper picks the number of
//   slices so that about 8 blocks are resident on each of the 132 SMs:
//   the early stages (32-144 channels, up to 270,336 outputs a channel)
//   get many slices, the late ones (1,152 channels of 1,056 outputs) one.
// * Each thread sums acc and acc^2 in f32 over its outputs; the block
//   reduces them with warp shuffles in a fixed order and writes one
//   partial per (channel, slice). A second small launch adds each
//   channel's partials in slice order. No atomics: y, sum and sumsq are
//   bit-reproducible from run to run.
//
// Bound on this card: bytes. The function reads x once and writes y once
// (at the largest B0 launch, N 24 x 96 x 64 x 176 in, 32 x 88 out, f32:
// 104 MB + 26 MB, 0.039 ms at 3.35 TB/s) against 2*k*k + 3 f32 operations
// an output (0.002 ms at 67 TFLOP/s).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// partial: (2, C, slices) f32; [0] holds sums, [1] sums of squares.
template <typename T, int K, int S>
__global__ void __launch_bounds__(kThreads)
    dw_conv_stats_kernel(const T* __restrict__ x, const float* __restrict__ w,
                         T* __restrict__ y, float* __restrict__ partial, int C,
                         int H, int W, int Ho, int Wo, int pad_h, int pad_w,
                         int total, int chunk) {
  const int c = blockIdx.x;
  const int slice = blockIdx.y;
  const int slices = gridDim.y;

  float wk[K * K];
#pragma unroll
  for (int i = 0; i < K * K; ++i) wk[i] = __ldg(w + (int64_t)c * K * K + i);

  const int hw_out = Ho * Wo;
  const int64_t first = (int64_t)slice * chunk;
  const int64_t last = first + chunk;
  const int begin = (int)(first < total ? first : total);
  const int end = (int)(last < total ? last : total);
  float s1 = 0.f, s2 = 0.f;
  for (int i = begin + (int)threadIdx.x; i < end; i += kThreads) {
    const int n = i / hw_out;
    const int r = i - n * hw_out;
    const int oh = r / Wo;
    const int ow = r - oh * Wo;
    const int64_t plane = (int64_t)n * C + c;
    const T* xp = x + plane * H * W;
    const int ih0 = oh * S - pad_h;
    const int iw0 = ow * S - pad_w;
    float acc = 0.f;
#pragma unroll
    for (int kh = 0; kh < K; ++kh) {
      const int ih = ih0 + kh;
      if (ih < 0 || ih >= H) continue;
      const T* row = xp + (int64_t)ih * W;
#pragma unroll
      for (int kw = 0; kw < K; ++kw) {
        const int iw = iw0 + kw;
        if (iw < 0 || iw >= W) continue;
        acc = fmaf(to_f32(row[iw]), wk[kh * K + kw], acc);
      }
    }
    store(y + plane * hw_out + r, acc);
    s1 += acc;
    s2 = fmaf(acc, acc, s2);
  }

  // fixed-order block reduction: shuffles within each warp, then warp 0
  // over the warps' results
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_down_sync(0xffffffffu, s1, o);
    s2 += __shfl_down_sync(0xffffffffu, s2, o);
  }
  __shared__ float red[2][kWarps];
  if (lane == 0) {
    red[0][warp] = s1;
    red[1][warp] = s2;
  }
  __syncthreads();
  if (warp == 0) {
    s1 = lane < kWarps ? red[0][lane] : 0.f;
    s2 = lane < kWarps ? red[1][lane] : 0.f;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s1 += __shfl_down_sync(0xffffffffu, s1, o);
      s2 += __shfl_down_sync(0xffffffffu, s2, o);
    }
    if (lane == 0) {
      partial[(int64_t)c * slices + slice] = s1;
      partial[((int64_t)C + c) * slices + slice] = s2;
    }
  }
}

// Each channel's partials added in slice order into sums[c] and sumsq[c].
__global__ void dw_stats_finalize(const float* __restrict__ partial,
                                  float* __restrict__ sums,
                                  float* __restrict__ sumsq, int C,
                                  int slices) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float a = 0.f, b = 0.f;
  for (int j = 0; j < slices; ++j) {
    a += partial[(int64_t)c * slices + j];
    b += partial[((int64_t)C + c) * slices + j];
  }
  sums[c] = a;
  sumsq[c] = b;
}

template <typename T, int K, int S>
void launch(const void* x, const float* w, void* y, float* partial, int C,
            int H, int W, int Ho, int Wo, int pad_h, int pad_w, int total,
            int chunk, int slices, cudaStream_t stream) {
  dw_conv_stats_kernel<T, K, S><<<dim3(C, slices), kThreads, 0, stream>>>(
      static_cast<const T*>(x), w, static_cast<T*>(y), partial, C, H, W, Ho,
      Wo, pad_h, pad_w, total, chunk);
}

template <typename T>
void dispatch(int k, int s, const void* x, const float* w, void* y,
              float* partial, int C, int H, int W, int Ho, int Wo, int pad_h,
              int pad_w, int total, int chunk, int slices,
              cudaStream_t stream) {
  if (k == 3 && s == 1) {
    launch<T, 3, 1>(x, w, y, partial, C, H, W, Ho, Wo, pad_h, pad_w, total,
                    chunk, slices, stream);
  } else if (k == 3 && s == 2) {
    launch<T, 3, 2>(x, w, y, partial, C, H, W, Ho, Wo, pad_h, pad_w, total,
                    chunk, slices, stream);
  } else if (k == 5 && s == 1) {
    launch<T, 5, 1>(x, w, y, partial, C, H, W, Ho, Wo, pad_h, pad_w, total,
                    chunk, slices, stream);
  } else {
    launch<T, 5, 2>(x, w, y, partial, C, H, W, Ho, Wo, pad_h, pad_w, total,
                    chunk, slices, stream);
  }
}

}  // namespace

extern "C" {

// x: (N, C, H, W) f32 (dtype 0) or bf16 (dtype 1), contiguous.
// w: (C, k, k) f32. y: (N, C, Ho, Wo) in x's dtype. partial: (2, C, slices)
// f32 scratch. sums, sumsq: (C,) f32 out. k in {3, 5}, s in {1, 2};
// N*Ho*Wo <= chunk*slices and N*Ho*Wo < 2^31. Launches on `stream` and
// returns cudaGetLastError() (0 on success).
int lss_dw_conv_stats(const void* x, int dtype, const void* w, void* y,
                      void* partial, void* sums, void* sumsq, int N, int C,
                      int H, int W, int k, int s, int Ho, int Wo, int pad_h,
                      int pad_w, int chunk, int slices, void* stream) {
  const int64_t total = (int64_t)N * Ho * Wo;
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || Ho <= 0 || Wo <= 0 ||
      (k != 3 && k != 5) || (s != 1 && s != 2) || (dtype != 0 && dtype != 1) ||
      chunk <= 0 || slices <= 0 || slices > 65535 ||
      total > (int64_t)0x7fffffff || (int64_t)chunk * slices < total) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* wf = static_cast<const float*>(w);
  float* part = static_cast<float*>(partial);
  if (dtype == 0) {
    dispatch<float>(k, s, x, wf, y, part, C, H, W, Ho, Wo, pad_h, pad_w,
                    (int)total, chunk, slices, st);
  } else {
    dispatch<__nv_bfloat16>(k, s, x, wf, y, part, C, H, W, Ho, Wo, pad_h,
                            pad_w, (int)total, chunk, slices, st);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dw_stats_finalize<<<(C + 255) / 256, 256, 0, st>>>(
      part, static_cast<float*>(sums), static_cast<float*>(sumsq), C, slices);
  return (int)cudaGetLastError();
}

const char* lss_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
