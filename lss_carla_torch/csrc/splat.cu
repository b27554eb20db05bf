// Splat (voxel pooling) scatter-add for Hopper (sm_90a).
//
// Replaces the TPU kernel lss_carla_tpu/ops/splat_pallas.py::_splat_kernel
// (driven by _splat_single / _splat_forward, public splat_pallas_batched):
//
//     acc[b, s, :] = sum over p with ids[b, p] == s of pts[b, p, :]
//
// for every batch item b and slot s in [0, S). Ids outside [0, S) -- the
// sentinel S that voxel_indices gives out-of-grid points -- are dropped.
// All B items go in one launch.
//
// The TPU design keeps one item's whole accumulator resident in VMEM and
// updates rows in order, one grid step after another. Blocks on this card
// run in parallel and in no order, so the design here is different:
// a grid-stride loop over (point, 4-channel group) pairs. Neighbouring
// threads take neighbouring channel groups of one point, so the feature
// loads are coalesced (16 bytes a thread for f32, 8 for bf16) and the
// atomics of a warp land on 2 contiguous rows. Each thread skips sentinel
// points before loading their features, and adds its 4 values into the f32
// accumulator with atomicAdd (its result is unused, so it compiles to a
// fire-and-forget RED). The accumulator is allocated and zeroed by the
// caller; it is f32 for f32 and bf16 features alike.
//
// Bound on this card: bytes. The function reads the features and ids once
// and writes the dense accumulator once; at the flagship shape (B = 8,
// P = 43,296, C = 64, S = 40,000) that is about 8 * (11.1 MB + 0.17 MB)
// read and 8 * 10.2 MB written, ~0.05 ms at 3.35 TB/s, against about 0.2
// GFLOP of adds. The atomics resolve in L2; the 82 MB accumulator does not
// fit the 50 MB L2, so part of it round-trips to device memory. Sums taken
// by atomics depend on the order the adds arrive in, so the result is not
// bit-reproducible from run to run (a few f32 ulps of the slot's sum).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = __ldg(reinterpret_cast<const float4*>(p));
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
  __nv_bfloat162 lo, hi;
  lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

// VEC channels per thread: 4 when C % 4 == 0 and the features are aligned
// for a vector load, else 1.
template <typename T, int VEC>
__global__ void splat_kernel(const T* __restrict__ pts,
                             const int32_t* __restrict__ ids,
                             float* __restrict__ acc, int64_t B, int64_t P,
                             int C, int64_t S) {
  const int nvec = C / VEC;
  const int64_t total = B * P * nvec;
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; t < total;
       t += stride) {
    const int64_t row = t / nvec;  // b * P + p
    const int c = (int)(t - row * nvec) * VEC;
    const int32_t id = __ldg(ids + row);
    if (id < 0 || (int64_t)id >= S) continue;  // sentinel: dropped
    const int64_t b = row / P;
    float* dst = acc + (b * S + id) * C + c;
    const T* src = pts + row * C + c;
    if (VEC == 4) {
      float v[4];
      load4(src, v);
#pragma unroll
      for (int k = 0; k < 4; ++k) atomicAdd(dst + k, v[k]);
    } else {
      atomicAdd(dst, load1(src));
    }
  }
}

template <typename T>
void launch(const T* pts, const int32_t* ids, float* acc, int64_t B,
            int64_t P, int C, int64_t S, cudaStream_t stream) {
  const bool vec = (C % 4 == 0) &&
                   (reinterpret_cast<uintptr_t>(pts) % (4 * sizeof(T)) == 0);
  const int64_t total = B * P * (vec ? C / 4 : C);
  const int threads = 256;
  int64_t blocks = (total + threads - 1) / threads;
  if (blocks > (int64_t)1 << 20) blocks = (int64_t)1 << 20;  // grid-stride
  if (vec) {
    splat_kernel<T, 4><<<(unsigned)blocks, threads, 0, stream>>>(
        pts, ids, acc, B, P, C, S);
  } else {
    splat_kernel<T, 1><<<(unsigned)blocks, threads, 0, stream>>>(
        pts, ids, acc, B, P, C, S);
  }
}

}  // namespace

extern "C" {

// pts: (B, P, C) f32 (dtype 0) or bf16 (dtype 1), contiguous.
// ids: (B, P) int32. acc: (B, S, C) f32, zeroed by the caller.
// Launches on `stream` and returns cudaGetLastError() (0 on success).
int lss_splat_forward(const void* pts, int dtype, const void* ids, void* acc,
                      long long B, long long P, int C, long long S,
                      void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || S <= 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* id = static_cast<const int32_t*>(ids);
  float* out = static_cast<float*>(acc);
  if (dtype == 0) {
    launch(static_cast<const float*>(pts), id, out, B, P, C, S, s);
  } else {
    launch(static_cast<const __nv_bfloat16*>(pts), id, out, B, P, C, S, s);
  }
  return (int)cudaGetLastError();
}

const char* lss_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
