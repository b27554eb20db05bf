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
// Bound on this card: bytes. The function reads the ids, the features of
// the in-grid points and writes the dense accumulator once; at the
// flagship shape (B = 8, P = 43,296, C = 64, S = 40,000, f32) that is
// about 8 * (0.17 MB + 10.7 MB) read and 8 * 10.2 MB written, ~0.05 ms at
// 3.35 TB/s, against ~0.02 GFLOP of adds. The caller zero-fills the
// accumulator (a memset on the stream); this kernel only adds into it.
//
// The TPU design keeps one item's accumulator resident in VMEM and adds
// rows in order. Here the adds are atomics into the f32 accumulator in
// L2, and the design is about sending fewer of them:
//
// * Tiles. A persistent grid of blocks walks tiles of kTile = 176
//   consecutive points of one item, in item order, so the blocks in
//   flight touch one or two items' 10.2 MB accumulators, which stay in
//   the 50 MB L2. Tile offsets come from blockIdx: one division a tile,
//   none a point.
// * Asynchronous staging. The tile's kTile x C features are one
//   contiguous run (44 KB at f32, C = 64). Thread 0 stages them into
//   shared memory with one TMA bulk copy (cp.async.bulk, completion on an
//   mbarrier) when the run is 16-byte aligned and fits; otherwise the
//   block reads them from global memory where it sums them.
// * Source-side reduction. While the copy is in flight, each thread loads
//   one id (256 threads, the sort's width; 80 hold no point) and the
//   block sorts the (id, point) keys (bitonic: shuffles for partners
//   within a warp, shared memory across warps). Dropped ids
//   sort last and their features, NaN in the tests, are never read. The
//   run heads of the sorted ids are compacted with a ballot scan; each run
//   is one voxel. On the main path a tile is one (camera, depth) slab of
//   the 8 x 22 feature map, and its in-grid points share ids about 8 to 1:
//   the 8 image rows of one (depth, column) land in one voxel.
// * Vector atomics. A group of lanes takes a run, each lane 4 channels:
//   it sums the run's feature rows from shared memory in f32, in sorted
//   (= point) order, and sends one 16-byte vector atomicAdd (float4, a
//   global-memory RED on sm_90) per 4 channels per run. Against one
//   scalar atomic per point and channel that is ~8x fewer at the source
//   and 4x fewer by width. C not a multiple of 4, or features not aligned
//   for a vector load, take a scalar path (one lane a channel).
//
// bf16 features load as bf16 and sum in f32; the accumulator is f32 for
// both, and the wrapper rounds it to bf16 afterwards. The sums still
// arrive at L2 in run-to-run order, so the result is not bit-reproducible
// (a few f32 ulps of a slot's sum). The deterministic BEVPoolv2-style
// design (per-voxel intervals, no atomics) stays open (ROADMAP A6).

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

// points a tile: one (camera, depth) slab of the flagship's 8 x 22 feature
// map, so a tile's runs are whole; it was measured against 256 and 512
// (PERF.md, PR 3). ops/splat_cuda.py::TILE holds the same number.
constexpr int kTile = 176;
constexpr int next_pow2(int n) { return n <= 1 ? 1 : 2 * next_pow2((n + 1) / 2); }
// threads a block: the sort's width, the least power of two >= kTile
constexpr int kThreads = next_pow2(kTile) < 32 ? 32 : next_pow2(kTile);
constexpr int kWarps = kThreads / 32;
static_assert(kTile > 0 && kThreads <= 1024, "tile of 1 to 1024 points");
constexpr uint32_t kDropped = 0xffffffffu;  // sorts after every valid id
// largest tile of features staged in shared memory (C <= 302 at f32)
constexpr int kMaxStagedBytes = 208 * 1024;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One thread: arrive on `bar` expecting `bytes`, then bulk-copy `bytes`
// from global `src` into shared `dst`; the copy completes the phase.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  // order the block's earlier reads of dst before the async proxy's write
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

__device__ __forceinline__ void load4(const float* p, float v[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float v[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  v[0] = a.x;
  v[1] = a.y;
  v[2] = b.x;
  v[3] = b.y;
}

__device__ __forceinline__ float load1(const float* p) { return *p; }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}

__device__ __forceinline__ void red4(float* dst, const float v[4]) {
#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
#else
#pragma unroll
  for (int k = 0; k < 4; ++k) atomicAdd(dst + k, v[k]);
#endif
}

// Sorts the block's kThreads keys ascending; thread t ends holding the key of
// rank t, which is also stored in keys[t]. Partners within a warp swap by
// shuffle; across warps through shared memory.
__device__ __forceinline__ unsigned long long bitonic_sort(
    unsigned long long key, unsigned long long* keys) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 2; k <= kThreads; k <<= 1) {
#pragma unroll
    for (int j = k >> 1; j > 0; j >>= 1) {
      unsigned long long other;
      if (j >= 32) {
        keys[t] = key;
        __syncthreads();
        other = keys[t ^ j];
        __syncthreads();
      } else {
        other = __shfl_xor_sync(0xffffffffu, key, j);
      }
      const bool ascending = (t & k) == 0;
      const bool lower = (t & j) == 0;
      key = (lower == ascending) ? (key < other ? key : other)
                                 : (key < other ? other : key);
    }
  }
  keys[t] = key;
  __syncthreads();
  return key;
}

// VEC channels a lane: 4 when C % 4 == 0 and the features are aligned for
// a vector load, else 1. STAGED: the instance may stage tiles in shared
// memory (dynamic shared memory of kTile * C * sizeof(T) bytes).
template <typename T, int VEC, bool STAGED>
__global__ void __launch_bounds__(kThreads)
    splat_kernel(const T* __restrict__ pts, const int32_t* __restrict__ ids,
                 float* __restrict__ acc, int64_t P, int C, int64_t S,
                 int64_t tiles_per_item, int64_t num_tiles) {
  extern __shared__ __align__(16) unsigned char staged_feats[];
  __shared__ unsigned long long keys[kThreads];
  __shared__ int run_start[kTile + 1];
  __shared__ int warp_heads[kWarps];
  __shared__ __align__(8) unsigned long long bar_storage;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const uint32_t bar = smem_addr(&bar_storage);
  if (STAGED && tid == 0) mbar_init(bar, 1);
  __syncthreads();
  uint32_t parity = 0;

  // lanes a run: the least power of two >= C / VEC channel groups, <= 32
  const int groups = C / VEC;
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < groups && lanes_log2 < 5) ++lanes_log2;
  const int lanes = 1 << lanes_log2;
  const int runs_a_warp = 32 >> lanes_log2;
  const int run_lane = lane & (lanes - 1);
  const int run_slot = warp * runs_a_warp + (lane >> lanes_log2);
  const int run_stride = kWarps * runs_a_warp;
  const int64_t row_bytes = (int64_t)C * sizeof(T);

  for (int64_t tile = blockIdx.x; tile < num_tiles; tile += gridDim.x) {
    const int64_t b = tile / tiles_per_item;
    const int64_t p0 = (tile - b * tiles_per_item) * kTile;
    const int count = (int)(P - p0 < kTile ? P - p0 : kTile);
    const T* gfeats = pts + (b * P + p0) * C;
    const uint32_t bytes = (uint32_t)(count * row_bytes);
    const bool staged = STAGED &&
                        (reinterpret_cast<uintptr_t>(gfeats) & 15) == 0 &&
                        (bytes & 15) == 0;
    if (staged && tid == 0) {
      bulk_load(smem_addr(staged_feats), gfeats, bytes, bar);
    }
    const T* feats =
        staged ? reinterpret_cast<const T*>(staged_feats) : gfeats;

    uint32_t id = kDropped;
    if (tid < count) {
      const int32_t v = __ldg(ids + b * P + p0 + tid);
      if (v >= 0 && (int64_t)v < S) id = (uint32_t)v;
    }
    const int nvalid = __syncthreads_count(id != kDropped);
    const unsigned long long key =
        bitonic_sort(((unsigned long long)id << 32) | (uint32_t)tid, keys);

    // heads of the runs of equal ids among the nvalid valid keys
    const uint32_t my_id = (uint32_t)(key >> 32);
    const bool head = tid < nvalid && (tid == 0 || (uint32_t)(keys[tid - 1] >> 32) != my_id);
    const unsigned heads = __ballot_sync(0xffffffffu, head);
    if (lane == 0) warp_heads[warp] = __popc(heads);
    __syncthreads();
    int before = 0, nruns = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int h = warp_heads[w];
      before += w < warp ? h : 0;
      nruns += h;
    }
    if (head) run_start[before + __popc(heads & ((1u << lane) - 1))] = tid;
    if (tid == 0) run_start[nruns] = nvalid;
    if (staged) mbar_wait(bar, parity);
    __syncthreads();

    for (int r = run_slot; r < nruns; r += run_stride) {
      const int begin = run_start[r];
      const int end = run_start[r + 1];
      float* dst = acc + (b * S + (int64_t)(keys[begin] >> 32)) * C;
      for (int g = run_lane; g < groups; g += lanes) {
        const int c = g * VEC;
        if (VEC == 4) {
          float s[4] = {0.f, 0.f, 0.f, 0.f};
          for (int j = begin; j < end; ++j) {
            const int row = (int)(keys[j] & 0xffffffffu);
            float v[4];
            load4(feats + (int64_t)row * C + c, v);
#pragma unroll
            for (int q = 0; q < 4; ++q) s[q] += v[q];
          }
          red4(dst + c, s);
        } else {
          float s = 0.f;
          for (int j = begin; j < end; ++j) {
            const int row = (int)(keys[j] & 0xffffffffu);
            s += load1(feats + (int64_t)row * C + c);
          }
          atomicAdd(dst + c, s);
        }
      }
    }
    if (staged) parity ^= 1;
    __syncthreads();  // keys, runs and the staged tile are reused
  }
}

template <typename T, int VEC, bool STAGED>
cudaError_t launch_one(const T* pts, const int32_t* ids, float* acc,
                       int64_t P, int C, int64_t S, int64_t tiles_per_item,
                       int64_t num_tiles, cudaStream_t stream) {
  auto kernel = splat_kernel<T, VEC, STAGED>;
  const int smem = STAGED ? kTile * C * (int)sizeof(T) : 0;
  static int smem_allowed = 48 * 1024;  // per instance, raised as needed
  cudaError_t err;
  if (smem > smem_allowed) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kMaxStagedBytes);
    if (err != cudaSuccess) return err;
    smem_allowed = kMaxStagedBytes;
  }
  int device = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kThreads, smem)) != cudaSuccess)
    return err;
  int64_t grid = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > num_tiles) grid = num_tiles;
  kernel<<<(unsigned)grid, kThreads, smem, stream>>>(
      pts, ids, acc, P, C, S, tiles_per_item, num_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const T* pts, const int32_t* ids, float* acc, int64_t B,
                   int64_t P, int C, int64_t S, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(pts);
  const bool vec = (C % 4 == 0) && (addr % (4 * sizeof(T)) == 0);
  const bool staged = (int64_t)kTile * C * (int64_t)sizeof(T) <= kMaxStagedBytes &&
                      addr % 16 == 0;
  const int64_t tiles_per_item = (P + kTile - 1) / kTile;
  const int64_t num_tiles = B * tiles_per_item;
  if (vec && staged)
    return launch_one<T, 4, true>(pts, ids, acc, P, C, S, tiles_per_item,
                                  num_tiles, stream);
  if (vec)
    return launch_one<T, 4, false>(pts, ids, acc, P, C, S, tiles_per_item,
                                   num_tiles, stream);
  if (staged)
    return launch_one<T, 1, true>(pts, ids, acc, P, C, S, tiles_per_item,
                                  num_tiles, stream);
  return launch_one<T, 1, false>(pts, ids, acc, P, C, S, tiles_per_item,
                                 num_tiles, stream);
}

}  // namespace

extern "C" {

// pts: (B, P, C) f32 (dtype 0) or bf16 (dtype 1), contiguous.
// ids: (B, P) int32. acc: (B, S, C) f32, zeroed by the caller.
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
int lss_splat_forward(const void* pts, int dtype, const void* ids, void* acc,
                      long long B, long long P, int C, long long S,
                      void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || S <= 0 || S > 0x7fffffffLL ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* id = static_cast<const int32_t*>(ids);
  float* out = static_cast<float*>(acc);
  if (dtype == 0) {
    return (int)launch(static_cast<const float*>(pts), id, out, B, P, C, S, s);
  }
  return (int)launch(static_cast<const __nv_bfloat16*>(pts), id, out, B, P, C,
                     S, s);
}

const char* lss_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
