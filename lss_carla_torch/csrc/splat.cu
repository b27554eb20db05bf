// Splat (voxel pooling) for Hopper (sm_90a): two kernels, one a dtype.
//
// Replaces the TPU kernel lss_carla_tpu/ops/splat_pallas.py::_splat_kernel
// (driven by _splat_single / _splat_forward, public splat_pallas_batched):
//
//     out[b, s, :] = sum over p with ids[b, p] == s of pts[b, p, :]
//
// for every batch item b and slot s in [0, S). Ids outside [0, S) -- the
// sentinel S that voxel_indices gives out-of-grid points -- are dropped and
// their features never read. All B items go in one launch.
//
// Bound on this card: bytes: every id, the in-grid points' features, and
// the dense output written once. The output dominates at the model's
// shapes (B0 at bsz 8 in f32: 82 MB out, 89 MB in; the stretch grid at bsz
// 4 in bf16: 82 MB out, 22 MB in).
//
// * bf16 takes the segment kernel (the second half of this file). It
//   writes every output row once, in bf16, from one block, and keeps no
//   accumulator in device memory: no zero fill, no f32 buffer, no cast
//   pass and no float atomics. Each slot's points are summed in f32 in
//   point order from 0 and rounded once, the plain version's arithmetic
//   (ops/library.py::splat_reference on the CPU): two calls give the same
//   bits, and so does the plain version on the CPU. One launch a call.
// * f32 takes the tile kernel (the first half): run sums added with float4
//   atomics into the output, which the wrapper zero-fills (two device
//   activities a call); the sums arrive in run-to-run order, a few f32
//   ulps of a slot's sum. The segment kernel takes f32 too and is slower
//   there on the H100 (PERF.md, PR 10): it reads each segment's feature
//   rows where the points lie, spread over the item, while the tile
//   kernel streams them in point order; at f32 the features weigh as much
//   as the output.

#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// ===== the tile kernel (f32) =====
//
// The TPU design keeps one item's accumulator resident in VMEM and adds
// rows in order. Here the adds are atomics into the f32 output in L2, and
// the design is about sending fewer of them:
//
// * Tiles. A persistent grid of blocks walks tiles of kTile = 176
//   consecutive points of one item, in item order, so the blocks in
//   flight touch one or two items' 10.2 MB outputs, which stay in the
//   50 MB L2. Tile offsets come from blockIdx: one division a tile, none a
//   point.
// * Asynchronous staging. The tile's kTile x C features are one
//   contiguous run (44 KB at C = 64). Thread 0 stages them into shared
//   memory with one TMA bulk copy (cp.async.bulk, completion on an
//   mbarrier) when the run is 16-byte aligned and fits; otherwise the
//   block reads them from global memory where it sums them.
// * Source-side reduction. While the copy is in flight, each thread loads
//   one id (256 threads, the sort's width; 80 hold no point) and the
//   block sorts the (id, point) keys (bitonic: shuffles for partners
//   within a warp, shared memory across warps). Dropped ids sort last and
//   their features, NaN in the tests, are never read. The run heads of the
//   sorted ids are compacted with a ballot scan; each run is one voxel. On
//   the main path a tile is one (camera, depth) slab of the 8 x 22 feature
//   map, and its in-grid points share ids about 8 to 1.
// * Vector atomics. A group of lanes takes a run, each lane 4 channels:
//   it sums the run's feature rows from shared memory in f32, in sorted
//   (= point) order, and sends one 16-byte vector atomicAdd (float4, a
//   global-memory RED on sm_90) per 4 channels per run. C not a multiple
//   of 4, or features not aligned for a vector load, take a scalar path
//   (one lane a channel).

// points a tile: one (camera, depth) slab of the flagship's 8 x 22 feature
// map, so a tile's runs are whole; it was measured against 256 and 512
// (PERF.md, PR 3). ops/splat_cuda.py::TILE holds the same number.
constexpr int kTile = 176;
constexpr int next_pow2(int n) { return n <= 1 ? 1 : 2 * next_pow2((n + 1) / 2); }
// threads a block: the sort's width, the least power of two >= kTile
constexpr int kTileThreads = next_pow2(kTile) < 32 ? 32 : next_pow2(kTile);
constexpr int kTileWarps = kTileThreads / 32;
static_assert(kTile > 0 && kTileThreads <= 1024, "tile of 1 to 1024 points");
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

__device__ __forceinline__ float load1(const float* p) { return *p; }

__device__ __forceinline__ void red4(float* dst, const float v[4]) {
#if defined(CUDART_VERSION) && CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float4*>(dst), make_float4(v[0], v[1], v[2], v[3]));
#else
#pragma unroll
  for (int k = 0; k < 4; ++k) atomicAdd(dst + k, v[k]);
#endif
}

// Sorts the block's kTileThreads keys ascending; thread t ends holding the key of
// rank t, which is also stored in keys[t]. Partners within a warp swap by
// shuffle; across warps through shared memory.
__device__ __forceinline__ unsigned long long bitonic_sort(
    unsigned long long key, unsigned long long* keys) {
  const int t = threadIdx.x;
#pragma unroll
  for (int k = 2; k <= kTileThreads; k <<= 1) {
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
__global__ void __launch_bounds__(kTileThreads)
    splat_kernel_tiles(const T* __restrict__ pts, const int32_t* __restrict__ ids,
                 float* __restrict__ acc, int64_t P, int C, int64_t S,
                 int64_t tiles_per_item, int64_t num_tiles) {
  extern __shared__ __align__(16) unsigned char staged_feats[];
  __shared__ unsigned long long keys[kTileThreads];
  __shared__ int run_start[kTile + 1];
  __shared__ int warp_heads[kTileWarps];
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
  const int run_stride = kTileWarps * runs_a_warp;
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
    for (int w = 0; w < kTileWarps; ++w) {
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
cudaError_t tile_launch_one(const T* pts, const int32_t* ids, float* acc,
                       int64_t P, int C, int64_t S, int64_t tiles_per_item,
                       int64_t num_tiles, cudaStream_t stream) {
  auto kernel = splat_kernel_tiles<T, VEC, STAGED>;
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
           &per_sm, kernel, kTileThreads, smem)) != cudaSuccess)
    return err;
  int64_t grid = (int64_t)sms * (per_sm > 0 ? per_sm : 1);
  if (grid > num_tiles) grid = num_tiles;
  kernel<<<(unsigned)grid, kTileThreads, smem, stream>>>(
      pts, ids, acc, P, C, S, tiles_per_item, num_tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t tile_launch(const T* pts, const int32_t* ids, float* acc, int64_t B,
                   int64_t P, int C, int64_t S, cudaStream_t stream) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(pts);
  const bool vec = (C % 4 == 0) && (addr % (4 * sizeof(T)) == 0);
  const bool staged = (int64_t)kTile * C * (int64_t)sizeof(T) <= kMaxStagedBytes &&
                      addr % 16 == 0;
  const int64_t tiles_per_item = (P + kTile - 1) / kTile;
  const int64_t num_tiles = B * tiles_per_item;
  if (vec && staged)
    return tile_launch_one<T, 4, true>(pts, ids, acc, P, C, S, tiles_per_item,
                                  num_tiles, stream);
  if (vec)
    return tile_launch_one<T, 4, false>(pts, ids, acc, P, C, S, tiles_per_item,
                                   num_tiles, stream);
  if (staged)
    return tile_launch_one<T, 1, true>(pts, ids, acc, P, C, S, tiles_per_item,
                                  num_tiles, stream);
  return tile_launch_one<T, 1, false>(pts, ids, acc, P, C, S, tiles_per_item,
                                 num_tiles, stream);
}

// ===== the segment kernel (bf16; f32 when called directly) =====
//
// One cooperative launch (every block resident, the grid sized by
// occupancy), four phases between grid-wide barriers:
//
// A. Count. Items are cut into segments of kSegSlots (R) consecutive slots
//    and points into tiles of `rounds` x 256 consecutive points. A block
//    takes a tile; each warp groups its 32 points by segment with
//    __match_any_sync and publishes (segment, count) for its groups; a
//    point's rank among the tile's earlier points of its segment follows
//    from the warps before it and its lanes before it (point order). The
//    block adds the tile's count of each segment it touches into an
//    (item, segment, tile) table, which every call leaves at 0.
// B. Scan. A warp a segment scans its row of the table over tiles
//    (exclusive, in tile order) and reserves the segment's bucket, a run
//    of n_g positions in the point scratch (from an atomic allocator:
//    where a bucket lies changes nothing but the address). A segment of
//    more than kChunkPoints (K) points is cut into ceil(n_g / K) chunks,
//    queued.
// C. Scatter. Point p of segment g in tile t goes to bucket position
//    start_g + table[g][t] + rank: every bucket holds its points in point
//    order, whatever order the blocks ran in.
// D. Sum. Blocks take work items (the queued chunks, then every other
//    segment) from a counter. For its segment the block counts each
//    slot's points a warp (each warp walks a contiguous run of the bucket,
//    so counts in warp order are counts in point order), scans them into
//    slot offsets, and places its chunk's points grouped by slot, in point
//    order, in shared memory (device memory for a chunk too large). A
//    chunk owns the slots whose first point falls in its K-point share of
//    the bucket, so no slot's run is ever split and every output row has
//    one writer: chunks need no partial sums and no combining pass. While
//    the block counts, an unsplit segment's feature rows (up to
//    kStageBytes) are copied into shared memory by cp.async, the row of
//    bucket entry i at row i, so the sums read shared memory; gathering
//    them from device memory where they are needed ran at a fraction of
//    the card's rate. The rows without points are stored as zeros; a
//    group of lanes (16 bytes of channels a lane) sums the runs of a few
//    rows at once, each in point order in f32 in registers, and stores
//    each row once as 16-byte vectors in the output dtype. C not a
//    multiple of the vector width, or unaligned pointers, take a scalar
//    path (one channel a lane) and no staging.
//
// Skew: a chunk's work is at most K points plus the rest of its last
// slot's run; one voxel's points are one serial chain of adds, summed by
// one lane group. What holds it back (PERF.md, PR 10): each item is a
// chain of dependent steps (bucket loads, counts, a block scan, placement,
// stores) with a few blocks an SM in flight; the count phase, whose warps
// scan each other's (segment, count) lists; and the three grid barriers.

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// slots a segment (R): one thread a slot in the block's slot scan.
// ops/splat_cuda.py::SEG_SLOTS holds the same number.
constexpr int kSegSlots = 256;
// points a chunk (K). ops/splat_cuda.py::CHUNK_POINTS holds the same.
constexpr int kChunkPoints = 512;
static_assert(kSegSlots == kThreads, "the slot scan takes one thread a slot");
static_assert(kSegSlots <= 256, "a slot within its segment is one byte");
// points of a segment's bucket whose slots stay in shared memory, and of
// a chunk's grouped points; more are read from device memory
constexpr int kCache = 2048;
static_assert(kCache >= kChunkPoints, "an unsplit segment fits");
// shared memory for the feature rows of an unsplit segment, staged by
// cp.async in bucket order while the block groups its points
constexpr int kStageBytes = 48 * 1024;

struct Params {
  const void* pts;
  const int32_t* ids;
  void* out;
  int64_t B, P, S;
  int C;
  int64_t nseg;    // segments an item
  int64_t tiles;   // tiles an item
  int rounds;      // 256-point rounds a tile
  int32_t* ctl;    // [0] bucket allocator, [1] queued chunks, [2] work counter
  int32_t* table;  // (B * nseg, tiles) counts, then offsets; left at 0
  long long* chunks;  // queued chunks: segment << 32 | chunk
  int32_t* seg_start;
  int32_t* seg_count;
  int32_t* rank;     // (B * P) rank within its tile and segment
  int32_t* bucket;   // points by segment, in point order
  int32_t* grouped;  // a chunk's points by slot, when too many for shared memory
  uint8_t* bucket_slot;  // their slots within the segment

};

struct Shared {
  // phase A: each warp's (segment, count) groups
  int list_seg[kWarps][32];
  int list_n[kWarps][32];
  int list_len[kWarps];
  // phase D: per-warp slot counts, then bases; the slots' offsets
  int cnt[kWarps][kSegSlots];
  int slot_start[kSegSlots];
  int slot_total[kSegSlots];
  int slot_chunk[kSegSlots];
  int busy[kSegSlots];  // the chunk's slots that have points
  uint8_t cache_slot[kCache];  // the bucket's slots, when they fit
  int grouped[kCache];  // the chunk's points by slot, when they fit
  int warp_sum[kWarps];
  int nbusy, chunk_lo, chunk_n;
  int item;
};

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// VEC channels of a row, summed in f32: 16-byte vectors (4 f32, 8 bf16)
// or one channel.
template <typename T, int VEC>
struct Vec;

template <>
struct Vec<float, 4> {
  using Raw = float4;
  __device__ static Raw load(const float* p) { return *reinterpret_cast<const float4*>(p); }
  __device__ static void add(float acc[4], const Raw& r) {
    acc[0] += r.x;
    acc[1] += r.y;
    acc[2] += r.z;
    acc[3] += r.w;
  }
  __device__ static void store(float* p, const float acc[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(acc[0], acc[1], acc[2], acc[3]);
  }
};

template <>
struct Vec<__nv_bfloat16, 8> {
  using Raw = uint4;
  __device__ static Raw load(const __nv_bfloat16* p) { return *reinterpret_cast<const uint4*>(p); }
  __device__ static void add(float acc[8], const Raw& r) {
    const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[k]));
      acc[2 * k] += f.x;
      acc[2 * k + 1] += f.y;
    }
  }
  __device__ static void store(__nv_bfloat16* p, const float acc[8]) {
    uint32_t w[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(acc[2 * k], acc[2 * k + 1]);
      w[k] = *reinterpret_cast<const uint32_t*>(&h);
    }
    *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
  }
};

template <>
struct Vec<float, 1> {
  using Raw = float;
  __device__ static Raw load(const float* p) { return *p; }
  __device__ static void add(float acc[1], const Raw& r) { acc[0] += r; }
  __device__ static void store(float* p, const float acc[1]) { *p = acc[0]; }
};

template <>
struct Vec<__nv_bfloat16, 1> {
  using Raw = float;
  __device__ static Raw load(const __nv_bfloat16* p) { return __bfloat162float(*p); }
  __device__ static void add(float acc[1], const Raw& r) { acc[0] += r; }
  __device__ static void store(__nv_bfloat16* p, const float acc[1]) {
    *p = __float2bfloat16_rn(acc[0]);
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Exclusive scan of one int a thread over the block.
__device__ __forceinline__ int block_exclusive_scan(int v, int* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) before += w < warp ? warp_sum[w] : 0;
  __syncthreads();  // warp_sum is reused
  return before + x - v;
}

// A. Ranks within (tile, segment) and the table's counts: a block a tile
// of `rounds` x 256 points, a round's warps in order.
__device__ void count_phase(const Params& p, Shared& sh) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t tile_points = (int64_t)p.rounds * kThreads;
  for (int64_t tile = blockIdx.x; tile < p.B * p.tiles; tile += gridDim.x) {
    const int64_t b = tile / p.tiles;
    const int64_t t = tile - b * p.tiles;
    int32_t* col = p.table + b * p.nseg * p.tiles + t;  // entry g at g * tiles
    for (int r = 0; r < p.rounds; ++r) {
      const int64_t pt = t * tile_points + (int64_t)r * kThreads + tid;
      int key = -1;
      if (pt < p.P) {
        const int32_t id = __ldg(p.ids + b * p.P + pt);
        if (id >= 0 && (int64_t)id < p.S) key = id / kSegSlots;
      }
      // each warp's groups of one segment, published as (segment, count)
      const unsigned same = __match_any_sync(0xffffffffu, key);
      const bool leader = (same & lanemask_lt()) == 0;
      const unsigned leaders = __ballot_sync(0xffffffffu, leader && key >= 0);
      if (leader && key >= 0) {
        const int e = __popc(leaders & lanemask_lt());
        sh.list_seg[warp][e] = key;
        sh.list_n[warp][e] = __popc(same);
      }
      if (lane == 0) sh.list_len[warp] = __popc(leaders);
      __syncthreads();
      int before = 0, total = 0, base = 0;
      if (key >= 0) {
        for (int w = 0; w < kWarps; ++w) {
          for (int e = 0; e < sh.list_len[w]; ++e) {
            if (sh.list_seg[w][e] == key) {
              const int n = sh.list_n[w][e];
              before += w < warp ? n : 0;
              total += n;
            }
          }
        }
        if (r > 0) base = __ldcg(col + (int64_t)key * p.tiles);  // else 0
        p.rank[b * p.P + pt] = base + before + __popc(same & lanemask_lt());
      }
      __syncthreads();  // every point has read its segment's count
      if (key >= 0 && leader && before == 0) col[(int64_t)key * p.tiles] = base + total;
      __syncthreads();  // the counts are in place for the next round
    }
  }
}

// B. A warp a segment: exclusive scan of its row over tiles, its bucket,
// and its chunks queued when it has more than K points.
__device__ void scan_phase(const Params& p) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = (int64_t)gridDim.x * kWarps;
  for (int64_t s = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
       s < p.B * p.nseg; s += warps) {
    int32_t* row = p.table + s * p.tiles;
    int carry = 0;
    for (int64_t t0 = 0; t0 < p.tiles; t0 += 32) {
      const bool in = t0 + lane < p.tiles;
      const int v = in ? __ldcg(row + t0 + lane) : 0;
      int x = v;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, x, o);
        if (lane >= o) x += y;
      }
      if (in) row[t0 + lane] = carry + x - v;
      carry += __shfl_sync(0xffffffffu, x, 31);
    }
    if (lane == 0) {
      p.seg_start[s] = atomicAdd(p.ctl + 0, carry);
      p.seg_count[s] = carry;
      const int m = (carry + kChunkPoints - 1) / kChunkPoints;
      if (m > 1) {
        const int at = atomicAdd(p.ctl + 1, m);
        for (int j = 0; j < m; ++j)
          p.chunks[at + j] = ((long long)s << 32) | (long long)j;
      }
    }
  }
}

// C. Every in-grid point to its bucket position.
__device__ void scatter_phase(const Params& p) {
  const int64_t tile_points = (int64_t)p.rounds * kThreads;
  const int64_t n = p.B * p.P;
  for (int64_t i = (int64_t)blockIdx.x * kThreads + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * kThreads) {
    const int32_t id = __ldg(p.ids + i);
    if (id < 0 || (int64_t)id >= p.S) continue;
    const int64_t b = i / p.P;
    const int64_t pt = i - b * p.P;
    const int64_t s = b * p.nseg + id / kSegSlots;
    const int pos = __ldcg(p.seg_start + s) +
                    __ldcg(p.table + s * p.tiles + pt / tile_points) +
                    __ldcg(p.rank + i);
    p.bucket[pos] = (int32_t)pt;
    p.bucket_slot[pos] = (uint8_t)(id % kSegSlots);
  }
}

// D. One work item: chunk j of segment s, all its rows.
template <typename T, int VEC>
__device__ void sum_item(const Params& p, Shared& sh, unsigned char* stage,
                         int64_t s, int j) {
  // rows a lane group sums at once: their loads are in flight together
  constexpr int U = VEC == 8 ? 2 : 4;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int64_t b = s / p.nseg;
  const int64_t slot0 = (s - b * p.nseg) * kSegSlots;
  const int n = __ldcg(p.seg_count + s);
  const int start = __ldcg(p.seg_start + s);
  const int m = n > kChunkPoints ? (n + kChunkPoints - 1) / kChunkPoints : 1;
  const bool cached = n <= kCache;
  const int32_t* bucket = p.bucket + start;
  const uint8_t* bucket_slot = p.bucket_slot + start;
  const T* pts = static_cast<const T*>(p.pts) + b * p.P * p.C;
  T* out = static_cast<T*>(p.out) + (b * p.S + slot0) * p.C;
  // an unsplit segment's rows go to shared memory (bucket order) by
  // cp.async while the block groups its points: 16-byte rows only
  const int row_bytes = p.C * (int)sizeof(T);
  const bool staged = VEC > 1 && m == 1 && n * row_bytes <= kStageBytes;

  for (int k = tid; k < kWarps * kSegSlots; k += kThreads) (&sh.cnt[0][0])[k] = 0;
  if (tid == 0) {
    sh.nbusy = 0;
    sh.chunk_lo = n;
    sh.chunk_n = 0;
  }
  if (j == 0) {  // the table's row goes back to 0 for the next call
    for (int64_t t = tid; t < p.tiles; t += kThreads) p.table[s * p.tiles + t] = 0;
  }
  __syncthreads();

  // each warp walks a contiguous run of the bucket, [lo, hi), so counts
  // in warp order are counts in point order; a staged point's row goes to
  // shared memory by cp.async, its lane issuing the row's 16-byte pieces
  const int per_warp = (n + kWarps - 1) / kWarps;
  const int lo = min(n, warp * per_warp), hi = min(n, lo + per_warp);
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    int key = -1;
    if (i < hi) {
      key = __ldcg(bucket_slot + i);
      if (cached) sh.cache_slot[i] = (uint8_t)key;
      if (staged) {
        const unsigned char* src =
            reinterpret_cast<const unsigned char*>(pts + (int64_t)__ldcg(bucket + i) * p.C);
        for (int k = 0; k < row_bytes; k += 16)
          cp_async16(stage + (size_t)i * row_bytes + k, src + k);
      }
    }
    const unsigned same = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && (same & lanemask_lt()) == 0) sh.cnt[warp][key] += __popc(same);
    __syncwarp();
  }
  if (staged) asm volatile("cp.async.commit_group;\n" ::: "memory");
  __syncthreads();

  // slot tid: its total, the warps' bases before it, its offset and chunk
  int total = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = sh.cnt[w][tid];
    sh.cnt[w][tid] = total;
    total += c;
  }
  const int first = block_exclusive_scan(total, sh.warp_sum);
  const int chunk = min(first / kChunkPoints, m - 1);
  sh.slot_start[tid] = first;
  sh.slot_total[tid] = total;
  sh.slot_chunk[tid] = chunk;
  if (chunk == j && total > 0) {  // integer min and sum: any order
    atomicMin(&sh.chunk_lo, first);
    atomicAdd(&sh.chunk_n, total);
    sh.busy[atomicAdd(&sh.nbusy, 1)] = tid;
  }
  __syncthreads();
  const int chunk_lo = sh.chunk_lo;
  int* grouped = sh.chunk_n <= kCache ? sh.grouped - chunk_lo : p.grouped + start;

  // this chunk's points grouped by slot, in point order: their bucket
  // positions when staged, else the points
  for (int i0 = lo; i0 < hi; i0 += 32) {
    const int i = i0 + lane;
    int key = -1, at = 0;
    if (i < hi) {
      const int sl = cached ? sh.cache_slot[i] : __ldcg(bucket_slot + i);
      if (sh.slot_chunk[sl] == j) {
        key = sl;
        at = staged ? i : __ldcg(bucket + i);
      }
    }
    const unsigned same = __match_any_sync(0xffffffffu, key);
    if (key >= 0)
      grouped[sh.slot_start[key] + sh.cnt[warp][key] + __popc(same & lanemask_lt())] = at;
    __syncwarp();
    if (key >= 0 && (same & lanemask_lt()) == 0) sh.cnt[warp][key] += __popc(same);
    __syncwarp();
  }
  if (staged) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int groups = p.C / VEC;  // channel vectors a row
  const int nslots = (int)min((int64_t)kSegSlots, p.S - slot0);

  // the chunk's rows without points: zeros, every thread a vector
  const float zero[VEC] = {};
  if (groups <= kThreads) {  // rows a pass: kThreads / groups
    const int step = kThreads / groups, g = tid % groups;
    for (int sl = tid / groups; sl < nslots && tid < step * groups; sl += step) {
      if (sh.slot_chunk[sl] == j && sh.slot_total[sl] == 0)
        Vec<T, VEC>::store(out + (int64_t)sl * p.C + g * VEC, zero);
    }
  } else {
    for (int sl = 0; sl < nslots; ++sl) {
      if (sh.slot_chunk[sl] != j || sh.slot_total[sl] != 0) continue;
      for (int g = tid; g < groups; g += kThreads)
        Vec<T, VEC>::store(out + (int64_t)sl * p.C + g * VEC, zero);
    }
  }

  // rows with points: a group of lanes sums U slots' runs at once, each
  // in point order in f32 from 0, and writes each row once
  int lanes_log2 = 0;
  while ((1 << lanes_log2) < groups && lanes_log2 < 5) ++lanes_log2;
  const int lanes = 1 << lanes_log2;
  const int ngroups = kThreads / lanes;
  const int group = tid >> lanes_log2;
  const int glane = tid & (lanes - 1);
  const int nbusy = sh.nbusy;
  const T* rows = staged ? reinterpret_cast<const T*>(stage) : pts;
  for (int e0 = group; e0 < nbusy; e0 += ngroups * U) {
    int begin[U], len[U], row[U];
    int most = 0;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = e0 + u * ngroups;
      const int sl = e < nbusy ? sh.busy[e] : 0;
      row[u] = sl;
      begin[u] = sh.slot_start[sl];
      len[u] = e < nbusy && sl < nslots ? sh.slot_total[sl] : 0;
      most = max(most, len[u]);
    }
    for (int g = glane; g < groups; g += lanes) {
      const int c = g * VEC;
      float acc[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int v = 0; v < VEC; ++v) acc[u][v] = 0.f;
      for (int k = 0; k < most; ++k) {
        typename Vec<T, VEC>::Raw r[U];
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k < len[u]) r[u] = Vec<T, VEC>::load(rows + (int64_t)grouped[begin[u] + k] * p.C + c);
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (k < len[u]) Vec<T, VEC>::add(acc[u], r[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (len[u] > 0) Vec<T, VEC>::store(out + (int64_t)row[u] * p.C + c, acc[u]);
    }
  }
  __syncthreads();  // shared memory is reused by the next item
}

// The whole call in one cooperative launch: A-C, then D for every item.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 3) splat_kernel_segments(const Params p) {
  __shared__ Shared sh;
  extern __shared__ __align__(16) unsigned char stage[];
  cg::grid_group grid = cg::this_grid();
  if (blockIdx.x == 0 && threadIdx.x < 3) p.ctl[threadIdx.x] = 0;
  count_phase(p, sh);
  grid.sync();
  scan_phase(p);
  grid.sync();
  scatter_phase(p);
  grid.sync();
  const int queued = __ldcg(p.ctl + 1);
  const int64_t items = queued + p.B * p.nseg;
  if (threadIdx.x == 0) sh.item = atomicAdd(p.ctl + 2, 1);
  __syncthreads();
  for (;;) {
    const int64_t item = sh.item;
    __syncthreads();
    if (item >= items) break;
    int next = 0;  // the next item's fetch overlaps this one
    if (threadIdx.x == 0) next = atomicAdd(p.ctl + 2, 1);
    if (item < queued) {
      const long long e = __ldcg(p.chunks + item);
      sum_item<T, VEC>(p, sh, stage, e >> 32, (int)(e & 0xffffffffLL));
    } else if (__ldcg(p.seg_count + (item - queued)) <= kChunkPoints) {
      sum_item<T, VEC>(p, sh, stage, item - queued, 0);
    }  // else: its chunks were queued
    if (threadIdx.x == 0) sh.item = next;
    __syncthreads();
  }
}

int cached_grid[2][2][16];  // [bf16][vector][device]: a full cooperative grid

template <typename T, int VEC>
cudaError_t segment_launch_one(const Params& p, cudaStream_t stream) {
  auto kernel = splat_kernel_segments<T, VEC>;
  cudaError_t err;
  int device = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  int& full = cached_grid[sizeof(T) == 2][VEC > 1][device & 15];
  if (full == 0) {
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    kStageBytes)) != cudaSuccess)
      return err;
    int sms = 0, per_sm = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      device)) != cudaSuccess)
      return err;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kernel, kThreads, kStageBytes)) != cudaSuccess)
      return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    full = sms * per_sm;
  }
  // no more blocks than the largest phase has work for
  int64_t work = p.B * p.tiles;
  const int64_t pts_blocks = (p.B * p.P + kThreads - 1) / kThreads;
  if (pts_blocks > work) work = pts_blocks;
  if (p.B * p.nseg > work) work = p.B * p.nseg;
  const unsigned grid = (unsigned)(work < full ? work : full);
  Params args = p;
  void* argv[] = {&args};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<void*>(kernel), dim3(grid),
                                    dim3(kThreads), argv, kStageBytes, stream);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// pts: (B, P, C) f32, contiguous. ids: (B, P) int32. acc: (B, S, C) f32,
// zeroed by the caller. Launches on `stream` and returns the launch's
// cudaError_t (0 on success).
int lss_splat_tiles_forward(const void* pts, const void* ids, void* acc,
                            long long B, long long P, int C, long long S,
                            void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || S <= 0 || S > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  return (int)tile_launch(static_cast<const float*>(pts),
                          static_cast<const int32_t*>(ids),
                          static_cast<float*>(acc), B, P, C, S,
                          static_cast<cudaStream_t>(stream));
}

// pts: (B, P, C) f32 (dtype 0) or bf16 (dtype 1), contiguous. ids: (B, P)
// int32. out: (B, S, C) in pts' dtype; every element is written. rounds:
// 256-point rounds a tile (ops/splat_cuda.py::plan_splat). work: int32
// scratch of work_ints, 8-byte aligned; table: int32 scratch of
// table_ints, all 0 before the first call (every call leaves it at 0).
// Launches on `stream` and returns the launch's cudaError_t (0 on success).
int lss_splat_segments_forward(const void* pts, int dtype, const void* ids, void* out,
                      long long B, long long P, int C, long long S,
                      int rounds, void* work, long long work_ints, void* table,
                      long long table_ints, void* stream) {
  if (B <= 0 || P <= 0 || C <= 0 || S <= 0 || S > 0x7fffffffLL ||
      B * P > 0x7fffffffLL || rounds <= 0 || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Params p{};
  p.pts = pts;
  p.ids = static_cast<const int32_t*>(ids);
  p.out = out;
  p.B = B;
  p.P = P;
  p.S = S;
  p.C = C;
  p.nseg = (S + kSegSlots - 1) / kSegSlots;
  p.rounds = rounds;
  p.tiles = (P + (long long)rounds * kThreads - 1) / ((long long)rounds * kThreads);
  // the layout ops/splat_cuda.py::plan_splat sizes
  const long long chunk_cap = 2 * B * P / kChunkPoints + 1;
  const long long segs = B * p.nseg;
  const long long need_work = 2 * chunk_cap + 2 * segs + 3 * B * P + (B * P + 3) / 4;
  const long long need_table = 4 + segs * p.tiles;
  if (work_ints < need_work || table_ints < need_table ||
      (reinterpret_cast<uintptr_t>(work) & 7) != 0 || segs > 0x7fffffffLL) {
    return (int)cudaErrorInvalidValue;
  }
  int32_t* w = static_cast<int32_t*>(work);
  p.chunks = reinterpret_cast<long long*>(w);
  p.seg_start = w + 2 * chunk_cap;
  p.seg_count = p.seg_start + segs;
  p.rank = p.seg_count + segs;
  p.bucket = p.rank + B * P;
  p.grouped = p.bucket + B * P;
  p.bucket_slot = reinterpret_cast<uint8_t*>(p.grouped + B * P);
  p.ctl = static_cast<int32_t*>(table);
  p.table = p.ctl + 4;

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte vectors: C a multiple of them, both tensors 16-byte aligned
  const bool vec = C % (dtype == 0 ? 4 : 8) == 0 &&
                   (reinterpret_cast<uintptr_t>(pts) & 15) == 0 &&
                   (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  if (dtype == 0) {
    return (int)(vec ? segment_launch_one<float, 4>(p, s)
                     : segment_launch_one<float, 1>(p, s));
  }
  return (int)(vec ? segment_launch_one<__nv_bfloat16, 8>(p, s)
                   : segment_launch_one<__nv_bfloat16, 1>(p, s));
}

const char* lss_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
