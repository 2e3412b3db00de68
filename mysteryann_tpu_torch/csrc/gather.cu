// Row gather for Hopper (sm_90a): out[i] = table[idx[i]] for a table of
// any row width and dtype, copied as raw bytes.
//
// Replaces the Pallas TPU kernel mysteryann_tpu/ops/gather.py::_gather_kernel
// (one async DMA per row, indices scalar-prefetched into SMEM). Every row
// fetch of the port goes through it: neighbour rows and neighbour vectors in
// the beam search, candidate vectors in the occlusion prune, the build's
// supply / reverse rows, the fused engine's byte rows, the flat and IVF
// reranks and the IVF index's cluster blocks.
//
// What bounds it on the card: bytes. Each gathered row is read once from a
// random place in HBM and written once, and each index is read once; at
// 3.35 TB/s that is the least time a call can take. A random row read waits
// ~1 us on HBM, so the kernel nears that rate only with tens of KB in
// flight on every SM, and a row's copy should not wait on a dependent index
// load. The launch plan (path, word, tile, loads, segment, grid) is chosen
// on the host by ops/gather.py::_plan, once per row width, alignment and
// index-count bucket, and passed in; nothing here queries the device per
// launch. Two paths:
//
//   narrow  (row bytes a multiple of 16, at most 2 KB, both pointers 16-B
//           aligned: f32 x 128 vectors, i32 adjacency rows, bf16 / int8
//           rows). A warp owns a tile of 32 rows and loads the tile's 32
//           indices with one coalesced load, a tile ahead of the copy, so no
//           row waits on its index. The tile's rows are one flat run of
//           16-byte words; every lane issues kLoads (8 for rows of 512 B and
//           more, else 4) non-coherent 16-byte loads, rows picked by
//           __shfl_sync of the tile's indices, before its first store, so a
//           warp keeps 2-4 KB in flight. Registers are capped at 64 so four
//           256-thread blocks share an SM; the grid is persistent: the
//           occupancy the CUDA runtime reports, times the SMs.
//   register (every other row: the fused engine's 2,304-6,528 B byte rows,
//           the IVF index's 100-400 KB cluster blocks, and rows whose width
//           or pointers are not 16-B aligned). A group of lanes per row,
//           16-, 4- or 1-byte words through registers; rows of 8 KB and more
//           are cut into segments of 32 x kUnroll words, one warp each, with
//           every lane's kUnroll loads issued before its first store, so a
//           call of 4 blocks still spreads over the card.
//
// Wider rows reach ~82% of the byte bound on the register path, about what
// a device-to-device copy reaches. A design that staged them through shared
// memory with Hopper's bulk copy engine (cp.async.bulk global -> shared ->
// global, a ring of mbarrier-counted stages per one-warp block) tied it on
// 6,528 B rows and lost by 2-25% at the other byte-row and block shapes
// (PERF.md, K1's A/B), so it is not kept.
//
// An index outside [0, n_rows) reads nothing on either path: its output row
// is zeroed and the device error flag is set, so a caller's bad clamp shows
// up instead of reading out of bounds. Every kernel lives in namespace
// msann_k1, so a profiler trace finds K1 by that name.

#include <cuda_runtime.h>
#include <stdint.h>

namespace msann_k1 {

constexpr unsigned kFull = 0xffffffffu;

// ---- plan, as ops/gather.py::_plan packs it (int64 fields, in order) ----
enum PlanField {
  kPath = 0,      // 0 narrow, 1 register
  kRowBytes,      // bytes per row
  kWord,          // bytes per word moved through registers: 16, 4 or 1
  kTile,          // narrow: rows per warp tile; register: lanes per row
  kLaneLoads,     // narrow: 16-byte loads in flight per lane (4 or 8)
  kSegBytes,      // register: bytes per segment (0: whole rows)
  kGrid,          // blocks
  kThreads,       // threads per block
  kPlanFields
};
enum Path { kNarrow = 0, kRegister = 1 };

// ------------------------------- narrow ------------------------------------
constexpr int kNarrowThreads = 256;
constexpr int kNarrowBlocksPerSM = 4;   // caps registers at 64 a thread
constexpr int kTileRows = 32;       // rows per warp tile (at most 32)

template <typename IdxT>
__device__ __forceinline__ int64_t load_index(const IdxT* __restrict__ idx,
                                              int64_t i, int64_t n_idx) {
  return i < n_idx ? (int64_t)__ldg(idx + i) : -1;
}

template <typename IdxT, int kLoads>
__global__ void __launch_bounds__(kNarrowThreads, kNarrowBlocksPerSM)
narrow_rows_kernel(const uint4* __restrict__ table, int64_t n_rows,
                   int words, const IdxT* __restrict__ idx, int64_t n_idx,
                   uint4* __restrict__ out, int* __restrict__ err) {
  const int lane = threadIdx.x & 31;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  const int64_t n_tiles = (n_idx + kTileRows - 1) / kTileRows;
  // lane j < kTileRows holds the row of the tile's j-th index
  auto tile_row = [&](int64_t t) -> int64_t {
    return lane < kTileRows ? load_index(idx, t * kTileRows + lane, n_idx)
                            : -1;
  };
  int64_t tile = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  int64_t next = tile < n_tiles ? tile_row(tile) : -1;
  for (; tile < n_tiles; tile += n_warps) {
    const int64_t row = next;    // this lane's row of the tile
    if (tile + n_warps < n_tiles) next = tile_row(tile + n_warps);
    const int64_t i0 = tile * kTileRows;
    const int rows =
        (int)(n_idx - i0 < kTileRows ? n_idx - i0 : kTileRows);
    const bool bad = lane < rows && (row < 0 || row >= n_rows);
    if (__any_sync(kFull, bad) && lane == 0) atomicExch(err, 1);
    uint4* dst = out + i0 * words;
    const unsigned total = (unsigned)(rows * words);
    for (unsigned base = 0; base < total; base += 32 * kLoads) {
      uint4 v[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const unsigned j = base + u * 32 + lane;
        const unsigned r = j / (unsigned)words;
        const int64_t src = __shfl_sync(kFull, row, (int)(r % kTileRows));
        v[u] = make_uint4(0, 0, 0, 0);
        if (j < total && src >= 0 && src < n_rows)
          v[u] = __ldg(table + src * words + (j - r * (unsigned)words));
      }
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        const unsigned j = base + u * 32 + lane;
        if (j < total) dst[j] = v[u];
      }
    }
  }
}

// ------------------------------ register -----------------------------------
template <typename Word>
__global__ void gather_rows_kernel(const char* __restrict__ table,
                                   int64_t n_rows, int64_t row_bytes,
                                   const void* __restrict__ idx, int idx_is_64,
                                   int64_t n_idx, char* __restrict__ out,
                                   int* __restrict__ err, int group) {
  const int64_t words = row_bytes / (int64_t)sizeof(Word);
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  const int64_t n_threads = (int64_t)gridDim.x * blockDim.x;
  const int lane = (int)(tid % group);
  const int64_t groups = n_threads / group;
  for (int64_t i = tid / group; i < n_idx; i += groups) {
    const int64_t r = idx_is_64 ? static_cast<const int64_t*>(idx)[i]
                                : (int64_t) static_cast<const int32_t*>(idx)[i];
    Word* dst = reinterpret_cast<Word*>(out + i * row_bytes);
    if (r < 0 || r >= n_rows) {
      const Word zero = Word();
      for (int64_t w = lane; w < words; w += group) dst[w] = zero;
      if (lane == 0) atomicExch(err, 1);
      continue;
    }
    const Word* src = reinterpret_cast<const Word*>(table + r * row_bytes);
    for (int64_t w = lane; w < words; w += group) dst[w] = src[w];
  }
}

constexpr int kUnroll = 4;

template <typename Word>
__global__ void gather_segments_kernel(const char* __restrict__ table,
                                       int64_t n_rows, int64_t row_bytes,
                                       const void* __restrict__ idx,
                                       int idx_is_64, int64_t n_idx,
                                       char* __restrict__ out,
                                       int* __restrict__ err) {
  constexpr int64_t kSeg = 32 * kUnroll;  // words per segment
  const int64_t words = row_bytes / (int64_t)sizeof(Word);
  const int64_t n_seg = (words + kSeg - 1) / kSeg;
  const int lane = threadIdx.x & 31;
  const int64_t warp = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int64_t n_warps = ((int64_t)gridDim.x * blockDim.x) >> 5;
  for (int64_t item = warp; item < n_idx * n_seg; item += n_warps) {
    const int64_t i = item / n_seg;
    const int64_t w0 = (item - i * n_seg) * kSeg + lane;
    const int64_t r = idx_is_64 ? static_cast<const int64_t*>(idx)[i]
                                : (int64_t) static_cast<const int32_t*>(idx)[i];
    Word* dst = reinterpret_cast<Word*>(out + i * row_bytes);
    if (r < 0 || r >= n_rows) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t w = w0 + u * 32;
        if (w < words) dst[w] = Word();
      }
      if (w0 == 0) atomicExch(err, 1);
      continue;
    }
    const Word* src = reinterpret_cast<const Word*>(table + r * row_bytes);
    Word v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t w = w0 + u * 32;
      if (w < words) v[u] = src[w];
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t w = w0 + u * 32;
      if (w < words) dst[w] = v[u];
    }
  }
}

template <typename Word>
void launch_register(const int64_t* p, const void* table, int64_t n_rows,
                     const void* idx, int i64, int64_t n_idx, void* out,
                     int* err, cudaStream_t s) {
  const dim3 grid((unsigned)p[kGrid]), block((unsigned)p[kThreads]);
  const char* t = static_cast<const char*>(table);
  char* o = static_cast<char*>(out);
  if (p[kSegBytes] > 0)
    gather_segments_kernel<Word><<<grid, block, 0, s>>>(
        t, n_rows, p[kRowBytes], idx, i64, n_idx, o, err);
  else
    gather_rows_kernel<Word><<<grid, block, 0, s>>>(
        t, n_rows, p[kRowBytes], idx, i64, n_idx, o, err, (int)p[kTile]);
}

template <typename IdxT>
void launch_narrow(const int64_t* p, const void* table, int64_t n_rows,
                   const void* idx, int64_t n_idx, void* out, int* err,
                   cudaStream_t s) {
  const dim3 grid((unsigned)p[kGrid]), block((unsigned)p[kThreads]);
  const uint4* t = static_cast<const uint4*>(table);
  const IdxT* ix = static_cast<const IdxT*>(idx);
  uint4* o = static_cast<uint4*>(out);
  const int words = (int)(p[kRowBytes] / 16);
  if (p[kLaneLoads] == 4)
    narrow_rows_kernel<IdxT, 4><<<grid, block, 0, s>>>(t, n_rows, words, ix,
                                                        n_idx, o, err);
  else
    narrow_rows_kernel<IdxT, 8><<<grid, block, 0, s>>>(t, n_rows, words, ix,
                                                        n_idx, o, err);
}

}  // namespace msann_k1

using namespace msann_k1;

// What the host plan needs to know of the current device, read once per
// device (ops/gather.py::DeviceInfo): info[0] SMs, info[1] the narrow
// kernels' least occupancy in 256-thread blocks per SM.
extern "C" int msann_gather_setup(int64_t* info) {
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const void* narrow[4] = {(const void*)narrow_rows_kernel<int32_t, 4>,
                           (const void*)narrow_rows_kernel<int32_t, 8>,
                           (const void*)narrow_rows_kernel<int64_t, 4>,
                           (const void*)narrow_rows_kernel<int64_t, 8>};
  int occ = 1 << 30;
  for (int k = 0; rc == cudaSuccess && k < 4; ++k) {
    int n = 0;
    rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, narrow[k],
                                                       kNarrowThreads, 0);
    occ = n < occ ? n : occ;
  }
  if (rc != cudaSuccess) return (int)rc;
  info[0] = sms;
  info[1] = occ;
  return (int)cudaSuccess;
}

// out[i] = table[idx[i]]. One argument, so the host passes a single packed
// buffer (ops/gather.py::_pack_args) rather than converting nine: a[0]
// table, a[1] its rows, a[2] idx, a[3] 1 for int64 indices, a[4] their
// count, a[5] out, a[6] the error flag, a[7] the stream, a[8] the plan
// (kPlanFields int64s, see PlanField). Returns the launch's CUDA error (0
// when it was queued).
extern "C" int msann_gather(const int64_t* a) {
  const void* table = reinterpret_cast<const void*>(a[0]);
  const int64_t n_rows = a[1], idx_is_64 = a[3], n_idx = a[4];
  const void* idx = reinterpret_cast<const void*>(a[2]);
  void* out = reinterpret_cast<void*>(a[5]);
  int* e = reinterpret_cast<int*>(a[6]);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a[7]);
  const int64_t* plan = reinterpret_cast<const int64_t*>(a[8]);
  if (n_idx <= 0 || plan[kRowBytes] <= 0) return (int)cudaSuccess;
  if (plan[kPath] == kNarrow) {
    if (idx_is_64)
      launch_narrow<int64_t>(plan, table, n_rows, idx, n_idx, out, e, s);
    else
      launch_narrow<int32_t>(plan, table, n_rows, idx, n_idx, out, e, s);
  } else {
    const int i64 = idx_is_64 ? 1 : 0;
    if (plan[kWord] == 16)
      launch_register<uint4>(plan, table, n_rows, idx, i64, n_idx, out, e, s);
    else if (plan[kWord] == 4)
      launch_register<uint32_t>(plan, table, n_rows, idx, i64, n_idx, out, e,
                                s);
    else
      launch_register<uint8_t>(plan, table, n_rows, idx, i64, n_idx, out, e,
                               s);
  }
  return (int)cudaGetLastError();
}
