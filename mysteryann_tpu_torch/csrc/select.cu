// k-selection for Hopper (sm_90a): the k smallest entries of every row of a
// float32 matrix, ascending, ties to the lower column -- kernel K3 of the
// port.
//
// Replaces the TPU's partial-reduce selection, which the JAX package reaches
// through jax.lax.approx_min_k (mysteryann_tpu/search/seeding.py:54;
// ops/knn.py:76, :228, :240, :309, :322; ops/scan.py:152) and the exact
// jax.lax.top_k (ops/knn.py:36, :78; flat.py:53; ivf.py:58, :131, :201,
// :219, :231, :249): the exact and int8 kNN tiles and their running
// merges, the flat index's rerank, the binned scan's bin top-k, the IVF
// index's probe choice, per-chunk selection, merge and rerank, and the
// merge of the fused score kernel's (score_select.cu) partial results.
// ops/sort.py::topk_smallest routes every CUDA call here (ops/select.py):
// k <= 256 to the warp queue, any larger k to the wide route.
//
// Order: the composite (order image, column) key of k3_queue.cuh, formed in
// registers. The k smallest keys, ascending, are exactly what the plain
// version selects, on any input: selection adds no arithmetic. The values
// written are the row's own bits at the chosen columns, so a -0.0 keeps its
// sign.
//
// What bounds it on the card: bytes. Every element is read once from HBM
// (rows x n x 4 bytes) and k values and indices are written per row; at
// 3.35 TB/s that is the least time a call takes, and the work per element
// must stay a few instructions to keep up.
//
// Warp route (k <= 256; Faiss's WarpSelect, arXiv 1702.08734). A warp owns
// a row, or W warps of one block share a long row when rows are few. Each
// lane issues kUnroll coalesced loads (a warp reads 32 consecutive
// elements per load) before it looks at any, forms the keys and compares
// each with the warp's threshold, the k-th smallest key seen so far; most
// elements cost that one compare and one warp vote. A key below it is
// appended to the warp's candidate buffer in shared memory (one ballot,
// one popc for the slot). The queue holds the N = 32 x KPL best keys,
// sorted ascending across the warp's registers; the share's first N
// columns fill it directly, so the threshold holds from the first step.
// After a step of 32 x kUnroll columns, once more than N keys wait, the
// warp merges them into the queue (k3_queue.cuh's flush); the threshold is
// then the key at k - 1. The merge has one call site, so the unrolled
// networks are compiled once per queue width. With W warps a row, each
// warp scans an interleaved share of the columns and the first warp merges
// the others' sorted queues from shared memory.
//
// Wide route (k > 256; any k <= n): select, then sort only k keys. One
// block of 256 threads a row. The row is copied to shared memory once when
// it fits beside the sort buffer (else every pass reads it from HBM).
// (1) A radix select finds the k-th smallest composite key, 8 bits a pass
// from the top: a histogram of the keys that match the digits found so far
// (shared atomics, one per group of lanes with the same bin, found with
// __match_any_sync) and a block scan that finds the bin holding the k-th.
// A pass ends the search when the k-th is the last key of its bin; the
// column's bits are searched only past the value's, and only as many as n
// needs. k = n skips it. (2) One pass collects the k keys at or below it
// (unique keys: exactly k; one shared atomic a warp). (3) The k keys,
// padded to a power of two L >= 512 with kNoKey, are sorted: each warp
// sorts 256-key segments in registers (k3_queue.cuh's warp_sort), then
// bitonic merges of sorted runs, stages with strides of 256 and more in
// shared memory with a barrier each, the rest in registers. For L > 8192
// the keys are collected in global scratch, sorted in chunks of 8,192 in
// shared memory by a second kernel, and the sorted runs merged pairwise
// through global memory (each key's place is its rank in its run plus its
// rank in the partner run, by binary search); a last kernel writes the
// first k. The old design (a block queue that sorted a 2,048-key buffer
// per flush, 66 barriered stages a row) was sort-bound at 3-7% of the
// byte bound.
//
// Rows are read with a row stride, so a column slice of a wider block or
// the rows of a [C, qmax, cap] view need no copy. Every kernel lives in
// namespace msann_k3, so a profiler trace finds K3 by that name.

#include <cuda_runtime.h>
#include <stdint.h>

#include "k3_queue.cuh"

namespace msann_k3 {

constexpr int kUnroll = 8;           // loads in flight per lane
constexpr int kMaxThreads = 256;     // a block: 8 warps on one row at most
constexpr int kWideThreads = 256;    // the wide route: a block a row
constexpr int kSeg = 256;            // keys a warp sorts in registers
constexpr int kMinSort = 512;        // the wide route's narrowest sort
constexpr int kSmemSort = 8192;      // its widest in shared memory (64 KB)
constexpr int kWideSmem = 200 << 10; // its dynamic shared memory, at most

// ---- launch arguments, as ops/select.py::_pack_args packs them ----
enum Arg {
  kX = 0,        // input rows, float32
  kRows,
  kN,            // columns per row
  kRowStride,    // elements between the starts of two rows
  kK,
  kOutV,         // values [rows, k], float32
  kOutI,         // indices [rows, k] int64
  kQueue,        // the warp queue's keys, >= k: 32 x 1, 2, 4 or 8; or the
                 // wide route's sort length L, a power of two >= 512
  kCache,        // wide: 1 when the row is copied to shared memory; warp: 0
  kScratch,      // wide, L > kSmemSort: 2 x rows x L int64 keys; else 0
  kWarpsPerRow,  // W: 1, or warps of one block sharing a row (warp queue)
  kGrid,
  kThreads,
  kStream,
  kArgs
};

template <int KPL>
__device__ __forceinline__ void scan_row(uint64_t (&q)[KPL], uint64_t* buf,
                                         const float* __restrict__ xr,
                                         int64_t n,
                                         int64_t first, int64_t step, int k,
                                         int lane) {
  constexpr int N = 32 * KPL;
  static_assert(KPL <= kUnroll, "the fill lies in the share's first step");
#pragma unroll
  for (int r = 0; r < KPL; ++r) {
    const int64_t c = first + r * 32 + lane;
    q[r] = c < n ? make_key(__ldg(xr + c), c) : kNoKey;
  }
  warp_sort<KPL>(q, lane);
  uint64_t thr = kth<KPL>(q, k);
  int count = 0;
  for (int64_t c0 = first;; c0 += step) {
    const bool more = c0 < n;
    if (more) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t c = c0 + u * 32 + lane;
        v[u] = c < n ? __ldg(xr + c) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int64_t c = c0 + u * 32 + lane;
        // the first step's first KPL loads are in the queue already
        const bool fresh = u >= KPL || c0 != first;
        const uint64_t key = c < n && fresh ? make_key(v[u], c) : kNoKey;
        const bool take = key < thr;
        const unsigned m = __ballot_sync(kFull, take);
        if (m) {     // warp-uniform: once the threshold settles, rarely
          if (take) buf[count + __popc(m & ((1u << lane) - 1u))] = key;
          count += __popc(m);
        }
      }
    }
    if (count > N || (!more && count > 0)) {
      flush<KPL>(q, buf, count, lane);
      count = 0;
      thr = kth<KPL>(q, k);
    }
    if (!more) break;
  }
}

template <int KPL>
__global__ void __launch_bounds__(256)
select_kernel(const float* __restrict__ x, int64_t rows, int64_t n,
              int64_t row_stride, int k, int warps_per_row,
              float* __restrict__ out_v, int64_t* __restrict__ out_i) {
  constexpr int N = 32 * KPL;
  constexpr int kBuf = N + 32 * kUnroll;
  extern __shared__ uint64_t smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int rows_per_block = (blockDim.x >> 5) / warps_per_row;
  const int64_t row = (int64_t)blockIdx.x * rows_per_block + warp / warps_per_row;
  const int part = warp % warps_per_row;
  uint64_t* buf = smem + warp * kBuf;
  const float* xr = x + (row < rows ? row : 0) * row_stride;

  uint64_t q[KPL];
#pragma unroll
  for (int r = 0; r < KPL; ++r) q[r] = kNoKey;
  if (row < rows)
    scan_row<KPL>(q, buf, xr, n, (int64_t)part * 32 * kUnroll,
                     (int64_t)warps_per_row * 32 * kUnroll, k, lane);

  if (warps_per_row > 1) {
    // one row a block: every warp publishes its sorted queue, the first
    // merges them
#pragma unroll
    for (int r = 0; r < KPL; ++r) buf[r * 32 + lane] = q[r];
    __syncthreads();
    if (part == 0) {
      for (int w = 1; w < warps_per_row; ++w) {
        uint64_t b[KPL];
#pragma unroll
        for (int r = 0; r < KPL; ++r)
          b[r] = smem[(warp + w) * kBuf + r * 32 + lane];
        merge_sorted<KPL>(q, b, lane);
      }
    }
  }

  if (row < rows && part == 0) {
    const uint32_t* bits = reinterpret_cast<const uint32_t*>(xr);
    uint32_t* ov = reinterpret_cast<uint32_t*>(out_v) + row * k;
    int64_t* oi = out_i + row * k;
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int i = r * 32 + lane;
      if (i < k) {
        const uint32_t c = (uint32_t)q[r];
        oi[i] = (int64_t)c;
        ov[i] = bits[c];
      }
    }
  }
}


// ---- the wide route (k > 256): one block a row, select then sort k ----

struct WideShared {
  int hist[256];
  int warp_sum[kWideThreads / 32];
  int sel_bin, sel_below, sel_count;
  int count;
};

// The bin of hist[0, nbins) holding the kk-th key (1-based), with the
// keys below it and its own count, into s.sel_*; one bin a thread.
__device__ void find_bin(WideShared& s, int kk, int nbins) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int h = t < nbins ? s.hist[t] : 0;
  int inc = h;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  if (lane == 31) s.warp_sum[warp] = inc;
  __syncthreads();
  for (int w = 0; w < warp; ++w) inc += s.warp_sum[w];
  const int exc = inc - h;
  if (h > 0 && exc < kk && kk <= inc) {
    s.sel_bin = t;
    s.sel_below = exc;
    s.sel_count = h;
  }
  __syncthreads();
}

// The least key K such that exactly k keys of the row are <= K: the k-th
// smallest with the bits below the digit that settled it set. Columns fit
// in cb bits.
__device__ uint64_t radix_kth(const float* src, int64_t n, int k, int cb,
                              WideShared& s) {
  const int t = threadIdx.x, lane = t & 31;
  uint64_t prefix = 0;
  int hi = 64, kk = k;
  for (;;) {
    if (hi == 32) hi = cb;     // column bits at and above cb are zero
    const int lo = hi > 8 ? hi - 8 : 0;
    const int nbins = 1 << (hi - lo);
    s.hist[t] = 0;
    __syncthreads();
    for (int64_t c0 = t - lane; c0 < n; c0 += kWideThreads) {
      const int64_t c = c0 + lane;
      int bin = -1;
      if (c < n) {
        const uint64_t key = make_key(src[c], c);
        if (hi >= 64 || ((key ^ prefix) >> hi) == 0)
          bin = (int)((key >> lo) & (uint64_t)(nbins - 1));
      }
      const unsigned peers = __match_any_sync(kFull, bin);
      if (bin >= 0 && lane == __ffs(peers) - 1)
        atomicAdd(&s.hist[bin], __popc(peers));
    }
    __syncthreads();
    find_bin(s, kk, nbins);
    prefix |= (uint64_t)s.sel_bin << lo;
    kk -= s.sel_below;
    if (s.sel_count == kk || lo == 0) return prefix | ((1ull << lo) - 1);
    hi = lo;
  }
}

// Sort a[0, len) ascending, len a power of two from kSeg: each warp sorts
// 256-key segments in registers, then bitonic merges of sorted runs (a
// flip stage, then half-cleaners), strides >= kSeg in shared memory with a
// barrier each, smaller ones in registers.
__device__ void block_sort(uint64_t* a, int len) {
  constexpr int kWarps = kWideThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int segs = len / kSeg;
  for (int sg = warp; sg < segs; sg += kWarps) {
    uint64_t r[8];
    uint64_t* p = a + sg * kSeg;
#pragma unroll
    for (int i = 0; i < 8; ++i) r[i] = p[i * 32 + lane];
    warp_sort<8>(r, lane);
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i * 32 + lane] = r[i];
  }
  __syncthreads();
  for (int m = kSeg; m < len; m <<= 1) {
    for (int p = threadIdx.x; p < len / 2; p += kWideThreads) {
      const int off = p & (m - 1), base = (p - off) * 2;
      const int i = base + off, j = base + 2 * m - 1 - off;
      const uint64_t lo = a[i], hi = a[j];
      if (lo > hi) {
        a[i] = hi;
        a[j] = lo;
      }
    }
    __syncthreads();
    for (int stride = m >> 1; stride >= kSeg; stride >>= 1) {
      for (int p = threadIdx.x; p < len / 2; p += kWideThreads) {
        const int i = 2 * p - (p & (stride - 1)), j = i + stride;
        const uint64_t lo = a[i], hi = a[j];
        if (lo > hi) {
          a[i] = hi;
          a[j] = lo;
        }
      }
      __syncthreads();
    }
    for (int sg = warp; sg < segs; sg += kWarps) {
      uint64_t r[8];
      uint64_t* p = a + sg * kSeg;
#pragma unroll
      for (int i = 0; i < 8; ++i) r[i] = p[i * 32 + lane];
      warp_clean<8>(r, lane);
#pragma unroll
      for (int i = 0; i < 8; ++i) p[i * 32 + lane] = r[i];
    }
    __syncthreads();
  }
}

// Dynamic shared memory: the sort buffer (len keys, when len <= kSmemSort),
// then the row's copy (n floats, when cache).
__global__ void __launch_bounds__(kWideThreads)
wide_select_kernel(const float* __restrict__ x, int64_t n, int64_t row_stride,
                   int k, int len, int cache, int cb,
                   float* __restrict__ out_v, int64_t* __restrict__ out_i,
                   uint64_t* __restrict__ scratch) {
  extern __shared__ uint64_t smem[];
  __shared__ WideShared s;
  const int64_t row = blockIdx.x;
  const float* xr = x + row * row_stride;
  const bool in_smem = len <= kSmemSort;
  uint64_t* dst = in_smem ? smem : scratch + row * len;
  const float* src = xr;
  if (cache) {
    float* copy = reinterpret_cast<float*>(smem + (in_smem ? len : 0));
    for (int64_t c = threadIdx.x; c < n; c += kWideThreads)
      copy[c] = __ldg(xr + c);
    src = copy;
  }
  if (threadIdx.x == 0) s.count = 0;
  __syncthreads();
  const uint64_t kstar = k == n ? kNoKey : radix_kth(src, n, k, cb, s);

  // the k keys at or below kstar, in any order, then padding to len
  const int lane = threadIdx.x & 31;
  for (int64_t c0 = threadIdx.x - lane; c0 < n; c0 += kWideThreads) {
    const int64_t c = c0 + lane;
    const uint64_t key = c < n ? make_key(src[c], c) : kNoKey;
    const bool take = c < n && key <= kstar;
    const unsigned m = __ballot_sync(kFull, take);
    if (m) {
      const int first = __ffs(m) - 1;
      int base = 0;
      if (lane == first) base = atomicAdd(&s.count, __popc(m));
      base = __shfl_sync(kFull, base, first);
      if (take) dst[base + __popc(m & ((1u << lane) - 1u))] = key;
    }
  }
  for (int i = k + threadIdx.x; i < len; i += kWideThreads) dst[i] = kNoKey;
  __syncthreads();
  if (!in_smem) return;

  block_sort(dst, len);
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(src);
  uint32_t* ov = reinterpret_cast<uint32_t*>(out_v) + row * k;
  int64_t* oi = out_i + row * k;
  for (int i = threadIdx.x; i < k; i += kWideThreads) {
    const uint32_t c = (uint32_t)dst[i];
    oi[i] = (int64_t)c;
    ov[i] = bits[c];
  }
}

// L > kSmemSort: sort every chunk of kSmemSort keys in shared memory.
__global__ void __launch_bounds__(kWideThreads)
chunk_sort_kernel(uint64_t* __restrict__ keys) {
  extern __shared__ uint64_t smem[];
  uint64_t* g = keys + (int64_t)blockIdx.x * kSmemSort;
  for (int i = threadIdx.x; i < kSmemSort; i += kWideThreads) smem[i] = g[i];
  __syncthreads();
  block_sort(smem, kSmemSort);
  for (int i = threadIdx.x; i < kSmemSort; i += kWideThreads) g[i] = smem[i];
}

// One round of pairwise merges of sorted runs of `run` keys in rows of
// `len` (both powers of two, run < len): a key's place is its rank in its
// own run plus the count of the partner run's keys below it (a left run's
// key goes before an equal right one: the kNoKey padding repeats).
__global__ void __launch_bounds__(256)
merge_pass_kernel(const uint64_t* __restrict__ src, uint64_t* __restrict__ dst,
                  int64_t total, int len, int run) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= total) return;
  const int64_t row = g / len;
  const int i = (int)(g - row * len);
  const uint64_t* s = src + row * len;
  const int r0 = i & ~(run - 1);
  const bool left = (r0 & run) == 0;
  const int p0 = left ? r0 + run : r0 - run;
  const uint64_t key = s[i];
  int lo = 0, hi = run;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const uint64_t v = s[p0 + mid];
    if (left ? v < key : v <= key) lo = mid + 1;
    else hi = mid;
  }
  dst[row * len + (r0 < p0 ? r0 : p0) + (i - r0) + lo] = key;
}

// The first k sorted keys of every row: their columns and the row's bits.
__global__ void __launch_bounds__(256)
emit_kernel(const uint64_t* __restrict__ keys, int len,
            const float* __restrict__ x, int64_t row_stride, int k,
            int64_t rows, float* __restrict__ out_v,
            int64_t* __restrict__ out_i) {
  const int64_t g = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (g >= rows * k) return;
  const int64_t row = g / k;
  const uint32_t c = (uint32_t)keys[row * len + (g - row * k)];
  out_i[g] = (int64_t)c;
  reinterpret_cast<uint32_t*>(out_v)[g] =
      reinterpret_cast<const uint32_t*>(x + row * row_stride)[c];
}

void launch_warp(const int64_t* a) {
  const float* x = reinterpret_cast<const float*>(a[kX]);
  float* out_v = reinterpret_cast<float*>(a[kOutV]);
  int64_t* out_i = reinterpret_cast<int64_t*>(a[kOutI]);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a[kStream]);
  const int threads = (int)a[kThreads];
  const int kpl = (int)a[kQueue] / 32;
  const size_t smem =
      (size_t)(threads / 32) * (32 * kpl + 32 * kUnroll) * sizeof(uint64_t);
  const dim3 grid((unsigned)a[kGrid]);
  const int k = (int)a[kK], w = (int)a[kWarpsPerRow];
  if (kpl == 1)
    select_kernel<1><<<grid, threads, smem, s>>>(
        x, a[kRows], a[kN], a[kRowStride], k, w, out_v, out_i);
  else if (kpl == 2)
    select_kernel<2><<<grid, threads, smem, s>>>(
        x, a[kRows], a[kN], a[kRowStride], k, w, out_v, out_i);
  else if (kpl == 4)
    select_kernel<4><<<grid, threads, smem, s>>>(
        x, a[kRows], a[kN], a[kRowStride], k, w, out_v, out_i);
  else
    select_kernel<8><<<grid, threads, smem, s>>>(
        x, a[kRows], a[kN], a[kRowStride], k, w, out_v, out_i);
}

int launch_wide(const int64_t* a) {
  const float* x = reinterpret_cast<const float*>(a[kX]);
  float* out_v = reinterpret_cast<float*>(a[kOutV]);
  int64_t* out_i = reinterpret_cast<int64_t*>(a[kOutI]);
  uint64_t* scratch = reinterpret_cast<uint64_t*>(a[kScratch]);
  cudaStream_t s = reinterpret_cast<cudaStream_t>(a[kStream]);
  const int64_t rows = a[kRows], n = a[kN];
  const int k = (int)a[kK], len = (int)a[kQueue], cache = (int)a[kCache];
  int cb = 1;
  while ((int64_t(1) << cb) < n) ++cb;
  const bool in_smem = len <= kSmemSort;
  const size_t smem = (in_smem ? (size_t)len * 8 : 0) +
                      (cache ? (size_t)n * 4 : 0);
  cudaError_t e = cudaFuncSetAttribute(
      wide_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  wide_select_kernel<<<dim3((unsigned)rows), kWideThreads, smem, s>>>(
      x, n, a[kRowStride], k, len, cache, cb, out_v, out_i, scratch);
  if (in_smem) return (int)cudaSuccess;
  e = cudaFuncSetAttribute(chunk_sort_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kSmemSort * 8);
  if (e != cudaSuccess) return (int)e;
  const int64_t total = rows * len;
  chunk_sort_kernel<<<dim3((unsigned)(total / kSmemSort)), kWideThreads,
                      kSmemSort * 8, s>>>(scratch);
  uint64_t* k0 = scratch;
  uint64_t* k1 = scratch + total;
  for (int run = kSmemSort; run < len; run *= 2) {
    merge_pass_kernel<<<dim3((unsigned)((total + 255) / 256)), 256, 0, s>>>(
        k0, k1, total, len, run);
    uint64_t* t = k0;
    k0 = k1;
    k1 = t;
  }
  emit_kernel<<<dim3((unsigned)((rows * k + 255) / 256)), 256, 0, s>>>(
      k0, len, x, a[kRowStride], k, rows, out_v, out_i);
  return (int)cudaSuccess;
}

bool pow2(int64_t v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace msann_k3

using namespace msann_k3;

// The k smallest of every row. One argument, a packed buffer of kArgs
// int64s (see Arg). Returns the launch's CUDA error (0 when it was
// queued); an argument the kernel cannot take returns
// cudaErrorInvalidValue before anything is launched.
extern "C" int msann_select(const int64_t* a) {
  const int64_t queue = a[kQueue], k = a[kK], w = a[kWarpsPerRow];
  const int64_t n = a[kN];
  if (a[kRows] <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > queue || k > n || n >= (int64_t(1) << 32))
    return (int)cudaErrorInvalidValue;
  if (queue <= 256) {
    if ((queue != 32 && queue != 64 && queue != 128 && queue != 256) ||
        a[kCache] != 0 || w < 1 || a[kThreads] % (32 * w) != 0 ||
        a[kThreads] > kMaxThreads)
      return (int)cudaErrorInvalidValue;
    launch_warp(a);
  } else {
    const int64_t smem = (queue <= kSmemSort ? queue * 8 : 0) +
                         (a[kCache] ? n * 4 : 0);
    if (!pow2(queue) || queue < kMinSort || queue > (int64_t(1) << 30) ||
        a[kThreads] != kWideThreads || a[kGrid] != a[kRows] ||
        smem > kWideSmem || (queue > kSmemSort && a[kScratch] == 0) ||
        a[kRows] > 0x7fffffffLL || a[kRows] * queue >= (int64_t(1) << 40))
      return (int)cudaErrorInvalidValue;
    const int e = launch_wide(a);
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}
