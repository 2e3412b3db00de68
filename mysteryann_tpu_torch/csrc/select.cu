// k-selection for Hopper (sm_90a): the k smallest entries of every row of a
// float32 matrix, ascending, ties to the lower column -- kernel K3 of the
// port.
//
// Replaces the TPU's partial-reduce selection, which the JAX package reaches
// through jax.lax.approx_min_k (mysteryann_tpu/search/seeding.py:54;
// ops/knn.py:76, :228, :240, :309, :322; ops/scan.py:152) and the exact
// jax.lax.top_k (ops/knn.py:36, :78; flat.py:53): the seed scan's score
// tiles, the exact and int8 kNN tiles and their running merges, the flat
// index's rerank, the binned scan's bin top-k, and the IVF index's probe
// choice, per-chunk selection, merge and rerank. ops/sort.py::topk_smallest
// routes every CUDA call here (ops/select.py): k <= 256 to the warp queue,
// 256 < k <= 8192 to the block queue (the IVF exactness gates select all
// 2,000 or 6,324 clusters).
//
// Order. Each element becomes one unique 64-bit key, formed in registers:
// the high word is the order-preserving image of the value (float: -0.0
// first turned into +0.0 by adding +0.0, then the sign-magnitude bits
// mapped to two's complement), biased to unsigned; the
// low word is the column. The k smallest keys, ascending, are exactly what
// the plain version (ops/sort.py::topk_smallest_ref, an int64 composite key
// fed to torch.topk) selects, on any input: selection adds no arithmetic.
// The values written are the row's own bits at the chosen columns, so a
// -0.0 keeps its sign.
//
// What bounds it on the card: bytes. Every element is read once from HBM
// (rows x n x 4 bytes) and k values and indices are written per row; at
// 3.35 TB/s that is the least time a call takes, and the work per element
// must stay a few instructions to keep up.
//
// Design (Faiss's WarpSelect / BlockSelect, arXiv 1702.08734). A warp owns
// a row, or W warps of one block share a long row when rows are few. Each
// lane issues kUnroll coalesced loads (a warp reads 32 consecutive
// elements per load) before it looks at any, forms the keys and compares
// each with the warp's threshold, the k-th smallest key seen so far; most
// elements cost that one compare and one warp vote. A key below it is
// appended to the warp's candidate buffer in shared memory (one ballot,
// one popc for the slot). The queue holds the N = 32 x KPL best keys,
// sorted ascending across the warp's registers (element r x 32 + lane in
// register r of that lane); the share's first N columns fill it directly,
// so the threshold holds from the first step. After a step of 32 x kUnroll
// columns, once more than N keys wait, the warp merges them into the
// queue: N buffered keys at a time are bitonic-sorted across the
// warp (shuffles for strides below 32, register swaps above), reversed
// against the queue, the smaller of each pair kept (a bitonic sequence
// holding the N smallest of both), and one bitonic merge sorts it again;
// the threshold is then the key at k - 1. The merge has one call site, so
// the unrolled networks are compiled once per queue width. With W warps a
// row, each warp scans an interleaved share of the columns and the first
// warp merges the others' sorted queues from shared memory.
//
// For 256 < k <= 8192 (the wide route) the queue moves to shared memory
// (BlockSelect's queue, block-wide): one block of 256 threads a row, a
// queue of Q >= k keys (a power of two, 512..8192) sorted ascending and a
// candidate buffer of B = max(Q, 2 x 1024) keys. Each step of 1,024
// columns appends the keys below the threshold to the buffer (one shared
// atomic each); once the buffer could not take another step, or at the
// row's end, the block bitonic-sorts the buffer's filled power of two,
// keeps the smaller of the queue and the reversed buffer (a bitonic
// sequence holding the Q smallest of both) and merges it, with a barrier
// after every stage. When k is close to n, as at the exactness gates, this
// is one sort of the whole row.
//
// Rows are read with a row stride, so a column slice of a wider block or
// the rows of a [C, qmax, cap] view need no copy. Every kernel lives in
// namespace msann_k3, so a profiler trace finds K3 by that name.

#include <cuda_runtime.h>
#include <stdint.h>

namespace msann_k3 {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kNoKey = ~0ull;   // above every real key
constexpr int kUnroll = 8;           // loads in flight per lane
constexpr int kMaxThreads = 256;     // a block: 8 warps on one row at most
constexpr int kBlockThreads = 256;   // the block queue: one block a row
constexpr int kBlockUnroll = 4;      // its loads in flight per thread
constexpr int kBlockStep = kBlockThreads * kBlockUnroll;
constexpr int kMinQueue = 512;       // the block queue's narrowest
constexpr int kMaxQueue = 8192;      // and widest (with its buffer, 128 KB)

// ---- launch arguments, as ops/select.py::_pack_args packs them ----
enum Arg {
  kX = 0,        // input rows, float32
  kRows,
  kN,            // columns per row
  kRowStride,    // elements between the starts of two rows
  kK,
  kOutV,         // values [rows, k], float32
  kOutI,         // indices [rows, k] int64
  kQueue,        // keys in the queue, >= k: the warp's 32 x 1, 2, 4 or 8,
                 // or the block's power of two from kMinQueue to kMaxQueue
  kBuf,          // the block queue's candidate buffer in keys; 0: the warp's
  kWarpsPerRow,  // W: 1, or warps of one block sharing a row (warp queue)
  kGrid,
  kThreads,
  kStream,
  kArgs
};

__device__ __forceinline__ uint32_t image(float v) {
  // __fadd_rn is never contracted or folded: -0.0 + 0.0 = +0.0, and a NaN
  // comes out as the card's canonical NaN, as torch's x + 0.0 gives it
  const int b = __float_as_int(__fadd_rn(v, 0.0f));
  return (uint32_t)(b < 0 ? b ^ 0x7fffffff : b) ^ 0x80000000u;
}

__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// One compare-exchange stage of a bitonic network over the warp's
// N = 32 x KPL keys: pairs (e, e ^ stride), ascending where e & size == 0.
template <int KPL>
__device__ __forceinline__ void stage(uint64_t (&a)[KPL], int size,
                                      int stride, int lane) {
  if (stride < 32) {
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const uint64_t o = __shfl_xor_sync(kFull, a[r], stride);
      const bool up = ((r * 32 + lane) & size) == 0;
      const bool low = (lane & stride) == 0;
      a[r] = (low == up) ? kmin(a[r], o) : kmax(a[r], o);
    }
  } else {
    const int rs = stride / 32;
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int p = r ^ rs;
      if (p > r) {
        const bool up = ((r * 32 + lane) & size) == 0;
        const uint64_t lo = a[r], hi = a[p];
        if (up ? lo > hi : lo < hi) {
          a[r] = hi;
          a[p] = lo;
        }
      }
    }
  }
}

template <int KPL>
__device__ __forceinline__ void warp_sort(uint64_t (&a)[KPL], int lane) {
  constexpr int N = 32 * KPL;
#pragma unroll
  for (int size = 2; size <= N; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
      stage<KPL>(a, size, stride, lane);
  }
}

// q and b sorted ascending: q becomes the N smallest of both, sorted.
template <int KPL>
__device__ __forceinline__ void merge_sorted(uint64_t (&q)[KPL],
                                             const uint64_t (&b)[KPL],
                                             int lane) {
  constexpr int N = 32 * KPL;
#pragma unroll
  for (int r = 0; r < KPL; ++r)
    q[r] = kmin(q[r], __shfl_sync(kFull, b[KPL - 1 - r], 31 - lane));
#pragma unroll
  for (int stride = N >> 1; stride > 0; stride >>= 1)
    stage<KPL>(q, N, stride, lane);
}

// The key at position k - 1 of the queue, on every lane.
template <int KPL>
__device__ __forceinline__ uint64_t kth(const uint64_t (&q)[KPL], int k) {
  uint64_t t = q[0];
#pragma unroll
  for (int r = 1; r < KPL; ++r)
    if (r == (k - 1) >> 5) t = q[r];
  return __shfl_sync(kFull, t, (k - 1) & 31);
}

// Merge the warp's `count` buffered keys into its queue, N at a time.
template <int KPL>
__device__ __forceinline__ void flush(uint64_t (&q)[KPL], const uint64_t* buf,
                                      int count, int lane) {
  constexpr int N = 32 * KPL;
  __syncwarp();
  for (int c0 = 0; c0 < count; c0 += N) {
    uint64_t b[KPL];
#pragma unroll
    for (int r = 0; r < KPL; ++r) {
      const int i = c0 + r * 32 + lane;
      b[r] = i < count ? buf[i] : kNoKey;
    }
    warp_sort<KPL>(b, lane);
    merge_sorted<KPL>(q, b, lane);
  }
  __syncwarp();
}

__device__ __forceinline__ uint64_t make_key(float v, int64_t c) {
  return ((uint64_t)image(v) << 32) | (uint32_t)c;
}

// One warp's share of a row: columns part x 32 x kUnroll on, in steps of
// `step`. The share's first N columns fill the queue directly and one warp
// sort orders them, so the threshold holds from the start. The buffer
// holds N + 32 x kUnroll keys: at most N wait at the start of a step, and
// a step appends at most 32 x kUnroll.
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

// ---- the block queue (256 < k <= kMaxQueue): one block a row ----

// Sort a[0, len) ascending, len a power of two: a bitonic network over the
// block, a barrier after every stage.
__device__ void block_sort(uint64_t* a, int len) {
  for (int size = 2; size <= len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int p = threadIdx.x; p < len / 2; p += blockDim.x) {
        const int i = 2 * p - (p & (stride - 1)), j = i + stride;
        const uint64_t lo = a[i], hi = a[j];
        if ((i & size) == 0 ? lo > hi : lo < hi) {
          a[i] = hi;
          a[j] = lo;
        }
      }
      __syncthreads();
    }
  }
}

// Merge the block's `count` buffered keys into its queue q[0, qn), sorted
// ascending: sort the buffer's least power of two holding them (the rest
// of the queue's width padded with kNoKey), keep the smaller of q[i] and
// buf[qn - 1 - i] and merge that bitonic sequence.
__device__ void block_flush(uint64_t* q, uint64_t* buf, int count, int qn) {
  int len = 2;
  while (len < count) len <<= 1;
  const int fill = len > qn ? len : qn;
  for (int i = count + threadIdx.x; i < fill; i += blockDim.x)
    buf[i] = kNoKey;
  __syncthreads();
  block_sort(buf, len);
  for (int i = threadIdx.x; i < qn; i += blockDim.x)
    q[i] = kmin(q[i], buf[qn - 1 - i]);
  __syncthreads();
  for (int stride = qn >> 1; stride > 0; stride >>= 1) {
    for (int p = threadIdx.x; p < qn / 2; p += blockDim.x) {
      const int i = 2 * p - (p & (stride - 1)), j = i + stride;
      const uint64_t lo = q[i], hi = q[j];
      if (lo > hi) {
        q[i] = hi;
        q[j] = lo;
      }
    }
    __syncthreads();
  }
}

// Shared memory: the queue (qn keys) then the buffer (bn keys). Before a
// step the buffer holds at most bn - kBlockStep keys, so a step's appends
// fit.
__global__ void __launch_bounds__(kBlockThreads)
block_select_kernel(const float* __restrict__ x, int64_t n,
                    int64_t row_stride, int k, int qn, int bn,
                    float* __restrict__ out_v, int64_t* __restrict__ out_i) {
  extern __shared__ uint64_t smem[];
  __shared__ int count;
  uint64_t* q = smem;
  uint64_t* buf = smem + qn;
  const int64_t row = blockIdx.x;
  const float* xr = x + row * row_stride;
  for (int i = threadIdx.x; i < qn; i += blockDim.x) q[i] = kNoKey;
  if (threadIdx.x == 0) count = 0;
  __syncthreads();
  uint64_t thr = kNoKey;
  for (int64_t c0 = 0; c0 < n; c0 += kBlockStep) {
    float v[kBlockUnroll];
#pragma unroll
    for (int u = 0; u < kBlockUnroll; ++u) {
      const int64_t c = c0 + u * kBlockThreads + threadIdx.x;
      v[u] = c < n ? __ldg(xr + c) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kBlockUnroll; ++u) {
      const int64_t c = c0 + u * kBlockThreads + threadIdx.x;
      if (c < n) {
        const uint64_t key = make_key(v[u], c);
        if (key < thr) buf[atomicAdd(&count, 1)] = key;
      }
    }
    __syncthreads();
    const int filled = count;   // the same on every thread: branches agree
    __syncthreads();            // read by all before the next append
    if (filled > bn - kBlockStep || (c0 + kBlockStep >= n && filled > 0)) {
      if (threadIdx.x == 0) count = 0;
      block_flush(q, buf, filled, qn);
      thr = q[k - 1];
    }
  }
  const uint32_t* bits = reinterpret_cast<const uint32_t*>(xr);
  uint32_t* ov = reinterpret_cast<uint32_t*>(out_v) + row * k;
  int64_t* oi = out_i + row * k;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    const uint32_t c = (uint32_t)q[i];
    oi[i] = (int64_t)c;
    ov[i] = bits[c];
  }
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

int launch_block(const int64_t* a) {
  const int qn = (int)a[kQueue], bn = (int)a[kBuf];
  const size_t smem = (size_t)(qn + bn) * sizeof(uint64_t);
  const cudaError_t e = cudaFuncSetAttribute(
      block_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  block_select_kernel<<<dim3((unsigned)a[kGrid]), kBlockThreads, smem,
                        reinterpret_cast<cudaStream_t>(a[kStream])>>>(
      reinterpret_cast<const float*>(a[kX]), a[kN], a[kRowStride],
      (int)a[kK], qn, bn, reinterpret_cast<float*>(a[kOutV]),
      reinterpret_cast<int64_t*>(a[kOutI]));
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
  if (a[kRows] <= 0 || k <= 0) return (int)cudaSuccess;
  if (k > queue || k > a[kN] || a[kN] >= (int64_t(1) << 32))
    return (int)cudaErrorInvalidValue;
  if (a[kBuf] == 0) {
    if ((queue != 32 && queue != 64 && queue != 128 && queue != 256) ||
        w < 1 || a[kThreads] % (32 * w) != 0 || a[kThreads] > kMaxThreads)
      return (int)cudaErrorInvalidValue;
    launch_warp(a);
  } else {
    if (!pow2(queue) || queue < kMinQueue || queue > kMaxQueue ||
        !pow2(a[kBuf]) || a[kBuf] < queue || a[kBuf] < 2 * kBlockStep ||
        a[kBuf] > kMaxQueue || a[kThreads] != kBlockThreads ||
        a[kGrid] != a[kRows])
      return (int)cudaErrorInvalidValue;
    const int e = launch_block(a);
    if (e != 0) return e;
  }
  return (int)cudaGetLastError();
}
