// K3's composite key and its warp queue, shared by the k-selection kernel
// (select.cu) and the score product fused with it (score_select.cu).
//
// Order. Each element becomes one unique 64-bit key, formed in registers:
// the high word is the order-preserving image of the value (float: -0.0
// first turned into +0.0 by adding +0.0, then the sign-magnitude bits
// mapped to two's complement), biased to unsigned; the low word is the
// column. The k smallest keys, ascending, are exactly what the plain
// version (ops/sort.py::topk_smallest_ref, an int64 composite key fed to
// torch.topk) selects, on any input.
//
// The warp queue holds N = 32 x KPL keys sorted ascending across the
// warp's registers: element r x 32 + lane in register r of that lane.
// Bitonic stages use shuffles for strides below 32 and register swaps
// above, so no register is indexed at run time.

#pragma once

#include <stdint.h>

namespace msann_k3 {

constexpr unsigned kFull = 0xffffffffu;
constexpr uint64_t kNoKey = ~0ull;   // above every real key

__device__ __forceinline__ uint32_t image(float v) {
  // __fadd_rn is never contracted or folded: -0.0 + 0.0 = +0.0, and a NaN
  // comes out as the card's canonical NaN, as torch's x + 0.0 gives it
  const int b = __float_as_int(__fadd_rn(v, 0.0f));
  return (uint32_t)(b < 0 ? b ^ 0x7fffffff : b) ^ 0x80000000u;
}

// The value whose image is `u` (the image of -0.0 comes back as +0.0).
__device__ __forceinline__ float unimage(uint32_t u) {
  const int b = (int)(u ^ 0x80000000u);
  return __int_as_float(b < 0 ? b ^ 0x7fffffff : b);
}

__device__ __forceinline__ uint64_t make_key(float v, int64_t c) {
  return ((uint64_t)image(v) << 32) | (uint32_t)c;
}

__device__ __forceinline__ uint64_t kmin(uint64_t a, uint64_t b) {
  return a < b ? a : b;
}

__device__ __forceinline__ uint64_t kmax(uint64_t a, uint64_t b) {
  return a < b ? b : a;
}

// One compare-exchange stage of a bitonic network over the warp's
// N = 32 x KPL keys: pairs (e, e ^ stride), ascending where e & size == 0
// (a size above N: ascending everywhere).
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

// a bitonic (or sorted) across the warp: a sorted ascending.
template <int KPL>
__device__ __forceinline__ void warp_clean(uint64_t (&a)[KPL], int lane) {
  constexpr int N = 32 * KPL;
#pragma unroll
  for (int stride = N >> 1; stride > 0; stride >>= 1)
    stage<KPL>(a, 2 * N, stride, lane);
}

// q and b sorted ascending: q becomes the N smallest of both, sorted.
template <int KPL>
__device__ __forceinline__ void merge_sorted(uint64_t (&q)[KPL],
                                             const uint64_t (&b)[KPL],
                                             int lane) {
#pragma unroll
  for (int r = 0; r < KPL; ++r)
    q[r] = kmin(q[r], __shfl_sync(kFull, b[KPL - 1 - r], 31 - lane));
  warp_clean<KPL>(q, lane);
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

}  // namespace msann_k3
