// Row gather for Hopper (sm_90a): out[i] = table[idx[i]] for a table of
// any row width and dtype, copied as raw bytes.
//
// Replaces the Pallas TPU kernel mysteryann_tpu/ops/gather.py::_gather_kernel
// (one async DMA per row, indices scalar-prefetched into SMEM). Every row
// fetch of the build-then-search path goes through it: neighbour rows and
// neighbour vectors in the beam search, candidate vectors in the occlusion
// prune, and the build's edge / merge / overflow / cap row gathers.
//
// What bounds it on the card: bytes. Each index moves one 128-512 B row
// (int32 adjacency rows of 32-96 ids, f32 vectors of 128 dims), read from a
// random place in device memory, so the kernel is latency- and L2-bound long
// before it reaches the HBM rate. The design answers that with many rows in
// flight and wide accesses:
//   - a group of G lanes (a power of two, at most a warp) copies one row, G
//     chosen so that every lane moves one or a few 16-byte words; neighbouring
//     lanes touch neighbouring words, so each row is one or a few coalesced
//     transactions and a warp keeps 32/G rows in flight at once;
//   - 16-byte vector loads and stores when the row width and both base
//     pointers allow it, else 4-byte words, else single bytes;
//   - a grid-stride loop over rows, sized to keep every SM full; each group
//     loads its own index (there is no scalar prefetch on this card).
// An index outside [0, n_rows) reads nothing: its output row is zeroed and
// the wrapper's device error flag is set, so a caller's bad clamp shows up
// instead of reading out of bounds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

template <typename Word>
cudaError_t launch(const void* table, int64_t n_rows, int64_t row_bytes,
                   const void* idx, int idx_is_64, int64_t n_idx, void* out,
                   int* err, cudaStream_t stream) {
  const int64_t words = row_bytes / (int64_t)sizeof(Word);
  int group = 1;
  while (group < 32 && group < words) group <<= 1;
  const int threads = 256;
  int device = 0, sms = 132;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const int64_t needed = (n_idx * group + threads - 1) / threads;
  const int64_t cap = (int64_t)sms * 16;  // 16 blocks of 256 per SM, in waves
  const int blocks = (int)(needed < cap ? needed : cap);
  gather_rows_kernel<Word><<<blocks, threads, 0, stream>>>(
      static_cast<const char*>(table), n_rows, row_bytes, idx, idx_is_64,
      n_idx, static_cast<char*>(out), err, group);
  return cudaGetLastError();
}

}  // namespace

extern "C" int msann_gather_rows(const void* table, int64_t n_rows,
                                 int64_t row_bytes, const void* idx,
                                 int64_t idx_is_64, int64_t n_idx, void* out,
                                 void* err, void* stream) {
  if (n_idx <= 0 || row_bytes <= 0) return (int)cudaSuccess;
  const uintptr_t t = reinterpret_cast<uintptr_t>(table);
  const uintptr_t o = reinterpret_cast<uintptr_t>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* e = static_cast<int*>(err);
  const int i64 = idx_is_64 ? 1 : 0;
  cudaError_t rc;
  if (row_bytes % 16 == 0 && t % 16 == 0 && o % 16 == 0) {
    rc = launch<uint4>(table, n_rows, row_bytes, idx, i64, n_idx, out, e, s);
  } else if (row_bytes % 4 == 0 && t % 4 == 0 && o % 4 == 0) {
    rc = launch<uint32_t>(table, n_rows, row_bytes, idx, i64, n_idx, out, e, s);
  } else {
    rc = launch<uint8_t>(table, n_rows, row_bytes, idx, i64, n_idx, out, e, s);
  }
  return (int)rc;
}
