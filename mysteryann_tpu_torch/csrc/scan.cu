// Binned flat scan for Hopper (sm_90a): bf16 query x bf16 table scores in
// f32, each score max-folded into one of BINS = 4096 bins per query.
//
// Replaces the Pallas TPU kernel mysteryann_tpu/ops/scan.py::_scan_kernel,
// the scan of FlatIndex(precision="scan"). Its semantics are kept exactly,
// since the bin a column folds into decides which collisions drop:
//   column col lies in tile t = col / C_BLK, lane group g = (col % C_BLK)
//   / 128, lane col % 128; it folds into bin p = ((t % TG) * G + g) * 128
//   + lane with j = t / TG. A bin keeps the largest score and its j; the
//   strict '>' of a fold in ascending j lets the lowest j win a tie. A bin
//   never written keeps -inf / j = 0. When n % C_BLK != 0 the last tile's
//   columns at or past n score -inf. The output is the negated maximum.
//
// Design. Bins are independent: bin row r = p / 128 owns the columns
// (j * TG + r / G) * C_BLK + (r % G) * 128 + lane, j = 0, 1, ... So one
// thread block takes a (query tile of QT = 64, bin row r) pair and walks j
// by itself: no reduction across blocks and no atomics. For each j it
// stages the 128 table rows of that lane group and the 64 query rows, DK =
// 32 dimensions at a time, as f32 in shared memory (bf16 -> f32 is exact),
// and each of 256 threads accumulates a 4 query x 8 lane register tile of
// dot products with fmaf in ascending order over d. The running maximum and
// its j stay in registers; each bin is written once, at the end.
//
// What bounds it on this card: f32 FMAs on the CUDA cores — 2·B·N·d flops
// (2.1 TFLOP for 8192 queries x 1M x 128), against 67 TFLOP/s of f32 peak.
// Table bytes are not the limit: the blocks of one bin row that run at the
// same time (blockIdx.x is the query tile, the fastest-varying index) read
// the same table rows in near lockstep, so most reads hit L2. Tensor cores
// (mma.sync / wgmma), TMA staging and a fused top-k are left for later.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int C_BLK = 512;           // table rows per tile
constexpr int TG = 8;                // tile-group stride
constexpr int G = C_BLK / 128;       // lane groups per tile
constexpr int BINS = TG * G * 128;   // 4096 bins per query
constexpr int QT = 64;               // queries per block
constexpr int LN = 128;              // lanes (columns) per block and step
constexpr int DK = 32;               // dimensions staged per chunk
constexpr int THREADS = 256;         // 16 query groups x 16 lane groups

// Stage `rows` rows of DK bf16 values (row i at src + i * d) transposed
// into dst [DK][rows] as f32 (bf16 -> f32 is exact: the bf16 bits are the
// high half of the f32). Work item i < 2 * rows loads 16 values (32 bytes)
// of row i % rows; neighbouring threads take neighbouring rows, so each
// shared store of a warp hits 32 different banks. Rows at or past
// row_limit are staged as zeros.
template <int ROWS>
__device__ __forceinline__ void stage(float (*dst)[ROWS],
                                      const uint16_t* __restrict__ src,
                                      int64_t d, int64_t row_limit) {
  for (int i = threadIdx.x; i < 2 * ROWS; i += THREADS) {
    const int row = i % ROWS;
    const int h0 = (i / ROWS) * 16;
    uint4 w0 = make_uint4(0, 0, 0, 0), w1 = make_uint4(0, 0, 0, 0);
    if (row < row_limit) {
      const uint4* p = reinterpret_cast<const uint4*>(src + row * d + h0);
      w0 = p[0];
      w1 = p[1];
    }
    // little-endian: value 2m is the low half of word m, 2m+1 the high half
    const uint32_t words[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      dst[h0 + 2 * m][row] = __uint_as_float(words[m] << 16);
      dst[h0 + 2 * m + 1][row] = __uint_as_float(words[m] & 0xffff0000u);
    }
  }
}

__global__ void __launch_bounds__(THREADS)
binned_scan_kernel(const uint16_t* __restrict__ q,
                   const uint16_t* __restrict__ table, int64_t B,
                   int64_t nt, int64_t d, int64_t n,
                   float* __restrict__ out_d, int16_t* __restrict__ out_j) {
  __shared__ __align__(16) float qs[DK][QT];
  __shared__ __align__(16) float bs[DK][LN];

  const int64_t q0 = (int64_t)blockIdx.x * QT;
  const int r = blockIdx.y;                 // bin row: bins r*128 .. +128
  const int tq = threadIdx.x / 16;          // queries tq*4 .. +4
  const int tl = threadIdx.x % 16;          // lanes tl*4 .. +4, 64+tl*4 .. +4
  const int64_t q_rows = B - q0 < QT ? B - q0 : QT;

  // the tail mask of the TPU kernel: only the last tile, only when n is
  // not a multiple of C_BLK, columns at or past n - (nt - 1) * C_BLK
  const bool ragged = (n % C_BLK) != 0;
  const int64_t tail_lim = n - (nt - 1) * C_BLK;

  float best[4][8];
  int bj[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      best[i][l] = -INFINITY;
      bj[i][l] = 0;
    }

  for (int64_t j = 0;; ++j) {
    const int64_t t = j * TG + r / G;
    if (t >= nt) break;
    const int64_t col0 = t * C_BLK + (r % G) * 128;
    float acc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int l = 0; l < 8; ++l) acc[i][l] = 0.0f;

    for (int64_t k0 = 0; k0 < d; k0 += DK) {
      stage<QT>(qs, q + q0 * d + k0, d, q_rows);
      stage<LN>(bs, table + col0 * d + k0, d, LN);
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < DK; ++k) {
        const float4 qv = *reinterpret_cast<const float4*>(&qs[k][tq * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&bs[k][tl * 4]);
        const float4 b1 =
            *reinterpret_cast<const float4*>(&bs[k][64 + tl * 4]);
        const float qa[4] = {qv.x, qv.y, qv.z, qv.w};
        const float ba[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int l = 0; l < 8; ++l)
            acc[i][l] = fmaf(qa[i], ba[l], acc[i][l]);
      }
      __syncthreads();
    }

    const bool last = ragged && t == nt - 1;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int lane = l < 4 ? tl * 4 + l : 64 + tl * 4 + (l - 4);
      const bool masked = last && ((r % G) * 128 + lane) >= tail_lim;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float s = masked ? -INFINITY : acc[i][l];
        if (s > best[i][l]) {
          best[i][l] = s;
          bj[i][l] = (int)j;
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int64_t b = q0 + tq * 4 + i;
    if (b >= B) continue;
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int lane = l < 4 ? tl * 4 + l : 64 + tl * 4 + (l - 4);
      const int64_t o = b * BINS + (int64_t)r * 128 + lane;
      out_d[o] = -best[i][l];
      out_j[o] = (int16_t)bj[i][l];  // the TPU kernel's i16 sidecar
    }
  }
}

}  // namespace

// q bf16 [B, d], table bf16 [nt * C_BLK, d] (rows >= n zero), d % DK == 0,
// both 16-byte aligned; out_d f32 [B, BINS], out_j i16 [B, BINS].
extern "C" int msann_binned_scan(const void* q, const void* table, int64_t B,
                                 int64_t nt, int64_t d, int64_t n,
                                 void* out_d, void* out_j, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (d % DK != 0 || nt <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((B + QT - 1) / QT), BINS / 128);
  binned_scan_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(table), B,
      nt, d, n, static_cast<float*>(out_d), static_cast<int16_t*>(out_j));
  return (int)cudaGetLastError();
}
