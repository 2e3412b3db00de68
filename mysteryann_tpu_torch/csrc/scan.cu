// Binned flat scan for Hopper (sm_90a): bf16 query x bf16 table scores in
// f32 on the tensor cores, each score max-folded into one of BINS = 4096
// bins per query.
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
// Decomposition. Bins are independent: bin row r = p / 128 owns the table
// rows (j * TG + r / G) * C_BLK + (r % G) * 128 + lane, j = 0, 1, ..., and
// those 128 rows are contiguous. A thread block takes QT = 256 queries and
// one half (NH = 64 lanes) of one bin row and walks j by itself: no
// reduction crosses blocks and nothing is atomic. blockIdx.x is the query
// tile, the fastest grid index, so the blocks of one bin row run together
// and stream the same table rows through L2.
//
// Engine. Warpgroup 2 is the producer: one thread issues TMA loads of the
// table rows of each step, KC = 64 dimensions at a time (an 8 KB [64 rows x
// 128 B] box, 128-byte swizzled), into a ring of stages guarded by full /
// empty mbarriers. Warpgroups 0 and 1 are consumers: each owns 128 of the
// queries and issues wgmma.m64n128k16 bf16 -> f32 on the transposed
// product, A = the step's 64 table rows and B = its 128 queries, both
// K-major in shared memory behind matrix descriptors (one m64n128 atom
// reads a third less shared memory per flop than two m64n64 atoms with the
// queries as A). The query tile is loaded once by TMA and
// stays resident for the whole walk while 512 * d bytes and four stages fit
// in shared memory (d <= 384); past that the query chunks stream through the
// ring beside the table chunks. After wgmma.wait_group the consumer folds
// its accumulator fragment into its running maximum and j, kept in
// registers (the fold is a compare and two selects per score, against 256
// tensor-core flops), and writes each bin once at the end. setmaxnreg gives
// the producer 40 registers and the consumers 232.
//
// What bounds it on this card: the products, 2·B·N·d flops (2.1 TFLOP for
// 8192 queries x 1M x 128) against 989 TFLOP/s of bf16 tensor-core peak, so
// about 2.1 ms. Device-memory bytes are far below that (the table once, the
// queries once, the bins once: 0.46 GB, 0.14 ms). L2 carries the table once
// per 256-query tile (8 GB at that shape), which the ring hides while L2
// keeps up. On an H100 the tensor pipe runs at 55-65% of peak here at d =
// 128 and 256 alike; letting the two warpgroups take turns, so that one
// folds while the other's products run, made it slower, so the fold is
// not what holds it back. Larger atoms (n256) would need more registers
// than the running maximum, its j and the accumulator leave.

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper_tma.cuh"

namespace {

using namespace msann_hopper;

constexpr int C_BLK = 512;           // table rows per tile
constexpr int TG = 8;                // tile-group stride
constexpr int G = C_BLK / 128;       // lane groups per tile
constexpr int BINS = TG * G * 128;   // 4096 bins per query
constexpr int QT = 256;              // queries per block
constexpr int NH = 64;               // lanes (table rows) per block and step
constexpr int KC = 64;               // dimensions per chunk (128 B of bf16)
constexpr int THREADS = 384;         // consumer warpgroups 0, 1; producer 2
constexpr int T_BYTES = NH * KC * 2;             // table chunk: 8 KB
constexpr int Q_BYTES = QT * KC * 2;             // query chunk: 32 KB
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;               // per block, sm_90
constexpr int SMEM_SLACK = 1024 + 256;           // alignment + barriers

__global__ void __launch_bounds__(THREADS, 1)
binned_scan_kernel(const __grid_constant__ CUtensorMap q_map,
                   const __grid_constant__ CUtensorMap t_map, int64_t nt,
                   int d, int64_t n, int resident, int stages,
                   float* __restrict__ out_d, int16_t* __restrict__ out_j) {
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 B: align the base to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);

  const int chunks = d / KC;
  const uint32_t q_area = resident ? static_cast<uint32_t>(chunks) * Q_BYTES
                                   : 0u;
  const uint32_t stage_bytes = resident ? T_BYTES : T_BYTES + Q_BYTES;
  const uint32_t ring = base + q_area;   // stage s: ring + s * stage_bytes
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      gbase + q_area + static_cast<uint32_t>(stages) * stage_bytes);
  // bars[s]: stage s full; bars[MAX_STAGES + s]: stage s empty; then qbar
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  const uint32_t qbar = full0 + 16 * MAX_STAGES;

  const int64_t q0 = static_cast<int64_t>(blockIdx.x) * QT;
  const int r = blockIdx.y >> 1;             // bin row: bins r*128 .. +128
  const int h = blockIdx.y & 1;              // its lanes h*64 .. +64
  const int64_t t_first = r / G;
  const int64_t steps = nt > t_first ? (nt - t_first + TG - 1) / TG : 0;

  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 2);          // one arrival per consumer
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 256 || steps == 0) return;
    if (resident) {
      mbar_expect_tx(qbar, static_cast<uint32_t>(chunks) * Q_BYTES);
      for (int c = 0; c < chunks; ++c)
        tma_load(base + c * Q_BYTES, &q_map, qbar, c * KC, (int)q0);
    }
    int s = 0;
    uint32_t phase = 0;
    for (int64_t j = 0; j < steps; ++j) {
      const int64_t t = j * TG + t_first;
      const int row0 = (int)(t * C_BLK + (r % G) * 128 + h * NH);
      for (int c = 0; c < chunks; ++c) {
        mbar_wait(empty0 + 8 * s, phase ^ 1u);
        const uint32_t st = ring + s * stage_bytes;
        mbar_expect_tx(full0 + 8 * s, stage_bytes);
        tma_load(st, &t_map, full0 + 8 * s, c * KC, row0);
        if (!resident)
          tma_load(st + T_BYTES, &q_map, full0 + 8 * s, c * KC, (int)q0);
        if (++s == stages) {
          s = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns queries q0 + wg*128 .. +128 ----
  // The products are taken transposed, S^T = T · Q^T: wgmma's M is the 64
  // table rows of the step (A, K-major) and its N the warpgroup's 128
  // queries (B, K-major), one m64n128 atom per warpgroup.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // this thread's fragment: lanes (table rows) warp*16 + lane/4 (+8),
  // queries 8i + 2*(lane%4) (+1), i = 0..15
  const int row0 = warp * 16 + lane / 4;
  const int col_in_tile = (r % G) * 128 + h * NH + row0;
  const bool ragged = (n % C_BLK) != 0;
  const int64_t tail_lim = n - (nt - 1) * C_BLK;
  const bool cut_lo = col_in_tile >= tail_lim;
  const bool cut_hi = col_in_tile + 8 >= tail_lim;

  float best[64];
  int bj[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    best[e] = -INFINITY;
    bj[e] = 0;
  }

  if (steps > 0 && resident) mbar_wait(qbar, 0);
  int s = 0;
  uint32_t phase = 0;
  for (int64_t j = 0; j < steps; ++j) {
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
    int prev = 0;
    for (int c = 0; c < chunks; ++c) {
      mbar_wait(full0 + 8 * s, phase);
      const uint32_t st = ring + s * stage_bytes;
      const uint32_t qb = (resident ? base + c * Q_BYTES : st + T_BYTES) +
                          wg * (Q_BYTES / 2);
      const uint64_t da = make_desc(st);
      const uint64_t db = make_desc(qb);
      fence_acc(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < KC / 16; ++kk)
        wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk,
                         (c > 0 || kk > 0) ? 1 : 0);
      wgmma_commit();
      fence_acc(acc);
      if (c > 0) {
        wgmma_wait<1>();                     // chunk c - 1 has been read
        if (tid == 0) mbar_arrive(empty0 + 8 * prev);
      }
      prev = s;
      if (++s == stages) {
        s = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (tid == 0) mbar_arrive(empty0 + 8 * prev);

    const int64_t t = j * TG + t_first;
    if (ragged && t == nt - 1) {             // the tail mask: last tile only
#pragma unroll
      for (int e = 0; e < 64; ++e)
        if ((e % 4) >= 2 ? cut_hi : cut_lo) acc[e] = -INFINITY;
    }
    const int jj = static_cast<int>(j);
#pragma unroll
    for (int e = 0; e < 64; ++e) {
      const bool win = acc[e] > best[e];
      best[e] = win ? acc[e] : best[e];
      bj[e] = win ? jj : bj[e];
    }
  }

  // each bin once; a warp's store covers 8 queries x 8 adjacent bins
  const int64_t bin0 = static_cast<int64_t>(r) * 128 + h * NH + row0;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    const int64_t b = q0 + wg * 128 + 8 * (e / 4) + 2 * (lane % 4) + (e % 2);
    const int64_t o = b * BINS + bin0 + ((e % 4) >= 2 ? 8 : 0);
    out_d[o] = -best[e];
    out_j[o] = static_cast<int16_t>(bj[e]);  // the i16 sidecar
  }
}

}  // namespace

// q bf16 [B, d] with B % 256 == 0, table bf16 [nt * C_BLK, d] (rows >= n
// zero), d % 128 == 0, both 16-byte aligned; out_d f32 [B, BINS], out_j i16
// [B, BINS]. Returns a cudaError_t (cudaErrorInvalidValue for a shape the
// kernel does not take or a tensor map the driver refuses).
extern "C" int msann_binned_scan(const void* q, const void* table, int64_t B,
                                 int64_t nt, int64_t d, int64_t n,
                                 void* out_d, void* out_j, void* stream) {
  if (B <= 0) return (int)cudaSuccess;
  if (B % QT != 0 || d % 128 != 0 || nt <= 0 ||
      nt * C_BLK > 0x7fffffffLL || B > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const int64_t budget = SMEM_LIMIT - SMEM_SLACK;
  const int64_t q_bytes = static_cast<int64_t>(QT) * d * 2;
  const int resident = q_bytes + 4 * T_BYTES <= budget ? 1 : 0;
  const int64_t stage_bytes = resident ? T_BYTES : T_BYTES + Q_BYTES;
  int64_t stages = (budget - (resident ? q_bytes : 0)) / stage_bytes;
  if (stages > MAX_STAGES) stages = MAX_STAGES;
  if (stages < 2) return (int)cudaErrorInvalidValue;
  const int64_t smem = (resident ? q_bytes : 0) + stages * stage_bytes +
                       SMEM_SLACK;

  CUtensorMap q_map, t_map;
  if (!encode(&q_map, q, B, d, QT) ||
      !encode(&t_map, table, nt * C_BLK, d, NH))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      binned_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(static_cast<unsigned>(B / QT), 2 * BINS / 128);
  binned_scan_kernel<<<grid, THREADS, smem,
                       static_cast<cudaStream_t>(stream)>>>(
      q_map, t_map, nt, static_cast<int>(d), n, resident,
      static_cast<int>(stages), static_cast<float*>(out_d),
      static_cast<int16_t*>(out_j));
  return (int)cudaGetLastError();
}
