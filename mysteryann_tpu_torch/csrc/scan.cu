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

namespace {

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

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  }
}

// One 2-D TMA box (inner coordinate c0 in elements, row c1) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma matrix descriptor of a K-major operand in the 128-byte swizzled
// layout TMA writes: 8-row groups 1024 B apart (SBO), the leading offset
// unused, the base 1024-byte aligned. Adding 2 advances K by 16 bf16 (32 B).
__device__ __forceinline__ uint64_t make_desc(uint32_t saddr) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// acc (64 x 128 f32, this thread's 64 values) (+)= A (64 x 16) · B (16 x 128)
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da,
                                                 uint64_t db, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keeps the compiler from moving reads or writes of the accumulator across
// the asynchronous wgmma boundaries.
__device__ __forceinline__ void fence_acc(float (&acc)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(acc[i])::"memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled through the runtime's driver entry point, so the
// library needs no -lcuda.
EncodeTiled encode_fn() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 [rows, d] row-major matrix as boxes of [box_rows, 64] elements,
// 128-byte swizzled (the layout the wgmma descriptors above read).
bool encode(CUtensorMap* map, const void* ptr, int64_t rows, int64_t d,
            uint32_t box_rows) {
  EncodeTiled fn = encode_fn();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 2};
  const cuuint32_t box[2] = {KC, box_rows};
  const cuuint32_t estr[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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
