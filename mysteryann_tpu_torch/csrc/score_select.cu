// The bf16 score product fused with the k-selection, for Hopper (sm_90a):
// for bf16 queries Q [B, d] and a bf16 table T [n, d], the k <= 256
// smallest of dist(q, t) per query, ascending, ties to the lower column,
// with no [B, n] score block ever written -- kernel K3f of the port.
//
//   ip, cosine:  dist = -(q . t)
//   l2:          dist = max(q_sq - 2 (q . t) + t_sq, 0)   (f32, in that order)
//
// Products are bf16 x bf16 with an f32 accumulation on the tensor cores.
//
// Replaces the TPU's matmul -> approx_min_k fusion: XLA feeds the bf16
// einsum with an f32 result (mysteryann_tpu/search/seeding.py:45-54) and
// the bf16 flat scan's distance block (mysteryann_tpu/ops/knn.py:70-78,
// from flat.py:174-178) straight into the partial-reduce selection, so the
// TPU never writes a score block either. Here it serves seed_scan (the
// seeded searchers, the fused build's phase-D seeds) and exact_knn_device
// on bf16 operands (FlatIndex(precision="bf16")).
//
// What bounds it on the card: not the products' 2 B n d flops at 989
// TFLOP/s (33.1 ms for 8,192 queries x 10M x 200) but the ring's feed and
// the card's power. Each of the 64 query tiles reads the whole table from
// L2 (256 GB a call at that shape); a block's ring alone, with no product
// and no selection, sustains a 128-row step of d = 200 in ~1.4 us at the
// TMA's ~2 us round trip, and the products and the selection together draw
// the card to its 700 W cap, where the SM clock falls to ~1.5 GHz. So what
// the design spends less of is bytes in flight and energy a step.
//
// Engine (K2's, scan.cu): warpgroup `consumers` is the producer, one thread
// of it keeping a ring of swizzled table stages full by TMA, guarded by
// full / empty mbarriers; the query tile (64 x consumers queries, all of d)
// is loaded once and stays resident. A stage is one chunk of a step: 128
// table rows x 64 dimensions (16 KB, 128-byte swizzle). Each consumer
// warpgroup owns 64 queries and issues wgmma.m64n128k16 bf16 -> f32 with the
// queries as A and the step's 128 table rows as B, both K-major behind
// matrix descriptors. A thread then holds 32 scores of each of two queries
// (rows lane/4 and lane/4 + 8 of its warp's 16): two thresholds in
// registers. setmaxnreg gives the producer 40 registers and the consumers
// 232.
//
// Long shares (the plan's, queues of 32 and 64): where a row's last
// dimensions fit 16 or 32 columns and that makes the ring deeper, the last
// chunk is a box that wide (32- or 64-byte swizzle: 4 KB at d = 200, in the
// query tile too), of which a warpgroup issues only the 1 or 2 k-slices
// that hold dimensions (13 of 16 at d = 200); the ring then holds whole
// steps, and beside a queue of 32 the candidate buffers hold 24 keys (8
// stages, two steps at d = 200, where full boxes held 1.25). Each of these
// is an instance's template parameter, with the pre-filter below: ptxas
// serializes every wgmma of a kernel with a runtime branch around one, and
// the pre-filter's block cost the short shares' loop ~2% even switched off.
// Everything else runs the base loop: full boxes, all four k-slices of
// every chunk, 32-key buffers (ten instances in all).
//
// Schedule. The consumer warpgroups run in step: each issues a step chunk
// by chunk, releasing each chunk's stage once the next is issued and it
// has been read, and selects once its product has drained, while the
// producer refills the released stages. Two warpgroups that take turns on
// the tensor cores (ping-pong: one selects under the other's product) were
// built and measured slower at every shape (8-9% at d = 128): a stage then
// lives until the second warpgroup's product, which a ring of two steps
// cannot cover at that round trip, and under the power cap overlapping the
// selection saves no energy.
//
// Selection (K3's, k3_queue.cuh), after a warpgroup's product of a step has
// drained. On long shares, for ip and cosine, after a step that passed no
// score, each lane first takes the largest of its 32 scores of each query:
// when no query of the warp has one that reaches its filter (almost every
// step once the queues are full), one vote ends the step, in place of 64
// compares and predicated stores a lane (the pre-filter). Else each
// score is compared, as a float, with its query's threshold value (the k-th
// best key so far; an unfilled queue's lets every score through), and a
// lane stages the few that pass, with their place in the fragment, in
// shared memory: the compare, a predicated store and an add, in one compact
// unrolled loop per metric (a branch per score in that loop, the metric's
// or a warp vote's, made the kernel several times slower). The staged
// scores then form their composite keys (value image, column; columns past
// the block's share or past n -- TMA's zero fill -- get no key), compared
// exactly with the threshold key; a key below it takes a slot of its
// query's candidate buffer (the instance's BUF keys; a shared atomic). A
// full buffer makes the warp merge its 16 queries' buffers into their
// sorted queues (shared memory, N = 32 x KPL keys each, loaded into
// registers for K3's warp merge: one call site) and reload the thresholds;
// what did not fit stays staged and is compared again. A lane with more
// than STAGE passing scores in a step (the first steps) sends the warp to
// an exact pass over the registers instead, which skips the keys it took
// (a bit a score) when it goes over a step again after a flush.
//
// Split: the table's columns are cut into `splits` shares of `split_cols`
// (a multiple of 128) per query tile, so the grid fills the SMs at any B.
// Each block writes its k best of its share, ascending, to a partial
// [B, splits x k]; K3's warp route merges those rows (ops/score_select.py).
// A query's scores do not depend on the split, the batch, the schedule or
// the other queries of its tile (the K order is fixed per element; the
// k-slices of zeros a narrow box leaves out add +0.0 to each sum, and a key
// reads -0.0 as +0.0), and the selection is exact over unique keys: a
// query's result has the same bits alone and in any batch, on every run.
//
// Every kernel lives in namespace msann_k3f.

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_tma.cuh"
#include "k3_queue.cuh"

namespace msann_k3f {

using namespace msann_hopper;
using namespace msann_k3;

constexpr int NT = 128;                      // table rows a step
constexpr int KC = kBoxCols;                 // dimensions a chunk
constexpr int T_BYTES = NT * KC * 2;         // a full table stage: 16 KB
constexpr int MAX_STAGES = 8;
constexpr int SMEM_LIMIT = 232448;           // per block, sm_90
constexpr int SMEM_SLACK = 1024 + 8 * (2 * MAX_STAGES + 1);
constexpr int BUF = 32;                      // candidate buffer keys a query
constexpr int SMALL_BUF = 24;                // ... beside a queue of 32 and a
                                             // narrow last box
constexpr int STAGE = 4;                     // staged scores a lane a step
constexpr int STAGE_WARP = 32 * STAGE + 64;  // a warp's, with room to run over

// ---- launch arguments, as ops/score_select.py::_pack_args packs them ----
enum Arg {
  kQ = 0,        // queries, bf16 [B, d], rows kLdQ apart, 16-byte aligned
  kT,            // table, bf16 [n, d], rows kLdT apart, 16-byte aligned
  kQSq,          // l2: f32 [B]; else 0
  kTSq,          // l2: f32 [n]; else 0
  kOutV,         // values, f32 [B, ld]
  kOutI,         // columns, int64 [B, ld]
  kB,
  kN,
  kD,            // the row width, any (past the last box: zeros)
  kLdQ,          // row pitches in elements: multiples of 8, at least d
  kLdT,
  kK,
  kL2,           // 1: l2; 0: ip / cosine
  kLd,           // splits x k
  kConsumers,    // consumer warpgroups: 64 queries each
  kSplitCols,    // columns a block, a multiple of NT
  kSplits,
  kQueue,        // N = 32 x KPL >= k
  kStages,       // ring stages; a multiple of the chunks under a narrow tail
  kTailCols,     // the last chunk's box: 64, or (pre-filter) 32 or 16
  kBuf,          // candidate buffer keys a query: BUF, or SMALL_BUF beside
                 // a queue of 32 and a narrow last box
  kPrefilter,    // 1 (queues of 32 and 64): ip's per-step maximum may end a
                 // quiet step
  kStream,
  kArgs
};

struct Params {
  const float* q_sq;
  const float* t_sq;
  float* out_v;
  int64_t* out_i;
  int64_t B, n, ld, split_cols;
  int chunks, k, l2, stages, consumers;
};

// A step of the ring: chunks - 1 full stages and the last chunk's box.
__host__ __device__ inline int64_t step_bytes(int chunks, int tail_cols) {
  return (int64_t)(chunks - 1) * T_BYTES + (int64_t)NT * tail_cols * 2;
}

// Stage s's offset in the ring: whole steps, then full stages (a narrow
// tail needs a multiple of the chunks; under a full one this is s x T_BYTES).
__host__ __device__ inline int64_t stage_off(int s, int chunks,
                                             int tail_cols) {
  return (s / chunks) * step_bytes(chunks, tail_cols) +
         (int64_t)(s % chunks) * T_BYTES;
}

// the query tile, the ring, the queues and buffers, the staged scores and
// the buffers' counts
int64_t smem_bytes(int chunks, int tail_cols, int consumers, int queue,
                   int stages, int buf) {
  const int64_t qt = 64 * consumers;
  return SMEM_SLACK + qt * ((int64_t)(chunks - 1) * KC + tail_cols) * 2 +
         stage_off(stages, chunks, tail_cols) + qt * (queue + buf) * 8 +
         (int64_t)4 * consumers * STAGE_WARP * 8 + qt * 4;
}

// acc (64 x 128 f32, this thread's 64 values) (+)= A (64 x 16 NK) . B^T:
// NK k-slices of a chunk (4, or the last chunk's)
template <int NK>
__device__ __forceinline__ void mma_chunk(float (&acc)[64], uint64_t da,
                                          uint64_t db, bool first) {
#pragma unroll
  for (int kk = 0; kk < NK; ++kk)
    wgmma_m64n128k16(acc, da + 2 * kk, db + 2 * kk,
                     (!first || kk > 0) ? 1 : 0);
}

// The largest of this lane's 32 scores of query A (Q = 0) or B (Q = 2):
// acc[e] with e & 2 == Q. fmaxf drops a NaN, which can form no key below a
// filled queue's threshold (an unfilled one's filter is NaN: all pass).
template <int Q>
__device__ __forceinline__ float step_max(const float (&acc)[64]) {
  float m[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = fmaxf(acc[4 * i + Q], acc[4 * i + Q + 1]);
#pragma unroll
  for (int e = 16; e < 64; e += 16) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      m[i] = fmaxf(m[i], fmaxf(acc[e + 4 * i + Q], acc[e + 4 * i + Q + 1]));
  }
  return fmaxf(fmaxf(m[0], m[1]), fmaxf(m[2], m[3]));
}

// The float filter of a threshold key: a distance can form a key below
// it only if it is not above the key's value (l2: the distance itself;
// ip: the inner product, the negated distance, against the negated value);
// a NaN value -- an unfilled queue's kNoKey, or a NaN k-th -- lets every
// score through to the exact key compare.
__device__ __forceinline__ float filter_of(uint64_t thr, int l2) {
  const float tf = unimage((uint32_t)(thr >> 32));
  return l2 ? tf : -tf;
}

// Merge the buffered keys of the warp's 16 queries into their queues
// (queue j at wq + j x N, buffer at wb + j x BUF, count at wc[j]), zero the
// counts and reload the lane's two thresholds and filters.
template <int KPL, int BUF>
__device__ void flush_warp(uint64_t* wq, const uint64_t* wb, int* wc, int k,
                           int l2, int lane, uint64_t& thrA, uint64_t& thrB,
                           float& fA, float& fB) {
  constexpr int N = 32 * KPL;
  __syncwarp();
#pragma unroll 1
  for (int j = 0; j < 16; ++j) {
    const int c = min(wc[j], BUF);
    if (c == 0) continue;
    uint64_t* qq = wq + j * N;
    uint64_t q[KPL];
#pragma unroll
    for (int r = 0; r < KPL; ++r) q[r] = qq[r * 32 + lane];
    flush<KPL>(q, wb + j * BUF, c, lane);
#pragma unroll
    for (int r = 0; r < KPL; ++r) qq[r * 32 + lane] = q[r];
  }
  __syncwarp();
  if (lane < 16) wc[lane] = 0;
  thrA = wq[(lane >> 2) * N + k - 1];
  thrB = wq[((lane >> 2) + 8) * N + k - 1];
  fA = filter_of(thrA, l2);
  fB = filter_of(thrB, l2);
  __syncwarp();
}

// The column of this lane's score e of the step from c0 (acc[e]: query
// e & 2 ? B : A).
__device__ __forceinline__ int64_t col_of(int e, int64_t c0, int lane) {
  return c0 + 8 * (e >> 2) + 2 * (lane & 3) + (e & 1);
}

// A candidate's composite key; no key past the block's share.
__device__ __forceinline__ uint64_t cand_key(float dist, int e, int64_t c0,
                                             int64_t col_end, int lane) {
  const int64_t col = col_of(e, c0, lane);
  return col < col_end ? make_key(dist, col) : kNoKey;
}

// l2: max(q_sq - 2 ip + t_sq, 0), in the plain version's order.
__device__ __forceinline__ float l2_dist(float q_sq, float ip,
                                         const float* t_sq, int e, int64_t c0,
                                         int64_t col_end, int lane) {
  const int64_t col = col_of(e, c0, lane);
  const float x = __fadd_rn(__fsub_rn(q_sq, __fmul_rn(2.0f, ip)),
                            __ldg(t_sq + (col < col_end ? col : 0)));
  return x < 0.0f ? 0.0f : x;
}

// The filter over a step's 64 scores of this lane (acc[e]: query e & 2 ? B
// : A): each score that may form a key below its query's threshold is
// staged with its e (the distance for l2, the inner product for ip).
// Returns the count; entries past STAGE run on into the next lanes'.
template <bool L2>
__device__ __forceinline__ int stage_scores(const float (&acc)[64], uint2* st,
                                            float fA, float fB, float qsqA,
                                            float qsqB, const float* t_sq,
                                            int64_t c0, int64_t col_end,
                                            int lane) {
  int n = 0;
#pragma unroll
  for (int e = 0; e < 64; ++e) {
    float v;
    bool maybe;
    if (L2) {
      v = l2_dist((e & 2) ? qsqB : qsqA, acc[e], t_sq, e, c0, col_end, lane);
      maybe = !(v > ((e & 2) ? fB : fA));
    } else {
      v = acc[e];
      maybe = !(v < ((e & 2) ? fB : fA));   // -acc <= the k-th value
    }
    if (maybe) st[n++] = make_uint2(__float_as_uint(v), (unsigned)e);
  }
  return n;
}

// TAILK 4: the last chunk in a full box, all four k-slices issued (the
// base loop); 1 or 2: in a box 16 x TAILK columns wide, TAILK k-slices.
// PRE: the ip pre-filter.
template <int KPL, int TAILK, int BUF, bool PRE>
__global__ void __launch_bounds__(384, 1)
score_select_kernel(const __grid_constant__ CUtensorMap q_map,
                    const __grid_constant__ CUtensorMap t_map,
                    const __grid_constant__ CUtensorMap q_tail_map,
                    const __grid_constant__ CUtensorMap t_tail_map,
                    const Params p) {
  constexpr int N = 32 * KPL;
  constexpr bool kNarrow = TAILK < 4;
  constexpr int kTailCols = kNarrow ? 16 * TAILK : KC;
  constexpr uint32_t kTailBytes = NT * kTailCols * 2;
  extern __shared__ uint8_t smem_raw[];
  // TMA's 128-byte swizzle repeats every 1024 B: align the base to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = smem_raw + (base - raw);

  const int qt = 64 * p.consumers;
  const int last = p.chunks - 1;
  // the query tile: chunk c's box at c x qt x 128 B, the last one narrower
  const uint32_t q_area = (uint32_t)qt * (last * KC + kTailCols) * 2;
  const uint32_t ring = base + q_area;
  uint64_t* queues = reinterpret_cast<uint64_t*>(
      gbase + q_area + stage_off(p.stages, p.chunks, kTailCols));
  uint64_t* bufs = queues + (size_t)qt * N;
  uint2* stage = reinterpret_cast<uint2*>(bufs + (size_t)qt * BUF);
  int* counts = reinterpret_cast<int*>(stage + (size_t)4 * p.consumers *
                                                   STAGE_WARP);
  uint64_t* bars = reinterpret_cast<uint64_t*>(counts + qt);
  // bars[s]: stage s full; bars[MAX_STAGES + s]: stage s empty; then qbar
  const uint32_t full0 = smem_u32(bars);
  const uint32_t empty0 = full0 + 8 * MAX_STAGES;
  const uint32_t qbar = full0 + 16 * MAX_STAGES;

  const int64_t q0 = (int64_t)blockIdx.x * qt;
  const int64_t col_start = (int64_t)blockIdx.y * p.split_cols;
  const int64_t col_end = min(p.n, col_start + p.split_cols);
  const int64_t steps = (col_end - col_start + NT - 1) / NT;

  if (threadIdx.x == 0) {
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, p.consumers);  // one arrival a consumer
    }
    mbar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == p.consumers) {
    // ---- producer: one thread keeps the ring full ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;");
    if (threadIdx.x != 128 * p.consumers) return;
    mbar_expect_tx(qbar, q_area);
    for (int c = 0; c < p.chunks; ++c)
      tma_load(base + c * qt * KC * 2,
               kNarrow && c == last ? &q_tail_map : &q_map, qbar, c * KC,
               (int)q0);
    int s = 0;
    uint32_t phase = 0, off = 0;   // narrow: stage s at ring + off
    for (int64_t j = 0; j < steps; ++j) {
      const int row0 = (int)(col_start + j * NT);
      for (int c = 0; c < p.chunks; ++c) {
        mbar_wait(empty0 + 8 * s, phase ^ 1u);
        if constexpr (kNarrow) {
          const uint32_t bytes = c < last ? T_BYTES : kTailBytes;
          mbar_expect_tx(full0 + 8 * s, bytes);
          tma_load(ring + off, c < last ? &t_map : &t_tail_map,
                   full0 + 8 * s, c * KC, row0);
          off += bytes;
        } else {
          mbar_expect_tx(full0 + 8 * s, T_BYTES);
          tma_load(ring + s * T_BYTES, &t_map, full0 + 8 * s, c * KC, row0);
        }
        if (++s == p.stages) {
          s = 0;
          off = 0;
          phase ^= 1u;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns queries q0 + wg*64 .. +64; warp w of
  // it the 16 from wrow0, lane the two at lane/4 and lane/4 + 8 ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;");
  const int tid = threadIdx.x % 128;
  const int lane = tid % 32;
  const int warp = wg * 4 + tid / 32;
  const int wrow0 = warp * 16;
  const int rowA = wrow0 + lane / 4, rowB = rowA + 8;
  uint64_t* wq = queues + (size_t)wrow0 * N;
  uint64_t* wb = bufs + (size_t)wrow0 * BUF;
  int* wc = counts + wrow0;
  uint2* st = stage + (size_t)warp * STAGE_WARP + lane * STAGE;
  for (int i = lane; i < 16 * N; i += 32) wq[i] = kNoKey;
  if (lane < 16) wc[lane] = 0;
  __syncwarp();
  float qsqA = 0.0f, qsqB = 0.0f;
  if (p.l2) {
    if (q0 + rowA < p.B) qsqA = p.q_sq[q0 + rowA];
    if (q0 + rowB < p.B) qsqB = p.q_sq[q0 + rowB];
  }
  uint64_t thrA = kNoKey, thrB = kNoKey;
  float fA = filter_of(kNoKey, p.l2), fB = fA;
  bool quiet = false;   // no score of the warp passed its last step's filter
  // this warpgroup's A of chunk c: its 64 rows of the query tile's box
  const uint32_t qa = base + wg * 64 * KC * 2;

  mbar_wait(qbar, 0);
  int s = 0;
  uint32_t phase = 0, off = 0;     // narrow: stage s at ring + off
  for (int64_t j = 0; j < steps; ++j) {
    const int64_t c0 = col_start + j * NT;
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.0f;
    // the full chunks, then, in a narrow box, the last one's TAILK
    // k-slices; each chunk's stage is released once the next one is issued
    // and it has been read
    const int full = kNarrow ? last : p.chunks;
    int prev = 0;
    for (int c = 0; c < full; ++c) {
      mbar_wait(full0 + 8 * s, phase);
      const uint64_t da = make_desc(qa + c * qt * KC * 2);
      const uint64_t db = make_desc(ring + (kNarrow ? off : s * T_BYTES));
      fence_acc(acc);
      wgmma_fence();
      mma_chunk<4>(acc, da, db, c == 0);
      wgmma_commit();
      fence_acc(acc);
      if (c > 0) {
        wgmma_wait<1>();                     // chunk c - 1 has been read
        if (tid == 0) mbar_arrive(empty0 + 8 * prev);
      }
      prev = s;
      if constexpr (kNarrow) off += T_BYTES;
      if (++s == p.stages) {
        s = 0;
        off = 0;
        phase ^= 1u;
      }
    }
    if constexpr (kNarrow) {
      mbar_wait(full0 + 8 * s, phase);
      const uint64_t da = make_desc(
          base + last * qt * KC * 2 + wg * 64 * kTailCols * 2, kTailCols);
      const uint64_t db = make_desc(ring + off, kTailCols);
      fence_acc(acc);
      wgmma_fence();
      mma_chunk<TAILK>(acc, da, db, last == 0);
      wgmma_commit();
      fence_acc(acc);
      if (last > 0) {
        wgmma_wait<1>();
        if (tid == 0) mbar_arrive(empty0 + 8 * prev);
      }
      prev = s;
      off += kTailBytes;
      if (++s == p.stages) {
        s = 0;
        off = 0;
        phase ^= 1u;
      }
    }
    wgmma_wait<0>();
    fence_acc(acc);
    if (tid == 0) mbar_arrive(empty0 + 8 * prev);

    // ip: when each query's largest inner product of the step is below its
    // filter, no score can pass (the steady state): one vote in place of the
    // filter's 64 compares and stores, tried after a step that passed none
    // (PRE: where the plan's shares are long enough for the queues to settle)
    if constexpr (PRE) {
      if (!p.l2 && quiet &&
          !__any_sync(kFull, !(step_max<0>(acc) < fA) ||
                                 !(step_max<2>(acc) < fB)))
        continue;
    }
    // the filter; a lane's entries past STAGE run over into the next
    // lane's (the warp's region has room for 64 past its last lane) and
    // send the warp to the exact pass below
    int n = p.l2 ? stage_scores<true>(acc, st, fA, fB, qsqA, qsqB, p.t_sq,
                                      c0, col_end, lane)
                 : stage_scores<false>(acc, st, fA, fB, qsqA, qsqB, p.t_sq,
                                       c0, col_end, lane);
    if constexpr (PRE) quiet = false;
    if (__any_sync(kFull, n > STAGE)) {
      // the exact pass over the registers (the first steps: every score
      // passes an unfilled queue's filter); a buffer that cannot take a
      // key flushes the warp and the step is gone over again, skipping the
      // keys already taken
      uint64_t taken = 0;
      for (;;) {
        bool over = false;
#pragma unroll
        for (int e = 0; e < 64; ++e) {
          const bool isB = (e & 2) != 0;
          float v;
          if (p.l2) {
            v = l2_dist(isB ? qsqB : qsqA, acc[e], p.t_sq, e, c0, col_end,
                        lane);
          } else {
            v = -acc[e];
          }
          const uint64_t key = cand_key(v, e, c0, col_end, lane);
          if (!((taken >> e) & 1ull) && key < (isB ? thrB : thrA)) {
            const int row = isB ? rowB : rowA;
            const int slot = atomicAdd(counts + row, 1);
            if (slot < BUF) {
              bufs[(size_t)row * BUF + slot] = key;
              taken |= 1ull << e;
            } else {
              over = true;
            }
          }
        }
        if (!__any_sync(kFull, over)) break;
        flush_warp<KPL, BUF>(wq, wb, wc, p.k, p.l2, lane, thrA, thrB, fA,
                             fB);
      }
    } else if (__any_sync(kFull, n > 0)) {
      // the staged candidates: exact keys; what a full buffer cannot take
      // stays staged until the warp has flushed
      for (;;) {
        int kept = 0;
        for (int i = 0; i < n; ++i) {
          const uint2 c = st[i];
          const int e = (int)c.y;
          const bool isB = (e & 2) != 0;
          const float v = p.l2 ? __uint_as_float(c.x) : -__uint_as_float(c.x);
          const uint64_t key = cand_key(v, e, c0, col_end, lane);
          if (key < (isB ? thrB : thrA)) {
            const int row = isB ? rowB : rowA;
            const int slot = atomicAdd(counts + row, 1);
            if (slot < BUF) bufs[(size_t)row * BUF + slot] = key;
            else st[kept++] = c;
          }
        }
        n = kept;
        if (!__any_sync(kFull, kept > 0)) break;
        flush_warp<KPL, BUF>(wq, wb, wc, p.k, p.l2, lane, thrA, thrB, fA,
                             fB);
      }
    } else if constexpr (PRE) {
      quiet = true;
    }
  }
  flush_warp<KPL, BUF>(wq, wb, wc, p.k, p.l2, lane, thrA, thrB, fA, fB);

  // this block's k best of its share, each query's ascending
  for (int j = 0; j < 16; ++j) {
    const int64_t b = q0 + wrow0 + j;
    if (b >= p.B) break;
    const uint64_t* qq = wq + j * N;
    float* ov = p.out_v + b * p.ld + (int64_t)blockIdx.y * p.k;
    int64_t* oi = p.out_i + b * p.ld + (int64_t)blockIdx.y * p.k;
    for (int i = lane; i < p.k; i += 32) {
      const uint64_t key = qq[i];
      oi[i] = (int64_t)(uint32_t)key;
      ov[i] = unimage((uint32_t)(key >> 32));
    }
  }
}

// A launch's grid and arguments.
struct Launch {
  const CUtensorMap* maps;   // q, t, and the boxes of their last chunks
  Params p;
  int64_t tiles, splits;
  size_t smem;
  cudaStream_t stream;
};

template <int KPL, int TAILK, int BUF, bool PRE>
int launch(const Launch& l) {
  const cudaError_t e = cudaFuncSetAttribute(
      score_select_kernel<KPL, TAILK, BUF, PRE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)l.smem);
  if (e != cudaSuccess) return (int)e;
  score_select_kernel<KPL, TAILK, BUF, PRE>
      <<<dim3((unsigned)l.tiles, (unsigned)l.splits),
         128 * (l.p.consumers + 1), l.smem, l.stream>>>(
          l.maps[0], l.maps[1], l.maps[2], l.maps[3], l.p);
  return (int)cudaSuccess;
}

// The kernel's ten instances: the base loop (a full last box, BUF-key
// buffers, no pre-filter) for each queue; for queues of 32 and 64 on the
// plan's long shares, the pre-filter, with the last chunk in a full box or
// in a 16- or 32-column one (24-key buffers beside a queue of 32).
int launch_plan(const Launch& l, int queue, int tail_cols, bool prefilter) {
  if (!prefilter) {
    switch (queue) {
      case 32: return launch<1, 4, BUF, false>(l);
      case 64: return launch<2, 4, BUF, false>(l);
      case 128: return launch<4, 4, BUF, false>(l);
      default: return launch<8, 4, BUF, false>(l);
    }
  }
  if (queue == 32) {
    if (tail_cols == 16) return launch<1, 1, SMALL_BUF, true>(l);
    if (tail_cols == 32) return launch<1, 2, SMALL_BUF, true>(l);
    return launch<1, 4, BUF, true>(l);
  }
  if (tail_cols == 16) return launch<2, 1, BUF, true>(l);
  if (tail_cols == 32) return launch<2, 2, BUF, true>(l);
  return launch<2, 4, BUF, true>(l);
}

}  // namespace msann_k3f

using namespace msann_k3f;

// One argument, a packed buffer of kArgs int64s (see Arg). Returns the
// launch's CUDA error (0 when it was queued); an argument the kernel cannot
// take, or a tensor map the driver refuses, returns cudaErrorInvalidValue
// before anything is launched.
extern "C" int msann_score_select(const int64_t* a) {
  const int64_t B = a[kB], n = a[kN], d = a[kD], k = a[kK];
  const int64_t ld_q = a[kLdQ], ld_t = a[kLdT];
  const int64_t queue = a[kQueue], consumers = a[kConsumers];
  const int64_t split_cols = a[kSplitCols], splits = a[kSplits];
  const int64_t stages = a[kStages], tail_cols = a[kTailCols];
  const int64_t buf = a[kBuf];
  const bool prefilter = a[kPrefilter] != 0;
  const bool narrow = tail_cols < KC;
  if (B <= 0) return (int)cudaSuccess;
  const int64_t qt = 64 * consumers;
  const int64_t chunks = (d + KC - 1) / KC;
  const int64_t tail = d - KC * (chunks - 1);
  if (k < 1 || k > queue || k > n ||
      (queue != 32 && queue != 64 && queue != 128 && queue != 256) ||
      (consumers != 1 && consumers != 2) || d < 1 || ld_q < d ||
      ld_q % 8 != 0 || ld_t < d || ld_t % 8 != 0 || a[kQ] % 16 != 0 ||
      a[kT] % 16 != 0 || n + NT >= 0x7fffffffLL ||
      B + qt >= 0x7fffffffLL || split_cols <= 0 || split_cols % NT != 0 ||
      splits < 1 || splits > 65535 || (splits - 1) * split_cols >= n ||
      splits * split_cols < n || a[kLd] != splits * k ||
      stages < 2 || stages > MAX_STAGES ||
      (tail_cols != 16 && tail_cols != 32 && tail_cols != KC) ||
      tail > tail_cols || (narrow && stages % chunks != 0) ||
      (prefilter && queue > 64) || (narrow && !prefilter) ||
      buf != (narrow && queue == 32 ? SMALL_BUF : BUF) ||
      (a[kL2] && (!a[kQSq] || !a[kTSq])))
    return (int)cudaErrorInvalidValue;
  const int64_t smem = smem_bytes((int)chunks, (int)tail_cols,
                                  (int)consumers, (int)queue, (int)stages,
                                  (int)buf);
  if (smem > SMEM_LIMIT) return (int)cudaErrorInvalidValue;

  // q, t, and the boxes of the last chunk of each; boxes past B, n or d (a
  // batch under a tile, a table under a step, d under a box) read as zeros:
  // masked by p.B and the share's end, or never multiplied
  CUtensorMap maps[4];
  const void* q = reinterpret_cast<const void*>(a[kQ]);
  const void* t = reinterpret_cast<const void*>(a[kT]);
  if (!encode(&maps[0], q, B, d, (uint32_t)qt, ld_q) ||
      !encode(&maps[1], t, n, d, NT, ld_t) ||
      !encode(&maps[2], q, B, d, (uint32_t)qt, ld_q, (uint32_t)tail_cols) ||
      !encode(&maps[3], t, n, d, NT, ld_t, (uint32_t)tail_cols))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q_sq = reinterpret_cast<const float*>(a[kQSq]);
  p.t_sq = reinterpret_cast<const float*>(a[kTSq]);
  p.out_v = reinterpret_cast<float*>(a[kOutV]);
  p.out_i = reinterpret_cast<int64_t*>(a[kOutI]);
  p.B = B;
  p.n = n;
  p.ld = a[kLd];
  p.split_cols = split_cols;
  p.chunks = (int)chunks;
  p.k = (int)k;
  p.l2 = a[kL2] ? 1 : 0;
  p.stages = (int)stages;
  p.consumers = (int)consumers;
  const Launch l{maps, p, (B + qt - 1) / qt, splits, (size_t)smem,
                 reinterpret_cast<cudaStream_t>(a[kStream])};
  const int e = launch_plan(l, (int)queue, (int)tail_cols, prefilter);
  if (e != 0) return e;
  return (int)cudaGetLastError();
}
