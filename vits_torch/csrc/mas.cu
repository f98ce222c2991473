// Monotonic Alignment Search (MAS) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of vits_tpu/ops/mas_pallas.py,
// _forward_kernel (mas_pallas.py:36), the forward DP over frames that emits
// one decision row per frame, and _backtrack_kernel (mas_pallas.py:57), the
// reverse walk from (t_y-1, t_x-1) that writes the path. Two designs, of
// which ops/mas_cuda.py::route picks one by shape:
//   mas_fused_kernel     both in one launch, warp-resident DP, decisions
//                        bit-packed in shared memory; the main path's kernel
//                        (its own note is at its definition below)
//   mas_wide_kernel      the same in one launch at the shapes mas_fused
//                        cannot take (T_x > 1024, or decisions beyond shared
//                        memory): an item's columns over a cluster of blocks,
//                        a wavefront of warps of narrow lanes, decisions
//                        bit-packed in device memory (its note is at its
//                        definition)
//
// Semantics are those of vits_tpu/ops/mas.py::maximum_path_scan and of the
// plain PyTorch version in vits_torch/ops/mas.py, bit for bit: the same f32
// sentinel (-1e9), the same `neg + fmaxf(prev, shifted)` order and a strict
// `<` for the decision, so ties stay in the column. The kernels work on the
// rectangle [t_y, t_x] that the lengths give: no value inside it depends on
// a cell outside it, so masking by -1e9 is never needed there. A length is
// clamped to the tensor's extent, so no length reaches memory outside it.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmas.so mas.cu   (vits_torch/_build.py)
// Each entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <type_traits>

namespace {

constexpr float kBigNeg = -1e9f;

// ---------------------------------------------------------------------------
// mas_fused_kernel: the whole of maximum_path in one launch.
//
// Replaces _forward_kernel (vits_tpu/ops/mas_pallas.py:36) and
// _backtrack_kernel (mas_pallas.py:57) together, and the glue that two
// separate kernels would need (length sums, casts, a decision tensor in
// device memory). It reads neg_cent and the mask, [B, T_y, T_x] f32, and writes the
// [B, T_y, T_x] f32 path, equal bit for bit to
// vits_torch/ops/mas.py::maximum_path_torch, with its arithmetic: the same
// `neg + fmaxf(prev, shifted)`, -1e9 sentinels, strict `<` and the walk's
// `idx == y` step.
//
// Bound on this card: it must read the scores inside each item's t_y x t_x
// rectangle (4 B a cell) and the mask's first column and row, and write the
// whole path (4 B a cell of B*T_y*T_x); at B=16, T_y=400, T_x=191 with the
// main path's lengths that is about 8.6 MB, about 2.6 us at 3.35 TB/s. The
// arithmetic (an add, a max and a compare a cell) is negligible. The real
// floor is the chain: row y of the DP needs all of row y-1, and the walk's
// row y-1 needs the column row y chose, so an item takes t_y dependent row
// steps and then t_y dependent walk steps, whatever the bandwidth. What the
// design does about each:
//   * The DP row lives in registers of one warp and the chain holds no block
//     barrier. Lane l holds K consecutive columns lK .. lK+K-1 (K a template
//     parameter, odd so that the lanes' scalar shared-memory loads of a row
//     hit 32 different banks). Only column lK needs another lane: one
//     __shfl_up_sync a row brings lane l-1's last column, and it is issued
//     first, on values the previous row finished first, so its latency
//     overlaps the other K-1 columns' compare, max and add. (Lanes on
//     columns l, l+32, ... need K shuffles, K lane-0 selects and K ballots
//     a row, and ran markedly slower on this card: one warp cannot hide that
//     many dependent latencies. Splitting the columns over several warps
//     along a wavefront, with boundary values handed over in shared memory,
//     was slower again: the hand-over and progress checks cost more than the
//     columns they took off the warp.)
//   * The decisions are packed in the lane, one shared-memory store a row.
//     One warp issues the compare, select and max of a column at half rate,
//     so a column's decision is the sign bit of v - s (set exactly when
//     v < s: for finite floats without flush to zero the difference is 0
//     only when they are equal, and rounding keeps its sign; a NaN from
//     inf - inf is the card's positive canonical NaN, as `<` is false), an
//     add at full rate, and one funnel shift moves it into the lane's K-bit
//     field.
//   * The scores are prefetched deep. A ring of kStages stages of R rows
//     each (R = min(16, 24 KB / row bytes)) is filled by TMA bulk copies
//     (cp.async.bulk) that complete on one mbarrier a stage; lane 0 of the
//     DP warp refills a stage as soon as the warp has read it, so three
//     stages (48 rows at T_x <= 384) are in flight while the DP reads the
//     fourth: several microseconds of rows, more than an HBM round trip
//     (tools/probe_mas_fused.py measures the cycles a row). A chunk of rows
//     is contiguous in memory; the
//     copy takes its 16-byte aligned superset (at most 12 bytes more at each
//     end, inside 16-byte granules the tensor touches) and the reader skips
//     the head. Lanes past T_x read whatever follows in shared memory (each
//     stage has room for it): those columns never feed a column to their
//     left, and the walk never reads them. The next row's scores are loaded
//     into registers one row ahead.
//   * The decisions never leave shared memory: [t_y, 32] fields of 1, 2 or
//     4 bytes (12.8 KB at 400 x 191, 51.2 KB at 800 x 384, 96 KB at
//     1500 x 384).
//   * The walk runs in the same launch, 32 rows a round: lane r gathers row
//     y0-r's fields around the current column into a 32-column window; the
//     walk's other conditions (step where the column equals the row, never
//     step at column 0) are folded into the window's bits; then every lane
//     steps through the 32 windows it gets by shuffle (shift, and,
//     subtract: three dependent operations a row, no memory access on the
//     chain). Lane r keeps row y0-r's column and writes its 1.0f after the
//     round.
//   * The path write overlaps the DP: warps 1-2 zero-fill the item's
//     [T_y, T_x] path with 16-byte stores while warp 0 runs the DP; after one
//     block barrier the walk writes t_y ones.
//   * The lengths are counted in the kernel from mask[b, :, 0] and
//     mask[b, 0, :] (its nonzero entries, so never beyond the tensor's
//     extent), eight loads in flight a thread, while the first stages'
//     copies are in flight.
// What sets the time now: the DP's row step, one warp issuing a load, an
// add, a max, an add and a funnel shift a column plus a shuffle, a select
// and a store a row, at well under one instruction a cycle; then the walk.
// Neither is bytes.
// One item per block: the batch (16-64) is below the card's 132 SMs, so each
// chain gets an SM and its issue slots to itself; several items a block
// would leave SMs idle and share one SM among several chains, lengthening
// the critical path.

constexpr unsigned kFull = 0xffffffffu;
constexpr int kFusedThreads = 96;  // warp 0: DP and walk; warps 1-2: zero-fill
constexpr int kStages = 4;
constexpr int kStageBudget = 24 * 1024;  // bytes of scores a stage holds
constexpr int kMaxRowsPerStage = 16;
constexpr int kHeader = 64;  // kStages mbarriers, then 2 counts a warp
constexpr int kMaxFusedCols = 1024;
constexpr size_t kMaxSharedOptIn = 232448;  // 227 KB, the most a block takes

__host__ __device__ inline int fused_rows_per_stage(int T_x) {
  const int r = kStageBudget / (T_x * 4);
  return r < 1 ? 1 : (r > kMaxRowsPerStage ? kMaxRowsPerStage : r);
}

// R rows of scores and a spare row that the DP's one-row-ahead load may read
// after the last, each rounded up to 16 bytes (stages start 16-byte
// aligned, as the bulk copies need), 32 bytes for the aligned superset and
// 256 for the lanes past T_x (32 K - T_x < 64 columns)
__host__ __device__ inline size_t align16(size_t n) { return (n + 15) & ~(size_t)15; }
__host__ __device__ inline size_t fused_stage_bytes(int T_x) {
  return align16((size_t)fused_rows_per_stage(T_x) * T_x * 4) +
         align16((size_t)T_x * 4) + 32 + 256;
}

// a lane's decisions of one row, K bits
template <int K>
using Field = typename std::conditional<
    (K <= 8), uint8_t,
    typename std::conditional<(K <= 16), uint16_t, uint32_t>::type>::type;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// Chunk c of item b's scores: rows [c*R, min((c+1)*R, rows)). One thread
// copies its 16-byte aligned superset into stage c % kStages; the copy
// completes on that stage's mbarrier.
__device__ __forceinline__ void load_chunk(const float* negb, int c, int R,
                                           int rows, int T_x,
                                           unsigned char* ring,
                                           size_t stage_bytes,
                                           uint64_t* bars) {
  const int y0 = c * R;
  const int n = min(R, rows - y0);
  const uintptr_t a = (uintptr_t)(negb + (size_t)y0 * T_x);
  const uintptr_t e = (uintptr_t)(negb + (size_t)(y0 + n) * T_x);
  const uintptr_t lo = a & ~(uintptr_t)15;
  const unsigned bytes = (unsigned)(((e + 15) & ~(uintptr_t)15) - lo);
  const int s = c % kStages;
  uint64_t* bar = bars + s;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_u32(ring + s * stage_bytes)),
      "l"(lo), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// One row of the DP on one warp: lane l holds K consecutive columns, v the
// previous row's values there on entry and this row's on return, n this
// row's scores; left0 is the previous row's value left of lane 0's first
// column. Returns the row's decisions, bit k for the lane's column k: set
// exactly where value[y-1, x] < value[y-1, x-1].
template <int K>
__device__ __forceinline__ unsigned dp_row(float (&v)[K], const float (&n)[K],
                                           float left0, int lane) {
  float left = __shfl_up_sync(kFull, v[K - 1], 1);
  if (lane == 0) left = left0;
  float diff[K];
  // last column first: it is what the next row's shuffle sends
#pragma unroll
  for (int k = K - 1; k >= 0; --k) {
    const float s = k > 0 ? v[k > 0 ? k - 1 : 0] : left;
    diff[k] = v[k] - s;  // sign bit set exactly when v[k] < s
    v[k] = n[k] + fmaxf(v[k], s);
  }
  unsigned f = 0;  // bit k: column k's decision
#pragma unroll
  for (int k = K - 1; k >= 0; --k)
    f = __funnelshift_l(__float_as_uint(diff[k]), f, 1);
  return f;
}

// Zero-fills cells floats from p, thread t of nt, 16-byte stores where
// aligned.
__device__ __forceinline__ void zero_fill(float* p, size_t cells, int t, int nt) {
  const size_t lead = ((16 - ((uintptr_t)p & 15)) & 15) / 4;
  const size_t head = lead < cells ? lead : cells;
  for (size_t i = t; i < head; i += nt) p[i] = 0.0f;
  float4* body = reinterpret_cast<float4*>(p + head);
  const size_t n4 = (cells - head) / 4;
  for (size_t i = t; i < n4; i += nt) body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (size_t i = head + 4 * n4 + t; i < cells; i += nt) p[i] = 0.0f;
}

// One round of the walk over rows y0 .. y0-31. Lane r holds row yy = y0-r's
// window of decisions, bit c for column lo + c; rel is the column at row y0,
// relative to lo. Folds the walk's other conditions into the window (step
// where the column equals the row, never step below column 0), steps through
// the 32 windows it gets by shuffle (shift, and, subtract a row) and returns
// this lane's row's column, relative to lo; rel leaves as row y0-32's.
__device__ __forceinline__ int walk_round(unsigned win, int yy, int lo, int& rel,
                                          int lane) {
  const int diag = yy - lo;  // step where the column equals the row
  if (diag >= 0 && diag < 32) win |= 1u << diag;
  if (lo == 0) win &= ~1u;  // never step below column 0
  int mine = 0;
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const unsigned bits = __shfl_sync(kFull, win, r);
    if (lane == r) mine = rel;
    rel -= (bits >> rel) & 1u;
  }
  return mine;
}

// first score of chunk c inside its stage
__device__ __forceinline__ const float* chunk_rows(const float* negb, int c,
                                                   int R, int T_x,
                                                   const unsigned char* ring,
                                                   size_t stage_bytes) {
  const uintptr_t a = (uintptr_t)(negb + (size_t)c * R * T_x);
  return reinterpret_cast<const float*>(ring + (c % kStages) * stage_bytes) +
         ((a & 15) >> 2);
}

template <int K>
__global__ void __launch_bounds__(kFusedThreads, 1)
    mas_fused_kernel(const float* __restrict__ neg,
                     const float* __restrict__ mask, float* __restrict__ path,
                     int T_y, int T_x) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  int* counts = reinterpret_cast<int*>(smem + kStages * sizeof(uint64_t));
  unsigned char* ring = smem + kHeader;
  const size_t stage_bytes = fused_stage_bytes(T_x);
  Field<K>* fields = reinterpret_cast<Field<K>*>(ring + kStages * stage_bytes);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const size_t cells = (size_t)T_y * T_x;
  const float* negb = neg + blockIdx.x * cells;
  const float* maskb = mask + blockIdx.x * cells;
  float* pathb = path + blockIdx.x * cells;
  const int R = fused_rows_per_stage(T_x);
  const int early = min(kStages, (T_y + R - 1) / R);

  // the first stages' copies go out before the lengths are known; they
  // take rows up to T_y, which t_y never exceeds
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) mbar_init(bars + s, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    for (int c = 0; c < early; ++c)
      load_chunk(negb, c, R, T_y, T_x, ring, stage_bytes, bars);
  }
  // eight loads in flight a thread, not one
  int cy = 0, cx = 0;
  for (int y = tid; y < T_y; y += 8 * kFusedThreads) {
    float m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int yj = y + j * kFusedThreads;
      m[j] = yj < T_y ? maskb[(size_t)yj * T_x] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cy += m[j] != 0.0f;
  }
  for (int x = tid; x < T_x; x += kFusedThreads) cx += maskb[x] != 0.0f;
  cy = __reduce_add_sync(kFull, cy);
  cx = __reduce_add_sync(kFull, cx);
  if (lane == 0) {
    counts[2 * warp] = cy;
    counts[2 * warp + 1] = cx;
  }
  __syncthreads();
  int ty = 0, tx = 0;
  for (int w = 0; w < kFusedThreads / 32; ++w) {
    ty += counts[2 * w];
    tx += counts[2 * w + 1];
  }
  const bool walk = ty > 0 && tx > 0;

  if (warp == 0) {
    // ---- forward DP over rows 0 .. ty-1, warp-resident ----
    int consumed = 0, issued = early;
    if (walk) {
      const int nchunks = (ty + R - 1) / R;
      const int x0 = lane * K;  // this lane's first column
      float v[K];  // row y-1's values at columns x0 .. x0+K-1
      int y = 0;
      for (int c = 0; c < nchunks; ++c) {
        mbar_wait(bars + c % kStages, (c / kStages) & 1);
        const float* rowp = chunk_rows(negb, c, R, T_x, ring, stage_bytes);
        rowp += (size_t)(y - c * R) * T_x + x0;
        const int y_end = min(ty, (c + 1) * R);
        float n[K];  // this row's scores; the next row's load in flight
#pragma unroll
        for (int k = 0; k < K; ++k) n[k] = rowp[k];
        if (c == 0) {  // row 0: only (0, 0) is reachable; no decisions
#pragma unroll
          for (int k = 0; k < K; ++k) v[k] = n[k] + (x0 + k == 0 ? 0.0f : kBigNeg);
          y = 1;
          rowp += T_x;
#pragma unroll
          for (int k = 0; k < K; ++k) n[k] = rowp[k];
        }
#pragma unroll 1
        for (; y < y_end; ++y) {
          // the next row, or the stage's spare row after its last one
          rowp += T_x;
          float next[K];
#pragma unroll
          for (int k = 0; k < K; ++k) next[k] = rowp[k];
          const unsigned f = dp_row<K>(v, n, kBigNeg, lane);
          fields[(size_t)y * 32 + lane] = (Field<K>)f;
#pragma unroll
          for (int k = 0; k < K; ++k) n[k] = next[k];
        }
        // the warp has read stage c: refill it with chunk c + kStages
        __syncwarp();
        if (c + kStages < nchunks) {
          if (lane == 0) {
            asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
            load_chunk(negb, c + kStages, R, ty, T_x, ring, stage_bytes, bars);
          }
          issued = c + kStages + 1;
        }
      }
      consumed = nchunks;
    }
    // no copy may still be landing in shared memory when the block exits
    for (int c = consumed; c < issued; ++c)
      mbar_wait(bars + c % kStages, (c / kStages) & 1);
  } else {
    zero_fill(pathb, cells, tid - 32, kFusedThreads - 32);
  }
  __syncthreads();  // zeros written before the walk's ones
  if (warp != 0 || !walk) return;

  // ---- walk from (ty-1, tx-1) down to row 0, 32 rows a round ----
  int idx = tx - 1;
  for (int y0 = ty - 1; y0 >= 0; y0 -= 32) {
    const int lo = max(idx - 31, 0);  // the round's columns: lo .. lo+31
    const int yy = y0 - lane;         // this lane's row
    unsigned win = 0;
    if (yy >= 1) {
      // column c is bit c % K of lane c / K's field
      const Field<K>* row = fields + (size_t)yy * 32;
      const int l0 = lo / K, off = lo - l0 * K;
#pragma unroll
      for (int i = 0; i <= (K + 30) / K; ++i) {
        const unsigned fld = l0 + i < 32 ? row[l0 + i] : 0u;
        const int at = i * K - off;  // window bit of the field's bit 0
        win |= at >= 0 ? (at < 32 ? fld << at : 0u) : fld >> -at;
      }
    }
    int rel = idx - lo;
    const int mine = walk_round(win, yy, lo, rel, lane);
    if (yy >= 0) pathb[(size_t)yy * T_x + lo + mine] = 1.0f;
    idx = lo + rel;
  }
}

int fused_field_bytes(int k) { return k <= 8 ? 1 : (k <= 16 ? 2 : 4); }

// columns a lane holds: the smallest odd K with 32 K >= T_x (odd, so a row's
// loads hit 32 banks), or 32; -1 if T_x is out of [1, 1024]
int fused_k(int T_x) {
  if (T_x < 1 || T_x > kMaxFusedCols) return -1;
  const int need = (T_x + 31) / 32;
  return need == 32 ? 32 : need | 1;
}

template <int K>
int launch_fused(const float* neg, const float* mask, float* path, int B,
                 int T_y, int T_x, size_t smem, cudaStream_t stream) {
  static bool opted_in = false;  // above 48 KB only after this, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        mas_fused_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)kMaxSharedOptIn);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  mas_fused_kernel<K><<<B, kFusedThreads, smem, stream>>>(neg, mask, path, T_y,
                                                          T_x);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// mas_wide_kernel: maximum_path in one launch at any [T_y, T_x].
//
// Replaces _forward_kernel (vits_tpu/ops/mas_pallas.py:36) and
// _backtrack_kernel (mas_pallas.py:57) together, as mas_fused_kernel does,
// for the shapes that kernel cannot take: T_x > 1024, or more decision rows
// than a block's 227 KB of shared memory holds (ops/mas_cuda.py::route
// chooses by shape before the launch). The arithmetic is the plain
// version's: `neg + fmaxf(prev, shifted)`, the -1e9 sentinels, and as the
// decision the plain version's own predicate `prev < shifted` (a ballot
// takes a predicate, so the sign bit of their difference, which equals it
// on every finite value, is not needed). The path is maximum_path_torch's
// bit for bit.
//
// Bound on this card: the bytes of the function, as mas_fused's: read the
// scores inside each item's t_y x t_x rectangle and the mask's first column
// and row, write the whole f32 path. At B=16, T_y=1500, T_x=1024 with full
// lengths that is 196.8 MB, 58.7 us at 3.35 TB/s; the arithmetic (an add, a
// max and a compare a cell) is negligible. The chain floor: row y of the DP
// needs all of row y-1, so an item takes t_y dependent row steps (a
// shuffle, a select, a max and an add: ~80 cycles on this card, the shuffle
// most of it), and the walk t_y / 32 rounds of 32 dependent steps of three
// operations; then the wavefront's fill, about a group and a handover a warp
// boundary. At 1500 x 1024 the chain is ~0.1 ms, above the bytes: the
// kernel is chain-bound (tools/probe_mas_wide.py times each part). The
// design:
//   * Narrow lanes, no transpose. Lane l of a warp holds K = 2 columns
//     x0 + 32 c + l (c < K), whatever T_x. A row's scores are read
//     coalesced straight into place; a column's left neighbour is one
//     __shfl_sync away (lane 0 takes lane 31's value of c - 1, or for c = 0
//     the warp to its left); and one __ballot_sync of the decision
//     predicates a c is the decision word itself, bit x % 32 of word x / 32,
//     which lane 0 stores (the rows of the [B, T_y, words] uint32 scratch are
//     padded to an even number of words, so a warp's K words go out as one
//     8-byte store). The first design's 32 consecutive columns a lane needed
//     a 32 x 33 shared-memory tile a row to reach that layout and 32 columns
//     of work a lane a row; this layout needs no tile, and a row's step is
//     ~14 instructions a warp. (K = 4 and K = 1, tools/probe_mas_wide.py's
//     k4 and k1, ran 6-7% slower at 1500 x 1024: more work a row against
//     more warps to hand over between.)
//   * A wavefront of warps, no barrier a row. A warp needs only the last
//     column of the warp to its left, one row up. Lane 31 of that warp hands
//     it over G = 16 rows at a time with two st.async stores (st.async
//     .shared::cluster.mbarrier::complete_tx) into a ring of D = 4 slots in
//     the receiver's shared memory; the receiver arms the slot's full
//     mbarrier for their 64 bytes, waits, reads them and arrives on the
//     sender's empty mbarrier; the sender waits on empty before it stores.
//     Each warp waits only on its left neighbour, a group behind it, so a
//     handover's latency is paid once a warp boundary over the whole run,
//     not once a row. Every arrival is CTA-scoped or completes bytes, as in
//     CUTLASS's cluster pipelines: with cluster-scoped release and acquire a
//     group cost ~2.5 us more (the release drains the warp's stores of
//     decision words to L2), and the kernel 0.58 ms. G = 8 ran 21% slower:
//     more barrier operations a row (a try_wait that finds its phase
//     complete costs ~100-200 cycles).
//   * An item's columns over a thread-block cluster. The launch is B x C
//     blocks in clusters of C <= 8 (cudaLaunchKernelEx); block c of item b's
//     cluster owns the columns [c BC, (c + 1) BC), BC = W x 32 K for W <= 8
//     DP warps. It copies only those columns' scores, writes only their
//     decision words, zero-fills a C-th of the item's path (a band of whole
//     rows, so the stores are 16 bytes wide), and its last warp hands its
//     last column to warp 0 of block c + 1 through distributed shared memory
//     (mapa for the addresses, st.async for the values, a remote
//     mbarrier.arrive for the credit). The plan (wide_plan below, mirrored
//     by ops/mas_cuda.py::wide_plan) aims at 4 DP warps a block and takes no
//     more blocks an item than the card runs at once (C <= SMs / B), so
//     (16, 1500, 1024) runs 64 blocks on 64 SMs and (64, 1500, 1024) 128
//     blocks of 8 DP warps. Rows wider than C x BC (4096 columns at most)
//     run as stripes one after another, as the first design's did: stripe s's last warp
//     writes its last column, row by row, to a [2, B, T_y] f32 scratch in
//     device memory (the planes in turns), which warp 0 of block 0 reads a
//     group ahead in stripe s + 1, after a cluster barrier; so only device
//     memory bounds the shape.
//   * The scores come through a ring of S stages of R = 16 rows in shared
//     memory, filled by TMA bulk copies (cp.async.bulk, one a row, lane r of
//     the copy warp issuing row r's: the 16-byte aligned superset of the
//     row's columns in the block, so T_x % 4 != 0 is no matter; the reader
//     skips the head) that complete on one mbarrier a stage. The block's
//     last active DP warp, the last to read a stage (every warp to its left
//     is ahead of it), frees it on an empty mbarrier. S x R rows, up to
//     ~130 KB, are in flight. (One lane issuing a stage's 16 copies in turn
//     left the leading warp waiting on its stages for ~30% of its time.)
//   * One warp zero-fills the block's band of the path while the DP runs;
//     two ran 9% slower at 1500 x 1024: their stores took the memory the
//     copies and the decision words need.
//   * The lengths: every block counts t_y and t_x from mask[b, :, 0] and
//     mask[b, 0, :] while thread 0 initialises the mbarriers; one cluster
//     barrier then publishes both, cluster-wide.
//   * The walk is mas_fused's (walk_round), 32 rows a round, on warp 0 of
//     block 0 after a cluster barrier (barrier.cluster.arrive.release /
//     wait.acquire) that orders every block's decisions and zeros before it.
//     Lane r reads row y0-r's window from device memory (L2) a round ahead:
//     the column falls by at most 32 a round, so the three words around a
//     round's first column hold every window the next round can need, and a
//     round no longer starts with a wait on L2.
// Every block of a cluster reaches every cluster barrier whatever its
// columns hold (blocks past an item's t_x, items with t_y or t_x 0), and no
// block touches another's shared memory after the last barrier.

constexpr int kWideLaneCols = 2;     // K: columns a lane
constexpr int kWideGroup = 16;       // rows one handover carries
constexpr int kWideDepth = 4;        // groups a handover ring holds
constexpr int kWideStageRows = 16;   // rows of scores a stage holds
constexpr int kWideMaxStages = 8;
constexpr int kWideRingBudget = 160 * 1024;  // bytes the stages take at most
constexpr int kWideMaxWarps = 8;     // DP warps a block at most
constexpr int kWidePlanWarps = 4;    // DP warps a block the plan aims at
constexpr int kWideMaxCluster = 8;   // the portable cluster size
constexpr int kWideFillWarps = 1;
// warps 0 .. W-1 run the DP, warp W copies the scores, then the fill warps
constexpr int kWideThreads = (kWideMaxWarps + 1 + kWideFillWarps) * 32;
static_assert(kWideStageRows % kWideGroup == 0, "a stage holds whole groups");
static_assert(kWideStageRows <= 32, "a lane of the copy warp copies a row of a stage");
static_assert(((kWideStageRows / kWideGroup) & (kWideStageRows / kWideGroup - 1)) == 0,
              "groups a stage: a power of two");
static_assert(kWideGroup % 4 == 0, "a handover is 16-byte stores");
static_assert((kWideDepth & (kWideDepth - 1)) == 0, "the handover ring: a power of two");

struct WideShared {
  float inbox[kWideMaxWarps][kWideDepth][kWideGroup];  // warp w's handover ring
  uint64_t in_full[kWideMaxWarps][kWideDepth];         // ... and its full barriers
  uint64_t out_empty[kWideMaxWarps][kWideDepth];       // warp w's credits to send
  uint64_t stage_full[kWideMaxStages];
  uint64_t stage_empty[kWideMaxStages];
  int lens[2 * (kWideMaxWarps + 1 + kWideFillWarps)];
};
constexpr int kWideHeader = (sizeof(WideShared) + 1023) / 1024 * 1024;  // then the stages

struct WidePlan {
  int cluster, warps, k, group, stage_rows, stages, depth;
  long long smem;
};

__host__ __device__ inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// a stage's row: a block's columns and the 16 bytes an aligned superset adds
__host__ __device__ inline size_t wide_slot_bytes(int block_cols) {
  return (size_t)block_cols * 4 + 16;
}

// words of a decision row in the scratch: ceil(T_x / 32), padded to 2 (a
// warp's K = 2 words go out as one 8-byte store)
int wide_dec_words(int T_x) { return ((T_x + 31) / 32 + 1) & ~1; }

// mas_wide_kernel's plan at [B, T_y, T_x] (each >= 1) on a card of `sms` SMs.
// K: columns a lane, 2. C: blocks an item, as many as
// hold kWidePlanWarps DP warps each, at most 8 and at most sms / B (so that
// the batch runs in one wave where it can); W: DP warps a block, up to 8, as
// many as the row needs over C blocks; then C again, so that no block is
// wholly past T_x. S: stages within kWideRingBudget, 2 to 8, and no more
// than the rows need.
WidePlan wide_plan(int B, int T_y, int T_x, int sms) {
  WidePlan p;
  p.k = kWideLaneCols;
  const int need = ceil_div(T_x, 32 * p.k);  // warps a row needs
  const int room = std::max(1, std::min(kWideMaxCluster, sms / B));
  const int c = std::min(room, ceil_div(need, kWidePlanWarps));
  p.warps = std::min(kWideMaxWarps, ceil_div(need, c));
  p.cluster = std::min(c, ceil_div(need, p.warps));
  p.group = kWideGroup;
  p.stage_rows = kWideStageRows;
  p.depth = kWideDepth;
  const long long stage = (long long)kWideStageRows * wide_slot_bytes(p.warps * 32 * p.k);
  const long long fit = kWideRingBudget / stage;
  const long long rows = ceil_div(std::max(T_y - 1, 1), kWideStageRows);
  p.stages = (int)std::max(2LL, std::min((long long)kWideMaxStages, std::min(fit, rows)));
  p.smem = kWideHeader + p.stages * stage;
  return p;
}

__device__ __forceinline__ unsigned cluster_rank() {
  unsigned r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ __forceinline__ unsigned cluster_blocks() {
  unsigned n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// p (in this block's shared memory) in block `rank`'s, as an address of the
// cluster's shared window
__device__ __forceinline__ unsigned cluster_addr(const void* p, unsigned rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// every thread of every block of the cluster
__device__ __forceinline__ void cluster_sync() {
  __syncwarp();
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// Waits for the phase of the given parity of one of this block's mbarriers.
// Every arrival on them is CTA-scoped or completes bytes of an asynchronous
// copy or store, as in CUTLASS's cluster pipelines: a cluster-scoped release
// would first drain the warp's stores of decision words to L2, which cost
// ~2.5 us a group on this card. A phase that has not completed after 2^24
// tries (well over a second; the kernel's waits last microseconds) can only
// be a fault of the kernel: the wait traps, so that the launch fails instead
// of hanging the card.
__device__ __forceinline__ void wide_wait(const uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  for (unsigned tries = 0; !done; ++tries) {
    if (tries == (1u << 24)) __trap();
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
  }
}

// arrives on an mbarrier of this block or, by its cluster address, another's
__device__ __forceinline__ void mbar_arrive_cluster(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

// arms this phase of an mbarrier of this block for `bytes` of asynchronous
// stores or copies, as its one arrival
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// 16 bytes into shared memory of a block of the cluster (this one
// included), completing 16 bytes on that block's mbarrier `bar`
__device__ __forceinline__ void st_async(unsigned addr, float a, float b, float c, float d,
                                         unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];" ::"r"(addr),
      "f"(a), "f"(b), "f"(c), "f"(d), "r"(bar)
      : "memory");
}

// the 16-byte aligned superset of row t's columns [x_lo, x_hi): its first
// byte in lo, its length returned
__device__ __forceinline__ unsigned row_span(const float* negb, int t, int T_x, int x_lo,
                                             int x_hi, uintptr_t& lo) {
  const uintptr_t a = (uintptr_t)(negb + (size_t)t * T_x + x_lo);
  const uintptr_t e = (uintptr_t)(negb + (size_t)t * T_x + x_hi);
  lo = a & ~(uintptr_t)15;
  return (unsigned)(((e + 15) & ~(uintptr_t)15) - lo);
}

// One row of the DP on one warp: lane l holds columns x0 + 32 c + l, v the
// previous row's values there on entry and this row's on return, n this
// row's scores; left0 is the previous row's value left of column x0. word[c]
// is the row's decision word of columns x0 + 32 c .. x0 + 32 c + 31, bit l
// set exactly where value[y-1, x] < value[y-1, x-1].
__device__ __forceinline__ void wide_row(float (&v)[kWideLaneCols],
                                         const float (&n)[kWideLaneCols], float left0,
                                         int lane, unsigned (&word)[kWideLaneCols]) {
  constexpr int K = kWideLaneCols;
  float rot[K];  // lane l - 1's values; lane 0 gets lane 31's
#pragma unroll
  for (int c = 0; c < K; ++c) rot[c] = __shfl_sync(kFull, v[c], (lane + 31) & 31);
#pragma unroll
  for (int c = 0; c < K; ++c) {
    const float s = lane == 0 ? (c == 0 ? left0 : rot[c > 0 ? c - 1 : 0]) : rot[c];
    word[c] = __ballot_sync(kFull, v[c] < s);
    v[c] = n[c] + fmaxf(v[c], s);
  }
}

// a warp's K = 2 decision words of a row at p (8-byte aligned: x0 / 32 and
// the row's words are even), one store
__device__ __forceinline__ void store_words(unsigned* p, const unsigned (&w)[kWideLaneCols]) {
  *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
}

// G rows of the DP on one warp (all G, or the first `live` where kAll is
// false): the scores from the stage rows `rows` (a row every `slot` bytes,
// its first column `head` floats into the row, moving by head_step a row;
// this lane's first column lane_col further), the left neighbour's values
// carry (row t0 - 1) and e[0 .. G-2]; each row's words stored by lane 0 at
// drow, a row every dec_words; out[j] this warp's last column at row j.
template <int G, bool kAll>
__device__ __forceinline__ void wide_group(float (&v)[kWideLaneCols], float (&out)[G],
                                           const unsigned char* rows, size_t slot, int head,
                                           int head_step, int lane_col, float carry,
                                           const float (&e)[G], unsigned* drow, int dec_words,
                                           int lane, int live) {
  constexpr int K = kWideLaneCols;
  float n[G][K];
#pragma unroll
  for (int j = 0; j < G; ++j) {
    if (kAll || j < live) {
      const float* row = reinterpret_cast<const float*>(rows + j * slot) +
                         ((head + j * head_step) & 3) + lane_col;
#pragma unroll
      for (int c = 0; c < K; ++c) n[j][c] = row[32 * c];
    }
  }
#pragma unroll
  for (int j = 0; j < G; ++j) {
    out[j] = 0.0f;
    if (kAll || j < live) {
      unsigned word[K];
      wide_row(v, n[j], j == 0 ? carry : e[j > 0 ? j - 1 : 0], lane, word);
      if (lane == 0) store_words(drow + (size_t)j * dec_words, word);
      out[j] = v[K - 1];
    }
  }
}

// the walk's words of decision row `row` from word `base` on: three, 0 past
// the row's words and for rows below 1 (row 0 has no decisions)
__device__ __forceinline__ void walk_words(unsigned (&w)[3], const unsigned* decb,
                                           int dec_words, int row, int base) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
    w[i] = row >= 1 && base + i < dec_words ? __ldcg(decb + (size_t)row * dec_words + base + i)
                                            : 0u;
}

__global__ void __launch_bounds__(kWideThreads, 1)
    mas_wide_kernel(const float* __restrict__ neg, const float* __restrict__ mask,
                    float* __restrict__ path, unsigned* __restrict__ dec,
                    float* __restrict__ edge, int T_y, int T_x, int W, int S,
                    int dec_words) {
  constexpr int G = kWideGroup, R = kWideStageRows, D = kWideDepth, K = kWideLaneCols;
  extern __shared__ __align__(16) unsigned char smem[];
  WideShared& sh = *reinterpret_cast<WideShared*>(smem);
  unsigned char* ring = smem + kWideHeader;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, nt = blockDim.x;
  const int C = (int)cluster_blocks(), rank = (int)cluster_rank();
  const int b = blockIdx.x / C;
  const size_t cells = (size_t)T_y * T_x;
  const float* negb = neg + b * cells;
  const float* maskb = mask + b * cells;
  float* pathb = path + b * cells;
  unsigned* decb = dec + (size_t)b * T_y * dec_words;
  const size_t plane = (size_t)(gridDim.x / C) * T_y;
  float* edgeb = edge + (size_t)b * T_y;

  if (tid == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&sh.stage_full[s], 1);
      mbar_init(&sh.stage_empty[s], 1);
    }
    for (int w = 0; w < W; ++w)
      for (int d = 0; d < D; ++d) {
        mbar_init(&sh.in_full[w][d], 1);
        mbar_init(&sh.out_empty[w][d], 1);
      }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // the lengths: the nonzero entries of mask[b, :, 0] and mask[b, 0, :],
  // eight loads in flight a thread
  int cy = 0, cx = 0;
  for (int y = tid; y < T_y; y += 8 * nt) {
    float m[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int yj = y + j * nt;
      m[j] = yj < T_y ? maskb[(size_t)yj * T_x] : 0.0f;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) cy += m[j] != 0.0f;
  }
  for (int x = tid; x < T_x; x += nt) cx += maskb[x] != 0.0f;
  cy = __reduce_add_sync(kFull, cy);
  cx = __reduce_add_sync(kFull, cx);
  if (lane == 0) {
    sh.lens[2 * warp] = cy;
    sh.lens[2 * warp + 1] = cx;
  }
  cluster_sync();  // the mbarriers initialised cluster-wide, the counts published
  int ty = 0, tx = 0;
  for (int w = 0; w < nt / 32; ++w) {
    ty += sh.lens[2 * w];
    tx += sh.lens[2 * w + 1];
  }

  const int warp_cols = 32 * K, block_cols = W * warp_cols, stripe_cols = C * block_cols;
  const size_t slot = wide_slot_bytes(block_cols);
  const int stripes = ty > 0 && tx > 0 ? ceil_div(tx, stripe_cols) : 0;
  const int steps = ty - 1;  // row steps 1 .. ty-1
  const int groups = stripes ? ceil_div(steps, G) : 0;
  const int chunks = stripes ? ceil_div(steps, R) : 0;

  if (warp > W) {  // a C-th of the item's path, contiguous
    const size_t part = ((cells + C - 1) / C + 3) & ~(size_t)3;
    const size_t start = rank * part;
    if (start < cells)
      zero_fill(pathb + start, part < cells - start ? part : cells - start,
                tid - (W + 1) * 32, nt - (W + 1) * 32);
  }

  int chunk_base = 0;          // chunks of the block's earlier stripes
  int received = 0, sent = 0;  // groups through this warp's ring, and to its right
  for (int s = 0; s < stripes; ++s) {
    const int xb = s * stripe_cols + rank * block_cols;  // the block's first column
    const int active = xb < tx ? min(W, ceil_div(tx - xb, warp_cols)) : 0;
    if (warp == W) {
      // ---- the copies: chunk k holds rows k R + 1 .. k R + R, lane r row k R + 1 + r ----
      if (active) {
        const int x_hi = min(xb + block_cols, tx);
        for (int k = 0; k < chunks; ++k) {
          const int q = chunk_base + k, stage = q % S;
          wide_wait(&sh.stage_empty[stage], ((q / S) & 1) ^ 1);
          const int t = k * R + 1 + lane;
          uintptr_t src = 0;
          const unsigned bytes =
              lane < R && t < ty ? row_span(negb, t, T_x, xb, x_hi, src) : 0u;
          const unsigned total = __reduce_add_sync(kFull, bytes);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          if (lane == 0) mbar_expect(&sh.stage_full[stage], total);
          __syncwarp();
          if (bytes) {
            unsigned char* dst = ring + (size_t)(stage * R + lane) * slot;
            asm volatile(
                "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
                "[%0], [%1], %2, [%3];" ::"r"(smem_u32(dst)),
                "l"(src), "r"(bytes), "r"(smem_u32(&sh.stage_full[stage]))
                : "memory");
          }
        }
      }
    } else if (warp < active) {
      // ---- the DP of this warp's columns x0 + 32 c + lane, row by row ----
      const int x0 = xb + warp * warp_cols;
      // the left neighbour: the warp before (maybe in block rank - 1), the
      // edge column of stripe s - 1, or none (column 0)
      const bool left_ring = warp > 0 || rank > 0;
      const bool left_edge = !left_ring && s > 0;
      // the right neighbour: the next active warp (maybe in block rank + 1),
      // or the edge column for stripe s + 1
      const bool right_ring =
          warp + 1 < active || (warp + 1 == W && rank + 1 < C && xb + block_cols < tx);
      const bool right_edge = warp + 1 == W && rank + 1 == C && s + 1 < stripes;
      const bool last = warp + 1 == active;  // frees each stage after reading it
      const unsigned credit =
          left_ring ? cluster_addr(&sh.out_empty[warp > 0 ? warp - 1 : W - 1][0],
                                   warp > 0 ? rank : rank - 1)
                    : 0u;
      const unsigned to_inbox =
          right_ring ? cluster_addr(&sh.inbox[warp + 1 < W ? warp + 1 : 0][0][0],
                                    warp + 1 < W ? rank : rank + 1)
                     : 0u;
      const unsigned to_full =
          right_ring ? cluster_addr(&sh.in_full[warp + 1 < W ? warp + 1 : 0][0],
                                    warp + 1 < W ? rank : rank + 1)
                     : 0u;
      const float* edge_in = edgeb + ((s + 1) & 1) * plane;  // stripe s - 1's
      float* edge_out = edgeb + (s & 1) * plane;

      // row 0: only (0, 0) is reachable; no decisions
      float v[K];
#pragma unroll
      for (int c = 0; c < K; ++c) {
        const int x = x0 + 32 * c + lane;
        v[c] = (x < T_x ? negb[x] : 0.0f) + (x == 0 ? 0.0f : kBigNeg);
      }
      // the left neighbour's row-0 value (its column x0 - 1 is never 0)
      float carry = x0 > 0 ? negb[x0 - 1] + kBigNeg : kBigNeg;
      float e_next[G];  // the edge column a group ahead
      if (left_edge) {
#pragma unroll
        for (int j = 0; j < G; ++j) e_next[j] = 1 + j < ty ? __ldcg(edge_in + 1 + j) : 0.0f;
      }
      // the stage ring's position, the offset of row 1's first column of the
      // block in its 16-byte granule (floats; a row moves it by T_x % 4), and
      // row 1's decision words
      int stage = chunk_base % S;
      unsigned lap = (unsigned)(chunk_base / S) & 1u;
      int head = (int)(((uintptr_t)(negb + (size_t)T_x + xb) & 15) >> 2);
      const int head_step = T_x & 3;
      unsigned* drow = decb + (size_t)dec_words + (x0 >> 5);
      for (int g = 0; g < groups; ++g) {
        const int gi = g & (R / G - 1);  // the group's place in its stage
        if (gi == 0) {
          if (g > 0 && ++stage == S) {
            stage = 0;
            lap ^= 1u;
          }
          wide_wait(&sh.stage_full[stage], lap);
        }
        const unsigned char* rows = ring + (size_t)(stage * R + gi * G) * slot;
        const int t0 = g * G + 1, live = ty - t0;  // rows t0 .. t0 + min(G, live) - 1
        // e[j]: the left neighbour's value at row t0 + j, so row t0 + j + 1's left
        float e[G];
        if (left_ring) {
          const int d = received & (D - 1);
          if (lane == 0) mbar_expect(&sh.in_full[warp][d], G * 4);
          wide_wait(&sh.in_full[warp][d], (received / D) & 1);
          const float4* in = reinterpret_cast<const float4*>(sh.inbox[warp][d]);
#pragma unroll
          for (int i = 0; i < G / 4; ++i) {
            const float4 q4 = in[i];
            e[4 * i] = q4.x;
            e[4 * i + 1] = q4.y;
            e[4 * i + 2] = q4.z;
            e[4 * i + 3] = q4.w;
          }
          __syncwarp();
          if (lane == 0) mbar_arrive_cluster(credit + d * 8);
          ++received;
        } else if (left_edge) {
#pragma unroll
          for (int j = 0; j < G; ++j) e[j] = e_next[j];
          if (g + 1 < groups) {
#pragma unroll
            for (int j = 0; j < G; ++j) {
              const int t = t0 + G + j;
              e_next[j] = t < ty ? __ldcg(edge_in + t) : 0.0f;
            }
          }
        } else {
#pragma unroll
          for (int j = 0; j < G; ++j) e[j] = kBigNeg;
        }
        float out[G];  // this warp's last column at rows t0 .. t0 + G - 1
        if (live >= G)
          wide_group<G, true>(v, out, rows, slot, head, head_step, x0 - xb + lane, carry, e,
                              drow, dec_words, lane, G);
        else
          wide_group<G, false>(v, out, rows, slot, head, head_step, x0 - xb + lane, carry, e,
                               drow, dec_words, lane, live);
        head = (head + G * head_step) & 3;
        drow += (size_t)G * dec_words;
        carry = e[G - 1];
        if (right_ring) {
          const int d = sent & (D - 1);
          wide_wait(&sh.out_empty[warp][d], ((sent / D) & 1) ^ 1);
          if (lane == 31) {
#pragma unroll
            for (int i = 0; i < G / 4; ++i)
              st_async(to_inbox + (d * G + 4 * i) * 4, out[4 * i], out[4 * i + 1],
                       out[4 * i + 2], out[4 * i + 3], to_full + d * 8);
          }
          ++sent;
        } else if (right_edge && lane == 31) {
#pragma unroll
          for (int j = 0; j < G; ++j)
            if (j < live) edge_out[t0 + j] = out[j];
        }
        if (last && (gi == R / G - 1 || g + 1 == groups)) {
          __syncwarp();
          if (lane == 0) mbar_arrive(&sh.stage_empty[stage]);
        }
      }
    }
    if (active) chunk_base += chunks;
    if (s + 1 < stripes) cluster_sync();  // stripe s's edge column written
  }
  cluster_sync();  // every block's decisions and zeros written before the walk
  if (rank != 0 || warp != 0 || stripes == 0) return;

  // ---- the walk from (ty-1, tx-1) down to row 0, 32 rows a round ----
  int col = tx - 1;
  int base = max(col - 31, 0) >> 5;  // the first word this round's rows were read from
  unsigned w3[3];
  walk_words(w3, decb, dec_words, ty - 1 - lane, base);
  for (int y0 = ty - 1; y0 >= 0; y0 -= 32) {
    const int lo = max(col - 31, 0);  // the round's columns: lo .. lo+31
    const int yy = y0 - lane;         // this lane's row
    const bool up = (lo >> 5) > base;  // the window starts in the second word
    const unsigned a = up ? w3[1] : w3[0], hi = up ? w3[2] : w3[1];
    const int off = lo & 31;
    const unsigned win = off ? (a >> off) | (hi << (32 - off)) : a;
    // the next round starts at a column in col - 32 .. col: its windows lie
    // in the three words from (col - 63) / 32 on
    base = max(col - 63, 0) >> 5;
    walk_words(w3, decb, dec_words, yy - 32, base);
    int rel = col - lo;
    const int mine = walk_round(win, yy, lo, rel, lane);
    if (yy >= 0) pathb[(size_t)yy * T_x + lo + mine] = 1.0f;
    col = lo + rel;
  }
}

// sets the launch's shared-memory ceiling once for the kernel
int wide_opt_in() {
  static bool opted_in = false;  // above 48 KB only after this, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        mas_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMaxSharedOptIn);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  return 0;
}

cudaLaunchConfig_t wide_config(const WidePlan& p, int B, cudaStream_t stream,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(B * p.cluster);
  cfg.blockDim = dim3((p.warps + 1 + kWideFillWarps) * 32);
  cfg.dynamicSmemBytes = (size_t)p.smem;
  cfg.stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

int launch_wide(const float* neg, const float* mask, float* path, unsigned* dec, float* edge,
                int B, int T_y, int T_x, const WidePlan& p, cudaStream_t stream) {
  const int opt = wide_opt_in();
  if (opt) return opt;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wide_config(p, B, stream, attr);
  const cudaError_t err = cudaLaunchKernelEx(&cfg, mas_wide_kernel, neg, mask, path, dec,
                                             edge, T_y, T_x, p.warps, p.stages,
                                             wide_dec_words(T_x));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

int wide_active_clusters(const WidePlan& p, int B) {
  const int opt = wide_opt_in();
  if (opt) return -opt;
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = wide_config(p, B, 0, attr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, mas_wide_kernel, &cfg);
  return err != cudaSuccess ? -(int)err : n;
}

int device_sms(int& sms) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (int)err;
}

}  // namespace

extern "C" {

// Dynamic shared memory mas_fused takes at [T_y, T_x], or -1 if T_x is out
// of [1, 1024]. ops/mas_cuda.py::fused_plan repeats it.
long long mas_fused_smem_bytes(int T_y, int T_x) {
  const int k = fused_k(T_x);
  if (k < 0 || T_y < 0) return -1;
  return kHeader + (long long)kStages * fused_stage_bytes(T_x) +
         (long long)T_y * 32 * fused_field_bytes(k);
}

// neg, mask: [B, T_y, T_x] f32, the mask the 0/1 rectangle of each item's
// lengths; neg 16-byte aligned. path: [B, T_y, T_x] f32, written in full.
int mas_fused(const float* neg, const float* mask, float* path, int B, int T_y,
              int T_x, cudaStream_t stream) {
  const long long smem = mas_fused_smem_bytes(T_y, T_x);
  if (smem < 0 || smem > (long long)kMaxSharedOptIn)
    return (int)cudaErrorInvalidValue;
  const size_t s = (size_t)smem;
  switch (fused_k(T_x)) {
    case 1: return launch_fused<1>(neg, mask, path, B, T_y, T_x, s, stream);
    case 3: return launch_fused<3>(neg, mask, path, B, T_y, T_x, s, stream);
    case 5: return launch_fused<5>(neg, mask, path, B, T_y, T_x, s, stream);
    case 7: return launch_fused<7>(neg, mask, path, B, T_y, T_x, s, stream);
    case 9: return launch_fused<9>(neg, mask, path, B, T_y, T_x, s, stream);
    case 11: return launch_fused<11>(neg, mask, path, B, T_y, T_x, s, stream);
    case 13: return launch_fused<13>(neg, mask, path, B, T_y, T_x, s, stream);
    case 15: return launch_fused<15>(neg, mask, path, B, T_y, T_x, s, stream);
    case 17: return launch_fused<17>(neg, mask, path, B, T_y, T_x, s, stream);
    case 19: return launch_fused<19>(neg, mask, path, B, T_y, T_x, s, stream);
    case 21: return launch_fused<21>(neg, mask, path, B, T_y, T_x, s, stream);
    case 23: return launch_fused<23>(neg, mask, path, B, T_y, T_x, s, stream);
    case 25: return launch_fused<25>(neg, mask, path, B, T_y, T_x, s, stream);
    case 27: return launch_fused<27>(neg, mask, path, B, T_y, T_x, s, stream);
    case 29: return launch_fused<29>(neg, mask, path, B, T_y, T_x, s, stream);
    case 31: return launch_fused<31>(neg, mask, path, B, T_y, T_x, s, stream);
    case 32: return launch_fused<32>(neg, mask, path, B, T_y, T_x, s, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// mas_wide_kernel's plan at [B, T_y, T_x] on a card of `sms` SMs, as
// ops/mas_cuda.py::wide_plan computes it: out[0..7] = cluster size, DP warps
// a block, K, group rows, stage rows, stages, handover depth, shared-memory
// bytes. Returns -1 if an argument is below 1.
int mas_wide_plan(int B, int T_y, int T_x, int sms, long long* out) {
  if (B < 1 || T_y < 1 || T_x < 1 || sms < 1) return -1;
  const WidePlan p = wide_plan(B, T_y, T_x, sms);
  const long long fields[8] = {p.cluster, p.warps, p.k, p.group,
                               p.stage_rows, p.stages, p.depth, p.smem};
  for (int i = 0; i < 8; ++i) out[i] = fields[i];
  return 0;
}

// Clusters of mas_wide_kernel's plan at [B, T_y, T_x] that the current card
// holds at once (cudaOccupancyMaxActiveClusters), or minus a cudaError.
int mas_wide_active_clusters(int B, int T_y, int T_x) {
  if (B < 1 || T_y < 1 || T_x < 1) return -(int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = device_sms(sms);
  if (err) return -err;
  const WidePlan p = wide_plan(B, T_y, T_x, sms);
  return wide_active_clusters(p, B);
}

// neg, mask: [B, T_y, T_x] f32, the mask the 0/1 rectangle of each item's
// lengths. path: [B, T_y, T_x] f32, written in full. dec: [B, T_y,
// wide_dec_words(T_x)] uint32 scratch; edge: [2, B, T_y] f32 scratch, read
// and written only where T_x is wider than a cluster's columns. B, T_y,
// T_x >= 1. Launches B clusters of the plan's size on the current device.
int mas_wide(const float* neg, const float* mask, float* path, unsigned* dec,
             float* edge, int B, int T_y, int T_x, cudaStream_t stream) {
  if (B < 1 || T_y < 1 || T_x < 1) return (int)cudaErrorInvalidValue;
  int sms = 0;
  const int err = device_sms(sms);
  if (err) return err;
  const WidePlan p = wide_plan(B, T_y, T_x, sms);
  if (p.smem > (long long)kMaxSharedOptIn) return (int)cudaErrorInvalidValue;
  return launch_wide(neg, mask, path, dec, edge, B, T_y, T_x, p, stream);
}

}  // extern "C"
