// Monotonic Alignment Search (MAS) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of vits_tpu/ops/mas_pallas.py,
// _forward_kernel (mas_pallas.py:36), the forward DP over frames that emits
// one decision row per frame, and _backtrack_kernel (mas_pallas.py:57), the
// reverse walk from (t_y-1, t_x-1) that writes the path. Two designs:
//   mas_fused_kernel     both in one launch, warp-resident DP, decisions
//                        bit-packed in shared memory; the main path's kernel
//                        (its own note is at its definition below)
//   mas_forward_kernel + mas_backtrack_kernel
//                        the first port, one kernel per Pallas kernel, with
//                        the decisions in device memory between them; kept
//                        as the yardstick of the fused kernel, off the main
//                        path
//
// Semantics are those of vits_tpu/ops/mas.py::maximum_path_scan and of the
// plain PyTorch version in vits_torch/ops/mas.py, bit for bit: the same f32
// sentinel (-1e9), the same `neg + fmaxf(prev, shifted)` order and a strict
// `<` for the decision, so ties stay in the column. The kernels work on the
// rectangle [t_y, t_x] that the lengths give: no value inside it depends on
// a cell outside it, so masking by -1e9 is never needed there. A length is
// clamped to the tensor's extent, so no length reaches memory outside it.
//
// Design of the pair. On the TPU the grid ran in order and the previous row
// lived in VMEM across grid steps. Here blocks run in parallel, so the frame
// loop runs inside one block per batch item:
//   forward:   T_x across threads (up to MAX_COLS columns each), the previous
//              and current rows in shared memory (double buffered, one
//              __syncthreads per row), the next frame's scores prefetched
//              into registers, decisions written to a uint8 [B, T_y, T_x]
//              scratch that the caller allocates. The value lattice never
//              reaches device memory.
//   backtrack: warp 0 walks 32 rows at a time: each lane loads one row's 32
//              decisions around the current column into a bit mask in shared
//              memory, then lane 0 steps through them. All threads then write
//              the whole [T_y, T_x] path tile once, coalesced.
//
// Bound on this card: the function must read neg_cent over the rectangles
// (4 bytes a cell) and write the path (4 bytes a cell): at B=32, T_y=800,
// T_x=384 that is 78.6 MB, about 23 us at 3.35 TB/s; the arithmetic (an add,
// a max and a compare a cell) is negligible. What holds the kernel back is
// the serial chain of T_y rows, each one barrier and one shared-memory round
// trip, with B blocks on 132 SMs; mas_fused_kernel is the redesign.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmas.so mas.cu   (vits_torch/_build.py)
// Each entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kBigNeg = -1e9f;
constexpr int kMaxCols = 4;  // columns per thread: T_x <= kMaxCols * blockDim.x

__global__ void mas_forward_kernel(const float* __restrict__ neg,
                                   uint8_t* __restrict__ dec,
                                   const int* __restrict__ t_ys,
                                   const int* __restrict__ t_xs, int T_y,
                                   int T_x) {
  extern __shared__ float rows[];  // [2, T_x]: previous and current values
  const int b = blockIdx.x;
  const int ty = min(t_ys[b], T_y);
  const int tx = min(t_xs[b], T_x);
  const float* negb = neg + (size_t)b * T_y * T_x;
  uint8_t* decb = dec + (size_t)b * T_y * T_x;
  float* prev = rows;
  float* cur = rows + T_x;
  if (ty <= 0 || tx <= 0) return;

  // row 0: only (0, 0) is reachable; no decisions
  for (int x = threadIdx.x; x < tx; x += blockDim.x) {
    prev[x] = negb[x] + (x == 0 ? 0.0f : kBigNeg);
    decb[x] = 0;
  }
  float next[kMaxCols];
#pragma unroll
  for (int j = 0; j < kMaxCols; ++j) {
    const int x = threadIdx.x + j * blockDim.x;
    next[j] = (ty > 1 && x < tx) ? negb[(size_t)T_x + x] : 0.0f;
  }
  __syncthreads();

  for (int y = 1; y < ty; ++y) {
    float n[kMaxCols];
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int x = threadIdx.x + j * blockDim.x;
      n[j] = next[j];
      if (y + 1 < ty && x < tx) next[j] = negb[(size_t)(y + 1) * T_x + x];
    }
#pragma unroll
    for (int j = 0; j < kMaxCols; ++j) {
      const int x = threadIdx.x + j * blockDim.x;
      if (x < tx) {
        const float p = prev[x];
        const float s = x > 0 ? prev[x - 1] : kBigNeg;
        decb[(size_t)y * T_x + x] = p < s;
        cur[x] = n[j] + fmaxf(p, s);
      }
    }
    __syncthreads();
    float* t = prev;
    prev = cur;
    cur = t;
  }
}

__global__ void mas_backtrack_kernel(const uint8_t* __restrict__ dec,
                                     const int* __restrict__ t_ys,
                                     const int* __restrict__ t_xs,
                                     float* __restrict__ path, int T_y,
                                     int T_x) {
  extern __shared__ int cols[];  // [T_y]: the path's column per row, or -1
  __shared__ unsigned window[32];
  const int b = blockIdx.x;
  const int tx = min(t_xs[b], T_x);
  const int ty = tx > 0 ? min(t_ys[b], T_y) : 0;  // no columns: no walk
  const uint8_t* decb = dec + (size_t)b * T_y * T_x;

  for (int y = max(ty, 0) + threadIdx.x; y < T_y; y += blockDim.x) cols[y] = -1;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int idx = tx - 1;
    for (int y0 = ty - 1; y0 >= 0; y0 -= 32) {
      // rows y0 - r (r < 32), columns lo .. lo + 31; within 32 rows the
      // column drops by at most 31 from idx, so it stays in the window
      const int lo = max(idx - 31, 0);
      const int y = y0 - lane;
      unsigned bits = 0;
      if (y >= 0) {
        const uint8_t* row = decb + (size_t)y * T_x;
        for (int c = 0; c < 32; ++c) {
          const int x = lo + c;
          if (x < tx && row[x]) bits |= 1u << c;
        }
      }
      window[lane] = bits;
      __syncwarp();
      if (lane == 0) {
        for (int r = 0; r < 32 && y0 - r >= 0; ++r) {
          const int yy = y0 - r;
          cols[yy] = idx;
          if (idx != 0 && (idx == yy || ((window[r] >> (idx - lo)) & 1u))) --idx;
        }
      }
      idx = __shfl_sync(0xffffffffu, idx, 0);
    }
  }
  __syncthreads();

  float* pathb = path + (size_t)b * T_y * T_x;
  const size_t n = (size_t)T_y * T_x;
  for (size_t i = threadIdx.x; i < n; i += blockDim.x) {
    const int y = (int)(i / T_x);
    const int x = (int)(i - (size_t)y * T_x);
    pathb[i] = x == cols[y] ? 1.0f : 0.0f;
  }
}

// ---------------------------------------------------------------------------
// mas_fused_kernel: the whole of maximum_path in one launch.
//
// Replaces _forward_kernel (vits_tpu/ops/mas_pallas.py:36) and
// _backtrack_kernel (mas_pallas.py:57) together, and the glue the pair above
// needs (length sums, casts, a decision tensor in device memory). It reads
// neg_cent and the mask, [B, T_y, T_x] f32, and writes the [B, T_y, T_x] f32
// path, equal bit for bit to vits_torch/ops/mas.py::maximum_path_torch, with
// the arithmetic of the pair: the same `neg + fmaxf(prev, shifted)`, -1e9
// sentinels, strict `<` and the walk's `idx == y` step.
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
          float left = __shfl_up_sync(kFull, v[K - 1], 1);
          if (lane == 0) left = kBigNeg;
          float diff[K];
          // last column first: it is what the next row's shuffle sends
#pragma unroll
          for (int k = K - 1; k >= 0; --k) {
            const float s = k > 0 ? v[k > 0 ? k - 1 : 0] : left;
            diff[k] = v[k] - s;  // sign bit set exactly when v[k] < s
            v[k] = n[k] + fmaxf(v[k], s);
          }
          unsigned f = 0;  // bit k: column x0 + k's decision
#pragma unroll
          for (int k = K - 1; k >= 0; --k)
            f = __funnelshift_l(__float_as_uint(diff[k]), f, 1);
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
    // ---- zero-fill the item's path, 16-byte stores where aligned ----
    const int t = tid - 32, nt = kFusedThreads - 32;
    const size_t lead = ((16 - ((uintptr_t)pathb & 15)) & 15) / 4;
    const size_t head = lead < cells ? lead : cells;
    for (size_t i = t; i < head; i += nt) pathb[i] = 0.0f;
    float4* body = reinterpret_cast<float4*>(pathb + head);
    const size_t n4 = (cells - head) / 4;
    for (size_t i = t; i < n4; i += nt) body[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (size_t i = head + 4 * n4 + t; i < cells; i += nt) pathb[i] = 0.0f;
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
    const int diag = yy - lo;  // step where the column equals the row
    if (diag >= 0 && diag < 32) win |= 1u << diag;
    if (lo == 0) win &= ~1u;  // never step below column 0
    int rel = idx - lo, mine = 0;
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const unsigned bits = __shfl_sync(kFull, win, r);
      if (lane == r) mine = rel;
      rel -= (bits >> rel) & 1u;
    }
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

}  // namespace

extern "C" {

int mas_max_cols() { return kMaxCols; }

// neg: [B, T_y, T_x] f32; dec: [B, T_y, T_x] uint8 (written inside the
// rectangles); t_ys, t_xs: [B] int32 on the device.
int mas_forward(const float* neg, uint8_t* dec, const int* t_ys,
                const int* t_xs, int B, int T_y, int T_x, int threads,
                cudaStream_t stream) {
  const size_t smem = 2 * (size_t)T_x * sizeof(float);
  mas_forward_kernel<<<B, threads, smem, stream>>>(neg, dec, t_ys, t_xs, T_y,
                                                   T_x);
  return (int)cudaGetLastError();
}

// dec: [B, T_y, T_x] uint8; path: [B, T_y, T_x] f32, written in full.
int mas_backtrack(const uint8_t* dec, const int* t_ys, const int* t_xs,
                  float* path, int B, int T_y, int T_x, int threads,
                  cudaStream_t stream) {
  const size_t smem = (size_t)T_y * sizeof(int);
  mas_backtrack_kernel<<<B, threads, smem, stream>>>(dec, t_ys, t_xs, path,
                                                     T_y, T_x);
  return (int)cudaGetLastError();
}

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

}  // extern "C"
