// Monotonic Alignment Search (MAS) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of vits_tpu/ops/mas_pallas.py:
//   mas_forward_kernel   <- _forward_kernel   (mas_pallas.py:36): the forward
//                           DP over frames, emitting one decision row per frame
//   mas_backtrack_kernel <- _backtrack_kernel (mas_pallas.py:57): the reverse
//                           walk from (t_y-1, t_x-1) that writes the path
//
// Semantics are those of vits_tpu/ops/mas.py::maximum_path_scan and of the
// plain PyTorch version in vits_torch/ops/mas.py, bit for bit: the same f32
// sentinel (-1e9), the same `neg + fmaxf(prev, shifted)` order and a strict
// `<` for the decision, so ties stay in the column. The kernels work on the
// rectangle [t_y, t_x] that the lengths give: no value inside it depends on
// a cell outside it, so masking by -1e9 is never needed there. A length is
// clamped to the tensor's extent, so no length reaches memory outside it.
//
// Design. On the TPU the grid ran in order and the previous row lived in
// VMEM across grid steps. Here blocks run in parallel, so the frame loop
// runs inside one block per batch item:
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
// trip, with B blocks on 132 SMs. Bit-packed decisions in shared memory,
// fusion with the backtrack and several items per block are later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libmas.so mas.cu   (vits_torch/_build.py)
// Each entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <stdint.h>

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

}  // extern "C"
