// Monotonic Alignment Search — native host kernel (the port's copy of
// native/mas.cpp, kept byte for byte below this header).
//
// Role: the host-side MAS for CPU debugging and as an independent oracle
// of the CUDA kernel (csrc/mas.cu) and the plain PyTorch version
// (ops/mas.py). Mirrors the reference's native component
// (monotonic_align/core.pyx — the published Glow-TTS Viterbi DP), written
// directly in C++ with OpenMP batch parallelism instead of Cython.
//
// Build: see vits_torch/ops/mas_native.py (g++ -O3 -fopenmp -shared -fPIC,
// at first use, into vits_torch/_build/).

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr float kBigNeg = -1e9f;

// Forward DP + backtrack for one sample.
// value: [t_y, t_x] row-major, modified in place (DP accumulation).
// path:  [t_y, t_x] int32, zero-initialized by the caller.
void mas_single(float* value, std::int32_t* path, int t_y, int t_x,
                int stride) {
  // forward: value[y][x] += max(value[y-1][x-1], value[y-1][x])
  // with the diagonal/band constraints of the published algorithm.
  for (int y = 0; y < t_y; ++y) {
    float* row = value + static_cast<std::ptrdiff_t>(y) * stride;
    const float* prev = row - stride;
    const int x_lo = std::max(0, t_x + y - t_y);
    const int x_hi = std::min(t_x, y + 1);
    for (int x = x_lo; x < x_hi; ++x) {
      const float v_cur = (x == y) ? kBigNeg : prev[x];
      float v_prev;
      if (x == 0) {
        v_prev = (y == 0) ? 0.0f : kBigNeg;
      } else {
        v_prev = prev[x - 1];
      }
      row[x] += std::max(v_prev, v_cur);
    }
  }
  // backtrack from (t_y-1, t_x-1)
  int index = t_x - 1;
  for (int y = t_y - 1; y >= 0; --y) {
    path[static_cast<std::ptrdiff_t>(y) * stride + index] = 1;
    if (index != 0) {
      const float* prev = value + static_cast<std::ptrdiff_t>(y - 1) * stride;
      if (index == y || prev[index] < prev[index - 1]) {
        --index;
      }
    }
  }
}

}  // namespace

extern "C" {

// neg_cent: [b, t_y, t_x] float32 (copied into a scratch value buffer per
// sample); paths: [b, t_y, t_x] int32 out; t_ys/t_xs: per-sample lengths.
void mas_batch(const float* neg_cent, std::int32_t* paths,
               const std::int32_t* t_ys, const std::int32_t* t_xs, int b,
               int t_y, int t_x) {
  const std::ptrdiff_t plane = static_cast<std::ptrdiff_t>(t_y) * t_x;
#pragma omp parallel
  {
    float* scratch = new float[plane];
#pragma omp for schedule(dynamic)
    for (int i = 0; i < b; ++i) {
      std::memcpy(scratch, neg_cent + i * plane, plane * sizeof(float));
      std::memset(paths + i * plane, 0, plane * sizeof(std::int32_t));
      mas_single(scratch, paths + i * plane, t_ys[i], t_xs[i], t_x);
    }
    delete[] scratch;
  }
}

}  // extern "C"
