// Input gradient of a grouped 1-D convolution with few channels a group, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no multi-period or scale
// discriminator. It was added because cuDNN's f32 route for this gradient
// at the scale discriminator's (models/mpd.py::DiscriminatorS) grouped convs
// -- kernel 41, stride 4, padding 20, 4 input channels a group, 16 or 4
// output channels a group -- is a direct kernel with no tensor-core path, and
// took about 78 ms of a pitchless train step where the work needs well under
// one.
//
// It computes, for every row b, group g, input channel ci of the group and
// input position t,
//   grad_in[b, g*cin_g + ci, t] =
//     sum_co sum_k grad_out[b, g*cout_g + co, j] * w[g*cout_g + co, ci, k]
// over the taps with t + pad - k = s*j and 0 <= j < T_out, in float32
// with fused multiply-adds (no TF32, no bf16), in a fixed order: co, then k.
//
// Bound on this card: at the cell's shapes (128 rows of 8192 samples; layers
// 16 -> 64 / 4 groups, 64 -> 256 / 16, 256 -> 1024 / 64, 1024 -> 1024 / 256)
// the four layers need ~70 M multiply-adds a row, ~17.9 GFLOP a pass: ~0.27 ms
// at the H100's 67 TFLOP/s of plain f32 FMA. The bytes (each grad_out and
// grad_in value once, ~0.49 GB a pass) take ~0.15 ms at 3.35 TB/s. So the
// kernel is bound by the FMA pipes if it keeps them fed, and what the design
// does is keep the loads per FMA low:
//   * Polyphase. Position t = s*u + v has its taps k = r + s*m with r the
//     residue of (v + pad) mod s, and reads grad_out at j = u + qoff - m,
//     qoff = (v + pad) div s: ~K/s taps a position instead of K with a test.
//     The weight slice is padded in shared memory to ceil(K/s)*s taps with
//     zeros, so every residue runs the same trip count without a branch.
//   * Shared memory. A block stages its groups' weight slices, laid out
//     [group][co][k][ci] so that one 16-byte load brings the 4 input
//     channels of a tap, and the window of grad_out its positions read, with
//     zeros outside [0, T_out), loaded coalesced along time.
//   * Lanes. Lane = v + s*uu covers s*(32/s) consecutive positions: the s
//     residues of 32/s consecutive u. A weight load is then one 16-byte
//     word per residue (s distinct addresses a warp, conflict-free), a
//     grad_out load 32/s (+1) consecutive words (conflict-free), and a
//     store 32 consecutive floats (coalesced).
//   * Registers. A thread accumulates all cin_g channels (CIN, a template
//     parameter padded to 1, 2, 4 or 8) for P positions 32 apart (P of 1, 2,
//     4 or 8): a tap's CIN weights are reused over P positions and each
//     grad_out value over CIN channels, CIN*P FMAs for CIN/4 + P loads.
//   * Blocks. A warp covers 32*P positions of one group; a block NT warps
//     along time and GB groups (GB*NT <= 8), so that the narrow last layer
//     (4 x 4 channels a group, T_in 128) still fills the card. The entry
//     point chooses the plan (P, NT, GB): see choose_plan.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libgrouped_conv.so grouped_conv.cu
//        (vits_torch/_build.py)
// The entry point launches on the given stream, does not synchronise,
// allocates nothing and returns cudaGetLastError() (cudaErrorInvalidValue,
// without a launch, for arguments outside its limits).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSharedOptIn = 232448;  // 227 KB, a block's most after opting in
constexpr int kMaxWarps = 8;
constexpr int kMaxCin = 8, kMaxCout = 64, kMaxKernel = 64, kMaxStride = 8;

struct Args {
  const float* grad_out;  // [B, G*cout_g, T_out]
  const float* weight;    // [G*cout_g, cin_g, K]
  float* grad_in;         // [B, G*cin_g, T_in]
  int G, cin_g, cout_g, T_in, T_out, K, s, pad;
  int taps;  // M = ceil(K / s): taps a residue, the weight slice padded to M*s
  int uw;    // 32 / s: the u a warp covers a position step
  int nt, gb;
  int win;   // grad_out values a (group, co) of the block's window
};

int cin_pad(int cin_g) { return cin_g <= 1 ? 1 : cin_g <= 2 ? 2 : cin_g <= 4 ? 4 : 8; }

// Floats of the weight slices, rounded up so the window starts 16-byte aligned.
__host__ __device__ long long weight_floats(int gb, int cout_g, int taps, int s, int cin) {
  return ((long long)gb * cout_g * taps * s * cin + 3) / 4 * 4;
}

int window(int nt, int uw, int p, int s, int pad, int taps) {
  return nt * uw * p + ((s - 1 + pad) / s - pad / s) + taps - 1;
}

// Dynamic shared memory of one block under the plan (P, NT, GB): the groups'
// weight slices and their grad_out windows, 4 bytes a float.
long long smem_bytes(int cin_g, int cout_g, int K, int s, int pad, int P, int NT, int GB) {
  const int taps = (K + s - 1) / s;
  return 4 * (weight_floats(GB, cout_g, taps, s, cin_pad(cin_g)) +
              (long long)GB * cout_g * window(NT, 32 / s, P, s, pad, taps));
}

struct Plan {
  int p;   // positions a thread, 32 apart
  int nt;  // warps a block along time
  int gb;  // groups a block
  long long smem;
};

// P positions a thread, 8 where 8 warps of 8 fit in the row, else the fewest
// of 1, 2, 4 that cover the row with one warp, at most 4; NT warps along
// time, as many as the row needs, at most 8; GB groups a block, so that a
// block has 4 warps where fewer cover the row; then GB, NT and P halved while
// the shared memory exceeds a block's 227 KB (P = NT = GB = 1 fits at every
// width the kernel takes). At the cell's four shapes this is the fastest plan
// or within 1% of it (an H100, timed over every plan).
Plan choose_plan(int T_in, int G, int cin_g, int cout_g, int K, int s, int pad) {
  const int chunk = (32 / s) * s;  // positions a warp covers a step of P
  const int steps = (T_in + chunk - 1) / chunk;
  const int few = steps < 4 ? steps : 4;
  Plan pl;
  pl.p = steps >= kMaxWarps * 8 ? 8 : few <= 1 ? 1 : few <= 2 ? 2 : 4;
  pl.nt = (steps + pl.p - 1) / pl.p < kMaxWarps ? (steps + pl.p - 1) / pl.p : kMaxWarps;
  pl.gb = 4 / pl.nt < 1 ? 1 : G < 4 / pl.nt ? G : 4 / pl.nt;
  while ((pl.smem = smem_bytes(cin_g, cout_g, K, s, pad, pl.p, pl.nt, pl.gb)) >
             kMaxSharedOptIn && (pl.p > 1 || pl.nt > 1 || pl.gb > 1)) {
    if (pl.gb > 1)
      pl.gb /= 2;
    else if (pl.nt > 1)
      pl.nt /= 2;
    else
      pl.p /= 2;
  }
  return pl;
}

template <int CIN>
__device__ __forceinline__ void load_taps(const float* src, float (&w)[CIN]) {
  if constexpr (CIN % 4 == 0) {
#pragma unroll
    for (int c = 0; c < CIN; c += 4) {
      const float4 q = *reinterpret_cast<const float4*>(src + c);
      w[c] = q.x, w[c + 1] = q.y, w[c + 2] = q.z, w[c + 3] = q.w;
    }
  } else if constexpr (CIN == 2) {
    const float2 q = *reinterpret_cast<const float2*>(src);
    w[0] = q.x, w[1] = q.y;
  } else {
    w[0] = src[0];
  }
}

template <int CIN, int P>
__global__ void __launch_bounds__(kMaxWarps * 32)
    grouped_dgrad_kernel(const Args a) {
  extern __shared__ float4 smem4[];
  float* w_s = reinterpret_cast<float*>(smem4);
  const int cg = a.cout_g, kp = a.taps * a.s;
  float* go_s = w_s + weight_floats(a.gb, cg, a.taps, a.s, CIN);
  const int b = blockIdx.z, g0 = blockIdx.y * a.gb;
  const int u0 = blockIdx.x * a.nt * a.uw * P;
  const int qlo = a.pad / a.s;
  const int jb = u0 + qlo - (a.taps - 1);  // grad_out index of window slot 0

  // A warp stages whole rows (a group's output channel), so no element needs
  // a division by a runtime width: the weights as [gl][co][k][ci], zero
  // beyond cin_g, K and G, and the grad_out window as [gl][co][slot], zero
  // outside [0, T_out) and G, read coalesced along time.
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, warps = blockDim.x >> 5;
  const long long chan0 = ((long long)b * a.G + g0) * cg;
  for (int row = warp; row < a.gb * cg; row += warps) {
    const bool live = g0 + row / cg < a.G;
    const float* src = a.weight + (g0 * cg + row) * (long long)a.cin_g * a.K;
    float* dst = w_s + row * kp * CIN;
    for (int e = lane; e < kp * CIN; e += 32) {
      const int k = e / CIN, ci = e % CIN;
      dst[e] = live && ci < a.cin_g && k < a.K ? src[ci * a.K + k] : 0.f;
    }
    const float* go_row = a.grad_out + (chan0 + row) * a.T_out;
    float* win = go_s + row * a.win;
    for (int x = lane; x < a.win; x += 32) {
      const int j = jb + x;
      win[x] = live && j >= 0 && j < a.T_out ? go_row[j] : 0.f;
    }
  }
  __syncthreads();

  const int gl = warp / a.nt, nt = warp % a.nt, g = g0 + gl;
  if (g >= a.G || lane >= a.uw * a.s) return;
  const int v = lane % a.s, uu = lane / a.s;
  const int r = (v + a.pad) % a.s, qoff = (v + a.pad) / a.s;
  const int ul = nt * a.uw * P + uu;  // the block's local u at p = 0

  float acc[CIN][P];
#pragma unroll
  for (int c = 0; c < CIN; ++c)
#pragma unroll
    for (int p = 0; p < P; ++p) acc[c][p] = 0.f;

  const float* wp = w_s + ((long long)gl * cg * kp + r) * CIN;
  const float* gp = go_s + (long long)gl * cg * a.win + ul + qoff - qlo + a.taps - 1;
  const int uw = a.uw, w_step = a.s * CIN;
  for (int co = 0; co < cg; ++co, wp += kp * CIN, gp += a.win) {
    const float* wq = wp;
    const float* gq = gp;
#pragma unroll 4
    for (int m = 0; m < a.taps; ++m, wq += w_step, --gq) {
      float w[CIN];
      load_taps<CIN>(wq, w);
#pragma unroll
      for (int p = 0; p < P; ++p) {
        const float x = gq[p * uw];
#pragma unroll
        for (int c = 0; c < CIN; ++c) acc[c][p] = fmaf(w[c], x, acc[c][p]);
      }
    }
  }

  float* out = a.grad_in + ((long long)b * a.G + g) * a.cin_g * a.T_in;
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int t = a.s * (u0 + ul + p * uw) + v;
    if (t < a.T_in) {
#pragma unroll
      for (int c = 0; c < CIN; ++c)
        if (c < a.cin_g) out[(long long)c * a.T_in + t] = acc[c][p];
    }
  }
}

template <int CIN, int P>
int launch(const Args& a, dim3 grid, int threads, int smem, cudaStream_t stream) {
  static bool opted_in = false;  // above 48 KB only after this, once
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        grouped_dgrad_kernel<CIN, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxSharedOptIn);
    if (err != cudaSuccess) return (int)err;
    opted_in = true;
  }
  grouped_dgrad_kernel<CIN, P><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int CIN>
int launch_p(const Args& a, int p, dim3 grid, int threads, int smem, cudaStream_t stream) {
  switch (p) {
    case 1: return launch<CIN, 1>(a, grid, threads, smem, stream);
    case 2: return launch<CIN, 2>(a, grid, threads, smem, stream);
    case 4: return launch<CIN, 4>(a, grid, threads, smem, stream);
    case 8: return launch<CIN, 8>(a, grid, threads, smem, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// grad_out: [B, G*cout_g, T_out] f32; weight: [G*cout_g, cin_g, K] f32;
// grad_in: [B, G*cin_g, T_in] f32, written in full. All contiguous, T_out the
// forward's (T_in + 2 pad - K) / stride + 1.
int grouped_dgrad(const float* grad_out, const float* weight, float* grad_in, int B,
                  int G, int cin_g, int cout_g, int T_in, int T_out, int K, int stride,
                  int pad, cudaStream_t stream) {
  if (cin_g < 1 || cin_g > kMaxCin || cout_g < 1 || cout_g > kMaxCout || K < 1 ||
      K > kMaxKernel || stride < 1 || stride > kMaxStride || pad < 0 || B < 1 ||
      B > 65535 || G < 1 || G > 65535 || T_in < 1 || T_out < 1 ||
      T_out != (T_in + 2 * pad - K) / stride + 1)
    return (int)cudaErrorInvalidValue;
  const Plan pl = choose_plan(T_in, G, cin_g, cout_g, K, stride, pad);
  if (pl.smem > kMaxSharedOptIn) return (int)cudaErrorInvalidValue;
  Args a{grad_out, weight, grad_in, G, cin_g, cout_g, T_in, T_out, K, stride, pad};
  a.taps = (K + stride - 1) / stride;
  a.uw = 32 / stride;
  a.nt = pl.nt;
  a.gb = pl.gb;
  a.win = window(pl.nt, a.uw, pl.p, stride, pad, a.taps);
  const int n_u = (T_in + stride - 1) / stride, tile_u = pl.nt * a.uw * pl.p;
  const dim3 grid((n_u + tile_u - 1) / tile_u, (G + pl.gb - 1) / pl.gb, B);
  const int threads = pl.nt * pl.gb * 32, s = (int)pl.smem;
  switch (cin_pad(cin_g)) {
    case 1: return launch_p<1>(a, pl.p, grid, threads, s, stream);
    case 2: return launch_p<2>(a, pl.p, grid, threads, s, stream);
    case 4: return launch_p<4>(a, pl.p, grid, threads, s, stream);
    case 8: return launch_p<8>(a, pl.p, grid, threads, s, stream);
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
