// 13x13 metric bilateral depth filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cofusion_tpu/ops/pallas_stencil.py
// (_bilateral_kernel).  Plain PyTorch twin: bilateral_filter_plain in
// cofusion_tpu_torch/ops/cuda_stencil.py, which the CPU tests hold to the
// JAX package.
//
// What bounds it: operations, not memory.  Each output sums 169 taps, each
// with a precise expf (a special-function-unit exp2 plus 7 fp32 ops of
// range reduction) and ~8 more fp32 ops; one 640x480 frame moves 2.4 MB.
// The design cuts the instructions around each tap:
//  * A block of 32x4 threads owns a 128x4 output tile and stages its
//    140x16 halo in shared memory once (pixels outside the image read as
//    +inf, the reference's "tap outside the image" marker).
//  * Each thread computes kP = 4 horizontally adjacent outputs and keeps one
//    (num, den) pair per output.  For each tap row dy it reads the kP+12
//    values of its row segment with 128-bit loads (consecutive lanes,
//    consecutive 16 B: no bank conflicts), tests each with isfinite once,
//    and column c serves output j as tap dx = c - j - 6.  Every output
//    still sums its taps dy-major, dx-minor.
//  * The 13 spatial terms of row dy, float(double(dy^2+dx^2) * 0.024691358)
//    rounded exactly as the plain version's Python-scalar product is, are
//    read once per row for all kP outputs from a table the block fills at
//    start.  They are stored negated: -(s + c) is computed as (-s) - c,
//    which is exact (only the sign of a zero sum differs, and exp(+-0) = 1).
//  * A non-finite tap enters the exponent as -inf (color term +inf, so
//    expf gives exactly 0) and the numerator as 0: the same zero weight and
//    zero product the plain version's selects give, with the select moved
//    from each (tap, output) pair to each tap.  The dx and output loops are
//    unrolled; the row loop is not.  A first design that unrolled that loop
//    too (all 676 tap-outputs of a thread as straight-line code, the spatial
//    terms as immediates) was slower on the H100 than one output per thread
//    with a loop: the code outgrew the instruction cache.  Per tap and
//    output the loop now issues the 15 instructions the arithmetic needs
//    (8 of them the precise expf).
//
// The isfinite test runs on every tap (an inf or NaN depth inside the image
// is dropped like an out-of-image tap); the centre gate and the summation
// order are the plain version's.  Built with -fmad=false and without fast
// math: no FMA contraction and a precise expf, so the sums round like the
// plain version's on the card.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kR = 6;
constexpr int kSide = 2 * kR + 1;
constexpr int kP = 4;                 // outputs per thread, along a row
constexpr int kBX = 32;               // threads across
constexpr int kBY = 4;                // threads down = tile height
constexpr int kOW = kBX * kP;         // tile width (outputs)
constexpr int kTW = kOW + 2 * kR;     // 140
constexpr int kTH = kBY + 2 * kR;     // 16
constexpr int kSeg = kP + 2 * kR;     // row segment a thread reads per dy
constexpr double kSpace = 0.024691358;  // 1 / (2 * 4.5^2)
constexpr float kColor = 555.556f;      // 1 / (2 * 0.03^2)
static_assert(kP % 4 == 0 && kSeg % 4 == 0 && kTW % 4 == 0, "128-bit row segment loads");

__global__ void __launch_bounds__(kBX * kBY)
bilateral_tile_kernel(const float* __restrict__ depth, float* __restrict__ out, int H, int W,
                      float max_depth) {
  __shared__ __align__(16) float tile[kTH][kTW];
  __shared__ float neg_space[kSide][kSide];
  for (int i = threadIdx.y * kBX + threadIdx.x; i < kSide * kSide; i += kBX * kBY) {
    const int dy = i / kSide - kR;
    const int dx = i % kSide - kR;
    neg_space[dy + kR][dx + kR] =
        -static_cast<float>(static_cast<double>(dy * dy + dx * dx) * kSpace);
  }
  const int gx0 = blockIdx.x * kOW - kR;
  const int gy0 = blockIdx.y * kBY - kR;
  for (int ty = threadIdx.y; ty < kTH; ty += kBY) {
    const int gy = gy0 + ty;
    const bool row_in = gy >= 0 && gy < H;
    for (int tx = threadIdx.x; tx < kTW; tx += kBX) {
      const int gx = gx0 + tx;
      tile[ty][tx] = (row_in && gx >= 0 && gx < W)
                         ? depth[static_cast<size_t>(gy) * W + gx]
                         : INFINITY;
    }
  }
  __syncthreads();

  const int x0 = blockIdx.x * kOW + threadIdx.x * kP;
  const int y = blockIdx.y * kBY + threadIdx.y;
  if (x0 >= W || y >= H) return;

  float c[kP], num[kP], den[kP];
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    c[j] = tile[threadIdx.y + kR][threadIdx.x * kP + j + kR];
    num[j] = 0.0f;
    den[j] = 0.0f;
  }
#pragma unroll 1
  for (int dyr = 0; dyr < kSide; ++dyr) {
    const float4* seg = reinterpret_cast<const float4*>(&tile[threadIdx.y + dyr][threadIdx.x * kP]);
    float v[kSeg];
#pragma unroll
    for (int q = 0; q < kSeg / 4; ++q) {
      const float4 f = seg[q];
      v[4 * q] = f.x;
      v[4 * q + 1] = f.y;
      v[4 * q + 2] = f.z;
      v[4 * q + 3] = f.w;
    }
    float nv[kSeg], nc[kSeg];  // value for the numerator / for the colour term
#pragma unroll
    for (int i = 0; i < kSeg; ++i) {
      const bool inb = isfinite(v[i]);
      nv[i] = inb ? v[i] : 0.0f;
      nc[i] = inb ? v[i] : -INFINITY;
    }
    float ns[kSide];
#pragma unroll
    for (int dxr = 0; dxr < kSide; ++dxr) ns[dxr] = neg_space[dyr][dxr];
#pragma unroll
    for (int j = 0; j < kP; ++j) {
#pragma unroll
      for (int dxr = 0; dxr < kSide; ++dxr) {
        const float diff = c[j] - nc[j + dxr];
        const float color2 = diff * diff;
        const float w = expf(ns[dxr] - color2 * kColor);
        num[j] = num[j] + nv[j + dxr] * w;
        den[j] = den[j] + w;
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kP; ++j) {
    if (x0 + j < W) {
      const float o = num[j] / fmaxf(den[j], 1e-12f);
      out[static_cast<size_t>(y) * W + x0 + j] = (c[j] >= 0.3f && c[j] <= max_depth) ? o : 0.0f;
    }
  }
}

}  // namespace

extern "C" int cofusion_bilateral_f32(const float* depth, float* out, int H, int W,
                                      float max_depth, void* stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kOW - 1) / kOW, (H + kBY - 1) / kBY);
  bilateral_tile_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      depth, out, H, W, max_depth);
  return static_cast<int>(cudaGetLastError());
}
