// 13x13 metric bilateral depth filter for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel cofusion_tpu/ops/pallas_stencil.py
// (_bilateral_kernel).  Plain PyTorch twin: bilateral_filter_plain in
// cofusion_tpu_torch/ops/cuda_stencil.py, which the CPU tests hold to the
// JAX package.
//
// What bounds it: 169 precise expf per output pixel (compute), not memory —
// one 640x480 frame reads 1.2 MB and writes 1.2 MB.  The design keeps every
// tap read out of device memory: a 32x8 block stages its (8+12)x(32+12) halo
// tile in shared memory once (pixels outside the image read as +inf, the
// reference's "tap outside the image" marker), then each thread sums its 169
// taps from shared memory in the reference's dy-major, dx-minor order and
// applies the centre gate in the same pass.
//
// Built with -fmad=false and without fast math: no FMA contraction and a
// precise expf, so the sums round like the plain version's.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kR = 6;
constexpr int kBX = 32;
constexpr int kBY = 8;
constexpr int kTW = kBX + 2 * kR;
constexpr int kTH = kBY + 2 * kR;
constexpr float kSpace = 0.024691358f;  // 1 / (2 * 4.5^2)
constexpr float kColor = 555.556f;      // 1 / (2 * 0.03^2)

__global__ void __launch_bounds__(kBX * kBY)
bilateral_kernel(const float* __restrict__ depth, float* __restrict__ out,
                 int H, int W, float max_depth) {
  __shared__ float tile[kTH][kTW];
  const int x0 = blockIdx.x * kBX;
  const int y0 = blockIdx.y * kBY;
  const int tid = threadIdx.y * kBX + threadIdx.x;
  for (int i = tid; i < kTH * kTW; i += kBX * kBY) {
    const int ty = i / kTW;
    const int tx = i - ty * kTW;
    const int gy = y0 + ty - kR;
    const int gx = x0 + tx - kR;
    tile[ty][tx] = (gy >= 0 && gy < H && gx >= 0 && gx < W) ? depth[gy * W + gx] : INFINITY;
  }
  __syncthreads();

  const int x = x0 + threadIdx.x;
  const int y = y0 + threadIdx.y;
  if (x >= W || y >= H) return;

  const float c = tile[threadIdx.y + kR][threadIdx.x + kR];
  float num = 0.0f;
  float den = 0.0f;
  for (int dy = -kR; dy <= kR; ++dy) {
    const float* row = &tile[threadIdx.y + kR + dy][threadIdx.x + kR];
    for (int dx = -kR; dx <= kR; ++dx) {
      const float nbr = row[dx];
      const bool inb = isfinite(nbr);
      const float nv = inb ? nbr : 0.0f;
      const float space2 = static_cast<float>(dy * dy + dx * dx);
      const float diff = c - nv;
      const float color2 = diff * diff;
      float w = expf(-(space2 * kSpace + color2 * kColor));
      w = inb ? w : 0.0f;
      num = num + nv * w;
      den = den + w;
    }
  }
  const float o = num / fmaxf(den, 1e-12f);
  out[y * W + x] = (c >= 0.3f && c <= max_depth) ? o : 0.0f;
}

}  // namespace

extern "C" int cofusion_bilateral_f32(const float* depth, float* out, int H, int W,
                                      float max_depth, void* stream) {
  const dim3 block(kBX, kBY);
  const dim3 grid((W + kBX - 1) / kBX, (H + kBY - 1) / kBY);
  bilateral_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      depth, out, H, W, max_depth);
  return static_cast<int>(cudaGetLastError());
}
