// Segmented reverse affine scan y_t = x_t + c_t * y_{t+1}, y_T = 0, over
// time-major (T, N) float32 tensors.
//
// Replaces: trpo_tpu/ops/pallas_scan.py, reverse_affine_scan_pallas (:75)
// -> _scan_call (:55) -> _scan_kernel (:39).
//
// Bound on the H100: memory. The scan reads c and x once and writes y once
// (12 bytes per element, two flops); at the training shape (391, 128) that
// is 0.6 MB, under a microsecond at 3.35 TB/s, so one launch's fixed cost
// dominates. Design: one thread per env column carries y in a register and
// walks t = T-1 ... 0; neighbouring threads read neighbouring addresses, so
// every row access coalesces along N. It is one pass, as the Pallas kernel
// is, and the ragged N edge is masked instead of padded.

#include <cuda_runtime.h>

namespace {

__global__ void reverse_affine_scan_kernel(const float* __restrict__ c,
                                           const float* __restrict__ x,
                                           float* __restrict__ y, int T,
                                           int N) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  float carry = 0.f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * N + n;
    carry = x[i] + c[i] * carry;
    y[i] = carry;
  }
}

}  // namespace

extern "C" int trpo_reverse_affine_scan(const float* c, const float* x,
                                        float* y, int T, int N,
                                        cudaStream_t stream) {
  const int threads = 128;
  const int blocks = (N + threads - 1) / threads;
  reverse_affine_scan_kernel<<<blocks, threads, 0, stream>>>(c, x, y, T, N);
  return static_cast<int>(cudaGetLastError());
}
