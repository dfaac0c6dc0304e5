// Segmented reverse affine scan y_t = x_t + c_t * y_{t+1}, y_T = 0, over
// time-major (T, N) float32 tensors.
//
// Replaces: trpo_tpu/ops/pallas_scan.py, reverse_affine_scan_pallas (:75)
// -> _scan_call (:55) -> _scan_kernel (:39).
//
// Bound on the H100: memory, 12 bytes and two flops per element. At the
// training shape (391, 128) that is 0.6 MB, 0.18 us at 3.35 TB/s, so what
// a call costs is its latency: a launch and a chain of dependent steps.
// One thread per column walking all T steps is a chain of T dependent
// load-FMA steps on 128 threads of one SM.
//
// Design: the recurrence composes affine maps,
// (c1, x1) o (c2, x2) = (c1 c2, x1 + c1 x2). A block owns 32 columns (one
// warp wide, so every row access coalesces along N) and splits T into 16
// chunks, one warp per chunk: 512 threads per block, four blocks at
// N = 128. Each thread issues all its chunk's loads at once (up to 32
// steps kept in registers), composes the chunk's map y_t0 = X + C y_t1,
// publishes it in shared memory, folds the later chunks' maps into its
// incoming carry, and re-walks its chunk from the registers writing y.
// Chunks longer than 32 steps go 32 at a time. Ragged T and N are masked.

#include <cuda_runtime.h>

namespace {

constexpr int COLS = 32;    // env columns per block
constexpr int CHUNKS = 16;  // time chunks per column, one warp each
constexpr int RL = 32;      // steps a thread holds in registers

__global__ void __launch_bounds__(COLS * CHUNKS)
    reverse_affine_scan_kernel(const float* __restrict__ c,
                               const float* __restrict__ x,
                               float* __restrict__ y, int T, int N, int L) {
  __shared__ float sC[CHUNKS][COLS], sX[CHUNKS][COLS];
  const int tx = threadIdx.x, j = threadIdx.y;
  const int n = blockIdx.x * COLS + tx;
  const bool ok = n < N;
  const int t0 = min(j * L, T), t1 = min(t0 + L, T);
  const bool cached = t1 - t0 <= RL;
  float cr[RL], xr[RL];

  // this chunk's map y_t0 = X + C * y_t1, composed from the end
  float C = 1.f, X = 0.f;
  for (int hi = t1; hi > t0; hi -= RL) {
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int t = hi - 1 - i;
      if (ok && t >= t0) {
        cr[i] = c[(size_t)t * N + n];
        xr[i] = x[(size_t)t * N + n];
      }
    }
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int t = hi - 1 - i;
      if (ok && t >= t0) {
        X = fmaf(cr[i], X, xr[i]);
        C *= cr[i];
      }
    }
  }
  sC[j][tx] = C;
  sX[j][tx] = X;
  __syncthreads();

  // y_t1: the later chunks' maps applied to y_T = 0 (empty chunks are the
  // identity map)
  float carry = 0.f;
  for (int k = CHUNKS - 1; k > j; --k)
    carry = fmaf(sC[k][tx], carry, sX[k][tx]);
  if (!ok) return;

  for (int hi = t1; hi > t0; hi -= RL) {
    if (!cached) {
#pragma unroll
      for (int i = 0; i < RL; ++i) {
        const int t = hi - 1 - i;
        if (t >= t0) {
          cr[i] = c[(size_t)t * N + n];
          xr[i] = x[(size_t)t * N + n];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RL; ++i) {
      const int t = hi - 1 - i;
      if (t >= t0) {
        carry = fmaf(cr[i], carry, xr[i]);
        y[(size_t)t * N + n] = carry;
      }
    }
  }
}

}  // namespace

extern "C" int trpo_reverse_affine_scan(const float* c, const float* x,
                                        float* y, int T, int N,
                                        cudaStream_t stream) {
  const int L = (T + CHUNKS - 1) / CHUNKS;
  const dim3 block(COLS, CHUNKS);
  const dim3 grid((N + COLS - 1) / COLS);
  reverse_affine_scan_kernel<<<grid, block, 0, stream>>>(c, x, y, T, N, L);
  return static_cast<int>(cudaGetLastError());
}
