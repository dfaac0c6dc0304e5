// Damped Gauss-Newton Fisher-vector product (F + lambda I) v = J^T M J v +
// lambda v for a plain-MLP diagonal-Gaussian policy, f32 end to end.
//
// Replaces: trpo_tpu/ops/fused_fvp.py, make_fused_gaussian_mlp_fvp (:298),
// kernel body _fvp_kernel (:150-229), pallas_call at :407.
//
// Bound on the H100: operations. Per row it does 472,064 multiply-adds
// (tangent sweep + backward sweep); at the training shape (37,536 rows,
// 376 -> 256 -> 256 -> 17) that is 35.4 GFLOP against ~133 MB of
// compulsory reads (obs and the two stored activations), so the f32 CUDA
// core rate, not memory, sets the floor (~0.53 ms at 67 TFLOP/s).
//
// Design. The TPU kernel accumulates the parameter cotangents into its
// outputs across a SEQUENTIAL grid; Hopper blocks run in parallel, and a
// per-block copy of the 166.7k-float cotangent would be hundreds of MB. So
// the operator is split into two deterministic phases, no atomics:
//   (A) row-parallel sweeps: tiled GEMMs over row blocks with fused
//       epilogues -- the tangent forward (times the activation derivative,
//       read from the stored activation), the Fisher weighting
//       c = d_mean * w_n * exp(-2 log_std), and the backward dgrad chain --
//       writing the per-row pre-activation cotangents g_k and c to scratch;
//   (B) parameter-parallel weight gradients: each block owns a tile of one
//       layer's [b; W] cotangent (the bias is a ones column prepended to the
//       activations, so the tile lands in the flat ravel order b, then W)
//       and sums a fixed slice of rows (split-K); a reduce kernel adds the
//       slices in a fixed order plus lambda v.
// The products are 64x64 tiles in shared memory, 16-deep, each thread a
// 4x4 register block, in plain f32 FMAs (no tensor cores, no TF32). Making
// it fast (wgmma/TMA, keeping g_k on chip) is later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int THREADS = 256;

enum { ACT_TANH = 0, ACT_RELU = 1, ACT_ELU = 2 };
enum { EPI_DERIV = 0, EPI_FISHER = 1 };

// Activation derivative from the activation OUTPUT h (what is stored).
__device__ __forceinline__ float act_deriv(int act, float h) {
  if (act == ACT_TANH) return 1.f - h * h;
  if (act == ACT_RELU) return h > 0.f ? 1.f : 0.f;
  return h > 0.f ? 1.f : h + 1.f;  // elu
}

// C[M, N] = A1 @ op(B1) [+ A2 @ op(B2)] + bias, then the epilogue:
//   EPI_DERIV:  C *= act'(H)            (tangent forward / backward dgrad)
//   EPI_FISHER: C *= wn[row] * m[col]   (the dist-space Fisher weighting)
// TRANS_B = false: B is (K, N) row-major, leading dimension ldb.
// TRANS_B = true:  B is stored (N, K) row-major (a weight (in, out) used as
//                  its transpose), leading dimension ldb.
template <bool TRANS_B>
__global__ void __launch_bounds__(THREADS) sweep_gemm_kernel(
    int M, int N, const float* __restrict__ A1, int lda1, int K1,
    const float* __restrict__ B1, int ldb1, const float* __restrict__ A2,
    int lda2, int K2, const float* __restrict__ B2, int ldb2,
    const float* __restrict__ bias, int epi, int act,
    const float* __restrict__ H, int ldh, const float* __restrict__ wn,
    const float* __restrict__ mvec, float* __restrict__ C, int ldc) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;
  float acc[4][4] = {};

  for (int pair = 0; pair < 2; ++pair) {
    const float* A = pair ? A2 : A1;
    const float* B = pair ? B2 : B1;
    const int K = pair ? K2 : K1;
    const int lda = pair ? lda2 : lda1;
    const int ldb = pair ? ldb2 : ldb1;
    if (A == nullptr || K <= 0) continue;
    for (int k0 = 0; k0 < K; k0 += BK) {
      for (int e = tid; e < BM * BK; e += THREADS) {
        const int r = e / BK, kk = e % BK;  // consecutive threads: along k
        const int gr = row0 + r, gk = k0 + kk;
        As[kk][r] = (gr < M && gk < K) ? A[(size_t)gr * lda + gk] : 0.f;
      }
      for (int e = tid; e < BK * BN; e += THREADS) {
        int kk, cc;
        if (TRANS_B) {
          cc = e / BK;  // consecutive threads: along k (B's contiguous dim)
          kk = e % BK;
        } else {
          kk = e / BN;  // consecutive threads: along n
          cc = e % BN;
        }
        const int gk = k0 + kk, gc = col0 + cc;
        float v = 0.f;
        if (gk < K && gc < N)
          v = TRANS_B ? B[(size_t)gc * ldb + gk] : B[(size_t)gk * ldb + gc];
        Bs[kk][cc] = v;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int cidx = col0 + tx * 4 + j;
      if (cidx >= N) continue;
      float v = acc[i][j] + (bias != nullptr ? bias[cidx] : 0.f);
      if (epi == EPI_DERIV)
        v *= act_deriv(act, H[(size_t)r * ldh + cidx]);
      else
        v *= wn[r] * mvec[cidx];
      C[(size_t)r * ldc + cidx] = v;
    }
  }
}

// Phase B: partial[s][i * N + j] = sum over rows r of split s of
//   Aaug[r][i] * G[r][j],   Aaug = [1 | A]  (i = 0 is the bias row),
// for i in [0, Kin], j in [0, N). Grid: (N tiles, (Kin+1) tiles, splits).
__global__ void __launch_bounds__(THREADS) wgrad_kernel(
    int M, int rows_per_split, int Kin, int N, const float* __restrict__ A,
    int lda, const float* __restrict__ G, int ldg, float* __restrict__ partial,
    long long split_stride) {
  __shared__ float As[BK][BM + 1];
  __shared__ float Gs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int i0 = blockIdx.y * BM;
  const int j0 = blockIdx.x * BN;
  const int rbeg = blockIdx.z * rows_per_split;
  const int rend = min(rbeg + rows_per_split, M);
  float acc[4][4] = {};

  for (int r0 = rbeg; r0 < rend; r0 += BK) {
    for (int e = tid; e < BK * BM; e += THREADS) {
      const int kk = e / BM, ii = e % BM;  // consecutive threads: along i
      const int r = r0 + kk, i = i0 + ii;
      float v = 0.f;
      if (r < rend && i <= Kin) v = (i == 0) ? 1.f : A[(size_t)r * lda + i - 1];
      As[kk][ii] = v;
    }
    for (int e = tid; e < BK * BN; e += THREADS) {
      const int kk = e / BN, jj = e % BN;  // consecutive threads: along j
      const int r = r0 + kk, j = j0 + jj;
      Gs[kk][jj] = (r < rend && j < N) ? G[(size_t)r * ldg + j] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Gs[kk][tx * 4 + j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  float* out = partial + (long long)blockIdx.z * split_stride;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ii = i0 + ty * 4 + i;
    if (ii > Kin) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int jj = j0 + tx * 4 + j;
      if (jj < N) out[(size_t)ii * N + jj] = acc[i][j];
    }
  }
}

// out[p] = sum_{s < S} partial[s * P + p] + damping * v[p], s in order.
__global__ void reduce_kernel(int P, int S, const float* __restrict__ partial,
                              const float* __restrict__ v, float damping,
                              float* __restrict__ out) {
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < P;
       p += gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += partial[(size_t)k * P + p];
    out[p] = s + damping * v[p];
  }
}

inline int cdiv(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" int trpo_fvp_sweep_gemm(
    int trans_b, int M, int N, const float* A1, int lda1, int K1,
    const float* B1, int ldb1, const float* A2, int lda2, int K2,
    const float* B2, int ldb2, const float* bias, int epi, int act,
    const float* H, int ldh, const float* wn, const float* mvec, float* C,
    int ldc, cudaStream_t stream) {
  const dim3 grid(cdiv(N, BN), cdiv(M, BM));
  if (trans_b)
    sweep_gemm_kernel<true><<<grid, THREADS, 0, stream>>>(
        M, N, A1, lda1, K1, B1, ldb1, A2, lda2, K2, B2, ldb2, bias, epi, act,
        H, ldh, wn, mvec, C, ldc);
  else
    sweep_gemm_kernel<false><<<grid, THREADS, 0, stream>>>(
        M, N, A1, lda1, K1, B1, ldb1, A2, lda2, K2, B2, ldb2, bias, epi, act,
        H, ldh, wn, mvec, C, ldc);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trpo_fvp_wgrad(int M, int rows_per_split, int n_splits,
                              int Kin, int N, const float* A, int lda,
                              const float* G, int ldg, float* partial,
                              long long split_stride, cudaStream_t stream) {
  const dim3 grid(cdiv(N, BN), cdiv(Kin + 1, BM), n_splits);
  wgrad_kernel<<<grid, THREADS, 0, stream>>>(M, rows_per_split, Kin, N, A, lda,
                                             G, ldg, partial, split_stride);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trpo_fvp_reduce(int P, int S, const float* partial,
                               const float* v, float damping, float* out,
                               cudaStream_t stream) {
  const int threads = 256;
  const int blocks = cdiv(P, threads) < 4096 ? cdiv(P, threads) : 4096;
  reduce_kernel<<<blocks, threads, 0, stream>>>(P, S, partial, v, damping,
                                                out);
  return static_cast<int>(cudaGetLastError());
}
