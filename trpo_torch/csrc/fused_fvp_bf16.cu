// Damped Gauss-Newton Fisher-vector product (F + lambda I) v for a
// plain-MLP diagonal-Gaussian policy with bf16 operands: K1-bf16, the
// solver ladder's cheap matvec (cfg.fvp_dtype = "bf16") and the operator of
// a policy whose compute dtype is bfloat16.
//
// Replaces: trpo_tpu/ops/fused_fvp.py, make_fused_gaussian_mlp_fvp (:298)
// at compute_dtype=bf16 (its default, :306; setup :346-362, :418-422;
// kernel body _fvp_kernel :150-229).
//
// What it computes, and where it rounds (the accuracy contract of the
// reference's body): obs, the stored activations h_k (from a bf16 forward
// outside the kernel), the weights and the weight tangents are bf16; the
// bias tangents stay f32. Every product accumulates in f32. The activation
// derivative is computed in f32 from the bf16 h. The tangent dh, the
// Fisher-weighted c and the backward cotangents g are rounded to bf16 only
// where they feed the next product; the bias cotangents sum the unrounded
// f32 values (c32, g32). So the sweeps store c32/g32 (and dh) in f32 and
// the tile loaders round them to bf16 on their way into shared memory: a
// value is rounded exactly where the reference rounds it, and nowhere else.
//
// Bound on the H100 SXM: operations. At the training shape (37,536 rows,
// 376 -> 256 -> 256 -> 17) the operator does 35.44 GFLOP of products:
// 0.036 ms at 989 TFLOP/s dense bf16, against 66.7 MB of compulsory bf16
// row operands (obs, h_0, h_1) = 0.020 ms at 3.35 TB/s.
//
// Design: the two-phase, atomic-free structure of the f32 kernel
// (fused_fvp.cu), on mma.sync.m16n8k16 bf16 tensor-core products:
//   (A) row-parallel sweeps (fvp16_sweep_kernel, one launch per product):
//       C = A1 B1 [+ A2 B2] + bias with a fused epilogue (times act'(h),
//       or the Fisher weighting w_n * exp(-2 log_std)), f32 out;
//   (B) parameter-parallel weight gradients (fvp16_wgrad_kernel: a tile of
//       one layer's W cotangent over a fixed slice of rows, split-K) and
//       the bias cotangents (fvp16_colsum_kernel: column sums of the f32
//       g32/c32 over the same slices), then trpo_fvp_reduce (fused_fvp.cu)
//       adds the slices in a fixed order plus lambda v, lambda read from
//       device memory. The result is bitwise repeatable.
// Tiles are 64 x 64 x 64 over four warps (a 32 x 32 warp tile). The tile
// loader copies 8 values a thread (16 bytes of bf16, or 32 of f32 rounded
// to bf16) into shared memory in the operand's own layout: the sweeps'
// operands lie k contiguous, so their mma fragments are 32-bit loads; the
// weight gradients' activations and cotangents lie k-major, and their
// fragments come from ldmatrix.trans. The sweeps' epilogue stages its
// tile through shared memory, so it reads H and writes C in 16-byte
// pieces. Ragged edges are zero filled by the loader
// and masked in the epilogues, so any width works. Two shared-memory
// stages (36 KB a block): stage k+1's loads are issued into registers
// before stage k's products and stored to the other stage after them. The
// weight gradients are split over enough row slices (about eight blocks
// an SM) that many k-loops wait on their loads at once: each is
// latency-bound, not bandwidth-bound.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 64;
constexpr int SK = BK + 8;  // shared row stride in bf16: 144 bytes
constexpr int THREADS = 128;
constexpr int MAX_LAYERS = 8;

enum { ACT_TANH = 0, ACT_RELU = 1, ACT_ELU = 2 };
enum { EPI_DERIV = 0, EPI_FISHER = 1 };

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// Round to nearest even, as torch's and XLA's f32 -> bf16 casts do.
__device__ __forceinline__ uint16_t bf16_bits(float x) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float bf16_float(uint16_t b) {
  return __uint_as_float(static_cast<uint32_t>(b) << 16);
}

// Eight consecutive values as bf16 bits (p 16-byte aligned).
__device__ __forceinline__ void load8(const uint16_t* p, uint16_t (&o)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    o[2 * q] = static_cast<uint16_t>(w[q] & 0xffffu);
    o[2 * q + 1] = static_cast<uint16_t>(w[q] >> 16);
  }
}
__device__ __forceinline__ void load8(const float* p, uint16_t (&o)[8]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  o[0] = bf16_bits(a.x);
  o[1] = bf16_bits(a.y);
  o[2] = bf16_bits(a.z);
  o[3] = bf16_bits(a.w);
  o[4] = bf16_bits(b.x);
  o[5] = bf16_bits(b.y);
  o[6] = bf16_bits(b.z);
  o[7] = bf16_bits(b.w);
}
__device__ __forceinline__ uint16_t load1(const uint16_t* p) { return *p; }
__device__ __forceinline__ uint16_t load1(const float* p) {
  return bf16_bits(*p);
}

// A thread's share of one R x C tile copy (C the contiguous dimension in
// device memory), 8 values a chunk, held in registers as packed bf16
// between the loads from device memory and the stores to shared memory, so
// that the next stage's loads are in flight while this stage's products
// run. Shared memory keeps the device layout: value (r, c) at
// dst[r * SK + c]. The threads of a warp walk along c: coalesced loads,
// 16-byte stores.
template <int R, int C>
struct TileRegs {
  static constexpr int CH = C / 8, N = R * CH;
  static_assert(CH * 8 == C && N % THREADS == 0, "tile shape");
  static constexpr int PER = N / THREADS;
  uint32_t w[PER][4];
};

// Load the tile at src (row stride ld, a multiple of 8 values, the base
// 16-byte aligned; rows_ok x cols_ok of it in range) into registers as
// bf16, zero filling the rest.
template <int R, int C, class T>
__device__ __forceinline__ void tile_load(TileRegs<R, C>& regs, const T* src,
                                          int ld, int rows_ok, int cols_ok) {
#pragma unroll
  for (int i = 0; i < TileRegs<R, C>::PER; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / (C / 8), c = (e % (C / 8)) * 8;
    uint16_t o[8];
    if (r < rows_ok && c + 8 <= cols_ok) {
      load8(src + (size_t)r * ld + c, o);
    } else {
#pragma unroll
      for (int q = 0; q < 8; ++q)
        o[q] = (r < rows_ok && c + q < cols_ok)
                   ? load1(src + (size_t)r * ld + c + q)
                   : static_cast<uint16_t>(0);
    }
#pragma unroll
    for (int q = 0; q < 4; ++q)
      regs.w[i][q] = o[2 * q] | (static_cast<uint32_t>(o[2 * q + 1]) << 16);
  }
}

template <int R, int C>
__device__ __forceinline__ void tile_store(uint16_t* dst,
                                           const TileRegs<R, C>& regs) {
#pragma unroll
  for (int i = 0; i < TileRegs<R, C>::PER; ++i) {
    const int e = threadIdx.x + i * THREADS;
    const int r = e / (C / 8), c = (e % (C / 8)) * 8;
    *reinterpret_cast<uint4*>(dst + r * SK + c) =
        make_uint4(regs.w[i][0], regs.w[i][1], regs.w[i][2], regs.w[i][3]);
  }
}

// d += a b for one m16n8k16 bf16 product, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += sA sB^T over one BK-deep stage. sA holds the block's BM rows of A
// and sB its BN columns of B, both [row][k]. Warp w owns rows
// 32 (w / 2) .. +31 and columns 32 (w % 2) .. +31: acc[mi][ni][0..1] are
// (row mi*16 + g, columns ni*8 + 2t, +1) of it and [2..3] row + 8.
__device__ __forceinline__ void tile_mma(const uint16_t* sA,
                                         const uint16_t* sB,
                                         float (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int mi = 0; mi < 2; ++mi) {
      const uint16_t* p = sA + (wm + mi * 16 + g) * SK + kk + 2 * t;
      a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
      a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * SK);
      a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
      a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * SK + 8);
    }
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const uint16_t* q = sB + (wn + ni * 8 + g) * SK + kk + 2 * t;
      b[ni][0] = *reinterpret_cast<const uint32_t*>(q);
      b[ni][1] = *reinterpret_cast<const uint32_t*>(q + 8);
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// Four 8 x 8 b16 matrices from shared memory, transposed: lane L gives
// the address of row L % 8 of matrix L / 8, and register i of every lane
// holds two values of matrix i from consecutive rows of one column.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&d)[4],
                                              const uint16_t* p) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
      : "r"(a));
}

// tile_mma for tiles stored k-major, sA[k * SK + m] and sB[k * SK + n] (the
// weight gradients' activations and cotangents, as they lie in device
// memory): the fragments come from ldmatrix.trans.
__device__ __forceinline__ void tile_mma_kmajor(const uint16_t* sA,
                                                const uint16_t* sB,
                                                float (&acc)[2][4][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
  const int lr = lane & 7, lm = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < BK; kk += 16) {
    uint32_t a[2][4], b[4][2];
    // A matrices: (k 0-7, m 0-7), (k 0-7, m 8-15), (k 8-15, m 0-7),
    // (k 8-15, m 8-15) -- the a0..a7 register order of m16n8k16
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
      ldsm_x4_trans(a[mi], sA + (kk + lr + 8 * (lm >> 1)) * SK + wm +
                               mi * 16 + 8 * (lm & 1));
    // B matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15),
    // (k 8-15, n 8-15): b0b1, b2b3 of two n8 blocks
#pragma unroll
    for (int nb = 0; nb < 2; ++nb) {
      uint32_t r[4];
      ldsm_x4_trans(r, sB + (kk + lr + 8 * (lm & 1)) * SK + wn + nb * 16 +
                           8 * (lm >> 1));
      b[2 * nb][0] = r[0];
      b[2 * nb][1] = r[1];
      b[2 * nb + 1][0] = r[2];
      b[2 * nb + 1][1] = r[3];
    }
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
        mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
  }
}

// Activation derivative, in f32, from the bf16 activation OUTPUT h.
__device__ __forceinline__ float act_deriv(int act, float h) {
  if (act == ACT_TANH) return 1.f - h * h;
  if (act == ACT_RELU) return h > 0.f ? 1.f : 0.f;
  return h > 0.f ? 1.f : h + 1.f;  // elu
}

// ---- phase A ----------------------------------------------------------
struct SweepArgs {
  int M, N;
  const void* A1; int lda1; int K1;      // bf16, or f32 with A1_F32
  const uint16_t* B1; int ldb1;          // (N, K1), k contiguous
  const float* A2; int lda2; int K2;     // optional, f32
  const uint16_t* B2; int ldb2;          // (N, K2), k contiguous
  const float* bias; int epi; int act;
  const uint16_t* H; int ldh;            // the epilogue's activation
  const float* wn; const float* mvec;
  float* C; int ldc;
};

// C[M, N] = A1 @ B1^T [+ A2 @ B2^T] + bias, then the epilogue:
//   EPI_DERIV:  C *= act'(H)            (tangent forward / backward dgrad)
//   EPI_FISHER: C *= wn[row] * m[col]   (the dist-space Fisher weighting)
// Every A value is rounded to bf16 as it is loaded.
template <bool A1_F32>
__global__ void __launch_bounds__(THREADS)
    fvp16_sweep_kernel(const __grid_constant__ SweepArgs p) {
  // two shared-memory stages: stage kt+1 is stored while kt's products
  // run out of the other
  __shared__ __align__(16) uint16_t sA[2][BM * SK];
  __shared__ __align__(16) uint16_t sB[2][BN * SK];
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int nk1 = cdiv(p.K1, BK);
  const int nk = nk1 + (p.A2 != nullptr ? cdiv(p.K2, BK) : 0);
  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  TileRegs<BM, BK> ra;
  TileRegs<BN, BK> rb;
  auto fetch = [&](int kt) {
    if (kt < nk1) {
      const int k0 = kt * BK;
      if (A1_F32)
        tile_load<BM, BK>(
            ra, static_cast<const float*>(p.A1) + (size_t)row0 * p.lda1 + k0,
            p.lda1, p.M - row0, p.K1 - k0);
      else
        tile_load<BM, BK>(
            ra,
            static_cast<const uint16_t*>(p.A1) + (size_t)row0 * p.lda1 + k0,
            p.lda1, p.M - row0, p.K1 - k0);
      tile_load<BN, BK>(rb, p.B1 + (size_t)col0 * p.ldb1 + k0, p.ldb1,
                        p.N - col0, p.K1 - k0);
    } else {
      const int k0 = (kt - nk1) * BK;
      tile_load<BM, BK>(ra, p.A2 + (size_t)row0 * p.lda2 + k0, p.lda2,
                        p.M - row0, p.K2 - k0);
      tile_load<BN, BK>(rb, p.B2 + (size_t)col0 * p.ldb2 + k0, p.ldb2,
                        p.N - col0, p.K2 - k0);
    }
  };
  auto store = [&](int buf) {
    tile_store<BM, BK>(sA[buf], ra);
    tile_store<BN, BK>(sB[buf], rb);
  };
  if (nk > 0) {
    fetch(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) fetch(kt + 1);
    tile_mma(sA[kt & 1], sB[kt & 1], acc);
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }

  // the epilogue: the accumulators go through shared memory (the spent
  // A stages) so that each thread then reads H and writes C four
  // consecutive columns at a time
  constexpr int SC = BN + 4;
  static_assert(BM * SC * 4 <= (int)sizeof(sA), "epilogue tile");
  float* sC = reinterpret_cast<float*>(&sA[0][0]);
  {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
    const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int half = 0; half < 2; ++half)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni)
          *reinterpret_cast<float2*>(
              sC + (wm + mi * 16 + g + half * 8) * SC + wn + ni * 8 + 2 * t) =
              make_float2(acc[mi][ni][half * 2], acc[mi][ni][half * 2 + 1]);
  }
  __syncthreads();
  for (int e = threadIdx.x; e < BM * (BN / 4); e += THREADS) {
    const int rr = e / (BN / 4), cc = (e % (BN / 4)) * 4;
    const int r = row0 + rr, c = col0 + cc;
    if (r >= p.M || c >= p.N) continue;
    const int nq = min(4, p.N - c);
    const float rw = p.epi == EPI_FISHER ? p.wn[r] : 0.f;
    float v[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      if (q >= nq) break;
      v[q] = sC[rr * SC + cc + q] + (p.bias != nullptr ? p.bias[c + q] : 0.f);
      if (p.epi == EPI_FISHER)
        v[q] *= rw * p.mvec[c + q];
      else
        v[q] *= act_deriv(p.act, bf16_float(p.H[(size_t)r * p.ldh + c + q]));
    }
    float* out = p.C + (size_t)r * p.ldc + c;
    if (nq == 4) {
      *reinterpret_cast<float4*>(out) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      for (int q = 0; q < nq; ++q) out[q] = v[q];
    }
  }
}

// ---- phase B ----------------------------------------------------------
struct WgradLayer {
  const uint16_t* A; int lda; int kin;  // activations (rows, kin), bf16
  const float* G; int ldg; int n;       // cotangents (rows, n), f32
  int out;                              // offset of [b; W] in a partial row
  int tiles_j, first_tile;
};
struct WgradArgs {
  WgradLayer layer[MAX_LAYERS];
  int n_layers, n_tiles, rows, rows_per_split;
  float* partial;  // (splits, P)
  long long P;
};

// One (layer, i tile, j tile) of one row split:
//   partial[s][out + (1 + i) * n + j] = sum_{r in split} A[r][i] * bf16(G[r][j])
// Grid: n_tiles x splits, split-major.
__global__ void __launch_bounds__(THREADS)
    fvp16_wgrad_kernel(const __grid_constant__ WgradArgs p) {
  __shared__ __align__(16) uint16_t sA[2][BM * SK];
  __shared__ __align__(16) uint16_t sB[2][BN * SK];
  const int split = blockIdx.x / p.n_tiles;
  const int tile = blockIdx.x % p.n_tiles;
  int l = 0;
  while (l + 1 < p.n_layers && tile >= p.layer[l + 1].first_tile) ++l;
  const WgradLayer& L = p.layer[l];
  const int local = tile - L.first_tile;
  const int i0 = (local / L.tiles_j) * BM, j0 = (local % L.tiles_j) * BN;
  const int rbeg = split * p.rows_per_split;
  const int rend = min(rbeg + p.rows_per_split, p.rows);
  const int nk = rend > rbeg ? cdiv(rend - rbeg, BK) : 0;

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[mi][ni][q] = 0.f;

  TileRegs<BK, BM> ra;
  TileRegs<BK, BN> rb;
  auto fetch = [&](int kt) {
    const int r0 = rbeg + kt * BK;
    tile_load<BK, BM>(ra, L.A + (size_t)r0 * L.lda + i0, L.lda, rend - r0,
                      L.kin - i0);
    tile_load<BK, BN>(rb, L.G + (size_t)r0 * L.ldg + j0, L.ldg, rend - r0,
                      L.n - j0);
  };
  auto store = [&](int buf) {
    tile_store<BK, BM>(sA[buf], ra);
    tile_store<BK, BN>(sB[buf], rb);
  };
  if (nk > 0) {
    fetch(0);
    store(0);
  }
  __syncthreads();
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) fetch(kt + 1);
    tile_mma_kmajor(sA[kt & 1], sB[kt & 1], acc);
    if (kt + 1 < nk) store((kt + 1) & 1);
    __syncthreads();
  }

  float* out = p.partial + (long long)split * p.P + L.out;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int i = i0 + wm + mi * 16 + g + half * 8;
      if (i >= L.kin) continue;
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int j = j0 + wn + ni * 8 + 2 * t + q;
          if (j < L.n)
            out[(size_t)(1 + i) * L.n + j] = acc[mi][ni][half * 2 + q];
        }
    }
}

// The bias cotangents: partial[s][out + j] = sum_{r in split} G[r][j] over
// the unrounded f32 G, in a fixed order (8 row lanes, then the lanes in
// order). Block: 32 columns x 8 row lanes; grid: column blocks x splits.
struct ColsumArgs {
  const float* G[MAX_LAYERS];
  int ldg[MAX_LAYERS], n[MAX_LAYERS], out[MAX_LAYERS];
  int first_block[MAX_LAYERS + 1];
  int n_layers, rows, rows_per_split;
  float* partial;
  long long P;
};

__global__ void __launch_bounds__(256)
    fvp16_colsum_kernel(const __grid_constant__ ColsumArgs p) {
  __shared__ float red[8][32];
  const int lane = threadIdx.x & 31, rl = threadIdx.x >> 5;
  const int split = blockIdx.y;
  int l = 0;
  while (l + 1 < p.n_layers && (int)blockIdx.x >= p.first_block[l + 1]) ++l;
  const int j = (blockIdx.x - p.first_block[l]) * 32 + lane;
  const int rbeg = split * p.rows_per_split;
  const int rend = min(rbeg + p.rows_per_split, p.rows);
  const float* G = p.G[l];
  float s = 0.f;
  if (j < p.n[l])
    for (int r = rbeg + rl; r < rend; r += 8) s += G[(size_t)r * p.ldg[l] + j];
  red[rl][lane] = s;
  __syncthreads();
  if (rl == 0 && j < p.n[l]) {
    float total = red[0][lane];
#pragma unroll
    for (int k = 1; k < 8; ++k) total += red[k][lane];
    p.partial[(long long)split * p.P + p.out[l] + j] = total;
  }
}

// Each weight-tangent block V_l of the flat f32 v (row-major (rows, cols)
// at v + off[l]) rounded to bf16 and written transposed, (cols, rows), into
// a buffer of row stride ld: the sweeps read it k contiguous.
struct UnpackArgs {
  const float* v;
  uint16_t* dst[MAX_LAYERS];
  long long off[MAX_LAYERS];
  int cols[MAX_LAYERS], ld[MAX_LAYERS];
  int start[MAX_LAYERS + 1];
  int n_layers;
};

__global__ void fvp16_unpack_kernel(const __grid_constant__ UnpackArgs p) {
  const int total = p.start[p.n_layers];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int l = 0;
    while (i >= p.start[l + 1]) ++l;
    const int j = i - p.start[l];
    const int r = j / p.cols[l], c = j - r * p.cols[l];
    p.dst[l][(size_t)c * p.ld[l] + r] = bf16_bits(p.v[p.off[l] + j]);
  }
}

}  // namespace

// One sweep product (see fvp16_sweep_kernel). a1_f32: A1 is f32 (rounded
// on load), else bf16. Returns the launch's error.
extern "C" int trpo_fvp16_sweep(
    int M, int N, const void* A1, int a1_f32, int lda1, int K1,
    const uint16_t* B1, int ldb1, const float* A2, int lda2, int K2,
    const uint16_t* B2, int ldb2, const float* bias, int epi, int act,
    const uint16_t* H, int ldh, const float* wn, const float* mvec, float* C,
    int ldc, cudaStream_t stream) {
  const SweepArgs a{M,  N,    A1,   lda1, K1,  B1, ldb1, A2,   lda2, K2, B2,
                    ldb2, bias, epi, act,  H,  ldh, wn,  mvec, C,    ldc};
  const dim3 grid(cdiv(N, BN), cdiv(M, BM));
  if (a1_f32)
    fvp16_sweep_kernel<true><<<grid, THREADS, 0, stream>>>(a);
  else
    fvp16_sweep_kernel<false><<<grid, THREADS, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Every layer's weight gradients (one launch) and bias cotangents (one
// launch) into the split partials. Per-layer arrays of n_layers entries;
// out_off[l] is the offset of layer l's [b; W] in a partial row of P
// floats. Returns the first launch error.
extern "C" int trpo_fvp16_wgrad(int n_layers, const uint16_t* const* A,
                                const int* lda, const int* kin,
                                const float* const* G, const int* ldg,
                                const int* n, const int* out_off, int rows,
                                int rows_per_split, int splits,
                                float* partial, long long P,
                                cudaStream_t stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return cudaErrorInvalidValue;
  WgradArgs a{};
  ColsumArgs c{};
  int tiles = 0, blocks = 0;
  for (int l = 0; l < n_layers; ++l) {
    WgradLayer& L = a.layer[l];
    L.A = A[l];
    L.lda = lda[l];
    L.kin = kin[l];
    L.G = G[l];
    L.ldg = ldg[l];
    L.n = n[l];
    L.out = out_off[l];
    L.tiles_j = cdiv(n[l], BN);
    L.first_tile = tiles;
    tiles += cdiv(kin[l], BM) * L.tiles_j;
    c.G[l] = G[l];
    c.ldg[l] = ldg[l];
    c.n[l] = n[l];
    c.out[l] = out_off[l];
    c.first_block[l] = blocks;
    blocks += cdiv(n[l], 32);
  }
  c.first_block[n_layers] = blocks;
  a.n_layers = c.n_layers = n_layers;
  a.n_tiles = tiles;
  a.rows = c.rows = rows;
  a.rows_per_split = c.rows_per_split = rows_per_split;
  a.partial = c.partial = partial;
  a.P = c.P = P;
  fvp16_wgrad_kernel<<<tiles * splits, THREADS, 0, stream>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  fvp16_colsum_kernel<<<dim3(blocks, splits), 256, 0, stream>>>(c);
  return static_cast<int>(cudaGetLastError());
}

// Per-layer arrays of n_layers entries (see UnpackArgs). Returns the
// launch's error.
extern "C" int trpo_fvp16_unpack(int n_layers, const float* v,
                                 uint16_t* const* dst, const long long* off,
                                 const int* rows, const int* cols,
                                 const int* ld, cudaStream_t stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return cudaErrorInvalidValue;
  UnpackArgs a{};
  a.v = v;
  a.n_layers = n_layers;
  for (int l = 0; l < n_layers; ++l) {
    a.dst[l] = dst[l];
    a.off[l] = off[l];
    a.cols[l] = cols[l];
    a.ld[l] = ld[l];
    a.start[l + 1] = a.start[l] + rows[l] * cols[l];
  }
  const int threads = 256;
  int blocks = cdiv(a.start[n_layers], threads);
  blocks = blocks < 1024 ? blocks : 1024;
  fvp16_unpack_kernel<<<blocks, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
