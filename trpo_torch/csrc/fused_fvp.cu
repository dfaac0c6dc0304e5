// Damped Gauss-Newton Fisher-vector product (F + lambda I) v = J^T M J v +
// lambda v for a plain-MLP diagonal-Gaussian policy, f32-accurate products
// on Hopper's tensor cores (3xTF32 on wgmma).
//
// Replaces: trpo_tpu/ops/fused_fvp.py, make_fused_gaussian_mlp_fvp (:298),
// kernel body _fvp_kernel (:150-229), pallas_call at :407.
//
// Bound on the H100 SXM: operations. At the training shape (37,536 rows,
// 376 -> 256 -> 256 -> 17) the operator does 35.44 GFLOP of products.
// A single TF32 pass keeps ~10 mantissa bits and misses the reference's
// 1e-5 operator tolerance, so every product is 3xTF32: each f32 operand is
// split into hi (x rounded to TF32) and lo = x - hi, and the tensor cores
// accumulate lo*hi + hi*lo + hi*hi in f32 (relative error near 2^-22).
// That is 3 x 35.44 GFLOP at 495 TFLOP/s dense TF32 = 0.215 ms, against
// ~135 MB of compulsory bytes (obs, the two stored activations, v and the
// result) = 0.040 ms at 3.35 TB/s. (On the f32 CUDA cores the same work
// would be bounded at 0.529 ms.)
//
// Design. The TPU kernel accumulates the parameter cotangents into its
// outputs across a SEQUENTIAL grid; Hopper blocks run in parallel, and a
// per-block copy of the 166.7k-float cotangent would be hundreds of MB. So
// the operator is two deterministic phases, no float atomics:
//   (A) row-parallel sweeps (fvp_sweep_kernel, one launch per product):
//       the tangent forward (times the activation derivative, read from
//       the stored activation), the Fisher weighting
//       c = d_mean * w_n * exp(-2 log_std), and the backward dgrad chain,
//       each a GEMM with a fused epilogue, writing the per-row
//       pre-activation cotangents g_k and c to scratch;
//   (B) parameter-parallel weight gradients (fvp_wgrad_kernel, ONE launch
//       over a tile list of every layer): each block owns a tile of one
//       layer's W cotangent and a fixed slice of rows (split-K, the split
//       count sized to fill the card once); the blocks of a layer's first
//       row tile also sum the bias cotangent from the G values they split.
//       fvp_reduce_kernel adds the slices in a fixed order plus lambda v,
//       and writes the log_std block's closed form, so the result is
//       bitwise reproducible from call to call.
// Every product is wgmma.m64nNk8.tf32 (N = 128, or 24 for the action-width
// outputs): a block is two warpgroups over a 128 x N tile, BK = 32 per
// stage. A comes from registers, so each thread loads its fragments from
// the raw tile as it lies in device memory (row-major activations, or
// their transpose for the weight gradients) and splits them there. wgmma
// takes TF32 B only K-major from shared memory, so each stage's raw B tile
// ((in, out) weights, tangents or cotangents: N-major) is split once by
// the block into hi and lo halves laid out as K-major core matrices. The
// split and the copies of the next stages run while the current stage's
// wgmma does (two raw cp.async slots, two split buffers). Operands reach
// the kernel 16-byte aligned with row strides of a multiple of 4 floats:
// the fixed weights (and obs, h_k where their widths need it) are padded
// copies made once per operator build, and fvp_unpack_kernel copies the
// tangent blocks of v into aligned buffers at the start of each call
// (0.16M floats), so each tile copy is a fixed set of 16-byte cp.async a
// thread. Ragged edges are zero-filled by the copies and masked in the
// epilogues, so any width works.
//
// Bytes per call of this design at the training shape: phase A re-reads
// obs/h_k and writes t_k, g_k and c (~562 MB), phase B reads them once more
// and writes and reads the split partials (~230 MB): ~0.24 ms at
// 3.35 TB/s, above the bound for operations. Keeping t_k/g_k on chip (a
// row-tile-resident phase A) is the step that removes most of it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BK = 32;
constexpr int THREADS = 256;  // two warpgroups
constexpr int MAX_LAYERS = 8;

enum { ACT_TANH = 0, ACT_RELU = 1, ACT_ELU = 2 };
enum { EPI_DERIV = 0, EPI_FISHER = 1 };

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// The least stride >= n with stride % 32 == r (floats).
constexpr int padded(int n, int r) { return n + ((r - n % 32) + 32) % 32; }

// A block is two warpgroups; warpgroup w owns rows 64w..64w+63 of the
// block's 128-row tile and all BN columns.
template <int BN_, int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = 128, BN = BN_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;  // resident per SM
  static constexpr int NACC = BN / 2;  // f32 accumulators per thread
  // Row strides in floats of the raw tiles. A stored [m][k] (sweeps): 4
  // mod 32, A stored [k][m] (weight gradients) and B stored [k][n]: 8 mod
  // 32, so that the 32 lanes of every fragment load hit 32 different banks.
  static constexpr int SA_K = padded(BK, 4);
  static constexpr int SA_M = padded(BM, 8);
  static constexpr int SB = padded(BN, 8);
  static constexpr int STAGE_SWEEP = BM * SA_K + BK * SB;  // floats
  static constexpr int STAGE_WGRAD = BK * SA_M + BK * SB;
  static constexpr int SPLIT = BN * BK;  // floats of B's hi (and lo) half
};
using Wide = Tile<128, 1>;   // outputs wider than 24
using Narrow = Tile<24, 2>;  // the action-width outputs

// ---- PTX helpers ------------------------------------------------------
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// x = hi + lo to ~2^-22 relative. hi is x rounded to TF32 (10 mantissa
// bits) to nearest, ties away from zero -- the rounding of
// cvt.rna.tf32.f32, done as two full-rate integer ops on the bit pattern.
// lo = x - hi is exact in f32; the tensor cores read its top 19 bits,
// which keeps lo to 2^-11 of itself, i.e. x to ~2^-22.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// ---- wgmma helpers ----------------------------------------------------
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ void fence_regs(uint32_t (&r)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// B's hi and lo halves lie in shared memory as wgmma's K-major core
// matrices, 8 n-rows x 4 k (16 bytes a row): element (n, k) of a BN x BK
// half at (n/8)*CORE_SBO + (k/4)*CORE_LBO + (n%8)*4 + k%4 floats.
constexpr int CORE_LBO = 32;             // floats: the next 4 k
constexpr int CORE_SBO = (BK / 4) * 32;  // floats: the next 8 n

// The shared-memory matrix descriptor of such a half from its first k
// (no swizzle; leading and stride byte offsets in 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)(4 * CORE_LBO >> 4) << 16) |
         ((uint64_t)(4 * CORE_SBO >> 4) << 32);
}

// d (+)= a b for a warpgroup: m64nBNk8 on the tensor cores, A (TF32, four
// registers a thread, mma.sync's m16n8k8 layout per warp) from registers,
// B from shared memory, f32 accumulators (d[4i..4i+3]: rows g and g+8,
// columns 8i + 2t, +1 of the warp's 16 rows). scale_d = 0 overwrites d.
template <int BN>
__device__ __forceinline__ void wgmma_tf32(float (&d)[BN / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc, int scale_d);
template <>
__device__ __forceinline__ void wgmma_tf32<128>(float (&d)[64],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}
template <>
__device__ __forceinline__ void wgmma_tf32<24>(float (&d)[12],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %17, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n24k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11}, "
      "{%12, %13, %14, %15}, %16, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// Activation derivative from the activation OUTPUT h (what is stored).
__device__ __forceinline__ float act_deriv(int act, float h) {
  if (act == ACT_TANH) return 1.f - h * h;
  if (act == ACT_RELU) return h > 0.f ? 1.f : 0.f;
  return h > 0.f ? 1.f : h + 1.f;  // elu
}

// Copy the R x C tile at src (row stride ld; rows_ok x cols_ok of it in
// range) into shared memory with row stride S, zero filling the rest, in
// 16-byte copies: every operand starts on a 16-byte boundary and has a
// row stride that is a multiple of 4 floats (the wrapper pads them). Each
// thread's copies are fixed at compile time; a tile wholly in range skips
// the edge arithmetic.
template <int R, int C>
__device__ __forceinline__ void load_tile(float* sm, int S, const float* src,
                                          int ld, int rows_ok, int cols_ok) {
  constexpr int CH = C / 4, N = R * CH;
  static_assert(CH * 4 == C, "tile width");
  const bool full = rows_ok >= R && cols_ok >= C;
#pragma unroll
  for (int i = 0; i < (N + THREADS - 1) / THREADS; ++i) {
    const int e = threadIdx.x + i * THREADS;
    if (N % THREADS != 0 && e >= N) break;
    const int r = e / CH, c = (e % CH) * 4;
    int n = 4;
    if (!full) n = r < rows_ok ? min(max(cols_ok - c, 0), 4) : 0;
    cp_async16(sm + r * S + c, n ? src + r * ld + c : src, 4 * n);
  }
}

// ---- the block's products ---------------------------------------------
// B's part of a stage (BN x BK raw values stored [k][n], stride SB) split
// into its hi and lo core-matrix halves. With do_bias, also adds the values
// into bsum: the bias cotangent of the weight gradients (a thread's column
// n is the same in every stage).
template <class T>
__device__ __forceinline__ void split_b(const float* sB, float* hi_out,
                                        float* lo_out, float& bsum,
                                        bool do_bias) {
  constexpr int ITEMS = T::BN * (BK / 4);
#pragma unroll 1
  for (int i = 0; i < (ITEMS + THREADS - 1) / THREADS; ++i) {
    const int item = threadIdx.x + i * THREADS;
    if (ITEMS % THREADS != 0 && item >= ITEMS) break;
    const int n = item % T::BN, kg = item / T::BN;
    float x[4];
    uint32_t hi[4], lo[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      x[q] = sB[(kg * 4 + q) * T::SB + n];
      split_tf32(x[q], hi[q], lo[q]);
    }
    if (do_bias) bsum += (x[0] + x[1]) + (x[2] + x[3]);
    const int off = (n >> 3) * CORE_SBO + kg * CORE_LBO + (n & 7) * 4;
    *reinterpret_cast<uint4*>(hi_out + off) =
        make_uint4(hi[0], hi[1], hi[2], hi[3]);
    *reinterpret_cast<uint4*>(lo_out + off) =
        make_uint4(lo[0], lo[1], lo[2], lo[3]);
  }
}

// A thread's A fragments of a stage (stored [k][m], stride SA_M, when
// A_MMAJOR, else [m][k], stride SA_K), split into hi and lo registers.
template <class T, bool A_MMAJOR>
__device__ __forceinline__ void a_frags(const float* sA,
                                        uint32_t (&ahi)[BK / 8][4],
                                        uint32_t (&alo)[BK / 8][4]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int m = (warp >> 2) * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const int k = kk * 8;
    float a[4];
    if (A_MMAJOR) {
      const float* col = sA + (k + t) * T::SA_M + m;
      a[0] = col[0];
      a[1] = col[8];
      a[2] = col[4 * T::SA_M];
      a[3] = col[4 * T::SA_M + 8];
    } else {
      const float* row = sA + m * T::SA_K + k + t;
      a[0] = row[0];
      a[1] = row[8 * T::SA_K];
      a[2] = row[4];
      a[3] = row[8 * T::SA_K + 4];
    }
#pragma unroll
    for (int q = 0; q < 4; ++q) split_tf32(a[q], ahi[kk][q], alo[kk][q]);
  }
}

// A stage's products on the warpgroup's tensor cores, into fresh
// accumulators d: per k8 the two small cross terms first, lo_a hi_b and
// hi_a lo_b, then hi_a hi_b.
template <class T>
__device__ __forceinline__ void issue_stage(float (&d)[T::NACC],
                                            uint32_t (&ahi)[BK / 8][4],
                                            uint32_t (&alo)[BK / 8][4],
                                            const float* bhi,
                                            const float* blo) {
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    fence_regs(ahi[kk]);
    fence_regs(alo[kk]);
  }
  fence_regs(d);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BK / 8; ++kk) {
    const uint64_t dhi = smem_desc(bhi + kk * 2 * CORE_LBO);
    const uint64_t dlo = smem_desc(blo + kk * 2 * CORE_LBO);
    wgmma_tf32<T::BN>(d, alo[kk], dhi, kk > 0 ? 1 : 0);
    wgmma_tf32<T::BN>(d, ahi[kk], dlo, 1);
    wgmma_tf32<T::BN>(d, ahi[kk], dhi, 1);
  }
  wgmma_commit();
}

// acc += the block's 3xTF32 products over nk BK-deep stages. Two raw
// slots of STAGE floats (A at the start, B at A_SIZE) take the cp.async
// copies, load(kt) issuing stage kt's into slot kt % 2; split holds two
// buffers of 2 * SPLIT floats (B's hi, then lo). While stage k's wgmma
// runs, the threads issue stage k+2's copies and split stage k+1's B into
// the other buffer; then they wait for stage k, add it into acc and load
// stage k+1's A fragments.
//
// The tensor cores' f32 accumulation truncates; left to run over hundreds
// of k-steps it biases a long sum by ~1e-5. So a stage's products go into
// fresh accumulators, which are added to acc by rounded f32 adds: the
// truncation then acts on 12 products at a time.
template <class T, bool A_MMAJOR, int STAGE, int A_SIZE, class Load>
__device__ __forceinline__ void wg_mainloop(int nk, const Load& load,
                                            float* smem, float* split,
                                            float (&acc)[T::NACC],
                                            float& bsum, bool do_bias) {
  float d[T::NACC];
  uint32_t ahi[BK / 8][4], alo[BK / 8][4];
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) d[i] = 0.f;
  if (nk <= 0) {
    cp_async_commit();
    cp_async_wait<0>();
    return;
  }
  load(0);
  cp_async_commit();
  if (1 < nk) load(1);
  cp_async_commit();
  cp_async_wait<1>();
  __syncthreads();
  split_b<T>(smem + A_SIZE, split, split + T::SPLIT, bsum, do_bias);
  a_frags<T, A_MMAJOR>(smem, ahi, alo);
  fence_proxy_async();
  __syncthreads();
  issue_stage<T>(d, ahi, alo, split, split + T::SPLIT);
  for (int kt = 0; kt < nk; ++kt) {
    // stage kt's products run; its raw slot is free
    if (kt + 2 < nk) load(kt + 2);
    cp_async_commit();
    const bool next = kt + 1 < nk;
    float* nbuf = split + ((kt + 1) & 1) * 2 * T::SPLIT;
    const float* nraw = smem + ((kt + 1) & 1) * STAGE;
    if (next) {
      cp_async_wait<1>();
      __syncthreads();
      split_b<T>(nraw + A_SIZE, nbuf, nbuf + T::SPLIT, bsum, do_bias);
    }
    wgmma_wait_all();
    fence_regs(d);
#pragma unroll
    for (int i = 0; i < T::NACC; ++i) acc[i] += d[i];
    if (next) {
      a_frags<T, A_MMAJOR>(nraw, ahi, alo);
      fence_proxy_async();
      __syncthreads();
      issue_stage<T>(d, ahi, alo, nbuf, nbuf + T::SPLIT);
    }
  }
  cp_async_wait<0>();
}

// ---- phase A ----------------------------------------------------------
struct SweepArgs {
  int M, N;
  const float* A1; int lda1; int K1; const float* B1; int ldb1;
  const float* A2; int lda2; int K2; const float* B2; int ldb2;
  const float* bias; int epi; int act;
  const float* H; int ldh; const float* wn; const float* mvec;
  float* C; int ldc;
};

// C[M, N] = A1 @ B1 [+ A2 @ B2] + bias, then the epilogue:
//   EPI_DERIV:  C *= act'(H)            (tangent forward / backward dgrad)
//   EPI_FISHER: C *= wn[row] * m[col]   (the dist-space Fisher weighting)
// A_i (M, K_i) row-major; B_i (K_i, N) row-major.
template <class T>
__global__ void __launch_bounds__(THREADS, T::MIN_BLOCKS)
    fvp_sweep_kernel(const __grid_constant__ SweepArgs p) {
  extern __shared__ __align__(128) float smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row0 = blockIdx.y * T::BM, col0 = blockIdx.x * T::BN;
  const int nk1 = p.K1 > 0 ? cdiv(p.K1, BK) : 0;
  const int nk = nk1 + (p.A2 != nullptr && p.K2 > 0 ? cdiv(p.K2, BK) : 0);
  // shared memory: two raw slots, two split buffers, the activation tile
  float* sbuf = smem + 2 * T::STAGE_SWEEP;
  float* sH = sbuf + 4 * T::SPLIT;

  auto load = [&](int kt) {
    float* sA = smem + (kt & 1) * T::STAGE_SWEEP;
    float* sB = sA + T::BM * T::SA_K;
    const bool two = kt >= nk1;
    const int k0 = (two ? kt - nk1 : kt) * BK;
    const float* A = two ? p.A2 : p.A1;
    const float* B = two ? p.B2 : p.B1;
    const int lda = two ? p.lda2 : p.lda1, ldb = two ? p.ldb2 : p.ldb1;
    const int K = two ? p.K2 : p.K1;
    load_tile<T::BM, BK>(sA, T::SA_K, A + (size_t)row0 * lda + k0, lda,
                         p.M - row0, K - k0);
    load_tile<BK, T::BN>(sB, T::SB, B + (size_t)k0 * ldb + col0, ldb, K - k0,
                         p.N - col0);
  };

  float acc[T::NACC], unused = 0.f;
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;

  // The epilogue's activation tile streams in with the first stage.
  const float* Ht = p.H + (size_t)row0 * p.ldh + col0;
  const bool deriv = p.epi == EPI_DERIV;
  if (deriv) load_tile<T::BM, T::BN>(sH, T::SB, Ht, p.ldh, p.M - row0,
                                     p.N - col0);
  wg_mainloop<T, false, T::STAGE_SWEEP, T::BM * T::SA_K>(
      nk, load, smem, sbuf, acc, unused, false);
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  const bool pair_ok = (p.ldc & 1) == 0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int rt = (warp >> 2) * 64 + (warp & 3) * 16 + g + half * 8;
    const int r = row0 + rt;
    if (r >= p.M) continue;
    const float rw = p.epi == EPI_FISHER ? p.wn[r] : 0.f;
#pragma unroll
    for (int ni = 0; ni < T::BN / 8; ++ni) {
      const int c = col0 + ni * 8 + 2 * t;
      if (c >= p.N) continue;
      float v[2];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int cc = c + q < p.N ? c + q : c;
        v[q] = acc[ni * 4 + half * 2 + q] +
               (p.bias != nullptr ? p.bias[cc] : 0.f);
        if (p.epi == EPI_FISHER) v[q] *= rw * p.mvec[cc];
      }
      if (deriv) {
        const float* h = sH + rt * T::SB + (c - col0);
        v[0] *= act_deriv(p.act, h[0]);
        v[1] *= act_deriv(p.act, h[1]);
      }
      float* out = p.C + (size_t)r * p.ldc + c;
      if (pair_ok && c + 1 < p.N) {
        *reinterpret_cast<float2*>(out) = make_float2(v[0], v[1]);
      } else {
        out[0] = v[0];
        if (c + 1 < p.N) out[1] = v[1];
      }
    }
  }
}

// ---- phase B ----------------------------------------------------------
struct WgradLayer {
  const float* A; int lda; int kin;  // activations (rows, kin)
  const float* G; int ldg; int n;    // cotangents (rows, n)
  int out;                           // offset of [b; W] in a partial row
  int tiles_i, tiles_j, narrow, first_tile;
};
struct WgradArgs {
  WgradLayer layer[MAX_LAYERS];
  int n_layers, n_tiles, rows, rows_per_split;
  float* partial;  // (splits, P)
  long long P;
};

// One (layer, i tile, j tile) of one split:
//   partial[s][out + (1 + i) * n + j] = sum_{r in split} A[r][i] * G[r][j]
// and, with BIAS (the first i tile), partial[s][out + j] = sum_r G[r][j].
template <class T, bool BIAS>
__device__ __forceinline__ void wgrad_tile(const WgradArgs& p,
                                           const WgradLayer& L, int ti,
                                           int tj, int split, float* smem) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i0 = ti * T::BM, j0 = tj * T::BN;
  const int rbeg = split * p.rows_per_split;
  const int rend = min(rbeg + p.rows_per_split, p.rows);
  const int nk = rend > rbeg ? cdiv(rend - rbeg, BK) : 0;
  float* sbuf = smem + 2 * T::STAGE_WGRAD;

  auto load = [&](int kt) {
    float* sA = smem + (kt & 1) * T::STAGE_WGRAD;
    float* sB = sA + BK * T::SA_M;
    const int r0 = rbeg + kt * BK;
    load_tile<BK, T::BM>(sA, T::SA_M, L.A + (size_t)r0 * L.lda + i0, L.lda,
                         rend - r0, L.kin - i0);
    load_tile<BK, T::BN>(sB, T::SB, L.G + (size_t)r0 * L.ldg + j0, L.ldg,
                         rend - r0, L.n - j0);
  };

  float acc[T::NACC], bsum = 0.f;
#pragma unroll
  for (int i = 0; i < T::NACC; ++i) acc[i] = 0.f;
  wg_mainloop<T, true, T::STAGE_WGRAD, BK * T::SA_M>(nk, load, smem, sbuf,
                                                     acc, bsum, BIAS);

  float* out = p.partial + (long long)split * p.P + L.out;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = i0 + (warp >> 2) * 64 + (warp & 3) * 16 + g + half * 8;
    if (i >= L.kin) continue;
#pragma unroll
    for (int ni = 0; ni < T::BN / 8; ++ni)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int j = j0 + ni * 8 + 2 * t + q;
        if (j < L.n)
          out[(size_t)(1 + i) * L.n + j] = acc[ni * 4 + half * 2 + q];
      }
  }
  if (BIAS) {
    // the threads that split column n: n, n + BN, ... below the item count
    constexpr int ITEMS = T::BN * (BK / 4);
    constexpr int USED = ITEMS < THREADS ? ITEMS : THREADS;
    __syncthreads();
    smem[threadIdx.x] = bsum;
    __syncthreads();
    if (threadIdx.x < T::BN) {
      float s = 0.f;
      for (int k = threadIdx.x; k < USED; k += T::BN) s += smem[k];
      const int j = j0 + threadIdx.x;
      if (j < L.n) out[j] = s;
    }
  }
}

// Grid: n_tiles x splits, split-major so that consecutive blocks share
// the same rows of A and G in L2.
__global__ void __launch_bounds__(THREADS, 1) fvp_wgrad_kernel(
    const __grid_constant__ WgradArgs p) {
  extern __shared__ __align__(128) float smem[];
  const int split = blockIdx.x / p.n_tiles;
  const int tile = blockIdx.x % p.n_tiles;
  int l = 0;
  while (l + 1 < p.n_layers && tile >= p.layer[l + 1].first_tile) ++l;
  const WgradLayer& L = p.layer[l];
  const int local = tile - L.first_tile;
  const int ti = local / L.tiles_j, tj = local % L.tiles_j;
  // separate bodies for the bias tiles keep the others' registers free
  if (L.narrow) {
    if (ti == 0)
      wgrad_tile<Narrow, true>(p, L, ti, tj, split, smem);
    else
      wgrad_tile<Narrow, false>(p, L, ti, tj, split, smem);
  } else {
    if (ti == 0)
      wgrad_tile<Wide, true>(p, L, ti, tj, split, smem);
    else
      wgrad_tile<Wide, false>(p, L, ti, tj, split, smem);
  }
}

// out[p] = coef * v[p] for the log_std block (p < A), and
// out[p] = sum_{s < S} partial[s][p - A] + damping * v[p] after it, with
// coef and damping read from device memory (damping may be adapted on the
// device between updates). K1-bf16 (fused_fvp_bf16.cu) shares it.
__global__ void fvp_reduce_kernel(int A, int P, int S,
                                  const float* __restrict__ partial,
                                  const float* __restrict__ v,
                                  const float* __restrict__ coef,
                                  const float* __restrict__ damping,
                                  float* __restrict__ out) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < A + P;
       i += gridDim.x * blockDim.x) {
    if (i < A) {
      out[i] = coef[0] * v[i];
      continue;
    }
    const int q = i - A;
    float s = 0.f;
    for (int k = 0; k < S; ++k) s += partial[(size_t)k * P + q];
    out[i] = s + damping[0] * v[i];
  }
}

// Each tangent block V_l of the flat v (row-major (rows, cols) at v +
// off[l]) copied into a 16-byte-aligned buffer of row stride ld, whose
// padding columns stay zero.
struct UnpackArgs {
  const float* v;
  float* dst[MAX_LAYERS];
  long long off[MAX_LAYERS];
  int cols[MAX_LAYERS], ld[MAX_LAYERS];
  int start[MAX_LAYERS + 1];  // where block l begins in the walk
  int n_layers;
};

__global__ void fvp_unpack_kernel(const __grid_constant__ UnpackArgs p) {
  const int total = p.start[p.n_layers];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int l = 0;
    while (i >= p.start[l + 1]) ++l;
    const int j = i - p.start[l];
    const int r = j / p.cols[l], c = j - r * p.cols[l];
    p.dst[l][(size_t)r * p.ld[l] + c] = p.v[p.off[l] + j];
  }
}

template <class K>
cudaError_t allow_smem(K kernel, int bytes) {
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              bytes);
}

// The sweep's two raw slots and two split buffers, plus the epilogue's
// activation tile when it has one.
template <class T>
constexpr int sweep_smem(bool deriv) {
  return (2 * T::STAGE_SWEEP + 4 * T::SPLIT +
          (deriv ? T::BM * T::SB : 0)) * 4;
}
template <class T>
constexpr int wgrad_smem_of() {
  return (2 * T::STAGE_WGRAD + 4 * T::SPLIT) * 4;
}
constexpr int wgrad_smem() {
  return wgrad_smem_of<Wide>() > wgrad_smem_of<Narrow>()
             ? wgrad_smem_of<Wide>()
             : wgrad_smem_of<Narrow>();
}

template <class K>
int blocks_per_sm(K kernel, int bytes) {
  int n = 0;
  if (allow_smem(kernel, bytes) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, THREADS,
                                                    bytes) != cudaSuccess)
    return -1;
  return n;
}

template <class T>
cudaError_t launch_sweep(const SweepArgs& a, cudaStream_t stream) {
  static cudaError_t attr =
      allow_smem(fvp_sweep_kernel<T>, sweep_smem<T>(true));
  if (attr != cudaSuccess) return attr;
  const dim3 grid(cdiv(a.N, T::BN), cdiv(a.M, T::BM));
  fvp_sweep_kernel<T><<<grid, THREADS, sweep_smem<T>(a.epi == EPI_DERIV),
                        stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// One sweep product (see fvp_sweep_kernel): 128 x 24 tiles for outputs up
// to 24 wide, else 128 x 128. Returns the launch's error.
extern "C" int trpo_fvp_sweep(
    int M, int N, const float* A1, int lda1, int K1, const float* B1,
    int ldb1, const float* A2, int lda2, int K2, const float* B2, int ldb2,
    const float* bias, int epi, int act, const float* H, int ldh,
    const float* wn, const float* mvec, float* C, int ldc,
    cudaStream_t stream) {
  const SweepArgs a{M,  N,  A1,   lda1, K1,  B1, ldb1, A2, lda2, K2, B2,
                    ldb2, bias, epi, act, H, ldh, wn,   mvec, C,  ldc};
  const cudaError_t err = N <= Narrow::BN ? launch_sweep<Narrow>(a, stream)
                                          : launch_sweep<Wide>(a, stream);
  return static_cast<int>(err);
}

namespace {

// The weight-gradient tiles of a layer with kin inputs and n outputs.
void layer_tiles(WgradLayer& L, int kin, int n) {
  L.kin = kin;
  L.n = n;
  L.narrow = n <= Narrow::BN;
  L.tiles_i = cdiv(kin, L.narrow ? Narrow::BM : Wide::BM);
  L.tiles_j = cdiv(n, L.narrow ? Narrow::BN : Wide::BN);
}

}  // namespace

// Tiles per split of one weight-gradient launch over n_layers layers (kin,
// n: per-layer arrays), and in *per_sm the blocks of it one SM holds, for
// the caller to size the split count. Returns -1 on a CUDA error.
extern "C" int trpo_fvp_wgrad_tiles(int n_layers, const int* kin,
                                    const int* n, int* per_sm) {
  *per_sm = blocks_per_sm(fvp_wgrad_kernel, wgrad_smem());
  if (*per_sm < 1) return -1;
  int tiles = 0;
  for (int l = 0; l < n_layers; ++l) {
    WgradLayer L{};
    layer_tiles(L, kin[l], n[l]);
    tiles += L.tiles_i * L.tiles_j;
  }
  return tiles;
}

// Per-layer arrays of n_layers entries; out_off[l] is the offset of layer
// l's [b; W] in a partial row of P floats. Returns the launch's error.
extern "C" int trpo_fvp_wgrad(int n_layers, const float* const* A,
                              const int* lda, const int* kin,
                              const float* const* G, const int* ldg,
                              const int* n, const int* out_off, int rows,
                              int rows_per_split, int splits, float* partial,
                              long long P, cudaStream_t stream) {
  if (n_layers < 1 || n_layers > MAX_LAYERS) return cudaErrorInvalidValue;
  WgradArgs a{};
  int tiles = 0;
  for (int l = 0; l < n_layers; ++l) {
    WgradLayer& L = a.layer[l];
    L.A = A[l];
    L.lda = lda[l];
    L.G = G[l];
    L.ldg = ldg[l];
    L.out = out_off[l];
    layer_tiles(L, kin[l], n[l]);
    L.first_tile = tiles;
    tiles += L.tiles_i * L.tiles_j;
  }
  a.n_layers = n_layers;
  a.n_tiles = tiles;
  a.rows = rows;
  a.rows_per_split = rows_per_split;
  a.partial = partial;
  a.P = P;
  constexpr int bytes = wgrad_smem();
  static cudaError_t attr = allow_smem(fvp_wgrad_kernel, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  fvp_wgrad_kernel<<<tiles * splits, THREADS, bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int trpo_fvp_reduce(int A, int P, int S, const float* partial,
                               const float* v, const float* coef,
                               const float* damping, float* out,
                               cudaStream_t stream) {
  const int threads = 256;
  int blocks = cdiv(A + P, threads);
  blocks = blocks < 4096 ? blocks : 4096;
  fvp_reduce_kernel<<<blocks, threads, 0, stream>>>(A, P, S, partial, v, coef,
                                                    damping, out);
  return static_cast<int>(cudaGetLastError());
}

// Per-layer arrays of n_layers entries (see UnpackArgs). Returns the
// launch's error.
extern "C" int trpo_fvp_unpack(int n_layers, const float* v,
                               float* const* dst, const long long* off,
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
  fvp_unpack_kernel<<<blocks, threads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
