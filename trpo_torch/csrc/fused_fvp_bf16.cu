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
// Fisher-weighted c and the backward cotangents g are rounded to bf16 where
// they feed the next product; the bias cotangents sum the unrounded f32
// values (c32, g32).
//
// Bound on the H100 SXM: operations. At the training shape (37,536 rows,
// 376 -> 256 -> 256 -> 17) the operator does 35.44 GFLOP of products:
// 0.036 ms at 989 TFLOP/s dense bf16, against 66.7 MB of compulsory bf16
// row operands (obs, h_0, h_1) = 0.020 ms at 3.35 TB/s.
//
// Design: two deterministic phases on wgmma (m64nNk16, bf16 in, f32
// accumulators), operands brought in by TMA with 128-byte swizzle, no
// float atomics.
//   (A) fvp16_phase_a_kernel: one block per 128-row tile takes the tile
//       through the whole chain of 2L + 1 products -- the tangent sweep
//       (obs V_0, then dh_{k-1} W_k + h_{k-1} V_k), the head with the Fisher
//       weighting c = d_mean * w_n * exp(-2 log_std), and the backward
//       dgrads (c W_L^T, then g_k W_k^T). The chained value (dh, c, g) never
//       leaves the chip: each epilogue rounds it to bf16 into a 128 x 256
//       shared-memory buffer in the K-major swizzled layout, and the next
//       product reads it there as its A operand. The epilogue's activation
//       tile comes into that same buffer by TMA once the product has read
//       its chain input (a tangent product reads its chain chunks first, so
//       the load runs behind its streamed chunks), and each output is
//       written in the place of its h. Only what phase B needs goes to
//       device memory: the rounded c and g_k (TMA stores from the buffer)
//       and, per tile, the column sums of the unrounded c32 and g32 in a
//       fixed order. A producer warpgroup (one thread issuing) keeps the TMA
//       loads of the streamed operands (obs / h_k tiles, weight and tangent
//       chunks, 64 deep, from L2) three stages ahead of two consumer
//       warpgroups of 64 rows each, and gives them its registers
//       (setmaxnreg 40 / 232; the launch bound alone allows 168).
//   (B) fvp16_phase_b_kernel: every layer's weight gradient A_k^T G_k as
//       128 x 128 (or 128 x 64) output tiles over fixed row splits, both
//       operands read as they lie (row-major: MN-major to wgmma, no
//       transposed copies). The blocks of a layer's first row tile also add
//       the phase-A column sums of their split. trpo_fvp_reduce
//       (fused_fvp.cu) then adds the splits in a fixed order plus
//       lambda v, lambda read from device memory: bitwise repeatable.
// B operands: the tangent products read V_k and W_k as they lie ((in, out):
// MN-major); the head's V_L and W_L are read from small K-major transposed
// copies (W_L^T once per operator build, V_L^T by the unpack kernel), so the
// head can use a 32-wide wgmma; the backward products read W_k as it lies
// (K-major). Widths: one warpgroup's accumulator holds a 64 x 256 tile, so
// the chain stays on chip when every hidden and the action width is at most
// 256. A wider torso runs phase A product by product instead (one launch
// each, a block per 128-row x 256-column tile): each product streams its
// chained input, rounded to bf16 as before, from device memory (dh_k goes
// to the g_k buffer that g_k later overwrites) the way it streams obs and
// h_k, and stores its output there. A torso deeper than MAX_LAYERS - 1
// hidden layers runs the same way, one product a launch, and its unpack and
// phase B take the layers in groups of MAX_LAYERS (the argument blocks of a
// launch hold at most that many). Ragged edges: TMA fills out-of-range
// rows and columns with zeros and clips the stores; the epilogues mask the
// rest.
//
// Bytes per call of this design at the training shape: phase A reads obs
// and h_k once (66.6 MB) and writes g_0, g_1 and c (39.7 MB); phase B reads
// the same six row operands again and writes and reads its split partials:
// about 230 MB, 0.069 ms at 3.35 TB/s.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cstring>
#include <vector>

namespace {

constexpr int BM = 128;        // rows of a phase-A tile, kin of a phase-B tile
constexpr int BK = 64;         // k per stage: one 128-byte swizzled bf16 row
constexpr int CONSUMERS = 256;  // two consumer warpgroups
constexpr int THREADS_A = CONSUMERS + 128;  // and a producer warpgroup
constexpr int THREADS_B = CONSUMERS + 32;   // and a producer warp
constexpr int MAX_LAYERS = 8;
constexpr int MAX_PROD = 2 * MAX_LAYERS - 1;
constexpr int MAX_MAPS = 6 * MAX_LAYERS;
constexpr int MAXW = 256;      // the widest output of a block's product

constexpr int HALF = 64 * 128;           // 64 rows x 64 bf16 (8 KB)
constexpr int ATOM = BM * 128;           // 128 rows x 64 bf16 (16 KB)
constexpr int STAGES_A = 3;
constexpr int STAGE_A = ATOM + MAXW * 128;  // A chunk + B chunk (48 KB)
constexpr int CHAIN = 4 * ATOM;             // 128 rows x 256 (64 KB)
constexpr int CSUM = 8 * MAXW * 4;          // per-warp column sums
constexpr int SMEM_A = STAGES_A * STAGE_A + CHAIN + CSUM + 1024;
constexpr int STAGES_B = 6;
constexpr int STAGE_B = 2 * HALF + 2 * HALF;  // 128 kin x 64 + 64 x 128 n
constexpr int SMEM_B = STAGES_B * STAGE_B + 1024;

enum { ACT_TANH = 0, ACT_RELU = 1, ACT_ELU = 2 };
enum { EPI_TAN = 0, EPI_HEAD = 1, EPI_BWD = 2 };

template <int V>
struct Int {};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }
__host__ __device__ inline int pad8(int n) { return (n + 7) / 8 * 8; }

// One product of phase A: D (128 x nc) = A_s B_s [+ chain B_c], then its
// epilogue.
struct Prod {
  int epi;      // EPI_*: a tangent product's B operands are MN-major, the
                // head's and the backward ones' K-major
  int nc;       // wgmma N: 32, 64, 128 or 256
  int n;        // output width
  int a_map;    // streamed A (obs or h_k, K-major), -1: none
  int ka;       // its depth
  int b_map_a;  // B paired with the streamed A
  int kc;       // depth of the chain part, 0: none
  int b_map_c;  // B paired with the chain
  int c_map;    // the chain in device memory ({64, 64}), -1: on chip
  int h_map;    // activation of act'(h) in the epilogue ({64, 64}), -1
  int store;    // map of the rounded output's store, -1: none
  int bcol;     // column of its bias cotangent in a colsum row, -1: none
  long long vb;  // offset of the bias tangent in v, -1: none
};

struct ArgsA {
  CUtensorMap maps[MAX_MAPS];
  Prod prod[MAX_PROD];
  int first, n_prod;  // this launch runs products first .. n_prod - 1
  int rows, act, pb;  // pb: the length of a colsum row
  const float* v;
  const float* wn;
  const float* m;
  float* colsum;  // (tiles, pb)
};

struct LayerB {
  int a_map, g_map;  // activations, cotangents: {64, 64} boxes
  int kin, n, nb, tiles_j, first_tile;
  int out;   // offset of the layer's [b; W] in a partial row
  int bcol;  // column of its bias cotangent in a colsum row
};

struct ArgsB {
  CUtensorMap maps[MAX_MAPS];
  LayerB layer[MAX_LAYERS];
  int n_layers, n_tiles, rows, rows_per_split, row_tiles, pb;
  const float* colsum;
  float* partial;  // (splits, P)
  long long P;
};

// Each weight-tangent block V_l of the flat f32 v (row-major (rows, cols) at
// v + off[l]) rounded to bf16 into a buffer of row stride ld: as it lies,
// or, for the head (block `head` of the launch, -1: not in it), transposed
// (cols, rows).
struct UnpackArgs {
  const float* v;
  uint16_t* dst[MAX_LAYERS];
  long long off[MAX_LAYERS];
  int cols[MAX_LAYERS], ld[MAX_LAYERS];
  int start[MAX_LAYERS + 1];
  int n_layers, head;
};

// The launch plan: this header, then n_a phase-A argument blocks, n_g
// phase-B blocks and n_g unpack blocks (plan_layout). A torso of at most
// MAX_LAYERS layers is one block of each; a deeper one runs phase A one
// product per launch, each block holding only its product's maps, and the
// unpack and phase B in groups of MAX_LAYERS layers.
struct Plan {
  int n_layers, grid_a;
  int wide;  // phase A one launch per product (a width past MAXW, or deep)
  int n_a, n_g;
};

// ---- PTX helpers ------------------------------------------------------
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(b)),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect(uint64_t* b, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(b)),
      "r"(bytes)
      : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(b))
               : "memory");
}
// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* b, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra.uni DONE;\nbra.uni LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_u32(b)),
      "r"(parity)
      : "memory");
}
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_prefetch(const CUtensorMap* map, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}],"
      " [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Hand registers from the producer warpgroup to the consumers (all four
// warps of a warpgroup execute it).
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Shared-memory matrix descriptor, 128-byte swizzle (the layout TMA writes
// with CU_TENSOR_MAP_SWIZZLE_128B into a 1024-byte-aligned tile). K-major:
// rows of 64 k (128 bytes), SBO = 1024 (the next 8 rows); a k16 step moves
// the start 32 bytes. MN-major: rows of 64 m/n for one k, SBO = 1024 (the
// next 8 k), LBO = the next 64 m/n; a k16 step moves the start 2048 bytes.
__device__ __forceinline__ uint64_t desc(const void* p, uint32_t lbo) {
  return (uint64_t)((smem_u32(p) & 0x3FFFF) >> 4) |
         ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(1024 >> 4) << 32) |
         (1ull << 62);
}
__device__ __forceinline__ uint64_t desc_k(const uint8_t* tile, int ks) {
  return desc(tile + ks * 32, 16);
}
__device__ __forceinline__ uint64_t desc_mn(const uint8_t* tile, int ks) {
  return desc(tile + ks * 2048, HALF);
}

// d (+)= A B for a warpgroup, m64nNk16 bf16 -> f32, A and B from shared
// memory; TA/TB 1 = MN-major. scale_d = 0 overwrites d. d[4i..4i+3] are
// (row g, columns 8i + 2q, +1) and (row g + 8, the same columns) of the
// warp's 16 rows, g = lane / 4, q = lane % 4.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d, Int<32>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d, Int<64>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d, Int<128>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss(float (&d)[128], uint64_t da,
                                         uint64_t db, int scale_d, Int<256>) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]), "+f"(d[65]),
        "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),
        "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]), "+f"(d[88]), "+f"(d[89]),
        "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]),
        "+f"(d[102]), "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]),
        "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]),
        "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TA), "n"(TB));
}

// The first 1024-byte boundary in p, as an offset from p so that the
// pointer stays a shared-memory one to the compiler.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// ---- phase A ----------------------------------------------------------
// A block's columns of a product's output: n0 .. n0 + n_cols(P, n0) - 1.
__device__ __forceinline__ int n_cols(const Prod& P, int n0) {
  return min(P.n - n0, MAXW);
}

// The producer: for every product, its chain chunks (B only, or A and B
// when the chain lies in device memory), then its streamed chunks (A and
// B), into a ring of STAGES_A stages.
__device__ void produce_a(const ArgsA& p, const Prod* prods, uint8_t* stages,
                          uint64_t* full, uint64_t* empty, int row0,
                          int n0) {
  int it = 0;
  for (int j = p.first; j < p.n_prod; ++j) {
    const Prod& P = prods[j];
    // a tangent product's activation tile, into L2 ahead of its epilogue
    if (P.epi == EPI_TAN)
      for (int a = 0; a < cdiv(n_cols(P, n0), 64); ++a)
        for (int w = 0; w < 2; ++w)
          tma_prefetch(&p.maps[P.h_map], n0 + 64 * a, row0 + 64 * w);
    const int ncc = cdiv(P.kc, BK);
    const int nch = ncc + (P.a_map >= 0 ? cdiv(P.ka, BK) : 0);
    for (int c = 0; c < nch; ++c, ++it) {
      const int s = it % STAGES_A;
      mbar_wait(&empty[s], ((it / STAGES_A) & 1) ^ 1);
      uint8_t* sa = stages + s * STAGE_A;
      uint8_t* sb = sa + ATOM;
      const bool streamed = c >= ncc;
      const bool a_in = streamed || P.c_map >= 0;
      const int k0 = (streamed ? c - ncc : c) * BK;
      const CUtensorMap* bm = &p.maps[streamed ? P.b_map_a : P.b_map_c];
      mbar_expect(&full[s], P.nc * 128 + (a_in ? ATOM : 0));
      if (streamed) {
        tma_load(sa, &p.maps[P.a_map], &full[s], k0, row0);
      } else if (a_in) {  // the chain, as two 64-row boxes
        tma_load(sa, &p.maps[P.c_map], &full[s], k0, row0);
        tma_load(sa + HALF, &p.maps[P.c_map], &full[s], k0, row0 + 64);
      }
      if (P.epi != EPI_TAN) {  // K-major
        tma_load(sb, bm, &full[s], k0, n0);
      } else {
        for (int jb = 0; jb < P.nc / 64; ++jb)
          tma_load(sb + jb * HALF, bm, &full[s], n0 + 64 * jb, k0);
      }
    }
  }
}

// Bring the warpgroup's 64 rows of an activation tile (columns n0 ..
// n0 + n - 1) into the chain buffer (after the last store from it has read
// it).
__device__ __forceinline__ void load_h(const ArgsA& p, int h_map, int n,
                                       uint8_t* chain, uint64_t* hbar,
                                       int row0, int n0, int wg) {
  bulk_wait_read();
  mbar_expect(&hbar[wg], cdiv(n, 64) * HALF);
  for (int a = 0; a < cdiv(n, 64); ++a)
    tma_load(chain + a * ATOM + wg * HALF, &p.maps[h_map], &hbar[wg],
             n0 + 64 * a, row0 + wg * 64);
}

// One product's products: every chunk's four k16 steps, the chain chunks
// first, each stage released once the products that read it are done. A
// tangent product (TB) then has the chain free while its streamed chunks
// run, and loads its epilogue's activation tile there meanwhile.
template <int NC, int TB>
__device__ __forceinline__ void mainloop_a(const ArgsA& p, const Prod& P,
                                           float (&acc)[128],
                                           const uint8_t* stages,
                                           uint8_t* chain, uint64_t* full,
                                           uint64_t* empty, uint64_t* hbar,
                                           int& it, int row0, int n0,
                                           int wg) {
  const int ncc = cdiv(P.kc, BK);
  const int nch = ncc + (P.a_map >= 0 ? cdiv(P.ka, BK) : 0);
  const int h_map = P.h_map, n = n_cols(P, n0);
  const bool on_chip = P.c_map < 0;
  int prev = -1;
  for (int c = 0; c < nch; ++c, ++it) {
    if (TB && c == ncc) {
      wgmma_wait<0>();
      if (prev >= 0) mbar_arrive(&empty[prev]);
      prev = -1;
      bar_sync(2 + wg, 128);  // the warpgroup is done reading the chain
      if ((threadIdx.x & 127) == 0)
        load_h(p, h_map, n, chain, hbar, row0, n0, wg);
    }
    const int s = it % STAGES_A;
    mbar_wait(&full[s], (it / STAGES_A) & 1);
    const uint8_t* sa = (c < ncc && on_chip ? chain + c * ATOM
                                            : stages + s * STAGE_A) +
                        wg * HALF;
    const uint8_t* sb = stages + s * STAGE_A + ATOM;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<0, TB>(acc, desc_k(sa, ks),
                      TB ? desc_mn(sb, ks) : desc_k(sb, ks), (c | ks) != 0,
                      Int<NC>{});
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
  wgmma_wait<0>();
  mbar_arrive(&empty[prev]);
}

template <int ACT>
__device__ __forceinline__ float act_deriv(float h) {
  if (ACT == ACT_TANH) return 1.f - h * h;
  if (ACT == ACT_RELU) return h > 0.f ? 1.f : 0.f;
  return h > 0.f ? 1.f : h + 1.f;  // elu
}

// The epilogue of one product (see Prod): EPI_TAN dh = bf16(act'(h) (D +
// vb)); EPI_HEAD c32 = (D + vb) w_n m, c = bf16(c32); EPI_BWD g32 = act'(h)
// D, g = bf16(g32). Each thread holds rows r, r + 8 of its warp's 16 and
// columns 8i + 2q, +1 of the warpgroup's 64 x NC accumulator tile. The
// activation tile (TAN, BWD) first comes into the chain buffer by TMA
// (the product has read its chain input); each thread reads its values of
// h there and writes its outputs in their place. The kind and the
// activation are template parameters: the loop is unrolled, and a runtime
// branch in it would put every variant's code in the instruction stream.
template <int NC, int EPI, int ACT>
__device__ __forceinline__ void epilogue_a(const ArgsA& p, const Prod& P,
                                           const float (&acc)[128],
                                           uint8_t* chain, float* csum,
                                           uint64_t* hbar, int& hphase,
                                           int row0, int n0) {
  const int t = threadIdx.x, wg = t >> 7, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, q = lane & 3;
  const bool issuer = (t & 127) == 0;
  // P lies in shared memory, as does the chain: the fields in registers,
  // or every chain store would force them to be read again. The block's
  // columns are n0 .. n0 + n - 1 of the output.
  const int n = n_cols(P, n0), bcol = P.bcol + n0, store = P.store,
            h_map = P.h_map;
  const float* vb = p.v + P.vb + n0;  // TAN, HEAD
  const float* mrow = p.m + n0;       // HEAD
  // every thread of the warpgroup has finished its products before the
  // chain is overwritten (and the previous store has read it: load_h)
  if (issuer && EPI == EPI_HEAD) bulk_wait_read();
  bar_sync(2 + wg, 128);
  if (EPI != EPI_HEAD) {
    // a tangent product's tile was requested by its mainloop
    if (EPI == EPI_BWD && issuer)
      load_h(p, h_map, n, chain, hbar, row0, n0, wg);
    mbar_wait(&hbar[wg], hphase);
    hphase ^= 1;
  }
  const int rl = wg * 64 + (warp & 3) * 16 + g;  // tile row of half 0
  const bool ok0 = row0 + rl < p.rows, ok1 = row0 + rl + 8 < p.rows;
  float rw0 = 0.f, rw1 = 0.f;
  if (EPI == EPI_HEAD) {
    rw0 = ok0 ? __ldg(p.wn + row0 + rl) : 0.f;
    rw1 = ok1 ? __ldg(p.wn + row0 + rl + 8) : 0.f;
  }
  // (r, c) of the chain: atom c / 64, row r, 16-byte chunk (c % 64) / 8
  // swizzled by r % 8 (= g)
  uint8_t* row = chain + rl * 128 + q * 4;
  // groups of G column fragments: every load of a group is issued before
  // its first store (a load after a store to the same buffer would wait
  // for it), so the group's loads are in flight together
  constexpr int G = NC < 64 ? NC / 8 : 8;
#pragma unroll
  for (int i0 = 0; i0 < NC / 8; i0 += G) {
    uint32_t hw[G][2];
    float b[G][2], mv[G][2];
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int i = i0 + k, c = 8 * i + 2 * q;
      uint8_t* at = row + (i >> 3) * ATOM + (((i & 7) ^ g) << 4);
      if (EPI != EPI_HEAD) {
        hw[k][0] = *reinterpret_cast<const uint32_t*>(at);
        hw[k][1] = *reinterpret_cast<const uint32_t*>(at + 1024);
      }
      b[k][0] = b[k][1] = mv[k][0] = mv[k][1] = 0.f;
      if (EPI != EPI_BWD) {
        b[k][0] = c < n ? __ldg(vb + c) : 0.f;
        b[k][1] = c + 1 < n ? __ldg(vb + c + 1) : 0.f;
      }
      if (EPI == EPI_HEAD) {
        mv[k][0] = c < n ? __ldg(mrow + c) : 0.f;
        mv[k][1] = c + 1 < n ? __ldg(mrow + c + 1) : 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < G; ++k) {
      const int i = i0 + k, c = 8 * i + 2 * q;
      const bool c0 = c < n, c1 = c + 1 < n;
      uint8_t* at = row + (i >> 3) * ATOM + (((i & 7) ^ g) << 4);
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const float x0 = acc[4 * i + 2 * hh], x1 = acc[4 * i + 2 * hh + 1];
        float y0, y1;
        if (EPI == EPI_HEAD) {
          const float rw = hh ? rw1 : rw0;
          y0 = (x0 + b[k][0]) * (rw * mv[k][0]);
          y1 = (x1 + b[k][1]) * (rw * mv[k][1]);
        } else {
          const uint32_t w = hw[k][hh];
          const bool ok = hh ? ok1 : ok0;
          const float d0 =
              ok && c0 ? act_deriv<ACT>(__uint_as_float(w << 16)) : 0.f;
          const float d1 =
              ok && c1 ? act_deriv<ACT>(__uint_as_float(w & 0xffff0000u))
                       : 0.f;
          y0 = d0 * (x0 + b[k][0]);
          y1 = d1 * (x1 + b[k][1]);
        }
        s0 += y0;
        s1 += y1;
        const __nv_bfloat162 o = __floats2bfloat162_rn(y0, y1);
        *reinterpret_cast<uint32_t*>(at + hh * 1024) =
            *reinterpret_cast<const uint32_t*>(&o);
      }
      if (EPI != EPI_TAN) {
#pragma unroll
        for (int o = 4; o < 32; o <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, o);
          s1 += __shfl_xor_sync(0xffffffffu, s1, o);
        }
        if (g == 0) {
          csum[warp * MAXW + c] = s0;
          csum[warp * MAXW + c + 1] = s1;
        }
      }
    }
  }
  if (NC == 32) {
    // a 32-wide output feeds the next product as a 64-deep chunk
#pragma unroll
    for (int hh = 0; hh < 2; ++hh)
#pragma unroll
      for (int i = 4; i < 8; ++i)
        *reinterpret_cast<uint32_t*>(row + hh * 1024 + ((i ^ g) << 4)) = 0u;
  }
  if (EPI != EPI_TAN) {
    // the tile's column sums, the eight warps added in order
    bar_sync(1, CONSUMERS);
    for (int c = t; c < n; c += CONSUMERS) {
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += csum[w * MAXW + c];
      p.colsum[(size_t)blockIdx.x * p.pb + bcol + c] = s;
    }
    bar_sync(1, CONSUMERS);
  }
  fence_proxy_async();  // the chain's generic writes, to wgmma and TMA
  bar_sync(2 + wg, 128);
  if (issuer && store >= 0 && row0 + wg * 64 < p.rows) {
    for (int a = 0; a < cdiv(n, 64); ++a)
      tma_store(&p.maps[store], chain + a * ATOM + wg * HALF, n0 + 64 * a,
                row0 + wg * 64);
    bulk_commit();
  }
}

template <int NC, int EPI>
__device__ __forceinline__ void epilogue_act(const ArgsA& p, const Prod& P,
                                             const float (&acc)[128],
                                             uint8_t* chain, float* csum,
                                             uint64_t* hbar, int& hphase,
                                             int row0, int n0) {
  switch (p.act) {
    case ACT_TANH:
      epilogue_a<NC, EPI, ACT_TANH>(p, P, acc, chain, csum, hbar, hphase,
                                    row0, n0);
      break;
    case ACT_RELU:
      epilogue_a<NC, EPI, ACT_RELU>(p, P, acc, chain, csum, hbar, hphase,
                                    row0, n0);
      break;
    default:
      epilogue_a<NC, EPI, ACT_ELU>(p, P, acc, chain, csum, hbar, hphase,
                                   row0, n0);
  }
}

// One product: MN-major B operands (TB) are the tangent products', K-major
// the head's and the backward ones'.
template <int NC, int TB>
__device__ __forceinline__ void product_a(const ArgsA& p, const Prod& P,
                                          float (&acc)[128],
                                          const uint8_t* stages,
                                          uint8_t* chain, float* csum,
                                          uint64_t* full, uint64_t* empty,
                                          uint64_t* hbar, int& it,
                                          int& hphase, int row0, int n0) {
  mainloop_a<NC, TB>(p, P, acc, stages, chain, full, empty, hbar, it, row0,
                     n0, threadIdx.x >> 7);
  if constexpr (TB == 1) {
    epilogue_act<NC, EPI_TAN>(p, P, acc, chain, csum, hbar, hphase, row0,
                              n0);
  } else {
    if (P.epi == EPI_HEAD)
      epilogue_a<NC, EPI_HEAD, ACT_TANH>(p, P, acc, chain, csum, hbar, hphase,
                                         row0, n0);
    else
      epilogue_act<NC, EPI_BWD>(p, P, acc, chain, csum, hbar, hphase,
                                row0, n0);
  }
}

// One 128-row tile through every product of the chain, or in a wide plan
// through one product's 256 columns n0 = blockIdx.y * 256 (see the header).
// The launch bound alone would hold every thread to 168 registers; the
// producer warpgroup gives its registers to the consumers (40 / 232).
__global__ void __launch_bounds__(THREADS_A, 1)
    fvp16_phase_a_kernel(const __grid_constant__ ArgsA p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = align1024(smem_raw);
  uint8_t* chain = stages + STAGES_A * STAGE_A;
  float* csum = reinterpret_cast<float*>(chain + CHAIN);
  __shared__ __align__(8) uint64_t full[STAGES_A], empty[STAGES_A], hbar[2];
  // the product list, read by every thread at every product
  __shared__ Prod prods[MAX_PROD];
  for (int i = p.first + threadIdx.x; i < p.n_prod; i += THREADS_A)
    prods[i] = p.prod[i];
  // the chain starts as zeros: a product may read past its input's width
  for (int i = threadIdx.x; i < CHAIN / 16; i += THREADS_A)
    reinterpret_cast<uint4*>(chain)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_A; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_init(&hbar[0], 1);
    mbar_init(&hbar[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();
  const int row0 = blockIdx.x * BM, n0 = blockIdx.y * MAXW;
  if (threadIdx.x >= CONSUMERS) {
    setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS)
      produce_a(p, prods, stages, full, empty, row0, n0);
    return;
  }
  setmaxnreg_inc<232>();
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  int it = 0, hphase = 0;
  for (int j = p.first; j < p.n_prod; ++j) {
    const Prod& P = prods[j];
#define PRODUCT(NC, TB)                                                \
  product_a<NC, TB>(p, P, acc, stages, chain, csum, full, empty, hbar, \
                    it, hphase, row0, n0);                             \
  break
    if (P.epi != EPI_TAN) {
      switch (P.nc) {
        case 32: PRODUCT(32, 0);
        case 64: PRODUCT(64, 0);
        case 128: PRODUCT(128, 0);
        default: PRODUCT(256, 0);
      }
    } else {
      switch (P.nc) {
        case 64: PRODUCT(64, 1);
        case 128: PRODUCT(128, 1);
        default: PRODUCT(256, 1);
      }
    }
#undef PRODUCT
  }
  if ((threadIdx.x & 127) == 0) bulk_wait();
}

// ---- phase B ----------------------------------------------------------
// One (layer, 128-row i tile, nb-wide j tile) of one row split:
//   partial[s][out + (1 + i) * n + j] = sum_{r in split} A[r][i] G[r][j]
// and, on a layer's first i tile, partial[s][out + j] = the phase-A column
// sums of the split's row tiles. Grid: n_tiles x splits, split-major.
template <int NB>
__device__ __forceinline__ void mainloop_b(float (&acc)[128],
                                           const uint8_t* stages,
                                           uint64_t* full, uint64_t* empty,
                                           int nch, int wg) {
  int prev = -1;
  for (int c = 0; c < nch; ++c) {
    const int s = c % STAGES_B;
    mbar_wait(&full[s], (c / STAGES_B) & 1);
    const uint8_t* sa = stages + s * STAGE_B + wg * HALF;
    const uint8_t* sb = stages + s * STAGE_B + 2 * HALF;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss<1, 1>(acc, desc_mn(sa, ks), desc_mn(sb, ks), (c | ks) != 0,
                     Int<NB>{});
    wgmma_commit();
    wgmma_wait<1>();
    if (prev >= 0) mbar_arrive(&empty[prev]);
    prev = s;
  }
  wgmma_wait<0>();
  if (prev >= 0) mbar_arrive(&empty[prev]);
}

__global__ void __launch_bounds__(THREADS_B, 1)
    fvp16_phase_b_kernel(const __grid_constant__ ArgsB p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* stages = align1024(smem_raw);
  __shared__ __align__(8) uint64_t full[STAGES_B], empty[STAGES_B];
  __shared__ LayerB layer;  // see fvp16_phase_a_kernel's product list
  const int split = blockIdx.x / p.n_tiles;
  const int tile = blockIdx.x % p.n_tiles;
  int l = 0;
  while (l + 1 < p.n_layers && tile >= p.layer[l + 1].first_tile) ++l;
  if (threadIdx.x == 0) layer = p.layer[l];
  __syncthreads();
  const LayerB& L = layer;
  const int local = tile - L.first_tile;
  const int ti = local / L.tiles_j;
  const int i0 = ti * BM, j0 = (local % L.tiles_j) * L.nb;
  const int rbeg = split * p.rows_per_split;
  const int rend = min(rbeg + p.rows_per_split, p.rows);
  const int nch = cdiv(rend - rbeg, 64);
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES_B; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS) {
    if (threadIdx.x == CONSUMERS) {
      for (int c = 0; c < nch; ++c) {
        const int s = c % STAGES_B;
        mbar_wait(&empty[s], ((c / STAGES_B) & 1) ^ 1);
        uint8_t* sa = stages + s * STAGE_B;
        const int r = rbeg + c * 64;
        mbar_expect(&full[s], 2 * HALF + L.nb * 128);
        tma_load(sa, &p.maps[L.a_map], &full[s], i0, r);
        tma_load(sa + HALF, &p.maps[L.a_map], &full[s], i0 + 64, r);
        for (int jb = 0; jb < L.nb / 64; ++jb)
          tma_load(sa + 2 * HALF + jb * HALF, &p.maps[L.g_map], &full[s],
                   j0 + 64 * jb, r);
      }
    }
    return;
  }
  const int t = threadIdx.x, wg = t >> 7, warp = t >> 5, lane = t & 31;
  const int g = lane >> 2, q = lane & 3;
  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  if (L.nb == 64)
    mainloop_b<64>(acc, stages, full, empty, nch, wg);
  else
    mainloop_b<128>(acc, stages, full, empty, nch, wg);
  float* out = p.partial + (long long)split * p.P + L.out;
  const int ib = i0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int i = ib + 8 * hh;
    if (i >= L.kin) continue;
    float* row = out + (size_t)(1 + i) * L.n;
#pragma unroll
    for (int f = 0; f < 16; ++f) {  // nb / 8 fragments (nb <= 128)
      if (f >= L.nb / 8) break;
      const int j = j0 + 8 * f + 2 * q;
      if (j < L.n) row[j] = acc[4 * f + 2 * hh];
      if (j + 1 < L.n) row[j + 1] = acc[4 * f + 2 * hh + 1];
    }
  }
  if (ti == 0) {
    const int t0 = rbeg / BM, t1 = min(p.row_tiles, cdiv(rend, BM));
    for (int c = t; c < L.nb; c += CONSUMERS) {
      const int j = j0 + c;
      if (j >= L.n) continue;
      float s = 0.f;
      for (int tt = t0; tt < t1; ++tt)
        s += p.colsum[(size_t)tt * p.pb + L.bcol + j];
      out[j] = s;
    }
  }
}

__global__ void fvp16_unpack_kernel(const __grid_constant__ UnpackArgs p) {
  const int total = p.start[p.n_layers];
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < total;
       i += gridDim.x * blockDim.x) {
    int l = 0;
    while (i >= p.start[l + 1]) ++l;
    const int j = i - p.start[l];
    const int r = j / p.cols[l], c = j - r * p.cols[l];
    const size_t at = l == p.head ? (size_t)c * p.ld[l] + r
                                  : (size_t)r * p.ld[l] + c;
    p.dst[l][at] = __bfloat16_as_ushort(__float2bfloat16_rn(p.v[p.off[l] + j]));
  }
}

// ---- host side ----------------------------------------------------------
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A bf16 (rows, cols) tensor of row stride pad8(cols) as TMA boxes of
// box_cols x box_rows, 128-byte swizzle, zeros out of range. Returns 0 or
// a nonzero error (a CUresult, or -1 when the lookup found no encoder).
int make_map(CUtensorMap* map, const void* base, int rows, int cols,
             int box_cols, int box_rows) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)pad8(cols) * 2};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t unit[2] = {1, 1};
  return static_cast<int>(fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                             const_cast<void*>(base), dims, strides, box,
                             unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                             CU_TENSOR_MAP_SWIZZLE_128B,
                             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE));
}

// wgmma widths: K-major B takes 32 .. 256, MN-major B whole 64-wide atoms.
int width_k(int n) { return n <= 32 ? 32 : n <= 64 ? 64 : n <= 128 ? 128 : 256; }
int width_mn(int n) { return n <= 64 ? 64 : n <= 128 ? 128 : 256; }

}  // namespace


namespace {

// A tensor map to build: a bf16 (rows, cols) tensor in boxes of bc x br;
// base == nullptr: none.
struct MapSpec {
  const void* base;
  int rows, cols, bc, br;
};
constexpr MapSpec NONE{nullptr, 0, 0, 0, 0};

// The maps of one argument block, each built once however many of its
// products or layers read it.
struct MapSet {
  CUtensorMap* maps;
  MapSpec specs[MAX_MAPS];
  int n, err;
  explicit MapSet(CUtensorMap* m) : maps(m), n(0), err(0) {}
  int get(const MapSpec& s) {
    if (s.base == nullptr) return -1;
    for (int i = 0; i < n; ++i) {
      const MapSpec& o = specs[i];
      if (o.base == s.base && o.rows == s.rows && o.cols == s.cols &&
          o.bc == s.bc && o.br == s.br)
        return i;
    }
    if (n == MAX_MAPS) {
      if (err == 0) err = cudaErrorInvalidValue;
      return 0;
    }
    const int e = make_map(&maps[n], s.base, s.rows, s.cols, s.bc, s.br);
    if (e != 0 && err == 0) err = e;
    specs[n] = s;
    return n++;
  }
};

// One product of the chain (see Prod), with its maps still to be built.
struct ProdSpec {
  int epi, nc, n;
  MapSpec a;
  int ka;
  MapSpec b_a;
  int kc;
  MapSpec b_c, c;
  long long vb;
  MapSpec h, store;
  int bcol;
};

void put_prod(ArgsA& a, MapSet& ms, const ProdSpec& q) {
  Prod& P = a.prod[a.n_prod++];
  P.epi = q.epi; P.nc = q.nc; P.n = q.n;
  P.a_map = ms.get(q.a); P.ka = q.ka; P.b_map_a = ms.get(q.b_a);
  P.kc = q.kc; P.b_map_c = ms.get(q.b_c); P.c_map = ms.get(q.c);
  P.vb = q.vb; P.h_map = ms.get(q.h); P.store = ms.get(q.store);
  P.bcol = q.bcol;
}

size_t up64(size_t n) { return (n + 63) / 64 * 64; }

// Where a plan of n_layers layers keeps its blocks (see Plan).
struct Layout {
  size_t a, b, u, bytes;
  int n_a, n_g;
};
Layout plan_layout(int n_layers) {
  Layout l;
  l.n_a = n_layers > MAX_LAYERS ? 2 * n_layers - 1 : 1;
  l.n_g = cdiv(n_layers, MAX_LAYERS);
  l.a = up64(sizeof(Plan));
  l.b = l.a + up64(sizeof(ArgsA)) * l.n_a;
  l.u = l.b + up64(sizeof(ArgsB)) * l.n_g;
  l.bytes = l.u + up64(sizeof(UnpackArgs)) * l.n_g;
  return l;
}

template <class T>
T& block(void* plan, size_t off, int i) {
  return *reinterpret_cast<T*>(static_cast<char*>(plan) + off +
                               up64(sizeof(T)) * i);
}
template <class T>
const T& block(const void* plan, size_t off, int i) {
  return *reinterpret_cast<const T*>(static_cast<const char*>(plan) + off +
                                     up64(sizeof(T)) * i);
}

}  // namespace

extern "C" int trpo_fvp16_plan_bytes(int n_layers) {
  return n_layers < 2 ? 0 : static_cast<int>(plan_layout(n_layers).bytes);
}

// Build the launch plan of one operator into `out`
// (trpo_fvp16_plan_bytes(n_layers) bytes, 64-byte aligned). n_layers =
// L + 1 (L hidden layers, any number), dims[0..L+1] the widths (obs,
// hidden..., action). Every bf16 buffer has row stride pad8(cols). ptr, in
// order:
//   obs (rows, d0); h_0 .. h_{L-1} (rows, d_{k+1}); W_1 .. W_L (d_k, d_{k+1});
//   W_L^T (A, d_L); V_0 .. V_{L-1} (d_k, d_{k+1}) and V_L^T (A, d_L), the
//   unpack targets; g_0 .. g_{L-1} (rows, d_{k+1}); c (rows, A);
//   colsum (cdiv(rows, 128), sum of d_1 .. d_{L+1}) f32; wn (rows,) f32;
//   m (A,) f32.
// boff/woff[l]: offsets of layer l's b and W in v; out[l]: offset of its
// [b; W] in a partial row of P floats. Phase B's row splits are sized so
// that its blocks fill the card's `sms` SMs once; their count goes to
// *splits, for the caller's (splits, P) f32 partials.
// Returns 0, or the first tensor map's error, or a cudaError_t.
extern "C" int trpo_fvp16_plan(void* out, int n_layers, const int* dims,
                               int rows, int act, int sms,
                               const void* const* ptr, const long long* boff,
                               const long long* woff, const int* out_off,
                               long long P, int* splits) {
  const int L = n_layers - 1;
  if (L < 1 || rows < 1 || sms < 1) return cudaErrorInvalidValue;
  const Layout lay = plan_layout(n_layers);
  std::memset(out, 0, lay.bytes);
  Plan& pl = *static_cast<Plan*>(out);
  pl.n_a = lay.n_a;
  pl.n_g = lay.n_g;
  const int A = dims[L + 1];
  const void* obs = ptr[0];
  const void* const* h = ptr + 1;
  const void* const* W = ptr + 1 + L - 1;  // W[k], k = 1 .. L
  const void* WLt = ptr[2 * L + 1];
  const void* const* V = ptr + 2 * L + 2;  // V[k], k = 0 .. L
  const void* const* G = ptr + 3 * L + 3;  // g_0 .. g_{L-1}, then c
  float* colsum = (float*)ptr[4 * L + 4];
  const float* wn = (const float*)ptr[4 * L + 5];
  const float* m = (const float*)ptr[4 * L + 6];
  std::vector<int> bcol(n_layers);
  int pb = 0;
  for (int l = 0; l <= L; ++l) {
    bcol[l] = pb;
    pb += dims[l + 1];
    if (dims[l + 1] > MAXW) pl.wide = 1;
  }
  if (lay.n_a > 1) pl.wide = 1;

  // the maps: obs and h_k as 128-row boxes (streamed A), h_k as 64-row
  // boxes (epilogues, phase B), the tangent and weight blocks, the g_k
  const int head = width_k(A);
  auto s_h = [&](int k) { return MapSpec{h[k], rows, dims[k + 1], 64, BM}; };
  auto s_he = [&](int k) {
    return MapSpec{h[k], rows, dims[k + 1], 64, 64};
  };
  auto s_v = [&](int k) {
    return k < L ? MapSpec{V[k], dims[k], dims[k + 1], 64, 64}
                 : MapSpec{V[L], A, dims[L], 64, head};
  };
  auto s_wt = [&](int k) {
    return k < L ? MapSpec{W[k], dims[k], dims[k + 1], 64, 64}
                 : MapSpec{WLt, A, dims[L], 64, head};
  };
  auto s_wb = [&](int k) {
    return MapSpec{W[k], dims[k], dims[k + 1], 64, width_k(dims[k])};
  };
  auto s_g = [&](int k) { return MapSpec{G[k], rows, dims[k + 1], 64, 64}; };

  // the chain: tangents, head, backward dgrads. A wide plan passes each
  // chained value through device memory: dh_k through g_k's buffer.
  const bool wide = pl.wide;
  auto chained = [&](int k) { return wide ? s_g(k) : NONE; };
  std::vector<ProdSpec> prods;
  prods.push_back({EPI_TAN, width_mn(dims[1]), dims[1],
                   MapSpec{obs, rows, dims[0], 64, BM}, dims[0], s_v(0), 0,
                   NONE, NONE, boff[0], s_he(0), chained(0), -1});
  for (int k = 1; k < L; ++k)
    prods.push_back({EPI_TAN, width_mn(dims[k + 1]), dims[k + 1],
                     s_h(k - 1), dims[k], s_v(k), dims[k], s_wt(k),
                     chained(k - 1), boff[k], s_he(k), chained(k), -1});
  prods.push_back({EPI_HEAD, head, A, s_h(L - 1), dims[L], s_v(L), dims[L],
                   s_wt(L), chained(L - 1), boff[L], NONE, s_g(L), bcol[L]});
  for (int k = L; k >= 1; --k)
    prods.push_back({EPI_BWD, width_k(dims[k]), dims[k], NONE, 0, NONE,
                     dims[k + 1], s_wb(k), chained(k), -1, s_he(k - 1),
                     s_g(k - 1), bcol[k - 1]});
  pl.grid_a = cdiv(rows, BM);
  for (int i = 0; i < lay.n_a; ++i) {
    ArgsA& a = block<ArgsA>(out, lay.a, i);
    MapSet ms(a.maps);
    const int j0 = lay.n_a > 1 ? i : 0;
    const int j1 = lay.n_a > 1 ? i + 1 : static_cast<int>(prods.size());
    for (int j = j0; j < j1; ++j) put_prod(a, ms, prods[j]);
    if (ms.err != 0) return ms.err;
    a.rows = rows;
    a.act = act;
    a.pb = pb;
    a.wn = wn;
    a.m = m;
    a.colsum = colsum;
  }

  // phase B: every layer's output tiles times the row splits fill the card
  // once; the layers go in groups of MAX_LAYERS, one launch each
  auto nb_of = [&](int l) { return dims[l + 1] <= 64 ? 64 : 128; };
  int tiles = 0;
  for (int l = 0; l <= L; ++l)
    tiles += cdiv(dims[l], BM) * cdiv(dims[l + 1], nb_of(l));
  int n_split = (sms + tiles / 2) / tiles;
  n_split = n_split < 1 ? 1 : n_split < pl.grid_a ? n_split : pl.grid_a;
  const int rows_per_split = cdiv(cdiv(rows, n_split), BM) * BM;
  *splits = cdiv(rows, rows_per_split);
  for (int gi = 0; gi < lay.n_g; ++gi) {
    ArgsB& b = block<ArgsB>(out, lay.b, gi);
    MapSet ms(b.maps);
    const int l0 = gi * MAX_LAYERS;
    const int l1 = l0 + MAX_LAYERS < n_layers ? l0 + MAX_LAYERS : n_layers;
    int t = 0;
    for (int l = l0; l < l1; ++l) {
      LayerB& Ly = b.layer[l - l0];
      Ly.a_map = ms.get(l == 0 ? MapSpec{obs, rows, dims[0], 64, 64}
                               : s_he(l - 1));
      Ly.g_map = ms.get(s_g(l));
      Ly.kin = dims[l];
      Ly.n = dims[l + 1];
      Ly.nb = nb_of(l);
      Ly.tiles_j = cdiv(Ly.n, Ly.nb);
      Ly.first_tile = t;
      Ly.out = out_off[l];
      Ly.bcol = bcol[l];
      t += cdiv(Ly.kin, BM) * Ly.tiles_j;
    }
    if (ms.err != 0) return ms.err;
    b.n_layers = l1 - l0;
    b.n_tiles = t;
    b.rows = rows;
    b.rows_per_split = rows_per_split;
    b.row_tiles = pl.grid_a;
    b.pb = pb;
    b.colsum = colsum;
    b.P = P;

    UnpackArgs& u = block<UnpackArgs>(out, lay.u, gi);
    u.n_layers = l1 - l0;
    u.head = l1 - 1 == L ? L - l0 : -1;
    for (int l = l0; l < l1; ++l) {
      const int i = l - l0;
      u.dst[i] = static_cast<uint16_t*>(const_cast<void*>(V[l]));
      u.off[i] = woff[l];
      u.cols[i] = dims[l + 1];
      u.ld[i] = l == L ? pad8(dims[L]) : pad8(dims[l + 1]);
      u.start[i + 1] = u.start[i] + dims[l] * dims[l + 1];
    }
  }
  pl.n_layers = n_layers;
  return 0;
}

// One call on the flat f32 v: the tangent unpack, phase A (one launch, or
// one per product in a wide plan), phase B into `partial` (the caller then
// launches trpo_fvp_reduce). Returns the first launch error.
extern "C" int trpo_fvp16_run(const void* plan, const float* v,
                              float* partial, cudaStream_t stream) {
  const Plan& pl = *static_cast<const Plan*>(plan);
  static const cudaError_t attr = [] {
    cudaError_t e = cudaFuncSetAttribute(
        fvp16_phase_a_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        SMEM_A);
    if (e != cudaSuccess) return e;
    return cudaFuncSetAttribute(fvp16_phase_b_kernel,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                SMEM_B);
  }();
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const Layout lay = plan_layout(pl.n_layers);
  cudaError_t err = cudaSuccess;
  for (int gi = 0; gi < pl.n_g; ++gi) {
    UnpackArgs u = block<UnpackArgs>(plan, lay.u, gi);
    u.v = v;
    const int total = u.start[u.n_layers];
    const int blocks = cdiv(total, 256) < 1024 ? cdiv(total, 256) : 1024;
    fvp16_unpack_kernel<<<blocks, 256, 0, stream>>>(u);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  for (int i = 0; i < pl.n_a; ++i) {
    ArgsA a = block<ArgsA>(plan, lay.a, i);
    a.v = v;
    const int n_prod = a.n_prod, launches = pl.wide ? n_prod : 1;
    for (int j = 0; j < launches; ++j) {
      a.first = pl.wide ? j : 0;
      a.n_prod = pl.wide ? j + 1 : n_prod;
      const dim3 grid(pl.grid_a, pl.wide ? cdiv(a.prod[j].n, MAXW) : 1);
      fvp16_phase_a_kernel<<<grid, THREADS_A, SMEM_A, stream>>>(a);
      err = cudaGetLastError();
      if (err != cudaSuccess) return static_cast<int>(err);
    }
  }
  for (int gi = 0; gi < pl.n_g; ++gi) {
    ArgsB b = block<ArgsB>(plan, lay.b, gi);
    b.partial = partial;
    const int grid = b.n_tiles * cdiv(b.rows, b.rows_per_split);
    fvp16_phase_b_kernel<<<grid, THREADS_B, SMEM_B, stream>>>(b);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}
