// The tensor-core GEMM mainloop of the contextual attention: the bf16
// route (attention_tc.cu: one kernel template, six GEMMs; v1's two in
// attention_tc_v1.cu and the stage ablation's variants of two of them in
// attention_tc_ablate.cu) and the float32 route (attention_tf32.cu: the
// same six GEMMs in 3xTF32, attention_tf32_kernels.cuh; v1's and the
// ablation's in attention_tf32_v1.cu and attention_tf32_ablate.cu).
//
// Every operand is a tile of 128-byte rows (64 bf16 or 32 float32 values),
// loaded by TMA into shared memory in the 128-byte swizzle that wgmma reads.
// One thread keeps a ring of OP::STAGES stages in flight, each completing on
// its own `full` mbarrier; one warpgroup (128 threads) issues
// wgmma.mma_async on the tiles that have arrived (m64nNk16 in bf16, m64nNk8
// in TF32: either way four 32-byte K steps a row) and keeps the float32
// sums in registers. Each warp arrives on a stage's `empty` mbarrier once
// its products have read the stage, and the loading thread waits for all
// four before refilling it.
//
// The element type is a trait of the OP (`TF32`). A bf16 OP multiplies one
// B tile by its one or two A tiles (the hi and lo halves of a split
// operand). A TF32 OP holds each float32 operand as two tiles, big =
// tf32(x) and small = tf32(x - big), and runs the 3xTF32 products small big
// + big small + big big per K step, in that order, the small terms first
// (`split_tf32`). TF32 wgmma reads K-major operands only; an OP whose B
// arrives MN-major (`TRANSFORM`) rewrites it K-major, split, in shared
// memory before its products (attention_tf32_kernels.cuh).
//
// The 2-D shifts of the attention (the 9 window offsets of the score, the
// 4 or 16 taps of the paste) are TMA coordinates: each operand is a tensor
// map over a view whose outer dimensions are the hd x wd grid, loaded at the
// tile's grid corner plus a signed offset, and TMA fills what falls outside
// the grid with zeros. No thread computes an operand's address or bounds.
//
// Positions. A tile of 64 (or 128) positions is a rectangle of the grid in
// a padded row-major order: wdp = wd rounded up to a power of two >= 8 (to
// a multiple of 128 above 64), position (i, j) at flat index i * wdp + j.
// Columns j >= wd and rows i >= hd are phantoms: TMA gives them zeros or
// shifted neighbours, the epilogue writes nothing for them, and an (L, P)
// operand stored for a later GEMM holds zeros there (the scratch planes of
// width kp = hd * wdp rounded up to 64, see attention_cuda.py).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hv_tc {

constexpr int BK = 64;       // K chunk: one 128-byte swizzle row of bf16
constexpr int BK_F32 = 32;   // the same row of float32
constexpr int BM = 64;       // rows of a tile: one wgmma m64
constexpr int STAGES = 4;
constexpr int THREADS = 128;  // one warpgroup
constexpr int TILE_BYTES = BM * BK * 2;     // 8 KiB: 64 rows of 128 bytes
constexpr int STAGE_BYTES = 3 * TILE_BYTES;  // 24 KiB: A, A or B, B
constexpr int SMEM_BYTES = STAGES * STAGE_BYTES + 1024;  // + alignment slack

// The ring and element type of the bf16 OPs (each derives from it): bf16
// tiles, wgmma k16, one B tile, STAGES stages of STAGE_BYTES.
struct Bf16Ring {
  static constexpr bool TF32 = false;
  static constexpr bool TRANSFORM = false;
  static constexpr int STAGES = hv_tc::STAGES;
  static constexpr int STAGE_BYTES = hv_tc::STAGE_BYTES;
  static constexpr int PROMOTE = 0;  // see mainloop
};

// Dynamic shared memory of a GEMM kernel over OP's ring.
template <class OP>
constexpr int smem_bytes() {
  return OP::STAGES * OP::STAGE_BYTES + 1024;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4)
      : "memory");
}

// wgmma shared-memory descriptor of a tile in the 128-byte swizzle.
// K-major (rows of 64 K values): SBO = 1024 bytes between 8-row groups, LBO
// unused; a 16-deep K step adds 32 bytes to the start. MN-major (rows of 64
// N values, one row per K): SBO = 1024 bytes between groups of 8 K rows,
// LBO (between 64-wide N atoms) unused at N = 64; a K step adds 2048 bytes.
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  uint64_t d = (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // LBO (unused)
  d |= (uint64_t)(1024 >> 4) << 32;  // SBO
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
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

// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous wgmma.
template <int R>
__device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define HV_F8(i)                                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d = A B + (accumulate ? d : 0) for one 16-deep step: A (64 x 16)
// K-major, B (16 x N) K-major (TRANS_B = 0) or MN-major (TRANS_B = 1), both
// from shared memory.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], uint64_t da, uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %35, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %34;\n"
      "}\n"
      : HV_F8(0), HV_F8(8), HV_F8(16), HV_F8(24)
      : "l"(da), "l"(db), "n"(TRANS_B), "r"(accumulate));
}

template <int TRANS_B>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %67, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %66;\n"
      "}\n"
      : HV_F8(0), HV_F8(8), HV_F8(16), HV_F8(24), HV_F8(32), HV_F8(40), HV_F8(48), HV_F8(56)
      : "l"(da), "l"(db), "n"(TRANS_B), "r"(accumulate));
}

// As wgmma_n64 with A (64 x 16) from registers: four 32-bit registers of
// two bf16 each, in the layout `a_frag_row` and `a_frag_col` give.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_n64_ra(float (&d)[32], const uint32_t (&a)[4], uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %38, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %37;\n"
      "}\n"
      : HV_F8(0), HV_F8(8), HV_F8(16), HV_F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "n"(TRANS_B), "r"(accumulate));
}

// The TF32 forms, one 8-deep step: A (64 x 8) and B (8 x N) from shared
// memory, both K-major (TF32 wgmma has no transpose).
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1;\n"
      "}\n"
      : HV_F8(0), HV_F8(8), HV_F8(16), HV_F8(24)
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1;\n"
      "}\n"
      : HV_F8(0), HV_F8(8), HV_F8(16), HV_F8(24), HV_F8(32), HV_F8(40), HV_F8(48), HV_F8(56)
      : "l"(da), "l"(db), "r"(accumulate));
}

#undef HV_F8

// The 3xTF32 split of a float32 value: big = tf32(v), small = tf32(v -
// big), each rounded to nearest (cvt.rna, ties away from zero) with the
// low 13 mantissa bits zero, which the tensor cores would otherwise drop.
// |v - big - small| <= 2^-22 |v|, and the dropped small * small is below
// 2^-22 |v w| too.
__device__ __forceinline__ float tf32_rna(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return __uint_as_float(r);
}
__device__ __forceinline__ void split_tf32(float v, float& big, float& small) {
  big = tf32_rna(v);
  small = tf32_rna(v - big);
}

// Row and column of accumulator register i of thread `tid` in an m64nN
// tile: warp w owns rows 16w..16w+15; register 4j+q holds row lane/4 (+8
// for q >= 2) and column 8j + 2 (lane % 4) (+1 for odd q). A register-A
// fragment of a 16-deep step: register q holds row lane/4 (+8 for odd q)
// of the warp's 16 and columns 2 (lane % 4), +1 (+8 for q >= 2).
__device__ __forceinline__ int acc_row(int tid, int i) {
  return (tid / 32) * 16 + ((i >> 1) & 1) * 8 + (tid % 32) / 4;
}
__device__ __forceinline__ int acc_col(int tid, int i) {
  return (i >> 2) * 8 + (tid % 4) * 2 + (i & 1);
}
__device__ __forceinline__ int a_frag_row(int tid, int q) {
  return (tid / 32) * 16 + (q & 1) * 8 + (tid % 32) / 4;
}
__device__ __forceinline__ int a_frag_col(int tid, int q) {
  return (q >> 1) * 8 + (tid % 4) * 2;
}

// The products of one stage (one 128-byte row deep: 64 bf16 or 32 TF32
// values, four 32-byte steps) into acc; the first product of the GEMM (it
// == 0) overwrites the sums. TF32: A big and small at 0 and TILE_BYTES, B
// big and small at B_OFF and B_OFF + BN rows of 128 bytes, all K-major; an
// OP with one A tile (NA = 1: operands whose values are exact in TF32, the
// ablation's paste_bf16) takes big big alone.
template <class OP>
__device__ __forceinline__ void stage_products(uint32_t st, int it, float (&acc)[OP::BN / 2]) {
  constexpr int B_OFF = OP::NA * TILE_BYTES;
  if constexpr (OP::TF32) {
    constexpr int B_TILE = OP::BN * 128;
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t a_big = desc_sw128(st + kk * 32);
      const uint64_t b_big = desc_sw128(st + B_OFF + kk * 32);
      if constexpr (OP::NA == 1) {
        wgmma_tf32(acc, a_big, b_big, it > 0 || kk > 0);
      } else {
        const uint64_t a_small = desc_sw128(st + TILE_BYTES + kk * 32);
        const uint64_t b_small = desc_sw128(st + B_OFF + B_TILE + kk * 32);
        wgmma_tf32(acc, a_small, b_big, it > 0 || kk > 0);
        wgmma_tf32(acc, a_big, b_small, 1);
        wgmma_tf32(acc, a_big, b_big, 1);
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db = desc_sw128(st + B_OFF + (OP::TRANS_B ? kk * 2048 : kk * 32));
#pragma unroll
      for (int a = 0; a < OP::NA; ++a) {
        const uint64_t da = desc_sw128(st + a * TILE_BYTES + kk * 32);
        // the first product overwrites the sums: no zero fill of the
        // registers, which would serialise the wgmma pipeline
        const int accumulate = it > 0 || kk > 0 || a > 0;
        if constexpr (OP::BN == 128) {
          wgmma_n128<OP::TRANS_B>(acc, da, db, accumulate);
        } else {
          wgmma_n64<OP::TRANS_B>(acc, da, db, accumulate);
        }
      }
    }
  }
}

// Issues, commits and (REG_A) waits for the products of one stage. An op
// with REG_A builds its A operand in registers from the stage's two A
// tiles (`fragments`: the hi and lo halves of a split operand, rebuilt,
// for each 16-deep step) and multiplies them with the B tile in shared
// memory; the registers are rewritten for the next stage, so it waits for
// its own products.
template <class OP>
__device__ __forceinline__ void issue_products(const OP& op, int it, uint8_t* st,
                                               float (&acc)[OP::BN / 2]) {
  // the first product of a run of PROMOTE stages (of the GEMM when 0)
  // overwrites the sums
  const int run_it = OP::PROMOTE > 0 ? it % OP::PROMOTE : it;
  if constexpr (OP::REG_A) {
    constexpr int B_OFF = OP::NA * TILE_BYTES;
    uint32_t frag[BK / 16][2][4];
    op.fragments(it, st, frag);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t db =
          desc_sw128(smem_u32(st) + B_OFF + (OP::TRANS_B ? kk * 2048 : kk * 32));
#pragma unroll
      for (int a = 0; a < 2; ++a)
        wgmma_n64_ra<OP::TRANS_B>(acc, frag[kk][a], db, run_it > 0 || kk > 0 || a > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
  } else {
    if constexpr (OP::TRANSFORM) {
      // every thread rewrites its share of the stage's operands; the
      // generic-proxy stores are made visible to wgmma's async proxy, and
      // the warpgroup meets, before any product reads them
      op.transform(it, st);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
    }
    wgmma_fence();
    stage_products<OP>(smem_u32(st), run_it, acc);
    wgmma_commit();
  }
}

// The mainloop. OP supplies
//   static constexpr int BN, NA (1 or 2 A tiles per stage, summed into one
//   product: the hi and lo halves of a split operand), TRANS_B;
//   static constexpr bool TF32 (see stage_products), TRANSFORM (and then
//   void transform(int it, uint8_t* stage) const, run by every thread once
//   the stage has arrived; see issue_products);
//   static constexpr int STAGES, STAGE_BYTES: the ring (Bf16Ring for bf16);
//   static constexpr bool REG_A (and then void fragments(int it, const
//   uint8_t* stage, uint32_t (&frag)[BK / 16][2][4]) const, run by every
//   thread; see issue_products);
//   static constexpr int PROMOTE (below);
//   int iters() const;
//   void load(int it, uint8_t* a0, uint8_t* a1, uint8_t* b, uint64_t* bar) const
//     (issues the stage's TMA loads on `bar`, thread 0 only);
//   uint32_t stage_bytes() const;
// and returns the sums in acc (the kernel's epilogue writes them out). Each
// stage holds A tiles at 0 and TILE_BYTES and the B tile(s) at B_OFF.
//
// PROMOTE. The tensor cores add each step's products to the float32 sums
// and truncate the result (round toward zero), so over a long K the error
// of a large sum grows with the number of steps, one way: a float32 (P, C)
// GEMM (4 to 9 taps of kp = 1024 positions, 3 products a step) whose sums
// reach ~170 (the ablation's no_softmax pastes the unnormalised fused
// scores) drifted 1.4e-3 from the plain version on an H100, against the
// 3e-4 + 1e-5 max|y| of its gate (tests/test_torch_cuda_kernel.py; a CPU
// emulation of the truncation gives 1.2e-3). An OP with PROMOTE > 0 runs
// its products into registers of their own, restarted every PROMOTE stages
// and added to acc (round to nearest) once the run's products are done: a
// run's sum is small and its truncation errors take the sign of each run
// (the emulation: 4.2e-5 at PROMOTE = 4). 0: the products go into acc.
template <class OP>
__device__ __forceinline__ void promote(int it, int n_it, float (&part)[OP::BN / 2],
                                        float (&acc)[OP::BN / 2]) {
  if ((it + 1) % OP::PROMOTE == 0 || it + 1 == n_it) {
    wgmma_wait<0>();
    fence_acc(part);
#pragma unroll
    for (int i = 0; i < OP::BN / 2; ++i) acc[i] += part[i];
  }
}

// The products go into wacc; with PROMOTE, `promote` adds them to sums.
template <class OP>
__device__ __forceinline__ void mainloop_ring(const OP& op, float (&wacc)[OP::BN / 2],
                                              float (&sums)[OP::BN / 2]) {
  constexpr int B_OFF = OP::NA * TILE_BYTES;
  constexpr int NST = OP::STAGES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full[NST];
  __shared__ __align__(8) uint64_t empty[NST];
  // the 128-byte swizzle repeats every 1024 bytes: align the ring to it
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int n_it = op.iters();

  if (tid == 0) {
    for (int s = 0; s < NST; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], THREADS / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  auto issue = [&](int it) {
    const int s = it % NST;
    uint8_t* st = smem + s * OP::STAGE_BYTES;
    mbar_expect_tx(&full[s], op.stage_bytes());
    op.load(it, st, st + TILE_BYTES, st + B_OFF, &full[s]);
  };
  if (tid == 0) {
    for (int it = 0; it < NST && it < n_it; ++it) issue(it);
  }
  for (int it = 0; it < n_it; ++it) {
    const int s = it % NST;
    mbar_wait(&full[s], (it / NST) & 1);
    fence_acc(wacc);
    issue_products(op, it, smem + s * OP::STAGE_BYTES, wacc);
    // one group stays in flight; this warp's products of the previous one
    // are done, so it releases that stage. The stage is refilled once all
    // four warps have released it: wait_group orders only its own warp.
    wgmma_wait<1>();
    fence_acc(wacc);
    if (it >= 1) {
      const int prev = it - 1;
      if (tid % 32 == 0) mbar_arrive(&empty[prev % NST]);
      if (tid == 0 && prev + NST < n_it) {
        mbar_wait(&empty[prev % NST], (prev / NST) & 1);
        issue(prev + NST);
      }
    }
    if constexpr (OP::PROMOTE > 0) promote<OP>(it, n_it, wacc, sums);
  }
  wgmma_wait<0>();
  fence_acc(wacc);
}

template <class OP>
__device__ __forceinline__ void mainloop(const OP& op, float (&acc)[OP::BN / 2]) {
  if constexpr (OP::PROMOTE > 0) {
    float part[OP::BN / 2];
#pragma unroll
    for (int i = 0; i < OP::BN / 2; ++i) acc[i] = 0.f;
    mainloop_ring(op, part, acc);
  } else {
    mainloop_ring(op, acc, acc);
  }
}

// The mainloop at ring depth 1: synchronous loads. Each iteration loads its
// stage, waits for it, runs its products and waits for them
// (wgmma_wait<0>), and the warpgroup meets before the next load overwrites
// the stage: no load overlaps a product. (`mainloop` with STAGES = 1 would
// deadlock: it refills a stage one iteration late, after the next `full`
// wait.) The products are `mainloop`'s, in the same order, and so are the
// promotions, so the sums are bit-equal. The kernel keeps the ring's shared-memory request, so that the
// blocks an SM holds, and with them the latency other blocks hide, stay the
// same.
template <class OP>
__device__ __forceinline__ void mainloop_sync_ring(const OP& op, float (&wacc)[OP::BN / 2],
                                                   float (&sums)[OP::BN / 2]) {
  constexpr int B_OFF = OP::NA * TILE_BYTES;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full;
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const int tid = threadIdx.x;
  const int n_it = op.iters();

  if (tid == 0) {
    mbar_init(&full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  for (int it = 0; it < n_it; ++it) {
    if (tid == 0) {
      mbar_expect_tx(&full, op.stage_bytes());
      op.load(it, smem, smem + TILE_BYTES, smem + B_OFF, &full);
    }
    mbar_wait(&full, it & 1);
    fence_acc(wacc);
    issue_products(op, it, smem, wacc);
    wgmma_wait<0>();
    fence_acc(wacc);
    if constexpr (OP::PROMOTE > 0) promote<OP>(it, n_it, wacc, sums);
    __syncthreads();
  }
}

template <class OP>
__device__ __forceinline__ void mainloop_sync(const OP& op, float (&acc)[OP::BN / 2]) {
  if constexpr (OP::PROMOTE > 0) {
    float part[OP::BN / 2];
#pragma unroll
    for (int i = 0; i < OP::BN / 2; ++i) acc[i] = 0.f;
    mainloop_sync_ring(op, part, acc);
  } else {
    mainloop_sync_ring(op, acc, acc);
  }
}

// Shift (sy, sx) and phase plane of tap `tap` of each GEMM.
//   window: the 9 offsets of a 3 x 3 window, o = (tap / 3 - 1, tap % 3 - 1);
//   paste: offset ab in 0..3 of output phase (r, t) = (phase / 2,
//     phase % 2), (a, bb) = (ab / 2 - r, ab % 2 - t); the 16 taps of the
//     paste's adjoint in probs are phase = tap / 4, ab = tap % 4.
__device__ __forceinline__ void window_tap(int tap, int& sy, int& sx) {
  sy = tap / 3 - 1;
  sx = tap % 3 - 1;
}
__device__ __forceinline__ void paste_tap(int phase, int ab, int& sy, int& sx) {
  sy = ab / 2 - phase / 2;
  sx = ab % 2 - phase % 2;
}

}  // namespace hv_tc
