// The pieces of the float32 tensor-core route (3xTF32) of the contextual
// attention: the (L, P) and (P, C) GEMMs on the mainloop of
// attention_tc.cuh with float32 tiles, and the split of a float32 map into
// its TF32 halves. The forward and backward (attention_tf32.cu), v1
// (attention_tf32_v1.cu) and the stage ablation (attention_tf32_ablate.cu)
// instantiate them; the sweeps and epilogues are attention_tc_kernels.cuh's
// on float32 planes. attention_tf32.cu's note gives the design.
//
// Internal linkage, as attention_tc_kernels.cuh: each translation unit
// compiles its own copy of each kernel it instantiates.
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_tc_kernels.cuh"

namespace {

constexpr int TF32_STAGES = 2;

struct Tf32Ring {
  static constexpr bool TF32 = true;
  static constexpr bool REG_A = false;
  static constexpr int STAGES = TF32_STAGES;
  static constexpr int NA = 2;  // A big and small
  static constexpr int TRANS_B = 0;
  static constexpr int PROMOTE = 0;  // see mainloop (attention_tc.cuh)
};

// (L, P) GEMMs in 3xTF32, as LPOp: score (9 window taps of bd (A) and fd
// (B)) and dprobs (16 paste taps of the phase planes of b_full (A) and dy
// (B)); every map split beforehand into big and small, read in boxes of
// 32 channels. Stage: A big, A small (64 x 32), B big, B small (128 x 32).
template <int KIND>
struct LPOpTf32 : Tf32Ring {
  static constexpr int BN = 128;
  static constexpr bool TRANSFORM = false;
  static constexpr int STAGE_BYTES = 2 * TILE_BYTES + 2 * BN * 128;  // 48 KiB
  const CUtensorMap* ma_big;
  const CUtensorMap* ma_small;
  const CUtensorMap* mb_big;
  const CUtensorMap* mb_small;
  int b, li0, lj0, pi0, pj0, chunks;
  __device__ int iters() const { return (KIND == kDprobs ? 16 : 9) * chunks; }
  __device__ uint32_t stage_bytes() const { return STAGE_BYTES; }
  __device__ void load(int it, uint8_t* a0, uint8_t* a1, uint8_t* bt, uint64_t* bar) const {
    const int tap = it / chunks, k0 = (it % chunks) * BK_F32;
    int sy, sx, ph = 0;
    if (KIND == kDprobs) {
      ph = tap / 4;
      paste_tap(ph, tap % 4, sy, sx);
    } else {
      window_tap(tap, sy, sx);
    }
    tma_load_5d(a0, ma_big, bar, k0, lj0 + sx, li0 + sy, ph, b);
    tma_load_5d(a1, ma_small, bar, k0, lj0 + sx, li0 + sy, ph, b);
    tma_load_5d(bt, mb_big, bar, k0, pj0 + sx, pi0 + sy, ph, b);
    tma_load_5d(bt + BN * 128, mb_small, bar, k0, pj0 + sx, pi0 + sy, ph, b);
  }
};

// (P, C) GEMMs in 3xTF32, as PCOp (paste, db_full, dfd, dbd): A the split
// scratch planes (kp, wd, hd, B) at the tile's 64 output positions minus
// the tap, K blocks of 32 entries; B the feature map (Cp, wd, hd, phase,
// B) itself, unsplit, its 32 K rows (positions) plus the tap, loaded as
// two boxes of 32 channels (channel rows of 128 bytes, MN-major), then
// rewritten K-major and split by `transform`. Stage: A big, A small, B big,
// B small (64 x 32 each, K-major), B as loaded (two 32 x 32 tiles).
// The paste's variants (VAR, the ablation's): kPasteBf16 loads the big
// plane alone (the sweep wrote probs rounded to bf16 there) and rounds B
// to bf16 in the transform: one product a step, exact in TF32; kFoldNorm
// scales each A row, the unnormalised probs column p = m - s, by
// col_inv[p] in the transform, big + small times it split again. IO: see
// PasteIO (kNaturalToNatural reads b_full through natural_map<float>).
// Their K runs to 4 or 9 taps of kp positions: the sums are promoted every
// 4 stages (128 K values; `mainloop`'s PROMOTE).
template <int KIND, int VAR = kFull, int IO = kPlanesToNatural>
struct PCOpTf32 : Tf32Ring {
  static constexpr int BN = 64;
  static constexpr int PROMOTE = 4;
  static constexpr int NA = VAR == kPasteBf16 ? 1 : 2;
  static constexpr bool TRANSFORM = true;
  static constexpr bool PASTE = KIND == kPaste || KIND == kDbfull;
  static constexpr int RAW_OFF = 4 * TILE_BYTES;
  static constexpr int STAGE_BYTES = 5 * TILE_BYTES;  // 40 KiB
  const CUtensorMap* ma_big;
  const CUtensorMap* ma_small;
  const CUtensorMap* mb;
  int b, mi0, mj0, c0, wdp, phase, chunks;
  const float* col_inv;  // kFoldNorm: (B, L)
  int hd, wd;
  __device__ int iters() const { return (PASTE ? 4 : 9) * chunks; }
  __device__ uint32_t stage_bytes() const { return (NA + 1) * TILE_BYTES; }
  __device__ void tap(int it, int& sy, int& sx) const {
    if (PASTE) {
      paste_tap(phase, it / chunks, sy, sx);
    } else {
      window_tap(it / chunks, sy, sx);
    }
  }
  __device__ void load(int it, uint8_t* a0, uint8_t* a1, uint8_t* bt, uint64_t* bar) const {
    const int k0 = (it % chunks) * BK_F32;
    int sy, sx;
    tap(it, sy, sx);
    tma_load_4d(a0, ma_big, bar, k0, mj0 - sx, mi0 - sy, b);
    if (NA == 2) tma_load_4d(a1, ma_small, bar, k0, mj0 - sx, mi0 - sy, b);
    uint8_t* raw = bt + (RAW_OFF - NA * TILE_BYTES);
    for (int half = 0; half < 2; ++half) {
      uint8_t* dst = raw + half * (TILE_BYTES / 2);
      if (IO == kNaturalToNatural) {
        // column phase t, then every second row from 2 (i + sy) + r
        tma_load_5d(dst, mb, bar, c0 + half * BK_F32, phase % 2, k0 % wdp + sx,
                    2 * (k0 / wdp + sy) + phase / 2, b);
      } else {
        tma_load_5d(dst, mb, bar, c0 + half * BK_F32, k0 % wdp + sx, k0 / wdp + sy,
                    PASTE ? phase : 0, b);
      }
    }
  }
  // B as loaded: half h holds channels c0 + 32 h ..; row k (position k of
  // the block) at k * 128, channel cc's 16-byte chunk cc / 4 at chunk
  // (cc / 4) ^ (k % 8) (the 128-byte swizzle). Written: row c (channel) of
  // the big and small tiles holds the block's 32 positions, chunk q (k =
  // 4q .. 4q + 3) at chunk q ^ (c % 8). Thread t takes channel t % 64 and
  // positions 16 (t / 64) .. + 15: a warp loads 32 channels of one row (32
  // banks) and stores 32 rows' chunk q (eight 16-byte columns, four
  // wavefronts for 512 bytes). kFoldNorm first rescales A: thread t takes
  // half t % 2 of row t / 2 of both A tiles (the swizzle permutes chunks
  // within a row, and the row has one scale). Row r holds grid position
  // (mi0 - sy + r / w, mj0 - sx + r % w), w the box width; zero off the
  // grid, where TMA filled zeros.
  __device__ void transform(int it, uint8_t* st) const {
    const int t = threadIdx.x;
    if constexpr (VAR == kFoldNorm) {
      int sy, sx;
      tap(it, sy, sx);
      const int r = t / 2, w = wdp < BM ? wdp : BM;
      const int pi = mi0 - sy + r / w, pj = mj0 - sx + r % w;
      const float inv = (pi >= 0 && pi < hd && pj >= 0 && pj < wd)
                            ? col_inv[((size_t)b * hd + pi) * wd + pj]
                            : 0.f;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        float4* big = reinterpret_cast<float4*>(st + r * 128 + ((t % 2) * 4 + q) * 16);
        float4* small = reinterpret_cast<float4*>(reinterpret_cast<uint8_t*>(big) + TILE_BYTES);
        float4 vb = *big, vs = *small;
        split_tf32((vb.x + vs.x) * inv, vb.x, vs.x);
        split_tf32((vb.y + vs.y) * inv, vb.y, vs.y);
        split_tf32((vb.z + vs.z) * inv, vb.z, vs.z);
        split_tf32((vb.w + vs.w) * inv, vb.w, vs.w);
        *big = vb;
        *small = vs;
      }
    }
    const int c = t % 64, kh = t / 64;
    const uint8_t* raw = st + RAW_OFF + (c / 32) * (TILE_BYTES / 2);
    const int cq = (c % 32) / 4, cb = (c % 4) * 4;
    uint8_t* big = st + NA * TILE_BYTES;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float vb[4], vs[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = kh * 16 + q * 4 + e;
        const float v = *reinterpret_cast<const float*>(raw + k * 128 + ((cq ^ (k % 8)) * 16) + cb);
        if constexpr (VAR == kPasteBf16) {
          vb[e] = __bfloat162float(__float2bfloat16(v));
        } else {
          split_tf32(v, vb[e], vs[e]);
        }
      }
      const int at = c * 128 + (((kh * 4 + q) ^ (c % 8)) * 16);
      *reinterpret_cast<float4*>(big + at) = make_float4(vb[0], vb[1], vb[2], vb[3]);
      if constexpr (VAR != kPasteBf16) {
        *reinterpret_cast<float4*>(big + TILE_BYTES + at) = make_float4(vs[0], vs[1], vs[2], vs[3]);
      }
    }
  }
};

// One (L, P) tile at ring depth NSTAGES (TF32_STAGES, or 1 for
// mainloop_sync).
template <int KIND, int NSTAGES>
__device__ __forceinline__ void lp_tile_tf32(const CUtensorMap& ma_big, const CUtensorMap& ma_small,
                                             const CUtensorMap& mb_big, const CUtensorMap& mb_small,
                                             const Geom& g, const float* __restrict__ nrm_raw,
                                             float* __restrict__ out) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * 128;
  const LPOpTf32<KIND> op{{}, &ma_big, &ma_small, &mb_big, &mb_small, b, m0 / g.wdp, m0 % g.wdp,
                          n0 / g.wdp, n0 % g.wdp, g.Cp / BK_F32};
  float acc[64];
  if constexpr (NSTAGES == 1) {
    mainloop_sync(op, acc);
  } else {
    mainloop(op, acc);
  }
  lp_store<KIND>(acc, g, b, m0, n0, nrm_raw, out);
}

// One (P, C) tile; out float32 (see pc_store).
template <int KIND, int VAR, int IO, int NSTAGES>
__device__ __forceinline__ void pc_tile_tf32(const CUtensorMap& ma_big, const CUtensorMap& ma_small,
                                             const CUtensorMap& mb, const Geom& g,
                                             const float* __restrict__ dn2,
                                             const float* __restrict__ bd,
                                             const float* __restrict__ col_inv,
                                             float* __restrict__ out) {
  using Op = PCOpTf32<KIND, VAR, IO>;
  const int b = blockIdx.z;
  const int phase = Op::PASTE ? blockIdx.y % 4 : 0;
  const int m0 = (Op::PASTE ? blockIdx.y / 4 : blockIdx.y) * BM, c0 = blockIdx.x * 64;
  const Op op{{}, &ma_big, &ma_small, &mb, b, m0 / g.wdp, m0 % g.wdp, c0, g.wdp, phase,
              g.kp / BK_F32, col_inv, g.hd, g.wd};
  float acc[32];
  if constexpr (NSTAGES == 1) {
    mainloop_sync(op, acc);
  } else {
    mainloop(op, acc);
  }
  pc_store<KIND, IO, float>(acc, g, b, phase, m0, c0, dn2, bd, out);
}

// Grid (ceil(hd wdp / 128), ceil(hd wdp / 64), B).
template <int KIND>
__global__ void __launch_bounds__(THREADS)
lp_gemm_tf32(const __grid_constant__ CUtensorMap ma_big, const __grid_constant__ CUtensorMap ma_small,
             const __grid_constant__ CUtensorMap mb_big, const __grid_constant__ CUtensorMap mb_small,
             Geom g, const float* __restrict__ nrm_raw, float* __restrict__ out) {
  lp_tile_tf32<KIND, TF32_STAGES>(ma_big, ma_small, mb_big, mb_small, g, nrm_raw, out);
}

// Grid (Cp / 64, ceil(hd wdp / 64) x phases, B).
template <int KIND>
__global__ void __launch_bounds__(THREADS)
pc_gemm_tf32(const __grid_constant__ CUtensorMap ma_big, const __grid_constant__ CUtensorMap ma_small,
             const __grid_constant__ CUtensorMap mb, Geom g, const float* __restrict__ dn2,
             const float* __restrict__ bd, float* __restrict__ out) {
  pc_tile_tf32<KIND, kFull, kPlanesToNatural, TF32_STAGES>(ma_big, ma_small, mb, g, dn2, bd,
                                                           nullptr, out);
}

// big and small TF32 halves of n float32 values, n a multiple of 4 (a
// feature map with Cp channels), four a thread, grid-stride.
__global__ void split_kernel(const float4* __restrict__ x, float4* __restrict__ big,
                             float4* __restrict__ small, size_t n4) {
  for (size_t i = blockIdx.x * (size_t)blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    const float4 v = x[i];
    float4 hb, hs;
    split_tf32(v.x, hb.x, hs.x);
    split_tf32(v.y, hb.y, hs.y);
    split_tf32(v.z, hb.z, hs.z);
    split_tf32(v.w, hb.w, hs.w);
    big[i] = hb;
    small[i] = hs;
  }
}

int split_async(const float* x, float* big, float* small, size_t n, cudaStream_t st) {
  const size_t n4 = n / 4;
  const int blocks = (int)((n4 + 255) / 256 < 132 * 16 ? (n4 + 255) / 256 : 132 * 16);
  split_kernel<<<blocks, 256, 0, st>>>(reinterpret_cast<const float4*>(x),
                                       reinterpret_cast<float4*>(big),
                                       reinterpret_cast<float4*>(small), n4);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_lp_tf32(const CUtensorMap& ma_big, const CUtensorMap& ma_small,
                   const CUtensorMap& mb_big, const CUtensorMap& mb_small, const Geom& g, int B,
                   const float* nrm_raw, float* out, cudaStream_t st) {
  constexpr int bytes = smem_bytes<LPOpTf32<KIND>>();
  HV_TRY(smem_attribute(lp_gemm_tf32<KIND>, bytes));
  lp_gemm_tf32<KIND><<<lp_grid(g, B), THREADS, bytes, st>>>(ma_big, ma_small, mb_big, mb_small, g,
                                                             nrm_raw, out);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_pc_tf32(const CUtensorMap& ma_big, const CUtensorMap& ma_small, const CUtensorMap& mb,
                   const Geom& g, int B, const float* dn2, const float* bd, float* out,
                   cudaStream_t st) {
  using Op = PCOpTf32<KIND>;
  constexpr int bytes = smem_bytes<Op>();
  HV_TRY(smem_attribute(pc_gemm_tf32<KIND>, bytes));
  pc_gemm_tf32<KIND><<<pc_grid(g, B, Op::PASTE ? 4 : 1), THREADS, bytes, st>>>(
      ma_big, ma_small, mb, g, dn2, bd, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
