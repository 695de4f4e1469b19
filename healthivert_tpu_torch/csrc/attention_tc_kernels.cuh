// The pieces of the tensor-core routes of the contextual attention: the
// grid geometry, the score and paste GEMMs of the bf16 route on the
// mainloop of attention_tc.cuh and the epilogues of every GEMM, the sweeps
// between the GEMMs (fuse + softmax, the split of probs, the fuse
// adjoint), and the tensor maps. The bf16 route (attention_tc.cu)
// instantiates every template at its defaults; its stage ablation
// (attention_tc_ablate.cu) and v1 (attention_tc_v1.cu) add bf16
// instantiations, and the float32 route (attention_tf32.cu, its v1 and
// ablation; GEMMs in attention_tf32_kernels.cuh) instantiates the sweeps
// with float32 planes (PT = float) and the maps over float32. None of them
// puts a branch into another's kernels.
//
// Everything here has internal linkage (the top-level anonymous namespace,
// which the including file's own code shares): each translation unit that
// includes the file compiles and registers its own copy of each kernel.
#pragma once

#include <type_traits>

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "attention_tc.cuh"
#include "attention_v2_kernels.cuh"

namespace {

using namespace hv_tc;
using bf16 = __nv_bfloat16;
using hv_attn::kFoldNorm;
using hv_attn::kFull;
using hv_attn::kNoFuse;
using hv_attn::kNoSoftmax;
using hv_attn::kPasteBf16;
using hv_attn::SM_COLS;
using hv_attn::SM_ROWS;

// Grid geometry shared by every kernel. wdp: the padded row length of the
// position order; kp: the width of an (L, P) scratch plane row (positions
// in that order, zero at phantoms). Cp: channels padded to a multiple of 64.
struct Geom {
  int hd, wd, wdp, kp, C, Cp;
  __host__ __device__ __forceinline__ int L() const { return hd * wd; }
  // real grid index of padded position q, or -1 for a phantom
  __device__ __forceinline__ int real(int q) const {
    const int i = q / wdp, j = q % wdp;
    return (i < hd && j < wd) ? i * wd + j : -1;
  }
};

enum GemmKind : int { kScore, kDprobs, kPaste, kDbfull, kDfd, kDbd };

// Where the paste's B operand (b_full) comes from and where y goes:
//   kPlanesToNatural   b_full's phase planes (B, 4, hd, wd, Cp), split in
//                      the wrapper; y (B, 2hd, 2wd, C). The forward's.
//   kNaturalToNatural  b_full itself (B, 2hd, 2wd, Cp), through a tensor
//                      map with element stride 2 (natural_map); y natural.
//   kPlanesToPlanes    phase planes in, y as phase planes (B, 2, 2, hd, wd,
//                      C): the ablation's phase layout.
enum PasteIO : int { kPlanesToNatural = 0, kNaturalToNatural, kPlanesToPlanes };

// (L, P) GEMMs, M = rows l, N = columns p, K = taps x channels; both
// operands K-major feature maps (Cp, wd, hd, phase, B), rows shifted by the
// tap. score: 9 window taps of bd (A) and fd (B); dprobs: the 16 paste taps
// of the phase planes of b_full (A) and dy (B).
template <int KIND>
struct LPOp : Bf16Ring {
  static constexpr int BN = 128, NA = 1, TRANS_B = 0;
  static constexpr bool REG_A = false;
  const CUtensorMap* ma;
  const CUtensorMap* mb;
  int b, li0, lj0, pi0, pj0, chunks;
  __device__ int iters() const { return (KIND == kDprobs ? 16 : 9) * chunks; }
  __device__ uint32_t stage_bytes() const { return 3 * TILE_BYTES; }
  __device__ void load(int it, uint8_t* a0, uint8_t*, uint8_t* bt, uint64_t* bar) const {
    const int tap = it / chunks, k0 = (it % chunks) * BK;
    int sy, sx, ph = 0;
    if (KIND == kDprobs) {
      ph = tap / 4;
      paste_tap(ph, tap % 4, sy, sx);
    } else {
      window_tap(tap, sy, sx);
    }
    tma_load_5d(a0, ma, bar, k0, lj0 + sx, li0 + sy, ph, b);
    tma_load_5d(bt, mb, bar, k0, pj0 + sx, pi0 + sy, ph, b);
  }
};

// The epilogue of an (L, P) tile at rows m0, columns n0 of sample b:
// out[b, l, p] (B, L, P) float, the score divided by max(nrm_raw[l],
// 1e-4), or dprobs / 4.
template <int KIND>
__device__ __forceinline__ void lp_store(const float (&acc)[64], const Geom& g, int b, int m0,
                                         int n0, const float* __restrict__ nrm_raw,
                                         float* __restrict__ out) {
  const int tid = threadIdx.x;
  const int L = g.L();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = g.real(m0 + acc_row(tid, 2 * h));
    if (l < 0) continue;
    const float scale =
        KIND == kDprobs ? 0.25f : 1.f / fmaxf(nrm_raw[(size_t)b * L + l], 1e-4f);
    float* row = out + ((size_t)b * L + l) * L;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const int p = g.real(n0 + acc_col(tid, i));
        if (p >= 0) row[p] = acc[i] * scale;
      }
    }
  }
}

// The epilogues of v1's GEMMs (attention_tc_v1.cu, attention_tf32_v1.cu):
// an (L, P) tile of s (B, L, P) float at rows m0, columns n0, with row
// scale 1 (wnorm arrives normalised); a (P, C) tile of vals (B, P, C) in T
// at positions m0, columns c0, cut back to the real C.
__device__ __forceinline__ void v1_store_scores(const float (&acc)[64], const Geom& g, int b,
                                                int m0, int n0, float* __restrict__ out) {
  const int tid = threadIdx.x;
  const int L = g.L();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int l = g.real(m0 + acc_row(tid, 2 * h));
    if (l < 0) continue;
    float* row = out + ((size_t)b * L + l) * L;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const int p = g.real(n0 + acc_col(tid, i));
        if (p >= 0) row[p] = acc[i];
      }
    }
  }
}

template <typename T>
__device__ __forceinline__ void v1_store_vals(const float (&acc)[32], const Geom& g, int b,
                                              int m0, int c0, T* __restrict__ out) {
  const int tid = threadIdx.x;
  const int L = g.L();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int p = g.real(m0 + acc_row(tid, 2 * h));
    if (p < 0) continue;
    T* row = out + ((size_t)b * L + p) * g.C;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const int c = c0 + acc_col(tid, i);
        if (c < g.C) row[c] = hv_attn::from_f<T>(acc[i]);
      }
    }
  }
}

// One (L, P) tile of the bf16 route. NSTAGES: the ring depth (STAGES, or 1
// for mainloop_sync).
template <int KIND, int NSTAGES>
__device__ __forceinline__ void lp_tile(const CUtensorMap& ma, const CUtensorMap& mb,
                                        const Geom& g, const float* __restrict__ nrm_raw,
                                        float* __restrict__ out) {
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * 128;
  const LPOp<KIND> op{{}, &ma, &mb, b, m0 / g.wdp, m0 % g.wdp, n0 / g.wdp, n0 % g.wdp,
                      g.Cp / BK};
  float acc[64];
  if constexpr (NSTAGES == 1) {
    mainloop_sync(op, acc);
  } else {
    mainloop(op, acc);
  }
  lp_store<KIND>(acc, g, b, m0, n0, nrm_raw, out);
}

// Grid (ceil(hd wdp / 128), ceil(hd wdp / 64), B).
template <int KIND>
__global__ void __launch_bounds__(THREADS)
lp_gemm(const __grid_constant__ CUtensorMap ma, const __grid_constant__ CUtensorMap mb,
        Geom g, const float* __restrict__ nrm_raw, float* __restrict__ out) {
  lp_tile<KIND, STAGES>(ma, mb, g, nrm_raw, out);
}

__device__ __forceinline__ void split(float v, bf16& hi, bf16& lo) {
  hi = __float2bfloat16(v);
  lo = __float2bfloat16(v - __bfloat162float(hi));
}
// The float32 route's planes: big and small TF32 halves, kept in float32.
__device__ __forceinline__ void split(float v, float& big, float& small) {
  split_tf32(v, big, small);
}

// (P, C) GEMMs, M = output positions, N = 64 channels, K = taps x kp: A is
// a split (hi, lo) scratch plane (kp, wd, hd, B), rows shifted by -tap; B
// a feature map (Cp, wd, hd, phase, B), MN-major, its K rows (positions)
// shifted by +tap.
//   paste:  y(r, t)[m]   = 1/4 sum_ab sum_l probsT[m - s, l] b_full(r, t)[l + s]
//   db_full: db(r, t)[m] = 1/4 sum_ab sum_p probs[m - s, p] dy(r, t)[p + s]
//   dfd:    dfd[y] = sum_o sum_l ds0T[y - o, l] bd[l + o]
//   dbd:    dbd[y] = sum_o sum_p ds0[y - o, p] fd[p + o] + 2 bd[y] box(dn2)[y]
// with s = (a, bb) the 4 offsets of output phase (r, t), o the 9 window
// offsets. The paste's variants (VAR, the ablation's): kPasteBf16 reads the
// hi plane alone (one product a step); kFoldNorm scales each A row, the
// unnormalised probs column p = m - s, by col_inv[p] in registers
// (`fragments`, wgmma's register-A form) before the products. IO: see
// PasteIO.
template <int KIND, int VAR = kFull, int IO = kPlanesToNatural>
struct PCOp : Bf16Ring {
  static constexpr int BN = 64, NA = VAR == kPasteBf16 ? 1 : 2, TRANS_B = 1;
  static constexpr bool REG_A = VAR == kFoldNorm;
  static constexpr bool PASTE = KIND == kPaste || KIND == kDbfull;
  const CUtensorMap* ma_hi;
  const CUtensorMap* ma_lo;
  const CUtensorMap* mb;
  int b, mi0, mj0, c0, wdp, phase, chunks;
  const float* col_inv;  // kFoldNorm: (B, L)
  int hd, wd;
  __device__ int iters() const { return (PASTE ? 4 : 9) * chunks; }
  __device__ uint32_t stage_bytes() const { return (NA + 1) * TILE_BYTES; }
  __device__ void load(int it, uint8_t* a0, uint8_t* a1, uint8_t* bt, uint64_t* bar) const {
    const int tap = it / chunks, k0 = (it % chunks) * BK;
    int sy, sx;
    if (PASTE) {
      paste_tap(phase, tap, sy, sx);
    } else {
      window_tap(tap, sy, sx);
    }
    tma_load_4d(a0, ma_hi, bar, k0, mj0 - sx, mi0 - sy, b);
    if (NA == 2) tma_load_4d(a1, ma_lo, bar, k0, mj0 - sx, mi0 - sy, b);
    if (IO == kNaturalToNatural) {
      // column phase t, then every second row from 2 (i + sy) + r
      tma_load_5d(bt, mb, bar, c0, phase % 2, k0 % wdp + sx, 2 * (k0 / wdp + sy) + phase / 2, b);
    } else {
      tma_load_5d(bt, mb, bar, c0, k0 % wdp + sx, k0 / wdp + sy, PASTE ? phase : 0, b);
    }
  }
  // kFoldNorm: the A fragments of each 16-deep step, hi + lo of the stage's
  // two tiles times col_inv of the row's column p, split again. Row r of
  // the tiles holds grid position (mi0 - sy + r / w, mj0 - sx + r % w), w
  // the box width (zero off the grid, where TMA filled zeros); a thread
  // holds two rows. The 128-byte swizzle stores 16-byte chunk k of row r at
  // chunk k ^ (r % 8).
  __device__ void fragments(int it, const uint8_t* st, uint32_t (&frag)[BK / 16][2][4]) const {
    int sy, sx;
    paste_tap(phase, it / chunks, sy, sx);
    const int w = wdp < BM ? wdp : BM;
    const int tid = threadIdx.x;
    float inv[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = a_frag_row(tid, h);
      const int pi = mi0 - sy + r / w, pj = mj0 - sx + r % w;
      inv[h] = (pi >= 0 && pi < hd && pj >= 0 && pj < wd)
                   ? col_inv[((size_t)b * hd + pi) * wd + pj]
                   : 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int r = a_frag_row(tid, q), col = kk * 16 + a_frag_col(tid, q);
        const int at = r * 128 + (((col / 8) ^ (r % 8)) * 16) + (col % 8) * 2;
        const __nv_bfloat162 h = *reinterpret_cast<const __nv_bfloat162*>(st + at);
        const __nv_bfloat162 l = *reinterpret_cast<const __nv_bfloat162*>(st + TILE_BYTES + at);
        bf16 h0, l0, h1, l1;
        split((__low2float(h) + __low2float(l)) * inv[q & 1], h0, l0);
        split((__high2float(h) + __high2float(l)) * inv[q & 1], h1, l1);
        const __nv_bfloat162 nh = __halves2bfloat162(h0, h1), nl = __halves2bfloat162(l0, l1);
        frag[kk][0][q] = *reinterpret_cast<const uint32_t*>(&nh);
        frag[kk][1][q] = *reinterpret_cast<const uint32_t*>(&nl);
      }
    }
  }
};

// The epilogue of a (P, C) tile at output positions m0, channels c0, of
// output phase `phase` of sample b; out in T (bf16 or float) with C
// channels: (B, 2hd, 2wd, C) for paste and db_full (or phase planes (B, 2,
// 2, hd, wd, C), kPlanesToPlanes), (B, hd, wd, C) else. dbd adds the norm
// term 2 bd box(dn2), bd (B, hd, wd, Cp) in T.
template <int KIND, int IO, typename T>
__device__ __forceinline__ void pc_store(const float (&acc)[32], const Geom& g, int b,
                                         int phase, int m0, int c0,
                                         const float* __restrict__ dn2,
                                         const T* __restrict__ bd, T* __restrict__ out) {
  constexpr bool PASTE = KIND == kPaste || KIND == kDbfull;
  const int tid = threadIdx.x;
  const int L = g.L();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int m = g.real(m0 + acc_row(tid, 2 * h));
    if (m < 0) continue;
    const int mi = m / g.wd, mj = m % g.wd;
    size_t at;
    if (PASTE && IO == kPlanesToPlanes) {
      at = (((size_t)b * 4 + phase) * L + m) * g.C;
    } else if (PASTE) {
      at = (((size_t)b * 2 * g.hd + 2 * mi + phase / 2) * 2 * g.wd + 2 * mj + phase % 2) * g.C;
    } else {
      at = ((size_t)b * L + m) * g.C;
    }
    float box = 0.f;
    if (KIND == kDbd) {
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          const int y = mi + dy, x = mj + dx;
          if (y >= 0 && y < g.hd && x >= 0 && x < g.wd) box += dn2[(size_t)b * L + y * g.wd + x];
        }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int i = 4 * j + 2 * h + e;
        const int c = c0 + acc_col(tid, i);
        if (c >= g.C) continue;
        float v = acc[i];
        if (PASTE) v *= 0.25f;
        if (KIND == kDbd) v += 2.f * hv_attn::to_f(bd[((size_t)b * L + m) * g.Cp + c]) * box;
        out[at + c] = hv_attn::from_f<T>(v);
      }
    }
  }
}

// One (P, C) tile of the bf16 route.
template <int KIND, int VAR, int IO, int NSTAGES>
__device__ __forceinline__ void pc_tile(const CUtensorMap& ma_hi, const CUtensorMap& ma_lo,
                                        const CUtensorMap& mb, const Geom& g,
                                        const float* __restrict__ dn2, const bf16* __restrict__ bd,
                                        const float* __restrict__ col_inv,
                                        bf16* __restrict__ out) {
  using Op = PCOp<KIND, VAR, IO>;
  constexpr bool PASTE = Op::PASTE;
  const int b = blockIdx.z;
  const int phase = PASTE ? blockIdx.y % 4 : 0;
  const int m0 = (PASTE ? blockIdx.y / 4 : blockIdx.y) * BM, c0 = blockIdx.x * 64;
  const Op op{{}, &ma_hi, &ma_lo, &mb, b, m0 / g.wdp, m0 % g.wdp, c0, g.wdp, phase, g.kp / BK,
              col_inv, g.hd, g.wd};
  float acc[32];
  if constexpr (NSTAGES == 1) {
    mainloop_sync(op, acc);
  } else {
    mainloop(op, acc);
  }
  pc_store<KIND, IO, bf16>(acc, g, b, phase, m0, c0, dn2, bd, out);
}

// Grid (Cp / 64, ceil(hd wdp / 64) x phases, B).
template <int KIND>
__global__ void __launch_bounds__(THREADS)
pc_gemm(const __grid_constant__ CUtensorMap ma_hi, const __grid_constant__ CUtensorMap ma_lo,
        const __grid_constant__ CUtensorMap mb, Geom g, const float* __restrict__ dn2,
        const bf16* __restrict__ bd, bf16* __restrict__ out) {
  pc_tile<KIND, kFull, kPlanesToNatural, STAGES>(ma_hi, ma_lo, mb, g, dn2, bd, nullptr, out);
}

// A row of a transpose tile: BK values and 16 bytes of pad, so that rows
// stay 16-byte aligned (144 bytes in bf16, 272 in float32).
template <typename PT>
constexpr int ROW_PAD = BK + 16 / (int)sizeof(PT);
// Warps of a fuse + softmax block, one row group each: 32 (1024 threads,
// at most 64 registers a thread). The sweep took 1.87 ms at B = 64 on an
// H100 with 32, 2.30 ms with 8 (chip_smoke.py's stage split, PERF.md).
constexpr int SOFTMAX_ROWS = 32;

// Fuse and gated column softmax (as hv_attn::fuse_softmax_kernel), writing
// the paste's operand: probsT (B, P, kp) in hi and lo bf16 (PT = float:
// big and small TF32 halves), row p holding probs[l, p] at l's padded
// position, zero at phantoms; and, when probs is not null, the float32
// probs (B, L, P). Grid (ceil(P / 32), B), block
// (32, SOFTMAX_ROWS). The first sweep takes the online max and sum of each
// column's logits; the second computes the fused scores again (the 9-tap
// gather of s) rather than storing them, and goes through a 32 x 64 tile
// in shared memory so that the transposed rows are written whole.
// MODE (hv_attn::StageMode; the ablation's variants): kNoFuse reads s[l, p]
// in place of the gather; kNoSoftmax writes the fused scores (no sweep for
// max and sum, no exp, 1/sum or gate); kPasteBf16 writes the hi plane alone
// (pt_lo unused), each value rounded to bf16 (kept in float32 when PT =
// float); kFoldNorm writes e * g unnormalised and col_inv[b, p] = 1 / sum
// (B, L).
template <int MODE = kFull, typename PT = bf16>
__global__ void __launch_bounds__(SM_COLS * SOFTMAX_ROWS)
fuse_softmax_tc_kernel(const float* __restrict__ s, const float* __restrict__ mm,
                       float* __restrict__ probs, PT* __restrict__ pt_hi,
                       PT* __restrict__ pt_lo, Geom g, float scale,
                       float* __restrict__ col_inv = nullptr) {
  using namespace hv_attn;
  __shared__ float part_max[SOFTMAX_ROWS][SM_COLS];
  __shared__ float part_sum[SOFTMAX_ROWS][SM_COLS];
  __shared__ __align__(16) PT tile[2][SM_COLS][ROW_PAD<PT>];
  const int L = g.L();
  const int b = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * SM_COLS + tx;
  const int p = blockIdx.x * SM_COLS + tx;
  const float* sb = s + (size_t)b * L * L;
  const float* gb = mm + (size_t)b * L;
  auto score = [&](int l) {
    return MODE == kNoFuse ? sb[(size_t)l * L + p] : fused_score(sb, l, p, g.wd, L);
  };

  float col_max = 0.f, inv = 1.f;
  if constexpr (MODE != kNoSoftmax) {
    float run_max = -INFINITY, run_sum = 0.f;
    if (p < L) {
      for (int l = ty; l < L; l += SOFTMAX_ROWS) {
        const float logit = score(l) * gb[l] * scale;
        if (logit > run_max) {
          run_sum = run_sum * expf(run_max - logit) + 1.f;
          run_max = logit;
        } else {
          run_sum += expf(logit - run_max);
        }
      }
    }
    part_max[ty][tx] = run_max;
    part_sum[ty][tx] = run_sum;
    __syncthreads();
    col_max = -INFINITY;
    for (int r = 0; r < SOFTMAX_ROWS; ++r) col_max = fmaxf(col_max, part_max[r][tx]);
    float col_sum = 0.f;
    for (int r = 0; r < SOFTMAX_ROWS; ++r) {
      const float pm = part_max[r][tx];
      if (pm > -INFINITY) col_sum += part_sum[r][tx] * expf(pm - col_max);
    }
    inv = 1.f / col_sum;
    if constexpr (MODE == kFoldNorm) {
      if (ty == 0 && p < L) col_inv[(size_t)b * L + p] = inv;
    }
  }

  // the write-out: 16 bytes (VEC values) a thread, CHUNKS of them a row
  constexpr int VEC = 16 / (int)sizeof(PT), CHUNKS = BK / VEC;
  const int row = tid / CHUNKS, chunk = tid % CHUNKS;
  const int prow = blockIdx.x * SM_COLS + row;
  for (int k0 = 0; k0 < g.kp; k0 += BK) {
    for (int kk = ty; kk < BK; kk += SOFTMAX_ROWS) {
      const int l = g.real(k0 + kk);
      float v = 0.f;
      if (p < L && l >= 0) {
        if constexpr (MODE == kNoSoftmax) {
          v = score(l);
        } else {
          const float gl = gb[l];
          const float e = expf(score(l) * gl * scale - col_max);
          v = MODE == kFoldNorm ? e * gl : e * inv * gl;
        }
        if (probs != nullptr) probs[((size_t)b * L + l) * L + p] = v;
      }
      if constexpr (MODE == kPasteBf16 && std::is_same_v<PT, float>) {
        tile[0][tx][kk] = __bfloat162float(__float2bfloat16(v));
      } else if constexpr (MODE == kPasteBf16) {
        tile[0][tx][kk] = __float2bfloat16(v);
      } else {
        split(v, tile[0][tx][kk], tile[1][tx][kk]);
      }
    }
    __syncthreads();
    if (tid < SM_COLS * CHUNKS && prow < L) {
      const size_t at = ((size_t)b * L + prow) * g.kp + k0 + chunk * VEC;
      *reinterpret_cast<uint4*>(pt_hi + at) = *reinterpret_cast<const uint4*>(&tile[0][row][chunk * VEC]);
      if constexpr (MODE != kPasteBf16) {
        *reinterpret_cast<uint4*>(pt_lo + at) = *reinterpret_cast<const uint4*>(&tile[1][row][chunk * VEC]);
      }
    }
    __syncthreads();
  }
}

// hi/lo planes (B, L, kp) of a float (B, L, P) matrix (PT = float: big and
// small), columns at their padded positions, zero at phantoms. Grid (B *
// L): one block a row, on grid x, whose limit (2^31 - 1) no batch reaches;
// 256 threads.
template <typename PT = bf16>
__global__ void __launch_bounds__(256)
split_rows_kernel(const float* __restrict__ x, PT* __restrict__ hi, PT* __restrict__ lo,
                  Geom g) {
  const int L = g.L();
  const size_t row = blockIdx.x;
  for (int q = threadIdx.x; q < g.kp; q += 256) {
    const int p = g.real(q);
    const float v = p >= 0 ? x[row * L + p] : 0.f;
    split(v, hi[row * g.kp + q], lo[row * g.kp + q]);
  }
}

// Fuse adjoint over a 64 x 64 tile of padded (row a, column c) positions:
// ds0 = fuse_adjoint_at(dfused, a, c) / max(nrm_raw[a], 1e-4), written in
// hi and lo (PT = float: big and small) both as ds0 (B, L, kp), row a, and
// as its transpose ds0T (B, P, kp), row c; zero at phantoms. rowsum[b, a]
// += sum_c ds * s[a, c] (zeroed beforehand): the norm's gradient before
// dn2_kernel. Grid (kp / 64, kp / 64, B), block (32, 8).
template <typename PT = bf16>
__global__ void __launch_bounds__(SM_COLS * SM_ROWS)
fuse_adj_tc_kernel(const float* __restrict__ dfused, const float* __restrict__ s,
                   const float* __restrict__ nrm_raw, PT* __restrict__ ds_hi,
                   PT* __restrict__ ds_lo, PT* __restrict__ dst_hi,
                   PT* __restrict__ dst_lo, float* __restrict__ rowsum, Geom g) {
  using namespace hv_attn;
  constexpr int VEC = 16 / (int)sizeof(PT), CHUNKS = BK / VEC;  // 16-byte chunks of a row
  __shared__ __align__(16) PT tile[2][BK][ROW_PAD<PT>];
  const int L = g.L();
  const int b = blockIdx.z;
  const int c0 = blockIdx.x * BK, a0 = blockIdx.y * BK;
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * SM_COLS + tx;
  const float* fb = dfused + (size_t)b * L * L;
  const int cols[2] = {g.real(c0 + tx), g.real(c0 + tx + 32)};

  for (int ar = ty; ar < BK; ar += SM_ROWS) {
    const int a = g.real(a0 + ar);
    float part = 0.f;
    const float nrm = a >= 0 ? fmaxf(nrm_raw[(size_t)b * L + a], 1e-4f) : 1.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = 0.f;
      if (a >= 0 && cols[e] >= 0) {
        const float ds = fuse_adjoint_at(fb, a, cols[e], g.wd, L);
        part += ds * s[((size_t)b * L + a) * L + cols[e]];
        v = ds / nrm;
      }
      split(v, tile[0][ar][tx + 32 * e], tile[1][ar][tx + 32 * e]);
    }
    for (int off = 16; off > 0; off /= 2) part += __shfl_down_sync(0xffffffffu, part, off);
    if (tx == 0 && a >= 0) atomicAdd(rowsum + (size_t)b * L + a, part);
  }
  __syncthreads();
  // rows a: 64 rows of CHUNKS 16-byte chunks a plane
  for (int k = tid; k < BK * CHUNKS; k += SM_COLS * SM_ROWS) {
    const int ar = k / CHUNKS, chunk = k % CHUNKS;
    const int a = g.real(a0 + ar);
    if (a < 0) continue;
    const size_t at = ((size_t)b * L + a) * g.kp + c0 + chunk * VEC;
    *reinterpret_cast<uint4*>(ds_hi + at) = *reinterpret_cast<const uint4*>(&tile[0][ar][chunk * VEC]);
    *reinterpret_cast<uint4*>(ds_lo + at) = *reinterpret_cast<const uint4*>(&tile[1][ar][chunk * VEC]);
  }
  // rows c of the transpose: a column of the tile, gathered VEC values a chunk
  for (int k = tid; k < BK * CHUNKS; k += SM_COLS * SM_ROWS) {
    const int cr = k / CHUNKS, chunk = k % CHUNKS;
    const int c = g.real(c0 + cr);
    if (c < 0) continue;
    const size_t at = ((size_t)b * L + c) * g.kp + a0 + chunk * VEC;
#pragma unroll
    for (int plane = 0; plane < 2; ++plane) {
      __align__(16) PT v[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) v[e] = tile[plane][chunk * VEC + e][cr];
      *reinterpret_cast<uint4*>((plane ? dst_lo : dst_hi) + at) = *reinterpret_cast<const uint4*>(v);
    }
  }
}

// dn2 = -rowsum / nrm * 0.5 / nrm_raw where nrm_raw > 1e-4, else 0 (the
// norm's gradient, as the plain version's dnrm2).
__global__ void dn2_kernel(const float* __restrict__ rowsum, const float* __restrict__ nrm_raw,
                           float* __restrict__ dn2, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float nr = nrm_raw[i];
  const float dn = -rowsum[i] / fmaxf(nr, 1e-4f);
  dn2[i] = nr > 1e-4f ? dn * 0.5f / fmaxf(nr, 1e-12f) : 0.f;
}

// ---- host side ----

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, through the runtime's entry-point
// query (no link against it: the toolkit's stub need not match its
// version).
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found);
#else
    const cudaError_t rc =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    const bool ok = rc == cudaSuccess && found == cudaDriverEntryPointSuccess;
    return ok ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

constexpr int kMapError = 1000;  // returned, plus the CUresult, when a map fails

// A tensor map of element type T (bf16, or float32) over a dense tensor,
// dims innermost first, 128-byte swizzle, zero fill out of bounds; element
// strides 1, or `estride`. Returns 0 or kMapError + CUresult. The float32
// maps are FLOAT32, not TFLOAT32: TMA copies the bits as they are, and the
// route splits every float32 operand into TF32 halves itself.
template <typename T = bf16>
int make_map(CUtensorMap* map, const void* ptr, int rank, const uint64_t* dims,
             const uint32_t* box, const uint32_t* estride = nullptr) {
  static_assert(std::is_same_v<T, bf16> || std::is_same_v<T, float>);
  constexpr CUtensorMapDataType kType = std::is_same_v<T, float>
                                            ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                            : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return kMapError + static_cast<int>(CUDA_ERROR_NOT_FOUND);
  cuuint64_t gdim[5], gstride[4];
  cuuint32_t bdim[5], edim[5];
  uint64_t stride = sizeof(T);
  for (int i = 0; i < rank; ++i) {
    gdim[i] = dims[i];
    bdim[i] = box[i];
    edim[i] = estride == nullptr ? 1 : estride[i];
    if (i > 0) gstride[i - 1] = stride;
    stride *= dims[i];
  }
  const CUresult r = fn(map, kType, rank, const_cast<void*>(ptr), gdim,
                        gstride, bdim, edim, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kMapError + static_cast<int>(r);
}

// Values of T in one 128-byte swizzle row: a box's inner extent.
template <typename T>
constexpr uint32_t ROW_VALUES = 128 / sizeof(T);

// A feature map (B, phases, hd, wd, Cp) of T read in boxes of one 128-byte
// row of channels (64 bf16, 32 float32) by `positions` grid positions (a
// rectangle of the padded order).
template <typename T = bf16>
int feature_map(CUtensorMap* map, const void* ptr, const Geom& g, int phases, int B,
                int positions) {
  const int w = g.wdp < positions ? g.wdp : positions;
  const uint64_t dims[5] = {(uint64_t)g.Cp, (uint64_t)g.wd, (uint64_t)g.hd, (uint64_t)phases,
                            (uint64_t)B};
  const uint32_t box[5] = {ROW_VALUES<T>, (uint32_t)w, (uint32_t)(positions / w), 1, 1};
  return make_map<T>(map, ptr, 5, dims, box);
}

// A scratch plane (B, hd, wd, kp) of T read in boxes of one 128-byte row of
// entries by 64 grid positions.
template <typename T = bf16>
int plane_map(CUtensorMap* map, const void* ptr, const Geom& g, int B) {
  const int w = g.wdp < BM ? g.wdp : BM;
  const uint64_t dims[4] = {(uint64_t)g.kp, (uint64_t)g.wd, (uint64_t)g.hd, (uint64_t)B};
  const uint32_t box[4] = {ROW_VALUES<T>, (uint32_t)w, (uint32_t)(BM / w), 1};
  return make_map<T>(map, ptr, 4, dims, box);
}

// The geometry the wrapper chose, checked against what the maps need, and
// the batch against the grid's z limit. The float32 maps' boxes (32
// channels or entries, by 32, 64 or 128 positions) need no more: Cp and kp
// are multiples of 64, and a 32-position box is a rectangle of every wdp
// allowed here (a divisor of 32, or a multiple of it).
bool valid(const Geom& g, int B) {
  const bool wdp_ok = g.wdp <= 64 ? (g.wdp >= 8 && 64 % g.wdp == 0) : g.wdp % 128 == 0;
  return wdp_ok && g.wdp >= g.wd && g.kp % BK == 0 && g.kp >= g.hd * g.wdp && g.Cp % BK == 0 &&
         g.Cp >= g.C && g.hd >= 2 && g.wd >= 2 && B >= 1 && B <= 65535;
}

#define HV_TRY(x)          \
  do {                     \
    const int rc_ = (x);   \
    if (rc_ != 0) return rc_; \
  } while (0)

// The GEMM kernels' dynamic shared memory (above the 48 KiB default). The
// limit is an attribute of the function on each device, so every launcher
// sets it on the current device before each launch (a host call that
// queues nothing): a flag kept once per process would leave a second card
// at the default, where the launch fails.
template <class K>
int smem_attribute(K kernel, int bytes = SMEM_BYTES) {
  return static_cast<int>(
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

// Grid of an (L, P) GEMM and of a (P, C) GEMM with `phases` output phases.
inline dim3 lp_grid(const Geom& g, int B) {
  const int q = g.hd * g.wdp;
  return dim3((q + 127) / 128, (q + BM - 1) / BM, B);
}
inline dim3 pc_grid(const Geom& g, int B, int phases) {
  return dim3(g.Cp / 64, (g.hd * g.wdp + BM - 1) / BM * phases, B);
}

template <int KIND>
int launch_lp(const CUtensorMap& ma, const CUtensorMap& mb, const Geom& g, int B,
              const float* nrm_raw, float* out, cudaStream_t st) {
  HV_TRY(smem_attribute(lp_gemm<KIND>));
  lp_gemm<KIND><<<lp_grid(g, B), THREADS, SMEM_BYTES, st>>>(ma, mb, g, nrm_raw, out);
  return static_cast<int>(cudaGetLastError());
}

template <int KIND>
int launch_pc(const CUtensorMap& ma_hi, const CUtensorMap& ma_lo, const CUtensorMap& mb,
              const Geom& g, int B, const float* dn2, const void* bd, void* out,
              cudaStream_t st) {
  HV_TRY(smem_attribute(pc_gemm<KIND>));
  pc_gemm<KIND><<<pc_grid(g, B, PCOp<KIND>::PASTE ? 4 : 1), THREADS, SMEM_BYTES, st>>>(
      ma_hi, ma_lo, mb, g, dn2, static_cast<const bf16*>(bd), static_cast<bf16*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
