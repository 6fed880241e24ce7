// Per-(sample, level) cell math of the "oadd" hash-grid encoding, shared by
// hash_encode_fwd.cu and hash_encode_bwd.cu.
//
// The same arithmetic as the plain version (ngp_tpu_torch/ops/hash_encoding.py:
// oct_base_w0 and the corner weights), operation for operation:
//   scaled = fma(pos, scale, 0.5)                 one rounding, as XLA's fma
//   base = floor(scaled), frac = scaled - base
//   dense levels clamp each dimension's corner pair into [0, res - 2], with
//   the weight moved onto the surviving corner
//   idx0 = (u0 + u1 * sy + u2 * sz) mod size      uint32 wraparound
//   row(k) = idx0 + offs[k], minus size when it reaches size
//   w(k) = (W0 * W1) * W2, W_d = bit_d(k) ? 1 - w0_d : w0_d
// Every product and sum that the plain version rounds on its own is an
// explicit __fmul_rn / __fadd_rn / __fsub_rn, so nvcc cannot contract it.
//
// Level groups (the gather and the stochastic deposit): a block takes
// kBlock consecutive samples and one group of kGroupFloats / F levels, so
// that one sample's F floats over the group's levels are exactly one
// 32-byte sector of the (N, L*F) output or gradient. The block stages its
// positions and that sector of each sample through shared memory with
// coalesced accesses (every warp access covers whole sectors), and each
// thread works on one sample over the group's levels.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace hash_grid {

constexpr int kMaxLevels = 32;
constexpr int kBlock = 256;                // samples (threads) a block, in the level-group kernels
constexpr int kGroupFloats = 8;            // floats of one sample over one level group: a 32-byte sector
constexpr int kStride = kGroupFloats + 1;  // a sample's shared-memory row (odd: no bank conflicts)

// Level constants of one HashGridSpec, built once on the host and passed to
// each kernel by value (1,796 bytes of kernel parameters). The field order and
// types match ngp_tpu_torch/ops/hash_encoding.py::LevelConstants.
struct LevelConstants {
  float scale[kMaxLevels];
  int res[kMaxLevels];
  int dense[kMaxLevels];
  uint32_t size[kMaxLevels];
  uint32_t sy[kMaxLevels];
  uint32_t sz[kMaxLevels];
  uint32_t offs[kMaxLevels][8];
  int n_levels;
};

// One (sample, level) cell: the base row and each dimension's corner-0 weight.
struct Cell {
  uint32_t idx0;
  float w0[3];
};

__device__ __forceinline__ Cell locate(const float* __restrict__ p, int l, const LevelConstants& lc) {
  const float scale = lc.scale[l];
  const int res = lc.res[l];
  const bool dense = lc.dense[l] != 0;
  const int top = res - 2 > 0 ? res - 2 : 0;
  Cell c;
  uint32_t u[3];
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float scaled = __fmaf_rn(p[d], scale, 0.5f);
    const float base_f = floorf(scaled);
    const float frac = __fsub_rn(scaled, base_f);
    const int base = static_cast<int>(base_f);
    int b = base;
    float w0 = __fsub_rn(1.0f, frac);
    if (dense) {
      b = base < 0 ? 0 : (base > top ? top : base);
      w0 = base > res - 2 ? 0.0f : (base < 0 ? 1.0f : w0);
    }
    u[d] = static_cast<uint32_t>(b);
    c.w0[d] = w0;
  }
  c.idx0 = (u[0] + u[1] * lc.sy[l] + u[2] * lc.sz[l]) % lc.size[l];
  return c;
}

__device__ __forceinline__ uint32_t corner_row(const Cell& c, int l, int k, const LevelConstants& lc) {
  const uint32_t row = c.idx0 + lc.offs[l][k];
  return row >= lc.size[l] ? row - lc.size[l] : row;
}

__device__ __forceinline__ float corner_weight(const Cell& c, int k) {
  const float wx = (k & 1) ? __fsub_rn(1.0f, c.w0[0]) : c.w0[0];
  const float wy = (k & 2) ? __fsub_rn(1.0f, c.w0[1]) : c.w0[1];
  const float wz = (k & 4) ? __fsub_rn(1.0f, c.w0[2]) : c.w0[2];
  return __fmul_rn(__fmul_rn(wx, wy), wz);
}

// Row loads and stores of F floats: one 8-byte access at F = 2 and 16-byte
// accesses at F = 4 and 8 (every row offset is a multiple of 4 * F bytes).
template <int F>
__device__ __forceinline__ void load_row(const float* __restrict__ src, float (&v)[F]) {
  if constexpr (F == 1) {
    v[0] = __ldg(src);
  } else if constexpr (F == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(src));
    v[0] = a.x;
    v[1] = a.y;
  } else {
#pragma unroll
    for (int j = 0; j < F; j += 4) {
      const float4 a = __ldg(reinterpret_cast<const float4*>(src + j));
      v[j] = a.x;
      v[j + 1] = a.y;
      v[j + 2] = a.z;
      v[j + 3] = a.w;
    }
  }
}

template <int F>
__device__ __forceinline__ void store_row(float* __restrict__ dst, const float (&v)[F]) {
  if constexpr (F == 1) {
    dst[0] = v[0];
  } else if constexpr (F == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int j = 0; j < F; j += 4) *reinterpret_cast<float4*>(dst + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
  }
}

// Corners k and k|1 of a cell (k even): rows r and (r + 1) mod size, since
// offs[k|1] = (offs[k] + 1) mod size. The second row wraps to 0 only on a
// hash level at r = size - 1; the dense clamp keeps r + 1 < size. Where
// `paired` (the level's base is aligned to 2 * 4F bytes) and r is even, one
// load reads both rows at F = 1 (8 bytes) and F = 2 (16 bytes); otherwise,
// and always at F >= 4 (a row is already a 16-byte access), two loads.
template <int F>
__device__ __forceinline__ void load_pair(const float* __restrict__ level, uint32_t r, uint32_t size, bool paired,
                                          float (&v0)[F], float (&v1)[F]) {
  const uint32_t r1 = r + 1 == size ? 0u : r + 1;
  if constexpr (F <= 2) {
    if (paired && !(r & 1u) && r1 != 0u) {
      if constexpr (F == 1) {
        const float2 a = __ldg(reinterpret_cast<const float2*>(level + r));
        v0[0] = a.x;
        v1[0] = a.y;
      } else {
        const float4 a = __ldg(reinterpret_cast<const float4*>(level + 2 * (size_t)r));
        v0[0] = a.x;
        v0[1] = a.y;
        v1[0] = a.z;
        v1[1] = a.w;
      }
      return;
    }
  }
  load_row<F>(level + (size_t)r * F, v0);
  load_row<F>(level + (size_t)r1 * F, v1);
}

// The block's positions, samples [i0, i0 + nb), into s_pos (3 * kBlock
// floats) with coalesced loads: each position is read once per level group.
__device__ __forceinline__ void stage_positions(const float* __restrict__ pos, long long i0, int nb, float* s_pos) {
  for (int e = threadIdx.x; e < 3 * nb; e += blockDim.x) s_pos[e] = __ldg(pos + 3 * i0 + e);
}

// Columns [col, col + w) of rows [i0, i0 + nb) of a row-major array with
// `cols` columns, to (load_group) or from (store_group) shared memory rows of
// kStride floats. Consecutive threads take consecutive floats, so a warp
// access covers whole 32-byte sectors when w = kGroupFloats.
__device__ __forceinline__ void load_group(const float* __restrict__ x, long long i0, int nb, int cols, int col, int w,
                                           float* s) {
  for (int e = threadIdx.x; e < nb * w; e += blockDim.x) {
    const int r = e / w, c = e - r * w;
    s[r * kStride + c] = __ldg(x + (i0 + r) * cols + col + c);
  }
}

__device__ __forceinline__ void store_group(float* __restrict__ x, long long i0, int nb, int cols, int col, int w,
                                            const float* s) {
  for (int e = threadIdx.x; e < nb * w; e += blockDim.x) {
    const int r = e / w, c = e - r * w;
    x[(i0 + r) * cols + col + c] = s[r * kStride + c];
  }
}

}  // namespace hash_grid
