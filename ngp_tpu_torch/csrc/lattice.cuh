// The march lattice's per-point arithmetic on the card, shared by the training
// batch's march (train_batch.cu), the spp-1 renderer's march
// (render_march.cu) and the spp-n frame's cover march (render_cover_march.cu):
// a lattice point's t and position, its box test, its occupancy, the cover
// test of its segment, and the coarse pass's segment test. Each helper is a template on
// its parameter struct P, which holds the fields it reads under these names:
//   occ (n_cascades, G, G, G) bytes, index ((c * G + x) * G + y) * G + z;
//   pooled (n_cascades, P, P, P) the halo-pooled super-grid; grid, pooled_res,
//   n_cascades; mip_lo (the march's static mip), mip_hi (the next one),
//   mip_by_pos (1: a point's mip is mip_from_pos floored at mip_lo); dt;
//   near_thresh, cut_thresh, near_band (coarse_segment_mask's mip edge band,
//   scene-cube cut and 16 dt); lo[3], hi[3] (the scene box); on the cone
//   lattice also cone_c, max_dt, log1pc.
// Every operation is rounded as the plain PyTorch path rounds it (sampling/
// lattice.py, grid/occupancy.py, utils/fma.py), so a point is the same to the
// bit on both.

#pragma once

#include <cuda_runtime.h>

namespace lattice {

constexpr int SEG = 8;  // lattice points of one segment (one packed word's group)
constexpr unsigned FULL = 0xffffffffu;
constexpr int PACKED = 0, CASCADE = 1, CONE = 2;

// float32(a * b + c) with the product unrounded: utils/fma.py's fma (the
// product of two floats is exact in double; one double add, one rounding)
__device__ __forceinline__ float fma_once(float a, float b, float c) {
  return __double2float_rn(__dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

__device__ __forceinline__ int cell_of(float x, float scale, int res) {
  const float f = floorf(__fmul_rn(x, scale));
  const long long c = (long long)f;
  return (int)(c < 0 ? 0 : (c > res - 1 ? res - 1 : c));
}

// grid/occupancy._frexp_exponent: frexpf's exponent from the float's bits
__device__ __forceinline__ int frexp_exponent(float x) { return ((__float_as_int(x) >> 23) & 0xFF) - 126; }

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

// grid/occupancy.mip_from_pos from the point's max |p - 0.5|
__device__ __forceinline__ int mip_from_maxval(float maxval, int nc) {
  return maxval == 0.0f ? min(1, nc - 1) : clampi(frexp_exponent(maxval) + 1, 0, nc - 1);
}

__device__ __forceinline__ float max_offset(const float p[3]) {
  float m = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) m = fmaxf(m, fabsf(__fsub_rn(p[k], 0.5f)));
  return m;
}

// lattice.march_mip of a constant-dt march: the static mip, or per point
// (aabb_scale > 1) mip_from_pos floored at it
template <class P>
__device__ __forceinline__ int march_mip(const P& a, const float p[3]) {
  return a.mip_by_pos ? max(mip_from_maxval(max_offset(p), a.n_cascades), a.mip_lo) : a.mip_lo;
}

// grid/occupancy.occupancy_lookup (cell) or pooled_lookup at one mip:
// (pos - 0.5) * 2^-mip + 0.5, each operation rounded, on a grid of `res`
__device__ __forceinline__ long long grid_index(const float p[3], int mip, int res) {
  const float scale = __int_as_float((127 - mip) << 23);
  int c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = cell_of(__fadd_rn(__fmul_rn(__fsub_rn(p[k], 0.5f), scale), 0.5f), (float)res, res);
  const long long s = res;
  return ((mip * s + c[0]) * s + c[1]) * s + c[2];
}

template <class P>
__device__ __forceinline__ bool pooled_at(const P& a, const float p[3], int mip) {
  return a.pooled[grid_index(p, mip, a.pooled_res)] != 0;
}

// sampling/lattice.coarse_segment_mask for segment s of a window that starts
// at ordinal k0f (a float32), from the march start st
template <int MODE, class P>
__device__ __forceinline__ bool coarse_keep(const P& a, const float o[3], const float d[3], float st, float k0f, int s) {
  const float ai = __fadd_rn(__fadd_rn(k0f, (float)(SEG * s)), 4.0f);
  const float tm = fma_once(ai, a.dt, st);
  float p[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) p[k] = fma_once(tm, d[k], o[k]);
  const float maxval = max_offset(p);
  // near the mip's edge the next mip's lookup too (with one cascade mip_hi
  // is mip_lo and the or changes nothing)
  if constexpr (MODE == PACKED) {
    bool occ = pooled_at(a, p, a.mip_lo);
    if (maxval >= a.near_thresh) occ = occ || pooled_at(a, p, a.mip_hi);
    return occ && maxval <= a.cut_thresh;
  } else {
    // mip m's range ends at maxval = 2^(m - 1): its float bits, less 16 dt
    const int mip = march_mip(a, p);
    bool occ = pooled_at(a, p, mip);
    if (maxval >= __fsub_rn(__int_as_float((126 + mip) << 23), a.near_band))
      occ = occ || pooled_at(a, p, min(mip + 1, a.n_cascades - 1));
    return occ && maxval <= a.cut_thresh;
  }
}

// lattice_t of ordinal i on the cone lattice from the ray's start st and
// anchors (iA, tA, iC, tC), dt the least step, dt_max the most
__device__ __forceinline__ float cone_t(const float* anc, float st, float i, float dt, float log1pc, float dt_max) {
  if (i <= anc[0]) return __fadd_rn(st, __fmul_rn(i, dt));
  if (i <= anc[2]) return __fmul_rn(anc[1], expf(__fmul_rn(__fsub_rn(i, anc[0]), log1pc)));
  return __fadd_rn(anc[3], __fmul_rn(__fsub_rn(i, anc[2]), dt_max));
}

// grid/occupancy.mip_from_dt of the point at t (dt = lattice_dt(t))
template <class P>
__device__ __forceinline__ int cone_mip(const P& a, const float p[3], float t) {
  const int mip = mip_from_maxval(max_offset(p), a.n_cascades);
  const float dt = fminf(fmaxf(__fmul_rn(a.cone_c, t), a.dt), a.max_dt);
  const float dd = __fmul_rn(__fmul_rn(dt, 2.0f), (float)a.grid);
  return dd < 1.0f ? mip : max(mip, clampi(frexp_exponent(dd), 0, a.n_cascades - 1));
}

// The lane's point of lattice ordinal k (k0 + 8 seg + r on the constant-dt
// lattices, lanes 8g .. 8g + 7 holding one segment): its position p, whether
// it is in the box (`inside`), its cascade (`mip`), and whether it is an
// occupied point in the box. On PACKED the cell is cm + clamp(cp - cm, -1, 1),
// cm the cell of the segment's midpoint (the mean of its points 3 and 4) and
// cp the point's: the bit the packed 3^3 word of cm holds for the point
// (grid/occupancy.packed_chunk_lookup), read without building the words.
// Every lane of the warp calls it.
template <int MODE, class P>
__device__ __forceinline__ bool fine_point(const P& a, const float o[3], const float d[3], float st, const float anc[4],
                                           long long k, bool& inside, int& mip, float (&p)[3]) {
  float t;
  if constexpr (MODE == CONE) t = cone_t(anc, st, __ll2float_rn(k), a.dt, a.log1pc, a.max_dt);
  else t = fma_once(__ll2float_rn(k), a.dt, st);
  inside = true;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p[j] = fma_once(t, d[j], o[j]);
    inside = inside && p[j] >= a.lo[j] && p[j] <= a.hi[j];
  }
  const long long G = a.grid;
  if constexpr (MODE == PACKED) {
    const int lane = threadIdx.x & 31;
    const int base = lane & ~(SEG - 1);
    const float g = (float)a.grid;
    int cell[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float p3 = __shfl_sync(FULL, p[j], base + 3);
      const float p4 = __shfl_sync(FULL, p[j], base + 4);
      const int cm = cell_of(__fmul_rn(0.5f, __fadd_rn(p3, p4)), g, a.grid);
      const int cp = cell_of(p[j], g, a.grid);
      cell[j] = cm + max(-1, min(1, cp - cm));
    }
    mip = a.mip_lo;
    return inside && a.occ[(cell[0] * G + cell[1]) * G + cell[2]] != 0;
  } else {
    mip = MODE == CONE ? cone_mip(a, p, t) : march_mip(a, p);
    return inside && a.occ[grid_index(p, mip, a.grid)] != 0;
  }
}

// The jitter-cover march's test of the lane's point of lattice ordinal k on
// the PACKED lattice (sampling/lattice.segment_points with jitter_cover, lanes
// 8g .. 8g + 7 holding one segment, every lane of the warp calling): its
// position p, whether p or the end of its segment p + d dt lies in the box
// (`inside`), and whether it is a cover point: in the box, and some cell of
// the box of cells between cell(p) and cell(p + d dt) occupied, each clamped
// to within one cell of cm, the cell of the segment's midpoint, and read from
// cm's packed 3^3 word (grid/occupancy.packed_cover_lookup). P holds `packed`,
// the (G^3,) int32 words of grid/occupancy.packed_neighborhood.
template <class P>
__device__ __forceinline__ bool cover_point(const P& a, const float o[3], const float d[3], float st, long long k,
                                            bool& inside, float (&p)[3]) {
  const float t = fma_once(__ll2float_rn(k), a.dt, st);
  bool in_p = true, in_e = true;
  float e[3];
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    p[j] = fma_once(t, d[j], o[j]);
    e[j] = fma_once(d[j], a.dt, p[j]);
    in_p = in_p && p[j] >= a.lo[j] && p[j] <= a.hi[j];
    in_e = in_e && e[j] >= a.lo[j] && e[j] <= a.hi[j];
  }
  inside = in_p || in_e;
  const int base = (threadIdx.x & 31) & ~(SEG - 1);
  const float g = (float)a.grid;
  int cm[3];
  unsigned span[3];  // per axis, bits lo..hi of the offsets {0, 1, 2} from cm - 1
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float p3 = __shfl_sync(FULL, p[j], base + 3);
    const float p4 = __shfl_sync(FULL, p[j], base + 4);
    cm[j] = cell_of(__fmul_rn(0.5f, __fadd_rn(p3, p4)), g, a.grid);
    const int cp = cell_of(p[j], g, a.grid);
    const int cq = cell_of(e[j], g, a.grid);
    const int lo = clampi(min(cp, cq) - cm[j], -1, 1) + 1;
    const int hi = clampi(max(cp, cq) - cm[j], -1, 1) + 1;
    span[j] = ((1u << (hi + 1)) - 1u) & ~((1u << lo) - 1u);
  }
  unsigned yz = 0u, box = 0u;
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if ((span[1] >> q) & 1u) yz |= span[2] << (3 * q);
#pragma unroll
  for (int q = 0; q < 3; ++q)
    if ((span[0] >> q) & 1u) box |= yz << (9 * q);
  const long long G = a.grid;
  const unsigned word = (unsigned)a.packed[(cm[0] * G + cm[1]) * G + cm[2]];
  return inside && (word & box) != 0u;
}

}  // namespace lattice
