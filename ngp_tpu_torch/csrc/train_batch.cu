// Training batch generation, for Hopper (sm_90a): the march of a training
// step's rays with its per-ray compaction (train_march), and the emission of
// the flat network inputs over the sample slots (train_emit).
//
// Replaces: no Pallas kernel of ngp_tpu. ngp_tpu computes the batch as XLA
// code (ngp_tpu/sampling/training.py:83-329, generate_training_batch, over
// ngp_tpu/sampling/lattice.py's coarse_segment_mask, count_samples and
// count_samples_segments): every ray marches every point of its window as
// (R, W) tensors, and a row sort of where(mask, ordinal, sentinel)
// left-justifies each ray's samples. The port ran the same as some 500
// PyTorch operations a step over (R, W) and (R, W, 3) intermediates. These
// two kernels compute the same numbers bit for bit (sampling/training.py
// keeps the plain version, which runs on the CPU and for configurations the
// kernels do not take):
//
// train_march, one warp a ray, from its window start k0:
//   - the coarse pass (the two-level march, or its segment statistic): 32
//     lanes test 32 segments of 8 lattice points at a time with
//     coarse_segment_mask's arithmetic (the segment's midpoint t, the pooled
//     super-grid's lookup or-ed with the next mip's near the mip's edge, the
//     scene-cube cut); a ballot and a popc rank the kept segments, the first
//     seg_cap of which are the fine march's segments; the ray's kept count is
//     the segment statistic.
//   - the fine pass: the lanes take 4 segments x 8 points. A point's t and
//     position are ngp_tpu's fused multiply-adds as utils/fma.py computes
//     them (the product in double, one add, one rounding to float), its box
//     test as the plain path's, and its occupancy the cascade-0 cell
//     cm + clamp(cp - cm, -1, 1), cm the cell of the segment's midpoint and
//     cp the point's: the bit the packed 3^3 word of cm holds for the point
//     (grid/occupancy.packed_chunk_lookup), read without building the
//     words. A ballot and a prefix popc give each sample its ordinal in march
//     order; maximum_marching_steps caps it. The first s_pad k0-relative
//     lattice ordinals go to lat_pad, the rest of the row takes the sentinel.
//     The box test is pointwise with the window's first point's: in the convex
//     box, along a ray whose every coordinate is monotone in the ordinal, that
//     is count_samples' break at the first point outside, so the march stops
//     there too. With seg_cap 0 every segment of the window is marched
//     (count_samples(return_masks=True)); with seg_cap > 0 the kept segments,
//     then, as count_samples_segments does, the segment past the window once
//     for each unfilled slot (its points are outside the occupied box, so in
//     practice it adds nothing).
// train_emit, one thread a flat sample slot: the slot's lattice ordinal
//   k0 + lat_pad[ray, j] (0 on an invalid slot), t = startt + ordinal * dt and
//   the position o + t * d with the multiply and the add rounded apart (as
//   XLA leaves them), the position made relative to the scene box, and the
//   warped direction (d + 1) / 2.
//
// Bound: bytes. At the training cells' shape (10,240 rays, window 1,152
// points, 96 kept segments a ray at most, s_pad 512, 2^18 slots) the march
// reads 37 B a ray and writes 16 B and its lat_pad row (1 KB as int16, most
// of it the sentinel fill), and reads the cascade-0 occupancy (2 MB) and the
// pooled grid (8 KB) once: 13.1 MB, 3.9 us at 3.35 TB/s. The emission reads
// 17 B a slot (ray, position in the ray, valid), 36 B a ray and a valid
// slot's 2-byte ordinal, and writes 24 B a slot: 11.6 MB, 3.5 us. The design
// keeps every per-point intermediate in registers: no (R, W) mask, no sort,
// no (R, W, 3) float64 positions, no packed words; a ray's march stops at its
// box exit or at maximum_marching_steps, and the lat_pad row is written with
// consecutive lanes on consecutive ordinals. The march runs about ten times
// its byte bound: each warp's iterations wait on a dependent read of the
// occupancy in L2 (chip_smoke.py prints both times).

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int SEG = 8;                // lattice points of one segment (one packed word's group)
constexpr int WARPS = 4;              // rays (warps) a block of train_march
constexpr unsigned FULL = 0xffffffffu;

struct March {
  const float* o;                     // (R, 3)
  const float* d;                     // (R, 3)
  const float* startt;                // (R,)
  const long long* k0;                // (R,) window start ordinal
  const bool* hits;                   // (R,) the ray meets the scene box
  const unsigned char* occ0;          // (G, G, G) cascade-0 occupancy, index (x * G + y) * G + z
  const unsigned char* pooled;        // (n_cascades, P, P, P) halo-pooled super-grid (coarse pass only)
  long long* counts;                  // (R,) samples a ray takes (capped at max_steps, not at s_pad)
  long long* seg_counts;              // (R,) coarse-kept segments (coarse pass only)
  short* lat_pad;                     // (R, s_pad) k0-relative ordinals of the ray's first samples
  int n_rays, grid, pooled_res, n_seg, seg_cap, coarse, mip_lo, mip_hi, max_steps, s_pad, sentinel;
  float dt, near_thresh, cut_thresh;
  float lo[3], hi[3];
};

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

// grid/occupancy.pooled_lookup at one mip: (pos - 0.5) * 2^-mip + 0.5, each
// operation rounded
__device__ __forceinline__ bool pooled_at(const March& a, const float p[3], int mip) {
  const float scale = __int_as_float((127 - mip) << 23);
  const float res = (float)a.pooled_res;
  int c[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) c[k] = cell_of(__fadd_rn(__fmul_rn(__fsub_rn(p[k], 0.5f), scale), 0.5f), res, a.pooled_res);
  const long long s = a.pooled_res;
  return a.pooled[((mip * s + c[0]) * s + c[1]) * s + c[2]] != 0;
}

// sampling/lattice.coarse_segment_mask for window segment s
__device__ __forceinline__ bool coarse_keep(const March& a, const float o[3], const float d[3], float st, float k0f,
                                            int s) {
  const float ai = __fadd_rn(__fadd_rn(k0f, (float)(SEG * s)), 4.0f);
  const float tm = fma_once(ai, a.dt, st);
  float p[3], maxval = 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = fma_once(tm, d[k], o[k]);
    maxval = fmaxf(maxval, fabsf(__fsub_rn(p[k], 0.5f)));
  }
  // near the mip's edge the next mip's lookup too (with one cascade mip_hi
  // is mip_lo and the or changes nothing)
  bool occ = pooled_at(a, p, a.mip_lo);
  if (maxval >= a.near_thresh) occ = occ || pooled_at(a, p, a.mip_hi);
  return occ && maxval <= a.cut_thresh;
}

// The lane's point r = lane % 8 of window segment `seg` (lanes 8g .. 8g + 7
// hold one segment): whether it is in the box (`inside`) and whether it is
// an occupied point in the box. Every lane of the warp calls it.
__device__ __forceinline__ bool fine_point(const March& a, const float o[3], const float d[3], float st, long long k0,
                                           int seg, int r, bool& inside) {
  const float t = fma_once(__ll2float_rn(k0 + (long long)(SEG * seg + r)), a.dt, st);
  const int lane = threadIdx.x & 31;
  const int base = lane & ~(SEG - 1);
  const float g = (float)a.grid;
  float p[3];
  int cell[3];
  inside = true;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    p[k] = fma_once(t, d[k], o[k]);
    inside = inside && p[k] >= a.lo[k] && p[k] <= a.hi[k];
    // the segment's midpoint: the mean of its points 3 and 4
    const float p3 = __shfl_sync(FULL, p[k], base + 3);
    const float p4 = __shfl_sync(FULL, p[k], base + 4);
    const int cm = cell_of(__fmul_rn(0.5f, __fadd_rn(p3, p4)), g, a.grid);
    const int cp = cell_of(p[k], g, a.grid);
    cell[k] = cm + max(-1, min(1, cp - cm));
  }
  const long long G = a.grid;
  return inside && a.occ0[(cell[0] * G + cell[1]) * G + cell[2]] != 0;
}

__global__ void __launch_bounds__(WARPS * 32) train_march_kernel(March a) {
  extern __shared__ short seg_lists[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long ray = (long long)blockIdx.x * WARPS + warp;
  if (ray >= a.n_rays) return;  // the whole warp leaves together
  short* seg_list = seg_lists + warp * a.seg_cap;
  short* lat = a.lat_pad + ray * a.s_pad;
  const unsigned below = (1u << lane) - 1u;
  float o[3], d[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    o[k] = a.o[3 * ray + k];
    d[k] = a.d[3 * ray + k];
  }
  const float st = a.startt[ray];
  const long long k0 = a.k0[ray];
  int kept = 0, taken = 0;
  if (a.hits[ray]) {
    if (a.coarse) {
      const float k0f = __ll2float_rn(k0);
      for (int s0 = 0; s0 < a.n_seg; s0 += 32) {
        const int s = s0 + lane;
        const bool keep = s < a.n_seg && coarse_keep(a, o, d, st, k0f, s);
        const unsigned m = __ballot_sync(FULL, keep);
        const int rank = kept + __popc(m & below);
        if (keep && rank < a.seg_cap) seg_list[rank] = (short)s;
        kept += __popc(m);
      }
      __syncwarp();
    }
    // the window's first point: outside the box, the ray takes no sample
    bool inside0;
    fine_point(a, o, d, st, k0, 0, 0, inside0);
    inside0 = __shfl_sync(FULL, inside0, 0);
    const int n_real = a.seg_cap > 0 ? min(kept, a.seg_cap) : a.n_seg;
    if (inside0) {
      const int r = lane & (SEG - 1);
      for (int s0 = 0; s0 < n_real; s0 += 32 / SEG) {
        const int slot = s0 + lane / SEG;
        const bool live = slot < n_real;
        const int seg = live ? (a.seg_cap > 0 ? (int)seg_list[slot] : slot) : 0;
        bool inside;
        const bool sample = fine_point(a, o, d, st, k0, seg, r, inside) && live;
        const unsigned m = __ballot_sync(FULL, sample);
        const int ord = taken + __popc(m & below);
        if (sample && ord < a.max_steps && ord < a.s_pad) lat[ord] = (short)(SEG * seg + r);
        taken = min(taken + __popc(m), a.max_steps);
        // past the box exit every later point is outside too
        if (__any_sync(FULL, live && !inside) || taken >= a.max_steps) break;
      }
      // count_samples_segments pads the kept segments with the segment past
      // the window: its points, once for every unfilled slot, in march order;
      // lat_pad holds them sorted by ordinal, as the plain path's row sort
      const int n_dup = a.seg_cap > 0 ? a.seg_cap - n_real : 0;
      if (n_dup > 0) {
        bool inside;
        const bool sample = fine_point(a, o, d, st, k0, a.n_seg, r, inside) && lane < SEG;
        const unsigned b = __ballot_sync(FULL, sample);
        if (b != 0u) {
          const int p = __popc(b);
          const long long avail = a.max_steps - taken > 0 ? a.max_steps - taken : 0;
          const int surv = (int)min((long long)p * n_dup, avail);
          if (lane == 0) {
            const int full = surv / p, rem = surv % p;
            int ord = taken, k = 0;
            for (int j = 0; j < SEG; ++j) {
              if (!((b >> j) & 1u)) continue;
              const int c = full + (k < rem ? 1 : 0);
              ++k;
              for (int q = 0; q < c; ++q, ++ord)
                if (ord < a.s_pad) lat[ord] = (short)(SEG * a.n_seg + j);
            }
          }
          taken += surv;
        }
      }
    }
  }
  if (lane == 0) {
    a.counts[ray] = taken;
    if (a.coarse) a.seg_counts[ray] = kept;
  }
  __syncwarp();
  for (int j = min(taken, a.s_pad) + lane; j < a.s_pad; j += 32) lat[j] = (short)a.sentinel;
}

struct Emit {
  const long long* ray_ids;     // (C,) the slot's ray (clamped)
  const long long* pos_in_ray;  // (C,) the slot's sample in its ray (clamped to s_pad - 1)
  const bool* flat_valid;       // (C,)
  const long long* k0;          // (R,)
  const float* startt;          // (R,)
  const float* o;               // (R, 3)
  const float* d;               // (R, 3)
  const short* lat_pad;         // (R, s_pad)
  float* pos;                   // (C, 3) position relative to the scene box
  float* dirs;                  // (C, 3) warped direction
  long long n_slots;
  int s_pad;
  float dt;
  float lo[3], diag[3];
};

__global__ void train_emit_kernel(Emit a) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n_slots) return;
  const long long r = a.ray_ids[i];
  long long lat = 0;
  if (a.flat_valid[i]) lat = a.k0[r] + a.lat_pad[r * a.s_pad + a.pos_in_ray[i]];
  const float t = __fadd_rn(a.startt[r], __fmul_rn(__ll2float_rn(lat), a.dt));
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float dk = a.d[3 * r + k];
    const float p = __fadd_rn(a.o[3 * r + k], __fmul_rn(t, dk));
    a.pos[3 * i + k] = __fdiv_rn(__fsub_rn(p, a.lo[k]), a.diag[k]);
    a.dirs[3 * i + k] = __fmul_rn(__fadd_rn(dk, 1.0f), 0.5f);
  }
}

}  // namespace

extern "C" {

// The march of n_rays rays on `stream`; returns cudaGetLastError() (0 =
// launched). seg_cap 0 marches every segment of the window; coarse 0 skips
// the coarse pass (pooled and seg_counts are then not read or written).
int train_march(const void* o, const void* d, const void* startt, const void* k0, const void* hits, const void* occ0,
                const void* pooled, void* counts, void* seg_counts, void* lat_pad, int n_rays, int grid, int pooled_res,
                int n_seg, int seg_cap, int coarse, int mip_lo, int mip_hi, int max_steps, int s_pad,
                int sentinel, float dt, float near_thresh, float cut_thresh, float lo_x, float lo_y, float lo_z,
                float hi_x, float hi_y, float hi_z, void* stream) {
  if (n_rays <= 0) return 0;
  March a{static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(startt),
          static_cast<const long long*>(k0), static_cast<const bool*>(hits),
          static_cast<const unsigned char*>(occ0), static_cast<const unsigned char*>(pooled),
          static_cast<long long*>(counts), static_cast<long long*>(seg_counts), static_cast<short*>(lat_pad),
          n_rays, grid, pooled_res, n_seg, seg_cap, coarse, mip_lo, mip_hi, max_steps, s_pad, sentinel,
          dt, near_thresh, cut_thresh, {lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}};
  const int blocks = (n_rays + WARPS - 1) / WARPS;
  const size_t smem = sizeof(short) * (size_t)WARPS * (size_t)seg_cap;
  train_march_kernel<<<blocks, WARPS * 32, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

// The flat inputs of n_slots slots on `stream`; returns cudaGetLastError().
int train_emit(const void* ray_ids, const void* pos_in_ray, const void* flat_valid, const void* k0, const void* startt,
               const void* o, const void* d, const void* lat_pad, void* pos, void* dirs, long long n_slots, int s_pad,
               float dt, float lo_x, float lo_y, float lo_z, float diag_x, float diag_y, float diag_z, void* stream) {
  if (n_slots <= 0) return 0;
  Emit a{static_cast<const long long*>(ray_ids), static_cast<const long long*>(pos_in_ray),
         static_cast<const bool*>(flat_valid), static_cast<const long long*>(k0), static_cast<const float*>(startt),
         static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const short*>(lat_pad),
         static_cast<float*>(pos), static_cast<float*>(dirs), n_slots, s_pad, dt,
         {lo_x, lo_y, lo_z}, {diag_x, diag_y, diag_z}};
  const long long blocks = (n_slots + 255) / 256;
  train_emit_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
