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
// kernels do not take). The per-point arithmetic (a point's t, position, box
// test and occupancy, the coarse pass's segment test) is lattice.cuh's,
// shared with the spp-1 renderer's march (render_march.cu).
//
// Three lattices, one instantiation of train_march each (MODE):
//   PACKED  (constant dt, aabb_scale 1, 3.5 dt G <= 1: every base.json
//           configuration): every march point is at cascade 0, and a point's
//           occupancy is the bit the packed 3^3 word of its segment's midpoint
//           holds for it (below).
//   CASCADE (constant dt otherwise, e.g. aabb_scale > 1): each point reads
//           the cell of its own cascade, lattice.march_mip (mip_from_pos,
//           floored at the step's static mip; constant for aabb_scale 1).
//   CONE    (cone_angle_constant > 0): t of ordinal i is lattice_t's closed
//           form t0 + i m, tA (1 + c)^(i - iA), tC + (i - iC) M with the
//           anchors (iA, tA, iC, tC) that lattice.cone_anchors computed, in
//           the same float32 operations (expf, no fast math); each point's
//           cascade is mip_from_dt of its position and lattice_dt(t). The
//           plain path marches the whole lattice from ordinal 0; the kernel
//           walks only the ordinals whose t can reach the occupied box (its
//           slab span grown by a margin, turned into ordinals by the inverse
//           closed form, one ordinal wider on each side), which holds every
//           occupied point: a point outside that box lies in no occupied cell.
//
// train_march, one warp a ray, from its window start k0:
//   - the coarse pass (PACKED and CASCADE; the two-level march, or its segment
//     statistic): 32 lanes test 32 segments of 8 lattice points at a time with
//     coarse_segment_mask's arithmetic (the segment's midpoint t, the pooled
//     super-grid's lookup at the midpoint's march mip or-ed with the next
//     mip's near the mip's edge, the scene-cube cut); a ballot and a popc rank
//     the kept segments, the first seg_cap of which are the fine march's
//     segments; the ray's kept count is the segment statistic.
//   - the fine pass: the lanes take 4 segments x 8 points (CONE: 32
//     consecutive ordinals). A point's t and position are ngp_tpu's fused
//     multiply-adds as utils/fma.py computes them (the product in double, one
//     add, one rounding to float), its box test as the plain path's, and its
//     occupancy as above; on PACKED the cascade-0 cell cm + clamp(cp - cm, -1,
//     1), cm the cell of the segment's midpoint and cp the point's: the bit
//     the packed 3^3 word of cm holds for the point
//     (grid/occupancy.packed_chunk_lookup), read without building the words.
//     A ballot and a prefix popc give each sample its ordinal in march order;
//     maximum_marching_steps caps it. The first s_pad k0-relative lattice
//     ordinals go to lat_pad, the rest of the row takes the sentinel. The box
//     test is pointwise with the window's first point's (CONE: ordinal 0's):
//     in the convex box, along a ray whose every coordinate is monotone in the
//     ordinal, that is count_samples' break at the first point outside, so the
//     march stops there too. With seg_cap 0 every segment of the window is
//     marched (count_samples(return_masks=True)); with seg_cap > 0 the kept
//     segments, then, as count_samples_segments does, the segment past the
//     window once for each unfilled slot (its points are outside the occupied
//     box, so in practice it adds nothing).
//   - counters: each block adds its rays, their lat_pad slots, the lattice
//     points whose occupancy the fine pass read and the samples the rays take
//     in each cascade into a persistent int64 buffer on the card (one atomic
//     a counter a block), which the training loop reads with its stats.
// train_emit, one thread a flat sample slot: the slot's lattice ordinal
//   k0 + lat_pad[ray, j] (0 on an invalid slot), its t (startt + ordinal * dt,
//   or the cone lattice's closed form) and the position o + t * d with the
//   multiply and the add rounded apart (as XLA leaves them), the position
//   made relative to the scene box, and the warped direction (d + 1) / 2. On
//   the cone lattice further threads write the composite's step sizes
//   lattice_dt(t) of the (R, s_short) rows and of the long bucket's (n_long,
//   s_pad) rows from the same ordinals, an invalid ray's row from the
//   sentinel (the plain path's row sort of its masked ordinals).
//
// Bound: bytes. At the base training cells' shape (10,240 rays, window 1,152
// points, 96 kept segments a ray at most, s_pad 512, 2^18 slots) the march
// reads 37 B a ray and writes 16 B and its lat_pad row (1 KB as int16, most
// of it the sentinel fill), and reads the cascade-0 occupancy (2 MB) and the
// pooled grid (8 KB) once: 13.1 MB, 3.9 us at 3.35 TB/s. The cone march reads
// a ray's 16 B of anchors besides and the occupancy of every cascade (10.5 MB
// at aabb_scale 16). The emission reads 17 B a slot (ray, position in the
// ray, valid), 36 B a ray and a valid slot's 2-byte ordinal, and writes 24 B a
// slot: 11.6 MB, 3.5 us. The design keeps every per-point intermediate in
// registers: no (R, W) mask, no sort, no (R, W, 3) float64 positions, no
// packed words; a ray's march stops at its box exit or at
// maximum_marching_steps, and the lat_pad row is written with consecutive
// lanes on consecutive ordinals. The march runs about ten times its byte
// bound: each warp's iterations wait on a dependent read of the occupancy in
// L2 (chip_smoke.py prints both times).

#include <cuda_runtime.h>

#include <cstdint>

#include "lattice.cuh"

namespace {

using namespace lattice;

constexpr int WARPS = 4;              // rays (warps) a block of train_march
constexpr int MAX_CASCADES = 8;
// the cone march's margin around the occupied box, in world units: far beyond
// the rounding of a position or of a cell's bounds (about 1e-6 at |p| < 10)
constexpr float BOX_MARGIN = 1e-3f;
// the counter buffer: rays, lat_pad slots, points read, then samples by cascade
constexpr int C_RAYS = 0, C_SLOTS = 1, C_POINTS = 2, C_MIP0 = 3, N_COUNTERS = C_MIP0 + MAX_CASCADES;

struct March {
  const float* o;                     // (R, 3)
  const float* d;                     // (R, 3)
  const float* startt;                // (R,)
  const long long* k0;                // (R,) window start ordinal
  const bool* hits;                   // (R,) the ray meets the scene box
  const float* anchors;               // (R, 4) cone anchors iA, tA, iC, tC (CONE only)
  const unsigned char* occ;           // (n_cascades, G, G, G) occupancy, index ((c * G + x) * G + y) * G + z
  const unsigned char* pooled;        // (n_cascades, P, P, P) halo-pooled super-grid (coarse pass only)
  const float* occ_box;               // (2, 3) the occupied cells' box (CONE only)
  long long* counts;                  // (R,) samples a ray takes (capped at max_steps, not at s_pad)
  long long* seg_counts;              // (R,) coarse-kept segments (coarse pass only)
  short* lat_pad;                     // (R, s_pad) k0-relative ordinals of the ray's first samples
  unsigned long long* counters;       // (N_COUNTERS,) persistent totals, or null: nothing counted
  int n_rays, grid, pooled_res, n_cascades, n_seg, seg_cap, coarse, mip_lo, mip_hi, mip_by_pos, max_steps, s_pad,
      sentinel, n_lattice;
  float dt, near_thresh, cut_thresh, near_band, cone_c, max_dt, log1pc;
  float lo[3], hi[3];
};

// The first ordinal past t on the cone lattice, less one: the inverse of
// cone_t, floored (a float estimate; the callers widen it by an ordinal)
__device__ __forceinline__ long long cone_ordinal(const March& a, const float anc[4], float st, float t) {
  float i;
  if (t <= anc[1]) i = floorf((t - st) / a.dt);
  else if (t <= anc[3]) i = anc[0] + floorf(logf(t / anc[1]) / a.log1pc);
  else i = anc[2] + floorf((t - anc[3]) / a.max_dt);
  return (long long)fmaxf(fminf(i, (float)a.n_lattice), -1.0f);
}

// [k_lo, k_hi): the cone lattice's ordinals that can reach the occupied box
__device__ __forceinline__ void cone_window(const March& a, const float o[3], const float d[3], float st,
                                            const float anc[4], long long& k_lo, long long& k_hi) {
  float t_lo = -INFINITY, t_hi = INFINITY;
#pragma unroll
  for (int j = 0; j < 3; ++j) {
    const float dd = fabsf(d[j]) < 1e-12f ? 1e-12f : d[j];
    const float t1 = (a.occ_box[j] - BOX_MARGIN - o[j]) / dd;
    const float t2 = (a.occ_box[3 + j] + BOX_MARGIN - o[j]) / dd;
    t_lo = fmaxf(t_lo, fminf(t1, t2));
    t_hi = fminf(t_hi, fmaxf(t1, t2));
  }
  if (!(t_hi >= fmaxf(t_lo, st))) {
    k_lo = k_hi = 0;
    return;
  }
  // a relative margin on t far beyond the rounding of the slab test
  t_lo = fmaxf(t_lo, st) * (1.0f - 1e-4f);
  t_hi = t_hi * (1.0f + 1e-4f);
  k_lo = max(cone_ordinal(a, anc, st, t_lo) - 1, 0ll);
  k_hi = min(cone_ordinal(a, anc, st, t_hi) + 3, (long long)a.n_lattice);
  if (k_hi < k_lo) k_hi = k_lo;
}

// c[idx] += v with a compile-time index on every slot (the array stays in registers)
template <int N>
__device__ __forceinline__ void bump(int (&c)[N], int idx, int v) {
#pragma unroll
  for (int k = 0; k < N; ++k) c[k] += k == idx ? v : 0;
}

template <int MODE>
__global__ void __launch_bounds__(WARPS * 32) train_march_kernel(March a) {
  extern __shared__ short seg_lists[];
  __shared__ unsigned long long block_counts[N_COUNTERS];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x < N_COUNTERS) block_counts[threadIdx.x] = 0ull;
  __syncthreads();
  const long long ray = (long long)blockIdx.x * WARPS + warp;
  const unsigned below = (1u << lane) - 1u;
  int taken = 0, points = 0;
  int kept_mip[MODE == PACKED ? 1 : MAX_CASCADES] = {};  // this lane's samples by cascade
  if (ray < a.n_rays) {  // the whole warp takes this branch together
    short* seg_list = seg_lists + warp * a.seg_cap;
    short* lat = a.lat_pad + ray * a.s_pad;
    float o[3], d[3], anc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = a.o[3 * ray + k];
      d[k] = a.d[3 * ray + k];
    }
    if constexpr (MODE == CONE) {
#pragma unroll
      for (int k = 0; k < 4; ++k) anc[k] = a.anchors[4 * ray + k];
    }
    const float st = a.startt[ray];
    const long long k0 = a.k0[ray];
    int kept = 0;
    if (a.hits[ray]) {
      if constexpr (MODE != CONE) {
        if (a.coarse) {
          const float k0f = __ll2float_rn(k0);
          for (int s0 = 0; s0 < a.n_seg; s0 += 32) {
            const int s = s0 + lane;
            const bool keep = s < a.n_seg && coarse_keep<MODE>(a, o, d, st, k0f, s);
            const unsigned m = __ballot_sync(FULL, keep);
            const int rank = kept + __popc(m & below);
            if (keep && rank < a.seg_cap) seg_list[rank] = (short)s;
            kept += __popc(m);
          }
          __syncwarp();
        }
      }
      // the window's first point (the cone lattice's: ordinal 0, k0 being 0
      // there): outside the box, the ray takes no sample
      bool inside0;
      int mip;
      float p[3];
      fine_point<MODE>(a, o, d, st, anc, k0, inside0, mip, p);
      inside0 = __shfl_sync(FULL, inside0, 0);
      if constexpr (MODE == CONE) {
        long long k_lo = 0, k_hi = 0;
        if (inside0) cone_window(a, o, d, st, anc, k_lo, k_hi);
        for (long long j0 = k_lo; j0 < k_hi; j0 += 32) {
          const long long k = j0 + lane;
          const bool live = k < k_hi;
          bool inside;
          const bool sample = fine_point<MODE>(a, o, d, st, anc, k, inside, mip, p) && live;
          const unsigned m = __ballot_sync(FULL, sample);
          const int ord = taken + __popc(m & below);
          if (sample && ord < a.max_steps) {
            if (ord < a.s_pad) lat[ord] = (short)k;
            bump(kept_mip, mip, 1);
          }
          points += __popc(__ballot_sync(FULL, live));
          taken = min(taken + __popc(m), a.max_steps);
          // past the box exit every later point is outside too
          if (__any_sync(FULL, live && !inside) || taken >= a.max_steps) break;
        }
      } else if (inside0) {
        const int r = lane & (SEG - 1);
        const int n_real = a.seg_cap > 0 ? min(kept, a.seg_cap) : a.n_seg;
        for (int s0 = 0; s0 < n_real; s0 += 32 / SEG) {
          const int slot = s0 + lane / SEG;
          const bool live = slot < n_real;
          const int seg = live ? (a.seg_cap > 0 ? (int)seg_list[slot] : slot) : 0;
          bool inside;
          const bool sample = fine_point<MODE>(a, o, d, st, anc, k0 + SEG * seg + r, inside, mip, p) && live;
          const unsigned m = __ballot_sync(FULL, sample);
          const int ord = taken + __popc(m & below);
          if (sample && ord < a.max_steps) {
            if (ord < a.s_pad) lat[ord] = (short)(SEG * seg + r);
            bump(kept_mip, MODE == PACKED ? 0 : mip, 1);
          }
          points += __popc(__ballot_sync(FULL, live));
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
          const bool sample = fine_point<MODE>(a, o, d, st, anc, k0 + SEG * a.n_seg + r, inside, mip, p) && lane < SEG;
          const unsigned b = __ballot_sync(FULL, sample);
          points += SEG;
          if (b != 0u) {
            const int p = __popc(b);
            const long long avail = a.max_steps - taken > 0 ? a.max_steps - taken : 0;
            const int surv = (int)min((long long)p * n_dup, avail);
            const int full = surv / p, rem = surv % p;
            if (sample) bump(kept_mip, MODE == PACKED ? 0 : mip, full + (__popc(b & below) < rem ? 1 : 0));
            if (lane == 0) {
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
    // the ray's counters: lane 0 adds the warp's, then one atomic a block
    if (lane == 0) {
      atomicAdd(&block_counts[C_RAYS], 1ull);
      atomicAdd(&block_counts[C_SLOTS], (unsigned long long)a.s_pad);
      atomicAdd(&block_counts[C_POINTS], (unsigned long long)points);
    }
    if constexpr (MODE == PACKED) {
      const int n = __reduce_add_sync(FULL, kept_mip[0]);
      if (lane == 0 && n) atomicAdd(&block_counts[C_MIP0 + a.mip_lo], (unsigned long long)n);
    } else {
#pragma unroll
      for (int c = 0; c < MAX_CASCADES; ++c) {
        const int n = __reduce_add_sync(FULL, kept_mip[c]);
        if (lane == 0 && n) atomicAdd(&block_counts[C_MIP0 + c], (unsigned long long)n);
      }
    }
  }
  __syncthreads();
  if (a.counters != nullptr && threadIdx.x < N_COUNTERS && block_counts[threadIdx.x] != 0ull)
    atomicAdd(&a.counters[threadIdx.x], block_counts[threadIdx.x]);
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
  const float* anchors;         // (R, 4) cone anchors (cone only)
  const bool* ray_valid;        // (R,) (cone only)
  const long long* sel_long;    // (n_long,) the long bucket's rays (cone, bucketed only)
  float* pos;                   // (C, 3) position relative to the scene box
  float* dirs;                  // (C, 3) warped direction
  float* dt_pad;                // (R, s_short) step sizes (cone only)
  float* dt_pad_long;           // (n_long, s_pad) (cone, bucketed only)
  long long n_slots;
  int n_rays, s_pad, s_short, n_long, sentinel, cone;
  float dt, cone_c, max_dt, log1pc;
  float lo[3], diag[3];
};

// lattice_t of an ordinal: startt + ordinal * dt (the multiply and the add
// rounded apart), or the cone lattice's closed form
__device__ __forceinline__ float emit_t(const Emit& a, long long r, long long ordinal) {
  const float i = __ll2float_rn(ordinal);
  const float st = a.startt[r];
  if (!a.cone) return __fadd_rn(st, __fmul_rn(i, a.dt));
  return cone_t(a.anchors + 4 * r, st, i, a.dt, a.log1pc, a.max_dt);
}

// lattice_dt of ray r's j-th padded ordinal (the sentinel on an invalid ray)
__device__ __forceinline__ float emit_dt(const Emit& a, long long r, int j) {
  const long long lat = a.ray_valid[r] ? (long long)a.lat_pad[r * a.s_pad + j] : (long long)a.sentinel;
  const float t = emit_t(a, r, a.k0[r] + lat);
  return fminf(fmaxf(__fmul_rn(a.cone_c, t), a.dt), a.max_dt);
}

__global__ void train_emit_kernel(Emit a) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i < a.n_slots) {
    const long long r = a.ray_ids[i];
    long long lat = 0;
    if (a.flat_valid[i]) lat = a.k0[r] + a.lat_pad[r * a.s_pad + a.pos_in_ray[i]];
    const float t = emit_t(a, r, lat);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float dk = a.d[3 * r + k];
      const float p = __fadd_rn(a.o[3 * r + k], __fmul_rn(t, dk));
      a.pos[3 * i + k] = __fdiv_rn(__fsub_rn(p, a.lo[k]), a.diag[k]);
      a.dirs[3 * i + k] = __fmul_rn(__fadd_rn(dk, 1.0f), 0.5f);
    }
    return;
  }
  if (!a.cone) return;
  i -= a.n_slots;
  const long long n_short = (long long)a.n_rays * a.s_short;
  if (i < n_short) {
    const long long r = i / a.s_short;
    const int j = (int)(i % a.s_short);
    a.dt_pad[i] = emit_dt(a, r, j);
    return;
  }
  i -= n_short;
  if (i < (long long)a.n_long * a.s_pad) {
    const long long row = i / a.s_pad;
    a.dt_pad_long[i] = emit_dt(a, a.sel_long[row], (int)(i % a.s_pad));
  }
}

}  // namespace

extern "C" {

// The march of n_rays rays on `stream`; returns cudaGetLastError() (0 =
// launched). mode: 0 packed, 1 per-point cascades, 2 cone lattice. seg_cap 0
// marches every segment of the window; coarse 0 skips the coarse pass
// (pooled and seg_counts are then not read or written).
int train_march(const void* o, const void* d, const void* startt, const void* k0, const void* hits,
                const void* anchors, const void* occ, const void* pooled, const void* occ_box, void* counts,
                void* seg_counts, void* lat_pad, void* counters, int mode, int n_rays, int grid, int pooled_res,
                int n_cascades, int n_seg, int seg_cap, int coarse, int mip_lo, int mip_hi, int mip_by_pos,
                int max_steps, int s_pad, int sentinel, int n_lattice, float dt, float near_thresh, float cut_thresh,
                float near_band, float cone_c, float max_dt, float log1pc, float lo_x, float lo_y,
                float lo_z, float hi_x, float hi_y, float hi_z, void* stream) {
  if (n_rays <= 0) return 0;
  if (n_cascades > MAX_CASCADES || mode < PACKED || mode > CONE) return (int)cudaErrorInvalidValue;
  March a{static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(startt),
          static_cast<const long long*>(k0), static_cast<const bool*>(hits), static_cast<const float*>(anchors),
          static_cast<const unsigned char*>(occ), static_cast<const unsigned char*>(pooled),
          static_cast<const float*>(occ_box), static_cast<long long*>(counts), static_cast<long long*>(seg_counts),
          static_cast<short*>(lat_pad), static_cast<unsigned long long*>(counters),
          n_rays, grid, pooled_res, n_cascades, n_seg, seg_cap, coarse, mip_lo, mip_hi, mip_by_pos, max_steps, s_pad,
          sentinel, n_lattice, dt, near_thresh, cut_thresh, near_band, cone_c, max_dt, log1pc,
          {lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z}};
  const int blocks = (n_rays + WARPS - 1) / WARPS;
  const size_t smem = sizeof(short) * (size_t)WARPS * (size_t)seg_cap;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == PACKED) train_march_kernel<PACKED><<<blocks, WARPS * 32, smem, s>>>(a);
  else if (mode == CASCADE) train_march_kernel<CASCADE><<<blocks, WARPS * 32, smem, s>>>(a);
  else train_march_kernel<CONE><<<blocks, WARPS * 32, smem, s>>>(a);
  return (int)cudaGetLastError();
}

// The flat inputs of n_slots slots on `stream`, and on the cone lattice
// (cone 1) the (n_rays, s_short) and (n_long, s_pad) step sizes; returns
// cudaGetLastError().
int train_emit(const void* ray_ids, const void* pos_in_ray, const void* flat_valid, const void* k0, const void* startt,
               const void* o, const void* d, const void* lat_pad, const void* anchors, const void* ray_valid,
               const void* sel_long, void* pos, void* dirs, void* dt_pad, void* dt_pad_long, long long n_slots,
               int n_rays, int s_pad, int s_short, int n_long, int sentinel, int cone, float dt, float cone_c,
               float max_dt, float log1pc, float lo_x, float lo_y, float lo_z, float diag_x, float diag_y,
               float diag_z, void* stream) {
  Emit a{static_cast<const long long*>(ray_ids), static_cast<const long long*>(pos_in_ray),
         static_cast<const bool*>(flat_valid), static_cast<const long long*>(k0), static_cast<const float*>(startt),
         static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const short*>(lat_pad),
         static_cast<const float*>(anchors), static_cast<const bool*>(ray_valid),
         static_cast<const long long*>(sel_long), static_cast<float*>(pos), static_cast<float*>(dirs),
         static_cast<float*>(dt_pad), static_cast<float*>(dt_pad_long), n_slots, n_rays, s_pad, s_short, n_long,
         sentinel, cone, dt, cone_c, max_dt, log1pc, {lo_x, lo_y, lo_z}, {diag_x, diag_y, diag_z}};
  const long long n = n_slots + (cone ? (long long)n_rays * s_short + (long long)n_long * s_pad : 0);
  if (n <= 0) return 0;
  const long long blocks = (n + 255) / 256;
  train_emit_kernel<<<(unsigned)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
