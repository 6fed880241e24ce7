// The spp-1 renderer's march on the PACKED lattice, for Hopper (sm_90a): one
// round of every live ray of a frame in one launch (render_march), with the
// coarse pass, the fine march, the sample cap, the ray's end and the
// compaction of the live rays and of their samples.
//
// Replaces: no Pallas kernel of ngp_tpu. ngp_tpu marches a frame as XLA code
// (ngp_tpu/render/renderer.py's _coarse_pass and count_samples_segments over
// ngp_tpu/sampling/lattice.py). The port's plain path (render/renderer.py:
// _kept_segments, segment_plan, march_round, then a nonzero over the round's
// mask and the live rays' bookkeeping) runs some hundred PyTorch operations
// a round over (L, 128) and (L, 128, 3) tensors and synchronises with the
// host four times a round. This kernel computes the same samples bit for bit
// (render/march.py keeps a plain version with its interface, and the
// renderer keeps the plain path for the CPU and the other lattices).
//
// A round is RANGE_SEGS = 16 segments of 8 lattice points, aligned at ordinal
// 0: round r holds ordinals 128 r .. 128 r + 127. A ray's window starts at
// w0 = k0 - k0 % 8 (segment s0 = w0 / 8) and spans the frame's n_seg segments;
// a segment j of the window is kept where coarse_segment_mask keeps it (the
// pooled grid at the segment's midpoint at the unjittered t0).
//
// render_march, one warp a ray of the launch's list:
//   - the ray's start: on the frame's first launch, round 0 with no sample
//     taken; after it, the ray's round and taken from the last launch, and
//     the ray goes on only if that round left it with transmittance >=
//     transmittance_threshold (the composite's, read from `trans`), under the
//     step cap and inside the box (a round that ends it stores round -1).
//   - the coarse pass: the lanes test the segments of two rounds at once
//     (lanes 0-15 round r, 16-31 round r + 1) with coarse_segment_mask's
//     arithmetic (lattice.cuh's coarse_keep), within j < n_seg and rounds <
//     n_rounds; a ballot finds the first round from the start that keeps a
//     segment, as segment_plan's nxt does. A ray with none ends.
//   - the fine march of that round's kept segments, 4 segments x 8 points a
//     warp iteration: a point's t = fma(ordinal, dt, startt) at the jittered
//     start, its position, its box test and its bit in the packed 3^3 word of
//     its segment's midpoint cell (lattice.cuh's fine_point), valid below the
//     lattice's n_lat points. A ballot and a prefix popc give each sample its
//     index in the round; maximum_marching_steps caps it with the ray's
//     taken. `exited` where a valid point lies outside the box.
//   - the output: a block-wide prefix over its warps and one atomic a block
//     on this launch's counters give each marched ray its slot in the live
//     list and its samples' first row; the ray's (128,) mask row, and a row
//     per sample: its flat index slot * 128 + column, its position and its
//     warped direction (d + 1) / 2. The live list's order is the order in
//     which blocks take their offsets; every later stage is per ray or per
//     row, so the frame does not depend on it.
// The host reads this launch's counters (live rays, rows, and the frame's
// n_seg) once a round: they size the network's evaluation and the composite.
//
// Bound: bytes. A launch reads a listed ray's 48 B (o, d, t0, startt, k0,
// trans, taken, round) and writes its state, its slot and its 128-byte mask
// row, 32 B a sample; the occupancy's cascade 0 (2 MB at G = 128) and the
// pooled grid (4 KB) are read through L2. At the orbit cell's first round
// (~3 x 10^5 rays, ~4 x 10^6 samples) that is ~0.2 GB, ~0.06 ms at 3.35 TB/s.
// The design keeps every per-point intermediate in registers: no (L, 128)
// t or (L, 128, 3) positions, no plan over every segment of every ray, no
// nonzero; a round with no kept segment costs a ballot.

#include <cuda_runtime.h>

#include "lattice.cuh"

namespace {

using namespace lattice;

constexpr int WARPS = 8;                     // rays (warps) a block
constexpr int RANGE_SEGS = 16;               // segments of a round
constexpr int ROUND = RANGE_SEGS * SEG;      // lattice points of a round
constexpr int ITERS = ROUND / 32;            // warp iterations of a round's fine march
constexpr int SEGS_PER_ITER = 32 / SEG;      // segments a warp iteration marches
constexpr int C_LIVE = 0, C_ROWS = 1, C_NSEG = 2, N_COUNTERS = 3;

struct Params {
  // lattice.cuh's fields (the PACKED lattice's)
  const unsigned char* occ;     // (n_cascades, G, G, G) occupancy; cascade 0 read
  const unsigned char* pooled;  // (n_cascades, P, P, P) halo-pooled super-grid
  int grid, pooled_res, mip_lo, mip_hi;
  float dt, near_thresh, cut_thresh;
  float lo[3], hi[3];
  // the frame's rays, by ray id
  const float* o;               // (N, 3)
  const float* d;               // (N, 3)
  const float* t0;              // (N,) unjittered march start (the coarse pass)
  const float* startt;          // (N,) jittered march start (the fine march)
  const long long* k0;          // (N,) window start ordinal
  const float* trans;           // (N,) transmittance after the ray's last composited round
  int* taken;                   // (N,) samples taken before this round (state across launches)
  int* rnd;                     // (N,) the ray's last round, -1: it ended there (state across launches)
  const long long* n_seg;       // () the frame's window in segments
  // this launch
  const long long* list_in;     // (n_in,) ray ids
  long long* list_out;          // (n_in,) the marched rays' ids, compacted
  unsigned* mask;               // (n_in, ROUND) bool, written as words: a marched ray's samples by column
  long long* flat;              // (n_in * ROUND,) a sample's slot * ROUND + column
  float* pos;                   // (n_in * ROUND, 3) its position
  float* dirs;                  // (n_in * ROUND, 3) its warped direction
  unsigned long long* counts;   // (N_COUNTERS,) this launch's: live rays, rows, n_seg
  int n_in, first, n_rounds, n_lat, max_steps;
  float thresh;
};

__global__ void __launch_bounds__(WARPS * 32) render_march_kernel(Params a) {
  __shared__ int warp_live[WARPS], warp_rows[WARPS];
  __shared__ unsigned long long block_live, block_rows;
  __shared__ unsigned row_words[WARPS][ROUND / 4];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const long long i = (long long)blockIdx.x * WARPS + warp;
  row_words[warp][lane] = 0u;
  long long ray = 0;
  int rnd = -1;  // the round marched (-1: the ray ends in this launch)
  int n = 0;     // its samples
  unsigned sampled = 0u;  // bit it: this lane's point of iteration `it` is a sample
  float sp[ITERS][3], dw[3] = {0.0f, 0.0f, 0.0f};
  int scol[ITERS], sidx[ITERS];
  if (i < a.n_in) {  // the whole warp takes this branch together
    ray = a.list_in[i];
    int taken = 0, from = 0;
    bool go = true;
    if (!a.first) {
      const int last = a.rnd[ray];
      taken = a.taken[ray];
      go = last >= 0 && a.trans[ray] >= a.thresh;
      from = last + 1;
    }
    if (go) {
      float o[3], d[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        o[k] = a.o[3 * ray + k];
        d[k] = a.d[3 * ray + k];
      }
      const long long k0 = a.k0[ray];
      const long long w0 = k0 - k0 % SEG;
      const int s0 = (int)(w0 / SEG);
      const int n_seg = (int)*a.n_seg;
      const int end = min(a.n_rounds, (s0 + n_seg - 1) / RANGE_SEGS + 1);
      const float w0f = __ll2float_rn(w0);
      const float t0 = a.t0[ray];
      unsigned kept = 0u;
      int r = max(from, s0 / RANGE_SEGS);
      for (; r < end; r += 2) {
        const int rr = r + (lane >> 4);
        const int j = RANGE_SEGS * rr - s0 + (lane & (RANGE_SEGS - 1));
        const bool keep = rr < end && j >= 0 && j < n_seg && coarse_keep<PACKED>(a, o, d, t0, w0f, j);
        const unsigned b = __ballot_sync(FULL, keep);
        if (b & 0xffffu) {
          kept = b & 0xffffu;
          break;
        }
        if (b) {
          kept = b >> RANGE_SEGS;
          ++r;
          break;
        }
      }
      if (kept) {
        rnd = r;
        const float st = a.startt[ray];
        const int n_kept = __popc(kept);
        const int pt = lane & (SEG - 1);
        bool exited = false;
        int n_pre = 0;  // samples of the round before this iteration, uncapped
#pragma unroll
        for (int it = 0; it < ITERS; ++it) {
          if (it * SEGS_PER_ITER < n_kept) {
            const int slot = it * SEGS_PER_ITER + lane / SEG;
            const bool live = slot < n_kept;
            unsigned m = kept;
            for (int q = 0; q < slot && m; ++q) m &= m - 1u;
            const int c = live ? __ffs(m) - 1 : 0;  // the slot-th kept segment of the round
            const long long k = (long long)ROUND * r + SEG * c + pt;
            const bool valid = live && k < a.n_lat;
            bool inside;
            int mip;
            float p[3];
            const bool s = fine_point<PACKED>(a, o, d, st, nullptr, k, inside, mip, p) && valid;
            exited = __any_sync(FULL, valid && !inside) || exited;
            const unsigned b = __ballot_sync(FULL, s);
            const int idx = n_pre + __popc(b & below);
            if (s && taken + idx < a.max_steps) {
              sampled |= 1u << it;
              scol[it] = SEG * c + pt;
              sidx[it] = idx;
#pragma unroll
              for (int q = 0; q < 3; ++q) sp[it][q] = p[q];
            }
            n_pre += __popc(b);
          }
        }
        n = min(n_pre, a.max_steps - taken);
#pragma unroll
        for (int q = 0; q < 3; ++q) dw[q] = __fmul_rn(__fadd_rn(d[q], 1.0f), 0.5f);
        if (lane == 0) {
          a.taken[ray] = taken + n;
          a.rnd[ray] = exited || taken + n >= a.max_steps ? -1 : r;
        }
      }
    }
  }
  // the block's slots in the live list and its rows: one atomic each a block
  if (lane == 0) {
    warp_live[warp] = rnd >= 0;
    warp_rows[warp] = n;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int total_live = 0, total_rows = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) {
      total_live += warp_live[w];
      total_rows += warp_rows[w];
    }
    block_live = total_live ? atomicAdd(&a.counts[C_LIVE], (unsigned long long)total_live) : 0ull;
    block_rows = total_rows ? atomicAdd(&a.counts[C_ROWS], (unsigned long long)total_rows) : 0ull;
    if (blockIdx.x == 0) a.counts[C_NSEG] = (unsigned long long)*a.n_seg;
  }
  __syncthreads();
  if (rnd >= 0) {
    unsigned long long slot = block_live, row0 = block_rows;
    for (int w = 0; w < warp; ++w) {
      slot += warp_live[w];
      row0 += warp_rows[w];
    }
    if (lane == 0) a.list_out[slot] = ray;
    unsigned char* row_bytes = reinterpret_cast<unsigned char*>(row_words[warp]);
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      if ((sampled >> it) & 1u) {
        row_bytes[scol[it]] = 1;
        const unsigned long long row = row0 + sidx[it];
        a.flat[row] = (long long)(slot * ROUND + scol[it]);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          a.pos[3 * row + q] = sp[it][q];
          a.dirs[3 * row + q] = dw[q];
        }
      }
    }
    __syncwarp();
    a.mask[slot * (ROUND / 4) + lane] = row_words[warp][lane];
  }
}

}  // namespace

extern "C" {

// One round of the n_in listed rays on `stream`; returns cudaGetLastError()
// (0 = launched). first 1: the frame's first launch (no state read).
int render_march(const void* occ, const void* pooled, const void* o, const void* d, const void* t0, const void* startt,
                 const void* k0, const void* trans, void* taken, void* rnd, const void* n_seg, const void* list_in,
                 void* list_out, void* mask, void* flat, void* pos, void* dirs, void* counts, int n_in, int first,
                 int n_rounds, int n_lat, int max_steps, int grid, int pooled_res, int mip_lo, int mip_hi, float dt,
                 float near_thresh, float cut_thresh, float thresh, float lo_x, float lo_y, float lo_z, float hi_x,
                 float hi_y, float hi_z, void* stream) {
  if (n_in <= 0) return 0;
  Params a{static_cast<const unsigned char*>(occ), static_cast<const unsigned char*>(pooled), grid, pooled_res, mip_lo,
           mip_hi, dt, near_thresh, cut_thresh, {lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z},
           static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(t0),
           static_cast<const float*>(startt), static_cast<const long long*>(k0), static_cast<const float*>(trans),
           static_cast<int*>(taken), static_cast<int*>(rnd), static_cast<const long long*>(n_seg),
           static_cast<const long long*>(list_in), static_cast<long long*>(list_out), static_cast<unsigned*>(mask),
           static_cast<long long*>(flat), static_cast<float*>(pos), static_cast<float*>(dirs),
           static_cast<unsigned long long*>(counts), n_in, first, n_rounds, n_lat, max_steps, thresh};
  const int blocks = (n_in + WARPS - 1) / WARPS;
  render_march_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
