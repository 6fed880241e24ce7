// The spp-n Shade frame's cover march on the PACKED lattice, for Hopper
// (sm_90a): one round of every live ray of a block of the frame in one launch
// (render_cover_march), with the coarse pass, the cover test of the round's
// kept segments and of the lookahead segment, the step cap, the ray's end, the
// rows the shared evaluation takes, and the compaction of the live rays and of
// those rows.
//
// Replaces: no Pallas kernel of ngp_tpu. ngp_tpu marches its batched frame as
// XLA code (ngp_tpu/render/renderer.py's _coarse_pass and the jitter_cover
// count_samples_segments over ngp_tpu/sampling/lattice.py). The port's plain
// path (the coarse pass over every segment of every hit ray's window, the
// segment plan and its cull, then a round of march_round(lookahead=1,
// jitter_cover=True) over (L, 136) ordinals and (L, 136, 3) positions, the
// sample ordinals' cumsum, the lerp partners, a nonzero over the rows to
// evaluate and the live rays' bookkeeping) runs some hundred PyTorch
// operations a round and synchronises with the host three times a round. This
// kernel computes the same rows, masks and state bit for bit
// (render/march.py's render_cover_march_plain is its plain version, with its
// interface).
//
// A round is RANGE_SEGS = 16 segments of 8 lattice points, aligned at the
// ray's window start k0: round r holds ordinals k0 + 128 r .. k0 + 128 r + 127,
// and its lookahead segment the 8 after them. Segment j of the window is kept
// where coarse_segment_mask keeps it (the pooled grid at the segment's
// midpoint at the unjittered t0). A ray marches rounds below its `limit`
// (ceil(span / 128)); the lookahead segment is tested whatever the limit.
//
// render_cover_march, one warp a ray of the launch's list:
//   - the ray's start: on a block's first launch, from round 0, no sample
//     taken and nothing carried; after it, the ray's round, taken and carried
//     flag from the last launch, and the ray goes on only if that round left
//     it in the box and under the step cap (a round that ends it stores round
//     -1) and some pass's transmittance (the composite's (R, P) `trans`) is
//     >= transmittance_threshold.
//   - the coarse pass: the lanes test the segments of two rounds at once
//     (lanes 0-15 round r, 16-31 round r + 1) with coarse_segment_mask's
//     arithmetic (lattice.cuh's coarse_keep) below the ray's limit; a ballot
//     finds the first round from the start that keeps a segment, as
//     segment_plan's nxt does. A ray with none ends. Then the lookahead
//     segment's coarse test.
//   - the cover march of that round's 128 points, 32 a warp iteration (an
//     iteration with no kept segment costs a ballot), and of the lookahead
//     segment's first point, with lattice.cuh's cover_point at the unjittered
//     t0. A ballot and a prefix popc give each cover point its ordinal in the
//     round; maximum_marching_steps caps it with the ray's taken. `exited`
//     where a point of a kept segment of the round (the lookahead aside) and
//     the end of its segment both lie outside the box.
//   - the rows to evaluate, from the round's mask words: q, a point's sample
//     ordinal on its ray (taken plus a prefix popc); adj, the lerp partner
//     (the next point is a sample too, the lookahead point after column 127,
//     and q + 1 is not a multiple of SHARE_ROUND); ev, the samples, less
//     column 0 where the last round carried its evaluation in, plus the
//     lookahead point (column 128) where column 127 lerps towards it, which
//     the ray carries out.
//   - the output, in list order: each block takes a ticket (its place in the
//     list, in the order blocks start) and finds the live rays and rows of
//     the blocks before it by a decoupled look-back (one status word a
//     block: its own count, then its inclusive prefix), and a block-wide
//     prefix over its warps gives each marched ray its slot in the live list
//     and its rows' first row; the ray's (128,) mask and adj rows, its
//     carried-in and carried-out flags and its (128,) t (the composite's box
//     test fma(u, dt, t) <= tmax takes t as written here, not recomputed);
//     and a row per point to evaluate, by column: its flat index
//     slot * 129 + column, its position and its warped direction (d + 1) / 2.
//     So the live list and the rows come out in the plain version's order
//     (its nonzero's), and the frame to the byte: the composite's batched
//     products over more than 65,535 rays give a ray other bits at another
//     place in the batch, and an order set by atomics would differ from run
//     to run.
// The host reads this launch's counters (live rays, rows) once a round: they
// size the network's evaluation and the composite.
//
// Bound: bytes. A launch reads a listed ray's id and state (17 B) and its P
// transmittances (32 B at spp 8), 40 B more for a ray it marches (o, d, t0,
// k0, limit), and writes that ray's state, its slot, its 128-byte mask and
// adj rows, its 2 flags and its 512-byte t row, and 32 B a row; the packed
// words (8 MB at G = 128) and the pooled grid (4 KB) are read through L2. The design keeps every per-point intermediate in
// registers: no (R, n_seg) plan, no (L, 136) t or (L, 136, 3) positions, no
// nonzero; a round with no kept segment costs a ballot.

#include <cuda_runtime.h>

#include "lattice.cuh"

namespace {

using namespace lattice;

constexpr int WARPS = 8;                  // rays (warps) a block
constexpr int RANGE_SEGS = 16;            // segments of a round
constexpr int ROUND = RANGE_SEGS * SEG;   // lattice points of a round
constexpr int COLS = ROUND + 1;           // a round's evaluation columns: its points and the lookahead point
constexpr int ITERS = ROUND / 32;         // warp iterations of a round's cover march
constexpr int SEGS_PER_ITER = 32 / SEG;   // segments a warp iteration marches
constexpr int C_LIVE = 0, C_ROWS = 1;
// a block's status word: a flag in the top two bits, its live rays in bits
// 32-61 and its rows in bits 0-31 (so two words add field by field)
constexpr unsigned long long AGGREGATE = 1ull << 62, PREFIX = 2ull << 62, VALUE = AGGREGATE - 1ull;

struct Params {
  // lattice.cuh's fields (the PACKED lattice's)
  const unsigned char* pooled;  // (n_cascades, P, P, P) halo-pooled super-grid
  const int* packed;            // (G^3,) cascade 0's packed 3^3 words
  int grid, pooled_res, mip_lo, mip_hi;
  float dt, near_thresh, cut_thresh;
  float lo[3], hi[3];
  // the block's rays, by index in the block
  const float* o;               // (R, 3)
  const float* d;               // (R, 3)
  const float* t0;              // (R,) unjittered march start
  const long long* k0;          // (R,) window start ordinal
  const int* limit;             // (R,) rounds of the window: ceil(span / 128)
  const float* trans;           // (R, n_pass) each pass's transmittance after the ray's last composited round
  int* taken;                   // (R,) samples taken before this round (state across launches)
  int* rnd;                     // (R,) the ray's last round, -1: it ended there (state across launches)
  unsigned char* carried;       // (R,) bool: the last round evaluated this round's first point (state)
  // this launch
  const long long* list_in;     // (n_in,) ray indices
  long long* list_out;          // (n_in,) the marched rays' indices, compacted
  unsigned* mask;               // (n_in, ROUND) bool, written as words: a marched ray's samples by column
  unsigned* adj;                // (n_in, ROUND) bool, as words: the column lerps towards the next one
  unsigned char* carry;         // (n_in, 2) bool: carried in, carried out
  float* t;                     // (n_in, ROUND) the round's t by column
  long long* flat;              // (n_in * COLS,) a row's slot * COLS + column
  float* pos;                   // (n_in * COLS, 3) its position
  float* dirs;                  // (n_in * COLS, 3) its warped direction
  unsigned long long* counts;   // (2,) this launch's: live rays, rows
  unsigned long long* scan;     // (1 + blocks,) zero: the blocks' ticket, then a status word a block
  int n_in, first, n_rounds, max_steps, n_pass, share_round;
  float thresh;
};

// four mask bits from `bit` on as the bytes of a word (bool columns 4l .. 4l + 3)
__device__ __forceinline__ unsigned bytes_of(const unsigned (&w)[ITERS], int bit) {
  const unsigned b = (w[bit >> 5] >> (bit & 31)) & 0xfu;
  return (b & 1u) | ((b & 2u) << 7) | ((b & 4u) << 14) | ((b & 8u) << 21);
}

// The live rays and rows of the blocks before ticket b, from their status
// words (thread 0 of block b; every block before b has started, so each
// publishes its count without waiting on another).
__device__ unsigned long long look_back(unsigned long long* status, long long b, unsigned long long own) {
  if (b == 0) {
    atomicExch(&status[0], PREFIX | own);
    return 0ull;
  }
  atomicExch(&status[b], AGGREGATE | own);
  unsigned long long before = 0ull;
  for (long long j = b - 1;; --j) {
    unsigned long long w;
    do {
      w = *reinterpret_cast<volatile unsigned long long*>(&status[j]);
    } while (!(w & ~VALUE));
    before += w & VALUE;
    if (w & PREFIX) break;
  }
  atomicExch(&status[b], PREFIX | (before + own));
  return before;
}

__global__ void __launch_bounds__(WARPS * 32) render_cover_march_kernel(Params a) {
  __shared__ int warp_live[WARPS], warp_rows[WARPS];
  __shared__ unsigned long long ticket, block_before;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  if (threadIdx.x == 0) ticket = atomicAdd(&a.scan[0], 1ull);
  __syncthreads();
  const long long b = (long long)ticket;
  const long long i = b * WARPS + warp;
  long long ray = 0, k_round = 0;
  int rnd = -1;    // the round marched (-1: the ray ends in this launch)
  int n_rows = 0;  // its rows to evaluate
  bool c_in = false, c_out = false;
  unsigned mw[ITERS] = {0u, 0u, 0u, 0u}, aw[ITERS] = {0u, 0u, 0u, 0u}, ew[ITERS] = {0u, 0u, 0u, 0u};
  float sp[ITERS][3], sl[3] = {0.0f, 0.0f, 0.0f}, dw[3] = {0.0f, 0.0f, 0.0f}, t0 = 0.0f;
  if (i < a.n_in) {  // the whole warp takes this branch together
    ray = a.list_in[i];
    int taken = 0, from = 0;
    bool go = true;
    if (!a.first) {
      const int last = a.rnd[ray];
      taken = a.taken[ray];
      c_in = a.carried[ray] != 0;
      go = last >= 0;
      if (go) {
        bool above = false;
        for (int p = lane; p < a.n_pass; p += 32) above = above || a.trans[ray * a.n_pass + p] >= a.thresh;
        go = __any_sync(FULL, above);
      }
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
      const float k0f = __ll2float_rn(k0);
      t0 = a.t0[ray];
      const int end = min(a.limit[ray], a.n_rounds);
      unsigned kept = 0u;
      int r = from;
      for (; r < end; r += 2) {
        const int rr = r + (lane >> 4);
        const int j = RANGE_SEGS * rr + (lane & (RANGE_SEGS - 1));
        const bool keep = rr < end && coarse_keep<PACKED>(a, o, d, t0, k0f, j);
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
        k_round = k0 + (long long)ROUND * r;
        bool exited = false;
        int n_pre = 0;  // cover points of the round before this iteration, uncapped
#pragma unroll
        for (int it = 0; it < ITERS; ++it) {
          const unsigned segs = (kept >> (SEGS_PER_ITER * it)) & 0xfu;
          bool s = false;
          if (segs) {
            const bool valid = (segs >> (lane / SEG)) & 1u;
            bool inside;
            float p[3];
            s = cover_point(a, o, d, t0, k_round + 32 * it + lane, inside, p) && valid;
            exited = __any_sync(FULL, valid && !inside) || exited;
#pragma unroll
            for (int q = 0; q < 3; ++q) sp[it][q] = p[q];
          }
          const unsigned b = __ballot_sync(FULL, s);
          mw[it] = __ballot_sync(FULL, s && taken + n_pre + __popc(b & below) < a.max_steps);
          n_pre += __popc(b);
        }
        // the lookahead segment: only its first point (column 128) is read
        bool m_next = false;
        if (coarse_keep<PACKED>(a, o, d, t0, k0f, RANGE_SEGS * (r + 1))) {
          bool inside;
          float p[3];
          const bool s = cover_point(a, o, d, t0, k_round + ROUND + (lane & (SEG - 1)), inside, p);
          m_next = __shfl_sync(FULL, s, 0) && taken + n_pre < a.max_steps;
#pragma unroll
          for (int q = 0; q < 3; ++q) sl[q] = __shfl_sync(FULL, p[q], 0);
        }
        // q, adj and ev of the lane's column 32 it + lane
        int q_pre = taken;  // samples of the ray before this iteration's columns
#pragma unroll
        for (int it = 0; it < ITERS; ++it) {
          const unsigned first_next = it + 1 < ITERS ? mw[min(it + 1, ITERS - 1)] & 1u : (unsigned)m_next;
          const bool next = lane < 31 ? (mw[it] >> (lane + 1)) & 1u : first_next;
          const int q = q_pre + __popc(mw[it] & below);
          aw[it] = __ballot_sync(FULL, next && (q + 1) % a.share_round != 0);
          q_pre += __popc(mw[it]);
          ew[it] = mw[it];
        }
        if (c_in) ew[0] &= ~1u;
        c_out = (mw[ITERS - 1] >> 31) & (aw[ITERS - 1] >> 31) & 1u;
        n_rows = (int)c_out;
#pragma unroll
        for (int it = 0; it < ITERS; ++it) n_rows += __popc(ew[it]);
#pragma unroll
        for (int q = 0; q < 3; ++q) dw[q] = __fmul_rn(__fadd_rn(d[q], 1.0f), 0.5f);
        const int n = min(n_pre, a.max_steps - taken);
        if (lane == 0) {
          a.taken[ray] = taken + n;
          a.rnd[ray] = exited || taken + n >= a.max_steps ? -1 : r;
          a.carried[ray] = c_out;
        }
      }
    }
  }
  // the block's slots in the live list and its rows, after the blocks before it
  if (lane == 0) {
    warp_live[warp] = rnd >= 0;
    warp_rows[warp] = n_rows;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long own = 0ull;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) own += ((unsigned long long)warp_live[w] << 32) + (unsigned long long)warp_rows[w];
    const unsigned long long before = look_back(a.scan + 1, b, own);
    block_before = before;
    if (b == (long long)gridDim.x - 1) {
      a.counts[C_LIVE] = (before + own) >> 32;
      a.counts[C_ROWS] = (before + own) & 0xffffffffull;
    }
  }
  __syncthreads();
  if (rnd >= 0) {
    unsigned long long slot = block_before >> 32, row = block_before & 0xffffffffull;
    for (int w = 0; w < warp; ++w) {
      slot += warp_live[w];
      row += warp_rows[w];
    }
    if (lane == 0) {
      a.list_out[slot] = ray;
      a.carry[2 * slot] = c_in;
      a.carry[2 * slot + 1] = c_out;
    }
    a.mask[slot * (ROUND / 4) + lane] = bytes_of(mw, 4 * lane);
    a.adj[slot * (ROUND / 4) + lane] = bytes_of(aw, 4 * lane);
#pragma unroll
    for (int it = 0; it < ITERS; ++it) {
      const int col = 32 * it + lane;
      a.t[slot * ROUND + col] = fma_once(__ll2float_rn(k_round + col), a.dt, t0);
      if ((ew[it] >> lane) & 1u) {
        const unsigned long long r = row + __popc(ew[it] & below);
        a.flat[r] = (long long)(slot * COLS + col);
#pragma unroll
        for (int q = 0; q < 3; ++q) {
          a.pos[3 * r + q] = sp[it][q];
          a.dirs[3 * r + q] = dw[q];
        }
      }
      row += __popc(ew[it]);
    }
    if (c_out && lane == 0) {
      a.flat[row] = (long long)(slot * COLS + ROUND);
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        a.pos[3 * row + q] = sl[q];
        a.dirs[3 * row + q] = dw[q];
      }
    }
  }
}

}  // namespace

extern "C" {

// One round of the n_in listed rays of a block on `stream`; returns
// cudaGetLastError() (0 = launched). first 1: the block's first launch (no
// state read).
int render_cover_march(const void* pooled, const void* packed, const void* o, const void* d, const void* t0,
                       const void* k0, const void* limit, const void* trans, void* taken, void* rnd, void* carried,
                       const void* list_in, void* list_out, void* mask, void* adj, void* carry, void* t, void* flat,
                       void* pos, void* dirs, void* counts, void* scan, int n_in, int first, int n_rounds, int max_steps,
                       int n_pass, int share_round, int grid, int pooled_res, int mip_lo, int mip_hi, float dt,
                       float near_thresh, float cut_thresh, float thresh, float lo_x, float lo_y, float lo_z,
                       float hi_x, float hi_y, float hi_z, void* stream) {
  if (n_in <= 0) return 0;
  Params a{static_cast<const unsigned char*>(pooled), static_cast<const int*>(packed), grid, pooled_res, mip_lo,
           mip_hi, dt, near_thresh, cut_thresh, {lo_x, lo_y, lo_z}, {hi_x, hi_y, hi_z},
           static_cast<const float*>(o), static_cast<const float*>(d), static_cast<const float*>(t0),
           static_cast<const long long*>(k0), static_cast<const int*>(limit), static_cast<const float*>(trans),
           static_cast<int*>(taken), static_cast<int*>(rnd), static_cast<unsigned char*>(carried),
           static_cast<const long long*>(list_in), static_cast<long long*>(list_out), static_cast<unsigned*>(mask),
           static_cast<unsigned*>(adj), static_cast<unsigned char*>(carry), static_cast<float*>(t),
           static_cast<long long*>(flat), static_cast<float*>(pos), static_cast<float*>(dirs),
           static_cast<unsigned long long*>(counts), static_cast<unsigned long long*>(scan), n_in, first, n_rounds,
           max_steps, n_pass, share_round, thresh};
  const int blocks = (n_in + WARPS - 1) / WARPS;
  render_cover_march_kernel<<<blocks, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
