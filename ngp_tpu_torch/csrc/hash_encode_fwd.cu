// Forward of the "oadd" multiresolution hash-grid encoding (the gather), for
// Hopper (sm_90a).
//
// Stands for: the TPU probes that asked how fast one level's gather could run
// inside Pallas, tools/microbench.py::bench_vmem_probe (:29, call :39),
// bench_dyn_gather_lowering (:54, :70), bench_dyn_gather_bf16 (:94, :105),
// bench_row_fetch_lane_select (:123, :144), bench_dyn_gather_single_vreg
// (:428, :441), tools/mb23_mosaic_gather.py::probe_take_along_axis (:53, :67),
// probe_vreg_select_tree (:77, :104) and probe_onehot_mxu (:114, :131). The
// function they were written for is ngp_tpu/ops/hash_encoding.py::
// _encode_oadd_packed (:498-513), plain jnp there:
//   out[n, l*F + f] = sum_k w(n, l, k) * table[l, row(n, l, k), f]
// over the 8 corners k of the cell that sample n falls in at level l
// (hash_grid.cuh has the cell math). pos (N, 3) f32, table (L, T_pad, F) f32,
// out (N, L*F) f32, all contiguous.
//
// Bound: bytes. A sample reads 12 B of position and writes 4*L*F B; the
// table rows it needs are read once each at best (U distinct (level, row)
// pairs of 4*F B, which depend on the positions: ~5.9M at base.json's spec
// for 2^18 uniform positions, far fewer for the samples of a ray-ordered
// batch). At N = 2^18 with uniform positions that is ~3 + ~47 + 34 MB, ~0.025
// ms at 3.35 TB/s; there is almost no arithmetic. What a gather really moves
// is sectors: one random row is one 32-byte sector request into the L2.
//
// Design:
// - Level groups (hash_grid.cuh): a block takes 256 consecutive samples and
//   8 / F levels (4 at base.json's F = 2); blockIdx.y is the group, so the
//   blocks in flight read one group's rows (at most 4 levels x 4 MB at
//   base.json's size), which stay in the 50 MB L2. Each thread takes one
//   sample over the group's levels: its position is staged once per group,
//   and a warp's loads at one level come from 32 consecutive samples, so
//   the samples of one ray share sectors (and requests) at coarse levels.
// - Paired corners: corners k and k|1 are rows r and r + 1 (wrapping only
//   at r = size - 1 of a hash level); at F = 2 an even r reads both with one
//   16-byte load (one 8-byte load at F = 1), so ~6 requests in ~5 sectors a
//   (sample, level) instead of 8 requests.
// - Whole-sector stores: each sample's 8 floats of the group go to shared
//   memory, and the block writes them out with consecutive threads on
//   consecutive floats (a thread per (sample, level) would write 8 bytes
//   128 bytes apart: 32 sectors a warp store for 256 useful bytes).
// - The 8 products are summed in corner order.
// A level count that is not a multiple of the group is masked.
// No "oct" view: ngp_tpu gathers one row of a packed (L, T_pad, 8F) view
// because a TPU gather costs per row; on the card that view would be 8x the
// table (537 MB at base.json's size) and rebuilt every training step.

#include <cstdint>

#include "hash_grid.cuh"

namespace {

using hash_grid::LevelConstants;
using hash_grid::kBlock;
using hash_grid::kStride;

template <int F>
__global__ void __launch_bounds__(kBlock) hash_encode_fwd_kernel(const float* __restrict__ table,
                                                                 const float* __restrict__ pos,
                                                                 float* __restrict__ out, long long n,
                                                                 long long t_pad, int paired, LevelConstants lc) {
  constexpr int G = hash_grid::kGroupFloats / F;  // levels a group
  __shared__ float s_pos[3 * kBlock];
  __shared__ float s_out[kBlock * kStride];
  const long long i0 = (long long)blockIdx.x * kBlock;
  const int nb = (int)min((long long)kBlock, n - i0);
  const int l0 = blockIdx.y * G;
  const int gl = min(G, lc.n_levels - l0);  // levels of this group (the last may be short)
  hash_grid::stage_positions(pos, i0, nb, s_pos);
  __syncthreads();
  const int t = threadIdx.x;
  if (t < nb) {
    const float p[3] = {s_pos[3 * t], s_pos[3 * t + 1], s_pos[3 * t + 2]};
#pragma unroll
    for (int q = 0; q < G; ++q) {
      if (q < gl) {
        const int l = l0 + q;
        const hash_grid::Cell c = hash_grid::locate(p, l, lc);
        const float* level = table + (long long)l * t_pad * F;
        float acc[F];
#pragma unroll
        for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; k += 2) {
          float v0[F], v1[F];
          hash_grid::load_pair<F>(level, hash_grid::corner_row(c, l, k, lc), lc.size[l], paired != 0, v0, v1);
          const float w0 = hash_grid::corner_weight(c, k);
          const float w1 = hash_grid::corner_weight(c, k + 1);
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w0, v0[f]));
#pragma unroll
          for (int f = 0; f < F; ++f) acc[f] = __fadd_rn(acc[f], __fmul_rn(w1, v1[f]));
        }
#pragma unroll
        for (int f = 0; f < F; ++f) s_out[t * kStride + q * F + f] = acc[f];
      }
    }
  }
  __syncthreads();
  hash_grid::store_group(out, i0, nb, lc.n_levels * F, l0 * F, gl * F, s_out);
}

template <int F>
int launch(const void* table, const void* pos, void* out, long long n, long long t_pad, const LevelConstants& lc,
           cudaStream_t stream) {
  constexpr int G = hash_grid::kGroupFloats / F;
  // one load for a row pair needs each level's base aligned to 2 rows
  const int paired = (t_pad % 2 == 0) && (reinterpret_cast<uintptr_t>(table) % (8 * F) == 0);
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock), (unsigned)((lc.n_levels + G - 1) / G));
  hash_encode_fwd_kernel<F><<<grid, kBlock, 0, stream>>>(static_cast<const float*>(table),
                                                         static_cast<const float*>(pos), static_cast<float*>(out),
                                                         n, t_pad, paired, lc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// out (N, L*F) = the encoding of pos (N, 3) through table (L, T_pad, F) on
// `stream`. Returns cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for a feature width other than 1, 2, 4, 8 or a
// level count outside [1, 32].
int hash_encode_fwd(const void* table, const void* pos, void* out, long long n, long long t_pad, int f,
                    const hash_grid::LevelConstants* lc, void* stream) {
  if (lc->n_levels < 1 || lc->n_levels > hash_grid::kMaxLevels) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 1: return launch<1>(table, pos, out, n, t_pad, *lc, s);
    case 2: return launch<2>(table, pos, out, n, t_pad, *lc, s);
    case 4: return launch<4>(table, pos, out, n, t_pad, *lc, s);
    case 8: return launch<8>(table, pos, out, n, t_pad, *lc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
