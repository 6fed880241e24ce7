// Backward of the hash-grid encoding into its table (the scatter), for
// Hopper (sm_90a). Two entry points:
//
//   exact:      d[l, row(n, l, k)] += w(n, l, k) * g[n, l]   for all 8 corners,
//               in each of the three variants (hash_grid.cuh;
//               ngp_tpu/ops/hash_encoding.py::_bwd_oadd, :606-650,
//               _bwd_xadd, :373-419, _bwd_tcnn, :252-276, without d/dpos;
//               the plain version is ops/hash_encoding.py::
//               hash_bwd_exact_plain)
//   stochastic: d[l, row(n, l, k*)] += kr * g[n, l]           for one corner
//               k* drawn with probability w(n, l, k*), from a hash of pos's
//               float32 bits (_bwd_oadd_stochastic, :520-603; plain version
//               hash_bwd_oadd_stochastic_plain). With level subsampling
//               (kr > 1, N % kr == 0) sample n deposits only into the levels
//               l with l % kr == n % kr; otherwise kr = 1. oadd only, as
//               ngp_tpu draws only for oadd (:742).
//
// g (N, L*F) f32, pos (N, 3) f32, d (L, T_pad, F) f32, zero-filled by the
// caller, all contiguous.
//
// Stands for: the TPU probes of one level's backward scatter inside Pallas,
// tools/microbench.py::bench_mxu_window_scatter (:252, call :278) and
// bench_lane_route_scatter (:299, call :325).
//
// Bound: bytes. Positions in (12 B a sample), the g that is deposited (4*F B
// per sample and level, over kr for the stochastic draw) and the whole
// (L, T_pad, F) gradient written once (67 MB at base.json's size, which the
// zero fill already costs). What the kernels really do is vector atomic
// adds, which run in the L2: about 6*L*N units (exact, on uniform positions)
// or L*N/kr rows (stochastic), fewer where the lanes of a warp merge theirs.
//
// Design of the exact entry (instantiated for each variant):
// - Level groups with staged g, as the stochastic entry below: a block takes
//   256 consecutive samples and 8 / F levels, blockIdx.y the group, its
//   positions staged once and g's (sample, group) sector read whole by
//   coalesced loads (one thread a (sample, level) read 8 bytes 128 bytes
//   apart: 32 sectors a warp for 256 useful bytes). Each thread takes one
//   sample over the group's levels, so the atomics in flight land in one
//   group's rows (at most 4 levels x 4 MB at base.json's size, in the L2).
// - Paired vector deposits: corners k and k|1 (k even) differ only in x. At
//   F <= 2 a deposit is a unit of two flat rows {2u, 2u + 1} of the
//   (L * T_pad, F) gradient: one 8-byte float2 atomicAdd at F = 1, one
//   16-byte float4 at F = 2 (Hopper's vector atomics on global memory; the
//   entry takes only an even L * T_pad and d aligned to two rows, which
//   every spec of the port gives); at F >= 4 a unit is one row (already
//   16-byte atomics). Where the pair's two
//   rows fall in one unit, one deposit adds both: oadd and xadd at an even
//   r (rows r and r + 1), tcnn on a hash level at an even base x (rows h and
//   h ^ 1, size a power of two), tcnn on a dense level where x clamps at
//   res - 1 (one row: both products summed, as the plain version sums them).
//   Otherwise each row goes as its own unit, the other half zero (adding
//   +0.0 to a row that started at +0.0 leaves it bit for bit as it was).
//   About 6 vector atomics a (sample, level) on uniform positions, against
//   8 x F scalar ones (67.1M a launch at base.json's size) before.
// - Warp-merged deposits (deposit_merged, as the stochastic entry): a batch
//   is ray-major, so at the coarse levels the lanes of one ray add into the
//   same rows, and their atomics serialise in the L2. For each corner pair,
//   lanes with the same unit find each other with __match_any_sync on the
//   32-bit unit index and the group's lowest lane adds the sum: a first
//   round for each lane's first unit, a second, where any lane of the warp
//   has one, for the units of pairs that span two. Every deposit is a whole
//   unit, so no deposit of another width shares a key.
// Each product is __fmul_rn(w, g), as the plain version's; only the order of
// the sums differs.
//
// Design of the stochastic entry:
// - Level groups, as the gather (hash_grid.cuh): a block takes 256
//   consecutive samples and 8 / F levels, blockIdx.y the group, so the
//   atomics in flight land in one group's rows (at most 4 levels x 4 MB at
//   base.json's size). Each thread takes one sample over the group's levels
//   it feeds (l % kr == n % kr); its position is staged once per group, and
//   g's (sample, group) sector is read whole by coalesced loads (a thread
//   per (sample, level) would read 8 bytes 128 bytes apart).
// - Warp-merged deposits: a training batch is ray-major, so at the coarse
//   levels many lanes of a warp deposit into the same row, and their
//   atomics serialise on it in the L2. Lanes with the same (level, row) find
//   each other with __match_any_sync on the 32-bit key l * T_pad + row, sum
//   their kr * g by shuffles (pointer jumping along the group's lanes in
//   lane order: log2 of the group's size steps, none where every row is
//   distinct), and the group's lowest lane adds the sum.
// - One vector reduction a deposit: atomicAdd on a float2 at F = 2 (float4
//   at F = 4 and 8; Hopper's vector atomics on global memory), a float at F = 1.
// Both entries are reductions (nothing is read back). The order in which the
// adds land is not fixed, as with index_add_ on the card: sums of values that
// are not exact in fp32 differ from run to run in their last bits; on
// dyadic g every partial sum is exact and the result is bit-equal to the
// plain version.

#include "hash_grid.cuh"

namespace {

using hash_grid::LevelConstants;
using hash_grid::kBlock;
using hash_grid::kStride;

// the draw's constants (ngp_tpu/ops/hash_encoding.py:561-565, :586-587)
constexpr uint32_t kPosMulX = 0x9E3779B1u, kPosMulY = 0x85EBCA77u, kPosMulZ = 0xC2B2AE3Du;
constexpr uint32_t kLevelSalt = 0x27D4EB2Fu;
constexpr uint32_t kMix = 0x2C1B3C6Du;

constexpr unsigned kFullWarp = 0xFFFFFFFFu;
// never a unit or a row: the entries check L * T_pad < 2^32 - 1
constexpr uint32_t kNoDeposit = 0xFFFFFFFFu;

// Add v (F floats) into unit `key` of d, F floats a unit (a row of the flat
// (L * T_pad, F) gradient, or two rows of the exact entry's paired units),
// once for each group of the warp's lanes with the same key: the group's
// values are summed by shuffles and its lowest lane adds the sum. Every lane
// of the warp calls this together; an inactive lane deposits nothing.
template <int F>
__device__ __forceinline__ void deposit_merged(float* __restrict__ d, uint32_t key, bool active, float (&v)[F]) {
  const int lane = threadIdx.x & 31;
  const unsigned peers = __match_any_sync(kFullWarp, key);
  // pointer jumping: nxt is the group's next lane above this one; after step
  // s, v sums this lane and the 2^(s+1) - 1 lanes after it in the group
  int nxt = active ? __ffs(peers & (0xFFFFFFFEu << lane)) - 1 : -1;
  while (__any_sync(kFullWarp, nxt >= 0)) {
    const int src = nxt >= 0 ? nxt : lane;
    float o[F];
#pragma unroll
    for (int f = 0; f < F; ++f) o[f] = __shfl_sync(kFullWarp, v[f], src);
    const int onxt = __shfl_sync(kFullWarp, nxt, src);
    if (nxt >= 0) {
#pragma unroll
      for (int f = 0; f < F; ++f) v[f] = __fadd_rn(v[f], o[f]);
      nxt = onxt;
    }
  }
  if (!active || lane != __ffs(peers) - 1) return;
  float* dst = d + (size_t)key * F;
  if constexpr (F == 1) {
    atomicAdd(dst, v[0]);
  } else if constexpr (F == 2) {
    atomicAdd(reinterpret_cast<float2*>(dst), make_float2(v[0], v[1]));
  } else {
#pragma unroll
    for (int j = 0; j < F; j += 4) atomicAdd(reinterpret_cast<float4*>(dst + j), make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]));
  }
}

// Add v (F floats) into the slot of flat row `row` in a deposit unit u of
// 2^S rows (W = F << S floats).
template <int F, int S, int W>
__device__ __forceinline__ void add_to_unit(float (&u)[W], uint32_t row, const float (&v)[F]) {
  const int slot = S ? (int)(row & 1u) : 0;
#pragma unroll
  for (int h = 0; h < (1 << S); ++h) {
#pragma unroll
    for (int f = 0; f < F; ++f) u[h * F + f] = h == slot ? __fadd_rn(u[h * F + f], v[f]) : u[h * F + f];
  }
}

template <int F, int V>
__global__ void __launch_bounds__(kBlock) hash_bwd_exact_kernel(const float* __restrict__ pos,
                                                                const float* __restrict__ g, float* __restrict__ d,
                                                                long long n, long long t_pad, LevelConstants lc) {
  constexpr int G = hash_grid::kGroupFloats / F;  // levels a group
  constexpr int S = F <= 2 ? 1 : 0;               // log2 of the rows a unit spans
  constexpr int W = F << S;                       // floats a unit
  __shared__ float s_pos[3 * kBlock];
  __shared__ float s_g[kBlock * kStride];
  const long long i0 = (long long)blockIdx.x * kBlock;
  const int nb = (int)min((long long)kBlock, n - i0);
  const int l0 = blockIdx.y * G;
  const int gl = min(G, lc.n_levels - l0);  // levels of this group (the last may be short)
  hash_grid::stage_positions(pos, i0, nb, s_pos);
  hash_grid::load_group(g, i0, nb, lc.n_levels * F, l0 * F, gl * F, s_g);
  __syncthreads();
  // every thread of the block runs the loops below (the warp-wide merge
  // needs all 32 lanes); a thread past the batch's end deposits nothing
  const int t = threadIdx.x;
  const bool live = t < nb;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    p[0] = s_pos[3 * t];
    p[1] = s_pos[3 * t + 1];
    p[2] = s_pos[3 * t + 2];
  }
  for (int q = 0; q < gl; ++q) {
    const int l = l0 + q;
    const auto c = hash_grid::locate_cell<V>(p, l, lc);
    const uint32_t base = (uint32_t)l * (uint32_t)t_pad;  // the level's first flat row
    float gv[F];
#pragma unroll
    for (int f = 0; f < F; ++f) gv[f] = live ? s_g[t * kStride + q * F + f] : 0.0f;
#pragma unroll
    for (int k = 0; k < 8; k += 2) {
      const uint32_t r0 = base + hash_grid::corner_row(c, l, k, lc);
      const uint32_t r1 = base + hash_grid::corner_row(c, l, k + 1, lc);
      const float w0 = hash_grid::corner_weight(c, k), w1 = hash_grid::corner_weight(c, k + 1);
      float v0[F], v1[F];
#pragma unroll
      for (int f = 0; f < F; ++f) {
        v0[f] = __fmul_rn(w0, gv[f]);
        v1[f] = __fmul_rn(w1, gv[f]);
      }
      const bool one = (r0 >> S) == (r1 >> S);  // both corners in one unit
      float u[W];
#pragma unroll
      for (int f = 0; f < W; ++f) u[f] = 0.0f;
      add_to_unit<F, S, W>(u, r0, v0);
      if (one) add_to_unit<F, S, W>(u, r1, v1);
      deposit_merged<W>(d, live ? r0 >> S : kNoDeposit, live, u);
      const bool two = live && !one;
      if (__any_sync(kFullWarp, two)) {
#pragma unroll
        for (int f = 0; f < W; ++f) u[f] = 0.0f;
        add_to_unit<F, S, W>(u, r1, v1);
        deposit_merged<W>(d, two ? r1 >> S : kNoDeposit, two, u);
      }
    }
  }
}

template <int F>
__global__ void __launch_bounds__(kBlock) hash_bwd_stochastic_kernel(const float* __restrict__ pos,
                                                                     const float* __restrict__ g,
                                                                     float* __restrict__ d, long long n, int kr,
                                                                     long long t_pad, LevelConstants lc) {
  constexpr int G = hash_grid::kGroupFloats / F;  // levels a group
  __shared__ float s_pos[3 * kBlock];
  __shared__ float s_g[kBlock * kStride];
  const long long i0 = (long long)blockIdx.x * kBlock;
  const int nb = (int)min((long long)kBlock, n - i0);
  const int l0 = blockIdx.y * G;
  const int gl = min(G, lc.n_levels - l0);  // levels of this group (the last may be short)
  hash_grid::stage_positions(pos, i0, nb, s_pos);
  hash_grid::load_group(g, i0, nb, lc.n_levels * F, l0 * F, gl * F, s_g);
  __syncthreads();
  // every thread of the block runs the loop below the same number of times
  // (the warp-wide merge needs all 32 lanes); a thread past the batch's end
  // is inactive
  const int t = threadIdx.x;
  const bool live = t < nb;
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    p[0] = s_pos[3 * t];
    p[1] = s_pos[3 * t + 1];
    p[2] = s_pos[3 * t + 2];
  }
  const uint32_t hp = (__float_as_uint(p[0]) * kPosMulX) ^ (__float_as_uint(p[1]) * kPosMulY) ^
                      (__float_as_uint(p[2]) * kPosMulZ);
  // sample i feeds the levels l with l % kr == i % kr: the group's first
  // such level is l0 + first, then every kr-th
  const int first = (int)((((i0 + t) % kr) - l0 % kr + kr) % kr);
  const int steps = (gl + kr - 1) / kr;
  const float scale = (float)kr;
  for (int s = 0; s < steps; ++s) {
    const int q = first + s * kr;  // the level's place in the group
    const bool active = live && q < gl;
    uint32_t key = kNoDeposit;
    float v[F];
#pragma unroll
    for (int f = 0; f < F; ++f) v[f] = 0.0f;
    if (active) {
      const int l = l0 + q;
      const hash_grid::Cell c = hash_grid::locate(p, l, lc);  // oadd's cell
      uint32_t h = hp ^ (uint32_t)(l + 1) * kLevelSalt;
      int k = 0;
#pragma unroll
      for (int dim = 0; dim < 3; ++dim) {  // one independent 24-bit uniform per dimension
        h = (h ^ (h >> 15)) * kMix;
        const float u = (float)(h >> 8) * 0x1p-24f;  // exact: h >> 8 < 2^24
        k |= (u >= c.w0[dim] ? 1 : 0) << dim;
      }
      key = (uint32_t)l * (uint32_t)t_pad + hash_grid::corner_row(c, l, k, lc);
#pragma unroll
      for (int f = 0; f < F; ++f) {
        const float gv = s_g[t * kStride + q * F + f];
        v[f] = kr > 1 ? __fmul_rn(gv, scale) : gv;
      }
    }
    deposit_merged<F>(d, key, active, v);
  }
}

template <int F, int V>
int launch_exact(const float* p, const float* gg, float* dd, long long n, long long t_pad, const LevelConstants& lc,
                 cudaStream_t stream) {
  constexpr int G = hash_grid::kGroupFloats / F;
  // a unit of two rows (F <= 2) needs the flat gradient's row count even and
  // d aligned to two rows
  if (F <= 2 && (lc.n_levels * t_pad % 2 != 0 || reinterpret_cast<uintptr_t>(dd) % (8 * F) != 0))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kBlock - 1) / kBlock), (unsigned)((lc.n_levels + G - 1) / G));
  hash_bwd_exact_kernel<F, V><<<grid, kBlock, 0, stream>>>(p, gg, dd, n, t_pad, lc);
  return (int)cudaGetLastError();
}

template <int F>
int launch(bool stochastic, const void* pos, const void* g, void* d, long long n, int kr, long long t_pad,
           const LevelConstants& lc, cudaStream_t stream) {
  const auto* p = static_cast<const float*>(pos);
  const auto* gg = static_cast<const float*>(g);
  auto* dd = static_cast<float*>(d);
  if (stochastic) {
    constexpr int G = hash_grid::kGroupFloats / F;
    const dim3 grid((unsigned)((n + kBlock - 1) / kBlock), (unsigned)((lc.n_levels + G - 1) / G));
    hash_bwd_stochastic_kernel<F><<<grid, kBlock, 0, stream>>>(p, gg, dd, n, kr, t_pad, lc);
    return (int)cudaGetLastError();
  }
  switch (lc.variant) {
    case hash_grid::kOadd: return launch_exact<F, hash_grid::kOadd>(p, gg, dd, n, t_pad, lc, stream);
    case hash_grid::kXadd: return launch_exact<F, hash_grid::kXadd>(p, gg, dd, n, t_pad, lc, stream);
    case hash_grid::kTcnn: return launch_exact<F, hash_grid::kTcnn>(p, gg, dd, n, t_pad, lc, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

int dispatch(bool stochastic, const void* pos, const void* g, void* d, long long n, int kr, long long t_pad, int f,
             const hash_grid::LevelConstants* lc, void* stream) {
  if (lc->n_levels < 1 || lc->n_levels > hash_grid::kMaxLevels || kr < 1) return (int)cudaErrorInvalidValue;
  if ((unsigned long long)lc->n_levels * (unsigned long long)t_pad >= kNoDeposit) return (int)cudaErrorInvalidValue;
  if (n <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (f) {
    case 1: return launch<1>(stochastic, pos, g, d, n, kr, t_pad, *lc, s);
    case 2: return launch<2>(stochastic, pos, g, d, n, kr, t_pad, *lc, s);
    case 4: return launch<4>(stochastic, pos, g, d, n, kr, t_pad, *lc, s);
    case 8: return launch<8>(stochastic, pos, g, d, n, kr, t_pad, *lc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Each adds into d (L, T_pad, F) on `stream` and returns cudaGetLastError()
// after the launch (0 = launched), or cudaErrorInvalidValue for a feature
// width other than 1, 2, 4, 8, a level count outside [1, 32], kr < 1, an
// unknown variant or L * T_pad >= 2^32 - 1 (the merge's 32-bit keys, with
// 2^32 - 1 kept for "no deposit"). The exact entry at F <= 2 also refuses an
// odd L * T_pad or a d not aligned to two rows (8 * F bytes). The stochastic
// entry takes the level rate kr as the caller resolved it (kr divides N) and
// an oadd level set only.
int hash_encode_bwd_exact(const void* pos, const void* g, void* d, long long n, long long t_pad, int f,
                          const hash_grid::LevelConstants* lc, void* stream) {
  return dispatch(false, pos, g, d, n, 1, t_pad, f, lc, stream);
}

int hash_encode_bwd_stochastic(const void* pos, const void* g, void* d, long long n, int kr, long long t_pad, int f,
                               const hash_grid::LevelConstants* lc, void* stream) {
  if (kr < 1 || n % kr != 0 || lc->variant != hash_grid::kOadd) return (int)cudaErrorInvalidValue;
  return dispatch(true, pos, g, d, n, kr, t_pad, f, lc, stream);
}

}  // extern "C"
