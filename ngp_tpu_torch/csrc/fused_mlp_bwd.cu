// Fused backward of both NGP MLP heads, for Hopper (sm_90a).
//
// Replaces: ngp_tpu/ops/fused_mlp.py::_bwd_kernel (launched by
// _fused_heads_bwd at fused_mlp.py:227). Per row tile it recomputes the
// forward (csrc/fused_mlp_fwd.cu numerics: bf16 operands, fp32 sums, ReLU in
// fp32, bf16 between layers) and backprops g_rgb (N, 3) and g_dens (N, dd):
//   rgb head:  dV_l += r_{l-1}^T g;  g = (g V_l^T) * [r_{l-1} > 0]
//   V0 split:  dV0a += dens^T g;  dV0b += sh^T g;  g = g V0a^T + g_dens
//   density:   dW_l += h_{l-1}^T g;  g = (g W_l^T) * [h_{l-1} > 0];  d_enc = g W0^T
// Every product takes bf16-rounded (RNE) operands and sums in fp32. The ReLU
// masks come from the fp32 pre-activations: a positive value that rounds to
// bf16 zero is kept as bf16 -0.0 (the same product, a nonzero bit pattern),
// so mask = (bits != 0).
//
// Bound: at the training path's shape (N = 2^18 rows, base.json widths) the
// kernel reads enc 128 + sh 64 + g_rgb 12 + g_dens 64 B and writes d_enc
// 128 B a row (396 B, ~104 MB: 31 us at 3.35 TB/s) and does 28,224 MAC a
// row (forward recompute and both backward products: 15 us at 989 TFLOP/s),
// so bytes bound it.
//
// Design (register-resident, csrc/fused_mlp.cuh):
// - forward recompute and input gradients run warp by warp on register
//   fragments (mma.sync.m16n8k16); each warp owns 16 rows of the block's
//   tile of T = 16 x warps rows. Each layer's bf16 activations and
//   gradients are also stored in the block's shared tile (16-byte row
//   padding), which the weight gradients read transposed;
// - g = (g W^T) * mask takes its B fragments by ldmatrix (non-.trans) from
//   the same shared weights as the recompute (ldmatrix.trans);
// - weight gradients dW_l += act_l^T g_l (K = the tile's rows): every m16n8
//   tile of every dW is owned by one warp. In the register buckets (32 and
//   64 wide, at most 2 x kSlots x 4 tiles, base.json: 80) the tiles go by
//   m16n16 pairs (global pair p -> warp p % 4, slot p / 4; the pair shares
//   its A fragments and runs two independent mma chains), and each warp
//   keeps its pairs' fp32 sums in registers for the whole grid-stride loop
//   and writes them once at the end. The 128-wide bucket, and heads with
//   more tiles, keep the sums in shared memory instead (fp32, loaded and
//   stored per tile, any warps a block);
// - the block writes its partial sums to partial[block], and a second
//   launch sums the blocks in a fixed order: two runs give bit-equal
//   weight gradients;
// - enc and sh of the next tile load by cp.async (16 bytes a copy) while
//   this tile's backward runs, g_rgb and g_dens of the next tile while this
//   tile's density layers run; the ragged last tile is zero-filled by the copies
//   (zero rows add nothing to the sums) and masked on store;
// - at base.json widths a block of 4 warps takes ~105 KB of shared memory,
//   so 2 blocks share an SM; weight offsets are running register values
//   (no run-time-indexed local array); the launch plan is computed once per
//   set of dimensions and device by fused_mlp_bwd_plan.

#include "fused_mlp.cuh"

namespace {

using namespace fmlp;

constexpr int kSlots = 12;      // register-resident dW m16n16 tile pairs a warp can own
constexpr int kRegWarps = 4;    // warps a block of the register buckets runs
constexpr int kGRgbFloats = kRows * kRgbOut;  // one warp's g_rgb rows, contiguous

__host__ __device__ inline int gmax_of(const Dims& d) {
  int g = kRgbPad;
  g = g > d.wr ? g : d.wr;
  g = g > d.wd ? g : d.wd;
  g = g > d.dd ? g : d.dd;
  return g;
}

// (K, N) of layer li in packed order
__host__ __device__ inline void layer_shape(const Dims& d, int li, int& k, int& n) {
  const int nd = d.nd, last = d.nd + d.nr - 1;
  if (li == 0) { k = d.d_in; n = d.wd; }
  else if (li < nd - 1) { k = d.wd; n = d.wd; }
  else if (li == nd - 1) { k = d.wd; n = d.dd; }
  else if (li == nd) { k = d.dd; n = d.wr; }
  else if (li == nd + 1) { k = d.d_sh; n = d.wr; }
  else if (li < last) { k = d.wr; n = d.wr; }
  else { k = d.wr; n = kRgbPad; }
}

// m16n8 tiles of all weight gradients
__host__ __device__ inline int total_tiles(const Dims& d) {
  int t = 0;
  for (int li = 0; li < d.nd + d.nr; ++li) {
    int k, n;
    layer_shape(d, li, k, n);
    t += (k / 16) * (n / 8);
  }
  return t;
}

// per-warp staging: 16 rows of enc and sh (region A), then of g_dens and g_rgb (region B)
__host__ __device__ inline int stage_a_floats(const Dims& d) { return kRows * (ld_stage(d.d_in) + ld_stage(d.d_sh)); }
__host__ __device__ inline int stage_floats(const Dims& d) {
  return stage_a_floats(d) + kRows * ld_stage(d.dd) + kGRgbFloats;
}

// bf16 elements of the block's activation and gradient tile
__host__ __device__ inline long long tile_elems(const Dims& d, int warps) {
  const long long t = (long long)kRows * warps;
  return t * (ld(d.d_in) + (long long)(d.nd - 1) * ld(d.wd) + ld(d.dd) + ld(d.d_sh) + (long long)(d.nr - 2) * ld(d.wr) +
              2LL * ld(gmax_of(d)));
}

__host__ __device__ inline long long smem_bytes(const Dims& d, int warps, bool sums_in_smem) {
  return 2 * smem_weight_elems(d) + (sums_in_smem ? 4 * weight_elems(d) : 0) + 4LL * warps * stage_floats(d) +
         2 * tile_elems(d, warps);
}

// c (m16n8 tile (mt, nt) of a dW) += act^T g over the tile's T rows
__device__ __forceinline__ void wgrad_tile(float (&c)[4], const bf16* act, int lda, int mt, const bf16* g, int ldg,
                                           int nt, int T, int lane) {
  const int m = lane >> 3, r = lane & 7;
  for (int r0 = 0; r0 < T; r0 += 16) {
    uint32_t a[4], b[2];
    ldmatrix_x4_trans(a, act + (r0 + (m >> 1) * 8 + r) * lda + mt * 16 + (m & 1) * 8);
    ldmatrix_x2_trans(b, g + (r0 + (m & 1) * 8 + r) * ldg + nt * 8);
    mma(c, a, b[0], b[1]);
  }
}

// c (the two m16n8 tiles of the m16n16 tile (mt, n16) of a dW) += act^T g
// over the T rows of the tile, T known at compile time: every fragment is
// loaded first, then the two independent mma chains run
template <int T>
__device__ __forceinline__ void wgrad_pair(float (&c)[2][4], const bf16* act, int lda, int mt, const bf16* g, int ldg,
                                           int n16, int lane) {
  const int m = lane >> 3, r = lane & 7;
  uint32_t a[T / 16][4], b[T / 16][4];
#pragma unroll
  for (int k = 0; k < T / 16; ++k) {
    ldmatrix_x4_trans(a[k], act + (k * 16 + (m >> 1) * 8 + r) * lda + mt * 16 + (m & 1) * 8);
    // (rows 0-7, cols 0-7), (rows 8-15, cols 0-7), (rows 0-7, cols 8-15), (rows 8-15, cols 8-15)
    ldmatrix_x4_trans(b[k], g + (k * 16 + (m & 1) * 8 + r) * ldg + n16 * 16 + (m >> 1) * 8);
  }
#pragma unroll
  for (int k = 0; k < T / 16; ++k) {
    mma(c[0], a[k], b[k][0], b[k][1]);
    mma(c[1], a[k], b[k][2], b[k][3]);
  }
}

// acc[s] += the tile pair (mt, n16) of act^T g, for a slot s known only at
// run time: a jump to the slot's own copy, so the sums stay in registers and
// only the slots a layer uses run (an unrolled loop over every slot with a
// test in each is if-converted by the compiler, which then issues them all)
template <int T, int SLOTS>
__device__ __forceinline__ void wgrad_slot(float (&acc)[SLOTS][2][4], int s, const bf16* act, int lda, int mt,
                                           const bf16* g, int ldg, int n16, int lane) {
  static_assert(SLOTS == 12, "one case a slot");
#define FMLP_SLOT(k) \
  case k: wgrad_pair<T>(acc[k], act, lda, mt, g, ldg, n16, lane); break;
  switch (s) {
    FMLP_SLOT(0) FMLP_SLOT(1) FMLP_SLOT(2) FMLP_SLOT(3) FMLP_SLOT(4) FMLP_SLOT(5)
    FMLP_SLOT(6) FMLP_SLOT(7) FMLP_SLOT(8) FMLP_SLOT(9) FMLP_SLOT(10) FMLP_SLOT(11)
    default: break;
  }
#undef FMLP_SLOT
}

// 16 staged rows of g_rgb (contiguous, 3 floats a row) -> A fragment slice 0
// of the zero-padded (16, 16) upstream gradient
__device__ __forceinline__ void grgb_to_a(uint32_t (&a)[4], const float* s, int lane) {
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float* row = s + (grp + 8 * h) * kRgbOut;
    const float v0 = 2 * tig < kRgbOut ? row[2 * tig] : 0.0f;
    const float v1 = 2 * tig + 1 < kRgbOut ? row[2 * tig + 1] : 0.0f;
    a[h] = pack_bf16(v0, v1);
  }
  a[2] = a[3] = 0u;
}

template <int WMAX, int SLOTS>
__global__ void __launch_bounds__(32 * kRegWarps) fused_mlp_bwd_kernel(
    const float* __restrict__ enc, const float* __restrict__ sh, const float* __restrict__ g_rgb,
    const float* __restrict__ g_dens, const bf16* __restrict__ weights, float* __restrict__ d_enc,
    float* __restrict__ partial, Dims dm) {
  constexpr int KT = WMAX / 16, NT = WMAX / 8;
  constexpr bool kSmemSums = SLOTS == 0;
  extern __shared__ __align__(128) unsigned char smem[];
  const int warps = blockDim.x >> 5, T = kRows * warps;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int n = dm.n, nd = dm.nd, nr = dm.nr, n_layers = nd + nr;
  const int wd = dm.wd, wr = dm.wr, dd = dm.dd, gmax = gmax_of(dm);
  const long long w_elems = weight_elems(dm);

  // shared layout: weights (bf16, padded), [sums (fp32)], staging (fp32), tile (bf16)
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  float* acc_s = reinterpret_cast<float*>(w_s + smem_weight_elems(dm));
  float* stage = acc_s + (kSmemSums ? w_elems : 0) + (size_t)warp * stage_floats(dm);
  const int ls_in = ld_stage(dm.d_in), ls_sh = ld_stage(dm.d_sh), ls_gd = ld_stage(dd);
  float* st_enc = stage;
  float* st_sh = st_enc + kRows * ls_in;
  float* st_gd = stage + stage_a_floats(dm);
  float* st_grgb = st_gd + kRows * ls_gd;
  bf16* x_s = reinterpret_cast<bf16*>(acc_s + (kSmemSums ? w_elems : 0) + (size_t)warps * stage_floats(dm));
  bf16* dh_s = x_s + (size_t)T * ld(dm.d_in);              // (nd - 1) x (T, wd)
  bf16* dens_s = dh_s + (size_t)(nd - 1) * T * ld(wd);     // (T, dd)
  bf16* sh_s = dens_s + (size_t)T * ld(dd);                // (T, d_sh)
  bf16* rh_s = sh_s + (size_t)T * ld(dm.d_sh);             // (nr - 2) x (T, wr)
  bf16* ga_s = rh_s + (size_t)(nr - 2) * T * ld(wr);       // (T, gmax) x 2
  bf16* gb_s = ga_s + (size_t)T * ld(gmax);
  const int rw0 = warp * kRows;  // this warp's first row inside the tile

  load_weights(w_s, weights, dm);
  if constexpr (kSmemSums)
    for (long long i = threadIdx.x; i < w_elems; i += blockDim.x) acc_s[i] = 0.0f;
  float acc_w[SLOTS > 0 ? SLOTS : 1][2][4];
#pragma unroll
  for (int s = 0; s < (SLOTS > 0 ? SLOTS : 1); ++s)
#pragma unroll
    for (int h = 0; h < 8; ++h) acc_w[s][h >> 2][h & 3] = 0.0f;
  const int n_wtiles = total_tiles(dm);
  const int n_pairs = n_wtiles / 2;  // every N is a multiple of 16
  const long long w_pad = smem_weight_elems(dm);

  auto stage_a = [&](int tile) {
    const int row0 = tile * T + rw0;
    stage_rows(st_enc, ls_in, enc, dm.d_in, n, row0, lane);
    stage_rows(st_sh, ls_sh, sh, dm.d_sh, n, row0, lane);
  };
  auto stage_b = [&](int tile) {
    const int row0 = tile * T + rw0;
    stage_rows(st_gd, ls_gd, g_dens, dd, n, row0, lane);
    // this warp's g_rgb rows are 48 contiguous floats (row0 is a multiple of 16)
    const long long avail = ((long long)n - row0) * kRgbOut;  // floats left in the array
    if (lane < kGRgbFloats / 4) {
      const long long left = avail - 4 * lane;
      const int bytes = left >= 4 ? 16 : (left > 0 ? 4 * (int)left : 0);
      cp_async16(st_grgb + 4 * lane, bytes > 0 ? g_rgb + (size_t)row0 * kRgbOut + 4 * lane : g_rgb, bytes);
    }
  };
  const int n_tiles = (n + T - 1) / T;
  if (blockIdx.x < n_tiles) {
    stage_a(blockIdx.x);
    cp_async_commit();
    stage_b(blockIdx.x);
  } else {
    cp_async_commit();
  }
  cp_async_commit();
  __syncthreads();  // the weights (and zeroed sums)

  uint32_t a[KT][4];
  float c[NT][4];
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * T + rw0;  // global first row of this warp
    const bool has_next = tile + gridDim.x < n_tiles;

    // ---- forward recompute of this warp's 16 rows; activations to the tile
    cp_async_wait<1>();  // region A of this tile
    __syncwarp();
    stage_to_a(a, st_enc, ls_in, dm.d_in, lane);
    store_a(x_s + rw0 * ld(dm.d_in), ld(dm.d_in), a, dm.d_in, lane);
    const bf16* w = w_s;
    int k_dim = dm.d_in;
    for (int l = 0; l < nd - 1; ++l) {
      zero(c);
      layer_fwd(c, a, k_dim, w, ld(wd), wd, lane);
      acc_to_a<Epi::kReluMask>(a, c, wd);
      store_a(dh_s + ((size_t)l * T + rw0) * ld(wd), ld(wd), a, wd, lane);
      w += k_dim * ld(wd);
      k_dim = wd;
    }
    zero(c);
    layer_fwd(c, a, wd, w, ld(dd), dd, lane);
    acc_to_a<Epi::kNone>(a, c, dd);
    store_a(dens_s + rw0 * ld(dd), ld(dd), a, dd, lane);
    const bf16* v0a = w + wd * ld(dd);
    const bf16* v0b = v0a + dd * ld(wr);
    zero(c);
    layer_fwd(c, a, dd, v0a, ld(wr), wr, lane);
    stage_to_a(a, st_sh, ls_sh, dm.d_sh, lane);
    store_a(sh_s + rw0 * ld(dm.d_sh), ld(dm.d_sh), a, dm.d_sh, lane);
    layer_fwd(c, a, dm.d_sh, v0b, ld(wr), wr, lane);
    acc_to_a<Epi::kReluMask>(a, c, wr);
    store_a(rh_s + rw0 * ld(wr), ld(wr), a, wr, lane);
    __syncwarp();  // region A is read: load the next tile's enc and sh
    if (has_next) stage_a(tile + gridDim.x);
    cp_async_commit();
    const bf16* v = v0b + dm.d_sh * ld(wr);
    for (int l = 0; l < nr - 3; ++l) {
      zero(c);
      layer_fwd(c, a, wr, v, ld(wr), wr, lane);
      acc_to_a<Epi::kReluMask>(a, c, wr);
      store_a(rh_s + ((size_t)(l + 1) * T + rw0) * ld(wr), ld(wr), a, wr, lane);
      v += wr * ld(wr);
    }

    // ---- backward, layer by layer from the output
    cp_async_wait<1>();  // region B of this tile
    __syncwarp();
    grgb_to_a(a[0], st_grgb, lane);
    bf16* g_cur = ga_s;
    bf16* g_nxt = gb_s;
    store_a(g_cur + rw0 * ld(gmax), ld(gmax), a, kRgbPad, lane);
    int pb = n_pairs;        // first dW m16n16 tile pair of layer li (counted down)
    long long po = w_elems;  // packed offset of layer li
    long long wo = w_pad;    // padded shared offset of layer li
    for (int li = n_layers - 1; li >= 0; --li) {
      int K, N;
      layer_shape(dm, li, K, N);
      const int tn = N / 8, cnt = (K / 16) * tn;
      pb -= cnt / 2;
      po -= (long long)K * N;
      wo -= (long long)K * ld(N);
      // the layer's input activation in the tile
      const bf16* act;
      if (li == 0) act = x_s;
      else if (li < nd) act = dh_s + (size_t)(li - 1) * T * ld(wd);
      else if (li == nd) act = dens_s;
      else if (li == nd + 1) act = sh_s;
      else act = rh_s + (size_t)(li - nd - 2) * T * ld(wr);
      const int lda = ld(K), ldg = ld(gmax);
      __syncthreads();  // every warp's g of this layer is in g_cur

      // weight gradient: this warp's tiles of dW_li += act^T g
      if constexpr (kSmemSums) {
        for (int local = warp; local < cnt; local += warps) {
          const int mt = local / tn, nt = local - mt * tn;
          float* dst = acc_s + po + (size_t)(mt * 16 + grp) * N + nt * 8 + 2 * tig;
          float cw[4];
          const float2 lo = *reinterpret_cast<const float2*>(dst);
          const float2 hi = *reinterpret_cast<const float2*>(dst + 8 * N);
          cw[0] = lo.x; cw[1] = lo.y; cw[2] = hi.x; cw[3] = hi.y;
          wgrad_tile(cw, act, lda, mt, g_cur, ldg, nt, T, lane);
          *reinterpret_cast<float2*>(dst) = make_float2(cw[0], cw[1]);
          *reinterpret_cast<float2*>(dst + 8 * N) = make_float2(cw[2], cw[3]);
        }
      } else if constexpr (SLOTS > 0) {
        // the warp's global pairs p = warp + s * warps in [pb, pb + cnt / 2):
        // slots s_lo, s_lo + 1, ... hold layer pairs local = p - pb
        const int pn = tn / 2, pcnt = cnt / 2;
        const int s_lo = pb > warp ? (pb - warp + kRegWarps - 1) / kRegWarps : 0;
        int local = warp + s_lo * kRegWarps - pb;
        int mt = local / pn, n16 = local - mt * pn;
        for (int s = s_lo; local < pcnt; ++s, local += kRegWarps) {
          wgrad_slot<kRows * kRegWarps>(acc_w, s, act, lda, mt, g_cur, ldg, n16, lane);
          for (n16 += kRegWarps; n16 >= pn; n16 -= pn) ++mt;
        }
      }

      // input gradient of this warp's rows
      if (li == nd + 1) continue;  // V0b: sh takes no gradient; V0a uses the same g
      zero(c);
      layer_bwd(c, a, N, w_s + wo, ld(N), K, lane);
      if (li == 0) {  // d_enc, fp32 from the accumulators
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j * 8 < K) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int row = row0 + grp + 8 * h;
              if (row < n)
                *reinterpret_cast<float2*>(d_enc + (size_t)row * K + j * 8 + 2 * tig) = make_float2(c[j][2 * h], c[j][2 * h + 1]);
            }
          }
        }
        continue;
      }
      if (li == nd) {  // into the density output: + g_dens, no ReLU
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j * 8 < K) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const float2 gd = *reinterpret_cast<const float2*>(st_gd + (grp + 8 * h) * ls_gd + j * 8 + 2 * tig);
              c[j][2 * h] += gd.x;
              c[j][2 * h + 1] += gd.y;
            }
          }
        }
        __syncwarp();  // region B is read: load the next tile's g_dens and g_rgb
        if (has_next) stage_b(tile + gridDim.x);
        cp_async_commit();
      } else {  // into a ReLU layer: mask from the stored activation bits
        const bf16* am = act + rw0 * lda;
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          if (j * 8 < K) {
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const uint32_t bits = *reinterpret_cast<const uint32_t*>(am + (grp + 8 * h) * lda + j * 8 + 2 * tig);
              if ((bits & 0xFFFFu) == 0u) c[j][2 * h] = 0.0f;
              if ((bits >> 16) == 0u) c[j][2 * h + 1] = 0.0f;
            }
          }
        }
      }
      acc_to_a<Epi::kNone>(a, c, K);
      store_a(g_nxt + rw0 * ldg, ldg, a, K, lane);
      bf16* t = g_cur;
      g_cur = g_nxt;
      g_nxt = t;
    }
    __syncthreads();  // the next tile's recompute overwrites what this one read
  }
  cp_async_wait<0>();

  // this block's weight-gradient sums -> its row of partials
  float* dst = partial + (size_t)blockIdx.x * w_elems;
  if constexpr (kSmemSums) {
    __syncthreads();
    for (long long i = threadIdx.x; i < w_elems; i += blockDim.x) dst[i] = acc_s[i];
  } else {
#pragma unroll
    for (int s = 0; s < (SLOTS > 0 ? SLOTS : 1); ++s) {
      const int t = warp + s * warps;  // pair index
      if (t < n_pairs) {
        int pb0 = 0;
        long long p = 0;
        for (int li = 0; li < n_layers; ++li) {
          int K, N;
          layer_shape(dm, li, K, N);
          const int pn = N / 16, pcnt = (K / 16) * pn;
          if (t < pb0 + pcnt) {
            const int local = t - pb0, mt = local / pn, n16 = local - mt * pn;
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              float* q = dst + p + (size_t)(mt * 16 + grp) * N + n16 * 16 + 8 * h + 2 * tig;
              *reinterpret_cast<float2*>(q) = make_float2(acc_w[s][h][0], acc_w[s][h][1]);
              *reinterpret_cast<float2*>(q + 8 * N) = make_float2(acc_w[s][h][2], acc_w[s][h][3]);
            }
            break;
          }
          pb0 += pcnt;
          p += (long long)K * N;
        }
      }
    }
  }
}

// grads[w] = sum over blocks b = 0, 1, ... of partial[b][w], in that order
__global__ void reduce_blocks_kernel(const float* __restrict__ partial, int n_blocks, int w_elems,
                                     float* __restrict__ grads) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= w_elems) return;
  float s = 0.0f;
#pragma unroll 8
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * w_elems + w];  // loads run ahead, sums in order
  grads[w] = s;
}

using KernelFn = void (*)(const float*, const float*, const float*, const float*, const bf16*, float*, float*, Dims);

// the instantiation of a bucket; regs = dW sums in registers
KernelFn kernel_of(int bucket, bool regs) {
  if (regs) {
    if (bucket == 32) return fused_mlp_bwd_kernel<32, kSlots>;
    if (bucket == 64) return fused_mlp_bwd_kernel<64, kSlots>;
    return nullptr;  // the 128-wide bucket keeps its sums in shared memory
  }
  if (bucket == 32) return fused_mlp_bwd_kernel<32, 0>;
  if (bucket == 64) return fused_mlp_bwd_kernel<64, 0>;
  if (bucket == 128) return fused_mlp_bwd_kernel<128, 0>;
  return nullptr;
}

}  // namespace

extern "C" {

// The launch plan of these padded dimensions on the current device. regs:
// the register instantiation (4 warps a block, at most 2 x kSlots x 4 dW
// tiles); else the shared-memory one with the most warps (4, 2, 1) whose
// tile fits. Sets the attribute and returns warps, the persistent grid and
// the shared memory; -1 when no block fits (*smem: the least it needs).
int fused_mlp_bwd_plan(int bucket, int regs, int d_in, int d_sh, int wd, int wr, int dd, int nd, int nr, int* warps,
                       int* grid, int* smem) {
  const Dims dm{0, d_in, d_sh, wd, wr, dd, nd, nr};
  KernelFn kernel = kernel_of(bucket, regs != 0);
  if (kernel == nullptr || nd < 2 || nr < 3) return (int)cudaErrorInvalidValue;
  if (regs && total_tiles(dm) > 2 * kSlots * kRegWarps) return (int)cudaErrorInvalidValue;
  int max_smem = 0, device = 0, n_sms = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != cudaSuccess)
    return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  int w = regs ? kRegWarps : 0;
  if (!regs) {
    for (int cand = kRegWarps; cand >= 1 && w == 0; cand /= 2)
      if (smem_bytes(dm, cand, true) <= max_smem) w = cand;
  }
  if (w == 0 || smem_bytes(dm, w, !regs) > max_smem) {
    *smem = (int)smem_bytes(dm, regs ? kRegWarps : 1, !regs);
    return -1;
  }
  const int bytes = (int)smem_bytes(dm, w, !regs);
  // the attribute belongs to the instantiation, which plans of other widths
  // share: allow the card's whole opt-in shared memory once
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem)) != cudaSuccess)
    return (int)err;
  int per_sm = 0;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 32 * w, bytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *warps = w;
  *grid = n_sms * per_sm;
  *smem = bytes;
  return 0;
}

// Launches the backward kernel and the block reduction on `stream` with a
// plan from fused_mlp_bwd_plan; grid <= the plan's grid and <= the number of
// row tiles. partial holds grid * w_elems floats. Returns cudaGetLastError().
int fused_mlp_bwd(const void* enc, const void* sh, const void* g_rgb, const void* g_dens, const void* weights,
                  void* d_enc, void* partial, void* grads, int n, int d_in, int d_sh, int wd, int wr, int dd, int nd,
                  int nr, int bucket, int regs, int warps, int grid, int smem, void* stream) {
  if (n <= 0) return 0;
  KernelFn kernel = kernel_of(bucket, regs != 0);
  if (kernel == nullptr || warps < 1 || warps > kRegWarps) return (int)cudaErrorInvalidValue;
  const Dims dm{n, d_in, d_sh, wd, wr, dd, nd, nr};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  kernel<<<grid, 32 * warps, smem, s>>>(static_cast<const float*>(enc), static_cast<const float*>(sh),
                                        static_cast<const float*>(g_rgb), static_cast<const float*>(g_dens),
                                        static_cast<const bf16*>(weights), static_cast<float*>(d_enc),
                                        static_cast<float*>(partial), dm);
  cudaError_t err;
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int w_elems = (int)weight_elems(dm);
  reduce_blocks_kernel<<<(w_elems + 127) / 128, 128, 0, s>>>(static_cast<const float*>(partial), grid, w_elems,
                                                              static_cast<float*>(grads));
  return (int)cudaGetLastError();
}

}  // extern "C"
