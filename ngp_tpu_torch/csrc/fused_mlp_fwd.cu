// Fused forward of both NGP MLP heads, for Hopper (sm_90a).
//
// Replaces: ngp_tpu/ops/fused_mlp.py::_fwd_kernel (launched by
// _fused_fwd_impl at fused_mlp.py:194). Per row:
//   dens = W_last(relu(... relu(enc @ W0)))                  (density head)
//   r    = relu(dens @ V0a + sh @ V0b)                        (split V0: no concat)
//   r    = relu(r @ V_i) for each hidden rgb layer
//   rgb  = r @ V_last
// bf16 operands (round to nearest even), fp32 sums, ReLU in fp32, bf16
// between layers (ngp_tpu/ops/mlp.py numerics).
//
// Bound: at the render path's shape (N = 2^18 rows, base.json widths) the
// kernel moves 268 B a row (enc 128 + sh 64 in, rgb 12 + dens 64 out) and
// does 9,408 MAC a row: ~21 us of traffic at 3.35 TB/s against ~5 us of
// bf16 tensor-core work at 989 TFLOP/s, so bytes bound it, and the design
// keeps every intermediate out of device memory and the loads in flight.
//
// Design (register-resident, csrc/fused_mlp.cuh):
// - activations stay in registers: each warp owns 16 rows, every layer is
//   mma.sync.m16n8k16 on register fragments, and the epilogue (ReLU, bf16
//   cast, repacking into the next A fragment) runs in registers; no
//   activation touches shared memory between layers;
// - the weights are copied once per persistent block into shared memory as
//   bf16 with 16-byte row padding (ldmatrix without bank conflicts);
// - inputs arrive by cp.async, 16 bytes a copy, into a per-warp double
//   buffer: the next 16-row tile loads while this one computes; the ragged
//   last tile is zero-filled by the copy and masked on store;
// - dens is written from the accumulators with 8-byte stores, rgb (N, 3)
//   with the row mask;
// - templated on the bucket (largest padded width: 32, 64 or 128) so the
//   register arrays have compile-time sizes;
// - the launch plan (instantiation, grid, shared memory, the attribute) is
//   computed once per set of dimensions and device by
//   fused_mlp_fwd_plan; a launch is one call of fused_mlp_fwd.

#include "fused_mlp.cuh"

namespace {

using namespace fmlp;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

// floats of one staging buffer of a warp: 16 rows of enc and of sh
__host__ __device__ inline int stage_floats(const Dims& d) { return kRows * (ld_stage(d.d_in) + ld_stage(d.d_sh)); }

__host__ __device__ inline long long smem_bytes(const Dims& d) {
  return 2 * smem_weight_elems(d) + 4LL * kWarps * 2 * stage_floats(d);
}

template <int WMAX>
__global__ void __launch_bounds__(kThreads) fused_mlp_fwd_kernel(const float* __restrict__ enc,
                                                                 const float* __restrict__ sh,
                                                                 const bf16* __restrict__ weights,
                                                                 float* __restrict__ rgb_out,
                                                                 float* __restrict__ dens_out, Dims dm) {
  constexpr int KT = WMAX / 16, NT = WMAX / 8;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int grp = lane >> 2, tig = lane & 3;
  const int sf = stage_floats(dm);
  float* stage = reinterpret_cast<float*>(w_s + smem_weight_elems(dm)) + (size_t)warp * 2 * sf;
  const int ls_in = ld_stage(dm.d_in), ls_sh = ld_stage(dm.d_sh);
  const int n = dm.n, dd = dm.dd, wd = dm.wd, wr = dm.wr;

  load_weights(w_s, weights, dm);

  const int n_tiles = (n + kRows - 1) / kRows;
  const int step = gridDim.x * kWarps;
  int tile = blockIdx.x * kWarps + warp;
  auto stage_tile = [&](int t, int buf) {
    float* s = stage + buf * sf;
    stage_rows(s, ls_in, enc, dm.d_in, n, t * kRows, lane);
    stage_rows(s + kRows * ls_in, ls_sh, sh, dm.d_sh, n, t * kRows, lane);
  };
  if (tile < n_tiles) stage_tile(tile, 0);
  cp_async_commit();
  __syncthreads();  // the weights

  // weight matrices in the shared copy (csrc/fused_mlp.cuh order)
  const bf16* w_dh = w_s + dm.d_in * ld(wd);
  const bf16* w_dl = w_dh + (size_t)(dm.nd - 2) * wd * ld(wd);
  const bf16* v_0a = w_dl + wd * ld(dd);
  const bf16* v_0b = v_0a + dd * ld(wr);
  const bf16* v_h = v_0b + dm.d_sh * ld(wr);
  const bf16* v_l = v_h + (size_t)(dm.nr - 3) * wr * ld(wr);

  uint32_t a[KT][4];
  float c[NT][4];
  for (int buf = 0; tile < n_tiles; tile += step, buf ^= 1) {
    if (tile + step < n_tiles) stage_tile(tile + step, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();  // this tile's copies have landed
    __syncwarp();
    const float* s = stage + buf * sf;
    const int row0 = tile * kRows;

    // density head
    stage_to_a(a, s, ls_in, dm.d_in, lane);
    int k_dim = dm.d_in;
    const bf16* w = w_s;
    for (int l = 0; l < dm.nd - 1; ++l) {
      zero(c);
      layer_fwd(c, a, k_dim, w, ld(wd), wd, lane);
      acc_to_a<Epi::kRelu>(a, c, wd);
      w = (l == 0) ? w_dh : w + (size_t)wd * ld(wd);
      k_dim = wd;
    }
    zero(c);
    layer_fwd(c, a, wd, w_dl, ld(dd), dd, lane);
    // density output: fp32 to device memory from the accumulators
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j * 8 < dd) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = row0 + grp + 8 * h;
          if (row < n)
            *reinterpret_cast<float2*>(dens_out + (size_t)row * dd + j * 8 + 2 * tig) = make_float2(c[j][2 * h], c[j][2 * h + 1]);
        }
      }
    }
    acc_to_a<Epi::kNone>(a, c, dd);

    // rgb head: relu(dens @ V0a + sh @ V0b), the hidden layers, V_last
    zero(c);
    layer_fwd(c, a, dd, v_0a, ld(wr), wr, lane);
    stage_to_a(a, s + kRows * ls_in, ls_sh, dm.d_sh, lane);
    layer_fwd(c, a, dm.d_sh, v_0b, ld(wr), wr, lane);
    acc_to_a<Epi::kRelu>(a, c, wr);
    __syncwarp();  // every lane has read this buffer: the next stage may overwrite it
    const bf16* v = v_h;
    for (int l = 0; l < dm.nr - 3; ++l) {
      zero(c);
      layer_fwd(c, a, wr, v, ld(wr), wr, lane);
      acc_to_a<Epi::kRelu>(a, c, wr);
      v += (size_t)wr * ld(wr);
    }
    zero(c);
    layer_fwd(c, a, wr, v_l, ld(kRgbPad), kRgbPad, lane);
    // rgb: columns 0-2 of the first n8 tile (lanes with tig 0 and 1)
    if (tig < 2) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = row0 + grp + 8 * h;
        if (row < n) {
          rgb_out[(size_t)row * kRgbOut + 2 * tig] = c[0][2 * h];
          if (tig == 0) rgb_out[(size_t)row * kRgbOut + 1] = c[0][2 * h + 1];
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int WMAX>
int plan_for(const Dims& dm, int* grid, int* smem) {
  auto kernel = fused_mlp_fwd_kernel<WMAX>;
  const long long bytes = smem_bytes(dm);
  int device = 0, n_sms = 0, per_sm = 0, max_smem = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) != cudaSuccess)
    return (int)err;
  *smem = (int)bytes;
  if (bytes > max_smem) return -1;
  // the attribute belongs to the instantiation, which plans of other widths
  // share: allow the card's whole opt-in shared memory once
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, (int)bytes)) != cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  *grid = n_sms * per_sm;
  return 0;
}

}  // namespace

extern "C" {

// The launch plan of these padded dimensions on the current device: sets the
// bucket's shared-memory attribute (to the card's opt-in maximum) and returns
// the persistent grid (every SM filled at the kernel's occupancy) and the
// dynamic shared memory; -1 when a block does not fit (*smem: what it needs).
int fused_mlp_fwd_plan(int bucket, int d_in, int d_sh, int wd, int wr, int dd, int nd, int nr, int* grid, int* smem) {
  const Dims dm{0, d_in, d_sh, wd, wr, dd, nd, nr};
  switch (bucket) {
    case 32: return plan_for<32>(dm, grid, smem);
    case 64: return plan_for<64>(dm, grid, smem);
    case 128: return plan_for<128>(dm, grid, smem);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Launches the kernel on `stream` with a plan from fused_mlp_fwd_plan;
// returns cudaGetLastError() (0 = launched).
int fused_mlp_fwd(const void* enc, const void* sh, const void* weights, void* rgb_out, void* dens_out, int n,
                  int d_in, int d_sh, int wd, int wr, int dd, int nd, int nr, int bucket, int grid, int smem,
                  void* stream) {
  if (n <= 0) return 0;
  const Dims dm{n, d_in, d_sh, wd, wr, dd, nd, nr};
  const int n_tiles = (n + kRows * kWarps - 1) / (kRows * kWarps);
  const int g = grid < n_tiles ? grid : n_tiles;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* e = static_cast<const float*>(enc);
  const float* h = static_cast<const float*>(sh);
  const bf16* w = static_cast<const bf16*>(weights);
  float* r = static_cast<float*>(rgb_out);
  float* o = static_cast<float*>(dens_out);
  switch (bucket) {
    case 32: fused_mlp_fwd_kernel<32><<<g, kThreads, smem, s>>>(e, h, w, r, o, dm); break;
    case 64: fused_mlp_fwd_kernel<64><<<g, kThreads, smem, s>>>(e, h, w, r, o, dm); break;
    case 128: fused_mlp_fwd_kernel<128><<<g, kThreads, smem, s>>>(e, h, w, r, o, dm); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
