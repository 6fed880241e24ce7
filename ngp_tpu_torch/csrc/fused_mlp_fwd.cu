// Fused forward of both NGP MLP heads, for Hopper (sm_90a).
//
// Replaces: ngp_tpu/ops/fused_mlp.py::_fwd_kernel (launched by
// _fused_fwd_impl at fused_mlp.py:194). Per row:
//   dens = W_last(relu(... relu(enc @ W0)))                  (density head)
//   r    = relu(dens @ V0a + sh @ V0b)                        (split V0: no concat)
//   r    = relu(r @ V_i) for each hidden rgb layer
//   rgb  = r @ V_last
// bf16 operands, fp32 accumulation, fp32 activations, hidden activations
// re-cast to bf16 between layers (ngp_tpu/ops/mlp.py numerics).
//
// Bound: at the render path's shape (N = 2^18 rows, default widths) the
// kernel moves 268 B/row (enc 128 + sh 64 in, rgb 12 + dens 64 out) and does
// 9,408 MAC/row; at 3.35 TB/s and 989 TFLOP/s that is ~21 us of traffic
// against ~5 us of tensor-core work, so it is memory-bound. The design keeps
// every intermediate out of device memory: all weights sit in shared memory
// as bf16 (18.8 KB at default widths), loaded once per persistent CTA, and
// each warp keeps its 16 rows' activations in shared memory through the
// whole chain, so device memory sees only the inputs and outputs.
//
// Design (simple first version): a CTA of 8 warps owns 128-row tiles and
// walks over them grid-stride. Each warp computes its own 16 rows layer by
// layer with nvcuda::wmma 16x16x16 bf16 -> fp32 products; an n-tile's
// accumulator goes through a 16x16 fp32 shared scratch where the epilogue
// (ReLU, bf16 re-cast, or the fp32 output store) runs. Nothing is carried
// between CTAs. The ragged last tile is masked on load and store.
//
// Dimensions arrive padded to multiples of 16 (the wrapper zero-pads the
// weights, which is exact). Weights are one bf16 buffer of row-major (in, out)
// matrices in the order
//   W0 (d_in x wd), (nd - 2) x (wd x wd), W_last (wd x dd),
//   V0a (dd x wr), V0b (d_sh x wr), (nr - 3) x (wr x wr), V_last (wr x 16)
// with nd = density layers (>= 2) and nr = rgb layers after the V0 split (>= 3).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int kRowsPerWarp = 16;
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kTileRows = kRowsPerWarp * kWarps;
constexpr int kRgbOut = 3;

struct Dims {
  int n, d_in, d_sh, wd, wr, dd, nd, nr;
};

// One layer for a warp's 16 rows: for each 16-wide output tile j,
// acc = a @ w[:, j] (+ a2 @ w2[:, j]); then epi(row, col, value) per element.
template <typename Epi>
__device__ __forceinline__ void warp_layer(const bf16* a, int k_dim, const bf16* w, int n_out,
                                           const bf16* a2, int k2_dim, const bf16* w2,
                                           float* scratch, int lane, Epi epi) {
  for (int j = 0; j < n_out / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < k_dim / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + k * 16, k_dim);
      wmma::load_matrix_sync(fb, w + (size_t)k * 16 * n_out + j * 16, n_out);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    if (a2 != nullptr) {
      for (int k = 0; k < k2_dim / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a2 + k * 16, k2_dim);
        wmma::load_matrix_sync(fb, w2 + (size_t)k * 16 * n_out + j * 16, n_out);
        wmma::mma_sync(acc, fa, fb, acc);
      }
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) epi(e >> 4, j * 16 + (e & 15), scratch[e]);
    __syncwarp();
  }
}

// fp32 rows [row0, row0 + 16) of a (n, cols) array -> bf16 shared rows;
// rows past n read as zero
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int n, int cols, int row0,
                                          bf16* dst, int lane) {
  for (int e = lane; e < kRowsPerWarp * cols; e += 32) {
    const int r = e / cols, c = e - r * cols;
    const int row = row0 + r;
    dst[e] = __float2bfloat16(row < n ? src[(size_t)row * cols + c] : 0.0f);
  }
}

__global__ void __launch_bounds__(kThreads) fused_mlp_fwd_kernel(
    const float* __restrict__ enc, const float* __restrict__ sh, const bf16* __restrict__ weights,
    int w_elems, float* __restrict__ rgb_out, float* __restrict__ dens_out, Dims dm) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* w_s = reinterpret_cast<bf16*>(smem);

  // weights -> shared, 16 bytes per thread per step (w_elems * 2 is a
  // multiple of 512 bytes: every matrix is 16-multiple by 16-multiple)
  {
    const uint4* src = reinterpret_cast<const uint4*>(weights);
    uint4* dst = reinterpret_cast<uint4*>(w_s);
    const int n16 = w_elems / 8;
    for (int i = threadIdx.x; i < n16; i += kThreads) dst[i] = src[i];
  }

  // weight matrix offsets, in buffer order
  const bf16* w_d0 = w_s;
  const bf16* w_dh = w_d0 + dm.d_in * dm.wd;
  const bf16* w_dl = w_dh + (size_t)(dm.nd - 2) * dm.wd * dm.wd;
  const bf16* v_0a = w_dl + dm.wd * dm.dd;
  const bf16* v_0b = v_0a + dm.dd * dm.wr;
  const bf16* v_h = v_0b + dm.d_sh * dm.wr;
  const bf16* v_l = v_h + (size_t)(dm.nr - 3) * dm.wr * dm.wr;

  // per-warp activation buffers after the weights
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int wmax = dm.d_in > dm.wd ? dm.d_in : dm.wd;
  wmax = wmax > dm.wr ? wmax : dm.wr;
  const int per_warp = 2 * kRowsPerWarp * wmax + kRowsPerWarp * dm.dd + kRowsPerWarp * dm.d_sh;  // bf16s
  bf16* act0 = w_s + w_elems + (size_t)warp * (per_warp + 2 * 256);  // + 256 floats of scratch
  bf16* act1 = act0 + kRowsPerWarp * wmax;
  bf16* dens_b = act1 + kRowsPerWarp * wmax;
  bf16* sh_b = dens_b + kRowsPerWarp * dm.dd;
  float* scratch = reinterpret_cast<float*>(sh_b + kRowsPerWarp * dm.d_sh);

  __syncthreads();

  const int n_tiles = (dm.n + kTileRows - 1) / kTileRows;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * kTileRows + warp * kRowsPerWarp;
    if (row0 >= dm.n) continue;

    load_rows(enc, dm.n, dm.d_in, row0, act0, lane);
    load_rows(sh, dm.n, dm.d_sh, row0, sh_b, lane);
    __syncwarp();

    // density head: hidden ReLU layers ping-pong between act0 and act1
    bf16* in = act0;
    bf16* out = act1;
    int k_dim = dm.d_in;
    const bf16* w = w_d0;
    for (int l = 0; l < dm.nd - 1; ++l) {
      const int wd = dm.wd;
      warp_layer(in, k_dim, w, wd, nullptr, 0, nullptr, scratch, lane,
                 [&](int r, int c, float v) { out[r * wd + c] = __float2bfloat16(fmaxf(v, 0.0f)); });
      bf16* t = in;
      in = out;
      out = t;
      k_dim = dm.wd;
      w = (l == 0) ? w_dh : w + (size_t)dm.wd * dm.wd;
    }
    // density output (no activation): fp32 to device memory, bf16 for V0a
    {
      const int dd = dm.dd, n = dm.n;
      warp_layer(in, k_dim, w_dl, dd, nullptr, 0, nullptr, scratch, lane, [&](int r, int c, float v) {
        dens_b[r * dd + c] = __float2bfloat16(v);
        if (row0 + r < n) dens_out[(size_t)(row0 + r) * dd + c] = v;
      });
    }
    __syncwarp();

    // rgb head: relu(dens @ V0a + sh @ V0b), then the hidden layers
    {
      const int wr = dm.wr;
      warp_layer(dens_b, dm.dd, v_0a, wr, sh_b, dm.d_sh, v_0b, scratch, lane,
                 [&](int r, int c, float v) { out[r * wr + c] = __float2bfloat16(fmaxf(v, 0.0f)); });
      bf16* t = in;
      in = out;
      out = t;
      const bf16* v = v_h;
      for (int l = 0; l < dm.nr - 3; ++l) {
        warp_layer(in, wr, v, wr, nullptr, 0, nullptr, scratch, lane,
                   [&](int r, int c, float x) { out[r * wr + c] = __float2bfloat16(fmaxf(x, 0.0f)); });
        t = in;
        in = out;
        out = t;
        v += (size_t)wr * wr;
      }
      const int n = dm.n;
      warp_layer(in, wr, v_l, 16, nullptr, 0, nullptr, scratch, lane, [&](int r, int c, float x) {
        if (c < kRgbOut && row0 + r < n) rgb_out[(size_t)(row0 + r) * kRgbOut + c] = x;
      });
    }
  }
}

}  // namespace

extern "C" {

// Shared memory bytes the kernel needs for these padded dimensions.
long long fused_mlp_fwd_smem_bytes(int d_in, int d_sh, int wd, int wr, int dd, int nd, int nr) {
  const long long w_elems = (long long)d_in * wd + (long long)(nd - 2) * wd * wd + (long long)wd * dd +
                            (long long)dd * wr + (long long)d_sh * wr + (long long)(nr - 3) * wr * wr +
                            (long long)wr * 16;
  int wmax = d_in > wd ? d_in : wd;
  wmax = wmax > wr ? wmax : wr;
  const long long per_warp = 2LL * kRowsPerWarp * wmax + kRowsPerWarp * dd + kRowsPerWarp * d_sh + 2 * 256;
  return 2 * (w_elems + kWarps * per_warp);
}

// Launches the kernel on `stream`; returns cudaGetLastError() (0 = launched).
int fused_mlp_fwd(const void* enc, const void* sh, const void* weights, void* rgb_out, void* dens_out, int n,
                  int d_in, int d_sh, int wd, int wr, int dd, int nd, int nr, void* stream) {
  if (n <= 0) return 0;
  const Dims dm{n, d_in, d_sh, wd, wr, dd, nd, nr};
  const int w_elems = d_in * wd + (nd - 2) * wd * wd + wd * dd + dd * wr + d_sh * wr + (nr - 3) * wr * wr + wr * 16;
  const int smem = (int)fused_mlp_fwd_smem_bytes(d_in, d_sh, wd, wr, dd, nd, nr);

  cudaError_t err = cudaFuncSetAttribute(fused_mlp_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, n_sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_fwd_kernel, kThreads, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int n_tiles = (n + kTileRows - 1) / kTileRows;
  int grid = n_sms * per_sm;
  if (grid > n_tiles) grid = n_tiles;

  fused_mlp_fwd_kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(enc), static_cast<const float*>(sh), static_cast<const bf16*>(weights), w_elems,
      static_cast<float*>(rgb_out), static_cast<float*>(dens_out), dm);
  return (int)cudaGetLastError();
}

}  // extern "C"
