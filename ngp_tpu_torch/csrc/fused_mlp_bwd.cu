// Fused backward of both NGP MLP heads, for Hopper (sm_90a).
//
// Replaces: ngp_tpu/ops/fused_mlp.py::_bwd_kernel (launched by
// _fused_heads_bwd at fused_mlp.py:227). Per row tile it recomputes the
// forward (csrc/fused_mlp_fwd.cu numerics: bf16 operands, fp32 sums, ReLU
// in fp32, bf16 between layers), keeps every hidden activation in shared
// memory, and backprops g_rgb (N, 3) and g_dens (N, dd):
//   rgb head:  dV_l += r_{l-1}^T g;  g = (g V_l^T) * [r_{l-1} > 0]
//   V0 split:  dV0a += dens^T g;  dV0b += sh^T g;  g = g V0a^T + g_dens
//   density:   dW_l += h_{l-1}^T g;  g = (g W_l^T) * [h_{l-1} > 0];  d_enc = g W0^T
// Every product takes bf16-rounded (RNE) operands and sums in fp32. The ReLU
// masks come from the fp32 activations: a positive activation that rounds to
// bf16 zero is stored as bf16 -0.0 (the same product, a nonzero bit pattern),
// so mask = (bits != 0).
//
// Bound: at the training path's shape (N = 2^18 rows, default widths) the
// kernel reads enc 128 + sh 64 + g_rgb 12 + g_dens 64 B and writes d_enc
// 128 B per row (396 B, ~104 MB: 31 us at 3.35 TB/s) and does ~28k MAC per
// row (forward recompute + both backward products, 14.8 GFLOP: 15 us at
// 989 TFLOP/s), so it is bound by bytes. The design keeps every intermediate
// out of device memory: weights and the block's weight-gradient sums live in
// shared memory; device memory sees the inputs, d_enc and one row of partial
// weight gradients per block.
//
// The Pallas kernel sums weight gradients in VMEM across a sequential grid.
// Here blocks run in parallel: each block walks its row tiles grid-stride,
// every weight-gradient tile is owned by one warp of the block (so the
// block's sum has a fixed order, no atomics), the block writes its partial
// sums to partial[block][w], and a second kernel sums the blocks in order
// (deterministic). Rows past N load as zero and store nothing, so the ragged
// tail adds nothing to the weight gradients.
//
// Layout: a block of W warps owns tiles of 16*W rows (W chosen by the
// wrapper so the tile fits in shared memory). Per tile: phase A, each warp
// recomputes the forward of its 16 rows; phase B, layer by layer from the
// output, (1) the block's warps split the weight-gradient tiles of the layer
// (K = the tile's rows), (2) each warp computes its rows' input gradient.
// Weights and dimensions follow csrc/fused_mlp_fwd.cu (padded to 16).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstdint>

using namespace nvcuda;
using bf16 = __nv_bfloat16;

namespace {

constexpr int kRowsPerWarp = 16;
constexpr int kRgbOut = 3;
constexpr int kRgbPad = 16;

struct Dims {
  int n, d_in, d_sh, wd, wr, dd, nd, nr, warps;
};

__host__ __device__ inline long long weight_elems(const Dims& d) {
  return (long long)d.d_in * d.wd + (long long)(d.nd - 2) * d.wd * d.wd + (long long)d.wd * d.dd +
         (long long)d.dd * d.wr + (long long)d.d_sh * d.wr + (long long)(d.nr - 3) * d.wr * d.wr +
         (long long)d.wr * kRgbPad;
}

__host__ __device__ inline int gmax_of(const Dims& d) {
  int g = kRgbPad;
  g = g > d.wr ? g : d.wr;
  g = g > d.wd ? g : d.wd;
  g = g > d.dd ? g : d.dd;
  return g;
}

// bf16 elements of the tile buffers: x, density hiddens, dens, sh, rgb
// hiddens, two gradient buffers
__host__ __device__ inline long long tile_elems(const Dims& d) {
  const long long t = (long long)kRowsPerWarp * d.warps;
  return t * (d.d_in + (long long)(d.nd - 1) * d.wd + d.dd + d.d_sh + (long long)(d.nr - 2) * d.wr + 2LL * gmax_of(d));
}

__host__ __device__ inline long long smem_bytes(const Dims& d) {
  return 2 * weight_elems(d) + 4 * weight_elems(d) + 2 * tile_elems(d) + 4LL * 256 * d.warps;
}

__device__ __forceinline__ bf16 relu_bf16(float v) {
  if (v > 0.0f) {
    bf16 b = __float2bfloat16(v);
    if (__bfloat16_as_ushort(b) == 0) b = __ushort_as_bfloat16(0x8000);  // -0: value 0, mask 1
    return b;
  }
  return __ushort_as_bfloat16(0);
}

__device__ __forceinline__ bool live(bf16 b) { return __bfloat16_as_ushort(b) != 0; }

// warp: for each 16-wide output tile j of its 16 rows,
// acc = a @ w[:, j] (+ a2 @ w2[:, j]) with w row-major (k, n_out); epi(r, c, v)
template <typename Epi>
__device__ __forceinline__ void warp_fwd(const bf16* a, int lda, int k_dim, const bf16* w, int n_out,
                                         const bf16* a2, int lda2, int k2, const bf16* w2, float* scratch,
                                         int lane, Epi epi) {
  for (int j = 0; j < n_out / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < k_dim / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, a + k * 16, lda);
      wmma::load_matrix_sync(fb, w + (size_t)k * 16 * n_out + j * 16, n_out);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    if (a2 != nullptr) {
      for (int k = 0; k < k2 / 16; ++k) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
        wmma::load_matrix_sync(fa, a2 + k * 16, lda2);
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

// warp: input gradient of a layer for its 16 rows, g (rows, n_out) @ w^T
// with w row-major (k_in, n_out): output tile j covers inputs [16j, 16j+16)
template <typename Epi>
__device__ __forceinline__ void warp_bwd(const bf16* g, int ldg, const bf16* w, int k_in, int n_out,
                                         float* scratch, int lane, Epi epi) {
  for (int j = 0; j < k_in / 16; ++j) {
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
    for (int k = 0; k < n_out / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> fb;  // w^T
      wmma::load_matrix_sync(fa, g + k * 16, ldg);
      wmma::load_matrix_sync(fb, w + (size_t)j * 16 * n_out + k * 16, n_out);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(scratch, acc, 16, wmma::mem_row_major);
    __syncwarp();
    for (int e = lane; e < 256; e += 32) epi(e >> 4, j * 16 + (e & 15), scratch[e]);
    __syncwarp();
  }
}

// block: acc_w (k_in, n_out) fp32 += act^T (k_in x T) @ g (T x n_out) over
// the tile's T = 16 * warps rows; each output tile is owned by one warp
__device__ __forceinline__ void block_wgrad(const bf16* act, int lda, int k_in, const bf16* g, int ldg,
                                            int n_out, float* acc_w, int warp, int warps) {
  const int tn = n_out / 16, tiles = (k_in / 16) * tn;
  for (int t = warp; t < tiles; t += warps) {
    const int ti = t / tn, to = t - ti * tn;
    float* dst = acc_w + (size_t)ti * 16 * n_out + to * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::load_matrix_sync(acc, dst, n_out, wmma::mem_row_major);
    for (int c = 0; c < warps; ++c) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;  // act^T
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
      wmma::load_matrix_sync(fa, act + (size_t)c * 16 * lda + ti * 16, lda);
      wmma::load_matrix_sync(fb, g + (size_t)c * 16 * ldg + to * 16, ldg);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(dst, acc, n_out, wmma::mem_row_major);
  }
}

// fp32 rows [row0, row0 + 16) of a (n, cols) array -> bf16 rows of width
// `ld` in shared memory; rows past n read as zero
__device__ __forceinline__ void load_rows(const float* __restrict__ src, int n, int cols, int row0, bf16* dst,
                                          int ld, int lane) {
  for (int e = lane; e < kRowsPerWarp * cols; e += 32) {
    const int r = e / cols, c = e - r * cols;
    const int row = row0 + r;
    dst[r * ld + c] = __float2bfloat16(row < n ? src[(size_t)row * cols + c] : 0.0f);
  }
}

__global__ void fused_mlp_bwd_kernel(const float* __restrict__ enc, const float* __restrict__ sh,
                                     const float* __restrict__ g_rgb, const float* __restrict__ g_dens,
                                     const bf16* __restrict__ weights, float* __restrict__ d_enc,
                                     float* __restrict__ partial, Dims dm) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int w_elems = (int)weight_elems(dm);
  bf16* w_s = reinterpret_cast<bf16*>(smem);
  float* acc_s = reinterpret_cast<float*>(w_s + w_elems);
  const int warps = dm.warps, T = kRowsPerWarp * warps;
  const int gmax = gmax_of(dm);
  bf16* x_s = reinterpret_cast<bf16*>(acc_s + w_elems);
  bf16* dh_s = x_s + (size_t)T * dm.d_in;               // (nd - 1) x (T, wd)
  bf16* dens_s = dh_s + (size_t)(dm.nd - 1) * T * dm.wd;  // (T, dd)
  bf16* sh_s = dens_s + (size_t)T * dm.dd;                // (T, d_sh)
  bf16* rh_s = sh_s + (size_t)T * dm.d_sh;                // (nr - 2) x (T, wr)
  bf16* ga_s = rh_s + (size_t)(dm.nr - 2) * T * dm.wr;    // (T, gmax)
  bf16* gb_s = ga_s + (size_t)T * gmax;
  float* scratch_all = reinterpret_cast<float*>(gb_s + (size_t)T * gmax);

  {
    const uint4* src = reinterpret_cast<const uint4*>(weights);
    uint4* dst = reinterpret_cast<uint4*>(w_s);
    for (int i = threadIdx.x; i < w_elems / 8; i += blockDim.x) dst[i] = src[i];
    for (int i = threadIdx.x; i < w_elems; i += blockDim.x) acc_s[i] = 0.0f;
  }
  // weight matrices (and their gradient sums) in buffer order
  long long off[64];
  {
    long long p = 0;
    int m = 0;
    off[m++] = p; p += (long long)dm.d_in * dm.wd;
    for (int l = 0; l < dm.nd - 2; ++l) { off[m++] = p; p += (long long)dm.wd * dm.wd; }
    off[m++] = p; p += (long long)dm.wd * dm.dd;
    off[m++] = p; p += (long long)dm.dd * dm.wr;
    off[m++] = p; p += (long long)dm.d_sh * dm.wr;
    for (int l = 0; l < dm.nr - 3; ++l) { off[m++] = p; p += (long long)dm.wr * dm.wr; }
    off[m++] = p;
  }
  const int nd = dm.nd, nr = dm.nr;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* scratch = scratch_all + warp * 256;
  const int rw0 = warp * kRowsPerWarp;  // this warp's first row inside the tile
  __syncthreads();

  const int n_tiles = (dm.n + T - 1) / T;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int row0 = tile * T + rw0;  // global first row of this warp
    const int n = dm.n;

    // ---- phase A: forward recompute of this warp's 16 rows
    load_rows(enc, n, dm.d_in, row0, x_s + rw0 * dm.d_in, dm.d_in, lane);
    load_rows(sh, n, dm.d_sh, row0, sh_s + rw0 * dm.d_sh, dm.d_sh, lane);
    __syncwarp();
    {
      const bf16* in = x_s + rw0 * dm.d_in;
      int ld_in = dm.d_in;
      for (int l = 0; l < nd - 1; ++l) {
        bf16* out = dh_s + ((size_t)l * T + rw0) * dm.wd;
        const int wd = dm.wd;
        warp_fwd(in, ld_in, ld_in, w_s + off[l], wd, nullptr, 0, 0, nullptr, scratch, lane,
                 [&](int r, int c, float v) { out[r * wd + c] = relu_bf16(v); });
        in = out;
        ld_in = wd;
      }
      bf16* dens = dens_s + rw0 * dm.dd;
      const int dd = dm.dd;
      warp_fwd(in, ld_in, ld_in, w_s + off[nd - 1], dd, nullptr, 0, 0, nullptr, scratch, lane,
               [&](int r, int c, float v) { dens[r * dd + c] = __float2bfloat16(v); });
      __syncwarp();
      const int wr = dm.wr;
      bf16* r0 = rh_s + (size_t)rw0 * wr;
      warp_fwd(dens, dd, dd, w_s + off[nd], wr, sh_s + rw0 * dm.d_sh, dm.d_sh, dm.d_sh, w_s + off[nd + 1],
               scratch, lane, [&](int r, int c, float v) { r0[r * wr + c] = relu_bf16(v); });
      for (int l = 0; l < nr - 3; ++l) {
        const bf16* rin = rh_s + ((size_t)l * T + rw0) * wr;
        bf16* rout = rh_s + ((size_t)(l + 1) * T + rw0) * wr;
        warp_fwd(rin, wr, wr, w_s + off[nd + 2 + l], wr, nullptr, 0, 0, nullptr, scratch, lane,
                 [&](int r, int c, float v) { rout[r * wr + c] = relu_bf16(v); });
      }
    }
    // upstream rgb gradient, zero-padded to 16 columns
    for (int e = lane; e < kRowsPerWarp * kRgbPad; e += 32) {
      const int r = e / kRgbPad, c = e - r * kRgbPad, row = row0 + r;
      ga_s[(rw0 + r) * gmax + c] = __float2bfloat16(c < kRgbOut && row < n ? g_rgb[(size_t)row * kRgbOut + c] : 0.0f);
    }

    // ---- phase B: backward, layer by layer from the output
    bf16* g = ga_s;
    bf16* g2 = gb_s;
    const int wr = dm.wr, wd = dm.wd, dd = dm.dd;
    // rgb output layer V_last (wr x 16): input r_{nr-3}
    {
      const bf16* inp = rh_s + (size_t)(nr - 3) * T * wr;
      __syncthreads();
      block_wgrad(inp, wr, wr, g, gmax, kRgbPad, acc_s + off[nd + nr - 1], warp, warps);
      const bf16* inp_w = inp + (size_t)rw0 * wr;
      bf16* out = g2 + (size_t)rw0 * gmax;
      warp_bwd(g + (size_t)rw0 * gmax, gmax, w_s + off[nd + nr - 1], wr, kRgbPad, scratch, lane,
               [&](int r, int c, float v) { out[r * gmax + c] = live(inp_w[r * wr + c]) ? __float2bfloat16(v) : __float2bfloat16(0.0f); });
      bf16* t = g; g = g2; g2 = t;
    }
    // middle rgb layers V_{2+k}, input r_k
    for (int k = nr - 4; k >= 0; --k) {
      const bf16* inp = rh_s + (size_t)k * T * wr;
      __syncthreads();
      block_wgrad(inp, wr, wr, g, gmax, wr, acc_s + off[nd + 2 + k], warp, warps);
      const bf16* inp_w = inp + (size_t)rw0 * wr;
      bf16* out = g2 + (size_t)rw0 * gmax;
      warp_bwd(g + (size_t)rw0 * gmax, gmax, w_s + off[nd + 2 + k], wr, wr, scratch, lane,
               [&](int r, int c, float v) { out[r * gmax + c] = live(inp_w[r * wr + c]) ? __float2bfloat16(v) : __float2bfloat16(0.0f); });
      bf16* t = g; g = g2; g2 = t;
    }
    // split first rgb layer: dV0a, dV0b; g_dens = g V0a^T + upstream (fp32)
    {
      __syncthreads();
      block_wgrad(dens_s, dd, dd, g, gmax, wr, acc_s + off[nd], warp, warps);
      block_wgrad(sh_s, dm.d_sh, dm.d_sh, g, gmax, wr, acc_s + off[nd + 1], warp, warps);
      bf16* out = g2 + (size_t)rw0 * gmax;
      warp_bwd(g + (size_t)rw0 * gmax, gmax, w_s + off[nd], dd, wr, scratch, lane, [&](int r, int c, float v) {
        const int row = row0 + r;
        out[r * gmax + c] = __float2bfloat16(v + (row < n ? g_dens[(size_t)row * dd + c] : 0.0f));
      });
      bf16* t = g; g = g2; g2 = t;
    }
    // density layers l = nd-1 .. 0; input of layer l is x (l = 0) or h_{l-1}
    for (int l = nd - 1; l >= 0; --l) {
      const bf16* inp = l == 0 ? x_s : dh_s + (size_t)(l - 1) * T * wd;
      const int k_in = l == 0 ? dm.d_in : wd;
      const int n_out = l == nd - 1 ? dd : wd;
      __syncthreads();
      block_wgrad(inp, k_in, k_in, g, gmax, n_out, acc_s + off[l], warp, warps);
      if (l > 0) {
        const bf16* inp_w = inp + (size_t)rw0 * wd;
        bf16* out = g2 + (size_t)rw0 * gmax;
        warp_bwd(g + (size_t)rw0 * gmax, gmax, w_s + off[l], wd, n_out, scratch, lane,
                 [&](int r, int c, float v) { out[r * gmax + c] = live(inp_w[r * wd + c]) ? __float2bfloat16(v) : __float2bfloat16(0.0f); });
        bf16* t = g; g = g2; g2 = t;
      } else {
        const int d_in = dm.d_in;
        warp_bwd(g + (size_t)rw0 * gmax, gmax, w_s + off[0], d_in, n_out, scratch, lane, [&](int r, int c, float v) {
          if (row0 + r < n) d_enc[(size_t)(row0 + r) * d_in + c] = v;
        });
      }
    }
    __syncthreads();  // the next tile's phase A overwrites what this one read
  }

  // this block's weight-gradient sums -> its row of partials
  float* dst = partial + (size_t)blockIdx.x * w_elems;
  for (int i = threadIdx.x; i < w_elems; i += blockDim.x) dst[i] = acc_s[i];
}

// grads[w] = sum over blocks b = 0, 1, ... of partial[b][w], in that order
__global__ void reduce_blocks_kernel(const float* __restrict__ partial, int n_blocks, int w_elems,
                                     float* __restrict__ grads) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= w_elems) return;
  float s = 0.0f;
  for (int b = 0; b < n_blocks; ++b) s += partial[(size_t)b * w_elems + w];
  grads[w] = s;
}

}  // namespace

extern "C" {

// Shared memory bytes the kernel needs for these padded dimensions and warps per block.
long long fused_mlp_bwd_smem_bytes(int d_in, int d_sh, int wd, int wr, int dd, int nd, int nr, int warps) {
  const Dims dm{0, d_in, d_sh, wd, wr, dd, nd, nr, warps};
  return smem_bytes(dm);
}

// Blocks the launch uses for n rows (the wrapper sizes the partial buffer
// with it): every SM filled at the kernel's occupancy, at most one per tile.
int fused_mlp_bwd_grid(int n, int d_in, int d_sh, int wd, int wr, int dd, int nd, int nr, int warps, int* grid) {
  const Dims dm{n, d_in, d_sh, wd, wr, dd, nd, nr, warps};
  const int smem = (int)smem_bytes(dm);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  int device = 0, n_sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess) return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_mlp_bwd_kernel, 32 * warps, smem)) !=
      cudaSuccess)
    return (int)err;
  if (per_sm < 1) return (int)cudaErrorInvalidConfiguration;
  const int tile = kRowsPerWarp * warps;
  const int n_tiles = (n + tile - 1) / tile;
  int g = n_sms * per_sm;
  *grid = g < n_tiles ? g : (n_tiles > 0 ? n_tiles : 1);
  return 0;
}

// Launches the backward kernel and the block reduction on `stream`; returns
// cudaGetLastError() (0 = launched). partial holds grid * w_elems floats.
int fused_mlp_bwd(const void* enc, const void* sh, const void* g_rgb, const void* g_dens, const void* weights,
                  void* d_enc, void* partial, void* grads, int n, int d_in, int d_sh, int wd, int wr, int dd, int nd,
                  int nr, int warps, int grid, void* stream) {
  if (n <= 0) return 0;
  if (nd < 2 || nr < 3 || nd + nr > 64 || warps < 1 || warps > 8) return (int)cudaErrorInvalidValue;
  const Dims dm{n, d_in, d_sh, wd, wr, dd, nd, nr, warps};
  const int smem = (int)smem_bytes(dm);
  cudaError_t err = cudaFuncSetAttribute(fused_mlp_bwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  fused_mlp_bwd_kernel<<<grid, 32 * warps, smem, s>>>(
      static_cast<const float*>(enc), static_cast<const float*>(sh), static_cast<const float*>(g_rgb),
      static_cast<const float*>(g_dens), static_cast<const bf16*>(weights), static_cast<float*>(d_enc),
      static_cast<float*>(partial), dm);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  const int w_elems = (int)weight_elems(dm);
  reduce_blocks_kernel<<<(w_elems + 255) / 256, 256, 0, s>>>(static_cast<const float*>(partial), grid, w_elems,
                                                              static_cast<float*>(grads));
  return (int)cudaGetLastError();
}

}  // extern "C"
