// Register-resident layer code shared by csrc/fused_mlp_fwd.cu and
// csrc/fused_mlp_bwd.cu (both NGP MLP heads, bf16 operands, fp32 sums).
//
// One warp owns 16 rows. A layer is mma.sync.m16n8k16 (bf16 x bf16 -> fp32)
// on fragments held in registers: the fp32 accumulators of two neighbouring
// n8 tiles have, element for element, the layout of the next layer's A
// fragment for one k16 slice, so ReLU, the bf16 cast (round to nearest even)
// and the repacking happen in registers and no activation goes through
// shared memory between layers.
//
// Weights sit in shared memory as bf16, each (in, out) matrix row-major with
// rows padded by kPad elements (16 bytes): the eight 16-byte rows an
// ldmatrix phase reads then fall in eight different bank groups (no
// conflicts). B fragments come from ldmatrix.trans (x @ W) or ldmatrix
// (g @ W^T) on the same copy.
//
// Register arrays have compile-time sizes: the kernels are templated on the
// largest padded width of the heads (a bucket of 32, 64 or 128), and each
// layer checks its actual widths at run time inside the bucket. Every loop
// over a register array is unrolled, so its indices are constants and
// nothing goes to the stack.
//
// The packed global weight buffer (ops/fused_mlp.py::FusedWeights) holds
// the matrices in the order
//   W0 (d_in x wd), (nd - 2) x (wd x wd), W_last (wd x dd),
//   V0a (dd x wr), V0b (d_sh x wr), (nr - 3) x (wr x wr), V_last (wr x 16)
// with every dimension a multiple of 16.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace fmlp {

using bf16 = __nv_bfloat16;

constexpr int kRows = 16;     // rows a warp owns
constexpr int kRgbOut = 3;    // rgb channels written
constexpr int kRgbPad = 16;   // padded width of V_last
constexpr int kPad = 8;       // bf16 padding of every shared row (16 bytes)
constexpr int kStagePad = 8;  // fp32 padding of every staged input row (32 bytes)

struct Dims {
  int n, d_in, d_sh, wd, wr, dd, nd, nr;
};

// leading dimension (elements) of a shared bf16 matrix or tile with `cols` columns
__host__ __device__ inline int ld(int cols) { return cols + kPad; }
// leading dimension (floats) of a staged fp32 input row of `cols` columns
__host__ __device__ inline int ld_stage(int cols) { return cols + kStagePad; }

// elements of the packed global weight buffer
__host__ __device__ inline long long weight_elems(const Dims& d) {
  return (long long)d.d_in * d.wd + (long long)(d.nd - 2) * d.wd * d.wd + (long long)d.wd * d.dd +
         (long long)d.dd * d.wr + (long long)d.d_sh * d.wr + (long long)(d.nr - 3) * d.wr * d.wr +
         (long long)d.wr * kRgbPad;
}

// elements of the padded shared copy of the weights
__host__ __device__ inline long long smem_weight_elems(const Dims& d) {
  return (long long)d.d_in * ld(d.wd) + (long long)(d.nd - 2) * d.wd * ld(d.wd) + (long long)d.wd * ld(d.dd) +
         (long long)d.dd * ld(d.wr) + (long long)d.d_sh * ld(d.wr) + (long long)(d.nr - 3) * d.wr * ld(d.wr) +
         (long long)d.wr * ld(kRgbPad);
}

// ------------------------------------------------------------ PTX wrappers
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; src_bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)), "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
// wait until at most `Pending` of this thread's committed groups are in flight
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p))
               : "memory");
}

// c (16 x 8 fp32) += a (16 x 16 bf16, row) @ b (16 x 8 bf16, col)
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> two bf16 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// ReLU to bf16 bits, keeping the mask: a positive value that rounds to bf16
// zero becomes -0.0 (value 0, bits != 0), so mask = (bits != 0)
__device__ __forceinline__ uint32_t relu_bits(float v) {
  if (v > 0.0f) {
    const uint32_t b = __bfloat16_as_ushort(__float2bfloat16(v));
    return b == 0 ? 0x8000u : b;
  }
  return 0u;
}

// Fragment coordinates (PTX ISA, mma.m16n8k16): lane = 4 * grp + tig.
// A regs: {rows grp, grp + 8} x {cols 2 tig, 2 tig + 1} of the k slice's
// first 8 columns (regs 0, 1) and last 8 columns (regs 2, 3).
// C regs: row grp cols (2 tig, 2 tig + 1) (regs 0, 1); row grp + 8 (regs 2, 3).

enum class Epi { kNone, kRelu, kReluMask };

// NT accumulator n8 tiles -> NT / 2 A k16 slices (for the first `cols` columns)
template <Epi E, int KT, int NT>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[KT][4], const float (&c)[NT][4], int cols) {
  static_assert(NT == 2 * KT, "two n8 tiles per k16 slice");
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k * 16 < cols) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // n8 tile 2k + h -> regs (2h, 2h + 1)
        const float* v = c[2 * k + h];
        if (E == Epi::kReluMask) {
          a[k][2 * h] = relu_bits(v[0]) | (relu_bits(v[1]) << 16);
          a[k][2 * h + 1] = relu_bits(v[2]) | (relu_bits(v[3]) << 16);
        } else if (E == Epi::kRelu) {
          a[k][2 * h] = pack_bf16(fmaxf(v[0], 0.0f), fmaxf(v[1], 0.0f));
          a[k][2 * h + 1] = pack_bf16(fmaxf(v[2], 0.0f), fmaxf(v[3], 0.0f));
        } else {
          a[k][2 * h] = pack_bf16(v[0], v[1]);
          a[k][2 * h + 1] = pack_bf16(v[2], v[3]);
        }
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&c)[NT][4]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.0f;
}

// c[:, :n_out] += a[:, :k_dim] @ w, w row-major (k_dim, n_out) in shared
// memory with leading dimension ldw (x @ W: B fragments by ldmatrix.trans)
template <int KT, int NT>
__device__ __forceinline__ void layer_fwd(float (&c)[NT][4], const uint32_t (&a)[KT][4], int k_dim, const bf16* w,
                                          int ldw, int n_out, int lane) {
  const int m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    if (j * 16 < n_out) {
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (k * 16 < k_dim) {
          uint32_t b[4];  // (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
          ldmatrix_x4_trans(b, w + (k * 16 + (m & 1) * 8 + r) * ldw + j * 16 + (m >> 1) * 8);
          mma(c[2 * j], a[k], b[0], b[1]);
          mma(c[2 * j + 1], a[k], b[2], b[3]);
        }
      }
    }
  }
}

// c[:, :k_in] += a[:, :n_out] @ w^T, w row-major (k_in, n_out) in shared
// memory with leading dimension ldw (g @ W^T: B fragments by ldmatrix)
template <int KT, int NT>
__device__ __forceinline__ void layer_bwd(float (&c)[NT][4], const uint32_t (&a)[KT][4], int n_out, const bf16* w,
                                          int ldw, int k_in, int lane) {
  const int m = lane >> 3, r = lane & 7;
#pragma unroll
  for (int j = 0; j < NT / 2; ++j) {
    if (j * 16 < k_in) {
#pragma unroll
      for (int k = 0; k < KT; ++k) {
        if (k * 16 < n_out) {
          uint32_t b[4];  // (i 0-7, o 0-7), (i 0-7, o 8-15), (i 8-15, o 0-7), (i 8-15, o 8-15)
          ldmatrix_x4(b, w + (j * 16 + (m >> 1) * 8 + r) * ldw + k * 16 + (m & 1) * 8);
          mma(c[2 * j], a[k], b[0], b[1]);
          mma(c[2 * j + 1], a[k], b[2], b[3]);
        }
      }
    }
  }
}

// A fragments of 16 staged fp32 rows (leading dimension ls floats), first
// `cols` columns, rounded to bf16
template <int KT>
__device__ __forceinline__ void stage_to_a(uint32_t (&a)[KT][4], const float* s, int ls, int cols, int lane) {
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k * 16 < cols) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {  // reg q: row grp + 8 (q & 1), cols + 8 (q >> 1)
        const float2 v = *reinterpret_cast<const float2*>(s + (grp + 8 * (q & 1)) * ls + k * 16 + 8 * (q >> 1) + 2 * tig);
        a[k][q] = pack_bf16(v.x, v.y);
      }
    }
  }
}

// store A fragments (first `cols` columns) as 16 bf16 rows, leading dimension lds
template <int KT>
__device__ __forceinline__ void store_a(bf16* s, int lds, const uint32_t (&a)[KT][4], int cols, int lane) {
  const int grp = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (k * 16 < cols) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        *reinterpret_cast<uint32_t*>(s + (grp + 8 * (q & 1)) * lds + k * 16 + 8 * (q >> 1) + 2 * tig) = a[k][q];
    }
  }
}

// 16 rows of an (n, cols) fp32 array from row0 -> shared (leading dimension
// ls floats) by cp.async, 16 bytes a copy; rows past n are zero-filled
__device__ __forceinline__ void stage_rows(float* dst, int ls, const float* __restrict__ src, int cols, int n, int row0,
                                           int lane) {
  const int per_row = cols >> 2;
  for (int c = lane; c < kRows * per_row; c += 32) {
    const int r = c / per_row, q = c - r * per_row;
    const int row = row0 + r;
    const bool ok = row < n;
    cp_async16(dst + r * ls + 4 * q, ok ? src + (size_t)row * cols + 4 * q : src, ok ? 16 : 0);
  }
}

// Copy the packed global weights into the padded shared copy (whole block).
__device__ __forceinline__ void load_weights(bf16* w_s, const bf16* __restrict__ w, const Dims& d) {
  const int nd = d.nd, nr = d.nr;
  const int n_mat = nd + nr;
  const bf16* src = w;
  bf16* dst = w_s;
  for (int mi = 0; mi < n_mat; ++mi) {
    int k, n;
    if (mi == 0) { k = d.d_in; n = d.wd; }
    else if (mi < nd - 1) { k = d.wd; n = d.wd; }
    else if (mi == nd - 1) { k = d.wd; n = d.dd; }
    else if (mi == nd) { k = d.dd; n = d.wr; }
    else if (mi == nd + 1) { k = d.d_sh; n = d.wr; }
    else if (mi < n_mat - 1) { k = d.wr; n = d.wr; }
    else { k = d.wr; n = kRgbPad; }
    const int per_row = n >> 3;  // 16-byte chunks a row
    for (int c = threadIdx.x; c < k * per_row; c += blockDim.x) {
      const int r = c / per_row, q = c - r * per_row;
      *reinterpret_cast<uint4*>(dst + r * ld(n) + 8 * q) = *reinterpret_cast<const uint4*>(src + r * n + 8 * q);
    }
    src += k * n;
    dst += k * ld(n);
  }
}

}  // namespace fmlp
