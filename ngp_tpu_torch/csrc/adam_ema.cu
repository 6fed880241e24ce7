// Fused (lazy) Adam + learning-rate step + parameter EMA, for Hopper (sm_90a).
//
// Replaces: tools/mb22_optfuse.py::_kernel (launched by pallas_update at
// mb22_optfuse.py:81), which computes per element what one optimizer step of
// ngp_tpu's training loop computes for a leaf (ngp_tpu/train/optimizer.py:
// add_decayed_weights, scale_by_adam_lazy, scale_by_learning_rate, then
// ema_update):
//   g' = g + l2 * p                               (l2 = 0 for the hash table)
//   visited = !lazy || g' != 0
//   m = visited ? b1 * m + (1 - b1) * g' : m
//   v = visited ? b2 * v + (1 - b2) * g' * g' : v
//   p = p - lr * (visited ? (m / bc1) / (sqrt(v / bc2) + eps) : 0)
//   e = decay * e + (1 - decay) * p
// in that order, with IEEE division and square root (built without
// --use_fast_math: eps = 1e-15 sits at fp32's edge). m, v, p and e are
// updated in place, as the Pallas call aliases them.
//
// Bound: an unvisited element needs 16 B (g and p read, e read and written),
// a visited one 20 B more (m and v read, m, v and p written). With 4 % of the
// base.json hash table's rows visited that is about 17 B an element: 282 MB
// for its 16.8M elements, 0.084 ms at 3.35 TB/s; a few flops per element, so
// it is bound by bytes. One pass, grid-stride over 16-byte groups of four
// elements: m and v are loaded, and m, v and p stored, only for a group that
// holds a visited element. The last n % 4 elements go to block 0's first
// threads. Every buffer must be 16-byte aligned.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

struct Hyper {
  float lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, decay, one_minus_decay, l2;
  int lazy;
};

// every product and sum rounded on its own (__fmul_rn / __fadd_rn keep nvcc
// from contracting them into fused multiply-adds), as the plain version does
__device__ __forceinline__ float with_l2(float g, float p, const Hyper& h) {
  return h.l2 != 0.0f ? __fadd_rn(g, __fmul_rn(h.l2, p)) : g;
}

__device__ __forceinline__ bool is_visited(float g, const Hyper& h) { return !h.lazy || g != 0.0f; }

__device__ __forceinline__ void adam(float g, float& m, float& v, float& p, const Hyper& h) {
  if (!is_visited(g, h)) return;
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.one_minus_b1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.one_minus_b2, g), g));
  p = __fsub_rn(p, __fmul_rn(h.lr, __fdiv_rn(__fdiv_rn(m, h.bc1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, h.bc2)), h.eps))));
}

__device__ __forceinline__ float ema(float e, float p, const Hyper& h) {
  return __fadd_rn(__fmul_rn(h.decay, e), __fmul_rn(h.one_minus_decay, p));
}

__global__ void adam_ema_kernel(const float* __restrict__ g, float* __restrict__ m, float* __restrict__ v,
                                float* __restrict__ p, float* __restrict__ e, long long n, Hyper h) {
  const long long n4 = n / 4;
  const float4* g4 = reinterpret_cast<const float4*>(g);
  float4* m4 = reinterpret_cast<float4*>(m);
  float4* v4 = reinterpret_cast<float4*>(v);
  float4* p4 = reinterpret_cast<float4*>(p);
  float4* e4 = reinterpret_cast<float4*>(e);
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n4; i += (long long)gridDim.x * blockDim.x) {
    float4 gi = g4[i], pi = p4[i], ei = e4[i];
    gi.x = with_l2(gi.x, pi.x, h);
    gi.y = with_l2(gi.y, pi.y, h);
    gi.z = with_l2(gi.z, pi.z, h);
    gi.w = with_l2(gi.w, pi.w, h);
    if (is_visited(gi.x, h) || is_visited(gi.y, h) || is_visited(gi.z, h) || is_visited(gi.w, h)) {
      float4 mi = m4[i], vi = v4[i];
      adam(gi.x, mi.x, vi.x, pi.x, h);
      adam(gi.y, mi.y, vi.y, pi.y, h);
      adam(gi.z, mi.z, vi.z, pi.z, h);
      adam(gi.w, mi.w, vi.w, pi.w, h);
      m4[i] = mi;
      v4[i] = vi;
      p4[i] = pi;
    }
    e4[i] = make_float4(ema(ei.x, pi.x, h), ema(ei.y, pi.y, h), ema(ei.z, pi.z, h), ema(ei.w, pi.w, h));
  }
  const long long j = n4 * 4 + threadIdx.x;
  if (blockIdx.x == 0 && j < n) {
    float pj = p[j];
    const float gj = with_l2(g[j], pj, h);
    if (is_visited(gj, h)) {
      float mj = m[j], vj = v[j];
      adam(gj, mj, vj, pj, h);
      m[j] = mj;
      v[j] = vj;
      p[j] = pj;
    }
    e[j] = ema(e[j], pj, h);
  }
}

}  // namespace

extern "C" {

// One step over n contiguous fp32 elements on `stream`; returns
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue when a buffer
// is not 16-byte aligned. The (1 - b) terms are passed in, rounded from
// double on the host, as the JAX code folds them.
int adam_ema(const void* g, void* m, void* v, void* p, void* e, long long n, float lr, float bc1, float bc2, float b1,
             float one_minus_b1, float b2, float one_minus_b2, float eps, float decay, float one_minus_decay, float l2,
             int lazy, void* stream) {
  if (n <= 0) return 0;
  if (((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(m) | reinterpret_cast<uintptr_t>(v) |
        reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(e)) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  const Hyper h{lr, bc1, bc2, b1, one_minus_b1, b2, one_minus_b2, eps, decay, one_minus_decay, l2, lazy};
  int device = 0, n_sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&n_sms, cudaDevAttrMultiProcessorCount, device);
  long long blocks = (n / 4 + 255) / 256;
  const long long cap = (long long)n_sms * 16;
  if (blocks > cap) blocks = cap;
  if (blocks < 1) blocks = 1;  // block 0 also takes the last n % 4 elements
  adam_ema_kernel<<<(int)blocks, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<float*>(m), static_cast<float*>(v), static_cast<float*>(p),
      static_cast<float*>(e), n, h);
  return (int)cudaGetLastError();
}

}  // extern "C"
