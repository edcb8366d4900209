// Adam step with the moments stored in bf16 by stochastic rounding (K7).
//
// Replaces unislam_tpu/core/optim.py: `_sr_round` (:43-69),
// `scale_by_adam_lp` (:72-125) and `adam_lp` (:128-135), together with
// what the JAX mapper applies after them: optax.scale(-lr), the phase's
// `* lr_scale` (unislam_tpu/engine/mapper.py:249-263) and `p + u`.
//
// One launch steps one leaf in place. Each element reads g and p (f32) and
// m and v (bf16) and writes p, m and v.
// All arithmetic is f32, in the reference's order:
//   mf = m*b1 + g*(1-b1);  vf = v*b2 + (g*g)*(1-b2)
//   upd = (mf/bc1) / (sqrt(vf/bc2) + eps);  p = p + (upd*(-lr))*lr_scale
// The moments are stored by stochastic rounding: the low 16 bits of a
// murmur3-style finaliser of (flat index * 0x9E3779B1) ^ salt are added to
// the f32 bits, which are then truncated; an inf or NaN keeps its bits (so
// a NaN with payload only in its low 16 bits becomes +-inf, as in the
// reference). The salts and the f32 constants come from the host
// (unislam_tpu_torch/core/optim.py: step_scalars). The flat index is the
// element's index in the whole leaf: a launch on a row block of a table
// (`parallel.shard_tables`) passes the block's first element as `offset`,
// so each element draws the bits it draws in a step of the whole table.
//
// Bound on the H100: memory. 20 bytes an element (g, p in; p out; m, v in
// and out at 2 bytes); a few dozen integer and float operations. The
// design is a grid-stride loop over groups of 4 elements: 16-byte loads
// and stores of g and p, 8-byte ones of m and v, the hash in registers.
//
// Built with -fmad=false: `m*b1 + g*(1-b1)` must round twice, as the
// reference (op by op) and the plain PyTorch version do. Division and
// square root are IEEE (nvcc's default -prec-div / -prec-sqrt).

#include <cuda_runtime.h>
#include <stdint.h>

struct AdamScalars {
  float b1, c1, b2, c2, bc1, bc2, eps, neg_lr, lr_scale;
  uint32_t salt_m, salt_v;
};

__device__ __forceinline__ uint16_t sr_bf16(float x, uint32_t idx,
                                            uint32_t salt) {
  uint32_t bits = __float_as_uint(x);
  uint32_t h = (idx * 0x9E3779B1u) ^ salt;
  h = (h ^ (h >> 16)) * 0x85EBCA6Bu;
  h = (h ^ (h >> 13)) * 0xC2B2AE35u;
  h = h ^ (h >> 16);
  uint32_t up = ((bits & 0x7F800000u) != 0x7F800000u) ? bits + (h & 0xFFFFu)
                                                       : bits;
  return (uint16_t)(up >> 16);
}

__device__ __forceinline__ float from_bf16(uint32_t b) {
  return __uint_as_float(b << 16);
}

// one element: p, mf, vf updated in place
__device__ __forceinline__ void adam_elem(float& p, float g, float& mf,
                                          float& vf, const AdamScalars& s) {
  mf = mf * s.b1 + g * s.c1;
  vf = vf * s.b2 + (g * g) * s.c2;
  float upd = (mf / s.bc1) / (sqrtf(vf / s.bc2) + s.eps);
  float u = upd * s.neg_lr;
  u = u * s.lr_scale;
  p = p + u;
}

// 4 elements per iteration
__global__ void adam_lp_kernel(float* __restrict__ p,
                               const float* __restrict__ g,
                               uint16_t* __restrict__ m,
                               uint16_t* __restrict__ v, long long n,
                               uint32_t offset, AdamScalars s) {
  const long long n4 = n >> 2;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  for (long long q = t0; q < n4; q += stride) {
    float4 pv = reinterpret_cast<float4*>(p)[q];
    const float4 gv = reinterpret_cast<const float4*>(g)[q];
    const uint2 mv = reinterpret_cast<uint2*>(m)[q];
    const uint2 vv = reinterpret_cast<uint2*>(v)[q];
    float pp[4] = {pv.x, pv.y, pv.z, pv.w};
    const float gg[4] = {gv.x, gv.y, gv.z, gv.w};
    float mm[4] = {from_bf16(mv.x & 0xFFFFu), from_bf16(mv.x >> 16),
                   from_bf16(mv.y & 0xFFFFu), from_bf16(mv.y >> 16)};
    float ww[4] = {from_bf16(vv.x & 0xFFFFu), from_bf16(vv.x >> 16),
                   from_bf16(vv.y & 0xFFFFu), from_bf16(vv.y >> 16)};
    uint32_t mo[4], vo[4];
    const uint32_t base = offset + (uint32_t)(q << 2);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      adam_elem(pp[i], gg[i], mm[i], ww[i], s);
      mo[i] = sr_bf16(mm[i], base + i, s.salt_m);
      vo[i] = sr_bf16(ww[i], base + i, s.salt_v);
    }
    reinterpret_cast<float4*>(p)[q] = make_float4(pp[0], pp[1], pp[2], pp[3]);
    reinterpret_cast<uint2*>(m)[q] =
        make_uint2(mo[0] | (mo[1] << 16), mo[2] | (mo[3] << 16));
    reinterpret_cast<uint2*>(v)[q] =
        make_uint2(vo[0] | (vo[1] << 16), vo[2] | (vo[3] << 16));
  }
  // the last n % 4 elements, one a thread
  const long long i = (n4 << 2) + t0;
  if (i < n) {
    float pi = p[i], mi = from_bf16(m[i]), vi = from_bf16(v[i]);
    adam_elem(pi, g[i], mi, vi, s);
    p[i] = pi;
    m[i] = sr_bf16(mi, offset + (uint32_t)i, s.salt_m);
    v[i] = sr_bf16(vi, offset + (uint32_t)i, s.salt_v);
  }
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// p, g: f32 (n,); m, v: bf16 bits (uint16) (n,); all 4-element aligned.
// `offset`: the flat index of element 0 in the whole leaf (offset + n <=
// 2^32). Returns cudaGetLastError() after the launch.
int adam_lp_step(float* p, const float* g, uint16_t* m, uint16_t* v,
                 long long n, long long offset, const AdamScalars* s,
                 cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int threads = 256;
  long long groups = (n >> 2) > 0 ? (n >> 2) : 1;
  long long want = (groups + threads - 1) / threads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  adam_lp_kernel<<<blocks, threads, 0, stream>>>(p, g, m, v, n,
                                                  (uint32_t)offset, *s);
  return (int)cudaGetLastError();
}

}  // extern "C"
