// Volume compositing of a ray's samples (K3): forward, probe weights and
// backward.
//
// Replaces unislam_tpu/render/renderer.py: `sdf2alpha` (:80-82),
// `_exclusive_cumprod_weights` (:85-104), the five sums of `render_rays`
// (:206-211) and the no-depth probe's weights (:151-160), which XLA fuses
// and the port ran as ~20 elementwise and reduction launches forward and
// ~35 backward. Per ray, over S samples in z order:
//   alpha_i = 1 - exp(-beta * sigmoid(-beta * sdf_i))
//   w_i = alpha_i * T_i,  T_i = prod_{j<i} (1 - alpha_j + 1e-10)
//   rgb = sum w c, D = sum w z, term = sum w, unc = (1 - term)^2,
//   std = sqrt(sum w (D - z)^2)
// T is the reference's own doubling product (p = [1, f_0, ..., f_{S-2}],
// then p_i *= p_{i-k} for k = 1, 2, 4, ... < S), so it is bitwise the JAX
// package's; the sums are trees, so they round otherwise than the plain
// version's: agreement is to round-off (kernels/composite.py's plain
// version is the oracle).
//
// Backward, from the saved (raw, z, beta, D, term, std) and the cotangents
// that were passed (a null pointer is a term skipped, as JAX skips a
// symbolic zero; g_std at std = 0 gives JAX's inf or NaN):
//   g_term' = g_term - 2 (1 - term) g_unc,  g_std' = g_std / (2 std),
//   g_D' = g_D + g_std' sum w 2 (D - z),
//   g_w_i = g_rgb . c_i + g_D' z_i + g_term' + g_std' (D - z_i)^2,
//   d alpha_k = T_k (g_w_k - A_k),
//   A_k = g_w_{k+1} alpha_{k+1} + (1 - alpha_{k+1} + 1e-10) A_{k+1},
// with no division by a factor (1 - alpha + 1e-10), which is 1e-10 where
// alpha saturates at 1; then through sigmoid and exp to d sdf and d beta,
// and d c = g_rgb w. A_k is a suffix scan of the affine maps
// M_j(A) = u_j + f_j A (u_j = g_w_j alpha_j, f_j the factor): the pair
// (U, F) of slot i becomes (U_i + F_i U_{i+k}, F_i F_{i+k}) for k = 1, 2,
// 4, ... while i + k < S, and A_k = U_{k+1} (0 for the last sample). A NaN
// at sample j reaches A_k for k < j only, as in a walk from the last
// sample down.
//
// Bound on the H100: memory, and far below what one launch costs. Forward
// reads raw and z (20 bytes a sample) and writes 28 bytes a ray; backward
// also writes d raw (16 bytes a sample); a few tens of flops a sample.
// Design: one warp a ray, RAYS rays a block. Lane l holds samples l and
// l + 32 (S <= MAX_S = 64): raw is read as one float4 a sample, 512
// contiguous bytes a warp; the prefix product and the suffix scan are
// shuffle scans over the 64 slots (at most six steps each); the sums are
// fixed __shfl_xor_sync trees (a lane adds its two slots, then offsets 16,
// 8, 4, 2, 1), the spread a second tree once D is known. Nothing goes to
// local memory. d beta sums R*S terms with no float atomics: a warp's tree,
// a fixed tree over the block's warps into one partial, and the last block
// to finish (an integer counter in the launch's own scratch, set to 0
// before the launch) sums the partials in index order, so d beta is
// bitwise the same on a repeat, in one launch. Built with -fmad=false and
// precise expf, as the plain version's separate ops round.

#include <cuda_runtime.h>

#define MAX_S 64        // samples a ray (kernels/composite.py: MAX_S)
#define RAYS 8          // rays (warps) a block (kernels/composite.py: _RAYS)
#define THREADS (RAYS * 32)
#define FULL 0xffffffffu

// alpha of one sample and the two intermediates its derivative takes:
// s = sigmoid(-sdf * beta), e = exp(-beta * s), alpha = 1 - e
struct Alpha {
  float s, e, a;
};

__device__ __forceinline__ Alpha alpha_of(float sdf, float beta) {
  Alpha r;
  r.s = 1.0f / (1.0f + expf(sdf * beta));   // sigmoid(-sdf * beta)
  r.e = expf(-beta * r.s);
  r.a = 1.0f - r.e;
  return r;
}

__device__ __forceinline__ float factor(float a) {
  return (1.0f - a) + 1e-10f;
}

// a lane's two slots, an invalid one left out
__device__ __forceinline__ float pair(bool v0, float x0, bool v1, float x1) {
  return (v0 ? x0 : 0.0f) + (v1 ? x1 : 0.0f);
}

// the warp's sum by a fixed xor tree; every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = v + __shfl_xor_sync(FULL, v, off);
  return v;
}

// The exclusive prefix product T of slots l (t0) and l + 32 (t1), from the
// factors f of those slots, by the reference's doubling.
__device__ __forceinline__ void exclusive_prod(float f0, float f1, int S,
                                               int lane, float& t0,
                                               float& t1) {
  const float u0 = __shfl_up_sync(FULL, f0, 1);
  const float u1 = __shfl_up_sync(FULL, f1, 1);
  const float w = __shfl_sync(FULL, f0, 31);
  float p0 = lane == 0 ? 1.0f : u0;     // slot l: f_{l-1}
  float p1 = lane == 0 ? w : u1;        // slot l + 32: f_{l+31}
  for (int k = 1; k < S; k <<= 1) {
    if (k == 32) {                      // slot l + 32 takes slot l
      p1 = p1 * p0;
      continue;
    }
    const float a0 = __shfl_up_sync(FULL, p0, k);
    const float a1 = __shfl_up_sync(FULL, p1, k);
    const float wr = __shfl_sync(FULL, p0, (lane - k) & 31);
    if (lane >= k) {
      p0 = p0 * a0;
      p1 = p1 * a1;
    } else {
      p1 = p1 * wr;                     // slot l + 32 - k, in reg 0
    }
  }
  t0 = p0;
  t1 = p1;
}

// The suffix scan of the maps (u, f) of slots l and l + 32: on return
// (u0, f0), (u1, f1) are the compositions M_i o ... o M_{S-1}.
__device__ __forceinline__ void suffix_scan(float& u0, float& f0, float& u1,
                                            float& f1, int S, int lane) {
  for (int k = 1; k < S; k <<= 1) {
    if (k == 32) {                      // slot l takes slot l + 32
      if (lane + 32 < S) {
        u0 = u0 + f0 * u1;
        f0 = f0 * f1;
      }
      continue;
    }
    const float du0 = __shfl_down_sync(FULL, u0, k);
    const float df0 = __shfl_down_sync(FULL, f0, k);
    const float du1 = __shfl_down_sync(FULL, u1, k);
    const float df1 = __shfl_down_sync(FULL, f1, k);
    const int src = (lane + k) & 31;
    const float wu = __shfl_sync(FULL, u1, src);
    const float wf = __shfl_sync(FULL, f1, src);
    const bool low = lane + k < 32;     // partner of slot l in reg 0
    if (lane + k < S) {
      const float pu = low ? du0 : wu, pf = low ? df0 : wf;
      u0 = u0 + f0 * pu;
      f0 = f0 * pf;
    }
    if (low && lane + 32 + k < S) {
      u1 = u1 + f1 * du1;
      f1 = f1 * df1;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
composite_fwd_kernel(const float4* __restrict__ raw,
                     const float* __restrict__ z, const float* beta_p, int R,
                     int S, float* __restrict__ rgb,
                     float* __restrict__ depth, float* __restrict__ term,
                     float* __restrict__ unc, float* __restrict__ stdv) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * RAYS + (threadIdx.x >> 5);
  if (r >= R) return;   // the whole warp
  const float beta = *beta_p;
  const bool v0 = lane < S, v1 = lane + 32 < S;
  const long long o = r * S + lane;
  float4 c0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), c1 = c0;
  float z0 = 0.0f, z1 = 0.0f;
  if (v0) {
    c0 = raw[o];
    z0 = z[o];
  }
  if (v1) {
    c1 = raw[o + 32];
    z1 = z[o + 32];
  }
  const float a0 = v0 ? alpha_of(c0.w, beta).a : 0.0f;
  const float a1 = v1 ? alpha_of(c1.w, beta).a : 0.0f;
  float t0, t1;
  exclusive_prod(factor(a0), factor(a1), S, lane, t0, t1);
  const float w0 = a0 * t0, w1 = a1 * t1;
  float s[5] = {pair(v0, w0 * c0.x, v1, w1 * c1.x),
                pair(v0, w0 * c0.y, v1, w1 * c1.y),
                pair(v0, w0 * c0.z, v1, w1 * c1.z),
                pair(v0, w0 * z0, v1, w1 * z1), pair(v0, w0, v1, w1)};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int i = 0; i < 5; ++i) s[i] = s[i] + __shfl_xor_sync(FULL, s[i], off);
  const float d = s[3];
  const float e0 = d - z0, e1 = d - z1;
  const float v = warp_sum(pair(v0, w0 * (e0 * e0), v1, w1 * (e1 * e1)));
  if (lane == 0) {
    rgb[3 * r] = s[0];
    rgb[3 * r + 1] = s[1];
    rgb[3 * r + 2] = s[2];
    depth[r] = d;
    term[r] = s[4];
    const float u = 1.0f - s[4];
    unc[r] = u * u;
    stdv[r] = sqrtf(v);
  }
}

__global__ void __launch_bounds__(THREADS)
composite_probe_kernel(const float* __restrict__ sdf,
                       const float* __restrict__ z, const float* beta_p,
                       int R, int S, float* __restrict__ w_out,
                       float* __restrict__ depth) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * RAYS + (threadIdx.x >> 5);
  if (r >= R) return;
  const float beta = *beta_p;
  const bool v0 = lane < S, v1 = lane + 32 < S;
  const long long o = r * S + lane;
  const float a0 = v0 ? alpha_of(sdf[o], beta).a : 0.0f;
  const float a1 = v1 ? alpha_of(sdf[o + 32], beta).a : 0.0f;
  const float z0 = v0 ? z[o] : 0.0f, z1 = v1 ? z[o + 32] : 0.0f;
  float t0, t1;
  exclusive_prod(factor(a0), factor(a1), S, lane, t0, t1);
  const float w0 = a0 * t0, w1 = a1 * t1;
  if (v0) w_out[o] = w0;
  if (v1) w_out[o + 32] = w1;
  const float d = warp_sum(pair(v0, w0 * z0, v1, w1 * z1));
  if (lane == 0) depth[r] = d;
}

// One slot's part of the backward: g_w, then d raw and the d beta terms.
struct Slot {
  float4 c;
  float z;
  Alpha al;
};

__global__ void __launch_bounds__(THREADS)
composite_bwd_kernel(const float4* __restrict__ raw,
                     const float* __restrict__ z, const float* beta_p,
                     const float* __restrict__ depth,
                     const float* __restrict__ term,
                     const float* __restrict__ stdv,
                     const float* __restrict__ g_rgb,
                     const float* __restrict__ g_depth,
                     const float* __restrict__ g_term,
                     const float* __restrict__ g_unc,
                     const float* __restrict__ g_std, int R, int S,
                     float4* __restrict__ d_raw, float* partial,
                     unsigned int* done, float* __restrict__ d_beta) {
  __shared__ float warp_db[RAYS];
  __shared__ float buf[THREADS];
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long r = (long long)blockIdx.x * RAYS + warp;
  const float beta = *beta_p;
  float db = 0.0f;
  if (r < R) {   // uniform across the warp
    const bool v0 = lane < S, v1 = lane + 32 < S;
    const long long o = r * S + lane;
    Slot s0 = {make_float4(0.0f, 0.0f, 0.0f, 0.0f), 0.0f, {0.0f, 1.0f, 0.0f}};
    Slot s1 = s0;
    if (v0) {
      s0.c = raw[o];
      s0.z = z[o];
      s0.al = alpha_of(s0.c.w, beta);
    }
    if (v1) {
      s1.c = raw[o + 32];
      s1.z = z[o + 32];
      s1.al = alpha_of(s1.c.w, beta);
    }
    const float f0 = factor(s0.al.a), f1 = factor(s1.al.a);
    float t0, t1;
    exclusive_prod(f0, f1, S, lane, t0, t1);
    const float w0 = s0.al.a * t0, w1 = s1.al.a * t1;
    const float D = depth[r];
    float gr0 = 0.0f, gr1 = 0.0f, gr2 = 0.0f;
    if (g_rgb) {
      gr0 = g_rgb[3 * r];
      gr1 = g_rgb[3 * r + 1];
      gr2 = g_rgb[3 * r + 2];
    }
    float g_t = g_term ? g_term[r] : 0.0f;
    if (g_unc) g_t -= (2.0f * (1.0f - term[r])) * g_unc[r];
    const float g_s = g_std ? g_std[r] / (2.0f * stdv[r]) : 0.0f;
    float g_d = g_depth ? g_depth[r] : 0.0f;
    if (g_std)
      g_d += g_s * warp_sum(pair(v0, w0 * (2.0f * (D - s0.z)), v1,
                                 w1 * (2.0f * (D - s1.z))));
    const bool has_d = g_depth || g_std;
    float gw[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const Slot& sl = i ? s1 : s0;
      float g = g_t;
      if (g_rgb) g += (gr0 * sl.c.x + gr1 * sl.c.y) + gr2 * sl.c.z;
      if (has_d) g += g_d * sl.z;
      if (g_std) {
        const float e = D - sl.z;
        g += g_s * (e * e);
      }
      gw[i] = g;
    }
    // A of each slot: U of the slot above it, 0 for the last sample
    float u0 = gw[0] * s0.al.a, u1 = gw[1] * s1.al.a, F0 = f0, F1 = f1;
    suffix_scan(u0, F0, u1, F1, S, lane);
    const float n0 = __shfl_down_sync(FULL, u0, 1);
    const float n1 = __shfl_down_sync(FULL, u1, 1);
    const float b1 = __shfl_sync(FULL, u1, 0);
    const float A0 = lane + 1 < S ? (lane < 31 ? n0 : b1) : 0.0f;
    const float A1 = lane + 33 < S ? n1 : 0.0f;
    float dbl[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const Slot& sl = i ? s1 : s0;
      const float da = (i ? t1 : t0) * (gw[i] - (i ? A1 : A0));
      // alpha = 1 - exp(q), q = -beta * s, s = sigmoid(u), u = -sdf * beta
      const float gq = -da * sl.al.e;
      const float gu = (gq * -beta) * (sl.al.s * (1.0f - sl.al.s));
      dbl[i] = gq * -sl.al.s + gu * -sl.c.w;
      const float w = i ? w1 : w0;
      if (i ? v1 : v0)
        d_raw[o + 32 * i] = make_float4(gr0 * w, gr1 * w, gr2 * w, gu * -beta);
    }
    db = warp_sum(pair(v0, dbl[0], v1, dbl[1]));
  }
  // d beta: this block's partial, then the last block sums the partials
  if (lane == 0) warp_db[warp] = db;
  __syncthreads();
  if (threadIdx.x == 0) {
    float p[RAYS];
#pragma unroll
    for (int i = 0; i < RAYS; ++i) p[i] = warp_db[i];
#pragma unroll
    for (int n = RAYS / 2; n > 0; n >>= 1)
#pragma unroll
      for (int i = 0; i < n; ++i) p[i] = p[2 * i] + p[2 * i + 1];
    partial[blockIdx.x] = p[0];
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float p = 0.0f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
    p += ((volatile float*)partial)[b];
  buf[threadIdx.x] = p;
  __syncthreads();
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if ((int)threadIdx.x < off) buf[threadIdx.x] += buf[threadIdx.x + off];
    __syncthreads();
  }
  if (threadIdx.x == 0) *d_beta = buf[0];
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

static bool bad_shape(int R, int S) { return R < 1 || S < 1 || S > MAX_S; }

static bool misaligned(const void* p) { return ((size_t)p & 15) != 0; }

// raw (R, S, 4) [r, g, b, sdf] (16-byte aligned), z (R, S), beta (1,) on
// the device -> rgb (R, 3), depth, term, unc, std (R,). Returns
// cudaGetLastError().
int composite_fwd(const float* raw, const float* z, const float* beta, int R,
                  int S, float* rgb, float* depth, float* term, float* unc,
                  float* stdv, cudaStream_t stream) {
  if (bad_shape(R, S) || misaligned(raw)) return (int)cudaErrorInvalidValue;
  composite_fwd_kernel<<<(R + RAYS - 1) / RAYS, THREADS, 0, stream>>>(
      (const float4*)raw, z, beta, R, S, rgb, depth, term, unc, stdv);
  return (int)cudaGetLastError();
}

// sdf (R, S), z (R, S), beta (1,) -> w (R, S), sum w z (R,).
int composite_probe(const float* sdf, const float* z, const float* beta,
                    int R, int S, float* w, float* depth,
                    cudaStream_t stream) {
  if (bad_shape(R, S)) return (int)cudaErrorInvalidValue;
  composite_probe_kernel<<<(R + RAYS - 1) / RAYS, THREADS, 0, stream>>>(
      sdf, z, beta, R, S, w, depth);
  return (int)cudaGetLastError();
}

// The saved forward (raw, z, beta, depth, term, std) and the cotangents of
// rgb (R, 3), depth, term, unc, std (R,), each null when not passed ->
// d_raw (R, S, 4), d_beta (1,). `partial` holds n_partial + 1 floats of
// scratch, n_partial >= the block count ceil(R / RAYS): the blocks'
// partials, then the launch's completion counter, which is set to 0 here,
// on the stream, before the launch.
int composite_bwd(const float* raw, const float* z, const float* beta,
                  const float* depth, const float* term, const float* stdv,
                  const float* g_rgb, const float* g_depth,
                  const float* g_term, const float* g_unc, const float* g_std,
                  int R, int S, float* d_raw, float* partial, int n_partial,
                  float* d_beta, cudaStream_t stream) {
  const int blocks = (R + RAYS - 1) / RAYS;
  if (bad_shape(R, S) || n_partial < blocks || misaligned(raw)
      || misaligned(d_raw))
    return (int)cudaErrorInvalidValue;
  unsigned int* done = (unsigned int*)(partial + n_partial);
  cudaError_t err = cudaMemsetAsync(done, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return (int)err;
  composite_bwd_kernel<<<blocks, THREADS, 0, stream>>>(
      (const float4*)raw, z, beta, depth, term, stdv, g_rgb, g_depth, g_term,
      g_unc, g_std, R, S, (float4*)d_raw, partial, done, d_beta);
  return (int)cudaGetLastError();
}

}  // extern "C"
