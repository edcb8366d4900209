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
// The products and sums run in sample order, so they round otherwise than
// the reference's doubling product and tree sums: agreement is to round-off
// (kernels/composite.py's plain version is the oracle).
//
// Backward, from the saved (raw, z, beta, D, term, std) and the cotangents
// that were passed (a null pointer is a term skipped, as JAX skips a
// symbolic zero; g_std at std = 0 gives JAX's inf or NaN):
//   g_term' = g_term - 2 (1 - term) g_unc,  g_std' = g_std / (2 std),
//   g_D' = g_D + g_std' sum w 2 (D - z),
//   g_w_i = g_rgb . c_i + g_D' z_i + g_term' + g_std' (D - z_i)^2,
//   d alpha_k = T_k (g_w_k - A_k),
//   A_k = g_w_{k+1} alpha_{k+1} + (1 - alpha_{k+1} + 1e-10) A_{k+1},
// walked from the last sample down with no division by a factor
// (1 - alpha + 1e-10), which is 1e-10 where alpha saturates at 1; then
// through sigmoid and exp to d sdf and d beta, and d c = g_rgb w.
//
// Bound on the H100: memory, and far below what one launch costs. Forward
// reads raw and z (20 bytes a sample) and writes 28 bytes a ray; backward
// also writes d raw (16 bytes a sample); a few tens of flops a sample.
// Design (first version: right and simple): one thread a ray, its samples
// in a loop; the backward keeps alpha and T of up to MAX_S samples in
// local memory for the reverse walk. d beta sums R*S terms with no float
// atomics: each thread sums its ray in sample order, each block reduces
// its threads by a fixed tree into one partial, and the last block to
// finish (an integer counter) sums the partials in index order, so d beta
// is bitwise the same on a repeat, in one launch. Built with -fmad=false
// and precise expf, as the plain version's separate ops round.

#include <cuda_runtime.h>

#define MAX_S 64        // samples a ray (kernels/composite.py: MAX_S)
#define THREADS 128     // rays a block (kernels/composite.py: _THREADS)

// blocks of composite_bwd_kernel done so far; the last one resets it
__device__ unsigned int g_blocks_done = 0;

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

__device__ __forceinline__ float next_t(float t, float a) {
  return t * ((1.0f - a) + 1e-10f);
}

__global__ void __launch_bounds__(THREADS)
composite_fwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ z, const float* beta_p, int R,
                     int S, float* __restrict__ rgb,
                     float* __restrict__ depth, float* __restrict__ term,
                     float* __restrict__ unc, float* __restrict__ stdv) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const float beta = *beta_p;
  const float* rr = raw + r * S * 4;
  const float* zr = z + r * S;
  float t = 1.0f, c0 = 0.0f, c1 = 0.0f, c2 = 0.0f, d = 0.0f, ws = 0.0f;
  for (int i = 0; i < S; ++i) {
    const float a = alpha_of(rr[4 * i + 3], beta).a;
    const float w = a * t;
    c0 += w * rr[4 * i];
    c1 += w * rr[4 * i + 1];
    c2 += w * rr[4 * i + 2];
    d += w * zr[i];
    ws += w;
    t = next_t(t, a);
  }
  // the spread about D: the weights again, bit for bit
  float v = 0.0f;
  t = 1.0f;
  for (int i = 0; i < S; ++i) {
    const float a = alpha_of(rr[4 * i + 3], beta).a;
    const float e = d - zr[i];
    v += (a * t) * (e * e);
    t = next_t(t, a);
  }
  rgb[3 * r] = c0;
  rgb[3 * r + 1] = c1;
  rgb[3 * r + 2] = c2;
  depth[r] = d;
  term[r] = ws;
  const float u = 1.0f - ws;
  unc[r] = u * u;
  stdv[r] = sqrtf(v);
}

__global__ void __launch_bounds__(THREADS)
composite_probe_kernel(const float* __restrict__ sdf,
                       const float* __restrict__ z, const float* beta_p,
                       int R, int S, float* __restrict__ w_out,
                       float* __restrict__ depth) {
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (r >= R) return;
  const float beta = *beta_p;
  float t = 1.0f, d = 0.0f;
  for (int i = 0; i < S; ++i) {
    const float a = alpha_of(sdf[r * S + i], beta).a;
    const float w = a * t;
    w_out[r * S + i] = w;
    d += w * z[r * S + i];
    t = next_t(t, a);
  }
  depth[r] = d;
}

// Sum of the block's THREADS values in `buf` by a fixed tree; the result
// is in buf[0] for every thread after the call.
__device__ __forceinline__ void block_sum(float* buf) {
  for (int off = THREADS / 2; off > 0; off >>= 1) {
    if ((int)threadIdx.x < off) buf[threadIdx.x] += buf[threadIdx.x + off];
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
composite_bwd_kernel(const float* __restrict__ raw,
                     const float* __restrict__ z, const float* beta_p,
                     const float* __restrict__ depth,
                     const float* __restrict__ term,
                     const float* __restrict__ stdv,
                     const float* __restrict__ g_rgb,
                     const float* __restrict__ g_depth,
                     const float* __restrict__ g_term,
                     const float* __restrict__ g_unc,
                     const float* __restrict__ g_std, int R, int S,
                     float* __restrict__ d_raw, float* partial,
                     float* __restrict__ d_beta) {
  __shared__ float buf[THREADS];
  __shared__ bool last;
  const long long r = (long long)blockIdx.x * THREADS + threadIdx.x;
  const float beta = *beta_p;
  float db = 0.0f;
  if (r < R) {
    const float* rr = raw + r * S * 4;
    const float* zr = z + r * S;
    float* dr = d_raw + r * S * 4;
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
    float alpha[MAX_S], trans[MAX_S];
    float t = 1.0f, q = 0.0f;
    for (int i = 0; i < S; ++i) {
      const float a = alpha_of(rr[4 * i + 3], beta).a;
      alpha[i] = a;
      trans[i] = t;
      if (g_std) q += (a * t) * (2.0f * (D - zr[i]));
      t = next_t(t, a);
    }
    float g_d = g_depth ? g_depth[r] : 0.0f;
    if (g_std) g_d += g_s * q;
    const bool has_d = g_depth || g_std;
    float acc = 0.0f;   // A_k
    for (int k = S - 1; k >= 0; --k) {
      const float a = alpha[k], tk = trans[k], zk = zr[k];
      const float c0 = rr[4 * k], c1 = rr[4 * k + 1], c2 = rr[4 * k + 2];
      const float sdf = rr[4 * k + 3];
      float gw = g_t;
      if (g_rgb) gw += (gr0 * c0 + gr1 * c1) + gr2 * c2;
      if (has_d) gw += g_d * zk;
      if (g_std) {
        const float e = D - zk;
        gw += g_s * (e * e);
      }
      const float da = tk * (gw - acc);
      acc = gw * a + ((1.0f - a) + 1e-10f) * acc;
      // alpha = 1 - exp(q), q = -beta * s, s = sigmoid(u), u = -sdf * beta
      const Alpha al = alpha_of(sdf, beta);
      const float gq = -da * al.e;
      const float gu = (gq * -beta) * (al.s * (1.0f - al.s));
      db += gq * -al.s;
      db += gu * -sdf;
      const float w = a * tk;
      dr[4 * k] = gr0 * w;
      dr[4 * k + 1] = gr1 * w;
      dr[4 * k + 2] = gr2 * w;
      dr[4 * k + 3] = gu * -beta;
    }
  }
  // d beta: this block's partial, then the last block sums the partials
  buf[threadIdx.x] = db;
  __syncthreads();
  block_sum(buf);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = buf[0];
    __threadfence();
    last = atomicAdd(&g_blocks_done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float p = 0.0f;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += THREADS)
    p += ((volatile float*)partial)[b];
  buf[threadIdx.x] = p;
  __syncthreads();
  block_sum(buf);
  if (threadIdx.x == 0) {
    *d_beta = buf[0];
    g_blocks_done = 0;
  }
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

static bool bad_shape(int R, int S) { return R < 1 || S < 1 || S > MAX_S; }

// raw (R, S, 4) [r, g, b, sdf], z (R, S), beta (1,) on the device ->
// rgb (R, 3), depth, term, unc, std (R,). Returns cudaGetLastError().
int composite_fwd(const float* raw, const float* z, const float* beta, int R,
                  int S, float* rgb, float* depth, float* term, float* unc,
                  float* stdv, cudaStream_t stream) {
  if (bad_shape(R, S)) return (int)cudaErrorInvalidValue;
  composite_fwd_kernel<<<(R + THREADS - 1) / THREADS, THREADS, 0, stream>>>(
      raw, z, beta, R, S, rgb, depth, term, unc, stdv);
  return (int)cudaGetLastError();
}

// sdf (R, S), z (R, S), beta (1,) -> w (R, S), sum w z (R,).
int composite_probe(const float* sdf, const float* z, const float* beta,
                    int R, int S, float* w, float* depth,
                    cudaStream_t stream) {
  if (bad_shape(R, S)) return (int)cudaErrorInvalidValue;
  composite_probe_kernel<<<(R + THREADS - 1) / THREADS, THREADS, 0,
                           stream>>>(sdf, z, beta, R, S, w, depth);
  return (int)cudaGetLastError();
}

// The saved forward (raw, z, beta, depth, term, std) and the cotangents of
// rgb (R, 3), depth, term, unc, std (R,), each null when not passed ->
// d_raw (R, S, 4), d_beta (1,). `partial` holds n_partial >= the block
// count, ceil(R / THREADS), floats of scratch.
int composite_bwd(const float* raw, const float* z, const float* beta,
                  const float* depth, const float* term, const float* stdv,
                  const float* g_rgb, const float* g_depth,
                  const float* g_term, const float* g_unc, const float* g_std,
                  int R, int S, float* d_raw, float* partial, int n_partial,
                  float* d_beta, cudaStream_t stream) {
  const int blocks = (R + THREADS - 1) / THREADS;
  if (bad_shape(R, S) || n_partial < blocks)
    return (int)cudaErrorInvalidValue;
  composite_bwd_kernel<<<blocks, THREADS, 0, stream>>>(
      raw, z, beta, depth, term, stdv, g_rgb, g_depth, g_term, g_unc, g_std,
      R, S, d_raw, partial, d_beta);
  return (int)cudaGetLastError();
}

}  // extern "C"
