// Multiresolution hash-grid encode, forward (K1) and backward (K2).
//
// Replaces unislam_tpu/models/hash_encoding.py: `_encode_fwd` (with
// `_corner_indices` and `_interp_weights`) and `_encode_bwd`.
//
// K1, forward: one thread per (point, level). It clamps the point to
// [0,1], finds the 8 cell corners, hashes or densely indexes them, gathers
// one float2 row per corner (F = 2) and interpolates trilinearly. Output
// is (N, L*2) f32, level-major, written by consecutive threads at
// consecutive addresses.
//
// K2, backward: one thread per point, looping over the levels. It
// recomputes corners and weights from the points instead of keeping the
// (L, N, 8, F) gathered rows from the forward pass, and writes
//   - the point gradient (the factorised trilinear derivatives times the
//     level scale, summed over levels in order, zero where the unclamped
//     point lies outside [0,1]) when `g_points` is not null;
//   - the table-gradient rows `w * g` and their destination rows, in the
//     reference's (L, N, 8) order, when `row_idx` is not null. They are
//     reduced by the sorted scatter-accumulate kernel (scatter_accum.cu),
//     which is deterministic, instead of atomics into the table.
//
// Bound on the H100: memory. Per point and level K1 reads 8 rows of 8
// bytes from the table and writes 8 bytes; K2 with rows writes 96 bytes
// (8 indices, 8 float2 rows) per point and level, which is most of its
// traffic. Arithmetic is a few dozen flops per row. The design keeps every
// access to the outputs coalesced (vector stores of 16 bytes) and leaves
// the random table gathers to L2 (the SDF table, 7 MB, fits in its 50 MB).
//
// Built with -fmad=false: `p * scale + 0.5` must round twice like the plain
// PyTorch and JAX versions, or a point on a cell face floors to another
// corner; the weight products and sums then also round like theirs.

#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 32

struct HashLevels {
  int n_levels;
  uint32_t hash_mask;          // 2^log2_hashmap_size - 1
  float scale[MAX_LEVELS];     // grid scale per level
  int res[MAX_LEVELS];         // cells per axis
  int offset[MAX_LEVELS];      // first table row of the level
  int size[MAX_LEVELS];        // table rows of the level
  int hashed[MAX_LEVELS];      // 1: spatial hash, 0: dense
};

__device__ __forceinline__ int corner_row(const HashLevels& lv, int l, int x,
                                          int y, int z) {
  int idx;
  if (lv.hashed[l]) {
    const uint32_t h = ((uint32_t)x * 1u) ^ ((uint32_t)y * 2654435761u) ^
                       ((uint32_t)z * 805459861u);
    idx = (int)(h & lv.hash_mask);
  } else {
    const int r = lv.res[l];
    idx = x + y * r + z * r * r;
  }
  return min(idx, lv.size[l] - 1) + lv.offset[l];
}

// Corner rows (corner k = 4*bx + 2*by + bz, x slowest) and per-axis
// weights wl[a] = {1 - frac_a, frac_a} of point p at level l.
__device__ __forceinline__ void level_corners(const HashLevels& lv, int l,
                                              const float p[3], int rows[8],
                                              float wl[3][2]) {
  const float s = lv.scale[l];
  const int r = lv.res[l];
  int c[3][2];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = fminf(fmaxf(p[a], 0.0f), 1.0f);
    const float pos = __fadd_rn(__fmul_rn(x, s), 0.5f);
    const float fl = floorf(pos);
    const float fr = __fsub_rn(pos, fl);
    const int g = (int)fl;
    c[a][0] = min(max(g, 0), r - 1);
    c[a][1] = min(max(g + 1, 0), r - 1);
    wl[a][0] = 1.0f - fr;
    wl[a][1] = fr;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    rows[k] = corner_row(lv, l, c[0][k >> 2], c[1][(k >> 1) & 1],
                         c[2][k & 1]);
}

__device__ __forceinline__ float corner_weight(const float wl[3][2], int k) {
  return (wl[0][k >> 2] * wl[1][(k >> 1) & 1]) * wl[2][k & 1];
}

__global__ void __launch_bounds__(256)
hash_fwd_kernel(const float* __restrict__ points,
                const float2* __restrict__ table, float2* __restrict__ out,
                int n_points, const HashLevels lv) {
  const int L = lv.n_levels;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_points * L) return;
  const int n = (int)(t / L);
  const int l = (int)(t - (long long)n * L);
  const float p[3] = {points[3 * n], points[3 * n + 1], points[3 * n + 2]};
  int rows[8];
  float wl[3][2];
  level_corners(lv, l, p, rows, wl);
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = corner_weight(wl, k);
    const float2 f = __ldg(table + rows[k]);
    acc.x += w * f.x;
    acc.y += w * f.y;
  }
  out[t] = acc;  // t = n * L + l: (N, L, 2) level-major
}

__global__ void __launch_bounds__(128)
hash_bwd_kernel(const float* __restrict__ points,
                const float2* __restrict__ table,
                const float2* __restrict__ g_out, float* __restrict__ g_points,
                int* __restrict__ row_idx, float2* __restrict__ row_val,
                int n_points, const HashLevels lv) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_points) return;
  const int L = lv.n_levels;
  const float p[3] = {points[3 * n], points[3 * n + 1], points[3 * n + 2]};
  float gp[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < L; ++l) {
    int rows[8];
    float wl[3][2];
    level_corners(lv, l, p, rows, wl);
    const float2 g = g_out[(long long)n * L + l];
    if (row_idx != nullptr) {
      const long long base = ((long long)l * n_points + n) * 8;
      int4* ri = reinterpret_cast<int4*>(row_idx + base);
      ri[0] = make_int4(rows[0], rows[1], rows[2], rows[3]);
      ri[1] = make_int4(rows[4], rows[5], rows[6], rows[7]);
      float4* rv = reinterpret_cast<float4*>(row_val + base);
#pragma unroll
      for (int k = 0; k < 8; k += 2) {
        const float w0 = corner_weight(wl, k);
        const float w1 = corner_weight(wl, k + 1);
        rv[k / 2] = make_float4(w0 * g.x, w0 * g.y, w1 * g.x, w1 * g.y);
      }
    }
    if (g_points != nullptr) {
      float gw[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float2 f = __ldg(table + rows[k]);
        gw[k] = f.x * g.x + f.y * g.y;
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        float acc = 0.0f;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int bit[3] = {k >> 2, (k >> 1) & 1, k & 1};
          float other = gw[k];
#pragma unroll
          for (int a2 = 0; a2 < 3; ++a2)
            if (a2 != a) other = other * wl[a2][bit[a2]];
          acc += bit[a] ? other : -other;
        }
        gp[a] += acc * lv.scale[l];
      }
    }
  }
  if (g_points != nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      g_points[3 * n + a] = (p[a] >= 0.0f && p[a] <= 1.0f) ? gp[a] : 0.0f;
  }
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int hash_encode_fwd(const float* points, const float* table, float* out,
                    int n_points, const HashLevels* lv, cudaStream_t stream) {
  const long long total = (long long)n_points * lv->n_levels;
  if (total > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    hash_fwd_kernel<<<blocks, threads, 0, stream>>>(
        points, reinterpret_cast<const float2*>(table),
        reinterpret_cast<float2*>(out), n_points, *lv);
  }
  return (int)cudaGetLastError();
}

int hash_encode_bwd(const float* points, const float* table,
                    const float* g_out, float* g_points, int* row_idx,
                    float* row_val, int n_points, const HashLevels* lv,
                    cudaStream_t stream) {
  if (n_points > 0) {
    const int threads = 128;
    const unsigned blocks = (unsigned)((n_points + threads - 1) / threads);
    hash_bwd_kernel<<<blocks, threads, 0, stream>>>(
        points, reinterpret_cast<const float2*>(table),
        reinterpret_cast<const float2*>(g_out), g_points, row_idx,
        reinterpret_cast<float2*>(row_val), n_points, *lv);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
