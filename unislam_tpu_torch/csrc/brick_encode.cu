// Multiresolution brick encode, forward (K5) and backward (K6).
//
// Replaces the Pallas kernels examples/pallas_fused_dense.py `encode_fwd` /
// `_fwd_kernel` and `encode_bwd` / `_bwd_kernel`, and the JAX package's own
// form of them, unislam_tpu/models/brick_encoding.py `_encode_fwd` (with
// `_level_indices`, `_gather_rows`, `_interp_weights`) and `_bwd_group`.
// The Pallas version looks rows up by a one-hot matmul per level tile; here
// a thread reads the rows it needs directly.
//
// The table is (rows, 27*F) f32: a row holds the F features of the 27
// vertices of one brick of 2x2x2 cells, column ((i*3 + j)*3 + k)*F + f for
// the vertex at (i, j, k). A point's trilinear footprint at a level is 8 of
// those 27 vertices; the other 19 have weight 0 and are never read.
//
// K5, forward: one thread per (point, level of the call's subset). It
// clamps the point to [0,1], finds the cell (pos = p*(res-1), clamped to
// [0, res-2]) and its brick, hashes or densely indexes the brick's row,
// reads the footprint's 8 F-vectors, rounds each value to bf16 (to nearest
// even, as the JAX package's bf16 gather does) and sums them times the f32
// weights (wx*wy)*wz in f32. Output (N, L*F) level-major, written by
// consecutive threads at consecutive addresses. No residual is kept: K6
// re-reads the rows.
//
// K6, backward: one thread per point, looping over the call's levels. With
// g_bf = bf16(g) it writes
//   - the point gradient when `g_points` is not null: per touched vertex
//     g_w = sum_f bf16(row) * g_bf in f32, through the +-1 weight
//     derivatives times (res-1), summed over levels in order, zero where
//     the unclamped point lies outside [0,1];
//   - the table-gradient rows when `row_idx` is not null: for each of the
//     8 touched vertices the F values bf16(bf16(w) * g_bf) (the product of
//     two bf16 values is exact in f32, so this equals the JAX package's
//     bf16 rows) and the vertex's row of the (rows*27, F) view of the
//     table, in (level, point, vertex) order. The sorted scatter-accumulate
//     (scatter_accum.cu) reduces them; the 19 untouched vertices would add
//     exact zeros.
//
// Bound on the H100: memory. K5 reads 12 bytes a point and 8 F-vectors
// (256 bytes at F=8) a point and level, and writes 4F bytes; K6 with rows
// writes 8 indices and 8 F-vectors (288 bytes) a point and level, most of
// its traffic. The arithmetic is a few hundred flops a point and level.
// Reads of the table are 16-byte vector loads of whole F-vectors; the
// outputs are written as 16-byte vectors.
//
// F = 8 features a vertex (every brick config of the repo); the kernels
// are templates on F, a multiple of 4 for the float4 accesses.
//
// Built with -fmad=false: `p*(res-1) - cell` must round twice like the
// plain PyTorch and JAX versions, or a point on a cell face gets another
// frac; the weight products and the sums then also round like theirs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define MAX_LEVELS 16

struct BrickLevels {
  int n_levels;                 // levels of this call (a ladder subset)
  float res_m1[MAX_LEVELS];     // cell resolution - 1
  int res_m2[MAX_LEVELS];       // largest cell index, resolution - 2
  int brick_res[MAX_LEVELS];    // bricks per axis (dense levels)
  int rows[MAX_LEVELS];         // table rows of the level
  int offset[MAX_LEVELS];       // first table row of the level
  int hashed[MAX_LEVELS];       // 1: spatial hash, 0: dense
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Table row of point p's brick at level l, the footprint's 8 vertex slots
// (corner k = 4*a + 2*b + c over the x, y, z offsets a, b, c) and per-axis
// weights wl[axis] = {1 - frac, frac}.
__device__ __forceinline__ int footprint(const BrickLevels& lv, int l,
                                         const float p[3], int slot[8],
                                         float wl[3][2]) {
  int b[3], loc[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float x = fminf(fmaxf(p[a], 0.0f), 1.0f);
    const float pos = __fmul_rn(x, lv.res_m1[l]);
    const int c = max(min((int)floorf(pos), lv.res_m2[l]), 0);
    const float fr = __fsub_rn(pos, (float)c);
    b[a] = c >> 1;
    loc[a] = c - 2 * b[a];
    wl[a][0] = __fsub_rn(1.0f, fr);
    wl[a][1] = fr;
  }
  int row;
  if (lv.hashed[l]) {
    const uint32_t h = ((uint32_t)b[0] * 1u) ^
                       ((uint32_t)b[1] * 2654435761u) ^
                       ((uint32_t)b[2] * 805459861u);
    row = (int)(h % (uint32_t)lv.rows[l]);
  } else {
    const int br = lv.brick_res[l];
    row = min(b[0] + b[1] * br + b[2] * br * br, lv.rows[l] - 1);
  }
#pragma unroll
  for (int k = 0; k < 8; ++k)
    slot[k] = ((loc[0] + (k >> 2)) * 3 + loc[1] + ((k >> 1) & 1)) * 3 +
              loc[2] + (k & 1);
  return row + lv.offset[l];
}

__device__ __forceinline__ float corner_weight(const float wl[3][2], int k) {
  return __fmul_rn(__fmul_rn(wl[0][k >> 2], wl[1][(k >> 1) & 1]),
                   wl[2][k & 1]);
}

template <int F>
__global__ void __launch_bounds__(256)
brick_fwd_kernel(const float* __restrict__ points,
                 const float* __restrict__ table, float* __restrict__ out,
                 int n_points, const BrickLevels lv) {
  const int L = lv.n_levels;
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (long long)n_points * L) return;
  const int n = (int)(t / L);
  const int l = (int)(t - (long long)n * L);
  const float p[3] = {points[3 * n], points[3 * n + 1], points[3 * n + 2]};
  int slot[8];
  float wl[3][2];
  const int row = footprint(lv, l, p, slot, wl);
  const float* base = table + (long long)row * (27 * F);
  float acc[F];
#pragma unroll
  for (int f = 0; f < F; ++f) acc[f] = 0.0f;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = corner_weight(wl, k);
    const float4* v = reinterpret_cast<const float4*>(base + slot[k] * F);
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 x = __ldg(v + q);
      acc[4 * q + 0] += w * bf16_round(x.x);
      acc[4 * q + 1] += w * bf16_round(x.y);
      acc[4 * q + 2] += w * bf16_round(x.z);
      acc[4 * q + 3] += w * bf16_round(x.w);
    }
  }
  float4* o = reinterpret_cast<float4*>(out + t * F);  // (N, L, F)
#pragma unroll
  for (int q = 0; q < F / 4; ++q)
    o[q] = make_float4(acc[4 * q], acc[4 * q + 1], acc[4 * q + 2],
                       acc[4 * q + 3]);
}

template <int F>
__global__ void __launch_bounds__(128)
brick_bwd_kernel(const float* __restrict__ points,
                 const float* __restrict__ table,
                 const float* __restrict__ g_out, float* __restrict__ g_points,
                 int* __restrict__ row_idx, float* __restrict__ row_val,
                 int n_points, const BrickLevels lv) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= n_points) return;
  const int L = lv.n_levels;
  const float p[3] = {points[3 * n], points[3 * n + 1], points[3 * n + 2]};
  float gp[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < L; ++l) {
    int slot[8];
    float wl[3][2];
    const int row = footprint(lv, l, p, slot, wl);
    float g[F];
    const float4* gv =
        reinterpret_cast<const float4*>(g_out + ((long long)n * L + l) * F);
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 x = gv[q];
      g[4 * q + 0] = bf16_round(x.x);
      g[4 * q + 1] = bf16_round(x.y);
      g[4 * q + 2] = bf16_round(x.z);
      g[4 * q + 3] = bf16_round(x.w);
    }
    if (row_idx != nullptr) {
      const long long out = ((long long)l * n_points + n) * 8;
      const int vrow = row * 27;
      int4* ri = reinterpret_cast<int4*>(row_idx + out);
      ri[0] = make_int4(vrow + slot[0], vrow + slot[1], vrow + slot[2],
                        vrow + slot[3]);
      ri[1] = make_int4(vrow + slot[4], vrow + slot[5], vrow + slot[6],
                        vrow + slot[7]);
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float wb = bf16_round(corner_weight(wl, k));
        float4* rv = reinterpret_cast<float4*>(row_val + (out + k) * F);
#pragma unroll
        for (int q = 0; q < F / 4; ++q)
          rv[q] = make_float4(bf16_round(wb * g[4 * q + 0]),
                              bf16_round(wb * g[4 * q + 1]),
                              bf16_round(wb * g[4 * q + 2]),
                              bf16_round(wb * g[4 * q + 3]));
      }
    }
    if (g_points != nullptr) {
      const float* base = table + (long long)row * (27 * F);
      float gw[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const float4* v = reinterpret_cast<const float4*>(base + slot[k] * F);
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < F / 4; ++q) {
          const float4 x = __ldg(v + q);
          s += bf16_round(x.x) * g[4 * q + 0];
          s += bf16_round(x.y) * g[4 * q + 1];
          s += bf16_round(x.z) * g[4 * q + 2];
          s += bf16_round(x.w) * g[4 * q + 3];
        }
        gw[k] = s;
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
        gp[a] += acc * lv.res_m1[l];
      }
    }
  }
  if (g_points != nullptr) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      g_points[3 * n + a] = (p[a] >= 0.0f && p[a] <= 1.0f) ? gp[a] : 0.0f;
  }
}

template <int F>
static void launch_fwd(const float* points, const float* table, float* out,
                       int n_points, const BrickLevels& lv,
                       cudaStream_t stream) {
  const long long total = (long long)n_points * lv.n_levels;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  brick_fwd_kernel<F><<<blocks, threads, 0, stream>>>(points, table, out,
                                                      n_points, lv);
}

template <int F>
static void launch_bwd(const float* points, const float* table,
                       const float* g_out, float* g_points, int* row_idx,
                       float* row_val, int n_points, const BrickLevels& lv,
                       cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n_points + threads - 1) / threads);
  brick_bwd_kernel<F><<<blocks, threads, 0, stream>>>(
      points, table, g_out, g_points, row_idx, row_val, n_points, lv);
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int brick_encode_fwd(const float* points, const float* table, float* out,
                     int n_points, int n_features, const BrickLevels* lv,
                     cudaStream_t stream) {
  if (n_features != 8) return (int)cudaErrorInvalidValue;
  if (n_points > 0 && lv->n_levels > 0)
    launch_fwd<8>(points, table, out, n_points, *lv, stream);
  return (int)cudaGetLastError();
}

int brick_encode_bwd(const float* points, const float* table,
                     const float* g_out, float* g_points, int* row_idx,
                     float* row_val, int n_points, int n_features,
                     const BrickLevels* lv, cudaStream_t stream) {
  if (n_features != 8) return (int)cudaErrorInvalidValue;
  if (n_points > 0 && lv->n_levels > 0)
    launch_bwd<8>(points, table, g_out, g_points, row_idx, row_val, n_points,
                  *lv, stream);
  return (int)cudaGetLastError();
}

}  // extern "C"
