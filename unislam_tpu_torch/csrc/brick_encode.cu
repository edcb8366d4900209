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
// K6, backward, with table rows (mapping): eight lanes a point, lane k
// owning footprint vertex k; a warp is 4 consecutive points, and each
// 8-lane group walks the call's levels. Per level a lane
//   - reads the point's g_out F-vector (the group's 8 lanes read the same
//     32 bytes: one broadcast) and rounds it, g_bf = bf16(g);
//   - writes its vertex's row of the (rows*27, F) view of the table and
//     its F values bf16(bf16(w_k) * g_bf) (the product of two bf16 values
//     is exact in f32, so this equals the JAX package's bf16 rows), in
//     (level, point, vertex) order: a group's stores are 32 contiguous
//     bytes of indices and 8F contiguous floats, a warp's 1 KB at F = 8,
//     evict-first. The fixed-point scatter-accumulate (scatter_accum.cu)
//     reduces them; the 19 untouched vertices would add exact zeros;
//   - when `g_points` is not null: reads its vertex's F-vector, forms
//     g_w = sum_f bf16(row) * g_bf in f32 and the three axis terms (g_w
//     times the other two axes' weights, + for the upper vertex along the
//     axis, - for the lower), sums them over the 8 lanes by a fixed
//     __shfl_xor_sync tree, ((t0+t1)+(t2+t3)) + ((t4+t5)+(t6+t7)), the same
//     bits in every lane, and adds them times (res-1) over the levels in
//     order. One lane writes the point gradient, zero where the unclamped
//     point lies outside [0,1]: bitwise the same on every run.
// K6 without rows (tracking freezes the scene; the point gradient alone):
// one thread per point over the levels, its 8 vertex reads in flight
// together, the corner terms summed in order. Timed on the H100, the
// eight-lane kernel was slower there (0.0128 against 0.0100 ms at 80,000
// points x 2 levels): it repeats the footprint arithmetic in 8 lanes, and
// without rows there are no scattered stores for it to cure.
//
// Bound on the H100: memory. K5 reads 12 bytes a point and 8 F-vectors
// (256 bytes at F=8) a point and level, and writes 4F bytes; K6 with rows
// writes 8 indices and 8 F-vectors (288 bytes) a point and level, most of
// its traffic. The arithmetic is a few hundred flops a point and level.
// Reads of the table are 16-byte vector loads of whole F-vectors; the
// outputs are written as 16-byte vectors. K6 with rows was one thread per
// point until its stores held it: a thread's 288 bytes a level made a
// warp's 16-byte stores 32 chunks 256 bytes apart (0.102 ms at the mapping
// coarse group, 0.033 ms as eight lanes a point; PERF.md).
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

// K6 with rows: eight lanes a point, lane k owning footprint vertex k; a
// block is BWD_POINTS consecutive points, a warp 4 of them.
#define BWD_POINTS 32

template <int F>
__global__ void __launch_bounds__(8 * BWD_POINTS)
brick_bwd_kernel(const float* __restrict__ points,
                 const float* __restrict__ table,
                 const float* __restrict__ g_out, float* __restrict__ g_points,
                 int* __restrict__ row_idx, float* __restrict__ row_val,
                 int n_points, const BrickLevels lv) {
  const int k = threadIdx.x & 7;
  const int n = blockIdx.x * BWD_POINTS + (threadIdx.x >> 3);
  if (n >= n_points) return;  // the whole 8-lane group
  const unsigned group = 0xFFu << (threadIdx.x & 24);
  const int L = lv.n_levels;
  const int bit[3] = {k >> 2, (k >> 1) & 1, k & 1};
  const float p[3] = {points[3 * n], points[3 * n + 1], points[3 * n + 2]};
  float gp[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < L; ++l) {
    int slots[8];
    float wl[3][2];
    const int row = footprint(lv, l, p, slots, wl);
    int slot = slots[0];  // slots[k] by selects, not a local-memory index
#pragma unroll
    for (int j = 1; j < 8; ++j) slot = (k == j) ? slots[j] : slot;
    float w[3];  // this vertex's weight along each axis
#pragma unroll
    for (int a = 0; a < 3; ++a) w[a] = bit[a] ? wl[a][1] : wl[a][0];
    // the point's g_out F-vector: the group's 8 lanes read the same 32
    // bytes, one broadcast
    float g[F];
    const float4* gv =
        reinterpret_cast<const float4*>(g_out + ((long long)n * L + l) * F);
#pragma unroll
    for (int q = 0; q < F / 4; ++q) {
      const float4 x = __ldg(gv + q);
      g[4 * q + 0] = bf16_round(x.x);
      g[4 * q + 1] = bf16_round(x.y);
      g[4 * q + 2] = bf16_round(x.z);
      g[4 * q + 3] = bf16_round(x.w);
    }
    if (row_idx != nullptr) {
      // slot (l, n, k): a group's indices are 32 contiguous bytes and its
      // values 8F floats, a warp's 4 points 1 KB at F = 8; evict-first
      const long long out = ((long long)l * n_points + n) * 8 + k;
      __stcs(row_idx + out, row * 27 + slot);
      const float wb = bf16_round(__fmul_rn(__fmul_rn(w[0], w[1]), w[2]));
      float4* rv = reinterpret_cast<float4*>(row_val + out * F);
#pragma unroll
      for (int q = 0; q < F / 4; ++q)
        __stcs(rv + q, make_float4(bf16_round(wb * g[4 * q + 0]),
                                   bf16_round(wb * g[4 * q + 1]),
                                   bf16_round(wb * g[4 * q + 2]),
                                   bf16_round(wb * g[4 * q + 3])));
    }
    if (g_points != nullptr) {
      const float4* v = reinterpret_cast<const float4*>(
          table + (long long)row * (27 * F) + slot * F);
      float gw = 0.0f;
#pragma unroll
      for (int q = 0; q < F / 4; ++q) {
        const float4 x = __ldg(v + q);
        gw += bf16_round(x.x) * g[4 * q + 0];
        gw += bf16_round(x.y) * g[4 * q + 1];
        gw += bf16_round(x.z) * g[4 * q + 2];
        gw += bf16_round(x.w) * g[4 * q + 3];
      }
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        // d out / d frac_a: the vertex value weighted by the other two
        // axes' weights, + for the upper vertex along a, - for the lower;
        // the 8 vertices summed as ((t0+t1)+(t2+t3)) + ((t4+t5)+(t6+t7)),
        // the same bits in every lane of the group
        float t = gw;
#pragma unroll
        for (int a2 = 0; a2 < 3; ++a2)
          if (a2 != a) t = t * w[a2];
        t = bit[a] ? t : -t;
        t += __shfl_xor_sync(group, t, 1, 8);
        t += __shfl_xor_sync(group, t, 2, 8);
        t += __shfl_xor_sync(group, t, 4, 8);
        gp[a] += t * lv.res_m1[l];  // levels in order
      }
    }
  }
  if (g_points != nullptr && k == 0) {
#pragma unroll
    for (int a = 0; a < 3; ++a)
      g_points[3 * n + a] = (p[a] >= 0.0f && p[a] <= 1.0f) ? gp[a] : 0.0f;
  }
}

// K6 without table rows (tracking: the scene is frozen): one thread per
// point, its 8 vertex reads in flight together, levels in order.
template <int F>
__global__ void __launch_bounds__(128)
brick_bwd_points_kernel(const float* __restrict__ points,
                        const float* __restrict__ table,
                        const float* __restrict__ g_out,
                        float* __restrict__ g_points, int n_points,
                        const BrickLevels lv) {
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
      const float4 x = __ldg(gv + q);
      g[4 * q + 0] = bf16_round(x.x);
      g[4 * q + 1] = bf16_round(x.y);
      g[4 * q + 2] = bf16_round(x.z);
      g[4 * q + 3] = bf16_round(x.w);
    }
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
#pragma unroll
  for (int a = 0; a < 3; ++a)
    g_points[3 * n + a] = (p[a] >= 0.0f && p[a] <= 1.0f) ? gp[a] : 0.0f;
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
  if (row_idx == nullptr && g_points != nullptr) {
    const unsigned blocks = (unsigned)((n_points + 127) / 128);
    brick_bwd_points_kernel<F><<<blocks, 128, 0, stream>>>(
        points, table, g_out, g_points, n_points, lv);
    return;
  }
  const unsigned blocks = (unsigned)((n_points + BWD_POINTS - 1) /
                                     BWD_POINTS);
  brick_bwd_kernel<F><<<blocks, 8 * BWD_POINTS, 0, stream>>>(
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
