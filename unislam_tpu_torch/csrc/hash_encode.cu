// Multiresolution hash-grid encode, forward (K1) and backward (K2).
//
// Replaces unislam_tpu/models/hash_encoding.py: `_encode_fwd` (with
// `_corner_indices` and `_interp_weights`) and `_encode_bwd`.
//
// K1, forward: one thread per (point, level), in blocks of P consecutive
// points x the L levels (P = 64 up to 16 levels), laid out level-major: a
// warp is 32 consecutive points at one level. A thread clamps its point to
// [0,1], finds the 8 cell corners, hashes or densely indexes them and
// interpolates the float2 rows (F = 2) trilinearly, k = 0..7 in order. The
// block stages its points in shared memory once and its (P, L, 2) results
// too, then writes them to (N, L*2), level-major, as 16-byte stores.
//
// What bounds K1 on the H100 is the random 8-byte row gathers of the fine
// (hashed) levels, not HBM bytes: each costs a 32-byte sector that the L1
// misses, so the sector traffic from L2 sets the pace (the SDF table is 7
// MB and stays in L2, yet K1 takes 0.069 ms there against 0.082 ms for the
// 44 MB color table). The design takes from those gathers what the data
// allows: warps at one level share the level's parameters and its
// dense/hashed branch, and at the coarse levels the rows their lanes
// gather (samples of one ray are consecutive points); corners k and k+4
// (x and x+1) come in one 16-byte load when their rows share an aligned
// pair (`interp_level`). Measured and dropped on the H100 (PERF.md): the
// previous point-major layout, t = n*L + l (0.087 ms at the color/map
// shape); the level-major layout without the paired loads (0.093, slower
// than point-major); point-major with paired loads (faster on the color
// grid, slower on the SDF grid); 32-point blocks (0.085); and a loop of
// 4-8 (point, level) tasks per thread (0.10-0.19: each task's gathers then
// wait for the previous task's).
//
// K2, backward: two lanes a point, each walking the point's levels, lane
// q taking corners 4q .. 4q+3 (consecutive points on consecutive lane
// pairs). It recomputes corners and weights from the points instead of
// keeping the (L, N, 8, F) gathered rows from the forward pass, and writes
//   - the table-gradient rows `w * g` and their destination rows, in the
//     reference's (L, N, 8) order, when `row_idx` is not null. A lane's 4
//     corners are adjacent in that order, so a warp's stores cover
//     contiguous spans and a block writes 12 KB runs of each level; the
//     stores are evict-first so that the rows (258 MB at the mapping
//     shape) do not push the table out of L2. They are reduced by the
//     fixed-point scatter-accumulate kernel (scatter_accum.cu);
//   - the point gradient (the factorised trilinear derivatives times the
//     level scale, zero where the unclamped point lies outside [0,1]) when
//     `g_points` is not null: per level, the 8 corner terms are summed as
//     ((c0+c1)+(c2+c3)) + ((c4+c5)+(c6+c7)), each lane its half and one
//     shuffle, and the levels add up in order in registers. Deterministic;
//     within 3 u of the terms' absolute sum per level.
// The point's g_out row (L float2) stays in L1 while its lanes walk the
// levels. Timed on the H100 (PERF.md), the layouts this one replaced were
// slower with rows: one thread per point, or one per (point, level) in
// blocks of 32 points x 16 levels, leave each thread's 96 bytes of rows as
// strided 16-byte stores over 16 levels at once; a grid of one level per
// block makes the 8-byte g_out reads strided instead; four lanes a point
// repeat the corner arithmetic twice as often for no better stores.
//
// Bound on the H100: memory. Per point and level K1 reads 8 rows of 8
// bytes from the table and writes 8 bytes; K2 with rows writes 96 bytes
// (8 indices, 8 float2 rows) per point and level, which is most of its
// traffic. Arithmetic is a few dozen flops per row. Both keep every access
// to their outputs coalesced (vector stores of 16 bytes) and leave the
// random table gathers to L2 (the SDF table, 7 MB, fits in its 50 MB).
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

// Cell corners c[a] = {lower, upper} per axis and per-axis weights wl[a] =
// {1 - frac_a, frac_a} of point p at level l.
__device__ __forceinline__ void level_cell(const HashLevels& lv, int l,
                                           const float p[3], int c[3][2],
                                           float wl[3][2]) {
  const float s = lv.scale[l];
  const int r = lv.res[l];
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
}

// Table row of corner k = 4*bx + 2*by + bz (x slowest).
__device__ __forceinline__ int corner_k_row(const HashLevels& lv, int l,
                                            const int c[3][2], int k) {
  return corner_row(lv, l, c[0][k >> 2], c[1][(k >> 1) & 1], c[2][k & 1]);
}

__device__ __forceinline__ float corner_weight(const float wl[3][2], int k) {
  return (wl[0][k >> 2] * wl[1][(k >> 1) & 1]) * wl[2][k & 1];
}

// Trilinear interpolation of point cell c at level l: the 8 corner rows
// times their weights, summed over k = 0..7 in order. Corners k and k + 4
// differ only in x, and their rows often lie in one aligned 16-byte pair:
// dense rows x + y*r + z*r^2 and x + 1 + ... when that index is even, hashed
// rows always when x is even (x * 1 is the hash's x term, so x + 1 flips
// bit 0 only). One 16-byte load then brings both; the second load is made
// only by the lanes whose pair is split. The launcher requires even level
// offsets and sizes (make_spec's are multiples of 8), so a pair never
// reaches past its level.
__device__ __forceinline__ float2 interp_level(
    const float2* __restrict__ table, const HashLevels& lv, int l,
    const int c[3][2], const float wl[3][2]) {
  float2 f[8];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int r0 = corner_k_row(lv, l, c, k);
    const int r1 = corner_k_row(lv, l, c, k + 4);
    const float4 pair =
        __ldg(reinterpret_cast<const float4*>(table + (r0 & ~1)));
    f[k] = (r0 & 1) ? make_float2(pair.z, pair.w)
                    : make_float2(pair.x, pair.y);
    if ((r0 >> 1) == (r1 >> 1))
      f[k + 4] = (r1 & 1) ? make_float2(pair.z, pair.w)
                          : make_float2(pair.x, pair.y);
    else
      f[k + 4] = __ldg(table + r1);
  }
  float2 acc = make_float2(0.0f, 0.0f);
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float w = corner_weight(wl, k);
    acc.x += w * f[k].x;
    acc.y += w * f[k].y;
  }
  return acc;
}

// K1: a block is P consecutive points x the L levels, one thread each
// (P * L <= 1024: P = 64 up to 16 levels, else 32); warp w of the block
// takes level w / (P / 32) of 32 of its points.
template <int P>
__global__ void __launch_bounds__(1024)
hash_fwd_kernel(const float* __restrict__ points,
                const float2* __restrict__ table, float2* __restrict__ out,
                int n_points, const HashLevels lv) {
  __shared__ float s_pts[3 * P];
  // (point, level) results, a point's row padded to L + 1 so that a warp's
  // 32 points at one level write distinct banks
  __shared__ float2 s_out[P * (1024 / P + 1)];
  const int L = lv.n_levels;
  const int n0 = blockIdx.x * P;
  const int np = min(P, n_points - n0);
  for (int i = threadIdx.x; i < 3 * np; i += blockDim.x)
    s_pts[i] = points[3 * n0 + i];
  __syncthreads();
  const int l = threadIdx.x / P;  // the same for the whole warp
  const int q = threadIdx.x % P;
  if (q < np) {
    const float p[3] = {s_pts[3 * q], s_pts[3 * q + 1], s_pts[3 * q + 2]};
    int c[3][2];
    float wl[3][2];
    level_cell(lv, l, p, c, wl);
    s_out[q * (L + 1) + l] = interp_level(table, lv, l, c, wl);
  }
  __syncthreads();
  // the block's outputs are np * L consecutive float2 of (N, L, 2): copy
  // them out two at a time as 16-byte stores (n0 * L and e are even, so
  // o + e is 16-byte aligned)
  float2* o = out + (long long)n0 * L;
  const int total = np * L;
  for (int e = 2 * threadIdx.x; e < total; e += 2 * blockDim.x) {
    const int qa = e / L, la = e - qa * L;
    const float2 a = s_out[qa * (L + 1) + la];
    if (e + 1 < total) {
      const int qb = (e + 1) / L, lb = e + 1 - qb * L;
      const float2 b = s_out[qb * (L + 1) + lb];
      *reinterpret_cast<float4*>(o + e) = make_float4(a.x, a.y, b.x, b.y);
    } else {
      o[e] = a;
    }
  }
}

// K2: 2 lanes a point, lane q taking corners 4q .. 4q+3; 128 points a block.
#define BWD_POINTS 128

__global__ void __launch_bounds__(2 * BWD_POINTS)
hash_bwd_kernel(const float* __restrict__ points,
                const float2* __restrict__ table,
                const float2* __restrict__ g_out, float* __restrict__ g_points,
                int* __restrict__ row_idx, float2* __restrict__ row_val,
                int n_points, const HashLevels lv) {
  const int L = lv.n_levels;
  const int q = threadIdx.x & 1;
  const int n = blockIdx.x * BWD_POINTS + (threadIdx.x >> 1);
  const bool live = n < n_points;  // the same for both lanes of a point
  float p[3] = {0.0f, 0.0f, 0.0f};
  if (live) {
    p[0] = points[3 * n];
    p[1] = points[3 * n + 1];
    p[2] = points[3 * n + 2];
  }
  float gp[3] = {0.0f, 0.0f, 0.0f};
  for (int l = 0; l < L; ++l) {
    int c[3][2];
    float wl[3][2];
    level_cell(lv, l, p, c, wl);
    int rows[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) rows[j] = corner_k_row(lv, l, c, 4 * q + j);
    const float2 g = live ? __ldg(g_out + (long long)n * L + l)
                          : make_float2(0.0f, 0.0f);
    if (row_idx != nullptr && live) {
      // a lane's 4 corners are adjacent slots: a warp's index store is one
      // 512-byte span, its two value stores one 1 KB span; evict-first
      const long long slot = ((long long)l * n_points + n) * 8 + 4 * q;
      __stcs(reinterpret_cast<int4*>(row_idx + slot),
             make_int4(rows[0], rows[1], rows[2], rows[3]));
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        const float w0 = corner_weight(wl, 4 * q + j);
        const float w1 = corner_weight(wl, 4 * q + j + 1);
        __stcs(reinterpret_cast<float4*>(row_val + slot + j),
               make_float4(w0 * g.x, w0 * g.y, w1 * g.x, w1 * g.y));
      }
    }
    if (g_points == nullptr) continue;
    float gw[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      gw[j] = 0.0f;
      if (live) {
        const float2 f = __ldg(table + rows[j]);
        gw[j] = f.x * g.x + f.y * g.y;
      }
    }
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      // d out / d frac_a: corner values weighted by the other two axes'
      // weights, upper corner minus lower corner along axis a
      float t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * q + j;
        const int bit[3] = {k >> 2, (k >> 1) & 1, k & 1};
        float other = gw[j];
#pragma unroll
        for (int a2 = 0; a2 < 3; ++a2)
          if (a2 != a) other = other * wl[a2][bit[a2]];
        t[j] = bit[a] ? other : -other;
      }
      // ((c0+c1)+(c2+c3)) + ((c4+c5)+(c6+c7)): the two lanes' halves
      float acc = (t[0] + t[1]) + (t[2] + t[3]);
      acc += __shfl_xor_sync(0xffffffffu, acc, 1, 2);
      gp[a] += acc * lv.scale[l];  // levels in order
    }
  }
  if (g_points != nullptr && live && q == 0) {
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
  const int L = lv->n_levels;
  // interp_level's 16-byte pairs stay inside a level only when every
  // level starts and ends on an even row
  for (int l = 0; l < L; ++l)
    if ((lv->offset[l] | lv->size[l]) & 1) return (int)cudaErrorInvalidValue;
  if (n_points > 0 && L > 0) {
    const float2* t = reinterpret_cast<const float2*>(table);
    float2* o = reinterpret_cast<float2*>(out);
    if (L <= 16)
      hash_fwd_kernel<64><<<(n_points + 63) / 64, 64 * L, 0, stream>>>(
          points, t, o, n_points, *lv);
    else
      hash_fwd_kernel<32><<<(n_points + 31) / 32, 32 * L, 0, stream>>>(
          points, t, o, n_points, *lv);
  }
  return (int)cudaGetLastError();
}

int hash_encode_bwd(const float* points, const float* table,
                    const float* g_out, float* g_points, int* row_idx,
                    float* row_val, int n_points, const HashLevels* lv,
                    cudaStream_t stream) {
  if (n_points > 0) {
    const unsigned blocks = (unsigned)((n_points + BWD_POINTS - 1) /
                                       BWD_POINTS);
    hash_bwd_kernel<<<blocks, 2 * BWD_POINTS, 0, stream>>>(
        points, reinterpret_cast<const float2*>(table),
        reinterpret_cast<const float2*>(g_out), g_points, row_idx,
        reinterpret_cast<float2*>(row_val), n_points, *lv);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
