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
// K5, forward: one launch for all the groups of an `encode_multi` (up to
// MAX_GROUPS point sets, each with its own level subset). Each group's
// blocks cover P consecutive points x its L levels, two lanes per (point,
// level), level-major: a warp is 16 consecutive points (samples of one
// ray) at one level, so the level's parameters and its dense/hashed branch
// are the same across the warp. A block finds its group by comparing its
// index with the groups' first blocks (the same for the whole block). A
// lane clamps its point to [0,1], finds the cell (pos = p*(res-1), clamped
// to [0, res-2]) and its brick, hashes or densely indexes the brick's row,
// reads its half of each of the footprint's 8 F-vectors (one 16-byte load
// each at F = 8), rounds each value to bf16 (to nearest even, as the JAX
// package's bf16 gather does; two values per conversion instruction) and
// sums them times the f32 weights (wx*wy)*wz in f32, corners k = 0..7 in
// order, then stores its 16 bytes of the row-major (N, L*F) output: a
// lane pair's 32 bytes are one whole sector. No residual is kept: K6
// re-reads the rows.
// One launch for the groups matters because the drive's band groups have
// bounds of 1-4 us, below what a launch costs on the device. Measured and
// dropped on the H100 (PERF.md): staging the points and the results in
// shared memory (5-15% slower: the stores are already whole sectors and
// the barriers wait for the slowest gathers), one or four lanes per
// (point, level), blocks of 4 warps (no faster) or 16 (slower), and an
// L1::evict_last hint on the dense level. What holds K5 is the launch and
// its output stores (0.004 ms of the 0.011 at the mapping pair with no
// gathers at all) and the per-(point, level) instructions.
// The Pallas kernel keeps its table slice in VMEM; here the coarse dense
// level alone is 1,000 rows x 216 f32 = 864 KB, beyond a block's 227 KB
// of shared memory, so the table is read through L1 from the 50 MB L2.
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
// Reads of the table are 16-byte vector loads; the outputs are written as
// 16-byte vectors. K6 with rows was one thread per point until its stores
// held it: a thread's 288 bytes a level made a
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

// Both values rounded to bf16 by one conversion instruction (round to
// nearest even, the same bits as bf16_round on each).
__device__ __forceinline__ float2 bf16_round2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

// K5: a block is FWD_WARPS warps; a group's block covers P points (a
// multiple of FWD_POINTS, chosen by the caller) x its L levels as
// (P / FWD_POINTS) * L warp tasks, task t being level t / (P / FWD_POINTS)
// of FWD_POINTS of the points. The caller picks P = FWD_POINTS * max(1,
// FWD_WARPS / L), so a warp has at most one task unless L > FWD_WARPS.
#define MAX_GROUPS 4
#define FWD_WARPS 8
#define FWD_POINTS 16  // points of a warp: two lanes a point

struct FwdGroups {
  int n_groups;
  const float* points[MAX_GROUPS];
  float* out[MAX_GROUPS];
  int n_points[MAX_GROUPS];
  int points_per_block[MAX_GROUPS];
  int first_block[MAX_GROUPS];
  BrickLevels lv[MAX_GROUPS];
};

template <int F>
__global__ void __launch_bounds__(32 * FWD_WARPS)
brick_fwd_kernel(const float* __restrict__ table, const FwdGroups gs) {
  constexpr int FL = F / 2;  // features of a lane
  static_assert(FL % 4 == 0, "a lane's features are whole float4s");
  const int b = blockIdx.x;
  int g = 0;  // the last group whose first block is at or before b
#pragma unroll
  for (int k = 1; k < MAX_GROUPS; ++k)
    g += (k < gs.n_groups && b >= gs.first_block[k]);
  const BrickLevels& lv = gs.lv[g];
  const int L = lv.n_levels;
  const int P = gs.points_per_block[g];
  const int n0 = (b - gs.first_block[g]) * P;
  const int np = min(P, gs.n_points[g] - n0);
  const int chunks = P / FWD_POINTS;
  const int lane = threadIdx.x & 31;
  const int h = lane & 1;  // this lane's half of the F-vectors
  for (int t = threadIdx.x >> 5; t < chunks * L; t += FWD_WARPS) {
    const int l = t / chunks;  // the same for the whole warp
    const int q = (t - l * chunks) * FWD_POINTS + (lane >> 1);
    if (q >= np) continue;
    const long long n = n0 + q;
    const float* pn = gs.points[g] + 3 * n;
    const float p[3] = {pn[0], pn[1], pn[2]};
    int slot[8];
    float wl[3][2];
    const int row = footprint(lv, l, p, slot, wl);
    const float* base = table + (long long)row * (27 * F) + h * FL;
    float acc[FL];
#pragma unroll
    for (int f = 0; f < FL; ++f) acc[f] = 0.0f;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float w = corner_weight(wl, k);
      const float4* v = reinterpret_cast<const float4*>(base + slot[k] * F);
#pragma unroll
      for (int c = 0; c < FL / 4; ++c) {
        const float4 x = __ldg(v + c);
        const float2 lo = bf16_round2(x.x, x.y), hi = bf16_round2(x.z, x.w);
        acc[4 * c + 0] += w * lo.x;
        acc[4 * c + 1] += w * lo.y;
        acc[4 * c + 2] += w * hi.x;
        acc[4 * c + 3] += w * hi.y;
      }
    }
    float4* o = reinterpret_cast<float4*>(gs.out[g] + (n * L + l) * F +
                                          h * FL);
#pragma unroll
    for (int c = 0; c < FL / 4; ++c)
      o[c] = make_float4(acc[4 * c], acc[4 * c + 1], acc[4 * c + 2],
                         acc[4 * c + 3]);
  }
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

// K5 over n_groups groups: group k encodes its n_points[k] points against
// lv[k]'s levels into out[k], in blocks of points_per_block[k] points that
// start at block first_block[k]; first_block[n_groups] is the grid size.
// The grid must be exactly the groups' blocks back to back.
int brick_encode_fwd_multi(const float* table, int n_features, int n_groups,
                           const float* const* points, float* const* out,
                           const int* n_points, const int* points_per_block,
                           const int* first_block, const BrickLevels* lv,
                           cudaStream_t stream) {
  const int F = 8;
  if (n_features != F || n_groups < 1 || n_groups > MAX_GROUPS ||
      first_block[0] != 0)
    return (int)cudaErrorInvalidValue;
  FwdGroups gs{};  // groups past n_groups stay zero and get no blocks
  gs.n_groups = n_groups;
  for (int k = 0; k < n_groups; ++k) {
    const int P = points_per_block[k], L = lv[k].n_levels;
    if (n_points[k] < 0 || P < FWD_POINTS || P % FWD_POINTS != 0 ||
        L < 1 || L > MAX_LEVELS ||
        first_block[k + 1] - first_block[k] != (n_points[k] + P - 1) / P)
      return (int)cudaErrorInvalidValue;
    gs.points[k] = points[k];
    gs.out[k] = out[k];
    gs.n_points[k] = n_points[k];
    gs.points_per_block[k] = P;
    gs.first_block[k] = first_block[k];
    gs.lv[k] = lv[k];
  }
  const int blocks = first_block[n_groups];
  if (blocks > 0)
    brick_fwd_kernel<F><<<blocks, 32 * FWD_WARPS, 0, stream>>>(table, gs);
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
