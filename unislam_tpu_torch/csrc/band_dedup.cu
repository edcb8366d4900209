// Band row dedup of the brick backward's table-gradient rows (K8).
//
// Replaces unislam_tpu/models/brick_encoding.py: `_dedup_rows` (called from
// `_encode_multi_bwd`), the XLA prefix-sum + boundary-difference dedup of a
// band group's row cotangents before the one scatter (here K9).
//
// Per (level, ray) of a band group (K samples in z order, 8 vertex rows of
// F = 8 a sample, as K6 emits them in (L, R*K, 8) order):
// - a run is a stretch of consecutive samples with the same brick row
//   (row_idx / 27);
// - a 27 x F f32 prefix S over the ray's samples, never reset: each sample
//   adds its 8 rows into slots (row_idx % 27, f);
// - at the end of run u < Ku: bf16_rn(S - P) for all 216 slots, P the
//   prefix at the previous run end (0 before the first), index
//   brick_row * 27 + v; runs past Ku - 1 are dropped;
// - slots u past the ray's last run: S - P with P = S (zero, or NaN where S
//   is not finite) at the brick row of the ray's last sample.
// kernels/band_dedup.py's plain version does the same adds in the same
// order, so the two agree bit for bit (NaN payloads aside).
//
// Bound on the H100: memory. Each input row is read once (36 bytes: an
// index and 8 values) and each output row written once (L*R*Ku*27 rows of
// 36 bytes); one add per input value and one subtract per output value.
// Design: one warp per (level, ray), 8 warps a block. The warp's prefix and
// previous boundary live in shared memory (2 x 216 f32): a sample's 64
// values are read coalesced (two per lane) and each lane adds its values
// into the slots they name; the sample's 8 vertex slots are distinct, so
// the adds never collide and need no atomics. A run end writes 216
// contiguous values (7 a lane) and 27 indices. Output is the same on every
// run. Only adds and subtracts: -fmad=false (as for the other sources)
// changes nothing here.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define FULL_MASK 0xffffffffu
#define V3 27          // vertices of a brick
#define FEAT 8         // F, features a vertex
#define FOOT 8         // vertex rows a sample adds
#define SLOTS (V3 * FEAT)
#define WARPS 8        // warps of a block, one ray each

__device__ __forceinline__ float bf16_rn(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Write run u: S - P rounded to bf16 at every slot, P <- S, and the 27
// vertex indices of `brick`. Each lane owns slots lane, lane + 32, ...
__device__ __forceinline__ void emit(float* S, float* P, float* ro, int* io,
                                     int u, int brick, int lane) {
  float* out = ro + (long long)u * SLOTS;
  for (int s = lane; s < SLOTS; s += 32) {
    const float cur = S[s];
    out[s] = bf16_rn(cur - P[s]);
    P[s] = cur;
  }
  if (lane < V3) io[(long long)u * V3 + lane] = brick * V3 + lane;
  __syncwarp();
}

__global__ void __launch_bounds__(WARPS * 32)
band_dedup_kernel(const int* __restrict__ row_idx,
                  const float* __restrict__ rows, int* __restrict__ idx_out,
                  float* __restrict__ rows_out, int n_rays, int K, int Ku) {
  __shared__ float s_sum[WARPS][SLOTS];
  __shared__ float s_prev[WARPS][SLOTS];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long ray = (long long)blockIdx.x * WARPS + warp;
  if (ray >= n_rays) return;  // the whole warp leaves together
  float* S = s_sum[warp];
  float* P = s_prev[warp];
  for (int s = lane; s < SLOTS; s += 32) {
    S[s] = 0.0f;
    P[s] = 0.0f;
  }
  __syncwarp();
  const int* ri = row_idx + ray * K * FOOT;
  const float* rv = rows + ray * K * FOOT * FEAT;
  int* io = idx_out + ray * Ku * V3;
  float* ro = rows_out + ray * Ku * SLOTS;
  const int f = lane & (FEAT - 1);
  int u = 0, run_brick = 0;
  for (int k = 0; k < K; ++k) {
    const int mine = lane < FOOT ? ri[k * FOOT + lane] : 0;
    const int brick = __shfl_sync(FULL_MASK, mine, 0) / V3;
    if (k == 0) {
      run_brick = brick;
    } else if (brick != run_brick) {  // run u ended at sample k - 1
      emit(S, P, ro, io, u, run_brick, lane);
      if (++u == Ku) break;           // the ray's farther runs are dropped
      run_brick = brick;
    }
    // value t of the sample's 64 is vertex row t / 8, feature t % 8
    const int va = __shfl_sync(FULL_MASK, mine, lane >> 3) % V3;
    const int vb = __shfl_sync(FULL_MASK, mine, (lane >> 3) + 4) % V3;
    const float xa = rv[k * FOOT * FEAT + lane];
    const float xb = rv[k * FOOT * FEAT + 32 + lane];
    S[va * FEAT + f] += xa;
    S[vb * FEAT + f] += xb;
    __syncwarp();
  }
  // the last run (unless it was past Ku), then the unused slots; without
  // the break, run_brick is the brick of the ray's last sample
  for (; u < Ku; ++u) emit(S, P, ro, io, u, run_brick, lane);
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// row_idx (n_rays*K*8,) int32, rows (n_rays*K*8, F) f32 -> idx_out
// (n_rays*Ku*27,) int32, rows_out (n_rays*Ku*27, F) f32; n_rays = L*R.
// Returns cudaGetLastError() after the launch.
int band_dedup(const int* row_idx, const float* rows, int* idx_out,
               float* rows_out, int n_rays, int K, int Ku, int F,
               cudaStream_t stream) {
  if (F != FEAT || K < 1 || Ku < 1 || Ku > K || n_rays < 0)
    return (int)cudaErrorInvalidValue;
  if (n_rays == 0) return (int)cudaSuccess;
  const int blocks = (n_rays + WARPS - 1) / WARPS;
  band_dedup_kernel<<<blocks, WARPS * 32, 0, stream>>>(
      row_idx, rows, idx_out, rows_out, n_rays, K, Ku);
  return (int)cudaGetLastError();
}

}  // extern "C"
