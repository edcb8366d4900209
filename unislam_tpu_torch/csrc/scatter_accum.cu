// Sorted scatter-accumulate (K9): out[idx[i]] += upd[i], deterministic.
//
// Replaces the Pallas kernel examples/pallas_scatter_accum.py:
// `scatter_accumulate` / `_kernel`, and with it the table gradients of the
// hash backward (unislam_tpu/models/hash_encoding.py `_encode_bwd`,
// `jnp.zeros(...).at[idx].add(g_rows)`) and of the brick backward
// (unislam_tpu/models/brick_encoding.py `_scatter_segments`).
//
// The wrapper (kernels/scatter_accum.py) sorts the destinations with a
// stable sort and permutes the update rows, as the Pallas version's argsort
// also sits outside its kernel. This kernel then reduces each run of equal
// destinations and writes the destination row once. The wrapper zeroes the
// output, so untouched rows stay 0. No atomics: the result is bitwise the
// same from run to run, and because the sort is stable each destination
// sums its updates in their original order, one by one in f32.
//
// Two forms, by row width d:
// - d == 2 (the hash grids): one thread per sorted row; the thread at the
//   head of a run sums the run's float2 rows;
// - any other d (the brick backward's F-wide vertex rows): one thread per
//   (sorted row, column); the thread of a run head's column sums that
//   column over the run, so the d columns of a run are summed in parallel
//   and neighbouring threads read neighbouring addresses.
//
// Unlike the Pallas version, updates are not rounded to bf16: the hash
// path's gradient rows are f32 and the reference scatters them unrounded
// (the brick path's rows already hold bf16 values).
// Destinations outside [0, n_rows) are dropped.
//
// Bound on the H100: memory (read idx and upd once, write the table
// gradient once; one add per update value). This first design is uneven:
// a run is summed by one thread per column, and the dense coarse levels
// have runs of thousands of rows while most runs are a few rows long.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256)
scatter_runs_kernel(const int* __restrict__ keys,
                    const float* __restrict__ upd, long long m,
                    int n_rows, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int k = keys[i];
  if (i > 0 && keys[i - 1] == k) return;  // not the head of a run
  if (k < 0 || k >= n_rows) return;
  long long end = i + 1;
  while (end < m && keys[end] == k) ++end;
  const float2* u = reinterpret_cast<const float2*>(upd);
  float ax = 0.0f, ay = 0.0f;
  for (long long j = i; j < end; ++j) {
    const float2 v = u[j];
    ax += v.x;
    ay += v.y;
  }
  out[2LL * k] = ax;
  out[2LL * k + 1] = ay;
}

__global__ void __launch_bounds__(256)
scatter_cols_kernel(const int* __restrict__ keys,
                    const float* __restrict__ upd, long long m, int d,
                    int n_rows, float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= m * d) return;
  const long long i = t / d;
  const int c = (int)(t - i * d);
  const int k = keys[i];
  if (i > 0 && keys[i - 1] == k) return;  // not the head of a run
  if (k < 0 || k >= n_rows) return;
  float acc = 0.0f;
  for (long long j = i; j < m && keys[j] == k; ++j) acc += upd[j * d + c];
  out[(long long)k * d + c] = acc;
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int scatter_accumulate_sorted(const int* keys, const float* upd, long long m,
                              int d, int n_rows, float* out,
                              cudaStream_t stream) {
  if (m > 0 && d > 0) {
    const int threads = 256;
    if (d == 2) {
      const unsigned blocks = (unsigned)((m + threads - 1) / threads);
      scatter_runs_kernel<<<blocks, threads, 0, stream>>>(keys, upd, m,
                                                          n_rows, out);
    } else {
      const unsigned blocks =
          (unsigned)((m * d + threads - 1) / threads);
      scatter_cols_kernel<<<blocks, threads, 0, stream>>>(keys, upd, m, d,
                                                          n_rows, out);
    }
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
