// Sorted scatter-accumulate (K9): out[idx[i]] += upd[i], deterministic.
//
// Replaces the Pallas kernel examples/pallas_scatter_accum.py:
// `scatter_accumulate` / `_kernel`, and with it the table gradient of the
// hash backward (unislam_tpu/models/hash_encoding.py `_encode_bwd`,
// `jnp.zeros(...).at[idx].add(g_rows)`).
//
// The wrapper (kernels/scatter_accum.py) sorts the destinations with a
// stable sort and permutes the update rows, as the Pallas version's argsort
// also sits outside its kernel. This kernel then reduces each run of equal
// destinations: one thread per sorted row; the thread at the head of a run
// sums the run's rows in sorted order in f32 and writes the destination
// row once. The wrapper zeroes the output, so untouched rows stay 0. No
// atomics: the result is bitwise the same from run to run, and because the
// sort is stable each destination sums its updates in their original order.
//
// Unlike the Pallas version, updates are not rounded to bf16: the hash
// path's gradient rows are f32 and the reference scatters them unrounded.
// Destinations outside [0, n_rows) are dropped.
//
// Bound on the H100: memory (read idx and upd once, write the table
// gradient once; one add per update value). This first design is uneven:
// a run is summed by one thread, and the dense coarse levels have runs of
// thousands of rows while most runs are a few rows long.

#include <cuda_runtime.h>
#include <stdint.h>

__global__ void __launch_bounds__(256)
scatter_runs_kernel(const int* __restrict__ keys,
                    const float* __restrict__ upd, long long m, int d,
                    int n_rows, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const int k = keys[i];
  if (i > 0 && keys[i - 1] == k) return;  // not the head of a run
  if (k < 0 || k >= n_rows) return;
  long long end = i + 1;
  while (end < m && keys[end] == k) ++end;
  if (d == 2) {
    const float2* u = reinterpret_cast<const float2*>(upd);
    float ax = 0.0f, ay = 0.0f;
    for (long long j = i; j < end; ++j) {
      const float2 v = u[j];
      ax += v.x;
      ay += v.y;
    }
    out[2LL * k] = ax;
    out[2LL * k + 1] = ay;
  } else {
    for (int c = 0; c < d; ++c) {
      float acc = 0.0f;
      for (long long j = i; j < end; ++j) acc += upd[j * d + c];
      out[(long long)k * d + c] = acc;
    }
  }
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

int scatter_accumulate_sorted(const int* keys, const float* upd, long long m,
                              int d, int n_rows, float* out,
                              cudaStream_t stream) {
  if (m > 0) {
    const int threads = 256;
    const unsigned blocks = (unsigned)((m + threads - 1) / threads);
    scatter_runs_kernel<<<blocks, threads, 0, stream>>>(keys, upd, m, d,
                                                        n_rows, out);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
