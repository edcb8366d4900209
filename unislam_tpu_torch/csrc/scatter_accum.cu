// Order-independent fixed-point scatter-accumulate (K9): out[idx[i]] += upd[i].
//
// Replaces the Pallas kernel examples/pallas_scatter_accum.py:
// `scatter_accumulate` / `_kernel`, and with it the table gradients of the
// hash backward (unislam_tpu/models/hash_encoding.py `_encode_bwd`,
// `jnp.zeros(...).at[idx].add(g_rows)`) and of the brick backward
// (unislam_tpu/models/brick_encoding.py `_scatter_segments`).
//
// Why integers: the Pallas kernel sorts so that each destination sums its
// updates in a fixed order; a float sum depends on its order. Neither
// reference fixes that order (`.at[].add` leaves it open); what matters is
// that the gradient is accurate and the same on every run. An integer sum
// is associative, so here each destination's terms are scaled to int64 by
// a per-destination power of two and summed with atomics in any order: the
// result is exact, bitwise the same on every run, row order and card, and
// no sort or row permute is needed. kernels/scatter_accum.py's plain
// version does the same steps (see its note for the numerics and bound).
//
// Three passes on the caller's stream; the wrapper zeroes `meta` (n_rows
// int2: largest finite |term| bits, term count), `cls` (n_rows int32: the
// non-finite classes per column) and `acc` (n_rows x d int64):
// - A: per row, the largest |term| bits over its finite columns (finite
//   non-zero terms are 1 .. 0x7f7fffff) and a count of one, by atomicMax /
//   atomicAdd into meta[k]; each non-finite column c sets its class bit in
//   cls[k] (bit 3c NaN, 3c+1 +inf, 3c+2 -inf; d <= 8 fits in 24 bits) by
//   atomicOr, which commutes, so the result stays independent of order;
// - B: per row, q = round_half_even(v * 2^s_k) per finite column (a
//   non-finite term adds 0), summed into acc[k] with 64-bit atomicAdd (two's
//   complement);
// - C: one thread per output element: from its class bits, NaN (a NaN
//   term, or both a +inf and a -inf term) or +-inf (terms of one infinite
//   sign); otherwise acc to f64, times 2^-s_k, to f32. So each column sums
//   by IEEE rules, as the reference's `.at[idx].add` does.
// Rows are in the hash backward's (L, N, 8) order, so neighbouring lanes
// often share a coarse-level destination: passes A and B first combine the
// lanes of a warp that share one (__match_any_sync, then a shuffle tree),
// which is exact and cuts contention on the coarse levels' long runs (19k
// rows on one destination). Row widths d are those of the two table
// gradients, 2 (hash) and 8 (brick vertex rows): a float2 or two float4
// loads a row.
//
// Bound on the H100: memory (read idx and upd once, write the output once;
// one add per update value). What sets the pace is the rate of atomics in
// L2: per row (after the warp's combining) pass A issues a count and, when
// its value beats what it reads there, a max; pass B one 64-bit add per
// column. That is twice the atomics of a plain f32 `index_add_`, whose
// sum depends on the order its atomics land in.

#include <cuda_runtime.h>
#include <stdint.h>

#define FULL_MASK 0xffffffffu
#define ABS_BITS 0x7fffffff
#define INF_BITS 0x7f800000

// 2^s as a double, exactly, for s in [-1022, 1023].
__device__ __forceinline__ double pow2(int s) {
  return __longlong_as_double((long long)(s + 1023) << 52);
}

// frexp exponent of the positive finite f32 with these bits: 2^(e-1) <= x
// < 2^e. Integer arithmetic, so subnormals need no care.
__device__ __forceinline__ int frexp_exponent(int bits) {
  const int biased = bits >> 23;
  if (biased > 0) return biased - 126;
  return (32 - __clz(bits)) - 149;  // subnormal: bit length of the mantissa
}

// s_k = 62 - e_k - h_k, h_k = ceil(log2(count)).
__device__ __forceinline__ int fixed_shift(int2 m) {
  const int h = m.y <= 1 ? 0 : 32 - __clz(m.y - 1);
  return 62 - frexp_exponent(m.x) - h;
}

// Combine v over the lanes of `peers` (this lane's group of lanes with the
// same key); the group's lowest lane ends with the result. A tree over the
// group's ranks: each round a lane takes the value of the next remaining
// lane of its group, and the odd-ranked lanes drop out. All 32 lanes call.
template <typename T, typename Op>
__device__ __forceinline__ T combine_peers(unsigned peers, T v, Op op) {
  const int lane = threadIdx.x & 31;
  unsigned above = peers & ~(0xffffffffu >> (31 - lane));  // lanes > lane
  int rank = __popc(peers & ((1u << lane) - 1));
  while (__any_sync(FULL_MASK, above != 0)) {
    const int next = __ffs(above) - 1;
    const T t = __shfl_sync(FULL_MASK, v, next < 0 ? lane : next);
    if (next >= 0) v = op(v, t);
    above &= ~__ballot_sync(FULL_MASK, rank & 1);
    rank >>= 1;
  }
  return v;
}

struct MaxOp {
  __device__ int operator()(int a, int b) const { return max(a, b); }
};
struct OrOp {
  __device__ int operator()(int a, int b) const { return a | b; }
};
struct AddOp {
  __device__ long long operator()(long long a, long long b) const {
    return a + b;
  }
};

// Row i's D columns into v, with 16-byte loads where the width allows.
template <int D>
__device__ __forceinline__ void load_row(const float* __restrict__ upd,
                                         long long i, float* v) {
  if constexpr (D == 2) {
    const float2 a = __ldg(reinterpret_cast<const float2*>(upd) + i);
    v[0] = a.x;
    v[1] = a.y;
  } else if constexpr (D == 8) {
    const float4* p = reinterpret_cast<const float4*>(upd) + 2 * i;
    const float4 a = __ldg(p), b = __ldg(p + 1);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  }
}

// Destination of row i, or -1 (row past the end, or outside [0, n_rows)).
__device__ __forceinline__ int row_key(const int* __restrict__ idx,
                                       long long i, long long m, int n_rows) {
  if (i >= m) return -1;
  const int k = __ldg(idx + i);
  return (k >= 0 && k < n_rows) ? k : -1;
}

// Class bits of a non-finite f32 with |bits| `abs_bits` (>= INF_BITS):
// 1 NaN, 2 +inf, 4 -inf.
__device__ __forceinline__ int non_finite_class(float x, int abs_bits) {
  if (abs_bits > INF_BITS) return 1;
  return x > 0.0f ? 2 : 4;
}

// Pass A: per destination, the largest finite |term| bits, the term count
// and the columns' non-finite classes.
template <int D>
__global__ void __launch_bounds__(256)
pass_a_kernel(const int* __restrict__ idx, const float* __restrict__ upd,
              long long m, int n_rows, int2* __restrict__ meta,
              int* __restrict__ cls) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int k = row_key(idx, i, m, n_rows);
  int top = 0, word = 0;
  if (k >= 0) {
    float v[D];
    load_row<D>(upd, i, v);
#pragma unroll
    for (int c = 0; c < D; ++c) {
      const int b = __float_as_int(v[c]) & ABS_BITS;
      if (b < INF_BITS)
        top = max(top, b);
      else
        word |= non_finite_class(v[c], b) << (3 * c);
    }
  }
  const unsigned peers = __match_any_sync(FULL_MASK, k);
  top = combine_peers(peers, top, MaxOp());
  // rows with non-finite terms are rare: most warps skip the OR tree
  if (__any_sync(FULL_MASK, word != 0))
    word = combine_peers(peers, word, OrOp());
  if (k >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1) {
    // meta[k].x only grows, so a stale read can only be lower: skipping
    // the atomic when the read is already >= top is safe
    if (top > __ldcg(&meta[k].x)) atomicMax(&meta[k].x, top);
    atomicAdd(&meta[k].y, __popc(peers));
    if (word != 0) atomicOr(cls + k, word);
  }
}

// Pass B: the terms in fixed point, summed per (destination, column).
template <int D>
__global__ void __launch_bounds__(256)
pass_b_kernel(const int* __restrict__ idx, const float* __restrict__ upd,
              long long m, int n_rows, const int2* __restrict__ meta,
              unsigned long long* __restrict__ acc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  int k = row_key(idx, i, m, n_rows);
  int2 mk = make_int2(0, 0);
  if (k >= 0) {
    mk = __ldg(meta + k);
    // every finite term zero: nothing to add
    if (mk.x == 0) k = -1;
  }
  const unsigned peers = __match_any_sync(FULL_MASK, k);
  const bool leader = k >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1;
  const double scale = k >= 0 ? pow2(fixed_shift(mk)) : 0.0;
  unsigned long long* out = acc + (long long)(k >= 0 ? k : 0) * D;
  float v[D];
  if (k >= 0) load_row<D>(upd, i, v);
#pragma unroll
  for (int c = 0; c < D; ++c) {
    const bool finite = (__float_as_int(v[c]) & ABS_BITS) < INF_BITS;
    long long q = k >= 0 && finite ? __double2ll_rn((double)v[c] * scale)
                                   : 0;
    q = combine_peers(peers, q, AddOp());
    if (leader && q != 0) atomicAdd(out + c, (unsigned long long)q);
  }
}

// Pass C: one thread per output element.
template <int D>
__global__ void __launch_bounds__(256)
pass_c_kernel(const int2* __restrict__ meta, const int* __restrict__ cls,
              const long long* __restrict__ acc, long long total,
              float* __restrict__ out) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  const long long k = t / D;
  const int c = (int)(t % D);
  const int bits = (__ldg(cls + k) >> (3 * c)) & 7;
  float r;
  if ((bits & 1) || bits == 6) {
    r = __int_as_float(0x7fc00000);  // the quiet NaN PyTorch writes
  } else if (bits) {
    r = __int_as_float(bits == 2 ? INF_BITS : (int)0xff800000);
  } else {
    const int2 mk = __ldg(meta + k);
    if (mk.x == 0) {
      r = 0.0f;
    } else {
      const double x = __ll2double_rn(acc[t]) * pow2(-fixed_shift(mk));
      r = __double2float_rn(x);
    }
  }
  out[t] = r;
}

template <int D>
static void launch_ab(const int* idx, const float* upd, long long m,
                      int n_rows, int2* meta, int* cls,
                      unsigned long long* acc, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((m + threads - 1) / threads);
  pass_a_kernel<D><<<blocks, threads, 0, stream>>>(idx, upd, m, n_rows, meta,
                                                   cls);
  pass_b_kernel<D><<<blocks, threads, 0, stream>>>(idx, upd, m, n_rows, meta,
                                                   acc);
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// d is 2 or 8 (the wrapper checks). meta (n_rows x int2), cls (n_rows
// int32, in practice the tail of meta's buffer, so one memset zeroes both)
// and acc (n_rows x d int64) must be zero; out (n_rows x d f32) is written
// in full.
int scatter_accumulate_fixed(const int* idx, const float* upd, long long m,
                             int d, int n_rows, int* meta, int* cls,
                             long long* acc, float* out,
                             cudaStream_t stream) {
  if (n_rows <= 0) return (int)cudaGetLastError();
  int2* meta2 = reinterpret_cast<int2*>(meta);
  unsigned long long* acc_u = reinterpret_cast<unsigned long long*>(acc);
  if (m > 0) {
    if (d == 2)
      launch_ab<2>(idx, upd, m, n_rows, meta2, cls, acc_u, stream);
    else
      launch_ab<8>(idx, upd, m, n_rows, meta2, cls, acc_u, stream);
  }
  const long long total = (long long)n_rows * d;
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  if (d == 2)
    pass_c_kernel<2><<<blocks, threads, 0, stream>>>(meta2, cls, acc, total,
                                                      out);
  else
    pass_c_kernel<8><<<blocks, threads, 0, stream>>>(meta2, cls, acc, total,
                                                      out);
  return (int)cudaGetLastError();
}

}  // extern "C"
