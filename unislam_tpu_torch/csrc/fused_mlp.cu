// The fused decoder MLP (K4): bias-free in_dim -> 16 -> out with bf16
// operands and f32 accumulation, forward and backward, one or two heads on
// shared input features.
//
// Replaces unislam_tpu/models/decoders.py `mlp_apply`, bias-free branch
// (:72-88; the reference's tcnn FullyFusedMLP, `grid.tcnn_network: true`),
// and its VJP as JAX differentiates it. Rounding points, from the jaxpr:
//   forward:  xb = bf16(x); a = xb @ bf16(W0) (f32 sums of exact products);
//             h = bf16(max(a, 0)); o = h @ bf16(W1); t = tanh / sigmoid(o)
//   backward: d = tanh: w = g*(1-t), w + w*t; sigmoid: g*(t*(1-t)); none: g
//             dW1 = bf16(h^T d) (an f32 sum over all N points);
//             z = bf16(d @ bf16(W1)^T) * relu'(a), relu'(a) = 1 above 0,
//             0.5 at +-0 (JAX's max derivative), 0 below 0 or at NaN;
//             dW0 = bf16(xb^T z); g_x = bf16(z @ bf16(W0)^T), and with two
//             heads each head's bf16 g_x, added in f32.
//
// Design (a first version, right before fast): one thread per point, 128
// points a tile, the heads' bf16 weights in shared memory (read as
// broadcasts). A block stages its tile of x with coalesced loads.
// - fused_mlp_fwd: one tile a block; both heads in one launch write their
//   columns of one (N, out_cols) output.
// - fused_mlp_bwd: recomputes the forward from x (no saved activations);
//   each thread forms its point's g_x into a shared tile, written out with
//   coalesced stores. With weight gradients, the tile's z, h and d go to
//   shared memory too, and each thread owns a few weight-gradient elements
//   whose per-tile sums over the tile's points, in point order, it carries
//   in registers across the tiles of its block (a fixed number of blocks,
//   WG_BLOCKS, so the tiles a block takes depend on N only). A second
//   kernel sums the blocks' partials in a fixed tree and rounds to bf16. No
//   float atomics: two runs give the same bits.
//
// Bound on the H100: memory for the inputs and outputs (x, g_out, g_x: 96
// to 128 bytes a point each way); the arithmetic, a few hundred mul and
// add a point a head, runs on the CUDA cores in f32 here, so this version
// is instruction-bound (tensor cores, mma.sync on bf16, are for a later
// version).
//
// Built with -fmad=false: the activation derivatives and the products of
// f32 terms round as the plain PyTorch version's separate ops do.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define HID 16          // hidden width
#define MAX_IN 32       // input width, at most
#define MAX_OUT 4       // outputs of one head, at most
#define MAX_HEADS 2
#define PTS 128         // points a tile = threads a block
#define XS (MAX_IN + 1)  // row stride of the staged x / g_x tiles
#define HS (HID + 1)     // row stride of the staged z / h tiles
#define WG_BLOCKS 264    // blocks of the backward with weight gradients
// weight-gradient elements, at most: 2 heads x (32 x 16 + 16 x 4)
#define MAX_WG (MAX_HEADS * (MAX_IN * HID + HID * MAX_OUT))
#define OWN ((MAX_WG + PTS - 1) / PTS)   // owned by one thread, at most

enum { ACT_NONE = 0, ACT_TANH = 1, ACT_SIGMOID = 2 };

struct MlpHeads {
  int n_heads, in_dim, out_cols;
  int out_dim[MAX_HEADS], act[MAX_HEADS], col[MAX_HEADS];
  const float* w0[MAX_HEADS];   // (in_dim, 16) row-major
  const float* w1[MAX_HEADS];   // (16, out_dim) row-major
};

// shared memory, in floats
#define SM_W0 0
#define SM_W1 (SM_W0 + MAX_HEADS * MAX_IN * HID)
#define SM_X (SM_W1 + MAX_HEADS * HID * MAX_OUT)
#define SM_GX (SM_X + PTS * XS)
#define SM_Z (SM_GX + PTS * XS)
#define SM_H (SM_Z + MAX_HEADS * PTS * HS)
#define SM_D (SM_H + MAX_HEADS * PTS * HS)
#define SM_END (SM_D + MAX_HEADS * PTS * MAX_OUT)

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float relu(float a) {
  return a > 0.0f ? a : (a != a ? a : 0.0f);  // NaN stays NaN
}

__device__ __forceinline__ float activate(float o, int act) {
  if (act == ACT_TANH) return tanhf(o);
  if (act == ACT_SIGMOID) return 1.0f / (1.0f + expf(-o));
  return o;
}

// the heads' weights as bf16 values into shared memory
__device__ void load_weights(const MlpHeads& hd, float* sm) {
  for (int h = 0; h < hd.n_heads; ++h) {
    for (int e = threadIdx.x; e < hd.in_dim * HID; e += blockDim.x)
      sm[SM_W0 + h * MAX_IN * HID + e] = bf16r(hd.w0[h][e]);
    for (int e = threadIdx.x; e < HID * hd.out_dim[h]; e += blockDim.x)
      sm[SM_W1 + h * HID * MAX_OUT + e] = bf16r(hd.w1[h][e]);
  }
}

// rows [base, base + nval) of x, rounded to bf16, into the x tile
__device__ void load_tile(const float* __restrict__ x, int in, long long base,
                          int nval, float* sm) {
  for (int e = threadIdx.x; e < nval * in; e += blockDim.x) {
    int r = e / in;
    sm[SM_X + r * XS + (e - r * in)] = bf16r(x[base * in + e]);
  }
}

// one head's forward at one point: pre-activations a, bf16 hidden h,
// outputs t (after the activation)
__device__ __forceinline__ void head_forward(const float* xrow, int in,
                                             const float* w0,
                                             const float* w1, int od,
                                             int act, float a[HID],
                                             float h[HID],
                                             float t[MAX_OUT]) {
#pragma unroll
  for (int j = 0; j < HID; ++j) a[j] = 0.0f;
  for (int k = 0; k < in; ++k) {
    const float xk = xrow[k];
#pragma unroll
    for (int j = 0; j < HID; ++j) a[j] = a[j] + xk * w0[k * HID + j];
  }
#pragma unroll
  for (int j = 0; j < HID; ++j) h[j] = bf16r(relu(a[j]));
#pragma unroll
  for (int c = 0; c < MAX_OUT; ++c) {
    if (c < od) {
      float o = 0.0f;
#pragma unroll
      for (int j = 0; j < HID; ++j) o = o + h[j] * w1[j * od + c];
      t[c] = activate(o, act);
    }
  }
}

__global__ void __launch_bounds__(PTS)
    fused_mlp_fwd_kernel(const float* __restrict__ x, int n, MlpHeads hd,
                         float* __restrict__ out) {
  extern __shared__ float sm[];
  const long long base = (long long)blockIdx.x * PTS;
  const int nval = (int)min((long long)PTS, (long long)n - base);
  load_weights(hd, sm);
  load_tile(x, hd.in_dim, base, nval, sm);
  __syncthreads();
  const int tid = threadIdx.x;
  if (tid >= nval) return;
  float a[HID], h[HID], t[MAX_OUT];
  float* orow = out + (base + tid) * hd.out_cols;
  for (int hh = 0; hh < hd.n_heads; ++hh) {
    const int od = hd.out_dim[hh];
    head_forward(sm + SM_X + tid * XS, hd.in_dim,
                 sm + SM_W0 + hh * MAX_IN * HID,
                 sm + SM_W1 + hh * HID * MAX_OUT, od, hd.act[hh], a, h, t);
#pragma unroll
    for (int c = 0; c < MAX_OUT; ++c)
      if (c < od) orow[hd.col[hh] + c] = t[c];
  }
}

// owned weight-gradient element e -> (smem offset of A, of B, strides):
// dW0[k][j] = sum_q z[q][j] * xb[q][k]; dW1[j][c] = sum_q d[q][c] * h[q][j]
struct Owned {
  int a, b, sa, sb;
};

__device__ Owned owned_element(const MlpHeads& hd, int e) {
  Owned o;
  for (int hh = 0; hh < hd.n_heads; ++hh) {
    const int n0 = hd.in_dim * HID, n1 = HID * hd.out_dim[hh];
    if (e < n0) {
      const int k = e / HID, j = e - k * HID;
      o.a = SM_Z + hh * PTS * HS + j;
      o.sa = HS;
      o.b = SM_X + k;
      o.sb = XS;
      return o;
    }
    e -= n0;
    if (e < n1) {
      const int j = e / hd.out_dim[hh], c = e - j * hd.out_dim[hh];
      o.a = SM_D + hh * PTS * MAX_OUT + c;
      o.sa = MAX_OUT;
      o.b = SM_H + hh * PTS * HS + j;
      o.sb = HS;
      return o;
    }
    e -= n1;
  }
  return o;  // not reached: e < the element count
}

template <bool WGRAD>
__global__ void __launch_bounds__(PTS)
    fused_mlp_bwd_kernel(const float* __restrict__ x,
                         const float* __restrict__ g_out, int n, MlpHeads hd,
                         int n_wg, float* __restrict__ g_x,
                         float* __restrict__ partial) {
  extern __shared__ float sm[];
  const int tid = threadIdx.x, in = hd.in_dim;
  load_weights(hd, sm);
  float acc[OWN];
  Owned own[OWN];
  if (WGRAD) {
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      acc[i] = 0.0f;
      const int e = tid + i * PTS;
      if (e < n_wg) own[i] = owned_element(hd, e);
    }
  }
  const long long n_tiles = ((long long)n + PTS - 1) / PTS;
  for (long long tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const long long base = tile * PTS;
    const int nval = (int)min((long long)PTS, (long long)n - base);
    __syncthreads();   // the previous tile's shared data is consumed
    load_tile(x, in, base, nval, sm);
    __syncthreads();
    if (tid < nval) {
      float a[HID], h[HID], t[MAX_OUT], d[MAX_OUT], z[HID];
      const float* grow = g_out + (base + tid) * hd.out_cols;
      float* gxrow = sm + SM_GX + tid * XS;
      for (int hh = 0; hh < hd.n_heads; ++hh) {
        const int od = hd.out_dim[hh], act = hd.act[hh];
        const float* w0 = sm + SM_W0 + hh * MAX_IN * HID;
        const float* w1 = sm + SM_W1 + hh * HID * MAX_OUT;
        head_forward(sm + SM_X + tid * XS, in, w0, w1, od, act, a, h, t);
#pragma unroll
        for (int c = 0; c < MAX_OUT; ++c) {
          if (c < od) {
            const float g = grow[hd.col[hh] + c];
            if (act == ACT_TANH) {
              const float w = g * (1.0f - t[c]);
              d[c] = w + w * t[c];
            } else if (act == ACT_SIGMOID) {
              d[c] = g * (t[c] * (1.0f - t[c]));
            } else {
              d[c] = g;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < HID; ++j) {
          float gh = 0.0f;
#pragma unroll
          for (int c = 0; c < MAX_OUT; ++c)
            if (c < od) gh = gh + d[c] * w1[j * od + c];
          const float mask = a[j] > 0.0f ? 1.0f : (a[j] == 0.0f ? 0.5f : 0.0f);
          z[j] = bf16r(gh) * mask;
        }
        for (int k = 0; k < in; ++k) {
          float s = 0.0f;
#pragma unroll
          for (int j = 0; j < HID; ++j) s = s + z[j] * w0[k * HID + j];
          gxrow[k] = hh == 0 ? bf16r(s) : gxrow[k] + bf16r(s);
        }
        if (WGRAD) {
          float* zr = sm + SM_Z + hh * PTS * HS + tid * HS;
          float* hr = sm + SM_H + hh * PTS * HS + tid * HS;
#pragma unroll
          for (int j = 0; j < HID; ++j) {
            zr[j] = z[j];
            hr[j] = h[j];
          }
#pragma unroll
          for (int c = 0; c < MAX_OUT; ++c)
            if (c < od) sm[SM_D + hh * PTS * MAX_OUT + tid * MAX_OUT + c] = d[c];
        }
      }
    }
    __syncthreads();
    // the tile's g_x rows, coalesced
    for (int e = tid; e < nval * in; e += PTS) {
      const int r = e / in;
      g_x[base * in + e] = sm[SM_GX + r * XS + (e - r * in)];
    }
    if (WGRAD) {
#pragma unroll
      for (int i = 0; i < OWN; ++i) {
        if (tid + i * PTS < n_wg) {
          const Owned o = own[i];
          float s = 0.0f;
          for (int q = 0; q < nval; ++q)
            s = s + sm[o.a + q * o.sa] * sm[o.b + q * o.sb];
          acc[i] = acc[i] + s;
        }
      }
    }
  }
  if (WGRAD) {
#pragma unroll
    for (int i = 0; i < OWN; ++i) {
      const int e = tid + i * PTS;
      if (e < n_wg) partial[(long long)blockIdx.x * n_wg + e] = acc[i];
    }
  }
}

// dw[e] = bf16(sum over the blocks' partials), in a fixed order: thread
// (x, y) sums blocks y, y + 8, ... of element 32 * blockIdx.x + x, then
// the 8 sums are added in order of y
__global__ void fused_mlp_wgrad_reduce(const float* __restrict__ partial,
                                       int n_blocks, int n_wg,
                                       float* __restrict__ dw) {
  __shared__ float part[8][33];
  const int e = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (e < n_wg)
    for (int b = threadIdx.y; b < n_blocks; b += 8)
      s = s + partial[(long long)b * n_wg + e];
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && e < n_wg) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < 8; ++y) t = t + part[y][threadIdx.x];
    dw[e] = bf16r(t);
  }
}

static int smem_bytes(bool bwd, bool wgrad) {
  return (int)sizeof(float) * (wgrad ? SM_END : bwd ? SM_Z : SM_GX);
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out (n, hd->out_cols); returns cudaGetLastError() after the launch
int fused_mlp_fwd(const float* x, int n, const MlpHeads* hd, float* out,
                  cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int blocks = (n + PTS - 1) / PTS;
  fused_mlp_fwd_kernel<<<blocks, PTS, smem_bytes(false, false), stream>>>(
      x, n, *hd, out);
  return (int)cudaGetLastError();
}

// The number of weight-gradient blocks for n points (the partials' rows).
int fused_mlp_wgrad_blocks(int n) {
  const int tiles = (n + PTS - 1) / PTS;
  return tiles < WG_BLOCKS ? tiles : WG_BLOCKS;
}

// g_x (n, in_dim). With dw not null: the weight gradients, packed per head
// as dW0 (in_dim, 16) then dW1 (16, out_dim), n_wg values in all, through
// `partial` (fused_mlp_wgrad_blocks(n) x n_wg floats of scratch).
int fused_mlp_bwd(const float* x, const float* g_out, int n,
                  const MlpHeads* hd, float* g_x, float* partial, float* dw,
                  int n_wg, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  const int tiles = (n + PTS - 1) / PTS;
  if (dw == nullptr) {
    fused_mlp_bwd_kernel<false><<<tiles, PTS, smem_bytes(true, false),
                                   stream>>>(x, g_out, n, *hd, 0, g_x,
                                             nullptr);
    return (int)cudaGetLastError();
  }
  static bool attr_set = false;
  if (!attr_set) {
    cudaFuncSetAttribute(fused_mlp_bwd_kernel<true>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes(true, true));
    attr_set = true;
  }
  const int blocks = fused_mlp_wgrad_blocks(n);
  fused_mlp_bwd_kernel<true><<<blocks, PTS, smem_bytes(true, true),
                               stream>>>(x, g_out, n, *hd, n_wg, g_x,
                                         partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  fused_mlp_wgrad_reduce<<<(n_wg + 31) / 32, dim3(32, 8), 0, stream>>>(
      partial, blocks, n_wg, dw);
  return (int)cudaGetLastError();
}

}  // extern "C"
