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
// The kernel writes dW0 and dW1 as the f32 sums; their bf16 rounding is
// the caller's (Mapper.backward), after a data-parallel run's ranks have
// summed their parts.
//
// Bound on the H100: memory. The work is about 16 flops a byte moved (x,
// g_out and g_x: 96 to 128 bytes a point each way), far below the 295 a
// byte at which the bf16 tensor cores would bound it.
//
// Design: the products with K = 16 or more run on the tensor cores
// (mma.sync m16n8k16, bf16 in, f32 accumulate): xb @ W0, z @ W0^T and
// xb^T z. The three narrow ones (16 x out multiply-adds a point) stay in
// f32 on the CUDA cores: g_h = d @ bf16(W1)^T and dW1 = h^T d, since a bf16
// operand d would be a rounding point the reference does not have, and
// o = h @ bf16(W1) (below). A warp takes a tile of 16 points (the mma's
// m16) at a time:
// - the tile's x and g_out are copied by cp.async into the warp's ring of
//   STAGES staged tiles, so the next tile's copies are in flight while one
//   computes and no register holds them. A tile of x (16 rows of in_dim
//   floats) is one contiguous block: where in_dim is a multiple of 4 it
//   moves as 16-byte chunks, whole lines a warp, and g_x goes out the same
//   way through the spent stage (streaming stores); otherwise one lane a
//   column of each row. The A fragments of xb @ W0 are rounded to bf16
//   from the staged f32 rows;
// - a = xb @ W0: two k16 steps (in_dim padded with zeros to 32) into two n8
//   accumulator tiles (the 16 hidden units); ReLU and the bf16 rounding in
//   registers, h into the warp's h tile;
// - o = h @ W1 (16 x out multiply-adds a point) in f32 on the CUDA cores,
//   each sum in hidden-unit order as the plain version's: near a sigmoid's
//   saturation d = g t (1 - t) follows the last bits of that cancelling
//   sum, where the tensor core's order would move z by a bf16 step;
// - backward: recomputes the forward (no saved activations); the lane
//   that owns an output forms its d into the warp's d tile; each lane forms
//   g_h for its four hidden units of two rows, the places of a's
//   accumulators, which are an A fragment's: z = bf16(g_h) * relu'(a), a
//   bf16 value, converted to bf16 pairs is the A fragment of g_x =
//   z @ W0^T, up to four mma a head;
// - weight gradients: dW0 = xb^T z is an mma with K = the tile's 16
//   points, A = xb^T and B = z from the warp's shared tiles by
//   ldmatrix.trans, accumulated in f32 across the warp's tiles; dW1 = h^T d
//   in f32, each lane owning two of a head's 16 x out elements (a sum over
//   the tile's points in order, added to its running sum). The warps'
//   sums meet in a fixed tree in shared memory, one partial a block; the
//   blocks are a fixed number (fused_mlp_wgrad_blocks: N alone sets the
//   tiles a warp takes), and a second kernel sums the partials in a fixed
//   order and rounds to bf16. No float atomics: two runs give the same bits.
// The forward and the backward without weight gradients take as many
// blocks as stay resident (or fewer), each warp looping over its tiles.
// The weights are staged once a block in shared memory as bf16, laid out so
// that every fragment is one 32-bit load (rows padded against bank
// conflicts). The tensor core sums a k16 step in its own order, so a hidden
// unit or a gradient can round one bf16 step from the plain version's; the
// check (chip_smoke.k4_misfit) admits that and not a missing rounding point.
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
#define WARPS 8         // warps a block
#define THREADS (WARPS * 32)
#define TILE 16         // points a warp tile
#define WG_BLOCKS 264   // blocks of the backward with weight gradients, at most
#define STAGES 2        // a warp's ring of staged tiles: one in flight
// weight-gradient elements, at most: 2 heads x (32 x 16 + 16 x 4)
#define MAX_WG (MAX_HEADS * (MAX_IN * HID + HID * MAX_OUT))
// row strides of the shared tiles, padded so that a warp's fragment loads
// fall on distinct banks and ldmatrix rows on 16 bytes
#define FS 40           // staged f32 x tile (16 x 32), in floats
#define XS 40           // bf16 x tile (16 x 32), in bf16 elements
#define ZS 24           // z and h tiles (16 x 16)
#define W0S 24          // W0 (32 x 16)
#define W0TS 40         // W0^T (16 x 32)

enum { ACT_NONE = 0, ACT_TANH = 1, ACT_SIGMOID = 2 };

struct MlpHeads {
  int n_heads, in_dim, out_cols;
  int out_dim[MAX_HEADS], act[MAX_HEADS], col[MAX_HEADS];
  const float* w0[MAX_HEADS];   // (in_dim, 16) row-major
  const float* w1[MAX_HEADS];   // (16, out_dim) row-major
};

typedef __nv_bfloat16 bf16;

// a tile as read (cp.async): x rows, zeros past in_dim and past N, and the
// g_out rows
struct Stage {
  float x[TILE][FS];
  float g[TILE * MAX_HEADS * MAX_OUT];
};

struct WarpTile {
  bf16 x[TILE][XS];             // xb (weight gradients)
  bf16 z[TILE][ZS];             // one head's z (weight gradients)
  bf16 h[TILE][ZS];             // one head's h
  float d[TILE][MAX_OUT];       // one head's d (backward)
};

struct __align__(16) Smem {
  bf16 w0[MAX_HEADS][MAX_IN][W0S];    // bf16(W0), zero rows past in_dim
  bf16 w0t[MAX_HEADS][HID][W0TS];     // its transpose
  float w1[MAX_HEADS][HID][MAX_OUT];  // bf16(W1) as f32, zero past out
  WarpTile tile[WARPS];
  union {
    Stage ring[WARPS][STAGES];
    float red[WARPS][MAX_WG];         // the warps' weight-gradient sums
  } u;
};

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

// two values as one bf16x2 register, lo in the low half (exact for values
// that are bf16 already)
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, f32 accumulate
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// four transposed 8 x 8 bf16 matrices; lane l names row l % 8 of matrix
// l / 8
__device__ __forceinline__ void ldmatrix_t(uint32_t r[4], const bf16* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a)
      : "memory");
}

// a 4-byte cp.async, zero-filled where not valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(d), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// a 16-byte cp.async, zero-filled where not valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(d), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ const float* pick(const float* const* p, int h) {
  return h == 0 ? p[0] : p[1];
}

// the heads' weights as bf16 into shared memory, in the fragments' layouts
__device__ __forceinline__ void load_weights(const MlpHeads& hd, Smem& s) {
#pragma unroll
  for (int e = threadIdx.x; e < MAX_HEADS * MAX_IN * HID; e += THREADS) {
    const int h = e / (MAX_IN * HID), k = (e / HID) % MAX_IN, j = e % HID;
    const float v = h < hd.n_heads && k < hd.in_dim
                        ? pick(hd.w0, h)[k * HID + j] : 0.0f;
    const bf16 b = __float2bfloat16_rn(v);
    s.w0[h][k][j] = b;
    s.w0t[h][j][k] = b;
  }
#pragma unroll
  for (int e = threadIdx.x; e < MAX_HEADS * HID * MAX_OUT; e += THREADS) {
    const int h = e / (HID * MAX_OUT), j = (e / MAX_OUT) % HID,
              c = e % MAX_OUT;
    const int od = h == 0 ? hd.out_dim[0] : hd.out_dim[1];
    s.w1[h][j][c] = h < hd.n_heads && c < od
                        ? bf16r(pick(hd.w1, h)[j * od + c]) : 0.0f;
  }
}

// A tile of x (16 rows of in_dim floats) is one contiguous block. Where
// in_dim is a multiple of 4 and the arrays start on 16 bytes, the lanes
// move it as 16-byte chunks, chunk f = lane + 32 i (whole lines a warp);
// Chunks holds each chunk's row and column, the same for every tile.
struct Chunks {
  bool vec;
  int row[4], col[4];
};

__device__ __forceinline__ Chunks chunks_of(int in, int lane, bool aligned) {
  Chunks c;
  c.vec = aligned && (in & 3) == 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = 4 * (lane + 32 * i);
    c.row[i] = c.vec && e < TILE * in ? e / in : TILE;   // TILE: no chunk
    c.col[i] = c.vec ? e - (e / in) * in : 0;
  }
  return c;
}

// Start the copies of a tile into a stage: x by chunks or, without them,
// each row by the lanes, one a column (coalesced); and the tile's g_out
// values (backward). Rows past N are zero-filled.
__device__ __forceinline__ void issue_tile(const float* __restrict__ x,
                                           const float* __restrict__ g_out,
                                           int n, int in, int oc, int tile,
                                           int lane, const Chunks& ck,
                                           Stage& st) {
  const long long base = (long long)tile * TILE;
  const int nval = (int)min((long long)TILE, (long long)n - base);
  if (ck.vec) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (ck.row[i] < TILE) {
        const bool v = ck.row[i] < nval;
        cp_async16(&st.x[ck.row[i]][ck.col[i]],
                   v ? x + base * in + 4 * (lane + 32 * i) : x, v);
      }
    }
  } else {
#pragma unroll
    for (int p = 0; p < TILE; ++p) {
      const bool v = lane < in && p < nval;
      cp_async4(&st.x[p][lane], v ? x + (base + p) * in + lane : x, v);
    }
  }
  if (g_out) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int e = lane + 32 * i;
      const bool v = e < nval * oc;
      cp_async4(&st.g[e], v ? g_out + base * oc + e : g_out, v);
    }
  }
}

// One head's hidden layer on the warp's tile: pre-activations a (two n8
// accumulator tiles: hidden units 0-7, 8-15), and h into the warp's h tile.
__device__ __forceinline__ void head_hidden(const Smem& s, int hh,
                                            const uint32_t ax[2][4], int g,
                                            int t, WarpTile& w,
                                            float a[2][4]) {
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int i = 0; i < 4; ++i) a[nt][i] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < 2; ++ks)
      mma(a[nt], ax[ks], ld32(&s.w0t[hh][nt * 8 + g][ks * 16 + 2 * t]),
          ld32(&s.w0t[hh][nt * 8 + g][ks * 16 + 8 + 2 * t]));
  }
  // accumulator places: (row g, units 2t, 2t+1), (row g+8, ..), then the
  // same at units 8 + 2t, 9 + 2t
  *reinterpret_cast<uint32_t*>(&w.h[g][2 * t]) =
      pack(relu(a[0][0]), relu(a[0][1]));
  *reinterpret_cast<uint32_t*>(&w.h[g + 8][2 * t]) =
      pack(relu(a[0][2]), relu(a[0][3]));
  *reinterpret_cast<uint32_t*>(&w.h[g][8 + 2 * t]) =
      pack(relu(a[1][0]), relu(a[1][1]));
  *reinterpret_cast<uint32_t*>(&w.h[g + 8][8 + 2 * t]) =
      pack(relu(a[1][2]), relu(a[1][3]));
  __syncwarp();
}

// o = h @ bf16(W1) for the outputs this lane owns: row p = lane % 16,
// columns c = lane / 16 and c + 2 below od. In f32 on the CUDA cores, each
// a sum over the hidden units in order from 0, as the plain version's
// product rounds: near a sigmoid's saturation d = g t (1 - t) follows the
// last bits of o, a sum of 16 terms that can cancel, where the tensor
// core's sum (closer to an f64 sum there) moves z by a bf16 step.
__device__ __forceinline__ void head_out(const Smem& s, int hh,
                                         const WarpTile& w, int lane, int od,
                                         float o[2]) {
  const int p = lane & 15, c0 = lane >> 4;
  float h[HID];
#pragma unroll
  for (int j = 0; j < HID; j += 2) {
    const uint32_t v = ld32(&w.h[p][j]);
    h[j] = __uint_as_float(v << 16);
    h[j + 1] = __uint_as_float(v & 0xffff0000u);
  }
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const int c = c0 + 2 * m;
    o[m] = 0.0f;
    if (c < od) {
#pragma unroll
      for (int j = 0; j < HID; ++j) o[m] = o[m] + h[j] * s.w1[hh][j][c];
    }
  }
}

// xb @ W0's A fragments, rounded to bf16 from the staged f32 tile
__device__ __forceinline__ void x_fragments(const Stage& st, int g, int t,
                                            uint32_t ax[2][4]) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 v = *reinterpret_cast<const float2*>(
          &st.x[g + (i & 1) * 8][ks * 16 + (i >> 1) * 8 + 2 * t]);
      ax[ks][i] = pack(v.x, v.y);
    }
}

// One kernel for the three calls: the forward (BWD false), the backward
// without (WGRAD false) and with the weight gradients. A warp takes tiles
// blockIdx.x * WARPS + warp, then every gridDim.x * WARPS on, through its
// ring of STAGES staged tiles.
template <bool BWD, bool WGRAD>
__global__ void __launch_bounds__(THREADS, 2)
    fused_mlp_kernel(const float* __restrict__ x,
                     const float* __restrict__ g_out, int n, MlpHeads hd,
                     int n_wg, float* __restrict__ out,
                     float* __restrict__ partial) {
  extern __shared__ __align__(16) unsigned char smem[];
  Smem& s = *reinterpret_cast<Smem*>(smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3, in = hd.in_dim, oc = hd.out_cols;
  const int p = lane & 15, c0 = lane >> 4;   // head_out's outputs
  const int n_tiles = (n + TILE - 1) / TILE;
  const int stride = gridDim.x * WARPS;
  const float* gsrc = BWD ? g_out : nullptr;
  Stage* ring = s.u.ring[warp];
  const Chunks ck = chunks_of(
      in, lane, (((size_t)x | (BWD ? (size_t)out : 0)) & 15) == 0);
  if (ck.vec) {   // the columns past in_dim, which no chunk writes
#pragma unroll
    for (int k = 0; k < STAGES; ++k)
#pragma unroll
      for (int r = 0; r < TILE; ++r)
        if (lane >= in) ring[k].x[r][lane] = 0.0f;
  }
  int tile = blockIdx.x * WARPS + warp;
#pragma unroll
  for (int k = 0; k < STAGES - 1; ++k) {
    if (tile + k * stride < n_tiles)
      issue_tile(x, gsrc, n, in, oc, tile + k * stride, lane, ck, ring[k]);
    cp_async_commit();
  }
  load_weights(hd, s);
  __syncthreads();
  WarpTile& w = s.tile[warp];
  // the weight-gradient sums: dW0 fragments (k' tiles of 16 x j tiles of
  // 8), and the two dW1 elements a lane owns
  float dw0[MAX_HEADS][2][2][4], dw1[MAX_HEADS][2];
  if (WGRAD) {
#pragma unroll
    for (int hh = 0; hh < MAX_HEADS; ++hh) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) dw0[hh][mt][nt][i] = 0.0f;
      dw1[hh][0] = dw1[hh][1] = 0.0f;
    }
  }
  for (int cur = 0; tile < n_tiles; tile += stride) {
    // the tile STAGES - 1 on goes into the slot the previous tile used
    const int next = tile + (STAGES - 1) * stride;
    if (next < n_tiles)
      issue_tile(x, gsrc, n, in, oc, next, lane, ck,
                 ring[cur == 0 ? STAGES - 1 : cur - 1]);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();   // this tile's copies are done
    __syncwarp();
    Stage& st = ring[cur];
    cur = cur + 1 == STAGES ? 0 : cur + 1;
    const long long base = (long long)tile * TILE;
    const int nval = (int)min((long long)TILE, (long long)n - base);
    uint32_t ax[2][4];
    x_fragments(st, g, t, ax);
    if (WGRAD) {
#pragma unroll
      for (int r = 0; r < TILE; ++r)
        w.x[r][lane] = __float2bfloat16_rn(st.x[r][lane]);
    }
    float gx[4][4];   // g_x: four n8 tiles of input columns
#pragma unroll
    for (int hh = 0; hh < MAX_HEADS; ++hh) {
      if (hh >= hd.n_heads) break;
      const int od = hd.out_dim[hh], act = hd.act[hh], col = hd.col[hh];
      float a[2][4], o[2];
      head_hidden(s, hh, ax, g, t, w, a);
      head_out(s, hh, w, lane, od, o);
      if (!BWD) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          const int c = c0 + 2 * m;
          if (p < nval && c < od)
            out[(base + p) * oc + col + c] = activate(o[m], act);
        }
        __syncwarp();   // the next head rewrites the h tile
        continue;
      }
      // d of this lane's outputs into the warp's d tile (0 past N)
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int c = c0 + 2 * m;
        if (c < od) {
          float d = 0.0f;
          if (p < nval) {
            const float tv = activate(o[m], act);
            const float gv = st.g[p * oc + col + c];
            if (act == ACT_TANH) {
              const float wv = gv * (1.0f - tv);
              d = wv + wv * tv;
            } else if (act == ACT_SIGMOID) {
              d = gv * (tv * (1.0f - tv));
            } else {
              d = gv;
            }
          }
          w.d[p][c] = d;
        }
      }
      __syncwarp();
      // z at hidden units 2t, 2t+1, 2t+8, 2t+9 of rows g, g+8 (a's
      // accumulator places, which are an A fragment's)
      float zv[2][4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = 2 * t + (u & 1) + (u >> 1) * 8;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float gh = 0.0f;
#pragma unroll
          for (int c = 0; c < MAX_OUT; ++c)
            if (c < od) gh = gh + w.d[g + 8 * r][c] * s.w1[hh][j][c];
          const float av = a[u >> 1][2 * r + (u & 1)];
          const float mask = av > 0.0f ? 1.0f : (av == 0.0f ? 0.5f : 0.0f);
          zv[r][u] = bf16r(gh) * mask;
        }
      }
      uint32_t zA[4];
      zA[0] = pack(zv[0][0], zv[0][1]);
      zA[1] = pack(zv[1][0], zv[1][1]);
      zA[2] = pack(zv[0][2], zv[0][3]);
      zA[3] = pack(zv[1][2], zv[1][3]);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt * 8 >= in) break;
        float c4[4] = {0.0f, 0.0f, 0.0f, 0.0f};
        mma(c4, zA, ld32(&s.w0[hh][nt * 8 + g][2 * t]),
            ld32(&s.w0[hh][nt * 8 + g][8 + 2 * t]));
#pragma unroll
        for (int i = 0; i < 4; ++i)
          gx[nt][i] = hh == 0 ? bf16r(c4[i]) : gx[nt][i] + bf16r(c4[i]);
      }
      if (WGRAD) {
        *reinterpret_cast<uint32_t*>(&w.z[g][2 * t]) = zA[0];
        *reinterpret_cast<uint32_t*>(&w.z[g + 8][2 * t]) = zA[1];
        *reinterpret_cast<uint32_t*>(&w.z[g][8 + 2 * t]) = zA[2];
        *reinterpret_cast<uint32_t*>(&w.z[g + 8][8 + 2 * t]) = zA[3];
        __syncwarp();
        // dW0 += xb^T z: A = xb^T from the x tile, B = z, K = the points
        const int mi = lane >> 3, mr = lane & 7;
        uint32_t zb[4];
        ldmatrix_t(zb, &w.z[mr + (mi & 1) * 8][(mi >> 1) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt * 16 >= in) break;
          uint32_t xa[4];
          ldmatrix_t(xa, &w.x[mr + (mi >> 1) * 8][mt * 16 + (mi & 1) * 8]);
          mma(dw0[hh][mt][0], xa, zb[0], zb[1]);
          mma(dw0[hh][mt][1], xa, zb[2], zb[3]);
        }
        // dW1 += h^T d: this lane's elements e = lane, lane + 32
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = lane + 32 * i;
          if (e < HID * od) {
            const int j = e / od, c = e - j * od;
            float sum = 0.0f;
#pragma unroll
            for (int pp = 0; pp < TILE; ++pp)
              sum = sum + __bfloat162float(w.h[pp][j]) * w.d[pp][c];
            dw1[hh][i] = dw1[hh][i] + sum;
          }
        }
      }
      __syncwarp();   // the next head rewrites the h, d (and z) tiles
    }
    if (BWD && ck.vec) {
      // the tile's g_x through the spent stage's x rows, out by chunks
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt * 8 >= in) break;
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<float2*>(&st.x[g + 8 * r][nt * 8 + 2 * t]) =
              make_float2(gx[nt][2 * r], gx[nt][2 * r + 1]);
      }
      __syncwarp();
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (ck.row[i] < nval)   // streaming: no reuse in L2
          __stcs(reinterpret_cast<float4*>(out + base * in +
                                           4 * (lane + 32 * i)),
                 *reinterpret_cast<const float4*>(
                     &st.x[ck.row[i]][ck.col[i]]));
      }
    } else if (BWD) {   // the tile's g_x from the fragments
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        if (nt * 8 >= in) break;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int row = g + (i >> 1) * 8, c = nt * 8 + 2 * t + (i & 1);
          if (row < nval && c < in) out[(base + row) * in + c] = gx[nt][i];
        }
      }
    }
    __syncwarp();   // the next copies rewrite this stage
  }
  if (!WGRAD) return;
  // the block's partial: each warp's sums into shared memory, then a fixed
  // tree over the warps
  cp_async_wait<0>();
  __syncthreads();
  int off = 0;
#pragma unroll
  for (int hh = 0; hh < MAX_HEADS; ++hh) {
    if (hh >= hd.n_heads) break;
    const int od = hd.out_dim[hh];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = mt * 16 + g + (i >> 1) * 8;
          const int j = nt * 8 + 2 * t + (i & 1);
          if (k < in) s.u.red[warp][off + k * HID + j] = dw0[hh][mt][nt][i];
        }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int e = lane + 32 * i;
      if (e < HID * od) s.u.red[warp][off + in * HID + e] = dw1[hh][i];
    }
    off += in * HID + HID * od;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < n_wg; e += THREADS) {
    float v[WARPS];
#pragma unroll
    for (int i = 0; i < WARPS; ++i) v[i] = s.u.red[i][e];
#pragma unroll
    for (int m = WARPS / 2; m > 0; m >>= 1)
#pragma unroll
      for (int i = 0; i < m; ++i) v[i] = v[2 * i] + v[2 * i + 1];
    partial[(long long)blockIdx.x * n_wg + e] = v[0];
  }
}

// dw[e] = the sum over the blocks' partials, in a fixed order: thread
// (x, y) sums blocks y, y + 8, ... of element 32 * blockIdx.x + x, then
// the 8 sums are added in order of y. The f32 sum is stored unrounded:
// the caller rounds it to bf16 once a data-parallel run's ranks have
// summed theirs (Mapper.backward), as one rank rounds the whole batch's.
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
    dw[e] = t;
  }
}

static int n_tile_blocks(int n) {
  const int tiles = (n + TILE - 1) / TILE;
  return (tiles + WARPS - 1) / WARPS;
}

// Once a kernel: allow its shared memory (over the 48 KB default), and the
// number of its blocks the card holds resident.
template <bool BWD, bool WGRAD>
static int resident_blocks() {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaFuncSetAttribute(fused_mlp_kernel<BWD, WGRAD>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                         (int)sizeof(Smem));
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, fused_mlp_kernel<BWD, WGRAD>, THREADS, sizeof(Smem));
    resident = sms * (per_sm > 0 ? per_sm : 1);
  }
  return resident;
}

// The grid of the forward and the backward without weight gradients: a
// tile a warp, or as many blocks as stay resident, each warp then looping
// over its tiles. (Each output is one warp's arithmetic, so the grid does
// not change a bit of it.)
template <bool BWD>
static int resident_grid(int n) {
  const int blocks = n_tile_blocks(n), resident = resident_blocks<BWD, false>();
  return blocks < resident ? blocks : resident;
}

extern "C" {

const char* unislam_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

// out (n, hd->out_cols); returns cudaGetLastError() after the launch
int fused_mlp_fwd(const float* x, int n, const MlpHeads* hd, float* out,
                  cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  fused_mlp_kernel<false, false><<<resident_grid<false>(n), THREADS,
                                   sizeof(Smem), stream>>>(
      x, nullptr, n, *hd, 0, out, nullptr);
  return (int)cudaGetLastError();
}

// The number of weight-gradient blocks for n points (the partials' rows).
int fused_mlp_wgrad_blocks(int n) {
  const int blocks = n_tile_blocks(n);
  return blocks < WG_BLOCKS ? blocks : WG_BLOCKS;
}

// g_x (n, in_dim). With dw not null: the weight gradients, packed per head
// as dW0 (in_dim, 16) then dW1 (16, out_dim), n_wg values in all, through
// `partial` (fused_mlp_wgrad_blocks(n) x n_wg floats of scratch), as f32
// sums (not rounded to bf16).
int fused_mlp_bwd(const float* x, const float* g_out, int n,
                  const MlpHeads* hd, float* g_x, float* partial, float* dw,
                  int n_wg, cudaStream_t stream) {
  if (n <= 0) return (int)cudaGetLastError();
  if (dw == nullptr) {
    fused_mlp_kernel<true, false><<<resident_grid<true>(n), THREADS,
                                    sizeof(Smem), stream>>>(
        x, g_out, n, *hd, 0, g_x, nullptr);
    return (int)cudaGetLastError();
  }
  const int blocks = fused_mlp_wgrad_blocks(n);
  resident_blocks<true, true>();
  fused_mlp_kernel<true, true><<<blocks, THREADS, sizeof(Smem), stream>>>(
      x, g_out, n, *hd, n_wg, g_x, partial);
  int err = (int)cudaGetLastError();
  if (err != 0) return err;
  fused_mlp_wgrad_reduce<<<(n_wg + 31) / 32, dim3(32, 8), 0, stream>>>(
      partial, blocks, n_wg, dw);
  return (int)cudaGetLastError();
}

}  // extern "C"
