// Flash-attention backward for Hopper (sm_90a), fp32 and bf16: the dq kernel
// and the dk/dv kernel.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py:345 _flash_bwd_dq_kernel
// and :376 _flash_bwd_dkv_kernel, the two Pallas TPU kernels launched by
// _flash_bwd. For q, dO [b, sq, h, d] and k, v [b, sk, h, d] (any batch,
// sequence and head strides; d contiguous, d <= 128), the forward's lse and
// delta = rowsum(dO * O), both [b*h, sq] fp32, and the lse cotangent glse
// (same shape, or null for zeros) they compute, with the arithmetic of the
// Pallas _bwd_block:
//   s  = (q . k) * sm_scale         fp32 dot of the widened inputs, then one
//                                   fp32 multiply by sm_scale = 1/sqrt(d)
//   p  = exp(s - lse)               and p = 0 for a masked key: keys at or
//                                   past sk, and with `causal` keys past
//                                   q_row + (sk - sq) (bottom-right causal)
//   dp = dO . v                     fp32 dot of the widened inputs
//   ds = p * (dp - delta + glse) * sm_scale
//   dq = sum_k round(ds) . k        (dq kernel)
//   dv = sum_q round(p)^T . dO      (dk/dv kernel)
//   dk = sum_q round(ds)^T . q      (dk/dv kernel)
// round() is the inputs' dtype (bf16 rounds to nearest even, fp32 is exact);
// the sums are fp32 and the outputs dq [b, sq, h, d] and dk, dv [b, sk, h,
// d] are contiguous in the inputs' dtype. The Pallas kernel lets a masked
// key reach exp(-1e30 - lse); here p is zeroed, so a query row that sees no
// key (causal, sq > sk; the forward gives it o = 0 and lse = -1e30) gets
// dq = 0 and adds nothing to dk or dv. Tiles that lie wholly in the masked
// future are skipped, as the Pallas kernels' `live` does. The two kernels
// split the work as the Pallas pair does, dq over key tiles with the query
// tile resident and dk/dv over query tiles with the key tile resident, so
// no sum crosses CTAs: no atomics, and two runs give the same bits.
//
// Bound: operations in fp32, bytes in bf16. dq does 6*d flops per visible
// (query, key) pair (q.k, dO.v, ds.k) and dk/dv 8*d (q.k, dO.v, p.dO,
// ds.q); dq moves q, k, v, dO and dq once, dk/dv q, k, v, dO, dk and dv.
// At the BERT fine-tuning shape (b*h = 384, s = 128, d = 64) that is 2.42
// and 3.22 GFLOP against 31 and 38 MB in bf16.
// Design (simple, not yet fast): 128 threads per CTA, 64 x 64 tiles staged
// in dynamic shared memory as fp32 with rows padded by 4 floats (16-byte
// reads of a warp hit distinct banks). Each thread computes 4 x 8 entries
// of the score and dP tiles with fp32 FMAs on CUDA cores, writes round(ds)
// (and round(p)) to shared memory, and after a barrier adds its 4 rows x
// d/8 columns of the products into fp32 registers. No tensor cores, TMA or
// pipelining yet (later work). Shared memory passes 48 KB (87 KB for dq and
// 105 KB for dk/dv at d = 64), so each launch raises the kernel's dynamic
// shared-memory limit first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kThreads = 128;  // 16 x 8 threads: ty owns 4 rows, tx 8 columns
constexpr int kP = kTile + 4;  // row stride of the ds / p tiles

struct Strides {  // in elements; the head dim has stride 1
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// x rounded to T and widened back (ds.astype(q.dtype) of the Pallas body)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int DMAX>
struct Layout {
  static constexpr int kLd = DMAX + 4;  // row stride of the staged tiles
  // dq: q, dO, k, v tiles and the ds tile
  static constexpr int kDqBytes =
      (4 * kTile * kLd + kTile * kP) * (int)sizeof(float);
  // dk/dv: k, v, q, dO tiles, the p and ds tiles, lse, delta, glse
  static constexpr int kDkvBytes =
      (4 * kTile * kLd + 2 * kTile * kP + 3 * kTile) * (int)sizeof(float);
};

// Rows [row0, row0 + 64) of a [rows, d] slab with `row_stride`, widened to
// fp32 into shared memory with row stride `ld`; rows past n_rows and
// columns past d are zero (they then add exact zeros).
template <typename T, int DMAX>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int n_rows, int d) {
  constexpr int kGroups = DMAX / 4;
  for (int g = threadIdx.x; g < kTile * kGroups; g += kThreads) {
    const int r = g / kGroups;
    const int c = (g % kGroups) * 4;
    const int row = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < n_rows) {
      const T* p = src + (long long)row * row_stride + c;
      if (c + 0 < d) val.x = to_f32(p[0]);
      if (c + 1 < d) val.y = to_f32(p[1]);
      if (c + 2 < d) val.z = to_f32(p[2]);
      if (c + 3 < d) val.w = to_f32(p[3]);
    }
    *reinterpret_cast<float4*>(dst + r * ld + c) = val;
  }
}

// out[i][j] = sum_c A[ty + 16 i][c] * B[tx + 8 j][c] over c < dpad, for two
// [64, ld] fp32 tiles in shared memory
__device__ __forceinline__ void tile_dot(const float* a_tile,
                                         const float* b_tile, int ld,
                                         int dpad, int ty, int tx,
                                         float (&out)[4][8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) out[i][j] = 0.f;
  for (int kk = 0; kk < dpad; kk += 4) {
    float4 a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_tile + (ty + 16 * i) * ld +
                                              kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(b_tile + (tx + 8 * j) * ld + kk);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        out[i][j] = fmaf(a[i].x, b.x, out[i][j]);
        out[i][j] = fmaf(a[i].y, b.y, out[i][j]);
        out[i][j] = fmaf(a[i].z, b.z, out[i][j]);
        out[i][j] = fmaf(a[i].w, b.w, out[i][j]);
      }
    }
  }
}

// acc[i][c] += sum_r W[ty + 16 i][r] * X[r][tx * DMAX/8 + c] over r < n
// (n a multiple of 4): W is [64, kP] and X is [64, ld] in shared memory
template <int DMAX>
__device__ __forceinline__ void tile_accumulate(const float* w_tile,
                                                const float* x_tile, int ld,
                                                int n, int ty, int tx,
                                                float (&acc)[4][DMAX / 8]) {
  constexpr int kDC = DMAX / 8;
  for (int r = 0; r < n; r += 4) {
    float4 w4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w4[i] = *reinterpret_cast<const float4*>(w_tile + (ty + 16 * i) * kP +
                                               r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float* xrow = x_tile + (r + u) * ld + tx * kDC;
      float xv[kDC];
#pragma unroll
      for (int c4 = 0; c4 < kDC / 4; ++c4) {
        const float4 x = *reinterpret_cast<const float4*>(xrow + 4 * c4);
        xv[4 * c4 + 0] = x.x;
        xv[4 * c4 + 1] = x.y;
        xv[4 * c4 + 2] = x.z;
        xv[4 * c4 + 3] = x.w;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float w = lane(w4[i], u);
#pragma unroll
        for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(w, xv[c], acc[i][c]);
      }
    }
  }
}

// p and ds of one (query row, key) pair; __fmul_rn keeps nvcc from fusing
// the scale into the following subtraction, so each step rounds as in the
// plain version
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse,
                                         float delta, float glse,
                                         bool masked, float sm_scale,
                                         float& p, float& ds) {
  p = masked ? 0.f : expf(__fmul_rn(s, sm_scale) - lse);
  ds = __fmul_rn(__fmul_rn(p, (dp - delta) + glse), sm_scale);
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        const float* __restrict__ glse, T* __restrict__ dq,
                        int h, int sq, int sk, int d, Strides st, int causal,
                        float sm_scale) {
  using L = Layout<DMAX>;
  constexpr int kDC = DMAX / 8;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kTile * L::kLd;
  float* ks = dos + kTile * L::kLd;
  float* vs = ks + kTile * L::kLd;
  float* dss = vs + kTile * L::kLd;

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h;
  const int q0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int causal_off = sk - sq;
  const int dpad = (d + 3) & ~3;
  const T* kb = k + bi * st.k_b + hi * st.k_h;
  const T* vb = v + bi * st.v_b + hi * st.v_h;

  load_tile<T, DMAX>(qs, L::kLd, q + bi * st.q_b + hi * st.q_h, st.q_s, q0,
                     sq, d);
  load_tile<T, DMAX>(dos, L::kLd, dout + bi * st.o_b + hi * st.o_h, st.o_s,
                     q0, sq, d);

  float row_lse[4], row_delta[4], row_glse[4], acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_row = q0 + ty + 16 * i;
    const long long at = (long long)bh * sq + q_row;
    row_lse[i] = q_row < sq ? lse[at] : 0.f;
    row_delta[i] = q_row < sq ? delta[at] : 0.f;
    row_glse[i] = (q_row < sq && glse != nullptr) ? glse[at] : 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (sk + kTile - 1) / kTile;
  if (causal) {
    // the last key any row of this tile may see; later tiles are all future
    const int last = q0 + kTile - 1 + causal_off;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kTile + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the previous tile's K, V and ds are consumed
    load_tile<T, DMAX>(ks, L::kLd, kb, st.k_s, k0, sk, d);
    load_tile<T, DMAX>(vs, L::kLd, vb, st.v_s, k0, sk, d);
    __syncthreads();

    // s[i][j], dp[i][j]: row ty + 16 i, key tx + 8 j
    float s[4][8], dp[4][8];
    tile_dot(qs, ks, L::kLd, dpad, ty, tx, s);
    tile_dot(dos, vs, L::kLd, dpad, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int q_row = q0 + row;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + tx + 8 * j;
        const bool masked = q_row >= sq || key >= sk ||
                            (causal && key > q_row + causal_off);
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], row_lse[i], row_delta[i], row_glse[i],
                 masked, sm_scale, p, ds);
        dss[row * kP + tx + 8 * j] = round_to(ds, T());
      }
    }
    __syncthreads();

    // acc[i][c] += sum_key ds[row i, key] * K[key, tx * kDC + c]; keys past
    // sk have ds = 0 and zero rows of K, so the loop stops at the 4 after
    tile_accumulate<DMAX>(dss, ks, L::kLd, (min(kTile, sk - k0) + 3) & ~3,
                          ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_row = q0 + ty + 16 * i;
    if (q_row >= sq) continue;
    T* drow = dq + (((long long)bi * sq + q_row) * h + hi) * d;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = tx * kDC + c;
      if (col < d) store(drow + col, acc[i][c]);
    }
  }
}

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                         const T* __restrict__ v, const T* __restrict__ dout,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const float* __restrict__ glse, T* __restrict__ dk,
                         T* __restrict__ dv, int h, int sq, int sk, int d,
                         Strides st, int causal, float sm_scale) {
  using L = Layout<DMAX>;
  constexpr int kDC = DMAX / 8;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kTile * L::kLd;
  float* qs = vs + kTile * L::kLd;
  float* dos = qs + kTile * L::kLd;
  float* pt = dos + kTile * L::kLd;   // round(p), [key][row]
  float* dst = pt + kTile * kP;       // round(ds), [key][row]
  float* lse_s = dst + kTile * kP;
  float* delta_s = lse_s + kTile;
  float* glse_s = delta_s + kTile;

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h;
  const int k0 = blockIdx.y * kTile;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int causal_off = sk - sq;
  const int dpad = (d + 3) & ~3;
  const T* qb = q + bi * st.q_b + hi * st.q_h;
  const T* ob = dout + bi * st.o_b + hi * st.o_h;
  const float* lse_b = lse + (long long)bh * sq;
  const float* delta_b = delta + (long long)bh * sq;
  const float* glse_b = glse == nullptr ? nullptr : glse + (long long)bh * sq;

  load_tile<T, DMAX>(ks, L::kLd, k + bi * st.k_b + hi * st.k_h, st.k_s, k0,
                     sk, d);
  load_tile<T, DMAX>(vs, L::kLd, v + bi * st.v_b + hi * st.v_h, st.v_s, k0,
                     sk, d);

  float acc_k[4][kDC], acc_v[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  const int n_tiles = (sq + kTile - 1) / kTile;
  for (int t = 0; t < n_tiles; ++t) {
    const int q0 = t * kTile;
    // no row of this query tile sees a key of this key tile: skip it
    if (causal && k0 > q0 + kTile - 1 + causal_off) continue;
    __syncthreads();  // the previous tile's Q, dO, p and ds are consumed
    load_tile<T, DMAX>(qs, L::kLd, qb, st.q_s, q0, sq, d);
    load_tile<T, DMAX>(dos, L::kLd, ob, st.o_s, q0, sq, d);
    for (int r = threadIdx.x; r < kTile; r += kThreads) {
      const int q_row = q0 + r;
      lse_s[r] = q_row < sq ? lse_b[q_row] : 0.f;
      delta_s[r] = q_row < sq ? delta_b[q_row] : 0.f;
      glse_s[r] = (q_row < sq && glse_b != nullptr) ? glse_b[q_row] : 0.f;
    }
    __syncthreads();

    // s[i][j], dp[i][j]: key ty + 16 i, query row tx + 8 j
    float s[4][8], dp[4][8];
    tile_dot(ks, qs, L::kLd, dpad, ty, tx, s);
    tile_dot(vs, dos, L::kLd, dpad, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = ty + 16 * i;
      const int key = k0 + kr;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tx + 8 * j;
        const int q_row = q0 + r;
        const bool masked = q_row >= sq || key >= sk ||
                            (causal && key > q_row + causal_off);
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], lse_s[r], delta_s[r], glse_s[r], masked,
                 sm_scale, p, ds);
        pt[kr * kP + r] = round_to(p, T());
        dst[kr * kP + r] = round_to(ds, T());
      }
    }
    __syncthreads();

    // rows past sq have p = ds = 0 and zero rows of Q and dO
    const int n_rows = (min(kTile, sq - q0) + 3) & ~3;
    tile_accumulate<DMAX>(pt, dos, L::kLd, n_rows, ty, tx, acc_v);
    tile_accumulate<DMAX>(dst, qs, L::kLd, n_rows, ty, tx, acc_k);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    const long long at = (((long long)bi * sk + key) * h + hi) * d;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = tx * kDC + c;
      if (col < d) {
        store(dk + at + col, acc_k[i][c]);
        store(dv + at + col, acc_v[i][c]);
      }
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *glse;
  int b, h, sq, sk, d;
  Strides st;
  int causal;
  float sm_scale;
  cudaStream_t stream;
};

template <typename T, int DMAX>
cudaError_t launch_dq(const Args& a, void* dq) {
  auto kernel = flash_bwd_dq_kernel<T, DMAX>;
  const int bytes = Layout<DMAX>::kDqBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h), (unsigned)((a.sq + kTile - 1) / kTile));
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.glse, static_cast<T*>(dq), a.h, a.sq, a.sk, a.d, a.st,
      a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <typename T, int DMAX>
cudaError_t launch_dkv(const Args& a, void* dk, void* dv) {
  auto kernel = flash_bwd_dkv_kernel<T, DMAX>;
  const int bytes = Layout<DMAX>::kDkvBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h), (unsigned)((a.sk + kTile - 1) / kTile));
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout), a.lse,
      a.delta, a.glse, static_cast<T*>(dk), static_cast<T*>(dv), a.h, a.sq,
      a.sk, a.d, a.st, a.causal, a.sm_scale);
  return cudaGetLastError();
}

// checks shared by both entry points; -1: valid and nothing to launch
int check(int b, int h, int sq, int sk, int d) {
  if (b < 0 || h < 0 || sq < 0 || sk < 1 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  if ((long long)b * h > 0x7fffffffLL || (sq + kTile - 1) / kTile > 65535 ||
      (sk + kTile - 1) / kTile > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || sq == 0) return -1;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// q, dout: [b, sq, h, d] and k, v: [b, sk, h, d] with the given batch,
// sequence and head strides (elements) and a contiguous head dim, all fp32
// (is_bf16 == 0) or all bf16; lse, delta and glse (null: zeros): contiguous
// fp32 [b*h, sq]. Both launch on `stream` and return the CUDA error code (0
// when the launch was accepted).

// dq: contiguous [b, sq, h, d] of the inputs' dtype
int zoo_flash_bwd_dq(const void* q, const void* k, const void* v,
                     const void* dout, const float* lse, const float* delta,
                     const float* glse, void* dq, int b, int h, int sq,
                     int sk, int d, long long q_b, long long q_s,
                     long long q_h, long long k_b, long long k_s,
                     long long k_h, long long v_b, long long v_s,
                     long long v_h, long long o_b, long long o_s,
                     long long o_h, int causal, float sm_scale, int is_bf16,
                     void* stream) {
  const int bad = check(b, h, sq, sk, d);
  if (bad != 0) return bad < 0 ? (int)cudaSuccess : bad;
  const Args a{q, k, v, dout, lse, delta, glse, b, h, sq, sk, d,
               Strides{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b,
                       o_s, o_h},
               causal, sm_scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (is_bf16)
    err = d <= 64 ? launch_dq<__nv_bfloat16, 64>(a, dq)
                  : launch_dq<__nv_bfloat16, 128>(a, dq);
  else
    err = d <= 64 ? launch_dq<float, 64>(a, dq) : launch_dq<float, 128>(a, dq);
  return (int)err;
}

// dk, dv: contiguous [b, sk, h, d] of the inputs' dtype. With sq == 0 they
// are left as they are (the caller zero-fills them).
int zoo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                      const void* dout, const float* lse, const float* delta,
                      const float* glse, void* dk, void* dv, int b, int h,
                      int sq, int sk, int d, long long q_b, long long q_s,
                      long long q_h, long long k_b, long long k_s,
                      long long k_h, long long v_b, long long v_s,
                      long long v_h, long long o_b, long long o_s,
                      long long o_h, int causal, float sm_scale, int is_bf16,
                      void* stream) {
  const int bad = check(b, h, sq, sk, d);
  if (bad != 0) return bad < 0 ? (int)cudaSuccess : bad;
  const Args a{q, k, v, dout, lse, delta, glse, b, h, sq, sk, d,
               Strides{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b,
                       o_s, o_h},
               causal, sm_scale, static_cast<cudaStream_t>(stream)};
  cudaError_t err;
  if (is_bf16)
    err = d <= 64 ? launch_dkv<__nv_bfloat16, 64>(a, dk, dv)
                  : launch_dkv<__nv_bfloat16, 128>(a, dk, dv);
  else
    err = d <= 64 ? launch_dkv<float, 64>(a, dk, dv)
                  : launch_dkv<float, 128>(a, dk, dv);
  return (int)err;
}

const char* zoo_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
