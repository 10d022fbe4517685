// Flash-attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py:156 _flash_fwd_kernel,
// the Pallas TPU kernel launched by _flash_fwd. For q [b, sq, h, d] and
// k, v [b, sk, h, d] (any batch, sequence and head strides; d contiguous,
// d <= 128) it computes o [b, sq, h, d] in q's dtype and, when asked, the
// per-row logsumexp lse [b*h, sq] in fp32, with the arithmetic of the
// Pallas body:
//   s = (q . k) * sm_scale      fp32 dot of the widened inputs, then one
//                               fp32 multiply by sm_scale = 1/sqrt(d)
//   masked s = -1e30            keys at or past sk, and with `causal` keys
//                               past q_row + (sk - sq) (bottom-right causal)
//   online softmax              fp32 running max m and sum l per row;
//                               l sums the unrounded p
//   o += round(p) . v           p rounded to v's dtype (bf16) before P.V,
//                               fp32 accumulation
//   o / max(l, 1e-37)           lse = m + log(max(l, 1e-37))
// Key tiles that lie wholly in the future of every row of a query tile
// are skipped. A masked key always gets p = 0: a row that sees no key
// gives o = 0 and lse = -1e30 whatever the tile sizes (the Pallas kernel
// gives such a row uniform weights over the tiles it visits; ROADMAP C).
//
// Bound: operations. 4*b*h*sq*sk*d flops (halved for causal) against
// (2*b*sq + 2*b*sk)*h*d elements moved: at BERT-Base's shape (s = 512,
// d = 64) that is 128 flops per fp32 byte, past the card's ridge.
// Design (simple, not yet fast): one CTA of 128 threads per (b*h, tile of
// 64 query rows); a loop over 64-key tiles of K and V staged in shared
// memory as fp32; each thread owns 4 query rows x 8 keys of the score
// tile and 4 rows x d/8 columns of the fp32 accumulator; scores and P.V
// are fp32 FMAs on CUDA cores (no tensor cores, no TMA, no pipelining:
// wgmma and TMA are later work). Shared rows are padded by 4 floats so the
// 16-byte reads of a warp hit distinct banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // query rows per CTA
constexpr int kBK = 64;        // keys per tile
constexpr int kThreads = 128;  // 16 x 8 threads: ty owns rows, tx keys/cols
constexpr float kNegInf = -1e30f;

struct Strides {  // in elements; the head dim has stride 1
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// x rounded to T and widened back (p.astype(v.dtype) of the Pallas body)
__device__ __forceinline__ float round_to(float x, float) { return x; }
__device__ __forceinline__ float round_to(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float lane(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <int DMAX>
struct Layout {
  static constexpr int kQK = DMAX + 4;  // row stride of the Q and K tiles
  static constexpr int kP = kBK + 4;    // row stride of the P tile
  static constexpr int kFloats = kBQ * kQK + kBK * kQK + kBK * DMAX + kBQ * kP;
  static constexpr int kBytes = kFloats * (int)sizeof(float);
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
  for (int g = threadIdx.x; g < 64 * kGroups; g += kThreads) {
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

template <typename T, int DMAX>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int h, int sq, int sk, int d,
                     Strides st, int causal, float sm_scale) {
  using L = Layout<DMAX>;
  constexpr int kDC = DMAX / 8;  // accumulator columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* ks = qs + kBQ * L::kQK;
  float* vs = ks + kBK * L::kQK;
  float* ps = vs + kBK * DMAX;

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h;
  const int q0 = blockIdx.y * kBQ;
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int causal_off = sk - sq;
  const int dpad = (d + 3) & ~3;
  const T* kb = k + bi * st.k_b + hi * st.k_h;
  const T* vb = v + bi * st.v_b + hi * st.v_h;

  load_tile<T, DMAX>(qs, L::kQK, q + bi * st.q_b + hi * st.q_h, st.q_s, q0,
                     sq, d);

  float m[4], l[4], acc[4][kDC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < kDC; ++c) acc[i][c] = 0.f;
  }

  int n_tiles = (sk + kBK - 1) / kBK;
  if (causal) {
    // the last key any row of this tile may see; later tiles are all future
    const int last = q0 + kBQ - 1 + causal_off;
    n_tiles = last < 0 ? 0 : min(n_tiles, last / kBK + 1);
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // the previous tile's K, V and P are consumed
    load_tile<T, DMAX>(ks, L::kQK, kb, st.k_s, k0, sk, d);
    load_tile<T, DMAX>(vs, DMAX, vb, st.v_s, k0, sk, d);
    __syncthreads();

    // s[i][j]: row ty + 16 i, key tx + 8 j
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int kk = 0; kk < dpad; kk += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * L::kQK +
                                                kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b =
            *reinterpret_cast<const float4*>(ks + (tx + 8 * j) * L::kQK + kk);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = ty + 16 * i;
      const int q_row = q0 + row;
      unsigned masked = 0;
      float tile_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + tx + 8 * j;
        if (key >= sk || (causal && key > q_row + causal_off)) {
          masked |= 1u << j;
          s[i][j] = kNegInf;
        } else {
          s[i][j] = s[i][j] * sm_scale;
        }
        tile_max = fmaxf(tile_max, s[i][j]);
      }
      // the 8 threads of a row are lanes differing in their low 3 bits
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, w));
      const float m_new = fmaxf(m[i], tile_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = (masked >> j) & 1u ? 0.f : expf(s[i][j] - m_new);
        row_sum += p;
        ps[row * L::kP + tx + 8 * j] = round_to(p, T());
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, w);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kDC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc[i][c] += sum_key P[row i, key] * V[key, tx * kDC + c]; keys past
    // sk have p = 0 and zero rows of V, so the loop stops at the 4 after
    const int n_keys = (min(kBK, sk - k0) + 3) & ~3;
    for (int key = 0; key < n_keys; key += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * L::kP +
                                                 key);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float* vrow = vs + (key + u) * DMAX + tx * kDC;
        float vv[kDC];
#pragma unroll
        for (int c4 = 0; c4 < kDC / 4; ++c4) {
          const float4 x = *reinterpret_cast<const float4*>(vrow + 4 * c4);
          vv[4 * c4 + 0] = x.x;
          vv[4 * c4 + 1] = x.y;
          vv[4 * c4 + 2] = x.z;
          vv[4 * c4 + 3] = x.w;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = lane(p4[i], u);
#pragma unroll
          for (int c = 0; c < kDC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int q_row = q0 + ty + 16 * i;
    if (q_row >= sq) continue;
    const float l_fin = fmaxf(l[i], 1e-37f);
    T* orow = o + (((long long)bi * sq + q_row) * h + hi) * d;
#pragma unroll
    for (int c = 0; c < kDC; ++c) {
      const int col = tx * kDC + c;
      if (col < d) store(orow + col, acc[i][c] / l_fin);
    }
    if (lse != nullptr && tx == 0)
      lse[(long long)bh * sq + q_row] = m[i] + logf(l_fin);
  }
}

template <typename T, int DMAX>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   float* lse, int b, int h, int sq, int sk, int d,
                   const Strides& st, int causal, float sm_scale,
                   cudaStream_t stream) {
  auto kernel = flash_fwd_kernel<T, DMAX>;
  const int bytes = Layout<DMAX>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + kBQ - 1) / kBQ));
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse, h, sq, sk, d, st,
      causal, sm_scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_d(const void* q, const void* k, const void* v, void* o,
                     float* lse, int b, int h, int sq, int sk, int d,
                     const Strides& st, int causal, float sm_scale,
                     cudaStream_t stream) {
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, b, h, sq, sk, d, st, causal,
                         sm_scale, stream);
  return launch<T, 128>(q, k, v, o, lse, b, h, sq, sk, d, st, causal,
                        sm_scale, stream);
}

}  // namespace

extern "C" {

// q: [b, sq, h, d], k and v: [b, sk, h, d] with the given batch, sequence
// and head strides (elements) and a contiguous head dim; o: contiguous
// [b, sq, h, d] of q's dtype (fp32 when is_bf16 == 0, bf16 otherwise);
// lse: contiguous fp32 [b*h, sq], or null. Launches on `stream` and returns
// the CUDA error code (0 when the launch was accepted).
int zoo_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int b, int h, int sq, int sk, int d,
                  long long q_b, long long q_s, long long q_h, long long k_b,
                  long long k_s, long long k_h, long long v_b, long long v_s,
                  long long v_h, int causal, float sm_scale, int is_bf16,
                  void* stream) {
  if (b < 0 || h < 0 || sq < 0 || sk < 1 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  if ((long long)b * h > 0x7fffffffLL || (sq + kBQ - 1) / kBQ > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || sq == 0) return (int)cudaSuccess;
  const Strides st{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  const cudaError_t err =
      is_bf16 ? launch_d<__nv_bfloat16>(q, k, v, o, lse_f, b, h, sq, sk, d,
                                        st, causal, sm_scale, s)
              : launch_d<float>(q, k, v, o, lse_f, b, h, sq, sk, d, st,
                                causal, sm_scale, s);
  return (int)err;
}

const char* zoo_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
