// Paged decode kernels for Hopper (sm_90a): the page gather and the
// single-query decode attention over a page pool.
//
// Layouts (as the JAX package's public functions take them):
//   pool / k_pool / v_pool  [n_pages, page_size, dim], fp32, or int8 with one
//                           fp32 scale per page (scales [n_pages])
//   table                   [batch, width] int32 page ids, clamped here into
//                           [0, n_pages) as JAX clamps them before dispatch
//   lengths                 [batch] int32 live positions of each row
//
// paged_gather_kernel replaces analytics_zoo_tpu/ops/paged_attention.py:77
// _gather_kernel (the Pallas kernel launched by _gather_pallas). Output
// [batch, out_len, dim] fp32: position pos of row b is page table[b, pos/ps]
// row pos%ps, dequantized as (float)x * scale[page] (one IEEE multiply,
// __fmul_rn, the expression of _gather_ref_core), and exactly 0.0 at every
// position >= lengths[b]. Such positions are written and never read, so a
// recycled page's stale rows (inf, NaN, anything) never reach the output.
// Only the first out_len positions are written: the trim costs nothing.
// Bound: device-memory bytes (the live rows read plus the output written;
// no arithmetic but the dequant multiply). Design: one block per (row, page
// of the table); the block reads its page id and length itself (no scalar
// prefetch on this card) and copies the page's rows with 16-byte loads and
// stores where a row is a multiple of 16 bytes (fp32 dim % 4 == 0; int8 reads
// 4 bytes and writes 16), element by element otherwise. At the decode path's
// shapes the output is a few KB: the launch is the cost.
//
// paged_attention_kernel replaces analytics_zoo_tpu/ops/paged_attention.py:174
// _attn_kernel (launched by _attn_pallas). Output [batch, dim] fp32: softmax
// over the live positions of q . k * softmax_scale, times v, with the
// dequant fused as in the gather. fp32 online softmax page by page: running
// max m (from -1e30), alpha = exp(m_prev - m_cur), weights exp(s - m_cur),
// l = l * alpha + sum(w), acc = acc * alpha + w . v, out = acc / l with l == 0
// taken as 1, so a row of length 0 gives exact zeros. Bound: the larger of
// the live K and V rows plus q and the output over the memory rate, and
// 4 * sum(len) * dim flops over the fp32 rate. Design: one block per batch
// row, one thread per output element (dim <= 1024); the block walks only the
// ceil(len / ps) pages that hold live positions and, inside the last one,
// only the live positions, so dead pages and dead slots are never read
// (the Pallas kernel reads them and multiplies their v by weight 0, which
// gives NaN where a dead slot holds inf or NaN; the plain version of the
// port zeroes them first, as JAX's reference does). Per page, warp w
// computes the scores of positions w, w + n_warps, ... (lanes over dim,
// shuffle reduction) into shared memory; then every thread folds the page's
// scores into its own copy of m and l (the same values in every thread) and
// its output element into acc.

#include <cuda_runtime.h>
#include <stdint.h>

#define ZOO_NEG_INF (-1e30f)

__device__ __forceinline__ int clamp_page(int page, int n_pages) {
  return page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
}

// ------------------------------------------------------------ paged gather

template <bool INT8, int VEC>
__global__ void paged_gather_kernel(const void* __restrict__ pool,
                                    const float* __restrict__ scales,
                                    const int* __restrict__ table,
                                    const int* __restrict__ lengths,
                                    float* __restrict__ out, int width,
                                    int page_size, int dim, int n_pages,
                                    int out_len) {
  const int p = blockIdx.x;  // page slot of the table
  const int b = blockIdx.y;  // batch row
  const int pos0 = p * page_size;
  const int rows = min(page_size, out_len - pos0);
  if (rows <= 0) return;
  const int len = lengths[b];
  const int page = clamp_page(table[(long long)b * width + p], n_pages);
  const float scale = INT8 ? scales[page] : 1.f;
  const int vecs = dim / VEC;  // vectors per row
  const long long total = (long long)rows * vecs;
  float* dst = out + ((long long)b * out_len + pos0) * dim;
  const long long src_page = (long long)page * page_size * dim;
  for (long long i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = (int)(i / vecs);
    const int c = (int)(i - (long long)r * vecs) * VEC;
    const long long o = (long long)r * dim + c;
    const bool live = pos0 + r < len;
    if (VEC == 4) {
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live) {
        if (INT8) {
          const char4 q = *reinterpret_cast<const char4*>(
              static_cast<const int8_t*>(pool) + src_page + o);
          v = make_float4(__fmul_rn((float)q.x, scale),
                          __fmul_rn((float)q.y, scale),
                          __fmul_rn((float)q.z, scale),
                          __fmul_rn((float)q.w, scale));
        } else {
          v = *reinterpret_cast<const float4*>(
              static_cast<const float*>(pool) + src_page + o);
        }
      }
      *reinterpret_cast<float4*>(dst + o) = v;
    } else {
      float v = 0.f;
      if (live) {
        if (INT8) {
          v = __fmul_rn(
              (float)(static_cast<const int8_t*>(pool)[src_page + o]), scale);
        } else {
          v = static_cast<const float*>(pool)[src_page + o];
        }
      }
      dst[o] = v;
    }
  }
}

template <bool INT8>
static void launch_gather(const void* pool, const float* scales,
                          const int* table, const int* lengths, float* out,
                          int batch, int width, int page_size, int dim,
                          int n_pages, int out_len, cudaStream_t stream) {
  // 16-byte vectors need whole vectors per row and aligned bases (a
  // tensor with a storage offset may not be)
  const bool aligned = (uintptr_t)out % 16 == 0 &&
                       (uintptr_t)pool % (INT8 ? 4 : 16) == 0;
  const int vec = (dim % 4 == 0 && aligned) ? 4 : 1;
  const int per_page = page_size * (dim / vec);
  int threads = ((per_page + 31) / 32) * 32;
  if (threads > 256) threads = 256;
  const dim3 grid((unsigned)((out_len + page_size - 1) / page_size),
                  (unsigned)batch);
  if (vec == 4) {
    paged_gather_kernel<INT8, 4><<<grid, threads, 0, stream>>>(
        pool, scales, table, lengths, out, width, page_size, dim, n_pages,
        out_len);
  } else {
    paged_gather_kernel<INT8, 1><<<grid, threads, 0, stream>>>(
        pool, scales, table, lengths, out, width, page_size, dim, n_pages,
        out_len);
  }
}

// ------------------------------------------------- paged decode attention

template <bool INT8>
__device__ __forceinline__ float load_kv(const void* pool, long long idx,
                                         float scale) {
  if (INT8) {
    return __fmul_rn((float)(static_cast<const int8_t*>(pool)[idx]), scale);
  }
  return static_cast<const float*>(pool)[idx];
}

template <bool INT8>
__global__ void paged_attention_kernel(
    const float* __restrict__ q, const void* __restrict__ k_pool,
    const void* __restrict__ v_pool, const float* __restrict__ k_scales,
    const float* __restrict__ v_scales, const int* __restrict__ table,
    const int* __restrict__ lengths, float* __restrict__ out, int width,
    int page_size, int dim, int n_pages, float softmax_scale) {
  extern __shared__ float smem[];
  float* q_sh = smem;        // [dim]
  float* s_sh = smem + dim;  // [page_size]
  const int b = blockIdx.x;
  const int j = threadIdx.x;
  const int lane = j & 31;
  const int warp = j >> 5;
  const int n_warps = blockDim.x >> 5;
  for (int e = j; e < dim; e += blockDim.x) q_sh[e] = q[(long long)b * dim + e];
  int len = lengths[b];
  const int cap = width * page_size;
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int pages = (len + page_size - 1) / page_size;
  float m = ZOO_NEG_INF;
  float l = 0.f;
  float acc = 0.f;
  __syncthreads();
  for (int p = 0; p < pages; ++p) {
    const int page = clamp_page(table[(long long)b * width + p], n_pages);
    const int live = min(page_size, len - p * page_size);
    const long long base = (long long)page * page_size * dim;
    const float ks = INT8 ? k_scales[page] : 1.f;
    const float vs = INT8 ? v_scales[page] : 1.f;
    for (int r = warp; r < live; r += n_warps) {
      float part = 0.f;
      for (int e = lane; e < dim; e += 32) {
        part += q_sh[e] * load_kv<INT8>(k_pool, base + (long long)r * dim + e,
                                        ks);
      }
      for (int off = 16; off > 0; off >>= 1)
        part += __shfl_xor_sync(0xffffffffu, part, off);
      if (lane == 0) s_sh[r] = part * softmax_scale;
    }
    __syncthreads();
    float m_cur = m;
    for (int r = 0; r < live; ++r) m_cur = fmaxf(m_cur, s_sh[r]);
    const float alpha = expf(m - m_cur);
    float l_page = 0.f;
    float pv = 0.f;
    for (int r = 0; r < live; ++r) {
      const float w = expf(s_sh[r] - m_cur);
      l_page += w;
      if (j < dim) pv += w * load_kv<INT8>(v_pool, base + (long long)r * dim + j,
                                           vs);
    }
    m = m_cur;
    l = l * alpha + l_page;
    acc = acc * alpha + pv;
    __syncthreads();  // s_sh is rewritten by the next page
  }
  if (j < dim) out[(long long)b * dim + j] = acc / (l == 0.f ? 1.f : l);
}

extern "C" {

// pool [n_pages, page_size, dim] fp32 (is_int8 == 0) or int8; scales
// [n_pages] fp32 (read only for int8); table [batch, width] int32; lengths
// [batch] int32; out [batch, out_len, dim] fp32, out_len <= width *
// page_size. All contiguous. Launches on `stream` and returns
// cudaGetLastError() (0 when the launch was accepted).
int zoo_paged_gather(const void* pool, const void* scales, const void* table,
                     const void* lengths, void* out, int batch, int width,
                     int page_size, int dim, int n_pages, int out_len,
                     int is_int8, void* stream) {
  if (batch < 0 || width < 1 || page_size < 1 || dim < 1 || n_pages < 1 ||
      out_len < 0 || out_len > width * page_size)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || out_len == 0) return (int)cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* sc = static_cast<const float*>(scales);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (is_int8) {
    launch_gather<true>(pool, sc, tb, ln, o, batch, width, page_size, dim,
                        n_pages, out_len, s);
  } else {
    launch_gather<false>(pool, sc, tb, ln, o, batch, width, page_size, dim,
                         n_pages, out_len, s);
  }
  return (int)cudaGetLastError();
}

// q [batch, dim] fp32; k_pool, v_pool as the gather's pool (one dtype);
// k_scales, v_scales [n_pages] fp32 (read only for int8); out [batch, dim]
// fp32. dim <= 1024. Same return convention.
int zoo_paged_attention(const void* q, const void* k_pool, const void* v_pool,
                        const void* k_scales, const void* v_scales,
                        const void* table, const void* lengths, void* out,
                        int batch, int width, int page_size, int dim,
                        int n_pages, float softmax_scale, int is_int8,
                        void* stream) {
  if (batch < 0 || width < 1 || page_size < 1 || dim < 1 || dim > 1024 ||
      n_pages < 1)
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  const int threads = ((dim + 31) / 32) * 32;
  const size_t shared = (size_t)(dim + page_size) * sizeof(float);
  if (shared > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        is_int8 ? paged_attention_kernel<true> : paged_attention_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shared);
    if (err != cudaSuccess) return (int)err;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* qf = static_cast<const float*>(q);
  const float* ks = static_cast<const float*>(k_scales);
  const float* vs = static_cast<const float*>(v_scales);
  const int* tb = static_cast<const int*>(table);
  const int* ln = static_cast<const int*>(lengths);
  float* o = static_cast<float*>(out);
  if (is_int8) {
    paged_attention_kernel<true><<<batch, threads, shared, s>>>(
        qf, k_pool, v_pool, ks, vs, tb, ln, o, width, page_size, dim, n_pages,
        softmax_scale);
  } else {
    paged_attention_kernel<false><<<batch, threads, shared, s>>>(
        qf, k_pool, v_pool, ks, vs, tb, ln, o, width, page_size, dim, n_pages,
        softmax_scale);
  }
  return (int)cudaGetLastError();
}

const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
