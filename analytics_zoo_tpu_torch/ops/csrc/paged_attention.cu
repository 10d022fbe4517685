// Paged decode kernels for Hopper (sm_90a): the page gather and the
// single-query decode attention over a page pool.
//
// Layouts (as the JAX package's public functions take them):
//   pool / k_pool / v_pool  [n_pages, page_size, dim], fp32, or int8 with one
//                           fp32 scale per page (scales [n_pages]; a null
//                           pointer reads as scale 1)
//   table                   [batch, width] int32 page ids, clamped here into
//                           [0, n_pages) as JAX clamps them before dispatch
//   lengths                 [batch] int32 live positions of each row, clamped
//                           here into [0, width * page_size]
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
// dequant fused as in the gather, accumulated in fp32 with accurate expf.
// It is held to the same softmax computed in float64 within JAX's limit
// for its kernel. The score q . k is summed in fp64 and rounded once: at
// int8's magnitudes (|k| up to 127 * scale) and long rows, the fp32 sums
// already take most of that limit, and an fp32 dot product (the variant
// f32_dot of dev/paged_variants.py) took more than all of it
// (dev/paged_accuracy.py).
// Bound: device-memory bytes (each live K and V row read once; 4 flops a
// live element against 3.35 TB/s). Design, split-page flash-decoding:
//   - The grid is (splits, batch): split s of row b owns the page slots
//     [s * P, min((s + 1) * P, width)), P = pages_per_split, so a long row
//     is read by many SMs at once. The host picks splits from the shapes
//     alone (never from the lengths, which live on the device). A split
//     reads only the live positions of its slots: dead pages and the dead
//     slots of the last page are never read, so their contents (inf, NaN)
//     never reach the output (the Pallas kernel reads them and multiplies
//     their v by weight 0).
//   - Inside a block, a group of 2^k lanes takes one position: each lane
//     loads 16 bytes of its K row (a float4, or 16 int8s) and of its V row,
//     and the score is a shuffle reduction inside the group. At d 128 fp32
//     a warp reads a K row as 32 float4s; at d 8 a warp takes 16 positions.
//     int8 widens in registers by a byte permute and an add (not the
//     type-conversion unit, the card's narrowest). Rows that are
//     not a multiple of 16 bytes take 4-byte int8 words; dims that are not a
//     multiple of 4, and pools whose base is not aligned, take the same
//     kernel with one element a load. Each lane loads ATTN_ROWS_AHEAD
//     vectors of K and of V before it folds any, and where its share of a
//     row is small it loads the next round's before folding this one.
//   - Each group keeps its own online softmax (m from -1e30, l, and acc in
//     registers); the groups of a warp merge by shuffles, then the warps of
//     the block in shared memory in warp order.
//   - With one split the block writes acc / l (l == 0 read as 1: a row of
//     length 0 gives exact zeros). With more, it writes its partial
//     (m, l, acc[dim]) to work [batch, splits, dim + 2] (a split with no live
//     position writes m = -1e30, l = 0, acc = 0), and
//     paged_attention_combine_kernel, one block per row, folds the splits:
//     m* = max m_s, out = sum acc_s e^(m_s - m*) / sum l_s e^(m_s - m*),
//     each warp a run of splits in split order, then the warps in warp
//     order. No atomics: the same inputs give the same bits.

#include <cuda_runtime.h>
#include <stdint.h>

#define ZOO_NEG_INF (-1e30f)
// threads of one block of the split kernel
#define ATTN_THREADS 128
// K (and V) vectors a lane loads before it folds them: ATTN_ROWS_AHEAD /
// vectors-a-lane positions a group, at least one. ops/paged_attention.py's
// _block_reach mirrors both (the positions one block takes in a round).
#define ATTN_ROWS_AHEAD 4
// the most splits of one row (the combine keeps one weight a split in
// shared memory)
#define ATTN_MAX_SPLITS 1024
#define COMBINE_THREADS 256
#define FULL_MASK 0xffffffffu

__device__ __forceinline__ int clamp_page(int page, int n_pages) {
  return page < 0 ? 0 : (page >= n_pages ? n_pages - 1 : page);
}

// Runs the calls between construction and destruction on `device`: reads
// the calling thread's device and switches (and back) only when it differs.
struct DeviceScope {
  int prev = -1;
  cudaError_t err = cudaSuccess;
  explicit DeviceScope(int device) {
    int cur = 0;
    err = cudaGetDevice(&cur);
    if (err == cudaSuccess && cur != device) {
      err = cudaSetDevice(device);
      if (err == cudaSuccess) prev = cur;
    }
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

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
  const float scale = (INT8 && scales != nullptr) ? scales[page] : 1.f;
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

// What one lane loads of a K or V row: VEC elements of the pool's type
// (int8: 16 or 4 bytes as 32-bit words, or one byte).
template <bool INT8, int VEC>
struct KvRaw;
template <>
struct KvRaw<false, 4> {
  typedef float4 T;
};
template <>
struct KvRaw<false, 1> {
  typedef float T;
};
template <>
struct KvRaw<true, 16> {
  typedef uint4 T;
};
template <>
struct KvRaw<true, 4> {
  typedef unsigned int T;
};
template <>
struct KvRaw<true, 1> {
  typedef signed char T;
};

// Byte i of a word of int8s as fp32, exactly (float)x: the byte biased by
// 128 is the mantissa of 2^23 + x + 128. A byte permute and an add, off
// the type-conversion unit.
__device__ __forceinline__ float s8_to_float(unsigned int biased, int i) {
  return __int_as_float(__byte_perm(biased, 0x4B000000u, 0x7540u | i)) -
         8388736.f;
}

__device__ __forceinline__ void widen_word(unsigned int w, float s,
                                           float* x) {
  const unsigned int biased = w ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = __fmul_rn(s8_to_float(biased, i), s);
}

// A loaded vector as fp32; int8 dequantizes as the gather does.
__device__ __forceinline__ void widen(float4 r, float, float* x) {
  x[0] = r.x;
  x[1] = r.y;
  x[2] = r.z;
  x[3] = r.w;
}
__device__ __forceinline__ void widen(float r, float, float* x) { x[0] = r; }
__device__ __forceinline__ void widen(uint4 r, float s, float* x) {
  widen_word(r.x, s, x);
  widen_word(r.y, s, x + 4);
  widen_word(r.z, s, x + 8);
  widen_word(r.w, s, x + 12);
}
__device__ __forceinline__ void widen(unsigned int r, float s, float* x) {
  widen_word(r, s, x);
}
__device__ __forceinline__ void widen(signed char r, float s, float* x) {
  x[0] = __fmul_rn((float)r, s);
}

// One round of a group's loads: U positions' K and V vectors, their pages'
// int8 scales, and which positions are live.
template <bool INT8, int VEC, int VPL, int U>
struct Round {
  typename KvRaw<INT8, VEC>::T k[U][VPL], v[U][VPL];
  float ks[U], vs[U];
  bool live[U];
};

struct AttnArgs {
  const float* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scales;  // null: scale 1 (and never read for fp32)
  const float* v_scales;
  const int* table;
  const int* lengths;
  float* out;
  float* work;  // [batch, splits, dim + 2]; read only with splits > 1
  int batch, width, page_size, dim, n_pages;
  float softmax_scale;
  int pages_per_split;
  int log_group;  // lanes of a group: 1 << log_group, <= 32
};

// VEC elements a load; VPL vectors a lane of each row (the group's lanes
// stride over the row's dim / VEC vectors).
template <bool INT8, int VEC, int VPL>
__global__ void __launch_bounds__(ATTN_THREADS)
    paged_attention_kernel(const AttnArgs a) {
  typedef typename KvRaw<INT8, VEC>::T Raw;
  constexpr int U = ATTN_ROWS_AHEAD / VPL > 0 ? ATTN_ROWS_AHEAD / VPL : 1;
  // two rounds in registers only where a lane's row share is small: int8
  // rows in 16 bytes a lane, or fp32 at d 1024, lose occupancy to it
  constexpr bool PIPE = VPL * VEC <= 8;
  constexpr int W = ATTN_THREADS / 32;
  extern __shared__ float smem[];  // W warp states of dim + 2: m, l, acc
  const Raw* kp = static_cast<const Raw*>(a.k_pool);
  const Raw* vp = static_cast<const Raw*>(a.v_pool);
  const int dim = a.dim, ps = a.page_size;
  const int split = blockIdx.x, splits = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int group = 1 << a.log_group;
  const int gl = lane & (group - 1);  // lane within its group
  const int gi = lane >> a.log_group;  // group within its warp
  const int per_warp = 32 >> a.log_group;  // positions a warp takes at once
  const int stride = W * per_warp;  // positions the block takes at once
  const int nv = dim / VEC;
  const int state = dim + 2;
  const int cap = a.width * ps;
  for (int b = blockIdx.y; b < a.batch; b += gridDim.y) {
    int len = a.lengths[b];
    len = len < 0 ? 0 : (len > cap ? cap : len);
    const int p0 = split * a.pages_per_split * ps;
    const int p1 = min(p0 + a.pages_per_split * ps, len);
    if (p0 >= p1) {  // nothing live here: zeros, or the empty partial
      if (splits == 1) {
        for (int j = threadIdx.x; j < dim; j += blockDim.x)
          a.out[(long long)b * dim + j] = 0.f;
      } else {
        float* dst = a.work + ((long long)b * splits + split) * state;
        for (int j = threadIdx.x; j < state; j += blockDim.x)
          dst[j] = j == 0 ? ZOO_NEG_INF : 0.f;
      }
      continue;  // uniform across the block
    }
    double qv[VPL][VEC];
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      const int v = gl + k * group;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        qv[k][e] = v < nv ? (double)a.q[(long long)b * dim + v * VEC + e]
                          : 0.0;
    }
    float m = ZOO_NEG_INF, l = 0.f;
    float acc[VPL][VEC];
#pragma unroll
    for (int k = 0; k < VPL; ++k)
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[k][e] = 0.f;
    const int n_live = p1 - p0;
    const int* row_table =
        a.table + (long long)b * a.width + split * a.pages_per_split;
    // position u of this group: split-local lpos = slot * ps + row, moved
    // on by U * stride each round without a division
    int slot[U], row[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int lpos = u * stride + warp * per_warp + gi;
      slot[u] = lpos / ps;
      row[u] = lpos - slot[u] * ps;
    }
    const int step_slots = U * stride / ps, step_rows = U * stride % ps;
    // one round: U positions' K and V vectors (and int8 scales) in
    // registers, then the positions moved on
    auto load = [&](Round<INT8, VEC, VPL, U>& r) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        r.live[u] = slot[u] * ps + row[u] < n_live;
        r.ks[u] = 1.f;
        r.vs[u] = 1.f;
        if (r.live[u]) {
          const int page = clamp_page(__ldg(row_table + slot[u]), a.n_pages);
          if (INT8) {
            if (a.k_scales != nullptr) r.ks[u] = __ldg(a.k_scales + page);
            if (a.v_scales != nullptr) r.vs[u] = __ldg(a.v_scales + page);
          }
          const long long at = ((long long)page * ps + row[u]) * nv;
#pragma unroll
          for (int k = 0; k < VPL; ++k) {
            const int v = gl + k * group;
            if (v < nv) {
              r.k[u][k] = __ldg(kp + at + v);
              r.v[u][k] = __ldg(vp + at + v);
            }
          }
        }
        slot[u] += step_slots;
        row[u] += step_rows;
        if (row[u] >= ps) {
          row[u] -= ps;
          ++slot[u];
        }
      }
    };
    Round<INT8, VEC, VPL, U> cur, nxt;
    load(cur);
    // the trip count is the same for every lane of the block, so the
    // group shuffles see whole warps
    for (int it = 0; it < n_live; it += U * stride) {
      const bool more = it + U * stride < n_live;
      // pipelined, the next round's loads are in flight while this round
      // folds
      if (PIPE && more) load(nxt);
      const auto& kr = cur.k;
      const auto& vr = cur.v;
      const auto& ks = cur.ks;
      const auto& vs = cur.vs;
      const auto& live = cur.live;
      // the dot product in fp64 (each product exact), rounded once to
      // fp32: the score is the correctly rounded q . k before the fp32
      // multiply by softmax_scale
      float s[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        double part = 0.0;
        if (live[u]) {
#pragma unroll
          for (int k = 0; k < VPL; ++k) {
            if (gl + k * group < nv) {
              float x[VEC];
              widen(kr[u][k], ks[u], x);
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                part = fma(qv[k][e], (double)x[e], part);
            }
          }
        }
        for (int o = group >> 1; o > 0; o >>= 1)
          part += __shfl_xor_sync(FULL_MASK, part, o);
        s[u] = __double2float_rn(part) * a.softmax_scale;
      }
      if (live[0]) {  // positions grow with u: live[u] implies live[0]
        float m_new = m;
#pragma unroll
        for (int u = 0; u < U; ++u)
          if (live[u]) m_new = fmaxf(m_new, s[u]);
        const float alpha = expf(m - m_new);
        l *= alpha;
#pragma unroll
        for (int k = 0; k < VPL; ++k)
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[k][e] *= alpha;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (live[u]) {
            const float p = expf(s[u] - m_new);
            l += p;
#pragma unroll
            for (int k = 0; k < VPL; ++k) {
              if (gl + k * group < nv) {
                float x[VEC];
                widen(vr[u][k], vs[u], x);
#pragma unroll
                for (int e = 0; e < VEC; ++e)
                  acc[k][e] = fmaf(p, x[e], acc[k][e]);
              }
            }
          }
        }
        m = m_new;
      }
      if (more) {
        if (PIPE) {
          cur = nxt;
        } else {
          load(cur);
        }
      }
    }
    // the groups of the warp, lower group first in every pair
    for (int o = group; o < 32; o <<= 1) {
      const bool low = (lane & o) == 0;
      const float m_o = __shfl_xor_sync(FULL_MASK, m, o);
      const float l_o = __shfl_xor_sync(FULL_MASK, l, o);
      const float ma = low ? m : m_o, mb = low ? m_o : m;
      const float mn = fmaxf(ma, mb);
      const float wa = expf(ma - mn), wb = expf(mb - mn);
      l = (low ? l : l_o) * wa + (low ? l_o : l) * wb;
#pragma unroll
      for (int k = 0; k < VPL; ++k)
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          const float x_o = __shfl_xor_sync(FULL_MASK, acc[k][e], o);
          acc[k][e] = (low ? acc[k][e] : x_o) * wa + (low ? x_o : acc[k][e]) * wb;
        }
      m = mn;
    }
    float* ws = smem + warp * state;
    if (lane == 0) {
      ws[0] = m;
      ws[1] = l;
    }
    if (lane < group) {
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int v = lane + k * group;
        if (v < nv) {
#pragma unroll
          for (int e = 0; e < VEC; ++e) ws[2 + v * VEC + e] = acc[k][e];
        }
      }
    }
    __syncthreads();
    // the warps of the block, in warp order
    float mb = ZOO_NEG_INF;
#pragma unroll
    for (int w = 0; w < W; ++w) mb = fmaxf(mb, smem[w * state]);
    float wt[W];
    float lb = 0.f;
#pragma unroll
    for (int w = 0; w < W; ++w) {
      wt[w] = expf(smem[w * state] - mb);
      lb += smem[w * state + 1] * wt[w];
    }
    if (splits == 1) {
      const float den = lb == 0.f ? 1.f : lb;
      for (int j = threadIdx.x; j < dim; j += blockDim.x) {
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) x += smem[w * state + 2 + j] * wt[w];
        a.out[(long long)b * dim + j] = x / den;
      }
    } else {
      float* dst = a.work + ((long long)b * splits + split) * state;
      if (threadIdx.x == 0) {
        dst[0] = mb;
        dst[1] = lb;
      }
      for (int j = threadIdx.x; j < dim; j += blockDim.x) {
        float x = 0.f;
#pragma unroll
        for (int w = 0; w < W; ++w) x += smem[w * state + 2 + j] * wt[w];
        dst[2 + j] = x;
      }
    }
    __syncthreads();  // smem is rewritten for the next row
  }
}

// One block per row folds the row's split partials: m* = max m_s (exact in
// any order); warp w sums splits [w * chunk, (w + 1) * chunk) in split
// order, lanes over the columns and l; then the warps' sums in warp order.
// A fixed order: the same partials give the same bits.
__global__ void __launch_bounds__(COMBINE_THREADS)
    paged_attention_combine_kernel(const float* __restrict__ work,
                                   float* __restrict__ out, int splits,
                                   int dim) {
  extern __shared__ float sh[];  // weight[splits], then W sums of dim + 1
  __shared__ float red[COMBINE_THREADS / 32];
  constexpr int W = COMBINE_THREADS / 32;
  float* weight = sh;
  float* part = sh + splits;
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int state = dim + 2;
  const float* w = work + (long long)b * splits * state;
  float m = ZOO_NEG_INF;
  for (int s = threadIdx.x; s < splits; s += COMBINE_THREADS)
    m = fmaxf(m, w[(long long)s * state]);
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(FULL_MASK, m, o));
  if (lane == 0) red[warp] = m;
  __syncthreads();
  m = red[0];
#pragma unroll
  for (int i = 1; i < W; ++i) m = fmaxf(m, red[i]);
  for (int s = threadIdx.x; s < splits; s += COMBINE_THREADS)
    weight[s] = expf(w[(long long)s * state] - m);
  __syncthreads();
  const int chunk = (splits + W - 1) / W;
  const int lo = min(warp * chunk, splits), hi = min(lo + chunk, splits);
  for (int j = lane; j <= dim; j += 32) {  // j == dim: l
    const int col = j == dim ? 1 : 2 + j;
    float x = 0.f;
#pragma unroll 4
    for (int s = lo; s < hi; ++s) x += w[(long long)s * state + col] * weight[s];
    part[warp * (dim + 1) + j] = x;
  }
  __syncthreads();
  float l = 0.f;
#pragma unroll
  for (int i = 0; i < W; ++i) l += part[i * (dim + 1) + dim];
  const float den = l == 0.f ? 1.f : l;
  for (int j = threadIdx.x; j < dim; j += COMBINE_THREADS) {
    float x = 0.f;
#pragma unroll
    for (int i = 0; i < W; ++i) x += part[i * (dim + 1) + j];
    out[(long long)b * dim + j] = x / den;
  }
}

template <bool INT8, int VEC, int VPL>
static void launch_split(const AttnArgs& a, dim3 grid, cudaStream_t stream) {
  const size_t shared = (size_t)(ATTN_THREADS / 32) * (a.dim + 2) *
                        sizeof(float);
  paged_attention_kernel<INT8, VEC, VPL>
      <<<grid, ATTN_THREADS, shared, stream>>>(a);
}

// The smallest VPL (a power of two) >= vpl that a row of at most 1024
// elements needs.
template <bool INT8, int VEC, int VPL>
static void launch_split_at(int vpl, const AttnArgs& a, dim3 grid,
                            cudaStream_t stream) {
  if constexpr (VPL * VEC * 32 < 1024) {
    if (vpl > VPL) {
      launch_split_at<INT8, VEC, VPL * 2>(vpl, a, grid, stream);
      return;
    }
  }
  launch_split<INT8, VEC, VPL>(a, grid, stream);
}

static void launch_combine(const float* work, float* out, int batch,
                           int splits, int dim, cudaStream_t stream) {
  // splits + 8 * (dim + 1) floats: at most 36 KB (1024 splits, dim 1024)
  const size_t shared =
      (size_t)(splits + (COMBINE_THREADS / 32) * (dim + 1)) * sizeof(float);
  paged_attention_combine_kernel<<<batch, COMBINE_THREADS, shared, stream>>>(
      work, out, splits, dim);
}

extern "C" {

// pool [n_pages, page_size, dim] fp32 (is_int8 == 0) or int8; scales
// [n_pages] fp32 or null (scale 1; read only for int8); table [batch, width]
// int32; lengths [batch] int32; out [batch, out_len, dim] fp32, out_len <=
// width * page_size. All contiguous, on `device`. Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
int zoo_paged_gather(const void* pool, const float* scales, const int* table,
                     const int* lengths, float* out, int batch, int width,
                     int page_size, int dim, int n_pages, int out_len,
                     int is_int8, int device, void* stream) {
  if (batch < 0 || batch > 65535 || width < 1 || page_size < 1 || dim < 1 ||
      n_pages < 1 || (long long)width * page_size > 0x3fffffffLL ||
      (long long)dim * page_size > 0x7fffffffLL || out_len < 0 ||
      out_len > width * page_size)
    return (int)cudaErrorInvalidValue;
  if (batch == 0 || out_len == 0) return (int)cudaSuccess;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_int8) {
    launch_gather<true>(pool, scales, table, lengths, out, batch, width,
                        page_size, dim, n_pages, out_len, s);
  } else {
    launch_gather<false>(pool, scales, table, lengths, out, batch, width,
                         page_size, dim, n_pages, out_len, s);
  }
  return (int)cudaGetLastError();
}

// q [batch, dim] fp32; k_pool, v_pool as the gather's pool (one dtype);
// k_scales, v_scales [n_pages] fp32 or null; out [batch, dim] fp32; work
// [batch, splits, dim + 2] fp32 (null when splits == 1). dim <= 1024. The
// row's page slots are cut into `splits` runs of pages_per_split (every
// slot in exactly one). One launch when splits == 1, the split kernel and
// the combine otherwise; with more than one split, work holds the splits'
// partials afterwards. Same return convention.
int zoo_paged_attention(const float* q, const void* k_pool,
                        const void* v_pool, const float* k_scales,
                        const float* v_scales, const int* table,
                        const int* lengths, float* out, float* work,
                        int batch, int width, int page_size, int dim,
                        int n_pages, int is_int8, int splits,
                        int pages_per_split, int device, void* stream,
                        float softmax_scale) {
  if (batch < 0 || width < 1 || page_size < 1 || dim < 1 || dim > 1024 ||
      n_pages < 1 || (long long)width * page_size > 0x3fffffffLL ||
      splits < 1 || splits > ATTN_MAX_SPLITS || pages_per_split < 1 ||
      (long long)splits * pages_per_split < width ||
      (long long)(splits - 1) * pages_per_split >= width ||
      (splits > 1 && work == nullptr))
    return (int)cudaErrorInvalidValue;
  if (batch == 0) return (int)cudaSuccess;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 16-byte vectors (int8: 16 or 4 bytes) need whole vectors per row and
  // aligned pool bases (a tensor with a storage offset may not be)
  const uintptr_t bases = (uintptr_t)k_pool | (uintptr_t)v_pool;
  int vec = 1;
  if (is_int8) {
    if (dim % 16 == 0 && bases % 16 == 0) {
      vec = 16;
    } else if (dim % 4 == 0 && bases % 4 == 0) {
      vec = 4;
    }
  } else if (dim % 4 == 0 && bases % 16 == 0) {
    vec = 4;
  }
  const int nv = dim / vec;
  int log_group = 0;
  while ((1 << log_group) < nv && log_group < 5) ++log_group;
  const int vpl = (nv + (1 << log_group) - 1) >> log_group;
  AttnArgs a;
  a.q = q;
  a.k_pool = k_pool;
  a.v_pool = v_pool;
  a.k_scales = k_scales;
  a.v_scales = v_scales;
  a.table = table;
  a.lengths = lengths;
  a.out = out;
  a.work = work;
  a.batch = batch;
  a.width = width;
  a.page_size = page_size;
  a.dim = dim;
  a.n_pages = n_pages;
  a.softmax_scale = softmax_scale;
  a.pages_per_split = pages_per_split;
  a.log_group = log_group;
  const dim3 grid((unsigned)splits, (unsigned)(batch < 65535 ? batch : 65535));
  if (is_int8) {
    if (vec == 16) {
      launch_split_at<true, 16, 1>(vpl, a, grid, s);
    } else if (vec == 4) {
      launch_split_at<true, 4, 1>(vpl, a, grid, s);
    } else {
      launch_split_at<true, 1, 1>(vpl, a, grid, s);
    }
  } else if (vec == 4) {
    launch_split_at<false, 4, 1>(vpl, a, grid, s);
  } else {
    launch_split_at<false, 1, 1>(vpl, a, grid, s);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  launch_combine(work, out, batch, splits, dim, s);
  return (int)cudaGetLastError();
}

const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
