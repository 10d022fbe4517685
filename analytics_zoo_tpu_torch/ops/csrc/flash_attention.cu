// Flash-attention forward for Hopper (sm_90a), fp32 and bf16.
//
// Replaces analytics_zoo_tpu/ops/flash_attention.py:156 _flash_fwd_kernel,
// the Pallas TPU kernel launched by _flash_fwd. For q [b, sq, h, d] and
// k, v [b, sk, h, d] (any batch, sequence and head strides; d contiguous,
// d <= 128) it computes o [b, sq, h, d] in q's dtype and, when asked, the
// per-row logsumexp lse [b*h, sq] in fp32, with the arithmetic of the
// Pallas body, which runs both products in the input dtype on the matrix
// unit with fp32 accumulation:
//   s = (q . k) * sm_scale      fp32 sum of the exact products of the
//                               inputs, then one fp32 multiply by
//                               sm_scale = 1/sqrt(d)
//   masked s = -1e30            keys at or past sk, and with `causal` keys
//                               past q_row + (sk - sq) (bottom-right causal)
//   online softmax              over key tiles of 64: fp32 running max m
//                               and sum l per row; l sums the unrounded p
//   o += round(p) . v           p rounded to v's dtype (bf16) before P.V,
//                               fp32 accumulation
//   o / max(l, 1e-37)           lse = m + log(max(l, 1e-37))
// Key tiles that lie wholly in the future of every row of a query tile
// are skipped. A masked key always gets p = 0: a row that sees no key
// gives o = 0 and lse = -1e30 whatever the tile sizes (the Pallas kernel
// gives such a row uniform weights over the tiles it visits; ROADMAP C3).
//
// Bound: at BERT-Base's shape (s 512, d 64) 4*b*h*sq*sk*d flops against
// (2*b*sq + 2*b*sk)*h*d elements moved is 64 flops per bf16 byte: in bf16
// under the tensor cores' ridge (about 295), so bytes bound it; in fp32,
// on CUDA cores at 67 TFLOP/s, operations do.
//
// Both kernels stage K and V tiles of 64 keys in shared memory with
// 16-byte cp.async copies of the next tile running while this one
// computes. The wrapper guarantees 16-byte aligned rows (it copies
// otherwise); columns past d up to the padded head dim D are zero-filled,
// so they add exact zeros.
//
// bf16 (flash_fwd_bf16_kernel): the FlashAttention-2 layout on the tensor
// cores with mma.sync.m16n8k16 (bf16 in, fp32 accumulate). A CTA of W
// warps (8 at d <= 64, 4 at d <= 128, for registers) owns 16 W query
// rows, each warp 16. Q is loaded once into A
// fragments with ldmatrix; K and V stay bf16 in shared memory, rows padded
// by 16 bytes so the 8 row addresses of each ldmatrix hit distinct banks.
// S = Q.K^T takes K's fragments by ldmatrix; the online softmax runs in
// registers (quad shuffles for the row max, thread-partial row sums
// reduced once at the end); p is rounded to bf16 in registers and reused
// as the A fragment of P.V, whose B fragments are V read by
// ldmatrix.trans. Masking is applied only on tiles that cross sk or the
// causal diagonal of the warp's rows.
//
// fp32 (flash_fwd_f32_kernel): TF32 keeps about 3 decimal digits, short
// of the 1e-5 limit against the plain version, so fp32 stays on CUDA
// cores, register-tiled to raise FMAs per shared-memory load: each of 128
// threads owns R rows (8 at d <= 64, 4 at d <= 128) x 8 keys of the score
// tile and R rows x D/8 columns of the accumulator; every 16-byte load of
// Q, K, P or V feeds R or 8 FMAs per element, the loads of a warp are
// broadcasts or hit distinct banks (rows padded by 16 bytes, V columns
// interleaved by 4), and p goes through shared memory to P.V. Its K and
// V tiles have one buffer each (so two CTAs of 128 rows fit an SM at
// d <= 64): the next K copies during softmax and P.V, the next V during
// the next S.
//
// Resources (nvcc 12.8 -Xptxas -v for sm_90a; chip_smoke.py prints them),
// no spills: bf16 126 registers at d <= 64 (8 warps, 54 KiB of shared
// memory: 2 CTAs an SM), 166 at d <= 128 (4 warps, 85 KiB); fp32 251-254
// (101 KiB at d <= 64: 2 CTAs an SM; 115 KiB at d <= 128). Dynamic shared
// memory past 48 KB is opted into per instantiation with
// cudaFuncSetAttribute; a refused launch returns its error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBK = 64;  // keys per tile (BLOCK_K in ops/flash_attention.py)
constexpr int kThreads = 128;  // the fp32 kernel's
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;  // fp32 log2(e)

struct Strides {  // in elements; the head dim has stride 1
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h;
};

// ------------------------------------------------------------ PTX helpers

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a . b on the tensor cores: a 16x16 bf16 (row), b 16x8 bf16 (col),
// d 16x8 fp32
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16 (round to nearest even), lo in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// p = exp(x - m) as exp2 of the rounded difference times log2(e), each
// step one fp32 rounding (a p below 2^-126, which ftz flushes to zero,
// moves no output). The plain version takes torch.exp: the two differ in
// the last bits, which in bf16 can round a p to its other neighbour (the
// flip term of chip_smoke.py's bf16 limit)
__device__ __forceinline__ float exp_diff(float x, float m) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"((x - m) * kLog2e));
  return y;
}

// Rows [row0, row0 + ROWS) of a [rows, d] slab with `row_stride`, into
// shared memory with row stride LD, by 16-byte cp.async: columns [0, dl),
// dl a multiple of 16 bytes; rows past n_rows and columns past dl, up to
// DMAX, are zero-filled.
template <typename T, int ROWS, int DMAX, int LD, int THREADS>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src,
                                          long long row_stride, int row0,
                                          int n_rows, int dl) {
  constexpr int kVec = 16 / (int)sizeof(T);
  constexpr int kChunks = DMAX / kVec;
  for (int i = threadIdx.x; i < ROWS * kChunks; i += THREADS) {
    const int r = i / kChunks;
    const int c = (i - r * kChunks) * kVec;
    T* d = dst + r * LD + c;
    const int row = row0 + r;
    if (row < n_rows && c < dl) {
      cp_async16(d, src + (long long)row * row_stride + c);
    } else {
      *reinterpret_cast<uint4*>(d) = make_uint4(0u, 0u, 0u, 0u);
    }
  }
}

// key tiles a query tile [q0, q0 + bq) visits: causal skips the tiles wholly
// in the future of its last row
__device__ __forceinline__ int key_tiles(int q0, int bq, int sk, int causal,
                                         int causal_off) {
  int n = (sk + kBK - 1) / kBK;
  if (causal) {
    const int last = q0 + bq - 1 + causal_off;
    n = last < 0 ? 0 : min(n, last / kBK + 1);
  }
  return n;
}

// ---------------------------------------------------------- bf16, mma.sync

template <int D, int W>
struct Bf16Tiles {
  static constexpr int kBQ = 16 * W;   // W warps x 16 query rows
  static constexpr int kLd = D + 8;    // row stride: 16 bytes of padding
  static constexpr int kQ = kBQ * kLd;
  static constexpr int kKV = kBK * kLd;
  static constexpr int kBytes = (kQ + 4 * kKV) * 2;  // Q, K[2], V[2]
};

// The online softmax of one key tile in registers. s: the scores as 8
// n-tiles of the m16n8 C fragment (element e of n-tile j is row row0 +
// 8 (e >> 1), key k0 + 8 j + 2 tig + (e & 1)): scaled, masked when MASK
// (keys at or past sk, causal), the running max m of rows row0 and
// row0 + 8 raised, p = exp(s - m) summed unrounded into this thread's l
// and rounded to bf16 into pa, the A fragments of P.V (the C fragment of
// n-tiles 2kk, 2kk + 1 is the A fragment of keys [16 kk, 16 kk + 16):
// a0/a1 from the first, a2/a3 from the second); corr rescales the
// accumulator's rows.
template <bool MASK>
__device__ __forceinline__ void softmax_tile(float (&s)[8][4],
                                             uint32_t (&pa)[4][4],
                                             float (&m)[2], float (&l)[2],
                                             float (&corr)[2], float sm_scale,
                                             int k0, int row0, int tig,
                                             int sk, int causal,
                                             int causal_off) {
  float mx[2] = {kNegInf, kNegInf};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = s[j][e] * sm_scale;
      if (MASK) {
        const int key = k0 + 8 * j + 2 * tig + (e & 1);
        const int row = row0 + 8 * (e >> 1);
        if (key >= sk || (causal && key > row + causal_off)) x = kNegInf;
      }
      s[j][e] = x;
      mx[e >> 1] = fmaxf(mx[e >> 1], x);
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    // the 4 threads of a row are the lanes of one quad
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    corr[r] = exp_diff(m[r], m_new);
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = MASK && s[j][e] == kNegInf ? 0.f : exp_diff(s[j][e], m[e >> 1]);
    rs[0] += p[0] + p[1];
    rs[1] += p[2] + p[3];
    pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
    pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * corr[r] + rs[r];
}

template <int D, int W>
__global__ void __launch_bounds__(32 * W)
    flash_fwd_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ o,
                          float* __restrict__ lse, int h, int sq, int sk,
                          int d, Strides st, int causal, float sm_scale) {
  using L = Bf16Tiles<D, W>;
  constexpr int kLd = L::kLd;
  constexpr int kT = 32 * W;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + L::kQ;       // [2][kBK][kLd]
  __nv_bfloat16* vs = ks + 2 * L::kKV;  // [2][kBK][kLd]

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h;
  const int q0 = blockIdx.y * L::kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // fragment row group, column
  const int causal_off = sk - sq;
  const int dl = (d + 7) & ~7;
  const int wrow0 = q0 + warp * 16;  // this warp's first query row
  const __nv_bfloat16* kb = k + bi * st.k_b + hi * st.k_h;
  const __nv_bfloat16* vb = v + bi * st.v_b + hi * st.v_h;
  const int n_tiles = key_tiles(q0, L::kBQ, sk, causal, causal_off);

  load_tile<__nv_bfloat16, L::kBQ, D, kLd, kT>(
      qs, q + bi * st.q_b + hi * st.q_h, st.q_s, q0, sq, dl);
  if (n_tiles > 0) {
    load_tile<__nv_bfloat16, kBK, D, kLd, kT>(ks, kb, st.k_s, 0, sk, dl);
    load_tile<__nv_bfloat16, kBK, D, kLd, kT>(vs, vb, st.v_s, 0, sk, dl);
  }
  cp_async_commit();

  // accumulator: D/8 n-tiles of 16 rows x 8 columns; rows g and g + 8
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's columns only, summed at the end
  uint32_t qa[D / 16][4];   // Q as A fragments, one per 16 columns of d

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<__nv_bfloat16, kBK, D, kLd, kT>(
          ks + (buf ^ 1) * L::kKV, kb, st.k_s, (t + 1) * kBK, sk, dl);
      load_tile<__nv_bfloat16, kBK, D, kLd, kT>(
          vs + (buf ^ 1) * L::kKV, vb, st.v_s, (t + 1) * kBK, sk, dl);
      cp_async_commit();
      cp_async_wait<1>();  // all but the tile just asked for
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) {
      // ldmatrix x4: lanes 8i..8i+7 address matrix i = (rows +8 if i odd,
      // columns +8 if i >= 2), giving a0..a3 of the m16k16 fragment
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldmatrix_x4(qa[kk], qs + (warp * 16 + (lane & 7) +
                                  ((lane >> 3) & 1) * 8) * kLd +
                                kk * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = ks + buf * L::kKV;
    const __nv_bfloat16* vt = vs + buf * L::kKV;

    // S = Q.K^T: 8 n-tiles of 8 keys
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        // matrices: keys +0 / +8 (i >= 2), columns +0 / +8 (i odd): b0, b1
        // of n-tile 2 nj, then of 2 nj + 1
        uint32_t b[4];
        ldmatrix_x4(b, kt + (nj * 16 + (lane & 7) + (lane >> 4) * 8) * kLd +
                           kk * 16 + ((lane >> 3) & 1) * 8);
        mma_bf16(s[2 * nj], qa[kk], b[0], b[1]);
        mma_bf16(s[2 * nj + 1], qa[kk], b[2], b[3]);
      }
    }

    // masks apply only on tiles that cross sk or the causal diagonal of
    // this warp's rows
    const int k0 = t * kBK;
    uint32_t pa[4][4];
    float corr[2];
    if (k0 + kBK > sk || (causal && k0 + kBK - 1 > wrow0 + causal_off)) {
      softmax_tile<true>(s, pa, m, l, corr, sm_scale, k0, wrow0 + g, tig, sk,
                         causal, causal_off);
    } else {
      softmax_tile<false>(s, pa, m, l, corr, sm_scale, k0, wrow0 + g, tig,
                          sk, causal, causal_off);
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= corr[0];
      acc[n][1] *= corr[0];
      acc[n][2] *= corr[1];
      acc[n][3] *= corr[1];
    }

    // O += round(P).V: V's B fragments by ldmatrix.trans (matrices: keys
    // +0 / +8 (i odd), columns +0 / +8 (i >= 2))
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nd = 0; nd < D / 16; ++nd) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vt + (kk * 16 + (lane & 7) +
                                   ((lane >> 3) & 1) * 8) * kLd +
                                 nd * 16 + (lane >> 4) * 8);
        mma_bf16(acc[2 * nd], pa[kk], b[0], b[1]);
        mma_bf16(acc[2 * nd + 1], pa[kk], b[2], b[3]);
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (n_tiles == 0)

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = wrow0 + g + 8 * r;
    if (row >= sq) continue;
    const float l_fin = fmaxf(l[r], 1e-37f);
    __nv_bfloat16* orow = o + (((long long)bi * sq + row) * h + hi) * d;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * tig;
      const float x0 = acc[n][2 * r] / l_fin;
      const float x1 = acc[n][2 * r + 1] / l_fin;
      if (col + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) orow[col] = __float2bfloat16_rn(x0);
        if (col + 1 < d) orow[col + 1] = __float2bfloat16_rn(x1);
      }
    }
    if (lse != nullptr && tig == 0)
      lse[(long long)bh * sq + row] = m[r] + logf(l_fin);
  }
}

// ---------------------------------------------------- fp32, register tiles

template <int D, int R>
struct F32Tiles {
  static constexpr int kBQ = 16 * R;     // 16 row groups of R rows
  static constexpr int kLdQK = D + 4;    // Q and K rows: 16 bytes padding
  static constexpr int kLdV = D;         // V: columns interleaved by 4
  static constexpr int kLdP = kBK + 4;
  static constexpr int kQ = kBQ * kLdQK;
  static constexpr int kK = kBK * kLdQK;
  static constexpr int kV = kBK * kLdV;
  static constexpr int kP = kBQ * kLdP;
  static constexpr int kBytes = (kQ + kK + kV + kP) * 4;
};

// K and V have one buffer each: the next K tile copies while softmax and
// P.V run, the next V tile while the next S runs, so two CTAs fit an SM
template <int D, int R>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_f32_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int h, int sq, int sk,
                         int d, Strides st, int causal, float sm_scale) {
  using L = F32Tiles<D, R>;
  constexpr int kC4 = D / 32;  // float4 column groups per thread
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);
  float* ks = qs + L::kQ;  // [kBK][kLdQK]
  float* vs = ks + L::kK;  // [kBK][kLdV]
  float* ps = vs + L::kV;  // [kBQ][kLdP]

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h;
  const int q0 = blockIdx.y * L::kBQ;
  // ty owns rows ty + 16 i, tx keys tx + 8 j and columns tx * 4 + 32 c4 + e
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int causal_off = sk - sq;
  const int dl = (d + 3) & ~3;
  const float* kb = k + bi * st.k_b + hi * st.k_h;
  const float* vb = v + bi * st.v_b + hi * st.v_h;
  const int n_tiles = key_tiles(q0, L::kBQ, sk, causal, causal_off);

  // copy groups, oldest first: {Q, K0}, {V0}, then per tile {K t+1} after
  // S and {V t+1} after P.V
  load_tile<float, L::kBQ, D, L::kLdQK, kThreads>(
      qs, q + bi * st.q_b + hi * st.q_h, st.q_s, q0, sq, dl);
  if (n_tiles > 0)
    load_tile<float, kBK, D, L::kLdQK, kThreads>(ks, kb, st.k_s, 0, sk, dl);
  cp_async_commit();
  if (n_tiles > 0)
    load_tile<float, kBK, D, L::kLdV, kThreads>(vs, vb, st.v_s, 0, sk, dl);
  cp_async_commit();

  float m[R], l[R], acc[R][D / 8];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const bool more = t + 1 < n_tiles;
    cp_async_wait<1>();  // K t has landed; V t may still be in flight
    __syncthreads();

    // s[i][j]: row ty + 16 i, key tx + 8 j
    float s[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int kk = 0; kk < D; kk += 4) {
      float4 a[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            qs + (ty + 16 * i) * L::kLdQK + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 b = *reinterpret_cast<const float4*>(
            ks + (tx + 8 * j) * L::kLdQK + kk);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          s[i][j] = fmaf(a[i].x, b.x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b.y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b.z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b.w, s[i][j]);
        }
      }
    }

    __syncthreads();  // K t is consumed: copy K t+1 during softmax, P.V
    if (more)
      load_tile<float, kBK, D, L::kLdQK, kThreads>(ks, kb, st.k_s,
                                                   (t + 1) * kBK, sk, dl);
    cp_async_commit();

    const int k0 = t * kBK;
#pragma unroll
    for (int i = 0; i < R; ++i) {
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
        const float p = (masked >> j) & 1u ? 0.f : exp_diff(s[i][j], m_new);
        row_sum += p;
        ps[row * L::kLdP + tx + 8 * j] = p;
      }
      const float corr = exp_diff(m[i], m_new);
      l[i] = l[i] * corr + row_sum;  // this thread's keys; summed at the end
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 8; ++c) acc[i][c] *= corr;
    }
    cp_async_wait<1>();  // V t has landed (K t+1 may still be in flight)
    __syncthreads();

    // acc[i][4 c4 + e] += sum_key P[row i, key] * V[key, tx * 4 + 32 c4 + e]
#pragma unroll 2
    for (int key = 0; key < kBK; key += 4) {
      float4 p4[R];
#pragma unroll
      for (int i = 0; i < R; ++i)
        p4[i] = *reinterpret_cast<const float4*>(
            ps + (ty + 16 * i) * L::kLdP + key);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float4 vv[kC4];
#pragma unroll
        for (int c4 = 0; c4 < kC4; ++c4)
          vv[c4] = *reinterpret_cast<const float4*>(
              vs + (key + u) * L::kLdV + tx * 4 + 32 * c4);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = u == 0 ? p4[i].x
                          : u == 1 ? p4[i].y
                          : u == 2 ? p4[i].z
                                   : p4[i].w;
#pragma unroll
          for (int c4 = 0; c4 < kC4; ++c4) {
            acc[i][4 * c4 + 0] = fmaf(p, vv[c4].x, acc[i][4 * c4 + 0]);
            acc[i][4 * c4 + 1] = fmaf(p, vv[c4].y, acc[i][4 * c4 + 1]);
            acc[i][4 * c4 + 2] = fmaf(p, vv[c4].z, acc[i][4 * c4 + 2]);
            acc[i][4 * c4 + 3] = fmaf(p, vv[c4].w, acc[i][4 * c4 + 3]);
          }
        }
      }
    }
    __syncthreads();  // V t and P are consumed: copy V t+1 during S
    if (more)
      load_tile<float, kBK, D, L::kLdV, kThreads>(vs, vb, st.v_s,
                                                  (t + 1) * kBK, sk, dl);
    cp_async_commit();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int w = 1; w < 8; w <<= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], w);
    const int q_row = q0 + ty + 16 * i;
    if (q_row >= sq) continue;
    const float l_fin = fmaxf(l[i], 1e-37f);
    float* orow = o + (((long long)bi * sq + q_row) * h + hi) * d;
#pragma unroll
    for (int c4 = 0; c4 < kC4; ++c4) {
      const int col = tx * 4 + 32 * c4;
      const float4 x = make_float4(
          acc[i][4 * c4 + 0] / l_fin, acc[i][4 * c4 + 1] / l_fin,
          acc[i][4 * c4 + 2] / l_fin, acc[i][4 * c4 + 3] / l_fin);
      if (col + 3 < d && (d & 3) == 0) {
        *reinterpret_cast<float4*>(orow + col) = x;
      } else {
        if (col + 0 < d) orow[col + 0] = x.x;
        if (col + 1 < d) orow[col + 1] = x.y;
        if (col + 2 < d) orow[col + 2] = x.z;
        if (col + 3 < d) orow[col + 3] = x.w;
      }
    }
    if (lse != nullptr && tx == 0)
      lse[(long long)bh * sq + q_row] = m[i] + logf(l_fin);
  }
}

// ------------------------------------------------------------------ launch

template <int D, int W>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o,
                        float* lse, int b, int h, int sq, int sk, int d,
                        const Strides& st, int causal, float sm_scale,
                        cudaStream_t stream) {
  using L = Bf16Tiles<D, W>;
  auto kernel = flash_fwd_bf16_kernel<D, W>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + L::kBQ - 1) / L::kBQ));
  kernel<<<grid, 32 * W, L::kBytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      lse, h, sq, sk, d, st, causal, sm_scale);
  return cudaGetLastError();
}

template <int D, int R>
cudaError_t launch_f32(const void* q, const void* k, const void* v, void* o,
                       float* lse, int b, int h, int sq, int sk, int d,
                       const Strides& st, int causal, float sm_scale,
                       cudaStream_t stream) {
  using L = F32Tiles<D, R>;
  auto kernel = flash_fwd_f32_kernel<D, R>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(b * h), (unsigned)((sq + L::kBQ - 1) / L::kBQ));
  kernel<<<grid, kThreads, L::kBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, h, sq, sk,
      d, st, causal, sm_scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// q: [b, sq, h, d], k and v: [b, sk, h, d] with the given batch, sequence
// and head strides (elements) and a contiguous head dim, each row starting
// on 16 bytes (pointers and strides multiples of 16 bytes, d a multiple of
// 16 bytes or its row zero-padded to one); o: contiguous [b, sq, h, d] of
// q's dtype (fp32 when is_bf16 == 0, bf16 otherwise); lse: contiguous fp32
// [b*h, sq], or null. Launches on `stream` and returns the CUDA error code
// (0 when the launch was accepted).
int zoo_flash_fwd(const void* q, const void* k, const void* v, void* o,
                  void* lse, int b, int h, int sq, int sk, int d,
                  long long q_b, long long q_s, long long q_h, long long k_b,
                  long long k_s, long long k_h, long long v_b, long long v_s,
                  long long v_h, int causal, float sm_scale, int is_bf16,
                  void* stream) {
  if (b < 0 || h < 0 || sq < 0 || sk < 1 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  if ((long long)b * h > 0x7fffffffLL || (sq + 63) / 64 > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || sq == 0) return (int)cudaSuccess;
  const Strides st{q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  cudaError_t err;
  if (is_bf16) {
    err = d <= 64 ? launch_bf16<64, 8>(q, k, v, o, lse_f, b, h, sq, sk, d,
                                       st, causal, sm_scale, s)
                  : launch_bf16<128, 4>(q, k, v, o, lse_f, b, h, sq, sk, d,
                                        st, causal, sm_scale, s);
  } else {
    err = d <= 64 ? launch_f32<64, 8>(q, k, v, o, lse_f, b, h, sq, sk, d, st,
                                      causal, sm_scale, s)
                  : launch_f32<128, 4>(q, k, v, o, lse_f, b, h, sq, sk, d,
                                       st, causal, sm_scale, s);
  }
  return (int)err;
}

const char* zoo_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
