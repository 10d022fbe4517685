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
//   s  = (q . k) * sm_scale         fp32 sum of the exact products of the
//                                   inputs, then one fp32 multiply by
//                                   sm_scale = 1/sqrt(d)
//   p  = exp(s - lse)               and p = 0 for a masked key: keys at or
//                                   past sk, and with `causal` keys past
//                                   q_row + (sk - sq) (bottom-right causal)
//   dp = dO . v                     fp32 sum of the exact products
//   ds = p * (dp - delta + glse) * sm_scale
//   dq = sum_k round(ds) . k        (dq kernel)
//   dv = sum_q round(p)^T . dO      (dk/dv kernel)
//   dk = sum_q round(ds)^T . q      (dk/dv kernel)
// round() is the inputs' dtype (bf16 rounds to nearest even, fp32 is exact);
// the sums are fp32 and the outputs dq [b, sq, h, d] and dk, dv [b, sk, h,
// d] are contiguous in the inputs' dtype. exp is ex2.approx of
// (s - lse) * log2(e), as in the forward; the plain version takes
// torch.exp, and in bf16 the two can round a p or a ds to its other
// neighbour (chip_smoke.py's bwd_flip_scale). The Pallas kernel lets a
// masked key reach exp(-1e30 - lse); here p is zeroed, so a query row that
// sees no key (causal, sq > sk; the forward gives it o = 0 and lse =
// -1e30) gets dq = 0 and adds nothing to dk or dv. Tiles that lie wholly in
// the masked future are skipped, as the Pallas kernels' `live` does. The
// two kernels split the work as the Pallas pair does, dq over key tiles
// with the query tile resident and dk/dv over query tiles with the key
// tile resident, so no sum crosses CTAs: no atomics, and two runs give the
// same bits.
//
// Bound: dq does 6*d flops per visible (query, key) pair (q.k, dO.v, ds.k)
// and dk/dv 8*d (q.k, dO.v, p.dO, ds.q); dq moves q, k, v, dO, the row
// statistics and dq once, dk/dv the same inputs and dk, dv. At the BERT
// fine-tuning shape (b*h = 384, s = 128, d = 64) that is 2.42 and 3.22
// GFLOP against 31 and 38 MB in bf16: bytes bound bf16 on the tensor cores
// (about 80 flops a byte, under the ridge of about 295), operations bound
// fp32 on CUDA cores.
//
// Every streamed tile is 64 rows (keys for dq, query rows for dk/dv),
// copied by 16-byte cp.async while the previous one computes. The wrapper
// guarantees 16-byte aligned rows (it copies otherwise); columns past d up
// to the padded head dim D and rows past the sequence are zero-filled, so
// they add exact zeros.
//
// bf16 (flash_bwd_{dq,dkv}_bf16_kernel): the FlashAttention-2 backward on
// the tensor cores with mma.sync.m16n8k16 (bf16 in, fp32 accumulate). A CTA
// of W = 4 warps keeps 64 resident rows, each warp 16: query rows (dq) or
// keys (dk/dv), as A fragments loaded once by ldmatrix (at d <= 64; at
// d <= 128 they are read again from shared memory each tile, for
// registers). The streamed tiles stay bf16 in shared memory, double-
// buffered, rows padded by 16 bytes so the 8 row addresses of each
// ldmatrix hit distinct banks. Per tile, in chunks of NC = 32 columns
// (fewer live registers than 64, and faster at d 64):
//   dq:    S = Q.K^T and dP = dO.V^T (B fragments by ldmatrix); p and ds in
//          registers from the warp's two rows' lse, delta and glse; ds
//          rounded to bf16 straight into the A fragments of dQ += dS.K,
//          whose B fragments are K read by ldmatrix.trans.
//   dk/dv: S^T = K.Q^T and dP^T = V.dO^T; p^T and ds^T in registers with
//          each column's statistics from shared memory (staged per tile
//          by cp.async); dV += round(p^T).dO and dK += round(ds^T).Q with
//          A fragments from registers and B fragments by ldmatrix.trans.
// Neither ds nor p touches shared memory. Masks apply only on tiles that
// cross sk, sq or the causal diagonal of the warp's rows.
//
// fp32 (flash_bwd_{dq,dkv}_f32_kernel): TF32 keeps about 3 decimal digits,
// short of the 2e-5 limit against the plain version, so fp32 stays on CUDA
// cores, register-tiled: 128 threads, each owning R resident rows x 8
// streamed rows of the score tiles and R rows x D/8 columns of the
// accumulators; every 16-byte load of shared memory feeds R or 8 FMAs per
// element, the loads of a warp are broadcasts or hit distinct banks (rows
// padded by 16 bytes). round(ds) (and round(p)) go through shared memory to
// the products. Each streamed tensor has one buffer, so two CTAs fit an SM
// at d <= 64, and the copies are ordered to overlap compute:
//   dq:    dP first (V), then S (K); V t+1 copies during S, ds and dS.K;
//          K t+1 during the next dP.
//   dk/dv: S^T first (Q), then dP^T (dO); Q t+1 copies during dV += p^T.dO;
//          dO t+1 and its statistics during the next S^T.
//
// Resources (nvcc 12.8 -Xptxas -v for sm_90a; chip_smoke.py prints them;
// dev/flash_bwd_variants.py times the alternatives): bf16 dq 128 registers
// at d <= 64 (4 warps, 54 KiB of shared memory), 172 at d <= 128 (102
// KiB), no spills; bf16 dk/dv at d <= 64 capped at 168 registers by
// __launch_bounds__(128, 3) for 3 CTAs an SM (24 bytes spilled; faster
// than 238 registers and 2 CTAs), 255 at d <= 128 (20 bytes spilled;
// chunks of 16 columns avoid the spill but run slower); fp32 dq 238 (85
// KiB at d <= 64, R = 4: 2 CTAs an SM) and 160 (d <= 128, R = 2), dk/dv
// 254 (103 KiB) and 212, no spills. Dynamic shared memory past 48 KB is
// opted into per instantiation with cudaFuncSetAttribute; a refused launch
// returns its error code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // streamed rows per tile
constexpr int kThreads = 128;  // the fp32 kernels'
constexpr float kLog2e = 1.4426950408889634f;  // fp32 log2(e)

struct Strides {  // in elements; the head dim has stride 1
  long long q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h, o_b, o_s, o_h;
};

// ------------------------------------------------------------ PTX helpers
// (as in flash_attention.cu; each library hashes only its own source)

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
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

// p and ds of one (query row, key) pair: p = exp2((s * sm_scale - lse) *
// log2(e)) by ex2.approx (a p below 2^-126, which ftz flushes to zero,
// moves no output); __fmul_rn keeps nvcc from fusing a scale into the
// neighbouring add, so each step rounds as in the plain version
__device__ __forceinline__ void p_and_ds(float s, float dp, float lse,
                                         float delta, float glse,
                                         bool masked, float sm_scale,
                                         float& p, float& ds) {
  float e;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(e)
      : "f"((__fmul_rn(s, sm_scale) - lse) * kLog2e));
  p = masked ? 0.f : e;
  ds = masked ? 0.f : __fmul_rn(__fmul_rn(p, (dp - delta) + glse), sm_scale);
}

__device__ __forceinline__ bool key_masked(int key, int row, int sk,
                                           int causal, int causal_off) {
  return key >= sk || (causal && key > row + causal_off);
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

// lse, delta and glse (null: zeros) of query rows [row0, row0 + kTile),
// by 4-byte cp.async; rows past n_rows are zero
template <int THREADS>
__device__ __forceinline__ void load_stats(float* lse_s, float* delta_s,
                                           float* glse_s, const float* lse_b,
                                           const float* delta_b,
                                           const float* glse_b, int row0,
                                           int n_rows) {
  for (int i = threadIdx.x; i < kTile; i += THREADS) {
    const int row = row0 + i;
    if (row < n_rows) {
      cp_async4(lse_s + i, lse_b + row);
      cp_async4(delta_s + i, delta_b + row);
      if (glse_b != nullptr)
        cp_async4(glse_s + i, glse_b + row);
      else
        glse_s[i] = 0.f;
    } else {
      lse_s[i] = delta_s[i] = glse_s[i] = 0.f;
    }
  }
}

// key tiles a query tile [q0, q0 + bq) visits: causal skips the tiles wholly
// in the future of its last row
__device__ __forceinline__ int key_tiles(int q0, int bq, int sk, int causal,
                                         int causal_off) {
  int n = (sk + kTile - 1) / kTile;
  if (causal) {
    const int last = q0 + bq - 1 + causal_off;
    n = last < 0 ? 0 : min(n, last / kTile + 1);
  }
  return n;
}

// the first query tile in which some row sees key k0: with causal, rows
// before k0 - (sk - sq) see no key of a tile that starts at k0
__device__ __forceinline__ int first_query_tile(int k0, int causal,
                                                int causal_off) {
  const int need = causal ? k0 - causal_off : 0;
  return need > 0 ? need / kTile : 0;
}

// ---------------------------------------------------------- bf16, mma.sync

using bf16 = __nv_bfloat16;

template <int D, int W>
struct Bf16Tiles {
  static constexpr int kRows = 16 * W;  // resident rows: W warps x 16
  static constexpr int kLd = D + 8;     // row stride: 16 bytes of padding
  static constexpr int kRes = kRows * kLd;
  static constexpr int kStream = kTile * kLd;
  // two resident tiles and two streamed tensors, double-buffered; dk/dv
  // also stages the streamed rows' lse, delta and glse, double-buffered
  static constexpr int kDqBytes = (2 * kRes + 4 * kStream) * 2;
  static constexpr int kDkvBytes = kDqBytes + 6 * kTile * 4;
};

// A fragment (16 x 16) of rows [row0, row0 + 16), columns [16 kk, 16 kk +
// 16) of a [rows][LD] bf16 tile: ldmatrix x4, lanes 8i..8i+7 address matrix
// i = (rows +8 if i odd, columns +8 if i >= 2), giving a0..a3
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile,
                                       int row0, int kk, int lane) {
  ldmatrix_x4(a, tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                     kk * 16 + (lane >> 4) * 8);
}

// B fragments of X^T for two n-tiles, X [rows][LD] with n = rows [n0, n0 +
// 16), k = columns [16 kk, 16 kk + 16): matrices rows +0 / +8 (i >= 2),
// columns +0 / +8 (i odd) give b0, b1 of n-tile n0, then of n0 + 8
template <int LD>
__device__ __forceinline__ void load_b(uint32_t (&b)[4], const bf16* tile,
                                       int n0, int kk, int lane) {
  ldmatrix_x4(b, tile + (n0 + (lane & 7) + (lane >> 4) * 8) * LD + kk * 16 +
                     ((lane >> 3) & 1) * 8);
}

// B fragments of X for two n-tiles, X [rows][LD] with k = rows [16 kk, 16
// kk + 16), n = columns [16 nd, 16 nd + 16), by ldmatrix.trans: matrices
// rows +0 / +8 (i odd), columns +0 / +8 (i >= 2)
template <int LD>
__device__ __forceinline__ void load_b_trans(uint32_t (&b)[4],
                                             const bf16* tile, int kk, int nd,
                                             int lane) {
  ldmatrix_x4_trans(b, tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                  LD +
                           nd * 16 + (lane >> 4) * 8);
}

// rows g and g + 8 of a warp's [16, D] fp32 accumulator (the C fragments of
// D/8 n-tiles) to bf16 rows of a contiguous [.., d] output
template <int D>
__device__ __forceinline__ void store_rows_bf16(const float (&acc)[D / 8][4],
                                                bf16* row_lo, bf16* row_hi,
                                                int d, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    bf16* out = r == 0 ? row_lo : row_hi;
    if (out == nullptr) continue;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int col = 8 * n + 2 * tig;
      const float x0 = acc[n][2 * r], x1 = acc[n][2 * r + 1];
      if (col + 1 < d && (d & 1) == 0) {
        *reinterpret_cast<__nv_bfloat162*>(out + col) =
            __floats2bfloat162_rn(x0, x1);
      } else {
        if (col < d) out[col] = __float2bfloat16_rn(x0);
        if (col + 1 < d) out[col + 1] = __float2bfloat16_rn(x1);
      }
    }
  }
}

template <int D, int W, int NC>
__global__ void __launch_bounds__(32 * W)
    flash_bwd_dq_bf16_kernel(const bf16* __restrict__ q,
                             const bf16* __restrict__ k,
                             const bf16* __restrict__ v,
                             const bf16* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ glse,
                             bf16* __restrict__ dq, int h, int sq, int sk,
                             int d, Strides st, int causal, float sm_scale) {
  using L = Bf16Tiles<D, W>;
  constexpr int kLd = L::kLd;
  constexpr int kT = 32 * W;
  constexpr bool kFragRegs = D <= 64;  // Q and dO fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kLd]
  bf16* dos = qs + L::kRes;                      // [kRows][kLd]
  bf16* ks = dos + L::kRes;                      // [2][kTile][kLd]
  bf16* vs = ks + 2 * L::kStream;                // [2][kTile][kLd]

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h;
  const int q0 = blockIdx.y * L::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;  // fragment row group, column
  const int causal_off = sk - sq;
  const int dl = (d + 7) & ~7;
  const int wrow0 = q0 + warp * 16;  // this warp's first query row
  const bf16* kb = k + bi * st.k_b + hi * st.k_h;
  const bf16* vb = v + bi * st.v_b + hi * st.v_h;
  const int n_tiles = key_tiles(q0, L::kRows, sk, causal, causal_off);

  load_tile<bf16, L::kRows, D, kLd, kT>(qs, q + bi * st.q_b + hi * st.q_h,
                                        st.q_s, q0, sq, dl);
  load_tile<bf16, L::kRows, D, kLd, kT>(
      dos, dout + bi * st.o_b + hi * st.o_h, st.o_s, q0, sq, dl);
  if (n_tiles > 0) {
    load_tile<bf16, kTile, D, kLd, kT>(ks, kb, st.k_s, 0, sk, dl);
    load_tile<bf16, kTile, D, kLd, kT>(vs, vb, st.v_s, 0, sk, dl);
  }
  cp_async_commit();

  // the statistics of this thread's two rows, wrow0 + g and wrow0 + g + 8
  float r_lse[2], r_delta[2], r_glse[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + g + 8 * r;
    const long long at = (long long)bh * sq + row;
    r_lse[r] = row < sq ? lse[at] : 0.f;
    r_delta[r] = row < sq ? delta[at] : 0.f;
    r_glse[r] = (row < sq && glse != nullptr) ? glse[at] : 0.f;
  }

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  uint32_t qa[kFragRegs ? D / 16 : 1][4], doa[kFragRegs ? D / 16 : 1][4];

  const bool warp_rows = wrow0 < sq;  // some of this warp's rows are real
  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      load_tile<bf16, kTile, D, kLd, kT>(ks + (buf ^ 1) * L::kStream, kb,
                                         st.k_s, (t + 1) * kTile, sk, dl);
      load_tile<bf16, kTile, D, kLd, kT>(vs + (buf ^ 1) * L::kStream, vb,
                                         st.v_s, (t + 1) * kTile, sk, dl);
      cp_async_commit();
      cp_async_wait<1>();  // all but the tile just asked for
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kFragRegs) {
      if (t == 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          load_a<kLd>(qa[kk], qs, warp * 16, kk, lane);
          load_a<kLd>(doa[kk], dos, warp * 16, kk, lane);
        }
      }
    }
    const bf16* kt = ks + buf * L::kStream;
    const bf16* vt = vs + buf * L::kStream;
    const int k0 = t * kTile;
    // some row of the warp sees the tile's first key
    const bool live =
        warp_rows && !(causal && k0 > wrow0 + 15 + causal_off);
    // masks apply only on tiles that cross sk or the causal diagonal of
    // this warp's rows
    const bool edge =
        k0 + kTile > sk || (causal && k0 + kTile - 1 > wrow0 + causal_off);
    if (live) {
#pragma unroll
      for (int c0 = 0; c0 < kTile; c0 += NC) {
        // S = Q.K^T and dP = dO.V^T over keys [k0 + c0, k0 + c0 + NC)
        float s[NC / 8][4], dp[NC / 8][4];
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t aq[4], ado[4];
          if constexpr (kFragRegs) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              aq[x] = qa[kk][x];
              ado[x] = doa[kk][x];
            }
          } else {
            load_a<kLd>(aq, qs, warp * 16, kk, lane);
            load_a<kLd>(ado, dos, warp * 16, kk, lane);
          }
#pragma unroll
          for (int nj = 0; nj < NC / 16; ++nj) {
            uint32_t b[4];
            load_b<kLd>(b, kt, c0 + nj * 16, kk, lane);
            mma_bf16(s[2 * nj], aq, b[0], b[1]);
            mma_bf16(s[2 * nj + 1], aq, b[2], b[3]);
            load_b<kLd>(b, vt, c0 + nj * 16, kk, lane);
            mma_bf16(dp[2 * nj], ado, b[0], b[1]);
            mma_bf16(dp[2 * nj + 1], ado, b[2], b[3]);
          }
        }
        // ds in registers, rounded to bf16 into the A fragments of dS.K:
        // the C fragment of n-tiles 2kk, 2kk + 1 is the A fragment of keys
        // [16 kk, 16 kk + 16) (a0/a1 from the first, a2/a3 the second)
        uint32_t dsa[NC / 16][4];
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          float ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const bool masked =
                edge && key_masked(k0 + c0 + 8 * j + 2 * tig + (e & 1),
                                   wrow0 + g + 8 * r, sk, causal,
                                   causal_off);
            float p;
            p_and_ds(s[j][e], dp[j][e], r_lse[r], r_delta[r], r_glse[r],
                     masked, sm_scale, p, ds[e]);
          }
          dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
          dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        // dQ += round(dS).K: K's B fragments by ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < NC / 16; ++kk) {
#pragma unroll
          for (int nd = 0; nd < D / 16; ++nd) {
            uint32_t b[4];
            load_b_trans<kLd>(b, kt + c0 * kLd, kk, nd, lane);
            mma_bf16(acc[2 * nd], dsa[kk], b[0], b[1]);
            mma_bf16(acc[2 * nd + 1], dsa[kk], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();  // no copy outlives the block (n_tiles == 0)

  bf16* rows[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = wrow0 + g + 8 * r;
    rows[r] = row < sq ? dq + (((long long)bi * sq + row) * h + hi) * d
                       : nullptr;
  }
  store_rows_bf16<D>(acc, rows[0], rows[1], d, tig);
}

template <int D, int W, int NC, int MINB>
__global__ void __launch_bounds__(32 * W, MINB)
    flash_bwd_dkv_bf16_kernel(const bf16* __restrict__ q,
                              const bf16* __restrict__ k,
                              const bf16* __restrict__ v,
                              const bf16* __restrict__ dout,
                              const float* __restrict__ lse,
                              const float* __restrict__ delta,
                              const float* __restrict__ glse,
                              bf16* __restrict__ dk, bf16* __restrict__ dv,
                              int h, int sq, int sk, int d, Strides st,
                              int causal, float sm_scale) {
  using L = Bf16Tiles<D, W>;
  constexpr int kLd = L::kLd;
  constexpr int kT = 32 * W;
  constexpr bool kFragRegs = D <= 64;  // K and V fragments in registers
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kLd]
  bf16* vs = ks + L::kRes;                       // [kRows][kLd]
  bf16* qs = vs + L::kRes;                       // [2][kTile][kLd]
  bf16* dos = qs + 2 * L::kStream;               // [2][kTile][kLd]
  float* stats = reinterpret_cast<float*>(dos + 2 * L::kStream);
  // [2][3][kTile]: lse, delta, glse of each buffer's rows

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h;
  const int k0 = blockIdx.y * L::kRows;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int causal_off = sk - sq;
  const int dl = (d + 7) & ~7;
  const int wk0 = k0 + warp * 16;  // this warp's first key
  const bf16* qb = q + bi * st.q_b + hi * st.q_h;
  const bf16* ob = dout + bi * st.o_b + hi * st.o_h;
  const float* lse_b = lse + (long long)bh * sq;
  const float* delta_b = delta + (long long)bh * sq;
  const float* glse_b = glse == nullptr ? nullptr : glse + (long long)bh * sq;
  const int n_tiles = (sq + kTile - 1) / kTile;
  const int t_first = first_query_tile(k0, causal, causal_off);

  load_tile<bf16, L::kRows, D, kLd, kT>(ks, k + bi * st.k_b + hi * st.k_h,
                                        st.k_s, k0, sk, dl);
  load_tile<bf16, L::kRows, D, kLd, kT>(vs, v + bi * st.v_b + hi * st.v_h,
                                        st.v_s, k0, sk, dl);
  if (t_first < n_tiles) {
    load_tile<bf16, kTile, D, kLd, kT>(qs, qb, st.q_s, t_first * kTile, sq,
                                       dl);
    load_tile<bf16, kTile, D, kLd, kT>(dos, ob, st.o_s, t_first * kTile, sq,
                                       dl);
    load_stats<kT>(stats, stats + kTile, stats + 2 * kTile, lse_b, delta_b,
                   glse_b, t_first * kTile, sq);
  }
  cp_async_commit();

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[n][e] = acc_v[n][e] = 0.f;
  uint32_t ka[kFragRegs ? D / 16 : 1][4], va[kFragRegs ? D / 16 : 1][4];

  for (int t = t_first; t < n_tiles; ++t) {
    const int buf = (t - t_first) & 1;
    if (t + 1 < n_tiles) {
      const int nb = buf ^ 1;
      load_tile<bf16, kTile, D, kLd, kT>(qs + nb * L::kStream, qb, st.q_s,
                                         (t + 1) * kTile, sq, dl);
      load_tile<bf16, kTile, D, kLd, kT>(dos + nb * L::kStream, ob, st.o_s,
                                         (t + 1) * kTile, sq, dl);
      float* sn = stats + nb * 3 * kTile;
      load_stats<kT>(sn, sn + kTile, sn + 2 * kTile, lse_b, delta_b, glse_b,
                     (t + 1) * kTile, sq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if constexpr (kFragRegs) {
      if (t == t_first) {
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          load_a<kLd>(ka[kk], ks, warp * 16, kk, lane);
          load_a<kLd>(va[kk], vs, warp * 16, kk, lane);
        }
      }
    }
    const bf16* qt = qs + buf * L::kStream;
    const bf16* dot = dos + buf * L::kStream;
    const float* lse_s = stats + buf * 3 * kTile;
    const float* delta_s = lse_s + kTile;
    const float* glse_s = delta_s + kTile;
    const int q0 = t * kTile;
    // some row of the tile sees the warp's first key, which lies before sk
    const bool live =
        wk0 < sk && !(causal && wk0 > q0 + kTile - 1 + causal_off);
    const bool edge = q0 + kTile > sq || wk0 + 16 > sk ||
                      (causal && wk0 + 15 > q0 + causal_off);
    if (live) {
#pragma unroll
      for (int c0 = 0; c0 < kTile; c0 += NC) {
        // S^T = K.Q^T and dP^T = V.dO^T over rows [q0 + c0, q0 + c0 + NC)
        float s[NC / 8][4], dp[NC / 8][4];
#pragma unroll
        for (int j = 0; j < NC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          uint32_t ak[4], av[4];
          if constexpr (kFragRegs) {
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              ak[x] = ka[kk][x];
              av[x] = va[kk][x];
            }
          } else {
            load_a<kLd>(ak, ks, warp * 16, kk, lane);
            load_a<kLd>(av, vs, warp * 16, kk, lane);
          }
#pragma unroll
          for (int nj = 0; nj < NC / 16; ++nj) {
            uint32_t b[4];
            load_b<kLd>(b, qt, c0 + nj * 16, kk, lane);
            mma_bf16(s[2 * nj], ak, b[0], b[1]);
            mma_bf16(s[2 * nj + 1], ak, b[2], b[3]);
            load_b<kLd>(b, dot, c0 + nj * 16, kk, lane);
            mma_bf16(dp[2 * nj], av, b[0], b[1]);
            mma_bf16(dp[2 * nj + 1], av, b[2], b[3]);
          }
        }
        // element e of n-tile j: key wk0 + g + 8 (e >> 1), row q0 + c0 +
        // 8 j + 2 tig + (e & 1); p^T and ds^T rounded into A fragments
        uint32_t pa[NC / 16][4], dsa[NC / 16][4];
#pragma unroll
        for (int j = 0; j < NC / 8; ++j) {
          const int col = c0 + 8 * j + 2 * tig;
          const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
          const float2 d2 = *reinterpret_cast<const float2*>(delta_s + col);
          const float2 g2 = *reinterpret_cast<const float2*>(glse_s + col);
          float p[4], ds[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = q0 + col + (e & 1);
            const bool masked =
                edge && (row >= sq || key_masked(wk0 + g + 8 * (e >> 1), row,
                                                 sk, causal, causal_off));
            p_and_ds(s[j][e], dp[j][e], (e & 1) ? l2.y : l2.x,
                     (e & 1) ? d2.y : d2.x, (e & 1) ? g2.y : g2.x, masked,
                     sm_scale, p[e], ds[e]);
          }
          pa[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);
          pa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
          dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
          dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        // dV += round(p^T).dO and dK += round(ds^T).Q: B by ldmatrix.trans
#pragma unroll
        for (int kk = 0; kk < NC / 16; ++kk) {
#pragma unroll
          for (int nd = 0; nd < D / 16; ++nd) {
            uint32_t b[4];
            load_b_trans<kLd>(b, dot + c0 * kLd, kk, nd, lane);
            mma_bf16(acc_v[2 * nd], pa[kk], b[0], b[1]);
            mma_bf16(acc_v[2 * nd + 1], pa[kk], b[2], b[3]);
            load_b_trans<kLd>(b, qt + c0 * kLd, kk, nd, lane);
            mma_bf16(acc_k[2 * nd], dsa[kk], b[0], b[1]);
            mma_bf16(acc_k[2 * nd + 1], dsa[kk], b[2], b[3]);
          }
        }
      }
    }
    __syncthreads();  // this buffer is consumed before it is refilled
  }
  cp_async_wait<0>();

  bf16* rk[2];
  bf16* rv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = wk0 + g + 8 * r;
    const long long at = (((long long)bi * sk + key) * h + hi) * d;
    rk[r] = key < sk ? dk + at : nullptr;
    rv[r] = key < sk ? dv + at : nullptr;
  }
  store_rows_bf16<D>(acc_k, rk[0], rk[1], d, tig);
  store_rows_bf16<D>(acc_v, rv[0], rv[1], d, tig);
}

// ---------------------------------------------------- fp32, register tiles

template <int D, int R>
struct F32Tiles {
  static constexpr int kRows = 16 * R;  // resident rows: 16 groups of R
  static constexpr int kLd = D + 4;     // row stride: 16 bytes of padding
  static constexpr int kLdP = kTile + 4;
  static constexpr int kRes = kRows * kLd;
  static constexpr int kStream = kTile * kLd;
  static constexpr int kP = kRows * kLdP;
  // dq: Q, dO, K, V, ds; dk/dv: K, V, Q, dO, p^T, ds^T, lse, delta, glse
  static constexpr int kDqBytes = (2 * kRes + 2 * kStream + kP) * 4;
  static constexpr int kDkvBytes =
      (2 * kRes + 2 * kStream + 2 * kP + 3 * kTile) * 4;
};

// out[i][j] += sum_c A[ty + 16 i][c] * B[tx + 8 j][c] over c < D, for a
// resident [16 R][LD] and a streamed [64][LD] fp32 tile
template <int D, int R, int LD>
__device__ __forceinline__ void f32_dot(const float* a_tile,
                                        const float* b_tile, int ty, int tx,
                                        float (&out)[R][8]) {
#pragma unroll 2
  for (int kk = 0; kk < D; kk += 4) {
    float4 a[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      a[i] = *reinterpret_cast<const float4*>(a_tile + (ty + 16 * i) * LD +
                                              kk);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(b_tile + (tx + 8 * j) * LD + kk);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        out[i][j] = fmaf(a[i].x, b.x, out[i][j]);
        out[i][j] = fmaf(a[i].y, b.y, out[i][j]);
        out[i][j] = fmaf(a[i].z, b.z, out[i][j]);
        out[i][j] = fmaf(a[i].w, b.w, out[i][j]);
      }
    }
  }
}

// acc[i][4 c4 + e] += sum_r W[ty + 16 i][r] * X[r][tx * 4 + 32 c4 + e] over
// the 64 streamed rows r: W is [16 R][kLdP], X [64][LD] in shared memory
template <int D, int R, int LD, int LDP>
__device__ __forceinline__ void f32_accumulate(const float* w_tile,
                                               const float* x_tile, int ty,
                                               int tx,
                                               float (&acc)[R][D / 8]) {
  constexpr int kC4 = D / 32;
#pragma unroll 2
  for (int r = 0; r < kTile; r += 4) {
    float4 w4[R];
#pragma unroll
    for (int i = 0; i < R; ++i)
      w4[i] = *reinterpret_cast<const float4*>(w_tile + (ty + 16 * i) * LDP +
                                               r);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      float4 x[kC4];
#pragma unroll
      for (int c4 = 0; c4 < kC4; ++c4)
        x[c4] = *reinterpret_cast<const float4*>(x_tile + (r + u) * LD +
                                                 tx * 4 + 32 * c4);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float w = u == 0 ? w4[i].x
                        : u == 1 ? w4[i].y
                        : u == 2 ? w4[i].z
                                 : w4[i].w;
#pragma unroll
        for (int c4 = 0; c4 < kC4; ++c4) {
          acc[i][4 * c4 + 0] = fmaf(w, x[c4].x, acc[i][4 * c4 + 0]);
          acc[i][4 * c4 + 1] = fmaf(w, x[c4].y, acc[i][4 * c4 + 1]);
          acc[i][4 * c4 + 2] = fmaf(w, x[c4].z, acc[i][4 * c4 + 2]);
          acc[i][4 * c4 + 3] = fmaf(w, x[c4].w, acc[i][4 * c4 + 3]);
        }
      }
    }
  }
}

// row ty + 16 i of acc (columns tx * 4 + 32 c4 + e) to a contiguous fp32 row
template <int D>
__device__ __forceinline__ void store_row_f32(const float (&acc)[D / 8],
                                              float* out, int d, int tx) {
#pragma unroll
  for (int c4 = 0; c4 < D / 32; ++c4) {
    const int col = tx * 4 + 32 * c4;
    const float4 x = make_float4(acc[4 * c4], acc[4 * c4 + 1],
                                 acc[4 * c4 + 2], acc[4 * c4 + 3]);
    if (col + 3 < d && (d & 3) == 0) {
      *reinterpret_cast<float4*>(out + col) = x;
    } else {
      if (col + 0 < d) out[col + 0] = x.x;
      if (col + 1 < d) out[col + 1] = x.y;
      if (col + 2 < d) out[col + 2] = x.z;
      if (col + 3 < d) out[col + 3] = x.w;
    }
  }
}

template <int D, int R>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dq_f32_kernel(const float* __restrict__ q,
                            const float* __restrict__ k,
                            const float* __restrict__ v,
                            const float* __restrict__ dout,
                            const float* __restrict__ lse,
                            const float* __restrict__ delta,
                            const float* __restrict__ glse,
                            float* __restrict__ dq, int h, int sq, int sk,
                            int d, Strides st, int causal, float sm_scale) {
  using L = F32Tiles<D, R>;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kRows][kLd]
  float* dos = qs + L::kRes;                       // [kRows][kLd]
  float* ks = dos + L::kRes;                       // [kTile][kLd]
  float* vs = ks + L::kStream;                     // [kTile][kLd]
  float* dss = vs + L::kStream;                    // [kRows][kLdP]

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h;
  const int q0 = blockIdx.y * L::kRows;
  // ty owns rows ty + 16 i, tx keys tx + 8 j and columns tx * 4 + 32 c4 + e
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int causal_off = sk - sq;
  const int dl = (d + 3) & ~3;
  const float* kb = k + bi * st.k_b + hi * st.k_h;
  const float* vb = v + bi * st.v_b + hi * st.v_h;
  const int n_tiles = key_tiles(q0, L::kRows, sk, causal, causal_off);

  // copy groups, oldest first: {Q, dO, V0}, {K0}; then per tile {V t+1}
  // after dP and {K t+1} after dS.K
  load_tile<float, L::kRows, D, kLd, kThreads>(
      qs, q + bi * st.q_b + hi * st.q_h, st.q_s, q0, sq, dl);
  load_tile<float, L::kRows, D, kLd, kThreads>(
      dos, dout + bi * st.o_b + hi * st.o_h, st.o_s, q0, sq, dl);
  if (n_tiles > 0)
    load_tile<float, kTile, D, kLd, kThreads>(vs, vb, st.v_s, 0, sk, dl);
  cp_async_commit();
  if (n_tiles > 0)
    load_tile<float, kTile, D, kLd, kThreads>(ks, kb, st.k_s, 0, sk, dl);
  cp_async_commit();

  float r_lse[R], r_delta[R], r_glse[R], acc[R][D / 8];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = (long long)bh * sq + row;
    r_lse[i] = row < sq ? lse[at] : 0.f;
    r_delta[i] = row < sq ? delta[at] : 0.f;
    r_glse[i] = (row < sq && glse != nullptr) ? glse[at] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc[i][c] = 0.f;
  }

  cp_async_wait<1>();  // Q, dO and V0 have landed
  __syncthreads();
  for (int t = 0; t < n_tiles; ++t) {
    const bool more = t + 1 < n_tiles;
    const int k0 = t * kTile;
    // s[i][j], dp[i][j]: row ty + 16 i, key tx + 8 j
    float s[R][8], dp[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    f32_dot<D, R, kLd>(dos, vs, ty, tx, dp);

    cp_async_wait<0>();  // K t has landed
    __syncthreads();     // and V t is consumed: copy V t+1 during S, dS.K
    if (more)
      load_tile<float, kTile, D, kLd, kThreads>(vs, vb, st.v_s, k0 + kTile,
                                                sk, dl);
    cp_async_commit();

    f32_dot<D, R, kLd>(qs, ks, ty, tx, s);
    const bool edge =
        k0 + kTile > sk || (causal && k0 + kTile - 1 > q0 + causal_off);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int row = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const bool masked = edge && key_masked(k0 + tx + 8 * j, q0 + row, sk,
                                               causal, causal_off);
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], r_lse[i], r_delta[i], r_glse[i], masked,
                 sm_scale, p, ds);
        dss[row * L::kLdP + tx + 8 * j] = ds;
      }
    }
    __syncthreads();  // ds is complete

    f32_accumulate<D, R, kLd, L::kLdP>(dss, ks, ty, tx, acc);

    if (more) {
      cp_async_wait<0>();  // V t+1 has landed
      __syncthreads();     // K t and ds are consumed: copy K t+1 during dP
      load_tile<float, kTile, D, kLd, kThreads>(ks, kb, st.k_s, k0 + kTile,
                                                sk, dl);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row < sq)
      store_row_f32<D>(acc[i], dq + (((long long)bi * sq + row) * h + hi) * d,
                       d, tx);
  }
}

template <int D, int R>
__global__ void __launch_bounds__(kThreads, 2)
    flash_bwd_dkv_f32_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             const float* __restrict__ delta,
                             const float* __restrict__ glse,
                             float* __restrict__ dk, float* __restrict__ dv,
                             int h, int sq, int sk, int d, Strides st,
                             int causal, float sm_scale) {
  using L = F32Tiles<D, R>;
  constexpr int kLd = L::kLd;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kRows][kLd]
  float* vs = ks + L::kRes;                        // [kRows][kLd]
  float* qs = vs + L::kRes;                        // [kTile][kLd]
  float* dos = qs + L::kStream;                    // [kTile][kLd]
  float* pt = dos + L::kStream;                    // round(p)^T [key][row]
  float* dst = pt + L::kP;                         // round(ds)^T
  float* lse_s = dst + L::kP;
  float* delta_s = lse_s + kTile;
  float* glse_s = delta_s + kTile;

  const int bh = blockIdx.x;
  const int bi = bh / h, hi = bh - bi * h;
  const int k0 = blockIdx.y * L::kRows;
  // ty owns keys ty + 16 i, tx rows tx + 8 j and columns tx * 4 + 32 c4 + e
  const int ty = threadIdx.x >> 3, tx = threadIdx.x & 7;
  const int causal_off = sk - sq;
  const int dl = (d + 3) & ~3;
  const float* qb = q + bi * st.q_b + hi * st.q_h;
  const float* ob = dout + bi * st.o_b + hi * st.o_h;
  const float* lse_b = lse + (long long)bh * sq;
  const float* delta_b = delta + (long long)bh * sq;
  const float* glse_b = glse == nullptr ? nullptr : glse + (long long)bh * sq;
  const int n_tiles = (sq + kTile - 1) / kTile;
  const int t_first = first_query_tile(k0, causal, causal_off);

  // copy groups, oldest first: {K, V, Q t0}, {dO t0 and its statistics};
  // then per tile {Q t+1} after dK and {dO t+1} after dV
  load_tile<float, L::kRows, D, kLd, kThreads>(
      ks, k + bi * st.k_b + hi * st.k_h, st.k_s, k0, sk, dl);
  load_tile<float, L::kRows, D, kLd, kThreads>(
      vs, v + bi * st.v_b + hi * st.v_h, st.v_s, k0, sk, dl);
  if (t_first < n_tiles)
    load_tile<float, kTile, D, kLd, kThreads>(qs, qb, st.q_s,
                                              t_first * kTile, sq, dl);
  cp_async_commit();
  if (t_first < n_tiles) {
    load_tile<float, kTile, D, kLd, kThreads>(dos, ob, st.o_s,
                                              t_first * kTile, sq, dl);
    load_stats<kThreads>(lse_s, delta_s, glse_s, lse_b, delta_b, glse_b,
                         t_first * kTile, sq);
  }
  cp_async_commit();

  float acc_k[R][D / 8], acc_v[R][D / 8];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < D / 8; ++c) acc_k[i][c] = acc_v[i][c] = 0.f;

  cp_async_wait<1>();  // K, V and Q t0 have landed
  __syncthreads();
  for (int t = t_first; t < n_tiles; ++t) {
    const bool more = t + 1 < n_tiles;
    const int q0 = t * kTile;
    // s[i][j], dp[i][j]: key ty + 16 i, query row tx + 8 j
    float s[R][8], dp[R][8];
#pragma unroll
    for (int i = 0; i < R; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = dp[i][j] = 0.f;
    f32_dot<D, R, kLd>(ks, qs, ty, tx, s);

    cp_async_wait<0>();  // dO t and its statistics have landed
    __syncthreads();
    f32_dot<D, R, kLd>(vs, dos, ty, tx, dp);

    const bool edge = q0 + kTile > sq || k0 + L::kRows > sk ||
                      (causal && k0 + L::kRows - 1 > q0 + causal_off);
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int kr = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int r = tx + 8 * j;
        const bool masked =
            edge && (q0 + r >= sq ||
                     key_masked(k0 + kr, q0 + r, sk, causal, causal_off));
        float p, ds;
        p_and_ds(s[i][j], dp[i][j], lse_s[r], delta_s[r], glse_s[r], masked,
                 sm_scale, p, ds);
        pt[kr * L::kLdP + r] = p;
        dst[kr * L::kLdP + r] = ds;
      }
    }
    __syncthreads();  // p^T and ds^T are complete

    f32_accumulate<D, R, kLd, L::kLdP>(dst, qs, ty, tx, acc_k);
    __syncthreads();  // Q t is consumed: copy Q t+1 during dV
    if (more)
      load_tile<float, kTile, D, kLd, kThreads>(qs, qb, st.q_s, q0 + kTile,
                                                sq, dl);
    cp_async_commit();

    f32_accumulate<D, R, kLd, L::kLdP>(pt, dos, ty, tx, acc_v);
    if (more) {
      cp_async_wait<0>();  // Q t+1 has landed
      __syncthreads();     // dO t, p^T, ds^T and the statistics consumed
      load_tile<float, kTile, D, kLd, kThreads>(dos, ob, st.o_s, q0 + kTile,
                                                sq, dl);
      load_stats<kThreads>(lse_s, delta_s, glse_s, lse_b, delta_b, glse_b,
                           q0 + kTile, sq);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= sk) continue;
    const long long at = (((long long)bi * sk + key) * h + hi) * d;
    store_row_f32<D>(acc_k[i], dk + at, d, tx);
    store_row_f32<D>(acc_v[i], dv + at, d, tx);
  }
}

// ------------------------------------------------------------------ launch

struct Args {
  const void *q, *k, *v, *dout;
  const float *lse, *delta, *glse;
  int b, h, sq, sk, d;
  Strides st;
  int causal;
  float sm_scale;
  cudaStream_t stream;
};

// per-instantiation launchers: one CTA per (b*h, resident tile)
template <int D, int W, int NC>
cudaError_t launch_dq_bf16(const Args& a, void* dq) {
  using L = Bf16Tiles<D, W>;
  auto kernel = flash_bwd_dq_bf16_kernel<D, W, NC>;
  const int bytes = L::kDqBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h),
                  (unsigned)((a.sq + L::kRows - 1) / L::kRows));
  kernel<<<grid, 32 * W, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, a.glse, static_cast<bf16*>(dq), a.h, a.sq, a.sk, a.d, a.st,
      a.causal, a.sm_scale);
  return cudaGetLastError();
}

// MINB: __launch_bounds__'s least CTAs an SM, which caps the registers
template <int D, int W, int NC, int MINB>
cudaError_t launch_dkv_bf16(const Args& a, void* dk, void* dv) {
  using L = Bf16Tiles<D, W>;
  auto kernel = flash_bwd_dkv_bf16_kernel<D, W, NC, MINB>;
  const int bytes = L::kDkvBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h),
                  (unsigned)((a.sk + L::kRows - 1) / L::kRows));
  kernel<<<grid, 32 * W, bytes, a.stream>>>(
      static_cast<const bf16*>(a.q), static_cast<const bf16*>(a.k),
      static_cast<const bf16*>(a.v), static_cast<const bf16*>(a.dout), a.lse,
      a.delta, a.glse, static_cast<bf16*>(dk), static_cast<bf16*>(dv), a.h,
      a.sq, a.sk, a.d, a.st, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <int D, int R>
cudaError_t launch_dq_f32(const Args& a, void* dq) {
  using L = F32Tiles<D, R>;
  auto kernel = flash_bwd_dq_f32_kernel<D, R>;
  const int bytes = L::kDqBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h),
                  (unsigned)((a.sq + L::kRows - 1) / L::kRows));
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.glse, static_cast<float*>(dq), a.h, a.sq, a.sk, a.d,
      a.st, a.causal, a.sm_scale);
  return cudaGetLastError();
}

template <int D, int R>
cudaError_t launch_dkv_f32(const Args& a, void* dk, void* dv) {
  using L = F32Tiles<D, R>;
  auto kernel = flash_bwd_dkv_f32_kernel<D, R>;
  const int bytes = L::kDkvBytes;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)(a.b * a.h),
                  (unsigned)((a.sk + L::kRows - 1) / L::kRows));
  kernel<<<grid, kThreads, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout),
      a.lse, a.delta, a.glse, static_cast<float*>(dk),
      static_cast<float*>(dv), a.h, a.sq, a.sk, a.d, a.st, a.causal,
      a.sm_scale);
  return cudaGetLastError();
}

// checks shared by both entry points; -1: valid and nothing to launch
int check(int b, int h, int sq, int sk, int d) {
  if (b < 0 || h < 0 || sq < 0 || sk < 1 || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  if ((long long)b * h > 0x7fffffffLL || (sq + 15) / 16 > 65535 ||
      (sk + 15) / 16 > 65535)
    return (int)cudaErrorInvalidValue;
  if (b == 0 || h == 0 || sq == 0) return -1;
  return (int)cudaSuccess;
}

}  // namespace

extern "C" {

// q, dout: [b, sq, h, d] and k, v: [b, sk, h, d] with the given batch,
// sequence and head strides (elements) and a contiguous head dim, each row
// starting on 16 bytes (pointers and strides multiples of 16 bytes, d a
// multiple of 16 bytes or its row zero-padded to one), all fp32 (is_bf16
// == 0) or all bf16; lse, delta and glse (null: zeros): contiguous fp32
// [b*h, sq]. Both launch on `stream` and return the CUDA error code (0
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
    err = d <= 64 ? launch_dq_bf16<64, 4, 32>(a, dq)
                  : launch_dq_bf16<128, 4, 32>(a, dq);
  else
    err = d <= 64 ? launch_dq_f32<64, 4>(a, dq) : launch_dq_f32<128, 2>(a, dq);
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
    err = d <= 64 ? launch_dkv_bf16<64, 4, 32, 3>(a, dk, dv)
                  : launch_dkv_bf16<128, 4, 32, 1>(a, dk, dv);
  else
    err = d <= 64 ? launch_dkv_f32<64, 4>(a, dk, dv)
                  : launch_dkv_f32<128, 2>(a, dk, dv);
  return (int)err;
}

const char* zoo_flash_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
