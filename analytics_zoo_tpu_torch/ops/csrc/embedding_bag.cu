// Fused N-table embedding lookup for Hopper (sm_90a).
//
// Replaces analytics_zoo_tpu/ops/embedding_bag.py:102 _fused_lookup_kernel,
// the Pallas TPU kernel launched by _fused_pallas. Computes, for every batch
// row b, the row ids[b, t] of each table t, combined as:
//   concat   side by side (mixed widths; column offsets are the prefix sums
//            of the widths)
//   sum/mul  left to right in fp32, each step one IEEE op (__fadd_rn /
//            __fmul_rn, never contracted into an FMA), then rounded once to
//            the table dtype (__float2bfloat16_rn for bf16: round to nearest
//            even, as torch rounds)
//   mean     the sum times inv_n, the fp32 reciprocal the host rounded once
//            from double (float(1.0 / N)), exactly as the plain version does
// Ids follow jnp.take, the plain version's rule: ids in [-V, V) index the
// table (negative ones wrap), any other id yields a NaN row. No read ever
// leaves a table.
//
// Bound: device-memory bytes. Per batch row it reads 4*N id bytes and
// sum(d_t)*itemsize table bytes and writes the output row; it does at most
// N-1 flops per output element. Design: one thread per output element, a
// grid-stride loop over the flattened [batch, d_out] output, so a block
// covers a tile of whole batch rows and neighbouring threads write
// neighbouring output addresses. Each thread reads its row's ids itself (L1
// serves the repeats). Rows are read element-wise: NCF's rows are 20 floats
// (80 bytes), so 16-byte vector loads would need an alignment the tables do
// not promise. Making it faster is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define ZOO_MAX_TABLES 8

// Mirrored by ctypes in ops/embedding_bag.py (_FusedArgs): keep in sync.
struct FusedArgs {
  const void* table[ZOO_MAX_TABLES];
  long long vocab[ZOO_MAX_TABLES];
  int dim[ZOO_MAX_TABLES];
  int offset[ZOO_MAX_TABLES];  // first output column of table t (concat)
  int n_tables;
  int d_out;
};

enum Combine { kConcat = 0, kSum = 1, kMean = 2, kMul = 3 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__device__ __forceinline__ T nan_of();
template <>
__device__ __forceinline__ float nan_of<float>() {
  return __int_as_float(0x7fc00000);
}
template <>
__device__ __forceinline__ __nv_bfloat16 nan_of<__nv_bfloat16>() {
  return __ushort_as_bfloat16((unsigned short)0x7fc0);
}

// Row index of id in a table of `vocab` rows, or -1 for a NaN row.
__device__ __forceinline__ long long resolve_row(int id, long long vocab) {
  long long r = id;
  if (r < 0) r += vocab;
  return (r >= 0 && r < vocab) ? r : -1;
}

template <typename T, int COMBINE>
__global__ void fused_lookup_kernel(const int* __restrict__ ids,
                                    const FusedArgs a, T* __restrict__ out,
                                    long long batch, float inv_n) {
  const long long total = batch * a.d_out;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long b = i / a.d_out;
    const int c = (int)(i - b * a.d_out);
    const int* row_ids = ids + b * a.n_tables;
    if (COMBINE == kConcat) {
      int t = 0;
      while (t + 1 < a.n_tables && c >= a.offset[t + 1]) ++t;
      const long long r = resolve_row(row_ids[t], a.vocab[t]);
      const T* tab = static_cast<const T*>(a.table[t]);
      out[i] = r < 0 ? nan_of<T>() : tab[r * a.dim[t] + (c - a.offset[t])];
    } else {
      float acc = 0.f;
      for (int t = 0; t < a.n_tables; ++t) {
        const long long r = resolve_row(row_ids[t], a.vocab[t]);
        const T* tab = static_cast<const T*>(a.table[t]);
        const float v = r < 0 ? __int_as_float(0x7fc00000)
                              : to_f32(tab[r * a.dim[t] + c]);
        if (t == 0) {
          acc = v;
        } else if (COMBINE == kMul) {
          acc = __fmul_rn(acc, v);
        } else {
          acc = __fadd_rn(acc, v);
        }
      }
      if (COMBINE == kMean) acc = __fmul_rn(acc, inv_n);
      store_f32(out + i, acc);
    }
  }
}

template <typename T>
static void launch(int combine, const int* ids, const FusedArgs& a, void* out,
                   long long batch, float inv_n, cudaStream_t stream) {
  const int threads = 256;
  const long long total = batch * a.d_out;
  long long blocks = (total + threads - 1) / threads;
  // grid-stride loop past 32 blocks per SM (132 SMs on an H100)
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  T* o = static_cast<T*>(out);
  switch (combine) {
    case kConcat:
      fused_lookup_kernel<T, kConcat>
          <<<(unsigned)blocks, threads, 0, stream>>>(ids, a, o, batch, inv_n);
      break;
    case kSum:
      fused_lookup_kernel<T, kSum>
          <<<(unsigned)blocks, threads, 0, stream>>>(ids, a, o, batch, inv_n);
      break;
    case kMean:
      fused_lookup_kernel<T, kMean>
          <<<(unsigned)blocks, threads, 0, stream>>>(ids, a, o, batch, inv_n);
      break;
    default:
      fused_lookup_kernel<T, kMul>
          <<<(unsigned)blocks, threads, 0, stream>>>(ids, a, o, batch, inv_n);
      break;
  }
}

extern "C" {

// ids: [batch, n_tables] int32, contiguous; out: [batch, d_out] of the tables'
// dtype (fp32 when is_bf16 == 0, bf16 otherwise). Launches on `stream` and
// returns cudaGetLastError() (0 when the launch was accepted).
int zoo_fused_lookup(const void* ids, const FusedArgs* args, void* out,
                     long long batch, int combine, int is_bf16, float inv_n,
                     void* stream) {
  if (args->n_tables < 1 || args->n_tables > ZOO_MAX_TABLES ||
      combine < kConcat || combine > kMul)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || args->d_out <= 0) return (int)cudaSuccess;
  const int* id_ptr = static_cast<const int*>(ids);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch<__nv_bfloat16>(combine, id_ptr, *args, out, batch, inv_n, s);
  } else {
    launch<float>(combine, id_ptr, *args, out, batch, inv_n, s);
  }
  return (int)cudaGetLastError();
}

const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
