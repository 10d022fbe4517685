// Embedding lookups for Hopper (sm_90a): the fused N-table lookup, the
// multi-hot bag, and the scatter-add that is the backward of both.
//
// 1. fused_lookup_kernel replaces analytics_zoo_tpu/ops/embedding_bag.py:102
//    _fused_lookup_kernel, the Pallas TPU kernel launched by _fused_pallas.
//    Computes, for every batch row b, the row ids[b, t] of each table t,
//    combined as:
//      concat   side by side (mixed widths; column offsets are the prefix
//               sums of the widths)
//      sum/mul  left to right in fp32, each step one IEEE op (__fadd_rn /
//               __fmul_rn, never contracted into an FMA), then rounded once
//               to the table dtype (__float2bfloat16_rn for bf16: round to
//               nearest even, as torch rounds)
//      mean     the sum times inv_n, the fp32 reciprocal the host rounded
//               once from double (float(1.0 / N)), as the plain version does
//    Ids follow jnp.take, the plain version's rule: ids in [-V, V) index the
//    table (negative ones wrap), any other id yields a NaN row.
//
// 2. bag_kernel replaces analytics_zoo_tpu/ops/embedding_bag.py:155
//    _bag_kernel (launched by _bag_pallas :177). For every bag b it sums the
//    rows ids[b, l] for l < min(len[b], L) in fp32, in slot order, starting
//    from +0.0 (the plain version adds 0.0 for a masked slot; skipping it
//    gives the same bits, since round-to-nearest never makes -0.0 from a sum
//    that starts at +0.0); mean divides by max(len[b], 1) with __fdiv_rn.
//    The wrapper clamps ids into [0, V-1] as JAX does; the kernel clamps
//    again, so no read leaves the table.
//
// 3. The scatter-add is the backward of both. JAX writes it in plain JAX
//    (_fused_bwd :222, _bag_bwd :261): a scatter-add into a zero table of
//    the table's dtype, one update per looked-up position. It must be
//    deterministic, so it uses no atomics: the wrapper stably sorts the
//    positions by row (a library sort), and every row's run of updates is
//    summed in a fixed order that depends on the inputs alone, never on the
//    launch or the device, each add rounded to the table dtype (bf16: every
//    add, as JAX's scatter in bf16 rounds). With C = SCATTER_RUN_CHUNK:
//      a run of n <= C updates   added in position order from zero;
//      a run of n > C updates    cut into chunks of C from its start, each
//                                chunk summed in position order from zero,
//                                then the chunk sums added in chunk order
//                                from zero.
//    So short runs keep the bits of a plain left-to-right sum (JAX's
//    autodiff route on the CPU), and a padding id's long run is spread over
//    warps. Update of position p (batch row b = p / bag), per column c:
//      combine copy  g[b, offset + c]
//      combine mul   g[b, c] times the other tables' rows ids[b, j] (j != t,
//                    ascending, jnp.take's NaN rows), one __fmul_rn each
//      scale recip   times inv_n (the fused mean: autodiff of _fused_ref)
//      scale length  divided by max(len[b], 1) (the bag mean, _bag_bwd)
//    then rounded to the table dtype. Positions the wrapper marks dropped
//    (key == vocab: ids outside [-V, V) of the fused lookup, masked bag
//    slots) sort last and are never read.
//
// Bound: device-memory bytes, all three. The lookups read the ids, each
// gathered row and write the output; the scatter reads the sorted keys, the
// permutation, one gradient row per position (plus the other tables' rows
// for mul) and writes the gradient table. Design: the lookups run one
// thread per output element in a grid-stride loop over the flattened
// output, so neighbouring threads write neighbouring addresses; rows are
// read element-wise (NCF's rows are 20 floats: 16-byte vector loads would
// need an alignment the tables do not promise). The scatter takes two
// launches, a warp per sorted position in each, the lanes owning columns:
//   scatter_chunk_kernel  the warp of a chunk's first position sums the
//                         chunk (the others exit after reading one or two
//                         keys). A position finds its run's start by a
//                         32-way search over the sorted keys (each step the
//                         lanes probe 32 points: 4 steps for 64 000
//                         positions), searched only when the run reaches C
//                         positions back. It walks the chunk 32 positions
//                         at a time: the lanes load 32 keys and batch rows
//                         together (coalesced) into shared memory, then
//                         each lane issues the 32 gradient loads of its
//                         column before it adds them in order, so the loads
//                         overlap and only the adds are serial. A short run
//                         writes its row; a chunk of a long run writes its
//                         sum into a scratch row [n_pos, dim] (the wrapper's
//                         torch.empty) at its first position.
//   scatter_runs_kernel   the warp of a long run's first position adds the
//                         run's chunk sums, 32 loads ahead, and writes the
//                         row.
// A run of n updates thus costs about min(n, C) dependent adds plus n / C
// in the second pass, where one warp alone used to add all n.

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

// Mirrored by ctypes in ops/embedding_bag.py (_ScatterArgs): keep in sync.
struct ScatterArgs {
  const void* table[ZOO_MAX_TABLES];  // mul: the lookup's tables
  long long vocab[ZOO_MAX_TABLES];
  const int* ids;      // mul: [batch, n_tables] ids of the lookup
  const int* lengths;  // scale length: [batch] bag lengths
  int n_tables;        // mul
  int target;          // mul: the table whose gradient this is
  int bag;             // positions per batch row (1 for the fused lookup)
  int g_stride;        // row stride of the output gradient
  int g_offset;        // first gradient column of this table (concat)
  int dim;             // width of the gradient table
  float inv_n;         // scale recip
};

enum Combine { kConcat = 0, kSum = 1, kMean = 2, kMul = 3 };
enum ScatterCombine { kCopy = 0, kMulOthers = 1 };
enum ScatterScale { kScaleNone = 0, kScaleRecip = 1, kScaleLength = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ void store_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// v rounded to T and widened back (the value a T element would hold).
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
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

// ------------------------------------------------------------ fused lookup

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

// Blocks for a grid-stride loop over `total` elements: past 32 blocks per
// SM (132 SMs on an H100) the threads loop.
static unsigned grid_for(long long total, int threads) {
  long long blocks = (total + threads - 1) / threads;
  if (blocks > 132LL * 32) blocks = 132LL * 32;
  return (unsigned)blocks;
}

template <typename T>
static void launch_fused(int combine, const int* ids, const FusedArgs& a,
                         void* out, long long batch, float inv_n,
                         cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = grid_for(batch * a.d_out, threads);
  T* o = static_cast<T*>(out);
  switch (combine) {
    case kConcat:
      fused_lookup_kernel<T, kConcat>
          <<<blocks, threads, 0, stream>>>(ids, a, o, batch, inv_n);
      break;
    case kSum:
      fused_lookup_kernel<T, kSum>
          <<<blocks, threads, 0, stream>>>(ids, a, o, batch, inv_n);
      break;
    case kMean:
      fused_lookup_kernel<T, kMean>
          <<<blocks, threads, 0, stream>>>(ids, a, o, batch, inv_n);
      break;
    default:
      fused_lookup_kernel<T, kMul>
          <<<blocks, threads, 0, stream>>>(ids, a, o, batch, inv_n);
      break;
  }
}

// --------------------------------------------------------------------- bag

template <typename T, bool MEAN>
__global__ void bag_kernel(const int* __restrict__ ids,
                           const int* __restrict__ lengths,
                           const T* __restrict__ table, long long vocab,
                           int dim, long long batch, int bag,
                           T* __restrict__ out) {
  const long long total = batch * dim;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long b = i / dim;
    const int c = (int)(i - b * dim);
    const int len = lengths[b];
    const int n = len < bag ? len : bag;  // len <= 0: an empty bag
    const int* row_ids = ids + b * bag;
    float acc = 0.f;
    for (int l = 0; l < n; ++l) {
      long long r = row_ids[l];
      r = r < 0 ? 0 : (r >= vocab ? vocab - 1 : r);
      acc = __fadd_rn(acc, to_f32(table[r * dim + c]));
    }
    if (MEAN) acc = __fdiv_rn(acc, (float)(len > 1 ? len : 1));
    store_f32(out + i, acc);
  }
}

template <typename T>
static void launch_bag(const int* ids, const int* lengths, const void* table,
                       long long vocab, int dim, long long batch, int bag,
                       int mean, void* out, cudaStream_t stream) {
  const int threads = 256;
  const unsigned blocks = grid_for(batch * dim, threads);
  const T* t = static_cast<const T*>(table);
  T* o = static_cast<T*>(out);
  if (mean) {
    bag_kernel<T, true><<<blocks, threads, 0, stream>>>(
        ids, lengths, t, vocab, dim, batch, bag, o);
  } else {
    bag_kernel<T, false><<<blocks, threads, 0, stream>>>(
        ids, lengths, t, vocab, dim, batch, bag, o);
  }
}

// ------------------------------------------------------------- scatter-add

#define SCATTER_WARPS 8        // warps (sorted positions) per block
#define SCATTER_STAGE 32       // positions of a chunk staged at a time
#define SCATTER_RUN_CHUNK 256  // C: positions per chunk of a long run
                               // (RUN_CHUNK in ops/embedding_bag.py)

// The update of batch row b to column c of table a.target, rounded to T.
template <typename T, int COMBINE, int SCALE>
__device__ __forceinline__ float scatter_update(const ScatterArgs& a,
                                                const T* __restrict__ g,
                                                long long b, int c) {
  float u = to_f32(g[b * a.g_stride + a.g_offset + c]);
  if (COMBINE == kMulOthers) {
    const int* row_ids = a.ids + b * a.n_tables;
    for (int j = 0; j < a.n_tables; ++j) {
      if (j == a.target) continue;
      const long long r = resolve_row(row_ids[j], a.vocab[j]);
      const T* tab = static_cast<const T*>(a.table[j]);
      u = __fmul_rn(u, r < 0 ? __int_as_float(0x7fc00000)
                             : to_f32(tab[r * a.dim + c]));
    }
  }
  if (SCALE == kScaleRecip) u = __fmul_rn(u, a.inv_n);
  if (SCALE == kScaleLength) {
    const int len = a.lengths[b];
    u = __fdiv_rn(u, (float)(len > 1 ? len : 1));
  }
  return round_to<T>(u);
}

// First sorted index of the run of `key`, known to lie in [0, hi] with
// keys[hi] == key. Each step the 32 lanes probe 32 points of [lo, hi] and
// keep the gap between the last probe before the run and the first in it.
__device__ __forceinline__ long long run_start(const int* __restrict__ keys,
                                               int key, long long hi,
                                               int lane) {
  long long lo = 0;
  while (lo < hi) {
    const long long span = hi - lo;
    const bool in_run = keys[lo + span * lane / 32] == key;
    const unsigned ball = __ballot_sync(0xffffffffu, in_run);
    if (ball & 1u) return lo;  // lane 0 probes lo itself
    const int f = ball ? __ffs(ball) - 1 : 32;  // first probe in the run
    if (f < 32) hi = lo + span * f / 32;
    lo = lo + span * (f - 1) / 32 + 1;  // past the last probe before it
  }
  return lo;
}

// Pass 1: the warp of position p sums the chunk that starts at p, if one
// does: a short run's sum goes to its row of `out`, a chunk of a long run's
// to row p of `partial`.
template <typename T, int COMBINE, int SCALE>
__global__ void __launch_bounds__(SCATTER_WARPS * 32)
    scatter_chunk_kernel(const int* __restrict__ keys,
                         const long long* __restrict__ perm, long long n_pos,
                         const T* __restrict__ g, const ScatterArgs a,
                         long long vocab, T* __restrict__ out,
                         T* __restrict__ partial) {
  __shared__ long long s_row[SCATTER_WARPS][SCATTER_STAGE];
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const long long p = (long long)blockIdx.x * SCATTER_WARPS + w;
  if (p >= n_pos) return;  // warp-uniform from here on
  const int key = keys[p];
  if (key < 0 || key >= vocab) return;  // dropped positions sort last
  bool long_run = true;
  if (p > 0 && keys[p - 1] == key) {
    // inside a run: a chunk starts here only if the run began a multiple
    // of C positions back, so at least C back
    if (p < SCATTER_RUN_CHUNK || keys[p - SCATTER_RUN_CHUNK] != key) return;
    const long long s = run_start(keys, key, p - SCATTER_RUN_CHUNK, lane);
    if ((p - s) % SCATTER_RUN_CHUNK != 0) return;
  } else {
    long_run = p + SCATTER_RUN_CHUNK < n_pos &&
               keys[p + SCATTER_RUN_CHUNK] == key;
  }
  const long long end =
      p + SCATTER_RUN_CHUNK < n_pos ? p + SCATTER_RUN_CHUNK : n_pos;
  T* dst = long_run ? partial + p * a.dim : out + (long long)key * a.dim;
  for (int c0 = 0; c0 < a.dim; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;  // the zero table
    for (long long q = p; q < end; q += SCATTER_STAGE) {
      const long long mine = q + lane;
      const bool in_run = mine < end && keys[mine] == key;
      // keys are sorted, so the run's positions are a prefix of the stage
      const int n = __popc(__ballot_sync(0xffffffffu, in_run));
      if (in_run) s_row[w][lane] = perm[mine] / a.bag;
      __syncwarp();
      if (c < a.dim) {
        float u[SCATTER_STAGE];
#pragma unroll
        for (int j = 0; j < SCATTER_STAGE; ++j) {
          if (j < n) u[j] = scatter_update<T, COMBINE, SCALE>(a, g,
                                                              s_row[w][j], c);
        }
#pragma unroll
        for (int j = 0; j < SCATTER_STAGE; ++j) {
          if (j < n) acc = round_to<T>(__fadd_rn(acc, u[j]));
        }
      }
      __syncwarp();
      if (n < SCATTER_STAGE) break;
    }
    if (c < a.dim) store_f32(dst + c, acc);
  }
}

// Pass 2: the warp of a long run's first position adds the run's chunk
// sums in chunk order, from zero, and writes the row.
template <typename T>
__global__ void __launch_bounds__(SCATTER_WARPS * 32)
    scatter_runs_kernel(const int* __restrict__ keys, long long n_pos,
                        long long vocab, int dim,
                        const T* __restrict__ partial, T* __restrict__ out) {
  const int lane = threadIdx.x & 31;
  const long long p =
      (long long)blockIdx.x * SCATTER_WARPS + (threadIdx.x >> 5);
  if (p >= n_pos) return;
  const int key = keys[p];
  if (key < 0 || key >= vocab) return;
  if (p > 0 && keys[p - 1] == key) return;  // not the first of its run
  if (p + SCATTER_RUN_CHUNK >= n_pos || keys[p + SCATTER_RUN_CHUNK] != key)
    return;  // a short run: pass 1 wrote its row
  for (int c0 = 0; c0 < dim; c0 += 32) {
    const int c = c0 + lane;
    float acc = 0.f;
    for (long long k0 = p;; k0 += (long long)SCATTER_STAGE *
                                  SCATTER_RUN_CHUNK) {
      const long long mine = k0 + (long long)lane * SCATTER_RUN_CHUNK;
      const bool in_run = mine < n_pos && keys[mine] == key;
      const int n = __popc(__ballot_sync(0xffffffffu, in_run));
      if (c < dim) {
        float u[SCATTER_STAGE];
#pragma unroll
        for (int j = 0; j < SCATTER_STAGE; ++j) {
          if (j < n)
            u[j] = to_f32(partial[(k0 + (long long)j * SCATTER_RUN_CHUNK) *
                                      dim + c]);
        }
#pragma unroll
        for (int j = 0; j < SCATTER_STAGE; ++j) {
          if (j < n) acc = round_to<T>(__fadd_rn(acc, u[j]));
        }
      }
      if (n < SCATTER_STAGE) break;
    }
    if (c < dim) store_f32(out + (long long)key * dim + c, acc);
  }
}

template <typename T, int COMBINE, int SCALE>
static cudaError_t launch_scatter_mode(const int* keys, const long long* perm,
                                       long long n_pos, const void* g,
                                       const ScatterArgs& a, void* out,
                                       long long vocab, void* partial,
                                       cudaStream_t stream) {
  const long long blocks = (n_pos + SCATTER_WARPS - 1) / SCATTER_WARPS;
  scatter_chunk_kernel<T, COMBINE, SCALE>
      <<<(unsigned)blocks, SCATTER_WARPS * 32, 0, stream>>>(
          keys, perm, n_pos, static_cast<const T*>(g), a, vocab,
          static_cast<T*>(out), static_cast<T*>(partial));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scatter_runs_kernel<T><<<(unsigned)blocks, SCATTER_WARPS * 32, 0, stream>>>(
      keys, n_pos, vocab, a.dim, static_cast<const T*>(partial),
      static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
static cudaError_t launch_scatter(int combine, int scale, const int* keys,
                                  const long long* perm, long long n_pos,
                                  const void* g, const ScatterArgs& a,
                                  void* out, long long vocab, void* partial,
                                  cudaStream_t stream) {
  if (combine == kMulOthers)
    return launch_scatter_mode<T, kMulOthers, kScaleNone>(
        keys, perm, n_pos, g, a, out, vocab, partial, stream);
  if (scale == kScaleRecip)
    return launch_scatter_mode<T, kCopy, kScaleRecip>(
        keys, perm, n_pos, g, a, out, vocab, partial, stream);
  if (scale == kScaleLength)
    return launch_scatter_mode<T, kCopy, kScaleLength>(
        keys, perm, n_pos, g, a, out, vocab, partial, stream);
  return launch_scatter_mode<T, kCopy, kScaleNone>(keys, perm, n_pos, g, a,
                                                   out, vocab, partial,
                                                   stream);
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
    launch_fused<__nv_bfloat16>(combine, id_ptr, *args, out, batch, inv_n, s);
  } else {
    launch_fused<float>(combine, id_ptr, *args, out, batch, inv_n, s);
  }
  return (int)cudaGetLastError();
}

// ids: [batch, bag] int32; lengths: [batch] int32; table: [vocab, dim];
// out: [batch, dim], all contiguous, of the table's dtype.
int zoo_embedding_bag(const void* ids, const void* lengths, const void* table,
                      long long vocab, int dim, long long batch, int bag,
                      int mean, int is_bf16, void* out, void* stream) {
  if (vocab < 1 || bag < 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || dim <= 0) return (int)cudaSuccess;
  const int* id_ptr = static_cast<const int*>(ids);
  const int* len_ptr = static_cast<const int*>(lengths);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    launch_bag<__nv_bfloat16>(id_ptr, len_ptr, table, vocab, dim, batch, bag,
                              mean, out, s);
  } else {
    launch_bag<float>(id_ptr, len_ptr, table, vocab, dim, batch, bag, mean,
                      out, s);
  }
  return (int)cudaGetLastError();
}

// sorted_keys: [n_pos] int32, the row of each position after a stable sort
// (vocab for a dropped position); perm: [n_pos] int64, the position each
// sorted slot came from; grad: the output gradient; out: [vocab, args->dim]
// of the table's dtype, zero-filled by the caller (rows that get no update
// stay zero); partial: [n_pos, args->dim] scratch of the table's dtype,
// uninitialised (the chunk sums of long runs). Launches the two passes on
// `stream` and returns the first launch error (0 when both were accepted).
int zoo_embedding_scatter_add(const void* sorted_keys, const void* perm,
                              long long n_pos, const void* grad,
                              const ScatterArgs* args, void* out,
                              long long vocab, int combine, int scale,
                              int is_bf16, void* partial, void* stream) {
  if (combine < kCopy || combine > kMulOthers || scale < kScaleNone ||
      scale > kScaleLength || args->bag < 1 || args->dim < 0 ||
      (combine == kMulOthers &&
       (args->n_tables < 1 || args->n_tables > ZOO_MAX_TABLES)))
    return (int)cudaErrorInvalidValue;
  if (n_pos <= 0 || args->dim == 0 || vocab <= 0) return (int)cudaSuccess;
  const int* k = static_cast<const int*>(sorted_keys);
  const long long* pm = static_cast<const long long*>(perm);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      is_bf16 ? launch_scatter<__nv_bfloat16>(combine, scale, k, pm, n_pos,
                                              grad, *args, out, vocab,
                                              partial, s)
              : launch_scatter<float>(combine, scale, k, pm, n_pos, grad,
                                      *args, out, vocab, partial, s);
  return (int)err;
}

const char* zoo_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
