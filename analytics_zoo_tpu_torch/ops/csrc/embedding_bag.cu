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
//    No lengths (a null pointer) means every slot is live and len[b] = L.
//    The kernel clamps each id it reads into [0, V-1], as JAX clamps before
//    either route, so the wrapper passes the ids as they come and no read
//    leaves the table.
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
// for mul) and writes the gradient table. Tensor cores and TMA have nothing
// to do here: what counts is the bytes in flight on each SM and 16-byte
// transactions. Design of the lookups:
//   - a group of G lanes (a power of two, at most a warp) owns one batch row
//     or bag, so a block of LOOKUP_THREADS holds LOOKUP_THREADS / G rows and
//     a row's index is a shift of the thread index: no divide per element.
//     The grid is one block per LOOKUP_THREADS / G rows (500 blocks at NCF's
//     b 8000), enough to spread over all 132 SMs;
//   - lane k of the group owns vector k (and k + G, ...) of the row's
//     columns: VB bytes, the widest of 16, 8, 4 (2 for bf16) that the row
//     width, the table's base and the output's base (and, for concat, the
//     segment's offset in the output row) allow. The launcher picks VB from
//     the pointers at each launch; every VB is a variant of the same kernel.
//     d 20 fp32 rows (80 B) take 16-byte loads when the table starts on 16
//     bytes, bf16 ones (40 B) 8-byte loads, a table view offset by one
//     element 4- (2-) byte loads;
//   - the fused lookup: lane t < N loads the row's id t (coalesced across
//     the groups of a warp) and resolves it; the resolved rows go to the
//     group's lanes by __shfl_sync. Each lane issues the loads of all N
//     tables before it stores or combines, so N loads are in flight a lane.
//     concat copies bits, each table's segment with its own VB; sum, mean
//     and mul combine the N vectors per element in table order;
//   - the bag: G >= BAG_UNROLL; lane k loads the id of slot s0 + k (G slots
//     at a time, coalesced), clamps it, and the rows' offsets go to the
//     lanes by __shfl_sync; each lane issues the loads of BAG_UNROLL slots
//     into registers, then adds them in slot order, so the loads overlap and
//     the sum order stays the plain version's.
// Registers a thread (nvcc 12.8 -Xptxas=-v, sm_90a, --fmad=false), by
// vector bytes VB: fused_concat_kernel 94; fused_combine_kernel fp32 55-56
// (VB 4), 64-66 (8), 72 (16), bf16 56-58 (2), 48 (4), 55-62 (8), 72 (16);
// bag_kernel, capped at 64, fp32 48 (4), 54-55 (8), 64 (16), bf16 48 (2),
// 40 (4), 45-46 (8), 59-62 (16). Only the fp32 bag's VB 16 sum spills (8
// bytes). Uncapped, the bag took 71-79 registers at VB 16 with its rows 8
// slots ahead, and the wide case ran in two waves.
// The scatter takes two launches, a warp per sorted position in each, the
// lanes owning columns:
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
// The wrapper builds one per set of tables and combine and keeps it.
struct FusedArgs {
  const void* table[ZOO_MAX_TABLES];
  long long vocab[ZOO_MAX_TABLES];
  int dim[ZOO_MAX_TABLES];
  int offset[ZOO_MAX_TABLES];  // first output column of table t (concat)
  int n_tables;
  int d_out;
  int combine;  // Combine
  int is_bf16;  // 0: fp32 tables and output, 1: bf16
  float inv_n;  // mean: float(1.0 / n_tables)
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

// Row index of id in a table of `vocab` rows, or -1 for a NaN row.
__device__ __forceinline__ long long resolve_row(int id, long long vocab) {
  long long r = id;
  if (r < 0) r += vocab;
  return (r >= 0 && r < vocab) ? r : -1;
}

// ------------------------------------------------------------- vectors

#define LOOKUP_THREADS 128  // threads a block of the lookups
#define BAG_UNROLL 4        // bag slots whose rows are in flight a lane
#define BAG_BLOCKS_PER_SM 8 // the bag's blocks an SM holds at once

// 32-bit words of a vector of VB bytes (a 2-byte vector takes one word).
template <int VB>
struct Words {
  unsigned w[VB >= 4 ? VB / 4 : 1];
};

template <int VB>
__device__ __forceinline__ Words<VB> load_words(const char* p) {
  Words<VB> v;
  if constexpr (VB == 16) {
    const uint4 x = __ldg(reinterpret_cast<const uint4*>(p));
    v.w[0] = x.x; v.w[1] = x.y; v.w[2] = x.z; v.w[3] = x.w;
  } else if constexpr (VB == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v.w[0] = x.x; v.w[1] = x.y;
  } else if constexpr (VB == 4) {
    v.w[0] = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    v.w[0] = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return v;
}

template <int VB>
__device__ __forceinline__ void store_words(char* p, const Words<VB>& v) {
  if constexpr (VB == 16) {
    *reinterpret_cast<uint4*>(p) = make_uint4(v.w[0], v.w[1], v.w[2], v.w[3]);
  } else if constexpr (VB == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v.w[0], v.w[1]);
  } else if constexpr (VB == 4) {
    *reinterpret_cast<unsigned*>(p) = v.w[0];
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)v.w[0];
  }
}

// Element e of a vector of T, widened to fp32 exactly (bf16: its bits in
// the high half of an fp32; element 0 is the low half of a word).
template <typename T>
__device__ __forceinline__ float element(const unsigned* w, int e);
template <>
__device__ __forceinline__ float element<float>(const unsigned* w, int e) {
  return __uint_as_float(w[e]);
}
template <>
__device__ __forceinline__ float element<__nv_bfloat16>(const unsigned* w,
                                                        int e) {
  const unsigned x = w[e >> 1];
  return __uint_as_float((e & 1) ? (x & 0xffff0000u) : (x << 16));
}

// VB / sizeof(T) fp32 values rounded to T (bf16: __float2bfloat16_rn) and
// packed into the words of one vector.
template <typename T, int VB>
__device__ __forceinline__ Words<VB> pack(const float* v) {
  Words<VB> out;
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int e = 0; e < VB / 4; ++e) out.w[e] = __float_as_uint(v[e]);
  } else {
#pragma unroll
    for (int i = 0; i < (VB >= 4 ? VB / 4 : 1); ++i) out.w[i] = 0u;
#pragma unroll
    for (int e = 0; e < VB / 2; ++e) {
      const unsigned h = __bfloat16_as_ushort(__float2bfloat16_rn(v[e]));
      out.w[e >> 1] |= h << (16 * (e & 1));
    }
  }
  return out;
}

// Vector of any width up to 16 bytes, chosen at run time (the concat copy:
// each table's segment has its own width).
__device__ __forceinline__ uint4 load_any(const char* p, int vb) {
  uint4 v;
  if (vb == 16) {
    v = __ldg(reinterpret_cast<const uint4*>(p));
  } else if (vb == 8) {
    const uint2 x = __ldg(reinterpret_cast<const uint2*>(p));
    v.x = x.x; v.y = x.y;
  } else if (vb == 4) {
    v.x = __ldg(reinterpret_cast<const unsigned*>(p));
  } else {
    v.x = __ldg(reinterpret_cast<const unsigned short*>(p));
  }
  return v;
}

__device__ __forceinline__ void store_any(char* p, int vb, uint4 v) {
  if (vb == 16) {
    *reinterpret_cast<uint4*>(p) = v;
  } else if (vb == 8) {
    *reinterpret_cast<uint2*>(p) = make_uint2(v.x, v.y);
  } else if (vb == 4) {
    *reinterpret_cast<unsigned*>(p) = v.x;
  } else {
    *reinterpret_cast<unsigned short*>(p) = (unsigned short)v.x;
  }
}

// Lanes of the group of 1 << log_group lanes that holds this thread.
__device__ __forceinline__ unsigned group_mask(int log_group) {
  const int g = 1 << log_group;
  const unsigned ones = g == 32 ? 0xffffffffu : (1u << g) - 1u;
  return ones << ((threadIdx.x & 31) & ~(g - 1));
}

// The largest of 16, 8, 4, 2 bytes (at least one element of `elem` bytes)
// that divides each address and byte count or-ed into `bits` (a power of
// two divides each term exactly when it divides their or).
static int vector_bytes(unsigned long long bits, int elem) {
  for (int vb = 16; vb > elem; vb >>= 1)
    if (bits % vb == 0) return vb;
  return elem;
}

// The smallest power of two >= n, within [lo, 32].
static int group_for(int n, int lo) {
  int g = lo;
  while (g < n && g < 32) g <<= 1;
  return g;
}

static int log2_of(int g) {
  int l = 0;
  while ((1 << l) < g) ++l;
  return l;
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

// ------------------------------------------------------------ fused lookup

// What one launch of the fused lookup needs, made by launch_fused from the
// wrapper's FusedArgs and the output pointer. Byte units throughout.
struct LookupPlan {
  const char* table[ZOO_MAX_TABLES];
  long long vocab[ZOO_MAX_TABLES];
  int row_bytes[ZOO_MAX_TABLES];  // table t's row
  int out_off[ZOO_MAX_TABLES];    // table t's segment in an output row
  int vb[ZOO_MAX_TABLES];         // vector bytes of table t
  int n_vec[ZOO_MAX_TABLES];      // vectors in a row of table t
  int n_tables;
  int max_vec;                    // the largest n_vec
  int out_row_bytes;
  int log_group;                  // G = 1 << log_group lanes a batch row
  float inv_n;
};

// Lane t < N of batch row b's group (k: the lane's index in it) loads and
// resolves the row's id t; every lane of the group gets each table's
// resolved row (-1: a NaN row).
__device__ __forceinline__ void lookup_rows(const int* __restrict__ ids,
                                            const LookupPlan& p, long long b,
                                            int k, unsigned mask,
                                            long long (&row)[ZOO_MAX_TABLES]) {
  long long mine = -1;
  if (k < p.n_tables) mine = resolve_row(ids[b * p.n_tables + k], p.vocab[k]);
#pragma unroll
  for (int t = 0; t < ZOO_MAX_TABLES; ++t)
    if (t < p.n_tables)
      row[t] = __shfl_sync(mask, mine, t, 1 << p.log_group);
}

// concat: bits copied, each table's segment in vectors of its own width;
// a NaN row writes nan_word (the dtype's quiet NaN in every element).
__global__ void __launch_bounds__(LOOKUP_THREADS)
    fused_concat_kernel(const int* __restrict__ ids, const LookupPlan p,
                        char* __restrict__ out, long long batch,
                        unsigned nan_word) {
  const int lg = p.log_group;
  const int k = threadIdx.x & ((1 << lg) - 1);
  const long long b =
      (long long)blockIdx.x * (LOOKUP_THREADS >> lg) + (threadIdx.x >> lg);
  if (b >= batch) return;  // the whole group: it shares b
  long long row[ZOO_MAX_TABLES];
  lookup_rows(ids, p, b, k, group_mask(lg), row);
  char* out_row = out + b * p.out_row_bytes;
  const uint4 nan4 = make_uint4(nan_word, nan_word, nan_word, nan_word);
  for (int j = k; j < p.max_vec; j += 1 << lg) {
    uint4 v[ZOO_MAX_TABLES];
#pragma unroll
    for (int t = 0; t < ZOO_MAX_TABLES; ++t)
      if (t < p.n_tables && j < p.n_vec[t])
        v[t] = row[t] < 0 ? nan4
                          : load_any(p.table[t] + row[t] * p.row_bytes[t] +
                                         j * p.vb[t],
                                     p.vb[t]);
#pragma unroll
    for (int t = 0; t < ZOO_MAX_TABLES; ++t)
      if (t < p.n_tables && j < p.n_vec[t])
        store_any(out_row + p.out_off[t] + j * p.vb[t], p.vb[t], v[t]);
  }
}

// sum, mean, mul: every table's row read in vectors of VB bytes, combined
// per element in table order in fp32, rounded once to T.
template <typename T, int VB, int COMBINE>
__global__ void __launch_bounds__(LOOKUP_THREADS)
    fused_combine_kernel(const int* __restrict__ ids, const LookupPlan p,
                         char* __restrict__ out, long long batch) {
  constexpr int E = VB / sizeof(T);
  const int lg = p.log_group;
  const int k = threadIdx.x & ((1 << lg) - 1);
  const long long b =
      (long long)blockIdx.x * (LOOKUP_THREADS >> lg) + (threadIdx.x >> lg);
  if (b >= batch) return;
  long long row[ZOO_MAX_TABLES];
  lookup_rows(ids, p, b, k, group_mask(lg), row);
  for (int j = k; j < p.max_vec; j += 1 << lg) {
    Words<VB> v[ZOO_MAX_TABLES];
#pragma unroll
    for (int t = 0; t < ZOO_MAX_TABLES; ++t)
      if (t < p.n_tables && row[t] >= 0)
        v[t] = load_words<VB>(p.table[t] + row[t] * p.row_bytes[t] + j * VB);
    float acc[E];
#pragma unroll
    for (int t = 0; t < ZOO_MAX_TABLES; ++t) {
      if (t >= p.n_tables) continue;
#pragma unroll
      for (int e = 0; e < E; ++e) {
        const float x =
            row[t] < 0 ? __int_as_float(0x7fc00000) : element<T>(v[t].w, e);
        if (t == 0) {
          acc[e] = x;
        } else if (COMBINE == kMul) {
          acc[e] = __fmul_rn(acc[e], x);
        } else {
          acc[e] = __fadd_rn(acc[e], x);
        }
      }
    }
    if (COMBINE == kMean) {
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = __fmul_rn(acc[e], p.inv_n);
    }
    store_words<VB>(out + b * p.out_row_bytes + j * VB, pack<T, VB>(acc));
  }
}

template <typename T, int VB>
static void launch_combine(int combine, unsigned blocks, const int* ids,
                           const LookupPlan& p, char* out, long long batch,
                           cudaStream_t stream) {
  if (combine == kSum)
    fused_combine_kernel<T, VB, kSum>
        <<<blocks, LOOKUP_THREADS, 0, stream>>>(ids, p, out, batch);
  else if (combine == kMean)
    fused_combine_kernel<T, VB, kMean>
        <<<blocks, LOOKUP_THREADS, 0, stream>>>(ids, p, out, batch);
  else
    fused_combine_kernel<T, VB, kMul>
        <<<blocks, LOOKUP_THREADS, 0, stream>>>(ids, p, out, batch);
}

static void launch_fused(const int* ids, const FusedArgs& a, void* out,
                         long long batch, cudaStream_t stream) {
  const int elem = a.is_bf16 ? 2 : 4;
  LookupPlan p;
  p.n_tables = a.n_tables;
  p.out_row_bytes = a.d_out * elem;
  p.inv_n = a.inv_n;
  p.max_vec = 0;
  const unsigned long long out_bits =
      (unsigned long long)out | (unsigned long long)p.out_row_bytes;
  // sum, mean and mul add the tables' vectors element by element, so they
  // share one width: the one every table allows
  unsigned long long common = out_bits;
  for (int t = 0; t < a.n_tables; ++t)
    common |= (unsigned long long)a.table[t] |
              (unsigned long long)(a.dim[t] * elem);
  for (int t = 0; t < a.n_tables; ++t) {
    p.table[t] = static_cast<const char*>(a.table[t]);
    p.vocab[t] = a.vocab[t];
    p.row_bytes[t] = a.dim[t] * elem;
    p.out_off[t] = a.combine == kConcat ? a.offset[t] * elem : 0;
    p.vb[t] = a.combine == kConcat
                  ? vector_bytes(out_bits | (unsigned long long)a.table[t] |
                                     (unsigned long long)p.row_bytes[t] |
                                     (unsigned long long)p.out_off[t],
                                 elem)
                  : vector_bytes(common, elem);
    p.n_vec[t] = p.row_bytes[t] / p.vb[t];
    if (p.n_vec[t] > p.max_vec) p.max_vec = p.n_vec[t];
  }
  const int g = group_for(p.max_vec > a.n_tables ? p.max_vec : a.n_tables, 1);
  p.log_group = log2_of(g);
  const long long rows_per_block = LOOKUP_THREADS / g;
  const unsigned blocks =
      (unsigned)((batch + rows_per_block - 1) / rows_per_block);
  char* o = static_cast<char*>(out);
  if (a.combine == kConcat) {
    fused_concat_kernel<<<blocks, LOOKUP_THREADS, 0, stream>>>(
        ids, p, o, batch, a.is_bf16 ? 0x7fc07fc0u : 0x7fc00000u);
    return;
  }
  if (a.is_bf16) {
    switch (p.vb[0]) {
      case 16: launch_combine<__nv_bfloat16, 16>(a.combine, blocks, ids, p, o,
                                                batch, stream); break;
      case 8: launch_combine<__nv_bfloat16, 8>(a.combine, blocks, ids, p, o,
                                              batch, stream); break;
      case 4: launch_combine<__nv_bfloat16, 4>(a.combine, blocks, ids, p, o,
                                              batch, stream); break;
      default: launch_combine<__nv_bfloat16, 2>(a.combine, blocks, ids, p, o,
                                               batch, stream); break;
    }
  } else {
    switch (p.vb[0]) {
      case 16: launch_combine<float, 16>(a.combine, blocks, ids, p, o, batch,
                                        stream); break;
      case 8: launch_combine<float, 8>(a.combine, blocks, ids, p, o, batch,
                                      stream); break;
      default: launch_combine<float, 4>(a.combine, blocks, ids, p, o, batch,
                                       stream); break;
    }
  }
}

// --------------------------------------------------------------------- bag

// One bag per group of G >= BAG_UNROLL lanes; lane k owns the vectors
// k, k + G, ... of VB bytes of the row. At most 64 registers a thread, so
// BAG_BLOCKS_PER_SM blocks fit an SM: the wide case's 4096 bags of d 128
// fp32 (one a warp, 1024 blocks) then run in one wave of 132 x 8 blocks
// instead of two of 132 x 7.
template <typename T, int VB, bool MEAN>
__global__ void __launch_bounds__(LOOKUP_THREADS, BAG_BLOCKS_PER_SM)
    bag_kernel(const int* __restrict__ ids, const int* __restrict__ lengths,
               const char* __restrict__ table, long long vocab,
               int row_bytes, int n_vec, long long batch, int bag,
               int log_group, char* __restrict__ out) {
  constexpr int E = VB / sizeof(T);
  const int g = 1 << log_group;
  const int k = threadIdx.x & (g - 1);
  const long long b = (long long)blockIdx.x * (LOOKUP_THREADS >> log_group) +
                      (threadIdx.x >> log_group);
  if (b >= batch) return;  // the whole group: it shares b
  const unsigned mask = group_mask(log_group);
  const int len = lengths != nullptr ? __ldg(lengths + b) : bag;
  const int n = len < 0 ? 0 : (len < bag ? len : bag);  // live slots
  const int* row_ids = ids + b * bag;
  // every lane of the group runs the same trips (n and n_vec are the
  // group's), so the shuffles see the whole group
  for (int c0 = 0; c0 < n_vec; c0 += g) {
    const int j = c0 + k;
    const bool mine = j < n_vec;
    const char* col = table + (long long)j * VB;
    float acc[E];
#pragma unroll
    for (int e = 0; e < E; ++e) acc[e] = 0.f;
    for (int s0 = 0; s0 < n; s0 += g) {
      const int cnt = n - s0 < g ? n - s0 : g;
      long long off = 0;  // byte offset of slot s0 + k's row
      if (k < cnt) {
        long long r = __ldg(row_ids + s0 + k);
        r = r < 0 ? 0 : (r >= vocab ? vocab - 1 : r);
        off = r * row_bytes;
      }
      for (int u0 = 0; u0 < cnt; u0 += BAG_UNROLL) {
        Words<VB> v[BAG_UNROLL];
#pragma unroll
        for (int u = 0; u < BAG_UNROLL; ++u) {
          const long long o = __shfl_sync(mask, off, u0 + u, g);
          if (mine && u0 + u < cnt) v[u] = load_words<VB>(col + o);
        }
#pragma unroll
        for (int u = 0; u < BAG_UNROLL; ++u) {
          if (mine && u0 + u < cnt) {
#pragma unroll
            for (int e = 0; e < E; ++e)
              acc[e] = __fadd_rn(acc[e], element<T>(v[u].w, e));
          }
        }
      }
    }
    if (MEAN) {
      const float d = (float)(len > 1 ? len : 1);
#pragma unroll
      for (int e = 0; e < E; ++e) acc[e] = __fdiv_rn(acc[e], d);
    }
    if (mine)
      store_words<VB>(out + b * row_bytes + (long long)j * VB,
                      pack<T, VB>(acc));
  }
}

template <typename T, int VB>
static void launch_bag_vec(const int* ids, const int* lengths,
                           const char* table, long long vocab, int row_bytes,
                           long long batch, int bag, int mean, char* out,
                           cudaStream_t stream) {
  const int n_vec = row_bytes / VB;
  const int g = group_for(n_vec, BAG_UNROLL);
  const int lg = log2_of(g);
  const long long rows_per_block = LOOKUP_THREADS / g;
  const unsigned blocks =
      (unsigned)((batch + rows_per_block - 1) / rows_per_block);
  if (mean)
    bag_kernel<T, VB, true><<<blocks, LOOKUP_THREADS, 0, stream>>>(
        ids, lengths, table, vocab, row_bytes, n_vec, batch, bag, lg, out);
  else
    bag_kernel<T, VB, false><<<blocks, LOOKUP_THREADS, 0, stream>>>(
        ids, lengths, table, vocab, row_bytes, n_vec, batch, bag, lg, out);
}

static void launch_bag(const int* ids, const int* lengths, const void* table,
                       long long vocab, int dim, long long batch, int bag,
                       int mean, int is_bf16, void* out,
                       cudaStream_t stream) {
  const int elem = is_bf16 ? 2 : 4;
  const int row_bytes = dim * elem;
  const int vb = vector_bytes((unsigned long long)table |
                                  (unsigned long long)out |
                                  (unsigned long long)row_bytes,
                              elem);
  const char* t = static_cast<const char*>(table);
  char* o = static_cast<char*>(out);
  if (is_bf16) {
    switch (vb) {
      case 16: launch_bag_vec<__nv_bfloat16, 16>(ids, lengths, t, vocab,
                                                row_bytes, batch, bag, mean,
                                                o, stream); break;
      case 8: launch_bag_vec<__nv_bfloat16, 8>(ids, lengths, t, vocab,
                                              row_bytes, batch, bag, mean, o,
                                              stream); break;
      case 4: launch_bag_vec<__nv_bfloat16, 4>(ids, lengths, t, vocab,
                                              row_bytes, batch, bag, mean, o,
                                              stream); break;
      default: launch_bag_vec<__nv_bfloat16, 2>(ids, lengths, t, vocab,
                                               row_bytes, batch, bag, mean,
                                               o, stream); break;
    }
  } else {
    switch (vb) {
      case 16: launch_bag_vec<float, 16>(ids, lengths, t, vocab, row_bytes,
                                        batch, bag, mean, o, stream); break;
      case 8: launch_bag_vec<float, 8>(ids, lengths, t, vocab, row_bytes,
                                      batch, bag, mean, o, stream); break;
      default: launch_bag_vec<float, 4>(ids, lengths, t, vocab, row_bytes,
                                       batch, bag, mean, o, stream); break;
    }
  }
}

// An empty kernel: the launch path's own cost (zoo_empty_launch).
__global__ void empty_kernel() {}

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

// ids: [batch, n_tables] int32, contiguous; out: [batch, d_out] of the
// tables' dtype. Launches on `stream` on `device` (switching the calling
// thread's device only if it differs, and back) and returns the launch
// error (0 when the launch was accepted).
int zoo_fused_lookup(const void* ids, const FusedArgs* args, void* out,
                     long long batch, int device, void* stream) {
  if (args->n_tables < 1 || args->n_tables > ZOO_MAX_TABLES ||
      args->combine < kConcat || args->combine > kMul)
    return (int)cudaErrorInvalidValue;
  if (batch <= 0 || args->d_out <= 0) return (int)cudaSuccess;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  launch_fused(static_cast<const int*>(ids), *args, out, batch,
               static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// ids: [batch, bag] int32 (clamped into [0, vocab - 1] as read); lengths:
// [batch] int32, or null when every slot is live; table: [vocab, dim]; out:
// [batch, dim], all contiguous, of the table's dtype. Device and stream as
// zoo_fused_lookup.
int zoo_embedding_bag(const void* ids, const void* lengths, const void* table,
                      long long vocab, int dim, long long batch, int bag,
                      int mean, int is_bf16, void* out, int device,
                      void* stream) {
  if (vocab < 1 || bag < 0) return (int)cudaErrorInvalidValue;
  if (batch <= 0 || dim <= 0) return (int)cudaSuccess;
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  launch_bag(static_cast<const int*>(ids), static_cast<const int*>(lengths),
             table, vocab, dim, batch, bag, mean, is_bf16, out,
             static_cast<cudaStream_t>(stream));
  return (int)cudaGetLastError();
}

// One launch of an empty kernel through the same path as the lookups
// (device check, stream, launch, error): the binding's own cost.
int zoo_empty_launch(int device, void* stream) {
  DeviceScope scope(device);
  if (scope.err != cudaSuccess) return (int)scope.err;
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
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
