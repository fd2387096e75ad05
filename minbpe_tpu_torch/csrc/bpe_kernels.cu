// Hand-written Hopper (sm_90a) kernels of the BPE main path: training and
// encode over a DENSE token stream (the dense route's rank sweep, the sorted
// route's per-chunk lowest-rank rule through a cuckoo pair table).
//
// The stream is two int32 arrays, ids[i] and seg[i] (chunk id), plus a live
// length n that lives in device memory (int32[1]), so a whole training run is
// launched without one host sync per merge. Position i pairs with i + 1 when
// both are below n and seg[i] == seg[i + 1]. After every applied merge (or
// batch of merges) the stream is compacted again, so the stream order is the
// reference's scan order, a pair's first occurrence is its smallest position,
// and the previous / next / second-next live tokens of position p are simply
// p - 1, p + 1 and p + 2.
//
// Kernels and the Pallas code they replace
// (minbpe_tpu/ops/pallas/fused_train.py::_kernel, fused_encode.py::_kernel,
// fused_train_xl.py's seven grid-over-segment kernels B3-B9):
//
//   K1 pair_stats     <- tiled_adjacency + count_width/count_blocked/
//                        count_full (fused_train.py:251-290, :816-891);
//                        _adjcount_kernel (fused_train_xl.py:74-157);
//                        one counting core with K9 (count_pairs)
//   K5 select_batch   <- the selection walk sel_body + select_candidate +
//                        no_pair (fused_train.py:915-1000, :1042-1084,
//                        :1118-1123); _adjcount_kernel's _select
//                        (fused_train_xl.py:158-173), _tie_kernel (:176-244)
//                        and _train_xl's walk (:689-731)
//   K3 merge_apply    <- tiled_apply (fused_train.py:293-340), _apply_kernel
//                        (fused_train_xl.py:247-297); with a carry-in, the
//                        distributed trainer's apply (parallel/train.py
//                        _extended_keep, _apply_round :192-226, :420-449)
//   K6 batch_hist     <- tiled_batch_mark and tiled_batch_hist_rev
//                        (fused_train.py:452-593), _mark_kernel and
//                        _histrev_kernel (fused_train_xl.py:328-439): the
//                        batch's sites and both creation histograms, one
//                        pass
//   K8 batch_apply    <- the trim (fused_train.py:1140-1153) and
//                        tiled_batch_apply (:596-634), _batch_apply_kernel
//                        (fused_train_xl.py:442-508)
//   K4 compact        <- _compact_inplace (fused_train.py:641-736),
//                        _compact_kernel (fused_train_xl.py:300-326)
//   K10 encode_sweep  <- fused_encode.py::_kernel (:45-127): the whole rank
//                        sweep and its compaction, one launch
//   K9 pair_count     <- ops/pallas/pair_count.py::_kernel (:29-53), the
//                        dense pair-count matrix of the selection paths;
//                        K1's counting core without first positions
//   K11 chunk_encode  <- no Pallas site: ops/flat_encode.py::_encode_flat
//                        (:61-186), a jitted lax.while_loop, on chunks of at
//                        most 256 tokens: one lane a chunk of up to 8, one
//                        warp a longer one
//   K12 encode_min_sweep <- the same, on longer chunks: each chunk's own
//                        lowest-rank loop in one block or one cluster
//   K17 segment_encode <- no Pallas site of its own: the dense route's use
//                        of fused_encode.py::_kernel (K10) on a stream cut
//                        into many segments. Bound by latency (each
//                        segment's rounds wait on probes of the cuckoo
//                        table), so each segment runs its own lowest-rank
//                        loop with K11's lane and warp bodies (a block's
//                        loop in device memory for one past CHUNK_MAX
//                        tokens), a block's output placed by K4's
//                        look-back, in one launch from K10's input
//   K13 pair_select   <- no Pallas site: ops/train_sortloop.py::_round
//                        (:49-83), the sort-round trainer's stable sort,
//                        run scans and selection: every pair's count and
//                        first position into a device hash table, then the
//                        largest count, earliest first occurrence, in one
//                        cooperative launch that leaves the table empty
//   K16 pair_summaries <- no Pallas site: parallel/train.py's
//                        _local_run_summaries, and the merges of
//                        _sparse_global_select and _owner_global_select
//                        (:229-383): a rank's distinct pairs with counts
//                        and first positions, and the champion of gathered
//                        ones, on K13's table, one cooperative launch each
//   K15 presplit_succ and presplit_orbit <- no Pallas site:
//                        ops/device_presplit.py::_presplit_device (:208),
//                        the GPT-2 / GPT-4 pre-split of raw UTF-8 bytes,
//                        two cooperative launches (the last section of
//                        this file); K15 presplit_cluster, the same for a
//                        stream of at most 32 KB in one cluster launch
//
// Training runs in rebuild SLOTS. The host enqueues slots without knowing
// what a slot does: that lives in device memory.
//   ctl[CTL_I]        merges done so far (i); new ids start at 256 + i
//   ctl[CTL_FAIL]     the fail round (M until a rebuild finds no pair)
//   ctl[CTL_REBUILDS] count rebuilds so far, every active slot included
// A slot is active while i < fail (fail starts at M, and i never passes M).
// K1 and K5 read ctl. K5 writes the slot record `slot` (the accepted
// candidates, their count bsel, and a snapshot of i), and every later kernel
// of the slot reads only the record, so the one thread that advances i (K5
// for a single merge, K8's trim for a batch) can do so while later kernels
// are still queued. The gates: K3 runs when bsel == 1, K6 and K8 when
// bsel >= 2, K4 when bsel >= 1; an idle slot has bsel = 0.
//
// Each extern "C" entry point launches one kernel on the caller's stream
// (K1 two, K9 a memset and one), allocates nothing, and returns
// cudaGetLastError() (0 on success), or the error of a refused
// cooperative or cluster launch (K10, K12, K13, K15, K16). K1, K9, K12 and
// K15's presplit_orbit also return the error of allowing their shared
// memory (once per device).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbpe_kernels.so bpe_kernels.cu

#include <atomic>
#include <type_traits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int TPB = 256;              // threads per block, tiled kernels
constexpr int IPT = 8;                // consecutive positions per thread
constexpr int TILE = TPB * IPT;       // positions per tile, K3 / K4 / K10
constexpr int MAX_STAT_BLOCKS = 132 * 8;

// the batch: K_CAP candidates at most, creation histograms of HB buckets
constexpr int K_CAP = 16;
constexpr int HB = 128;
constexpr int HIST = HB * K_CAP;      // one histogram, [bucket][candidate]

// ctl words
constexpr int CTL_I = 0;
constexpr int CTL_FAIL = 1;
constexpr int CTL_REBUILDS = 2;

// slot record words
constexpr int SLOT_PAIRS = 0;         // [2j], [2j + 1] = (pa_j, pb_j)
constexpr int SLOT_COUNT = 2 * K_CAP; // [SLOT_COUNT + j] = count of pair j
constexpr int SLOT_BSEL = 3 * K_CAP;  // candidates accepted (0: none, idle)
constexpr int SLOT_ZBASE = SLOT_BSEL + 1;  // 256 + i
constexpr int SLOT_I = SLOT_BSEL + 2;      // i at the slot's start
constexpr int SLOT_BSTAR = SLOT_BSEL + 3;  // merges applied by the slot

__device__ __forceinline__ bool idle(const int* ctl) {
  return ctl != nullptr && ctl[CTL_I] >= ctl[CTL_FAIL];
}

// a slot-mode kernel runs only when lo <= bsel <= hi
__device__ __forceinline__ bool gated_off(const int* slot, int lo, int hi) {
  if (slot == nullptr) return false;
  const int b = slot[SLOT_BSEL];
  return b < lo || b > hi;
}

template <bool CG>
__device__ __forceinline__ int ld1(const int* p) {
  if constexpr (CG) return __ldcg(p);
  else return __ldg(p);
}

template <bool CG>
__device__ __forceinline__ int4 ld4(const int* p) {
  if constexpr (CG) return __ldcg(reinterpret_cast<const int4*>(p));
  else return __ldg(reinterpret_cast<const int4*>(p));
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

__device__ __forceinline__ void unpack4(int4 v, int* o) {
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}

template <bool SUM>
__device__ __forceinline__ int op(int a, int b) {
  return SUM ? a + b : max(a, b);
}

// identity of the max-scan: every scanned value is a position (>= 0) or -1
template <bool SUM>
__device__ __forceinline__ int identity() {
  return SUM ? 0 : -1;
}

// Exclusive block scan of one int per thread (NT threads, NT % 32 == 0).
// *total receives the block's reduction, in every thread. Contains
// __syncthreads, so every thread of the block must call it.
template <bool SUM, int NT>
__device__ int block_exclusive_scan(int v, int* total) {
  __shared__ int warp_tot[32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  int x = v;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    int y = __shfl_up_sync(0xffffffffu, x, d);
    if (lane >= d) x = op<SUM>(x, y);
  }
  if (lane == 31) warp_tot[wid] = x;
  __syncthreads();
  if (wid == 0) {
    int w = lane < NT / 32 ? warp_tot[lane] : identity<SUM>();
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      int y = __shfl_up_sync(0xffffffffu, w, d);
      if (lane >= d) w = op<SUM>(w, y);
    }
    warp_tot[lane] = w;  // inclusive prefix over warps
  }
  __syncthreads();
  const int warp_excl = wid > 0 ? warp_tot[wid - 1] : identity<SUM>();
  int lane_excl = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) lane_excl = identity<SUM>();
  *total = warp_tot[NT / 32 - 1];
  __syncthreads();  // warp_tot is reused by the next call
  return op<SUM>(warp_excl, lane_excl);
}

// ---------------------------------------------------------------------------
// K1 pair_stats and K9 pair_count: one block-privatised pair histogram.
//
// Both count cnt[a * V + b] += 1 for every countable pair: a position p with
// p + 1 < n and seg[p] == seg[p + 1] whose ids a = ids[p], b = ids[p + 1]
// both lie in [0, W); an id outside it counts nowhere. The matrices are
// V x V (row stride V).
//   K1 (W = 256 + i from the trainer's ctl, or V without ctl) also keeps
//      first[a * V + b] = min(p), and rewrites only the W x W corner: its
//      clear kernel sets the corner's cnt to 0 and first to 0xFFFFFFFF (-1
//      as int32), one warp a row, and entries outside it keep what they
//      hold. An idle ctl returns before either kernel touches anything.
//   K9 (W = V) memsets the whole matrix first.
//
// Bound: bytes, 8 B read per token and 8 B (K1) or 4 B (K9) written per
// matrix entry: 8 n + 8 W^2 and 8 n + 4 V^2. The grid-stride kernels they
// replace sent about one L2 atomic per position (K1 two), because 32
// consecutive positions of text hold mostly distinct pairs, and a hot pair
// such as (" ", "t") serialised thousands of them at one address: 10-24x
// the bytes bound.
//
// So the histogram is privatised per block. A persistent grid (the blocks
// that fit on the device at once, capped at the stream's chunks of TILE
// positions) gives each block one contiguous range of chunks. A thread
// loads its IPT consecutive ids and seg with 16-byte loads and takes the
// token after them from its neighbour lane (lane 31 from memory), so each
// token is read from device memory once, and the pair at a chunk's last
// position belongs to that chunk alone. Equal pairs of a warp merge with
// __match_any_sync first (it collapses runs); each group's leader adds its
// size, and its position, which is the group's smallest, into an
// open-addressing table in dynamic shared memory: a key, a count and (K1)
// a first position per slot, the key claimed with a shared atomicCAS (the
// empty key is 0xFFFFFFFF, since key 0 is the pair (0, 0)). After its range
// the block flushes the table: one global atomicAdd (and one atomicMin) per
// occupied slot. On text the distinct pairs of a range are a small part of
// its positions, and a hot pair costs one global atomic per block. A table
// more than half full is flushed and cleared at the next chunk's end, and
// an insert that finds neither its key nor an empty slot within HIST_PROBES
// slots sends the global atomics itself; counts add and first is a min, so
// the result is exact either way.
//
// Geometry, tuned on the H100 with scripts/tune_pair_hist.py: 8,192 slots
// (96 KB for K1, 64 KB for K9: 2 and 3 blocks an SM), and a range of
// n / grid positions in whole chunks (47,683 for K1 on a 12.6M-token
// stream). What bounds them now is the shared-memory work per position:
// 3.4-6.3x the bytes bound on large streams, where the loads and matches
// alone take 1.4-1.6x. Where no pair is hot and a block gets one chunk,
// direct L2 atomics were faster (PERF.md).
// ---------------------------------------------------------------------------
constexpr unsigned EMPTY_KEY = 0xFFFFFFFFu;
constexpr int HIST_PROBES = 16;
// table slots 1 << log2: HIST_LOG2 by default (tuned on the H100 with
// scripts/tune_pair_hist.py), HIST_LOG2_MIN .. HIST_LOG2_MAX on request
constexpr int HIST_LOG2 = 13;
constexpr int HIST_LOG2_MIN = 5;
constexpr int HIST_LOG2_MAX = 14;

__device__ __forceinline__ int width_of(const int* ctl, int V) {
  return ctl == nullptr ? V : min(V, 256 + ctl[CTL_I]);
}

// The global side of the counting core: where a block's table flushes, and
// where a pair goes when the table has no room for it. K1 and K9 add into
// the V x V matrices at the key a * V + b (K1 also a min of first
// positions).
template <bool FIRST>
struct MatrixSink {
  static constexpr bool kFirst = FIRST;
  unsigned* cnt;
  unsigned* first;
  int W, V;

  __device__ __forceinline__ bool takes(int a, int b) const {
    return (unsigned)a < (unsigned)W && (unsigned)b < (unsigned)W;
  }
  __device__ __forceinline__ unsigned key(int a, int b) const {
    return (unsigned)(a * V + b);
  }
  __device__ __forceinline__ void add(unsigned k, unsigned c,
                                      unsigned p) const {
    atomicAdd(cnt + k, c);
    if (FIRST) atomicMin(first + k, p);
  }
};

template <class Key>
__device__ __forceinline__ unsigned slot_hash(Key k, int log2) {
  if constexpr (sizeof(Key) == 4)
    return (k * 0x9E3779B1u) >> (32 - log2);
  else
    return (unsigned)((k * 0x9E3779B97F4A7C15ull) >> (64 - log2));
}

// A block's table in dynamic shared memory, 1 << log2 slots: keys (all
// ones when empty), counts and (FIRST) first positions, each array 16-byte
// aligned.
template <bool FIRST>
struct PairTable {
  unsigned* key;
  unsigned* cnt;
  unsigned* first;
  int log2;

  // every slot empty; block-wide, the caller synchronises
  __device__ void clear() {
    const uint4 none = make_uint4(EMPTY_KEY, EMPTY_KEY, EMPTY_KEY, EMPTY_KEY);
    for (int q = threadIdx.x; q < (1 << log2) / 4; q += blockDim.x) {
      reinterpret_cast<uint4*>(key)[q] = none;
      reinterpret_cast<uint4*>(cnt)[q] = make_uint4(0, 0, 0, 0);
      if (FIRST) reinterpret_cast<uint4*>(first)[q] = none;
    }
  }

  // c occurrences of key k, the first at p; false when neither k nor an
  // empty slot lies within HIST_PROBES slots of its hash. ++*fresh when it
  // claims a slot.
  __device__ bool add(unsigned k, unsigned c, unsigned p, int* fresh) {
    const unsigned mask = (1u << log2) - 1;
    unsigned s = slot_hash(k, log2);
    for (int probe = 0; probe < HIST_PROBES; ++probe, s = (s + 1) & mask) {
      // a slot's key changes once per clear, from empty to its owner
      unsigned held = reinterpret_cast<volatile unsigned*>(key)[s];
      if (held == EMPTY_KEY) {
        held = atomicCAS(key + s, EMPTY_KEY, k);
        if (held == EMPTY_KEY) {
          held = k;
          ++*fresh;
        }
      }
      if (held == k) {
        atomicAdd(cnt + s, c);
        if (FIRST) atomicMin(first + s, p);
        return true;
      }
    }
    return false;
  }

  // each occupied slot into the sink, and emptied when reset; block-wide,
  // after a barrier
  template <class Sink>
  __device__ void flush(const Sink& sink, bool reset) {
    for (int q = threadIdx.x; q < (1 << log2) / 4; q += blockDim.x) {
      const uint4 k4 = reinterpret_cast<const uint4*>(key)[q];
      const unsigned ks[4] = {k4.x, k4.y, k4.z, k4.w};
      const uint4 c4 = reinterpret_cast<const uint4*>(cnt)[q];
      uint4 f4 = make_uint4(0, 0, 0, 0);
      if (FIRST) f4 = reinterpret_cast<const uint4*>(first)[q];
      const unsigned cs[4] = {c4.x, c4.y, c4.z, c4.w};
      const unsigned fs[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ks[j] == EMPTY_KEY) continue;
        sink.add(ks[j], cs[j], fs[j]);
      }
    }
    if (reset) clear();
  }
};

// ids and seg at p0 .. p0 + IPT - 1 into id[0 .. IPT), sg[0 .. IPT) (0 from
// n on), and at p0 + IPT into id[IPT], sg[IPT] from the next lane (lane 31
// from memory; meaningless from n on). Every lane of the warp calls it.
__device__ __forceinline__ void load_pairs(const int* ids, const int* seg,
                                           int p0, int n, bool vec,
                                           int (&id)[IPT + 1],
                                           int (&sg)[IPT + 1]) {
  if (vec && p0 + IPT <= n) {
#pragma unroll
    for (int v = 0; v < IPT / 4; ++v) {
      unpack4(ld4<false>(ids + p0 + 4 * v), id + 4 * v);
      unpack4(ld4<false>(seg + p0 + 4 * v), sg + 4 * v);
    }
  } else {
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      id[k] = p0 + k < n ? __ldg(ids + p0 + k) : 0;
      sg[k] = p0 + k < n ? __ldg(seg + p0 + k) : 0;
    }
  }
  id[IPT] = __shfl_down_sync(0xffffffffu, id[0], 1);
  sg[IPT] = __shfl_down_sync(0xffffffffu, sg[0], 1);
  if ((threadIdx.x & 31) == 31 && p0 + IPT < n) {
    id[IPT] = __ldg(ids + p0 + IPT);
    sg[IPT] = __ldg(seg + p0 + IPT);
  }
}

// The counting core of K1 and K9: the countable pairs of ids[0 .. n),
// seg[0 .. n) that the sink takes (both ids below W), added into the sink
// through the block's table (with their smallest positions where the sink
// keeps them). Chunk c holds the pairs at positions c * TILE .. c * TILE +
// TILE - 1.
template <class Sink>
__device__ void count_pairs(const int* __restrict__ ids,
                            const int* __restrict__ seg, int n,
                            const Sink& sink, int log2) {
  constexpr bool FIRST = Sink::kFirst;
  extern __shared__ uint4 hist_smem[];
  __shared__ int used;  // slots claimed since the last flush
  const int chunks = n >= 2 ? (n - 2) / TILE + 1 : 0;
  const int lo = (int)((long long)blockIdx.x * chunks / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * chunks / gridDim.x);
  if (lo >= hi) return;
  const int T = 1 << log2;
  unsigned* const smem = reinterpret_cast<unsigned*>(hist_smem);
  PairTable<FIRST> tab{smem, smem + T, FIRST ? smem + 2 * T : nullptr, log2};
  tab.clear();
  if (threadIdx.x == 0) used = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const bool vec = aligned16(ids, seg);
  // the loop bound depends on the block only, so whole warps iterate
  // together and __match_any_sync sees every lane
  for (int c = lo; c < hi; ++c) {
    const int p0 = c * TILE + threadIdx.x * IPT;
    int id[IPT + 1], sg[IPT + 1];
    load_pairs(ids, seg, p0, n, vec, id, sg);
    int fresh = 0;
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int a = id[k], b = id[k + 1];
      const bool ok = p0 + k + 1 < n && sg[k] == sg[k + 1] && sink.takes(a, b);
      const unsigned key = ok ? sink.key(a, b) : EMPTY_KEY;
      const unsigned group = __match_any_sync(0xffffffffu, key);
      if (ok && lane == __ffs(group) - 1) {
        const unsigned m = __popc(group);
        const unsigned p = (unsigned)(p0 + k);
        if (!tab.add(key, m, p, &fresh)) sink.add(key, m, p);
      }
    }
    fresh = __reduce_add_sync(0xffffffffu, fresh);
    if (lane == 0 && fresh) atomicAdd(&used, fresh);
    // thread 0 may read used before later warps add theirs: the flush then
    // comes a chunk later, and a full table only sends more global work
    const bool full = __syncthreads_or(
        threadIdx.x == 0 && *reinterpret_cast<volatile int*>(&used) > T / 2);
    if (full || c + 1 == hi) {
      tab.flush(sink, c + 1 < hi);
      if (threadIdx.x == 0) used = 0;
      __syncthreads();
    }
  }
}

// K1's clear: the W x W corner, one warp a row, 16-byte stores when every
// row is 16-byte aligned.
__global__ void __launch_bounds__(TPB)
    clear_stats_kernel(const int* ctl, unsigned* __restrict__ cnt,
                       unsigned* __restrict__ first, int V) {
  if (idle(ctl)) return;
  const int W = width_of(ctl, V);
  const int lane = threadIdx.x & 31;
  const int quads = V % 4 == 0 && aligned16(cnt, first) ? W / 4 : 0;
  const uint4 none = make_uint4(EMPTY_KEY, EMPTY_KEY, EMPTY_KEY, EMPTY_KEY);
  for (int r = blockIdx.x * (TPB / 32) + (threadIdx.x >> 5); r < W;
       r += gridDim.x * (TPB / 32)) {
    unsigned* const c = cnt + (size_t)r * V;
    unsigned* const f = first + (size_t)r * V;
    for (int q = lane; q < quads; q += 32) {
      reinterpret_cast<uint4*>(c)[q] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(f)[q] = none;
    }
    for (int j = 4 * quads + lane; j < W; j += 32) {
      c[j] = 0u;
      f[j] = EMPTY_KEY;
    }
  }
}

__global__ void __launch_bounds__(TPB)
    pair_stats_kernel(const int* __restrict__ ids,
                      const int* __restrict__ seg,
                      const int* __restrict__ n_ptr, const int* ctl,
                      unsigned* cnt, unsigned* first, int V, int log2) {
  if (idle(ctl)) return;
  count_pairs(ids, seg, *n_ptr,
              MatrixSink<true>{cnt, first, width_of(ctl, V), V}, log2);
}

__global__ void __launch_bounds__(TPB)
    pair_count_kernel(const int* __restrict__ ids,
                      const int* __restrict__ seg,
                      const int* __restrict__ n_ptr, unsigned* cnt, int V,
                      int log2) {
  count_pairs(ids, seg, *n_ptr, MatrixSink<false>{cnt, nullptr, V, V},
              log2);
}

// ---------------------------------------------------------------------------
// K5 select_batch: the selection walk of one count rebuild.
//
// The reference's max(stats, key=stats.get) over first-occurrence order is
// one 64-bit max of   key = count << 32 | (0xFFFFFFFF - first)   (0 for an
// absent pair): the largest key has the largest count and, among equal
// counts, the earliest first occurrence. The Pallas walk takes that argmax,
// zeroes it and takes the next one, K_CAP times at most; so it visits the
// pairs in descending key order, and needs only the K_CAP largest keys. No
// tie walk is needed, and no 64-tie cliff exists. Keys are unique, except
// 0, because first positions are unique per pair.
//
// A warp takes one row of the W x W corner: each lane loads its columns of
// cnt and first with 16-byte loads, all at once, and forms their keys in
// registers, with the pair (a, b) that the matrix index names, so nothing
// reads the stream. The K_CAP largest keys of a block, and then of all the
// blocks' lists, come from one selection (block_select): a bound lo at or
// below the K_CAP-th largest key is known first, the keys at or above it
// are gathered in shared memory, and each of those is placed by counting
// the gathered keys above it (keys are unique, so ranks are too). A row's
// bound is the K_CAP-th largest of its 32 lanes' maxima (16 distinct keys
// are at least that large), a block's the largest of its rows', and the
// blocks' lists give the largest of their K_CAP-th keys. On text few keys
// pass the bound, so a key costs a compare and the gathering a few shared
// atomics. The last block to finish (a done counter, which that block
// leaves zero again) merges the blocks' lists, and its warp 0 walks the
// candidates, candidate j in lane j: candidate j is accepted while its
// count is > 0 and either j == 0, or it is heterogeneous, candidate 0 is
// heterogeneous, and it shares no cross-side token with an earlier one (qa
// != pb, qb != pa); the walk stops at the first rejection
// (fused_train.py:1059-1064). It writes the slot record, counts the
// rebuild, sets fail = i when nothing was accepted, and for a single merge
// writes log row i and advances i.
//
// Grid: a warp per row of the V x V matrices (V / 8 blocks, at most 128),
// fixed per V since the host does not know W; warps past W's rows hold no
// keys.
// Bound: bytes (8 B per W x W entry read; 8 MB at W = 1024, which L2 holds).
// ---------------------------------------------------------------------------
constexpr unsigned FULL = 0xffffffffu;
constexpr int SEL_WARPS = TPB / 32;
constexpr int SEL_MAX_V = 1024;              // a row is 8 quads a lane
constexpr int SEL_QUADS = SEL_MAX_V / 128;
constexpr int SEL_KEYS = 4 * SEL_QUADS;      // a lane's keys of its row
constexpr int SEL_MAX_GRID = SEL_MAX_V / SEL_WARPS;
constexpr int SEL_LIST_KEYS = SEL_MAX_GRID * K_CAP / TPB;  // last block
constexpr int SEL_CAP = 2048;                // keys gathered at once

__device__ __forceinline__ unsigned long long sel_key(unsigned c,
                                                      unsigned f) {
  return c ? ((unsigned long long)c << 32) | (0xFFFFFFFFu - f) : 0ull;
}

struct SelShared {
  unsigned long long key[SEL_CAP];  // the gathered keys and their pairs
  unsigned ab[SEL_CAP];
  unsigned long long out_key[K_CAP];
  unsigned out_ab[K_CAP];
  unsigned long long lo;
  int ncand;
  bool last;
};

// Block-wide: the C gathered keys' K_CAP largest, descending, into
// sh.out_key / sh.out_ab (zeros after the last); ends synchronised.
__device__ void rank_gathered(SelShared& sh, int C) {
  if (threadIdx.x < K_CAP) {
    sh.out_key[threadIdx.x] = 0;
    sh.out_ab[threadIdx.x] = 0;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < C; s += TPB) {
    const unsigned long long k = sh.key[s];
    int rank = 0;
    for (int u = 0; u < C; ++u) rank += sh.key[u] > k;
    if (rank < K_CAP) {
      sh.out_key[rank] = k;
      sh.out_ab[rank] = sh.ab[s];
    }
  }
  __syncthreads();
}

// Block-wide: the K_CAP largest of every thread's R keys k[j] (0: none;
// pair ab_of(j)) into sh.out_key / sh.out_ab, given lo at or below the
// K_CAP-th largest of them. Should more than SEL_CAP keys reach lo, the
// K_CAP-th largest of SEL_CAP gathered ones is a higher bound, and the
// gathering starts again (each round drops SEL_CAP - K_CAP keys).
template <int R, class ABOf>
__device__ void block_select(SelShared& sh, const unsigned long long (&k)[R],
                             ABOf ab_of, unsigned long long lo) {
  while (true) {
    if (threadIdx.x == 0) sh.ncand = 0;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < R; ++j) {
      if (k[j] != 0 && k[j] >= lo) {
        const int s = atomicAdd(&sh.ncand, 1);
        if (s < SEL_CAP) {
          sh.key[s] = k[j];
          sh.ab[s] = ab_of(j);
        }
      }
    }
    __syncthreads();
    const int C = sh.ncand;
    if (C <= SEL_CAP) {
      rank_gathered(sh, C);
      return;
    }
    rank_gathered(sh, SEL_CAP);
    lo = sh.out_key[K_CAP - 1];
  }
}

// scratch: uint64 [done counter][gridDim.x * K_CAP keys][as many pairs]
__global__ void __launch_bounds__(TPB)
    select_batch_kernel(const unsigned* __restrict__ cnt,
                        const unsigned* __restrict__ first, int V, int* ctl,
                        int* slot, int* log, unsigned long long* scratch) {
  __shared__ SelShared sh;
  if (idle(ctl)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) slot[SLOT_BSEL] = 0;
    return;
  }
  const int i = ctl[CTL_I];
  const int W = width_of(ctl, V);
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  unsigned* done = reinterpret_cast<unsigned*>(scratch);
  unsigned long long* g_key = scratch + 1;
  unsigned long long* g_ab = g_key + gridDim.x * K_CAP;
  if (threadIdx.x == 0) sh.lo = 0;

  // this warp's row: key j of a lane is column 4 (lane + 32 (j / 4)) + j % 4
  const int r = blockIdx.x * SEL_WARPS + wid;
  unsigned long long k[SEL_KEYS];
#pragma unroll
  for (int j = 0; j < SEL_KEYS; ++j) k[j] = 0;
  if (r < W) {
    const unsigned* crow = cnt + (size_t)r * V;
    const unsigned* frow = first + (size_t)r * V;
    const bool vec = V % 4 == 0 && aligned16(cnt, first);
#pragma unroll
    for (int s = 0; s < SEL_QUADS; ++s) {
      const int col = 4 * (lane + 32 * s);
      if (vec && col + 4 <= W) {
        const uint4 c = __ldg(reinterpret_cast<const uint4*>(crow + col));
        const uint4 f = __ldg(reinterpret_cast<const uint4*>(frow + col));
        k[4 * s + 0] = sel_key(c.x, f.x);
        k[4 * s + 1] = sel_key(c.y, f.y);
        k[4 * s + 2] = sel_key(c.z, f.z);
        k[4 * s + 3] = sel_key(c.w, f.w);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (col + q < W)
            k[4 * s + q] = sel_key(__ldg(crow + col + q),
                                   __ldg(frow + col + q));
      }
    }
  }
  // the row's bound: the K_CAP-th largest lane maximum
  unsigned long long m = 0;
#pragma unroll
  for (int j = 0; j < SEL_KEYS; ++j) m = k[j] > m ? k[j] : m;
  int above = 0;
#pragma unroll
  for (int q = 0; q < 32; ++q) above += __shfl_sync(FULL, m, q) > m;
  const unsigned at = __ballot_sync(FULL, m != 0 && above == K_CAP - 1);
  __syncthreads();  // sh.lo is zero
  if (at && lane == __ffs(at) - 1) atomicMax(&sh.lo, m);
  __syncthreads();
  block_select(sh, k, [&](int j) {
    return (unsigned)r << 16 |
           (unsigned)(4 * (lane + 32 * (j >> 2)) + (j & 3));
  }, sh.lo);
  if (threadIdx.x < K_CAP) {
    g_key[blockIdx.x * K_CAP + threadIdx.x] = sh.out_key[threadIdx.x];
    g_ab[blockIdx.x * K_CAP + threadIdx.x] = sh.out_ab[threadIdx.x];
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) sh.last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!sh.last) return;
  __threadfence();

  // the last block: the K_CAP largest of the blocks' lists; entry e of
  // list e / K_CAP in thread e % TPB, the lists' K_CAP-th keys the bound
  unsigned long long lk[SEL_LIST_KEYS];
  unsigned lab[SEL_LIST_KEYS];
#pragma unroll
  for (int j = 0; j < SEL_LIST_KEYS; ++j) {
    const int e = threadIdx.x + j * TPB;
    const bool in = e < gridDim.x * K_CAP;
    lk[j] = in ? __ldcg(g_key + e) : 0ull;
    lab[j] = in ? (unsigned)__ldcg(g_ab + e) : 0u;
  }
  if (threadIdx.x == 0) sh.lo = 0;
  __syncthreads();
  if (threadIdx.x % K_CAP == K_CAP - 1) {
    unsigned long long f = 0;
#pragma unroll
    for (int j = 0; j < SEL_LIST_KEYS; ++j) f = lk[j] > f ? lk[j] : f;
    if (f) atomicMax(&sh.lo, f);
  }
  __syncthreads();
  block_select(sh, lk, [&](int j) { return lab[j]; }, sh.lo);
  if (wid != 0) return;

  // the walk: candidate j in lane j
  const unsigned long long key = lane < K_CAP ? sh.out_key[lane] : 0ull;
  const unsigned ab = lane < K_CAP ? sh.out_ab[lane] : 0u;
  const int pa = (int)(ab >> 16);
  const int pb = (int)(ab & 0xFFFFu);
  const int c = (int)(key >> 32);
  const bool het = pa != pb;
  const bool het0 = __shfl_sync(FULL, (int)het, 0) != 0;
  bool clash = false;
#pragma unroll
  for (int q = 0; q < K_CAP; ++q) {
    const int qa = __shfl_sync(FULL, pa, q);
    const int qb = __shfl_sync(FULL, pb, q);
    clash = clash || (q < lane && (qa == pb || qb == pa));
  }
  const bool ok = key != 0 && (lane == 0 || (het && het0 && !clash));
  const unsigned okm = __ballot_sync(FULL, ok) & ((1u << K_CAP) - 1);
  const int bsel = __ffs(~okm) - 1;  // the accepted prefix
  if (lane < K_CAP) {
    const bool in = lane < bsel;
    slot[SLOT_PAIRS + 2 * lane] = in ? pa : -1;
    slot[SLOT_PAIRS + 2 * lane + 1] = in ? pb : -1;
    slot[SLOT_COUNT + lane] = in ? c : 0;
  }
  if (lane != 0) return;
  slot[SLOT_BSEL] = bsel;
  slot[SLOT_ZBASE] = 256 + i;
  slot[SLOT_I] = i;
  slot[SLOT_BSTAR] = bsel == 1 ? 1 : 0;
  ctl[CTL_REBUILDS] += 1;
  if (bsel == 0) {
    ctl[CTL_FAIL] = i;
  } else if (bsel == 1) {
    log[4 * i + 0] = pa;
    log[4 * i + 1] = pb;
    log[4 * i + 2] = c;
    log[4 * i + 3] = 0;  // K3 adds the kept count
    ctl[CTL_I] = i + 1;
  }
  *done = 0u;
}

// ---------------------------------------------------------------------------
// K13 pair_select: the sort-round trainer's round, count and selection in
// one cooperative launch (minbpe_tpu/ops/train_sortloop.py::_round, :49-83:
// one stable lax.sort of (a, b, position) per round, run lengths as counts,
// run heads as first occurrences, then the largest count and the earliest
// first occurrence; no Pallas site).
//
// The count goes into an open-addressing table in device memory (the
// trainer's kernels.PairTable, >= 2 N slots for the run's first N tokens)
// of 16-byte slots: a 64-bit key a << 32 | b (all ones when empty: ids are
// >= 0, so no pair has that key), a count and a first position (0xFFFFFFFF
// when empty); and a dense list of the claimed slots with its length
// `used`. Ids are not packed into fewer bits: a vocab of any size fits. A
// round's keys hash into the first 1 << hl slots, hl the least power of
// two >= 2 n (n the live length, read on the device; at least 128 slots),
// so a stream that has shrunk probes a table that shrank with it; distinct
// pairs never exceed n - 1, so that part is at most half full and a probe
// ends.
//
// Three phases, separated by grid.sync(), over a grid of the blocks that
// fit at once (fixed per device, so the trainer makes the scratch once):
//   1. count. Each block counts one contiguous range of TILE-position chunks
//      into a table of PS_SLOTS slots in shared memory, with 32-bit keys a <<
//      16 | b for ids below NARROW (a pair with a larger id goes to the device
//      table at once); __match_any groups equal pairs of a warp first, and the
//      group's leader adds its size and its smallest position. The block lists
//      the slots it claimed, so that a flush and the clear after it cost the
//      claimed slots, not the table. A flush inserts each claimed slot into
//      the device table: a lane reads the slot's key, one 128-bit CAS from
//      empty claims an empty slot with its count and first position, a lane
//      that meets its own key adds them with reductions (an atomicAdd and an
//      atomicMin that return nothing), and one that meets another key probes
//      on without an atomic. The lanes of a warp that claimed device slots
//      take their list entries with one atomicAdd on `used` (a ballot, then
//      each lane's rank). A block whose first chunk claimed shared slots for
//      most of its pairs (no repeats to absorb) sends the rest of its range
//      straight to the device table; a pair that finds no room within
//      HIST_PROBES shared slots goes there too. Counts add and first is a min,
//      so the result is exact either way.
//   2. Every block reads its share of the listed slots (or of the hashed
//      slots in order, where that is cheaper: scan_in_order), keeps the
//      largest key count << 32 | (0xFFFFFFFF - first) (K5's key: the
//      largest count, then the earliest first occurrence; first positions
//      are unique per pair, so the result does not depend on the order of
//      the atomics), empties each slot it read, and writes its best to
//      scratch.
//   3. Block 0 folds the bests and writes the round's record: sel = (pa,
//      pb, count, ok), ok when a pair was found and the gate fail >= i
//      holds, else (-1, -1, 0, 0), which K3 merges nowhere; log row i
//      (pairs[i], counts[i]; zeros when not ok); fail = i when no pair was
//      found; and used = 0. The table is empty again.
// The gate fail < i is read by every block before the first grid.sync and
// written only after the last, so the return it causes is uniform; block
// 0 still writes the gated round's record (a round that skipped it would
// leave K3 the previous round's pair).
//
// Bound: bytes, 8 N + 40 for N tokens: ids and seg read once (8 B a
// token), n and fail read, and the record written. The device table is
// scratch, empty before and after the launch, so its traffic (about 56 B
// a distinct pair: slot and list entry written, read, and the slot
// emptied) is the design's, not the function's; on text the shared table
// absorbs repeats, and the device table is small enough for L2.
// ---------------------------------------------------------------------------
constexpr unsigned long long EMPTY_PAIR = ~0ull;
constexpr int PS_LOG2 = 12;  // a block's shared table: 4,096 slots
constexpr int PS_SLOTS = 1 << PS_LOG2;
// shared bytes: a key (4), count (4), first (4) and list entry (2) a slot
constexpr size_t PS_SMEM = (size_t)14 << PS_LOG2;
// the block's table takes pairs of ids below NARROW as 32-bit keys; a pair
// with a larger id goes straight to the device table
constexpr unsigned NARROW = 0xFFFFu;
constexpr int PS_HASH_LOG2_MIN = 7;

// A slot of the device table: the key, then the count and the first
// position, in one 16-byte word (the count's and first's half is EMPTY_HI
// when empty), so one 128-bit CAS claims a slot with its first count and
// position, and a slot is one 32-byte sector.
struct alignas(16) Slot {
  unsigned long long key;
  unsigned cnt, first;
};
constexpr unsigned long long EMPTY_HI = 0xFFFFFFFF00000000ull;

struct DeviceTable {
  Slot* slots;
  int* list;
  int* used;
  int log2;  // capacity: 1 << log2 slots
};

// The 16 bytes at a, (lo, hi) = the key and (first << 32 | count), set to
// (vlo, vhi) when they equal (clo, chi); returns what they held.
__device__ __forceinline__ ulonglong2 cas128(Slot* a, unsigned long long clo,
                                             unsigned long long chi,
                                             unsigned long long vlo,
                                             unsigned long long vhi) {
  ulonglong2 old;
  asm volatile(
      "{\n\t.reg .b128 c, v, d;\n\t"
      "mov.b128 c, {%2, %3};\n\t"
      "mov.b128 v, {%4, %5};\n\t"
      "atom.global.cas.b128 d, [%6], c, v;\n\t"
      "mov.b128 {%0, %1}, d;\n\t}"
      : "=l"(old.x), "=l"(old.y)
      : "l"(clo), "l"(chi), "l"(vlo), "l"(vhi), "l"(a)
      : "memory");
  return old;
}

// The pair of each lane that has one (c occurrences of key k, the first at
// p) into the device table, hashed over 1 << hl slots; a lane that claims a
// slot appends it to the list, and the warp's claims take one atomicAdd on
// used. Every lane of the warp calls it.
__device__ __forceinline__ void table_insert(const DeviceTable& t, int hl,
                                             bool has, unsigned long long k,
                                             unsigned c, unsigned p) {
  int claimed = -1;
  if (has) {
    const unsigned mask = (1u << hl) - 1;
    const unsigned long long mine = (unsigned long long)p << 32 | c;
    unsigned s = slot_hash(k, hl);
    for (unsigned probe = 0; probe <= mask; ++probe, s = (s + 1) & mask) {
      // a slot's key changes once a round, from empty to its owner: a read
      // answers for a held slot (half the hashed slots may be), and one
      // atomic claims an empty one with this count and position
      ulonglong2 held = make_ulonglong2(
          reinterpret_cast<volatile unsigned long long*>(&t.slots[s].key)[0],
          0ull);
      if (held.x == EMPTY_PAIR)
        held = cas128(t.slots + s, EMPTY_PAIR, EMPTY_HI, k, mine);
      if (held.x == EMPTY_PAIR && held.y == EMPTY_HI) {
        claimed = (int)s;
        break;
      }
      if (held.x == k) {
        atomicAdd(&t.slots[s].cnt, c);
        atomicMin(&t.slots[s].first, p);
        break;
      }
    }
  }
  const unsigned won = __ballot_sync(FULL, claimed >= 0);
  if (won == 0) return;
  const int lane = threadIdx.x & 31;
  const int head = __ffs(won) - 1;
  int base = 0;
  if (lane == head) base = atomicAdd(t.used, __popc(won));
  base = __shfl_sync(FULL, base, head);
  if (claimed >= 0) t.list[base + __popc(won & ((1u << lane) - 1))] = claimed;
}

// A block's table in dynamic shared memory: PS_SLOTS 32-bit keys a << 16 |
// b (both ids below NARROW; all ones when empty), counts, first positions,
// and the list of the slots claimed since the last flush.
struct BlockPairs {
  unsigned* key;
  unsigned* cnt;
  unsigned* first;
  unsigned short* list;

  // c occurrences of k, the first at p: the slot it claimed, -1 when k held
  // one already, -2 when neither k nor an empty slot lies within
  // HIST_PROBES slots of its hash
  __device__ __forceinline__ int add(unsigned k, unsigned c, unsigned p) {
    unsigned s = slot_hash(k, PS_LOG2);
    for (int probe = 0; probe < HIST_PROBES;
         ++probe, s = (s + 1) & (PS_SLOTS - 1)) {
      // a slot's key changes once between flushes, from empty to its owner
      unsigned held = reinterpret_cast<volatile unsigned*>(key)[s];
      int got = -1;
      if (held == EMPTY_KEY) {
        held = atomicCAS(key + s, EMPTY_KEY, k);
        if (held == EMPTY_KEY) {
          held = k;
          got = (int)s;
        }
      }
      if (held == k) {
        atomicAdd(cnt + s, c);
        atomicMin(first + s, p);
        return got;
      }
    }
    return -2;
  }

  // the u listed slots into the device table, each emptied; block-wide
  __device__ void flush(const DeviceTable& t, int hl, int u) {
    for (int e0 = 0; e0 < u; e0 += TPB) {
      const int e = e0 + threadIdx.x;
      unsigned k = EMPTY_KEY, c = 0, f = 0;
      if (e < u) {
        const int s = list[e];
        k = key[s];
        c = cnt[s];
        f = first[s];
        key[s] = EMPTY_KEY;
        cnt[s] = 0u;
        first[s] = EMPTY_KEY;
      }
      table_insert(t, hl, e < u,
                   (unsigned long long)(k >> 16) << 32 | (k & 0xFFFFu), c, f);
    }
  }
};

// Phase 2 walks the 1 << hl hashed slots in order (two a thread, 32 B)
// rather than the `used` listed ones at random when more than a 64th of
// them are claimed and they fit L2 (hl <= 21: 32 MB), or when more than an
// eighth are: measured on the H100 (scripts/time_pair_select.py), a listed
// slot costs a dependent pair of L2 round trips, so the list loses from a
// few thousand slots on where the walk stays in L2.
__device__ __forceinline__ bool scan_in_order(int used, int hl) {
  const long long slots = 1ll << hl;
  return 64ll * used > slots && (hl <= 21 || 8ll * used > slots);
}

// Block-wide: the largest (k, v) by k of every thread's pair into thread
// 0's (other threads' are meaningless); ends synchronised.
__device__ void block_max_pair(unsigned long long& k, unsigned long long& v) {
  __shared__ unsigned long long sk[TPB / 32], sv[TPB / 32];
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long ok = __shfl_down_sync(FULL, k, d);
    const unsigned long long ov = __shfl_down_sync(FULL, v, d);
    if (ok > k) k = ok, v = ov;
  }
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  if (lane == 0) sk[wid] = k, sv[wid] = v;
  __syncthreads();
  if (threadIdx.x == 0)
    for (int w = 1; w < TPB / 32; ++w)
      if (sk[w] > k) {
        k = sk[w];
        v = sv[w];
      }
  __syncthreads();
}

// Phase 1 for one block: the countable pairs of its range of chunks.
__device__ void count_into_table(const int* __restrict__ ids,
                                 const int* __restrict__ seg, int n,
                                 const DeviceTable& t, int hl) {
  extern __shared__ uint4 ps_smem[];
  __shared__ int claimed;  // shared slots claimed since the last flush
  const int chunks = n >= 2 ? (n - 2) / TILE + 1 : 0;
  const int lo = (int)((long long)blockIdx.x * chunks / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * chunks / gridDim.x);
  if (lo >= hi) return;  // block-uniform; the caller syncs the grid after
  unsigned* const smem = reinterpret_cast<unsigned*>(ps_smem);
  BlockPairs tab{smem, smem + PS_SLOTS, smem + 2 * PS_SLOTS,
                 reinterpret_cast<unsigned short*>(smem + 3 * PS_SLOTS)};
  {
    const uint4 none = make_uint4(EMPTY_KEY, EMPTY_KEY, EMPTY_KEY, EMPTY_KEY);
    for (int q = threadIdx.x; q < PS_SLOTS / 4; q += TPB) {
      reinterpret_cast<uint4*>(tab.key)[q] = none;
      reinterpret_cast<uint4*>(tab.cnt)[q] = make_uint4(0, 0, 0, 0);
      reinterpret_cast<uint4*>(tab.first)[q] = none;
    }
  }
  if (threadIdx.x == 0) claimed = 0;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const bool vec = aligned16(ids, seg);
  bool direct = false;  // block-uniform
  // the loop bound depends on the block only, so whole warps iterate
  // together and every warp-wide call sees every lane
  for (int c = lo; c < hi; ++c) {
    const int p0 = c * TILE + threadIdx.x * IPT;
    int id[IPT + 1], sg[IPT + 1];
    load_pairs(ids, seg, p0, n, vec, id, sg);
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int a = id[k], b = id[k + 1];
      const bool ok = p0 + k + 1 < n && sg[k] == sg[k + 1] && a >= 0 &&
                      b >= 0;
      const bool narrow = (unsigned)a < NARROW && (unsigned)b < NARROW;
      const unsigned long long key =
          ok ? (unsigned long long)(unsigned)a << 32 | (unsigned)b
             : EMPTY_PAIR;
      const unsigned key32 = ok ? (unsigned)a << 16 | (unsigned)b : EMPTY_KEY;
      // equal pairs of the warp: on the 32-bit keys unless a lane has a
      // wide pair
      const unsigned group = __any_sync(FULL, ok && !narrow)
                                 ? __match_any_sync(FULL, key)
                                 : __match_any_sync(FULL, key32);
      const bool lead = ok && lane == __ffs(group) - 1;
      const unsigned m = __popc(group);
      const unsigned p = (unsigned)(p0 + k);
      if (direct) {
        table_insert(t, hl, lead, key, m, p);
        continue;
      }
      const int got = lead && narrow ? tab.add(key32, m, p) : -1;
      const unsigned won = __ballot_sync(FULL, got >= 0);
      if (won) {
        const int head = __ffs(won) - 1;
        int base = 0;
        if (lane == head) base = atomicAdd(&claimed, __popc(won));
        base = __shfl_sync(FULL, base, head);
        if (got >= 0)
          tab.list[base + __popc(won & ((1u << lane) - 1))] =
              (unsigned short)got;
      }
      const bool spill = got == -2 || (lead && !narrow);
      if (__any_sync(FULL, spill)) table_insert(t, hl, spill, key, m, p);
    }
    if (direct) continue;
    __syncthreads();
    const int u = claimed;
    // the pairs this chunk holds (positions p with p + 1 < n)
    const int held = min(TILE, n - 1 - c * TILE);
    direct = c == lo && c + 1 < hi && 4 * u > 3 * held;
    const bool flush = direct || c + 1 == hi || u > PS_SLOTS / 2;
    __syncthreads();  // every thread has read claimed
    if (flush) {
      if (threadIdx.x == 0) claimed = 0;
      tab.flush(t, hl, u);
      __syncthreads();  // the slots are empty before the next chunk's adds
    }
  }
}

// scratch: uint64[2 * gridDim.x], each block's best key and its pair
__global__ void __launch_bounds__(TPB)
    pair_select_kernel(const int* __restrict__ ids,
                       const int* __restrict__ seg,
                       const int* __restrict__ n_ptr, int* fail, int i,
                       DeviceTable t, int* sel, int* pairs, int* counts,
                       unsigned long long* scratch) {
  cg::grid_group grid = cg::this_grid();
  const int f = *fail;
  if (f < i) {  // gated: every block returns here, block 0 writes (-1, -1)
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      sel[0] = sel[1] = -1;
      sel[2] = sel[3] = 0;
      pairs[2 * i] = pairs[2 * i + 1] = 0;
      counts[i] = 0;
    }
    return;
  }
  const int n = *n_ptr;
  const int hl =
      min(t.log2, max(PS_HASH_LOG2_MIN,
                      n > 1 ? 32 - __clz(2 * n - 1) : PS_HASH_LOG2_MIN));
  count_into_table(ids, seg, n, t, hl);
  grid.sync();

  const int used = __ldcg(t.used);
  unsigned long long best = 0, pair = 0;
  const int step = gridDim.x * TPB;
  // slot s (v: its key, then first << 32 | count) into the block's best;
  // the slot is emptied
  ulonglong2* const slot2 = reinterpret_cast<ulonglong2*>(t.slots);
  auto take = [&](int s, ulonglong2 v) {
    const unsigned long long k = sel_key((unsigned)v.y,
                                         (unsigned)(v.y >> 32));
    if (k > best) {
      best = k;
      pair = v.x;
    }
    slot2[s] = make_ulonglong2(EMPTY_PAIR, EMPTY_HI);
  };
  if (scan_in_order(used, hl)) {
    for (int s = 2 * (blockIdx.x * TPB + threadIdx.x); s < (1 << hl);
         s += 2 * step) {
      const ulonglong2 v0 = __ldcg(slot2 + s);
      const ulonglong2 v1 = __ldcg(slot2 + s + 1);
      if (v0.x != EMPTY_PAIR) take(s, v0);
      if (v1.x != EMPTY_PAIR) take(s + 1, v1);
    }
  } else {
    for (int e = blockIdx.x * TPB + threadIdx.x; e < used; e += step) {
      const int s = __ldcg(t.list + e);
      take(s, __ldcg(slot2 + s));
    }
  }
  block_max_pair(best, pair);
  if (threadIdx.x == 0) {
    scratch[2 * blockIdx.x] = best;
    scratch[2 * blockIdx.x + 1] = pair;
  }
  grid.sync();

  if (blockIdx.x != 0) return;
  best = pair = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += TPB) {
    const unsigned long long k = __ldcg(scratch + 2 * b);
    if (k > best) {
      best = k;
      pair = __ldcg(scratch + 2 * b + 1);
    }
  }
  block_max_pair(best, pair);
  if (threadIdx.x != 0) return;
  const bool ok = best != 0;
  const int pa = ok ? (int)(pair >> 32) : -1;
  const int pb = ok ? (int)(unsigned)pair : -1;
  const int c = ok ? (int)(best >> 32) : 0;
  sel[0] = pa;
  sel[1] = pb;
  sel[2] = c;
  sel[3] = ok;
  pairs[2 * i] = ok ? pa : 0;
  pairs[2 * i + 1] = ok ? pb : 0;
  counts[i] = c;
  if (!ok && i < f) *fail = i;
  *t.used = 0;
}

// ---------------------------------------------------------------------------
// K16 pair_summaries: the distributed trainer's sparse and owner selections
// (minbpe_tpu/parallel/train.py: _local_run_summaries :229-270, the merge
// of _sparse_global_select :272-301 and the owner's merge in
// _owner_global_select :355-374; jitted XLA sorts and run scans, no Pallas
// site), on K13's device table. One cooperative launch in either mode, over
// K13's grid; the table is empty before and after it.
//   count (mode 0): one rank's extended stream (its tokens, then the halo
//     token of the next rank that has one) is counted into the table by
//     K13's phase 1 (count_into_table); after a grid barrier every block
//     takes its share of the listed slots: entry e < cap becomes summary
//     row e, (a, b, count, first + base), base the rank's rank * Nl, and the
//     slot is emptied. After a second barrier block 0 writes the rows
//     written, min(used, cap), sets *overflow to 1 where used > cap (JAX's
//     n_runs > K; it never clears it) and empties used. The rows' order is
//     the list's, which the result does not depend on.
//   merge (mode 1): nb blocks of bs summary rows, the first lens[j] of
//     block j valid (the D gathered summaries, or an owner's D received
//     buckets), each inserted like a flushed shared slot (counts add,
//     firsts take the minimum), then K13's phases 2 and 3: the champion,
//     the largest count and among equal counts the earliest first, into
//     champ = (a, b, count, first), or (-1, -1, 0, INT32_MAX) when the
//     blocks hold nothing.
// Bound: bytes. Count: 8 (n + 1) in, 16 a distinct pair out, 40 the
// scalars; merge: 16 a row in, 16 out. The table's traffic is the design's
// (as K13's).
// ---------------------------------------------------------------------------
struct SummaryArgs {
  const int* ids;  // count: the extended stream and its length
  const int* seg;
  const int* n;
  int base;
  int4* out;  // count: the summary rows
  int cap;
  int* used_out;
  int* overflow;
  const int4* rows;  // merge: the rows, lens, nb blocks of bs
  const int* lens;
  int nb;
  int bs;
  int* champ;
};

__device__ __forceinline__ int table_log2(const DeviceTable& t, int n) {
  return min(t.log2, max(PS_HASH_LOG2_MIN,
                         n > 1 ? 32 - __clz(2 * n - 1) : PS_HASH_LOG2_MIN));
}

__global__ void __launch_bounds__(TPB)
    pair_summaries_kernel(int mode, SummaryArgs a, DeviceTable t,
                          unsigned long long* scratch) {
  cg::grid_group grid = cg::this_grid();
  const int step = gridDim.x * TPB;
  const int gtid = blockIdx.x * TPB + threadIdx.x;
  int hl;
  if (mode == 0) {
    const int n = *a.n;
    hl = table_log2(t, n);
    count_into_table(a.ids, a.seg, n, t, hl);
  } else {
    const int T = a.nb * a.bs;
    hl = table_log2(t, T);
    const int lane = threadIdx.x & 31;
    // whole warps iterate together: table_insert is warp-wide
    for (int e0 = gtid - lane; e0 < T; e0 += step) {
      const int e = e0 + lane;
      int4 r = make_int4(0, 0, 0, 0);
      bool has = false;
      if (e < T) {
        const int j = e / a.bs;
        has = e - j * a.bs < __ldg(a.lens + j);
        if (has) r = __ldg(a.rows + e);
      }
      table_insert(t, hl, has,
                   (unsigned long long)(unsigned)r.x << 32 | (unsigned)r.y,
                   (unsigned)r.z, (unsigned)r.w);
    }
  }
  grid.sync();

  const int used = __ldcg(t.used);
  ulonglong2* const slot2 = reinterpret_cast<ulonglong2*>(t.slots);
  const ulonglong2 empty = make_ulonglong2(EMPTY_PAIR, EMPTY_HI);
  if (mode == 0) {
    for (int e = gtid; e < used; e += step) {
      const int s = __ldcg(t.list + e);
      const ulonglong2 v = __ldcg(slot2 + s);
      if (e < a.cap)
        a.out[e] = make_int4((int)(v.x >> 32), (int)(unsigned)v.x,
                             (int)(unsigned)v.y,
                             (int)(unsigned)(v.y >> 32) + a.base);
      slot2[s] = empty;
    }
    grid.sync();  // every block has read used
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      *a.used_out = min(used, a.cap);
      if (used > a.cap) *a.overflow = 1;
      *t.used = 0;
    }
    return;
  }

  unsigned long long best = 0, pair = 0;
  auto take = [&](int s, ulonglong2 v) {
    const unsigned long long k = sel_key((unsigned)v.y,
                                         (unsigned)(v.y >> 32));
    if (k > best) {
      best = k;
      pair = v.x;
    }
    slot2[s] = empty;
  };
  if (scan_in_order(used, hl)) {
    for (int s = 2 * gtid; s < (1 << hl); s += 2 * step) {
      const ulonglong2 v0 = __ldcg(slot2 + s);
      const ulonglong2 v1 = __ldcg(slot2 + s + 1);
      if (v0.x != EMPTY_PAIR) take(s, v0);
      if (v1.x != EMPTY_PAIR) take(s + 1, v1);
    }
  } else {
    for (int e = gtid; e < used; e += step) {
      const int s = __ldcg(t.list + e);
      take(s, __ldcg(slot2 + s));
    }
  }
  block_max_pair(best, pair);
  if (threadIdx.x == 0) {
    scratch[2 * blockIdx.x] = best;
    scratch[2 * blockIdx.x + 1] = pair;
  }
  grid.sync();

  if (blockIdx.x != 0) return;
  best = pair = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += TPB) {
    const unsigned long long k = __ldcg(scratch + 2 * b);
    if (k > best) {
      best = k;
      pair = __ldcg(scratch + 2 * b + 1);
    }
  }
  block_max_pair(best, pair);
  if (threadIdx.x != 0) return;
  const bool ok = best != 0;
  a.champ[0] = ok ? (int)(pair >> 32) : -1;
  a.champ[1] = ok ? (int)(unsigned)pair : -1;
  a.champ[2] = ok ? (int)(best >> 32) : 0;
  a.champ[3] = ok ? (int)(0xFFFFFFFFu - (unsigned)best) : 0x7FFFFFFF;
  *t.used = 0;
}

// ---------------------------------------------------------------------------
// The batch (bsel >= 2): K6 batch_hist, then K8 batch_apply.
//
// The accepted candidates are heterogeneous and share no cross-side token,
// so their match sites never overlap and every match is a kept site. The
// trim keeps candidate k only while its count strictly beats every pair
// that merges 0 .. k-1 can create, and those creation counts are bounded
// before anything is applied, by two histograms of 128 partner buckets
// (id & 127) per creator j: acc_l over each site's previous token (pairs
// (v, z_j)) and acc_r over its second-next token (pairs (z_j, w); the next
// token is the site's own consumed one). A partner that lies inside another
// candidate's site is counted under both hypotheses, its id after the batch
// (F) and its id before, so the bound holds for every trimmed prefix; a
// position whose two hypotheses fall in one bucket counts once (the OR of
// _oh128_or, fused_train.py:416-423).
//
// The stream is dense, so the Pallas passes' select-scans for the previous
// and second-next live tokens, and their tile and segment carries, become
// p - 1 and p + 2. With c(q) the candidate matching at q (-1 unless q + 1 <
// n and seg[q] == seg[q + 1]) and F(q) = zbase + c(q), else zbase +
// c(q - 1), else ids[q], a site p of candidate j adds (F(p - 1), ids[p - 1])
// to acc_l's column j where seg[p - 1] == seg[p], and (F(p + 2), ids[p + 2])
// to acc_r's where p + 2 < n and seg[p + 2] == seg[p].
//
// K6 batch_hist computes cand[p] = c(p) for every p < n and both histograms
// in one pass (B7 _mark_kernel and B8 _histrev_kernel, fused_train_xl.py:328
// and :392; B1's tiled_batch_mark and tiled_batch_hist_rev,
// fused_train.py:452-593). F never leaves registers.
// Bound: bytes, 8 B read (ids, seg) and 4 B written (cand) per token, plus
// the two 8 KB histograms. So:
//   - a persistent grid (the blocks that fit at once, capped at the
//     stream's tiles at capacity) walks the live tiles of TILE positions;
//     a block whose first tile lies past n returns before it touches
//     shared memory, so slots late in a run pay for n, not for capacity;
//   - a thread takes IPT consecutive ids and seg with 16-byte loads and
//     the 2-before / 3-after halo from its neighbour lanes (lanes 0 and 31
//     from memory), so each token is read from device memory about once,
//     and writes its cand with 16-byte stores;
//   - the candidate at q is one lookup, not a loop over 16 pairs: mask[x]
//     has bit j where candidate j's left id is x (mod 1024) and bit 16 + j
//     where its right id is, so mask[a] & mask[b] >> 16 names the one
//     candidate (a, b) when every id is below 1024 (TRAIN_MAX_V), and the
//     few it names are checked against the pairs otherwise;
//   - each block counts into both histograms in shared memory (shared
//     atomics) and adds its non-zero bins into acc once, after its last
//     tile, one global atomic each.
// Bound of K8: it reads ids and cand and writes ids and live (13 B).
// ---------------------------------------------------------------------------
constexpr int MASK_IDS = 1024;  // entries of K6's match table: id & 1023

// the candidate matching the pair (a, b): mask as above, pairs the
// candidates' (pa, pb); exact when every candidate's ids are below MASK_IDS
__device__ __forceinline__ int match_pair(const unsigned* mask,
                                          const int* pairs, bool exact,
                                          int a, int b) {
  unsigned m =
      mask[a & (MASK_IDS - 1)] & (mask[b & (MASK_IDS - 1)] >> K_CAP);
  if (m == 0) return -1;
  if (exact && (unsigned)(a | b) < (unsigned)MASK_IDS) return __ffs(m) - 1;
  for (; m; m &= m - 1) {
    const int j = __ffs(m) - 1;
    if (pairs[2 * j] == a && pairs[2 * j + 1] == b) return j;
  }
  return -1;
}

__device__ __forceinline__ void hist_add(int* h, int v, int vid, int zbase,
                                         int j) {
  const int r1 = v & (HB - 1);
  atomicAdd(&h[r1 * K_CAP + j], 1);
  if (v >= zbase) {  // the partner lies in a site: its id before, too
    const int r2 = vid & (HB - 1);
    if (r2 != r1) atomicAdd(&h[r2 * K_CAP + j], 1);
  }
}

// acc: acc_l then acc_r, [bucket][candidate] each
__global__ void __launch_bounds__(TPB)
    batch_hist_kernel(const int* __restrict__ ids,
                      const int* __restrict__ seg,
                      const int* __restrict__ n_ptr,
                      const int* __restrict__ slot, int* __restrict__ cand,
                      int* acc) {
  __shared__ __align__(16) unsigned mask[MASK_IDS];
  __shared__ __align__(16) int h[2 * HIST];
  __shared__ int pairs[2 * K_CAP];
  // the slot's words and n, all read at once
  const int bsel = slot[SLOT_BSEL];
  const int zbase = slot[SLOT_ZBASE];
  const int pw = threadIdx.x < 2 * K_CAP ? slot[SLOT_PAIRS + threadIdx.x] : 0;
  const int n = *n_ptr;
  if (bsel < 2 || bsel > K_CAP || (int)blockIdx.x * TILE >= n) return;

  const int lane = threadIdx.x & 31;
  const bool vec = aligned16(ids, seg) && aligned16(cand, cand);
  // id[t], sg[t]: ids and seg at p0 - 2 + t, t < IPT + 5 (0 outside the
  // stream); t = 2 .. IPT + 1 are the thread's own positions
  int id[IPT + 5], sg[IPT + 5];
  auto load = [&](int base) {
    const int p0 = base + threadIdx.x * IPT;
    if (vec && p0 + IPT <= n) {
#pragma unroll
      for (int v = 0; v < IPT / 4; ++v) {
        unpack4(ld4<false>(ids + p0 + 4 * v), id + 2 + 4 * v);
        unpack4(ld4<false>(seg + p0 + 4 * v), sg + 2 + 4 * v);
      }
    } else {
#pragma unroll
      for (int k = 0; k < IPT; ++k) {
        id[2 + k] = p0 + k < n ? __ldg(ids + p0 + k) : 0;
        sg[2 + k] = p0 + k < n ? __ldg(seg + p0 + k) : 0;
      }
    }
    if (lane == 0) {
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int q = p0 - 2 + t;
        id[t] = q >= 0 && q < n ? __ldg(ids + q) : 0;
        sg[t] = q >= 0 && q < n ? __ldg(seg + q) : 0;
      }
    }
    if (lane == 31) {
#pragma unroll
      for (int t = IPT + 2; t < IPT + 5; ++t) {
        const int q = p0 - 2 + t;
        id[t] = q < n ? __ldg(ids + q) : 0;
        sg[t] = q < n ? __ldg(seg + q) : 0;
      }
    }
  };
  int base = (int)blockIdx.x * TILE;
  load(base);  // in flight while the tables are built

  for (int t = threadIdx.x; t < MASK_IDS / 4; t += TPB)
    reinterpret_cast<uint4*>(mask)[t] = make_uint4(0, 0, 0, 0);
  for (int t = threadIdx.x; t < 2 * HIST / 4; t += TPB)
    reinterpret_cast<int4*>(h)[t] = make_int4(0, 0, 0, 0);
  if (threadIdx.x < 2 * K_CAP) pairs[threadIdx.x] = pw;
  __syncthreads();
  bool mine_exact = true;
  if (threadIdx.x < bsel) {
    const int pa = pairs[2 * threadIdx.x], pb = pairs[2 * threadIdx.x + 1];
    atomicOr(&mask[pa & (MASK_IDS - 1)], 1u << threadIdx.x);
    atomicOr(&mask[pb & (MASK_IDS - 1)], 1u << (K_CAP + threadIdx.x));
    mine_exact = (unsigned)(pa | pb) < (unsigned)MASK_IDS;
  }
  const bool exact = __syncthreads_and(mine_exact);

  while (true) {
    const int p0 = base + threadIdx.x * IPT;
    // the halo from the neighbour lanes (lanes 0 and 31 loaded theirs)
    {
      const int i0 = __shfl_up_sync(FULL, id[IPT], 1);
      const int i1 = __shfl_up_sync(FULL, id[IPT + 1], 1);
      const int s0 = __shfl_up_sync(FULL, sg[IPT], 1);
      const int s1 = __shfl_up_sync(FULL, sg[IPT + 1], 1);
      if (lane != 0) {
        id[0] = i0;
        id[1] = i1;
        sg[0] = s0;
        sg[1] = s1;
      }
#pragma unroll
      for (int t = 0; t < 3; ++t) {
        const int i = __shfl_down_sync(FULL, id[2 + t], 1);
        const int s = __shfl_down_sync(FULL, sg[2 + t], 1);
        if (lane != 31) {
          id[IPT + 2 + t] = i;
          sg[IPT + 2 + t] = s;
        }
      }
    }
    // c(q) and F(q) at q = p0 - 2 + t (F from t = 1 on)
    int c[IPT + 4], F[IPT + 4];
#pragma unroll
    for (int t = 0; t < IPT + 4; ++t) {
      const int q = p0 - 2 + t;
      c[t] = q >= 0 && q + 1 < n && sg[t] == sg[t + 1]
                 ? match_pair(mask, pairs, exact, id[t], id[t + 1])
                 : -1;
    }
#pragma unroll
    for (int t = 1; t < IPT + 4; ++t)
      F[t] = c[t] >= 0 ? zbase + c[t]
                       : (c[t - 1] >= 0 ? zbase + c[t - 1] : id[t]);
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const int t = k + 2;
      const int j = c[t];
      if (j < 0) continue;
      if (p0 + k >= 1 && sg[t - 1] == sg[t])
        hist_add(h, F[t - 1], id[t - 1], zbase, j);
      if (p0 + k + 2 < n && sg[t + 2] == sg[t])
        hist_add(h + HIST, F[t + 2], id[t + 2], zbase, j);
    }
    if (vec && p0 + IPT <= n) {
#pragma unroll
      for (int v = 0; v < IPT / 4; ++v)
        reinterpret_cast<int4*>(cand + p0)[v] =
            make_int4(c[2 + 4 * v], c[3 + 4 * v], c[4 + 4 * v], c[5 + 4 * v]);
    } else {
#pragma unroll
      for (int k = 0; k < IPT; ++k)
        if (p0 + k < n) cand[p0 + k] = c[2 + k];
    }
    base += (int)gridDim.x * TILE;
    if (base >= n) break;
    load(base);
  }

  __syncthreads();
  for (int t = threadIdx.x; t < 2 * HIST / 4; t += TPB) {
    const int4 v = reinterpret_cast<const int4*>(h)[t];
    if (v.x) atomicAdd(acc + 4 * t, v.x);
    if (v.y) atomicAdd(acc + 4 * t + 1, v.y);
    if (v.z) atomicAdd(acc + 4 * t + 2, v.z);
    if (v.w) atomicAdd(acc + 4 * t + 3, v.w);
  }
}

// K8: the trim, then the combined apply, in one launch.
//
// The trim: cm[j] = the max over buckets of column j of acc_l and acc_r;
// bstar = the longest prefix whose every later count strictly beats the
// running max of cm[0 .. k-1], at most M - i. Every block computes it from
// the 16 KB histogram itself (four 16-byte loads a thread, a column max by
// shuffles, the prefix rule as a max-scan over 16 lanes and a ballot), so
// no block waits for another; its first tile's loads are in flight
// meanwhile.
//
// The apply: every site whose candidate is below bstar becomes
// zbase + cand, and its next token dies. A thread takes IPT consecutive
// positions with 16-byte loads of cand and ids, takes cand[p - 1] from the
// lane before (lane 0 from memory), and stores its 8 live flags as one
// 8-byte word. A thread counts its kept sites in 4-bit fields, one per
// candidate; the warp sums each field with one reduction, and each block
// adds its counts to scratch[1 + j] with one global atomic a candidate.
//
// The last block to finish (a done counter in scratch[0]) writes log rows
// i .. i + bstar - 1 with their kept counts, slot[SLOT_BSTAR] and
// ctl[CTL_I] = i + bstar, clears both histograms for the next slot (every
// other block has read them by then), and leaves the scratch zero again.
__global__ void __launch_bounds__(TPB)
    batch_apply_kernel(const int* __restrict__ ids,
                       const int* __restrict__ n_ptr,
                       const int* __restrict__ cand, int* slot, int* acc,
                       int* ctl, int* log, int M, int* __restrict__ ids_out,
                       unsigned char* __restrict__ live, int* scratch) {
  __shared__ int wmax[TPB / 32][K_CAP];
  __shared__ int kept[K_CAP];
  __shared__ int s_bstar;
  __shared__ bool last;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  // the slot's words, all read at once: candidate j's pair and count in
  // lane j of every warp
  const int bsel = slot[SLOT_BSEL];
  const int i = slot[SLOT_I];
  const int zbase = slot[SLOT_ZBASE];
  const int pa = lane < K_CAP ? slot[SLOT_PAIRS + 2 * lane] : 0;
  const int pb = lane < K_CAP ? slot[SLOT_PAIRS + 2 * lane + 1] : 0;
  const int cj = lane < K_CAP ? slot[SLOT_COUNT + lane] : 0;
  if (bsel < 2 || bsel > K_CAP) return;  // the gate: a batch

  const int n = *n_ptr;
  const bool vec = aligned16(ids, cand) && aligned16(ids_out, ids_out) &&
                   (reinterpret_cast<uintptr_t>(live) & 7) == 0;
  // positions p0 .. p0 + IPT - 1 of the tile at base, and cand[p0 - 1]
  // from the lane before (lane 0 from memory)
  int c[IPT], x[IPT], cb;
  auto load = [&](int base) {
    const int p0 = base + threadIdx.x * IPT;
    if (vec && p0 + IPT <= n) {
#pragma unroll
      for (int v = 0; v < IPT / 4; ++v) {
        unpack4(ld4<false>(cand + p0 + 4 * v), c + 4 * v);
        unpack4(ld4<false>(ids + p0 + 4 * v), x + 4 * v);
      }
    } else {
#pragma unroll
      for (int k = 0; k < IPT; ++k) {
        c[k] = p0 + k < n ? cand[p0 + k] : -1;
        x[k] = p0 + k < n ? ids[p0 + k] : 0;
      }
    }
    cb = lane == 0 && p0 > 0 && p0 <= n ? cand[p0 - 1] : -1;
  };
  int base = blockIdx.x * TILE;
  load(base);  // in flight while the trim reads the histograms

  // column maxima: thread t's quads t, t + TPB, ... all hold the columns
  // 4 (t % 4) .. 4 (t % 4) + 3
  int m[4] = {0, 0, 0, 0};
  for (int q = threadIdx.x; q < 2 * HIST / 4; q += TPB) {
    const int4 v = __ldcg(reinterpret_cast<const int4*>(acc) + q);
    m[0] = max(m[0], v.x);
    m[1] = max(m[1], v.y);
    m[2] = max(m[2], v.z);
    m[3] = max(m[3], v.w);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k)
#pragma unroll
    for (int d = 4; d < 32; d <<= 1)
      m[k] = max(m[k], __shfl_xor_sync(FULL, m[k], d));
  if (lane < 4)
#pragma unroll
    for (int k = 0; k < 4; ++k) wmax[wid][4 * lane + k] = m[k];
  if (threadIdx.x < K_CAP) kept[threadIdx.x] = 0;
  __syncthreads();
  if (wid == 0) {
    // candidate k joins while its count beats max(cm[0 .. k-1]) (every
    // earlier one joined): lane k's exclusive prefix max, then a ballot
    int cm = 0;
    if (lane < K_CAP)
      for (int w = 0; w < TPB / 32; ++w) cm = max(cm, wmax[w][lane]);
    int pre = cm;
#pragma unroll
    for (int d = 1; d < K_CAP; d <<= 1) {
      const int y = __shfl_up_sync(FULL, pre, d);
      if (lane >= d) pre = max(pre, y);
    }
    const int bnd = __shfl_up_sync(FULL, pre, 1);
    const bool joins = lane == 0 || (lane < bsel && cj > bnd);
    const int bstar = __ffs(~__ballot_sync(FULL, joins)) - 1;
    if (lane == 0) s_bstar = min(bstar, M - i);
  }
  __syncthreads();
  const int bstar = s_bstar;

  int wk[K_CAP];  // this warp's kept sites per candidate (every lane)
#pragma unroll
  for (int j = 0; j < K_CAP; ++j) wk[j] = 0;
  for (; base < n; base += gridDim.x * TILE) {
    const int p0 = base + threadIdx.x * IPT;
    if (base != blockIdx.x * TILE) load(base);
    const int cl = __shfl_up_sync(FULL, c[IPT - 1], 1);
    if (lane != 0) cb = cl;
    unsigned kp = 0;
    unsigned long long h = 0;  // 4 bits a candidate: its kept sites here
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      if (c[k] >= 0 && c[k] < bstar) {
        kp |= 1u << k;
        h += 1ull << (4 * c[k]);
      }
    }
    const unsigned dead = ((kp << 1) | (cb >= 0 && cb < bstar)) & 0xFFu;
    int y[IPT];
    unsigned long long lv = 0;
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      y[k] = (kp >> k) & 1u ? zbase + c[k] : x[k];
      lv |= (unsigned long long)(((dead >> k) & 1u) ^ 1u) << (8 * k);
    }
    if (vec && p0 + IPT <= n) {
#pragma unroll
      for (int v = 0; v < IPT / 4; ++v)
        reinterpret_cast<int4*>(ids_out + p0)[v] =
            make_int4(y[4 * v], y[4 * v + 1], y[4 * v + 2], y[4 * v + 3]);
      *reinterpret_cast<unsigned long long*>(live + p0) = lv;
    } else {
#pragma unroll
      for (int k = 0; k < IPT; ++k) {
        if (p0 + k < n) {
          ids_out[p0 + k] = y[k];
          live[p0 + k] = (unsigned char)((lv >> (8 * k)) & 1u);
        }
      }
    }
    if (__any_sync(FULL, h != 0)) {
#pragma unroll
      for (int j = 0; j < K_CAP; ++j)
        if (j < bstar)
          wk[j] += (int)__reduce_add_sync(
              FULL, (unsigned)(h >> (4 * j)) & 15u);
    }
  }
  if (lane == 0)
#pragma unroll
    for (int j = 0; j < K_CAP; ++j)
      if (wk[j]) atomicAdd(&kept[j], wk[j]);
  __syncthreads();
  if (threadIdx.x < K_CAP && kept[threadIdx.x])
    atomicAdd(&scratch[1 + threadIdx.x], kept[threadIdx.x]);
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u) ==
           gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // the last block: the log, the slot's bstar, i; clear acc and scratch
  for (int q = threadIdx.x; q < 2 * HIST / 4; q += TPB)
    reinterpret_cast<int4*>(acc)[q] = make_int4(0, 0, 0, 0);
  if (threadIdx.x < bstar) {
    const int j = threadIdx.x;
    int* row = log + 4 * (i + j);
    row[0] = pa;
    row[1] = pb;
    row[2] = cj;
    row[3] = __ldcg(scratch + 1 + j);
  }
  __syncthreads();  // every kept count is read before it is cleared
  if (threadIdx.x < K_CAP) scratch[1 + threadIdx.x] = 0;
  if (threadIdx.x == 0) {
    slot[SLOT_BSTAR] = bstar;
    ctl[CTL_I] = i + bstar;
    scratch[0] = 0;
  }
}

// ---------------------------------------------------------------------------
// The apply-and-compact pass: K3 merge_apply, K4 compact, K10 encode_sweep.
//
// One merge (pa, pb) -> z over the dense stream. m[i] = match at i. A match
// is kept when its distance from the start of its run of consecutive
// matches is even (a run only exists when pa == pb: a run of k equal tokens
// keeps the even offsets, as the reference's left-to-right walk does). The
// token after a kept match dies; the live tokens, moved to the front in
// order, are the stream after the merge.
//
// A block takes a tile of TILE positions. It stages the tile's ids and seg
// in shared memory with 16-byte loads, plus a halo of one position on each
// side, so each token is read from device memory once, and decides matches,
// run parity and the kept / dead flags from shared memory and registers.
// Two values chain the tiles:
//   (a) the latest run start before the tile, combined by max. Only a
//       homogeneous pair has runs, and only a tile that starts inside one
//       (a match at t0 - 1) needs it;
//   (b) the live tokens before the tile, combined by sum: the tile's output
//       offset. The last tile's inclusive sum is the new n.
// K3 (a only) and K4 (b only) chain them in one pass with a decoupled
// look-back (Merrill & Garland, 2016): tiles claim their index in launch
// order from a counter (tile_ticket), so every earlier tile is running or
// done and no wait can deadlock; each tile publishes its own aggregate at
// once and its inclusive prefix when it knows it, in a 64-bit status word
// per tile, and warp 0 combines the words back to the nearest prefix. A
// status word carries the generation of its launch, which the wrapper
// passes by value and increments per call, so no launch has to clear the
// words first. Two launches in flight at once must not share the counter
// and the words, so the wrapper keeps them per stream (launches on one
// stream run in order).
//
// K10 runs B2's whole rank sweep in one cooperative persistent launch: a
// grid sized by occupancy and capped at the stream's tiles loops over the
// ranks, each rank an apply-and-compact pass from one ping-pong buffer into
// the other. Each block owns a static range of tiles and the ranges chain
// by reduce-then-scan through a grid barrier: run starts (homogeneous pairs
// only), then live counts, then the scatter; a rank that merges nothing
// skips its scatter. A stream of one tile (a short document) runs in one
// block that keeps it in shared memory through all ranks.
//
// Bound: bytes. K3 reads 8 B and writes 5 B per token; K4 reads 9 B per
// token and writes 8 B per live token; K10 reads 8 B per token and writes
// 8 B per live token at every rank.
// ---------------------------------------------------------------------------
constexpr unsigned long long ST_A = 1;  // the tile's own aggregate
constexpr unsigned long long ST_P = 2;  // the prefix through the tile
constexpr unsigned GEN_MASK = (1u << 30) - 1;

struct Stage {
  int4 ids[TILE / 4];
  int4 seg[TILE / 4];
  int halo_id[2];  // positions t0 - 1 and t0 + TILE (-1 outside the stream)
  int halo_seg[2];
  unsigned char keep_last[TPB + 1];  // [0]: keep at t0 - 1; [k + 1]: at
                                     // thread k's last position
};

// One thread's IPT consecutive positions of a staged tile.
struct Lane {
  int id[IPT];
  unsigned m;  // bit k: a match at the thread's position k
  bool mb;     // a match at the position before its first
};

// The tile at t0 of ids[0 .. n), seg[0 .. n) into sh (positions from n on
// read as 0). CG: the stream was written by this launch (K10's ping-pong
// buffers), so it is read through L2 and not the read-only path.
template <bool CG>
__device__ void stage_tile(const int* ids, const int* seg, int t0, int n,
                           Stage& sh) {
  const bool vec = aligned16(ids, seg);
  __syncthreads();  // the previous tile's readers are done
  for (int q = threadIdx.x; q < TILE / 4; q += TPB) {
    const int p = t0 + 4 * q;
    int4 a = make_int4(0, 0, 0, 0), b = a;
    if (vec && p + 4 <= n) {
      a = ld4<CG>(ids + p);
      b = ld4<CG>(seg + p);
    } else if (p < n) {
      int x[4], y[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        x[k] = p + k < n ? ld1<CG>(ids + p + k) : 0;
        y[k] = p + k < n ? ld1<CG>(seg + p + k) : 0;
      }
      a = make_int4(x[0], x[1], x[2], x[3]);
      b = make_int4(y[0], y[1], y[2], y[3]);
    }
    sh.ids[q] = a;
    sh.seg[q] = b;
  }
  if (threadIdx.x < 2) {
    const int p = threadIdx.x == 0 ? t0 - 1 : t0 + TILE;
    const bool in = p >= 0 && p < n;
    sh.halo_id[threadIdx.x] = in ? ld1<CG>(ids + p) : -1;
    sh.halo_seg[threadIdx.x] = in ? ld1<CG>(seg + p) : -1;
  }
  __syncthreads();
}

__device__ __forceinline__ int staged_at(const int4* v, const int* halo,
                                         int l) {
  return l < 0 ? halo[0]
               : (l >= TILE ? halo[1] : reinterpret_cast<const int*>(v)[l]);
}

__device__ __forceinline__ Lane lane_matches(const Stage& sh, int t0, int n,
                                             int pa, int pb, int start = 0) {
  const int l0 = threadIdx.x * IPT;
  int id[IPT + 2], sg[IPT + 2];  // positions l0 - 1 .. l0 + IPT
#pragma unroll
  for (int v = 0; v < IPT / 4; ++v) {
    unpack4(sh.ids[l0 / 4 + v], id + 1 + 4 * v);
    unpack4(sh.seg[l0 / 4 + v], sg + 1 + 4 * v);
  }
  id[0] = staged_at(sh.ids, sh.halo_id, l0 - 1);
  sg[0] = staged_at(sh.seg, sh.halo_seg, l0 - 1);
  id[IPT + 1] = staged_at(sh.ids, sh.halo_id, l0 + IPT);
  sg[IPT + 1] = staged_at(sh.seg, sh.halo_seg, l0 + IPT);
  Lane x;
  x.m = 0;
  x.mb = false;
  const int p0 = t0 + l0 - 1;
#pragma unroll
  for (int k = 0; k <= IPT; ++k) {
    const int p = p0 + k;
    const bool mk = p >= start && p + 1 < n && id[k] == pa &&
                    id[k + 1] == pb && sg[k] == sg[k + 1];
    if (k == 0) x.mb = mk;
    else x.m |= (unsigned)mk << (k - 1);
  }
#pragma unroll
  for (int k = 0; k < IPT; ++k) x.id[k] = id[k + 1];
  return x;
}

// s[k]: the latest run start at or before the thread's position k, within
// the tile (-1: none); *tile_max: the tile's latest run start. Block-wide.
__device__ __forceinline__ void run_starts(const Lane& x, int t0,
                                           int (&s)[IPT], int* tile_max) {
  const int base = t0 + threadIdx.x * IPT;
  int run = -1;
  bool prev = x.mb;
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const bool mk = (x.m >> k) & 1u;
    if (mk && !prev) run = base + k;
    s[k] = run;
    prev = mk;
  }
  const int pre = block_exclusive_scan<false, TPB>(run, tile_max);
#pragma unroll
  for (int k = 0; k < IPT; ++k) s[k] = max(s[k], pre);
}

// Bit k: the match at the thread's position k is kept. carry: the latest
// run start before the tile.
__device__ __forceinline__ unsigned keep_mask(const Lane& x,
                                              const int (&s)[IPT], int t0,
                                              bool homog, int carry) {
  if (!homog) return x.m;
  const int base = t0 + threadIdx.x * IPT;
  unsigned kp = 0;
#pragma unroll
  for (int k = 0; k < IPT; ++k)
    if (((x.m >> k) & 1u) && ((base + k - max(carry, s[k])) & 1) == 0)
      kp |= 1u << k;
  return kp;
}

// Bit k: the token at the thread's position k dies (the one before it is a
// kept match). Block-wide.
__device__ __forceinline__ unsigned dead_mask(Stage& sh, const Lane& x,
                                              unsigned kp, int t0, bool homog,
                                              int carry) {
  if (threadIdx.x == 0)
    sh.keep_last[0] = x.mb && (!homog || ((t0 - 1 - carry) & 1) == 0);
  sh.keep_last[threadIdx.x + 1] = (kp >> (IPT - 1)) & 1u;
  __syncthreads();
  const unsigned before = sh.keep_last[threadIdx.x];
  __syncthreads();
  return ((kp << 1) | before) & ((1u << IPT) - 1);
}

// Bits of the thread's positions below n.
__device__ __forceinline__ unsigned valid_mask(int t0, int n) {
  const int v = min(max(n - (t0 + (int)threadIdx.x * IPT), 0), IPT);
  return (1u << v) - 1;
}

__device__ __forceinline__ int tile_ticket(unsigned* counter) {
  __shared__ int t;
  if (threadIdx.x == 0) {
    t = (int)atomicAdd(counter, 1u);
    // the last claim of this launch: every other one came before it
    if (t == (int)gridDim.x - 1) atomicExch(counter, 0u);
  }
  __syncthreads();
  return t;
}

__device__ __forceinline__ void st_publish(unsigned long long* st, int t,
                                           unsigned gen,
                                           unsigned long long flag, int v) {
  const unsigned long long tag = ((unsigned long long)(gen & GEN_MASK) << 2) |
                                 flag;
  atomicExch(st + t, (tag << 32) | (unsigned)v);
}

// Warp 0: the combination of tiles 0 .. t-1 (identity for t = 0), in every
// lane. Reads the words 32 at a time backwards, waiting for each to carry
// this launch's generation, and stops at the nearest inclusive prefix.
template <bool SUM>
__device__ int look_back(const unsigned long long* st, int t, unsigned gen) {
  const int lane = threadIdx.x & 31;
  const unsigned want = gen & GEN_MASK;
  int acc = identity<SUM>();
  for (int top = t - 1;; top -= 32) {
    const int j = top - lane;
    int v = identity<SUM>();
    bool p = true;  // before tile 0: the identity, final
    if (j >= 0) {
      unsigned long long w;
      while (true) {
        w = *reinterpret_cast<const volatile unsigned long long*>(st + j);
        const unsigned tag = (unsigned)(w >> 32);
        if ((tag >> 2) == want && (tag & 3u) != 0) break;
        __nanosleep(32);
      }
      v = (int)(unsigned)w;
      p = ((w >> 32) & 3u) == ST_P;
    }
    const unsigned ps = __ballot_sync(0xffffffffu, p);
    const int stop = ps ? __ffs(ps) - 1 : 32;
    if (lane > stop) v = identity<SUM>();
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      v = op<SUM>(v, __shfl_xor_sync(0xffffffffu, v, d));
    acc = op<SUM>(acc, v);
    if (ps) return acc;
  }
}

// K3: ids_out[i] = kept ? z : ids[i]; live[i] = !kept[i - 1];
// *kept += the kept matches. In slot mode (the trainer) the pair is the
// slot's candidate 0, z its 256 + i, the kept count goes to log row i, and
// it runs only for bsel == 1. A heterogeneous pair has no runs: its tiles
// need no chain, take their block's index, and touch neither the counter
// nor the status words.
//
// The carry-in (the distributed trainer, minbpe_tpu/parallel/train.py
// _extended_keep :192-226 and _apply_round :420-449): start = *carry_in
// (0 without it) drops the first `start` tokens, which the left rank's
// boundary merge took: no match starts before `start`, those tokens are
// dead, and the left-first parity starts at token `start`. With gate set,
// a launch whose start is 0 returns at once (it only redoes, at carry-in
// 1, what an earlier launch wrote at 0). tf (may be null) gets the
// transfer bits of the stream's last pair (n - 2, n - 1), the boundary
// pair of an extended stream: tf[0] = it is kept, tf[1] = it closes a run
// of matches that began at `start`; both 0 where it is not a pair.
__global__ void __launch_bounds__(TPB)
    merge_apply_kernel(const int* __restrict__ ids,
                       const int* __restrict__ seg,
                       const int* __restrict__ n_ptr,
                       const int* __restrict__ pair, int z, const int* slot,
                       int* __restrict__ ids_out,
                       unsigned char* __restrict__ live, int* kept,
                       const int* carry_in, int gate, int* tf,
                       unsigned long long* st, unsigned* counter,
                       unsigned gen) {
  if (gated_off(slot, 1, 1)) return;
  const int start = carry_in != nullptr ? *carry_in : 0;
  if (gate && start == 0) return;
  __shared__ Stage sh;
  __shared__ int bcast;
  const int n = *n_ptr;
  const int pa = pair[0], pb = pair[1];
  if (slot != nullptr) {
    z = slot[SLOT_ZBASE];
    kept += 4 * slot[SLOT_I] + 3;  // kept points at the merge log
  }
  const bool homog = pa == pb;
  const int t = homog ? tile_ticket(counter) : (int)blockIdx.x;
  const int t0 = t * TILE;
  if (tf != nullptr && t == 0 && threadIdx.x == 0 && n - 2 < start)
    tf[0] = tf[1] = 0;
  if (t0 >= n) return;
  stage_tile<false>(ids, seg, t0, n, sh);
  const Lane x = lane_matches(sh, t0, n, pa, pb, start);
  int s[IPT];
  int carry = -1;
#pragma unroll
  for (int k = 0; k < IPT; ++k) s[k] = -1;
  if (homog) {
    int tmax;
    run_starts(x, t0, s, &tmax);
    if (threadIdx.x == 0) {
      // a tile with a run start knows its inclusive max at once
      st_publish(st, t, gen, tmax >= 0 ? ST_P : ST_A, tmax);
      bcast = x.mb;  // the tile starts inside a run: it needs the carry
    }
    __syncthreads();
    const bool need = bcast;
    __syncthreads();
    if (need) {
      if (threadIdx.x < 32) {
        const int c = look_back<false>(st, t, gen);
        if (threadIdx.x == 0) {
          bcast = c;
          if (tmax < 0) st_publish(st, t, gen, ST_P, c);
        }
      }
      __syncthreads();
      carry = bcast;
    }
  }
  const unsigned kp = keep_mask(x, s, t0, homog, carry);
  const int base = t0 + threadIdx.x * IPT;
  // the tokens before start are dead
  const unsigned taken =
      start > base ? (1u << min(start - base, IPT)) - 1 : 0u;
  const unsigned lv = valid_mask(t0, n) & ~taken &
                      ~dead_mask(sh, x, kp, t0, homog, carry);
  const int q = n - 2;  // the last pair
  if (tf != nullptr && q >= start && q >= base && q < base + IPT) {
    const int k = q - base;
    const bool mk = (x.m >> k) & 1u;
    tf[0] = (kp >> k) & 1u;
    tf[1] = mk && (homog ? max(carry, s[k]) : q) == start;
  }
  int out[IPT];
#pragma unroll
  for (int k = 0; k < IPT; ++k) out[k] = ((kp >> k) & 1u) ? z : x.id[k];
  if (base + IPT <= n) {  // the wrapper's outputs are 16-byte aligned
    int4* o = reinterpret_cast<int4*>(ids_out + base);
#pragma unroll
    for (int v = 0; v < IPT / 4; ++v)
      o[v] = make_int4(out[4 * v], out[4 * v + 1], out[4 * v + 2],
                       out[4 * v + 3]);
    unsigned w[2] = {0, 0};
#pragma unroll
    for (int k = 0; k < IPT; ++k) w[k / 4] |= ((lv >> k) & 1u) << (8 * (k % 4));
    *reinterpret_cast<uint2*>(live + base) = make_uint2(w[0], w[1]);
  } else {
    for (int k = 0; k < IPT && base + k < n; ++k) {
      ids_out[base + k] = out[k];
      live[base + k] = (lv >> k) & 1u;
    }
  }
  if (kept != nullptr) {
    int tile_kept;
    block_exclusive_scan<true, TPB>(__popc(kp), &tile_kept);
    if (threadIdx.x == 0 && tile_kept) atomicAdd(kept, tile_kept);
  }
}

// K4: the live tokens of ids[0 .. n), seg[0 .. n) moved to the front in
// order (so first positions keep the reference's first-occurrence order),
// *n_out = their count. In slot mode it runs when the slot applied a merge
// (bsel >= 1). Each tile compacts into shared memory while it looks back,
// then writes its run of outputs with consecutive stores.
__global__ void __launch_bounds__(TPB)
    compact_kernel(const int* __restrict__ ids, const int* __restrict__ seg,
                   const unsigned char* __restrict__ live,
                   const int* __restrict__ n_ptr, const int* slot,
                   int* __restrict__ ids_out, int* __restrict__ seg_out,
                   int* __restrict__ n_out, unsigned long long* st,
                   unsigned* counter, unsigned gen) {
  if (gated_off(slot, 1, K_CAP)) return;
  __shared__ int o_ids[TILE];
  __shared__ int o_seg[TILE];
  __shared__ int prefix;
  const int n = *n_ptr;
  const int t = tile_ticket(counter);
  const int last = max((n + TILE - 1) / TILE, 1) - 1;
  if (t > last) return;
  const int t0 = t * TILE;
  const int base = t0 + threadIdx.x * IPT;
  int id[IPT], sg[IPT];
  unsigned lv = 0;
  if (base + IPT <= n && aligned16(ids, seg) &&
      (reinterpret_cast<uintptr_t>(live) & 7) == 0) {
#pragma unroll
    for (int v = 0; v < IPT / 4; ++v) {
      unpack4(ld4<false>(ids + base + 4 * v), id + 4 * v);
      unpack4(ld4<false>(seg + base + 4 * v), sg + 4 * v);
    }
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(live + base));
#pragma unroll
    for (int k = 0; k < IPT; ++k)
      lv |= (unsigned)((((k < 4 ? w.x : w.y) >> (8 * (k % 4))) & 0xffu) != 0)
            << k;
  } else {
#pragma unroll
    for (int k = 0; k < IPT; ++k) {
      const bool in = base + k < n;
      id[k] = in ? ids[base + k] : 0;
      sg[k] = in ? seg[base + k] : 0;
      lv |= (unsigned)(in && live[base + k]) << k;
    }
  }
  int tile_total;
  int o = block_exclusive_scan<true, TPB>(__popc(lv), &tile_total);
  if (threadIdx.x == 0) st_publish(st, t, gen, t == 0 ? ST_P : ST_A,
                                   tile_total);
#pragma unroll
  for (int k = 0; k < IPT; ++k)
    if ((lv >> k) & 1u) {
      o_ids[o] = id[k];
      o_seg[o] = sg[k];
      ++o;
    }
  if (threadIdx.x < 32) {
    const int pre = look_back<true>(st, t, gen);
    if (threadIdx.x == 0) {
      prefix = pre;
      if (t > 0) st_publish(st, t, gen, ST_P, pre + tile_total);
      if (t == last) *n_out = pre + tile_total;
    }
  }
  __syncthreads();
  const int pre = prefix;
  for (int i = threadIdx.x; i < tile_total; i += TPB) {
    ids_out[pre + i] = o_ids[i];
    seg_out[pre + i] = o_seg[i];
  }
}

// The max of v[0 .. cnt), written earlier in this launch, in every thread
// of the block.
__device__ int block_max(const int* v, int cnt) {
  int a = -1;
  for (int i = threadIdx.x; i < cnt; i += TPB) a = max(a, __ldcg(v + i));
  int total;
  block_exclusive_scan<false, TPB>(a, &total);
  return total;
}

// The sums of v[0 .. cnt) and of v[0 .. upto), in one pass.
__device__ void block_sums(const int* v, int cnt, int upto, int* total,
                           int* prefix) {
  int a = 0, p = 0;
  for (int i = threadIdx.x; i < cnt; i += TPB) {
    const int x = __ldcg(v + i);
    a += x;
    p += i < upto ? x : 0;
  }
  block_exclusive_scan<true, TPB>(a, total);
  block_exclusive_scan<true, TPB>(p, prefix);
}

// A stream of one tile (a short document) in a grid of one block: the
// block keeps it in shared memory through every rank and compacts it in
// place, so a rank reads and writes no device memory, and a rank whose
// pair occurs nowhere costs one barrier.
__device__ void sweep_one_tile(const int* ids, const int* seg, int n,
                               const int* __restrict__ pairs,
                               const int* __restrict__ new_ids, int M,
                               int* w_ids0, int* w_seg0, int* n_out,
                               Stage& sh) {
  stage_tile<false>(ids, seg, 0, n, sh);
  int* const t_ids = reinterpret_cast<int*>(sh.ids);
  int* const t_seg = reinterpret_cast<int*>(sh.seg);
  for (int r = 0; r < M && n >= 2; ++r) {
    const int pa = pairs[2 * r], pb = pairs[2 * r + 1];
    const bool homog = pa == pb;
    const Lane x = lane_matches(sh, 0, n, pa, pb);
    int sg[IPT];
#pragma unroll
    for (int v = 0; v < IPT / 4; ++v)
      unpack4(sh.seg[threadIdx.x * (IPT / 4) + v], sg + 4 * v);
    // every read of the tile is done once this barrier passes
    if (!__syncthreads_or(x.m != 0)) continue;
    int s[IPT];
#pragma unroll
    for (int k = 0; k < IPT; ++k) s[k] = -1;
    int tmax;
    if (homog) run_starts(x, 0, s, &tmax);
    const unsigned kp = keep_mask(x, s, 0, homog, -1);
    const unsigned lv =
        valid_mask(0, n) & ~dead_mask(sh, x, kp, 0, homog, -1);
    int total;
    int o = block_exclusive_scan<true, TPB>(__popc(lv), &total);
    const int z = new_ids[r];
#pragma unroll
    for (int k = 0; k < IPT; ++k)
      if ((lv >> k) & 1u) {
        t_ids[o] = ((kp >> k) & 1u) ? z : x.id[k];
        t_seg[o] = sg[k];
        ++o;
      }
    __syncthreads();
    n = total;
  }
  for (int i = threadIdx.x; i < n; i += TPB) {
    w_ids0[i] = t_ids[i];
    w_seg0[i] = t_seg[i];
  }
  if (threadIdx.x == 0) *n_out = n;
}

// K10: merges r = 0 .. M-1 (pairs[2r], pairs[2r + 1]) -> new_ids[r] over
// ids[0 .. n0), seg[0 .. n0), each applied everywhere, left first, and
// compacted, from one ping-pong buffer into the other.
// The result lands in buffer 0 (w_ids0, w_seg0) and its length in *n_out;
// the input is not written. blk: int32[3 * gridDim.x] (block values: run
// starts, then the live counts, which alternate between two halves by rank,
// so a rank that skips its scatter, and with it a barrier, never
// overwrites counts a slow block still reads).
// Launched cooperatively: every block is resident, so the grid barrier
// holds.
__device__ void sweep(const int* ids, const int* seg, int n0,
                      const int* __restrict__ pairs,
                      const int* __restrict__ new_ids, int M, int* w_ids0,
                      int* w_seg0, int* w_ids1, int* w_seg1, int* blk,
                      int* n_out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Stage sh;
  __shared__ int o_ids[TILE];
  __shared__ int o_seg[TILE];
  const int G = gridDim.x, b = blockIdx.x;
  if (G == 1 && n0 <= TILE) {
    sweep_one_tile(ids, seg, n0, pairs, new_ids, M, w_ids0, w_seg0, n_out,
                   sh);
    return;
  }
  int* const w_ids[2] = {w_ids0, w_ids1};
  int* const w_seg[2] = {w_seg0, w_seg1};
  const int* src_ids = ids;
  const int* src_seg = seg;
  int src = -1;  // -1: the input, else the work buffer it lies in
  int n = n0;
  for (int i = 0; i < M && n >= 2; ++i) {
    const int T = (n + TILE - 1) / TILE;
    const int lo = (int)((long long)b * T / G);
    const int hi = (int)((long long)(b + 1) * T / G);
    int staged = -1;  // the tile in sh (this rank's source and n)
    auto stage = [&](int t) {
      if (staged != t) stage_tile<true>(src_ids, src_seg, t * TILE, n, sh);
      staged = t;
    };
    const int pa = pairs[2 * i], pb = pairs[2 * i + 1], z = new_ids[i];
    const bool homog = pa == pb;
    int s[IPT];
#pragma unroll
    for (int k = 0; k < IPT; ++k) s[k] = -1;

    // (a) the latest run start before this block's range
    int carry = -1;
    if (homog) {
      int mx = -1;
      for (int t = lo; t < hi; ++t) {
        stage(t);
        int tmax;
        run_starts(lane_matches(sh, t * TILE, n, pa, pb), t * TILE, s, &tmax);
        mx = max(mx, tmax);
      }
      if (threadIdx.x == 0) blk[b] = mx;
      grid.sync();
      carry = block_max(blk, b);
    }

    // (b) live counts. One tile's keep and live bits, given the latest run
    // start before it; rc moves on to the next tile. A block of one tile
    // keeps them in registers for (c).
    int rc = carry;
    auto decide = [&](int t, unsigned& kp, unsigned& lv, Lane& x) {
      stage(t);
      x = lane_matches(sh, t * TILE, n, pa, pb);
      int tmax = -1;
      if (homog) run_starts(x, t * TILE, s, &tmax);
      kp = keep_mask(x, s, t * TILE, homog, rc);
      lv = valid_mask(t * TILE, n) &
           ~dead_mask(sh, x, kp, t * TILE, homog, rc);
      rc = max(rc, tmax);
    };
    const bool one = hi - lo == 1;
    unsigned kp1 = 0, lv1 = 0;
    Lane x1{};
    int cnt = 0;
    for (int t = lo; t < hi; ++t) {
      decide(t, kp1, lv1, x1);
      int tile_total;
      block_exclusive_scan<true, TPB>(__popc(lv1), &tile_total);
      cnt += tile_total;
    }
    int* counts = blk + G * (1 + (i & 1));
    if (threadIdx.x == 0) counts[b] = cnt;
    grid.sync();
    int total, off;
    block_sums(counts, G, b, &total, &off);
    if (total == n) continue;  // nothing merged: the stream stays

    // (c) the scatter into the other buffer
    const int dst = src == 0 ? 1 : 0;
    rc = carry;
    for (int t = lo; t < hi; ++t) {
      unsigned kp = kp1, lv = lv1;
      Lane x = x1;
      if (!one) decide(t, kp, lv, x);
      int tile_total;
      int o = block_exclusive_scan<true, TPB>(__popc(lv), &tile_total);
#pragma unroll
      for (int k = 0; k < IPT; ++k)
        if ((lv >> k) & 1u) {
          o_ids[o] = ((kp >> k) & 1u) ? z : x.id[k];
          o_seg[o] = reinterpret_cast<const int*>(
              sh.seg)[threadIdx.x * IPT + k];
          ++o;
        }
      __syncthreads();
      for (int q = threadIdx.x; q < tile_total; q += TPB) {
        w_ids[dst][off + q] = o_ids[q];
        w_seg[dst][off + q] = o_seg[q];
      }
      off += tile_total;
      __syncthreads();  // o_ids / o_seg are reused by the next tile
    }
    grid.sync();
    src = dst;
    src_ids = w_ids[dst];
    src_seg = w_seg[dst];
    n = total;
  }
  if (src != 0) {  // the result goes to buffer 0
    for (int i = b * TPB + threadIdx.x; i < n; i += G * TPB) {
      w_ids0[i] = __ldcg(src_ids + i);
      w_seg0[i] = __ldcg(src_seg + i);
    }
  }
  if (b == 0 && threadIdx.x == 0) *n_out = n;
}

__global__ void __launch_bounds__(TPB)
    encode_sweep_kernel(const int* ids, const int* seg, int n0,
                        const int* __restrict__ pairs,
                        const int* __restrict__ new_ids, int M, int* w_ids0,
                        int* w_seg0, int* w_ids1, int* w_seg1, int* blk,
                        int* n_out) {
  sweep(ids, seg, n0, pairs, new_ids, M, w_ids0, w_seg0, w_ids1, w_seg1, blk,
        n_out);
}

// ---------------------------------------------------------------------------
// K11 chunk_encode and K12 encode_min_sweep: encode with a table above the
// dense route's vocab (ops/flat_encode.py). They replace minbpe_tpu's flat
// encoder, ops/flat_encode.py::_encode_flat (:61-186): a jitted
// lax.while_loop over scan2d, with no Pallas site. Its rule is the
// reference's per-chunk loop (minbpe/regex.py:96-108): in each chunk, merge
// every occurrence of that chunk's lowest-rank pair, left first, until the
// chunk has none. The wrapper routes chunks by length on the host: those of
// at most CHUNK_MAX tokens to K11, the longer ones to K12.
//
// A pair's rank and new id come from a two-table cuckoo hash
// (ops/ranktab.py): rows [a, b, rank, new_id] of 16 bytes, table 2 after
// table 1, two probes of one 16-byte load each. Its two hashes differ (seeds
// s1, s2 and s3, s4) and must equal ranktab.mix bit for bit: uint32
// arithmetic that wraps. At 100,000 merges both tables take 8 MB, which
// the 50 MB L2 holds, so a probe is an L2 hit once the table is warm.
//
// Bound: bytes, 4 B read per input token (the bytes as int32) and 4 B
// written per output token; the lookups go to L2. What bounds both kernels
// is the latency of a chunk's rounds: a chunk takes one round per distinct
// rank it applies, and each round waits on a reduction over the chunk and
// on the probes of the pairs it changed.
//
// Both keep a chunk's tokens where its threads work on them and look pairs
// up only where a merge changed them. Each token holds the rank of the pair
// that ENDS at it (its key: the pair of the live token before it and
// itself), so a thread's keys are its own to rewrite. A round: the chunk's
// least key m (RANK_INF: done); then each live token whose key is m is
// merged unless the token before it was (left first, so a run of one token
// (a, a) keeps the even offsets from its start), takes m's new id, and the
// token before it dies; then the keys of the merged tokens and of the live
// token after each are looked up again.
//
// K11 gives a chunk of at most LANE_MAX tokens (a word, a number: 94% of
// the smoke corpus's GPT-4 split) to one lane, which runs the whole loop in
// registers; 32 such chunks share a warp with no synchronisation. A longer
// chunk (up to CHUNK_MAX) has a warp of its own, as K12's thread group at
// warp scope; the host puts the short chunks first. (One warp a chunk, with
// every pair probed again every round, spent a warp on ~4 tokens.)
//
// K12 gives each chunk its own group of threads (in place of a cooperative
// sweep over all long chunks, each round the grid's lowest rank with three
// or four grid barriers and a full rewrite of the stream, the rounds the
// union of every chunk's): one block up to K12_TPB * K12_P tokens, a thread-
// block cluster of up to K12_CLUSTER_MAX blocks above that. Its rounds
// synchronise within the group alone: one __syncthreads, and in a cluster
// one cluster barrier (0.54-1.12 us against 1.29-7.54 for a grid barrier,
// H100 80GB HBM3 at 700 W, scripts/time_barriers.py), so chunks proceed
// independently and the launch takes its longest chunk's rounds. Each thread
// owns consecutive positions of the chunk; dead ones stay in place, marked,
// and nothing is compacted until the end. A round's critical path is the
// slowest thread's own work (its walks over its slots, each a chain, and its
// lookups), so the slots live in registers (8, 16 or K12_P a thread, the
// fewest that hold the chunk in a block, 16 in a cluster where 16 blocks
// hold it; every walk unrolled) up to K12_CLUSTER_MAX * K12_TPB * K12_P
// tokens; past that, in device memory (L2), in sub-ranges of 8-slot groups
// with their summaries in shared memory, a tier chosen on the host from the
// chunk's length. A pair belongs to the thread of its left token (a thread's
// first token's pair is the thread before's boundary pair), so a thread can
// find every pair it looks up after the merges without asking its neighbours
// again, and a round takes one exchange: the group's scans combine, per
// warp, block and cluster, the least key, the carry of "the pair before was
// merged" as a function of the carry in (three ballots compose a warp's: a
// run's parity crosses threads, warps and blocks), and what a thread must
// know of the next live thread to find its new right-hand token (its first
// token, the key of its second, its boundary key).
// ---------------------------------------------------------------------------
constexpr int RANK_INF = 0x7fffffff;
constexpr int KEY_NEED = -2;       // a token whose pair is to be looked up
constexpr unsigned MIX_MUL = 0x2C1B3C6Du;
constexpr int CHUNK_MAX = 256;     // tokens of a chunk K11 takes
constexpr int LANE_MAX = 8;        // tokens of a chunk one K11 lane takes
constexpr int K11_WARPS = 8;       // warps a K11 block
constexpr int K12_TPB = 256;       // threads a K12 block
constexpr int K12_WARPS = K12_TPB / 32;
constexpr int K12_P = 32;          // slots a thread in registers
constexpr int K12_NS_MAX = 24;     // sub-ranges a thread in device memory
// shared memory of a block's sub-range summaries, a sub-range a thread
constexpr int K12_SUM_BYTES = 7 * 4 * K12_TPB;
constexpr int K12_CLUSTER_MAX = 16;
// a device-tier chunk's scratch offset counts units of this many ints (two
// ints a slot, 8-slot groups, so every chunk's scratch is a whole number of
// units), so that an int32 job names any offset
constexpr int K12_BASE_UNIT = 2 * K12_TPB * 8;

enum Level { LV_WARP = 0, LV_BLOCK = 1, LV_CLUSTER = 2 };

struct Cuckoo {
  const int4* rows;  // table 1: rows[0 .. H), table 2: rows[H .. 2H)
  int H;             // a power of two
  unsigned s1, s2, s3, s4;
};

__device__ __forceinline__ unsigned ck_hash(int a, int b, unsigned sa,
                                            unsigned sb, int H) {
  unsigned u = (unsigned)a * sa + (unsigned)b * sb;
  u ^= u >> 15;
  u *= MIX_MUL;
  u ^= u >> 12;
  return u & (unsigned)(H - 1);
}

// Brings the two rows the pair (a, b) may occupy into L1, so a lookup a
// barrier later waits on L1 and not on L2.
__device__ __forceinline__ void ck_prefetch(const Cuckoo& t, int a, int b) {
  if (a < 0 || b < 0) return;
  asm volatile("prefetch.global.L1 [%0];" ::"l"(
      t.rows + ck_hash(a, b, t.s1, t.s2, t.H)));
  asm volatile("prefetch.global.L1 [%0];" ::"l"(
      t.rows + t.H + ck_hash(a, b, t.s3, t.s4, t.H)));
}

// (rank, new id) of the pair (a, b), (RANK_INF, -1) where it is absent or
// a or b is negative. Both probes are issued before either is compared, so
// their latencies overlap.
__device__ __forceinline__ int2 ck_find(const Cuckoo& t, int a, int b) {
  if (a < 0 || b < 0) return make_int2(RANK_INF, -1);
  const int4 r1 = __ldg(t.rows + ck_hash(a, b, t.s1, t.s2, t.H));
  const int4 r2 = __ldg(t.rows + t.H + ck_hash(a, b, t.s3, t.s4, t.H));
  if (r1.x == a && r1.y == b) return make_int2(r1.z, r1.w);
  if (r2.x == a && r2.y == b) return make_int2(r2.z, r2.w);
  return make_int2(RANK_INF, -1);
}

// The carry of a run of tokens as a function of the carry into it (does
// the pair ending at the token before the run merge?), two bits: f(0) and
// f(1). FN_C0: a live token with no merge (the carry after it is 0);
// FN_ID: no live token; FN_NOT; FN_C1.
constexpr unsigned FN_C0 = 0u;
constexpr unsigned FN_NOT = 1u;
constexpr unsigned FN_ID = 2u;
constexpr unsigned FN_C1 = 3u;

__device__ __forceinline__ unsigned fn_at(unsigned f, unsigned x) {
  return (f >> x) & 1u;
}

// a record's function for the round's rank m: its own where its least key
// is m, else a run breaker where it holds a live token
__device__ __forceinline__ unsigned fn_for(int mn, unsigned f, bool live,
                                           int m) {
  return mn == m ? f : (live ? FN_C0 : FN_ID);
}

// A warp's functions as three ballots: constant, FN_C1, FN_NOT.
struct FnVotes {
  unsigned cm, one, nm;
};

__device__ __forceinline__ FnVotes fn_votes(unsigned f) {
  return {__ballot_sync(FULL, f == FN_C0 || f == FN_C1),
          __ballot_sync(FULL, f == FN_C1), __ballot_sync(FULL, f == FN_NOT)};
}

// The composition, in lane order, of the functions of the lanes in sel:
// the last constant one among them, flipped by each FN_NOT after it; with
// none, the carry in flipped by each FN_NOT.
__device__ __forceinline__ unsigned fn_compose(const FnVotes& v,
                                               unsigned sel) {
  const unsigned k = v.cm & sel;
  if (k) {
    const int j = 31 - __clz(k);
    const unsigned after = sel & ~(0xffffffffu >> (31 - j));
    return ((v.one >> j & 1u) ^ (__popc(v.nm & after) & 1u)) ? FN_C1
                                                            : FN_C0;
  }
  return __popc(v.nm & sel) & 1u ? FN_NOT : FN_ID;
}

// the warp's inclusive sum
__device__ __forceinline__ int sum_scan(int x) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(FULL, x, d);
    if (lane >= d) x += o;
  }
  return x;
}

// the lowest set bit of x above bit i (-1: none)
__device__ __forceinline__ int bit_after(unsigned x, int i) {
  x = i >= 31 ? 0u : x & (0xfffffffeu << i);
  return x ? __ffs(x) - 1 : -1;
}

// The records a block's warps, and a cluster's blocks, exchange once a
// round: the least key, the carry function | live << 2, and the first live
// thread's token, second key (-1: it holds one token) and boundary key. A
// block stores its record into every block of its cluster (indexed by its
// rank) before the cluster barrier, so each block reads them from its own
// shared memory after it.
// Each buffer has two halves, by round parity: a round's records are read
// while the next round's are written.
struct SweepShared {
  int4 wa[2][K12_WARPS];
  int wb[2][K12_WARPS];
  int4 ba[2][K12_CLUSTER_MAX];
  int bb[2][K12_CLUSTER_MAX];
  int ws[K12_WARPS];   // a warp's live tokens at the end
  int bs[K12_CLUSTER_MAX];
};

// What a thread knows of the next live thread of its chunk, as that
// thread stood before the round's merges: its first token, the key of its
// second (-1: it holds one token) and its boundary key (has: such a thread
// exists).
struct Next {
  int ftok, fk2, bkey;
  bool has;
};

// The merged token's neighbour to the right after the round (rank m, new
// id z): where this thread's boundary pair merged, or the next thread's
// first pair did (its second key, or its boundary key where it holds one
// token), it is z; else the next thread's first token.
__device__ __forceinline__ int next_first(const Next& nb, bool kb, int m,
                                          int z) {
  if (!nb.has) return -1;
  if (kb || (nb.fk2 < 0 ? nb.bkey : nb.fk2) == m) return z;
  return nb.ftok;
}

// One thread's slots of a chunk in memory (K12's device-memory tier): P = S
// * NS consecutive positions, slot k at tok[k * stride] (-1: dead) and
// key[k * stride]; S is a multiple of 8, and a walk reads 8 slots at a
// time, all 16 loads in flight at once. Each sub-range of S slots keeps a
// summary in shared memory (sm[(7 s + i) * stride]): its least key, its
// first and last live slots, their tokens, and the keys of its first and
// second live slots, so a round reads device memory only in the sub-ranges
// that hold its rank or changed. The thread's first live slot keeps the
// key RANK_INF: its pair is the thread before's boundary pair.
struct MemRun {
  int* tok;
  int* key;
  int* sm;
  int stride, S, NS;
  unsigned long long live = 0;   // the sub-ranges holding a live token
  unsigned long long mins = 0;   // the live sub-ranges whose least key is lmin
  unsigned long long dirty = 0;  // the sub-ranges the merges wrote
  bool moved = false;  // the last live token or rtok changed
  int lmin = RANK_INF;           // the least key, the boundary key's too
  int rtok = -1;   // the next live thread's first token (-1: none)
  int bkey = RANK_INF;  // the key of (the last live token, rtok)
  int ftok = -1, fk2 = -1;  // the first live token, the second's key

  __device__ int& T(int k) const { return tok[k * stride]; }
  __device__ int& K(int k) const { return key[k * stride]; }
  __device__ int& M(int s) const { return sm[7 * s * stride]; }
  __device__ int& F(int s) const { return sm[(7 * s + 1) * stride]; }
  __device__ int& L(int s) const { return sm[(7 * s + 2) * stride]; }
  __device__ int& FT(int s) const { return sm[(7 * s + 3) * stride]; }
  __device__ int& LT(int s) const { return sm[(7 * s + 4) * stride]; }
  __device__ int& FK(int s) const { return sm[(7 * s + 5) * stride]; }
  __device__ int& SK(int s) const { return sm[(7 * s + 6) * stride]; }

  __device__ void load8(int k0, int (&t)[8], int (&kv)[8]) const {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      t[j] = T(k0 + j);
      kv[j] = K(k0 + j);
    }
  }

  // Sub-range s's summary from its slots, and its live bit. With `look`,
  // keys marked KEY_NEED are looked up first (the pair with the live token
  // before, lt); without, they count as RANK_INF.
  __device__ void summarise(int s, bool look, int lt, const Cuckoo& ck) {
    int f = -1, l = -1, ft = -1, last = -1, fk = RANK_INF, sk = -1;
    int mn = RANK_INF, n = 0;
    for (int k0 = s * S; k0 < (s + 1) * S; k0 += 8) {
      int t[8], kv[8];
      load8(k0, t, kv);
      if (look) {  // each pair's left token first, then the lookups at once
        int a[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          a[j] = lt;
          if (t[j] >= 0) lt = t[j];
        }
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (t[j] >= 0 && kv[j] == KEY_NEED) {
            kv[j] = ck_find(ck, a[j], t[j]).x;
            K(k0 + j) = kv[j];
          }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (t[j] >= 0) {
          if (n == 0) {
            f = k0 + j;
            ft = t[j];
            fk = kv[j];
          } else if (n == 1) {
            sk = kv[j];
          }
          ++n;
          l = k0 + j;
          last = lt = t[j];
          if (kv[j] >= 0) mn = min(mn, kv[j]);
        }
    }
    M(s) = mn;
    F(s) = f;
    L(s) = l;
    FT(s) = ft;
    LT(s) = last;
    FK(s) = fk;
    SK(s) = sk;
    if (n)
      live |= 1ull << s;
    else
      live &= ~(1ull << s);
  }

  // lmin, the sub-ranges that hold it, and what the thread before reads
  __device__ void minima() {
    lmin = bkey;
    mins = 0;
#pragma unroll 4
    for (int s = 0; s < NS; ++s) {
      const int v = live >> s & 1 ? M(s) : RANK_INF;
      if (v < lmin) {
        lmin = v;
        mins = 0;
      }
      if (v == lmin && v != RANK_INF) mins |= 1ull << s;
    }
    ftok = -1;
    fk2 = -1;
    if (live) {
      const int s0 = __ffsll(live) - 1;
      const unsigned long long rest = live & (live - 1);
      ftok = FT(s0);
      fk2 = L(s0) != F(s0) ? SK(s0) : (rest ? FK(__ffsll(rest) - 1) : -1);
    }
  }

  // whether this thread holds exactly one live token
  __device__ bool single() const {
    const int s0 = __ffsll(live) - 1;
    return live == (1ull << s0) && F(s0) == L(s0);
  }

  // positions p0 .. p0 + P of the chunk ids[lo .. lo + n)
  __device__ void init(const int* __restrict__ ids, int lo, int n, int p0,
                       int P, const Cuckoo& ck) {
    int lt = -1;
    for (int s = 0; s < NS; ++s) {
      for (int k0 = s * S; k0 < (s + 1) * S; k0 += 8) {
        int t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int p = p0 + k0 + j;
          t[j] = p < n ? __ldg(ids + lo + p) : -1;
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          T(k0 + j) = t[j];
          K(k0 + j) = ck_find(ck, j ? t[j - 1] : lt, t[j]).x;
        }
        lt = t[7];
      }
      summarise(s, false, -1, ck);
    }
    rtok = live && p0 + P < n ? __ldg(ids + lo + p0 + P) : -1;
    bkey = live ? ck_find(ck, LT(63 - __clzll(live)), rtok).x : RANK_INF;
    minima();
  }

  // The carry function of this thread's pairs, its boundary pair last, for
  // rank m (lmin == m). The first live token's own pair is the thread
  // before's: the carry passes it.
  __device__ unsigned fn(int m) const {
    unsigned c0 = 0u, c1 = 1u;  // from carry in 0 and 1
    bool first = true;
    for (unsigned long long r = live; r; r &= r - 1) {
      const int s = __ffsll(r) - 1;
      if (!(mins >> s & 1)) {
        if (!(first && F(s) == L(s))) c0 = c1 = 0u;
        first = false;
        continue;
      }
      for (int k0 = s * S; k0 < (s + 1) * S; k0 += 8) {
        int t[8], kv[8];
        load8(k0, t, kv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (t[j] < 0) continue;
          if (first) {
            first = false;
            continue;
          }
          const bool hit = kv[j] == m;
          c0 = hit && !c0;
          c1 = hit && !c1;
        }
      }
    }
    const bool hit = bkey == m;
    c0 = hit && !c0;
    c1 = hit && !c1;
    return c0 | c1 << 1;
  }

  // the first live slot of sub-range s after slot k (-1: none)
  __device__ int first_after(int s, int k) const {
    for (int k0 = k + 1 - (k + 1 - s * S) % 8; k0 < (s + 1) * S; k0 += 8) {
      int t[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j] = T(k0 + j);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (k0 + j > k && t[j] >= 0) return k0 + j;
    }
    return -1;
  }

  // Merges this round's pairs (rank m, new id z): c, the pair ending at
  // this thread's first live token merged (it takes z); nb, the next live
  // thread. Marks KEY_NEED on each merged token and the live one after it
  // (the pairs known here prefetched into L1), finds the next thread's new
  // first token, and summarises the sub-ranges it wrote.
  __device__ void apply(int m, int z, bool c, const Next& nb,
                        const Cuckoo& ck) {
    dirty = 0;
    if (!live) {
      rtok = -1;
      moved = false;
      return;
    }
    const int s0 = __ffsll(live) - 1;
    const int top = 63 - __clzll(live);
    if (c) {  // the first live token takes z
      T(F(s0)) = z;
      dirty |= 1ull << s0;
    }
    bool pend = c;  // the next live token's left half merged
    int prev = -1, prev_s = -1;  // the live token before: a slot, or the
                                 // last live of a sub-range not walked
    bool first = true;
    int t1 = -1, t2 = -1;  // the tokens, after the merges, of the live slot
                           // before and of the one before it (-1: unknown)
    for (unsigned long long r = lmin == m ? live : 0ull; r; r &= r - 1) {
      const int s = __ffsll(r) - 1;
      if (!(mins >> s & 1)) {
        const bool just_first = first && F(s) == L(s);
        if (pend && !just_first) {
          const int k = first ? first_after(s, F(s)) : F(s);
          K(k) = KEY_NEED;
          dirty |= 1ull << s;
          pend = false;
        }
        if (!just_first) c = false;
        first = false;
        prev = -1;
        prev_s = s;
        t1 = t2 = -1;
        continue;
      }
      dirty |= 1ull << s;
      for (int k0 = s * S; k0 < (s + 1) * S; k0 += 8) {
        int t[8], kv[8];
        load8(k0, t, kv);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          if (t[j] < 0) continue;
          const int k = k0 + j;
          if (first) {  // its pair is the thread before's
            first = false;
            prev = k;
            prev_s = -1;
            t1 = t[j];
            continue;
          }
          const bool kept = kv[j] == m && !c;
          if (pend || kept) K(k) = KEY_NEED;
          if (pend) ck_prefetch(ck, t1, t[j]);
          pend = kept;
          if (kept) {
            ck_prefetch(ck, t2, z);
            t1 = z;
            T(k) = z;
            const int d = prev >= 0 ? prev : L(prev_s);
            T(d) = -1;
            K(d) = RANK_INF;
            dirty |= 1ull << (d / S);
          } else {
            t2 = t1;
            t1 = t[j];
          }
          c = kept;
          prev = k;
          prev_s = -1;
        }
      }
    }
    if (lmin != m) {  // only the first token's merge, and the boundary
      const bool one = single();
      if (pend && !one) {
        const int k = L(s0) != F(s0) ? first_after(s0, F(s0))
                                     : F(__ffsll(live & (live - 1)) - 1);
        K(k) = KEY_NEED;
        dirty |= 1ull << (k / S);
      }
      if (!one) c = false;
      prev = -1;
      prev_s = top;
    }
    const bool kb = bkey == m && !c;
    if (kb) {  // the boundary pair merged: the last live token dies
      const int d = prev >= 0 ? prev : L(prev_s);
      T(d) = -1;
      K(d) = RANK_INF;
      dirty |= 1ull << (d / S);
    }
    const int nr = next_first(nb, kb, m, z);
    moved = nr != rtok || kb || (dirty >> top & 1);
    rtok = nr;
    for (unsigned long long r = dirty; r; r &= r - 1)
      summarise(__ffsll(r) - 1, false, -1, ck);
  }

  // The keys marked KEY_NEED looked up, the first live token's set to
  // RANK_INF, the boundary key again where it moved; the least keys.
  __device__ void relook(const Cuckoo& ck) {
    if (live) {  // the first live token's pair is the thread before's
      const int s0 = __ffsll(live) - 1;
      if (FK(s0) != RANK_INF) {
        K(F(s0)) = RANK_INF;
        dirty |= 1ull << s0;
      }
    }
    if (!dirty && !moved) return;
    for (unsigned long long r = dirty & live; r; r &= r - 1) {
      const int s = __ffsll(r) - 1;
      const unsigned long long before = live & ((1ull << s) - 1);
      summarise(s, true, before ? LT(63 - __clzll(before)) : -1, ck);
    }
    if (moved)
      bkey = live ? ck_find(ck, LT(63 - __clzll(live)), rtok).x : RANK_INF;
    dirty = 0;
    moved = false;
    minima();
  }

  __device__ int count() const {
    int n = 0;
    for (unsigned long long q = live; q; q &= q - 1) {
      const int s = __ffsll(q) - 1;
      for (int k0 = s * S; k0 < (s + 1) * S; k0 += 8)
#pragma unroll
        for (int j = 0; j < 8; ++j) n += T(k0 + j) >= 0;
    }
    return n;
  }
  __device__ void write(int* o) const {
    for (unsigned long long q = live; q; q &= q - 1) {
      const int s = __ffsll(q) - 1;
      for (int k0 = s * S; k0 < (s + 1) * S; k0 += 8) {
        int t[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) t[j] = T(k0 + j);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (t[j] >= 0) *o++ = t[j];
      }
    }
  }
};

// One thread's P consecutive positions of a chunk in registers (P <= 32):
// slot k's token tok[k] and key key[k], live while bit k of `live` is set;
// the first live slot's key is not used (its pair is the thread before's
// boundary pair). Every walk is unrolled over the registers, so a round's
// work is register operations and one wait on its lookups, which go out
// together.
template <int P>
struct RegRun {
  int tok[P];
  int key[P];
  unsigned live = 0;
  unsigned need = 0;   // the slots whose key is to be looked up
  bool dirty = false;  // the merges changed this thread's slots
  bool moved = false;  // the last live token or rtok changed
  int lmin = RANK_INF;
  int rtok = -1;
  int bkey = RANK_INF;
  int ftok = -1, fk2 = -1;

  // lmin and what the thread before reads (the first token, the second
  // live token's key, -1 where there is none)
  __device__ void finish() {
    ftok = -1;
    fk2 = -1;
    const unsigned inner = live & (live - 1);  // every live slot but the first
    const unsigned second = inner & (0u - inner);
    int v[P];  // the least key by a tree, not a chain
#pragma unroll
    for (int k = 0; k < P; ++k) {
      v[k] = inner >> k & 1u ? key[k] : RANK_INF;
      if (second >> k & 1u) fk2 = key[k];
      if ((live & (0u - live)) >> k & 1u) ftok = tok[k];
    }
#pragma unroll
    for (int w = P / 2; w > 0; w /= 2)
#pragma unroll
      for (int k = 0; k < w; ++k) v[k] = min(v[k], v[k + w]);
    lmin = min(v[0], bkey);
  }

  __device__ int last_tok() const {
    int t = -1;
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (live >> k & 1u) t = tok[k];
    return t;
  }

  // positions p0 .. p0 + P of the chunk ids[lo .. lo + n)
  __device__ void init(const int* __restrict__ ids, int lo, int n, int p0,
                       int, const Cuckoo& ck) {
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int p = p0 + k;
      tok[k] = p < n ? __ldg(ids + lo + p) : -1;
      if (tok[k] >= 0) live |= 1u << k;
    }
    key[0] = RANK_INF;
#pragma unroll
    for (int k = 1; k < P; ++k) key[k] = ck_find(ck, tok[k - 1], tok[k]).x;
    rtok = live && p0 + P < n ? __ldg(ids + lo + p0 + P) : -1;
    bkey = ck_find(ck, last_tok(), rtok).x;
    finish();
  }

  // the carry function of this thread's pairs, its boundary pair last, for
  // rank m (lmin == m); the carry passes the first live token
  __device__ unsigned fn(int m) const {
    unsigned c0 = 0u, c1 = 1u;  // from carry in 0 and 1
    const unsigned inner = live & (live - 1);
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (inner >> k & 1u) {
        const bool hit = key[k] == m;
        c0 = hit && !c0;
        c1 = hit && !c1;
      }
    const bool hit = bkey == m;
    c0 = hit && !c0;
    c1 = hit && !c1;
    return c0 | c1 << 1;
  }

  // As MemRun::apply; the slots to look up go to `need`.
  __device__ void apply(int m, int z, bool c, const Next& nb, const Cuckoo&) {
    unsigned kill = 0, pbit = 0;  // pbit: the last live slot seen
    need = 0;
    const unsigned low = live & (0u - live);
    unsigned zed = c ? low : 0u;  // the slots that took z
    bool after = c;  // the pair ending at the next live token changed
    if (lmin == m || c) {
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (live >> k & 1u) {
          if (low >> k & 1u) {  // the first: the thread before's pair
            if (c) tok[k] = z;
          } else {
            const bool kept = key[k] == m && !c;
            if (kept) {
              tok[k] = z;
              kill |= pbit;
              zed |= 1u << k;
            }
            if (kept || after) need |= 1u << k;
            after = c = kept;
          }
          pbit = 1u << k;
        }
    } else {
      pbit = live ? 1u << (31 - __clz(live)) : 0u;
    }
    const bool kb = live && bkey == m && !c;
    if (kb) kill |= pbit;
    const int nr = next_first(nb, kb, m, z);
    moved = nr != rtok || kb || (pbit & zed);
    rtok = nr;
    live &= ~kill;
    need &= live;
    dirty = (kill | need | zed) != 0;
  }

  // The keys in `need` looked up (up to two gathered by selects and issued
  // together, more through one unrolled walk), the boundary key again where
  // it moved; the least keys.
  __device__ void relook(const Cuckoo& ck) {
    if (!dirty && !moved) return;
    const unsigned low = live & (0u - live);
    need &= ~low;
    if (__popc(need) <= 2) {
      const int k0 = need ? __ffs(need) - 1 : -1;
      const int k1 = need & (need - 1) ? __ffs(need & (need - 1)) - 1 : -1;
      int a0 = -1, b0 = -1, a1 = -1, b1 = -1, last = -1;
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (live >> k & 1u) {
          if (k < k0) a0 = tok[k];
          if (k < k1) a1 = tok[k];
          if (k == k0) b0 = tok[k];
          if (k == k1) b1 = tok[k];
          last = tok[k];
        }
      const int v0 = ck_find(ck, a0, b0).x, v1 = ck_find(ck, a1, b1).x;
      if (moved) bkey = ck_find(ck, last, rtok).x;
#pragma unroll
      for (int k = 0; k < P; ++k) {
        if (k == k0) key[k] = v0;
        if (k == k1) key[k] = v1;
      }
    } else {
      int lt = -1;
#pragma unroll
      for (int k = 0; k < P; ++k)
        if (live >> k & 1u) {
          if (need >> k & 1u) key[k] = ck_find(ck, lt, tok[k]).x;
          lt = tok[k];
        }
      if (moved) bkey = ck_find(ck, lt, rtok).x;
    }
    dirty = moved = false;
    finish();
  }

  __device__ int count() const { return __popc(live); }
  __device__ void write(int* o) const {
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (live >> k & 1u) *o++ = tok[k];
  }
};

// The round's rank m over the group's threads (RANK_INF: the chunk is
// done), with this thread's carry in (c: the pair ending at its first live
// token merged) and what it knows of the next live thread (nb), and m's
// new id in z where this thread holds m. A warp's lanes
// reduce and scan by shuffles for the warp's own least key; a block's warps
// through sh (the half of the round's parity) after a __syncthreads; a
// cluster's blocks through sh.ba after a cluster barrier.
template <int LEVEL, class R>
__device__ int round_min(const R& r, const int* __restrict__ new_ids,
                         SweepShared* sh, int round, int rank, int cs,
                         bool& c, Next& nb, int& z) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cw = __reduce_min_sync(FULL, r.lmin);
  const bool mine = r.lmin == cw && cw != RANK_INF;
  if (mine) z = __ldg(new_ids + cw);  // in flight across the barriers
  const FnVotes fv = fn_votes(mine ? r.fn(cw) : (r.live ? FN_C0 : FN_ID));
  const unsigned fx = fn_compose(fv, (1u << lane) - 1u);  // lanes before
  const unsigned lv = __ballot_sync(FULL, r.live != 0);
  const int la = bit_after(lv, lane);
  const int ls = la < 0 ? lane : la;
  const Next nl{__shfl_sync(FULL, r.ftok, ls), __shfl_sync(FULL, r.fk2, ls),
                __shfl_sync(FULL, r.bkey, ls), la >= 0};
  const unsigned lane_in = lv & ((1u << lane) - 1u) ? FN_C0 : FN_ID;
  if constexpr (LEVEL == LV_WARP) {
    c = fn_at(fx, 0u);
    nb = nl;
    return cw;
  }
  const int h = round & 1;
  const int f0 = lv ? __ffs(lv) - 1 : 0;
  if (lane == 0) {
    sh->wa[h][warp] = make_int4(cw, fn_compose(fv, FULL) | (lv != 0) << 2,
                                r.ftok, r.fk2);
    sh->wb[h][warp] = r.bkey;
  }
  // lane 0's record holds lane f0's fields: the first live lane's
  if (f0 != 0) {
    const int ft = __shfl_sync(FULL, r.ftok, f0);
    const int fk = __shfl_sync(FULL, r.fk2, f0);
    const int bk = __shfl_sync(FULL, r.bkey, f0);
    if (lane == 0) {
      sh->wa[h][warp].z = ft;
      sh->wa[h][warp].w = fk;
      sh->wb[h][warp] = bk;
    }
  }
  __syncthreads();
  const int4 w = lane < K12_WARPS ? sh->wa[h][lane]
                                  : make_int4(RANK_INF, FN_ID, -1, -1);
  const int wb = lane < K12_WARPS ? sh->wb[h][lane] : RANK_INF;
  const int bmin = __reduce_min_sync(FULL, w.x);
  // the block's warps for the block's least key; what the cluster's makes
  // of them is settled after its barrier
  const FnVotes fvb = fn_votes(fn_for(w.x, w.y & 3, w.y >> 2 & 1, bmin));
  const unsigned wl = __ballot_sync(FULL, lane < K12_WARPS && (w.y & 4));
  const int wa = bit_after(wl, warp);
  const int ws = wa < 0 ? 0 : wa;
  const Next nw{__shfl_sync(FULL, w.z, ws), __shfl_sync(FULL, w.w, ws),
                __shfl_sync(FULL, wb, ws), wa >= 0};
  const unsigned pw = fn_compose(fvb, (1u << warp) - 1u);  // warps before
  int m = bmin;
  unsigned cb = 0u;  // the carry into this block
  Next nbk{-1, -1, RANK_INF, false};  // the next live block's first thread
  if constexpr (LEVEL == LV_CLUSTER) {
    cg::cluster_group cluster = cg::this_cluster();
    const int w0 = wl ? __ffs(wl) - 1 : 0;
    const int4 rec = make_int4(bmin, fn_compose(fvb, FULL) | (wl != 0) << 2,
                               __shfl_sync(FULL, w.z, w0),
                               __shfl_sync(FULL, w.w, w0));
    const int rb = __shfl_sync(FULL, wb, w0);
    if (warp == 0 && lane < cs) {
      *cluster.map_shared_rank(&sh->ba[h][rank], lane) = rec;
      *cluster.map_shared_rank(&sh->bb[h][rank], lane) = rb;
    }
    cluster.sync();
    const int4 q = lane < cs ? sh->ba[h][lane]
                             : make_int4(RANK_INF, FN_ID, -1, -1);
    const int qb = lane < cs ? sh->bb[h][lane] : RANK_INF;
    m = __reduce_min_sync(FULL, q.x);
    cb = fn_at(fn_compose(fn_votes(fn_for(q.x, q.y & 3, q.y >> 2 & 1, m)),
                          (1u << rank) - 1u),
               0u);
    const int qa =
        bit_after(__ballot_sync(FULL, lane < cs && (q.y & 4)), rank);
    const int qs = qa < 0 ? 0 : qa;
    nbk = Next{__shfl_sync(FULL, q.z, qs), __shfl_sync(FULL, q.w, qs),
               __shfl_sync(FULL, qb, qs), qa >= 0};
  }
  if (m == RANK_INF) return m;
  // below the block's least key every warp is a run breaker or empty
  const unsigned cwarp =
      fn_at(m == bmin ? pw : (wl & ((1u << warp) - 1u) ? FN_C0 : FN_ID), cb);
  c = fn_at(cw == m ? fx : lane_in, cwarp);
  nb = la >= 0 ? nl : (wa >= 0 ? nw : nbk);
  return m;
}

// Writes the chunk's live tokens to out[lo ..] in order and their count to
// *len (and the rounds to *rounds where given).
template <int LEVEL, class R>
__device__ void write_chunk(const R& r, int* out, int lo, int* len,
                            int* rounds, int nr, SweepShared* sh, int rank,
                            int cs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cnt = r.count();
  const int x = sum_scan(cnt);
  int off = x - cnt, total = __shfl_sync(FULL, x, 31);
  bool lead = lane == 0;
  if constexpr (LEVEL != LV_WARP) {
    if (lane == 31) sh->ws[warp] = x;
    __syncthreads();
    const int wv = lane < K12_WARPS ? sh->ws[lane] : 0;
    const int wi = sum_scan(wv);
    off += __shfl_sync(FULL, wi - wv, warp);
    total = __shfl_sync(FULL, wi, 31);
    lead = threadIdx.x == 0;
    if constexpr (LEVEL == LV_CLUSTER) {
      cg::cluster_group cluster = cg::this_cluster();
      if (warp == 0 && lane < cs)
        *cluster.map_shared_rank(&sh->bs[rank], lane) = total;
      cluster.sync();  // after it no block touches another's shared memory
      const int qv = lane < cs ? sh->bs[lane] : 0;
      const int qi = sum_scan(qv);
      off += __shfl_sync(FULL, qi - qv, rank);
      total = __shfl_sync(FULL, qi, 31);
      lead = lead && rank == 0;
    }
  }
  r.write(out + lo + off);
  if (lead) {
    *len = total;
    if (rounds != nullptr) *rounds = nr;
  }
}

// The whole lowest-rank loop over chunk c, ids[lo .. lo + L), by the group
// (a warp, a block or a cluster); this thread's P slots hold positions p0 ..
template <int LEVEL, class R>
__device__ void sweep_chunk(R& r, const int* __restrict__ ids, int lo,
                            int L, int p0, int P, const Cuckoo& ck,
                            const int* __restrict__ new_ids, int* out,
                            int* len, int* rounds, SweepShared* sh, int rank,
                            int cs) {
  r.init(ids, lo, L, p0, P, ck);
  int nr = 0;
  for (;;) {
    bool c = false;
    Next nb{-1, -1, RANK_INF, false};
    int z = 0;
    const int m = round_min<LEVEL>(r, new_ids, sh, nr, rank, cs, c, nb, z);
    if (m == RANK_INF) break;
    ++nr;
    // a thread that holds m has its new id; another may need it too (its
    // first token, its right-hand token), and waits only where it does
    if (r.lmin != m) z = __ldg(new_ids + m);
    r.apply(m, z, c, nb, ck);
    r.relook(ck);
  }
  write_chunk<LEVEL>(r, out, lo, len, rounds, nr, sh, rank, cs);
}

// One lane's chunk of n <= LANE_MAX tokens, ids[0 .. n), in registers: each
// token's key and new id, the loop, then the tokens to out and the count
// to *len.
__device__ void encode_lane(const int* __restrict__ ids, int n,
                            const Cuckoo& ck, int* out, int* len) {
  int tok[LANE_MAX], key[LANE_MAX], nid[LANE_MAX];
#pragma unroll
  for (int k = 0; k < LANE_MAX; ++k) tok[k] = k < n ? __ldg(ids + k) : -1;
  key[0] = RANK_INF;
  nid[0] = -1;
#pragma unroll
  for (int k = 1; k < LANE_MAX; ++k) {
    const int2 f = ck_find(ck, tok[k - 1], tok[k]);
    key[k] = f.x;
    nid[k] = f.y;
  }
  for (;;) {
    int m = RANK_INF, z = -1;
#pragma unroll
    for (int k = 1; k < LANE_MAX; ++k)
      if (key[k] < m) {
        m = key[k];
        z = nid[k];
      }
    if (m == RANK_INF) break;
    bool c = false;
    unsigned kill = 0, moved = 0, pbit = 0;
#pragma unroll
    for (int k = 0; k < LANE_MAX; ++k) {
      if (tok[k] < 0) continue;
      const bool kept = key[k] == m && !c;
      if (kept) {
        tok[k] = z;
        kill |= pbit;
        moved |= 1u << k;
      }
      c = kept;
      pbit = 1u << k;
    }
#pragma unroll
    for (int k = 0; k < LANE_MAX; ++k)
      if (kill >> k & 1u) {
        tok[k] = -1;
        key[k] = RANK_INF;
      }
    int lt = -1;
    bool after = false;
#pragma unroll
    for (int k = 0; k < LANE_MAX; ++k) {
      if (tok[k] < 0) continue;
      const bool mk = moved >> k & 1u;
      if (mk || after) {
        const int2 f = ck_find(ck, lt, tok[k]);
        key[k] = f.x;
        nid[k] = f.y;
      }
      after = mk;
      lt = tok[k];
    }
  }
  int o = 0;
#pragma unroll
  for (int k = 0; k < LANE_MAX; ++k)
    if (tok[k] >= 0) out[o++] = tok[k];
  *len = o;
}

// K11: the chunks which[0 .. S), chunk c being ids[bounds[c] ..
// bounds[c + 1]) with at most CHUNK_MAX tokens, its tokens written to
// out[bounds[c] ..] and their count to lens[c] (-1 for a longer chunk,
// which the wrapper never sends). The first `lanes` chunks go 32 to a warp:
// each lane its own chunk of at most LANE_MAX tokens, then the whole warp
// each longer one among them in turn; every later chunk has a warp of its
// own, 8 positions a lane in registers. A grid-stride over those units of
// work.
__global__ void __launch_bounds__(K11_WARPS * 32)
    chunk_encode_kernel(const int* __restrict__ ids,
                        const int* __restrict__ bounds,
                        const int* __restrict__ which, int S, int lanes,
                        Cuckoo ck, const int* __restrict__ new_ids,
                        int* __restrict__ out, int* __restrict__ lens) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int groups = (lanes + 31) / 32;
  for (int u = blockIdx.x * K11_WARPS + warp; u < groups + S - lanes;
       u += gridDim.x * K11_WARPS) {
    const int w = u < groups ? 32 * u + lane : lanes + u - groups;
    int c = -1, lo = 0, n = 0;
    if (w < (u < groups ? lanes : S)) {
      c = which[w];
      lo = bounds[c];
      n = bounds[c + 1] - lo;
    }
    if (u < groups && c >= 0 && n <= LANE_MAX)
      encode_lane(ids + lo, n, ck, out + lo, lens + c);
    for (unsigned big = __ballot_sync(
             FULL, c >= 0 && (u >= groups ? lane == 0 : n > LANE_MAX));
         big; big &= big - 1) {
      const int src = __ffs(big) - 1;
      const int cc = __shfl_sync(FULL, c, src);
      const int clo = __shfl_sync(FULL, lo, src);
      const int cn = __shfl_sync(FULL, n, src);
      if (cn > CHUNK_MAX) {
        if (lane == 0) lens[cc] = -1;
        continue;
      }
      RegRun<CHUNK_MAX / 32> r;
      sweep_chunk<LV_WARP>(r, ids, clo, cn, lane * (CHUNK_MAX / 32),
                           CHUNK_MAX / 32, ck, new_ids, out, lens + cc,
                           nullptr, nullptr, 0, 1);
    }
  }
}

// K12: block b's job is jobs[b] = (w, mode | S << 4, P, base): chunk
// which[w] (w < 0: an idle block); mode 0 the block alone, P (8, 16 or
// K12_P) slots a thread in registers, and 1 the whole cluster, P (16 or
// K12_P) slots a thread in registers; 2 the whole cluster, P = S *
// NS slots a thread in device memory at scratch + base * K12_BASE_UNIT
// (two ints a slot), its sub-ranges' summaries in shared memory (ns a
// thread, seven ints each). rounds (may be null): each chunk's rounds.
__global__ void __launch_bounds__(K12_TPB)
    encode_min_sweep_kernel(const int* __restrict__ ids,
                            const int* __restrict__ bounds,
                            const int* __restrict__ which,
                            const int4* __restrict__ jobs, Cuckoo ck,
                            const int* __restrict__ new_ids,
                            int* __restrict__ out, int* __restrict__ lens,
                            int* __restrict__ rounds, int* scratch, int ns) {
  extern __shared__ int sums[];
  __shared__ SweepShared sh;
  const int4 job = jobs[blockIdx.x];
  if (job.x < 0) return;
  const int c = which[job.x];
  const int lo = bounds[c], L = bounds[c + 1] - lo;
  const int mode = job.y & 15;
  int* const rd = rounds == nullptr ? nullptr : rounds + c;
  const int P = job.z;
  if (mode == 0) {  // the fewest slots a thread that hold the chunk
    if (P == 8) {
      RegRun<8> r;
      sweep_chunk<LV_BLOCK>(r, ids, lo, L, (int)threadIdx.x * 8, 8, ck,
                            new_ids, out, lens + c, rd, &sh, 0, 1);
    } else if (P == 16) {
      RegRun<16> r;
      sweep_chunk<LV_BLOCK>(r, ids, lo, L, (int)threadIdx.x * 16, 16, ck,
                            new_ids, out, lens + c, rd, &sh, 0, 1);
    } else {
      RegRun<K12_P> r;
      sweep_chunk<LV_BLOCK>(r, ids, lo, L, (int)threadIdx.x * K12_P, K12_P,
                            ck, new_ids, out, lens + c, rd, &sh, 0, 1);
    }
    return;
  }
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int cs = (int)cluster.num_blocks();
  const int g = rank * K12_TPB + (int)threadIdx.x;
  if (mode == 1) {  // 16 slots a thread, or K12_P where 16 do not hold it
    if (P == 16) {
      RegRun<16> r;
      sweep_chunk<LV_CLUSTER>(r, ids, lo, L, g * 16, 16, ck, new_ids, out,
                              lens + c, rd, &sh, rank, cs);
    } else {
      RegRun<K12_P> r;
      sweep_chunk<LV_CLUSTER>(r, ids, lo, L, g * K12_P, K12_P, ck, new_ids,
                              out, lens + c, rd, &sh, rank, cs);
    }
    return;
  }
  const int S = job.y >> 4;
  int* const tp = scratch + (size_t)job.w * K12_BASE_UNIT +
                  (size_t)rank * 2 * K12_TPB * P;
  MemRun r{tp + threadIdx.x, tp + (size_t)K12_TPB * P + threadIdx.x,
           sums + threadIdx.x, K12_TPB, S, P / S};
  sweep_chunk<LV_CLUSTER>(r, ids, lo, L, g * P, P, ck, new_ids, out,
                          lens + c, rd, &sh, rank, cs);
}

// ---------------------------------------------------------------------------
// K17 segment_encode: the dense route's encode of a stream cut into many
// segments (a pre-split text's chunks: no pair crosses one), each segment by
// minbpe's own loop (minbpe/regex.py:96-108): merge every occurrence of the
// segment's lowest-rank pair, left first, until it has none. It takes K10's
// input as it lies on the card (ids, seg and n, a segment being a maximal
// run of equal seg), so the host needs no chunk ends, and gives K10's
// output: the compacted (ids, seg) and their count, in one launch.
//
// No Pallas site: it replaces the dense route's use of
// fused_encode.py::_kernel (K10) on segmented streams. K10 applies every
// one of the table's M ranks to the whole stream in turn, each an
// apply-and-compact pass with block scans and, past one tile, grid
// barriers; a chunk of L tokens needs at most L - 1 rounds, and a GPT-4
// split's chunks are a few bytes (94% of the smoke corpus's at most 8).
//
// Bound: latency. Its bytes are few (8 B read a token, 8 B written an
// output token, a token's 4 B through the scratch), but a block's path is
// its segments' rounds, each a wait on the cuckoo probes (L2 hits: the
// rows of 256 merges take 16 KB, cl100k's 100,000 take 8 MB of the 50 MB
// L2) of the pairs it changed, then the decoupled look-back that places
// its output. So the work is spread as
// thin as the stream allows: a block owns SE_TILE positions, a warp 32 of
// them, and a segment belongs to the warp whose window holds its first
// token. From the start flags of its window and the next CHUNK_MAX
// positions, staged once, a lane takes its own segment of at most LANE_MAX
// tokens in registers (K11's encode_lane), the warp each segment of at most
// CHUNK_MAX in turn (K11's warp body, sweep_chunk at warp scope); a longer
// one, at most one a block (it outlasts the block's window), takes the
// whole block, K12's unit of a long chunk, round by round over its tokens
// in device memory (seg_sweep_long).
// Each segment's tokens go to tmp at its input offset; the block's count
// chains with those of the blocks before it by K4's look-back (blocks take
// their tiles in launch order by ticket, so a block waits only on blocks
// that run), and the block copies its tokens to their place.
// ---------------------------------------------------------------------------
constexpr int SE_TILE = TPB;                 // positions a K17 block owns
constexpr int SE_STAGE = SE_TILE + CHUNK_MAX;  // start flags staged a block
constexpr int SE_WORDS = SE_STAGE / 32;
static_assert(SE_STAGE % TPB == 0, "the flags are staged TPB at a time");

struct SegShared {
  unsigned starts[SE_WORDS];  // bit q - t0: a segment starts at q (q >= n too)
  int len[SE_TILE];  // the tokens of the segment starting at t0 + k, encoded
  int off[SE_TILE];  // their exclusive sums
  int lk, ll;        // the block's long segment: its lane (-1: none), tokens
  int prefix;
};

// q >= n counts as a segment start, so every segment ends at one
__device__ __forceinline__ bool seg_start(const int* __restrict__ seg, int q,
                                          int n) {
  return q >= n || q == 0 || __ldg(seg + q) != __ldg(seg + q - 1);
}

// The least of v over the block, in every thread.
__device__ int block_least(int v) {
  __shared__ int w[TPB / 32];
  v = __reduce_min_sync(FULL, v);
  __syncthreads();  // the previous call's readers are done
  if ((threadIdx.x & 31) == 0) w[threadIdx.x >> 5] = v;
  __syncthreads();
  int m = w[0];
#pragma unroll
  for (int i = 1; i < TPB / 32; ++i) m = min(m, w[i]);
  return m;
}

// The end of the segment that starts at lo and runs past q0: the first
// position from q0 on that is n or holds another seg. Block-wide.
__device__ int seg_end(const int* __restrict__ seg, int lo, int q0, int n) {
  const int v = __ldg(seg + lo);
  for (int base = q0;; base += TPB * IPT) {
    int f = INT32_MAX;
#pragma unroll
    for (int k = IPT - 1; k >= 0; --k) {
      const int q = base + k * TPB + (int)threadIdx.x;
      if (q >= n || __ldg(seg + q) != v) f = q;
    }
    f = block_least(f);
    if (f != INT32_MAX) return f;
  }
}

// A segment of L > CHUNK_MAX tokens, src[0 .. L) (sg[0 .. L) its seg, one
// value), by the whole block, its tokens in device memory: each round
// the least rank of its pairs, tile by tile, then that rank's merge
// applied left first and compacted into the other of a and b, tile by tile
// (K10's apply and compaction by one block over every tile in turn, the
// latest run start carried from tile to tile). The result is left in a;
// returns its count.
__device__ int seg_sweep_long(const int* src, const int* sg, int L,
                              const Cuckoo& ck,
                              const int* __restrict__ pairs,
                              const int* __restrict__ new_ids, int* a, int* b,
                              Stage& sh, int* o_ids) {
  int* dst = a;
  const int l0 = threadIdx.x * IPT;
  for (;;) {
    int m = RANK_INF;
    for (int t0 = 0; t0 < L; t0 += TILE) {
      stage_tile<true>(src, sg, t0, L, sh);
      int id[IPT + 1];
#pragma unroll
      for (int k = 0; k <= IPT; ++k) id[k] = staged_at(sh.ids, sh.halo_id, l0 + k);
#pragma unroll
      for (int k = 0; k < IPT; ++k)
        if (t0 + l0 + k + 1 < L) m = min(m, ck_find(ck, id[k], id[k + 1]).x);
    }
    m = block_least(m);
    if (m == RANK_INF) break;
    const int pa = pairs[2 * m], pb = pairs[2 * m + 1], z = new_ids[m];
    const bool homog = pa == pb;
    int rc = -1, off = 0;
    for (int t0 = 0; t0 < L; t0 += TILE) {
      stage_tile<true>(src, sg, t0, L, sh);
      const Lane x = lane_matches(sh, t0, L, pa, pb);
      int s[IPT];
#pragma unroll
      for (int k = 0; k < IPT; ++k) s[k] = -1;
      int tmax = -1;
      if (homog) run_starts(x, t0, s, &tmax);
      const unsigned kp = keep_mask(x, s, t0, homog, rc);
      const unsigned lv =
          valid_mask(t0, L) & ~dead_mask(sh, x, kp, t0, homog, rc);
      rc = max(rc, tmax);
      int tile_total;
      int o = block_exclusive_scan<true, TPB>(__popc(lv), &tile_total);
#pragma unroll
      for (int k = 0; k < IPT; ++k)
        if ((lv >> k) & 1u) o_ids[o++] = ((kp >> k) & 1u) ? z : x.id[k];
      __syncthreads();
      for (int q = threadIdx.x; q < tile_total; q += TPB) dst[off + q] = o_ids[q];
      off += tile_total;
      __syncthreads();  // o_ids is reused by the next tile
    }
    src = dst;
    dst = dst == a ? b : a;
    L = off;
  }
  if (src != a)
    for (int i = threadIdx.x; i < L; i += TPB) a[i] = __ldcg(src + i);
  __syncthreads();
  return L;
}

// K17: ids[0 .. n), seg[0 .. n) (n >= 1), a segment a maximal run of equal
// seg, each segment encoded by its own lowest-rank loop through the cuckoo
// table ck (pairs and new_ids: its merges by rank); the tokens, compacted in
// order, to ids_out and their segments' seg to seg_out, their count to
// *n_out. tmp: int32[n], each segment's tokens at its input offset before
// they are placed; ids_out also serves a long segment as the other half of
// its ping-pong (its output lies left of it, and the blocks after it write
// only once it is done). One block a tile of SE_TILE positions, taken by
// ticket; st and counter: the look-back state of K3 and K4.
__global__ void __launch_bounds__(TPB)
    segment_encode_kernel(const int* __restrict__ ids,
                          const int* __restrict__ seg, int n, Cuckoo ck,
                          const int* __restrict__ pairs,
                          const int* __restrict__ new_ids, int* tmp,
                          int* ids_out, int* __restrict__ seg_out,
                          int* __restrict__ n_out, unsigned long long* st,
                          unsigned* counter, unsigned gen) {
  __shared__ SegShared ss;
  __shared__ Stage stage;
  __shared__ int o_ids[TILE];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = tile_ticket(counter);
  const int t0 = t * SE_TILE;
#pragma unroll
  for (int h = 0; h < SE_STAGE / TPB; ++h) {
    const unsigned b =
        __ballot_sync(FULL, seg_start(seg, t0 + h * TPB + threadIdx.x, n));
    if (lane == 0) ss.starts[h * (TPB / 32) + warp] = b;
  }
  ss.len[threadIdx.x] = 0;
  if (threadIdx.x == 0) ss.lk = -1;
  __syncthreads();
  const int p = t0 + threadIdx.x;
  const bool own = p < n && (ss.starts[warp] >> lane & 1u);
  int L = 0;  // own: the segment's tokens, -1 past the staged flags
  if (own) {
    L = -1;
    for (int w = warp; w < SE_WORDS; ++w) {
      unsigned m = ss.starts[w];
      if (w == warp) m = lane == 31 ? 0u : m & (0xfffffffeu << lane);
      if (m) {
        L = 32 * w + __ffs(m) - 1 - (int)threadIdx.x;
        break;
      }
    }
  }
  if (own && L <= LANE_MAX && L >= 1)
    encode_lane(ids + p, L, ck, tmp + p, &ss.len[threadIdx.x]);
  for (unsigned big = __ballot_sync(FULL, own && L > LANE_MAX &&
                                              L <= CHUNK_MAX);
       big; big &= big - 1) {
    const int src = __ffs(big) - 1;
    RegRun<CHUNK_MAX / 32> r;
    sweep_chunk<LV_WARP>(r, ids, t0 + 32 * warp + src,
                         __shfl_sync(FULL, L, src), lane * (CHUNK_MAX / 32),
                         CHUNK_MAX / 32, ck, new_ids, tmp,
                         &ss.len[32 * warp + src], nullptr, nullptr, 0, 1);
  }
  if (own && (L < 0 || L > CHUNK_MAX)) {  // the tile's last start
    ss.lk = threadIdx.x;
    ss.ll = L;
  }
  __syncthreads();
  if (ss.lk >= 0) {
    const int lo = t0 + ss.lk;
    const int len =
        ss.ll > 0 ? ss.ll : seg_end(seg, lo, t0 + SE_STAGE, n) - lo;
    const int k = seg_sweep_long(ids + lo, seg + lo, len, ck, pairs, new_ids,
                                 tmp + lo, ids_out + lo, stage, o_ids);
    if (threadIdx.x == 0) ss.len[ss.lk] = k;
    __syncthreads();
  }
  int total;
  ss.off[threadIdx.x] =
      block_exclusive_scan<true, TPB>(ss.len[threadIdx.x], &total);
  if (threadIdx.x == 0)
    st_publish(st, t, gen, t == 0 ? ST_P : ST_A, total);
  if (threadIdx.x < 32) {
    const int pre = look_back<true>(st, t, gen);
    if (threadIdx.x == 0) {
      ss.prefix = pre;
      if (t > 0) st_publish(st, t, gen, ST_P, pre + total);
      if (t == (int)gridDim.x - 1) *n_out = pre + total;
    }
  }
  __syncthreads();
  const int pre = ss.prefix;
  for (int j = threadIdx.x; j < total; j += TPB) {
    int a = 0, b = SE_TILE - 1;  // the last segment whose tokens start <= j
    while (a < b) {
      const int mid = (a + b + 1) >> 1;
      if (ss.off[mid] <= j) a = mid;
      else b = mid - 1;
    }
    ids_out[pre + j] = tmp[t0 + a + j - ss.off[a]];
    seg_out[pre + j] = __ldg(seg + t0 + a);
  }
}

inline int tiles_for(int cap) { return cap > 0 ? (cap + TILE - 1) / TILE : 1; }

// K6's grid over a stream of cap positions on the current device: the
// blocks that fit at once (cached per device), capped at cap's tiles
cudaError_t batch_hist_grid(int cap, int* grid) {
  static std::atomic<int> resident[64];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms, per;
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per, batch_hist_kernel, TPB, 0);
    if (e != cudaSuccess) return e;
    if (per < 1) return cudaErrorInvalidConfiguration;
    resident[dev] = per * sms;
  }
  const int tiles = tiles_for(cap);
  *grid = resident[dev] < tiles ? (int)resident[dev] : tiles;
  return cudaSuccess;
}

// the counting core's kernels: K9, K1
enum HistKind { HIST_COUNT = 0, HIST_STATS = 1 };

inline size_t hist_smem_bytes(int kind, int log2) {
  return (size_t)(kind == HIST_STATS ? 12 : 8) << log2;
}

// K1's (kind 1) or K9's (0) table slots (*log2; 0 chooses the default) and
// grid (*grid; 0 chooses the blocks that fit at once, capped at cap's
// chunks) on the current device; the kernel's shared-memory allowance is
// set once per device.
cudaError_t hist_geometry(int kind, int cap, int* log2, int* grid) {
  static std::atomic<int> sms[64][2];
  static std::atomic<int> per_sm[64][2][HIST_LOG2_MAX + 1];
  if (kind < 0 || kind > 1) return cudaErrorInvalidValue;
  const void* fn = kind == HIST_STATS ? (const void*)pair_stats_kernel
                                      : (const void*)pair_count_kernel;
  if (*log2 == 0) *log2 = HIST_LOG2;
  if (*log2 < HIST_LOG2_MIN || *log2 > HIST_LOG2_MAX || *grid < 0)
    return cudaErrorInvalidValue;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev][kind] == 0) {
    int s;
    e = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)hist_smem_bytes(kind, HIST_LOG2_MAX));
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&s, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return e;
    sms[dev][kind] = s;
  }
  if (*grid == 0) {
    std::atomic<int>& per = per_sm[dev][kind][*log2];
    if (per == 0) {
      int p;
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &p, fn, TPB, hist_smem_bytes(kind, *log2));
      if (e != cudaSuccess) return e;
      if (p < 1) return cudaErrorInvalidConfiguration;
      per = p;
    }
    const int chunks = cap >= 2 ? (cap - 2) / TILE + 1 : 1;
    *grid = per * sms[dev][kind];
    if (*grid > chunks) *grid = chunks;
  }
  return cudaSuccess;
}

// K13's or K16's cooperative grid on the current device: the blocks that
// fit at once with the shared table (queried once per device; the
// allowance is set then too)
cudaError_t table_grid(const void* kernel, std::atomic<int>* resident,
                       int* grid) {
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int coop, sms, per;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)PS_SMEM);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, TPB,
                                                        PS_SMEM);
    if (e != cudaSuccess) return e;
    if (!coop || per < 1) return cudaErrorCooperativeLaunchTooLarge;
    resident[dev] = per * sms;
  }
  *grid = resident[dev];
  return cudaSuccess;
}

cudaError_t pair_select_grid(int* grid) {
  static std::atomic<int> resident[64];
  return table_grid((const void*)pair_select_kernel, resident, grid);
}

cudaError_t pair_summaries_grid(int* grid) {
  static std::atomic<int> resident[64];
  return table_grid((const void*)pair_summaries_kernel, resident, grid);
}

cudaError_t launch_summaries(int mode, const SummaryArgs& a, void* slots,
                             int* list, int* used, int tlog2,
                             unsigned long long* scratch, int grid,
                             void* stream) {
  if (tlog2 < PS_HASH_LOG2_MIN || tlog2 > 30) return cudaErrorInvalidValue;
  int resident;  // also sets the shared-memory allowance on this device
  const cudaError_t e = pair_summaries_grid(&resident);
  if (e != cudaSuccess) return e;
  DeviceTable t{reinterpret_cast<Slot*>(slots), list, used, tlog2};
  SummaryArgs args = a;
  void* params[] = {&mode, &args, &t, &scratch};
  const cudaError_t l = cudaLaunchCooperativeKernel(
      (const void*)pair_summaries_kernel, dim3(grid), dim3(TPB), params,
      PS_SMEM, (cudaStream_t)stream);
  if (l != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next
    return l;
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int bpe_tile_size() { return TILE; }

int bpe_segment_tile() { return SE_TILE; }

// K5's grid for V x V matrices: a warp per row; 0 for V outside 1 .. 1024
int bpe_select_blocks(int V) {
  return V < 1 || V > SEL_MAX_V ? 0 : (V + SEL_WARPS - 1) / SEL_WARPS;
}

// cnt, first: V x V; ctl may be null (W = V). log2: the table's slots,
// grid: the blocks; 0 chooses either (hist_geometry).
int bpe_pair_stats(const int* ids, const int* seg, const int* n,
                   const int* ctl, unsigned* cnt, unsigned* first, int V,
                   int cap, int log2, int grid, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e = hist_geometry(HIST_STATS, cap, &log2, &grid);
  if (e != cudaSuccess) return e;
  clear_stats_kernel<<<(V + TPB / 32 - 1) / (TPB / 32), TPB, 0, s>>>(
      ctl, cnt, first, V);
  pair_stats_kernel<<<grid, TPB, hist_smem_bytes(HIST_STATS, log2), s>>>(
      ids, seg, n, ctl, cnt, first, V, log2);
  return cudaGetLastError();
}

// cnt: V x V, overwritten; log2 and grid as for bpe_pair_stats
int bpe_pair_count(const int* ids, const int* seg, const int* n,
                   unsigned* cnt, int V, int cap, int log2, int grid,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = hist_geometry(HIST_COUNT, cap, &log2, &grid);
  if (e == cudaSuccess)
    e = cudaMemsetAsync(cnt, 0, (size_t)V * V * sizeof(unsigned), s);
  if (e != cudaSuccess) return e;
  pair_count_kernel<<<grid, TPB, hist_smem_bytes(HIST_COUNT, log2), s>>>(
      ids, seg, n, cnt, V, log2);
  return cudaGetLastError();
}

// The grid K1 (kind = 1) or K9 (0) would launch over cap positions with
// 1 << log2 table slots (0: the default) on the current device; a
// negative CUDA error where it has none.
int bpe_pair_hist_grid(int kind, int cap, int log2) {
  int grid = 0;
  const cudaError_t e = hist_geometry(kind, cap, &log2, &grid);
  return e == cudaSuccess ? grid : -(int)e;
}

// K13's cooperative grid on the current device (the same for every
// stream); a negative CUDA error where the device has none. Its scratch is
// uint64[2 * grid].
int bpe_pair_select_grid() {
  int grid = 0;
  const cudaError_t e = pair_select_grid(&grid);
  return e == cudaSuccess ? grid : -(int)e;
}

// K13: one sort-round round. The countable pairs of ids[0 .. *n) into the
// table of 1 << tlog2 slots (slots: 16 bytes each, 16-byte aligned, a
// uint64 key, all ones when empty, a uint32 count, zero, and a uint32 first
// position, 0xFFFFFFFF; list: int32; used: int32[1]; as the previous call
// leaves them), then the best into sel (int32[4]), log row i
// (pairs: int32[M][2], counts: int32[M]) and fail (int32[1]); the table is
// left empty. A round with *fail < i counts nothing and writes (-1, -1, 0,
// 0). grid: bpe_pair_select_grid()'s; a refused cooperative launch returns
// its error.
int bpe_pair_select(const int* ids, const int* seg, const int* n, int* fail,
                    int i, void* slots, int* list, int* used, int tlog2,
                    int* sel, int* pairs, int* counts,
                    unsigned long long* scratch, int grid, void* stream) {
  if (tlog2 < PS_HASH_LOG2_MIN || tlog2 > 30) return cudaErrorInvalidValue;
  int resident;  // also sets the shared-memory allowance on this device
  const cudaError_t e = pair_select_grid(&resident);
  if (e != cudaSuccess) return e;
  DeviceTable t{reinterpret_cast<Slot*>(slots), list, used, tlog2};
  void* args[] = {&ids, &seg, &n, &fail, &i, &t, &sel, &pairs, &counts,
                  &scratch};
  const cudaError_t l = cudaLaunchCooperativeKernel(
      (const void*)pair_select_kernel, dim3(grid), dim3(TPB), args, PS_SMEM,
      (cudaStream_t)stream);
  if (l != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next
    return l;
  }
  return cudaGetLastError();
}

// K16's cooperative grid on the current device; a negative CUDA error
// where the device has none. Its scratch is uint64[2 * grid].
int bpe_pair_summaries_grid() {
  int grid = 0;
  const cudaError_t e = pair_summaries_grid(&grid);
  return e == cudaSuccess ? grid : -(int)e;
}

// K16, count: the countable pairs of ids[0 .. *n) (the extended stream)
// into the empty table (slots, list, used, tlog2 as for bpe_pair_select),
// then its first cap distinct pairs as rows (a, b, count, first + base) of
// out (int32[cap][4], 16-byte aligned), *used_out = the rows written and
// *overflow = 1 where the stream holds more than cap distinct pairs; the
// table is left empty. grid: bpe_pair_summaries_grid()'s.
int bpe_pair_summaries(const int* ids, const int* seg, const int* n,
                       int base, void* slots, int* list, int* used,
                       int tlog2, int* out, int cap, int* used_out,
                       int* overflow, unsigned long long* scratch, int grid,
                       void* stream) {
  if (reinterpret_cast<uintptr_t>(out) & 15) return cudaErrorInvalidValue;
  SummaryArgs a{ids,     seg,      n,       base,    (int4*)out,
                cap,     used_out, overflow, nullptr, nullptr,
                0,       1,        nullptr};
  return launch_summaries(0, a, slots, list, used, tlog2, scratch, grid,
                          stream);
}

// K16, merge: nb blocks of bs rows (a, b, count, first) of rows
// (int32[nb * bs][4], 16-byte aligned), the first lens[j] of block j
// valid, merged pair by pair in the empty table; the champion (largest
// count, then earliest first) into champ (int32[4]); the table is left
// empty.
int bpe_pair_summaries_merge(const int* rows, const int* lens, int nb,
                             int bs, void* slots, int* list, int* used,
                             int tlog2, int* champ,
                             unsigned long long* scratch, int grid,
                             void* stream) {
  if (reinterpret_cast<uintptr_t>(rows) & 15) return cudaErrorInvalidValue;
  if (nb < 1 || bs < 1) return cudaErrorInvalidValue;
  SummaryArgs a{nullptr, nullptr, nullptr, 0,  nullptr,
                0,       nullptr, nullptr, (const int4*)rows,
                lens,    nb,      bs,      champ};
  return launch_summaries(1, a, slots, list, used, tlog2, scratch, grid,
                          stream);
}

// scratch: uint64[1 + 2 * bpe_select_blocks(V) * 16], zero before the
// first call (the last block leaves it zero again)
int bpe_select_batch(const unsigned* cnt, const unsigned* first, int V,
                     int* ctl, int* slot, int* log,
                     unsigned long long* scratch, void* stream) {
  const int nb = bpe_select_blocks(V);
  if (nb == 0) return cudaErrorInvalidValue;  // V > 1024
  select_batch_kernel<<<nb, TPB, 0, (cudaStream_t)stream>>>(
      cnt, first, V, ctl, slot, log, scratch);
  return cudaGetLastError();
}

// state: uint64[1 + tiles_for(cap)], zero before its first call: word 0
// holds the tile counter (each launch leaves it 0), then one status word
// per tile; gen: 1 .. 2^30 - 1, a new one per call on the state. kept may
// be null. With slot given: pair = slot, z and kept's row from the slot,
// kept = the merge log. carry_in (int32[1], may be null: 0) and gate, and
// tf (int32[2], may be null), as merge_apply_kernel takes them.
int bpe_merge_apply(const int* ids, const int* seg, const int* n,
                    const int* pair, int z, const int* slot, int cap,
                    int* ids_out, unsigned char* live, int* kept,
                    const int* carry_in, int gate, int* tf,
                    unsigned long long* state, int gen, void* stream) {
  merge_apply_kernel<<<tiles_for(cap), TPB, 0, (cudaStream_t)stream>>>(
      ids, seg, n, pair, z, slot, ids_out, live, kept, carry_in, gate, tf,
      state + 1, reinterpret_cast<unsigned*>(state), (unsigned)gen);
  return cudaGetLastError();
}

// cand: int32[cap], written at every p < n; acc: int32[2 * 128 * 16]
// (acc_l then acc_r), accumulated into
int bpe_batch_hist(const int* ids, const int* seg, const int* n,
                   const int* slot, int cap, int* cand, int* acc,
                   void* stream) {
  int grid;
  const cudaError_t e = batch_hist_grid(cap, &grid);
  if (e != cudaSuccess) return e;
  batch_hist_kernel<<<grid, TPB, 0, (cudaStream_t)stream>>>(ids, seg, n, slot,
                                                            cand, acc);
  return cudaGetLastError();
}

// acc: int32[2 * 128 * 16] (acc_l then acc_r), 16-byte aligned, cleared
// here; log: (M, 4); scratch: int32[1 + 16], zero before the first call
// (the last block leaves it zero again)
int bpe_batch_apply(const int* ids, const int* n, const int* cand, int* slot,
                    int* acc, int* ctl, int* log, int M, int cap,
                    int* ids_out, unsigned char* live, int* scratch,
                    void* stream) {
  if (reinterpret_cast<uintptr_t>(acc) & 15) return cudaErrorInvalidValue;
  const int tiles = tiles_for(cap);
  batch_apply_kernel<<<tiles < MAX_STAT_BLOCKS ? tiles : MAX_STAT_BLOCKS, TPB,
                       0, (cudaStream_t)stream>>>(
      ids, n, cand, slot, acc, ctl, log, M, ids_out, live, scratch);
  return cudaGetLastError();
}

// n_out: int32[1]; state and gen as for bpe_merge_apply
int bpe_compact(const int* ids, const int* seg, const unsigned char* live,
                const int* n, const int* slot, int cap, int* ids_out,
                int* seg_out, int* n_out, unsigned long long* state, int gen,
                void* stream) {
  compact_kernel<<<tiles_for(cap), TPB, 0, (cudaStream_t)stream>>>(
      ids, seg, live, n, slot, ids_out, seg_out, n_out, state + 1,
      reinterpret_cast<unsigned*>(state), (unsigned)gen);
  return cudaGetLastError();
}

// K10's grid for a stream of cap tokens on the current device: the blocks
// that can be resident at once, capped at the stream's tiles; a negative
// CUDA error when the device takes no cooperative launch.
int bpe_encode_grid(int cap) {
  int dev, coop, sms, per;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, encode_sweep_kernel, TPB, 0);
  if (e != cudaSuccess) return -(int)e;
  if (!coop || per < 1) return -(int)cudaErrorCooperativeLaunchTooLarge;
  const int tiles = tiles_for(cap);
  return per * sms < tiles ? per * sms : tiles;
}

// pairs: int32[M][2], new_ids: int32[M]; w_*: int32[max(n, 1)] each, 16-byte
// aligned; blk: int32[3 * grid]; n_out: int32[1]. The result is in w_ids0,
// w_seg0. A refused cooperative launch returns its error.
int bpe_encode_sweep(const int* ids, const int* seg, int n, const int* pairs,
                     const int* new_ids, int M, int* w_ids0, int* w_seg0,
                     int* w_ids1, int* w_seg1, int* blk, int grid,
                     int* n_out, void* stream) {
  void* args[] = {&ids,    &seg,    &n,      &pairs,  &new_ids, &M,
                  &w_ids0, &w_seg0, &w_ids1, &w_seg1, &blk,     &n_out};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)encode_sweep_kernel, dim3(grid), dim3(TPB), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next
    return e;
  }
  return cudaGetLastError();
}

// K11 over the chunks which[0 .. S) (S >= 1) of ids, chunk c being
// ids[bounds[c] .. bounds[c + 1]) with at most CHUNK_MAX tokens, the first
// `lanes` 32 to a warp (best those of at most LANE_MAX), every later one a
// warp of its own. rows: int32[2 H][4], 16-byte aligned, H a power of two;
// seeds s1 .. s4 as in ops/ranktab.py; new_ids: int32[M] by rank. Writes
// each chunk's tokens to out[bounds[c] ..] and their count to lens[c]. A
// grid-stride: at most the blocks that fit on the device at once.
int bpe_chunk_encode(const int* ids, const int* bounds, const int* which,
                     int S, int lanes, const int* rows, int H, unsigned s1,
                     unsigned s2, unsigned s3, unsigned s4,
                     const int* new_ids, int* out, int* lens, void* stream) {
  if (lanes < 0 || lanes > S) return cudaErrorInvalidValue;
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int warps = (lanes + 31) / 32 + S - lanes;
  const int want = (warps + K11_WARPS - 1) / K11_WARPS;
  const int most = sms * (2048 / (K11_WARPS * 32));
  const Cuckoo ck{reinterpret_cast<const int4*>(rows), H, s1, s2, s3, s4};
  chunk_encode_kernel<<<want < most ? want : most, K11_WARPS * 32, 0,
                        (cudaStream_t)stream>>>(ids, bounds, which, S, lanes,
                                                ck, new_ids, out, lens);
  return cudaGetLastError();
}

// K12 over the chunks of ids (chunk c: ids[bounds[c] .. bounds[c + 1])) that
// jobs names: int32[blocks][4], 16-byte aligned, one (w, mode | S << 4, P,
// base) a block (encode_min_sweep_kernel), `cluster` blocks a cluster
// (blocks a multiple of it). rows, H, the seeds and new_ids as for K11.
// Writes each chunk's tokens to out[bounds[c] ..], their count to lens[c]
// and, where rounds is not null, its rounds to rounds[c]. scratch: the
// device-memory tier's slots; ns: its sub-ranges a thread. A launch whose
// clusters cannot be resident returns its error (the cluster-size and
// shared-memory allowances are set once per device).
int bpe_encode_min_sweep(const int* ids, const int* bounds, const int* which,
                         const int* jobs, int blocks, int cluster,
                         const int* rows, int H, unsigned s1, unsigned s2,
                         unsigned s3, unsigned s4, const int* new_ids,
                         int* out, int* lens, int* rounds, int* scratch,
                         int ns, void* stream) {
  static std::atomic<int> allowed[64];
  if (blocks < 1 || cluster < 1 || blocks % cluster || ns < 1 ||
      ns > K12_NS_MAX || (reinterpret_cast<uintptr_t>(jobs) & 15))
    return cudaErrorInvalidValue;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (allowed[dev] == 0) {
    e = cudaFuncSetAttribute((const void*)encode_min_sweep_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute((const void*)encode_min_sweep_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               K12_SUM_BYTES * K12_NS_MAX);
    if (e != cudaSuccess) return e;
    allowed[dev] = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(K12_TPB);
  cfg.dynamicSmemBytes = K12_SUM_BYTES * (size_t)ns;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  int fit = 0;
  e = cudaOccupancyMaxActiveClusters(
      &fit, (const void*)encode_min_sweep_kernel, &cfg);
  if (e == cudaSuccess && fit < 1) e = cudaErrorInvalidConfiguration;
  if (e == cudaSuccess) {
    const Cuckoo ck{reinterpret_cast<const int4*>(rows), H, s1, s2, s3, s4};
    e = cudaLaunchKernelEx(&cfg, encode_min_sweep_kernel, ids, bounds, which,
                           reinterpret_cast<const int4*>(jobs), ck, new_ids,
                           out, lens, rounds, scratch, ns);
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next
    return e;
  }
  return cudaGetLastError();
}

// K17 over ids[0 .. n), seg[0 .. n), 1 <= n <= INT32_MAX - TILE. rows, H
// and the seeds as for K11; pairs: int32[M][2] and new_ids: int32[M], the
// merges by rank. tmp, ids_out, seg_out: int32[n]; n_out: int32[1]; state:
// word 0 the ticket counter, then a look-back word a tile of SE_TILE
// positions (K3's and K4's state). One launch, a block a tile.
int bpe_segment_encode(const int* ids, const int* seg, int n, const int* rows,
                       int H, unsigned s1, unsigned s2, unsigned s3,
                       unsigned s4, const int* pairs, const int* new_ids,
                       int* tmp, int* ids_out, int* seg_out, int* n_out,
                       unsigned long long* state, int gen, void* stream) {
  if (n < 1 || n > INT32_MAX - TILE) return cudaErrorInvalidValue;
  const Cuckoo ck{reinterpret_cast<const int4*>(rows), H, s1, s2, s3, s4};
  segment_encode_kernel<<<(n + SE_TILE - 1) / SE_TILE, TPB, 0,
                          (cudaStream_t)stream>>>(
      ids, seg, n, ck, pairs, new_ids, tmp, ids_out, seg_out, n_out,
      state + 1, reinterpret_cast<unsigned*>(state), (unsigned)gen);
  return cudaGetLastError();
}

}  // extern "C"

// ===========================================================================
// K15 presplit: the GPT-2 / GPT-4 pre-split of a UTF-8 byte stream on the
// card (sm_90a), as two cooperative launches:
//
//   K15 presplit_succ   every char start p's successor f(p): the byte where
//                       the chunk that would start at p ends
//   K15 presplit_orbit  the chunk starts {0, f(0), f(f(0)), ...}, as
//                       per-byte boundary flags and segment ids
//
// or, for a stream of at most C_MAX tiles (32 KB), as one:
//
//   K15 presplit_cluster both, in one launch of one thread-block cluster
//
// They replace minbpe_tpu/ops/device_presplit.py::_presplit_device (:208),
// a jitted jnp program with no Pallas site: its UTF-8 decode (_decode_utf8,
// :74-90), class lookup (_char_flags, :93-98), successor (_successor,
// :117-205) and orbit by pointer doubling (_orbit, :101-114). Its output
// feeds K10 encode_sweep (fused_encode.py::_kernel) through the segment ids.
//
// Bound: bytes. The function reads the n bytes and the 64 KB class table
// and writes 4 n of segment ids and n of boundaries. The design moves
// about 18 n: presplit_succ reads the bytes (and a block's first tile
// again) and writes 4 n of successors; presplit_orbit reads them once,
// keeps 4 n of exit records in the segment-id buffer and n / 8 of trunk
// bits until step 4, and writes the boundaries and the ids.
//
// Both kernels cut the stream into tiles of 4,096 bytes on a cooperative
// grid. No loop that one thread, warp or block runs has a trip count that
// grows with the number of tiles on text: a block's loop over its own
// tiles is its share of the work, and what crosses blocks is one record a
// block (bounded by the grid, a constant of the card) or a doubling of
// depth log2 of the nodes.
//
// K15 presplit_succ works in bytes, not chars: the next char is p + len(p),
// the length read from the lead byte, so the contraction tests, \p{N}{1,3}
// and the optional space prefixes read at most three chars ahead. Every
// other look-ahead of the two patterns is the end of a class run:
//   C1, C2  the first and second coarse class change after p (classes L,
//           N, O = [^\s\p{L}\p{N}], whitespace); C1 ends p's run, C2 the
//           run after it, which is the letter run of a prefixed [^\r\n
//           \p{L}\p{N}]?+\p{L}+ and the run after GPT-2's optional space;
//   O1, O2  the same for GPT-4's [^\s\p{L}\p{N}]++[\r\n]*: the break after
//           an O run and the CR/LF run that follows it (the second, after
//           a leading space);
//   LCR     the last CR/LF in [p, end of p's whitespace run), -1 if none
//           (\s*[\r\n] ends after it).
// These are an associative aggregate of the bytes to the right (Agg). Each
// block owns a contiguous range of tiles. It stages a tile and 16 bytes
// either side in shared memory with 16-byte loads (the next tile's load in
// flight meanwhile) and classifies every byte there once (an ASCII chunk
// of 16 by table); the aggregates, the successors and the look-aheads read
// that. Before the one grid barrier each block combines its tiles'
// aggregates from the left and stops at the first saturated one (two
// breaks of each kind and a byte that is not whitespace: nothing to its
// right changes it), in text its first tile; after it, a warp combines the
// later blocks' aggregates 32 at a time until one saturates, in text the
// next block's, and the block walks its tiles from the right, each tile's
// carry its right neighbour's aggregate combined with that one's carry.
// Worst case (a run without breaks across the whole stream): phase 1
// reads a block's whole range and the look-right reads every later
// block's record, at most ceil(grid / 32) rounds of a warp.
//
// K15 presplit_orbit, in four steps split by two grid barriers:
//   1. each tile resolves by pointer doubling in shared memory (at most 12
//      rounds, each byte's word its walk's next byte and hops, the next
//      tile's successors loading meanwhile) where the walk from each of its
//      bytes leaves the tile (its exit) and how many chunk starts it makes
//      there, and marks the walk from its first char start, its trunk
//      (written as bits); where the walks leave at more than one exit it
//      dedupes them in a shared-memory hash (a char start inserts unless
//      the byte before it has its exit); it lists them (the tile's nodes,
//      in text one, at most two) and writes at each byte the index of its
//      exit in that list and its count (into seg);
//   2. the node graph: node (u, k), an exit of tile u landing on byte e of
//      tile w, leads to node (w, index at e). The path from byte 0's exit
//      is marked by doubling over the nodes, ceil(log2(nodes + 1)) rounds:
//      in block 0's shared memory while the tiles and the nodes number at
//      most 4,096 (the XL corpus has 3,108 nodes), else over the whole
//      grid with a grid barrier a round (at most 31). Each node on the path
//      is the entry of its tile and adds its count to its tile's block;
//   3. each block sums the chunk starts of the blocks before it;
//   4. each tile follows the walk from its entry, at most 16 hops, until it
//      meets the trunk (in text at once: the entry is the end of the chunk
//      that crosses into the tile, and so is the trunk's first jump), then
//      takes the trunk from there; a walk that does neither is marked by
//      doubling from the entry (inside a long digit run, where the walks
//      of the three residues never meet). A block counts its tiles'
//      boundaries into segment ids from its running count.
// A tile may list any number of exits up to its bytes, so there is no cap
// and no slow case but the doubling of step 4: a general forward f gives
// more nodes and more rounds.
//
// K15 presplit_cluster. On one document of a few KB the pair is bound by
// latency, not bytes (PERF.md §5): one SM runs each tile's serial work
// (a thread's 16 successors, 12 doubling rounds, the path's chains of
// device-memory loads) twice staged, behind two launches and four grid
// barriers. The cluster tier runs one cluster of up to C_MAX CTAs, CTA r
// the tile of T bytes at r * T, T the least of 512 to 4,096 whose C_MAX
// tiles hold the stream (ops/device_presplit.cluster_geometry), 4 bytes a
// thread up to 512 threads; so a 2 KB document spreads over 4 SMs. Each
// CTA stages and classifies its tile once and scans it; after a cluster
// barrier it combines the later CTAs' tile aggregates, read from their
// shared memory, into its carry and computes its successors into shared
// memory (presplit_succ's phase 3); it resolves its walks there by
// doubling (presplit_orbit's step 1, without the node lists); after a
// second barrier CTA 0 follows the path from byte 0 over the tiles, one
// distributed-shared-memory load a hop (at most C_MAX), and writes each
// CTA's entry and chunk starts before it into that CTA's shared memory;
// after a third each CTA marks the walk from its entry (presplit_orbit's
// step 4) and writes its boundaries and segment ids, the only writes to
// device memory. No scratch in device memory, no grid barrier.
// ===========================================================================

namespace {
namespace presplit {

// class flags of data/unicode_tables.npz (utils/presplit.py)
constexpr int FLAG_L = 1;
constexpr int FLAG_N = 2;
constexpr int FLAG_WS = 4;
constexpr int FLAG_C1 = 8;
constexpr int FLAG_CI_L = 16;
constexpr int FLAG_CI_V = 32;
constexpr int FLAG_CI_E = 64;
constexpr int FLAG_CI_R = 128;

// the class of a byte's char: letter, number, other ([^\s\p{L}\p{N}]),
// whitespace other than CR/LF, CR/LF
constexpr int CL_L = 0;
constexpr int CL_N = 1;
constexpr int CL_O = 2;
constexpr int CL_WS = 3;
constexpr int CL_CR = 4;

constexpr int BIG = 0x7FFFFFFF;
constexpr int TILE = 4096;             // bytes a tile, both kernels

constexpr int S_TPB = 256;             // K15 presplit_succ: threads a block
constexpr int S_BPT = 16;              // consecutive bytes a thread
constexpr int S_HALO = 16;             // bytes staged either side of a tile
constexpr int S_WIN = TILE + 2 * S_HALO;
constexpr int S_AGG = 6;               // ints of an aggregate
static_assert(S_TPB * S_BPT == TILE, "a thread's bytes tile the tile");

constexpr int O_TPB = 512;             // K15 presplit_orbit
constexpr int O_PER = 8;
constexpr int O_ROUNDS = 12;           // 2^12 >= the hops of a walk
constexpr int O_BLOCK_NODES = 4096;    // the node graph's one-block tier
constexpr int O_OWN = O_BLOCK_NODES / O_TPB;  // its tiles a thread
constexpr int O_WALK = 16;             // hops of an entry to its trunk
constexpr int O_CHUNK = 64;            // tiles whose trunks step 4 loads
static_assert(O_CHUNK * (TILE / 32) <= 2 * TILE, "in step 1's word buffers");
constexpr unsigned ND_NONE = 0xFFFFu;  // exit index of a byte off a start
static_assert(O_TPB * O_PER == TILE, "a block's bytes tile the tile");
static_assert(O_PER == 8, "step 4 moves a thread's bytes as 8 and 2 x 16");
// step 1: two word buffers, the roots' exits and the trunk's marks; step
// 2 in one block: each tile's first node, the next nodes twice, the marks
constexpr int O_SMEM = 3 * O_BLOCK_NODES * (int)sizeof(int) + O_BLOCK_NODES;
static_assert(O_SMEM >= 3 * TILE * (int)sizeof(int) + TILE,
              "step 1 fits the shared memory of step 2");

constexpr int C_MAX = 8;               // K15 presplit_cluster: CTAs, tiles
constexpr int C_MIN_TILE = 512;        // its least tile
// presplit_cluster's threads a CTA on tiles of T bytes: 4 bytes a thread,
// at most 512 threads
__host__ __device__ constexpr int c_tpb(int T) {
  return T / 4 < 512 ? T / 4 : 512;
}

// Phase stamps for scripts/profile_presplit.py: built with
// -DPRESPLIT_STAMPS, thread 0 of block 0 of each K15 kernel (kind 0
// presplit_succ, 1 presplit_orbit, 2 presplit_cluster) writes the SM clock
// and the global timer (ns) at the end of its phase k into
// presplit_stamps[kind][k]; built without, the stamps are no code.
constexpr int STAMPS = 16;
__device__ long long presplit_stamps[3][STAMPS][2];
#ifdef PRESPLIT_STAMPS
#define PRESPLIT_STAMP(kind, k)                                          \
  do {                                                                   \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                           \
      long long g_;                                                      \
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(g_));             \
      presplit_stamps[kind][k][0] = clock64();                           \
      presplit_stamps[kind][k][1] = g_;                                  \
    }                                                                    \
  } while (0)
#else
#define PRESPLIT_STAMP(kind, k) ((void)0)
#endif

struct Tables {
  const uint8_t* dense;  // flags of each BMP code point
  const int* starts;     // range starts over [0, 0x110000), ascending
  const uint8_t* flags;  // their flags
  int nstarts;
};

__device__ __forceinline__ bool lead(int b) { return (b & 0xC0) != 0x80; }

__device__ __forceinline__ int utf8_len(int b) {
  return b < 0x80 ? 1 : (b & 0xE0) == 0xC0 ? 2 : (b & 0xF0) == 0xE0 ? 3 : 4;
}

__device__ __forceinline__ int flags_of(const Tables& t, int cp) {
  if (cp < 0x10000) return __ldg(t.dense + cp);
  int lo = 0, hi = t.nstarts - 1;  // the last start <= cp (starts[0] = 0)
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (__ldg(t.starts + mid) <= cp) lo = mid;
    else hi = mid - 1;
  }
  return __ldg(t.flags + lo);
}

__device__ __forceinline__ int class_of(int fl, int cp) {
  return (fl & FLAG_L)    ? CL_L
       : (fl & FLAG_N)    ? CL_N
       : (fl & FLAG_WS)   ? ((cp == 10 || cp == 13) ? CL_CR : CL_WS)
                          : CL_O;
}

__device__ __forceinline__ int coarse(int c) { return c == CL_CR ? CL_WS : c; }

// a GPT-4 [^\s\p{L}\p{N}]++[\r\n]* span goes on from a char of class prev
// to one of class cur
__device__ __forceinline__ bool o_goes_on(int prev, int cur) {
  return (prev == CL_O && (cur == CL_O || cur == CL_CR)) ||
         (prev == CL_CR && cur == CL_CR);
}

// the start of the char that holds byte q (valid UTF-8: at most 3 back)
__device__ __forceinline__ int char_start(const uint8_t* d, int q) {
  for (int k = 0; k < 3 && q > 0 && !lead(__ldg(d + q)); ++k) --q;
  return q;
}

// the contiguous tiles [lo, hi) of this block (gridDim.x <= tiles)
__device__ __forceinline__ void block_range(int tiles, int& lo, int& hi) {
  lo = (int)((long long)blockIdx.x * tiles / gridDim.x);
  hi = (int)((long long)(blockIdx.x + 1) * tiles / gridDim.x);
}

// the block that owns tile w
__device__ __forceinline__ int owner(int w, int tiles) {
  return (int)((((long long)w + 1) * gridDim.x - 1) / tiles);
}

// ---------------------------------------------------------------------------
// K15 presplit_succ
// ---------------------------------------------------------------------------

// A byte's info word: its char's class (bits 0-2), whether it starts the
// char (bit 3), the char's length (bits 4-6) and flags (bits 8-15), the
// last two at a start only.
constexpr int I_START = 8;
__device__ __forceinline__ int i_cls(int w) { return w & 7; }
__device__ __forceinline__ bool i_start(int w) { return (w & I_START) != 0; }
__device__ __forceinline__ int i_len(int w) { return (w >> 4) & 7; }
__device__ __forceinline__ int i_fl(int w) { return w >> 8; }

__device__ __forceinline__ int info_word(int cp, int len, const Tables& t) {
  const int fl = flags_of(t, cp);
  return class_of(fl, cp) | I_START | (len << 4) | (fl << 8);
}

// The aggregate of a range of bytes: its least two breaks of each kind
// (c1 <= c2, o1 <= o2; BIG where absent); lr: whether it holds a byte that
// is not whitespace; lc: the last CR/LF before that byte (any, if lr is 0),
// -1 if none. As a state at position q (the aggregate of everything from q
// on, text end included): the breaks after q and LCR(q) = lc.
struct Agg {
  int c1, c2, o1, o2, lr, lc;
};

__device__ __forceinline__ Agg agg_identity() {
  return {BIG, BIG, BIG, BIG, 0, -1};
}

// a: the range to the left of b's
__device__ __forceinline__ Agg agg_combine(const Agg& a, const Agg& b) {
  Agg r;
  r.c1 = min(a.c1, b.c1);
  r.c2 = min(max(a.c1, b.c1), min(a.c2, b.c2));
  r.o1 = min(a.o1, b.o1);
  r.o2 = min(max(a.o1, b.o1), min(a.o2, b.o2));
  r.lr = a.lr | b.lr;
  r.lc = a.lr ? a.lc : (b.lc >= 0 ? b.lc : a.lc);
  return r;
}

// nothing to the right of a saturated aggregate changes a combine with it:
// its breaks lie left of any other's, and its lc is its own
__device__ __forceinline__ bool agg_saturated(const Agg& a) {
  return a.c2 != BIG && a.o2 != BIG && a.lr;
}

__device__ __forceinline__ Agg agg_shfl_up(const Agg& a, int d) {
  return {__shfl_up_sync(0xFFFFFFFFu, a.c1, d),
          __shfl_up_sync(0xFFFFFFFFu, a.c2, d),
          __shfl_up_sync(0xFFFFFFFFu, a.o1, d),
          __shfl_up_sync(0xFFFFFFFFu, a.o2, d),
          __shfl_up_sync(0xFFFFFFFFu, a.lr, d),
          __shfl_up_sync(0xFFFFFFFFu, a.lc, d)};
}

__device__ __forceinline__ Agg agg_shfl(const Agg& a, int lane) {
  return {__shfl_sync(0xFFFFFFFFu, a.c1, lane),
          __shfl_sync(0xFFFFFFFFu, a.c2, lane),
          __shfl_sync(0xFFFFFFFFu, a.o1, lane),
          __shfl_sync(0xFFFFFFFFu, a.o2, lane),
          __shfl_sync(0xFFFFFFFFu, a.lr, lane),
          __shfl_sync(0xFFFFFFFFu, a.lc, lane)};
}

__device__ __forceinline__ void agg_store(int* p, const Agg& g) {
  p[0] = g.c1; p[1] = g.c2; p[2] = g.o1; p[3] = g.o2; p[4] = g.lr;
  p[5] = g.lc;
}

__device__ __forceinline__ Agg agg_load(const int* p) {
  return {__ldcg(p), __ldcg(p + 1), __ldcg(p + 2), __ldcg(p + 3),
          __ldcg(p + 4), __ldcg(p + 5)};
}

struct SuccSmem {
  alignas(16) uint8_t buf[S_WIN];   // the tile's bytes, 16 either side
  unsigned short info[S_WIN];       // their info words
  unsigned short ascii[128];        // the info word of each ASCII char
  alignas(16) int fbuf[TILE];       // the tile's successors
  Agg wagg[S_TPB / 32];             // block_rscan's warp aggregates
  Agg carry;
  int flag;
};

// a thread's 16-byte chunks of the staged window (WIN bytes) of the tile
// at s, in a block of TPB threads: chunk threadIdx.x, then chunk TPB +
// threadIdx.x, ... where the window has it (bytes outside [0, n) read as 0)
constexpr int S_CHUNKS = (S_WIN / 16 + S_TPB - 1) / S_TPB;

template <int TPB, int WIN, int CH>
__device__ __forceinline__ void fetch(uint4 (&v)[CH],
                                      const uint8_t* __restrict__ d, int n,
                                      long long s, bool vec) {
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = threadIdx.x + c * TPB;
    const long long q = s - S_HALO + 16 * i;
    if (i >= WIN / 16) continue;
    if (vec && q >= 0 && q + 16 <= n) {
      v[c] = __ldg(reinterpret_cast<const uint4*>(d + q));
    } else {
      uint8_t* const b = reinterpret_cast<uint8_t*>(&v[c]);
#pragma unroll
      for (int j = 0; j < 16; ++j)
        b[j] = (q + j >= 0 && q + j < n) ? __ldg(d + q + j) : 0;
    }
  }
}

// Stage the fetched window into S.buf and classify every byte once: a
// thread takes U (16 or 4) bytes at a time, by table where all are ASCII;
// a continuation byte takes its char's class, its lead decoded again where
// it lies before the thread's bytes.
template <int TPB, int U, class Smem, int CH>
__device__ void stage(Smem& S, const uint4 (&v)[CH], const Tables& t) {
  constexpr int WIN = (int)sizeof(Smem::buf);
  static_assert(U == 16 || U == 4, "a unit of 16 or 4 bytes");
#pragma unroll
  for (int c = 0; c < CH; ++c) {
    const int i = threadIdx.x + c * TPB;
    if (i < WIN / 16) *reinterpret_cast<uint4*>(S.buf + 16 * i) = v[c];
  }
  __syncthreads();
  for (int i = threadIdx.x; i < WIN / U; i += TPB) {
    const int w0 = U * i;
    unsigned high;
    if constexpr (U == 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(S.buf + w0);
      high = (v.x | v.y | v.z | v.w) & 0x80808080u;
    } else {
      high = *reinterpret_cast<const unsigned*>(S.buf + w0) & 0x80808080u;
    }
    if (high == 0) {
#pragma unroll
      for (int j = 0; j < U; ++j) S.info[w0 + j] = S.ascii[S.buf[w0 + j]];
      continue;
    }
    // the class of the char that holds the byte before this run
    int cls = CL_O;
    if (!lead(S.buf[w0]) && w0 >= 3) {
      int q = w0 - 1;
      while (q > w0 - 3 && !lead(S.buf[q])) --q;
      const int b = S.buf[q];
      const int len = utf8_len(b);
      int cp = len == 1 ? b : b & (0x7F >> len);
      for (int k = 1; k < len; ++k)
        cp = (cp << 6) | (q + k < WIN ? S.buf[q + k] & 0x3F : 0);
      cls = class_of(flags_of(t, cp), cp);
    }
    for (int j = 0; j < U; ++j) {
      const int w = w0 + j;
      const int b = S.buf[w];
      int word;
      if (b < 0x80) {
        word = S.ascii[b];
      } else if (lead(b)) {
        const int len = utf8_len(b);
        int cp = b & (0x7F >> len);
        for (int k = 1; k < len; ++k)
          cp = (cp << 6) | (w + k < WIN ? S.buf[w + k] & 0x3F : 0);
        word = info_word(cp, len, t);
      } else {
        word = cls;
      }
      cls = i_cls(word);
      S.info[w] = (unsigned short)word;
    }
  }
  __syncthreads();
}

// A thread's S_BPT bytes [a, a + cnt): the class of each byte's char (3 bits
// a byte), the char starts, and where a coarse class or an O span breaks
// (bit j: between bytes a + j - 1 and a + j).
struct Seg {
  unsigned long long cls;
  unsigned starts, brk_c, brk_o;
};

template <class Smem>
__device__ __forceinline__ Seg seg_of(const Smem& S, long long a, int w0,
                                      int cnt) {
  Seg s{0ull, 0u, 0u, 0u};
  int prev = a > 0 ? i_cls(S.info[w0 - 1]) : -1;
  for (int j = 0; j < cnt; ++j) {
    const int w = S.info[w0 + j];
    const int c = i_cls(w);
    if (i_start(w)) {
      s.starts |= 1u << j;
      if (prev >= 0) {
        if (coarse(prev) != coarse(c)) s.brk_c |= 1u << j;
        if (!o_goes_on(prev, c)) s.brk_o |= 1u << j;
      }
    }
    s.cls |= (unsigned long long)c << (3 * j);
    prev = c;
  }
  return s;
}

__device__ __forceinline__ int cls_of(const Seg& s, int j) {
  return (int)((s.cls >> (3 * j)) & 7);
}

__device__ Agg seg_agg(const Seg& s, long long a, int cnt) {
  Agg g = agg_identity();
  unsigned m = s.brk_c;
  if (m) {
    g.c1 = (int)a + __ffs(m) - 1;
    m &= m - 1;
    if (m) g.c2 = (int)a + __ffs(m) - 1;
  }
  m = s.brk_o;
  if (m) {
    g.o1 = (int)a + __ffs(m) - 1;
    m &= m - 1;
    if (m) g.o2 = (int)a + __ffs(m) - 1;
  }
  for (int j = cnt - 1; j >= 0; --j) {
    const int c = cls_of(s, j);
    if (coarse(c) != CL_WS) {
      g.lr = 1;
      g.lc = -1;
    } else if (g.lc < 0 && c == CL_CR) {
      g.lc = (int)a + j;
    }
  }
  return g;
}

__device__ __forceinline__ Agg agg_shfl_down(const Agg& a, int d) {
  return {__shfl_down_sync(0xFFFFFFFFu, a.c1, d),
          __shfl_down_sync(0xFFFFFFFFu, a.c2, d),
          __shfl_down_sync(0xFFFFFFFFu, a.o1, d),
          __shfl_down_sync(0xFFFFFFFFu, a.o2, d),
          __shfl_down_sync(0xFFFFFFFFu, a.lr, d),
          __shfl_down_sync(0xFFFFFFFFu, a.lc, d)};
}

// Scan from the right over the block's TPB threads, by warp shuffles and
// one exchange of the warps' aggregates: returns the aggregate of the
// threads after this one, and the block's in total.
template <int TPB>
__device__ Agg block_rscan(Agg* wagg, const Agg& g, Agg& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  Agg v = g;
#pragma unroll
  for (int dist = 1; dist < 32; dist <<= 1) {
    const Agg o = agg_shfl_down(v, dist);
    if (lane + dist < 32) v = agg_combine(v, o);
  }
  Agg after = agg_shfl_down(v, 1);
  if (lane == 31) after = agg_identity();
  __syncthreads();  // the last call's readers are done with wagg
  if (lane == 0) wagg[warp] = v;
  __syncthreads();
  Agg later = agg_identity();
  for (int w = TPB / 32 - 1; w > warp; --w)
    later = agg_combine(wagg[w], later);
  total = later;
  for (int w = warp; w >= 0; --w) total = agg_combine(wagg[w], total);
  return agg_combine(after, later);
}

// f(p): where the chunk that starts at char start p < n ends, p's class
// cls, the breaks after p and LCR(p) given (utils/presplit.py's
// alternatives in order). The staged window starts at byte wb; every
// look-ahead but the last whitespace char's start lies in it.
template <class Smem>
__device__ int successor(const Smem& S, long long wb,
                         const uint8_t* __restrict__ d, int n, int mode,
                         int p, int cls, int c1, int c2, int o1, int o2,
                         int lcr) {
  const int wp = (int)(p - wb);
  const int byte = S.buf[wp];
  const int p1 = p + i_len(S.info[wp]);
  const bool v1 = p1 < n;
  const int n1 = v1 ? S.info[p1 - wb] : 0;
  const int n1cls = v1 ? i_cls(n1) : -1;
  const int p2 = p1 + (v1 ? i_len(n1) : 1);
  if (mode == 4) {
    // '(?i:[sdmt]|ll|ve|re): the case-folding flags, never ASCII
    if (byte == 39 && v1) {
      const int f1 = i_fl(n1);
      if (f1 & FLAG_C1) return p2;
      if (p2 < n) {
        const int n2 = S.info[p2 - wb];
        const int f2 = i_fl(n2);
        if (((f1 & FLAG_CI_L) && (f2 & FLAG_CI_L)) ||
            ((f1 & FLAG_CI_V) && (f2 & FLAG_CI_E)) ||
            ((f1 & FLAG_CI_R) && (f2 & FLAG_CI_E)))
          return p2 + i_len(n2);
      }
    }
    // [^\r\n\p{L}\p{N}]?+\p{L}+
    if (cls == CL_L) return c1;
    if (cls != CL_N && cls != CL_CR && n1cls == CL_L) return c2;
    // \p{N}{1,3}
    if (cls == CL_N) {
      if (p1 < c1 && p2 < c1) return p2 + i_len(S.info[p2 - wb]);
      return c1;
    }
    // " "?[^\s\p{L}\p{N}]++[\r\n]*
    const bool sp = byte == 32 && v1;
    if ((sp ? n1cls : cls) == CL_O) return sp ? o2 : o1;
    // \s*[\r\n] | \s+(?!\S) | \s+ (every other char is whitespace)
    if (lcr >= 0) return lcr + 1;
  } else {
    // '(?:[sdmt]|ll|ve|re): exact code points, ASCII lead bytes
    if (byte == 39 && v1) {
      const int a = S.buf[p1 - wb];
      if (a == 's' || a == 'd' || a == 'm' || a == 't') return p2;
      if (p2 < n) {
        const int b = S.buf[p2 - wb];
        if ((a == 'l' && b == 'l') || (a == 'v' && b == 'e') ||
            (a == 'r' && b == 'e'))
          return p2 + 1;
      }
    }
    // " "?\p{L}+ | " "?\p{N}+ | " "?[^\s\p{L}\p{N}]+
    if (byte == 32) {
      if (v1 && coarse(n1cls) != CL_WS) return c2;
    } else if (coarse(cls) != CL_WS) {
      return c1;
    }
  }
  // \s+(?!\S) | \s+: the whole run at the text's end, else all but its last
  // char when it has two or more, else the one char
  if (c1 >= n) return c1;
  if (p1 < c1) {
    int q = c1 - 1;
    const long long wq = q - wb;
    if (wq >= 3 && wq < (long long)sizeof(Smem::buf)) {
      while (!i_start(S.info[q - wb])) --q;
      return q;
    }
    return char_start(d, q);
  }
  return c1;
}

// grid: cooperative (every block resident), at most the tiles. f: int32[n]
// (the successor at each char start, -1 elsewhere); agg: int32[S_AGG *
// gridDim.x], each block's aggregate (its tiles' from the left, up to the
// first saturated one).
__global__ void __launch_bounds__(S_TPB)
presplit_succ_kernel(const uint8_t* __restrict__ d, int n, int mode,
                     Tables t, int* __restrict__ f, int* agg) {
  cg::grid_group grid = cg::this_grid();
  __shared__ SuccSmem S;
  PRESPLIT_STAMP(0, 0);
  const int tiles = (int)(((long long)n + TILE - 1) / TILE);
  const bool vec = (reinterpret_cast<uintptr_t>(d) & 15) == 0;
  int lo, hi;
  block_range(tiles, lo, hi);
  if (threadIdx.x < 128) S.ascii[threadIdx.x] = (unsigned short)info_word(
      threadIdx.x, 1, t);
  __syncthreads();
  PRESPLIT_STAMP(0, 1);

  // 1. the block's aggregate, from the left up to the first saturated one
  const int tb = threadIdx.x * S_BPT;
  Agg g = agg_identity();
  for (int tile = lo; tile < hi; ++tile) {
    const long long s = (long long)tile * TILE;
    const long long a = s + tb;
    const int cnt = (int)max(0ll, min((long long)S_BPT, n - a));
    uint4 v[S_CHUNKS];
    fetch<S_TPB, S_WIN>(v, d, n, s, vec);
    stage<S_TPB, 16>(S, v, t);
    PRESPLIT_STAMP(0, 2);
    Agg mine = agg_identity();
    if (cnt > 0) mine = seg_agg(seg_of(S, a, S_HALO + tb, cnt), a, cnt);
    Agg total;
    block_rscan<S_TPB>(S.wagg, mine, total);
    g = agg_combine(g, total);
    if (agg_saturated(g)) break;
  }
  if (threadIdx.x == 0) agg_store(agg + (long long)S_AGG * blockIdx.x, g);
  PRESPLIT_STAMP(0, 3);
  grid.sync();
  PRESPLIT_STAMP(0, 4);

  // 2. the carry at the block's end: the later blocks' aggregates, a warp
  // at a time, up to the first saturated prefix, else the text's end
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    Agg run = agg_identity();
    bool done = false;
    for (int base = blockIdx.x + 1; base < (int)gridDim.x && !done;
         base += 32) {
      const int k = base + lane;
      Agg v = k < (int)gridDim.x ? agg_load(agg + (long long)S_AGG * k)
                                 : agg_identity();
#pragma unroll
      for (int dist = 1; dist < 32; dist <<= 1) {
        const Agg o = agg_shfl_up(v, dist);
        if (lane >= dist) v = agg_combine(o, v);
      }
      v = agg_combine(run, v);
      const unsigned sat =
          __ballot_sync(0xFFFFFFFFu, k < (int)gridDim.x && agg_saturated(v));
      run = agg_shfl(v, sat ? __ffs(sat) - 1 : 31);
      done = sat != 0;
    }
    if (!done) run = agg_combine(run, Agg{n, BIG, n, BIG, 1, -1});
    if (lane == 0) S.carry = run;
  }
  __syncthreads();
  Agg carry = S.carry;
  PRESPLIT_STAMP(0, 5);

  // 3. the block's tiles from the right: each byte's state from its
  // thread's and its tile's carry, and the successor at every char start;
  // the next tile's bytes load meanwhile
  uint4 vnext[S_CHUNKS];
  fetch<S_TPB, S_WIN>(vnext, d, n, (long long)(hi - 1) * TILE, vec);
  for (int tile = hi - 1; tile >= lo; --tile) {
    const long long s = (long long)tile * TILE;
    const long long a = s + tb;
    const int cnt = (int)max(0ll, min((long long)S_BPT, n - a));
    uint4 v[S_CHUNKS];
#pragma unroll
    for (int c = 0; c < S_CHUNKS; ++c) v[c] = vnext[c];
    if (tile > lo) fetch<S_TPB, S_WIN>(vnext, d, n, s - TILE, vec);
    stage<S_TPB, 16>(S, v, t);
    PRESPLIT_STAMP(0, 6);
    Seg sg{0ull, 0u, 0u, 0u};
    Agg mine = agg_identity();
    if (cnt > 0) {
      sg = seg_of(S, a, S_HALO + tb, cnt);
      mine = seg_agg(sg, a, cnt);
    }
    Agg total;
    const Agg excl = block_rscan<S_TPB>(S.wagg, mine, total);
    const Agg st = agg_combine(excl, carry);
    int c1 = st.c1, c2 = st.c2, o1 = st.o1, o2 = st.o2, lcr = st.lc;
    for (int j = cnt - 1; j >= 0; --j) {
      const int q = (int)(a + j);
      const int c = cls_of(sg, j);
      if (coarse(c) != CL_WS) lcr = -1;
      else if (lcr < 0 && c == CL_CR) lcr = q;
      S.fbuf[tb + j] = ((sg.starts >> j) & 1u)
                           ? successor(S, s - S_HALO, d, n, mode, q, c, c1,
                                       c2, o1, o2, lcr)
                           : -1;
      if ((sg.brk_c >> j) & 1u) {
        c2 = c1;
        c1 = q;
      }
      if ((sg.brk_o >> j) & 1u) {
        o2 = o1;
        o1 = q;
      }
    }
    carry = agg_combine(total, carry);
    __syncthreads();
    PRESPLIT_STAMP(0, 7);
    const int len = (int)min((long long)TILE, n - s);
    for (int i = threadIdx.x; i < TILE / 4; i += S_TPB) {
      if (4 * i + 4 <= len) {
        reinterpret_cast<int4*>(f + s)[i] =
            reinterpret_cast<const int4*>(S.fbuf)[i];
      } else {
        for (int j = 4 * i; j < len; ++j) f[s + j] = S.fbuf[j];
      }
    }
  }
  PRESPLIT_STAMP(0, 8);
}

// ---------------------------------------------------------------------------
// K15 presplit_orbit
// ---------------------------------------------------------------------------

// Step 1's pointer doubling over the walk words of a tile of T bytes (at
// most TILE) in Wa (a byte's next byte on its walk in bits 0-11, the hops
// to it in bits 16-27, bit 31 kept), Wb the other buffer, TPB threads:
// each round every word jumps to its next byte's next, adding the hops,
// and each byte marked in vis marks its next byte, until no word moves (at
// most O_ROUNDS). Returns the buffer of the last words: each byte's walk's
// last byte in the tile and the hops to it; vis then holds the walks from
// the bytes first marked.
template <int TPB, int T>
__device__ unsigned* walk_rounds(unsigned* Wa, unsigned* Wb, uint8_t* vis) {
  constexpr int PER = T / TPB;  // a thread's bytes, TPB apart
  for (int r = 0; r < O_ROUNDS; ++r) {
    // every load of the round before any store, so that the loads of a
    // thread's bytes overlap
    unsigned w[PER], wj[PER];
    int vp[PER];
#pragma unroll
    for (int k = 0; k < PER; ++k) w[k] = Wa[threadIdx.x + k * TPB];
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int p = threadIdx.x + k * TPB;
      const int j = (int)(w[k] & 0xFFFu);
      wj[k] = Wa[j];
      vp[k] = j != p ? vis[p] : 0;
    }
    int more = 0;
#pragma unroll
    for (int k = 0; k < PER; ++k) {
      const int p = threadIdx.x + k * TPB;
      const int j = (int)(w[k] & 0xFFFu);
      if (vp[k]) vis[j] = 1;
      Wb[p] = ((w[k] & 0xFFFF0000u) + (wj[k] & 0x0FFF0000u)) |
              (wj[k] & 0xFFFu);
      more |= (int)(wj[k] & 0xFFFu) != j;
    }
    unsigned* tw = Wa; Wa = Wb; Wb = tw;
    if (!__syncthreads_or(more)) break;
  }
  return Wa;
}

// The boundaries (vis, len bytes) and segment ids from base, the chunk
// starts before it, of the tile of T bytes at s, to device memory: a block
// scan of the boundary counts, T / TPB consecutive bytes a thread. wsum:
// TPB / 32 ints. Where ids is given, also each byte's token id through
// byte_ids (int32[256]), the tile's bytes read at bytes (bytes[p] is byte
// s + p; shared or device memory). Returns the tile's chunk starts.
template <int TPB, int T>
__device__ int write_segments(const uint8_t* vis, long long s, int len,
                              int base, uint8_t* boundary, int* seg,
                              int* wsum, const uint8_t* bytes = nullptr,
                              const int* byte_ids = nullptr,
                              int* ids = nullptr) {
  constexpr int PER = T / TPB;
  static_assert(PER == 4 || PER == 8, "a thread's bytes as one word");
  using Word = typename std::conditional<PER == 8, uint2, unsigned>::type;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int p0 = threadIdx.x * PER;
  Word bv = *reinterpret_cast<const Word*>(vis + p0);
  const uint8_t* const bb = reinterpret_cast<const uint8_t*>(&bv);
  int mine = 0;
#pragma unroll
  for (int k = 0; k < PER; ++k) mine += bb[k];
  int incl = mine;
#pragma unroll
  for (int dist = 1; dist < 32; dist <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, dist);
    if (lane >= dist) incl += v;
  }
  if (lane == 31) wsum[warp] = incl;
  __syncthreads();
  int before = 0, in_tile = 0;
  for (int w = 0; w < TPB / 32; ++w) {
    if (w < warp) before += wsum[w];
    in_tile += wsum[w];
  }
  int running = base + before + incl - mine;
  int4 sv[PER / 4];
  int* const ss = reinterpret_cast<int*>(sv);
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    running += bb[k];
    ss[k] = running - 1;
  }
  if (p0 + PER <= len) {
    *reinterpret_cast<Word*>(boundary + s + p0) = bv;
#pragma unroll
    for (int c = 0; c < PER / 4; ++c)
      reinterpret_cast<int4*>(seg + s + p0)[c] = sv[c];
    if (ids != nullptr) {
      Word dv;
      uint8_t* const db = reinterpret_cast<uint8_t*>(&dv);
      if ((reinterpret_cast<uintptr_t>(bytes) & (sizeof(Word) - 1)) == 0) {
        dv = *reinterpret_cast<const Word*>(bytes + p0);
      } else {
#pragma unroll
        for (int k = 0; k < PER; ++k) db[k] = bytes[p0 + k];
      }
      int4 iv[PER / 4];
      int* const is = reinterpret_cast<int*>(iv);
#pragma unroll
      for (int k = 0; k < PER; ++k) is[k] = __ldg(byte_ids + db[k]);
#pragma unroll
      for (int c = 0; c < PER / 4; ++c)
        reinterpret_cast<int4*>(ids + s + p0)[c] = iv[c];
    }
  } else {
    for (int k = 0; k < len - p0; ++k) {
      boundary[s + p0 + k] = bb[k];
      seg[s + p0 + k] = ss[k];
      if (ids != nullptr) ids[s + p0 + k] = __ldg(byte_ids + bytes[p0 + k]);
    }
  }
  return in_tile;
}

// The walk word of byte p of the tile at s (len bytes), its successor fp
// (-1 off a char start): the next byte in the tile and one hop, else
// itself (a root); bit 31 at a char start. ex: a root's exit, the byte
// where its walk goes on past the tile (n past the text).
__device__ __forceinline__ unsigned walk_word(int fp, long long s, int p,
                                              int len, int n, int& ex) {
  ex = n;
  if (fp < 0) return (unsigned)p;
  if (fp > s + p && fp < s + len) return 0x80010000u | (unsigned)(fp - s);
  if (fp > s + p) ex = min(fp, n);
  return 0x80000000u | (unsigned)p;
}

// sum of v over the block (every thread gets it); red: O_TPB / 32 ints
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
#pragma unroll
  for (int dist = 16; dist > 0; dist >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, dist);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  long long total = 0;
  for (int w = 0; w < O_TPB / 32; ++w) total += red[w];
  return total;
}

// The path over the node graph in one block (step 2, while the tiles and
// the nodes number at most O_BLOCK_NODES): node ids compact, each tile's
// first id in base; a thread owns O_OWN consecutive tiles. Shared memory:
// base, then the next node of each id in two buffers, then the marks.
__device__ void path_in_block(int n, int tiles, const int* lists,
                              const int* seg, int* tl, int* bl, int G,
                              int* base, long long* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();  // red was read by the block sum before
  int* Ja = base + O_BLOCK_NODES;
  int* Jb = Ja + O_BLOCK_NODES;
  uint8_t* const vis = reinterpret_cast<uint8_t*>(Jb + O_BLOCK_NODES);
  const int w0 = threadIdx.x * O_OWN;
  // each tile's node count, then its first id (an exclusive scan)
  int m[O_OWN];
  int mine = 0;
#pragma unroll
  for (int u = 0; u < O_OWN; ++u) {
    m[u] = w0 + u < tiles ? __ldcg(tl + w0 + u) : 0;
    mine += m[u];
  }
  int incl = mine;
#pragma unroll
  for (int dist = 1; dist < 32; dist <<= 1) {
    const int v = __shfl_up_sync(0xFFFFFFFFu, incl, dist);
    if (lane >= dist) incl += v;
  }
  if (lane == 31) red[warp] = incl;
  __syncthreads();
  int id = incl - mine;
  for (int w = 0; w < warp; ++w) id += (int)red[w];
#pragma unroll
  for (int u = 0; u < O_OWN; ++u) {
    if (w0 + u < tiles) base[w0 + u] = id;
    id += m[u];
  }
  __syncthreads();
  // each node's next node: the node of its byte's own exit; the first
  // node of each tile with independent loads, any more one by one
  int e[O_OWN];
#pragma unroll
  for (int u = 0; u < O_OWN; ++u)
    e[u] = m[u] > 0 ? __ldcg(lists + (long long)(w0 + u) * TILE) : n;
  int nd[O_OWN];
#pragma unroll
  for (int u = 0; u < O_OWN; ++u) nd[u] = e[u] < n ? __ldcg(seg + e[u]) : -1;
#pragma unroll
  for (int u = 0; u < O_OWN; ++u) {
    for (int k = 0; k < m[u]; ++k) {
      int ek = e[u], ndk = nd[u];
      if (k > 0) {
        ek = __ldcg(lists + (long long)(w0 + u) * TILE + k);
        ndk = ek < n ? __ldcg(seg + ek) : -1;
      }
      const unsigned ix = (unsigned)ndk & 0xFFFFu;
      const int x = base[w0 + u] + k;
      Ja[x] = ek < n && ix != ND_NONE ? base[ek / TILE] + (int)ix : -1;
      vis[x] = 0;
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned ix = (unsigned)__ldcg(seg) & 0xFFFFu;
    if (ix != ND_NONE) vis[base[0] + ix] = 1;
  }
  int M = 0;
  for (int w = 0; w < O_TPB / 32; ++w) M += (int)red[w];
  __syncthreads();
  for (int r = 0; r < 32 - __clz(M); ++r) {
    int j[O_OWN], jj[O_OWN], vp[O_OWN];
#pragma unroll
    for (int i = 0; i < O_OWN; ++i) {
      const int x = threadIdx.x + i * O_TPB;
      j[i] = x < M ? Ja[x] : -1;
    }
#pragma unroll
    for (int i = 0; i < O_OWN; ++i) {
      jj[i] = -1;
      vp[i] = 0;
      if (j[i] >= 0) {
        jj[i] = Ja[j[i]];
        vp[i] = vis[threadIdx.x + i * O_TPB];
      }
    }
    int more = 0;
#pragma unroll
    for (int i = 0; i < O_OWN; ++i) {
      const int x = threadIdx.x + i * O_TPB;
      if (x < M) {
        if (vp[i]) vis[j[i]] = 1;
        Jb[x] = jj[i];
        more |= jj[i] >= 0;
      }
    }
    int* tj = Ja; Ja = Jb; Jb = tj;
    if (!__syncthreads_or(more)) break;
  }
  // each tile's marked node (at most one) enters its tile and adds its
  // chunk starts to the tile's block
  int x[O_OWN];
#pragma unroll
  for (int u = 0; u < O_OWN; ++u) {
    x[u] = -1;
    for (int k = 0; k < m[u]; ++k)
      if (vis[base[w0 + u] + k]) x[u] = (w0 + u) * TILE + k;
  }
#pragma unroll
  for (int u = 0; u < O_OWN; ++u) e[u] = x[u] >= 0 ? __ldcg(lists + x[u]) : n;
#pragma unroll
  for (int u = 0; u < O_OWN; ++u) nd[u] = e[u] < n ? __ldcg(seg + e[u]) : 0;
#pragma unroll
  for (int u = 0; u < O_OWN; ++u) {
    if (e[u] < n) {
      const int wt = e[u] / TILE;
      tl[tiles + wt] = e[u];
      atomicAdd(bl + G + owner(wt, tiles), (int)((unsigned)nd[u] >> 16));
    }
  }
  if (threadIdx.x == 0) {
    tl[tiles] = 0;
    atomicAdd(bl + G, (int)((unsigned)__ldcg(seg) >> 16));
  }
}

// The same over the whole grid, a grid barrier a round: node (w, k) at
// slot w * TILE + k; nj, nj2 its next node's slot in two buffers; its mark
// in boundary.
__device__ void path_in_grid(cg::grid_group& grid, int n, int tiles,
                             const int* lists, const int* seg, int* tl,
                             int* bl, int G, int* nj, int* nj2,
                             uint8_t* boundary, long long M) {
  const int step = G * O_TPB;
  const int first = blockIdx.x * O_TPB + threadIdx.x;
  for (int w = first; w < tiles; w += step) {
    const int m = __ldcg(tl + w);
    for (int k = 0; k < m; ++k) {
      const long long x = (long long)w * TILE + k;
      const int e = __ldcg(lists + x);
      int j = -1;
      if (e < n) {
        const unsigned ix = (unsigned)__ldcg(seg + e) & 0xFFFFu;
        if (ix != ND_NONE) j = (int)((e / TILE) * TILE + ix);
      }
      nj[x] = j;
      boundary[x] = 0;
    }
  }
  grid.sync();
  if (first == 0) {
    const unsigned ix = (unsigned)__ldcg(seg) & 0xFFFFu;
    if (ix != ND_NONE) boundary[ix] = 1;
  }
  grid.sync();
  int* Ja = nj;
  int* Jb = nj2;
  for (int r = 0; r < 64 - __clzll(M); ++r) {
    for (int w = first; w < tiles; w += step) {
      const int m = __ldcg(tl + w);
      for (int k = 0; k < m; ++k) {
        const long long x = (long long)w * TILE + k;
        const int j = __ldcg(Ja + x);
        int jj = -1;
        if (j >= 0) {
          if (__ldcg(boundary + x)) boundary[j] = 1;
          jj = __ldcg(Ja + j);
        }
        Jb[x] = jj;
      }
    }
    grid.sync();
    int* tj = Ja; Ja = Jb; Jb = tj;
  }
  for (int w = first; w < tiles; w += step) {
    const int m = __ldcg(tl + w);
    for (int k = 0; k < m; ++k) {
      const long long x = (long long)w * TILE + k;
      if (!__ldcg(boundary + x)) continue;
      const int e = __ldcg(lists + x);
      if (e >= n) continue;
      const int wt = e / TILE;
      tl[tiles + wt] = e;
      atomicAdd(bl + G + owner(wt, tiles),
                (int)((unsigned)__ldcg(seg + e) >> 16));
    }
  }
  if (first == 0) {
    tl[tiles] = 0;
    atomicAdd(bl + G, (int)((unsigned)__ldcg(seg) >> 16));
  }
}

// grid: cooperative, at most the tiles. Scratch: lists, nj, nj2:
// int32[n] (each tile's distinct exits at its first bytes' slots; the node
// graph's next nodes, two buffers, grid-wide only); tl: int32[2 * tiles]
// (each tile's node count, then its entry); bl: int32[2 * gridDim.x]
// (each block's node count, then the chunk starts in its tiles); trunk:
// uint32[128 * tiles] (each tile's trunk, a bit a byte). boundary:
// uint8[n] (the node marks, grid-wide, until step 4); seg: int32[n]
// (each byte's exit index and count until step 4). Where ids is given
// (int32[n]), step 4 writes each byte's token id too: byte_ids (int32[256])
// at the byte of d (uint8[n]).
__global__ void __launch_bounds__(O_TPB, 2)
presplit_orbit_kernel(const int* __restrict__ f, int n,
                      uint8_t* boundary, int* seg, int* lists, int* nj,
                      int* nj2, int* tl, int* bl, unsigned* trunk,
                      const uint8_t* __restrict__ d,
                      const int* __restrict__ byte_ids, int* ids) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ int4 o_smem[];
  PRESPLIT_STAMP(1, 0);
  __shared__ long long red[O_TPB / 32];
  __shared__ int first, tile_min, tile_max, walk_end, walk_len,
      walked[O_WALK], wsum[O_TPB / 32];
  __shared__ int ent[O_CHUNK];
  unsigned* const W0 = reinterpret_cast<unsigned*>(o_smem);
  unsigned* const W1 = W0 + TILE;
  int* const EX = reinterpret_cast<int*>(W1 + TILE);
  uint8_t* const vis = reinterpret_cast<uint8_t*>(EX + TILE);
  const int tiles = (int)(((long long)n + TILE - 1) / TILE);
  const int G = gridDim.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int lo, hi;
  block_range(tiles, lo, hi);

  // 1. each byte's exit from its tile and the chunk starts it makes there;
  // the walk from the tile's first char start (its trunk); each tile's
  // distinct exits. W: a byte's word, a byte on its walk (bits 0-11; the
  // walk's last byte in the tile, its root, in the end), the hops to it
  // (bits 16-27), whether it starts a char (bit 31); EX: each root's exit.
  long long nodes = 0;
  if (threadIdx.x == 0) {
    first = TILE;
    tile_min = 0x7FFFFFFF;
    tile_max = -1;
  }
  __syncthreads();
  // the next tile's successors load while this one is resolved
  int fnext[O_PER];
#pragma unroll
  for (int k = 0; k < O_PER; ++k) {
    const long long q = (long long)lo * TILE + threadIdx.x + k * O_TPB;
    fnext[k] = q < n ? __ldg(f + q) : -1;
  }
  for (int tile = lo; tile < hi; ++tile) {
    const long long s = (long long)tile * TILE;
    const int len = (int)min((long long)TILE, n - s);
    int fcur[O_PER];
#pragma unroll
    for (int k = 0; k < O_PER; ++k) {
      fcur[k] = fnext[k];
      const long long q = s + TILE + threadIdx.x + k * O_TPB;
      fnext[k] = tile + 1 < hi && q < n ? __ldg(f + q) : -1;
    }
    int lead = TILE;
#pragma unroll
    for (int k = 0; k < O_PER; ++k) {
      const int p = threadIdx.x + k * O_TPB;
      const int fp = p < len ? fcur[k] : -1;
      if (fp >= 0) lead = min(lead, p);
      W0[p] = walk_word(fp, s, p, len, n, EX[p]);
    }
    lead = __reduce_min_sync(0xFFFFFFFFu, lead);
    if (lane == 0 && lead < TILE) atomicMin(&first, lead);
    __syncthreads();
    PRESPLIT_STAMP(1, 1);
#pragma unroll
    for (int k = 0; k < O_PER; ++k) {
      const int p = threadIdx.x + k * O_TPB;
      vis[p] = p == first;
    }
    __syncthreads();
    unsigned* const Wa = walk_rounds<O_TPB, TILE>(W0, W1, vis);
    unsigned* const Wb = Wa == W0 ? W1 : W0;
    PRESPLIT_STAMP(1, 2);
    // each byte's exit (-1 off a char start) and count, the trunk's bits,
    // the tile's least and greatest exit
    int ex[O_PER], cnt[O_PER];
    int emin = 0x7FFFFFFF, emax = -1;
#pragma unroll
    for (int k = 0; k < O_PER; ++k) {
      const int p = threadIdx.x + k * O_TPB;
      const unsigned w = Wa[p];
      ex[k] = p < len && (w >> 31) ? EX[w & 0xFFFu] : -1;
      cnt[k] = (int)((w >> 16) & 0xFFFu) + 1;
      if (ex[k] >= 0) {
        emin = min(emin, ex[k]);
        emax = max(emax, ex[k]);
      }
      const unsigned bits = __ballot_sync(0xFFFFFFFFu, vis[p]);
      if (lane == 0) trunk[(long long)tile * (TILE / 32) + k * (O_TPB / 32) +
                           warp] = bits;
    }
    emin = __reduce_min_sync(0xFFFFFFFFu, emin);
    emax = __reduce_max_sync(0xFFFFFFFFu, emax);
    if (lane == 0) {
      atomicMin(&tile_min, emin);
      atomicMax(&tile_max, emax);
    }
    __syncthreads();
    // in text the tile's walks all leave at one exit: its only node
    const int tmin = tile_min, tmax = tile_max;
    int m;
    if (tmin >= tmax) {
      m = tmax >= 0;
      if (threadIdx.x == 0 && m) lists[s] = tmax;
#pragma unroll
      for (int k = 0; k < O_PER; ++k) {
        const int p = threadIdx.x + k * O_TPB;
        if (p < len)
          seg[s + p] = (int)((ex[k] >= 0 ? 0u : ND_NONE) |
                             ((unsigned)cnt[k] << 16));
      }
    } else {
      // the distinct exits: a hash of TILE slots in Wb (exit, or -1); a char
      // start inserts its exit unless the byte before it starts a char with
      // the same exit, then every char start looks its slot up
      int* const keys = reinterpret_cast<int*>(Wb);
  #pragma unroll
      for (int k = 0; k < O_PER; ++k) {
        EX[threadIdx.x + k * O_TPB] = ex[k];
        keys[threadIdx.x + k * O_TPB] = -1;
      }
      __syncthreads();
  #pragma unroll
      for (int k = 0; k < O_PER; ++k) {
        const int p = threadIdx.x + k * O_TPB;
        const int e = ex[k];
        if (e >= 0 && (p == 0 || EX[p - 1] != e)) {
          int h = (int)(((unsigned)e * 0x9E3779B1u) >> 20);
          for (;;) {
            const int old = keys[h] == e ? e : atomicCAS(keys + h, -1, e);
            if (old == -1 || old == e) break;
            h = (h + 1) & (TILE - 1);
          }
        }
      }
      __syncthreads();
      int slot[O_PER];
  #pragma unroll
      for (int k = 0; k < O_PER; ++k) {
        const int e = ex[k];
        slot[k] = -1;
        if (e >= 0) {
          int h = (int)(((unsigned)e * 0x9E3779B1u) >> 20);
          while (keys[h] != e) h = (h + 1) & (TILE - 1);
          slot[k] = h;
        }
      }
      __syncthreads();
      // number the occupied slots (a thread's 8 consecutive slots) and list
      // their exits
      int mine = 0;
  #pragma unroll
      for (int k = 0; k < O_PER; ++k)
        mine += keys[threadIdx.x * O_PER + k] >= 0;
      int incl = mine;
  #pragma unroll
      for (int dist = 1; dist < 32; dist <<= 1) {
        const int v = __shfl_up_sync(0xFFFFFFFFu, incl, dist);
        if (lane >= dist) incl += v;
      }
      if (lane == 31) red[warp] = incl;
      __syncthreads();
      int idx = incl - mine;
      m = 0;
      for (int w = 0; w < O_TPB / 32; ++w) {
        if (w < warp) idx += (int)red[w];
        m += (int)red[w];
      }
  #pragma unroll
      for (int k = 0; k < O_PER; ++k) {
        const int h = threadIdx.x * O_PER + k;
        const int e = keys[h];
        if (e >= 0) {
          lists[s + idx] = e;
          keys[h] = idx++;
        }
      }
      __syncthreads();
      // each byte's exit index and count
  #pragma unroll
      for (int k = 0; k < O_PER; ++k) {
        const int p = threadIdx.x + k * O_TPB;
        if (p < len) {
          const unsigned ix = slot[k] < 0 ? ND_NONE : (unsigned)keys[slot[k]];
          seg[s + p] = (int)(ix | ((unsigned)cnt[k] << 16));
        }
      }
    }
    if (threadIdx.x == 0) {
      tl[tile] = m;
      tl[tiles + tile] = -1;
      first = TILE;
    }
    nodes += m;
    __syncthreads();
    if (threadIdx.x == 0) {  // read by every thread before the barrier
      tile_min = 0x7FFFFFFF;
      tile_max = -1;
    }
  }
  PRESPLIT_STAMP(1, 3);
  if (threadIdx.x == 0) {
    bl[blockIdx.x] = (int)nodes;
    bl[G + blockIdx.x] = 0;
  }
  grid.sync();
  PRESPLIT_STAMP(1, 4);

  // 2. the path from byte 0's exit over the node graph: each node on it
  // is its tile's entry
  long long total = 0;
  for (int b = threadIdx.x; b < G; b += O_TPB) total += __ldcg(bl + b);
  const long long M = block_sum(total, red);
  if (M <= O_BLOCK_NODES && tiles <= O_BLOCK_NODES) {
    if (blockIdx.x == 0)
      path_in_block(n, tiles, lists, seg, tl, bl, G,
                    reinterpret_cast<int*>(o_smem), red);
  } else {
    path_in_grid(grid, n, tiles, lists, seg, tl, bl, G, nj, nj2, boundary,
                 M);
  }
  PRESPLIT_STAMP(1, 5);
  grid.sync();

  // 3. the chunk starts before this block's tiles
  total = 0;
  for (int b = threadIdx.x; b < (int)blockIdx.x; b += O_TPB)
    total += __ldcg(bl + G + b);
  int base = (int)block_sum(total, red);
  PRESPLIT_STAMP(1, 6);

  // 4. each tile's walk from its entry: up to O_WALK hops until it meets
  // the trunk, then the trunk from there; by doubling where it does not
  // meet it in those hops. Then the segment ids. The entries and trunks of
  // O_CHUNK tiles at a time are loaded at once.
  unsigned* const tb = W0;
  unsigned short* const H0 = reinterpret_cast<unsigned short*>(EX);
  unsigned short* const H1 = H0 + TILE;
  for (int c0 = lo; c0 < hi; c0 += O_CHUNK) {
    const int cn = min(O_CHUNK, hi - c0);
    for (int i = threadIdx.x; i < cn * (TILE / 32); i += O_TPB)
      tb[i] = __ldcg(trunk + (long long)c0 * (TILE / 32) + i);
    if (threadIdx.x < cn) ent[threadIdx.x] = __ldcg(tl + tiles + c0 +
                                                    threadIdx.x);
    __syncthreads();
    for (int t = 0; t < cn; ++t) {
      const int tile = c0 + t;
      const long long s = (long long)tile * TILE;
      const int len = (int)min((long long)TILE, n - s);
      const unsigned* const tw = tb + t * (TILE / 32);
      const int entry = ent[t] >= 0 ? (int)(ent[t] - s) : -1;
      if (threadIdx.x == 0) {
        // walk_end: where the walk met the trunk, TILE if it left the
        // tile, -1 without an entry, -2 if it did none in O_WALK hops
        int x = entry, k = 0;
        while (x >= 0 && k < O_WALK && !((tw[x >> 5] >> (x & 31)) & 1u)) {
          walked[k++] = x;
          const int fx = __ldg(f + s + x);
          x = fx > s + x && fx < s + len ? (int)(fx - s) : TILE;
          if (x == TILE) break;
        }
        walk_len = k;
        walk_end = x < 0 || x == TILE || ((tw[x >> 5] >> (x & 31)) & 1u)
                       ? x : -2;
      }
      __syncthreads();
      const int end = walk_end;
      PRESPLIT_STAMP(1, 7);
      if (end == -2) {
        // H: each char start's tile-relative successor, TILE if it leaves
#pragma unroll
        for (int k = 0; k < O_PER; ++k) {
          const int p = threadIdx.x + k * O_TPB;
          int j = TILE;
          if (p < len) {
            const int fp = __ldg(f + s + p);
            if (fp > s + p && fp < s + len) j = (int)(fp - s);
          }
          H0[p] = (unsigned short)j;
          vis[p] = p == entry ? 1 : 0;
        }
        __syncthreads();
        unsigned short* Ha = H0;
        unsigned short* Hb = H1;
        for (int r = 0; r < O_ROUNDS; ++r) {
          int j[O_PER], jj[O_PER], vp[O_PER];
#pragma unroll
          for (int k = 0; k < O_PER; ++k) j[k] = Ha[threadIdx.x + k * O_TPB];
#pragma unroll
          for (int k = 0; k < O_PER; ++k) {
            jj[k] = j[k];
            vp[k] = 0;
            if (j[k] < TILE) {
              jj[k] = Ha[j[k]];
              vp[k] = vis[threadIdx.x + k * O_TPB];
            }
          }
          int more = 0;
#pragma unroll
          for (int k = 0; k < O_PER; ++k) {
            if (vp[k]) vis[j[k]] = 1;
            Hb[threadIdx.x + k * O_TPB] = (unsigned short)jj[k];
            more |= jj[k] < TILE;
          }
          unsigned short* th = Ha; Ha = Hb; Hb = th;
          if (!__syncthreads_or(more)) break;
        }
      } else {
#pragma unroll
        for (int k = 0; k < O_PER; ++k) {
          const int p = threadIdx.x + k * O_TPB;
          vis[p] = end >= 0 && p >= end && ((tw[p >> 5] >> (p & 31)) & 1u);
        }
        __syncthreads();
        if (threadIdx.x < walk_len) vis[walked[threadIdx.x]] = 1;
        __syncthreads();
      }
      base += write_segments<O_TPB, TILE>(vis, s, len, base, boundary, seg,
                                          wsum, d + s, byte_ids, ids);
      __syncthreads();
    }
  }
  PRESPLIT_STAMP(1, 8);
}

// ---------------------------------------------------------------------------
// K15 presplit_cluster: a stream of at most C_MAX tiles in one launch
// ---------------------------------------------------------------------------

// a CTA's shared memory on a tile of T bytes
template <int T>
struct ClusterSmem {
  static constexpr int TPB = c_tpb(T);
  alignas(16) uint8_t buf[T + 2 * S_HALO];  // the tile, 16 bytes either side
  unsigned short info[T + 2 * S_HALO];      // their info words
  unsigned short ascii[128];        // the info word of each ASCII char
  alignas(16) int fbuf[T];          // the tile's successors
  unsigned W[2][T];                 // the walk words, two buffers
  int EX[T];                        // each root's exit
  unsigned xc[T];                   // a char start's exit | its count << 16
  alignas(8) uint8_t vis[T];        // the trunk, then the chunk starts
  Agg wagg[TPB / 32];
  Agg tagg;                         // the tile's aggregate
  Agg carry;                        // the later tiles' and the text's end
  int first, entry, base, walk_end, walk_len;
  int walked[O_WALK];
  int wsum[TPB / 32];
};

// One cluster of gridDim.x <= C_MAX CTAs of c_tpb(T) threads, CTA r the
// tile of T bytes at r * T (none past the text). boundary: uint8[n]; seg:
// int32[n], each written once; ids (int32[n]), where given, each byte's
// token id through byte_ids (int32[256]).
template <int T>
__global__ void __launch_bounds__(c_tpb(T), 1)
presplit_cluster_kernel(const uint8_t* __restrict__ d, int n, int mode,
                        Tables t, uint8_t* __restrict__ boundary,
                        int* __restrict__ seg,
                        const int* __restrict__ byte_ids,
                        int* __restrict__ ids) {
  constexpr int TPB = c_tpb(T);
  constexpr int BPT = T / TPB;  // a thread's bytes
  constexpr int WIN = T + 2 * S_HALO;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ int4 c_smem[];
  ClusterSmem<T>& S = *reinterpret_cast<ClusterSmem<T>*>(c_smem);
  PRESPLIT_STAMP(2, 0);
  const int rank = (int)cluster.block_rank();
  const int C = (int)cluster.num_blocks();
  const long long s = (long long)rank * T;
  const int len = (int)max(0ll, min((long long)T, n - s));

  // 1. the tile and its halo staged and classified once, 4 bytes a unit
  if (threadIdx.x < 128) S.ascii[threadIdx.x] = (unsigned short)info_word(
      threadIdx.x, 1, t);
  if (threadIdx.x == 0) S.first = T;
  uint4 v[(WIN / 16 + TPB - 1) / TPB];
  fetch<TPB, WIN>(v, d, n, s, (reinterpret_cast<uintptr_t>(d) & 15) == 0);
  stage<TPB, 4>(S, v, t);
  PRESPLIT_STAMP(2, 1);

  // 2. the aggregate of the thread's bytes, of the threads after it in the
  // tile, and the tile's, which the CTAs before it read
  const int tb = threadIdx.x * BPT;
  const long long a = s + tb;
  const int cnt = (int)max(0ll, min((long long)BPT, n - a));
  Seg sg{0ull, 0u, 0u, 0u};
  Agg mine = agg_identity();
  if (cnt > 0) {
    sg = seg_of(S, a, S_HALO + tb, cnt);
    mine = seg_agg(sg, a, cnt);
  }
  Agg total;
  const Agg excl = block_rscan<TPB>(S.wagg, mine, total);
  if (threadIdx.x == 0) S.tagg = total;
  PRESPLIT_STAMP(2, 2);
  cluster.sync();
  PRESPLIT_STAMP(2, 3);

  // 3. the carry at the tile's end: the later tiles' aggregates from their
  // CTAs' shared memory, a lane each, then the text's end
  if (threadIdx.x < 32) {
    const int k = rank + 1 + (int)threadIdx.x;
    Agg g = agg_identity();
    if (k < C) g = *cluster.map_shared_rank(&S.tagg, k);
    else if (k == C) g = Agg{n, BIG, n, BIG, 1, -1};
#pragma unroll
    for (int dist = 1; dist < C_MAX; dist <<= 1) {
      const Agg o = agg_shfl_down(g, dist);
      if ((int)threadIdx.x + dist < 32) g = agg_combine(g, o);
    }
    if (threadIdx.x == 0) S.carry = g;
  }
  __syncthreads();

  // 4. the successor at each char start of the thread's bytes, from the
  // right (presplit_succ's phase 3)
  const Agg st = agg_combine(excl, S.carry);
  int c1 = st.c1, c2 = st.c2, o1 = st.o1, o2 = st.o2, lcr = st.lc;
  int4 fv[BPT / 4];
  int* const fq = reinterpret_cast<int*>(fv);
#pragma unroll
  for (int j = BPT - 1; j >= 0; --j) {
    fq[j] = -1;
    if (j < cnt) {
      const int q = (int)(a + j);
      const int c = cls_of(sg, j);
      if (coarse(c) != CL_WS) lcr = -1;
      else if (lcr < 0 && c == CL_CR) lcr = q;
      if ((sg.starts >> j) & 1u)
        fq[j] = successor(S, s - S_HALO, d, n, mode, q, c, c1, c2, o1, o2,
                          lcr);
      if ((sg.brk_c >> j) & 1u) {
        c2 = c1;
        c1 = q;
      }
      if ((sg.brk_o >> j) & 1u) {
        o2 = o1;
        o1 = q;
      }
    }
  }
#pragma unroll
  for (int c = 0; c < BPT / 4; ++c)
    reinterpret_cast<int4*>(S.fbuf + tb)[c] = fv[c];
  __syncthreads();
  PRESPLIT_STAMP(2, 4);

  // 5. each byte's walk in the tile by doubling (presplit_orbit's step 1):
  // its exit and count; the walk from the tile's first char start, its
  // trunk, marked in vis
  int lead = T;
#pragma unroll
  for (int k = 0; k < BPT; ++k) {
    const int p = threadIdx.x + k * TPB;
    const int fp = p < len ? S.fbuf[p] : -1;
    if (fp >= 0) lead = min(lead, p);
    S.W[0][p] = walk_word(fp, s, p, len, n, S.EX[p]);
  }
  lead = __reduce_min_sync(0xFFFFFFFFu, lead);
  if ((threadIdx.x & 31) == 0 && lead < T) atomicMin(&S.first, lead);
  __syncthreads();
#pragma unroll
  for (int k = 0; k < BPT; ++k) {
    const int p = threadIdx.x + k * TPB;
    S.vis[p] = p == S.first;
  }
  __syncthreads();
  const unsigned* const Wf =
      walk_rounds<TPB, T>(S.W[0], S.W[1], S.vis);
#pragma unroll
  for (int k = 0; k < BPT; ++k) {
    const int p = threadIdx.x + k * TPB;
    const unsigned w = Wf[p];
    S.xc[p] = p < len && (w >> 31)
                  ? (unsigned)S.EX[w & 0xFFFu] |
                        ((((w >> 16) & 0xFFFu) + 1u) << 16)
                  : 0xFFFFFFFFu;
  }
  PRESPLIT_STAMP(2, 5);
  cluster.sync();
  PRESPLIT_STAMP(2, 6);

  // 6. the path from byte 0 over the tiles, in CTA 0: each tile's entry
  // (where the path enters it) and the chunk starts before it, written
  // into each CTA's shared memory
  if (rank == 0 && threadIdx.x == 0) {
    int ent[C_MAX], starts[C_MAX];
#pragma unroll
    for (int k = 0; k < C_MAX; ++k) {
      ent[k] = -1;
      starts[k] = 0;
    }
    for (int x = 0; x < n;) {
      const int w = x / T;
      const unsigned e = *cluster.map_shared_rank(&S.xc[x - w * T], w);
      ent[w] = x - w * T;
      starts[w] = (int)(e >> 16);
      x = (int)(e & 0xFFFFu);
    }
    int before = 0;
    for (int k = 0; k < C; ++k) {
      *cluster.map_shared_rank(&S.entry, k) = ent[k];
      *cluster.map_shared_rank(&S.base, k) = before;
      before += starts[k];
    }
  }
  PRESPLIT_STAMP(2, 7);
  cluster.sync();  // after it no CTA touches another's shared memory
  PRESPLIT_STAMP(2, 8);

  // 7. the walk from the entry (presplit_orbit's step 4): up to O_WALK
  // hops until it meets the trunk, then the trunk; by doubling from the
  // entry where it does not meet it in those hops
  const int entry = S.entry;
  if (threadIdx.x == 0) {
    int x = entry, k = 0;
    while (x >= 0 && k < O_WALK && !S.vis[x]) {
      S.walked[k++] = x;
      const int fx = S.fbuf[x];
      x = fx > s + x && fx < s + len ? (int)(fx - s) : T;
      if (x == T) break;
    }
    S.walk_len = k;
    S.walk_end = x < 0 || x == T || S.vis[x] ? x : -2;
  }
  __syncthreads();
  const int end = S.walk_end;
  if (end == -2) {
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const int p = threadIdx.x + k * TPB;
      S.W[0][p] = walk_word(p < len ? S.fbuf[p] : -1, s, p, len, n, S.EX[p]);
      S.vis[p] = p == entry;
    }
    __syncthreads();
    walk_rounds<TPB, T>(S.W[0], S.W[1], S.vis);
  } else {
#pragma unroll
    for (int k = 0; k < BPT; ++k) {
      const int p = threadIdx.x + k * TPB;
      S.vis[p] = end >= 0 && p >= end && S.vis[p];
    }
    __syncthreads();
    if ((int)threadIdx.x < S.walk_len) S.vis[S.walked[threadIdx.x]] = 1;
    __syncthreads();
  }
  PRESPLIT_STAMP(2, 9);

  // 8. the boundaries and segment ids, and the token ids from the staged
  // tile
  write_segments<TPB, T>(S.vis, s, len, S.base, boundary, seg, S.wsum,
                         S.buf + S_HALO, byte_ids, ids);
  PRESPLIT_STAMP(2, 10);
}

// One launch of presplit_cluster_kernel<T>: the cluster-size and
// shared-memory checks once per device and size.
template <int T>
cudaError_t cluster_launch(const uint8_t* data, int n, int mode,
                           const Tables& t, uint8_t* boundary, int* seg,
                           const int* byte_ids, int* ids, int cluster,
                           cudaStream_t stream) {
  static std::atomic<int> allowed[64][C_MAX + 1];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster);
  cfg.blockDim = dim3(c_tpb(T));
  cfg.dynamicSmemBytes = sizeof(ClusterSmem<T>);
  cfg.stream = stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = cluster;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if (allowed[dev][cluster] == 0) {
    e = cudaFuncSetAttribute((const void*)presplit_cluster_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)sizeof(ClusterSmem<T>));
    int fit = 0;
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveClusters(
          &fit, (const void*)presplit_cluster_kernel<T>, &cfg);
    if (e == cudaSuccess && fit < 1) e = cudaErrorInvalidConfiguration;
    if (e != cudaSuccess) return e;
    allowed[dev][cluster] = 1;
  }
  return cudaLaunchKernelEx(&cfg, presplit_cluster_kernel<T>, data, n, mode,
                            t, boundary, seg, byte_ids, ids);
}

// the cooperative grid of a kernel (0 presplit_succ, 1 presplit_orbit) on
// the current device: the blocks that fit at once, queried once per device
// (presplit_orbit's shared-memory allowance is set then too)
cudaError_t coop_grid(int kind, int* grid) {
  static std::atomic<int> resident[2][64];
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64 || kind < 0 || kind > 1) return cudaErrorInvalidValue;
  if (resident[kind][dev] == 0) {
    int coop, sms, per;
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (kind == 0) {
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, presplit_succ_kernel, S_TPB, 0);
    } else {
      if (e == cudaSuccess)
        e = cudaFuncSetAttribute((const void*)presplit_orbit_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 O_SMEM);
      if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per, presplit_orbit_kernel, O_TPB, O_SMEM);
    }
    if (e != cudaSuccess) return e;
    if (!coop || per < 1) return cudaErrorCooperativeLaunchTooLarge;
    resident[kind][dev] = per * sms;
  }
  *grid = resident[kind][dev];
  return cudaSuccess;
}

// a launch that exceeds the resident blocks is refused, not run
cudaError_t launch(int kind, const void* fn, int grid, int tpb, void** args,
                   int smem, void* stream) {
  int resident;
  cudaError_t e = coop_grid(kind, &resident);
  if (e == cudaSuccess && (grid < 1 || grid > resident))
    e = cudaErrorInvalidValue;
  if (e == cudaSuccess)
    e = cudaLaunchCooperativeKernel(fn, dim3(grid), dim3(tpb), args, smem,
                                    (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next
    return e;
  }
  return cudaGetLastError();
}

}  // namespace presplit
}  // namespace

extern "C" {

// bytes a tile of either K15 kernel
int bpe_presplit_tile_size() { return presplit::TILE; }

// the K15 phase stamps (long long[3][16][2]) into host memory at out:
// zero unless the library was built with -DPRESPLIT_STAMPS
int bpe_presplit_stamps(long long* out) {
  return cudaMemcpyFromSymbol(out, presplit::presplit_stamps,
                              sizeof(presplit::presplit_stamps));
}

// ints of bpe_presplit_succ's scratch a block of its grid
int bpe_presplit_scratch_ints() { return presplit::S_AGG; }

// the most nodes that bpe_presplit_orbit's path marking takes in one block
int bpe_presplit_block_nodes() { return presplit::O_BLOCK_NODES; }

// the most blocks of K15's kind 0 (presplit_succ) or 1 (presplit_orbit)
// that the current device holds at once (the same for every stream); a
// negative CUDA error where it takes no cooperative launch. A launch uses
// at most these, and at most the stream's tiles.
int bpe_presplit_grid(int kind) {
  int grid = 0;
  const cudaError_t e = presplit::coop_grid(kind, &grid);
  return e == cudaSuccess ? grid : -(int)e;
}

// K15 presplit_succ over data[0 .. n), n >= 1, mode 4 (GPT-4) or 2
// (GPT-2), on grid blocks (at most the tiles); the class tables: dense
// uint8[0x10000], starts int32[nstarts] and flags uint8[nstarts]. f:
// int32[n]; scratch: int32[grid * bpe_presplit_scratch_ints()].
int bpe_presplit_succ(const unsigned char* data, int n, int mode,
                      const unsigned char* dense, const int* starts,
                      const unsigned char* flags, int nstarts, int* f,
                      int* scratch, int grid, void* stream) {
  using namespace presplit;
  const long long tiles = ((long long)n + presplit::TILE - 1) / presplit::TILE;
  if (n < 1 || (mode != 4 && mode != 2) || nstarts < 1 || grid > tiles)
    return cudaErrorInvalidValue;
  Tables t{dense, starts, flags, nstarts};
  void* args[] = {&data, &n, &mode, &t, &f, &scratch};
  return launch(0, (const void*)presplit_succ_kernel, grid, S_TPB, args, 0,
                stream);
}

// the most tiles (and CTAs) of bpe_presplit_cluster's one cluster, and
// its least tile
int bpe_presplit_cluster_max() { return presplit::C_MAX; }
int bpe_presplit_cluster_min_tile() { return presplit::C_MIN_TILE; }

// K15 presplit_cluster over data[0 .. n), 1 <= n <= cluster * tile, mode
// and the class tables as for bpe_presplit_succ: one launch of one cluster
// of `cluster` CTAs (at most bpe_presplit_cluster_max()), a CTA a tile of
// `tile` bytes (512, 1024, 2048 or the tile size). boundary: uint8[n];
// seg: int32[n]; byte_ids: int32[256] and ids: int32[n], each byte's token
// id, or both null. A cluster that cannot be resident returns its error
// (the shared-memory allowance is set, and the cluster size checked, once
// per device, tile and size).
int bpe_presplit_cluster(const unsigned char* data, int n, int mode,
                         const unsigned char* dense, const int* starts,
                         const unsigned char* flags, int nstarts,
                         unsigned char* boundary, int* seg,
                         const int* byte_ids, int* ids, int tile,
                         int cluster, void* stream) {
  using namespace presplit;
  if (n < 1 || (mode != 4 && mode != 2) || nstarts < 1 || cluster < 1 ||
      cluster > C_MAX || (long long)cluster * tile < n ||
      (byte_ids == nullptr) != (ids == nullptr))
    return cudaErrorInvalidValue;
  const Tables t{dense, starts, flags, nstarts};
  const cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  switch (tile) {
    case 512:
      e = cluster_launch<512>(data, n, mode, t, boundary, seg,
                              byte_ids, ids, cluster, st);
      break;
    case 1024:
      e = cluster_launch<1024>(data, n, mode, t, boundary, seg,
                               byte_ids, ids, cluster, st);
      break;
    case 2048:
      e = cluster_launch<2048>(data, n, mode, t, boundary, seg,
                               byte_ids, ids, cluster, st);
      break;
    case presplit::TILE:
      e = cluster_launch<presplit::TILE>(data, n, mode, t, boundary, seg,
                                         byte_ids, ids, cluster, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  if (e != cudaSuccess) {
    cudaGetLastError();  // the refusal is returned, not left for the next
    return e;
  }
  return cudaGetLastError();
}

// K15 presplit_orbit over the successors f[0 .. n), n >= 1 (f[p] > p or
// -1), on grid blocks (at most the tiles). boundary: uint8[n]; seg:
// int32[n]; lists, nj, nj2: int32[n]; tl: int32[2 * tiles]; bl:
// int32[2 * grid]; trunk: uint32[tiles * tile size / 32]; data: uint8[n]
// (the bytes whose successors f are), byte_ids: int32[256] and ids:
// int32[n], each byte's token id, or all three null.
int bpe_presplit_orbit(const int* f, int n, unsigned char* boundary,
                       int* seg, int* lists, int* nj, int* nj2, int* tl,
                       int* bl, unsigned* trunk, const unsigned char* data,
                       const int* byte_ids, int* ids, int grid,
                       void* stream) {
  using namespace presplit;
  const long long tiles = ((long long)n + presplit::TILE - 1) / presplit::TILE;
  if (n < 1 || grid > tiles || (data == nullptr) != (ids == nullptr) ||
      (byte_ids == nullptr) != (ids == nullptr))
    return cudaErrorInvalidValue;
  void* args[] = {&f, &n, &boundary, &seg, &lists, &nj, &nj2, &tl, &bl,
                  &trunk, &data, &byte_ids, &ids};
  return launch(1, (const void*)presplit_orbit_kernel, grid, O_TPB, args,
                O_SMEM, stream);
}

}  // extern "C"
