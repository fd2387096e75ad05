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
//                        one counting core with K9 and K13 (count_pairs)
//   K5 select_batch   <- the selection walk sel_body + select_candidate +
//                        no_pair (fused_train.py:915-1000, :1042-1084,
//                        :1118-1123); _adjcount_kernel's _select
//                        (fused_train_xl.py:158-173), _tie_kernel (:176-244)
//                        and _train_xl's walk (:689-731)
//   K3 merge_apply    <- tiled_apply (fused_train.py:293-340), _apply_kernel
//                        (fused_train_xl.py:247-297)
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
//                        most 256 tokens, one warp a chunk
//   K12 encode_min_sweep <- the same, on longer chunks: K10's sweep, each
//                        round applying the lowest rank present
//   K13 pair_table    <- no Pallas site: ops/train_sortloop.py::_round
//                        (:49-83), the sort-round trainer's stable sort
//                        and run scans: every pair's count and first
//                        position into a device hash table, K1's counting
//                        core
//   K14 table_select  <- the same round's selection (:70-78): the largest
//                        count, then the earliest first occurrence, from
//                        the table's claimed slots, which it empties
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
// cudaGetLastError() (0 on success). K1 and K9 also return the error of
// allowing their shared-memory table (once per device).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbpe_kernels.so bpe_kernels.cu

#include <atomic>

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
// the V x V matrices at the 32-bit key a * V + b (K1 also a min of first
// positions); K13 inserts into a device hash table at the 64-bit key
// a << 32 | b (HashSink, below).
template <bool FIRST>
struct MatrixSink {
  using Key = unsigned;
  static constexpr bool kFirst = FIRST;
  unsigned* cnt;
  unsigned* first;
  int W, V;

  __device__ __forceinline__ bool takes(int a, int b) const {
    return (unsigned)a < (unsigned)W && (unsigned)b < (unsigned)W;
  }
  __device__ __forceinline__ Key key(int a, int b) const {
    return (unsigned)(a * V + b);
  }
  __device__ __forceinline__ void add(Key k, unsigned c, unsigned p) const {
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

// A block's table in dynamic shared memory, 1 << log2 slots: keys (Key, all
// ones when empty), counts and (FIRST) first positions, each array 16-byte
// aligned.
template <class Key, bool FIRST>
struct PairTable {
  Key* key;
  unsigned* cnt;
  unsigned* first;
  int log2;

  // every slot empty; block-wide, the caller synchronises
  __device__ void clear() {
    const uint4 none = make_uint4(EMPTY_KEY, EMPTY_KEY, EMPTY_KEY, EMPTY_KEY);
    constexpr int KW = sizeof(Key) / 4;  // a key's 32-bit words
    for (int q = threadIdx.x; q < (1 << log2) / 4; q += blockDim.x) {
#pragma unroll
      for (int w = 0; w < KW; ++w)
        reinterpret_cast<uint4*>(key)[KW * q + w] = none;
      reinterpret_cast<uint4*>(cnt)[q] = make_uint4(0, 0, 0, 0);
      if (FIRST) reinterpret_cast<uint4*>(first)[q] = none;
    }
  }

  // c occurrences of key k, the first at p; false when neither k nor an
  // empty slot lies within HIST_PROBES slots of its hash. ++*fresh when it
  // claims a slot.
  __device__ bool add(Key k, unsigned c, unsigned p, int* fresh) {
    const unsigned mask = (1u << log2) - 1;
    const Key empty = ~Key(0);
    unsigned s = slot_hash(k, log2);
    for (int probe = 0; probe < HIST_PROBES; ++probe, s = (s + 1) & mask) {
      // a slot's key changes once per clear, from empty to its owner
      Key held = reinterpret_cast<volatile Key*>(key)[s];
      if (held == empty) {
        held = atomicCAS(key + s, empty, k);
        if (held == empty) {
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
    const Key empty = ~Key(0);
    for (int q = threadIdx.x; q < (1 << log2) / 4; q += blockDim.x) {
      Key ks[4];
      if constexpr (sizeof(Key) == 4) {
        const uint4 k4 = reinterpret_cast<const uint4*>(key)[q];
        ks[0] = k4.x, ks[1] = k4.y, ks[2] = k4.z, ks[3] = k4.w;
      } else {
        const ulonglong2 k0 = reinterpret_cast<const ulonglong2*>(key)[2 * q];
        const ulonglong2 k1 =
            reinterpret_cast<const ulonglong2*>(key)[2 * q + 1];
        ks[0] = k0.x, ks[1] = k0.y, ks[2] = k1.x, ks[3] = k1.y;
      }
      const uint4 c4 = reinterpret_cast<const uint4*>(cnt)[q];
      uint4 f4 = make_uint4(0, 0, 0, 0);
      if (FIRST) f4 = reinterpret_cast<const uint4*>(first)[q];
      const unsigned cs[4] = {c4.x, c4.y, c4.z, c4.w};
      const unsigned fs[4] = {f4.x, f4.y, f4.z, f4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (ks[j] == empty) continue;
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

// The counting core of K1, K9 and K13: the countable pairs of ids[0 .. n),
// seg[0 .. n) that the sink takes (K1, K9: both ids below W; K13: every
// pair), added into the sink through the block's table (with their
// smallest positions where the sink keeps them). Chunk c holds the pairs
// at positions c * TILE .. c * TILE + TILE - 1.
template <class Sink>
__device__ void count_pairs(const int* __restrict__ ids,
                            const int* __restrict__ seg, int n,
                            const Sink& sink, int log2) {
  using Key = typename Sink::Key;
  constexpr bool FIRST = Sink::kFirst;
  extern __shared__ uint4 hist_smem[];
  __shared__ int used;  // slots claimed since the last flush
  const int chunks = n >= 2 ? (n - 2) / TILE + 1 : 0;
  const int lo = (int)((long long)blockIdx.x * chunks / gridDim.x);
  const int hi = (int)((long long)(blockIdx.x + 1) * chunks / gridDim.x);
  if (lo >= hi) return;
  const int T = 1 << log2;
  Key* const kmem = reinterpret_cast<Key*>(hist_smem);
  unsigned* const smem = reinterpret_cast<unsigned*>(kmem + T);
  PairTable<Key, FIRST> tab{kmem, smem, FIRST ? smem + T : nullptr, log2};
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
      const Key key = ok ? sink.key(a, b) : ~Key(0);
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
// K13 pair_table and K14 table_select: the sort-round trainer's count and
// selection (minbpe_tpu/ops/train_sortloop.py::_round, :49-83: one stable
// lax.sort of (a, b, position) per round, run lengths as counts, run heads
// as first occurrences; no Pallas site), as a device hash table.
//
// K13 counts every countable pair of ids[0 .. n) (p + 1 < n, seg[p] ==
// seg[p + 1], the rule of K1) into an open-addressing table in device
// memory of 1 << log2 slots: a 64-bit key a << 32 | b (all ones when empty:
// ids are >= 0, so no pair has that key), a count and a first position
// (0xFFFFFFFF when empty). Ids are not packed into fewer bits: a vocab of
// any size fits. It is K1's counting core with HashSink in place of the
// matrices: each block counts its range into a shared-memory table of
// 64-bit keys and flushes it with one global insert per distinct pair, so a
// hot pair costs one global atomic per block (2^20 copies of "a" are one
// pair). A global insert probes linearly from the key's hash; a slot is
// claimed by a 64-bit atomicCAS from empty, and a thread that loses the
// race re-reads the key it lost to, and goes on probing if that key is not
// its own. The claimer appends the slot to a dense list (an atomicAdd on
// used), so that K14 and the reset cost the distinct pairs and not the
// capacity. The capacity is a power of two >= 2 N for the run's first N
// tokens: distinct pairs never exceed n - 1 < N, so the table is at most
// half full and never fills (the wrapper checks it).
//
// K14 reads the listed slots, keeps the largest key count << 32 |
// (0xFFFFFFFF - first) (K5's key: the largest count, then the earliest
// first occurrence; first positions are unique per pair, so the order is
// total and the result does not depend on the order of the atomics), and
// resets each slot it reads, so the table is empty for the next round
// without a host fill. Each block's best goes to scratch; the last block
// to finish (a done counter that it leaves zero again) folds them and
// writes the round's record: sel = (pa, pb, count, ok), ok when a pair was
// found and the gate fail >= i holds, else (-1, -1, 0, 0), which K3
// merges nowhere; log row i (pairs[i], counts[i]; zeros when not ok); and
// fail = i when no pair was found. It also zeroes used. The host reads none
// of it per round. K13 returns at once when fail < i.
//
// Bound: bytes. K13 reads 8 B per token (ids, seg) and writes 16 B per
// distinct pair D (key, count, first); K14 reads those 16 D B. On text the
// shared table absorbs repeats, and the global inserts are probes into a
// table that L2 holds when it is small.
// ---------------------------------------------------------------------------
constexpr unsigned long long EMPTY_PAIR = ~0ull;
constexpr int TABLE_SELECT_GRID = 256;

struct HashSink {
  using Key = unsigned long long;
  static constexpr bool kFirst = true;
  unsigned long long* keys;
  unsigned* cnt;
  unsigned* first;
  int* list;
  int* used;
  int log2;

  __device__ __forceinline__ bool takes(int a, int b) const {
    return a >= 0 && b >= 0;
  }
  __device__ __forceinline__ Key key(int a, int b) const {
    return (unsigned long long)(unsigned)a << 32 | (unsigned)b;
  }
  __device__ void add(Key k, unsigned c, unsigned p) const {
    const size_t mask = ((size_t)1 << log2) - 1;
    size_t s = (size_t)((k * 0x9E3779B97F4A7C15ull) >> (64 - log2));
    for (size_t probe = 0; probe <= mask; ++probe, s = (s + 1) & mask) {
      unsigned long long held =
          reinterpret_cast<volatile unsigned long long*>(keys)[s];
      if (held == EMPTY_PAIR) {
        held = atomicCAS(keys + s, EMPTY_PAIR, k);
        if (held == EMPTY_PAIR) {
          held = k;
          list[atomicAdd(used, 1)] = (int)s;
        }
      }
      if (held == k) {
        atomicAdd(cnt + s, c);
        atomicMin(first + s, p);
        return;
      }
    }
  }
};

__global__ void __launch_bounds__(TPB)
    pair_table_kernel(const int* __restrict__ ids,
                      const int* __restrict__ seg,
                      const int* __restrict__ n_ptr, const int* fail, int i,
                      HashSink sink, int log2) {
  if (fail != nullptr && *fail < i) return;
  count_pairs(ids, seg, *n_ptr, sink, log2);
}

// Block-wide: the largest (k, v) by k of every thread's pair into thread
// 0's return value (other threads' are meaningless); ends synchronised.
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

// scratch: uint64 [done counter][gridDim.x (best key, its pair)]
__global__ void __launch_bounds__(TPB)
    table_select_kernel(HashSink t, int* sel, int* pairs, int* counts,
                        int* fail, int i, unsigned long long* scratch) {
  __shared__ bool last;
  const int used = *t.used;
  unsigned long long best = 0, pair = 0;
  for (int e = blockIdx.x * TPB + threadIdx.x; e < used;
       e += gridDim.x * TPB) {
    const int s = t.list[e];
    const unsigned long long k = sel_key(t.cnt[s], t.first[s]);
    if (k > best) {
      best = k;
      pair = t.keys[s];
    }
    t.keys[s] = EMPTY_PAIR;
    t.cnt[s] = 0u;
    t.first[s] = 0xFFFFFFFFu;
  }
  block_max_pair(best, pair);
  if (threadIdx.x == 0) {
    scratch[1 + 2 * blockIdx.x] = best;
    scratch[2 + 2 * blockIdx.x] = pair;
    __threadfence();
    last = atomicAdd(reinterpret_cast<unsigned*>(scratch), 1u) ==
           gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  best = pair = 0;
  for (int b = threadIdx.x; b < (int)gridDim.x; b += TPB) {
    const unsigned long long k = __ldcg(scratch + 1 + 2 * b);
    if (k > best) {
      best = k;
      pair = __ldcg(scratch + 2 + 2 * b);
    }
  }
  block_max_pair(best, pair);
  if (threadIdx.x != 0) return;
  const int f = *fail;
  const bool ok = best != 0 && f >= i;
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
  *reinterpret_cast<unsigned*>(scratch) = 0u;
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
                                             int pa, int pb) {
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
    const bool mk = p >= 0 && p + 1 < n && id[k] == pa && id[k + 1] == pb &&
                    sg[k] == sg[k + 1];
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
__global__ void __launch_bounds__(TPB)
    merge_apply_kernel(const int* __restrict__ ids,
                       const int* __restrict__ seg,
                       const int* __restrict__ n_ptr,
                       const int* __restrict__ pair, int z, const int* slot,
                       int* __restrict__ ids_out,
                       unsigned char* __restrict__ live, int* kept,
                       unsigned long long* st, unsigned* counter,
                       unsigned gen) {
  if (gated_off(slot, 1, 1)) return;
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
  if (t0 >= n) return;
  stage_tile<false>(ids, seg, t0, n, sh);
  const Lane x = lane_matches(sh, t0, n, pa, pb);
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
  const unsigned lv = valid_mask(t0, n) &
                      ~dead_mask(sh, x, kp, t0, homog, carry);
  const int base = t0 + threadIdx.x * IPT;
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
// written per output token; the lookups go to L2. What bounds K11 on text
// is the latency of its rounds: a chunk of k tokens takes one round per
// distinct rank it applies, each round two dependent L2 probes and a few
// warp votes; a warp has only the chunk's k lanes of work (k ~ 4 on text).
// K12 is K10's cooperative sweep with "the next row of the table" replaced
// by "the lowest rank present": a round looks up every pair of the stream
// and takes a grid min first, so a round costs one grid barrier more than
// a K10 rank, and there are as many rounds as distinct ranks the long
// chunks apply (by the well-foundedness of a merge table, the ranks one
// chunk applies only rise, so the grid min is the minimum of every chunk
// it occurs in, and applying it everywhere is each chunk's own next step).
// ---------------------------------------------------------------------------
constexpr int RANK_INF = 0x7fffffff;
constexpr unsigned MIX_MUL = 0x2C1B3C6Du;
constexpr int CHUNK_MAX = 256;         // tokens of a chunk K11 takes
constexpr int CW = CHUNK_MAX / 32;     // a chunk's words: position 32 k + lane
constexpr int K11_WARPS = 8;           // chunks a block works on at once

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

// The rank of the pair (a, b), RANK_INF where it is absent or b < 0. Both
// probes are issued before either is compared, so their latencies overlap.
__device__ __forceinline__ int ck_rank(const Cuckoo& t, int a, int b) {
  if (b < 0) return RANK_INF;
  const int4 r1 = __ldg(t.rows + ck_hash(a, b, t.s1, t.s2, t.H));
  const int4 r2 = __ldg(t.rows + t.H + ck_hash(a, b, t.s3, t.s4, t.H));
  if (r1.x == a && r1.y == b) return r1.z;
  if (r2.x == a && r2.y == b) return r2.z;
  return RANK_INF;
}

// K11: one warp per chunk of at most CHUNK_MAX tokens, a grid-stride over
// the chunks which[0 .. S). Chunk c is ids[bounds[c] .. bounds[c + 1]); its
// tokens go to out[bounds[c] ..] and their count to lens[c] (-1 for a chunk
// longer than CHUNK_MAX, which the wrapper never sends). Lane l holds the
// chunk's positions 32 k + l in registers (8 words of 32 positions). A
// round: each pair's rank from two probes (the token after a word's last
// lane comes from lane 0 of the next word), the chunk's lowest rank by
// __reduce_min_sync (RANK_INF: done), the matches of that rank as 8 ballots.
// Matches next to each other are a run of one token (a, a); the kept ones
// are the even offsets from each run's start (the reference's left-first
// walk), found per word with an add that carries through the runs, the
// parity carried from word to word. A kept match becomes the rank's new id,
// the token after it dies, and the live tokens go back, compacted by their
// popcount prefix, through the warp's slice of shared memory. Ranks are
// looked up again every round (no rank cache).
__global__ void __launch_bounds__(K11_WARPS * 32)
    chunk_encode_kernel(const int* __restrict__ ids,
                        const int* __restrict__ bounds,
                        const int* __restrict__ which, int S, Cuckoo ck,
                        const int* __restrict__ new_ids,
                        int* __restrict__ out, int* __restrict__ lens) {
  __shared__ int stage[K11_WARPS][CHUNK_MAX];
  constexpr unsigned FULL = 0xffffffffu;
  constexpr unsigned EVEN = 0x55555555u;
  const int lane = threadIdx.x & 31;
  const unsigned below = (1u << lane) - 1;
  int* const sh = stage[threadIdx.x >> 5];
  for (int w = blockIdx.x * K11_WARPS + (threadIdx.x >> 5); w < S;
       w += gridDim.x * K11_WARPS) {
    const int c = which[w];
    const int lo = bounds[c];
    int n = bounds[c + 1] - lo;
    if (n > CHUNK_MAX) {
      if (lane == 0) lens[c] = -1;
      continue;
    }
    int tok[CW];
#pragma unroll
    for (int k = 0; k < CW; ++k) {
      const int p = 32 * k + lane;
      tok[k] = p < n ? ids[lo + p] : -1;
    }
    while (n >= 2) {
      int rk[CW];
      unsigned mn = RANK_INF;
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        rk[k] = RANK_INF;
        if (32 * k < n - 1) {  // warp-uniform: the word holds a pair
          const int dn = __shfl_down_sync(FULL, tok[k], 1);
          const int up = __shfl_sync(FULL, k + 1 < CW ? tok[k + 1] : -1, 0);
          if (32 * k + lane + 1 < n)
            rk[k] = ck_rank(ck, tok[k], lane == 31 ? up : dn);
          mn = min(mn, (unsigned)rk[k]);
        }
      }
      mn = __reduce_min_sync(FULL, mn);
      if (mn == (unsigned)RANK_INF) break;
      const int z = __ldg(new_ids + mn);
      // every lane derives the same kept and live bits from the ballots
      unsigned kept[CW], live[CW];
      unsigned pm = 0, pk = 0;  // the previous word's last match, last keep
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        const unsigned x = __ballot_sync(FULL, rk[k] == (int)mn);
        // run starts; bit 0 continues a run when the last bit before it
        // matched, and is kept then exactly when that bit was not
        const unsigned s = x & ~((x << 1) | pm);
        const unsigned se = (s & EVEN) | (pm & x & (pk ^ 1u));
        // the runs started at even bits (or continued as kept at bit 0):
        // the add carries through each of them
        const unsigned re =
            x & (unsigned)(((unsigned long long)x + se) ^ x);
        const unsigned kp = (re & EVEN) | (x & ~re & ~EVEN);
        const int v = n - 32 * k;
        const unsigned valid = v >= 32 ? FULL : (v > 0 ? (1u << v) - 1 : 0u);
        kept[k] = kp;
        live[k] = valid & ~((kp << 1) | pk);
        pm = x >> 31;
        pk = kp >> 31;
      }
      int base = 0;
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        if ((live[k] >> lane) & 1u)
          sh[base + __popc(live[k] & below)] =
              ((kept[k] >> lane) & 1u) ? z : tok[k];
        base += __popc(live[k]);
      }
      __syncwarp();
      n = base;
#pragma unroll
      for (int k = 0; k < CW; ++k) {
        const int p = 32 * k + lane;
        tok[k] = p < n ? sh[p] : -1;
      }
      __syncwarp();  // every lane has read sh before the next round writes
    }
#pragma unroll
    for (int k = 0; k < CW; ++k) {
      const int p = 32 * k + lane;
      if (p < n) out[lo + p] = tok[k];
    }
    if (lane == 0) lens[c] = n;
  }
}

// A thread's best rank over the pairs at its IPT positions of a staged
// tile, as RANK_INF - rank (0 where it has none), for a max-reduction.
__device__ __forceinline__ int lane_best_rank(const Stage& sh, int t0, int n,
                                              const Cuckoo& ck) {
  const int l0 = threadIdx.x * IPT;
  int id[IPT + 1], sg[IPT + 1];  // positions l0 .. l0 + IPT
#pragma unroll
  for (int v = 0; v < IPT / 4; ++v) {
    unpack4(sh.ids[l0 / 4 + v], id + 4 * v);
    unpack4(sh.seg[l0 / 4 + v], sg + 4 * v);
  }
  id[IPT] = staged_at(sh.ids, sh.halo_id, l0 + IPT);
  sg[IPT] = staged_at(sh.seg, sh.halo_seg, l0 + IPT);
  int best = 0;
#pragma unroll
  for (int k = 0; k < IPT; ++k)
    if (t0 + l0 + k + 1 < n && sg[k] == sg[k + 1])
      best = max(best, RANK_INF - ck_rank(ck, id[k], id[k + 1]));
  return best;
}

// K10 (MIN false): merges r = 0 .. M-1 (pairs[2r], pairs[2r + 1]) ->
// new_ids[r] over ids[0 .. n0), seg[0 .. n0), each applied everywhere, left
// first, and compacted, from one ping-pong buffer into the other.
// K12 (MIN true): the same passes, where each round's merge is the rank r
// of the lowest-rank pair present (from the cuckoo table ck: each block
// takes the best over its tiles, then, past one more grid barrier, every
// block the grid's), until none is.
// The result lands in buffer 0 (w_ids0, w_seg0) and its length in *n_out;
// the input is not written. blk: int32[4 * gridDim.x] (block values: run
// starts, then the live counts, which alternate between two halves by rank,
// so a rank that skips its scatter, and with it a barrier, never
// overwrites counts a slow block still reads; then K12's best ranks).
// Launched cooperatively: every block is resident, so the grid barrier
// holds.
template <bool MIN>
__device__ void sweep(const int* ids, const int* seg, int n0,
                      const int* __restrict__ pairs,
                      const int* __restrict__ new_ids, int M, Cuckoo ck,
                      int* w_ids0, int* w_seg0, int* w_ids1, int* w_seg1,
                      int* blk, int* n_out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ Stage sh;
  __shared__ int o_ids[TILE];
  __shared__ int o_seg[TILE];
  const int G = gridDim.x, b = blockIdx.x;
  if (!MIN && G == 1 && n0 <= TILE) {
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
  for (int i = 0; (MIN || i < M) && n >= 2; ++i) {
    const int T = (n + TILE - 1) / TILE;
    const int lo = (int)((long long)b * T / G);
    const int hi = (int)((long long)(b + 1) * T / G);
    int staged = -1;  // the tile in sh (this rank's source and n)
    auto stage = [&](int t) {
      if (staged != t) stage_tile<true>(src_ids, src_seg, t * TILE, n, sh);
      staged = t;
    };
    int r = i;
    if constexpr (MIN) {  // the lowest rank present
      int best = 0;
      for (int t = lo; t < hi; ++t) {
        stage(t);
        best = max(best, lane_best_rank(sh, t * TILE, n, ck));
      }
      int tile_best;
      block_exclusive_scan<false, TPB>(best, &tile_best);
      if (threadIdx.x == 0) blk[3 * G + b] = tile_best;
      grid.sync();
      r = RANK_INF - block_max(blk + 3 * G, G);
      if (r == RANK_INF) break;
    }
    const int pa = pairs[2 * r], pb = pairs[2 * r + 1], z = new_ids[r];
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
  sweep<false>(ids, seg, n0, pairs, new_ids, M, Cuckoo{}, w_ids0, w_seg0,
               w_ids1, w_seg1, blk, n_out);
}

__global__ void __launch_bounds__(TPB)
    encode_min_sweep_kernel(const int* ids, const int* seg, int n0,
                            Cuckoo ck, const int* __restrict__ pairs,
                            const int* __restrict__ new_ids, int* w_ids0,
                            int* w_seg0, int* w_ids1, int* w_seg1, int* blk,
                            int* n_out) {
  sweep<true>(ids, seg, n0, pairs, new_ids, 0, ck, w_ids0, w_seg0, w_ids1,
              w_seg1, blk, n_out);
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

// the counting core's kernels: K9, K1, K13
enum HistKind { HIST_COUNT = 0, HIST_STATS = 1, HIST_TABLE = 2 };

// K13's shared table: 16 B a slot (a 64-bit key), 4,096 slots by default
// (64 KB: 3 blocks an SM), at most 8,192 (128 KB)
constexpr int TABLE_LOG2 = 12;
constexpr int TABLE_LOG2_MAX = 13;

inline size_t hist_smem_bytes(int kind, int log2) {
  const size_t per = kind == HIST_TABLE ? 16 : kind == HIST_STATS ? 12 : 8;
  return per << log2;
}

inline int hist_log2_max(int kind) {
  return kind == HIST_TABLE ? TABLE_LOG2_MAX : HIST_LOG2_MAX;
}

// K1's (kind 1), K9's (0) or K13's (2) table slots (*log2; 0 chooses the
// default) and grid (*grid; 0 chooses the blocks that fit at once, capped
// at cap's chunks) on the current device; the kernel's shared-memory
// allowance is set once per device.
cudaError_t hist_geometry(int kind, int cap, int* log2, int* grid) {
  static std::atomic<int> sms[64][3];
  static std::atomic<int> per_sm[64][3][HIST_LOG2_MAX + 1];
  const void* fn = kind == HIST_TABLE   ? (const void*)pair_table_kernel
                   : kind == HIST_STATS ? (const void*)pair_stats_kernel
                                        : (const void*)pair_count_kernel;
  if (kind < 0 || kind > 2) return cudaErrorInvalidValue;
  if (*log2 == 0) *log2 = kind == HIST_TABLE ? TABLE_LOG2 : HIST_LOG2;
  if (*log2 < HIST_LOG2_MIN || *log2 > hist_log2_max(kind) || *grid < 0)
    return cudaErrorInvalidValue;
  int dev;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (sms[dev][kind] == 0) {
    int s;
    e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)hist_smem_bytes(kind, hist_log2_max(kind)));
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

}  // namespace

extern "C" {

int bpe_tile_size() { return TILE; }

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

// The grid K1 (kind = 1), K9 (0) or K13 (2) would launch over cap
// positions with 1 << log2 table slots (0: the default) on the current
// device; a negative CUDA error where it has none.
int bpe_pair_hist_grid(int kind, int cap, int log2) {
  int grid = 0;
  const cudaError_t e = hist_geometry(kind, cap, &log2, &grid);
  return e == cudaSuccess ? grid : -(int)e;
}

// K13: the countable pairs of ids[0 .. *n) into the table of 1 << tlog2
// slots (key: uint64, all ones when empty; cnt: uint32, zero; first:
// uint32, 0xFFFFFFFF; list: int32; used: int32[1]; all as K14 leaves them),
// unless fail (may be null) holds a round below i. log2 and grid as for
// bpe_pair_stats.
int bpe_pair_table(const int* ids, const int* seg, const int* n,
                   const int* fail, int i, unsigned long long* key,
                   unsigned* cnt, unsigned* first, int* list, int* used,
                   int tlog2, int cap, int log2, int grid, void* stream) {
  if (tlog2 < 1 || tlog2 > 30) return cudaErrorInvalidValue;
  const cudaError_t e = hist_geometry(HIST_TABLE, cap, &log2, &grid);
  if (e != cudaSuccess) return e;
  const HashSink sink{key, cnt, first, list, used, tlog2};
  pair_table_kernel<<<grid, TPB, hist_smem_bytes(HIST_TABLE, log2),
                      (cudaStream_t)stream>>>(ids, seg, n, fail, i, sink,
                                              log2);
  return cudaGetLastError();
}

// K14's grid; its scratch is uint64[1 + 2 * grid], zero before the first
// call (the last block leaves it zero again)
int bpe_table_select_grid() { return TABLE_SELECT_GRID; }

// K14: the best of the table's listed slots into sel (int32[4]), log row i
// (pairs: int32[M][2], counts: int32[M]) and fail (int32[1]); the slots
// and used are left empty.
int bpe_table_select(unsigned long long* key, unsigned* cnt, unsigned* first,
                     int* list, int* used, int tlog2, int* sel, int* pairs,
                     int* counts, int* fail, int i,
                     unsigned long long* scratch, void* stream) {
  const HashSink t{key, cnt, first, list, used, tlog2};
  table_select_kernel<<<TABLE_SELECT_GRID, TPB, 0, (cudaStream_t)stream>>>(
      t, sel, pairs, counts, fail, i, scratch);
  return cudaGetLastError();
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
// kept = the merge log.
int bpe_merge_apply(const int* ids, const int* seg, const int* n,
                    const int* pair, int z, const int* slot, int cap,
                    int* ids_out, unsigned char* live, int* kept,
                    unsigned long long* state, int gen, void* stream) {
  merge_apply_kernel<<<tiles_for(cap), TPB, 0, (cudaStream_t)stream>>>(
      ids, seg, n, pair, z, slot, ids_out, live, kept, state + 1,
      reinterpret_cast<unsigned*>(state), (unsigned)gen);
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

// K10's (min_sweep 0) or K12's (1) grid for a stream of cap tokens on the
// current device: the blocks that can be resident at once, capped at the
// stream's tiles; a negative CUDA error when the device takes no
// cooperative launch.
int bpe_encode_grid(int cap, int min_sweep) {
  int dev, coop, sms, per;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = min_sweep ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                        &per, encode_min_sweep_kernel, TPB, 0)
                  : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
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
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K11 over the chunks which[0 .. S) (S >= 1) of ids, chunk c being
// ids[bounds[c] .. bounds[c + 1]) with at most CHUNK_MAX tokens. rows:
// int32[2 H][4], 16-byte aligned, H a power of two; seeds s1 .. s4 as in
// ops/ranktab.py; new_ids: int32[M] by rank. Writes each chunk's tokens to
// out[bounds[c] ..] and their count to lens[c]. A grid-stride over the
// chunks: at most the blocks that fit on the device at once.
int bpe_chunk_encode(const int* ids, const int* bounds, const int* which,
                     int S, const int* rows, int H, unsigned s1, unsigned s2,
                     unsigned s3, unsigned s4, const int* new_ids, int* out,
                     int* lens, void* stream) {
  int dev, sms;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int want = (S + K11_WARPS - 1) / K11_WARPS;
  const int most = sms * (2048 / (K11_WARPS * 32));
  const Cuckoo ck{reinterpret_cast<const int4*>(rows), H, s1, s2, s3, s4};
  chunk_encode_kernel<<<want < most ? want : most, K11_WARPS * 32, 0,
                        (cudaStream_t)stream>>>(ids, bounds, which, S, ck,
                                                new_ids, out, lens);
  return cudaGetLastError();
}

// K12 over ids[0 .. n), seg[0 .. n); rows, H and the seeds as for K11;
// pairs: int32[M][2] and new_ids: int32[M] by rank; w_*: int32[max(n, 1)]
// each, 16-byte aligned; blk: int32[4 * grid]; n_out: int32[1]. The result
// is in w_ids0, w_seg0. A refused cooperative launch returns its error.
int bpe_encode_min_sweep(const int* ids, const int* seg, int n,
                         const int* rows, int H, unsigned s1, unsigned s2,
                         unsigned s3, unsigned s4, const int* pairs,
                         const int* new_ids, int* w_ids0, int* w_seg0,
                         int* w_ids1, int* w_seg1, int* blk, int grid,
                         int* n_out, void* stream) {
  Cuckoo ck{reinterpret_cast<const int4*>(rows), H, s1, s2, s3, s4};
  void* args[] = {&ids,    &seg,    &n,      &ck,     &pairs, &new_ids,
                  &w_ids0, &w_seg0, &w_ids1, &w_seg1, &blk,   &n_out};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)encode_min_sweep_kernel, dim3(grid), dim3(TPB), args, 0,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // extern "C"
