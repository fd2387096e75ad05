// Hand-written Hopper (sm_90a) kernels of the BPE main path: training and
// rank-sweep encode over a DENSE token stream.
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
//                        _adjcount_kernel (fused_train_xl.py:74-157)
//   K5 select_batch   <- the selection walk sel_body + select_candidate +
//                        no_pair (fused_train.py:915-1000, :1042-1084,
//                        :1118-1123); _adjcount_kernel's _select
//                        (fused_train_xl.py:158-173), _tie_kernel (:176-244)
//                        and _train_xl's walk (:689-731)
//   K3 merge_apply    <- tiled_apply (fused_train.py:293-340), _apply_kernel
//                        (fused_train_xl.py:247-297) and the per-rank body of
//                        the encoder (fused_encode.py:58-87)
//   K6 batch_mark     <- tiled_batch_mark (fused_train.py:452-521),
//                        _mark_kernel (fused_train_xl.py:328-389)
//   K7 batch_hist_rev <- tiled_batch_hist_rev (fused_train.py:524-593),
//                        _histrev_kernel (fused_train_xl.py:392-439)
//   K8 batch_apply    <- the trim (fused_train.py:1140-1153) and
//                        tiled_batch_apply (:596-634), _batch_apply_kernel
//                        (fused_train_xl.py:442-508)
//   K4 compact        <- _compact_inplace (fused_train.py:641-736),
//                        _compact_kernel (fused_train_xl.py:300-326) and the
//                        encoder's output compaction (fused_encode.py:91-119)
//   K9 pair_count     <- ops/pallas/pair_count.py::_kernel (:29-53), the
//                        dense pair-count matrix of the selection paths
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
// are still queued. The gates: K3 runs when bsel == 1, K6-K8 when
// bsel >= 2, K4 when bsel >= 1; an idle slot has bsel = 0.
//
// Each extern "C" entry point launches on the caller's stream, allocates
// nothing, and returns cudaGetLastError() (0 on success).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libbpe_kernels.so bpe_kernels.cu

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TPB = 256;              // threads per block, tiled kernels
constexpr int IPT = 4;                // consecutive items per thread
constexpr int TILE = TPB * IPT;       // stream positions per block
constexpr int SCAN_TPB = 1024;        // threads of the one-block tile scan
constexpr int SCAN_CHUNK = SCAN_TPB * 4;
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

// K5's block: SEL_IPT matrix entries per thread
constexpr int SEL_IPT = 16;
constexpr int SEL_TILE = TPB * SEL_IPT;

__device__ __forceinline__ bool idle(const int* ctl) {
  return ctl != nullptr && ctl[CTL_I] >= ctl[CTL_FAIL];
}

// a slot-mode kernel runs only when lo <= bsel <= hi
__device__ __forceinline__ bool gated_off(const int* slot, int lo, int hi) {
  if (slot == nullptr) return false;
  const int b = slot[SLOT_BSEL];
  return b < lo || b > hi;
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
// K1 pair_stats: exact pair counts and first positions over the live prefix.
//
// The matrices are V x V (row stride V); the ids present are below
// W = 256 + i (the trainer's ctl) or W = V (no ctl). The clear kernel resets
// the W x W corner (cnt to 0, first to 0xFFFFFFFF, read as -1 from int32);
// entries outside it are never written, so they keep the 0 / -1 they were
// allocated with. Then cnt[a * V + b] += 1 and first[a * V + b] =
// min(position) for every countable pair (a, b) with a, b < W.
//
// Bound: the atomics, not the bytes (8 B read per token, 8 B per matrix
// entry written). A hot pair (" t", "e ") sends thousands of atomics to one
// address, and those serialize in L2. Each warp therefore aggregates equal
// pairs with __match_any_sync first: one atomicAdd of the group size and one
// atomicMin of the group's lowest lane, which holds its lowest position.
// Over the whole stream this is B3's count: segments were a VMEM limit, and
// 48M tokens of ids and seg are 384 MB of the card's 80 GB.
// ---------------------------------------------------------------------------
__device__ __forceinline__ int width_of(const int* ctl, int V) {
  return ctl == nullptr ? V : min(V, 256 + ctl[CTL_I]);
}

__global__ void clear_stats_kernel(const int* ctl, unsigned* __restrict__ cnt,
                                   unsigned* __restrict__ first, int V) {
  if (idle(ctl)) return;
  const int W = width_of(ctl, V);
  const int WW = W * W;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < WW;
       idx += gridDim.x * blockDim.x) {
    const int e = (idx / W) * V + idx % W;
    cnt[e] = 0u;
    first[e] = 0xFFFFFFFFu;
  }
}

__global__ void pair_stats_kernel(const int* __restrict__ ids,
                                  const int* __restrict__ seg,
                                  const int* __restrict__ n_ptr,
                                  const int* ctl,
                                  unsigned* __restrict__ cnt,
                                  unsigned* __restrict__ first, int V) {
  if (idle(ctl)) return;
  const int W = width_of(ctl, V);
  const int n = *n_ptr;
  const int stride = gridDim.x * blockDim.x;
  // the loop bound depends on the block only, so whole warps iterate
  // together and __match_any_sync sees every lane
  for (int base = blockIdx.x * blockDim.x; base < n - 1; base += stride) {
    const int i = base + threadIdx.x;
    int key = -1;
    if (i < n - 1 && seg[i] == seg[i + 1]) {
      const int a = ids[i];
      const int b = ids[i + 1];
      if (a >= 0 && a < W && b >= 0 && b < W) key = a * V + b;
    }
    const unsigned group = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && (threadIdx.x & 31) == __ffs(group) - 1) {
      atomicAdd(&cnt[key], (unsigned)__popc(group));
      atomicMin(&first[key], (unsigned)i);
    }
  }
}

// ---------------------------------------------------------------------------
// K9 pair_count: the dense V x V pair-count matrix of a stream, without
// first positions and without the trainer's state.
//
// The Pallas kernel builds bf16 one-hot slabs of each (8, 256) tile of pairs
// and accumulates (V, 256) @ (256, V) MXU products into a VMEM (V, V)
// accumulator: 2 N V^2 operations for what is a histogram of N entries. This
// is the histogram: cnt[a * V + b] += 1 for every p with p + 1 < n,
// seg[p] == seg[p + 1] and 0 <= a, b < V, (a, b) = (ids[p], ids[p + 1]); an
// id outside [0, V) has an all-zero one-hot row there and counts nowhere
// here. The clear is a memset of the matrix. One thread per position, in a
// grid-stride loop whose bound depends on the block only, so a warp
// aggregates equal pairs with __match_any_sync: one atomicAdd of the group
// size per distinct pair.
//
// Bound: bytes (8 B read per token, 4 B per matrix entry cleared and
// written); the matrix (16 MB at V = 2048) stays in L2, where the atomics of
// a hot pair serialize.
// ---------------------------------------------------------------------------
__global__ void pair_count_kernel(const int* __restrict__ ids,
                                  const int* __restrict__ seg,
                                  const int* __restrict__ n_ptr,
                                  unsigned* __restrict__ cnt, int V) {
  const int n = *n_ptr;
  const int stride = gridDim.x * blockDim.x;
  for (int base = blockIdx.x * blockDim.x; base < n - 1; base += stride) {
    const int i = base + threadIdx.x;
    long long key = -1;
    if (i < n - 1 && seg[i] == seg[i + 1]) {
      const int a = ids[i];
      const int b = ids[i + 1];
      if (a >= 0 && a < V && b >= 0 && b < V) key = (long long)a * V + b;
    }
    const unsigned group = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && (threadIdx.x & 31) == __ffs(group) - 1)
      atomicAdd(&cnt[key], (unsigned)__popc(group));
  }
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
// tie walk is needed, and no 64-tie cliff exists.
//
// Each block takes SEL_TILE entries of the W x W corner into registers and
// extracts its top K_CAP by K_CAP rounds of a block max; the last block to
// finish (a done counter, reset by that block) merges the blocks' lists the
// same way, and its thread 0 walks them: candidate j is accepted while its
// count is > 0 and either j == 0, or it is heterogeneous, candidate 0 is
// heterogeneous, and it shares no cross-side token with an accepted one
// (qa != every accepted pb, qb != every accepted pa). The walk stops at the
// first rejection (fused_train.py:1059-1064). It writes the slot record,
// counts the rebuild, sets fail = i when nothing was accepted, and for a
// single merge writes log row i and advances i.
//
// Bound: bytes (8 B per W x W entry read; 8 MB at W = 1024, which L2 holds).
// ---------------------------------------------------------------------------
__device__ __forceinline__ unsigned long long ullmax(unsigned long long a,
                                                     unsigned long long b) {
  return a > b ? a : b;
}

// The K_CAP largest of the block's TPB * SEL_IPT keys (unique, except 0),
// in descending order, into top[] (shared); zeros fill the tail.
__device__ void block_top_keys(unsigned long long (&k)[SEL_IPT],
                               unsigned long long* top) {
  __shared__ unsigned long long warp_max[TPB / 32];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  for (int r = 0; r < K_CAP; ++r) {
    unsigned long long m = 0;
#pragma unroll
    for (int q = 0; q < SEL_IPT; ++q) m = ullmax(m, k[q]);
#pragma unroll
    for (int d = 16; d > 0; d >>= 1)
      m = ullmax(m, __shfl_xor_sync(0xffffffffu, m, d));
    if (lane == 0) warp_max[wid] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
      unsigned long long b = 0;
      for (int w = 0; w < TPB / 32; ++w) b = ullmax(b, warp_max[w]);
      top[r] = b;
    }
    __syncthreads();
    const unsigned long long best = top[r];
    if (best == 0) {  // the same in every thread: the rest is empty
      if (threadIdx.x < K_CAP - r - 1) top[r + 1 + threadIdx.x] = 0;
      __syncthreads();
      return;
    }
#pragma unroll
    for (int q = 0; q < SEL_IPT; ++q)
      if (k[q] == best) k[q] = 0;
  }
}

__global__ void select_batch_kernel(const unsigned* __restrict__ cnt,
                                    const unsigned* __restrict__ first, int V,
                                    const int* __restrict__ ids, int* ctl,
                                    int* slot, int* log,
                                    unsigned long long* scratch) {
  __shared__ unsigned long long top[K_CAP];
  __shared__ bool last;
  if (idle(ctl)) {
    if (blockIdx.x == 0 && threadIdx.x == 0) slot[SLOT_BSEL] = 0;
    return;
  }
  const int i = ctl[CTL_I];
  const int W = width_of(ctl, V);
  const int WW = W * W;
  unsigned long long* lists = scratch + 1;
  unsigned* done = (unsigned*)scratch;

  unsigned long long k[SEL_IPT];
#pragma unroll
  for (int q = 0; q < SEL_IPT; ++q) {
    const int idx = blockIdx.x * SEL_TILE + q * TPB + threadIdx.x;
    k[q] = 0;
    if (idx < WW) {
      const int e = (idx / W) * V + idx % W;
      const unsigned c = cnt[e];
      if (c) k[q] = ((unsigned long long)c << 32) | (0xFFFFFFFFu - first[e]);
    }
  }
  block_top_keys(k, top);
  if (threadIdx.x < K_CAP) lists[blockIdx.x * K_CAP + threadIdx.x] =
      top[threadIdx.x];
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(done, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();

  // merge the blocks' lists: gridDim.x * K_CAP <= TPB * SEL_IPT keys
#pragma unroll
  for (int q = 0; q < SEL_IPT; ++q) {
    const int idx = q * TPB + threadIdx.x;
    k[q] = idx < gridDim.x * K_CAP ? __ldcg(&lists[idx]) : 0ull;
  }
  block_top_keys(k, top);
  if (threadIdx.x != 0) return;

  int pa_v[K_CAP], pb_v[K_CAP], c_v[K_CAP];
  int bsel = 0;
  for (int j = 0; j < K_CAP; ++j) {
    const unsigned long long key = top[j];
    if (key == 0) break;
    const int pos = (int)(0xFFFFFFFFu - (unsigned)(key & 0xFFFFFFFFull));
    const int pa = ids[pos];
    const int pb = ids[pos + 1];
    if (j > 0) {
      bool ok = pa != pb && pa_v[0] != pb_v[0];
      for (int q = 0; q < bsel; ++q)
        ok = ok && pa_v[q] != pb && pb_v[q] != pa;
      if (!ok) break;
    }
    pa_v[bsel] = pa;
    pb_v[bsel] = pb;
    c_v[bsel] = (int)(key >> 32);
    ++bsel;
  }
  for (int j = 0; j < K_CAP; ++j) {
    slot[SLOT_PAIRS + 2 * j] = j < bsel ? pa_v[j] : -1;
    slot[SLOT_PAIRS + 2 * j + 1] = j < bsel ? pb_v[j] : -1;
    slot[SLOT_COUNT + j] = j < bsel ? c_v[j] : 0;
  }
  slot[SLOT_BSEL] = bsel;
  slot[SLOT_ZBASE] = 256 + i;
  slot[SLOT_I] = i;
  slot[SLOT_BSTAR] = bsel == 1 ? 1 : 0;
  ctl[CTL_REBUILDS] += 1;
  if (bsel == 0) {
    ctl[CTL_FAIL] = i;
  } else if (bsel == 1) {
    log[4 * i + 0] = pa_v[0];
    log[4 * i + 1] = pb_v[0];
    log[4 * i + 2] = c_v[0];
    log[4 * i + 3] = 0;  // K3 adds the kept count
    ctl[CTL_I] = i + 1;
  }
  *done = 0u;
}

// ---------------------------------------------------------------------------
// K3 merge_apply: apply (pa, pb) -> z at every occurrence, left first.
//
// m[i] = match at i. A match is kept when its distance from the start of its
// run of consecutive matches is even (a run only exists when pa == pb: a
// run of k equal tokens keeps the even offsets, as the reference's
// left-to-right walk does). The token after a kept match dies.
//   ids_out[i] = kept ? z : ids[i];  live[i] = !kept[i - 1];
//   *kept += number of kept matches (what leaves the live count).
// In slot mode (the trainer) the pair is the slot's candidate 0, z is its
// 256 + i, the kept count goes to log row i, and it runs only for bsel == 1.
//
// Run starts come from an inclusive max-scan of "i if a run starts at i",
// carried across tiles by a second, one-block scan of per-tile maxima, so a
// run of L equal tokens costs O(L) and not O(L^2) (a 1 MB run of one byte is
// the case to survive). For pa != pb every match starts its own run; the
// tile passes see that from the pair and return at once.
//
// Bound: bytes (8 B read, 5 B written per live token).
// ---------------------------------------------------------------------------
__device__ __forceinline__ bool match_at(const int* ids, const int* seg, int i,
                                         int n, int pa, int pb) {
  return i >= 0 && i + 1 < n && ids[i] == pa && ids[i + 1] == pb &&
         seg[i] == seg[i + 1];
}

__global__ void run_starts_kernel(const int* __restrict__ ids,
                                  const int* __restrict__ seg,
                                  const int* __restrict__ n_ptr,
                                  const int* __restrict__ pair,
                                  const int* slot, int* __restrict__ agg) {
  if (gated_off(slot, 1, 1)) return;
  const int pa = pair[0], pb = pair[1];
  if (pa != pb) return;
  const int n = *n_ptr;
  const int t0 = blockIdx.x * TILE;
  if (t0 >= n) return;
  int s = -1;
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = t0 + k * TPB + threadIdx.x;
    if (match_at(ids, seg, i, n, pa, pb) &&
        !match_at(ids, seg, i - 1, n, pa, pb))
      s = max(s, i);
  }
  int tile_max;
  block_exclusive_scan<false, TPB>(s, &tile_max);
  if (threadIdx.x == 0) agg[blockIdx.x] = tile_max;
}

// One block: exclusive scan of the per-tile values agg[0 .. ceil(n/TILE)),
// in place, in chunks with a running carry (no limit on the tile count).
// Gated on the slot's bsel in [lo, hi]. With `pair` given it runs only for a
// homogeneous pair (K3's run starts); with `total` given it stores the grand
// total there (K4's new length).
template <bool SUM>
__global__ void scan_tiles_kernel(int* agg, const int* __restrict__ n_ptr,
                                  const int* slot, int lo, int hi,
                                  const int* pair, int* total) {
  if (gated_off(slot, lo, hi)) return;
  if (pair != nullptr && pair[0] != pair[1]) return;
  const int nb = (*n_ptr + TILE - 1) / TILE;
  int carry = identity<SUM>();
  for (int c0 = 0; c0 < nb; c0 += SCAN_CHUNK) {
    int loc[4];
    int t = identity<SUM>();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = c0 + threadIdx.x * 4 + k;
      loc[k] = t;
      t = op<SUM>(t, idx < nb ? agg[idx] : identity<SUM>());
    }
    int chunk_total;
    const int ex = block_exclusive_scan<SUM, SCAN_TPB>(t, &chunk_total);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int idx = c0 + threadIdx.x * 4 + k;
      if (idx < nb) agg[idx] = op<SUM>(carry, op<SUM>(ex, loc[k]));
    }
    carry = op<SUM>(carry, chunk_total);
  }
  if (total != nullptr && threadIdx.x == 0) *total = carry;
}

__global__ void merge_apply_kernel(const int* __restrict__ ids,
                                   const int* __restrict__ seg,
                                   const int* __restrict__ n_ptr,
                                   const int* __restrict__ pair, int z,
                                   const int* slot,
                                   const int* __restrict__ prefix,
                                   int* __restrict__ ids_out,
                                   unsigned char* __restrict__ live,
                                   int* kept) {
  if (gated_off(slot, 1, 1)) return;
  const int n = *n_ptr;
  const int t0 = blockIdx.x * TILE;
  if (t0 >= n) return;
  const int pa = pair[0], pb = pair[1];
  if (slot != nullptr) {
    z = slot[SLOT_ZBASE];
    kept += 4 * slot[SLOT_I] + 3;  // kept points at the merge log
  }
  const bool homog = pa == pb;
  // latest run start before this tile (only read for a homogeneous pair)
  const int pre = homog ? prefix[blockIdx.x] : -1;

  __shared__ unsigned char keep_sh[TILE + 1];  // [0] = keep at t0 - 1
  const int base = t0 + threadIdx.x * IPT;
  bool m[IPT];
  int s[IPT];
  int run = -1;
  bool prev = match_at(ids, seg, base - 1, n, pa, pb);
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    m[k] = match_at(ids, seg, base + k, n, pa, pb);
    if (m[k] && !prev) run = base + k;
    s[k] = run;  // thread-local inclusive max-scan of run starts
    prev = m[k];
  }
  int unused;
  const int carry = max(pre, block_exclusive_scan<false, TPB>(run, &unused));
  int nkeep = 0;
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = base + k;
    const bool kp = m[k] && (!homog || ((i - max(carry, s[k])) & 1) == 0);
    keep_sh[threadIdx.x * IPT + k + 1] = kp;
    nkeep += kp;
  }
  if (threadIdx.x == 0) {
    const int j = t0 - 1;
    keep_sh[0] = match_at(ids, seg, j, n, pa, pb) &&
                 (!homog || ((j - pre) & 1) == 0);
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = base + k;
    const int t = threadIdx.x * IPT + k;
    if (i < n) {
      ids_out[i] = keep_sh[t + 1] ? z : ids[i];
      live[i] = !keep_sh[t];
    }
  }
  if (kept != nullptr) {
    int tile_kept;
    block_exclusive_scan<true, TPB>(nkeep, &tile_kept);
    if (threadIdx.x == 0 && tile_kept) atomicAdd(kept, tile_kept);
  }
}

// ---------------------------------------------------------------------------
// The batch (bsel >= 2): K6, K7, K8.
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
// p - 1 and p + 2. K6 and K7 are one elementwise pass each, with the
// histogram in shared memory per block (shared atomics) and one global
// atomic per non-zero bin; K8 is a one-block trim and one elementwise pass.
// Bound: bytes. K6 reads ids and seg (8 B per token) and writes cand and F
// (8 B); K7 reads cand, F, ids and seg (16 B); K8 reads ids and cand and
// writes ids and live (13 B).
// ---------------------------------------------------------------------------
__device__ __forceinline__ int cand_at(const int* ids, const int* seg, int q,
                                       int n, const int* pairs, int bsel) {
  if (q < 0 || q + 1 >= n || seg[q] != seg[q + 1]) return -1;
  const int a = ids[q], b = ids[q + 1];
  for (int j = 0; j < bsel; ++j)
    if (pairs[2 * j] == a && pairs[2 * j + 1] == b) return j;
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

__device__ __forceinline__ void hist_flush(const int* h, int* acc) {
  __syncthreads();
  for (int t = threadIdx.x; t < HIST; t += blockDim.x)
    if (h[t]) atomicAdd(&acc[t], h[t]);
}

__global__ void batch_mark_kernel(const int* __restrict__ ids,
                                  const int* __restrict__ seg,
                                  const int* __restrict__ n_ptr,
                                  const int* __restrict__ slot,
                                  int* __restrict__ cand,
                                  int* __restrict__ F, int* acc_l) {
  if (gated_off(slot, 2, K_CAP)) return;
  __shared__ int pairs[2 * K_CAP];
  __shared__ int h[HIST];
  const int bsel = slot[SLOT_BSEL];
  const int zbase = slot[SLOT_ZBASE];
  if (threadIdx.x < 2 * K_CAP) pairs[threadIdx.x] = slot[threadIdx.x];
  for (int t = threadIdx.x; t < HIST; t += blockDim.x) h[t] = 0;
  __syncthreads();
  const int n = *n_ptr;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += gridDim.x * blockDim.x) {
    const int c0 = cand_at(ids, seg, p, n, pairs, bsel);
    const int c1 = cand_at(ids, seg, p - 1, n, pairs, bsel);
    cand[p] = c0;
    F[p] = c0 >= 0 ? zbase + c0 : (c1 >= 0 ? zbase + c1 : ids[p]);
    if (c0 >= 0 && p >= 1 && seg[p - 1] == seg[p]) {
      const int c2 = cand_at(ids, seg, p - 2, n, pairs, bsel);
      const int v = c1 >= 0 ? zbase + c1 : (c2 >= 0 ? zbase + c2 : ids[p - 1]);
      hist_add(h, v, ids[p - 1], zbase, c0);
    }
  }
  hist_flush(h, acc_l);
}

__global__ void batch_hist_rev_kernel(const int* __restrict__ ids,
                                      const int* __restrict__ seg,
                                      const int* __restrict__ n_ptr,
                                      const int* __restrict__ cand,
                                      const int* __restrict__ F,
                                      const int* __restrict__ slot,
                                      int* acc_r) {
  if (gated_off(slot, 2, K_CAP)) return;
  __shared__ int h[HIST];
  const int zbase = slot[SLOT_ZBASE];
  for (int t = threadIdx.x; t < HIST; t += blockDim.x) h[t] = 0;
  __syncthreads();
  const int n = *n_ptr;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += gridDim.x * blockDim.x) {
    const int c0 = cand[p];
    if (c0 >= 0 && p + 2 < n && seg[p + 2] == seg[p])
      hist_add(h, F[p + 2], ids[p + 2], zbase, c0);
  }
  hist_flush(h, acc_r);
}

// The trim, one block: cm[j] = max over buckets of column j of acc_l and
// acc_r; bstar = the longest prefix whose every later count strictly beats
// the running max of cm[0 .. k-1], at most M - i. Writes log rows
// i .. i + bstar - 1 (kept added by the apply), clears both histograms for
// the next slot, and advances i.
__global__ void batch_trim_kernel(int* acc, int* slot, int* ctl, int* log,
                                  int M) {
  if (gated_off(slot, 2, K_CAP)) return;
  __shared__ int cm[K_CAP];
  if (threadIdx.x < K_CAP) cm[threadIdx.x] = 0;
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * HIST; t += blockDim.x) {
    const int v = acc[t];
    if (v) atomicMax(&cm[t % K_CAP], v);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 2 * HIST; t += blockDim.x) acc[t] = 0;
  if (threadIdx.x != 0) return;
  const int bsel = slot[SLOT_BSEL];
  const int i = slot[SLOT_I];
  int bstar = 1;
  int bnd = cm[0];
  for (int k = 1; k < K_CAP; ++k) {
    if (k < bsel && bstar == k && slot[SLOT_COUNT + k] > bnd) {
      bstar = k + 1;
      bnd = max(bnd, cm[k]);
    }
  }
  bstar = min(bstar, M - i);
  slot[SLOT_BSTAR] = bstar;
  for (int j = 0; j < bstar; ++j) {
    log[4 * (i + j) + 0] = slot[SLOT_PAIRS + 2 * j];
    log[4 * (i + j) + 1] = slot[SLOT_PAIRS + 2 * j + 1];
    log[4 * (i + j) + 2] = slot[SLOT_COUNT + j];
    log[4 * (i + j) + 3] = 0;
  }
  ctl[CTL_I] = i + bstar;
}

// The apply: every site whose candidate is below bstar becomes
// zbase + cand, and its next token dies; per-candidate kept counts go to
// column 3 of log rows i + j.
__global__ void batch_apply_kernel(const int* __restrict__ ids,
                                   const int* __restrict__ n_ptr,
                                   const int* __restrict__ cand,
                                   const int* __restrict__ slot,
                                   int* __restrict__ ids_out,
                                   unsigned char* __restrict__ live,
                                   int* log) {
  if (gated_off(slot, 2, K_CAP)) return;
  __shared__ int kept[K_CAP];
  if (threadIdx.x < K_CAP) kept[threadIdx.x] = 0;
  __syncthreads();
  const int bstar = slot[SLOT_BSTAR];
  const int zbase = slot[SLOT_ZBASE];
  const int n = *n_ptr;
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n;
       p += gridDim.x * blockDim.x) {
    const int c0 = cand[p];
    const bool k0 = c0 >= 0 && c0 < bstar;
    const int c1 = p > 0 ? cand[p - 1] : -1;
    ids_out[p] = k0 ? zbase + c0 : ids[p];
    live[p] = !(c1 >= 0 && c1 < bstar);
    if (k0) atomicAdd(&kept[c0], 1);
  }
  __syncthreads();
  if (threadIdx.x < K_CAP && kept[threadIdx.x])
    atomicAdd(&log[4 * (slot[SLOT_I] + threadIdx.x) + 3], kept[threadIdx.x]);
}

// ---------------------------------------------------------------------------
// K4 compact: order-preserving compaction of ids and seg by the live mask.
// Per-tile live counts, a one-block exclusive scan of them (which also
// yields the new length), then each tile scatters its live tokens to its
// offset plus its in-tile exclusive scan. Order is kept, so first positions
// keep the reference's first-occurrence order. In slot mode it runs when
// the slot applied a merge (bsel >= 1).
//
// Bound: bytes (9 B read per token, 8 B written per live token).
// ---------------------------------------------------------------------------
__global__ void live_count_kernel(const unsigned char* __restrict__ live,
                                  const int* __restrict__ n_ptr,
                                  const int* slot, int* __restrict__ agg) {
  if (gated_off(slot, 1, K_CAP)) return;
  const int n = *n_ptr;
  const int t0 = blockIdx.x * TILE;
  if (t0 >= n) return;
  int c = 0;
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    const int i = t0 + k * TPB + threadIdx.x;
    if (i < n) c += live[i];
  }
  int tile_count;
  block_exclusive_scan<true, TPB>(c, &tile_count);
  if (threadIdx.x == 0) agg[blockIdx.x] = tile_count;
}

__global__ void compact_scatter_kernel(const int* __restrict__ ids,
                                       const int* __restrict__ seg,
                                       const unsigned char* __restrict__ live,
                                       const int* __restrict__ n_ptr,
                                       const int* slot,
                                       const int* __restrict__ offs,
                                       int* __restrict__ ids_out,
                                       int* __restrict__ seg_out) {
  if (gated_off(slot, 1, K_CAP)) return;
  const int n = *n_ptr;
  const int t0 = blockIdx.x * TILE;
  if (t0 >= n) return;
  const int base = t0 + threadIdx.x * IPT;
  bool f[IPT];
  int c = 0;
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    f[k] = base + k < n && live[base + k];
    c += f[k];
  }
  int unused;
  int o = offs[blockIdx.x] + block_exclusive_scan<true, TPB>(c, &unused);
#pragma unroll
  for (int k = 0; k < IPT; ++k) {
    if (f[k]) {
      ids_out[o] = ids[base + k];
      seg_out[o] = seg[base + k];
      ++o;
    }
  }
}

inline int tiles_for(int cap) { return cap > 0 ? (cap + TILE - 1) / TILE : 1; }

inline int stat_blocks(long long items) {
  long long g = (items + TPB - 1) / TPB;
  return g < 1 ? 1 : (g > MAX_STAT_BLOCKS ? MAX_STAT_BLOCKS : (int)g);
}

}  // namespace

extern "C" {

int bpe_tile_size() { return TILE; }

int bpe_select_blocks(int V) { return (V * V + SEL_TILE - 1) / SEL_TILE; }

// cnt, first: V x V; ctl may be null (W = V)
int bpe_pair_stats(const int* ids, const int* seg, const int* n,
                   const int* ctl, unsigned* cnt, unsigned* first, int V,
                   int cap, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  clear_stats_kernel<<<stat_blocks((long long)V * V), TPB, 0, s>>>(
      ctl, cnt, first, V);
  pair_stats_kernel<<<stat_blocks(cap), TPB, 0, s>>>(ids, seg, n, ctl, cnt,
                                                     first, V);
  return cudaGetLastError();
}

// cnt: V x V, overwritten
int bpe_pair_count(const int* ids, const int* seg, const int* n,
                   unsigned* cnt, int V, int cap, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      cudaMemsetAsync(cnt, 0, (size_t)V * V * sizeof(unsigned), s);
  if (e != cudaSuccess) return e;
  pair_count_kernel<<<stat_blocks(cap), TPB, 0, s>>>(ids, seg, n, cnt, V);
  return cudaGetLastError();
}

// scratch: uint64[1 + bpe_select_blocks(V) * 16], zero before the first call
// (the last block leaves it zero again)
int bpe_select_batch(const unsigned* cnt, const unsigned* first, int V,
                     const int* ids, int* ctl, int* slot, int* log,
                     unsigned long long* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = bpe_select_blocks(V);
  if (nb * K_CAP > SEL_TILE) return cudaErrorInvalidValue;  // V > 1024
  select_batch_kernel<<<nb, TPB, 0, s>>>(cnt, first, V, ids, ctl, slot, log,
                                         scratch);
  return cudaGetLastError();
}

// agg: int32[tiles_for(cap)] scratch; kept may be null. With slot given:
// pair = slot, z and kept's row from the slot, kept = the merge log.
int bpe_merge_apply(const int* ids, const int* seg, const int* n,
                    const int* pair, int z, const int* slot, int cap,
                    int* ids_out, unsigned char* live, int* kept, int* agg,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = tiles_for(cap);
  run_starts_kernel<<<nb, TPB, 0, s>>>(ids, seg, n, pair, slot, agg);
  scan_tiles_kernel<false><<<1, SCAN_TPB, 0, s>>>(agg, n, slot, 1, 1, pair,
                                                  nullptr);
  merge_apply_kernel<<<nb, TPB, 0, s>>>(ids, seg, n, pair, z, slot, agg,
                                        ids_out, live, kept);
  return cudaGetLastError();
}

// cand, F: int32[cap]; acc_l: int32[128 * 16], accumulated into
int bpe_batch_mark(const int* ids, const int* seg, const int* n,
                   const int* slot, int cap, int* cand, int* F, int* acc_l,
                   void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  batch_mark_kernel<<<stat_blocks(cap), TPB, 0, s>>>(ids, seg, n, slot, cand,
                                                     F, acc_l);
  return cudaGetLastError();
}

// acc_r: int32[128 * 16], accumulated into
int bpe_batch_hist_rev(const int* ids, const int* seg, const int* n,
                       const int* cand, const int* F, const int* slot,
                       int cap, int* acc_r, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  batch_hist_rev_kernel<<<stat_blocks(cap), TPB, 0, s>>>(ids, seg, n, cand, F,
                                                         slot, acc_r);
  return cudaGetLastError();
}

// acc: int32[2 * 128 * 16] (acc_l then acc_r), cleared here; log: (M, 4)
int bpe_batch_apply(const int* ids, const int* n, const int* cand, int* slot,
                    int* acc, int* ctl, int* log, int M, int cap,
                    int* ids_out, unsigned char* live, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  batch_trim_kernel<<<1, TPB, 0, s>>>(acc, slot, ctl, log, M);
  batch_apply_kernel<<<stat_blocks(cap), TPB, 0, s>>>(ids, n, cand, slot,
                                                      ids_out, live, log);
  return cudaGetLastError();
}

// agg: int32[tiles_for(cap)] scratch; n_out: int32[1]
int bpe_compact(const int* ids, const int* seg, const unsigned char* live,
                const int* n, const int* slot, int cap, int* ids_out,
                int* seg_out, int* n_out, int* agg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = tiles_for(cap);
  live_count_kernel<<<nb, TPB, 0, s>>>(live, n, slot, agg);
  scan_tiles_kernel<true><<<1, SCAN_TPB, 0, s>>>(agg, n, slot, 1, K_CAP,
                                                 nullptr, n_out);
  compact_scatter_kernel<<<nb, TPB, 0, s>>>(ids, seg, live, n, slot, agg,
                                            ids_out, seg_out);
  return cudaGetLastError();
}

}  // extern "C"
