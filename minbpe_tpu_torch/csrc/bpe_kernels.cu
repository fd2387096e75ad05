// Hand-written Hopper (sm_90a) kernels of the BPE main path: training and
// rank-sweep encode over a DENSE token stream.
//
// The stream is two int32 arrays, ids[i] and seg[i] (chunk id), plus a live
// length n that lives in device memory (int32[1]), so a whole training run is
// launched without one host sync. Position i pairs with i + 1 when both are
// below n and seg[i] == seg[i + 1]. After every applied merge the stream is
// compacted again, so the stream order is the reference's scan order and a
// pair's first occurrence is its smallest position.
//
// Kernels and the Pallas code they replace
// (minbpe_tpu/ops/pallas/fused_train.py::_kernel, fused_encode.py::_kernel):
//
//   K1 pair_stats   <- tiled_adjacency + count_width/count_blocked/count_full
//                      (fused_train.py:251-290, :816-891)
//   K2 select_best  <- select_candidate + no_pair (fused_train.py:915-1000,
//                      :1118-1123)
//   K3 merge_apply  <- tiled_apply (fused_train.py:293-340) and the per-rank
//                      body of the encoder (fused_encode.py:58-87)
//   K4 compact      <- _compact_inplace (fused_train.py:641-736) and the
//                      encoder's output compaction (fused_encode.py:91-119)
//
// Every kernel takes an optional `stop` flag (the trainer's fail round) and
// its round r: when *stop <= r it returns at once, so the rounds after a
// failed one cost one launch each and leave the merge log at its zero rows.
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

__device__ __forceinline__ bool stopped(const int* stop, int r) {
  return stop != nullptr && *stop <= r;
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
// cnt[a * W + b] += 1 and first[a * W + b] = min(position) for every
// countable pair (a, b) with a, b < W. The entry point clears both W x W
// matrices first (cnt to 0, first to 0xFFFFFFFF, read as -1 from int32).
//
// Bound: the atomics, not the bytes (8 B read per token, 8 B per matrix
// entry written). A hot pair (" t", "e ") sends thousands of atomics to one
// address, and those serialize in L2. Each warp therefore aggregates equal
// pairs with __match_any_sync first: one atomicAdd of the group size and one
// atomicMin of the group's lowest lane, which holds its lowest position.
// ---------------------------------------------------------------------------
__global__ void pair_stats_kernel(const int* __restrict__ ids,
                                  const int* __restrict__ seg,
                                  const int* __restrict__ n_ptr,
                                  const int* stop, int r,
                                  unsigned* __restrict__ cnt,
                                  unsigned* __restrict__ first, int W) {
  if (stopped(stop, r)) return;
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
      if (a >= 0 && a < W && b >= 0 && b < W) key = a * W + b;
    }
    const unsigned group = __match_any_sync(0xffffffffu, key);
    if (key >= 0 && (threadIdx.x & 31) == __ffs(group) - 1) {
      atomicAdd(&cnt[key], (unsigned)__popc(group));
      atomicMin(&first[key], (unsigned)i);
    }
  }
}

// ---------------------------------------------------------------------------
// K2 select_best: the reference's max(stats, key=stats.get) over
// first-occurrence insertion order, as one 64-bit max:
//   key = count << 32 | (0xFFFFFFFF - first),  0 for an absent pair.
// The largest key has the largest count and, among equal counts, the
// earliest first occurrence, so no tie walk is needed. The winner is
// (ids[first], ids[first + 1]). The last block to finish writes the log row
// (pa, pb, count), or sets *fail = r when no pair is left (max key 0).
//
// Bound: bytes (8 B per W x W entry read; 8 MB at W = 1024, which L2 holds).
// One grid-stride pass, a block reduction, one 64-bit atomicMax per block.
// ---------------------------------------------------------------------------
__global__ void select_best_kernel(const unsigned* __restrict__ cnt,
                                   const unsigned* __restrict__ first,
                                   int WW, const int* __restrict__ ids,
                                   int* fail, int r, int* row,
                                   unsigned long long* best,
                                   unsigned* done) {
  if (stopped(fail, r)) return;
  unsigned long long k = 0;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < WW;
       i += gridDim.x * blockDim.x) {
    const unsigned c = cnt[i];
    if (c) {
      const unsigned long long key =
          ((unsigned long long)c << 32) | (0xFFFFFFFFu - first[i]);
      k = key > k ? key : k;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const unsigned long long o = __shfl_down_sync(0xffffffffu, k, d);
    k = o > k ? o : k;
  }
  __shared__ unsigned long long warp_max[TPB / 32];
  __shared__ bool last;
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = k;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < TPB / 32; ++w) k = warp_max[w] > k ? warp_max[w] : k;
    atomicMax(best, k);
    __threadfence();
    last = atomicAdd(done, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (last && threadIdx.x == 0) {
    __threadfence();
    const unsigned long long b = atomicAdd(best, 0ull);
    if (b == 0) {
      *fail = r;
    } else {
      const int pos = (int)(0xFFFFFFFFu - (unsigned)(b & 0xFFFFFFFFull));
      row[0] = ids[pos];
      row[1] = ids[pos + 1];
      row[2] = (int)(b >> 32);
    }
  }
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
                                  const int* stop, int r,
                                  int* __restrict__ agg) {
  if (stopped(stop, r)) return;
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
// With `pair` given it runs only for a homogeneous pair (K3's run starts);
// with `total` given it stores the grand total there (K4's new length).
template <bool SUM>
__global__ void scan_tiles_kernel(int* agg, const int* __restrict__ n_ptr,
                                  const int* stop, int r, const int* pair,
                                  int* total) {
  if (stopped(stop, r)) return;
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
                                   const int* stop, int r,
                                   const int* __restrict__ prefix,
                                   int* __restrict__ ids_out,
                                   unsigned char* __restrict__ live,
                                   int* kept) {
  if (stopped(stop, r)) return;
  const int n = *n_ptr;
  const int t0 = blockIdx.x * TILE;
  if (t0 >= n) return;
  const int pa = pair[0], pb = pair[1];
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
// K4 compact: order-preserving compaction of ids and seg by the live mask.
// Per-tile live counts, a one-block exclusive scan of them (which also
// yields the new length), then each tile scatters its live tokens to its
// offset plus its in-tile exclusive scan. Order is kept, so first positions
// keep the reference's first-occurrence order.
//
// Bound: bytes (9 B read per token, 8 B written per live token).
// ---------------------------------------------------------------------------
__global__ void live_count_kernel(const unsigned char* __restrict__ live,
                                  const int* __restrict__ n_ptr,
                                  const int* stop, int r,
                                  int* __restrict__ agg) {
  if (stopped(stop, r)) return;
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
                                       const int* stop, int r,
                                       const int* __restrict__ offs,
                                       int* __restrict__ ids_out,
                                       int* __restrict__ seg_out) {
  if (stopped(stop, r)) return;
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

}  // namespace

extern "C" {

int bpe_tile_size() { return TILE; }

int bpe_pair_stats(const int* ids, const int* seg, const int* n,
                   const int* stop, int r, unsigned* cnt, unsigned* first,
                   int W, int cap, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t bytes = (size_t)W * W * sizeof(unsigned);
  cudaError_t e = cudaMemsetAsync(cnt, 0, bytes, s);
  if (e != cudaSuccess) return e;
  e = cudaMemsetAsync(first, 0xFF, bytes, s);
  if (e != cudaSuccess) return e;
  int grid = (cap + TPB - 1) / TPB;
  grid = grid < 1 ? 1 : (grid > MAX_STAT_BLOCKS ? MAX_STAT_BLOCKS : grid);
  pair_stats_kernel<<<grid, TPB, 0, s>>>(ids, seg, n, stop, r, cnt, first, W);
  return cudaGetLastError();
}

// scratch: 2 x uint64 (best key, done counter), cleared here
int bpe_select_best(const unsigned* cnt, const unsigned* first, int WW,
                    const int* ids, int* fail, int r, int* row,
                    unsigned long long* scratch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(scratch, 0, 2 * sizeof(unsigned long long), s);
  if (e != cudaSuccess) return e;
  int grid = (WW + TPB - 1) / TPB;
  grid = grid < 1 ? 1 : (grid > MAX_STAT_BLOCKS ? MAX_STAT_BLOCKS : grid);
  select_best_kernel<<<grid, TPB, 0, s>>>(cnt, first, WW, ids, fail, r, row,
                                          scratch, (unsigned*)(scratch + 1));
  return cudaGetLastError();
}

// agg: int32[tiles_for(cap)] scratch; kept may be null
int bpe_merge_apply(const int* ids, const int* seg, const int* n,
                    const int* pair, int z, const int* stop, int r, int cap,
                    int* ids_out, unsigned char* live, int* kept, int* agg,
                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = tiles_for(cap);
  run_starts_kernel<<<nb, TPB, 0, s>>>(ids, seg, n, pair, stop, r, agg);
  scan_tiles_kernel<false><<<1, SCAN_TPB, 0, s>>>(agg, n, stop, r, pair,
                                                  nullptr);
  merge_apply_kernel<<<nb, TPB, 0, s>>>(ids, seg, n, pair, z, stop, r, agg,
                                        ids_out, live, kept);
  return cudaGetLastError();
}

// agg: int32[tiles_for(cap)] scratch; n_out: int32[1]
int bpe_compact(const int* ids, const int* seg, const unsigned char* live,
                const int* n, const int* stop, int r, int cap, int* ids_out,
                int* seg_out, int* n_out, int* agg, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int nb = tiles_for(cap);
  live_count_kernel<<<nb, TPB, 0, s>>>(live, n, stop, r, agg);
  scan_tiles_kernel<true><<<1, SCAN_TPB, 0, s>>>(agg, n, stop, r, nullptr,
                                                 n_out);
  compact_scatter_kernel<<<nb, TPB, 0, s>>>(ids, seg, live, n, stop, r, agg,
                                            ids_out, seg_out);
  return cudaGetLastError();
}

}  // extern "C"
