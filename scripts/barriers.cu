// Device code of scripts/time_barriers.py: the cost of one barrier in a
// loop of rounds that synchronise through it, on one NVIDIA GPU.
// Back-to-back rounds of a trivial min-reduce (a warp min, a block min
// through shared memory, then the group's min), one barrier a round,
// through
//   grid_rounds      cg::this_grid().sync() over a cooperative grid;
//   cluster_rounds   cg::this_cluster().sync() over one cluster, the block
//                    minima read through distributed shared memory;
//   block_rounds     __syncthreads() in one block.
//
// nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//      -Xcompiler -fPIC -o libbarriers.so barriers.cu

#include <climits>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace rounds {

__device__ __forceinline__ int round_value(int r, unsigned t) {
  return (int)(((unsigned)r * 0x9E3779B1u ^ t * 0x85EBCA77u) >> 8);
}

// the block's min of v, returned to every thread; wm: 2 x 32 ints, by round
// parity, so one __syncthreads a round suffices
__device__ __forceinline__ int block_min(int v, int* wm, int r) {
  v = __reduce_min_sync(0xffffffffu, v);
  int* w = wm + 32 * (r & 1);
  if ((threadIdx.x & 31) == 0) w[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return __reduce_min_sync(
      0xffffffffu, lane < (int)(blockDim.x >> 5) ? w[lane] : INT_MAX);
}

__global__ void grid_rounds(int rounds, int* blk, int* out) {
  cg::grid_group grid = cg::this_grid();
  __shared__ int wm[64];
  const int G = gridDim.x;
  int acc = 0;
  for (int r = 0; r < rounds; ++r) {
    const int b = block_min(
        round_value(r, blockIdx.x * blockDim.x + threadIdx.x), wm, r);
    int* v = blk + (r & 1) * G;
    if (threadIdx.x == 0) v[blockIdx.x] = b;
    grid.sync();
    int m = INT_MAX;  // every warp reads every block's value
    for (int j = threadIdx.x & 31; j < G; j += 32) m = min(m, __ldcg(v + j));
    acc += __reduce_min_sync(0xffffffffu, m);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = acc;
}

__global__ void cluster_rounds(int rounds, int* out) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ int wm[64];
  __shared__ int bv[2];
  const int cs = (int)cluster.num_blocks();
  const int lane = threadIdx.x & 31;
  int acc = 0;
  for (int r = 0; r < rounds; ++r) {
    const int b = block_min(
        round_value(r, blockIdx.x * blockDim.x + threadIdx.x), wm, r);
    if (threadIdx.x == 0) bv[r & 1] = b;
    cluster.sync();
    int m = INT_MAX;
    if (lane < cs) m = cluster.map_shared_rank(bv, lane)[r & 1];
    acc += __reduce_min_sync(0xffffffffu, m);
  }
  cluster.sync();  // no block leaves while another may read its bv
  if (blockIdx.x == 0 && threadIdx.x == 0) *out = acc;
}

__global__ void block_rounds(int rounds, int* out) {
  __shared__ int wm[64];
  int acc = 0;
  for (int r = 0; r < rounds; ++r)
    acc += block_min(round_value(r, threadIdx.x), wm, r);
  if (threadIdx.x == 0) *out = acc;
}

}  // namespace rounds

extern "C" {

// ms per round of kind 0 (grid, `param` blocks of 256 threads), 1 (one
// cluster of `param` blocks of 256 threads) or 2 (one block of `param`
// threads): (time of `rounds` rounds - time of none) / rounds, each the
// best of three launches; a negative CUDA error where a launch fails.
double round_ms(int kind, int param, int rounds) {
  int* buf = nullptr;
  cudaError_t e = cudaMalloc(&buf, sizeof(int) * (2 * 4096 + 1));
  if (e != cudaSuccess) return -(double)e;
  if (kind == 1 && param > 8)
    e = cudaFuncSetAttribute((const void*)rounds::cluster_rounds,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  cudaEvent_t t0, t1;
  cudaEventCreate(&t0);
  cudaEventCreate(&t1);
  float best[2] = {1e30f, 1e30f};
  for (int rep = 0; rep < 4 && e == cudaSuccess; ++rep)
    for (int w = 0; w < 2 && e == cudaSuccess; ++w) {
      int R = w ? rounds : 0;
      int* out = buf + 2 * 4096;
      cudaEventRecord(t0);
      if (kind == 0) {
        void* args[] = {&R, &buf, &out};
        e = cudaLaunchCooperativeKernel((const void*)rounds::grid_rounds,
                                        dim3(param), dim3(256), args, 0, 0);
      } else if (kind == 1) {
        cudaLaunchConfig_t cfg = {};
        cfg.gridDim = dim3(param);
        cfg.blockDim = dim3(256);
        cudaLaunchAttribute at[1];
        at[0].id = cudaLaunchAttributeClusterDimension;
        at[0].val.clusterDim.x = param;
        at[0].val.clusterDim.y = 1;
        at[0].val.clusterDim.z = 1;
        cfg.attrs = at;
        cfg.numAttrs = 1;
        e = cudaLaunchKernelEx(&cfg, rounds::cluster_rounds, R, out);
      } else {
        rounds::block_rounds<<<1, param>>>(R, out);
        e = cudaGetLastError();
      }
      cudaEventRecord(t1);
      if (e == cudaSuccess) e = cudaEventSynchronize(t1);
      float ms = 0;
      cudaEventElapsedTime(&ms, t0, t1);
      if (rep > 0 && ms < best[w]) best[w] = ms;  // rep 0 warms up
    }
  cudaEventDestroy(t0);
  cudaEventDestroy(t1);
  cudaFree(buf);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(double)e;
  }
  return (best[1] - best[0]) / rounds;
}

// clusters of `size` blocks of 256 threads that can be resident at once
int max_clusters(int size) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(size);
  cfg.blockDim = dim3(256);
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = size;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  if (size > 8)
    cudaFuncSetAttribute((const void*)rounds::cluster_rounds,
                         cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  int n = 0;
  const cudaError_t e = cudaOccupancyMaxActiveClusters(
      &n, (const void*)rounds::cluster_rounds, &cfg);
  if (e != cudaSuccess) {
    cudaGetLastError();
    return -(int)e;
  }
  return n;
}

}  // extern "C"
