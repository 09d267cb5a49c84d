// K5 — expert-assignment histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `moe_histogram_kernel` (with `_kernel`)
// in src/repro/kernels/moe_histogram/moe_histogram.py.  Input: expert
// ids idx (T·K,) int32 and gates (T·K,) float32, contiguous.  Output:
// counts (E,) and load (E,) float32: per expert the number of
// assignments and the sum of their gates.  Ids outside [0, E) — the
// wrapper's −1 padding — match nothing.
//
// What bounds it on this card: bytes, and at the serve path's sizes the
// launch itself (262 144 assignments of a prefill are 2 MB, 1.6 µs at
// the card's rate).  The TPU expanded each token tile into a one-hot
// (tile, E) block in VMEM and reduced it on the VPU, carrying the sums
// across the sequential grid.  Here blocks run in parallel in no order,
// so nothing carries over: each block stages its chunk of assignments
// in shared memory and fills per-block bins, one owner thread per
// (sub-chunk, expert) bin scanning its sub-chunk in order — no float
// atomics, so the block's load is the same sum in the same order on
// every launch.  Counts are exact integers and go to global memory by
// integer atomics.  A second small kernel sums the blocks' load
// partials in block order and casts the counts to float32, so the load
// is deterministic too.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 2048;   // assignments a block stages (16 KB)
constexpr int kMaxE = 4096;    // experts: bins of 8 bytes each, 32 KB

// Block b owns assignments [b·kChunk, (b+1)·kChunk).  With E ≤ 256 the
// threads form `groups` = 256 / E teams of E; team g scans the elements
// j ≡ g (mod groups) of the chunk for its thread's expert.  With E > 256
// one team of 256 threads loops over the experts.  bins: (groups, E)
// counts then loads; the team partials are folded in team order.
__global__ void __launch_bounds__(kThreads)
moe_histogram_partial(const int* __restrict__ idx,
                      const float* __restrict__ gates, int n, int e,
                      int* __restrict__ counts, float* __restrict__ part) {
  extern __shared__ int smem[];
  int* s_idx = smem;                                     // kChunk
  float* s_gate = reinterpret_cast<float*>(s_idx + kChunk);  // kChunk
  const int span = e < kThreads ? e : kThreads;
  const int groups = kThreads / span;
  int* s_cnt = reinterpret_cast<int*>(s_gate + kChunk);  // groups · E
  float* s_load = reinterpret_cast<float*>(s_cnt + groups * e);

  const int lo = blockIdx.x * kChunk;
  const int m = min(kChunk, n - lo);
  for (int j = threadIdx.x; j < m; j += kThreads) {
    s_idx[j] = idx[lo + j];
    s_gate[j] = gates[lo + j];
  }
  __syncthreads();

  const int g = threadIdx.x / span;
  if (g < groups) {
    for (int x = threadIdx.x % span; x < e; x += span) {
      int c = 0;
      float l = 0.f;
      for (int j = g; j < m; j += groups) {
        if (s_idx[j] == x) {
          ++c;
          l += s_gate[j];
        }
      }
      s_cnt[g * e + x] = c;
      s_load[g * e + x] = l;
    }
  }
  __syncthreads();

  for (int x = threadIdx.x; x < e; x += kThreads) {
    int c = 0;
    float l = 0.f;
    for (int t = 0; t < groups; ++t) {
      c += s_cnt[t * e + x];
      l += s_load[t * e + x];
    }
    if (c) atomicAdd(counts + x, c);
    part[static_cast<size_t>(blockIdx.x) * e + x] = l;
  }
}

// One thread per expert: the blocks' load partials summed in block
// order, the integer counts cast to float32.
__global__ void __launch_bounds__(kThreads)
moe_histogram_final(const int* __restrict__ counts,
                    const float* __restrict__ part, int blocks, int e,
                    float* __restrict__ out_counts,
                    float* __restrict__ out_load) {
  const int x = blockIdx.x * kThreads + threadIdx.x;
  if (x >= e) return;
  float l = 0.f;
  for (int b = 0; b < blocks; ++b) l += part[static_cast<size_t>(b) * e + x];
  out_counts[x] = static_cast<float>(counts[x]);
  out_load[x] = l;
}

}  // namespace

// Blocks of a launch over n assignments (the wrapper sizes the partial
// load scratch (blocks, E) from it).
extern "C" int moe_histogram_blocks(int n) {
  return n <= 0 ? 1 : (n + kChunk - 1) / kChunk;
}

extern "C" int moe_histogram_max_experts() { return kMaxE; }

// Launch on `stream` of card `device`; returns the CUDA error code of
// the first failed call (0 = ok).  `counts_i` is int32 (E,) scratch,
// zeroed here; `part` is (moe_histogram_blocks(n), E) float32 scratch.
extern "C" int moe_histogram_launch(const int* idx, const float* gates, int n,
                                    int e, int* counts_i, float* part,
                                    float* out_counts, float* out_load,
                                    void* stream, int device) {
  if (n < 0 || e < 1 || e > kMaxE)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  err = cudaMemsetAsync(counts_i, 0, sizeof(int) * e, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = moe_histogram_blocks(n);
  if (n > 0) {
    const int span = e < kThreads ? e : kThreads;
    const int groups = kThreads / span;
    const size_t smem = sizeof(int) * 2 * kChunk
                        + sizeof(int) * 2 * static_cast<size_t>(groups) * e;
    moe_histogram_partial<<<blocks, kThreads, smem, s>>>(idx, gates, n, e,
                                                         counts_i, part);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  moe_histogram_final<<<(e + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      counts_i, part, n > 0 ? blocks : 0, e, out_counts, out_load);
  return static_cast<int>(cudaGetLastError());
}
