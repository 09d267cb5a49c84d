// K4 — continuous-kNN result-set update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `knn_match_kernel` (with `_knn_kernel`
// and `_dist_tile`) in src/repro/kernels/knn_match/knn_match.py.  Input:
// points (N, 2) and foci (Q, 2), contiguous float32, N >= k.  Output:
// (Q, k) float32, per focus the k smallest squared distances to the
// points, ascending, duplicates each counted.
//
// What bounds it on this card: operations.  Every (point, focus) pair
// costs two subtractions, two multiplications, one addition and one
// compare against the current k-th; the inputs are a few megabytes.
// The TPU kept a (k, 128) tile of best distances in VMEM and merged each
// point tile with k rounds of min-and-mask.  Here one thread owns one
// focus and keeps its k best in registers as a sorted list (k is a
// template parameter, so the list is never indexed at run time and does
// not spill to local memory); a candidate is compared with the current
// k-th and inserted, rarely, by one pass of min/max.  Points are staged
// in shared memory in tiles that all threads of a block read at the
// same address (a broadcast).  When the foci alone give too few blocks
// to fill the card, the points are split over the grid's y axis: each
// split keeps its own k best and a second kernel merges the splits'
// lists per focus (the k smallest of a union are the k smallest of the
// union of each part's k smallest, so the merge is exact).
//
// Numerics: dx = fx - px, then dx*dx and dy*dy each rounded, then their
// sum rounded (__fsub_rn / __fmul_rn / __fadd_rn, and the build passes
// --fmad=false), the plain version's order, so the distances equal it
// bit for bit.
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;    // foci per block, one per thread
constexpr int kTile = 2048;      // points staged per pass (16 KB)
constexpr int kMinSplit = 256;   // fewest points worth a split
constexpr int kMinBlocks = 2 * 132 * (2048 / kThreads);  // two full waves
constexpr int kMaxK = 16;

// Insert d into the ascending list best[0..K): one min/max pass, run
// only when d beats the current k-th.
template <int K>
__device__ __forceinline__ void insert(float (&best)[K], float d) {
  if (d < best[K - 1]) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const float lo = fminf(best[j], d);
      d = fmaxf(best[j], d);
      best[j] = lo;
    }
  }
}

// part: (splits, q, K); split s covers points [s * per_split, ...).
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_match_kernel(const float2* __restrict__ pts,
                 const float2* __restrict__ foci, int n, int q,
                 int per_split, float* __restrict__ part) {
  __shared__ float2 s_pts[kTile];
  const int f = blockIdx.x * kThreads + threadIdx.x;
  const bool live = f < q;
  const float2 c = live ? foci[f] : make_float2(0.f, 0.f);
  float best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = INFINITY;
  const int lo = blockIdx.y * per_split;
  const int hi = min(n, lo + per_split);
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int m = min(kTile, hi - t0);
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < m; j += kThreads) s_pts[j] = pts[t0 + j];
    __syncthreads();
    for (int j = 0; j < m; ++j) {
      const float2 p = s_pts[j];
      const float dx = __fsub_rn(c.x, p.x);
      const float dy = __fsub_rn(c.y, p.y);
      insert<K>(best, __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
    }
  }
  if (live) {
    float* out = part + (static_cast<size_t>(blockIdx.y) * q + f) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) out[j] = best[j];
  }
}

template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part, int splits, int q,
                 float* __restrict__ out) {
  const int f = blockIdx.x * kThreads + threadIdx.x;
  if (f >= q) return;
  float best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = INFINITY;
  for (int s = 0; s < splits; ++s) {
    const float* cand = part + (static_cast<size_t>(s) * q + f) * K;
#pragma unroll
    for (int j = 0; j < K; ++j) insert<K>(best, cand[j]);
  }
#pragma unroll
  for (int j = 0; j < K; ++j) out[static_cast<size_t>(f) * K + j] = best[j];
}

template <int K>
int launch(const float2* pts, const float2* foci, int n, int q, float* out,
           float* scratch, int splits, cudaStream_t stream) {
  const int per_split = (n + splits - 1) / splits;
  const dim3 grid((q + kThreads - 1) / kThreads, splits);
  knn_match_kernel<K><<<grid, kThreads, 0, stream>>>(
      pts, foci, n, q, per_split, splits == 1 ? out : scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  knn_merge_kernel<K><<<grid.x, kThreads, 0, stream>>>(scratch, splits, q,
                                                       out);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch(int k, const float2* pts, const float2* foci, int n, int q,
             float* out, float* scratch, int splits, cudaStream_t stream) {
  if (k == K) return launch<K>(pts, foci, n, q, out, scratch, splits, stream);
  if constexpr (K < kMaxK) {
    return dispatch<K + 1>(k, pts, foci, n, q, out, scratch, splits, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// How many point splits a launch with n points and q foci uses (the
// wrapper sizes the scratch from it): enough blocks for two full waves,
// each split at least kMinSplit points, and at most 65535 splits.
extern "C" int knn_match_splits(int n, int q) {
  const long long qb = (q + kThreads - 1) / kThreads;
  const long long most = (n + kMinSplit - 1) / kMinSplit;
  long long s = (kMinBlocks + qb - 1) / qb;
  s = s < most ? s : most;
  s = s < 65535 ? s : 65535;
  return s < 1 ? 1 : static_cast<int>(s);
}

// Launch on `stream` of card `device`; returns the CUDA error code of
// the first failed launch (0 = ok).  `out` is (q, k); `scratch` is
// (splits, q, k) with splits = knn_match_splits(n, q), unused when that
// is 1.  1 <= k <= kMaxK and k <= n (the wrapper checks).
extern "C" int knn_match_launch(const float* pts, const float* foci, int n,
                                int q, int k, float* out, float* scratch,
                                void* stream, int device) {
  if (n <= 0 || q <= 0 || k < 1 || k > kMaxK || k > n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return dispatch<1>(k, reinterpret_cast<const float2*>(pts),
                     reinterpret_cast<const float2*>(foci), n, q, out,
                     scratch, knn_match_splits(n, q),
                     static_cast<cudaStream_t>(stream));
}
