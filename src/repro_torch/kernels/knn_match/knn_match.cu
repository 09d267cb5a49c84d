// K4 — continuous-kNN result-set update for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `knn_match_kernel` (with `_knn_kernel`
// and `_dist_tile`) in src/repro/kernels/knn_match/knn_match.py.  Input:
// points (N, 2) and foci (Q, 2), contiguous float32, N >= k.  Output:
// (Q, k) float32, per focus the k smallest squared distances to the
// points, ascending, duplicates each counted; 1 <= k <= kMaxK.
//
// What bounds it on this card: operations.  Every (point, focus) pair
// costs two subtractions, two multiplications, one addition and one
// compare against the current k-th; the inputs are a few megabytes.
// The TPU kept a (k, 128) tile of best distances in VMEM and merged each
// point tile with k rounds of min-and-mask.  Here a thread owns R foci
// (R = kFoci to k = 16, half that past it, so the lists fit the
// registers) and keeps each focus's best in registers as a
// sorted list (the length is a template parameter, so the list is never
// indexed at run time and does not spill).  Points are staged in shared
// memory in tiles that every thread reads at the same address (a
// broadcast), two points a 16-byte load, so one load serves 2·R pairs.
// A group of four points is tested at once: for each focus the minimum
// of its four distances (three FMNMX) is compared once with the current
// k-th, the R tests are or-ed, and one warp vote decides whether any
// focus of the warp wins; only then are the distances taken again and a
// winning focus's group inserted point by point (one min/max pass
// each).  The common path is straight-line code with one uniform branch
// a group (a branch a focus costs a convergence barrier each), so a pair
// costs the bound's six instructions and a third.  The vote wins for a
// group when a point beats the k-th of any of the warp's 32·R foci, and
// the warp then pays for all of them; so the foci are taken in the
// wrapper's spatial (Morton) order, a warp's foci are neighbours, and a
// point near one of them tends to be near the others: far fewer groups
// win.  Past k = 16 the list is 24 or 32 long and the first k are written
// (the k smallest are the first k of the 24 or 32 smallest).
// When the foci alone give too few blocks to fill the card, the points
// are split over the grid's y axis: each split keeps its own list and a
// second kernel merges the splits' lists per focus (the k smallest of a
// union are the k smallest of the union of each part's k smallest, so
// the merge is exact, duplicates kept).  Fewer, longer splits insert
// less (a list fills from empty in every split, and early in a split
// the vote wins for almost every group), so the splits are as few as
// fill the card.
//
// Numerics: dx = fx - px, then dx*dx and dy*dy each rounded, then their
// sum rounded (__fsub_rn / __fmul_rn / __fadd_rn, and the build passes
// --fmad=false), the plain version's order, so the distances equal it
// bit for bit.  A tile is padded to whole groups with NaN points: their
// distance is NaN, which fminf passes over and no compare lets in.
//
// The geometry constants come from kernels/knn_match/ops.py as nvcc
// defines, so they are stated there alone.
#include <cuda_runtime.h>
#include <math.h>

#if !defined(KNN_MATCH_THREADS) || !defined(KNN_MATCH_FOCI) || \
    !defined(KNN_MATCH_TILE) || !defined(KNN_MATCH_BLOCKS) || \
    !defined(KNN_MATCH_MIN_SPLIT)
#error "build through repro_torch.kernels.knn_match.ops (nvcc -D defines)"
#endif

namespace {

constexpr int kThreads = KNN_MATCH_THREADS;  // threads a block
constexpr int kFoci = KNN_MATCH_FOCI;        // R, foci a thread to k = 16
constexpr int kTile = KNN_MATCH_TILE;        // points staged per pass
constexpr int kBlocks = KNN_MATCH_BLOCKS;    // blocks a launch aims at
constexpr int kMinSplit = KNN_MATCH_MIN_SPLIT;  // fewest points a split
constexpr int kGroup = 4;                    // points tested at once
constexpr int kMaxK = 32;
static_assert(kTile % kGroup == 0, "a tile holds whole groups");

// R at list length K: kFoci to 16, half that past it (the lists' 64
// registers a thread either way at the longest).
__host__ __device__ constexpr int foci_per_thread(int K) {
  return K <= 16 ? kFoci : (kFoci + 1) / 2;
}

// The list length that serves k: k itself to 16, then 24 or 32.
__host__ __device__ constexpr int list_len(int k) {
  return k <= 16 ? k : k <= 24 ? 24 : 32;
}

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

__device__ __forceinline__ float dist(float2 c, float px, float py) {
  const float dx = __fsub_rn(c.x, px);
  const float dy = __fsub_rn(c.y, py);
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// part: (splits, q, k_out); split s covers points [s * per_split, ...).
// The foci are taken in the wrapper's spatial order: the f-th is
// foci[order[f]], and its list goes to row out_row[f] of part (the
// caller's row, with one split) or to row f (split lists, merged by
// knn_merge_kernel) when out_row is null.  Block x owns ordered foci
// [x·kThreads·R, (x+1)·kThreads·R), thread t those x·kThreads·R + t +
// kThreads·r for r < R.
template <int K, int R>
__global__ void __launch_bounds__(kThreads)
knn_match_kernel(const float2* __restrict__ pts,
                 const float2* __restrict__ foci,
                 const long long* __restrict__ order, int n, int q,
                 int per_split, int k_out,
                 const long long* __restrict__ out_row,
                 float* __restrict__ part) {
  __shared__ float4 s_pts[kTile / 2];        // two points a float4
  float2* s_pt = reinterpret_cast<float2*>(s_pts);
  const int f0 = blockIdx.x * kThreads * R + threadIdx.x;
  float2 c[R];
  float best[R][K];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int f = f0 + r * kThreads;
    c[r] = f < q ? foci[order[f]] : make_float2(0.f, 0.f);
#pragma unroll
    for (int j = 0; j < K; ++j) best[r][j] = INFINITY;
  }
  const int lo = blockIdx.y * per_split;
  const int hi = min(n, lo + per_split);
  for (int t0 = lo; t0 < hi; t0 += kTile) {
    const int m = min(kTile, hi - t0);
    const int mg = (m + kGroup - 1) / kGroup * kGroup;
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < mg; j += kThreads)
      s_pt[j] = j < m ? pts[t0 + j] : make_float2(NAN, NAN);
    __syncthreads();
#pragma unroll 2
    for (int j = 0; j < mg; j += kGroup) {
      const float4 a = s_pts[j / 2];
      const float4 b = s_pts[j / 2 + 1];
      // the common case, straight-line: no focus of the warp wins
      bool win = false;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float d0 = dist(c[r], a.x, a.y);
        const float d1 = dist(c[r], a.z, a.w);
        const float d2 = dist(c[r], b.x, b.y);
        const float d3 = dist(c[r], b.z, b.w);
        win |= fminf(fminf(d0, d1), fminf(d2, d3)) < best[r][K - 1];
      }
      if (__any_sync(~0u, win)) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float d0 = dist(c[r], a.x, a.y);
          const float d1 = dist(c[r], a.z, a.w);
          const float d2 = dist(c[r], b.x, b.y);
          const float d3 = dist(c[r], b.z, b.w);
          if (fminf(fminf(d0, d1), fminf(d2, d3)) < best[r][K - 1]) {
            insert<K>(best[r], d0);
            insert<K>(best[r], d1);
            insert<K>(best[r], d2);
            insert<K>(best[r], d3);
          }
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int f = f0 + r * kThreads;
    if (f < q) {
      const long long row = out_row ? out_row[f] : f;
      float* out = part + (static_cast<size_t>(blockIdx.y) * q + row) * k_out;
#pragma unroll
      for (int j = 0; j < K; ++j)
        if (j < k_out) out[j] = best[r][j];
    }
  }
}

// out (q, k): row order[f] the first k of the K smallest of the splits'
// lists of ordered focus f.
template <int K>
__global__ void __launch_bounds__(kThreads)
knn_merge_kernel(const float* __restrict__ part,
                 const long long* __restrict__ order, int splits, int q,
                 int k, float* __restrict__ out) {
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
  float* row = out + static_cast<size_t>(order[f]) * k;
#pragma unroll
  for (int j = 0; j < K; ++j)
    if (j < k) row[j] = best[j];
}

int splits_for(int n, int q, int k) {
  const long long per_block = static_cast<long long>(kThreads)
                              * foci_per_thread(list_len(k));
  const long long qb = (q + per_block - 1) / per_block;
  const long long most = (n + kMinSplit - 1) / kMinSplit;
  long long s = (kBlocks + qb / 2) / qb;     // the nearest count
  s = s < most ? s : most;
  s = s < 65535 ? s : 65535;
  return s < 1 ? 1 : static_cast<int>(s);
}

struct Args {
  const float2* pts;
  const float2* foci;
  const long long* order;
  int n, q, k;
  float* out;
  float* scratch;
};

template <int K>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int R = foci_per_thread(K);
  const int splits = splits_for(a.n, a.q, a.k);
  const int per_split = (a.n + splits - 1) / splits;
  const dim3 grid((a.q + kThreads * R - 1) / (kThreads * R), splits);
  // one split writes the first k straight to out; splits write K each
  knn_match_kernel<K, R><<<grid, kThreads, 0, stream>>>(
      a.pts, a.foci, a.order, a.n, a.q, per_split,
      splits == 1 ? a.k : K, splits == 1 ? a.order : nullptr,
      splits == 1 ? a.out : a.scratch);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return static_cast<int>(err);
  knn_merge_kernel<K><<<(a.q + kThreads - 1) / kThreads, kThreads, 0,
                        stream>>>(a.scratch, a.order, splits, a.q, a.k,
                                  a.out);
  return static_cast<int>(cudaGetLastError());
}

template <int K>
int dispatch(const Args& a, cudaStream_t stream) {
  if (list_len(a.k) == K) return launch<K>(a, stream);
  if constexpr (K < 16) {
    return dispatch<K + 1>(a, stream);
  } else if constexpr (K < kMaxK) {
    return dispatch<K + 8>(a, stream);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// How many point splits a launch with n points, q foci and k neighbours
// uses: the count nearest to kBlocks blocks over the foci blocks, each
// split at least kMinSplit points, at most 65535.
extern "C" int knn_match_splits(int n, int q, int k) {
  return splits_for(n, q, k);
}

// Floats of scratch a launch needs (the splits' lists; 0 for one split).
extern "C" long long knn_match_scratch(int n, int q, int k) {
  const int s = splits_for(n, q, k);
  return s == 1 ? 0 : static_cast<long long>(s) * q * list_len(k);
}

// Launch on `stream` of card `device`; returns the CUDA error code of
// the first failed launch (0 = ok).  `order` is a permutation of the q
// foci (int64), the order they are taken in; `out` is (q, k) in the
// foci's own order; `scratch` holds knn_match_scratch(n, q, k) floats.
// 1 <= k <= kMaxK and k <= n (the wrapper checks).
extern "C" int knn_match_launch(const float* pts, const float* foci,
                                const long long* order, int n, int q, int k,
                                float* out, float* scratch, void* stream,
                                int device) {
  if (n <= 0 || q <= 0 || k < 1 || k > kMaxK || k > n || !order)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Args a{reinterpret_cast<const float2*>(pts),
               reinterpret_cast<const float2*>(foci), order, n, q, k, out,
               scratch};
  return dispatch<1>(a, static_cast<cudaStream_t>(stream));
}
