// K2 — inclusive point-in-rectangle spatial join for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `spatial_match_kernel` (with
// `_point_count_kernel` / `_query_count_kernel`) in
// src/repro/kernels/spatial_match/spatial_match.py.  Input: points
// (N, 2) and rects (Q, 4) = (x0, y0, x1, y1), contiguous float32.
// Output: per-point and per-rect hit counts, int32, which the caller
// zeroes.  A point is inside iff px >= x0 && px <= x1 && py >= y0 &&
// py <= y1 (inclusive, float32 compares, as the plain version).
//
// What bounds it on this card: operations.  Every (point, rect) pair
// costs four compares, three ands and one add; the inputs are a few
// megabytes.  The TPU ran the two reductions as two pallas_calls only
// because its accumulator had to be revisited on consecutive grid
// steps; here one launch computes both.  A block owns 256 points (one
// per thread, held in registers) and one chunk of rects staged in shared
// memory; each thread counts its point's hits in a register, and the
// per-rect counts of a warp come from one __ballot_sync + __popc per
// rect, parked in the register of lane (rect mod 32), added into a
// shared-memory count per rect, then one global atomicAdd per rect and
// per point per block where the count is not zero.  Integer atomics are
// order-free, so the counts are deterministic.  Ragged edges are masked
// (no padding of points or rects).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;      // points per block, one per thread
constexpr int kMaxChunk = 1024;    // rects per block (16 KB + 4 KB shared)
constexpr int kMinBlocks = 2 * 132 * (2048 / kThreads);  // two full waves
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
spatial_match_kernel(const float2* __restrict__ pts,
                     const float4* __restrict__ rects, int n, int q,
                     int chunk, int* __restrict__ pcnt,
                     int* __restrict__ qcnt) {
  __shared__ float4 s_rect[kMaxChunk];
  __shared__ int s_cnt[kMaxChunk];
  const int base = blockIdx.y * chunk;
  const int nr = min(chunk, q - base);
  for (int j = threadIdx.x; j < nr; j += kThreads) {
    s_rect[j] = rects[base + j];
    s_cnt[j] = 0;
  }
  __syncthreads();

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float2 p = live ? pts[i] : make_float2(0.f, 0.f);
  const int lane = threadIdx.x & 31;
  int hits = 0;
  // chunk is a multiple of 32, so r stays inside s_rect; entries past nr
  // are never written and are masked out
  for (int r0 = 0; r0 < nr; r0 += 32) {
    int mine = 0;
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const float4 b = s_rect[r0 + j];
      const bool hit = live && r0 + j < nr && p.x >= b.x && p.x <= b.z &&
                       p.y >= b.y && p.y <= b.w;
      hits += hit;
      const int c = __popc(__ballot_sync(kFull, hit));
      if (lane == j) mine = c;
    }
    if (mine) atomicAdd(&s_cnt[r0 + lane], mine);
  }
  __syncthreads();
  for (int j = threadIdx.x; j < nr; j += kThreads) {
    if (s_cnt[j]) atomicAdd(&qcnt[base + j], s_cnt[j]);
  }
  if (hits) atomicAdd(&pcnt[i], hits);
}

}  // namespace

// Launch on `stream` of card `device`; returns the CUDA error code of
// the launch (0 = ok).  `pcnt` (n) and `qcnt` (q) must be zero on entry.
// Points tile the grid's x axis, rect chunks its y axis, so q is at most
// 65535 * 1024 (the wrapper checks).
extern "C" int spatial_match_launch(const float* pts, const float* rects,
                                    int n, int q, int* pcnt, int* qcnt,
                                    void* stream, int device) {
  if (n <= 0 || q <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int xb = (n + kThreads - 1) / kThreads;
  int chunk = kMaxChunk;
  while (chunk > 32 &&
         static_cast<long long>(xb) * ((q + chunk - 1) / chunk) < kMinBlocks)
    chunk >>= 1;
  const dim3 grid(xb, (q + chunk - 1) / chunk);
  spatial_match_kernel<<<grid, kThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float2*>(pts),
      reinterpret_cast<const float4*>(rects), n, q, chunk, pcnt, qcnt);
  return static_cast<int>(cudaGetLastError());
}
