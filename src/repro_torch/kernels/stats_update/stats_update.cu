// K1 — SWARM Algorithm 2 (round close) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_kernel` (:22) and its launcher
// `stats_update_kernel` (:38) in src/repro/kernels/stats_update/
// stats_update.py.  Per row of a bank, with the channels of
// src/repro_torch/core/statistics.py (N, Q, R, SPANQ, PRESPANQ = 0..4,
// collectors C_N, C_Q, C_SPAN = 5..7):
//
//   cumN, cumQ, cumSpan = inclusive prefix sums of C_N, C_Q, C_SPAN
//   N' = N*decay + cumN     Q' = Q + cumQ      R' = cumN + cumQ
//   SPANQ' = SPANQ + cumSpan                   PRESPANQ' = cumSpan
//   C_N' = C_Q' = C_SPAN' = 0
//
// One body (`fold_row`) serves two entries:
//
// A. `stats_update_launch`, the device contract of `close_round_inputs`
//    (src/repro/kernels/stats_update/ops.py): (6, P, G1) float32 in IN_CH
//    order (N, Q, SPANQ, C_N, C_Q, C_SPAN) → (5, P, G1) in OUT_CH order
//    (N, Q, R, SPANQ, PRESPANQ), both in device memory; the collectors
//    are the caller's.  What bounds it: HBM bytes, 44 a column for
//    three adds a scan step, far below the card's operations-per-byte
//    line; at the main path's (6, 132, 513) that is 0.9 µs, below a
//    launch.
//
// B. `stats_update_live_launch`, the round close itself, in place: the
//    two (8, cap, G1) float32 banks (rows, cols) stay in page-locked
//    host memory, which the card addresses directly, and one block folds
//    a live partition's row of each bank where it lies — six channels
//    read, five written, the three collectors zeroed, as the TPU kernel
//    does.  Nothing is gathered, staged or scattered on the host.  What
//    bounds it: host-link bytes, 24 read and 32 written a column, each
//    way of the link carrying its own direction.  Loads and stores that
//    SMs issue to host memory move less than the link carries (on an
//    H100 at the main path's shape, loads alone ~22 GB/s, stores alone
//    ~34 GB/s, against ~50-55 GB/s for a page-locked copy), and a row's
//    stores wait for its loads, so the design overlaps the two
//    directions: a block stores its first row while its second row's
//    loads cross the link, and within a row it stores first what needs
//    only the scans (the zeroed collectors, R', PRESPANQ').
//
// The design, for both: a block walks its row in passes of kTiles tiles
// of kThreads columns.  Thread t owns column t of each tile, so a warp's
// load or store of a channel covers 128 contiguous bytes.  A thread
// issues every load of its pass — the three collectors first, then N, Q
// and SPANQ, of up to four tiles — before any arithmetic, so the row
// costs one round of memory latency; over the link that latency is
// microseconds.  Each warp scans its three collectors of every tile with
// __shfl_up_sync, lane 31 publishes the warp totals, and after a single
// __syncthreads every thread adds the totals before it (earlier tiles,
// then earlier warps of its tile) and writes.  A row of up to
// kTiles * kThreads = 1024 columns takes one pass and one barrier.
// Every store of a column follows the loads of that column by the same
// thread through a register it depends on or a barrier, so no store can
// overtake a load of its address on the way to host memory.
//
// Numerics: the collectors hold integer counts (C_SPAN in difference
// form, so negative ones too), every partial sum is an integer below
// 2^24 and exact in any association, so the outputs equal a sequential
// prefix sum bit for bit.  The N channel is not scanned; its update is
// rounded product then rounded sum, exactly like the reference
// (`__fmul_rn` / `__fadd_rn`, and the build passes --fmad=false), so no
// FMA contraction changes the last bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTiles = 4;              // tiles a pass: 1024 columns
constexpr int kIn = 6;                 // N, Q, SPANQ, C_N, C_Q, C_SPAN
constexpr unsigned kFull = 0xffffffffu;

// Bank channel of input k (IN_CH order) in an (8, cap, G1) bank; entry A's
// (6, P, G1) input holds input k at channel k.
template <bool kBank>
__device__ __forceinline__ int in_channel(int k) {
  return kBank ? (k < 2 ? k : (k == 2 ? 3 : k + 2)) : k;
}

// Fold one row.  `in` and `out` point at the row in channel 0 of their
// arrays, `stride` is the distance between channels (P * G1 for entry A,
// cap * G1 for a bank).  For a bank (kBank) `in == out`: every column is
// read and later written by the same thread, so folding in place is safe.
template <bool kBank>
__device__ __forceinline__ void fold_row(const float* in, float* out,
                                         size_t stride, int g1,
                                         float decay) {
  __shared__ float4 ws[kTiles * 3 * kWarps / 4];   // warp totals [t][c][w]
  float* wsf = reinterpret_cast<float*>(ws);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float carry[3] = {0.f, 0.f, 0.f};
  for (int base = 0; base < g1; base += kTiles * kThreads) {
    float x[kIn][kTiles];
#pragma unroll
    for (int k = kIn - 1; k >= 0; --k) {
#pragma unroll
      for (int t = 0; t < kTiles; ++t) {
        const int j = base + t * kThreads + threadIdx.x;
        x[k][t] = j < g1 ? in[in_channel<kBank>(k) * stride + j] : 0.f;
      }
    }
    // warp scans of the collectors (x[3..5]) of every tile that has columns
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (base + t * kThreads >= g1) break;      // uniform across the block
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          const float u = __shfl_up_sync(kFull, x[3 + c][t], d);
          if (lane >= d) x[3 + c][t] = __fadd_rn(x[3 + c][t], u);
        }
      }
      if (lane == 31) {
#pragma unroll
        for (int c = 0; c < 3; ++c)
          wsf[(t * 3 + c) * kWarps + warp] = x[3 + c][t];
      }
    }
    __syncthreads();
    // each column's offset: the carry, the totals of the earlier tiles,
    // then those of the earlier warps of its own tile
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (base + t * kThreads >= g1) break;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float4* w4 = ws + (t * 3 + c) * (kWarps / 4);
        float before = carry[c], total = carry[c];
#pragma unroll
        for (int q = 0; q < kWarps / 4; ++q) {
          const float4 v = w4[q];
          const float vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (4 * q + e < warp) before = __fadd_rn(before, vs[e]);
            total = __fadd_rn(total, vs[e]);
          }
        }
        x[3 + c][t] = __fadd_rn(x[3 + c][t], before);
        carry[c] = total;
      }
      // first what needs only the scans
      const int j = base + t * kThreads + threadIdx.x;
      if (j < g1) {
        if (kBank) {
          out[5 * stride + j] = 0.f;
          out[6 * stride + j] = 0.f;
          out[7 * stride + j] = 0.f;
        }
        out[2 * stride + j] = __fadd_rn(x[3][t], x[4][t]);
        out[4 * stride + j] = x[5][t];
      }
    }
    // then what needs N, Q and SPANQ, whose loads were issued last
#pragma unroll
    for (int t = 0; t < kTiles; ++t) {
      if (base + t * kThreads >= g1) break;
      const int j = base + t * kThreads + threadIdx.x;
      if (j < g1) {
        out[0 * stride + j] = __fadd_rn(__fmul_rn(x[0][t], decay), x[3][t]);
        out[1 * stride + j] = __fadd_rn(x[1][t], x[4][t]);
        out[3 * stride + j] = __fadd_rn(x[2][t], x[5][t]);
      }
    }
    if (base + kTiles * kThreads < g1) __syncthreads();  // ws is rewritten
  }
}

// Entry A: block b folds row b of the (6, p, g1) input into the (5, p, g1)
// output.
__global__ void __launch_bounds__(kThreads)
stats_update_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int p, int g1, float decay) {
  const size_t row = static_cast<size_t>(blockIdx.x) * g1;
  fold_row<false>(in + row, out + row, static_cast<size_t>(p) * g1, g1,
                  decay);
}

// Entry B: block b folds row live[b] of the rows bank, then of the cols
// bank, in place (the barrier between them guards the warp totals).
__global__ void __launch_bounds__(kThreads)
stats_update_live_kernel(float* rows, float* cols, int cap, int g1,
                         const int* __restrict__ live, float decay) {
  const size_t r = static_cast<size_t>(live[blockIdx.x]) * g1;
  const size_t stride = static_cast<size_t>(cap) * g1;
  fold_row<true>(rows + r, rows + r, stride, g1, decay);
  __syncthreads();
  fold_row<true>(cols + r, cols + r, stride, g1, decay);
}

}  // namespace

// Entry A on `stream` of card `device`; returns the CUDA error code of the
// launch (0 = ok).  The caller owns both buffers: `in` is (6, p, g1) and
// `out` (5, p, g1), contiguous float32 on that card.  (This library links
// its own CUDA runtime, whose current device is set here, not by PyTorch.)
extern "C" int stats_update_launch(const float* in, float* out, int p,
                                   int g1, float decay, void* stream,
                                   int device) {
  if (p <= 0 || g1 <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  stats_update_kernel<<<p, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      in, out, p, g1, decay);
  return static_cast<int>(cudaGetLastError());
}

// Entry B on `stream` of card `device`: one launch of n_live blocks folds
// rows `live` of both (8, cap, g1) float32 banks in place.  `rows`
// and `cols` are page-locked host memory (the card's address of each is
// asked of the runtime; memory that is not page-locked is refused with
// cudaErrorInvalidHostPointer);
// `live` is n_live distinct int32 ids below cap, on the card.  The banks
// hold the result once the stream has passed the kernel.
extern "C" int stats_update_live_launch(float* rows, float* cols, int cap,
                                        int g1, const int* live, int n_live,
                                        float decay, void* stream,
                                        int device) {
  if (cap <= 0 || g1 <= 0 || n_live <= 0 || n_live > cap)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* dev[2] = {nullptr, nullptr};
  float* host[2] = {rows, cols};
  for (int k = 0; k < 2; ++k) {
    cudaPointerAttributes a;
    err = cudaPointerGetAttributes(&a, host[k]);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (a.type != cudaMemoryTypeHost || a.devicePointer == nullptr)
      return static_cast<int>(cudaErrorInvalidHostPointer);
    dev[k] = static_cast<float*>(a.devicePointer);
  }
  stats_update_live_kernel<<<n_live, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      dev[0], dev[1], cap, g1, live, decay);
  return static_cast<int>(cudaGetLastError());
}
