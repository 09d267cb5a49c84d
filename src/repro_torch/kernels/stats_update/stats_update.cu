// K1 — SWARM Algorithm 2 (round close) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `stats_update_kernel` / `_kernel` in
// src/repro/kernels/stats_update/stats_update.py.  It implements the
// transfer-minimal contract of `close_round_inputs`
// (src/repro/kernels/stats_update/ops.py): the input is the six input
// channels of the live rows, (6, P, G1) float32 in IN_CH order
// (N, Q, SPANQ, C_N, C_Q, C_SPAN); the output is the five maintained
// channels, (5, P, G1) float32 in OUT_CH order (N, Q, R, SPANQ,
// PRESPANQ).  Per row:
//
//   cumN, cumQ, cumSpan = inclusive prefix sums of C_N, C_Q, C_SPAN
//   N' = N*decay + cumN     Q' = Q + cumQ      R' = cumN + cumQ
//   SPANQ' = SPANQ + cumSpan                   PRESPANQ' = cumSpan
//
// (the collectors are zeroed by the caller, they need no transfer).
//
// What bounds it on this card: bytes.  Every element is read once from
// six channels and written once to five, 44 bytes for three adds per
// scan step, far below the card's operations-per-byte line.  The design
// keeps every intermediate on chip: one thread block owns one row, walks
// it in tiles of kThreads elements, runs the three scans of a tile
// together (warp __shfl_up_sync scans plus one shared-memory pass over
// the warp totals) and carries the running row total in registers, so
// each element crosses device memory exactly once in each direction.
// Neighbouring threads touch neighbouring addresses, so every load and
// store is coalesced.
//
// Numerics: the collectors hold integer counts, so every partial sum is
// an integer below 2^24 and exact in any association.  The N channel is
// not scanned; its update is rounded product then rounded sum, exactly
// like the reference (`__fmul_rn` / `__fadd_rn`, and the build passes
// --fmad=false), so no FMA contraction changes the last bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Inclusive scan of three values per thread across the block.  On
// return each value holds its block prefix and t* the tile totals.
// `ws` is 3 * kWarps floats of shared memory.
__device__ __forceinline__ void block_scan3(float& a, float& b, float& c,
                                            float* ws, float& ta,
                                            float& tb, float& tc) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const float ua = __shfl_up_sync(kFull, a, d);
    const float ub = __shfl_up_sync(kFull, b, d);
    const float uc = __shfl_up_sync(kFull, c, d);
    if (lane >= d) {
      a = __fadd_rn(a, ua);
      b = __fadd_rn(b, ub);
      c = __fadd_rn(c, uc);
    }
  }
  if (lane == 31) {
    ws[warp] = a;
    ws[kWarps + warp] = b;
    ws[2 * kWarps + warp] = c;
  }
  __syncthreads();
  if (warp == 0) {
    float sa = lane < kWarps ? ws[lane] : 0.f;
    float sb = lane < kWarps ? ws[kWarps + lane] : 0.f;
    float sc = lane < kWarps ? ws[2 * kWarps + lane] : 0.f;
#pragma unroll
    for (int d = 1; d < kWarps; d <<= 1) {
      const float ua = __shfl_up_sync(kFull, sa, d);
      const float ub = __shfl_up_sync(kFull, sb, d);
      const float uc = __shfl_up_sync(kFull, sc, d);
      if (lane >= d) {
        sa = __fadd_rn(sa, ua);
        sb = __fadd_rn(sb, ub);
        sc = __fadd_rn(sc, uc);
      }
    }
    if (lane < kWarps) {
      ws[lane] = sa;
      ws[kWarps + lane] = sb;
      ws[2 * kWarps + lane] = sc;
    }
  }
  __syncthreads();
  if (warp > 0) {
    a = __fadd_rn(a, ws[warp - 1]);
    b = __fadd_rn(b, ws[kWarps + warp - 1]);
    c = __fadd_rn(c, ws[2 * kWarps + warp - 1]);
  }
  ta = ws[kWarps - 1];
  tb = ws[2 * kWarps - 1];
  tc = ws[3 * kWarps - 1];
  __syncthreads();  // ws is rewritten by the next tile's scan
}

__global__ void __launch_bounds__(kThreads)
stats_update_kernel(const float* __restrict__ in, float* __restrict__ out,
                    int p, int g1, float decay) {
  __shared__ float ws[3 * kWarps];
  const size_t plane = static_cast<size_t>(p) * g1;
  const size_t row = static_cast<size_t>(blockIdx.x) * g1;
  const float* n_in = in + row;
  const float* q_in = in + plane + row;
  const float* spanq_in = in + 2 * plane + row;
  const float* c_n = in + 3 * plane + row;
  const float* c_q = in + 4 * plane + row;
  const float* c_span = in + 5 * plane + row;
  float* n_out = out + row;
  float* q_out = out + plane + row;
  float* r_out = out + 2 * plane + row;
  float* spanq_out = out + 3 * plane + row;
  float* prespan_out = out + 4 * plane + row;

  float carry_n = 0.f, carry_q = 0.f, carry_s = 0.f;
  for (int base = 0; base < g1; base += kThreads) {
    const int j = base + threadIdx.x;
    const bool live = j < g1;
    float cum_n = live ? c_n[j] : 0.f;
    float cum_q = live ? c_q[j] : 0.f;
    float cum_s = live ? c_span[j] : 0.f;
    float tn, tq, ts;
    block_scan3(cum_n, cum_q, cum_s, ws, tn, tq, ts);
    cum_n = __fadd_rn(cum_n, carry_n);
    cum_q = __fadd_rn(cum_q, carry_q);
    cum_s = __fadd_rn(cum_s, carry_s);
    carry_n = __fadd_rn(carry_n, tn);
    carry_q = __fadd_rn(carry_q, tq);
    carry_s = __fadd_rn(carry_s, ts);
    if (live) {
      n_out[j] = __fadd_rn(__fmul_rn(n_in[j], decay), cum_n);
      q_out[j] = __fadd_rn(q_in[j], cum_q);
      r_out[j] = __fadd_rn(cum_n, cum_q);
      spanq_out[j] = __fadd_rn(spanq_in[j], cum_s);
      prespan_out[j] = cum_s;
    }
  }
}

}  // namespace

// Launch on `stream` of card `device`; returns the CUDA error code of the
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
