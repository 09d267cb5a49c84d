// K5 — expert-assignment histogram for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `moe_histogram_kernel` (with `_kernel`)
// in src/repro/kernels/moe_histogram/moe_histogram.py.  Input: expert
// ids idx (T·K,) int32 and gates (T·K,) float32, contiguous.  Output:
// one (2, E) float32 row pair: per expert the number of assignments and
// the sum of their gates.  Ids outside [0, E) — the wrapper's −1 padding
// — match nothing.
//
// What bounds it on this card: bytes, and at the serve path's sizes the
// launch and the latency of a few dependent steps (the 204 800
// assignments of a prefill are 1.6 MB, 0.5 µs at the card's rate; a
// decode call's 200 are nothing).  The TPU expanded each token tile into
// a one-hot (tile, E) block in VMEM and reduced it on the VPU, carrying
// the sums across the sequential grid.  Here blocks run in parallel in
// no order, so the design is one launch per call, short on dependent
// steps:
//
// - a warp reads `steps` · 32 consecutive assignments, one per lane and
//   step; blocks of up to kMaxWarps warps take few steps each (four at a
//   prefill, one at a decode call).  Each step `__match_any_sync` groups
//   the lanes that hold one expert, and the group's lowest lane adds the
//   group's gates, in lane order, into the warp's own bins in shared
//   memory: one writer per bin, no float atomics.  (A bit transpose of
//   the ids by ballots, bins in registers, was no faster on the H100.);
// - the block folds its warps' bins as a fixed tree (each level adds
//   warp w + h into warp w).  A grid of one block (every decode call)
//   writes the outputs here and is done;
// - otherwise each block writes its (count, load) row to scratch, and
//   one thread takes an atomic ticket with acquire-release order, after a
//   barrier so that the release covers the block's stores (one such
//   operation a block: a __threadfence in every thread cost more); the
//   block that draws the last ticket folds the rows — `segments` runs of
//   consecutive blocks, each in block order, then the runs in order —
//   writes both outputs and resets the ticket for the next launch.
//
// So each expert's load is one fixed float32 sum order, set by n and E
// alone: the same bits on every launch (`order.py` writes the order out
// in NumPy).  Counts are exact integers.  The geometry (warps, steps,
// blocks, segments) comes from the wrapper (ops.py), which caches the
// scratch rows and the ticket per (device, stream, E) and gives the
// constants it sizes the launch with to nvcc as -D defines.
#include <cuda_runtime.h>

#if !defined(MOE_HISTOGRAM_MAX_WARPS) || !defined(MOE_HISTOGRAM_STEPS) || \
    !defined(MOE_HISTOGRAM_MAX_EXPERTS) || !defined(MOE_HISTOGRAM_SMEM_BYTES)
#error "built by moe_histogram/ops.py, which defines the launch geometry"
#endif

namespace {

constexpr int kMaxWarps = MOE_HISTOGRAM_MAX_WARPS;
constexpr int kSteps = MOE_HISTOGRAM_STEPS;   // 32-assignment steps, most
constexpr int kMaxE = MOE_HISTOGRAM_MAX_EXPERTS;
constexpr int kSmemBytes = MOE_HISTOGRAM_SMEM_BYTES;   // dynamic, a block
constexpr int kBatch = 16;         // rows the last block loads at once
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kMaxWarps * 32)
moe_histogram_kernel(const int* __restrict__ idx,
                     const float* __restrict__ gates, int n, int e,
                     int steps, int segments, int* __restrict__ row_cnt,
                     float* __restrict__ row_load,
                     unsigned* __restrict__ ticket,
                     float* __restrict__ out) {
  extern __shared__ float smem[];
  __shared__ bool s_last;
  const int warps = blockDim.x >> 5;
  float* s_load = smem;                                       // warps × E
  int* s_cnt = reinterpret_cast<int*>(s_load + warps * e);    // warps × E
  float* s_gate = reinterpret_cast<float*>(s_cnt + warps * e);  // warps × 32
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this warp's assignments, read ahead of the bins' zeroing
  const long long base =
      (static_cast<long long>(blockIdx.x) * warps + warp) * steps * 32;
  int id[kSteps];
  float g[kSteps];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const long long j = base + s * 32 + lane;
    const bool in = s < steps && j < n;
    id[s] = in ? idx[j] : -1;
    g[s] = in ? gates[j] : 0.f;
  }
  for (int j = tid; j < warps * e; j += blockDim.x) {
    s_load[j] = 0.f;
    s_cnt[j] = 0;
  }
  __syncthreads();

  float* my_load = s_load + warp * e;
  int* my_cnt = s_cnt + warp * e;
  float* my_gate = s_gate + warp * 32;
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    if (s == steps) break;
    const int x = id[s];
    const bool ok = static_cast<unsigned>(x) < static_cast<unsigned>(e);
    const unsigned grp = __match_any_sync(kFull, ok ? x : -1);
    my_gate[lane] = g[s];
    __syncwarp();
    if (ok && lane == __ffs(grp) - 1) {
      float acc = my_load[x];
      for (unsigned m = grp; m; m &= m - 1) acc += my_gate[__ffs(m) - 1];
      my_load[x] = acc;
      my_cnt[x] += __popc(grp);
    }
    __syncwarp();
  }

  // the warps' bins as a tree: warps [h', h) onto [0, h - h'), h' = ⌈h/2⌉
  for (int h = warps; h > 1;) {
    const int half = (h + 1) / 2;
    __syncthreads();
    for (int k = tid; k < (h - half) * e; k += blockDim.x) {
      s_load[k] += s_load[k + half * e];
      s_cnt[k] += s_cnt[k + half * e];
    }
    h = half;
  }
  __syncthreads();

  if (gridDim.x == 1) {
    for (int x = tid; x < e; x += blockDim.x) {
      out[x] = static_cast<float>(s_cnt[x]);
      out[e + x] = s_load[x];
    }
    return;
  }
  for (int x = tid; x < e; x += blockDim.x) {
    const size_t at = static_cast<size_t>(blockIdx.x) * e + x;
    row_cnt[at] = s_cnt[x];
    row_load[at] = s_load[x];
  }

  // the last block to finish folds every block's row
  __syncthreads();
  if (tid == 0) {                // releases the rows, acquires the others'
    unsigned drawn;
    asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;"
                 : "=r"(drawn) : "l"(ticket) : "memory");
    s_last = drawn == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last) return;
  const int blocks = gridDim.x;
  // the bins are free again: segment partials, segments ≤ warps
  for (int k = tid; k < segments * e; k += blockDim.x) {
    const int sg = k / e, x = k - sg * e;
    const int lo = static_cast<int>(static_cast<long long>(sg) * blocks /
                                    segments);
    const int hi = static_cast<int>(static_cast<long long>(sg + 1) * blocks /
                                    segments);
    int c = 0;
    float l = 0.f;
    for (int b0 = lo; b0 < hi; b0 += kBatch) {
      int cb[kBatch];
      float lb[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {      // L2: the other blocks' rows
        const size_t at = static_cast<size_t>(b0 + u) * e + x;
        cb[u] = b0 + u < hi ? __ldcg(row_cnt + at) : 0;
        lb[u] = b0 + u < hi ? __ldcg(row_load + at) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        if (b0 + u < hi) {
          c += cb[u];
          l += lb[u];
        }
      }
    }
    s_cnt[k] = c;
    s_load[k] = l;
  }
  __syncthreads();
  for (int x = tid; x < e; x += blockDim.x) {
    int c = 0;
    float l = 0.f;
    for (int sg = 0; sg < segments; ++sg) {
      c += s_cnt[sg * e + x];
      l += s_load[sg * e + x];
    }
    out[x] = static_cast<float>(c);
    out[e + x] = l;
  }
  if (tid == 0) *ticket = 0u;
}

}  // namespace

// Launch on `stream` of card `device`; returns the CUDA error code of
// the launch (0 = ok).  Geometry from the wrapper (ops.geometry): `warps`
// warps a block, each taking `steps` · 32 assignments (steps ≤ kSteps),
// `blocks` blocks, `segments` runs in the last block's fold.  `rows` is
// int32 scratch of 2 · blocks · E (counts, then loads; unused when
// blocks = 1), `ticket` one uint32 that is 0 on entry and left 0; `out`
// (2, E) float32.
extern "C" int moe_histogram_launch(const int* idx, const float* gates, int n,
                                    int e, int warps, int steps, int blocks,
                                    int segments, int* rows, unsigned* ticket,
                                    float* out, void* stream, int device) {
  const size_t smem = sizeof(float) * 2 * static_cast<size_t>(warps) * e +
                      sizeof(float) * 32 * static_cast<size_t>(warps);
  if (n < 0 || e < 1 || e > kMaxE || warps < 1 || warps > kMaxWarps ||
      steps < 1 || steps > kSteps || blocks < 1 || segments < 1 ||
      segments > warps || segments > blocks || smem > kSmemBytes ||
      static_cast<long long>(blocks) * warps * steps * 32 < n)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int* row_cnt = rows;
  float* row_load =
      reinterpret_cast<float*>(rows + static_cast<size_t>(blocks) * e);
  moe_histogram_kernel<<<blocks, warps * 32, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      idx, gates, n, e, steps, segments, row_cnt, row_load, ticket, out);
  return static_cast<int>(cudaGetLastError());
}
