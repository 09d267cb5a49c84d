// K3 — fused spatial-keyword pub/sub join for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `keyword_match_kernel` (with
// `_point_count_kernel` / `_sub_count_kernel`) in
// src/repro/kernels/keyword_match/keyword_match.py.  A subscription
// (rect, bucket mask) matches a tuple (point, bucket mask) iff the point
// lies inside the rect (inclusive float32 compares, as K2) AND the
// tuple's mask covers the subscription's.  Input: points (N, 2), point
// masks (N, T), rects (Q, 4), subscription masks (Q, T), contiguous
// float32 with exact 0/1 masks.  Output: per-point deliveries and
// per-subscription matches, int32, which the caller zeroes.
//
// The TPU phrased the conjunction as a matmul on the MXU, miss =
// (1 - pmask)^T smask, match iff miss < 0.5.  For 0/1 masks that is the
// bit test "no bucket of the subscription is missing from the tuple", so
// here a first kernel packs each mask row into ceil(T/32) 32-bit words
// (one __ballot_sync per word, reading each mask once), and the match
// kernel tests (sub_word & ~tuple_word) == 0 over the words.  The test is
// exact integer logic: no tensor core and no float sum, so TF32 cannot
// touch it, and an all-zero subscription mask is a wildcard by
// construction.
//
// What bounds it on this card: operations at small T (four compares,
// three ands and one add per pair, plus the word tests of the pairs
// inside the rect); the bytes of the float masks, read once by the
// packing, at large T.  The match kernel has K2's structure: a block
// owns 256 tuples (one per thread) and one chunk of subscriptions staged
// in shared memory (the rect and the first mask word of each); the word
// test runs only for pairs that pass the spatial test and stops at the
// first missing bucket, so the further words of a mask (T > 32) are read
// from global memory through the caches only for those pairs.  A thread
// keeps its tuple's first word in a register.  Per-subscription counts
// come from one __ballot_sync + __popc per subscription and warp, a
// shared-memory sum per block and one global atomicAdd per subscription
// and per tuple per block where the count is not zero; integer atomics
// are order-free, so the counts are deterministic.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;        // tuples per block, one per thread
constexpr int kMaxChunk = 1024;      // subscriptions per block (24 KB)
constexpr int kMinBlocks = 2 * 132 * (2048 / kThreads);  // two full waves
constexpr unsigned kFull = 0xffffffffu;

// Bit b of word w of row r is mask[r, 32 w + b] > 0.5.  One warp per
// (row, word): its 32 lanes read 32 neighbouring floats.
__global__ void pack_bits_kernel(const float* __restrict__ mask, int rows,
                                 int t, int words,
                                 uint32_t* __restrict__ out) {
  const long long warp =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (warp >= static_cast<long long>(rows) * words) return;  // whole warp
  const int lane = threadIdx.x & 31;
  const long long r = warp / words;
  const int col = static_cast<int>(warp % words) * 32 + lane;
  const bool bit = col < t && mask[r * t + col] > 0.5f;
  const unsigned word = __ballot_sync(kFull, bit);
  if (lane == 0) out[warp] = word;
}

__global__ void __launch_bounds__(kThreads)
keyword_match_kernel(const float2* __restrict__ pts,
                     const uint32_t* __restrict__ pwords,
                     const float4* __restrict__ rects,
                     const uint32_t* __restrict__ swords, int n, int q,
                     int words, int chunk, int* __restrict__ pcnt,
                     int* __restrict__ qcnt) {
  __shared__ float4 s_rect[kMaxChunk];
  __shared__ uint32_t s_word0[kMaxChunk];
  __shared__ int s_cnt[kMaxChunk];
  const int base = blockIdx.y * chunk;
  const int nr = min(chunk, q - base);
  for (int j = threadIdx.x; j < nr; j += kThreads) {
    s_rect[j] = rects[base + j];
    s_word0[j] = swords[static_cast<size_t>(base + j) * words];
    s_cnt[j] = 0;
  }
  __syncthreads();

  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float2 p = live ? pts[i] : make_float2(0.f, 0.f);
  const uint32_t* pw = pwords + static_cast<size_t>(live ? i : 0) * words;
  const uint32_t pw0 = live ? pw[0] : 0u;
  const int lane = threadIdx.x & 31;
  int hits = 0;
  // chunk is a multiple of 32, so r stays inside the shared arrays;
  // entries past nr are never written and are masked out
  for (int r0 = 0; r0 < nr; r0 += 32) {
    int mine = 0;
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      const int r = r0 + j;
      const float4 b = s_rect[r];
      bool hit = live && r < nr && p.x >= b.x && p.x <= b.z && p.y >= b.y &&
                 p.y <= b.w && (s_word0[r] & ~pw0) == 0u;
      if (hit && words > 1) {
        const uint32_t* sw = swords + static_cast<size_t>(base + r) * words;
        for (int w = 1; hit && w < words; ++w) hit = (sw[w] & ~pw[w]) == 0u;
      }
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

int pack(const float* mask, int rows, int t, int words, uint32_t* out,
         cudaStream_t stream) {
  const long long threads = static_cast<long long>(rows) * words * 32;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pack_bits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      mask, rows, t, words, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream` of card `device`; returns the CUDA error code of
// the first failed launch (0 = ok).  `pwords` (n, words) and `swords`
// (q, words) are scratch owned by the caller, words = ceil(t / 32);
// `pcnt` (n) and `qcnt` (q) must be zero on entry.  Three launches: pack
// the tuple masks, pack the subscription masks, match.  Tuples tile the
// match grid's x axis and subscription chunks its y axis, so q is at
// most 65535 * 1024 (the wrapper checks).
extern "C" int keyword_match_launch(const float* pts, const float* pmask,
                                    const float* rects, const float* smask,
                                    int n, int q, int t, uint32_t* pwords,
                                    uint32_t* swords, int* pcnt, int* qcnt,
                                    void* stream_ptr, int device) {
  if (n <= 0 || q <= 0 || t <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int words = (t + 31) / 32;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int rc = pack(pmask, n, t, words, pwords, stream);
  if (rc) return rc;
  rc = pack(smask, q, t, words, swords, stream);
  if (rc) return rc;

  const int xb = (n + kThreads - 1) / kThreads;
  int chunk = kMaxChunk;
  while (chunk > 32 &&
         static_cast<long long>(xb) * ((q + chunk - 1) / chunk) < kMinBlocks)
    chunk >>= 1;
  const dim3 grid(xb, (q + chunk - 1) / chunk);
  keyword_match_kernel<<<grid, kThreads, 0, stream>>>(
      reinterpret_cast<const float2*>(pts), pwords,
      reinterpret_cast<const float4*>(rects), swords, n, q, words, chunk,
      pcnt, qcnt);
  return static_cast<int>(cudaGetLastError());
}
