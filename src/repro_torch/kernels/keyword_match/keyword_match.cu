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
// (one __ballot_sync per word, reading each mask once) and the match
// kernel tests (sub_word & ~tuple_word) == 0.  The test is exact integer
// logic: no tensor core and no float sum, so TF32 cannot touch it, and
// an all-zero subscription mask is a wildcard by construction.
//
// What bounds it on this card: operations at small T — the spatial
// and first-word tests of every (tuple, subscription) pair, a
// brute-force join as on the TPU — and the bytes of the float masks,
// read once by the packing, at large T.  Compares, logic and integer
// adds issue on the SM's ALU pipe, 16 lanes a clock per scheduler, half
// the rate of the FMA pipe (with float compares the SASS issued four
// FSETP, a LOP3, a PLOP3, a SEL and the adds a pair: 10.2 ms of ALU issue
// at the pub/sub delivery tick on an H100, which took 10.5 ms).  So the
// match kernel spends as few ALU instructions a pair as it can:
//
// - coordinates become order-preserving 32-bit keys (x + 0 folds -0 into
//   +0; a sign flip makes float order unsigned order), and a rect one
//   (lo key, width) pair per axis, so "lo <= x <= hi" is one subtraction,
//   which the compiler puts on the FMA pipe as an IMAD, and one unsigned
//   compare (k - lo) <= width.  A pair then issues one LOP3 (the word
//   test), two chained ISETP, a SEL and about one IADD3 (the counts) on
//   the ALU pipe.  That is exact: the keys of non-NaN floats keep their
//   order and equality, NaN keys lie outside [key(-inf), key(+inf)], and
//   a rect that can match nothing (lo > hi or a NaN bound) becomes
//   (0, 0), which only the key 0 passes — no point has it;
// - a thread holds R tuples (x and y keys and the complement of the
//   first mask word in registers), so one broadcast shared-memory read
//   of a subscription's keys and first word serves R pairs, and the
//   tests count the pair for the tuple and for the subscription.  Past
//   one mask word R is smaller (kMultiWordTuples), as the word tests
//   hold more registers;
// - padding instead of per-pair tests: tuples past N get the key of a
//   NaN, subscriptions past Q the rect (0, 0).  Every lane runs every
//   pair to the end;
// - a subscription's count over the warp's 32·R tuples is one
//   __reduce_add_sync of the threads' 0…R hits, kept by lane (sub mod
//   32), added into a shared count per subscription, and added to global
//   memory once per chunk where it is not zero; a tuple's count stays in
//   a register until the block ends.  Integer atomics are order-free, so
//   the counts are deterministic;
// - block (x, y) owns tuple tile x (kThreads·R tuples) and walks the `per`
//   consecutive chunks of group y (kChunk subscriptions each), staging
//   the next chunk by cp.async into a two-stage ring while it tests this
//   one.  The grid's y axis counts groups, not chunks, so Q has no limit
//   from the grid;
// - words past the first (T > 32) are tested only for pairs that pass the
//   spatial and first-word tests, and only a subscription's non-zero
//   words: a listing kernel keeps up to kList (index, word) pairs per
//   subscription and the count; a subscription with more falls back to
//   testing every word.
//
// The launch geometry is chosen by the wrapper (ops.py), which gives the
// constants it sizes tiles and chunks with to nvcc as -D defines.
#include <cuda_runtime.h>
#include <stdint.h>

#if !defined(KEYWORD_MATCH_THREADS) || !defined(KEYWORD_MATCH_CHUNK) || \
    !defined(KEYWORD_MATCH_TUPLES) || !defined(KEYWORD_MATCH_MULTI_WORD_TUPLES)
#error "built by keyword_match/ops.py, which defines the launch geometry"
#endif

namespace {

constexpr int kThreads = KEYWORD_MATCH_THREADS;
constexpr int kChunk = KEYWORD_MATCH_CHUNK;   // subscriptions staged at once
// R, tuples a thread, with one mask word and with more
constexpr int kTuples = KEYWORD_MATCH_TUPLES;
constexpr int kMultiWordTuples = KEYWORD_MATCH_MULTI_WORD_TUPLES;
constexpr int kList = 4;           // non-zero words listed per subscription
constexpr unsigned kFull = 0xffffffffu;
constexpr uint32_t kNanKey = 0xffffffffu;   // above key(+inf) = 0xff800000

// Order-preserving key of a float: x < y iff key(x) < key(y) and x == y
// iff key(x) == key(y) for non-NaN x, y (-0 and +0 alike); NaN → kNanKey.
__device__ __forceinline__ uint32_t order_key(float f) {
  if (f != f) return kNanKey;
  const uint32_t b = __float_as_uint(f + 0.0f);
  return (b & 0x80000000u) ? ~b : (b | 0x80000000u);
}

// Rect (x0, y0, x1, y1) → (key x0, key x1 - key x0, key y0, key y1 -
// key y0); a rect no point lies in (lo > hi, a NaN bound) → (0, 0, 0, 0).
__global__ void rect_keys_kernel(const float4* __restrict__ rects, int q,
                                 uint4* __restrict__ keys) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= q) return;
  const float4 b = rects[i];
  uint4 k = make_uint4(0u, 0u, 0u, 0u);
  if (b.x <= b.z && b.y <= b.w) {
    k.x = order_key(b.x);
    k.y = order_key(b.z) - k.x;
    k.z = order_key(b.y);
    k.w = order_key(b.w) - k.z;
  }
  keys[i] = k;
}

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

// One warp per subscription row of `words` packed words: its first word,
// its number of non-zero words, and the first kList of them as (index,
// word) pairs.
__global__ void list_words_kernel(const uint32_t* __restrict__ swords, int q,
                                  int words, uint2* __restrict__ slist,
                                  uint32_t* __restrict__ sw0,
                                  int* __restrict__ snz) {
  const long long r =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) >> 5;
  if (r >= q) return;                                        // whole warp
  const int lane = threadIdx.x & 31;
  const uint32_t* row = swords + r * words;
  int nz = 0;
  for (int w0 = 0; w0 < words; w0 += 32) {
    const int w = w0 + lane;
    const uint32_t v = w < words ? row[w] : 0u;
    const unsigned live = __ballot_sync(kFull, v != 0u);
    const int rank = nz + __popc(live & ((1u << lane) - 1u));
    if (v != 0u && rank < kList)
      slist[r * kList + rank] = make_uint2(static_cast<unsigned>(w), v);
    nz += __popc(live);
  }
  if (lane == 0) {
    sw0[r] = row[0];
    snz[r] = nz;
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

// Stage subscriptions [base, base + kChunk): rect keys and first words
// by cp.async, the rect (0, 0) and a zero word past q; one commit group.
__device__ __forceinline__ void stage(uint4* s_rect, uint32_t* s_w,
                                      const uint4* __restrict__ keys,
                                      const uint32_t* __restrict__ sw0, int q,
                                      int base) {
  for (int j = threadIdx.x; j < kChunk; j += kThreads) {
    const int g = base + j;
    if (g < q) {
      cp_async16(s_rect + j, keys + g);
      cp_async4(s_w + j, sw0 + g);
    } else {
      s_rect[j] = make_uint4(0u, 0u, 0u, 0u);
      s_w[j] = 0u;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Add a chunk's non-zero subscription counts to global memory and zero
// them for the chunk after next.
__device__ __forceinline__ void flush(int* s_cnt, int* __restrict__ qcnt,
                                      int base) {
  for (int j = threadIdx.x; j < kChunk; j += kThreads) {
    const int c = s_cnt[j];
    if (c) {
      atomicAdd(qcnt + base + j, c);
      s_cnt[j] = 0;
    }
  }
}

// Words past the first of subscription g against tuple i: the listed
// non-zero words, or every word when there are more than kList.
__device__ __noinline__ bool rest_covered(int g, long long i, int words,
                                          const uint32_t* __restrict__ pwords,
                                          const uint32_t* __restrict__ swords,
                                          const uint2* __restrict__ slist,
                                          const int* __restrict__ snz) {
  const uint32_t* pw = pwords + i * words;
  const int nz = snz[g];
  if (nz <= kList) {
    const uint2* l = slist + static_cast<size_t>(g) * kList;
    for (int k = 0; k < nz; ++k) {
      const uint2 e = l[k];
      if (e.y & ~pw[e.x]) return false;
    }
    return true;
  }
  const uint32_t* sw = swords + static_cast<size_t>(g) * words;
  for (int w = 1; w < words; ++w)
    if (sw[w] & ~pw[w]) return false;
  return true;
}

template <bool kMulti>
__global__ void __launch_bounds__(kThreads)
keyword_match_kernel(const float2* __restrict__ pts,
                     const uint32_t* __restrict__ pwords,
                     const uint4* __restrict__ keys,
                     const uint32_t* __restrict__ sw0,
                     const uint32_t* __restrict__ swords,
                     const uint2* __restrict__ slist,
                     const int* __restrict__ snz, int n, int q, int words,
                     int per, int* __restrict__ pcnt,
                     int* __restrict__ qcnt) {
  __shared__ __align__(16) uint4 s_rect[2][kChunk];
  __shared__ uint32_t s_w[2][kChunk];
  __shared__ int s_cnt[2][kChunk];
  constexpr int R = kMulti ? kMultiWordTuples : kTuples;
  const int tid = threadIdx.x, lane = tid & 31;
  const long long tile = static_cast<long long>(blockIdx.x) * kThreads * R;
  const int chunks = (q + kChunk - 1) / kChunk;
  const int c0 = blockIdx.y * per, c1 = min(c0 + per, chunks);  // c0 < c1
  stage(s_rect[0], s_w[0], keys, sw0, q, c0 * kChunk);

  uint32_t kx[R], ky[R];                         // the tuples' keys
  uint32_t npw[R];                               // ~ first word of the tuple
  int hits[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const long long i = tile + r * kThreads + tid;
    const bool live = i < n;
    const float2 p = live ? pts[i] : make_float2(0.f, 0.f);
    kx[r] = live ? order_key(p.x) : kNanKey;
    ky[r] = live ? order_key(p.y) : kNanKey;
    npw[r] = live ? ~pwords[i * words] : 0u;
    hits[r] = 0;
  }
  for (int j = tid; j < kChunk; j += kThreads) s_cnt[0][j] = s_cnt[1][j] = 0;

  for (int c = c0; c < c1; ++c) {
    const int s = (c - c0) & 1;
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();             // chunk c landed; chunk c - 1 tested
    if (c + 1 < c1)
      stage(s_rect[s ^ 1], s_w[s ^ 1], keys, sw0, q, (c + 1) * kChunk);
    if (c > c0) flush(s_cnt[s ^ 1], qcnt, (c - 1) * kChunk);
    const uint4* rect = s_rect[s];
    const uint32_t* word = s_w[s];
    for (int j0 = 0; j0 < kChunk; j0 += 32) {
      unsigned mine = 0;
#pragma unroll 4
      for (int j = 0; j < 32; ++j) {
        const uint4 b = rect[j0 + j];
        const uint32_t w = word[j0 + j];
        unsigned cnt = 0;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          // the word test first: its predicate then enters the compare
          // chain, where last it took a PLOP3 of its own
          bool hit = ((w & npw[r]) == 0u) & (kx[r] - b.x <= b.y) &
                     (ky[r] - b.z <= b.w);
          if (kMulti && hit)
            hit = rest_covered(c * kChunk + j0 + j, tile + r * kThreads + tid,
                               words, pwords, swords, slist, snz);
          hits[r] += hit;
          cnt += hit;
        }
        const unsigned v = __reduce_add_sync(kFull, cnt);
        mine = lane == j ? v : mine;
      }
      if (mine) atomicAdd(&s_cnt[s][j0 + lane], static_cast<int>(mine));
    }
  }
  __syncthreads();
  flush(s_cnt[(c1 - 1 - c0) & 1], qcnt, (c1 - 1) * kChunk);
#pragma unroll
  for (int r = 0; r < R; ++r)                    // a hit means a live tuple
    if (hits[r]) atomicAdd(pcnt + tile + r * kThreads + tid, hits[r]);
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

// 32-bit words of subscription scratch a launch over q subscriptions and
// t buckets needs: the rect keys and the packed words, and past one word
// a row also the (index, word) list, the first word and the non-zero
// count.
extern "C" long long keyword_match_sub_scratch(int q, int t) {
  const long long words = (t + 31) / 32;
  return static_cast<long long>(q) *
         (4 + (words == 1 ? 1 : words + 2 * kList + 2));
}

// Launch on `stream` of card `device`; returns the CUDA error code of
// the first failed launch (0 = ok).  `pwords` (n, ceil(t/32)) and `sub`
// (keyword_match_sub_scratch(q, t) words) are scratch owned by the
// caller; `pcnt` (n) and `qcnt` (q) must be zero on entry.  Geometry
// from the wrapper (ops.geometry): `tiles` tiles of kThreads·R tuples,
// `groups` groups of `per` chunks of kChunk subscriptions, every group
// non-empty.  Four launches at t ≤ 32 (pack
// the tuple masks, the rect keys, pack the subscription masks, match),
// five above (list the subscriptions' non-zero words before the match).
extern "C" int keyword_match_launch(const float* pts, const float* pmask,
                                    const float* rects, const float* smask,
                                    int n, int q, int t, int tiles,
                                    int groups, int per, uint32_t* pwords,
                                    uint32_t* sub, int* pcnt, int* qcnt,
                                    void* stream_ptr, int device) {
  const long long chunks = (static_cast<long long>(q) + kChunk - 1) / kChunk;
  const int words = (t + 31) / 32;
  const int r = words == 1 ? kTuples : kMultiWordTuples;
  if (n <= 0 || q <= 0 || t <= 0 || tiles < 1 || groups < 1 ||
      groups > 65535 || per < 1 ||
      static_cast<long long>(tiles) * kThreads * r < n ||
      static_cast<long long>(groups) * per < chunks ||
      static_cast<long long>(groups - 1) * per >= chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  int rc = pack(pmask, n, t, words, pwords, stream);
  if (rc) return rc;
  uint4* keys = reinterpret_cast<uint4*>(sub);
  uint32_t* swords = sub + 4 * static_cast<size_t>(q);
  uint32_t* sw0 = swords;
  uint2* slist = nullptr;
  int* snz = nullptr;
  if (words > 1) {
    slist = reinterpret_cast<uint2*>(swords);
    swords += 2 * kList * static_cast<size_t>(q);
    sw0 = swords + static_cast<size_t>(q) * words;
    snz = reinterpret_cast<int*>(sw0 + q);
  }
  rect_keys_kernel<<<(q + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      reinterpret_cast<const float4*>(rects), q, keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  rc = pack(smask, q, t, words, swords, stream);
  if (rc) return rc;
  if (words > 1) {
    const long long blocks = (static_cast<long long>(q) * 32 + kThreads - 1) /
                             kThreads;
    list_words_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        stream>>>(swords, q, words, slist, sw0, snz);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(tiles, groups);
  const float2* p = reinterpret_cast<const float2*>(pts);
  if (words == 1)
    keyword_match_kernel<false><<<grid, kThreads, 0, stream>>>(
        p, pwords, keys, sw0, swords, slist, snz, n, q, words, per, pcnt,
        qcnt);
  else
    keyword_match_kernel<true><<<grid, kThreads, 0, stream>>>(
        p, pwords, keys, sw0, swords, slist, snz, n, q, words, per, pcnt,
        qcnt);
  return static_cast<int>(cudaGetLastError());
}
