// K6 — blocked forward attention with an online softmax for Hopper
// (sm_90a).
//
// Replaces the Pallas TPU kernel `flash_attention_kernel` (with
// `_kernel`) in src/repro/kernels/flash_attention/flash_attention.py.
// Input: q (B, H, S, D), k and v (B, Hkv, Skv, D), float32 or bfloat16,
// each given by its batch, head and row strides with D contiguous (so a
// (B, S, H, D) projection or a KV cache longer than Skv is read in place).
// Output: o (B, H, S, D) in q's type.  Query head h reads kv head
// h / (H / Hkv) (GQA).  Row i sits at absolute position i + q_offset;
// key j is kept when j < Skv, j <= i + q_offset (causal) and
// j > i + q_offset − window (sliding window).  A row with no key gets 0,
// as the reference's max(l, 1e-30) gives.
//
// What bounds it on this card: for a bfloat16 prefill, bytes at the
// serve path's shapes (q, k, v, o once: 0.25 ms at (50, 16, 1024, 128))
// just above the 4·D operations per visible (query, key) pair on the
// bf16 tensor cores (0.22 ms; flash_mma issues 6·D, so 0.33 ms is its
// own floor); for a decode step, bytes (one query row against the whole
// cache).  The TPU walked the kv blocks as the
// innermost sequential grid axis and kept the running max, sum and
// accumulator in VMEM scratch.  Here the kv loop is a loop inside the
// block, and the state lives in registers.  Tiles wholly beyond the
// causal or window edge of a block's rows are never loaded, and blocks
// of the last query rows, which see the most keys, are issued first.
//
// - flash_mma (bfloat16, S > kRowMax: prefill): one block of 4 warps per
//   (b, h, 64 query rows), each warp owning 16 rows.  Both products run
//   on the bf16 tensor cores (mma.sync m16n8k16, float32 accumulators),
//   fed by ldmatrix from bf16 tiles in shared memory whose rows are
//   padded by 16 bytes (conflict-free ldmatrix); Q's fragments are read
//   from shared memory at each k step.  The Q tile is copied once, K and
//   V tiles of 32 keys through a two-stage ring, all with cp.async (16
//   bytes a thread, zero-filled past Skv or S), so tile j+1 is in flight
//   while tile j is computed.  32-key tiles and Q in shared memory keep
//   a thread at 128 registers at D = 128 (96 at D = 80) and a block at
//   52 KB, so four blocks share an SM; at D = 256 (254 registers, 101 KB)
//   two do.  Scores are scaled in float32 after the product (1/sqrt(D)
//   does not round to bf16 at D = 80, 128).  The online softmax runs on
//   the accumulator fragments (a row lives in a quad of lanes: two
//   shuffles for its max).  P goes from the score accumulators straight
//   into the A fragments of P·V, as two bf16 terms, hi = bf16(p) and
//   lo = bf16(p − hi), two MMAs a step: one bf16 rounding of p puts
//   outputs of rows that see few keys up to ~50× past two bf16 steps of
//   the plain value, the split keeps them within one.  That costs 6·D
//   tensor-core operations per pair instead of 4·D.
// - flash_tile (float32, S > kRowMax): one block of 8 warps per
//   (b, h, 64 query rows), each warp owning 8 rows, on float32 FMAs.  The
//   block stages its query rows (scaled) and then each kv tile in shared
//   memory; a lane owns BK/32 keys of the tile for the scores (float4
//   reads, K rows padded by 4 floats so the reads are free of bank
//   conflicts) and D/32 columns of the accumulator; P reaches the P·V
//   product by warp shuffles.
// - flash_row (S <= kRowMax, a decode step): one block of 4 warps per
//   (b, h, row), each warp streaming a quarter of the row's key range
//   from device memory (lanes split D, so each key row is one coalesced
//   read) with its own running state, four keys a step so their loads
//   overlap; the four states are merged at the end.
//
// Numerics: scores, the running max, the row sum and the accumulator are
// float32; exponentials are expf (not __expf); multiply-adds contract to
// FMAs (the build drops --fmad=false), so a result is held to a
// tolerance against the plain version, not bit for bit.  flash_mma needs
// every row of q, k and v to start on 16 bytes (the wrapper checks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;  // the running max's start, as on the TPU
constexpr int kWarps = 8;          // flash_tile: warps per block
constexpr int kRows = 8;           // flash_tile: query rows per warp
constexpr int kBQ = kWarps * kRows;
constexpr int kMmaWarps = kBQ / 16;  // flash_mma: warps of 16 rows each
constexpr int kRowWarps = 4;       // flash_row: warps per block
constexpr int kRowMax = 4;         // longest S that takes flash_row
constexpr int kUnroll = 4;         // flash_row: keys per step

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long q_sb, q_sh, q_ss;  // strides in elements: batch, head, row
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  int h, group, s, skv, q_offset, window, causal;
  float scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x = fmaxf(x, __shfl_xor_sync(~0u, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o; o >>= 1) x += __shfl_xor_sync(~0u, x, o);
  return x;
}

template <int D>
struct TileShape {
  static constexpr int BK = D > 128 ? 32 : 64;  // keys per kv tile
  static constexpr int DP = D + 4;              // padded K row (floats)
  static constexpr size_t smem =
      sizeof(float) * (kBQ * D + BK * DP + BK * D);
};

template <int D, typename T>
__global__ void __launch_bounds__(kWarps * 32)
flash_tile(Params p) {
  constexpr int BK = TileShape<D>::BK;
  constexpr int DP = TileShape<D>::DP;
  constexpr int KPL = BK / 32;          // keys per lane
  constexpr int DPL = (D + 31) / 32;    // accumulator columns per lane
  extern __shared__ float4 smem4[];
  float* sQ = reinterpret_cast<float*>(smem4);  // kBQ × D
  float* sK = sQ + kBQ * D;                     // BK × DP
  float* sV = sK + BK * DP;                     // BK × D

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int b = blockIdx.x / p.h, h = blockIdx.x % p.h, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int i = tid; i < kBQ * D; i += kWarps * 32) {
    const int r = i / D, d = i - r * D;
    sQ[i] = q0 + r < p.s ? to_f(q[(q0 + r) * p.q_ss + d]) * p.scale : 0.f;
  }
  const int last = min(q0 + kBQ, p.s) - 1 + p.q_offset;  // absolute
  const int kv_end = p.causal ? min(p.skv, last + 1) : p.skv;
  const int kv_begin =
      p.window > 0 ? max(0, q0 + p.q_offset - p.window + 1) : 0;

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }

  for (int j0 = kv_begin; j0 < kv_end; j0 += BK) {
    __syncthreads();  // the previous tile is consumed (and sQ is staged)
    for (int i = tid; i < BK * D; i += kWarps * 32) {
      const int jj = i / D, d = i - jj * D, col = j0 + jj;
      const bool in = col < kv_end;
      sK[jj * DP + d] = in ? to_f(k[col * p.k_ss + d]) : 0.f;
      sV[jj * D + d] = in ? to_f(v[col * p.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float s[kRows][KPL];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) s[r][kk] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 kf[KPL];
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk)
        kf[kk] = *reinterpret_cast<const float4*>(sK + (lane + 32 * kk) * DP
                                                  + d);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 qf =
            *reinterpret_cast<const float4*>(sQ + (warp * kRows + r) * D + d);
#pragma unroll
        for (int kk = 0; kk < KPL; ++kk) {
          s[r][kk] += qf.x * kf[kk].x;
          s[r][kk] += qf.y * kf[kk].y;
          s[r][kk] += qf.z * kf[kk].z;
          s[r][kk] += qf.w * kf[kk].w;
        }
      }
    }

    // masks and the online softmax; a masked score is -inf, so its
    // probability is exactly 0 and it never moves the running max
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int ra = q0 + warp * kRows + r + p.q_offset;
      float mx = -INFINITY;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        const int col = j0 + lane + 32 * kk;
        const bool ok = col < kv_end && (!p.causal || col <= ra)
                        && (p.window <= 0 || col > ra - p.window);
        s[r][kk] = ok ? s[r][kk] : -INFINITY;
        mx = fmaxf(mx, s[r][kk]);
      }
      const float m_new = fmaxf(m[r], warp_max(mx));
      const float alpha = expf(m[r] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int kk = 0; kk < KPL; ++kk) {
        s[r][kk] = expf(s[r][kk] - m_new);   // now the probability
        ps += s[r][kk];
      }
      l[r] = l[r] * alpha + warp_sum(ps);
      m[r] = m_new;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
    }

    // acc += P · V: key (kk, src) lives in lane src's s[·][kk]
#pragma unroll
    for (int kk = 0; kk < KPL; ++kk) {
#pragma unroll 4
      for (int src = 0; src < 32; ++src) {
        const float* vrow = sV + (kk * 32 + src) * D;
        float vv[DPL];
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          const int d = lane + 32 * i;
          vv[i] = d < D ? vrow[d] : 0.f;
        }
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float pj = __shfl_sync(~0u, s[r][kk], src);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] += pj * vv[i];
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    const int row = q0 + warp * kRows + r;
    if (row >= p.s) continue;
    const float denom = fmaxf(l[r], 1e-30f);
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      const int d = lane + 32 * i;
      if (d < D) o[row * p.o_ss + d] = from_f<T>(acc[r][i] / denom);
    }
  }
}

// --- flash_mma: bf16 tensor cores -----------------------------------------

template <int D>
struct MmaShape {
  // keys per kv tile and the K/V ring's depth: BK = 64 or three stages
  // leave fewer blocks an SM, 1.1–1.4× slower at D = 128 and 256
  // (variants.py)
  static constexpr int BK = 32;
  static constexpr int kStages = 2;
  static constexpr int LD = D + 8;    // shared row in bf16: 16 bytes of pad
  static constexpr size_t smem =
      sizeof(__nv_bfloat16) * (kBQ * LD + 2 * kStages * BK * LD);
};

__device__ __forceinline__ unsigned smem_u32(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global → shared, asynchronously; zero-filled when !full
__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(full ? 16 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], unsigned a) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(unsigned (&r)[4],
                                                  unsigned a) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// c (16×8, float32) += a (16×16, bf16, row) · b (16×8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned bf16x2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<unsigned*>(&x);
}

// (x, y) as two bf16 terms: hi = bf16(x), lo = bf16(x − hi), each packed
// with x in the low half (the lower column of an A fragment)
__device__ __forceinline__ void split_bf16(float x, float y, unsigned& hi,
                                           unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bf16x2_bits(h);
  lo = bf16x2_bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Fragment layouts (PTX ISA, mma.m16n8k16): lane = 4·g + t.  A (16×16)
// regs {(g, 2t..), (g+8, 2t..), (g, 2t+8..), (g+8, 2t+8..)}; B (16×8)
// regs {(2t.., g), (2t+8.., g)}; C (16×8) {(g, 2t), (g, 2t+1),
// (g+8, 2t), (g+8, 2t+1)}.  So the C fragments of two neighbouring n8
// score tiles are the A fragment of one k16 step of P·V.
template <int D>
__global__ void __launch_bounds__(kMmaWarps * 32)
flash_mma(Params p) {
  using bf16 = __nv_bfloat16;
  constexpr int BK = MmaShape<D>::BK, LD = MmaShape<D>::LD;
  constexpr int kStages = MmaShape<D>::kStages;
  constexpr int KS = D / 16;        // k16 steps of Q·Kᵀ
  constexpr int NT = BK / 8;        // n8 score tiles
  constexpr int DT = D / 8;         // n8 output tiles
  constexpr int CH = D / 8;         // 16-byte chunks in a row
  constexpr int kThreads = kMmaWarps * 32;
  static_assert(D % 16 == 0 && BK % 16 == 0, "k16 steps");
  extern __shared__ float4 smem4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem4);  // kBQ × LD
  bf16* sK = sQ + kBQ * LD;                   // kStages × BK × LD
  bf16* sV = sK + kStages * BK * LD;          // kStages × BK × LD

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / p.h, h = blockIdx.x % p.h, hk = h / p.group;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;  // heaviest first
  const bf16* q = static_cast<const bf16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const bf16* k = static_cast<const bf16*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const bf16* v = static_cast<const bf16*>(p.v) + b * p.v_sb + hk * p.v_sh;
  bf16* o = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;

  const int last = min(q0 + kBQ, p.s) - 1 + p.q_offset;  // absolute
  const int kv_end = p.causal ? min(p.skv, last + 1) : p.skv;
  const int kv_begin =
      p.window > 0 ? max(0, q0 + p.q_offset - p.window + 1) : 0;
  const int n_tiles = kv_end > kv_begin ? (kv_end - kv_begin + BK - 1) / BK
                                        : 0;

  for (int c = tid; c < kBQ * CH; c += kThreads) {
    const int r = c / CH, cc = c - r * CH;
    const bool in = q0 + r < p.s;
    cp_async16(smem_u32(sQ + r * LD + cc * 8),
               in ? q + (q0 + r) * p.q_ss + cc * 8 : q, in);
  }
  auto load_kv = [&](int tile, int stage) {
    const int j0 = kv_begin + tile * BK;
    bf16* dk = sK + stage * BK * LD;
    bf16* dv = sV + stage * BK * LD;
    for (int c = tid; c < BK * CH; c += kThreads) {
      const int r = c / CH, cc = c - r * CH, col = j0 + r;
      const bool in = col < kv_end;
      cp_async16(smem_u32(dk + r * LD + cc * 8),
                 in ? k + col * p.k_ss + cc * 8 : k, in);
      cp_async16(smem_u32(dv + r * LD + cc * 8),
                 in ? v + col * p.v_ss + cc * 8 : v, in);
    }
  };
  // the ring's first kStages − 1 tiles; group 0 also holds Q
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) load_kv(st, st);
    cp_async_commit();
  }

  // each lane's row and column in the 8×8 matrices of its ldmatrix.x4
  const int r0 = warp * 16;                                  // warp's rows
  const int a_row = lane & 15, a_col = (lane >> 4) * 8;      // Q: A
  const int k_row = (lane & 7) + ((lane >> 4) << 3);         // K: B
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_row = (lane & 7) + (((lane >> 3) & 1) << 3);   // V: B, trans
  const int v_col = (lane >> 4) * 8;
  const int ra0 = q0 + r0 + g + p.q_offset;  // absolute row of c0, c1

  float acc[DT][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int stage = tile % kStages, ahead = tile + kStages - 1;
    if (ahead < n_tiles) load_kv(ahead, ahead % kStages);
    cp_async_commit();
    cp_async_wait<kStages - 1>();   // tile has landed; later ones may not
    __syncthreads();
    const bf16* tK = sK + stage * BK * LD;
    const bf16* tV = sV + stage * BK * LD;

    // S = Q · Kᵀ for the warp's 16 rows and the tile's BK keys
    float s[NT][4];
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      unsigned a[4];
      ldmatrix_x4(a, smem_u32(sQ + (r0 + a_row) * LD + ks * 16 + a_col));
#pragma unroll
      for (int j = 0; j < NT; j += 2) {
        unsigned kb[4];
        ldmatrix_x4(kb, smem_u32(tK + (j * 8 + k_row) * LD + ks * 16
                                 + k_col));
        mma_bf16(s[j], a, kb[0], kb[1]);
        mma_bf16(s[j + 1], a, kb[2], kb[3]);
      }
    }

    // scale in float32; masks where the tile crosses an edge of the
    // block's rows (a masked score is -inf: its probability is exactly 0)
    const int j0 = kv_begin + tile * BK;
    const bool whole = j0 + BK <= kv_end
                       && (!p.causal || j0 + BK - 1 <= q0 + p.q_offset)
                       && (p.window <= 0
                           || j0 > q0 + kBQ - 1 + p.q_offset - p.window);
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * p.scale;
        if (!whole) {
          const int col = j0 + j * 8 + 2 * t + (e & 1);
          const int ra = ra0 + (e >> 1) * 8;
          const bool ok = col < kv_end && (!p.causal || col <= ra)
                          && (p.window <= 0 || col > ra - p.window);
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
      }

    // online softmax: rows g (i = 0) and g + 8 (i = 1) of the warp's 16;
    // l keeps this lane's share of the row sum, folded at the end
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < NT; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * i], s[j][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(~0u, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[j][e] = expf(s[j][e] - m_new);   // now the probability
          ps += s[j][e];
        }
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        acc[d][2 * i] *= alpha;
        acc[d][2 * i + 1] *= alpha;
      }
    }

    // acc += P · V, P as hi + lo bf16 terms
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      unsigned hi[4], lo[4];
      split_bf16(s[2 * kk][0], s[2 * kk][1], hi[0], lo[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], hi[1], lo[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], hi[2], lo[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int d = 0; d < DT; d += 2) {
        unsigned vb[4];
        ldmatrix_x4_trans(vb, smem_u32(tV + (kk * 16 + v_row) * LD + d * 8
                                       + v_col));
        mma_bf16(acc[d], hi, vb[0], vb[1]);
        mma_bf16(acc[d + 1], hi, vb[2], vb[3]);
        mma_bf16(acc[d], lo, vb[0], vb[1]);
        mma_bf16(acc[d + 1], lo, vb[2], vb[3]);
      }
    }
    __syncthreads();                // this stage may be refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(~0u, l[i], 1);
    l[i] += __shfl_xor_sync(~0u, l[i], 2);
    const int row = q0 + r0 + g + 8 * i;
    if (row >= p.s) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    bf16* orow = o + row * p.o_ss + 2 * t;
#pragma unroll
    for (int d = 0; d < DT; ++d)
      *reinterpret_cast<__nv_bfloat162*>(orow + d * 8) =
          __floats2bfloat162_rn(acc[d][2 * i] / denom,
                                acc[d][2 * i + 1] / denom);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kRowWarps * 32)
flash_row(Params p) {
  constexpr int DPL = (D + 31) / 32;
  __shared__ float s_m[kRowWarps], s_l[kRowWarps];
  __shared__ float s_acc[kRowWarps][DPL * 32];

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int b = blockIdx.x / p.h, h = blockIdx.x % p.h, hk = h / p.group;
  const int row = blockIdx.y;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh
               + row * p.q_ss;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + hk * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + hk * p.v_sh;

  float qv[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    qv[i] = d < D ? to_f(q[d]) * p.scale : 0.f;
  }
  // every key of [kv_begin, kv_end) passes this row's masks
  const int ra = row + p.q_offset;
  const int kv_end = p.causal ? min(p.skv, ra + 1) : p.skv;
  const int kv_begin = p.window > 0 ? max(0, ra - p.window + 1) : 0;
  const int n = max(0, kv_end - kv_begin);
  const int per = (n + kRowWarps - 1) / kRowWarps;
  const int lo = kv_begin + warp * per;
  const int hi = min(kv_end, lo + per);

  float m = kNegInf, l = 0.f, acc[DPL];
#pragma unroll
  for (int i = 0; i < DPL; ++i) acc[i] = 0.f;
  for (int j = lo; j < hi; j += kUnroll) {
    float s[kUnroll], vv[kUnroll][DPL];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool in = j + u < hi;
      float part = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        const int d = lane + 32 * i;
        const bool ld = in && d < D;
        part += ld ? qv[i] * to_f(k[(j + u) * p.k_ss + d]) : 0.f;
        vv[u][i] = ld ? to_f(v[(j + u) * p.v_ss + d]) : 0.f;
      }
      s[u] = part;
    }
    float mx = -INFINITY;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] = j + u < hi ? warp_sum(s[u]) : -INFINITY;
      mx = fmaxf(mx, s[u]);
    }
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[i] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const float pu = expf(s[u] - m_new);
      l += pu;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[i] += pu * vv[u][i];
    }
    m = m_new;
  }

  if (lane == 0) {
    s_m[warp] = m;
    s_l[warp] = l;
  }
#pragma unroll
  for (int i = 0; i < DPL; ++i) s_acc[warp][lane + 32 * i] = acc[i];
  __syncthreads();
  if (warp) return;
  float mm = kNegInf;
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) mm = fmaxf(mm, s_m[w]);
  float ll = 0.f, scale_w[kRowWarps];
#pragma unroll
  for (int w = 0; w < kRowWarps; ++w) {
    scale_w[w] = expf(s_m[w] - mm);
    ll += s_l[w] * scale_w[w];
  }
  const float denom = fmaxf(ll, 1e-30f);
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh + row * p.o_ss;
#pragma unroll
  for (int i = 0; i < DPL; ++i) {
    const int d = lane + 32 * i;
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kRowWarps; ++w) a += s_acc[w][d] * scale_w[w];
    if (d < D) o[d] = from_f<T>(a / denom);
  }
}

// Launch a tile kernel; its shared-memory cap is raised on its first
// launch (above 48 KB only dynamic shared memory may be used).
template <void (*Kernel)(Params)>
int launch_tile(dim3 grid, int threads, size_t smem, const Params& p,
                cudaStream_t stream) {
  static bool sized = false;
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  Kernel<<<grid, threads, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename T>
int launch(const Params& p, int batch, cudaStream_t stream) {
  if (p.s <= kRowMax) {
    flash_row<D, T><<<dim3(batch * p.h, p.s), kRowWarps * 32, 0, stream>>>(
        p);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(batch * p.h, (p.s + kBQ - 1) / kBQ);
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return launch_tile<flash_mma<D>>(grid, kMmaWarps * 32,
                                     MmaShape<D>::smem, p, stream);
  else
    return launch_tile<flash_tile<D, T>>(grid, kWarps * 32,
                                         TileShape<D>::smem, p, stream);
}

template <typename T>
int dispatch(int d, const Params& p, int batch, cudaStream_t stream) {
  switch (d) {
    case 16: return launch<16, T>(p, batch, stream);
    case 80: return launch<80, T>(p, batch, stream);
    case 128: return launch<128, T>(p, batch, stream);
    case 256: return launch<256, T>(p, batch, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Launch on `stream` of card `device`; returns the CUDA error code (0 =
// ok).  `strides` holds 12 element strides: batch, head and row of q, k,
// v and o, in that order.  dtype: 0 float32, 1 bfloat16 (all four
// tensors).  window <= 0: no sliding window.  d is one of 16, 80, 128,
// 256 (the wrapper checks).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const long long* strides, int batch,
                                      int h, int hkv, int s, int skv, int d,
                                      int dtype, int causal, int window,
                                      int q_offset, float scale,
                                      void* stream, int device) {
  if (batch <= 0 || h <= 0 || hkv <= 0 || h % hkv || s <= 0 || skv < 0
      || (s > kRowMax && (s + kBQ - 1) / kBQ > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p{q, k, v, o,
           strides[0], strides[1], strides[2], strides[3], strides[4],
           strides[5], strides[6], strides[7], strides[8], strides[9],
           strides[10], strides[11],
           h, h / hkv, s, skv, q_offset, window, causal, scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 1 ? dispatch<__nv_bfloat16>(d, p, batch, st)
                    : dispatch<float>(d, p, batch, st);
}
