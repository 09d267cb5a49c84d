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
// What bounds it on this card: operations for a prefill (S·Skv·D
// multiply-adds twice over, the causal half skipped), bytes for a decode
// step (one query row against the whole cache).  The TPU walked the kv
// blocks as the innermost sequential grid axis and kept the running max,
// sum and accumulator in VMEM scratch.  Here the kv loop is a loop inside
// the block, and the state lives in registers:
//
// - flash_tile (S > kRowMax): one block of 8 warps per (b, h, 64 query
//   rows), each warp owning 8 rows.  The block stages its query rows
//   (scaled) and then each kv tile in shared memory as float32; a lane
//   owns BK/32 keys of the tile for the scores (float4 reads, K rows
//   padded by 4 floats so the reads are free of bank conflicts) and
//   D/32 columns of the accumulator; P reaches the P·V product by warp
//   shuffles.  Tiles wholly beyond the causal or window edge of the
//   block's rows are never loaded.  Blocks of the last query rows, which
//   see the most keys, are issued first.
// - flash_row (S <= kRowMax, a decode step): one block of 4 warps per
//   (b, h, row), each warp streaming a quarter of the row's key range
//   from device memory (lanes split D, so each key row is one coalesced
//   read) with its own running state, four keys a step so their loads
//   overlap; the four states are merged at the end.
//
// Numerics: scores, the running max, the row sum and the accumulator are
// float32; exponentials are expf (not __expf); multiply-adds contract to
// FMAs (the build drops --fmad=false), so a result is held to a
// tolerance against the plain version, not bit for bit.  No tensor cores
// yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr float kNegInf = -1e30f;  // the running max's start, as on the TPU
constexpr int kWarps = 8;          // flash_tile: warps per block
constexpr int kRows = 8;           // flash_tile: query rows per warp
constexpr int kBQ = kWarps * kRows;
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

template <int D, typename T>
int launch(const Params& p, int batch, cudaStream_t stream) {
  if (p.s <= kRowMax) {
    flash_row<D, T><<<dim3(batch * p.h, p.s), kRowWarps * 32, 0, stream>>>(
        p);
    return static_cast<int>(cudaGetLastError());
  }
  constexpr size_t smem = TileShape<D>::smem;
  static bool sized = false;  // raise the block's shared-memory cap once
  if (!sized) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_tile<D, T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    sized = true;
  }
  flash_tile<D, T><<<dim3(batch * p.h, (p.s + kBQ - 1) / kBQ),
                     kWarps * 32, smem, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
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
