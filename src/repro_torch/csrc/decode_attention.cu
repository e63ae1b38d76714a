// Dense decode attention for Hopper (sm_90a): one query token per batch row
// against that row's dense KV cache.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/decode_attention.py
// (reached through `decode_attention`). Same function: for row b and q head h,
//   o[b, h] = softmax_t(q[b, h] . K[b, t, hmap[h]] * D^-0.5) V[b, t, hmap[h]]
// over t < valid_len[b]. Online softmax with m, l and the accumulator in
// f32; the output is written in the dtype of q. Differences from the TPU
// kernel: it reads one layer's unexpanded cache [B, S, KVH, D] through the
// q-head -> kv-head map hmap (the TPU kernel takes a head-expanded
// [B*H, S, D] copy), takes any S >= 1 (the TPU kernel needs S % 512 == 0
// above 512), and stops at valid_len instead of visiting and masking every
// 512-wide block (the result is the same). valid_len[b] = 0 is not on the
// serving path (the engine passes pos + 1 >= 1): such a row gets zeros here,
// where the reference returns the mean of V. A q head whose hmap entry is
// outside [0, KVH) is served by no block; block (0, b) writes zeros to it.
//
// What bounds it: reading K and V. Each K/V element is used by the few q
// heads of its group once, ~2 flops per byte read against the card's ~295
// flops/byte ridge, so the bound is the bytes of the valid K/V rows over the
// device memory rate. The design reads every needed K/V byte once and keeps
// the block's warps independent, as the paged kernel
// (paged_decode_attention.cu) does:
//   - one block per (kv head, batch row) serves every q head that hmap maps
//     to that kv head, at most kMaxHeads = 16 (qwen2.5-0.5b's padded 16), so
//     a group's state always fits in registers;
//   - the TPU's sequential KV-block grid axis becomes a loop inside the
//     block: each of the kWarps warps takes every kWarps-th tile of 32
//     positions with its own online-softmax state (m, l, acc) in registers;
//   - q.k: one position per lane, its K row read with 16-byte loads and
//     dotted with the group's q rows (f32 in shared memory, broadcast);
//     for f32 inputs the dot products are summed in f64 (exact products),
//     so the f32 kernel stays as close to an f64 evaluation as the plain
//     f32 version is (the rounding of the D-long sum, through exp, is the
//     largest error of an f32 evaluation at a peaked softmax);
//   - p.V: lanes own D/32 neighbouring head dims each and read each V row
//     coalesced; the tile's first V rows are loaded before its q.k math so
//     that their latency overlaps it (all 32 where they fit in registers);
//   - at the end the warps' states are merged through shared memory
//     (rescaled by exp(m_w - max m)), the flash-decoding combine, the warps
//     adding in a fixed order, so the same inputs give the same bits;
//   - positions at or past valid_len are neither read nor computed.
// The grid is small at decode (32 blocks for 16 rows x 2 kv heads): most
// SMs idle. Splitting long rows across blocks with a combine step is the
// next step.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;         // positions per warp step: one per lane
constexpr int kMaxHeads = 16;     // q heads per row (hence per kv group)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* out) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N neighbouring elements of a V row, one vector load, kept in the storage
// type until used
template <typename T, int N>
struct alignas(sizeof(T) * N) LaneVec {
  T v[N];
};

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const T* __restrict__ q, const T* __restrict__ k,
              const T* __restrict__ v, const int* __restrict__ valid_len,
              const int* __restrict__ hmap, T* __restrict__ out, int H,
              int KVH, int S, float scale) {
  constexpr int kN = D / 32;               // head dims per lane in p.V
  constexpr int kVec = 16 / sizeof(T);     // elements per 16-byte K load
  // V rows loaded ahead of q.k: all 32 where they take <= 64 registers
  constexpr int kPre = kN * sizeof(T) <= 8 ? kTile : 8;
  using Acc = typename std::conditional<std::is_same<T, float>::value,
                                        double, float>::type;
  using Lane = LaneVec<T, kN>;

  __shared__ __align__(16) float qs[kMaxHeads][D];
  __shared__ __align__(16) float ps[kWarps][kMaxHeads][kTile];
  __shared__ __align__(16) float os[kMaxHeads][D];
  __shared__ float m_w[kWarps][kMaxHeads], l_w[kWarps][kMaxHeads];
  __shared__ int heads[kMaxHeads];
  __shared__ int n_heads;

  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  if (warp == 0) {  // the group's q heads, in order (H <= kMaxHeads <= 32)
    const bool mine = lane < H && hmap[lane] == kvh;
    const unsigned mask = __ballot_sync(kFull, mine);
    if (mine) heads[__popc(mask & ((1u << lane) - 1u))] = lane;
    if (lane == 0) n_heads = __popc(mask);
  }
  if (kvh == 0) {  // a q head whose hmap entry no block serves: zeros
    for (int i = tid; i < H * D; i += kThreads) {
      const int g = hmap[i / D];
      if (g < 0 || g >= KVH) store(out + (long long)b * H * D + i, 0.f);
    }
  }
  __syncthreads();
  const int G = n_heads;
  const int n_keys = min(valid_len[b], S);
  const long long pos_stride = (long long)KVH * D;  // elements per position
  const long long base = (long long)b * S * pos_stride + (long long)kvh * D;

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    qs[g][d] = to_float(q[((long long)b * H + heads[g]) * D + d]);
  }
  __syncthreads();

  float m[kMaxHeads], l[kMaxHeads], acc[kMaxHeads][kN];
#pragma unroll
  for (int g = 0; g < kMaxHeads; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < kN; ++e) acc[g][e] = 0.f;
  }

  for (int t0 = warp * kTile; t0 < n_keys; t0 += kWarps * kTile) {
    const int t = t0 + lane;
    const bool valid = t < n_keys;
    const int nt = min(kTile, n_keys - t0);    // warp-uniform
    // element offset of position t's K/V row (lanes past the end: unused)
    const long long row = base + (long long)(valid ? t : t0) * pos_stride;
    Lane vv[kPre];
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const long long r = __shfl_sync(kFull, row, j);
      if (j < nt) vv[j] = *reinterpret_cast<const Lane*>(v + r + lane * kN);
    }
    Acc s[kMaxHeads];
#pragma unroll
    for (int g = 0; g < kMaxHeads; ++g) s[g] = 0;
    if (valid) {
#pragma unroll 4
      for (int c = 0; c < D / kVec; ++c) {
        float kf[kVec];
        load16(k + row + c * kVec, kf);
#pragma unroll
        for (int g = 0; g < kMaxHeads; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < kVec; e += 4) {   // q as 16-byte reads
              const float4 q4 =
                  *reinterpret_cast<const float4*>(&qs[g][c * kVec + e]);
              s[g] = fma_acc(Acc(q4.x), Acc(kf[e]), s[g]);
              s[g] = fma_acc(Acc(q4.y), Acc(kf[e + 1]), s[g]);
              s[g] = fma_acc(Acc(q4.z), Acc(kf[e + 2]), s[g]);
              s[g] = fma_acc(Acc(q4.w), Acc(kf[e + 3]), s[g]);
            }
          }
        }
      }
    }
    // online softmax over this warp's 32 positions, per head
#pragma unroll
    for (int g = 0; g < kMaxHeads; ++g) {
      if (g < G) {
        const float sg = valid ? float(s[g] * Acc(scale)) : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float p = expf(sg - m_new);
        const float alpha = expf(m[g] - m_new);
        l[g] = l[g] * alpha + warp_sum(p);
        m[g] = m_new;
#pragma unroll
        for (int e = 0; e < kN; ++e) acc[g][e] *= alpha;
        ps[warp][g][lane] = p;   // 0 past valid_len
      }
    }
    __syncwarp();
    // p.V: this lane's kN dims of 4 positions at a time
#pragma unroll
    for (int j = 0; j < kTile; j += 4) {
      if (j < nt) {
        float vf[4][kN];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int jj = j + u;
          Lane raw;
          if (jj < kPre) {
            raw = vv[jj < kPre ? jj : 0];
          } else {
            const long long r = __shfl_sync(kFull, row, jj);
            if (jj < nt) raw = *reinterpret_cast<const Lane*>(v + r + lane * kN);
          }
#pragma unroll
          for (int e = 0; e < kN; ++e)
            vf[u][e] = jj < nt ? to_float(raw.v[e]) : 0.f;
        }
#pragma unroll
        for (int g = 0; g < kMaxHeads; ++g) {
          if (g < G) {
            const float4 p4 = *reinterpret_cast<const float4*>(&ps[warp][g][j]);
#pragma unroll
            for (int e = 0; e < kN; ++e) {
              acc[g][e] = fmaf(p4.x, vf[0][e], acc[g][e]);
              acc[g][e] = fmaf(p4.y, vf[1][e], acc[g][e]);
              acc[g][e] = fmaf(p4.z, vf[2][e], acc[g][e]);
              acc[g][e] = fmaf(p4.w, vf[3][e], acc[g][e]);
            }
          }
        }
      }
    }
    __syncwarp();   // ps is rewritten by the next tile
  }

  // merge the warps' states (flash-decoding combine inside the block)
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < kMaxHeads; ++g) {
      if (g < G) {
        m_w[warp][g] = m[g];
        l_w[warp][g] = l[g];
      }
    }
  }
  __syncthreads();
  float f[kMaxHeads];   // this warp's weight in the merged softmax
#pragma unroll
  for (int g = 0; g < kMaxHeads; ++g) {
    f[g] = 0.f;
    if (g < G) {
      float mx = kNegInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
      float lsum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w)
        lsum = fmaf(l_w[w][g], expf(m_w[w][g] - mx), lsum);
      f[g] = expf(m[g] - mx) / fmaxf(lsum, 1e-30f);
    }
  }
  // the warps add their weighted accumulators in a fixed order
  for (int w = 0; w < kWarps; ++w) {
    if (warp == w) {
#pragma unroll
      for (int g = 0; g < kMaxHeads; ++g) {
        if (g < G) {
#pragma unroll
          for (int e = 0; e < kN; ++e) {
            const float x = acc[g][e] * f[g];
            float* o = &os[g][lane * kN + e];
            *o = w == 0 ? x : *o + x;
          }
        }
      }
    }
    __syncthreads();
  }
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    store(out + ((long long)b * H + heads[g]) * D + d, os[g][d]);
  }
}

template <typename T>
int launch_typed(const void* q, const void* k, const void* v, const int* vl,
                 const int* hm, void* out, int B, int H, int KVH, int S,
                 int D, float scale, cudaStream_t s) {
  const dim3 grid(KVH, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  T* ot = static_cast<T*>(out);
  if (D == 64) {
    decode_kernel<T, 64><<<grid, kThreads, 0, s>>>(qt, kt, vt, vl, hm, ot, H,
                                                   KVH, S, scale);
  } else if (D == 128) {
    decode_kernel<T, 128><<<grid, kThreads, 0, s>>>(qt, kt, vt, vl, hm, ot,
                                                    H, KVH, S, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int decode_attention_max_heads() { return kMaxHeads; }

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pointers are device pointers; valid_len [B] and hmap [H] are int32; q and
// out [B, H, D], k and v [B, S, KVH, D], contiguous. dtype: 0 = float32,
// 1 = bfloat16 (q, k, v and out share it); D is 64 or 128; H <= kMaxHeads.
// Launches on `stream` without synchronising and returns cudaGetLastError()
// (cudaErrorInvalidValue for what the kernel does not take).
int decode_attention(const void* q, const void* k, const void* v,
                     const void* valid_len, const void* hmap, void* out,
                     int B, int H, int KVH, int S, int D, float scale,
                     int dtype, void* stream) {
  if (H < 1 || H > kMaxHeads || KVH < 1 || S < 1 || B < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* vl = static_cast<const int*>(valid_len);
  const int* hm = static_cast<const int*>(hmap);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(q, k, v, vl, hm, out, B, H, KVH, S, D,
                                       scale, s);
  if (dtype == 0)
    return launch_typed<float>(q, k, v, vl, hm, out, B, H, KVH, S, D, scale,
                               s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
