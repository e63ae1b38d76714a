// Paged decode attention for Hopper (sm_90a): one query token per batch row
// against a KV cache that lives in a shared page pool.
//
// Replaces the TPU kernel `_paged_kernel` of
// src/repro/kernels/decode_attention.py (reached through
// `paged_decode_attention`). Same function: for row b and q head h,
//   o[b, h] = softmax_t(q[b, h] . K[t] * D^-0.5) V   over t < valid_len[b],
// where position t of row b lives in pool page page_tables[b, t / page_size]
// (sentinel entries >= num_pages are clamped to num_pages - 1 and, since the
// engine always allocates pages covering [0, valid_len), only ever sit past
// valid_len) and kv head hmap[h]. Online softmax with m, l and the
// accumulator in f32; the output is written in the dtype of q.
//
// What bounds it: reading K and V. At decode, each K/V element is used by
// the few q heads of its group once, so the kernel does ~2 flops per byte
// read, far below the card's ~295 flops/byte ridge: it is bound by device
// memory bandwidth once enough of the card is busy. The design reads every
// needed K/V byte once and keeps the block's warps independent:
//   - one block per (kv head, batch row) serves every q head that hmap maps
//     to that kv head (no head-expanded copy of the pool is ever built);
//     a row has at most kMaxHeads = 16 q heads (qwen2.5-0.5b's padded 16),
//     so a group always fits in registers at once;
//   - the TPU's sequential page grid axis becomes a loop inside the block:
//     each of the kWarps warps takes every kWarps-th tile of 32 positions
//     and keeps its own online-softmax state (m, l, acc) in registers, so
//     the warps load and compute without waiting for each other; the
//     page lookup is done per position, so any page_size works;
//   - q.k: one position per lane, its K row read with 16-byte loads and
//     dotted with the group's q rows (f32, in shared memory, broadcast);
//     p.V: lanes own two head dims each and read each V row coalesced, the
//     probabilities staged per warp in shared memory and read 4 at a time;
//     a tile's 32 V loads all start before its q.k math, so their
//     latency overlaps it; q is read from shared memory 16 bytes at a time
//     (the shared-memory pipe, not the FMA units, limits the inner loops);
//   - at the end the warps' states are merged through shared memory
//     (rescaled by exp(m_w - max m)), the flash-decoding combine, done
//     inside the block;
//   - positions at or past valid_len are neither read nor computed.
// With few rows the grid is small (8 blocks for 4 slots x 2 kv heads), so
// most SMs idle; splitting long rows across blocks is the next step.
//
// valid_len[b] = 0 is not on the serving path (the engine passes pos+1 >= 1);
// such a row gets zeros here, where the plain version returns the mean of V.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;            // head dim this kernel is written for
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;         // positions per warp step: one per lane
constexpr int kMaxHeads = 16;     // q heads per row (hence per kv group)
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

template <typename T> struct VecWidth;
template <> struct VecWidth<float> { static constexpr int value = 4; };
template <> struct VecWidth<__nv_bfloat16> { static constexpr int value = 8; };

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

// two neighbouring elements, kept in their storage type until used
template <typename T> struct Pair;
template <> struct Pair<float> { using type = float2; };
template <> struct Pair<__nv_bfloat16> { using type = __nv_bfloat162; };

__device__ __forceinline__ float2 load_pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ __nv_bfloat162 load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const __nv_bfloat162*>(p);
}
__device__ __forceinline__ float2 to_float2(float2 v) { return v; }
__device__ __forceinline__ float2 to_float2(__nv_bfloat162 v) {
  return __bfloat1622float2(v);
}

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

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

// per-warp probabilities of the current tile during the loop; the warps'
// accumulators for the merge afterwards
union __align__(16) WarpBuffers {
  float p[kWarps][kMaxHeads][kTile];
  float acc[kWarps][kMaxHeads][kD];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pool,
                    const T* __restrict__ v_pool,
                    const int* __restrict__ page_tables,
                    const int* __restrict__ valid_len,
                    const int* __restrict__ hmap, T* __restrict__ out, int H,
                    int KVH, int num_pages, int page_size, int max_pages,
                    float scale) {
  constexpr int kVec = VecWidth<T>::value;
  __shared__ __align__(16) float qs[kMaxHeads][kD];
  __shared__ float m_w[kWarps][kMaxHeads], l_w[kWarps][kMaxHeads];
  __shared__ WarpBuffers buf;
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
  __syncthreads();
  const int G = n_heads;
  const int n_keys = min(valid_len[b], max_pages * page_size);
  const int* row_table = page_tables + (size_t)b * max_pages;
  const long long pos_stride = (long long)KVH * kD;  // elements per position

  for (int i = tid; i < G * kD; i += kThreads) {
    const int g = i / kD, d = i % kD;
    qs[g][d] = to_float(q[((size_t)b * H + heads[g]) * kD + d]) * scale;
  }
  __syncthreads();

  float m[kMaxHeads], l[kMaxHeads], acc0[kMaxHeads], acc1[kMaxHeads];
#pragma unroll
  for (int g = 0; g < kMaxHeads; ++g) {
    m[g] = kNegInf;
    l[g] = acc0[g] = acc1[g] = 0.f;
  }

  for (int t0 = warp * kTile; t0 < n_keys; t0 += kWarps * kTile) {
    const int t = t0 + lane;
    const bool valid = t < n_keys;
    const int nt = min(kTile, n_keys - t0);
    long long row = 0;   // element offset of position t's K/V row
    if (valid) {
      const int page = min(row_table[t / page_size], num_pages - 1);
      row = ((long long)page * page_size + t % page_size) * pos_stride +
            (long long)kvh * kD;
    }
    // start the tile's V loads first (this lane's two dims of all 32
    // positions) so that they are in flight during q.k and the softmax
    typename Pair<T>::type vv[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const long long r = __shfl_sync(kFull, row, j);
      if (j < nt) vv[j] = load_pair(v_pool + r + 2 * lane);
    }
    float s[kMaxHeads];
#pragma unroll
    for (int g = 0; g < kMaxHeads; ++g) s[g] = 0.f;
    if (valid) {
#pragma unroll
      for (int c = 0; c < kD / kVec; ++c) {
        float kf[kVec];
        load16(k_pool + row + c * kVec, kf);
#pragma unroll
        for (int g = 0; g < kMaxHeads; ++g) {
          if (g < G) {
#pragma unroll
            for (int e = 0; e < kVec; e += 4) {   // q as 16-byte reads
              const float4 q4 =
                  *reinterpret_cast<const float4*>(&qs[g][c * kVec + e]);
              s[g] = fmaf(q4.x, kf[e], s[g]);
              s[g] = fmaf(q4.y, kf[e + 1], s[g]);
              s[g] = fmaf(q4.z, kf[e + 2], s[g]);
              s[g] = fmaf(q4.w, kf[e + 3], s[g]);
            }
          }
        }
      }
    }
    // online softmax over this warp's 32 positions, per head
#pragma unroll
    for (int g = 0; g < kMaxHeads; ++g) {
      if (g < G) {
        const float sg = valid ? s[g] : kNegInf;
        const float m_new = fmaxf(m[g], warp_max(sg));
        const float p = expf(sg - m_new);
        const float alpha = expf(m[g] - m_new);
        l[g] = l[g] * alpha + warp_sum(p);
        m[g] = m_new;
        acc0[g] *= alpha;
        acc1[g] *= alpha;
        buf.p[warp][g][lane] = p;   // 0 past valid_len
      }
    }
    __syncwarp();
    // p.V: this lane's two dims; probabilities read 4 at a time
#pragma unroll
    for (int j = 0; j < kTile; j += 4) {
      if (j < nt) {
        float2 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          v[u] = j + u < nt ? to_float2(vv[j + u]) : make_float2(0.f, 0.f);
#pragma unroll
        for (int g = 0; g < kMaxHeads; ++g) {
          if (g < G) {
            const float4 p4 =
                *reinterpret_cast<const float4*>(&buf.p[warp][g][j]);
            acc0[g] = fmaf(p4.x, v[0].x, acc0[g]);
            acc1[g] = fmaf(p4.x, v[0].y, acc1[g]);
            acc0[g] = fmaf(p4.y, v[1].x, acc0[g]);
            acc1[g] = fmaf(p4.y, v[1].y, acc1[g]);
            acc0[g] = fmaf(p4.z, v[2].x, acc0[g]);
            acc1[g] = fmaf(p4.z, v[2].y, acc1[g]);
            acc0[g] = fmaf(p4.w, v[3].x, acc0[g]);
            acc1[g] = fmaf(p4.w, v[3].y, acc1[g]);
          }
        }
      }
    }
    __syncwarp();   // buf.p is rewritten by the next tile
  }
  __syncthreads();  // every warp is done with buf.p before buf.acc

  // merge the warps' states (flash-decoding combine inside the block)
#pragma unroll
  for (int g = 0; g < kMaxHeads; ++g) {
    if (g < G) {
      if (lane == 0) {
        m_w[warp][g] = m[g];
        l_w[warp][g] = l[g];
      }
      buf.acc[warp][g][2 * lane] = acc0[g];
      buf.acc[warp][g][2 * lane + 1] = acc1[g];
    }
  }
  __syncthreads();
  for (int i = tid; i < G * kD; i += kThreads) {
    const int g = i / kD, d = i % kD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
    float lsum = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(m_w[w][g] - mx);
      lsum = fmaf(l_w[w][g], f, lsum);
      o = fmaf(buf.acc[w][g][d], f, o);
    }
    store(out + ((size_t)b * H + heads[g]) * kD + d,
          o / fmaxf(lsum, 1e-30f));
  }
}

}  // namespace

extern "C" {

int paged_decode_attention_head_dim() { return kD; }
int paged_decode_attention_max_heads() { return kMaxHeads; }

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pointers are device pointers; the tables, valid_len and hmap are int32.
// dtype: 0 = float32, 1 = bfloat16 (q, pools and out share it). Launches on
// `stream` without synchronising and returns cudaGetLastError().
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const void* page_tables,
                           const void* valid_len, const void* hmap, void* out,
                           int B, int H, int KVH, int num_pages, int page_size,
                           int max_pages, float scale, int dtype,
                           void* stream) {
  const dim3 grid(KVH, B);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* tbl = static_cast<const int*>(page_tables);
  const int* vl = static_cast<const int*>(valid_len);
  const int* hm = static_cast<const int*>(hmap);
  if (dtype == 1) {
    paged_decode_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(q),
        static_cast<const __nv_bfloat16*>(k_pool),
        static_cast<const __nv_bfloat16*>(v_pool), tbl, vl, hm,
        static_cast<__nv_bfloat16*>(out), H, KVH, num_pages, page_size,
        max_pages, scale);
  } else if (dtype == 0) {
    paged_decode_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(q), static_cast<const float*>(k_pool),
        static_cast<const float*>(v_pool), tbl, vl, hm,
        static_cast<float*>(out), H, KVH, num_pages, page_size, max_pages,
        scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
