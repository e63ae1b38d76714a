// Causal, optionally segment-masked flash attention for Hopper (sm_90a):
// the forward with its saved log-sum-exp, and the two backward kernels.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   flash_fwd_kernel  <- `_fwd_kernel`     (reached through flash_attention_fwd)
//   flash_dq_kernel   <- `_bwd_dq_kernel`  (flash_attention_bwd)
//   flash_dkv_kernel  <- `_bwd_dkv_kernel` (flash_attention_bwd)
// and `flash_attention_segmented`, which is the same three with segment ids.
// Same functions, with scale = D^-1/2 and s = q.k masked to key <= query
// (causal) and to equal segment ids (segmented; 0 = pad is a segment too):
//   forward: o = softmax(s) v, lse = m + log(max(l, 1e-30)), q scaled
//            before q.k, masked entries of p zeroed explicitly (a key tile
//            can be fully masked for a row, so m may still be the -1e30
//            sentinel, where exp(s - m) would be 1);
//   dq:      p = exp(s*scale - lse), ds = p (do.v - delta) scale, dq = ds k;
//   dk, dv:  dv = p^T do, dk = ds^T q, summed over the q heads of the kv
//            head in a fixed order (q heads ascending, then q tiles, each
//            tile's rows summed first), with no atomics: the same inputs
//            give the same bits.
// delta = rowsum(do * o) is computed by the caller.
//
// Layout: q, o, dq, do are [B, S, H, D] (the layer's layout); k, v, dk, dv
// [B, S, KVH, D], NOT head-expanded: q head h reads kv head hmap[h]. lse and
// delta are [B, H, S] f32; segment ids [B, S] int32. S is any length >= 1:
// rows and keys past S are zero-filled and masked. D is 64 or 128. Inputs
// are f32 or bf16; the math is f32 on the CUDA cores (no TF32, no tensor
// cores), but for f32 inputs the score dot products q.k and do.v sum in f64
// (see DotAcc), and outputs are written in the input dtype.
//
// What bounds it: operations. At the training shape (B 8, S 512, 16 q
// heads, D 64) a forward does ~4.3 GFLOP on ~25 MB, ~170 flops a byte; in
// f32 on the CUDA cores (67 TFLOP/s) the ridge is ~20 flops a byte, so the
// kernels are bound by the FMA pipes and, behind them, by shared-memory
// bandwidth. The design keeps every score tile out of device memory and
// feeds the FMAs from shared memory with 16-byte reads:
//   - a block of 256 threads (16 x 16) owns a 64-query (or, for dk/dv,
//     64-key) tile; Q, K, V, dO tiles are staged in shared memory as f32
//     rows of stride D + 4 floats (an odd number of 16-byte slots, so the
//     16 threads of a half-warp reading 16 different rows hit 16 different
//     bank groups);
//   - each thread computes a 4 x 4 block of the 64 x 64 score tile (rows
//     ty + 16 i, columns tx + 16 j): 8 16-byte shared reads per 64 FMAs;
//     softmax statistics of a row are reduced over the half-warp that holds
//     it with shuffles;
//   - the products with V, K, Q or dO read the probability tile row by row
//     (a broadcast) and 16-byte chunks of the value rows, the thread owning
//     4 rows x D/16 output columns in registers;
//   - the TPU's sequential grid axis (k tiles for forward and dq, q tiles
//     for dk/dv) is a loop inside the block; forward and dq stop at the
//     causal diagonal, dk/dv start at it, and the first dk/dv blocks take
//     the first k tiles, which have the most q tiles to visit.
// Tiles fully masked by segments are still visited (skipping them is the
// next step), and the dk/dv grid is small (S/64 x B x KVH blocks).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;          // queries (and keys) per tile
constexpr int kThreads = 256;      // 16 x 16
constexpr int kLDP = kTile + 4;    // row stride of a [64, 64] score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  __nv_bfloat162 a = __floats2bfloat162_rn(x.x, x.y);
  __nv_bfloat162 b = __floats2bfloat162_rn(x.z, x.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&a);
  raw.y = *reinterpret_cast<uint32_t*>(&b);
  *reinterpret_cast<uint2*>(p) = raw;
}

// max / sum over the 16 lanes of a half-warp (one score row); every lane
// gets the same bits
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// Rows r0 .. r0+63 of head `head` of a [B, S, heads, D] tensor into a
// [64, D + 4] f32 tile, times `mul`; rows at or past S are zeros.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int b, int r0, int head, int heads,
                                          int S, float mul) {
  constexpr int kLD = D + 4, kChunks = D / 4;
  for (int i = threadIdx.x; i < kTile * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) {
      x = load4(src + (((size_t)b * S + r0 + r) * heads + head) * D + c);
      x.x *= mul; x.y *= mul; x.z *= mul; x.w *= mul;
    }
    store4(dst + r * kLD + c, x);
  }
}

// segment ids of positions r0 .. r0+63 of row b (`fill` past S, or all 0
// without segments: then only the causal and length masks apply)
__device__ __forceinline__ void load_seg(int* dst, const int* __restrict__ seg,
                                         int b, int r0, int S, int fill) {
  for (int i = threadIdx.x; i < kTile; i += kThreads)
    dst[i] = r0 + i >= S ? fill : (seg ? seg[(size_t)b * S + r0 + i] : 0);
}

// The accumulator of the score dot products q.k and do.v: f64 for f32
// inputs, whose products are exact in f64. The rounding of these D-long
// sums is most of what separates an f32 evaluation from an f64 one: with a
// peaked softmax (q = 3 N(0, 1)) it goes through exp into p and puts dk and
// dv up to ~3x the 1e-5 tolerance away from f64; summed in f64, every
// output comes within it. bf16 inputs keep f32, which their 2e-2 tolerance
// allows.
template <typename T> struct DotAcc { using type = float; };
template <> struct DotAcc<float> { using type = double; };

__device__ __forceinline__ float fma_acc(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fma_acc(double a, double b, double c) {
  return fma(a, b, c);
}

// out[i][j] = sum_d A[row_i][d] * B[col_j][d] for the thread's rows ty + 16
// i of A and columns tx + 16 j (rows of B); both [64, D + 4]. Summed in Acc,
// rounded once to f32.
template <int D, typename Acc>
__device__ __forceinline__ void dot_tile(float (&out)[4][4],
                                         const float* A, const float* B,
                                         int ty, int tx) {
  constexpr int kLD = D + 4;
  Acc acc[4][4] = {};
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = load4(A + (ty + 16 * i) * kLD + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = load4(B + (tx + 16 * j) * kLD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        Acc x = acc[i][j];
        x = fma_acc(Acc(a[i].x), Acc(b[j].x), x);
        x = fma_acc(Acc(a[i].y), Acc(b[j].y), x);
        x = fma_acc(Acc(a[i].z), Acc(b[j].z), x);
        acc[i][j] = fma_acc(Acc(a[i].w), Acc(b[j].w), x);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) out[i][j] = static_cast<float>(acc[i][j]);
}

// out[i][4u + e] += sum_c P[row_i][c] * V[c][64 u + 4 tx + e] for the
// thread's rows ty + 16 i; P is [64, kLDP], V [64, D + 4]
template <int D>
__device__ __forceinline__ void mul_tile(float (&out)[4][D / 16],
                                         const float* P, const float* V,
                                         int ty, int tx) {
  constexpr int kLD = D + 4, kU = D / 64;
#pragma unroll 2
  for (int c = 0; c < kTile; c += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = load4(P + (ty + 16 * i) * kLDP + c);
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      float4 v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        v[e] = load4(V + (c + e) * kLD + 64 * u + 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pc[4] = {p[i].x, p[i].y, p[i].z, p[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          out[i][4 * u + 0] = fmaf(pc[e], v[e].x, out[i][4 * u + 0]);
          out[i][4 * u + 1] = fmaf(pc[e], v[e].y, out[i][4 * u + 1]);
          out[i][4 * u + 2] = fmaf(pc[e], v[e].z, out[i][4 * u + 2]);
          out[i][4 * u + 3] = fmaf(pc[e], v[e].w, out[i][4 * u + 3]);
        }
      }
    }
  }
}

// out += mul_tile's product, summed over this tile first: a total over many
// tiles then rounds a chain of 64 terms a tile and one add a tile, not one
// chain over every row of every tile
template <int D>
__device__ __forceinline__ void add_tile(float (&out)[4][D / 16],
                                         const float* P, const float* V,
                                         int ty, int tx) {
  float part[4][D / 16] = {};
  mul_tile<D>(part, P, V, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) out[i][c] += part[i][c];
}

// write the thread's rows ty + 16 i (those below S) of a [64, D] register
// tile to rows r0.. of head `head` of a [B, S, heads, D] tensor
template <typename T, int D>
__device__ __forceinline__ void store_tile(T* __restrict__ dst,
                                           const float (&x)[4][D / 16],
                                           int b, int r0, int head, int heads,
                                           int S, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty + 16 * i;
    if (r >= S) continue;
#pragma unroll
    for (int u = 0; u < D / 64; ++u)
      store4(dst + (((size_t)b * S + r) * heads + head) * D + 64 * u + 4 * tx,
             make_float4(x[i][4 * u], x[i][4 * u + 1], x[i][4 * u + 2],
                         x[i][4 * u + 3]));
  }
}

__device__ __forceinline__ bool attends(int q, int k, int S, int causal,
                                        int qseg, int kseg) {
  return q < S && k < S && (!causal || k <= q) && qseg == kseg;
}

template <int D>
constexpr int fwd_smem() {
  return (3 * kTile * (D + 4) + kTile * kLDP) * 4 + 2 * kTile * 4;
}
template <int D>
constexpr int dq_smem() {
  return (4 * kTile * (D + 4) + kTile * kLDP) * 4 + 2 * kTile * 4;
}
template <int D>
constexpr int dkv_smem() {
  return (4 * kTile * (D + 4) + 2 * kTile * kLDP) * 4 + 4 * kTile * 4;
}

// grid (S/64 q tiles, B*H); q scaled before q.k, as the TPU kernel does
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const int* __restrict__ seg,
                 const int* __restrict__ hmap, T* __restrict__ o,
                 float* __restrict__ lse, int S, int H, int KVH, float scale,
                 int causal) {
  constexpr int kLD = D + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kTile * kLD;
  float* Vs = Ks + kTile * kLD;
  float* Ps = Vs + kTile * kLD;
  int* qseg = reinterpret_cast<int*>(Ps + kTile * kLDP);
  int* kseg = qseg + kTile;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int g = hmap[h];

  load_tile<T, D>(Qs, q, b, q0, h, H, S, scale);
  load_seg(qseg, seg, b, q0, S, -1);
  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_keys = causal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    __syncthreads();   // the previous tile's reads of Ks, Vs, Ps are done
    load_tile<T, D>(Ks, k, b, k0, g, KVH, S, 1.f);
    load_tile<T, D>(Vs, v, b, k0, g, KVH, S, 1.f);
    load_seg(kseg, seg, b, k0, S, -2);
    __syncthreads();
    float s[4][4];
    dot_tile<D, typename DotAcc<T>::type>(s, Qs, Ks, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        if (!attends(q0 + r, k0 + c, S, causal, qseg[r], kseg[c]))
          s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = s[i][j] > 0.5f * kNegInf ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * kLDP + tx + 16 * j] = p;
        psum += p;
      }
      const float alpha = expf(m[i] - m_new);
      l[i] = l[i] * alpha + row_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    mul_tile<D>(acc, Ps, Vs, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float lsum = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = acc[i][c] / lsum;
    const int r = q0 + ty + 16 * i;
    if (tx == 0 && r < S)
      lse[((size_t)b * H + h) * S + r] = m[i] + logf(lsum);
  }
  store_tile<T, D>(o, acc, b, q0, h, H, S, ty, tx);
}

// grid (S/64 q tiles, B*H): dq of one q tile over the k tiles up to the
// diagonal
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                const T* __restrict__ v, const T* __restrict__ dout,
                const float* __restrict__ lse, const float* __restrict__ delta,
                const int* __restrict__ seg, const int* __restrict__ hmap,
                T* __restrict__ dq, int S, int H, int KVH, float scale,
                int causal) {
  constexpr int kLD = D + 4;
  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* dOs = Qs + kTile * kLD;
  float* Ks = dOs + kTile * kLD;
  float* Vs = Ks + kTile * kLD;
  float* dSs = Vs + kTile * kLD;
  int* qseg = reinterpret_cast<int*>(dSs + kTile * kLDP);
  int* kseg = qseg + kTile;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int q0 = blockIdx.x * kTile;
  const int b = blockIdx.y / H, h = blockIdx.y % H;
  const int g = hmap[h];

  load_tile<T, D>(Qs, q, b, q0, h, H, S, 1.f);
  load_tile<T, D>(dOs, dout, b, q0, h, H, S, 1.f);
  load_seg(qseg, seg, b, q0, S, -1);
  float lse_r[4], delta_r[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty + 16 * i;
    const size_t at = ((size_t)b * H + h) * S + r;
    lse_r[i] = r < S ? lse[at] : 0.f;
    delta_r[i] = r < S ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_keys = causal ? min(S, q0 + kTile) : S;
  for (int k0 = 0; k0 < n_keys; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(Ks, k, b, k0, g, KVH, S, 1.f);
    load_tile<T, D>(Vs, v, b, k0, g, KVH, S, 1.f);
    load_seg(kseg, seg, b, k0, S, -2);
    __syncthreads();
    float s[4][4], dp[4][4];
    dot_tile<D, typename DotAcc<T>::type>(s, Qs, Ks, ty, tx);
    dot_tile<D, typename DotAcc<T>::type>(dp, dOs, Vs, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const bool ok = attends(q0 + r, k0 + c, S, causal, qseg[r], kseg[c]);
        const float p = ok ? expf(s[i][j] * scale - lse_r[i]) : 0.f;
        dSs[r * kLDP + c] = p * (dp[i][j] - delta_r[i]) * scale;
      }
    }
    __syncthreads();
    mul_tile<D>(acc, dSs, Ks, ty, tx);
  }
  store_tile<T, D>(dq, acc, b, q0, h, H, S, ty, tx);
}

// grid (S/64 k tiles, B*KVH): dk, dv of one k tile of one kv head, summed
// over its q heads and the q tiles from the diagonal on, in a fixed order
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, const int* __restrict__ seg,
                 const int* __restrict__ hmap, T* __restrict__ dk,
                 T* __restrict__ dv, int S, int H, int KVH, float scale,
                 int causal) {
  constexpr int kLD = D + 4;
  extern __shared__ float4 smem4[];
  float* Ks = reinterpret_cast<float*>(smem4);
  float* Vs = Ks + kTile * kLD;
  float* Qs = Vs + kTile * kLD;
  float* dOs = Qs + kTile * kLD;
  float* Pt = dOs + kTile * kLD;     // p^T  [key, query]
  float* dSt = Pt + kTile * kLDP;    // ds^T [key, query]
  int* kseg = reinterpret_cast<int*>(dSt + kTile * kLDP);
  int* qseg = kseg + kTile;
  float* lse_s = reinterpret_cast<float*>(qseg + kTile);
  float* delta_s = lse_s + kTile;

  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  // the heaviest k tile (the first: every q tile after it) starts first
  const int k0 = (gridDim.x - 1 - blockIdx.x) * kTile;
  const int b = blockIdx.y / KVH, g = blockIdx.y % KVH;

  load_tile<T, D>(Ks, k, b, k0, g, KVH, S, 1.f);
  load_tile<T, D>(Vs, v, b, k0, g, KVH, S, 1.f);
  load_seg(kseg, seg, b, k0, S, -2);
  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int first_q = causal ? k0 : 0;
  for (int h = 0; h < H; ++h) {
    if (hmap[h] != g) continue;    // the q heads of this kv head, in order
    for (int q0 = first_q; q0 < S; q0 += kTile) {
      __syncthreads();   // the previous tile's reads are done
      load_tile<T, D>(Qs, q, b, q0, h, H, S, 1.f);
      load_tile<T, D>(dOs, dout, b, q0, h, H, S, 1.f);
      load_seg(qseg, seg, b, q0, S, -1);
      for (int i = threadIdx.x; i < kTile; i += kThreads) {
        const int r = q0 + i;
        const size_t at = ((size_t)b * H + h) * S + r;
        lse_s[i] = r < S ? lse[at] : 0.f;
        delta_s[i] = r < S ? delta[at] : 0.f;
      }
      __syncthreads();
      // transposed tiles: rows are keys ty + 16 i, columns queries tx + 16 j
      float st[4][4], dpt[4][4];
      dot_tile<D, typename DotAcc<T>::type>(st, Ks, Qs, ty, tx);
      dot_tile<D, typename DotAcc<T>::type>(dpt, Vs, dOs, ty, tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = tx + 16 * j;
          const bool ok = attends(q0 + r, k0 + c, S, causal, qseg[r], kseg[c]);
          const float p = ok ? expf(st[i][j] * scale - lse_s[r]) : 0.f;
          Pt[c * kLDP + r] = p;
          dSt[c * kLDP + r] = p * (dpt[i][j] - delta_s[r]) * scale;
        }
      }
      __syncthreads();
      add_tile<D>(dv_acc, Pt, dOs, ty, tx);
      add_tile<D>(dk_acc, dSt, Qs, ty, tx);
    }
  }
  store_tile<T, D>(dk, dk_acc, b, k0, g, KVH, S, ty, tx);
  store_tile<T, D>(dv, dv_acc, b, k0, g, KVH, S, ty, tx);
}

}  // namespace

extern "C" {

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Pointers are device pointers; `seg` may be null (no segment mask); hmap
// and seg are int32, lse and delta f32 [B, H, S]. dtype: 0 = float32,
// 1 = bfloat16 (q, k, v, o, do and the gradients share it). head_dim: 64 or
// 128. Each launches on `stream` without synchronising and returns the CUDA
// error of the launch (0 on success).

#define FLASH_DISPATCH(CALL)                                               \
  if (dtype == 0 && head_dim == 64) { CALL(float, 64); }                   \
  else if (dtype == 0 && head_dim == 128) { CALL(float, 128); }            \
  else if (dtype == 1 && head_dim == 64) { CALL(__nv_bfloat16, 64); }      \
  else if (dtype == 1 && head_dim == 128) { CALL(__nv_bfloat16, 128); }    \
  else { return static_cast<int>(cudaErrorInvalidValue); }                 \
  return static_cast<int>(cudaGetLastError());

int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* seg, const void* hmap, void* o, void* lse,
                        int B, int S, int H, int KVH, int head_dim,
                        float scale, int causal, int dtype, void* stream) {
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define FWD(T, D)                                                          \
  {                                                                        \
    auto kern = flash_fwd_kernel<T, D>;                                    \
    cudaError_t e = cudaFuncSetAttribute(                                  \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, fwd_smem<D>()); \
    if (e != cudaSuccess) return static_cast<int>(e);                      \
    kern<<<grid, kThreads, fwd_smem<D>(), st>>>(                           \
        static_cast<const T*>(q), static_cast<const T*>(k),                \
        static_cast<const T*>(v), static_cast<const int*>(seg),            \
        static_cast<const int*>(hmap), static_cast<T*>(o),                 \
        static_cast<float*>(lse), S, H, KVH, scale, causal);               \
  }
  FLASH_DISPATCH(FWD)
#undef FWD
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* seg,
                           const void* hmap, void* dq, int B, int S, int H,
                           int KVH, int head_dim, float scale, int causal,
                           int dtype, void* stream) {
  const dim3 grid((S + kTile - 1) / kTile, B * H);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DQ(T, D)                                                           \
  {                                                                        \
    auto kern = flash_dq_kernel<T, D>;                                     \
    cudaError_t e = cudaFuncSetAttribute(                                  \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dq_smem<D>());  \
    if (e != cudaSuccess) return static_cast<int>(e);                      \
    kern<<<grid, kThreads, dq_smem<D>(), st>>>(                            \
        static_cast<const T*>(q), static_cast<const T*>(k),                \
        static_cast<const T*>(v), static_cast<const T*>(dout),             \
        static_cast<const float*>(lse), static_cast<const float*>(delta),  \
        static_cast<const int*>(seg), static_cast<const int*>(hmap),       \
        static_cast<T*>(dq), S, H, KVH, scale, causal);                    \
  }
  FLASH_DISPATCH(DQ)
#undef DQ
}

int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* seg,
                            const void* hmap, void* dk, void* dv, int B,
                            int S, int H, int KVH, int head_dim, float scale,
                            int causal, int dtype, void* stream) {
  const dim3 grid((S + kTile - 1) / kTile, B * KVH);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DKV(T, D)                                                          \
  {                                                                        \
    auto kern = flash_dkv_kernel<T, D>;                                    \
    cudaError_t e = cudaFuncSetAttribute(                                  \
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dkv_smem<D>()); \
    if (e != cudaSuccess) return static_cast<int>(e);                      \
    kern<<<grid, kThreads, dkv_smem<D>(), st>>>(                           \
        static_cast<const T*>(q), static_cast<const T*>(k),                \
        static_cast<const T*>(v), static_cast<const T*>(dout),             \
        static_cast<const float*>(lse), static_cast<const float*>(delta),  \
        static_cast<const int*>(seg), static_cast<const int*>(hmap),       \
        static_cast<T*>(dk), static_cast<T*>(dv), S, H, KVH, scale,        \
        causal);                                                           \
  }
  FLASH_DISPATCH(DKV)
#undef DKV
}

#undef FLASH_DISPATCH

}  // extern "C"
