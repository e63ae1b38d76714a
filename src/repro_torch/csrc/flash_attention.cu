// Causal, optionally segment-masked flash attention for Hopper (sm_90a):
// the forward with its saved log-sum-exp, and the two backward kernels.
//
// Replaces the TPU kernels of src/repro/kernels/flash_attention.py:
//   forward (row 4) <- `_fwd_kernel`     (reached through flash_attention_fwd)
//   dq      (row 5) <- `_bwd_dq_kernel`  (flash_attention_bwd)
//   dk, dv  (row 6) <- `_bwd_dkv_kernel` (flash_attention_bwd)
// and `flash_attention_segmented`, which is the same three with segment ids.
// Same functions, with scale = D^-1/2 and s = q.k masked to key <= query
// (causal) and to equal segment ids (segmented; 0 = pad is a segment too):
//   forward: o = softmax(s scale) v, lse = m + log(max(l, 1e-30)), masked
//            entries of p zeroed explicitly (a key tile can be fully masked
//            for a row, so m may still be the -1e30 sentinel, where
//            exp(s - m) would be 1);
//   dq:      p = exp(s*scale - lse), ds = p (do.v - delta) scale, dq = ds k;
//   dk, dv:  dv = p^T do, dk = ds^T q, summed over the q heads of the kv
//            head in a fixed order with no atomics: the same inputs give
//            the same bits.
// delta = rowsum(do * o) is computed by the caller.
//
// Layout: q, o, dq, do are [B, S, H, D] (the layer's layout); k, v, dk, dv
// [B, S, KVH, D], NOT head-expanded: q head h reads kv head hmap[h]. lse and
// delta are [B, H, S] f32; segment ids [B, S] int32. S is any length >= 1:
// rows and keys past S are zero-filled and masked. D is 64 or 128.
//
// Which body serves which dtype:
//   - bf16 (all three): `flash_fwd_kernel_tc`, `flash_dq_kernel_tc`,
//     `flash_dkv_kernel_tc` (+ `flash_dkv_sum_kernel`), on the tensor cores
//     (below);
//   - f32 (all three): `flash_fwd_kernel`, `flash_dq_kernel`,
//     `flash_dkv_kernel`, f32 FMAs on the CUDA cores. The score dot
//     products q.k and do.v sum in f64 (DotAcc): they are the accuracy path
//     held against f64, which TF32 or bf16 tensor cores would not meet at
//     the f32 1e-5 tolerance.
//
// What bounds them: at the training shape (B 8, S 512, 16 q heads, D 64) a
// causal forward does ~4.3 GFLOP on ~19 MB, ~220 flops a byte: far above
// the CUDA cores' ridge (~20 flops a byte at 67 TFLOP/s f32), so the f32
// bodies are bound by operations; just below the bf16 tensor cores' (~295
// at 989 TFLOP/s), so the bf16 forward is bound by its bytes and the causal
// dk/dv (4 products) by operations. Segments cut the operations further:
// 8.3% of the causal pairs attend at the packed shape.
//
// The bf16 bodies (FlashAttention-2's shape, on mma.sync.m16n8k16, bf16 in,
// f32 accumulate):
//   - a block of 4 warps owns 64 rows of the fixed side (queries in the
//     forward and dq, keys of one kv head in dk/dv), 16 to a warp; its
//     tiles and the moving side's tiles are staged in shared memory as
//     bf16 rows of stride D + 8 (8 rows read by one ldmatrix hit 8
//     different 16-byte bank groups), the moving tiles in a ring of 3
//     cp.async stages (2 for the head-dim-128 forward and dq, for their
//     shared memory), rows past S zero-filled;
//   - every product runs on the tensor cores, its operands taken with
//     ldmatrix (.trans for the second product's B); the score tile stays in
//     the accumulator registers: the online softmax (forward), p and ds
//     (dq, dk/dv) are computed there, the scale applied to the f32 scores,
//     the row statistics reduced over the 4 lanes of a quad, and p (ds)
//     made the A operand of the next product in registers: in the forward
//     p and in dq ds rounded to bf16 once; in dk/dv p and ds as a bf16 hi +
//     lo pair, two products into the same sums (6 products a tile, not 4),
//     since dk and dv sum p do and ds q over many queries and q heads, and
//     one bf16 rounding of p and ds put small entries past the 2e-2
//     tolerance (up to 0.037 off on the card). dq sums ds k over the keys
//     of one q head only, and one rounding holds the tolerance;
//   - dq (the forward's twin: queries fixed, K and V tiles streaming past)
//     does 3 products a visited tile: s = Q K^T and dp = dO V^T, then
//     p = exp(s scale - lse) (ex2 of log2(e)-scaled arguments, masked
//     entries zeroed), ds = p (dp - delta) scale, dq += ds K with K as the
//     row-major B operand, as V is in the forward. At head dim 64 Q and dO
//     stay in registers as A fragments across the k loop; at 128 they are
//     read from shared memory each tile. lse and delta of the thread's two
//     rows stay in registers. Every q tile is one block: no partials, no
//     atomics, the same bits from the same inputs;
//   - tiles with no attending pair are skipped, decided before any load or
//     product of the tile: causal ones by the loop bounds; segment-masked
//     ones by an exact test on the ids. A candidate tile that overlaps the
//     fixed tile under the causal mask holds the pairs (p, p); any other
//     lies wholly on one side of it, so that it attends iff one of its ids
//     is among the fixed tile's ids (kept once per block as a list of runs;
//     no order of the ids is assumed, pad 0 is a segment). The block votes
//     on 32 candidate tiles at a time (warp OR, then 4 slots in shared
//     memory: two barriers);
//   - forward and dq grid (B*H, S/64), the longest causal rows first. dk/dv
//     grid (B*KVH*n_split, S/64), the first k tiles (the most q tiles)
//     first: the (q tile, q head) pairs of a kv head, q tiles ascending and
//     then its q heads ascending, are cut into n_split equal runs (the
//     caller's `n_split`: the q heads a kv head serves, at most 4; 512
//     blocks at the training shape, against 128 with one). Each block sums
//     its run in that order in f32 registers (the MMA adds each pair's 64
//     rows into them); with n_split 1 it rounds them to bf16 and stores dk,
//     dv; with n_split > 1 it writes f32 partials to the caller's workspace
//     [2, n_split, B, S, KVH, D] and `flash_dkv_sum_kernel` adds them in
//     split order 0, 1, .., n-1 and rounds once to bf16. Fixed order, no
//     atomics: the same inputs give the same bits.
// Registers a thread and spills (ptxas -v for sm_90a; phase 1 of
// chip_smoke.py prints them for every instance):
//   flash_fwd_kernel_tc<64>  162, none     flash_fwd_kernel_tc<128>  220, none
//   flash_dq_kernel_tc<64>   222, none     flash_dq_kernel_tc<128>   240, none
//   flash_dkv_kernel_tc<64>  240, none     flash_dkv_kernel_tc<128>  255,
//     292 bytes of spill stores, 368 of loads (112-byte stack frame)
//   flash_dkv_sum_kernel 32, none
//   f32: fwd 136 / 172, dq 184 / 188, dkv 180 / 254 (D 64 / 128), none.
//
// The f32 bodies: a block of 256 threads (16 x 16) owns a 64-query (or,
// for dk/dv, 64-key) tile; tiles are staged as f32 rows of stride D + 4;
// each thread computes a 4 x 4 block of the score tile from 16-byte shared
// reads, the products with V, K, Q or dO read the probability tile row by
// row; the TPU's sequential grid axis is a loop inside the block; masked
// tiles are visited; the dk/dv grid is S/64 x B x KVH blocks, each summing
// q heads ascending, then q tiles, each tile's rows summed first.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "smem_limit.cuh"

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

// ------------------------------------------------------------------------
// bf16 bodies on the tensor cores (see the note at the top)

using bf16 = __nv_bfloat16;
constexpr int kTcThreads = 128;                 // 4 warps, 16 rows each
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 (4) bytes global -> shared, asynchronously; unless `full`, zeros (and
// `src`, a valid address, is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool full) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// four 8 x 8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i (.trans: each transposed)
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
// c += a b: a 16 x 16 (row), b 16 x 8 (col), c 16 x 8 f32. Lane l holds
// c[l/4][2(l%4) + {0,1}] in c[0..1] and row l/4 + 8 in c[2..3]
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 x = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&x);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Rows r0 .. r0+R-1 of head `head` of a [B, S, heads, D] bf16 tensor into a
// [R, D + 8] tile, 16 bytes a copy; rows at or past S are zeros
template <int R, int D>
__device__ __forceinline__ void cp_tile(bf16* dst, const bf16* __restrict__ src,
                                        int b, int r0, int head, int heads,
                                        int S) {
  constexpr int kLD = D + 8, kChunks = D / 8;
#pragma unroll
  for (int i = threadIdx.x; i < R * kChunks; i += kTcThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    const bool in = r0 + r < S;
    cp_async16(dst + r * kLD + c,
               in ? src + (((size_t)b * S + r0 + r) * heads + head) * D + c
                  : src,
               in);
  }
}
// n 4-byte values src[p0 ..] into dst (zeros past S)
template <typename T>
__device__ __forceinline__ void cp_vals(T* dst, const T* __restrict__ src,
                                        int p0, int n, int S) {
  if (threadIdx.x < n) {
    const bool in = p0 + threadIdx.x < S;
    cp_async4(dst + threadIdx.x, in ? src + p0 + threadIdx.x : src, in);
  }
}

// The segment ids of the fixed tile (64 positions from fix0; queries in the
// forward, keys in dk/dv) as a list of runs: one entry for each run of equal
// neighbours below S, in `runs` (64 ints; `cnt` 2 ints of scratch). An id
// that comes back after another run is listed again, which is harmless.
// Returns the number of runs; every thread gets it.
__device__ int tile_runs(const int* ids, int fix0, int S, int* runs,
                         int* cnt) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const bool head = t < kTile && fix0 + t < S &&
                    (t == 0 || ids[t] != ids[t - 1]);
  const unsigned m = __ballot_sync(0xffffffffu, head);
  if (t < kTile && lane == 0) cnt[w] = __popc(m);
  __syncthreads();
  if (head) runs[(w ? cnt[0] : 0) + __popc(m & ((1u << lane) - 1))] = ids[t];
  const int n = cnt[0] + cnt[1];
  __syncthreads();
  return n;
}

// Bit i of the result is set if candidate tile t0 + i (i < n <= 32; tiles of
// CAND positions) holds a (query, key) pair that attends against the fixed
// tile. Exact: a candidate tile that overlaps the fixed tile's positions
// under the causal mask (bits `diag`) holds the pairs (p, p) and attends;
// every other candidate lies wholly on one side of the fixed tile, so that
// causality holds for all its pairs or for none (the caller's bounds), and
// it attends iff one of its ids below S is in the fixed tile's runs. The
// threads split the candidate positions (t % CAND) and the runs (t / CAND,
// strided), OR their bits over each warp and then over the block's 4 warps
// through `slots` (4 ints): two barriers for up to 32 tiles.
template <int CAND>
__device__ uint32_t vote_tiles(const int* runs, int n_runs,
                               const int* __restrict__ seg_row, int S, int t0,
                               int n, uint32_t diag, int* slots) {
  constexpr int kGroups = kTcThreads / CAND;
  const int cpos = threadIdx.x % CAND, r0 = threadIdx.x / CAND;
  uint32_t bits = 0;
  for (int i0 = 0; i0 < n; i0 += 8) {
    int id[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {   // the loads first, then the compares
      const int pos = (t0 + i0 + j) * CAND + cpos;
      id[j] = i0 + j < n && pos < S ? __ldg(seg_row + pos) : 0;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int pos = (t0 + i0 + j) * CAND + cpos;
      bool hit = false;
      if (i0 + j < n && pos < S)
        for (int r = r0; r < n_runs; r += kGroups) hit |= runs[r] == id[j];
      bits |= hit ? 1u << (i0 + j) : 0u;
    }
  }
  bits = __reduce_or_sync(0xffffffffu, bits);
  if ((threadIdx.x & 31) == 0) slots[threadIdx.x >> 5] = bits;
  __syncthreads();
  bits = slots[0] | slots[1] | slots[2] | slots[3];
  __syncthreads();                  // slots are free for the next vote
  return bits | diag;
}

// The tiles a block visits: candidates [t, hi) that hold an attending pair,
// in order; without segment ids every one (the caller's bounds take the
// causal cut). [dlo, dhi): the candidates that overlap the fixed tile
// under the causal mask (empty if not causal). (base, bits): the last 32
// candidates voted on.
template <int CAND>
struct TileScan {
  const int* runs;
  int n_runs;
  const int* seg_row;
  int S, hi, dlo, dhi;
  int* slots;
  int base = -64;
  uint32_t bits = 0;

  // the first visited tile >= t, or hi
  __device__ __forceinline__ int next(int t) {
    if (seg_row == nullptr) return min(t, hi);
    while (t < hi) {
      if (t >= base + 32) {
        base = t;
        const int n = min(32, hi - t);
        uint32_t diag = 0;
        for (int x = max(t, dlo); x < min(t + n, dhi); ++x)
          diag |= 1u << (x - t);
        bits = vote_tiles<CAND>(runs, n_runs, seg_row, S, t, n, diag, slots);
      }
      const uint32_t m = bits >> (t - base);
      if (m) return t + __ffs(m) - 1;
      t = base + 32;
    }
    return hi;
  }
};

// A = the warp's 16 rows (16 w + l % 16) of a [., D + 8] tile at column kc
template <int D>
__device__ __forceinline__ void ld_a(uint32_t (&a)[4], const bf16* tile,
                                     int kc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  ldsm4(a, tile + (warp * 16 + (lane & 15)) * (D + 8) + kc * 16 +
               (lane >> 4) * 8);
}
// B operands of two n tiles (rows j*16 .. j*16 + 15 of a [., D + 8] tile, as
// the columns of B) at depth kc: r[0..1] n tile 2j, r[2..3] n tile 2j + 1
template <int D>
__device__ __forceinline__ void ld_b(uint32_t (&r)[4], const bf16* tile, int j,
                                     int kc) {
  const int lane = threadIdx.x & 31;
  ldsm4(r, tile + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * (D + 8) +
               kc * 16 + ((lane >> 3) & 1) * 8);
}
// B operands read across rows (rows kc*16 .. kc*16 + 15 are the depth,
// columns dp*16 .. dp*16 + 15 two n tiles): r[0..1] n tile 2dp, r[2..3] 2dp+1
template <int D>
__device__ __forceinline__ void ld_bt(uint32_t (&r)[4], const bf16* tile,
                                      int kc, int dp) {
  const int lane = threadIdx.x & 31;
  ldsm4_t(r, tile + (kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                        (D + 8) +
                 dp * 16 + (lane >> 4) * 8);
}
// s[N tiles] = A(rows of `a_tile`) . B(rows of `b_tile`)^T over depth D
template <int D, int NT>
__device__ __forceinline__ void gemm_nt(float (&s)[NT][4], const bf16* a_tile,
                                        const bf16* b_tile) {
#pragma unroll
  for (int j = 0; j < NT; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    uint32_t a[4];
    ld_a<D>(a, a_tile, kc);
#pragma unroll
    for (int j = 0; j < NT / 2; ++j) {
      uint32_t b[4];
      ld_b<D>(b, b_tile, j, kc);
      mma16816(s[2 * j], a, b[0], b[1]);
      mma16816(s[2 * j + 1], a, b[2], b[3]);
    }
  }
}
// (x0, x1) - their bf16 rounding, rounded to bf16: the low half of a
// hi + lo pair that carries ~16 bits of x's mantissa
__device__ __forceinline__ uint32_t pack_bf16_lo(float x0, float x1) {
  const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(x0, x1));
  return pack_bf16(x0 - hi.x, x1 - hi.y);
}

// acc[D/8 tiles] += P . rows of `b_tile`, P the bf16 rounding of p (the
// warp's 16 rows x NT*8 columns, in accumulator layout). kHiLo: P as a
// bf16 hi + lo pair, two products into the same sums, hi first (p to ~2^-17
// instead of 2^-9: dk and dv sum many such terms over the q heads)
template <int D, int NT, bool kHiLo>
__device__ __forceinline__ void gemm_pv(float (&acc)[D / 8][4],
                                        const float (&p)[NT][4],
                                        const bf16* b_tile) {
#pragma unroll
  for (int kc = 0; kc < NT / 2; ++kc) {
    const uint32_t a[4] = {pack_bf16(p[2 * kc][0], p[2 * kc][1]),
                           pack_bf16(p[2 * kc][2], p[2 * kc][3]),
                           pack_bf16(p[2 * kc + 1][0], p[2 * kc + 1][1]),
                           pack_bf16(p[2 * kc + 1][2], p[2 * kc + 1][3])};
    uint32_t lo[4] = {};
    if (kHiLo) {
      lo[0] = pack_bf16_lo(p[2 * kc][0], p[2 * kc][1]);
      lo[1] = pack_bf16_lo(p[2 * kc][2], p[2 * kc][3]);
      lo[2] = pack_bf16_lo(p[2 * kc + 1][0], p[2 * kc + 1][1]);
      lo[3] = pack_bf16_lo(p[2 * kc + 1][2], p[2 * kc + 1][3]);
    }
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ld_bt<D>(b, b_tile, kc, dp);
      mma16816(acc[2 * dp], a, b[0], b[1]);
      mma16816(acc[2 * dp + 1], a, b[2], b[3]);
      if (kHiLo) {
        mma16816(acc[2 * dp], lo, b[0], b[1]);
        mma16816(acc[2 * dp + 1], lo, b[2], b[3]);
      }
    }
  }
}

// The block's [64, D] accumulator (rows 16 w + l/4 and + 8, times mul_lo and
// mul_hi) through the [64, D + 8] shared tile to rows r0.. of head `head` of
// a [B, S, heads, D] bf16 tensor (rows below S), 16 bytes a store. The
// tile must be free: no thread reads it any more.
template <int D>
__device__ __forceinline__ void store_acc(const float (&acc)[D / 8][4],
                                          float mul_lo, float mul_hi,
                                          bf16* tile, bf16* __restrict__ dst,
                                          int b, int r0, int head, int heads,
                                          int S) {
  constexpr int kLD = D + 8, kChunks = D / 8;
  const int lane = threadIdx.x & 31, r = (threadIdx.x >> 5) * 16 + (lane >> 2);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + ((lane & 3) << 1);
    *reinterpret_cast<uint32_t*>(tile + r * kLD + c) =
        pack_bf16(acc[n][0] * mul_lo, acc[n][1] * mul_lo);
    *reinterpret_cast<uint32_t*>(tile + (r + 8) * kLD + c) =
        pack_bf16(acc[n][2] * mul_hi, acc[n][3] * mul_hi);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kChunks; i += kTcThreads) {
    const int rr = i / kChunks, c = (i % kChunks) * 8;
    if (r0 + rr < S)
      *reinterpret_cast<uint4*>(
          dst + (((size_t)b * S + r0 + rr) * heads + head) * D + c) =
          *reinterpret_cast<const uint4*>(tile + rr * kLD + c);
  }
}

// 2^x on the special function unit (relative error ~2^-22; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// cp.async stages of the moving side's tiles (the K/V ring of the forward,
// the Q/dO ring of dk/dv): 3 where the shared memory leaves room for the
// blocks that the registers allow on an SM, else 2
template <int D>
__host__ __device__ constexpr int fwd_stages() { return D == 64 ? 3 : 2; }
constexpr int kDkvStages = 3;
constexpr int kScanInts = kTile + 8;   // runs, 2 counts, 4 vote slots

template <int D>
constexpr int fwd_tc_smem() {
  return (1 + 2 * fwd_stages<D>()) * kTile * (D + 8) * 2 +
         ((1 + fwd_stages<D>()) * kTile + kScanInts) * 4;
}

// grid (B*H, S/64): one 64-query tile of one q head; the k tiles that hold
// an attending pair, in order, through a ring of cp.async stages
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_fwd_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const int* __restrict__ seg,
                    const int* __restrict__ hmap, bf16* __restrict__ o,
                    float* __restrict__ lse, int S, int H, int KVH,
                    float scale, int causal) {
  constexpr int kLD = D + 8, kSt = fwd_stages<D>();
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);       // [64, kLD]
  bf16* Ks = Qs + kTile * kLD;                     // [kSt][64, kLD]
  bf16* Vs = Ks + kSt * kTile * kLD;               // [kSt][64, kLD]
  int* qseg = reinterpret_cast<int*>(Vs + kSt * kTile * kLD);   // [64]
  int* kseg = qseg + kTile;                        // [kSt][64]
  int* scan = kseg + kSt * kTile;                  // kScanInts

  const int lane = threadIdx.x & 31;
  const int qt = gridDim.y - 1 - blockIdx.y;       // the longest rows first
  const int q0 = qt * kTile;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = hmap[h];
  const int* seg_row = seg ? seg + (size_t)b * S : nullptr;

  cp_tile<kTile, D>(Qs, q, b, q0, h, H, S);
  cp_async_commit();
  if (threadIdx.x < kTile)
    qseg[threadIdx.x] = seg_row && q0 + (int)threadIdx.x < S
                            ? seg_row[q0 + threadIdx.x] : 0;
  __syncthreads();                                 // qseg, for the runs
  const int hi = causal ? qt + 1 : (S + kTile - 1) / kTile;
  TileScan<kTile> scan_k{scan, seg_row ? tile_runs(qseg, q0, S, scan,
                                                   scan + kTile) : 0,
                         seg_row, S, hi, causal ? qt : 0, causal ? qt + 1 : 0,
                         scan + kTile + 4};
  auto load_kv = [&](int kt, int buf) {
    cp_tile<kTile, D>(Ks + buf * kTile * kLD, k, b, kt * kTile, g, KVH, S);
    cp_tile<kTile, D>(Vs + buf * kTile * kLD, v, b, kt * kTile, g, KVH, S);
    if (seg_row) cp_vals(kseg + buf * kTile, seg_row, kt * kTile, kTile, S);
  };
  // the thread's rows: r_lo = 16 w + l/4 and r_lo + 8 of the tile
  const int r_lo = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int qr[2] = {q0 + r_lo, q0 + r_lo + 8};
  const int qs[2] = {qseg[r_lo], qseg[r_lo + 8]};
  const float sl2 = scale * kLog2e;
  // m: the row max of the raw scores q.k seen so far (-inf: none attended)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[D / 16][4];

  // cur: this iteration's tile; n1: the next (3 stages); each iteration
  // issues the tile kSt - 1 ahead
  int cur = scan_k.next(0), n1 = hi;
  if (cur < hi) load_kv(cur, 0);
  cp_async_commit();
  if (kSt == 3) {
    n1 = cur < hi ? scan_k.next(cur + 1) : hi;
    if (n1 < hi) load_kv(n1, 1);
    cp_async_commit();
  }
  for (int it = 0; cur < hi; ++it) {
    const int buf = it % kSt;
    cp_async_wait<kSt - 2>();
    // tile cur (and Q) have landed, and every warp is done with iteration
    // it - 1, whose buffer the next load overwrites
    __syncthreads();
    const int last = kSt == 3 ? n1 : cur;
    const int nn = last < hi ? scan_k.next(last + 1) : hi;
    if (nn < hi) load_kv(nn, (it + kSt - 1) % kSt);
    cp_async_commit();
    if (it == 0) {
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc) ld_a<D>(qf[kc], Qs, kc);
    }
    const bf16* Kb = Ks + buf * kTile * kLD;
    const int* ks = kseg + buf * kTile;
    const int k0 = cur * kTile;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t kb[4];
        ld_b<D>(kb, Kb, j, kc);
        mma16816(s[2 * j], qf[kc], kb[0], kb[1]);
        mma16816(s[2 * j + 1], qf[kc], kb[2], kb[3]);
      }
    if (seg_row != nullptr || (causal && cur == qt) || k0 + kTile > S) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = j * 8 + ((lane & 3) << 1);
        const int2 kid = seg_row ? *reinterpret_cast<const int2*>(ks + c)
                                 : make_int2(0, 0);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int key = k0 + c + (e & 1), r = e >> 1;
          if (!(key < S && (!causal || key <= qr[r]) &&
                (!seg_row || (e & 1 ? kid.y : kid.x) == qs[r])))
            s[j][e] = -INFINITY;
        }
      }
    }
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = quad_max(mx);
      // a row with no attending key so far keeps p = 0 and its sums
      alpha[r] = mx == -INFINITY ? 1.f : ex2((m[r] - mx) * sl2);
      ms[r] = mx == -INFINITY ? 0.f : mx * sl2;
      m[r] = mx;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = ex2(fmaf(s[j][e], sl2, -ms[e >> 1]));
        s[j][e] = p;
        l[e >> 1] += p;
      }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      acc[n][0] *= alpha[0]; acc[n][1] *= alpha[0];
      acc[n][2] *= alpha[1]; acc[n][3] *= alpha[1];
    }
    gemm_pv<D, 8, false>(acc, s, Vs + buf * kTile * kLD);
    if (kSt == 3) {
      cur = n1;
      n1 = nn;
    } else {
      cur = nn;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float lsum = fmaxf(quad_sum(l[r]), 1e-30f);
    inv[r] = 1.f / lsum;
    if ((lane & 3) == 0 && qr[r] < S)
      lse[((size_t)b * H + h) * S + qr[r]] =
          (m[r] == -INFINITY ? kNegInf : m[r] * scale) + logf(lsum);
  }
  store_acc<D>(acc, inv[0], inv[1], Qs, o, b, q0, h, H, S);
}

template <int D>
constexpr int dq_tc_smem() {
  return (2 + 2 * fwd_stages<D>()) * kTile * (D + 8) * 2 +
         ((1 + fwd_stages<D>()) * kTile + kScanInts) * 4;
}

// grid (B*H, S/64): dq of one 64-query tile of one q head over the k tiles
// that hold an attending pair, in order, through the forward's ring of
// cp.async stages. At head dim 64 Q and dO stay in registers as A
// fragments across the k loop; at 128 they are read from shared memory each
// tile (their 64 registers would crowd out the dq accumulator)
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_dq_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   const int* __restrict__ seg, const int* __restrict__ hmap,
                   bf16* __restrict__ dq, int S, int H, int KVH, float scale,
                   int causal) {
  constexpr int kLD = D + 8, kSt = fwd_stages<D>();
  constexpr bool kRegA = D == 64;
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);       // [64, kLD]
  bf16* dOs = Qs + kTile * kLD;                    // [64, kLD]
  bf16* Ks = dOs + kTile * kLD;                    // [kSt][64, kLD]
  bf16* Vs = Ks + kSt * kTile * kLD;               // [kSt][64, kLD]
  int* qseg = reinterpret_cast<int*>(Vs + kSt * kTile * kLD);   // [64]
  int* kseg = qseg + kTile;                        // [kSt][64]
  int* scan = kseg + kSt * kTile;                  // kScanInts

  const int lane = threadIdx.x & 31;
  const int qt = gridDim.y - 1 - blockIdx.y;       // the longest rows first
  const int q0 = qt * kTile;
  const int b = blockIdx.x / H, h = blockIdx.x % H;
  const int g = hmap[h];
  const int* seg_row = seg ? seg + (size_t)b * S : nullptr;

  cp_tile<kTile, D>(Qs, q, b, q0, h, H, S);
  cp_tile<kTile, D>(dOs, dout, b, q0, h, H, S);
  cp_async_commit();
  if (threadIdx.x < kTile)
    qseg[threadIdx.x] = seg_row && q0 + (int)threadIdx.x < S
                            ? seg_row[q0 + threadIdx.x] : 0;
  __syncthreads();                                 // qseg, for the runs
  const int hi = causal ? qt + 1 : (S + kTile - 1) / kTile;
  TileScan<kTile> scan_k{scan, seg_row ? tile_runs(qseg, q0, S, scan,
                                                   scan + kTile) : 0,
                         seg_row, S, hi, causal ? qt : 0, causal ? qt + 1 : 0,
                         scan + kTile + 4};
  auto load_kv = [&](int kt, int buf) {
    cp_tile<kTile, D>(Ks + buf * kTile * kLD, k, b, kt * kTile, g, KVH, S);
    cp_tile<kTile, D>(Vs + buf * kTile * kLD, v, b, kt * kTile, g, KVH, S);
    if (seg_row) cp_vals(kseg + buf * kTile, seg_row, kt * kTile, kTile, S);
  };
  // the thread's rows r_lo = 16 w + l/4 and r_lo + 8, their -lse log2(e)
  // and delta (0 past S: those rows are not stored)
  const int r_lo = (threadIdx.x >> 5) * 16 + (lane >> 2);
  const int qr[2] = {q0 + r_lo, q0 + r_lo + 8};
  const int qs[2] = {qseg[r_lo], qseg[r_lo + 8]};
  float nl[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t at = ((size_t)b * H + h) * S + qr[r];
    nl[r] = qr[r] < S ? -__ldg(lse + at) * kLog2e : 0.f;
    dl[r] = qr[r] < S ? __ldg(delta + at) : 0.f;
  }
  const float sl2 = scale * kLog2e;
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  uint32_t qf[kRegA ? D / 16 : 1][4], df[kRegA ? D / 16 : 1][4];

  // cur: this iteration's tile; n1: the next (3 stages); each iteration
  // issues the tile kSt - 1 ahead
  int cur = scan_k.next(0), n1 = hi;
  if (cur < hi) load_kv(cur, 0);
  cp_async_commit();
  if (kSt == 3) {
    n1 = cur < hi ? scan_k.next(cur + 1) : hi;
    if (n1 < hi) load_kv(n1, 1);
    cp_async_commit();
  }
  for (int it = 0; cur < hi; ++it) {
    const int buf = it % kSt;
    cp_async_wait<kSt - 2>();
    // tile cur (and Q, dO) have landed, and every warp is done with
    // iteration it - 1, whose buffer the next load overwrites
    __syncthreads();
    const int last = kSt == 3 ? n1 : cur;
    const int nn = last < hi ? scan_k.next(last + 1) : hi;
    if (nn < hi) load_kv(nn, (it + kSt - 1) % kSt);
    cp_async_commit();
    const bf16* Kb = Ks + buf * kTile * kLD;
    const bf16* Vb = Vs + buf * kTile * kLD;
    const int* ks = kseg + buf * kTile;
    const int k0 = cur * kTile;
    // s = Q K^T, dp = dO V^T: the warp's 16 queries x 64 keys
    float s[8][4], dp[8][4];
    if constexpr (kRegA) {
      if (it == 0) {
#pragma unroll
        for (int kc = 0; kc < D / 16; ++kc) {
          ld_a<D>(qf[kc], Qs, kc);
          ld_a<D>(df[kc], dOs, kc);
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[j][0] = s[j][1] = s[j][2] = s[j][3] =
            dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
#pragma unroll
      for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          uint32_t kb[4], vb[4];
          ld_b<D>(kb, Kb, j, kc);
          ld_b<D>(vb, Vb, j, kc);
          mma16816(s[2 * j], qf[kc], kb[0], kb[1]);
          mma16816(s[2 * j + 1], qf[kc], kb[2], kb[3]);
          mma16816(dp[2 * j], df[kc], vb[0], vb[1]);
          mma16816(dp[2 * j + 1], df[kc], vb[2], vb[3]);
        }
    } else {
      gemm_nt<D, 8>(s, Qs, Kb);
      gemm_nt<D, 8>(dp, dOs, Vb);
    }
    // p = exp(s scale - lse), zeroed where masked; ds = p (dp - delta) scale
    // into s, the A operand of dq += ds K
    const bool need_mask =
        seg_row != nullptr || (causal && cur == qt) || k0 + kTile > S;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = j * 8 + ((lane & 3) << 1);
      const int2 kid = seg_row ? *reinterpret_cast<const int2*>(ks + c)
                               : make_int2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + c + (e & 1), r = e >> 1;
        float p = ex2(fmaf(s[j][e], sl2, nl[r]));
        if (need_mask && !(key < S && (!causal || key <= qr[r]) &&
                           (!seg_row || (e & 1 ? kid.y : kid.x) == qs[r])))
          p = 0.f;
        s[j][e] = p * (dp[j][e] - dl[r]) * scale;
      }
    }
    gemm_pv<D, 8, false>(acc, s, Kb);
    if (kSt == 3) {
      cur = n1;
      n1 = nn;
    } else {
      cur = nn;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  store_acc<D>(acc, 1.f, 1.f, Qs, dq, b, q0, h, H, S);
}

// dk/dv q tile: 64 queries at head dim 64; 32 at 128, which keeps the score
// and dp tiles (2 x kBQ/2 registers) beside the two [16, D] accumulators
template <int D>
__host__ __device__ constexpr int dkv_bq() { return D == 64 ? 64 : 32; }
template <int D>
constexpr int dkv_tc_smem() {
  return (2 * kTile + 2 * kDkvStages * dkv_bq<D>()) * (D + 8) * 2 +
         (kTile + 3 * kDkvStages * dkv_bq<D>() + kScanInts) * 4;
}

// A (q tile, q head) pair of dk/dv's run: p = (qt - qt_lo) * nh + the head's
// index among kv head g's q heads; valid while p < the run's end
struct DkvPair {
  int qt, h;
  long long p;
};

// grid (B*KVH*n_split, S/64): dk, dv of one 64-key tile of one kv head over
// the split's run of (q tile, q head) pairs; see the note at the top
template <int D>
__global__ void __launch_bounds__(kTcThreads)
flash_dkv_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const int* __restrict__ seg, const int* __restrict__ hmap,
                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                    float* __restrict__ part, int n_split, int S, int H,
                    int KVH, float scale, int causal) {
  constexpr int kBQ = dkv_bq<D>(), kLD = D + 8, kQN = kBQ / 8;
  constexpr int kSt = kDkvStages;
  extern __shared__ float4 smem4[];
  bf16* Ks = reinterpret_cast<bf16*>(smem4);       // [64, kLD]
  bf16* Vs = Ks + kTile * kLD;                     // [64, kLD]
  bf16* Qs = Vs + kTile * kLD;                     // [kSt][kBQ, kLD]
  bf16* dOs = Qs + kSt * kBQ * kLD;                // [kSt][kBQ, kLD]
  int* kseg = reinterpret_cast<int*>(dOs + kSt * kBQ * kLD);   // [64]
  int* qseg = kseg + kTile;                        // [kSt][kBQ]
  float* lse_s = reinterpret_cast<float*>(qseg + kSt * kBQ);   // [kSt][kBQ]
  float* delta_s = lse_s + kSt * kBQ;              // [kSt][kBQ]
  int* scan = reinterpret_cast<int*>(delta_s + kSt * kBQ);     // kScanInts

  const int lane = threadIdx.x & 31;
  const int kt = blockIdx.y, k0 = kt * kTile;      // the first k tiles first
  const int sp = blockIdx.x % n_split, bg = blockIdx.x / n_split;
  const int b = bg / KVH, g = bg % KVH;
  const int* seg_row = seg ? seg + (size_t)b * S : nullptr;

  cp_tile<kTile, D>(Ks, k, b, k0, g, KVH, S);
  cp_tile<kTile, D>(Vs, v, b, k0, g, KVH, S);
  cp_async_commit();
  if (threadIdx.x < kTile)
    kseg[threadIdx.x] = seg_row && k0 + (int)threadIdx.x < S
                            ? seg_row[k0 + threadIdx.x] : 0;
  __syncthreads();                                 // kseg, for the runs

  // this block's run of the pairs (q tile, q head of g): q tiles ascending,
  // then heads ascending
  int nh = 0;
  for (int i = 0; i < H; ++i) nh += __ldg(hmap + i) == g;
  auto head_from = [&](int i) {        // the first head >= i on kv head g
    while (i < H && __ldg(hmap + i) != g) ++i;
    return i;
  };
  const int qt_lo = causal ? k0 / kBQ : 0, n_qt = (S + kBQ - 1) / kBQ;
  const long long n_pairs = (long long)(n_qt - qt_lo) * nh;
  const long long p_end = n_pairs * (sp + 1) / n_split;
  TileScan<kBQ> scan_q{scan, seg_row ? tile_runs(kseg, k0, S, scan,
                                                 scan + kTile) : 0,
                       seg_row, S, n_qt, causal ? qt_lo : 0,
                       causal ? (k0 + kTile) / kBQ : 0, scan + kTile + 4};
  auto next_pair = [&](DkvPair c) {    // the pair after c (c valid)
    c.h = head_from(c.h + 1);
    ++c.p;
    if (c.h >= H) {
      c.qt = scan_q.next(c.qt + 1);
      c.h = head_from(0);
      c.p = (long long)(c.qt - qt_lo) * nh;
    }
    return c;
  };
  DkvPair cur{n_qt, H, p_end};
  {
    const long long p = n_pairs * sp / n_split;
    if (p < p_end) {
      cur.qt = qt_lo + (int)(p / nh);
      int idx = (int)(p % nh);
      cur.p = p;
      const int a = scan_q.next(cur.qt);
      if (a != cur.qt) {
        cur.qt = a;
        idx = 0;
        cur.p = (long long)(a - qt_lo) * nh;
      }
      cur.h = head_from(0);
      for (int i = 0; i < idx; ++i) cur.h = head_from(cur.h + 1);
    }
  }
  auto load_pair = [&](DkvPair c, int buf) {
    const int q0 = c.qt * kBQ;
    cp_tile<kBQ, D>(Qs + buf * kBQ * kLD, q, b, q0, c.h, H, S);
    cp_tile<kBQ, D>(dOs + buf * kBQ * kLD, dout, b, q0, c.h, H, S);
    const size_t row = ((size_t)b * H + c.h) * S;
    cp_vals(lse_s + buf * kBQ, lse + row, q0, kBQ, S);
    cp_vals(delta_s + buf * kBQ, delta + row, q0, kBQ, S);
    if (seg_row) cp_vals(qseg + buf * kBQ, seg_row, q0, kBQ, S);
  };

  const int kr = (threadIdx.x >> 5) * 16 + (lane >> 2);   // rows kr, kr + 8
  const int kpos[2] = {k0 + kr, k0 + kr + 8};
  const int ksg[2] = {kseg[kr], kseg[kr + 8]};
  const float sl2 = scale * kLog2e;
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[n][e] = dv_acc[n][e] = 0.f;

  // cur: this iteration's pair, n1 the next; each iteration issues the
  // pair kSt - 1 = 2 ahead
  if (cur.p < p_end) load_pair(cur, 0);
  cp_async_commit();
  DkvPair n1 = cur.p < p_end ? next_pair(cur) : cur;
  if (n1.p < p_end) load_pair(n1, 1);
  cp_async_commit();
  for (int it = 0; cur.p < p_end; ++it) {
    const int buf = it % kSt;
    cp_async_wait<kSt - 2>();
    // the pair's tiles have landed, and every warp is done with iteration
    // it - 1, whose buffer the next load overwrites
    __syncthreads();
    const DkvPair nn = n1.p < p_end ? next_pair(n1) : n1;
    if (nn.p < p_end) load_pair(nn, (it + 2) % kSt);
    cp_async_commit();
    const bf16* Qb = Qs + buf * kBQ * kLD;
    const bf16* dOb = dOs + buf * kBQ * kLD;
    const float* ls = lse_s + buf * kBQ;
    const float* dl = delta_s + buf * kBQ;
    const int* qsg = qseg + buf * kBQ;
    const int q0 = cur.qt * kBQ;
    // p^T = exp(K Q^T scale - lse): the warp's 16 keys x kBQ queries
    float st[kQN][4];
    gemm_nt<D, kQN>(st, Ks, Qb);
    const bool need_mask = seg_row != nullptr ||
                           (causal && q0 < k0 + kTile - 1) ||
                           q0 + kBQ > S || k0 + kTile > S;
#pragma unroll
    for (int j = 0; j < kQN; ++j) {
      const int c = j * 8 + ((lane & 3) << 1);
      const float2 lv = *reinterpret_cast<const float2*>(ls + c);
      const int2 qid = seg_row ? *reinterpret_cast<const int2*>(qsg + c)
                               : make_int2(0, 0);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1;
        float pv = ex2(fmaf(st[j][e], sl2, -(e & 1 ? lv.y : lv.x) * kLog2e));
        if (need_mask) {
          const int qp = q0 + c + (e & 1);
          if (!(qp < S && kpos[r] < S && (!causal || kpos[r] <= qp) &&
                (!seg_row || (e & 1 ? qid.y : qid.x) == ksg[r])))
            pv = 0.f;
        }
        st[j][e] = pv;
      }
    }
    gemm_pv<D, kQN, true>(dv_acc, st, dOb);   // dv += p^T dO
    float dpt[kQN][4];
    gemm_nt<D, kQN>(dpt, Vs, dOb);            // dp^T = V dO^T
#pragma unroll
    for (int j = 0; j < kQN; ++j) {
      const int c = j * 8 + ((lane & 3) << 1);
      const float2 dv2 = *reinterpret_cast<const float2*>(dl + c);
#pragma unroll
      for (int e = 0; e < 4; ++e)             // ds^T
        st[j][e] = st[j][e] * (dpt[j][e] - (e & 1 ? dv2.y : dv2.x)) * scale;
    }
    gemm_pv<D, kQN, true>(dk_acc, st, Qb);    // dk += ds^T Q
    cur = n1;
    n1 = nn;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (n_split == 1) {
    store_acc<D>(dk_acc, 1.f, 1.f, Ks, dk, b, k0, g, KVH, S);
    store_acc<D>(dv_acc, 1.f, 1.f, Vs, dv, b, k0, g, KVH, S);
    return;
  }
  // f32 partials: part[0 (dk) / 1 (dv)][sp][b][s][g][:]
  const int B = gridDim.x / (n_split * KVH);
  const size_t n = (size_t)B * S * KVH * D;
  float* pk = part + (size_t)sp * n;
  float* pv = part + (size_t)(n_split + sp) * n;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (kpos[r] >= S) continue;
    const size_t at = (((size_t)b * S + kpos[r]) * KVH + g) * D +
                      ((lane & 3) << 1);
#pragma unroll
    for (int nn = 0; nn < D / 8; ++nn) {
      *reinterpret_cast<float2*>(pk + at + nn * 8) =
          make_float2(dk_acc[nn][2 * r], dk_acc[nn][2 * r + 1]);
      *reinterpret_cast<float2*>(pv + at + nn * 8) =
          make_float2(dv_acc[nn][2 * r], dv_acc[nn][2 * r + 1]);
    }
  }
}

// dk, dv = the n_split f32 partials summed in split order, rounded once
__global__ void __launch_bounds__(256)
flash_dkv_sum_kernel(const float* __restrict__ part, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int n_split, long long n) {
  const long long i = (blockIdx.x * (long long)blockDim.x + threadIdx.x) * 4;
  if (i >= 2 * n) return;
  const int which = i >= n;
  const long long j = i - which * n;
  const float* src = part + which * n_split * n + j;
  float4 s = load4(src);
  for (int sp = 1; sp < n_split; ++sp) {
    const float4 x = load4(src + sp * n);
    s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
  }
  store4((which ? dv : dk) + j, s);
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

// the f32 bodies' dispatch (the bf16 ones are launched before it)
#define FLASH_DISPATCH_F32(CALL)                                           \
  if (dtype == 0 && head_dim == 64) { CALL(float, 64); }                   \
  else if (dtype == 0 && head_dim == 128) { CALL(float, 128); }            \
  else { return static_cast<int>(cudaErrorInvalidValue); }                 \
  return static_cast<int>(cudaGetLastError());

// KERN in parentheses (a template-id's comma); a kernel that takes more
// than 48 KB of dynamic shared memory must be told, once a device: each
// expansion names one kernel instance and keeps its own `set`
#define FLASH_LAUNCH(KERN, GRID, THREADS, SMEM, ST, ...)                   \
  {                                                                        \
    auto kern = KERN;                                                      \
    static std::atomic<int> set[kMaxDevices];                              \
    cudaError_t e = allow_smem(kern, SMEM, set);                           \
    if (e != cudaSuccess) return static_cast<int>(e);                      \
    kern<<<GRID, THREADS, SMEM, ST>>>(__VA_ARGS__);                        \
  }

int flash_attention_fwd(const void* q, const void* k, const void* v,
                        const void* seg, const void* hmap, void* o, void* lse,
                        int B, int S, int H, int KVH, int head_dim,
                        float scale, int causal, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (head_dim == 64 || head_dim == 128)) {
    const dim3 grid(B * H, (S + kTile - 1) / kTile);
#define FWD_TC(D)                                                          \
  FLASH_LAUNCH((flash_fwd_kernel_tc<D>), grid, kTcThreads, fwd_tc_smem<D>(), \
               st, static_cast<const bf16*>(q), static_cast<const bf16*>(k), \
               static_cast<const bf16*>(v), static_cast<const int*>(seg),  \
               static_cast<const int*>(hmap), static_cast<bf16*>(o),       \
               static_cast<float*>(lse), S, H, KVH, scale, causal)
    if (head_dim == 64) FWD_TC(64) else FWD_TC(128)
#undef FWD_TC
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((S + kTile - 1) / kTile, B * H);
#define FWD(T, D)                                                          \
  FLASH_LAUNCH((flash_fwd_kernel<T, D>), grid, kThreads, fwd_smem<D>(), st,  \
               static_cast<const T*>(q), static_cast<const T*>(k),         \
               static_cast<const T*>(v), static_cast<const int*>(seg),     \
               static_cast<const int*>(hmap), static_cast<T*>(o),          \
               static_cast<float*>(lse), S, H, KVH, scale, causal)
  FLASH_DISPATCH_F32(FWD)
#undef FWD
}

int flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                           const void* dout, const void* lse,
                           const void* delta, const void* seg,
                           const void* hmap, void* dq, int B, int S, int H,
                           int KVH, int head_dim, float scale, int causal,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (head_dim == 64 || head_dim == 128)) {
    const dim3 grid(B * H, (S + kTile - 1) / kTile);
#define DQ_TC(D)                                                           \
  FLASH_LAUNCH((flash_dq_kernel_tc<D>), grid, kTcThreads, dq_tc_smem<D>(),  \
               st, static_cast<const bf16*>(q), static_cast<const bf16*>(k), \
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout), \
               static_cast<const float*>(lse),                             \
               static_cast<const float*>(delta),                           \
               static_cast<const int*>(seg), static_cast<const int*>(hmap), \
               static_cast<bf16*>(dq), S, H, KVH, scale, causal)
    if (head_dim == 64) DQ_TC(64) else DQ_TC(128)
#undef DQ_TC
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((S + kTile - 1) / kTile, B * H);
#define DQ(T, D)                                                           \
  FLASH_LAUNCH((flash_dq_kernel<T, D>), grid, kThreads, dq_smem<D>(), st,    \
               static_cast<const T*>(q), static_cast<const T*>(k),         \
               static_cast<const T*>(v), static_cast<const T*>(dout),      \
               static_cast<const float*>(lse),                             \
               static_cast<const float*>(delta),                           \
               static_cast<const int*>(seg), static_cast<const int*>(hmap), \
               static_cast<T*>(dq), S, H, KVH, scale, causal)
  FLASH_DISPATCH_F32(DQ)
#undef DQ
}

// bf16: `n_split` blocks share each (k tile, kv head); with n_split > 1,
// `part` is an f32 workspace of 2 * n_split * B * S * KVH * head_dim values
// that the kernel fills and a second kernel sums into dk and dv. f32:
// n_split and part are not read.
int flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                            const void* dout, const void* lse,
                            const void* delta, const void* seg,
                            const void* hmap, void* dk, void* dv, void* part,
                            int B, int S, int H, int KVH, int head_dim,
                            float scale, int causal, int dtype, int n_split,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && (head_dim == 64 || head_dim == 128)) {
    if (n_split < 1 || (n_split > 1 && part == nullptr))
      return static_cast<int>(cudaErrorInvalidValue);
    const dim3 grid(B * KVH * n_split, (S + kTile - 1) / kTile);
#define DKV_TC(D)                                                          \
  FLASH_LAUNCH((flash_dkv_kernel_tc<D>), grid, kTcThreads, dkv_tc_smem<D>(), \
               st, static_cast<const bf16*>(q), static_cast<const bf16*>(k), \
               static_cast<const bf16*>(v), static_cast<const bf16*>(dout), \
               static_cast<const float*>(lse),                             \
               static_cast<const float*>(delta),                           \
               static_cast<const int*>(seg), static_cast<const int*>(hmap), \
               static_cast<bf16*>(dk), static_cast<bf16*>(dv),             \
               static_cast<float*>(part), n_split, S, H, KVH, scale, causal)
    if (head_dim == 64) DKV_TC(64) else DKV_TC(128)
#undef DKV_TC
    if (n_split > 1) {
      cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return static_cast<int>(e);
      const long long n = (long long)B * S * KVH * head_dim;
      const long long blocks = (2 * n / 4 + 255) / 256;
      flash_dkv_sum_kernel<<<static_cast<unsigned>(blocks), 256, 0, st>>>(
          static_cast<const float*>(part), static_cast<bf16*>(dk),
          static_cast<bf16*>(dv), n_split, n);
    }
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid((S + kTile - 1) / kTile, B * KVH);
#define DKV(T, D)                                                          \
  FLASH_LAUNCH((flash_dkv_kernel<T, D>), grid, kThreads, dkv_smem<D>(), st,  \
               static_cast<const T*>(q), static_cast<const T*>(k),         \
               static_cast<const T*>(v), static_cast<const T*>(dout),      \
               static_cast<const float*>(lse),                             \
               static_cast<const float*>(delta),                           \
               static_cast<const int*>(seg), static_cast<const int*>(hmap), \
               static_cast<T*>(dk), static_cast<T*>(dv), S, H, KVH, scale, \
               causal)
  FLASH_DISPATCH_F32(DKV)
#undef DKV
}

#undef FLASH_LAUNCH
#undef FLASH_DISPATCH_F32

}  // extern "C"
