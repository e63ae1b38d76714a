// Decode attention for Hopper (sm_90a): one query token per batch row
// against that row's KV cache, dense (row 3) or paged (row 1), in one body.
//
// Replaces the two TPU kernels of src/repro/kernels/decode_attention.py,
// which keeps them in one file as this source does: `_kernel` (reached
// through `decode_attention`, the dense cache) and `_paged_kernel` (through
// `paged_decode_attention`, a cache in a shared page pool). Same function:
// for row b and q head h,
//   o[b, h] = softmax_t(q[b, h] . K[b, t, hmap[h]] * D^-0.5) V[b, t, hmap[h]]
// over t < valid_len[b]. Online softmax with m, l and the accumulator in
// f32; the output is written in the dtype of q. The two layouts differ only
// in where position t's K/V row lives (`DenseRows`, `PagedRows`):
//   - dense: k[b, t] of one layer's unexpanded cache [B, S, KVH, D];
//   - paged: k_pool[page, t % ps] of a pool [num_pages, ps, KVH, D], page =
//     page_tables[b, t / ps] clamped to [0, num_pages) (sentinel entries >=
//     num_pages only ever sit past valid_len), S = max_pages * ps.
// Every other instruction is shared, so row 1 on a pool gives the bits of
// row 3 on the dense view gathered through the same tables.
// Differences from the TPU kernels: they read through the q-head -> kv-head
// map hmap (the dense TPU kernel takes a head-expanded [B*H, S, D] copy),
// take any S >= 1 (the dense TPU kernel needs S % 512 == 0 above 512), and
// stop at valid_len instead of visiting and masking every block (the result
// is the same). valid_len[b] = 0 is not on the serving path (the engine
// passes pos + 1 >= 1): such a row gets zeros here, where the reference
// returns the mean of V. A q head whose hmap entry is outside [0, KVH) is
// served by no block; block (0, b, 0) writes zeros to it.
//
// What bounds it: reading K and V. Each K/V element is used by the few q
// heads of its group once, ~2 flops per byte read against the card's ~295
// flops/byte ridge, so the bound is the bytes of the valid K/V rows over the
// device memory rate. At decode those bytes are few (~1.7 MB a layer at the
// eval's 16 rows, ~0.4 MB at the serving engine's 4 slots), so what the
// kernel must fight is latency: the chain of dependent loads, and the
// dependent work of each tile. The design reads every needed K/V byte once,
// puts bf16 tiles on the tensor cores, and spreads long rows over blocks
// (flash-decoding) in one launch:
//   - grid (KVH * n_slice, B, n_split): a block per (kv head, head slice,
//     batch row, chunk) serves up to kMaxHeads = 16 of the q heads that
//     hmap maps to its kv head, in order: slice s takes the group's heads
//     16 s .. 16 s + 15. A row has at most kMaxQHeads = 64 q heads and
//     n_slice = ceil(H / 16), a function of the shapes only (1 for
//     qwen2.5-0.5b's padded 16; 2 for 32; 3 for qwen2.5-32b's padded 48,
//     whose kv head 7 serves 13 heads and the others 5; a block whose slice
//     holds no head returns at once, so any map of up to 64 heads is
//     served, all of them on one kv head included). Warp 0 finds a kv
//     head's q heads with two ballots, one a 32-head word of the map. Chunk c holds positions [c L, (c + 1) L), L =
//     S / n_split rounded up to 32; n_split (at most kMaxSplit) is the
//     caller's, a function of the shapes only
//     (kernels/decode_attention.py `decode_splits`: the fewest chunks of
//     at most 512 positions in bf16, since on the H100 one block walks a
//     512-position row faster than several blocks and their combine: 1
//     chunk at S 512, 4 at 2048, 16 at 8192; in f32, whose tiles cost
//     more, of at most 128);
//   - a chunk that starts at or past valid_len[b] reads nothing: its block
//     returns at once, and the row's n_used = ceil(valid_len / L) (at
//     least 1) chunks do the work. valid_len, the head map and, paged, the
//     first of the chunk's page-table entries (one a thread) are loaded
//     together, first; the chunk's slice of the table is then staged in
//     shared memory, clamped to the pool, before the first K/V copy, so no
//     copy waits on a table load of its own. Any page size >= 1 works: a
//     32-position tile may span several pages, and a chunk of L positions
//     at most ceil(L / ps) + 1 entries;
//   - inside a block each warp takes every (warps)-th tile of 32 positions
//     of the chunk with its own online-softmax state (m, l, acc);
//   - bf16 (`decode_kernel_tc`, 8 warps): the slice's q heads are the 16
//     rows of the A operand of mma.sync.m16n8k16 (bf16 in, f32
//     accumulate; rows past the slice are zeros), kept in registers; a
//     warp's K and V tiles come through cp.async into shared memory (rows
//     past valid_len zeros; the first tile is in flight while Q is staged;
//     paged, each lane looks up one position's row and the copies take it
//     by shuffle) and are read with ldmatrix; s = Q K^T (16 x 32) stays in
//     the accumulator registers, where the scale is applied, the positions
//     past valid_len are masked, and the row statistics are reduced over
//     the 4 lanes of a quad; p, as a bf16 hi + lo pair (~16 bits of its
//     mantissa, as flash dk/dv carries p: the reference keeps p in f32;
//     at the eval shape one rounding to bf16 gave a largest error of
//     7.8e-3, the pair 4.9e-4 for ~4% more time), is the A operand of two
//     products acc += P V. A tile at head dim 64 is 48 MMAs (16 for
//     Q K^T, 32 for P V) and 16 exponentials a lane
//     (the CUDA-core bodies this replaces spent 64 G dependent FMAs a lane
//     on q.k alone, G the group's q heads);
//   - f32 (`decode_kernel`, 4 warps, on the CUDA cores): q.k one position
//     per lane, its K row read with 16-byte loads and dotted with the
//     slice's q rows (f32 in shared memory, broadcast), summed in f64
//     (exact products), so the f32 kernel stays as close to an f64
//     evaluation as the plain f32 version is (the rounding of the D-long
//     sum, through exp, is the largest error of an f32 evaluation at a
//     peaked softmax); p.V: lanes own D/32 neighbouring head dims each and
//     read each V row coalesced; the tile's first V rows are loaded before
//     its q.k math;
//   - the warps' states are merged through shared memory (rescaled by
//     exp(m_w - max m)), the warps adding in a fixed order. A row with one
//     chunk in use normalises and writes its output there. Otherwise each
//     block writes its chunk's (m, l, unnormalised acc) in f32 to the
//     caller's workspace, fences, and takes a ticket from the (row, kv
//     head, slice)'s counter (CUDA's threadFenceReduction pattern); the
//     block that draws the last ticket reads every chunk's (m, l) at once,
//     sums the chunks in chunk order 0, 1, .., n_used - 1 (8 loads in
//     flight) with the weights exp(m_c - M) / sum_c l_c exp(m_c - M),
//     writes the output and resets the counter to 0 for the next launch.
//     The ticket only decides which block sums; the order of the sums is
//     fixed, so the same inputs give the same bits;
//   - positions at or past valid_len are neither read nor computed.
// Registers a thread and spills (ptxas -v for sm_90a; phase 2 of
// chip_smoke.py prints them): decode_kernel_tc<64, *Rows> 98-99, <128, *>
// 164-174; decode_kernel<64 and 128, *> 226; no spills.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <atomic>

#include "smem_limit.cuh"

namespace {

constexpr int kWarps = 4;         // the f32 body's
constexpr int kThreads = 32 * kWarps;
constexpr int kTile = 32;         // positions per warp step
constexpr int kMaxHeads = 16;     // q heads a block serves: the MMA's rows
constexpr int kMaxQHeads = 64;    // q heads a row: two of warp 0's lanes
constexpr int kMaxSplit = 32;     // chunks per row
constexpr float kNegInf = -1e30f;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load16(const float* p, float* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = v.x; out[1] = v.y; out[2] = v.z; out[3] = v.w;
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// N neighbouring elements of a V row, one vector load
template <int N>
struct alignas(4 * N) LaneVec {
  float v[N];
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

// Warp 0's two words of the head map: lane i holds hmap[i] and hmap[32 + i]
// (-1 past H, which matches no kv head); loaded beside valid_len
__device__ __forceinline__ int2 head_map(const int* __restrict__ hmap,
                                         int H) {
  const int t = threadIdx.x;
  return make_int2(t < 32 && t < H ? __ldg(hmap + t) : -1,
                   t < 32 && t + 32 < H ? __ldg(hmap + t + 32) : -1);
}

// The block's q heads: heads[0 .. n) the q heads of slice `slice` of those
// that hmap maps to kv head kvh, in order (H <= kMaxQHeads = 64; warp 0
// fills them from `my_map`, its lane's two entries from `head_map`: one
// ballot a word, the second word's heads counted after the first's); the
// row's first block also writes zeros to the q heads that no block serves.
// The caller synchronises before reading them.
template <typename T>
__device__ __forceinline__ void group_heads(int2 my_map,
                                            const int* __restrict__ hmap,
                                            T* __restrict__ out_b, int H,
                                            int KVH, int kvh, int slice,
                                            int D, bool first, int* heads,
                                            int* n_heads) {
  const int tid = threadIdx.x, lane = tid & 31;
  if (tid < 32) {
    const unsigned below = (1u << lane) - 1u;
    const unsigned lo = __ballot_sync(kFull, my_map.x == kvh);
    const unsigned hi = __ballot_sync(kFull, my_map.y == kvh);
    const int skip = slice * kMaxHeads;
    const int i0 = __popc(lo & below) - skip;
    const int i1 = __popc(lo) + __popc(hi & below) - skip;
    if (my_map.x == kvh && i0 >= 0 && i0 < kMaxHeads) heads[i0] = lane;
    if (my_map.y == kvh && i1 >= 0 && i1 < kMaxHeads) heads[i1] = 32 + lane;
    if (lane == 0)
      *n_heads = min(kMaxHeads, max(0, __popc(lo) + __popc(hi) - skip));
  }
  if (first) {
    for (int i = tid; i < H * D; i += blockDim.x) {
      const int g = hmap[i / D];
      if (g < 0 || g >= KVH) store(out_b + i, 0.f);
    }
  }
}

// Where a block finds position t's K/V row: its element offset in k and v
// (the same in both), for the block's row b and kv head
struct DenseRows {   // cache [B, S, KVH, D]: (b, t)
  static constexpr bool kPaged = false;
  long long base, stride;   // base: the offset of (b, 0, kvh)
  __device__ __forceinline__ long long at(int t) const {
    return base + t * stride;
  }
};
struct PagedRows {   // pool [num_pages, ps, KVH, D]: (tables[b, t / ps], t % ps)
  static constexpr bool kPaged = true;
  long long base, stride;   // base: the offset of (0, 0, kvh)
  const int* pages;   // shared: the chunk's pages from p0 on, clamped
  int p0, ps;
  __device__ __forceinline__ long long at(int t) const {
    const int p = t / ps;
    return base + ((long long)pages[p - p0] * ps + (t - p * ps)) * stride;
  }
};
// The paged layout's page tables (the dense layout passes none)
struct Pages {
  const int* tables;   // [B, max_pages] int32
  int num_pages, ps, max_pages;
};
// paged: entry p0 + threadIdx.x of row b's table, if the chunk has it (n
// entries from p0); loaded at once, beside valid_len and hmap
__device__ __forceinline__ int first_page(const Pages& pg, int b, int p0,
                                          int n) {
  return (int)threadIdx.x < n
             ? __ldg(pg.tables + (size_t)b * pg.max_pages + p0 + threadIdx.x)
             : 0;
}
// ... and the chunk's n entries, clamped to the pool, into shared `pages`
// (the caller synchronises before reading them)
__device__ __forceinline__ void stage_pages(const Pages& pg, int b, int p0,
                                            int n, int first, int* pages) {
  const int* row = pg.tables + (size_t)b * pg.max_pages + p0;
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    pages[i] = min(max(i == (int)threadIdx.x ? first : __ldg(row + i), 0),
                   pg.num_pages - 1);
}
// the block's rows: paged, over the chunk's pages staged from p0 on
template <typename Rows>
__device__ __forceinline__ Rows block_rows(int b, int S, int KVH, int kvh,
                                           int D, const int* pages, int p0,
                                           int ps) {
  const long long stride = (long long)KVH * D;   // elements per position
  if constexpr (Rows::kPaged)
    return Rows{(long long)kvh * D, stride, pages, p0, ps};
  else
    return Rows{(long long)b * S * stride + (long long)kvh * D, stride};
}

// After a block has written its chunk's (acc, m, l) of each q head to
// `chunks` + its chunk: the block that draws the (row, kv head)'s last
// ticket sums the n_used chunks in chunk order 0, 1, .. into the output
// rows of `heads` and resets the ticket; the others return.
template <typename T, int D>
__device__ void finish_chunks(const float* chunks, unsigned* ticket,
                              int n_used, int G, const int* heads,
                              T* __restrict__ out_b) {
  __shared__ float mw[kMaxSplit][kMaxHeads];   // m, then exp(m_c - M)
  __shared__ float wt[kMaxSplit][kMaxHeads];   // l, then the weights
  __shared__ int is_last;
  const int tid = threadIdx.x;
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == (unsigned)n_used - 1u;
  __syncthreads();
  if (!is_last) return;
  __threadfence();   // the other chunks' writes are seen (read through L2)
  // every chunk's (m, l) at once, one pair a thread
  for (int i = tid; i < n_used * G; i += blockDim.x) {
    const int c = i / G, g = i % G;
    const float2 x = __ldcg(reinterpret_cast<const float2*>(
        chunks + (c * kMaxHeads + g) * (D + 2) + D));
    mw[c][g] = x.x;
    wt[c][g] = x.y;
  }
  if (tid == 0) *ticket = 0u;   // zeroed for the next launch
  __syncthreads();
  if (tid < G) {   // the weights exp(m_c - M) / sum_c l_c exp(m_c - M)
    float mx = kNegInf;
    for (int c = 0; c < n_used; ++c) mx = fmaxf(mx, mw[c][tid]);
    float lsum = 0.f;
    for (int c = 0; c < n_used; ++c) {
      const float w = expf(mw[c][tid] - mx);
      lsum = fmaf(wt[c][tid], w, lsum);
      mw[c][tid] = w;
    }
    const float inv = 1.f / fmaxf(lsum, 1e-30f);
    for (int c = 0; c < n_used; ++c) wt[c][tid] = mw[c][tid] * inv;
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += blockDim.x) {
    const int g = i / D, d = i % D;
    const float* at = chunks + g * (D + 2) + d;
    float o = 0.f;
    for (int c0 = 0; c0 < n_used; c0 += 8) {   // 8 loads in flight, then
      float x[8];                               // the sums in chunk order
#pragma unroll
      for (int j = 0; j < 8; ++j)
        x[j] = c0 + j < n_used ? __ldcg(at + (c0 + j) * kMaxHeads * (D + 2))
                               : 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (c0 + j < n_used) o = fmaf(x[j], wt[c0 + j][g], o);
    }
    store(out_b + heads[g] * D + d, o);
  }
}

// this (row, kv head, slice)'s chunk 0 in the workspace:
// [B][KVH * n_slice][n_split][kMaxHeads][D + 2]
template <int D>
__device__ __forceinline__ float* chunk_base(float* part, int b) {
  return part +
         ((size_t)b * gridDim.x + blockIdx.x) * gridDim.z * kMaxHeads * (D + 2);
}

// f32 inputs, on the CUDA cores: q.k summed in f64
template <int D, typename Rows>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ q, const float* __restrict__ k,
              const float* __restrict__ v, const int* __restrict__ valid_len,
              const int* __restrict__ hmap, float* __restrict__ out,
              float* __restrict__ part, unsigned* __restrict__ tickets,
              Pages pg, int H, int KVH, int S, int chunk, int n_slice,
              float scale) {
  constexpr int kN = D / 32;               // head dims per lane in p.V
  constexpr int kVec = 4;                  // elements per 16-byte K load
  // V rows loaded ahead of q.k: all 32 where they take <= 64 registers
  constexpr int kPre = kN <= 2 ? kTile : 8;
  using Lane = LaneVec<kN>;

  __shared__ __align__(16) float qs[kMaxHeads][D];
  __shared__ __align__(16) float ps[kWarps][kMaxHeads][kTile];
  __shared__ __align__(16) float os[kMaxHeads][D];
  __shared__ float m_w[kWarps][kMaxHeads], l_w[kWarps][kMaxHeads];
  __shared__ int heads[kMaxHeads];
  __shared__ int n_heads;
  extern __shared__ int pages_f32[];   // paged: the chunk's pages

  const int kvh = blockIdx.x / n_slice;
  const int slice = blockIdx.x % n_slice;
  const int b = blockIdx.y;
  const int chunk_id = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0_chunk = chunk_id * chunk;
  int p0 = 0, n_pages = 0, first = 0;
  if constexpr (Rows::kPaged) {
    p0 = t0_chunk / pg.ps;
    n_pages = (min(S, t0_chunk + chunk) + pg.ps - 1) / pg.ps - p0;
    first = first_page(pg, b, p0, n_pages);
  }
  const int2 my_map = head_map(hmap, H);
  const int n_keys = max(0, min(valid_len[b], S));
  const int n_used = max(1, (n_keys + chunk - 1) / chunk);
  if (chunk_id >= n_used) return;   // past valid_len: nothing to read
  const int t_end = min(n_keys, t0_chunk + chunk);
  float* out_b = out + (size_t)b * H * D;

  group_heads(my_map, hmap, out_b, H, KVH, kvh, slice, D,
              blockIdx.x == 0 && chunk_id == 0, heads, &n_heads);
  if constexpr (Rows::kPaged)
    stage_pages(pg, b, p0, n_pages, first, pages_f32);
  __syncthreads();
  const int G = n_heads;
  if (G == 0) return;   // a slice past its kv head's group: no q head
  const Rows rows = block_rows<Rows>(b, S, KVH, kvh, D, pages_f32, p0, pg.ps);

  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D, d = i % D;
    qs[g][d] = q[((long long)b * H + heads[g]) * D + d];
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

  for (int t0 = t0_chunk + warp * kTile; t0 < t_end; t0 += kWarps * kTile) {
    const int t = t0 + lane;
    const bool valid = t < t_end;
    const int nt = min(kTile, t_end - t0);     // warp-uniform
    // element offset of position t's K/V row (lanes past the end: unused)
    const long long row = rows.at(valid ? t : t0);
    Lane vv[kPre];
#pragma unroll
    for (int j = 0; j < kPre; ++j) {
      const long long r = __shfl_sync(kFull, row, j);
      if (j < nt) vv[j] = *reinterpret_cast<const Lane*>(v + r + lane * kN);
    }
    double s[kMaxHeads];
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
            const float4 q4 =
                *reinterpret_cast<const float4*>(&qs[g][c * kVec]);
            s[g] = fma(double(q4.x), double(kf[0]), s[g]);
            s[g] = fma(double(q4.y), double(kf[1]), s[g]);
            s[g] = fma(double(q4.z), double(kf[2]), s[g]);
            s[g] = fma(double(q4.w), double(kf[3]), s[g]);
          }
        }
      }
    }
    // online softmax over this warp's 32 positions, per head
#pragma unroll
    for (int g = 0; g < kMaxHeads; ++g) {
      if (g < G) {
        const float sg = valid ? float(s[g] * double(scale)) : kNegInf;
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
            vf[u][e] = jj < nt ? raw.v[e] : 0.f;
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

  // merge the warps' states (rescaled to the block's max m), normalised
  // here when this is the row's only chunk in use
  const bool direct = n_used == 1;
  float* chunks = chunk_base<D>(part, b);
  float* mine = chunks + (size_t)chunk_id * kMaxHeads * (D + 2);
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
      f[g] = expf(m[g] - mx);
      if (direct) {
        f[g] /= fmaxf(lsum, 1e-30f);
      } else if (tid == g) {
        mine[g * (D + 2) + D] = mx;
        mine[g * (D + 2) + D + 1] = lsum;
      }
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
    if (direct) {
      store(out_b + heads[g] * D + d, os[g][d]);
    } else {
      mine[g * (D + 2) + d] = os[g][d];
    }
  }
  if (!direct)
    finish_chunks<float, D>(chunks, tickets + (size_t)b * gridDim.x +
                                blockIdx.x, n_used, G, heads, out_b);
}

// ------------------------------------------------------------------------
// bf16 inputs, on the tensor cores (mma.sync.m16n8k16, bf16 in, f32
// accumulate): the group's q heads are the 16 rows of the A operand

using bf16 = __nv_bfloat16;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kTcWarps = 8;   // a tile's cost is mostly its loads' latency
constexpr int kTcThreads = 32 * kTcWarps;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; unless `full`, zeros (and
// `src`, a valid address, is not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool full) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(full ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
// (x0, x1) - their bf16 rounding, rounded to bf16: the low half of a
// hi + lo pair that carries ~16 bits of x's mantissa
__device__ __forceinline__ uint32_t pack_bf16_lo(float x0, float x1) {
  const float2 hi = __bfloat1622float2(__floats2bfloat162_rn(x0, x1));
  return pack_bf16(x0 - hi.x, x1 - hi.y);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(kFull, x, 1));
  return fmaxf(x, __shfl_xor_sync(kFull, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(kFull, x, 1);
  return x + __shfl_xor_sync(kFull, x, 2);
}
// 2^x on the special function unit (relative error ~2^-22; 0 for -inf)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
constexpr int tc_smem() {   // Q, then each warp's K and V tiles, m and l
  return (kMaxHeads + 2 * kTcWarps * kTile) * (D + 8) * 2 +
         2 * kTcWarps * kMaxHeads * 4;
}

template <int D, typename Rows>
__global__ void __launch_bounds__(kTcThreads)
decode_kernel_tc(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v,
                 const int* __restrict__ valid_len,
                 const int* __restrict__ hmap, bf16* __restrict__ out,
                 float* __restrict__ part, unsigned* __restrict__ tickets,
                 Pages pg, int H, int KVH, int S, int chunk, int n_slice,
                 float scale) {
  constexpr int kLD = D + 8;   // bf16 row stride: ldmatrix rows on 8 banks
  extern __shared__ float4 smem4[];
  bf16* Qs = reinterpret_cast<bf16*>(smem4);               // [16, kLD]
  bf16* KV = Qs + kMaxHeads * kLD;                         // [warp][K, V]
  float* ml = reinterpret_cast<float*>(KV + 2 * kTcWarps * kTile * kLD);
  float* sums = reinterpret_cast<float*>(KV);   // [warp][16][D], after
  int* pages = reinterpret_cast<int*>(ml + 2 * kTcWarps * kMaxHeads);
  __shared__ int heads[kMaxHeads];
  __shared__ int n_heads;

  const int kvh = blockIdx.x / n_slice;
  const int slice = blockIdx.x % n_slice;
  const int b = blockIdx.y;
  const int chunk_id = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int t0_chunk = chunk_id * chunk;
  int p0 = 0, n_pages = 0, first = 0;
  if constexpr (Rows::kPaged) {
    p0 = t0_chunk / pg.ps;
    n_pages = (min(S, t0_chunk + chunk) + pg.ps - 1) / pg.ps - p0;
    first = first_page(pg, b, p0, n_pages);
  }
  const int2 my_map = head_map(hmap, H);
  const int n_keys = max(0, min(valid_len[b], S));
  const int n_used = max(1, (n_keys + chunk - 1) / chunk);
  if (chunk_id >= n_used) return;   // past valid_len: nothing to read
  const int t_end = min(n_keys, t0_chunk + chunk);
  bf16* out_b = out + (size_t)b * H * D;

  // this warp's tiles of 32 positions, K and V through cp.async; rows at or
  // past t_end are zeros
  bf16* Kw = KV + warp * 2 * kTile * kLD;
  bf16* Vw = Kw + kTile * kLD;
  const Rows rows = block_rows<Rows>(b, S, KVH, kvh, D, pages, p0, pg.ps);
  auto load_tile = [&](int t0) {
    // paged: each lane looks up one position's row, the copies shuffle it
    long long mine = 0;
    if constexpr (Rows::kPaged) mine = rows.at(min(t0 + lane, t_end - 1));
    for (int i = lane; i < kTile * (D / 8); i += 32) {
      const int r = i / (D / 8), c = (i % (D / 8)) * 8;
      const bool in = t0 + r < t_end;
      long long row;
      if constexpr (Rows::kPaged)
        row = __shfl_sync(kFull, mine, r);
      else
        row = rows.at(t0 + r);
      const size_t at = in ? row + c : 0;
      cp_async16(Kw + r * kLD + c, k + at, in);
      cp_async16(Vw + r * kLD + c, v + at, in);
    }
    cp_async_commit();
  };
  int t0 = t0_chunk + warp * kTile;
  if constexpr (!Rows::kPaged)
    if (t0 < t_end) load_tile(t0);   // in flight while Q is staged

  group_heads(my_map, hmap, out_b, H, KVH, kvh, slice, D,
              blockIdx.x == 0 && chunk_id == 0, heads, &n_heads);
  if constexpr (Rows::kPaged) stage_pages(pg, b, p0, n_pages, first, pages);
  __syncthreads();
  const int G = n_heads;
  if (G == 0) {   // a slice past its kv head's group: no q head to serve
    cp_async_wait_all();
    return;
  }
  if constexpr (Rows::kPaged)
    if (t0 < t_end) load_tile(t0);   // the pages are staged; in flight
                                     // while Q is staged
  // Q rows: the slice's q heads, zeros past G
  for (int i = tid; i < kMaxHeads * (D / 8); i += kTcThreads) {
    const int g = i / (D / 8), c = (i % (D / 8)) * 8;
    *reinterpret_cast<uint4*>(Qs + g * kLD + c) =
        g < G ? *reinterpret_cast<const uint4*>(
                    q + ((size_t)b * H + heads[g]) * D + c)
              : make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  uint32_t qf[D / 16][4];
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    ldsm4(qf[kc], Qs + (lane & 15) * kLD + kc * 16 + (lane >> 4) * 8);

  // the lane's rows: q heads lane/4 and lane/4 + 8; m the row max of the
  // raw scores q.k (-inf: none yet), l the lane's part of the row sum
  const float sl2 = scale * kLog2e;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  for (; t0 < t_end; t0 += kTcWarps * kTile) {
    cp_async_wait_all();
    __syncwarp();
    // s = Q K^T: 16 heads x 32 positions
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        uint32_t kf[4];
        ldsm4(kf, Kw + (j * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLD +
                      kc * 16 + ((lane >> 3) & 1) * 8);
        mma16816(s[2 * j], qf[kc], kf[0], kf[1]);
        mma16816(s[2 * j + 1], qf[kc], kf[2], kf[3]);
      }
    if (t0 + kTile > t_end) {
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t0 + j * 8 + ((lane & 3) << 1) + (e & 1) >= t_end)
            s[j][e] = -INFINITY;
    }
    float alpha[2], ms[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = m[r];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        mx = fmaxf(mx, fmaxf(s[j][2 * r], s[j][2 * r + 1]));
      mx = quad_max(mx);   // finite: the tile holds a valid position
      alpha[r] = ex2((m[r] - mx) * sl2);   // 0 from -inf
      ms[r] = mx * sl2;
      m[r] = mx;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
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
    // acc += P V, P as a bf16 hi + lo pair (p to ~2^-17; the reference
    // keeps p in f32): two products into the same sums, hi first
#pragma unroll
    for (int kc = 0; kc < 2; ++kc) {
      const uint32_t a[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                             pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                             pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                             pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint32_t lo[4] = {
          pack_bf16_lo(s[2 * kc][0], s[2 * kc][1]),
          pack_bf16_lo(s[2 * kc][2], s[2 * kc][3]),
          pack_bf16_lo(s[2 * kc + 1][0], s[2 * kc + 1][1]),
          pack_bf16_lo(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t vf[4];
        ldsm4_t(vf, Vw + (kc * 16 + (lane & 7) + (((lane >> 3) & 1) << 3)) *
                             kLD + dp * 16 + (lane >> 4) * 8);
        mma16816(acc[2 * dp], a, vf[0], vf[1]);
        mma16816(acc[2 * dp + 1], a, vf[2], vf[3]);
        mma16816(acc[2 * dp], lo, vf[0], vf[1]);
        mma16816(acc[2 * dp + 1], lo, vf[2], vf[3]);
      }
    }
    __syncwarp();   // every lane is done with Kw and Vw
    if (t0 + kTcWarps * kTile < t_end) load_tile(t0 + kTcWarps * kTile);
  }

  // merge the warps: each row's max over the warps, each warp's weight,
  // the weighted accumulators summed in warp order (normalised here when
  // this is the row's only chunk in use)
  const bool direct = n_used == 1;
  const int r0 = lane >> 2;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] = quad_sum(l[r]);
    if ((lane & 3) == 0) {
      ml[warp * kMaxHeads + r0 + 8 * r] = m[r];
      ml[(kTcWarps + warp) * kMaxHeads + r0 + 8 * r] = l[r];
    }
  }
  __syncthreads();   // also: every warp is done with its K and V tiles
  float* chunks = chunk_base<D>(part, b);
  float* mine = chunks + (size_t)chunk_id * kMaxHeads * (D + 2);
  float f[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int g = r0 + 8 * r;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w)
      mx = fmaxf(mx, ml[w * kMaxHeads + g]);
    float lsum = 0.f;
#pragma unroll
    for (int w = 0; w < kTcWarps; ++w)
      lsum = fmaf(ml[(kTcWarps + w) * kMaxHeads + g],
                  ex2((ml[w * kMaxHeads + g] - mx) * sl2), lsum);
    // 0 for a warp that saw no position, or all of them (valid_len 0)
    f[r] = mx == -INFINITY ? 0.f : ex2((m[r] - mx) * sl2);
    if (direct) {
      f[r] /= fmaxf(lsum, 1e-30f);
    } else if (warp == 0 && (lane & 3) == 0 && g < G) {
      // m in the natural units of the combine: the max of q.k D^-1/2
      mine[g * (D + 2) + D] = mx * scale;
      mine[g * (D + 2) + D + 1] = lsum;
    }
  }
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const int c = n * 8 + ((lane & 3) << 1);
    float* at = sums + (warp * kMaxHeads + r0) * D + c;
    *reinterpret_cast<float2*>(at) =
        make_float2(acc[n][0] * f[0], acc[n][1] * f[0]);
    *reinterpret_cast<float2*>(at + 8 * D) =
        make_float2(acc[n][2] * f[1], acc[n][3] * f[1]);
  }
  __syncthreads();
  for (int i = tid; i < G * D; i += kTcThreads) {
    float x = sums[i];
#pragma unroll
    for (int w = 1; w < kTcWarps; ++w) x += sums[w * kMaxHeads * D + i];
    const int g = i / D, d = i % D;
    if (direct) {
      store(out_b + heads[g] * D + d, x);
    } else {
      mine[g * (D + 2) + d] = x;
    }
  }
  if (!direct)
    finish_chunks<bf16, D>(chunks, tickets + (size_t)b * gridDim.x +
                               blockIdx.x, n_used, G, heads, out_b);
}

// positions per chunk: S / n_split rounded up to whole 32-position tiles
int chunk_len(int S, int n_split) {
  return ((S + n_split - 1) / n_split + kTile - 1) / kTile * kTile;
}

// Both layouts' launches: checks what the kernels take, then one launch of
// the dtype's body (cudaErrorInvalidValue for what they do not take)
template <typename Rows>
int launch(const void* q, const void* k, const void* v, const void* valid_len,
           const void* hmap, void* out, void* part, void* tickets, Pages pg,
           int B, int H, int KVH, int S, int D, int n_split, float scale,
           int dtype, void* stream) {
  if (H < 1 || H > kMaxQHeads || KVH < 1 || S < 1 || B < 1 ||
      B > 65535 || n_split < 1 || n_split > kMaxSplit ||
      (D != 64 && D != 128) ||
      (n_split > 1 && (part == nullptr || tickets == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_slice = (H + kMaxHeads - 1) / kMaxHeads;
  const dim3 grid(KVH * n_slice, B, n_split);
  const int chunk = chunk_len(S, n_split);
  // paged: the most pages a chunk spans, staged in shared memory
  const int table = Rows::kPaged ? 4 * ((chunk + pg.ps - 1) / pg.ps + 1) : 0;
  const int* vl = static_cast<const int*>(valid_len);
  const int* hm = static_cast<const int*>(hmap);
  float* pt = static_cast<float*>(part);
  unsigned* tk = static_cast<unsigned*>(tickets);
  // the largest dynamic shared memory set so far: [body][D == 128][device]
  static std::atomic<int> smem_set[2][2][kMaxDevices];
  cudaError_t e = cudaSuccess;
  if (dtype == 1) {
    const int smem = (D == 64 ? tc_smem<64>() : tc_smem<128>()) + table;
    auto kern = D == 64 ? decode_kernel_tc<64, Rows> : decode_kernel_tc<128, Rows>;
    e = allow_smem(kern, smem, smem_set[1][D == 128]);
    if (e == cudaSuccess)
      kern<<<grid, kTcThreads, smem, s>>>(
          static_cast<const bf16*>(q), static_cast<const bf16*>(k),
          static_cast<const bf16*>(v), vl, hm, static_cast<bf16*>(out), pt,
          tk, pg, H, KVH, S, chunk, n_slice, scale);
  } else if (dtype == 0) {
    auto kern = D == 64 ? decode_kernel<64, Rows> : decode_kernel<128, Rows>;
    e = allow_smem(kern, table, smem_set[0][D == 128]);
    if (e == cudaSuccess)
      kern<<<grid, kThreads, table, s>>>(
          static_cast<const float*>(q), static_cast<const float*>(k),
          static_cast<const float*>(v), vl, hm, static_cast<float*>(out), pt,
          tk, pg, H, KVH, S, chunk, n_slice, scale);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int decode_attention_max_heads() { return kMaxQHeads; }
int decode_attention_block_heads() { return kMaxHeads; }
int decode_attention_max_split() { return kMaxSplit; }

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Both entry points: pointers are device pointers; valid_len [B] and hmap
// [H] are int32; q and out [B, H, D], contiguous. dtype: 0 = float32, 1 =
// bfloat16 (q, the cache and out share it); D is 64 or 128; H <=
// kMaxQHeads; B <= 65535. n_split: chunks per row, 1 .. kMaxSplit. With
// n_split > 1, `part` is an f32 workspace of B * KVH * n_slice * n_split *
// kMaxHeads * (D + 2) values and `tickets` B * KVH * n_slice unsigned ints
// that are 0 at the launch (each launch leaves them 0), n_slice = ceil(H /
// kMaxHeads). Launches on `stream` without synchronising and returns
// cudaGetLastError() (cudaErrorInvalidValue for what the kernel does not
// take). Launches that share `tickets` must run one after another (one
// stream).

// Row 3: k and v [B, S, KVH, D], contiguous.
int decode_attention(const void* q, const void* k, const void* v,
                     const void* valid_len, const void* hmap, void* out,
                     void* part, void* tickets, int B, int H, int KVH, int S,
                     int D, int n_split, float scale, int dtype,
                     void* stream) {
  return launch<DenseRows>(q, k, v, valid_len, hmap, out, part, tickets,
                           Pages{nullptr, 0, 0, 0}, B, H, KVH, S, D, n_split,
                           scale, dtype, stream);
}

// Row 1: k_pool and v_pool [num_pages, page_size, KVH, D], contiguous;
// page_tables [B, max_pages] int32 (entries are clamped to [0, num_pages));
// the positions are S = max_pages * page_size.
int paged_decode_attention(const void* q, const void* k_pool,
                           const void* v_pool, const void* page_tables,
                           const void* valid_len, const void* hmap, void* out,
                           void* part, void* tickets, int B, int H, int KVH,
                           int num_pages, int page_size, int max_pages, int D,
                           int n_split, float scale, int dtype, void* stream) {
  if (page_tables == nullptr || num_pages < 1 || page_size < 1 ||
      max_pages < 1 || max_pages > INT_MAX / page_size)
    return static_cast<int>(cudaErrorInvalidValue);
  return launch<PagedRows>(
      q, k_pool, v_pool, valid_len, hmap, out, part, tickets,
      Pages{static_cast<const int*>(page_tables), num_pages, page_size,
            max_pages},
      B, H, KVH, max_pages * page_size, D, n_split, scale, dtype, stream);
}

}  // extern "C"
