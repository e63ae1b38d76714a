// RMSNorm forward for Hopper (sm_90a): for each row of x [N, D],
//   y = x * (1 / sqrt(mean(x^2) + eps)) * scale,
// statistics in f32, y in the dtype of x; x and scale each f32 or bf16.
//
// Replaces the TPU kernel `_kernel` of src/repro/kernels/rmsnorm.py
// (reached through its `rmsnorm`), and the port's earlier Triton forward,
// which ran one program a row padded to a power of two (D 5120 on 8192
// lanes, 37.5% masked), had nothing in flight while a row was reduced, and
// read the scale again for every row.
//
// What bounds it: bytes. Each element is read once and written once with
// ~4 flops between (~1 flop a byte against the card's ~295 flops/byte
// ridge), so the bound is 2 N D itemsize + D itemsize over the device
// memory rate. What the design does about it:
//   - rows at their exact width: a row is cut into 16-byte vectors (8 bf16
//     or 4 f32) and served by the fewest warps that keep a lane at
//     <= kMaxVecPerLane vectors (bf16: 1 warp up to D 2048, 2 at 3072 and
//     4096, 3 at 5120, 4 at 8192; f32 through the ring, for now, the
//     earlier forward's warps: see `f32_inv_rms`). Lane t of a row's
//     warps takes vectors t, t + 32 W, t + 64 W, ...: neighbouring lanes
//     on neighbouring 16 bytes, nothing padded;
//   - persistent blocks: the grid is about one wave (the plan's `blocks`:
//     SMs x resident blocks, capped by the row groups). A block holds
//     `groups` row groups of W warps; row group g of G in the grid walks
//     rows g, g + G, g + 2 G, ... The block stages the scale once, in f32,
//     in shared memory, for all its rows (each thread's loads issued
//     together, so that the staging costs one memory latency, beside the
//     first rows' copies);
//   - rows in flight: each row group keeps a ring of kStages = 3 row slots
//     in shared memory. One thread of the group issues a 1-D
//     bulk copy (cp.async.bulk, no tensor map: a row is contiguous) a row,
//     completing on the slot's mbarrier; while one row is reduced and
//     stored, the group's next 2 rows are on their way. The
//     group reads a slot twice, for the sum and for the store, so no row
//     is held in registers (128 a thread at most: two blocks of 256 threads
//     an SM); after the store the group syncs and the slot is refilled.
//     The widest ring, f32 at D 8192, is 96 KB a row group (with its 32 KB
//     scale, one block an SM);
//   - the reduction (bf16; f32 rows keep the earlier forward's, see
//     `f32_inv_rms`): a lane's sum of squares (a fixed tree over each
//     vector, then the vectors in order), then a __shfl_xor_sync butterfly;
//     a row on several warps adds one exchange of the warps' sums in shared
//     memory under a named barrier of that group's threads only (double-
//     buffered by the row's parity, so that the next row's exchange cannot
//     overwrite one still being read);
//   - stores are 16-byte vector stores.
// A bulk copy needs 16-byte-aligned addresses and sizes: when x's or
// out's base is not 16-byte aligned (a view such as x[1:] of a flat
// buffer) or D is not a multiple of the vector, the launcher picks the
// vector-width-1 instance of the same template, which loads a lane's
// elements of each row into registers (64 a thread: up to 32 warps a row).
// The scale is read element by element unless it is aligned, so its base
// needs no alignment.
//
// Deterministic: 64-bit row offsets; for each D, dtype and instance one
// fixed map from lanes to columns and one fixed reduction tree (the
// butterfly gives every lane the same bits, the warps' sums are added in
// warp order); 1 / sqrtf (IEEE), not rsqrtf, but for f32 rows through
// the ring, which take the earlier forward's approximate reciprocals and
// square root with its sum order; no atomics. The same inputs give the
// same bits.
//
// The launch plan (vector width, warps a row, row groups a block, stages,
// shared bytes, blocks) is computed by `fwd_plan` in kernels/rmsnorm.py;
// `rmsnorm_fwd` re-checks it and returns cudaErrorInvalidValue for a plan
// the kernel cannot run.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <type_traits>

#include "smem_limit.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxD = 8192;          // the widest row (MAX_D_FWD)
constexpr int kMaxVecPerLane = 8;    // vectors (or elements) a lane holds
constexpr int kStages = 3;           // ring slots a row group
constexpr int kMaxThreads = 1024;    // a block of the registers instance
                                     // (64 registers a thread)
constexpr int kMaxBulkThreads = 256; // a block of the bulk-copy instances,
                                     // two an SM (128 registers a thread)
constexpr int kMaxGroups = 15;       // row groups a block: named barriers 1-15
constexpr int kMaxSmem = 232448;     // the most a block may take (227 KB)

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

// VEC elements of T, aligned to their size: 16 bytes, or one element
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Vec {
  T v[VEC];
};

// A block's dynamic shared memory, in this order: the ring's mbarriers (one
// a slot), the warps' sums (2 x 4 a row group and warp: two rows' worth of
// the f32 path's four sums a warp), the scale in f32,
// the ring (groups x stages row slots; none in the vector-width-1
// instance). kernels/rmsnorm.py `_smem` reckons the same total.
__host__ __device__ constexpr int align16(int b) { return (b + 15) / 16 * 16; }

struct Layout {
  int bars, parts, scale, ring, total;
};

__host__ __device__ inline Layout layout(int d, int itemsize, int warps,
                                         int groups, int stages) {
  Layout l;
  l.bars = align16(8 * groups * stages);
  l.parts = align16(4 * 2 * 4 * groups * warps);
  l.scale = align16(4 * d);
  l.ring = groups * stages * align16(d * itemsize);
  l.total = l.bars + l.parts + l.scale + l.ring;
  return l;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of this parity has completed. A copy
// that never lands would otherwise hold the card forever: past ~10 s of
// clock the kernel traps, and the launch fails with an error instead.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// one row into a ring slot: the barrier's one arrival, expecting `bytes`,
// then the copy that completes them
__device__ __forceinline__ void bulk_row(uint32_t dst, const void* src,
                                         uint32_t bytes, uint32_t bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// the threads of one row group: a named barrier, or the warp
__device__ __forceinline__ void group_sync(int group, int warps) {
  if (warps == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync %0, %1;\n" ::"r"(1 + group), "r"(32 * warps)
                 : "memory");
  }
}

// The lane's vector i of the row: src[i * row_threads + t] of a ring
// slot, or src[i] of the lane's registers (kRegs).
template <bool kRegs, typename V>
__device__ __forceinline__ V lane_vec(const V* src, int i, int t,
                                      int row_threads) {
  return kRegs ? src[i] : src[i * row_threads + t];
}

// a lane's sum of squares over its vectors of the row: a fixed tree over
// each vector's elements, then the vectors in order
template <int VEC, bool kRegs, typename V>
__device__ __forceinline__ float sum_sq(const V* src, int nv, int t,
                                        int row_threads) {
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    if (i * row_threads + t < nv) {
      const V v = lane_vec<kRegs>(src, i, t, row_threads);
      float a[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) a[j] = to_float(v.v[j]) * to_float(v.v[j]);
#pragma unroll
      for (int w = VEC / 2; w > 0; w /= 2)
#pragma unroll
        for (int j = 0; j < w; ++j) a[j] += a[j + w];
      ss += a[0];
    }
  }
  return ss;
}

// The row's sum of squares in every thread of its group: the butterfly
// (every lane gets the same bits), then, on several warps, the warps' sums
// in warp order from this parity's exchange (so that the next row's cannot
// overwrite one still being read).
__device__ __forceinline__ float row_total(float ss, float* parts, int group,
                                           int groups, int warps, int t,
                                           int parity) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (warps == 1) return ss;
  float* p = parts + (parity * groups + group) * warps;
  if ((t & 31) == 0) p[t >> 5] = ss;
  group_sync(group, warps);
  float total = 0.f;
  for (int w = 0; w < warps; ++w) total += p[w];
  return total;
}

// f32 rows through the ring: r with the arithmetic of the port's earlier
// (Triton) forward, bit for bit. A temporary compatibility fork: it exists
// only so that f32 card trajectories keep their bits for chip_smoke.py
// phase 14(b), a card-against-CPU check that sits at the noise of AdamW's
// eps and fails on IEEE arithmetic here; once that check is repaired
// (ROADMAP Queue C 12) f32 takes the bf16 path's sums, IEEE 1 / sqrtf and
// fewest-warps plan, and this function and fwd_plan's f32 warp rule go.
// Its cost: an f32 row's bits depend on the instance, so an unaligned view
// (the vector-width-1 instance, IEEE) and an aligned copy of the same rows
// differ in their last bits. That forward laid a row padded to
// B = 2^ceil(log2 D) over T = 32 max(4, B / 256) threads, thread u holding
// the 4-element vectors u and u + T; with W = max(1, B / 1024) warps a row
// (the plan's f32 width), lane t of this kernel holds exactly the vectors
// of its threads t + 32 W m, m = 0..3. Each thread's sum is x1 x1, then
// fused x0, x2, x3 and the second vector's four in order; a butterfly over
// its warp; the 4 W warp sums added by a butterfly over lanes; then, as
// that forward was compiled (ptxas made its two divides reciprocals,
// MUFU.RCP, and folded the first one's product and the + eps into an FMA):
// sqrt.approx(fma(rcp(d), sum, eps)), and r its reciprocal.
// (Rows of at most 256 elements were laid out 2 to a thread there: their
// bits differ. No test holds these bits against that forward's, which is
// gone; the plain version's tolerance is what the tests check.)
__device__ __forceinline__ float f32_inv_rms(const Vec<float, 4>* src,
                                             float* parts, int nv, int t,
                                             int row_threads, int group,
                                             int groups, int warps,
                                             int parity, int d, float eps) {
  float u[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const int c0 = m * row_threads + t, c1 = (m + 4) * row_threads + t;
    const Vec<float, 4> zero{};
    const Vec<float, 4> a = c0 < nv ? src[c0] : zero;
    const Vec<float, 4> b = c1 < nv ? src[c1] : zero;
    float acc = __fmul_rn(a.v[1], a.v[1]);
    acc = __fmaf_rn(a.v[0], a.v[0], acc);
    acc = __fmaf_rn(a.v[2], a.v[2], acc);
    acc = __fmaf_rn(a.v[3], a.v[3], acc);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc = __fmaf_rn(b.v[j], b.v[j], acc);
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc = __fadd_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
    u[m] = acc;
  }
  float* p = parts + (parity * groups + group) * 4 * warps;
  const int lane = t & 31, nw = 4 * warps;
  if (lane == 0)
#pragma unroll
    for (int m = 0; m < 4; ++m) p[(t >> 5) + warps * m] = u[m];
  group_sync(group, warps);
  float v = lane < nw ? p[lane] : 0.f;
  for (int o = nw / 2; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  float inv_d, root, r;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(inv_d) : "f"(static_cast<float>(d)));
  asm("sqrt.approx.ftz.f32 %0, %1;"
      : "=f"(root)
      : "f"(__fmaf_rn(inv_d, __shfl_sync(0xffffffffu, v, 0), eps)));
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(root));
  return r;
}

// y = (x r) scale for the lane's vectors, 16-byte stores
template <typename T, int VEC, bool kRegs, typename V>
__device__ __forceinline__ void store_row(const V* src, T* dst,
                                          const float* s_scale, float r,
                                          int nv, int t, int row_threads) {
#pragma unroll
  for (int i = 0; i < kMaxVecPerLane; ++i) {
    const int c = i * row_threads + t;
    if (c < nv) {
      const V v = lane_vec<kRegs>(src, i, t, row_threads);
      float sc[VEC];
      if constexpr (VEC % 4 == 0) {
#pragma unroll
        for (int q = 0; q < VEC / 4; ++q) {
          const float4 f =
              reinterpret_cast<const float4*>(s_scale + c * VEC)[q];
          sc[4 * q] = f.x;
          sc[4 * q + 1] = f.y;
          sc[4 * q + 2] = f.z;
          sc[4 * q + 3] = f.w;
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) sc[j] = s_scale[c * VEC + j];
      }
      V o;
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        o.v[j] = from_float<T>(to_float(v.v[j]) * r * sc[j]);
      reinterpret_cast<V*>(dst)[c] = o;
    }
  }
}

// The scale into shared memory in f32, n items of SV elements: a thread's
// loads are issued kBatch at a time before any is used, so that staging
// costs one memory latency wherever a thread has at most kBatch (a loop
// that used each load at once would pay one latency a load).
template <typename S, int SV, int kBatch>
__device__ __forceinline__ void stage_scale(const S* scale, float* s_scale,
                                            int n) {
  using VS = Vec<S, SV>;
  const VS* src = reinterpret_cast<const VS*>(scale);
  const int step = blockDim.x;
  for (int i0 = threadIdx.x; i0 < n; i0 += kBatch * step) {
    VS v[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (i0 + b * step < n) v[b] = src[i0 + b * step];
#pragma unroll
    for (int b = 0; b < kBatch; ++b)
      if (i0 + b * step < n)
#pragma unroll
        for (int j = 0; j < SV; ++j)
          s_scale[(i0 + b * step) * SV + j] = to_float(v[b].v[j]);
  }
}

// Block = groups x warps x 32 threads. VEC = 16 / sizeof(T): rows come
// through bulk copies into the ring and are read from it twice (the sum,
// then the store), so no row is held in registers. VEC = 1: a lane's
// elements of a row are loaded into registers.
template <typename T, typename S, int VEC>
__global__ void __launch_bounds__(VEC > 1 ? kMaxBulkThreads : kMaxThreads,
                                  VEC > 1 ? 2 : 1)
    rmsnorm_fwd_kernel(const T* __restrict__ x, const S* __restrict__ scale,
                       T* __restrict__ out, long long n, int d, float eps,
                       int warps, int stages) {
  constexpr bool kBulk = VEC > 1;
  using V = Vec<T, VEC>;
  extern __shared__ __align__(16) unsigned char smem[];
  const int row_threads = 32 * warps;
  const int groups = blockDim.x / row_threads;
  const int group = threadIdx.x / row_threads;
  const int t = threadIdx.x - group * row_threads;
  const int nv = d / VEC;
  const uint32_t row_bytes = d * static_cast<uint32_t>(sizeof(T));
  const Layout lay = layout(d, sizeof(T), warps, groups, stages);
  float* parts = reinterpret_cast<float*>(smem + lay.bars);
  float* s_scale = reinterpret_cast<float*>(smem + lay.bars + lay.parts);

  // this group's rows: first, first + G, first + 2 G, ...; `step`
  // elements apart
  const long long G = static_cast<long long>(gridDim.x) * groups;
  const long long first = static_cast<long long>(blockIdx.x) * groups + group;
  const long long count = first < n ? (n - first + G - 1) / G : 0;
  const long long step = G * d;
  const T* src_x = x + first * d;   // the next row to fetch
  T* dst = out + first * d;
  // bulk: the group's slots and their barriers, as shared addresses
  const uint32_t bar0 = smem_addr(smem) + 8 * group * stages;
  const uint32_t slot0 = smem_addr(smem + lay.bars + lay.parts + lay.scale) +
                         group * stages * row_bytes;

  V cur[kMaxVecPerLane];   // the registers instance
  if constexpr (kBulk) {
    if (threadIdx.x < groups * stages)
      mbar_init(smem_addr(smem) + 8 * threadIdx.x, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    __syncthreads();
    // the first rows are in flight while the scale is staged
    for (int k = 0; k < stages && k < count; ++k, src_x += step)
      if (t == 0)
        bulk_row(slot0 + k * row_bytes, src_x, row_bytes, bar0 + 8 * k);
  } else if (count > 0) {
#pragma unroll
    for (int i = 0; i < kMaxVecPerLane; ++i)
      if (i * row_threads + t < nv)
        cur[i] = reinterpret_cast<const V*>(src_x)[i * row_threads + t];
    src_x += step;
  }
  // a thread has at most 8 elements, or 8 vectors of the bulk instances'
  // rows, to stage; the registers instance's 64 registers hold 2 vectors
  constexpr int SV = 16 / sizeof(S);
  if ((reinterpret_cast<uintptr_t>(scale) & 15) == 0 && d % SV == 0)
    stage_scale<S, SV, kBulk ? 8 : 2>(scale, s_scale, d / SV);
  else
    stage_scale<S, 1, 8>(scale, s_scale, d);
  __syncthreads();

  int slot = 0;
  uint32_t phase = 0;
  for (long long k = 0; k < count; ++k, dst += step) {
    if constexpr (kBulk) {
      mbar_wait(bar0 + 8 * slot, phase);
      const V* src = reinterpret_cast<const V*>(
          smem + lay.bars + lay.parts + lay.scale +
          (group * stages + slot) * row_bytes);
      float r;
      if constexpr (std::is_same<T, float>::value) {
        r = f32_inv_rms(src, parts, nv, t, row_threads, group, groups, warps,
                        k & 1, d, eps);
      } else {
        const float ss = row_total(sum_sq<VEC, false>(src, nv, t,
                                                      row_threads),
                                   parts, group, groups, warps, t, k & 1);
        r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
      }
      store_row<T, VEC, false>(src, dst, s_scale, r, nv, t, row_threads);
      if (k + stages < count) {   // the group is done with the slot: refill
        group_sync(group, warps);
        if (t == 0)
          bulk_row(slot0 + slot * row_bytes, src_x, row_bytes,
                   bar0 + 8 * slot);
        src_x += step;
      }
      if (++slot == stages) {
        slot = 0;
        phase ^= 1;
      }
    } else {
      if (k > 0) {
#pragma unroll
        for (int i = 0; i < kMaxVecPerLane; ++i)
          if (i * row_threads + t < nv)
            cur[i] = reinterpret_cast<const V*>(src_x)[i * row_threads + t];
        src_x += step;
      }
      const float ss = row_total(sum_sq<VEC, true>(cur, nv, t, row_threads),
                                 parts, group, groups, warps, t, k & 1);
      const float r = 1.0f / sqrtf(ss / static_cast<float>(d) + eps);
      store_row<T, VEC, true>(cur, dst, s_scale, r, nv, t, row_threads);
    }
  }
}

template <typename T, typename S, int VEC>
cudaError_t launch_as(const void* x, const void* scale, void* out,
                      long long n, int d, float eps, int warps, int groups,
                      int stages, int smem, int blocks, cudaStream_t st) {
  // the largest dynamic shared memory set so far, a device
  static std::atomic<int> set[kMaxDevices];
  auto kern = rmsnorm_fwd_kernel<T, S, VEC>;
  cudaError_t e = allow_smem(kern, smem, set);
  if (e != cudaSuccess) return e;
  kern<<<blocks, 32 * warps * groups, smem, st>>>(
      static_cast<const T*>(x), static_cast<const S*>(scale),
      static_cast<T*>(out), n, d, eps, warps, stages);
  return cudaGetLastError();
}

template <typename T, typename S>
cudaError_t launch_s(const void* x, const void* scale, void* out, long long n,
                     int d, float eps, int vec, int warps, int groups,
                     int stages, int smem, int blocks, cudaStream_t st) {
  return vec == 1 ? launch_as<T, S, 1>(x, scale, out, n, d, eps, warps,
                                       groups, stages, smem, blocks, st)
                  : launch_as<T, S, 16 / sizeof(T)>(x, scale, out, n, d, eps,
                                                    warps, groups, stages,
                                                    smem, blocks, st);
}

template <typename T>
cudaError_t launch_x(const void* x, const void* scale, void* out, long long n,
                     int d, float eps, int scale_dtype, int vec, int warps,
                     int groups, int stages, int smem, int blocks,
                     cudaStream_t st) {
  return scale_dtype == 0
             ? launch_s<T, float>(x, scale, out, n, d, eps, vec, warps, groups,
                                  stages, smem, blocks, st)
             : launch_s<T, bf16>(x, scale, out, n, d, eps, vec, warps, groups,
                                 stages, smem, blocks, st);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

int rmsnorm_fwd_max_d() { return kMaxD; }
int rmsnorm_fwd_max_vec_per_lane() { return kMaxVecPerLane; }
int rmsnorm_fwd_stages() { return kStages; }
int rmsnorm_fwd_max_threads() { return kMaxThreads; }
int rmsnorm_fwd_max_bulk_threads() { return kMaxBulkThreads; }
int rmsnorm_fwd_max_smem() { return kMaxSmem; }

const char* rmsnorm_fwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// x, out: [n, d] contiguous device arrays of x_dtype; scale: [d] of
// scale_dtype (0 = float32, 1 = bfloat16). vec, warps, groups, stages,
// smem, blocks: the plan of kernels/rmsnorm.py `fwd_plan`, checked here.
// Launches on `stream` without synchronising and returns
// cudaGetLastError() (cudaErrorInvalidValue for what the kernel does not
// take).
int rmsnorm_fwd(const void* x, const void* scale, void* out, long long n,
                int d, float eps, int x_dtype, int scale_dtype, int vec,
                int warps, int groups, int stages, int smem, int blocks,
                void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (n < 1 || d < 1 || d > kMaxD || (x_dtype != 0 && x_dtype != 1) ||
      (scale_dtype != 0 && scale_dtype != 1))
    return bad;
  const int itemsize = x_dtype == 1 ? 2 : 4;
  const int full = 16 / itemsize;
  if (vec == full) {
    if (d % vec != 0 || !aligned16(x) || !aligned16(out) || stages != kStages)
      return bad;
  } else if (vec != 1 || stages != 0) {
    return bad;
  }
  if (warps < 1 || groups < 1 || groups > kMaxGroups ||
      32 * warps * groups > (vec > 1 ? kMaxBulkThreads : kMaxThreads))
    return bad;
  const int nv = d / vec;
  if ((nv + 32 * warps - 1) / (32 * warps) > kMaxVecPerLane) return bad;
  if (smem != layout(d, itemsize, warps, groups, stages).total ||
      smem > kMaxSmem)
    return bad;
  if (blocks < 1 || static_cast<long long>(blocks - 1) * groups >= n)
    return bad;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t e =
      x_dtype == 1
          ? launch_x<bf16>(x, scale, out, n, d, eps, scale_dtype, vec, warps,
                           groups, stages, smem, blocks, st)
          : launch_x<float>(x, scale, out, n, d, eps, scale_dtype, vec, warps,
                            groups, stages, smem, blocks, st);
  return static_cast<int>(e);
}

}  // extern "C"
