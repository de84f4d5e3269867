// Pieces shared by the port's hand-written Hopper kernels: the counter-based
// random numbers (Philox4x32-10, Box-Muller) that replace the TPU's on-core
// PRNG, fixed-order float64 reductions over a warp or a block (a fixed
// order makes every run deterministic), and Hopper's asynchronous machinery
// as inline PTX: mbarriers, TMA tile loads, cp.async, wgmma and mma.sync on
// tf32 operands, the split of a float into two tf32 parts, register
// rebalancing between warpgroups (setmaxnreg), a barrier over the blocks of
// a cooperative launch, and programmatic dependent launches; and the
// accounting that the recorder (utils/profiling.py) reads: a C entry's
// launches on the host, a kernel's phases on the device.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: no libcuda link)
#include <cuda_runtime.h>
#include <stdint.h>
#include <time.h>

namespace {

__device__ __forceinline__ uint4 philox(uint4 ctr, uint2 key) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    const uint32_t lo0 = 0xD2511F53u * ctr.x, hi0 = __umulhi(0xD2511F53u, ctr.x);
    const uint32_t lo1 = 0xCD9E8D57u * ctr.z, hi1 = __umulhi(0xCD9E8D57u, ctr.z);
    ctr = make_uint4(hi1 ^ ctr.y ^ key.x, lo1, hi0 ^ ctr.w ^ key.y, lo0);
    key.x += 0x9E3779B9u;
    key.y += 0xBB67AE85u;
  }
  return ctr;
}

// uniform in (0, 1), never 0 or 1
__device__ __forceinline__ float uniform01(uint32_t bits) {
  return ((float)(bits >> 8) + 0.5f) * (1.0f / 16777216.0f);
}

// two standard normals from the first two words of a Philox draw
__device__ __forceinline__ float2 box_muller(uint4 r) {
  const float rad = sqrtf(-2.0f * logf(uniform01(r.x)));
  float s, co;
  sincospif(2.0f * uniform01(r.y), &s, &co);
  return make_float2(rad * co, rad * s);
}

// the Philox key of a 64-bit seed
inline uint2 seed_key(unsigned long long seed) {
  return make_uint2((uint32_t)seed, (uint32_t)(seed >> 32));
}

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over each aligned group of G lanes (G a power of two up to 32), the
// same in every lane of the group; no shuffle at all for G = 1.  Every lane
// of the warp must call it.
template <int G>
__device__ __forceinline__ double group_sum(double v) {
#pragma unroll
  for (int off = G / 2; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum over a block of blockDim.x (a multiple of 32, at most 1024) threads;
// the result is valid in thread 0.  Safe to call more than once per kernel.
__device__ double block_sum(double v) {
  __shared__ double part[32];
  __syncthreads();
  v = warp_sum(v);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) part[warp] = v;
  __syncthreads();
  v = (threadIdx.x < (blockDim.x >> 5)) ? part[threadIdx.x] : 0.0;
  if (warp == 0) v = warp_sum(v);
  return v;
}

// ---- tf32 split (3xTF32) ----

// a rounded to tf32 (10 mantissa bits, to nearest, ties away from zero),
// held in a float whose low 13 bits are zero
__device__ __forceinline__ float tf32_round(float a) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(a));
  return __uint_as_float(r);
}

// a = big + small exactly up to small's own tf32 rounding: big = tf32(a),
// small = tf32(a - big) (a - big is exact in float32)
__device__ __forceinline__ void tf32_split(float a, float& big, float& small) {
  big = tf32_round(a);
  small = tf32_round(a - big);
}

// d (16 x 8) += a (16 x 8, row-major) b (8 x 8), tf32 operands given as bit
// patterns, in the register layout of mma.sync.m16n8k8 (g = lane / 4,
// t = lane % 4): a[0..3] = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
// b0, b1 = B[t][g], B[t+4][g]; d[0..3] = D[g][2t], D[g][2t+1], D[g+8][2t],
// D[g+8][2t+1]
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The split by integer arithmetic on the bit pattern: big as tf32_split's
// (add half a tf32 ulp to the magnitude, clear the low 13 bits: what
// cvt.rna.tf32.f32 gives for finite a); small = a - big is exact and left
// unrounded, the tensor cores reading only its upper 19 bits (a truncation
// below 2^-21 |a|).  cvt.rna.tf32.f32 issues at the conversion unit's rate,
// a fraction of the ALU's: a loop that splits an operand per mma is bound
// by it.
__device__ __forceinline__ void tf32_split_alu(float a, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(a) + 0x1000u) & 0xFFFFE000u;
  small = __float_as_uint(a - __uint_as_float(big));
}

// ---- mbarriers and TMA ----

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(bar)) : "memory");
}

// one arrival that also announces `bytes` of TMA transfers to wait for
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// wait until the phase of parity `parity` has completed; a wait that lasts
// 2^35 SM cycles (~17 s) traps, so that a lost arrival fails the launch
// instead of hanging it
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  long long start = 0;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (start == 0) start = clock64();
    else if (clock64() - start > (1LL << 35)) __trap();
  }
}

// TMA: the box at (c0, c1, c2) of the tensor `map` into shared memory at
// dst, completing on bar (out-of-range elements arrive as zeros)
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4}], [%5];" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(smem_addr(bar))
      : "memory");
}

// orders this thread's plain shared-memory writes before later reads by
// the async proxy (wgmma operands, TMA overwrites)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier over the first `count` threads of the block (id 0 is __syncthreads)
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ---- cp.async: 16 bytes a thread from device to shared memory, through L2 only ----

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most N committed groups of this thread's copies are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// ---- a C entry's launch accounting, on the host ----

// The array a C entry's caller may pass (utils/profiling.py's LAUNCH_STATS):
// the operations queued on the stream (kernels, memsets and copies; a graph
// launch counts the kernels it holds), the host ns spent inside the launch
// statements (where the host waits for room in the launch queue; the
// cudaGetLastError after a launch is outside), the ns from the entry to its
// first launch, and the entry's own time, all on CLOCK_MONOTONIC (Python's
// perf_counter_ns).  With no array nothing reads the clock.
enum HostStat { kLaunches, kLaunchNs, kPrologueNs, kEntryNs, kHostStats };

thread_local long long* host_stats = nullptr;

inline long long host_ns() {
  timespec t;
  clock_gettime(CLOCK_MONOTONIC, &t);
  return t.tv_sec * 1000000000LL + t.tv_nsec;
}

// For the duration of a C entry: its array (null: none) zeroed and stamped.
struct HostStatsScope {
  explicit HostStatsScope(long long* stats) {
    if (stats) {
      for (int i = 0; i < kHostStats; ++i) stats[i] = 0;
      stats[kEntryNs] = host_ns();
    }
    host_stats = stats;
  }
  ~HostStatsScope() { host_stats = nullptr; }
};

// For the duration of a stream capture: its launches are counted into
// `into` (zeroed by the caller), not as queued.
struct CaptureStats {
  long long* saved;
  explicit CaptureStats(long long* into) : saved(host_stats) {
    if (host_stats) host_stats = into;
  }
  ~CaptureStats() { host_stats = saved; }
};

inline long long launch_begin() { return host_stats ? host_ns() : 0; }

// after a launch statement that began at t0 and queued n operations
inline void launch_end(long long t0, long long n = 1) {
  if (!host_stats) return;
  const long long t1 = host_ns();
  if (host_stats[kLaunches] == 0) host_stats[kPrologueNs] = t0 - host_stats[kEntryNs];
  host_stats[kLaunches] += n;
  host_stats[kLaunchNs] += t1 - t0;
}

// call() (a launch, memset, copy or graph launch that queues n operations
// and returns a cudaError_t), accounted; returns its error as an int
template <typename Call>
int queued(Call&& call, long long n = 1) {
  const long long t0 = launch_begin();
  const int err = (int)call();
  launch_end(t0, n);
  return err;
}

// ---- a kernel's phase cycles, on the device ----

// Per-phase SM cycles (clock64) that a thread adds up in registers as it
// passes the kernel's phase boundaries: lap(p) gives phase p (a constant)
// the cycles since the last lap or start(); flush adds the owner thread's
// sums into the kernel's N device counters, one atomicAdd each.  With ON
// false every call compiles to nothing, so the kernel is the one built
// without counters.
template <bool ON, int N>
struct PhaseClock {
  long long sum[N] = {}, last = 0;
  long long* counters;  // the owner's device counters; null in the other threads

  __device__ __forceinline__ PhaseClock(bool owner, long long* counters_)
      : counters(owner ? counters_ : nullptr) {}
  __device__ __forceinline__ void start() {
    if constexpr (ON) last = clock64();
  }
  __device__ __forceinline__ void lap(int p) {
    if constexpr (ON) {
      const long long t = clock64();
      sum[p] += t - last;
      last = t;
    }
  }
  __device__ __forceinline__ void flush() {
    if constexpr (ON) {
      if (counters)
#pragma unroll
        for (int i = 0; i < N; ++i)
          atomicAdd(reinterpret_cast<unsigned long long*>(counters) + i,
                    (unsigned long long)sum[i]);
    }
  }
};

// ---- programmatic dependent launch ----

// Waits until the grid before this one on the stream has finished and its
// writes are visible.  A kernel that launch_ex may start as a programmatic
// dependent calls it before it touches device memory; in a kernel launched
// otherwise it returns at once.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Launches kernel<<<grid, block, smem, stream>>>(args...) as a programmatic
// dependent launch, which the card may start while the grid before it on the
// stream finishes (the kernel must call grid_dependency_wait first).
// Returns the launch's cudaError_t.
template <typename... Params, typename... Args>
int launch_ex(void (*kernel)(Params...), dim3 grid, dim3 block, size_t smem, cudaStream_t stream,
              Args... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return queued([&] { return cudaLaunchKernelEx(&cfg, kernel, args...); });
}

// ---- a barrier over every block of a cooperative launch ----

// Every block waits until all gridDim.x blocks have arrived.  `count` starts
// at 0 before the launch and only grows; `target` is the block's own tally
// of the arrivals expected so far (the same in every block).  Writes before
// the barrier are visible after it to every block (reads of data that
// other blocks wrote must still bypass L1: ld.global.cg or cp.async.cg).
// A cooperative launch has every block resident, so only blocks that call
// it a different number of times can keep one waiting: after ~2^26 polls
// (seconds) it traps, and the launch fails instead of hanging.
__device__ __forceinline__ void grid_barrier(unsigned int* count, unsigned int& target) {
  __syncthreads();
  target += gridDim.x;
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(count, 1u);
    unsigned int seen, polls = 0;
    do {
      asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(seen) : "l"(count) : "memory");
      if (++polls == (1u << 26)) __trap();
    } while ((int)(seen - target) < 0);
    __threadfence();
  }
  __syncthreads();
}

// ---- wgmma ----

// Descriptor of a K-major operand tile in shared memory laid out as TMA
// writes it with 128-byte swizzling: rows of 32 floats (128 bytes), 8-row
// groups 1024 bytes apart; the tile must start on a 1024-byte boundary.
// Adding 2 to the descriptor advances it by one k8 slice (32 bytes).
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  uint64_t d = (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4);
  d |= (uint64_t)1 << 16;            // leading byte offset (unused when swizzled)
  d |= (uint64_t)(1024 >> 4) << 32;  // stride byte offset: 8 rows of 128 bytes
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most N committed wgmma groups of this warp are pending
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma that owns them
template <int R>
__device__ __forceinline__ void reg_fence(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// acc (m64 x n112, the wgmma register layout) += A (64 x 8) B^T (8 x 112): A
// in registers as tf32 bit patterns, per warp of the warpgroup its 16 rows
// in mma.sync.m16n8k8's fragment (g = lane / 4, t = lane % 4: a[0..3] =
// A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4]); B a K-major tf32 tile in
// 128-byte-swizzled shared memory, given by its descriptor.  The registers
// of a must not change until the wgmma group that reads them has completed.
__device__ __forceinline__ void wgmma_rs_n112(float (&d)[56], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %61, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, {%56, %57, %58, %59}, %60, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// wgmma_rs_n112 at N = 128: acc (m64 x n128) += A (64 x 8, registers) B^T (8 x 128)
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// keeps the compiler from reusing registers that an asynchronous wgmma
// still reads (its A operand) before the wait that completes it
template <int R>
__device__ __forceinline__ void reg_fence(uint32_t (&a)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

// ---- register rebalancing between the warpgroups of a block (sm_90a) ----

// every warp of the calling warpgroup gives up registers down to R a thread
template <int R>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

// every warp of the calling warpgroup takes registers up to R a thread
template <int R>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

}  // namespace

#define LAUNCH_CHECK()                        \
  do {                                        \
    const cudaError_t e_ = cudaGetLastError(); \
    if (e_ != cudaSuccess) return (int)e_;    \
  } while (0)

// `launch;` (a kernel<<<...>>>(...) statement), accounted, then its
// LAUNCH_CHECK
#define LAUNCH(...)                          \
  do {                                       \
    const long long t_ = launch_begin();     \
    __VA_ARGS__;                             \
    launch_end(t_);                          \
    LAUNCH_CHECK();                          \
  } while (0)
