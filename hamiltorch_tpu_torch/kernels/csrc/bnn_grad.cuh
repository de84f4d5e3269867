// The gradient of the one-hidden-layer tanh regression BNN,
//     o = tanh(x W1 + b1) w2 + b2,
//     logp = -tau/2 sum (o - y)^2 - 1/2 |theta|^2,
// for every chain at once, shared by the fused HMC (bnn_hmc.cu) and MCLMC
// (bnn_mclmc.cu) samplers and the one-gradient entry (bnn_grad.cu).
//
// Packed state.  Each chain's parameters lie at a stride of dp floats as
// (W1^T, b1, w2, b2): W1 TRANSPOSED, as H rows of ip floats (ip = I rounded
// up to 4, so that every row starts on 16 bytes, as TMA needs), then b1, w2,
// b2.  Padding slots hold zeros and no kernel writes them.  The logical
// layout (w1 row-major (i, h), b1, w2, b2) exists only at the edges: the
// pack/unpack kernels, the given momenta and normals, and the Philox
// counters, which stay keyed on the logical element index (pair_at).
//
// What bounds it.  Two GEMMs per chain, W1^T x^T (forward) and da^T x
// (backward), each 2 N I H flops: 26.3 GFLOP per gradient for 64 flagship
// chains (N=1024, I=784, H=128).  In float32 FMA that is 0.39 ms at the
// 67 TFLOP/s peak of an H100 SXM (700 W); the products here run on the
// tensor cores in 3xTF32 (three tf32 products per float32 product), 0.16 ms
// at the 495 TFLOP/s dense tf32 peak.  Bytes from device memory are far
// below either.  Shared memory is not: at the tensor cores' peak an SM
// would read ~64 bytes a cycle of B operands (big twice, small once, per k)
// and write and read its A and B tiles besides, about the 128 bytes a cycle
// an SM serves; and the wgmma stream of one warpgroup alone, with its
// register-A loads and splits between groups, does not keep the tensor
// cores full.
//
// 3xTF32.  Each operand a = big + small with big = tf32(a) (round to
// nearest) and small = a - big (exact; the tensor cores read its upper 19
// bits, or it is rounded to tf32 where it is staged), and the product is
// big.big + big.small + small.big (the dropped small.small and small's
// rounding are ~2^-21 of each product).  big.big accumulates in one set of
// registers and the two small products in a second, added once per tile:
// the tensor cores' float32 accumulation truncates, so its error grows with
// the number of additions into one accumulator.
//
// Both GEMMs are m64nNk8 wgmma with A in REGISTERS and B in shared memory:
//   forward   a^T (H, N) = W1^T (H, I) x^T: A = the chain's W1^T rows, B = x
//             (staged and split once per run by stage_x_kernel as (N, ip)
//             big and small, K-major as wgmma wants B);
//   backward  g^T (H, I) = da^T (H, N) x: A = da^T, which the forward writes
//             raw (C, H, np), B = x^T (staged as (I, np) big and small).
// A arrives raw by TMA and each thread splits its own fragment as it loads
// it (tf32_split_alu), so W1^T is split once per tile, by the thread that
// multiplies it, and no barrier runs per k-slice; the forward's accumulator
// comes out as (H, N), the layout da^T is stored in, so da's stores run
// along N, and da^T is half the bytes it was split (32 MiB a flagship
// gradient: it stays in L2 for the backward).
//
// Persistent, warp-specialised blocks.  Each GEMM runs one block of three
// warpgroups per SM (the grid is _plan's in kernels/bnn_grad.py: at most
// one block an SM, as few as keep the longest walk as short).  Block b
// walks tiles b, b + grid, b + 2 grid, ... of a static list ordered by
// chain.  The producer warpgroup gives its registers to the two consumer
// warpgroups (setmaxnreg); in it one thread a ring keeps the ring full
// with TMA, each k-slice (32 floats deep) completing on its own mbarrier
// ("full").  A consumer commits a wgmma group per k8 step (3 products per
// 64-row M block), double-buffers the A fragments across steps
// (wgmma_wait<1> before a buffer is refilled, so two groups are in
// flight), and frees a slice through its "empty" mbarrier (one arrival per
// warp) once the groups that read it have completed.
//
//   forward tile   one chain x FNC = 128 rows of x, all H hidden units in
//                  chunks of HC = 128, shared by the two consumers: consumer
//                  wg multiplies hidden units [64 wg, + 64) of each chunk
//                  over all 128 rows (wgmma N = 128: a wide wgmma beat
//                  consumers on 64-row tiles of their own, whose epilogues
//                  overlapped the other's products).  Both read one ring
//                  of COOP_STAGES slices.  Epilogue: +b1, tanh, o = h w2 +
//                  b2 (a column's hidden units lie over the 8 row groups of
//                  a warp and the warps of both consumers: three shuffles,
//                  then shared memory behind a barrier over the consumers),
//                  the residual, da = d w2 (1 - h^2) stored raw as da^T, and
//                  per-(FN = 64 rows, h) partial sums of h d and da (w2 and
//                  b1 gradients), per 64 rows of d (b2) and resid^2
//                  (likelihood);
//   backward tile  one chain x HB = 64 hidden units x BNB = 112 inputs (784
//                  = 7 x 112), K = N; the consumers take alternate tiles of
//                  the walk, each with a ring of RING slices and a producer
//                  thread of its own, so that one's epilogue overlaps the
//                  other's products.  Epilogue: g = (da^T x)^T - W1 into gr
//                  and partial sums of W1^2 (prior); for HMC the momentum
//                  kick, the next drift and partial sums of the kinetic
//                  energy; for MCLMC (backward_kernel<true>) float64 partial
//                  sums of |g|^2, u.g and |u|^2 against the velocity u.  A
//                  thread's 14 x 2 steps run in BWD_BATCHES batches, each
//                  reading all its W1 and p (HMC) or u (MCLMC) into
//                  registers before its first store: a store to th or p
//                  may alias a later load of the same array as far as the
//                  compiler knows, so step by step each load waited for the
//                  store before it, one memory round trip a step (the two
//                  accumulators are added first, so that a batch fits in
//                  the 168 registers ptxas compiles the kernel to);
//   small_kernel   reduces the partials per chain: the b1/w2/b2 gradients
//                  (with HMC's kick and drift), logp, the kinetic energy
//                  and, in small_kernel<true>, each chain's |g|^2, u.g and
//                  |u|^2 as finished float64 scalars (launch_gradient_dots).
// Every partial sum is reduced inside its warpgroup into a slot fixed by its
// tile, never by the block that ran it, and every reduction has a fixed
// order (wgmma's accumulation order is fixed too), so a run is
// deterministic; no atomics.  logp and the kinetic energy are reduced in
// float64 (at the flagship each is a sum near 5e4, and the samplers use
// differences of such sums).
//
// This design replaced the former one in commit b7e77cb (commit 1efd31b holds it).
#ifndef HAMILTORCH_BNN_GRAD_CUH
#define HAMILTORCH_BNN_GRAD_CUH

#include "common.cuh"

namespace {

constexpr int BM = 64;             // wgmma rows: an M block of hidden units
constexpr int FWD_MB = 2;          // M blocks of a forward tile
constexpr int HC = FWD_MB * BM;    // hidden units of a forward chunk; H must be a multiple
constexpr int FN = 64;             // rows of x of a forward partial-sum slot
constexpr int BWD_MB = 1;          // M blocks of a backward tile
constexpr int HB = BWD_MB * BM;    // hidden units of a backward tile
constexpr int BNB = 112;           // backward tile: inputs (the wgmma N; 784 = 7 x 112)
constexpr int BWD_BATCHES = 2;     // load batches of a backward epilogue (loads, then stores)
constexpr int BK = 32;             // k-depth of a ring slice: 32 floats, one 128-byte swizzle row
constexpr int CONSUMERS = 2;       // consumer warpgroups, each on its own tiles and ring
constexpr int STAGES = 6;          // ring slices in flight, over all consumers
constexpr int FNC = 128;           // forward tile: rows of x, shared by the consumers (wgmma N)
constexpr int COOP_STAGES = 4;     // its ring, read by both consumers
constexpr int NT = 128 * (CONSUMERS + 1);  // threads of a GEMM block
constexpr int RING = STAGES / CONSUMERS;   // stages of one consumer's ring
// Registers a thread: a block launches with LAUNCH_REGS a thread (the most
// __launch_bounds__(NT, 1) allows, which ptxas gives a kernel that uses
// setmaxnreg); the producer then gives back down to PRODUCER_REGS, and the
// consumers can take only what it gave back: setmaxnreg.inc waits, forever,
// for registers that the block does not hold.
constexpr int LAUNCH_REGS = 65536 / NT / 8 * 8;
constexpr int PRODUCER_REGS = 56;
constexpr int CONSUMER_REGS_MAX =
    ((CONSUMERS + 1) * LAUNCH_REGS - PRODUCER_REGS) / CONSUMERS / 8 * 8;
constexpr int CONSUMER_REGS = CONSUMER_REGS_MAX < 240 ? CONSUMER_REGS_MAX : 240;
static_assert(CONSUMERS > 1 && CONSUMER_REGS > LAUNCH_REGS,
              "setmaxnreg moves registers from the producer to two consumer warpgroups");
// A stage: A raw (the M blocks' rows of 32 floats), then B's big and small
// parts (N rows of 32 floats each)
template <int MBX>
__host__ __device__ constexpr int a_tile() { return MBX * BM * BK * 4; }
__host__ __device__ constexpr int b_tile(int n) { return n * BK * 4; }
constexpr int STAGE = a_tile<BWD_MB>() + 2 * b_tile(BNB);             // the backward's rings
constexpr int COOP_STAGE = a_tile<FWD_MB>() + 2 * b_tile(FNC);        // the forward's ring
constexpr int RINGS_BYTES =
    STAGES * STAGE > COOP_STAGES * COOP_STAGE ? STAGES * STAGE : COOP_STAGES * COOP_STAGE;
constexpr int GEMM_SMEM = RINGS_BYTES + 1024;  // + alignment slack
constexpr int EW = 256;   // threads of an elementwise block
constexpr int EW_MAX_BLOCKS = 64;  // elementwise blocks per chain
static_assert(STAGES % CONSUMERS == 0, "the consumers' rings are equal");
static_assert(BNB / 4 % BWD_BATCHES == 0, "a backward epilogue's batches are equal");
static_assert(CONSUMERS * BM == HC && FNC == 2 * FN,
              "a shared forward tile is one M block a consumer and two partial-sum slots of FN "
              "rows");
static_assert(a_tile<1>() % 1024 == 0 && b_tile(FNC) % 1024 == 0 && b_tile(BNB) % 1024 == 0 &&
                  STAGE % 1024 == 0 && COOP_STAGE % 1024 == 0,
              "wgmma tiles start on 1024 bytes");
static_assert(GEMM_SMEM <= 227 * 1024 - 6 * 1024, "the rings fit beside the static shared memory");

long long round_up(long long a, long long m) { return (a + m - 1) / m * m; }

// Sizes of the packed state and of the per-chain partial-sum grids.
struct BnnDims {
  int n, in_dim, hidden, chains;
  int ip, np;        // row strides of W1^T / x and of x^T / da^T: I, N rounded up to 4
  long long d;       // parameters per chain (logical)
  long long w1p;     // floats of the packed W1^T block: hidden * ip
  long long dp;      // stride of a chain's packed state
  int n_tiles;       // forward partial-sum slots of a chain: FN rows of x each
  int fwd_tiles;     // forward tiles of a chain: FNC rows of x each
  int i_tiles;       // BNB-input tiles of the backward
  int bwd_tiles;     // backward tiles of a chain: (H / HB) x i_tiles
  int ew_blocks;
  int fwd_grid, bwd_grid;  // GEMM blocks (set_grids, from the caller's plan)
};

BnnDims make_dims(int n, int in_dim, int hidden, int chains) {
  BnnDims s;
  s.n = n;
  s.in_dim = in_dim;
  s.hidden = hidden;
  s.chains = chains;
  s.ip = (int)round_up(in_dim, 4);
  s.np = (int)round_up(n, 4);
  s.d = (long long)in_dim * hidden + 2LL * hidden + 1;
  s.w1p = (long long)hidden * s.ip;
  s.dp = round_up(s.w1p + 2LL * hidden + 1, 4);
  s.n_tiles = (n + FN - 1) / FN;
  s.fwd_tiles = (n + FNC - 1) / FNC;
  s.i_tiles = (in_dim + BNB - 1) / BNB;
  s.bwd_tiles = s.i_tiles * (hidden / HB);
  long long pairs = (s.d + 1) / 2;
  long long blocks = (pairs + EW - 1) / EW;
  s.ew_blocks = (int)(blocks < EW_MAX_BLOCKS ? blocks : EW_MAX_BLOCKS);
  s.fwd_grid = s.bwd_grid = 0;
  return s;
}

// Takes the plan's grids (kernels/bnn_grad.py::_plan): each GEMM's blocks,
// between 1 and its number of tiles.  False if either is out of range.
bool set_grids(BnnDims& s, int fwd_grid, int bwd_grid) {
  const long long fwd = (long long)s.chains * s.fwd_tiles, bwd = (long long)s.chains * s.bwd_tiles;
  if (fwd >= (1LL << 31) || bwd >= (1LL << 31)) return false;
  if (fwd_grid < 1 || fwd_grid > fwd || bwd_grid < 1 || bwd_grid > bwd) return false;
  s.fwd_grid = fwd_grid;
  s.bwd_grid = bwd_grid;
  return true;
}

// The logical index (w1 (i, h) row-major, b1, w2, b2) of packed slot m, or
// -1 for a padding slot.
__device__ __forceinline__ long long logical_of(long long m, const BnnDims& s) {
  if (m < s.w1p) {
    const long long h = m / s.ip;
    const int i = (int)(m - h * s.ip);
    return i < s.in_dim ? (long long)i * s.hidden + h : -1;
  }
  const long long k = (long long)s.in_dim * s.hidden + (m - s.w1p);
  return k < s.d ? k : -1;
}

// The q-th pair of logical elements (k0, k0 + 1), q < (d + 1) / 2, and
// their packed slots (m1 = -1 past the last element).  Pairs are numbered
// so that consecutive q lie in consecutive slots: in W1 a pair is (i, h),
// (i, h + 1) for even h, q = (h / 2) * I + i.  Random numbers are keyed
// on k0 / 2, the logical pair.  Index is the type q is divided in: long
// long, or unsigned where the caller knows d < 2^31 (a 32-bit division is
// a fraction of a 64-bit one's instructions).
struct Pair {
  long long k0, m0, m1;
};

template <typename Index>
__device__ __forceinline__ Pair pair_at(Index q, const BnnDims& s) {
  const Index w1_pairs = (Index)((long long)s.in_dim * s.hidden / 2);  // hidden is even
  Pair r;
  if (q < w1_pairs) {
    const Index hp = q / (Index)s.in_dim;
    const int i = (int)(q - hp * (Index)s.in_dim);
    r.k0 = (long long)i * s.hidden + 2 * (long long)hp;
    r.m0 = 2 * (long long)hp * s.ip + i;
    r.m1 = r.m0 + s.ip;
  } else {
    r.k0 = 2 * (long long)q;
    r.m0 = s.w1p + (r.k0 - 2 * w1_pairs);
    r.m1 = (r.k0 + 1 < s.d) ? r.m0 + 1 : -1;
  }
  return r;
}

// Bump allocator over the caller's workspace (offsets 256-byte aligned).
struct Arena {
  size_t off = 0;
  size_t take(size_t count, size_t elem) {
    size_t at = off;
    off = (size_t)round_up((long long)(off + count * elem), 256);
    return at;
  }
};

// Device scratch of the gradient: x staged and split once per run, and
// the scratch of one evaluation.
struct GradScratch {
  float *xs, *xts, *dat, *pgw2, *pgb1, *pgb2;
  double *pll, *pprior, *pkin, *pdots;
};

struct GradOffsets {
  size_t xs, xts, dat, pgw2, pgb1, pgb2, pll, pprior, pkin, pdots;
};

GradOffsets take_grad_scratch(Arena& a, const BnnDims& s) {
  const size_t C = s.chains;
  GradOffsets o;
  o.xs = a.take(2 * (size_t)s.n * s.ip, 4);              // (2, N, ip): x big, small
  o.xts = a.take(2 * (size_t)s.in_dim * s.np, 4);        // (2, I, np): x^T big, small
  o.dat = a.take(C * (size_t)s.hidden * s.np, 4);        // (C, H, np): da^T, raw
  o.pgw2 = a.take(C * s.n_tiles * (size_t)s.hidden, 4);
  o.pgb1 = a.take(C * s.n_tiles * (size_t)s.hidden, 4);
  o.pgb2 = a.take(C * s.n_tiles, 4);
  o.pll = a.take(C * s.n_tiles, 8);
  o.pprior = a.take(C * s.bwd_tiles, 8);
  o.pkin = a.take(C * s.bwd_tiles, 8);
  o.pdots = a.take(C * s.bwd_tiles * 3, 8);  // (C, bwd_tiles, 3): |g|^2, u.g, |u|^2
  return o;
}

GradScratch grad_scratch(char* ws, const GradOffsets& o) {
  return GradScratch{(float*)(ws + o.xs),    (float*)(ws + o.xts),     (float*)(ws + o.dat),
                     (float*)(ws + o.pgw2),  (float*)(ws + o.pgb1),    (float*)(ws + o.pgb2),
                     (double*)(ws + o.pll),  (double*)(ws + o.pprior), (double*)(ws + o.pkin),
                     (double*)(ws + o.pdots)};
}

// The TMA descriptors of one run's operands.
struct GradMaps {
  CUtensorMap x;    // (2, N, ip) x split; box 32 x FNC
  CUtensorMap w1t;  // the packed W1^T of every chain of th; box 32 x HC
  CUtensorMap dat;  // (C, H, np) da^T raw; box 32 x HB
  CUtensorMap xt;   // (2, I, np) x^T split; box 32 x BNB
};

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// a float32 tensor of dims (d0, d1, d2), innermost first, rows s1 bytes and
// planes s2 bytes apart, read in 128-byte-swizzled boxes of 32 x rows x 1
int encode_3d(CUtensorMap* map, const void* base, uint64_t d0, uint64_t d1, uint64_t d2,
              uint64_t s1, uint64_t s2, uint32_t rows) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &fn, 12000,
                                                           cudaEnableDefault, &q);
    if (e != cudaSuccess) return (int)e;
    if (q != cudaDriverEntryPointSuccess || !fn) return (int)cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[3] = {d0, d1, d2};
  const cuuint64_t strides[2] = {s1, s2};
  const cuuint32_t box[3] = {(cuuint32_t)BK, rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3, const_cast<void*>(base), dims,
                            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// dst, dst2 (if not null) <- the packed (W1^T, b1, w2, b2) of each chain;
// padding slots get zeros
__global__ void __launch_bounds__(EW) pack_kernel(
    const float* __restrict__ w1, const float* __restrict__ b1, const float* __restrict__ w2,
    const float* __restrict__ b2, float* __restrict__ dst, float* __restrict__ dst2,
    const BnnDims s) {
  const int c = blockIdx.y;
  const long long ih = (long long)s.in_dim * s.hidden;
  for (long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x; m < s.dp;
       m += (long long)gridDim.x * blockDim.x) {
    const long long k = logical_of(m, s);
    float v = 0.f;
    if (k < 0) v = 0.f;
    else if (k < ih) v = w1[c * ih + k];
    else if (k < ih + s.hidden) v = b1[(long long)c * s.hidden + (k - ih)];
    else if (k < ih + 2 * s.hidden) v = w2[(long long)c * s.hidden + (k - ih - s.hidden)];
    else v = b2[c];
    dst[c * s.dp + m] = v;
    if (dst2) dst2[c * s.dp + m] = v;
  }
}

// dst (packed) <- src (C, d) in the logical layout; padding slots get zeros
__global__ void __launch_bounds__(EW) pack_flat_kernel(const float* __restrict__ src,
                                                       float* __restrict__ dst, const BnnDims s) {
  const int c = blockIdx.y;
  for (long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x; m < s.dp;
       m += (long long)gridDim.x * blockDim.x) {
    const long long k = logical_of(m, s);
    dst[c * s.dp + m] = k < 0 ? 0.f : src[c * s.d + k];
  }
}

// dst (C, d) in the logical layout <- src (packed)
__global__ void __launch_bounds__(EW) unpack_flat_kernel(const float* __restrict__ src,
                                                         float* __restrict__ dst,
                                                         const BnnDims s) {
  const int c = blockIdx.y;
  for (long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x; m < s.dp;
       m += (long long)gridDim.x * blockDim.x) {
    const long long k = logical_of(m, s);
    if (k >= 0) dst[c * s.d + k] = src[c * s.dp + m];
  }
}

// (w1, b1, w2, b2) <- theta; out[c] <- per_chain[c] / denom
__global__ void __launch_bounds__(EW) unpack_kernel(
    const float* __restrict__ theta, const double* __restrict__ per_chain, double denom,
    float* __restrict__ w1, float* __restrict__ b1, float* __restrict__ w2, float* __restrict__ b2,
    float* __restrict__ out, const BnnDims s) {
  const int c = blockIdx.y;
  const long long ih = (long long)s.in_dim * s.hidden;
  for (long long m = blockIdx.x * (long long)blockDim.x + threadIdx.x; m < s.dp;
       m += (long long)gridDim.x * blockDim.x) {
    const long long k = logical_of(m, s);
    if (k < 0) continue;
    const float v = theta[c * s.dp + m];
    if (k < ih) w1[c * ih + k] = v;
    else if (k < ih + s.hidden) b1[(long long)c * s.hidden + (k - ih)] = v;
    else if (k < ih + 2 * s.hidden) w2[(long long)c * s.hidden + (k - ih - s.hidden)] = v;
    else b2[c] = v;
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) out[c] = (float)(per_chain[c] / denom);
}

// x (N, I) -> big and small tf32 parts, as (2, N, ip) and transposed (2, I, np)
__global__ void __launch_bounds__(EW) stage_x_kernel(const float* __restrict__ x,
                                                     float* __restrict__ xs,
                                                     float* __restrict__ xts, const BnnDims s) {
  const long long total = (long long)s.n * s.in_dim;
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const int r = (int)(e / s.in_dim), i = (int)(e - (long long)r * s.in_dim);
    float big, small;
    tf32_split(x[e], big, small);
    xs[(long long)r * s.ip + i] = big;
    xs[((long long)s.n + r) * s.ip + i] = small;
    xts[(long long)i * s.np + r] = big;
    xts[((long long)s.in_dim + i) * s.np + r] = small;
  }
}

__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return (unsigned char*)(((uintptr_t)p + 1023) & ~(uintptr_t)1023);
}

// A ring of DEPTH k-slices of STRIDE bytes each, read by READERS consumer
// warpgroups.  A producer thread loads its pos-th slice since the launch
// into stage pos % DEPTH; the consumers wait for it, multiply, and free it.
// Each warpgroup waits on a ring in order.  A wait on an mbarrier's phase
// parity cannot tell a phase from the one two before it, so two consumers
// on different tiles each have a ring and a producer thread of their own
// (Ring); consumers that share every tile share one (CoopRing).
template <int DEPTH, int READERS, int STRIDE>
struct RingOf {
  static constexpr int depth = DEPTH, stride = STRIDE;
  uint64_t full[DEPTH], empty[DEPTH];

  __device__ void init() {  // by one thread, before a __syncthreads
    for (int s = 0; s < DEPTH; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * READERS);  // one arrival per consumer warp
    }
  }
  __device__ void wait_full(int pos) { mbar_wait(&full[pos % DEPTH], (pos / DEPTH) & 1); }
  // a first round's stage is free: the wait on the phase before it returns at once
  __device__ void wait_empty(int pos) { mbar_wait(&empty[pos % DEPTH], ((pos / DEPTH) & 1) ^ 1); }
  __device__ void release(int pos) {  // by every warp of the consumer warpgroups
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[pos % DEPTH]);
  }
};
using Ring = RingOf<RING, 1, STAGE>;
using CoopRing = RingOf<COOP_STAGES, CONSUMERS, COOP_STAGE>;

// The i-th tile of this block's walk over `total` tiles (block b walks b,
// b + grid, b + 2 grid, ...), or -1 past its end.  The list is ordered by
// chain.
__device__ __forceinline__ int block_tile(int i, int total) {
  const long long t = blockIdx.x + (long long)i * gridDim.x;
  return t < total ? (int)t : -1;
}

// The j-th tile that consumer warpgroup wg takes: its consumers take
// alternate tiles of the block's walk.
__device__ __forceinline__ int walk(int wg, int j, int total) {
  return block_tile(wg + CONSUMERS * j, total);
}

// A consumer thread: warpgroup wg, warp w of it, g = lane / 4, t = lane % 4.
// Accumulator element 4 j + 2 r + e of M block m holds row 64 m + 16 w + g
// + 8 r, column 8 j + 2 t + e of the tile.
struct Lane {
  int wg, w, g, t;
};

// This thread's A fragments of k8 step kk of M block m (rows 64 m + 16 w +
// g and + 8, k = 8 kk + t and + 4) from an A tile of 32-float rows as TMA
// writes it with 128-byte swizzling (16-byte unit u of row r lies at unit
// u ^ (r % 8), and r % 8 = g here: no bank conflicts), split into tf32 big
// and small parts as they are read.  g and t come from %laneid each time:
// addresses derived from them once per kernel would be kept for every (m,
// kk), more registers than the accumulators leave.
__device__ __forceinline__ void load_a(const unsigned char* tile, int m, int kk, int w,
                                       uint32_t (&big)[4], uint32_t (&small)[4]) {
  uint32_t lane;
  asm volatile("mov.u32 %0, %%laneid;" : "=r"(lane));
  const int g = lane >> 2;
  const float* a = reinterpret_cast<const float*>(tile) + (m * BM + w * 16 + g) * BK + (lane & 3);
  const int u = ((2 * kk) ^ g) << 2;  // unit 2 kk of row g, in floats; unit 2 kk + 1 is u ^ 4
  const int at[4] = {u, 8 * BK + u, u ^ 4, 8 * BK + (u ^ 4)};
#pragma unroll
  for (int e = 0; e < 4; ++e) tf32_split_alu(a[at[e]], big[e], small[e]);
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t b) {
  static_assert(N == 112 || N == 128, "wgmma_rs: N is 112 or 128");
  if constexpr (N == 128) wgmma_rs_n128(d, a, b);
  else wgmma_rs_n112(d, a, b);
}

// One tile's products over the ring positions pos0 .. pos0 + slices - 1 of
// the ring whose stages start at smem: acc (big.big) and acc_s (big.small +
// small.big) of MBX M blocks of N columns, A from M blocks m0 .. m0 + MBX -
// 1 of each stage's A tile (A_MB M blocks), B's big and small parts (N rows
// of 32 floats each) after A.  One wgmma group per k8 step (3 MBX wgmma);
// the A fragments alternate between two buffers, and a buffer is refilled
// only after the group that read it has completed (wgmma_wait<1>), so two
// groups are in flight.  Frees every slice it reads.
template <int MBX, int N, int A_MB, class R>
__device__ __forceinline__ void products(R& ring, unsigned char* smem, int pos0, int slices, int m0,
                                         const Lane& q, float (&acc)[MBX][N / 2],
                                         float (&acc_s)[MBX][N / 2]) {
  constexpr int A_BYTES = a_tile<A_MB>(), B_TILE = b_tile(N);
  uint32_t ab[2][MBX][4], as[2][MBX][4];
#pragma unroll
  for (int m = 0; m < MBX; ++m) {
#pragma unroll
    for (int k = 0; k < N / 2; ++k) acc[m][k] = acc_s[m][k] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) ab[0][m][e] = ab[1][m][e] = as[0][m][e] = as[1][m][e] = 0u;
  }
  for (int L = 0; L < slices; ++L) {
    const int pos = pos0 + L;
    unsigned char* st = smem + (pos % R::depth) * R::stride;
    ring.wait_full(pos);
    const uint64_t b_big = sw128_desc(st + A_BYTES);
    const uint64_t b_small = sw128_desc(st + A_BYTES + B_TILE);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      const int buf = kk & 1;  // BK / 8 is even: the parity of the step
      wgmma_wait<1>();         // the group of two steps back, which read buffer buf, is done
#pragma unroll
      for (int m = 0; m < MBX; ++m) {
        reg_fence(ab[buf][m]);
        reg_fence(as[buf][m]);
      }
      if (kk == 1 && L > 0) ring.release(pos - 1);  // the last group on slice L - 1 is done
#pragma unroll
      for (int m = 0; m < MBX; ++m) load_a(st, m0 + m, kk, q.w, ab[buf][m], as[buf][m]);
#pragma unroll
      for (int m = 0; m < MBX; ++m) {
        reg_fence(acc[m]);
        reg_fence(acc_s[m]);
      }
      wgmma_fence();
#pragma unroll
      for (int m = 0; m < MBX; ++m) {
        wgmma_rs<N>(acc[m], ab[buf][m], b_big + 2 * kk);
        wgmma_rs<N>(acc_s[m], ab[buf][m], b_small + 2 * kk);
        wgmma_rs<N>(acc_s[m], as[buf][m], b_big + 2 * kk);
      }
      wgmma_commit();
    }
  }
  wgmma_wait<0>();
#pragma unroll
  for (int m = 0; m < MBX; ++m) {
    reg_fence(acc[m]);
    reg_fence(acc_s[m]);
#pragma unroll
    for (int b = 0; b < 2; ++b) {
      reg_fence(ab[b][m]);
      reg_fence(as[b][m]);
    }
  }
  ring.release(pos0 + slices - 1);
}

// The start of a GEMM block: its NRINGS rings initialised, then the roles.
// Returns true in the consumer warpgroups (with their registers raised) and
// false in the producer warpgroup, after its thread p (one a ring) has run
// load(p, ring p, its stages) to the end of its walk.
template <int NRINGS, class R, class Load>
__device__ __forceinline__ bool start_block(R* rings, unsigned char* smem, Load load) {
  if (threadIdx.x < NRINGS) {
    rings[threadIdx.x].init();
    mbar_fence_init();
  }
  __syncthreads();
  if (threadIdx.x >= CONSUMERS * 128) {  // the producer warpgroup
    regs_dec<PRODUCER_REGS>();
    const int p = (threadIdx.x - CONSUMERS * 128) >> 5;  // warp p serves ring p
    if (p < NRINGS && (threadIdx.x & 31) == 0)
      load(p, rings[p], smem + p * R::depth * R::stride);
    return false;
  }
  regs_inc<CONSUMER_REGS>();
  return true;
}

// Forward pass, a^T = W1^T x^T, over the tiles (chain c, rows [FNC lt, +FNC)
// of x) of this block's walk: h = tanh(a + b1), o = h w2 + b2, resid = o -
// y, d = -tau resid, da = d w2 (1 - h^2) into da^T (raw); partial sums of h
// d and da over each FN rows for every h (w2 and b1 gradients), of d (b2
// gradient) and of resid^2.  Rows past N arrive as zeros and have d = 0.
// Both consumer warpgroups work on each tile, consumer wg on hidden units
// [HC ch + BM wg, + BM) of every chunk, so that the wgmma is FNC = 128
// columns wide; they read one ring, and o is summed over both warpgroups'
// warps through shared memory behind a barrier over the consumers.
__global__ void __launch_bounds__(NT, 1) forward_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ y, const float* __restrict__ th, float* __restrict__ dat,
    float* __restrict__ pgw2, float* __restrict__ pgb1, float* __restrict__ pgb2,
    double* __restrict__ pll, const BnnDims s, float tau) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  __shared__ CoopRing ring;
  __shared__ float red_o[2][CONSUMERS][4][FNC];  // o's sums per warp, by the tile's parity
  constexpr int A_BYTES = a_tile<FWD_MB>(), B_TILE = b_tile(FNC), HALF = FNC / 16;

  const int ktiles = (s.in_dim + BK - 1) / BK, nchunks = s.hidden / HC;
  const int slices = nchunks * ktiles, total = s.chains * s.fwd_tiles;
  const bool consumer = start_block<1>(&ring, smem, [&](int, CoopRing& r, unsigned char* stages) {
    int pos = 0;
    for (int i = 0, tile; (tile = block_tile(i, total)) >= 0; ++i) {
      const int c = tile / s.fwd_tiles, n0 = (tile % s.fwd_tiles) * FNC;
      for (int h0 = 0; h0 < s.hidden; h0 += HC)
        for (int k0 = 0; k0 < s.in_dim; k0 += BK, ++pos) {
          r.wait_empty(pos);
          unsigned char* st = stages + (pos % COOP_STAGES) * COOP_STAGE;
          uint64_t* bar = &r.full[pos % COOP_STAGES];
          mbar_expect_tx(bar, a_tile<FWD_MB>() + 2 * B_TILE);
          tma_load_3d(st, &wmap, k0, h0, c, bar);
          tma_load_3d(st + A_BYTES, &xmap, k0, n0, 0, bar);
          tma_load_3d(st + A_BYTES + B_TILE, &xmap, k0, n0, 1, bar);
        }
    }
  });
  if (!consumer) return;

  const int lane = threadIdx.x & 31;
  const Lane q{(int)(threadIdx.x >> 7), (int)((threadIdx.x >> 5) & 3), lane >> 2, lane & 3};
  constexpr int COLS = FNC / 4;  // columns of a thread: 8 jj + 2 t + e
  float acc[1][FNC / 2], acc_s[1][FNC / 2];
  for (int i = 0, tile; (tile = block_tile(i, total)) >= 0; ++i) {
    const int c = tile / s.fwd_tiles, lt = tile % s.fwd_tiles, n0 = lt * FNC;
    const float* b1 = th + c * s.dp + s.w1p;
    const float* w2 = b1 + s.hidden;
    float* dac = dat + (long long)c * s.hidden * s.np;
    float o_part[COLS];  // first written after the first chunk's products: not kept across them
    for (int ch = 0; ch < nchunks; ++ch) {
      const bool last = ch == nchunks - 1;
      products<1, FNC, FWD_MB>(ring, smem, i * slices + ch * ktiles, ktiles, q.wg, q, acc, acc_s);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = ch * HC + q.wg * BM + q.w * 16 + q.g + 8 * r;
        const float b1v = b1[h], w2v = w2[h];
#pragma unroll
        for (int jj = 0; jj < FNC / 8; ++jj)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * jj + 2 * r + e, col = n0 + 8 * jj + 2 * q.t + e;
            const float hv = tanhf((acc[0][k] + acc_s[0][k]) + b1v);
            const float before = (ch == 0 && r == 0) ? 0.f : o_part[2 * jj + e];
            o_part[2 * jj + e] = fmaf(hv, w2v, before);
            if (last) acc[0][k] = hv;
            else if (col < s.n) dac[(long long)h * s.np + col] = hv;
          }
      }
    }
    const int par = i & 1;
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      float v = o_part[k];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (q.g == 0) red_o[par][q.wg][q.w][8 * (k >> 1) + 2 * q.t + (k & 1)] = v;
    }
    named_barrier(1, CONSUMERS * 128);
    const float b2 = w2[s.hidden];
    float dv[COLS];
    float d_sum[2] = {0.f, 0.f};
    double r2_sum[2] = {0.0, 0.0};
#pragma unroll
    for (int k = 0; k < COLS; ++k) {
      const int col = 8 * (k >> 1) + 2 * q.t + (k & 1), row = n0 + col;
      float o = 0.f;
#pragma unroll
      for (int w = 0; w < CONSUMERS; ++w)
        o += ((red_o[par][w][0][col] + red_o[par][w][1][col]) + red_o[par][w][2][col]) +
             red_o[par][w][3][col];
      const float resid = row < s.n ? o + b2 - y[row] : 0.f;
      dv[k] = -tau * resid;
      d_sum[k >= COLS / 2] += dv[k];
      r2_sum[k >= COLS / 2] += (double)resid * resid;
    }
    for (int ch = 0; ch < nchunks; ++ch) {
      const bool last = ch == nchunks - 1;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int h = ch * HC + q.wg * BM + q.w * 16 + q.g + 8 * r;
        const float w2v = w2[h];
        float* row_h = dac + (long long)h * s.np;
        float cw[2] = {0.f, 0.f}, cb[2] = {0.f, 0.f};  // the tile's two slots of FN rows
#pragma unroll
        for (int jj = 0; jj < FNC / 8; ++jj) {
          const int col = n0 + 8 * jj + 2 * q.t, half = jj >= HALF;
          float da2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int k = 4 * jj + 2 * r + e;
            const float hv = last ? acc[0][k] : (col + e < s.n ? row_h[col + e] : 0.f);
            da2[e] = dv[2 * jj + e] * w2v * (1.f - hv * hv);
            cw[half] = fmaf(hv, dv[2 * jj + e], cw[half]);
            cb[half] += da2[e];
          }
          if (col + 1 < s.n)
            *reinterpret_cast<float2*>(row_h + col) = make_float2(da2[0], da2[1]);
          else if (col < s.n)
            row_h[col] = da2[0];
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          cw[hf] += __shfl_xor_sync(0xffffffffu, cw[hf], 1);
          cb[hf] += __shfl_xor_sync(0xffffffffu, cb[hf], 1);
          cw[hf] += __shfl_xor_sync(0xffffffffu, cw[hf], 2);
          cb[hf] += __shfl_xor_sync(0xffffffffu, cb[hf], 2);
          const int slot = 2 * lt + hf;
          if (q.t == 0 && slot < s.n_tiles) {
            const long long at = ((long long)c * s.n_tiles + slot) * s.hidden + h;
            pgw2[at] = cw[hf];
            pgb1[at] = cb[hf];
          }
        }
      }
    }
    if (q.wg == 0 && q.w == 0) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        d_sum[hf] += __shfl_xor_sync(0xffffffffu, d_sum[hf], 1);
        r2_sum[hf] += __shfl_xor_sync(0xffffffffu, r2_sum[hf], 1);
        d_sum[hf] += __shfl_xor_sync(0xffffffffu, d_sum[hf], 2);
        r2_sum[hf] += __shfl_xor_sync(0xffffffffu, r2_sum[hf], 2);
        const int slot = 2 * lt + hf;
        if (lane == 0 && slot < s.n_tiles) {
          pgb2[(long long)c * s.n_tiles + slot] = d_sum[hf];
          pll[(long long)c * s.n_tiles + slot] = r2_sum[hf];
        }
      }
    }
  }
}

// a[0], a[1] with two (8 bytes: a is 8-byte aligned), else a[0], 0
__device__ __forceinline__ float2 load_pair(const float* a, bool two) {
  return two ? *reinterpret_cast<const float2*>(a) : make_float2(a[0], 0.f);
}

// Backward pass, g^T = da^T x, over the tiles (chain c, hidden units
// [HB hb, +HB), inputs [BNB it, +BNB)) of this block's walk: g = (da^T x)^T
// - W1 into gr and partial sums of W1^2 (prior).  With p (HMC): p += kappa
// g, with drift th += eps p, and partial sums of p^2 (kinetic).  DOTS
// (MCLMC, which kicks nothing: p is not read): partial sums of |g|^2, u.g
// and |u|^2 against the velocity u.
// Each tile's sums are reduced inside its warpgroup into the tile's slot.
// PHASES: the first thread of each consumer warpgroup adds the cycles of
// its tiles' products (the waits on the ring included) and of their
// epilogues (from the products' end to the tile's sums written) into
// phases[0] and phases[1] (BWD_PHASES).
enum BwdPhase { kBwdProducts, kBwdEpilogue, BWD_PHASES };
template <bool DOTS, bool PHASES = false>
__global__ void __launch_bounds__(NT, 1) backward_kernel(
    const __grid_constant__ CUtensorMap dmap, const __grid_constant__ CUtensorMap xtmap,
    float* __restrict__ th, float* __restrict__ gr, float* __restrict__ p,
    double* __restrict__ pprior, double* __restrict__ pkin, const float* __restrict__ u,
    double* __restrict__ pdots, const BnnDims s, float kappa, float eps, int drift,
    long long* __restrict__ phases) {
  grid_dependency_wait();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  __shared__ Ring rings[CONSUMERS];
  __shared__ double red[CONSUMERS][2][4][5];  // per-warp sums, by the tile's parity
  constexpr int A_BYTES = a_tile<BWD_MB>(), B_TILE = b_tile(BNB);

  const int slices = (s.n + BK - 1) / BK, total = s.chains * s.bwd_tiles;
  const bool consumer = start_block<CONSUMERS>(rings, smem, [&](int pw, Ring& ring, unsigned char* stages) {
    int pos = 0;
    for (int j = 0, tile; (tile = walk(pw, j, total)) >= 0; ++j) {
      const int c = tile / s.bwd_tiles, lt = tile % s.bwd_tiles;
      const int h0 = (lt / s.i_tiles) * HB, i0 = (lt % s.i_tiles) * BNB;
      for (int k0 = 0; k0 < s.n; k0 += BK, ++pos) {
        ring.wait_empty(pos);
        unsigned char* st = stages + (pos % RING) * STAGE;
        uint64_t* bar = &ring.full[pos % RING];
        mbar_expect_tx(bar, a_tile<BWD_MB>() + 2 * B_TILE);
        tma_load_3d(st, &dmap, k0, h0, c, bar);
        tma_load_3d(st + A_BYTES, &xtmap, k0, i0, 0, bar);
        tma_load_3d(st + A_BYTES + B_TILE, &xtmap, k0, i0, 1, bar);
      }
    }
  });
  if (!consumer) return;

  const int lane = threadIdx.x & 31;
  const Lane q{(int)(threadIdx.x >> 7), (int)((threadIdx.x >> 5) & 3), lane >> 2, lane & 3};
  Ring& ring = rings[q.wg];
  unsigned char* stages = smem + q.wg * RING * STAGE;
  float acc[BWD_MB][BNB / 2], acc_s[BWD_MB][BNB / 2];
  PhaseClock<PHASES, BWD_PHASES> phase_clock(q.w == 0 && lane == 0, phases);
  phase_clock.start();
  for (int j = 0, tile; (tile = walk(q.wg, j, total)) >= 0; ++j) {
    const int c = tile / s.bwd_tiles, lt = tile % s.bwd_tiles;
    const int h0 = (lt / s.i_tiles) * HB, i0 = (lt % s.i_tiles) * BNB;
    products<BWD_MB, BNB, BWD_MB>(ring, stages, j * slices, slices, 0, q, acc, acc_s);
    phase_clock.lap(kBwdProducts);

#pragma unroll
    for (int m = 0; m < BWD_MB; ++m)
#pragma unroll
      for (int k = 0; k < BNB / 2; ++k) acc[m][k] += acc_s[m][k];  // big.big + the small products
    float* W1 = th + c * s.dp;
    float* G1 = gr + c * s.dp;
    float* P1 = !DOTS && p ? p + c * s.dp : nullptr;
    const float* U1 = DOTS ? u + c * s.dp : nullptr;
    double prior = 0.0, kin = 0.0, gg = 0.0, ug = 0.0, uu = 0.0;
    // the tile's steps st = 2 jj + r in BWD_BATCHES batches of SB, every load
    // of a batch before its first store (a store to th or p keeps any load
    // after it from starting before it); each sum's terms in the order of
    // the steps
    constexpr int SB = BNB / 4 / BWD_BATCHES;
#pragma unroll
    for (int m = 0; m < BWD_MB; ++m)
#pragma unroll
      for (int b = 0; b < BWD_BATCHES; ++b) {
        float2 wv[SB], uv[SB], pv[SB];
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          const int st = b * SB + i;
          const int in = i0 + 8 * (st >> 1) + 2 * q.t;  // even, and ip is a multiple of 4
          if (in >= s.in_dim) continue;
          const long long at = (long long)(h0 + m * BM + q.w * 16 + q.g + 8 * (st & 1)) * s.ip + in;
          const bool two = in + 1 < s.in_dim;  // then 8-byte accesses
          wv[i] = load_pair(W1 + at, two);
          if constexpr (DOTS) uv[i] = load_pair(U1 + at, two);
          if (P1) pv[i] = load_pair(P1 + at, two);
        }
#pragma unroll
        for (int i = 0; i < SB; ++i) {
          const int st = b * SB + i, k = 2 * st;  // k = 4 jj + 2 r
          const int in = i0 + 8 * (st >> 1) + 2 * q.t;
          if (in >= s.in_dim) continue;
          const long long at = (long long)(h0 + m * BM + q.w * 16 + q.g + 8 * (st & 1)) * s.ip + in;
          const bool two = in + 1 < s.in_dim;
          const float2 w = wv[i];
          const float2 gv = make_float2(acc[m][k] - w.x, acc[m][k + 1] - w.y);
          if (two) *reinterpret_cast<float2*>(G1 + at) = gv;
          else G1[at] = gv.x;
          prior += (double)w.x * w.x;
          prior += (double)w.y * w.y;
          if constexpr (DOTS) {
            const float gy = two ? gv.y : 0.f;
            gg += (double)gv.x * gv.x;
            gg += (double)gy * gy;
            ug += (double)uv[i].x * gv.x;
            ug += (double)uv[i].y * gy;
            uu += (double)uv[i].x * uv[i].x;
            uu += (double)uv[i].y * uv[i].y;
          }
          if (P1) {
            float2 pn = pv[i];
            pn.x = fmaf(kappa, gv.x, pn.x);
            pn.y = two ? fmaf(kappa, gv.y, pn.y) : 0.f;
            kin += (double)pn.x * pn.x;
            kin += (double)pn.y * pn.y;
            const float2 wn = make_float2(fmaf(eps, pn.x, w.x), fmaf(eps, pn.y, w.y));
            if (two) {
              *reinterpret_cast<float2*>(P1 + at) = pn;
              if (drift) *reinterpret_cast<float2*>(W1 + at) = wn;
            } else {
              P1[at] = pn.x;
              if (drift) W1[at] = wn.x;
            }
          }
        }
      }

    // the tile's sums: each warp's by shuffles, then the warpgroup's 4 warps in order
    const int par = j & 1;
    const double sums[5] = {warp_sum(prior), warp_sum(kin), DOTS ? warp_sum(gg) : 0.0,
                            DOTS ? warp_sum(ug) : 0.0, DOTS ? warp_sum(uu) : 0.0};
    if (lane == 0)
#pragma unroll
      for (int v = 0; v < 5; ++v) red[q.wg][par][q.w][v] = sums[v];
    named_barrier(1 + q.wg, 128);
    if (q.w == 0 && lane == 0) {
      double tot[5];
#pragma unroll
      for (int v = 0; v < 5; ++v)
        tot[v] = ((red[q.wg][par][0][v] + red[q.wg][par][1][v]) + red[q.wg][par][2][v]) +
                 red[q.wg][par][3][v];
      const long long at = (long long)c * s.bwd_tiles + lt;
      pprior[at] = tot[0];
      pkin[at] = tot[1];
      if constexpr (DOTS) {
        pdots[3 * at] = tot[2];
        pdots[3 * at + 1] = tot[3];
        pdots[3 * at + 2] = tot[4];
      }
    }
    phase_clock.lap(kBwdEpilogue);
  }
  phase_clock.flush();
}

// Per chain (one block each): the b1, w2, b2 gradients from the forward's
// partials, logp at th and, with p (HMC), their kick (and drift) and the
// kinetic energy of p.  DOTS (MCLMC): the chain's |g|^2, u.g and |u|^2
// against the velocity u into dots (C, 3), the backward's partials added in
// a fixed order.
template <bool DOTS>
__global__ void small_kernel(float* __restrict__ th, float* __restrict__ gr, float* __restrict__ p,
                             const float* __restrict__ pgw2, const float* __restrict__ pgb1,
                             const float* __restrict__ pgb2, const double* __restrict__ pll,
                             const double* __restrict__ pprior, const double* __restrict__ pkin,
                             double* __restrict__ logp_prop, double* __restrict__ kin_prop,
                             const float* __restrict__ u, const double* __restrict__ pdots,
                             double* __restrict__ dots, const BnnDims s, float tau, float kappa,
                             float eps, int drift) {
  if constexpr (DOTS) grid_dependency_wait();
  const int c = blockIdx.x, hidden = s.hidden, n_tiles = s.n_tiles, bwd_tiles = s.bwd_tiles;
  const long long base = c * s.dp + s.w1p;  // b1, then w2, then b2
  double prior = 0.0, kin = 0.0, ll = 0.0, gg = 0.0, ug = 0.0, uu = 0.0;

  auto update = [&](long long k, float partial) {
    const float v = th[k];
    const float g = partial - v;
    gr[k] = g;
    prior += (double)v * v;
    if constexpr (DOTS) {
      const float uv = u[k];
      gg += (double)g * g;
      ug += (double)uv * g;
      uu += (double)uv * uv;
    }
    if (p) {
      const float pv = fmaf(kappa, g, p[k]);
      p[k] = pv;
      kin += (double)pv * pv;
      if (drift) th[k] = fmaf(eps, pv, v);
    }
  };

  for (int j = threadIdx.x; j < hidden; j += blockDim.x) {
    float sb = 0.f, sw = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      const long long at = ((long long)c * n_tiles + t) * hidden + j;
      sb += pgb1[at];
      sw += pgw2[at];
    }
    update(base + j, sb);
    update(base + hidden + j, sw);
  }
  if (threadIdx.x == 0) {
    float sum = 0.f;
    for (int t = 0; t < n_tiles; ++t) {
      sum += pgb2[(long long)c * n_tiles + t];
      ll += pll[(long long)c * n_tiles + t];
    }
    update(base + 2 * hidden, sum);
    for (int b = 0; b < bwd_tiles; ++b) {
      prior += pprior[(long long)c * bwd_tiles + b];
      if (p) kin += pkin[(long long)c * bwd_tiles + b];
      if constexpr (DOTS) {
        const double* pd = pdots + 3 * ((long long)c * bwd_tiles + b);
        gg += pd[0];
        ug += pd[1];
        uu += pd[2];
      }
    }
  }
  prior = block_sum(prior);
  kin = block_sum(kin);
  if constexpr (DOTS) {
    gg = block_sum(gg);
    ug = block_sum(ug);
    uu = block_sum(uu);
  }
  if (threadIdx.x == 0) {
    logp_prop[c] = -0.5 * (double)tau * ll - 0.5 * prior;
    if (kin_prop) kin_prop[c] = 0.5 * kin;
    if constexpr (DOTS) {
      dots[3 * c] = gg;
      dots[3 * c + 1] = ug;
      dots[3 * c + 2] = uu;
    }
  }
}

// cudaSuccess if the GEMM kernel launches with the registers that
// start_block's setmaxnreg moves assume (else its consumers'
// setmaxnreg.inc would never return).
int check_registers(const void* kernel) {
  cudaFuncAttributes a;
  const cudaError_t e = cudaFuncGetAttributes(&a, kernel);
  if (e != cudaSuccess) return (int)e;
  return a.numRegs == LAUNCH_REGS ? 0 : (int)cudaErrorInvalidConfiguration;
}

// The GEMM kernel's launch registers checked and its shared-memory
// allowance set.  Returns a cudaError_t.
int allow_gemm(const void* kernel) {
  int err;
  if ((err = check_registers(kernel)) != 0) return err;
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   GEMM_SMEM);
}

// Once per run, before anything is launched (the host's part of
// prepare_gradient): the GEMM kernels' registers and shared-memory allowance
// (with phases, of the backward that counts them too) and the TMA
// descriptors of the operands (W1^T read from th).  Returns a cudaError_t.
int prepare_gradient_maps(const BnnDims& s, const float* th, const GradScratch& w, GradMaps* m,
                          bool phases = false) {
  int err;
  if ((err = allow_gemm((const void*)forward_kernel)) != 0) return err;
  if ((err = allow_gemm((const void*)backward_kernel<false>)) != 0) return err;
  if ((err = allow_gemm((const void*)backward_kernel<true>)) != 0) return err;
  if (phases) {
    if ((err = allow_gemm((const void*)backward_kernel<false, true>)) != 0) return err;
    if ((err = allow_gemm((const void*)backward_kernel<true, true>)) != 0) return err;
  }
  const uint64_t f = sizeof(float);
  if ((err = encode_3d(&m->x, w.xs, s.in_dim, s.n, 2, s.ip * f, (uint64_t)s.n * s.ip * f,
                       FNC)) != 0)
    return err;
  if ((err = encode_3d(&m->w1t, th, s.in_dim, s.hidden, s.chains, s.ip * f, s.dp * f, HC)) != 0)
    return err;
  if ((err = encode_3d(&m->dat, w.dat, s.n, s.hidden, s.chains, s.np * f,
                       (uint64_t)s.hidden * s.np * f, HB)) != 0)
    return err;
  return encode_3d(&m->xt, w.xts, s.n, s.in_dim, 2, s.np * f, (uint64_t)s.in_dim * s.np * f,
                   BNB);
}

// x staged and split into the workspace (the device's part of
// prepare_gradient).  Returns the launch's cudaError_t.
int stage_x(const BnnDims& s, const float* x, const GradScratch& w, cudaStream_t stream) {
  const long long elems = (long long)s.n * s.in_dim;
  const int blocks = (int)((elems + EW - 1) / EW < 1024 ? (elems + EW - 1) / EW : 1024);
  LAUNCH(stage_x_kernel<<<blocks, EW, 0, stream>>>(x, w.xs, w.xts, s));
  return 0;
}

// Once per run, before the first gradient: prepare_gradient_maps, then
// stage_x.  Returns a cudaError_t.
int prepare_gradient(const BnnDims& s, const float* x, const float* th, const GradScratch& w,
                     GradMaps* m, cudaStream_t stream) {
  int err;
  if ((err = prepare_gradient_maps(s, th, w, m)) != 0) return err;
  return stage_x(s, x, w, stream);
}

// One gradient evaluation at th (the buffer prepare_gradient described) for
// every chain, on the grids set_grids took: the gradient into gr and logp
// into logp_prop.  With p (HMC) the evaluation also kicks p by kappa g,
// drifts th by eps p when drift is set, and writes 0.5 |p|^2 to kin_prop.
// With phases (device memory, BWD_PHASES counters), the backward adds its
// phases' cycles into them.  Returns the first launch error as a
// cudaError_t (0 on success).
int launch_gradient(const BnnDims& s, const GradMaps& m, const float* y, float* th, float* gr,
                    float* p, const GradScratch& w, double* logp_prop, double* kin_prop,
                    float tau, float kappa, float eps, int drift, cudaStream_t stream,
                    long long* phases = nullptr) {
  LAUNCH(forward_kernel<<<s.fwd_grid, NT, GEMM_SMEM, stream>>>(
      m.x, m.w1t, y, th, w.dat, w.pgw2, w.pgb1, w.pgb2, w.pll, s, tau));
  if (phases)
    LAUNCH(backward_kernel<false, true><<<s.bwd_grid, NT, GEMM_SMEM, stream>>>(
        m.dat, m.xt, th, gr, p, w.pprior, w.pkin, nullptr, nullptr, s, kappa, eps, drift, phases));
  else
    LAUNCH(backward_kernel<false><<<s.bwd_grid, NT, GEMM_SMEM, stream>>>(
        m.dat, m.xt, th, gr, p, w.pprior, w.pkin, nullptr, nullptr, s, kappa, eps, drift,
        nullptr));
  LAUNCH(small_kernel<false><<<s.chains, 128, 0, stream>>>(
      th, gr, p, w.pgw2, w.pgb1, w.pgb2, w.pll, w.pprior, w.pkin, logp_prop, kin_prop, nullptr,
      nullptr, nullptr, s, tau, kappa, eps, drift));
  return 0;
}

// MCLMC's evaluation (no kick): launch_gradient's gradient into gr and logp
// into logp_prop, and each chain's |g|^2, u.g and |u|^2 against the velocity
// u into dots (C, 3), in float64.  The backward and small kernels are
// programmatic dependent launches (launch_ex).  phases as
// launch_gradient's.  Returns the first launch error as a cudaError_t (0 on
// success).
int launch_gradient_dots(const BnnDims& s, const GradMaps& m, const float* y, float* th, float* gr,
                         const float* u, const GradScratch& w, double* logp_prop, double* dots,
                         float tau, cudaStream_t stream, long long* phases = nullptr) {
  LAUNCH(forward_kernel<<<s.fwd_grid, NT, GEMM_SMEM, stream>>>(
      m.x, m.w1t, y, th, w.dat, w.pgw2, w.pgb1, w.pgb2, w.pll, s, tau));
  int err;
  if ((err = launch_ex(phases ? backward_kernel<true, true> : backward_kernel<true>,
                       dim3(s.bwd_grid), NT, GEMM_SMEM, stream, m.dat, m.xt, th, gr,
                       (float*)nullptr, w.pprior, w.pkin, u, w.pdots, s, 0.f, 0.f, 0,
                       phases)) != 0)
    return err;
  return launch_ex(small_kernel<true>, s.chains, 128, 0, stream, th, gr, (float*)nullptr, w.pgw2,
                   w.pgb1, w.pgb2, w.pll, w.pprior, w.pkin, logp_prop, (double*)nullptr, u, w.pdots,
                   dots, s, tau, 0.f, 0.f, 0);
}

}  // namespace

#endif  // HAMILTORCH_BNN_GRAD_CUH
