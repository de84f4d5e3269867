// The BNN gradient as the package ran it before its GEMMs became persistent
// and warp-specialised: hamiltorch_tpu_torch/kernels/csrc/bnn_grad.cuh as
// of commit 1efd31b, kept for scripts/bnn_gemm_variants_torch.py to time
// beside the package's design.  No part of the package.  It defines the package
// header's guard, so that a source of the package included after it
// (scripts/csrc/bnn_former_*.cu) runs on this gradient: make_dims,
// set_grids (here a no-op: the former grids follow from the shapes),
// prepare_gradient, launch_gradient and launch_gradient_dots keep the
// package's signatures.  What follows is the former header's own note.
//
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
// What bounds it.  Two GEMMs per chain, x W1 (forward) and x^T da
// (backward), each 2 N I H flops: 26.3 GFLOP per gradient for 64 flagship
// chains (N=1024, I=784, H=128).  In float32 FMA that is 0.39 ms at the
// 67 TFLOP/s peak of an H100 SXM (700 W); the products here run on the
// tensor cores in 3xTF32 (three tf32 products per float32 product), 0.16 ms
// at the 495 TFLOP/s dense tf32 peak.  Bytes are far below either.
//
// What the design does.  3xTF32 keeps float32 accuracy on tf32 tensor
// cores: each operand a = big + small with big = tf32(a), small =
// tf32(a - big), and the product is big.big + big.small + small.big (the
// dropped small.small and the rounding of small are ~2^-21 of each
// product).  A single tf32 product keeps ~3 digits, too few for the
// samplers' 1e-5 gates.  big.big accumulates in one set of registers and
// the two small products in a second, added once per tile: the tensor
// cores' float32 accumulation truncates, so its error grows with the
// number of additions into one accumulator (on an H100 the second set cut
// the flagship gradient's error against float64 from 6.2e-6 to 2.1e-6 of
// max |g| at no measurable cost; float32 cuBLAS: 3.4e-7).  wgmma reads
// tf32 operands only K-major from shared memory, so:
//   - x is split and staged once per run (stage_x_kernel) as x (N, ip)
//     and x^T (I, np), big and small parts each;
//   - the forward epilogue writes da already transposed and split,
//     da^T (H, np) big and small per chain: the backward's A operand;
//   - W1 changes every step and is kept transposed in the packed state,
//     which makes it the forward's K-major B operand as it lies; its tiles
//     arrive raw and are split in shared memory by the block.
// Each GEMM block is two warpgroups (256 threads), each with its own 64 A
// rows, sharing the B slices (the L2 traffic per FLOP is what bounds the
// smaller one-warpgroup block: on an H100 the flagship pair took 0.75 ms
// with it, 0.45 ms with two; scripts/bnn_gemm_variants_torch.py).
// Thread 0 keeps a ring of STAGES k-slices (32 floats deep: one 128-byte
// swizzle row) in flight with TMA, each slice completing on its own
// mbarrier ("full"); the warpgroups run 12 wgmma each (4 k8 steps x 3
// products) on a slice while later slices load, and free the slice through
// a second mbarrier ("empty", one arrival per warp once its wgmmas on it
// are done) before thread 0 refills it.  No __syncthreads runs per
// k-slice; the forward's in-place split of the shared W1^T slice needs one
// block barrier per slice.  Both GEMMs run one block per SM (~193 and
// ~181 KB of shared memory), so each block's epilogue leaves the tensor
// cores idle: later work.
//
// One evaluation is three launches (launch_gradient):
//   forward_kernel   block = 128 rows of x (64 per warpgroup) x one chain;
//                    64 x 128 wgmma tiles over H in chunks of 128.  Its
//                    epilogue fuses +b1, tanh, the w2 row reduction into o
//                    (a warpgroup covers all H columns of its rows, and a
//                    row of the accumulator lies in one quad of lanes: two
//                    shuffles), the residual, da = d w2 (1 - h^2) written
//                    as da^T big/small, and per-64-row-tile partial sums for
//                    the b1, w2, b2 gradients and the likelihood;
//   backward_kernel  block = 128 hidden units (64 per warpgroup) x 112
//                    inputs x one chain (784 = 7 x 112), g^T = da^T x over
//                    K = N; its epilogue writes the W1 gradient (g - W1) and
//                    partial sums of the prior, and, for HMC, fuses the
//                    momentum kick, the next drift and partial sums of the
//                    kinetic energy; for MCLMC (backward_kernel<true>) it
//                    reads the velocity u at the slots it writes and adds
//                    float64 partial sums of |g|^2, u.g and |u|^2 instead;
//   small_kernel     reduces the partials per chain: the b1/w2/b2 gradients
//                    (with HMC's kick and drift), logp and the kinetic energy;
//                    small_kernel<true> also adds the b1/w2/b2 terms of the
//                    three dots and reduces each chain's |g|^2, u.g and |u|^2
//                    to finished float64 scalars (launch_gradient_dots), so
//                    that a rotation reads three numbers a chain and never
//                    re-reads g for its dots.
// Every reduction has a fixed order (wgmma's accumulation order is fixed
// too), so a run is deterministic.  logp and the kinetic energy are reduced
// in float64 (at the flagship each is a sum near 5e4, and the samplers use
// differences of such sums).
#pragma once
#define HAMILTORCH_BNN_GRAD_CUH

#include "../../hamiltorch_tpu_torch/kernels/csrc/common.cuh"

namespace {

// acc (m64 x n128, the wgmma register layout) += A (64 x 8) B^T (8 x 128), both tf32 K-major
// tiles in 128-byte-swizzled shared memory, given by their descriptors
__device__ __forceinline__ void wgmma_n128(float (&d)[64], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1));
}

// acc (m64 x n112, the wgmma register layout) += A (64 x 8) B^T (8 x 112), both tf32 K-major
// tiles in 128-byte-swizzled shared memory, given by their descriptors
__device__ __forceinline__ void wgmma_n112(float (&d)[56], uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %58, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n112k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55"
      "}, %56, %57, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55])
      : "l"(a), "l"(b), "r"(1));
}

constexpr int BM = 64;    // wgmma tile rows: rows of x (forward), hidden units (backward)
constexpr int WGS = 2;    // warpgroups of a GEMM block, each on its own BM rows
constexpr int BN = 128;   // forward tile columns: a chunk of H
constexpr int HC = BN;    // the package's name: H must be a multiple of it
constexpr int BNB = 112;  // backward tile columns: inputs (784 = 7 x 112)
constexpr int BK = 32;    // k-depth of a ring slice: 32 floats, one 128-byte swizzle row
constexpr int NT = 128 * WGS;  // threads of a GEMM block
constexpr int FWD_STAGES = 3;
constexpr int BWD_STAGES = 3;
constexpr int A_TILE = WGS * BM * BK * 4;                 // 16 KB: the block's A rows
constexpr int WG_A_TILE = BM * BK * 4;                    // 8 KB: one warpgroup's
constexpr int FWD_B_TILE = BN * BK * 4;                   // 16 KB
constexpr int BWD_B_TILE = BNB * BK * 4;                  // 14 KB
constexpr int FWD_STAGE = 2 * A_TILE + 2 * FWD_B_TILE;    // big and small of A and B
constexpr int BWD_STAGE = 2 * A_TILE + 2 * BWD_B_TILE;
constexpr int FWD_SMEM = FWD_STAGES * FWD_STAGE + 1024;  // + alignment slack
constexpr int BWD_SMEM = BWD_STAGES * BWD_STAGE + 1024;
constexpr int EW = 256;   // threads of an elementwise block
constexpr int EW_MAX_BLOCKS = 64;  // elementwise blocks per chain

long long round_up(long long a, long long m) { return (a + m - 1) / m * m; }

// Sizes of the packed state and of the per-chain partial-sum grids.
struct BnnDims {
  int n, in_dim, hidden, chains;
  int ip, np;        // row strides of W1^T / x and of x^T / da^T: I, N rounded up to 4
  long long d;       // parameters per chain (logical)
  long long w1p;     // floats of the packed W1^T block: hidden * ip
  long long dp;      // stride of a chain's packed state
  int n_tiles, i_tiles, bwd_blocks, ew_blocks;
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
  s.n_tiles = (n + BM - 1) / BM;
  s.i_tiles = (in_dim + BNB - 1) / BNB;
  s.bwd_blocks = s.i_tiles * (hidden / (WGS * BM));
  long long pairs = (s.d + 1) / 2;
  long long blocks = (pairs + EW - 1) / EW;
  s.ew_blocks = (int)(blocks < EW_MAX_BLOCKS ? blocks : EW_MAX_BLOCKS);
  return s;
}

// The package's plan of its persistent grids; the former grids follow from
// the shapes, so any plan is taken.
bool set_grids(BnnDims&, int, int) { return true; }

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
  o.dat = a.take(C * 2 * (size_t)s.hidden * s.np, 4);    // (C, 2, H, np): da^T big, small
  o.pgw2 = a.take(C * s.n_tiles * (size_t)s.hidden, 4);
  o.pgb1 = a.take(C * s.n_tiles * (size_t)s.hidden, 4);
  o.pgb2 = a.take(C * s.n_tiles, 4);
  o.pll = a.take(C * s.n_tiles, 8);
  o.pprior = a.take(C * s.bwd_blocks, 8);
  o.pkin = a.take(C * s.bwd_blocks, 8);
  o.pdots = a.take(C * s.bwd_blocks * 3, 8);  // (C, bwd_blocks, 3): |g|^2, u.g, |u|^2
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
  CUtensorMap x;    // (2, N, ip) x split; box 32 x 128
  CUtensorMap w1t;  // the packed W1^T of every chain of th; box 32 x 128
  CUtensorMap dat;  // (C * 2, H, np) da^T split; box 32 x 128
  CUtensorMap xt;   // (2, I, np) x^T split; box 32 x 112
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

// The k-slice ring of a GEMM block: thread 0 loads slice L into stage
// L % STAGES; the warpgroups wait for it, multiply, and free it.
template <int STAGES>
struct Ring {
  uint64_t full[STAGES], empty[STAGES];

  __device__ void init() {  // by thread 0, before a __syncthreads
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], NT / 32);
    }
    mbar_fence_init();
  }
  __device__ void wait_full(int L) { mbar_wait(&full[L % STAGES], (L / STAGES) & 1); }
  // after this warp's wgmma_wait<1> in iteration L: slice L - 1 is done;
  // thread 0 then refills its stage with slice L - 1 + STAGES (< total)
  template <class Load>
  __device__ void release(int L, int total, Load load) {
    if (L < 1) return;
    const int s = (L - 1) % STAGES;
    if ((threadIdx.x & 31) == 0) mbar_arrive(&empty[s]);
    if (threadIdx.x == 0 && L - 1 + STAGES < total) {
      mbar_wait(&empty[s], ((L - 1) / STAGES) & 1);
      load(L - 1 + STAGES);
    }
  }
};

// Forward pass of chain blockIdx.y on the row tiles 2 blockIdx.x + wg (of
// BM rows each; warpgroup wg takes one, the two share the W1^T slices):
// a = x W1 + b1, h = tanh(a), o = h w2 + b2, resid = o - y, d = -tau resid,
// da = d w2 (1 - h^2) into da^T (big, small); per-tile partial sums of h d
// and da over the rows (w2 and b1 gradients), of d (b2 gradient) and of
// resid^2.  Accumulator element 4j + 2r + e of thread (warp w of its
// warpgroup, g = lane / 4, t = lane % 4) is row 16 w + g + 8r, column
// 8j + 2t + e of its tile.
__global__ void __launch_bounds__(NT, 1) forward_kernel(
    const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
    const float* __restrict__ y, const float* __restrict__ th, float* __restrict__ dat,
    float* __restrict__ pgw2, float* __restrict__ pgb1, float* __restrict__ pgb2,
    double* __restrict__ pll, const BnnDims s, float tau) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  __shared__ Ring<FWD_STAGES> ring;
  __shared__ float red_w2[NT / 32][BN];
  __shared__ float red_b1[NT / 32][BN];
  __shared__ float red_d[NT / 32];
  __shared__ double red_ll[NT / 32];

  const int tid = threadIdx.x, wg = tid >> 7, wtid = tid & 127;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int c = blockIdx.y, tile = WGS * blockIdx.x + wg, n0 = tile * BM;
  const int n = s.n, hidden = s.hidden;
  const float* b1 = th + c * s.dp + s.w1p;
  const float* w2 = b1 + hidden;
  const float b2 = w2[hidden];
  float* dat_big = dat + (long long)c * 2 * hidden * s.np;
  float* dat_small = dat_big + (long long)hidden * s.np;
  const int ktiles = (s.in_dim + BK - 1) / BK, nchunks = hidden / BN, total = ktiles * nchunks;

  if (tid == 0) ring.init();
  __syncthreads();
  const CUtensorMap* xm = &xmap;
  const CUtensorMap* wm = &wmap;
  auto load = [=](int L) {
    unsigned char* st = smem + (L % FWD_STAGES) * FWD_STAGE;
    const int k0 = (L % ktiles) * BK, j0 = (L / ktiles) * BN;
    uint64_t* bar = &ring.full[L % FWD_STAGES];
    mbar_expect_tx(bar, 2 * A_TILE + FWD_B_TILE);
    tma_load_3d(st, xm, k0, WGS * BM * blockIdx.x, 0, bar);
    tma_load_3d(st + A_TILE, xm, k0, WGS * BM * blockIdx.x, 1, bar);
    tma_load_3d(st + 2 * A_TILE, wm, k0, j0, c, bar);
  };
  if (tid == 0)
    for (int L = 0; L < FWD_STAGES && L < total; ++L) load(L);

  const int row0 = n0 + (warp & 3) * 16 + g;  // this thread's rows: row0 and row0 + 8
  float acc[64], acc_s[64];  // big.big, and the two small products
  float o_part[2] = {0.f, 0.f};
  for (int L = 0; L < total; ++L) {
    unsigned char* st = smem + (L % FWD_STAGES) * FWD_STAGE;
    if (L % ktiles == 0) {
#pragma unroll
      for (int q = 0; q < 64; ++q) acc[q] = acc_s[q] = 0.f;
    }
    ring.wait_full(L);
    // split the raw W1^T slice in place: big over it, small beside it (the
    // swizzle permutes both alike, so the split is elementwise)
    float4* bb = reinterpret_cast<float4*>(st + 2 * A_TILE);
    float4* bs = reinterpret_cast<float4*>(st + 2 * A_TILE + FWD_B_TILE);
#pragma unroll
    for (int e = 0; e < FWD_B_TILE / 16 / NT; ++e) {
      const float4 v = bb[tid + e * NT];
      float4 hi, lo;
      tf32_split(v.x, hi.x, lo.x);
      tf32_split(v.y, hi.y, lo.y);
      tf32_split(v.z, hi.z, lo.z);
      tf32_split(v.w, hi.w, lo.w);
      bb[tid + e * NT] = hi;
      bs[tid + e * NT] = lo;
    }
    fence_proxy_async();
    named_barrier(1, NT);
    reg_fence(acc);
    reg_fence(acc_s);
    wgmma_fence();
    const uint64_t a_big = sw128_desc(st + wg * WG_A_TILE);
    const uint64_t a_small = sw128_desc(st + A_TILE + wg * WG_A_TILE);
    const uint64_t b_big = sw128_desc(st + 2 * A_TILE);
    const uint64_t b_small = sw128_desc(st + 2 * A_TILE + FWD_B_TILE);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      wgmma_n128(acc, a_big + 2 * kk, b_big + 2 * kk);
      wgmma_n128(acc_s, a_big + 2 * kk, b_small + 2 * kk);
      wgmma_n128(acc_s, a_small + 2 * kk, b_big + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(acc);
    reg_fence(acc_s);
    ring.release(L, total, load);

    if (L % ktiles == ktiles - 1) {  // a chunk of H is done: h = tanh(a + b1), o
      wgmma_wait<0>();
      reg_fence(acc);
      reg_fence(acc_s);
#pragma unroll
      for (int q = 0; q < 64; ++q) acc[q] += acc_s[q];
      const int j0 = (L / ktiles) * BN;
      const bool last = (L == total - 1);
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = j0 + 8 * j + 2 * t + e, row = row0 + 8 * r;
            const float hv = tanhf(acc[4 * j + 2 * r + e] + b1[col]);
            if (row < n) o_part[r] = fmaf(hv, w2[col], o_part[r]);
            if (last) acc[4 * j + 2 * r + e] = hv;  // the last chunk stays in registers
            else if (row < n) dat_big[(long long)col * s.np + row] = hv;
          }
    }
  }

  // o per row: the 4 lanes of a quad hold the row's columns
  float dvals[2];
  float d_sum = 0.f;
  double r2_sum = 0.0;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float o = o_part[r];
    o += __shfl_xor_sync(0xffffffffu, o, 1);
    o += __shfl_xor_sync(0xffffffffu, o, 2);
    const int row = row0 + 8 * r;
    const float resid = (row < n) ? (o + b2 - y[row]) : 0.f;
    dvals[r] = -tau * resid;
    if (t == 0) {
      d_sum += dvals[r];
      r2_sum += (double)resid * resid;
    }
  }

  // da = d w2 (1 - h^2) as da^T big/small, and column partials of h d and da
  for (int ch = 0; ch < nchunks; ++ch) {
    const int j0 = ch * BN;
    const bool last = (ch == nchunks - 1);
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = j0 + 8 * j + 2 * t + e;
        float cw = 0.f, cb = 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = row0 + 8 * r;
          if (row < n) {
            const long long at = (long long)col * s.np + row;
            const float hv = last ? acc[4 * j + 2 * r + e] : dat_big[at];
            const float dav = dvals[r] * w2[col] * (1.f - hv * hv);
            float big, small;
            tf32_split(dav, big, small);
            dat_big[at] = big;
            dat_small[at] = small;
            cw = fmaf(hv, dvals[r], cw);
            cb += dav;
          }
        }
        // sum over the 8 row groups of the warp (lanes of equal t)
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          cw += __shfl_xor_sync(0xffffffffu, cw, off);
          cb += __shfl_xor_sync(0xffffffffu, cb, off);
        }
        if (g == 0) {
          red_w2[warp][8 * j + 2 * t + e] = cw;
          red_b1[warp][8 * j + 2 * t + e] = cb;
        }
      }
    __syncthreads();
    if (tile < s.n_tiles) {  // the sum of this warpgroup's four warps, in order
      const int w0 = 4 * wg;
      const float sw =
          ((red_w2[w0][wtid] + red_w2[w0 + 1][wtid]) + red_w2[w0 + 2][wtid]) + red_w2[w0 + 3][wtid];
      const float sb =
          ((red_b1[w0][wtid] + red_b1[w0 + 1][wtid]) + red_b1[w0 + 2][wtid]) + red_b1[w0 + 3][wtid];
      const long long at = ((long long)c * s.n_tiles + tile) * hidden + j0 + wtid;
      pgw2[at] = sw;
      pgb1[at] = sb;
    }
    __syncthreads();
  }

#pragma unroll
  for (int off = 4; off < 32; off <<= 1) {
    d_sum += __shfl_xor_sync(0xffffffffu, d_sum, off);
    r2_sum += __shfl_xor_sync(0xffffffffu, r2_sum, off);
  }
  if (lane == 0) {
    red_d[warp] = d_sum;
    red_ll[warp] = r2_sum;
  }
  __syncthreads();
  if (wtid == 0 && tile < s.n_tiles) {
    const int w0 = 4 * wg;
    pgb2[(long long)c * s.n_tiles + tile] =
        ((red_d[w0] + red_d[w0 + 1]) + red_d[w0 + 2]) + red_d[w0 + 3];
    pll[(long long)c * s.n_tiles + tile] =
        ((red_ll[w0] + red_ll[w0 + 1]) + red_ll[w0 + 2]) + red_ll[w0 + 3];
  }
}

// Backward pass of chain blockIdx.z on hidden units [2 BM blockIdx.y, +2 BM)
// (BM per warpgroup; the two share the x^T slices) and inputs
// [BNB blockIdx.x, +BNB): g = (da^T x)^T - W1 into gr and partial sums of
// W1^2 (prior).  With p (HMC): p += kappa g, with drift th += eps p, and
// partial sums of p^2 (kinetic).  DOTS (MCLMC): partial sums of |g|^2, u.g
// and |u|^2 against the velocity u into pdots.  Accumulator element
// 4j + 2r + e of thread (warp w of warpgroup wg, g, t) is hidden unit
// BM wg + 16 w + g + 8r of the block, input 8j + 2t + e.
template <bool DOTS>
__global__ void __launch_bounds__(NT, 1) backward_kernel(
    const __grid_constant__ CUtensorMap dmap, const __grid_constant__ CUtensorMap xtmap,
    float* __restrict__ th, float* __restrict__ gr, float* __restrict__ p,
    double* __restrict__ pprior, double* __restrict__ pkin, const float* __restrict__ u,
    double* __restrict__ pdots, const BnnDims s, float kappa, float eps, int drift) {
  if constexpr (DOTS) grid_dependency_wait();
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  __shared__ Ring<BWD_STAGES> ring;

  const int tid = threadIdx.x, wg = tid >> 7, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int c = blockIdx.z, i0 = blockIdx.x * BNB, hb = blockIdx.y * WGS * BM;
  const int total = (s.n + BK - 1) / BK;

  if (tid == 0) ring.init();
  __syncthreads();
  const CUtensorMap* dm = &dmap;
  const CUtensorMap* xm = &xtmap;
  auto load = [=](int L) {
    unsigned char* st = smem + (L % BWD_STAGES) * BWD_STAGE;
    const int k0 = L * BK;
    uint64_t* bar = &ring.full[L % BWD_STAGES];
    mbar_expect_tx(bar, BWD_STAGE);
    tma_load_3d(st, dm, k0, hb, 2 * c, bar);
    tma_load_3d(st + A_TILE, dm, k0, hb, 2 * c + 1, bar);
    tma_load_3d(st + 2 * A_TILE, xm, k0, i0, 0, bar);
    tma_load_3d(st + 2 * A_TILE + BWD_B_TILE, xm, k0, i0, 1, bar);
  };
  if (tid == 0)
    for (int L = 0; L < BWD_STAGES && L < total; ++L) load(L);

  float acc[56], acc_s[56];  // big.big, and the two small products
#pragma unroll
  for (int q = 0; q < 56; ++q) acc[q] = acc_s[q] = 0.f;
  for (int L = 0; L < total; ++L) {
    unsigned char* st = smem + (L % BWD_STAGES) * BWD_STAGE;
    ring.wait_full(L);
    reg_fence(acc);
    reg_fence(acc_s);
    wgmma_fence();
    const uint64_t a_big = sw128_desc(st + wg * WG_A_TILE);
    const uint64_t a_small = sw128_desc(st + A_TILE + wg * WG_A_TILE);
    const uint64_t b_big = sw128_desc(st + 2 * A_TILE);
    const uint64_t b_small = sw128_desc(st + 2 * A_TILE + BWD_B_TILE);
#pragma unroll
    for (int kk = 0; kk < BK / 8; ++kk) {
      wgmma_n112(acc, a_big + 2 * kk, b_big + 2 * kk);
      wgmma_n112(acc_s, a_big + 2 * kk, b_small + 2 * kk);
      wgmma_n112(acc_s, a_small + 2 * kk, b_big + 2 * kk);
    }
    wgmma_commit();
    wgmma_wait<1>();
    reg_fence(acc);
    reg_fence(acc_s);
    ring.release(L, total, load);
  }
  wgmma_wait<0>();
  reg_fence(acc);
  reg_fence(acc_s);
#pragma unroll
  for (int q = 0; q < 56; ++q) acc[q] += acc_s[q];

  float* W1 = th + c * s.dp;
  float* G1 = gr + c * s.dp;
  float* P1 = p ? p + c * s.dp : nullptr;
  const float* U1 = DOTS ? u + c * s.dp : nullptr;
  double prior = 0.0, kin = 0.0, gg = 0.0, ug = 0.0, uu = 0.0;
#pragma unroll
  for (int j = 0; j < 14; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = i0 + 8 * j + 2 * t;  // even, and ip is a multiple of 4
      if (i >= s.in_dim) continue;
      const long long k = (long long)(hb + warp * 16 + g + 8 * r) * s.ip + i;
      const bool two = i + 1 < s.in_dim;  // then 8-byte accesses
      const float2 w = two ? *reinterpret_cast<const float2*>(W1 + k) : make_float2(W1[k], 0.f);
      const float2 gv = make_float2(acc[4 * j + 2 * r] - w.x, acc[4 * j + 2 * r + 1] - w.y);
      if (two) *reinterpret_cast<float2*>(G1 + k) = gv;
      else G1[k] = gv.x;
      prior += (double)w.x * w.x;
      prior += (double)w.y * w.y;
      if constexpr (DOTS) {
        const float2 uv = two ? *reinterpret_cast<const float2*>(U1 + k) : make_float2(U1[k], 0.f);
        const float gy = two ? gv.y : 0.f;
        gg += (double)gv.x * gv.x;
        gg += (double)gy * gy;
        ug += (double)uv.x * gv.x;
        ug += (double)uv.y * gy;
        uu += (double)uv.x * uv.x;
        uu += (double)uv.y * uv.y;
      }
      if (P1) {
        float2 pv = two ? *reinterpret_cast<const float2*>(P1 + k) : make_float2(P1[k], 0.f);
        pv.x = fmaf(kappa, gv.x, pv.x);
        pv.y = two ? fmaf(kappa, gv.y, pv.y) : 0.f;
        kin += (double)pv.x * pv.x;
        kin += (double)pv.y * pv.y;
        const float2 wn = make_float2(fmaf(eps, pv.x, w.x), fmaf(eps, pv.y, w.y));
        if (two) {
          *reinterpret_cast<float2*>(P1 + k) = pv;
          if (drift) *reinterpret_cast<float2*>(W1 + k) = wn;
        } else {
          P1[k] = pv.x;
          if (drift) W1[k] = wn.x;
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
  if (tid == 0) {
    const long long at = (long long)c * gridDim.x * gridDim.y + blockIdx.y * gridDim.x + blockIdx.x;
    pprior[at] = prior;
    pkin[at] = kin;
    if constexpr (DOTS) {
      pdots[3 * at] = gg;
      pdots[3 * at + 1] = ug;
      pdots[3 * at + 2] = uu;
    }
  }
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
  const int c = blockIdx.x, hidden = s.hidden, n_tiles = s.n_tiles, bwd_blocks = s.bwd_blocks;
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
    for (int b = 0; b < bwd_blocks; ++b) {
      prior += pprior[(long long)c * bwd_blocks + b];
      if (p) kin += pkin[(long long)c * bwd_blocks + b];
      if constexpr (DOTS) {
        const double* pd = pdots + 3 * ((long long)c * bwd_blocks + b);
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

// Once per run, before anything is launched: the TMA descriptors of the
// operands (W1^T read from th) and the GEMM kernels' shared-memory
// allowance.  Returns a cudaError_t.
int prepare_gradient_maps(const BnnDims& s, const float* th, const GradScratch& w, GradMaps* m,
                          bool /*phases: this design counts none*/ = false) {
  int err;
  if ((err = (int)cudaFuncSetAttribute(forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       FWD_SMEM)) != 0)
    return err;
  if ((err = (int)cudaFuncSetAttribute(backward_kernel<false>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM)) != 0)
    return err;
  if ((err = (int)cudaFuncSetAttribute(backward_kernel<true>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, BWD_SMEM)) != 0)
    return err;
  const uint64_t f = sizeof(float);
  if ((err = encode_3d(&m->x, w.xs, s.in_dim, s.n, 2, s.ip * f, (uint64_t)s.n * s.ip * f,
                       WGS * BM)) != 0)
    return err;
  if ((err = encode_3d(&m->w1t, th, s.in_dim, s.hidden, s.chains, s.ip * f, s.dp * f, BN)) != 0)
    return err;
  if ((err = encode_3d(&m->dat, w.dat, s.n, s.hidden, 2 * (uint64_t)s.chains, s.np * f,
                       (uint64_t)s.hidden * s.np * f, WGS * BM)) != 0)
    return err;
  if ((err = encode_3d(&m->xt, w.xts, s.n, s.in_dim, 2, s.np * f,
                       (uint64_t)s.in_dim * s.np * f, BNB)) != 0)
    return err;
  return 0;
}

// x staged and split into the workspace.  Returns the launch's cudaError_t.
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
// every chain: the gradient into gr and logp into logp_prop.  With p (HMC)
// the evaluation also kicks p by kappa g, drifts th by eps p when drift is
// set, and writes 0.5 |p|^2 to kin_prop.  Returns the first launch error as
// a cudaError_t (0 on success).
int launch_gradient(const BnnDims& s, const GradMaps& m, const float* y, float* th, float* gr,
                    float* p, const GradScratch& w, double* logp_prop, double* kin_prop,
                    float tau, float kappa, float eps, int drift, cudaStream_t stream,
                    long long* /*phases: this design counts none*/ = nullptr) {
  const dim3 fwd_grid((s.n_tiles + WGS - 1) / WGS, s.chains);
  const dim3 bwd_grid(s.i_tiles, s.hidden / (WGS * BM), s.chains);
  forward_kernel<<<fwd_grid, NT, FWD_SMEM, stream>>>(m.x, m.w1t, y, th, w.dat, w.pgw2, w.pgb1,
                                                     w.pgb2, w.pll, s, tau);
  LAUNCH_CHECK();
  backward_kernel<false><<<bwd_grid, NT, BWD_SMEM, stream>>>(
      m.dat, m.xt, th, gr, p, w.pprior, w.pkin, nullptr, nullptr, s, kappa, eps, drift);
  LAUNCH_CHECK();
  small_kernel<false><<<s.chains, 128, 0, stream>>>(th, gr, p, w.pgw2, w.pgb1, w.pgb2, w.pll,
                                                    w.pprior, w.pkin, logp_prop, kin_prop, nullptr,
                                                    nullptr, nullptr, s, tau, kappa, eps, drift);
  LAUNCH_CHECK();
  return 0;
}

// MCLMC's evaluation (no kick): launch_gradient's gradient into gr and logp
// into logp_prop, and each chain's |g|^2, u.g and |u|^2 against the velocity
// u into dots (C, 3), in float64.  With dependent, the backward and small
// kernels are programmatic dependent launches (launch_ex).  Returns the
// first launch error as a cudaError_t (0 on success).
int launch_gradient_dots(const BnnDims& s, const GradMaps& m, const float* y, float* th, float* gr,
                         const float* u, const GradScratch& w, double* logp_prop, double* dots,
                         float tau, bool dependent, cudaStream_t stream,
                         long long* /*phases: this design counts none*/ = nullptr) {
  const dim3 fwd_grid((s.n_tiles + WGS - 1) / WGS, s.chains);
  const dim3 bwd_grid(s.i_tiles, s.hidden / (WGS * BM), s.chains);
  forward_kernel<<<fwd_grid, NT, FWD_SMEM, stream>>>(m.x, m.w1t, y, th, w.dat, w.pgw2, w.pgb1,
                                                     w.pgb2, w.pll, s, tau);
  LAUNCH_CHECK();
  int err;
  if ((err = launch_ex(backward_kernel<true>, bwd_grid, NT, BWD_SMEM, stream, dependent, m.dat,
                       m.xt, th, gr, (float*)nullptr, w.pprior, w.pkin, u, w.pdots, s, 0.f, 0.f,
                       0)) != 0)
    return err;
  return launch_ex(small_kernel<true>, s.chains, 128, 0, stream, dependent, th, gr,
                   (float*)nullptr, w.pgw2, w.pgb1, w.pgb2, w.pll, w.pprior, w.pkin, logp_prop,
                   (double*)nullptr, u, w.pdots, dots, s, tau, 0.f, 0.f, 0);
}

}  // namespace
