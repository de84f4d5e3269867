// A 3x3 convolution of stride 1 and padding 1 with as many output channels
// as input channels (C), over an NCHW float tensor of N images of S x S
// pixels, forward and backward, for ResNet-20-FRN's 16 same-width
// convolutions (models/resnet_frn.py, Conv3x3):
//
//   forward        out[n][o][p] = b[o] + sum_{i, tap} W[o][i][tap] x[n][i][p + d(tap)]
//   input grad     dx[n][i][p]  = sum_{o, tap} W[o][i][8 - tap] dy[n][o][p + d(tap)]
//   weight grad    dW[o][i][tap] = sum_{n, p} dy[n][o][p] x[n][i][p + d(tap)],
//                  db[o] = sum_{n, p} dy[n][o][p]
//
// with d(tap) the shift (ky - 1, kx - 1) of tap = 3 ky + kx and zeros
// outside the image.  At stride 1 and padding 1 the input gradient is the
// forward's convolution of dy with W turned 180 degrees and its two channel
// axes swapped: the same kernel, reading W at that index (no flipped copy).
//
// It replaces no TPU kernel: the JAX package leaves convolutions to XLA.  It
// was added because cuDNN has no float32 tensor-core path: with TF32 off (the
// potential's float32 hold) it runs these shapes as FFTs, FFMA implicit GEMMs
// and wgrad_alg0_engine at ~12 TFLOP/s.  Each direction is 2 * 9 C^2 S^2
// operations an image, the same at ResNet-20's three stages (C, S) = (16, 32),
// (32, 16), (64, 8), and reads one activation-sized tensor and writes or
// reads another (2 C S^2 floats an image: 128, 64 and 32 KB).  So at 3xTF32
// (165 TFLOP/s) and 3.35 TB/s stage 1 is bound by bytes and stages 2 and 3 by
// operations.
//
// The design, float32 at those three (C, S) (the tensor-core path):
//  - every product is 3xTF32 on mma.sync.m16n8k8 (big*small + small*big +
//    big*big, float32 sums), each operand split in registers as it is
//    loaded from shared memory;
//  - a block stages its operands in shared memory once: image planes with a
//    one-pixel zero halo (rows of S + 8 floats, the interior on 16-byte
//    boundaries for cp.async), so the nine taps are nine shifted reads of
//    one tile and every input byte comes from device memory once; two
//    stages, the next one's copies in flight while the current one computes;
//  - the tensor cores' float32 accumulation does not round to nearest, so its
//    error grows with the depth it sums: each stage's products are summed by
//    mma from zero and then added to the thread's sums in round-to-nearest;
//  - forward and input gradient (conv3x3_fwd_kernel<ROT>): an implicit GEMM,
//    rows the pixels of a group of images (16,384 / C / S^2 images, 512
//    threads: 32 sums a thread), columns the C output channels, depth (input
//    channel, tap) in stages of 8 channels; persistent blocks, one an SM,
//    walk the groups; the bias is added as the results are stored;
//  - weight and bias gradient (conv3x3_wgrad_kernel): rows the C output
//    channels, columns (tap, input channel), depth the pixels, in stages of 8
//    image rows; a block accumulates its images' sums in registers (warps
//    that split the depth add theirs in shared memory in a fixed order) and
//    writes one partial; conv3x3_wgrad_sum_kernel sums the partials in a
//    fixed order in float64.  No atomics: the same inputs give the same bits.
// Any other shape, float64, or float32 at other (C, S) takes the generic
// variant (conv3x3_*_any_kernel): one thread an output, fused multiply-adds
// in the tensor's own type.

#include "common.cuh"

namespace {

constexpr int THREADS = 256;       // a block of the weight gradient and the generic kernels
constexpr int FWD_THREADS = 512;   // a block of the forward and input-gradient kernel
constexpr int KC = 8;  // input channels (a depth step of mma) a forward stage
constexpr int WGRAD_BLOCKS = 264;  // partials of a weight gradient (2 an SM of an H100)

__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, bool copy) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(copy ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

// d += a b in 3xTF32: the two cross terms first, then big * big
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4], const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(d, as, bb[0], bb[1]);
  mma_tf32(d, ab, bs[0], bs[1]);
  mma_tf32(d, ab, bb[0], bb[1]);
}

__device__ __forceinline__ void zero_smem(float* smem, int floats) {
  for (int i = threadIdx.x; i < floats / 4; i += blockDim.x)
    reinterpret_cast<float4*>(smem)[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// ---- forward and input gradient ----

template <int C, int S>
struct Fwd {
  static constexpr int WARPS = FWD_THREADS / 32;
  static constexpr int IMG = 16384 / (C * S * S);  // images a tile: 32 sums a thread
  static constexpr int CHUNKS = C / KC;            // stages a tile
  static constexpr int RP = S + 8;                 // a halo row: pixel (y, x) at (y + 1) RP + x + 4
  static constexpr int PLANE = (S + 2) * RP;
  static constexpr int PS = PLANE + (24 - PLANE % 16) % 16;  // PS % 32 in {8, 24}: A reads conflict-free
  static constexpr int IN = IMG * KC * PS;         // floats of a stage's planes
  static constexpr int NS = C + 8;                 // a weight row: NS % 32 in {8, 24}
  static constexpr int STAGE = IN + 9 * KC * NS;   // planes, then weights [tap][k][n]
  static constexpr int SMEM = 2 * STAGE * 4;
  static constexpr int NT = C / 8 < 4 ? C / 8 : 4;  // n8 tiles a warp
  static constexpr int WN = C / 8 / NT;
  static constexpr int WM = WARPS / WN;
  static constexpr int MT = IMG * S * S / 16 / WM;  // m16 tiles a warp (8 tiles with NT)
  static constexpr int D8 = S >= 16 ? 8 : RP;       // pixel g + 8 of an m16 tile
  static_assert(IMG >= 1 && IMG * C * S * S == 16384 && S % 8 == 0 && C % KC == 0, "shape");
  static_assert(PS % 16 == 8 && NS % 16 == 8 && MT * 16 * WM == IMG * S * S, "layout");
  static_assert(MT * NT == 8, "32 sums a thread");
};

// ROT false: out = the forward of in (x) with bias b; ROT true: out = the
// input gradient of in (dy), b null.
template <int C, int S, bool ROT>
__global__ void __launch_bounds__(FWD_THREADS, 1)
    conv3x3_fwd_kernel(const float* __restrict__ in, const float* __restrict__ w,
                       const float* __restrict__ bias, float* __restrict__ out, int images) {
  using F = Fwd<C, S>;
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int wm = warp % F::WM, wn = warp / F::WM;
  const int tiles = (images + F::IMG - 1) / F::IMG;
  const int mine = (int)blockIdx.x < tiles ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int steps = mine * F::CHUNKS;

  zero_smem(smem, 2 * F::STAGE);  // the halos stay zero: copies fill interiors only
  __syncthreads();

  auto issue = [&](int s) {
    float* st = smem + (s & 1) * F::STAGE;
    const int n0 = ((int)blockIdx.x + (s / F::CHUNKS) * (int)gridDim.x) * F::IMG;
    const int c0 = (s % F::CHUNKS) * KC;
    constexpr int Q = S / 4;  // 16-byte pieces a row
    for (int e = tid; e < F::IMG * KC * S * Q; e += FWD_THREADS) {
      const int q = e % Q, y = (e / Q) % S, c = (e / (Q * S)) % KC, img = e / (Q * S * KC);
      const bool ok = n0 + img < images;
      const float* src = ok ? in + ((long long)(n0 + img) * C + c0 + c) * (S * S) + y * S + 4 * q : in;
      cp_async16_zfill(st + (img * KC + c) * F::PS + (y + 1) * F::RP + 4 + 4 * q, src, ok);
    }
    float* ws = st + F::IN;
    for (int e = tid; e < 9 * KC * C; e += FWD_THREADS) {
      const int tap = e % 9;
      if constexpr (!ROT) {  // B[k][n] = W[n][c0 + k][tap]
        const int n = e / (9 * KC), k = (e / 9) % KC;
        cp_async4(ws + (tap * KC + k) * F::NS + n, w + ((long long)n * C + c0 + k) * 9 + tap);
      } else {  // B[k][n] = W[c0 + k][n][8 - tap]
        const int k = e / (9 * C), n = (e / 9) % C;
        cp_async4(ws + ((8 - tap) * KC + k) * F::NS + n, w + ((long long)(c0 + k) * C + n) * 9 + tap);
      }
    }
  };

  int aoff[F::MT];  // the lane's pixel g of each m16 tile at tap (0, 0), channel t
#pragma unroll
  for (int mt = 0; mt < F::MT; ++mt) {
    const int q = (wm * F::MT + mt) * 16 + g;
    const int img = q / (S * S), y = (q % (S * S)) / S, x = q % S;
    aoff[mt] = (img * KC + t) * F::PS + y * F::RP + x + 3;
  }
  const int boff = t * F::NS + wn * F::NT * 8 + g;
  // the mma sums a stage (9 C / 8 products deep, 3 mma each) in acc, which is
  // then added to sum in round-to-nearest: the tensor cores' float32
  // accumulation does not round to nearest, and its error would grow with C
  float acc[F::MT][F::NT][4] = {}, sum[F::MT][F::NT][4] = {};

  if (steps > 0) issue(0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* st = smem + (s & 1) * F::STAGE;
    const float* ws = st + F::IN;
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int toff = (tap / 3) * F::RP + tap % 3;
      uint32_t bb[F::NT][2], bs[F::NT][2];
#pragma unroll
      for (int nt = 0; nt < F::NT; ++nt) {
        const float* b = ws + tap * KC * F::NS + boff + nt * 8;
        tf32_split_alu(b[0], bb[nt][0], bs[nt][0]);
        tf32_split_alu(b[4 * F::NS], bb[nt][1], bs[nt][1]);
      }
#pragma unroll
      for (int mt = 0; mt < F::MT; ++mt) {
        const float* a = st + aoff[mt] + toff;
        uint32_t ab[4], as[4];
        tf32_split_alu(a[0], ab[0], as[0]);
        tf32_split_alu(a[F::D8], ab[1], as[1]);
        tf32_split_alu(a[4 * F::PS], ab[2], as[2]);
        tf32_split_alu(a[4 * F::PS + F::D8], ab[3], as[3]);
#pragma unroll
        for (int nt = 0; nt < F::NT; ++nt) mma_3xtf32(acc[mt][nt], ab, as, bb[nt], bs[nt]);
      }
    }
#pragma unroll
    for (int mt = 0; mt < F::MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < F::NT; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sum[mt][nt][j] += acc[mt][nt][j];
          acc[mt][nt][j] = 0.f;
        }
    if (s % F::CHUNKS == F::CHUNKS - 1) {  // the tile's last stage: store it
      const int n0 = ((int)blockIdx.x + (s / F::CHUNKS) * (int)gridDim.x) * F::IMG;
#pragma unroll
      for (int mt = 0; mt < F::MT; ++mt)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = (wm * F::MT + mt) * 16 + g + 8 * r;
          const int n = n0 + q / (S * S), p = q % (S * S);
          if (n >= images) continue;
#pragma unroll
          for (int nt = 0; nt < F::NT; ++nt)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              const int o = (wn * F::NT + nt) * 8 + 2 * t + j;
              float v = sum[mt][nt][2 * r + j];
              if constexpr (!ROT) v += __ldg(bias + o);
              out[((long long)n * C + o) * (S * S) + p] = v;
            }
        }
#pragma unroll
      for (int mt = 0; mt < F::MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < F::NT; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j) sum[mt][nt][j] = 0.f;
    }
    __syncthreads();  // the stage is free for the copies of step s + 2
  }
  cp_async_wait<0>();
}

// ---- weight and bias gradient ----

template <int C, int S>
struct Wgrad {
  static constexpr int WARPS = THREADS / 32;
  static constexpr int CS = C < 64 ? C : 16;  // input channels a block: blockIdx.y slices
  static constexpr int SLICES = C / CS;
  static constexpr int R = 8;                 // image rows a stage
  static constexpr int CHUNKS = S / R;        // stages an image
  static constexpr int PIX = R * S;           // depth of a stage
  static constexpr int RP = S + 8;            // x's halo rows: rows y0 - 1 .. y0 + R
  static constexpr int XPLANE = (R + 2) * RP;
  static constexpr int XS = XPLANE % 8 == 4 ? XPLANE : XPLANE + 4;  // XS % 8 == 4: B reads conflict-free
  static constexpr int DS = PIX + 4;          // dy's planes: DS % 8 == 4, A reads conflict-free
  static constexpr int STAGE = CS * XS + C * DS;  // x's planes, then dy's
  static constexpr int SMEM = 2 * STAGE * 4;
  // a warp: one m16 tile of output channels x one 8-channel group of x at
  // the 9 taps (9 n8 tiles); GROUPS such pairs, KW warps a pair splitting
  // a stage's depth
  static constexpr int MTILES = C / 16, NCG = CS / 8;
  static constexpr int GROUPS = MTILES * NCG;
  static constexpr int KW = WARPS / GROUPS;
  static constexpr int KSTEPS = PIX / 8;
  static constexpr int LEN = 9 * C * C + C;   // a partial: dW, then db
  static_assert(GROUPS * KW == WARPS && KSTEPS % KW == 0, "layout");
  static_assert(XS % 8 == 4 && DS % 8 == 4 && S % R == 0, "layout");
  static_assert((KW - 1) * GROUPS * 9 * 128 <= 2 * STAGE, "the depth split's sums fit");
};

// part[blockIdx.x][...] = this block's images' sums: dW (C, C, 3, 3) at its
// slice of input channels, and db (slice 0)
template <int C, int S>
__global__ void __launch_bounds__(THREADS, 2)
    conv3x3_wgrad_kernel(const float* __restrict__ dy, const float* __restrict__ x,
                         float* __restrict__ part, int images) {
  using F = Wgrad<C, S>;
  extern __shared__ __align__(16) float smem[];
  __shared__ float dbs[THREADS];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int grp = warp % F::GROUPS, kw = warp / F::GROUPS;
  const int mt = grp % F::MTILES, cg = grp / F::MTILES;  // output channels 16 mt.., x's 8 cg..
  const int cs0 = (int)blockIdx.y * F::CS;
  const int mine = (int)blockIdx.x < images ? (images - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int steps = mine * F::CHUNKS;

  zero_smem(smem, 2 * F::STAGE);  // x's halo columns stay zero
  __syncthreads();

  auto issue = [&](int s) {
    float* st = smem + (s & 1) * F::STAGE;
    const int n = (int)blockIdx.x + (s / F::CHUNKS) * (int)gridDim.x;
    const int y0 = (s % F::CHUNKS) * F::R;
    constexpr int Q = S / 4;
    for (int e = tid; e < F::CS * (F::R + 2) * Q; e += THREADS) {
      const int q = e % Q, yy = (e / Q) % (F::R + 2), c = e / (Q * (F::R + 2));
      const int y = y0 - 1 + yy;
      const bool ok = y >= 0 && y < S;
      const float* src = ok ? x + (((long long)n * C + cs0 + c) * S + y) * S + 4 * q : x;
      cp_async16_zfill(st + c * F::XS + yy * F::RP + 4 + 4 * q, src, ok);
    }
    float* ds = st + F::CS * F::XS;
    for (int e = tid; e < C * F::PIX / 4; e += THREADS) {
      const int q = e % (F::PIX / 4), o = e / (F::PIX / 4);
      cp_async16(ds + o * F::DS + 4 * q, dy + ((long long)n * C + o) * (S * S) + y0 * S + 4 * q);
    }
  };

  const int aoff = (mt * 16 + g) * F::DS + t;      // dy[o = g][p = t]
  const int boff = (cg * 8 + g) * F::XS + t + 3;   // x[c = g][p = t] at tap (0, 0)
  // the mma sums a stage in acc, then added to sum in round-to-nearest, as
  // the forward does
  float acc[9][4] = {}, sum[9][4] = {};
  float db = 0.f;

  if (steps > 0) issue(0);
  cp_async_commit();
  for (int s = 0; s < steps; ++s) {
    if (s + 1 < steps) issue(s + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* xs = smem + (s & 1) * F::STAGE;
    const float* ds = xs + F::CS * F::XS;
    if (blockIdx.y == 0) {
#pragma unroll
      for (int k = 0; k < F::PIX * C / THREADS; ++k) {
        const int p = tid / C + k * (THREADS / C);
        db += ds[(tid % C) * F::DS + p];
      }
    }
#pragma unroll 2
    for (int ks = kw; ks < F::KSTEPS; ks += F::KW) {
      const int row = ks / (S / 8), col = (ks % (S / 8)) * 8;
      const float* a = ds + aoff + row * S + col;
      uint32_t ab[4], as[4];
      tf32_split_alu(a[0], ab[0], as[0]);
      tf32_split_alu(a[8 * F::DS], ab[1], as[1]);
      tf32_split_alu(a[4], ab[2], as[2]);
      tf32_split_alu(a[8 * F::DS + 4], ab[3], as[3]);
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const float* b = xs + boff + (row + tap / 3) * F::RP + col + tap % 3;
        uint32_t bb[2], bs[2];
        tf32_split_alu(b[0], bb[0], bs[0]);
        tf32_split_alu(b[4], bb[1], bs[1]);
        mma_3xtf32(acc[tap], ab, as, bb, bs);
      }
    }
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        sum[j][r] += acc[j][r];
        acc[j][r] = 0.f;
      }
    __syncthreads();  // the stage is free for the copies of step s + 2
  }
  cp_async_wait<0>();
  __syncthreads();

  // the warps that split the depth: kw > 0 leave their sums, kw = 0 adds them in order
  float4* red = reinterpret_cast<float4*>(smem);
  if (kw > 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j)
      red[(((kw - 1) * F::GROUPS + grp) * 9 + j) * 32 + lane] =
          make_float4(sum[j][0], sum[j][1], sum[j][2], sum[j][3]);
  }
  dbs[tid] = db;
  __syncthreads();
  float* out = part + (long long)blockIdx.x * F::LEN;
  if (kw == 0) {
    for (int k = 1; k < F::KW; ++k)
#pragma unroll
      for (int j = 0; j < 9; ++j) {
        const float4 v = red[(((k - 1) * F::GROUPS + grp) * 9 + j) * 32 + lane];
        sum[j][0] += v.x;
        sum[j][1] += v.y;
        sum[j][2] += v.z;
        sum[j][3] += v.w;
      }
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) {  // D[g + 8 (r / 2)][2 t + r % 2] at tap j
        const int o = mt * 16 + g + 8 * (r / 2);
        const int c = cs0 + cg * 8 + 2 * t + r % 2;
        out[((long long)o * C + c) * 9 + j] = sum[j][r];
      }
  }
  if (blockIdx.y == 0 && tid < C) {
    float v = 0.f;
    for (int k = 0; k < THREADS / C; ++k) v += dbs[tid + k * C];
    out[9 * C * C + tid] = v;
  }
}

// ---- the generic variant: any C and S, float32 or float64 ----

template <typename T>
__device__ __forceinline__ T mul_add(T a, T b, T c);
template <>
__device__ __forceinline__ float mul_add(float a, float b, float c) { return fmaf(a, b, c); }
template <>
__device__ __forceinline__ double mul_add(double a, double b, double c) { return fma(a, b, c); }

template <typename T, bool ROT>
__global__ void __launch_bounds__(THREADS)
    conv3x3_fwd_any_kernel(const T* __restrict__ in, const T* __restrict__ w,
                           const T* __restrict__ bias, T* __restrict__ out, long long images,
                           int C, int S) {
  const long long idx = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= images * C * S * S) return;
  const int x = (int)(idx % S), y = (int)(idx / S % S), o = (int)(idx / ((long long)S * S) % C);
  const long long n = idx / ((long long)C * S * S);
  T acc = ROT ? T(0) : bias[o];
  for (int i = 0; i < C; ++i) {
    const T* plane = in + (n * C + i) * S * S;
    for (int tap = 0; tap < 9; ++tap) {
      const int yy = y + tap / 3 - 1, xx = x + tap % 3 - 1;
      if (yy < 0 || yy >= S || xx < 0 || xx >= S) continue;
      const T wv = ROT ? w[((long long)i * C + o) * 9 + 8 - tap] : w[((long long)o * C + i) * 9 + tap];
      acc = mul_add(wv, plane[yy * S + xx], acc);
    }
  }
  out[idx] = acc;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    conv3x3_wgrad_any_kernel(const T* __restrict__ dy, const T* __restrict__ x,
                             T* __restrict__ part, long long images, int C, int S) {
  const int len = 9 * C * C + C;
  for (int e = threadIdx.x; e < len; e += THREADS) {
    T acc = 0;
    const int o = e < 9 * C * C ? e / (9 * C) : e - 9 * C * C;
    const int i = e / 9 % C, tap = e % 9;
    for (long long n = blockIdx.x; n < images; n += gridDim.x) {
      const T* dp = dy + (n * C + o) * S * S;
      const T* xp = x + (n * C + i) * S * S;
      for (int y = 0; y < S; ++y)
        for (int xx = 0; xx < S; ++xx) {
          if (e >= 9 * C * C) {
            acc += dp[y * S + xx];
            continue;
          }
          const int sy = y + tap / 3 - 1, sx = xx + tap % 3 - 1;
          if (sy >= 0 && sy < S && sx >= 0 && sx < S) acc = mul_add(dp[y * S + xx], xp[sy * S + sx], acc);
        }
    }
    part[(long long)blockIdx.x * len + e] = acc;
  }
}

// dw, db = the rows partials summed in order, in float64
template <typename T>
__global__ void __launch_bounds__(THREADS)
    conv3x3_wgrad_sum_kernel(const T* __restrict__ part, int rows, int len, T* __restrict__ dw,
                             T* __restrict__ db, int wlen) {
  const int e = blockIdx.x * THREADS + threadIdx.x;
  if (e >= len) return;
  double sum = 0;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) sum += (double)part[(long long)r * len + e];
  if (e < wlen) dw[e] = (T)sum;
  else db[e - wlen] = (T)sum;
}

// ---- launches ----

inline unsigned int blocks(long long items) {
  return (unsigned int)((items + THREADS - 1) / THREADS);
}

int sm_count() {
  static int count[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (count[dev] == 0 &&
      cudaDeviceGetAttribute(&count[dev], cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    count[dev] = 132;
  return count[dev];
}

template <typename Kernel>
int allow_smem(Kernel kernel, int bytes) {
  return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// the tensor-core path takes float32 at these (C, S) only
bool fast(int c, int s, int dtype) {
  return dtype == 0 && ((c == 16 && s == 32) || (c == 32 && s == 16) || (c == 64 && s == 8));
}

template <int C, int S, bool ROT>
int fwd_fast(const float* in, const float* w, const float* b, float* out, int images,
             cudaStream_t stream) {
  using F = Fwd<C, S>;
  const int err = allow_smem(conv3x3_fwd_kernel<C, S, ROT>, F::SMEM);
  if (err) return err;
  const int tiles = (images + F::IMG - 1) / F::IMG;
  const int grid = tiles < sm_count() ? tiles : sm_count();
  LAUNCH(conv3x3_fwd_kernel<C, S, ROT><<<grid, FWD_THREADS, F::SMEM, stream>>>(in, w, b, out,
                                                                               images));
  return 0;
}

template <bool ROT>
int fwd_dispatch(const void* in, const void* w, const void* b, void* out, long long images, int c,
                 int s, int dtype, cudaStream_t stream) {
  if (fast(c, s, dtype)) {
    const float *i = (const float*)in, *wf = (const float*)w, *bf = (const float*)b;
    float* o = (float*)out;
    const int n = (int)images;
    if (c == 16) return fwd_fast<16, 32, ROT>(i, wf, bf, o, n, stream);
    if (c == 32) return fwd_fast<32, 16, ROT>(i, wf, bf, o, n, stream);
    return fwd_fast<64, 8, ROT>(i, wf, bf, o, n, stream);
  }
  const long long items = images * c * s * s;
  if (dtype == 0) {
    LAUNCH(conv3x3_fwd_any_kernel<float, ROT><<<blocks(items), THREADS, 0, stream>>>(
        (const float*)in, (const float*)w, (const float*)b, (float*)out, images, c, s));
  } else {
    LAUNCH(conv3x3_fwd_any_kernel<double, ROT><<<blocks(items), THREADS, 0, stream>>>(
        (const double*)in, (const double*)w, (const double*)b, (double*)out, images, c, s));
  }
  return 0;
}

// the partials of a weight gradient: rows of 9 C^2 + C
int wgrad_rows(long long images) { return (int)(images < WGRAD_BLOCKS ? images : WGRAD_BLOCKS); }

template <int C, int S>
int wgrad_fast(const float* dy, const float* x, float* part, int rows, int images,
               cudaStream_t stream) {
  using F = Wgrad<C, S>;
  const int err = allow_smem(conv3x3_wgrad_kernel<C, S>, F::SMEM);
  if (err) return err;
  LAUNCH(conv3x3_wgrad_kernel<C, S><<<dim3(rows, F::SLICES), THREADS, F::SMEM, stream>>>(
      dy, x, part, images));
  return 0;
}

template <typename T>
int wgrad_sum(const void* part, int rows, void* dw, void* db, int c, cudaStream_t stream) {
  const int len = 9 * c * c + c;
  LAUNCH(conv3x3_wgrad_sum_kernel<T><<<blocks(len), THREADS, 0, stream>>>(
      (const T*)part, rows, len, (T*)dw, (T*)db, 9 * c * c));
  return 0;
}

bool valid(long long images, int c, int s, int dtype) {
  return images >= 1 && images <= (1LL << 30) && c >= 1 && s >= 1 && (dtype == 0 || dtype == 1);
}

}  // namespace

extern "C" {

const char* conv3x3_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// out = the convolution of x (images, c, s, s) with w (c, c, 3, 3) and bias
// b (c), stride 1, padding 1.  dtype 0 is float32, 1 float64; contiguous
// tensors, x and out 16-byte aligned.  Device pointers; stream is a
// cudaStream_t.  One kernel, queued without synchronising; returns its
// launch error as a cudaError_t (0 on success).
int conv3x3_forward(const void* x, const void* w, const void* b, void* out, long long images, int c,
                    int s, int dtype, void* stream) {
  if (!valid(images, c, s, dtype)) return (int)cudaErrorInvalidValue;
  return fwd_dispatch<false>(x, w, b, out, images, c, s, dtype, (cudaStream_t)stream);
}

// dx = the input gradient of conv3x3_forward at output gradient dy: the same
// convolution of dy with w turned 180 degrees and its channel axes swapped.
int conv3x3_dgrad(const void* dy, const void* w, void* dx, long long images, int c, int s,
                  int dtype, void* stream) {
  if (!valid(images, c, s, dtype)) return (int)cudaErrorInvalidValue;
  return fwd_dispatch<true>(dy, w, nullptr, dx, images, c, s, dtype, (cudaStream_t)stream);
}

// Elements of the scratch that conv3x3_wgrad takes.
long long conv3x3_wgrad_scratch(long long images, int c) {
  return (long long)wgrad_rows(images) * (9LL * c * c + c);
}

// dw (c, c, 3, 3) and db (c) = the weight and bias gradients of
// conv3x3_forward at input x and output gradient dy, through part
// (conv3x3_wgrad_scratch elements).  Two kernels, queued without
// synchronising; returns the first launch error (0 on success).
int conv3x3_wgrad(const void* dy, const void* x, void* part, void* dw, void* db, long long images,
                  int c, int s, int dtype, void* stream_ptr) {
  if (!valid(images, c, s, dtype)) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_ptr;
  const int rows = wgrad_rows(images);
  int err = 0;
  if (fast(c, s, dtype)) {
    const float *d = (const float*)dy, *xf = (const float*)x;
    float* p = (float*)part;
    const int n = (int)images;
    if (c == 16) err = wgrad_fast<16, 32>(d, xf, p, rows, n, stream);
    else if (c == 32) err = wgrad_fast<32, 16>(d, xf, p, rows, n, stream);
    else err = wgrad_fast<64, 8>(d, xf, p, rows, n, stream);
  } else if (dtype == 0) {
    LAUNCH(conv3x3_wgrad_any_kernel<float><<<rows, THREADS, 0, stream>>>(
        (const float*)dy, (const float*)x, (float*)part, images, c, s));
  } else {
    LAUNCH(conv3x3_wgrad_any_kernel<double><<<rows, THREADS, 0, stream>>>(
        (const double*)dy, (const double*)x, (double*)part, images, c, s));
  }
  if (err) return err;
  return dtype == 0 ? wgrad_sum<float>(part, rows, dw, db, c, stream)
                    : wgrad_sum<double>(part, rows, dw, db, c, stream);
}

}  // extern "C"
