// Fused linear + cross-entropy backward for Hopper (sm_90a), bf16 in, fp32
// accumulation: three kernels over one templated GEMM main loop.
//
// Replaces ray_tpu/ops/fused_ce.py:_ce_dx_kernel and _ce_dw_kernel
// (launched by _ce_bwd_pallas). With P = exp(x W^T - LSE) from the
// forward's row logsumexp (vocab columns at or past `vocab` are padding,
// P = 0 there) and P rounded to bf16 before each product, as the JAX
// kernels round it:
//   dx_unscaled [N, d] = P W
//   dW_unscaled [V, d] = P^T xg,   xg = x * g rounded to bf16
// The one-hot terms (-W[targets], -xg scattered to the target rows) and
// the upstream scaling stay outside, as in the JAX package.
//
// Why three kernels and not two: each TPU kernel recomputes the logits
// S = x W^T for itself, so the pair does four products of 2 N V d. Here
// the wrapper (kernels.ce_bwd) walks the vocabulary in chunks of Vc
// columns and, per chunk, launches
//   ce_probs: P_c = exp2(x W_c^T log2e - LSE log2e), masked, into a bf16
//             scratch [N, Vc]  (GEMM M = N, N = Vc, K = d)
//   ce_dx:    dx += P_c W_c, fp32 read-modify-write, the first chunk
//             writes                   (GEMM M = N, N = d, K = Vc)
//   ce_dw:    dW[c] = P_c^T xg         (GEMM M = Vc, N = d, K = N)
// so S is computed once per chunk and both gradients read it: three
// products, a quarter less work, and no product is tied to d. Vc is the
// largest multiple of 128 whose scratch fits 128 MiB (8192 at N = 8192:
// 7 chunks for V = 50304, 128 MiB of P written once and read twice).
//
// What bounds it on an H100: at GPT-2 small's training shape (N = 8192,
// d = 768, 50257 live vocab rows) the three products are 6 N vocab d =
// 1.897 TFLOP, 1.918 ms at 989 TFLOP/s; the bytes of x, W, xg, LSE, dx and
// dW read or written once (~0.3 GB, ~0.09 ms), and even the scratch's
// 2.5 GB of traffic (0.74 ms), stay below it: the tensor cores bound it.
//
// The shared main loop (gemm_kernel): a CTA of 8 warps computes a BM x BN
// tile of C = A B over K in BK steps, with operands staged in shared
// memory by a STAGES-deep cp.async ring (one barrier per K step; the
// copies of the next STAGES - 1 steps are in flight while one is
// multiplied; each thread's copy addresses and bounds are worked out once,
// before the loop) and multiplied with mma.sync m16n8k16 (bf16 in, fp32
// accumulators in registers, operands through ldmatrix, the next 16-deep
// step's fragments loaded before this step's products issue; shared rows
// are padded by 16 bytes, so ldmatrix is free of bank conflicts). Each
// operand is either K-contiguous (read with ldmatrix) or M/N-contiguous
// (read with ldmatrix.trans), a template flag, so P^T and W as a [K, N]
// operand need no transposed copy. The tile (128 x 256, BK 64, 3 stages,
// 8 warps of 64 x 64, one CTA per SM) is the fastest of those timed on an
// H100 (PERF.md). L2: d is small, so the operand every CTA shares (W_c or
// xg, 12.6 MB at d = 768) stays in the 50 MB L2 while CTAs that run
// together share one BM-row panel of the other (blockIdx.x walks the N
// tiles fastest). Entries past an operand's
// extent are zero-filled in shared memory and never read: W rows at or
// past `vocab` in ce_probs and ce_dx alike, so whatever the padding holds
// (NaN included: 0 * NaN is NaN) never reaches a gradient, and the padded
// dW rows are written as zeros without reading them.
#include <algorithm>
#include <type_traits>

#include "common.cuh"

using namespace port;

namespace {

constexpr int THREADS = 256;  // 8 warps
constexpr int PAD = 8;        // bf16 padding of a shared row (16 bytes)

// A CTA tile BM x BN with K step BK, a STAGES-deep copy ring, WARPS_M x
// (8 / WARPS_M) warps and at least MIN_BLOCKS CTAs resident per SM.
template <int BM_, int BN_, int BK_, int STAGES_, int WARPS_M_,
          int MIN_BLOCKS_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = 8 / WARPS_M_;
  static constexpr int MIN_BLOCKS = MIN_BLOCKS_;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // warp tile
  static constexpr int MI = WM / 16, NI = WN / 8;
  static_assert(WARPS_M * WARPS_N == 8, "8 warps");
  static_assert(WM % 16 == 0 && WN % 16 == 0, "mma tiles");
  static_assert(BK % 32 == 0, "an even number of 16-deep steps per stage");
  static_assert(STAGES >= 2, "a ring of at least two stages");
};

// The CTA tile of all three kernels, the fastest of those timed on an
// H100 (PERF.md): 128 x 256, BK 64, 3 stages, 2 x 4 warps, one CTA per SM.
using GemmTile = Tile<128, 256, 64, 3, 2, 1>;

// A stored bf16 matrix: `rows` x `cols` entries, cols contiguous, `ld`
// elements between rows. Entries at or past either extent read as zero
// (columns in whole 16-byte vectors of 8).
struct Operand {
  const bf16* ptr;
  long long ld;
  int rows, cols;
};

// This thread's part of copying one operand's [R][C] shared tile (rows
// padded to C + PAD) for K step kt: R C / 8 vectors of 16 bytes, THREADS
// apart, so each thread copies COPIES vectors of one tile column c, rows
// r0, r0 + RSTEP, ... K runs along the tile's columns (K_IN_COLS: the
// operand is K-contiguous) or along its rows; the other coordinate starts
// at `origin` (the CTA's m0 or n0) and is fixed. Addresses and the fixed
// coordinate's bounds are worked out once, before the main loop.
template <int R, int C, bool K_IN_COLS, int BK>
struct StageCopy {
  static constexpr int VEC = C / 8;
  static constexpr int RSTEP = THREADS / VEC;
  static constexpr int COPIES = R / RSTEP;
  static_assert(THREADS % VEC == 0 && R % RSTEP == 0, "whole copy rounds");
  const bf16* src;      // this thread's first vector at K step 0
  const bf16* base;     // a valid address for the zero-filled vectors
  long long row_step;   // elements between this thread's vectors
  long long k_step;     // elements the tile moves per K step
  int r0, c, k_lim;     // first tile row and column; the K extent
  unsigned ok;          // vectors whose fixed coordinate is in the extent

  __device__ __forceinline__ StageCopy(const Operand& op, int origin) {
    r0 = threadIdx.x / VEC;
    c = (threadIdx.x % VEC) * 8;
    base = op.ptr;
    row_step = RSTEP * op.ld;
    ok = 0;
    if (K_IN_COLS) {
#pragma unroll
      for (int it = 0; it < COPIES; ++it) {
        if (origin + r0 + it * RSTEP < op.rows) ok |= 1u << it;
      }
      src = op.ptr + (long long)(origin + r0) * op.ld + c;
      k_step = BK;
      k_lim = op.cols;
    } else {
      if (origin + c < op.cols) ok = (1u << COPIES) - 1;
      src = op.ptr + (long long)r0 * op.ld + origin + c;
      k_step = BK * op.ld;
      k_lim = op.rows;
    }
  }

  __device__ __forceinline__ void copy(bf16* stage, int kt) const {
    const bf16* s = src + kt * k_step;
    bf16* d = stage + r0 * (C + PAD) + c;
#pragma unroll
    for (int it = 0; it < COPIES; ++it) {
      const int k = kt * BK + (K_IN_COLS ? c : r0 + it * RSTEP);
      const bool valid = ((ok >> it) & 1) && k < k_lim;
      cp_async16(d + it * RSTEP * (C + PAD), valid ? s + it * row_step : base,
                 valid);
    }
  }
};

// bytes of shared memory of the ring; an operand's stage is [M or N][BK]
// when K-contiguous, else [BK][M or N], each row padded
template <class T>
__host__ __device__ constexpr int a_stage(bool a_kmajor) {
  return a_kmajor ? T::BM * (T::BK + PAD) : T::BK * (T::BM + PAD);
}
template <class T>
__host__ __device__ constexpr int b_stage(bool b_kmajor) {
  return b_kmajor ? T::BN * (T::BK + PAD) : T::BK * (T::BN + PAD);
}
template <class T, bool A_KMAJOR, bool B_KMAJOR>
__host__ __device__ constexpr int ring_bytes() {
  return T::STAGES * (a_stage<T>(A_KMAJOR) + b_stage<T>(B_KMAJOR)) * 2;
}

// C [M, N] = A [M, K] B [K, N], handed to `epi` as fp32 pairs. A is stored
// [M][K] (A_KMAJOR) or [K][M]; B is stored [N][K] (B_KMAJOR) or [K][N].
// Grid: x over N tiles, y over M tiles.
template <class T, bool A_KMAJOR, bool B_KMAJOR, class Epi>
__global__ void __launch_bounds__(THREADS, T::MIN_BLOCKS)
gemm_kernel(const Operand a, const Operand b, const int K, const Epi epi) {
  constexpr int BM = T::BM, BN = T::BN, BK = T::BK, STAGES = T::STAGES;
  constexpr int MI = T::MI, NI = T::NI;
  constexpr int KS = BK / 16;
  constexpr int A_STAGE = a_stage<T>(A_KMAJOR);
  constexpr int B_STAGE = b_stage<T>(B_KMAJOR);
  constexpr int LDA = A_KMAJOR ? BK + PAD : BM + PAD;
  constexpr int LDB = B_KMAJOR ? BK + PAD : BN + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sA = reinterpret_cast<bf16*>(smem);
  bf16* sB = sA + STAGES * A_STAGE;

  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int wm = (warp % T::WARPS_M) * T::WM;
  const int wn = (warp / T::WARPS_M) * T::WN;
  const int k_tiles = (K + BK - 1) / BK;

  using CopyA = std::conditional_t<A_KMAJOR, StageCopy<BM, BK, true, BK>,
                                   StageCopy<BK, BM, false, BK>>;
  using CopyB = std::conditional_t<B_KMAJOR, StageCopy<BN, BK, true, BK>,
                                   StageCopy<BK, BN, false, BK>>;
  const CopyA copy_a(a, m0);
  const CopyB copy_b(b, n0);
  auto load_stage = [&](int stage, int kt) {
    copy_a.copy(sA + stage * A_STAGE, kt);
    copy_b.copy(sB + stage * B_STAGE, kt);
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < k_tiles) load_stage(s, s);
    cp_async_commit();
  }

  // per-lane ldmatrix offsets within a stage (ks = 0, mi = 0, pair = 0).
  // A fragment rows (m) x k: [m][k] storage reads rows (lane & 15) at k
  // half (lane >> 4); [k][m] storage reads k rows (lane & 7) + 8 (lane >>
  // 4) at m half ((lane >> 3) & 1), transposed. B fragments of two n8
  // tiles: [n][k] storage reads n rows (lane & 7) + 8 (lane >> 4) at k
  // half ((lane >> 3) & 1); [k][n] storage reads k rows (lane & 15) at n
  // half (lane >> 4), transposed. Either way the four registers are b0, b1
  // of the first n8 tile, then b0, b1 of the second.
  const int a_off =
      A_KMAJOR ? (wm + (lane & 15)) * LDA + (lane >> 4) * 8
               : ((lane & 7) + ((lane >> 4) << 3)) * LDA + wm +
                     ((lane >> 3) & 1) * 8;
  const int b_off =
      B_KMAJOR ? (wn + (lane & 7) + ((lane >> 4) << 3)) * LDB +
                     ((lane >> 3) & 1) * 8
               : (lane & 15) * LDB + wn + (lane >> 4) * 8;

  // the A and B fragments of the 16-deep step at ks of a stage
  auto load_frags = [&](uint32_t(&af)[MI][4], uint32_t(&bfr)[NI][2],
                        int stage, int ks) {
    const bf16* tA = sA + stage * A_STAGE + a_off;
    const bf16* tB = sB + stage * B_STAGE + b_off;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
      if (A_KMAJOR) {
        ldmatrix_x4(af[mi], tA + mi * 16 * LDA + ks);
      } else {
        ldmatrix_x4_trans(af[mi], tA + ks * LDA + mi * 16);
      }
    }
#pragma unroll
    for (int nj = 0; nj < NI / 2; ++nj) {
      uint32_t r[4];
      if (B_KMAJOR) {
        ldmatrix_x4(r, tB + nj * 16 * LDB + ks);
      } else {
        ldmatrix_x4_trans(r, tB + ks * LDB + nj * 16);
      }
      bfr[2 * nj][0] = r[0];
      bfr[2 * nj][1] = r[1];
      bfr[2 * nj + 1][0] = r[2];
      bfr[2 * nj + 1][1] = r[3];
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;
    }
  }
  // fragments double-buffered in registers: the next 16-deep step's are
  // loaded before this step's products issue, across stages too
  uint32_t af[2][MI][4];
  uint32_t bfr[2][NI][2];
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  int rs = 0;           // the stage being read
  int ws = STAGES - 1;  // the stage the next copy fills
  load_frags(af[0], bfr[0], 0, 0);
  for (int kt = 0; kt < k_tiles; ++kt) {
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      if (ks == 0) {
        // refill the stage step kt - 1 read: every warp has passed the
        // barrier that follows its last fragment load from it
        const int next = kt + STAGES - 1;
        if (next < k_tiles) load_stage(ws, next);
        cp_async_commit();
        ws = ws + 1 == STAGES ? 0 : ws + 1;
      }
      if (ks == KS - 1) {
        // step kt + 1's copies visible before its first fragments load
        cp_async_wait<STAGES - 2>();
        __syncthreads();
        rs = rs + 1 == STAGES ? 0 : rs + 1;
      }
      load_frags(af[(ks + 1) % 2], bfr[(ks + 1) % 2], rs,
                 ((ks + 1) % KS) * 16);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          mma16816(acc[mi][ni], af[ks % 2][mi], bfr[ks % 2][ni][0],
                   bfr[ks % 2][ni][1]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // the accumulator of (mi, ni) holds rows g and g + 8, columns 2 tg and
  // 2 tg + 1 of its 16 x 8 tile
  const int g = lane >> 2;
  const int tg = lane & 3;
#pragma unroll
  for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm + mi * 16 + g + 8 * h;
      const float rv = epi.row_value(row);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        epi.store(row, n0 + wn + ni * 8 + 2 * tg, rv, acc[mi][ni][2 * h],
                  acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

// ce_probs: C = x W_c^T; stores P = exp2(C log2e - LSE log2e) as bf16 into
// the scratch [n, ldp], zero at columns at or past `live` (padding, and
// the part of a chunk's last tile past its width).
struct ProbsEpi {
  const float* lse;
  bf16* p;
  int n, ldp, live;
  __device__ __forceinline__ float row_value(int row) const {
    return row < n ? lse[row] * LOG2E : 0.f;
  }
  __device__ __forceinline__ void store(int row, int col, float l2, float v0,
                                        float v1) const {
    if (row >= n || col >= ldp) return;
    const float p0 = col < live ? exp2f(v0 * LOG2E - l2) : 0.f;
    const float p1 = col + 1 < live ? exp2f(v1 * LOG2E - l2) : 0.f;
    *reinterpret_cast<__nv_bfloat162*>(p + (long long)row * ldp + col) =
        __floats2bfloat162_rn(p0, p1);
  }
};

// ce_dx: dx [n, d] (+)= C; the first chunk writes
struct DxEpi {
  float* dx;
  int n, d, first;
  __device__ __forceinline__ float row_value(int) const { return 0.f; }
  __device__ __forceinline__ void store(int row, int col, float, float v0,
                                        float v1) const {
    if (row >= n || col >= d) return;
    float2* o = reinterpret_cast<float2*>(dx + (long long)row * d + col);
    if (first) {
      *o = make_float2(v0, v1);
    } else {
      const float2 old = *o;
      *o = make_float2(old.x + v0, old.y + v1);
    }
  }
};

// ce_dw: rows [0, rows) of the chunk's dW [rows, d] = C, zero at rows at
// or past `live`
struct DwEpi {
  float* dw;
  int rows, d, live;
  __device__ __forceinline__ float row_value(int) const { return 0.f; }
  __device__ __forceinline__ void store(int row, int col, float, float v0,
                                        float v1) const {
    if (row >= rows || col >= d) return;
    *reinterpret_cast<float2*>(dw + (long long)row * d + col) =
        row < live ? make_float2(v0, v1) : make_float2(0.f, 0.f);
  }
};

template <class T, bool A_KMAJOR, bool B_KMAJOR, class Epi>
int launch(int device, const Operand& a, const Operand& b, int M, int N,
           int K, const Epi& epi, void* stream) {
  if (device < 0 || device >= MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  constexpr int bytes = ring_bytes<T, A_KMAJOR, B_KMAJOR>();
  auto kernel = gemm_kernel<T, A_KMAJOR, B_KMAJOR, Epi>;
  // the shared-memory opt-in is per device; set it on first use only
  static bool done[MAX_DEVICES] = {};
  if (!done[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    done[device] = true;
  }
  const dim3 grid(std::max(1, (N + T::BN - 1) / T::BN),
                  std::max(1, (M + T::BM - 1) / T::BM));
  kernel<<<grid, THREADS, bytes, static_cast<cudaStream_t>(stream)>>>(
      a, b, K, epi);
  return static_cast<int>(cudaGetLastError());
}

// the chunk's live vocab columns: those below `vocab`
inline int live_cols(int c0, int width, int vocab) {
  return std::max(0, std::min(width, vocab - c0));
}

}  // namespace

// Whether the CE backward takes rows of width D on CUDA device `device`: D
// a positive multiple of 64 (16-byte rows, whole mma tiles) and every
// kernel's copy ring within the device's opt-in shared memory per block.
// Returns 1 or 0, or minus the CUDA error of the query.
extern "C" int ce_bwd_takes(int device, int D) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const int most = std::max({ring_bytes<GemmTile, true, true>(),
                             ring_bytes<GemmTile, true, false>(),
                             ring_bytes<GemmTile, false, false>()});
  return D > 0 && D % 64 == 0 && most <= limit;
}

// One vocabulary chunk [c0, c0 + width) of the backward, width <= ldp.
// x [N, D], w [V, D] bf16 contiguous (rows of w at or past `vocab` are
// padding and never read), lse [N] fp32 (natural log). Writes
// P = exp(x w_c^T - lse) as bf16 into p [N, ldp] (columns at or past the
// chunk's live width zero). Returns the CUDA error of the launch.
extern "C" int ce_probs_bf16(int device, const void* x, const void* w,
                             const void* lse, void* p, int N, int D, int c0,
                             int width, int ldp, int vocab, void* stream) {
  const int live = live_cols(c0, width, vocab);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* wb = static_cast<const bf16*>(w) + (long long)c0 * D;
  const Operand a{xb, D, N, D};
  const Operand b{wb, D, live, D};
  const ProbsEpi epi{static_cast<const float*>(lse), static_cast<bf16*>(p),
                     N, ldp, live};
  return launch<GemmTile, true, true>(device, a, b, N, live, D, epi, stream);
}

// dx [N, D] fp32 += p[:, :live] w[c0 : c0 + live] for the chunk ce_probs
// wrote into p [N, ldp]; `first` writes instead of adding.
extern "C" int ce_dx_bf16(int device, const void* p, const void* w,
                          void* dx, int N, int D, int c0, int width, int ldp,
                          int vocab, int first, void* stream) {
  const int live = live_cols(c0, width, vocab);
  const Operand a{static_cast<const bf16*>(p), ldp, N, live};
  const Operand b{static_cast<const bf16*>(w) + (long long)c0 * D, D, live,
                  D};
  const DxEpi epi{static_cast<float*>(dx), N, D, first};
  return launch<GemmTile, true, false>(device, a, b, N, D, live, epi, stream);
}

// dw rows [c0, c0 + width) fp32 = p[:, :width]^T xg, for the chunk
// ce_probs wrote into p [N, ldp]; xg [N, D] bf16. Rows at or past `vocab`
// are written as zeros.
extern "C" int ce_dw_bf16(int device, const void* p, const void* xg,
                          void* dw, int N, int D, int c0, int width, int ldp,
                          int vocab, void* stream) {
  const int live = live_cols(c0, width, vocab);
  const Operand a{static_cast<const bf16*>(p), ldp, N, live};
  const Operand b{static_cast<const bf16*>(xg), D, N, D};
  const DwEpi epi{static_cast<float*>(dw) + (long long)c0 * D, width, D,
                  live};
  return launch<GemmTile, false, false>(device, a, b, width, D, N, epi,
                                        stream);
}
