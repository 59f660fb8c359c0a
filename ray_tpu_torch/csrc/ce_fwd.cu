// Fused linear + cross-entropy forward for Hopper (sm_90a), bf16 in.
//
// Replaces ray_tpu/ops/fused_ce.py:_ce_fwd_kernel (launched by
// _ce_fwd_pallas): per-row loss = logsumexp(x W^T) - (x W^T)[target] and
// the row logsumexp, without writing the [N, V] logits to device memory.
//
// What bounds it on an H100: at GPT-2 small's LM head (d = 768, V =
// 50304) it does 2 N V d operations, 158 GFLOP at N = 2048 and 633 GFLOP
// at N = 8192 (0.160 and 0.639 ms at 989 TFLOP/s), against ~80 MB of x
// and W (reading W once takes ~23 us): bound by the tensor cores, which
// reach their rate only through wgmma fed from shared memory. Two more
// limits sit near it. The exponentials: N V ex2, ~1e8 at N = 2048, ~0.028
// ms at 16 a clock per SM, a sixth of the product time. And L2: a CTA
// tile of M rows by Nv vocab columns with full depth d does M Nv / (M +
// Nv) FLOP per byte it reads, 85 at 128 x 256, which at the full rate is
// more than L2 gives; smaller tiles do worse. The design:
//   * a CTA owns a 128-row tile of x and walks a contiguous range of
//     256-wide vocab tiles; per tile the logits [128, 256] are the
//     product of x [128, d] and a W tile [256, d], streamed along d in
//     64-deep k-chunks (x [128, 64] and W [256, 64], 48 KB) through a
//     four-stage TMA ring with 128-byte swizzle, one full and one empty
//     mbarrier a stage;
//   * one producer thread issues the TMA loads; two consumer warpgroups
//     each take 64 rows of the x tile against the same W chunk, wgmma
//     m64n256k16 with both operands in shared memory, 128 fp32
//     accumulators a thread (setmaxnreg gives the consumers 232
//     registers and the producer warpgroup 40). A consumer releases a
//     stage once the next chunk's products are issued and this one's are
//     done, so up to three chunks are in flight ahead of the products;
//   * after a tile's last chunk each consumer folds its accumulators into
//     a running (max, sum-exp, target logit) per row in fp32, log2 domain
//     (one FFMA and one ex2 a logit), masking columns at or past vocab.
//     Meanwhile the producer fills the ring with the next tile's chunks.
//     The two warpgroups wait on the same chunks, so they fold at about
//     the same time and the tensor cores wait for the fold (32768 ex2 a
//     tile, ~1.1 us at 16 a clock, against ~6.7 us of products at the
//     peak); having one fold while the other multiplies would need the
//     ring to hold the lag between them, more than shared memory holds
//     at 48 KB a stage;
//   * TMA zero-fills rows past N and past V and columns past d, so any N,
//     any V and any d that is a multiple of 16 is taken; every branch
//     around a wgmma depends on the tile and chunk counters only
//     (CTA-uniform), so ptxas does not serialize the products;
//   * 128-row tiles alone give 16 CTAs at N = 2048, so the vocabulary is
//     split: `splits` CTAs per row tile, each over `tiles_per_split`
//     vocab tiles (chosen by kernels.ce_fwd_partition: 128 CTAs at N 2048
//     and at N 8192 on 132 SMs); each writes its partial (max, sum,
//     target) per row and a second, tiny kernel merges them.
// The ring (`produce_chunks`) and the tile's products (`tile_products`)
// know nothing of the fold: a GEMM whose A tile is K-major rows of one
// matrix and whose B tile K-major rows of another can reuse them with its
// own epilogue. Times on the card against the bound, the mma.sync kernel
// this replaced and cuBLAS: PERF.md §6 (chip_smoke.py, phase ce_fwd).
#include "common.cuh"

using namespace port;

namespace {

constexpr int BM = 128;       // rows of x per CTA: two warpgroups of 64
constexpr int BV = 256;       // vocab rows of W per tile (wgmma N)
constexpr int BK = 64;        // d per k-chunk: one 128-byte swizzled row
constexpr int STAGES = 4;     // the (x, W) chunk ring
constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int THREADS = 128 * (1 + CONSUMERS);
constexpr int X_BYTES = BM * BK * 2;
constexpr int W_BYTES = BV * BK * 2;
constexpr int STAGE_BYTES = X_BYTES + W_BYTES;
// shared memory: the stages (x chunk, then W chunk, each 1024-byte
// aligned), then the full and the empty mbarriers
constexpr int OFF_BAR = STAGES * STAGE_BYTES;
// + 1024 for aligning the dynamic shared memory's base
constexpr int SMEM = OFF_BAR + 8 * 2 * STAGES + 1024;

// TMA maps: boxes of BM rows of x and BV rows of W, 64 columns of d
struct CeMaps {
  CUtensorMap x, w;
};

// 2^x in one MUFU.EX2, results below 2^-126 flushed to zero
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// One thread: the k-chunks of vocab tiles [t_begin, t_end) against the x
// rows from n0, in order, each into the next ring stage once its last
// chunk's consumers have released it.
__device__ __forceinline__ void produce_chunks(unsigned char* smem,
                                               const CeMaps& maps,
                                               uint64_t* full,
                                               uint64_t* empty, int n0,
                                               int t_begin, int t_end,
                                               int nk) {
  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
    for (int kc = 0; kc < nk; ++kc, ++it) {
      const int s = it % STAGES;
      if (it >= STAGES) mbar_wait(&empty[s], ((it / STAGES) - 1) & 1);
      unsigned char* stage = smem + s * STAGE_BYTES;
      mbar_expect_tx(&full[s], STAGE_BYTES);
      tma_load_2d(stage, &maps.x, &full[s], kc * BK, n0);
      tma_load_2d(stage + X_BYTES, &maps.w, &full[s], kc * BK, t * BV);
    }
  }
}

// One consumer warpgroup: acc = its 64 rows of the x tile times the W
// tile^T, [64, BV] in the wgmma accumulator layout, over the nk chunks
// from ring iteration `it` (advanced past them). Each chunk's stage is
// released (one arrival per warp) once the next chunk's products are
// issued and its own are done; the last on return.
__device__ __forceinline__ void tile_products(float* acc, unsigned char* smem,
                                              uint64_t* full,
                                              uint64_t* empty, int& it,
                                              int nk, int cw, int lane) {
  for (int kc = 0; kc < nk; ++kc, ++it) {
    const int s = it % STAGES;
    mbar_wait(&full[s], (it / STAGES) & 1);
    const uint32_t xa = smem_u32(smem + s * STAGE_BYTES) + cw * 64 * 128;
    const uint32_t wb = smem_u32(smem + s * STAGE_BYTES + X_BYTES);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      Wgmma<BV>::ss<0, 0>(acc, desc_sw128(xa + kk * 32, 16, 1024),
                          desc_sw128(wb + kk * 32, 16, 1024),
                          kc > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<1>();
    if (kc > 0 && lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
  }
  wgmma_wait<0>();
  fence_regs<BV / 2>(acc);
  if (lane == 0) mbar_arrive(&empty[(it - 1) % STAGES]);
}

// Folds one tile's logits (this thread: rows g and g + 8 of its warp's
// 16, two columns of each n8 block from c0 = the tile's first column + 2
// tg) into the running row max m (raw logits), partial sum-exp l (this
// thread's columns, relative to 2^(m log2 e)) and target logit tl.
// Columns at or past vocab are masked where the tile reaches them.
__device__ __forceinline__ void fold_tile(float* acc, float* m, float* l,
                                          float* tl, const int* tgt, int c0,
                                          bool masked, int vocab) {
  // the target logit: only where a row of this warp has its target here
  // (a warp-uniform branch; there is no wgmma inside it)
  bool here = false;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    here |= static_cast<unsigned>(tgt[r] - (c0 & ~(BV - 1))) <
            static_cast<unsigned>(BV);
  }
  if (__any_sync(0xffffffffu, here)) {
#pragma unroll
    for (int j = 0; j < BV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c0 + j * 8 + (e & 1) == tgt[e >> 1]) tl[e >> 1] = acc[4 * j + e];
      }
    }
  }
  if (masked) {
#pragma unroll
    for (int j = 0; j < BV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (c0 + j * 8 + (e & 1) >= vocab) acc[4 * j + e] = -INFINITY;
      }
    }
  }
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], acc[4 * j + e]);
  }
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // a row with every column masked so far keeps l = 0, not exp2(nan)
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    l[r] *= exp2_ftz((m[r] - m_use) * LOG2E);
    m[r] = m_new;
    neg[r] = -m_use * LOG2E;
  }
  // four partial sums (row, column parity) keep the adds' chains short
  float s[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BV / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      s[e] += exp2_ftz(fmaf(acc[4 * j + e], LOG2E, neg[e >> 1]));
    }
  }
  l[0] += s[0] + s[1];
  l[1] += s[2] + s[3];
}

__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_kernel(const __grid_constant__ CeMaps maps,
              const long long* __restrict__ targets,
              float* __restrict__ part, int N, int D, int vocab, int n_vt,
              int tiles_per_split) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + OFF_BAR);
  uint64_t* empty = full + STAGES;

  const int n0 = blockIdx.x * BM;
  const int t_begin = blockIdx.y * tiles_per_split;
  const int t_end = min(n_vt, t_begin + tiles_per_split);
  const int nk = (D + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], CONSUMERS * 4);  // one arrival per warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (wg == 0) {  // the producer warpgroup: one thread loads, the rest exit
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      produce_chunks(smem, maps, full, empty, n0, t_begin, t_end, nk);
    }
    return;
  }
  setmaxnreg_inc<232>();

  const int cw = wg - 1;  // this consumer's 64 rows of the x tile
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int row0 = n0 + cw * 64 + warp * 16 + g;  // and row0 + 8
  int tgt[2];
  float m[2], l[2], tl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    tgt[r] = row < N ? static_cast<int>(targets[row]) : -1;
    m[r] = -INFINITY;
    l[r] = tl[r] = 0.f;
  }
  float acc[BV / 2];
  int it = 0;
  for (int t = t_begin; t < t_end; ++t) {
    tile_products(acc, smem, full, empty, it, nk, cw, lane);
    fold_tile(acc, m, l, tl, tgt, t * BV + 2 * tg, t * BV + BV > vocab,
              vocab);
  }

  // this split's partial per row; part is [3][P][N]: max (log2 units),
  // sum, target logit
  const int P = gridDim.y;
  const int p = blockIdx.y;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], 1);
    tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], 2);
    const int row = row0 + 8 * r;
    if (tg == 0 && row < N) {
      part[(long long)p * N + row] = m[r] * LOG2E;
      part[((long long)P + p) * N + row] = l[r];
      part[((long long)2 * P + p) * N + row] = tl[r];
    }
  }
}

// Merge the P partial (max, sum, target) of each row into loss and LSE.
__global__ void ce_combine_kernel(const float* __restrict__ part,
                                  float* __restrict__ loss,
                                  float* __restrict__ lse, int N, int P) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = -INFINITY;
  for (int p = 0; p < P; ++p) m = fmaxf(m, part[(long long)p * N + row]);
  float l = 0.f;
  float tgt = 0.f;
  for (int p = 0; p < P; ++p) {
    const float lp = part[((long long)P + p) * N + row];
    if (lp > 0.f) l += lp * exp2f(part[(long long)p * N + row] - m);
    tgt += part[((long long)2 * P + p) * N + row];
  }
  const float lse_nat = (m + log2f(l)) * LN2;
  lse[row] = lse_nat;
  loss[row] = lse_nat - tgt;
}

}  // namespace

// Whether ce_fwd takes rows of width D on CUDA device `device`: D a
// positive multiple of 16 (TMA's 16-byte row stride, 16-deep products)
// and the ring within the device's opt-in shared memory per block.
// Returns 1 or 0, or minus the CUDA error of the query.
extern "C" int ce_fwd_takes(int device, int D) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return D > 0 && D % 16 == 0 && SMEM <= limit;
}

// ce_fwd's tile as built: `what` 0 the dynamic shared memory per CTA in
// bytes, 1 the rows of x per CTA, 2 the vocab columns per tile.
extern "C" int ce_fwd_config(int what) {
  return what == 0 ? SMEM : what == 1 ? BM : what == 2 ? BV : 0;
}

// x [N, D] and w [V, D] contiguous, 16-byte aligned bf16 (rows of w at or
// past `vocab` are padding and masked), targets [N] int64; loss, lse [N]
// fp32; part is fp32 scratch of 3 * splits * N floats. The vocab tiles
// of BV columns are split among `splits` CTAs per row tile,
// `tiles_per_split` each (kernels.ce_fwd_partition); every tile must be
// covered and no split empty. On CUDA device `device`; the caller has
// checked D with ce_fwd_takes. Returns the CUDA error of the launches (0
// = launched), or 10000 + the driver's error if a TMA map was refused.
extern "C" int ce_fwd_bf16(int device, const void* x, const void* w,
                           const void* targets, void* loss, void* lse,
                           void* part, int N, int D, int V, int vocab,
                           int splits, int tiles_per_split, void* stream) {
  static bool done[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const int n_vt = (V + BV - 1) / BV;
  if (splits < 1 || splits > 65535 || tiles_per_split < 1 ||
      (long long)splits * tiles_per_split < n_vt ||
      (long long)(splits - 1) * tiles_per_split >= n_vt) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaError_t err = opt_in(ce_fwd_kernel, SMEM, device, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  CeMaps m;
  int bad = encode_2d(&m.x, x, N, D, D, BM);
  if (!bad) bad = encode_2d(&m.w, w, V, D, D, BV);
  if (bad) return bad;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((N + BM - 1) / BM, splits);
  ce_fwd_kernel<<<grid, THREADS, SMEM, s>>>(
      m, static_cast<const long long*>(targets), static_cast<float*>(part), N,
      D, vocab, n_vt, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(loss),
      static_cast<float*>(lse), N, splits);
  return static_cast<int>(cudaGetLastError());
}
