// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces ray_tpu/ops/attention.py:_flash_fwd_kernel (launched by
// _flash_fwd_pallas): O = softmax(scale * Q K^T [causal]) V and the
// natural-log row logsumexp, without materialising the [Tq, Tk] scores in
// device memory.
//
// What bounds it on an H100: at the training shapes ([8, 1024, 12, 64]
// and [4, 2048, 12, 64], causal) it does 4 D flops per visible (query,
// key) pair, 25.8 GFLOP at [4, 2048] against ~50 MB: bound by operations
// (26 us at the bf16 peak), and Hopper's tensor cores reach their rate
// only through wgmma fed from shared memory. At the scoring shape ([4,
// 512, 12, 64]) it is bound by bytes (3.8 us at 3.35 TB/s) and, in
// practice, by latency. The design:
//   * one CTA per (batch*head, q tile): at D 64 one consumer warpgroup of
//     64 query rows, three CTAs an SM, so one CTA's softmax overlaps the
//     others' products; at D 128 two warpgroups (128 rows), one CTA an SM.
//     CTAs of the last (longest, under the causal mask) q tiles are
//     launched first;
//   * the Q tile is loaded once by TMA; K and V tiles of 64 keys stream
//     through a three-stage ring by TMA (128-byte swizzle, one mbarrier a
//     stage): one thread issues each load a tile ahead, with one CTA
//     barrier per kv tile and no copy instructions on the other threads;
//   * S = Q K^T by wgmma m64n64k16 with both operands K-major in shared
//     memory; the online softmax runs on the accumulators, its running max
//     on the raw scores, so each P is one FFMA (scale * log2(e) and the
//     max folded in) and one ex2; the mask only on tiles that straddle the
//     causal diagonal or the ragged end of Tk; tiles wholly above the
//     CTA's diagonal are never loaded;
//   * P is re-packed to bf16 in registers (c_to_a) as the A operand of
//     O += P V (wgmma, A from registers), V read MN-major through the
//     descriptor's transpose bit: no operand is copied or transposed;
//   * each warpgroup overlaps its own products with its softmax
//     (FlashAttention-3's intra-warpgroup pipelining): S of tile j is
//     issued together with P V of tile j - 1, and the softmax of tile j
//     runs while that P V is still on the tensor cores. Control flow
//     around every wgmma is the same for the whole CTA: where it differed
//     between warpgroups, ptxas serialized the products (C7520) and the
//     kernel ran markedly slower on an H100;
//   * causal with q_offset = Tk - Tq (queries aligned to the end of the kv
//     sequence); any Tq, Tk: rows and keys past the end are zero-filled by
//     TMA, masked, and never written. The epilogue writes O in bf16 and
//     the LSE for rows < Tq.
// Times on the card against the bound, the mma.sync kernel this replaced
// and SDPA: PERF.md §6 (chip_smoke.py, phase flash_fwd).
#include "common.cuh"

using namespace port;

namespace {

template <int D>
struct FwdCfg {
  // consumer warpgroups of 64 query rows: at D 64 one, three CTAs an
  // SM (on an H100 as fast as two warpgroups and two CTAs an SM at
  // the training shapes, faster at [4, 512]); at D 128 two, one CTA
  // an SM
  static constexpr int NWG = D == 64 ? 1 : 2;
  static constexpr int BQ = 64 * NWG;             // query rows per CTA
  static constexpr int BK = 64;                   // keys per kv tile
  static constexpr int THREADS = 128 * NWG;
  static constexpr int MIN_BLOCKS = D == 64 ? 3 : 1;  // CTAs per SM
  static constexpr int STAGES = 3;                // the K / V ring
  static constexpr int Q_BYTES = BQ * D * 2;
  static constexpr int KV_BYTES = BK * D * 2;     // a K or V tile
  // shared memory, tiles 1024-byte aligned: Q, the K stages, the V
  // stages, then the mbarriers (Q, one a stage)
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + STAGES * KV_BYTES;
  static constexpr int OFF_BAR = OFF_V + STAGES * KV_BYTES;
  // + 1024 for aligning the dynamic shared memory's base
  static constexpr int SMEM = OFF_BAR + 8 * (1 + STAGES) + 1024;
};

// TMA maps: boxes of BQ rows of Q, BK rows of K and V, 64 columns of D
struct FwdMaps {
  CUtensorMap q, k, v;
};

// One thread: the loads of kv tile `kt` into ring stage `stage`.
template <int D>
__device__ __forceinline__ void load_kv(unsigned char* smem,
                                        const FwdMaps& m, uint64_t* full,
                                        int stage, int kt, int b, int h) {
  typedef FwdCfg<D> C;
  unsigned char* sk = smem + C::OFF_K + stage * C::KV_BYTES;
  unsigned char* sv = smem + C::OFF_V + stage * C::KV_BYTES;
  mbar_expect_tx(full, 2 * C::KV_BYTES);
#pragma unroll
  for (int half = 0; half < D / 64; ++half) {
    tma_load_4d(sk + half * C::BK * 128, &m.k, full, half * 64, h,
                kt * C::BK, b);
    tma_load_4d(sv + half * C::BK * 128, &m.v, full, half * 64, h,
                kt * C::BK, b);
  }
}

// 2^x in one MUFU.EX2, results below 2^-126 flushed to zero (exp2f adds a
// range fix-up of three instructions around it)
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Issues S = Q K^T of one kv tile, [64 queries, BK keys], into s: A (this
// warpgroup's Q rows at qA) and B (the K tile at tK) K-major, k-steps of
// 16 along D (32 bytes in a swizzled row; a new 64-column half every 4).
template <int D>
__device__ __forceinline__ void issue_qk(float* s, uint32_t qA, uint32_t tK) {
  typedef FwdCfg<D> C;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t qa = (kk / 4) * C::BQ * 128 + (kk % 4) * 32;
    const uint32_t kb = (kk / 4) * C::BK * 128 + (kk % 4) * 32;
    Wgmma<C::BK>::template ss<0, 0>(s, desc_sw128(qA + qa, 16, 1024),
                                    desc_sw128(tK + kb, 16, 1024), kk > 0);
  }
  wgmma_commit();
}

// Issues O += P V, [64 queries, D]: P from registers (one k16 slice of 16
// keys each), V (the tile at tV) MN-major, k-steps of 16 keys (16 rows,
// 2048 bytes); the second 64-column half of D at BK * 128 bytes.
template <int D>
__device__ __forceinline__ void issue_pv(float* acc, uint32_t (*pa)[4],
                                         uint32_t tV) {
  typedef FwdCfg<D> C;
#pragma unroll
  for (int kk = 0; kk < C::BK / 16; ++kk) {
    Wgmma<D>::template rs<1>(acc, pa[kk],
                             desc_sw128(tV + kk * 2048, C::BK * 128, 1024),
                             1);
  }
  wgmma_commit();
}

// The online softmax of one tile's raw scores s, [64 queries, BK keys]
// (this thread: rows g and g + 8 of its warp's 16, two columns of each n8
// block): masked where `masked` says the tile straddles the causal
// diagonal or the end of Tk; m is the running row max of the raw scores,
// l the partial row sum (this thread's columns). s becomes P =
// 2^(scale_log2 * (s - m)), one FFMA and one ex2 each (scale_log2 >= 0:
// the wrapper flips the sign of q for a negative scale), and alpha the
// factor for O.
template <int BK>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l,
                                             float* alpha, bool masked,
                                             int k0, int qpos0, int Tk,
                                             int causal, int tg,
                                             float scale_log2) {
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked) {
        const int key = k0 + j * 8 + tg * 2 + (e & 1);
        const int qpos = qpos0 + (e >> 1) * 8;
        if (key >= Tk || (causal && key > qpos)) s[4 * j + e] = -INFINITY;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  }
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    // a row with nothing visible yet keeps p = 0 instead of exp2(nan)
    const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
    alpha[r] = exp2_ftz(m[r] == -INFINITY ? -INFINITY
                                          : (m[r] - m_use) * scale_log2);
    neg[r] = -m_use * scale_log2;
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float x = fmaf(s[4 * j + e], scale_log2, neg[e >> 1]);
      // masked scores stay -inf also at scale 0 (where -inf * 0 is nan)
      if (masked && s[4 * j + e] == -INFINITY) x = -INFINITY;
      const float p = exp2_ftz(x);
      s[4 * j + e] = p;
      l[e >> 1] += p;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(FwdCfg<D>::THREADS, FwdCfg<D>::MIN_BLOCKS)
flash_fwd_kernel(const __grid_constant__ FwdMaps maps, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk, int causal,
                 float scale_log2) {
  typedef FwdCfg<D> C;
  constexpr int STAGES = C::STAGES;
  constexpr int BK = C::BK;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sQ = smem_u32(smem);
  const uint32_t sK = sQ + C::OFF_K;
  const uint32_t sV = sQ + C::OFF_V;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::OFF_BAR);

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * C::BQ;  // longest first
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // accumulator row group
  const int tg = lane & 3;   // thread in group
  const int q_offset = Tk - Tq;

  // this warpgroup's 64 rows start at q0 + wg * 64; this thread's two are
  // rows warp * 16 + g (+ 8) of them, rows of the S and O accumulators
  const int row0 = q0 + wg * 64 + warp * 16 + g;
  const int qpos0 = q_offset + row0;
  // kv tiles up to the CTA's diagonal. Every warpgroup computes all of
  // them, and whether a tile is masked depends on the CTA's rows only:
  // control flow that differs between warpgroups around a wgmma makes
  // ptxas serialize the products (warning C7520).
  int n_tiles = (Tk + BK - 1) / BK;
  if (causal) {
    const int last_q = q_offset + min(q0 + C::BQ, Tq) - 1;
    n_tiles = min(n_tiles, last_q / BK + 1);
  }
  auto masked = [&](int k0) {  // the tile straddles a diagonal or Tk
    return (causal && k0 + BK - 1 > q_offset + q0) || k0 + BK > Tk;
  };

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[0], C::Q_BYTES);
#pragma unroll
    for (int half = 0; half < D / 64; ++half) {
      tma_load_4d(smem + half * C::BQ * 128, &maps.q, &bar[0], half * 64, h,
                  q0, b);
    }
    for (int s = 0; s < STAGES - 1 && s < n_tiles; ++s) {
      load_kv<D>(smem, maps, &bar[1 + s], s, s, b, h);
    }
  }

  const uint32_t qA = sQ + wg * 64 * 128;  // this warpgroup's Q rows
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // partial: this thread's columns only
  float alpha[2];
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float s[BK / 2];
  uint32_t pa[BK / 16][4];
  mbar_wait(&bar[0], 0);
  mbar_wait(&bar[1], 0);
  __syncwarp();

  // tile 0
  wgmma_fence();
  issue_qk<D>(s, qA, sK);
  wgmma_wait<0>();
  fence_regs<BK / 2>(s);
  softmax_tile<BK>(s, m, l, alpha, masked(0), 0, qpos0, Tk, causal, tg,
                   scale_log2);
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
    c_to_a(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
  }

  // Tile kt: S of tile kt is computed while P V of tile kt - 1 runs, and
  // its softmax while P V still runs (FlashAttention-3's intra-warpgroup
  // overlap). Tile kt - 1's V is read during iteration kt, so the stage
  // refilled there is tile kt - 2's: loads run STAGES - 2 tiles ahead.
  for (int kt = 1; kt < n_tiles; ++kt) {
    // every warpgroup is done with tile kt - 2's stage
    __syncthreads();
    if (threadIdx.x == 0 && kt + STAGES - 2 < n_tiles) {
      const int t = kt + STAGES - 2;
      load_kv<D>(smem, maps, &bar[1 + t % STAGES], t % STAGES, t, b, h);
    }
    const int k0 = kt * BK;
    mbar_wait(&bar[1 + kt % STAGES], (kt / STAGES) & 1);
    __syncwarp();
    wgmma_fence();
    issue_qk<D>(s, qA, sK + (kt % STAGES) * C::KV_BYTES);
    issue_pv<D>(acc, pa, sV + ((kt - 1) % STAGES) * C::KV_BYTES);
    wgmma_wait<1>();
    fence_regs<BK / 2>(s);
    softmax_tile<BK>(s, m, l, alpha, masked(k0), k0, qpos0, Tk, causal, tg,
                     scale_log2);
    wgmma_wait<0>();
    fence_regs<D / 2>(acc);
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      c_to_a(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
    }
  }
  // the last tile's P V
  wgmma_fence();
  issue_pv<D>(acc, pa, sV + ((n_tiles - 1) % STAGES) * C::KV_BYTES);
  wgmma_wait<0>();
  fence_regs<D / 2>(acc);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + r * 8;
    if (row >= Tq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* out = o + (((long long)b * Tq + row) * H + h) * D + tg * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] * inv,
                                acc[4 * j + 2 * r + 1] * inv);
    }
    if (tg == 0) {
      lse[(long long)bh * Tq + row] =
          (m[r] * scale_log2 + log2f(l[r])) * LN2;
    }
  }
}

// Returns a CUDA error, or TMAP_ERROR + the driver's error if a map was
// refused.
template <int D>
int launch(int device, const bf16* q, const bf16* k, const bf16* v, bf16* o,
           float* lse, int B, int H, int Tq, int Tk, long long qsb,
           long long qst, long long qsh, long long ksb, long long kst,
           long long ksh, long long vsb, long long vst, long long vsh,
           int causal, float scale_log2, cudaStream_t stream) {
  typedef FwdCfg<D> C;
  static bool done[MAX_DEVICES] = {};
  const int n_qt = (Tq + C::BQ - 1) / C::BQ;
  if (n_qt > 65535) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = opt_in(flash_fwd_kernel<D>, C::SMEM, device, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  FwdMaps m;
  int bad = encode_bthd(&m.q, q, B, Tq, H, D, qsb, qst, qsh, C::BQ);
  if (!bad) bad = encode_bthd(&m.k, k, B, Tk, H, D, ksb, kst, ksh, C::BK);
  if (!bad) bad = encode_bthd(&m.v, v, B, Tk, H, D, vsb, vst, vsh, C::BK);
  if (bad) return bad;
  dim3 grid(B * H, n_qt);
  flash_fwd_kernel<D><<<grid, C::THREADS, C::SMEM, stream>>>(
      m, o, lse, H, Tq, Tk, causal, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, H, D] bf16 with unit stride on D, 16-byte
// aligned rows and the given (batch, time, head) strides in elements; o
// [B, Tq, H, D] contiguous bf16; lse [B*H, Tq] fp32, on CUDA device
// `device`. Returns the CUDA error of the launch (0 = launched), or
// 10000 + the driver's error if a TMA map of the inputs was refused.
extern "C" int flash_fwd_bf16(int device, const void* q, const void* k,
                              const void* v, void* o, void* lse, int B,
                              int H, int Tq, int Tk, int D, long long qsb,
                              long long qst, long long qsh, long long ksb,
                              long long kst, long long ksh, long long vsb,
                              long long vst, long long vsh, int causal,
                              float scale_log2, void* stream) {
  if (device < 0 || device >= MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  bf16* op = static_cast<bf16*>(o);
  float* lp = static_cast<float*>(lse);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  if (D == 64) {
    return launch<64>(device, qp, kp, vp, op, lp, B, H, Tq, Tk, qsb, qst,
                      qsh, ksb, kst, ksh, vsb, vst, vsh, causal, scale_log2,
                      s);
  }
  if (D == 128) {
    return launch<128>(device, qp, kp, vp, op, lp, B, H, Tq, Tk, qsb, qst,
                       qsh, ksb, kst, ksh, vsb, vst, vsh, causal,
                       scale_log2, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Dynamic shared memory per CTA in bytes at head_dim D (0 if D is not
// taken).
extern "C" int flash_fwd_smem(int D) {
  return D == 64 ? FwdCfg<64>::SMEM : D == 128 ? FwdCfg<128>::SMEM : 0;
}
