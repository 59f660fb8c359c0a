// Flash-attention backward for Hopper (sm_90a), bf16 in, fp32 accumulation:
// the dQ kernel of the two-pass FlashAttention-2 backward, and one dK/dV
// main loop that serves both the two-pass backward and the single-pass
// (fused) one.
//
// All of them recompute P = exp2(S * scale * log2(e) - LSE * log2(e)) from
// the forward's saved natural-log LSE and read D = rowsum(dO * O)
// (computed outside, fp32):
//   dq:  dQ = scale * sum_kv dS K,            dS = P * (dO V^T - D)
//   dkv: dV = sum_q P^T dO,  dK = scale * sum_q dS^T Q
// without writing P or dS to device memory.
//
// flash_bwd_dq_kernel replaces ray_tpu/ops/attention.py:
// _flash_bwd_dq_kernel (attention.py:197). At GPT-2 small's training shape
// ([8, 1024, 12, 64], causal) it does 19.4 GFLOP (S, dP and dS K over the
// 50.4 M visible (query, key) pairs) against 63.7 MB: 20 us at the bf16
// peak. One CTA per (batch*head, 64 query rows), 4 warps of 16 rows,
// mma.sync m16n8k16 with fp32 accumulators in registers: Q and dO staged
// once and held as A fragments, K/V tiles of 64 keys double-buffered with
// cp.async up to the causal diagonal, the C fragments of dS re-packed in
// registers as the A fragments of dS K (c_to_a), K read again through
// ldmatrix.trans.
//
// flash_bwd_kv_kernel<D, WITH_DQ> replaces _flash_bwd_dkv_kernel
// (attention.py:251; WITH_DQ false: `flash_bwd_dkv`) and
// _flash_bwd_fused_kernel (attention.py:326; WITH_DQ true:
// `flash_bwd_fused`, the single-pass backward, opt-in in JAX with
// RAY_TPU_FLASH_FUSED_BWD=1, here `flash_attention(..., fused_bwd=True)`).
// Both instances run the same instructions in the same order for dK and
// dV, so they agree bit for bit; the fused one adds a dQ stage. Its plain
// version is ops/attention.py:_flash_bwd_reference.
// What bounds them on an H100: dkv at GPT-2's training shape does 25.8
// GFLOP (8 D flops per visible pair) against 75.5 MB, 26 us at the bf16
// peak against 23 us for the bytes; fused at the Llama training shape
// ([4, 2048, 12, 64], causal) 64.4 GFLOP (10 D per pair) against ~0.10
// GB, 65 us against 30 us. Both are bound by operations, and Hopper's
// tensor cores reach their rate only through wgmma, fed from shared
// memory without the issue cost of per-warp fragment loads. The design:
//   * one CTA per (batch*head, BN keys): at D 64 two consumer warpgroups
//     of 64 keys each (BN 128, so each dQ row takes half as many fp32
//     partials as with 64-key tiles: Tk / 128 at T 2048, 16), at D 128
//     one (BN 64), where the registers (dK and dV accumulators, 128 fp32
//     a thread, plus S^T and dP^T, 64) allow no more;
//   * K and V are loaded once by TMA; Q and dO tiles of 64 rows, with
//     their LSE and D rows, stream through a three-stage ring by TMA
//     (128-byte swizzle, one mbarrier per stage) from the first q tile
//     that sees the CTA's keys (the JAX kernel's start_q): one thread
//     issues the loads two tiles ahead while every warpgroup computes,
//     with one CTA barrier per q tile and no copy instructions on the
//     others;
//   * per q tile each warpgroup runs wgmma m64nNk16: S^T = K Q^T and
//     dP^T = V dO^T with both operands in shared memory (K-major); P^T
//     and dS^T = P^T (dP^T - D) on the accumulators in the log2 domain,
//     the mask only on tiles that straddle the causal diagonal or a ragged
//     end; then dV += P^T dO and dK += dS^T Q with A from registers (the
//     bf16 re-pack of the accumulators, c_to_a) and B = dO, Q read
//     MN-major through the descriptor's transpose bit: no operand is
//     copied or transposed;
//   * fused: dS^T goes to shared memory in bf16 (the values dK used,
//     swizzled as TMA would write them); after a barrier each warpgroup
//     computes its D / NWG columns of dQ[64 q, D] = dS K over all BN keys
//     (A = dS^T read transposed, B = the resident K, MN-major), so each
//     partial is added once, into an fp32 [B, Tq, H, D] buffer the caller
//     zero-filled, with float2 atomics from registers (vector
//     red.global.add). The cast to bf16 happens outside, as in JAX
//     (attention.py:464). Atomics add in a different order each run, so
//     dQ's last bits vary from run to run;
//   * causal with q_offset = Tk - Tq (queries aligned to the end of the kv
//     sequence), so tq < tk is taken; any Tq, Tk: rows past the end are
//     zero-filled by TMA, masked, and never written.
// Times on the card against the bound, the mma.sync kernels they replace
// and SDPA's backward: PERF.md §6 (chip_smoke.py, phases flash_bwd and
// flash_bwd_fused).
#include "common.cuh"

using namespace port;

namespace {

constexpr int BT = 64;        // rows of a q tile (and of dq's kv tile)
constexpr int THREADS = 128;  // dq: 4 warps x 16 rows

struct Strides {  // (batch, time, head) strides in elements
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh;
};

template <int D>
struct Layout {
  static constexpr int LD = D + 8;  // bf16 row stride of a staged tile
  static constexpr int TILE = BT * LD;
  static constexpr int dq_bytes = 6 * TILE * 2;  // Q, dO, 2 x K, 2 x V
};

// BT x D bf16 rows (row r at base + (row0 + r) * stride) into a padded
// shared tile with cp.async; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* base,
                                          long long stride, int row0,
                                          int valid) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < BT * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    const bool ok = row0 + r < valid;
    const bf16* src = ok ? base + (long long)(row0 + r) * stride + c : base;
    cp_async16(dst + r * Layout<D>::LD + c, src, ok);
  }
}

// The A fragment (rows r0 and r0 + 8 of a warp's 16, k columns kd*16 +
// [0, 16)) of a padded shared tile.
template <int D>
__device__ __forceinline__ void a_frag(uint32_t* a, const bf16* tile,
                                       int r0, int kd, int tg) {
  const bf16* base = tile + r0 * Layout<D>::LD + kd * 16 + tg * 2;
  a[0] = *reinterpret_cast<const uint32_t*>(base);
  a[1] = *reinterpret_cast<const uint32_t*>(base + 8 * Layout<D>::LD);
  a[2] = *reinterpret_cast<const uint32_t*>(base + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(base + 8 * Layout<D>::LD + 8);
}

// acc[16 rows, W] += A[16 rows, 64] B where B [64, W] is W columns of a
// padded shared tile of width D, read through ldmatrix.trans; `a` holds
// the 4 k-steps' fragments.
template <int D, int W = D>
__device__ __forceinline__ void mma_a_tile(float (*acc)[4],
                                           uint32_t (*a)[4],
                                           const bf16* tile, int lane) {
#pragma unroll
  for (int kk = 0; kk < BT / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < W / 8; j += 2) {
      // four 8x8 transposed tiles: rows kk*16 + [0,8) and [8,16) at
      // columns j*8 (lanes 0-15) and (j+1)*8 (lanes 16-31)
      uint32_t b[4];
      ldmatrix_x4_trans(
          b, tile + (kk * 16 + (lane & 15)) * Layout<D>::LD +
                 (j + (lane >> 4)) * 8);
      mma16816(acc[j], a[kk], b[0], b[1]);
      mma16816(acc[j + 1], a[kk], b[2], b[3]);
    }
  }
}

// P and dS of one score with every rounding pinned by an intrinsic, so no
// compiler contraction differs between kernels: the dq kernel and the
// dK/dV loop's dQ stage then take the same bf16 dS bit for bit (left to
// the compiler, some products were fused in one kernel and not the
// other). x = S * scale * log2(e), rounded, -inf where masked;
// P = 2^(x - LSE * log2(e)) with the subtraction in one fma;
// dS = P (dP - D). The mask goes on the scaled score, before the fma:
// where it followed x = fma(S, scale, -LSE * log2(e)), ptxas hoisted the
// mask's predicates in front of the dK/dV loop's S^T wgmma, and dkv ran
// ~18 % slower.
__device__ __forceinline__ float score_scaled(float s, float scale_log2) {
  return __fmul_rn(s, scale_log2);
}
__device__ __forceinline__ float score_p(float x, float lse) {
  return exp2f(__fmaf_rn(-lse, LOG2E, x));
}
__device__ __forceinline__ float score_ds(float p, float dp, float dc) {
  return __fmul_rn(p, __fsub_rn(dp, dc));
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ dcor, bf16* __restrict__ dq,
                    int H, int Tq, int Tk, Strides st, int causal,
                    float scale_log2, float scale) {
  typedef Layout<D> L;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sO = sQ + L::TILE;      // dO
  bf16* sK = sO + L::TILE;      // 2 buffers
  bf16* sV = sK + 2 * L::TILE;  // 2 buffers

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int q_offset = Tk - Tq;

  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  const bf16* ob = dout + b * st.ob + h * st.oh;

  int n_tiles = (Tk + BT - 1) / BT;
  int n_full = n_tiles;  // tiles that need no causal mask
  if (causal) {
    const int last_q = q_offset + min(q0 + BT, Tq) - 1;
    n_tiles = min(n_tiles, last_q / BT + 1);
    n_full = (q_offset + q0 + 1) / BT;
  }

  load_tile<D>(sQ, qb, st.qt, q0, Tq);
  load_tile<D>(sO, ob, st.ot, q0, Tq);
  load_tile<D>(sK, kb, st.kt, 0, Tk);
  load_tile<D>(sV, vb, st.vt, 0, Tk);
  cp_async_commit();

  // this thread's two rows within the q tile: r0 and r0 + 8
  const int r0 = warp * 16 + g;
  const int qpos0 = q_offset + q0 + r0;
  float lse_r[2], dc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    lse_r[r] = row < Tq ? lse[(long long)bh * Tq + row] : 0.f;
    dc[r] = row < Tq ? dcor[(long long)bh * Tq + row] : 0.f;
  }
  float acc[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  }
  uint32_t qf[D / 16][4], of[D / 16][4];

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_tile<D>(sK + (buf ^ 1) * L::TILE, kb, st.kt, (kt + 1) * BT, Tk);
      load_tile<D>(sV + (buf ^ 1) * L::TILE, vb, st.vt, (kt + 1) * BT, Tk);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        a_frag<D>(qf[kd], sQ, r0, kd, tg);
        a_frag<D>(of[kd], sO, r0, kd, tg);
      }
    }
    const bf16* tK = sK + buf * L::TILE;
    const bf16* tV = sV + buf * L::TILE;
    const int k0 = kt * BT;

    // S = Q K^T and dP = dO V^T, [16 rows, 64 keys] in 8 tiles of 8 keys
    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
      const bf16* krow = tK + (j * 8 + g) * LD + tg * 2;
      const bf16* vrow = tV + (j * 8 + g) * LD + tg * 2;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        mma16816(s[j], qf[kd],
                 *reinterpret_cast<const uint32_t*>(krow + kd * 16),
                 *reinterpret_cast<const uint32_t*>(krow + kd * 16 + 8));
        mma16816(dp[j], of[kd],
                 *reinterpret_cast<const uint32_t*>(vrow + kd * 16),
                 *reinterpret_cast<const uint32_t*>(vrow + kd * 16 + 8));
      }
    }

    // dS = P * (dP - D), P recomputed from the LSE (log2 domain)
    const bool masked = (causal && kt >= n_full) || (k0 + BT > Tk);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = score_scaled(s[j][e], scale_log2);
        if (masked) {
          const int key = k0 + j * 8 + tg * 2 + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          if (key >= Tk || (causal && key > qpos)) x = -INFINITY;
        }
        s[j][e] =
            score_ds(score_p(x, lse_r[e >> 1]), dp[j][e], dc[e >> 1]);
      }
    }

    // dQ[16 rows, D] += dS K: dS's C fragments are the A fragments
    uint32_t ds[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      c_to_a(ds[kk], s[2 * kk], s[2 * kk + 1]);
    }
    mma_a_tile<D>(acc, ds, tK, lane);
    __syncthreads();  // this buffer is refilled two tiles from now
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= Tq) continue;
    bf16* out = dq + (((long long)b * Tq + row) * H + h) * D + tg * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
          __floats2bfloat162_rn(acc[j][2 * r] * scale,
                                acc[j][2 * r + 1] * scale);
    }
  }
}

// ---- the dK/dV main loop (wgmma + TMA) ----

template <int D>
struct KvCfg {
  static constexpr int NWG = D == 64 ? 2 : 1;  // consumer warpgroups
  static constexpr int BN = 64 * NWG;          // keys per CTA
  static constexpr int THREADS = 128 * NWG;
  static constexpr int STAGES = 3;             // the Q / dO ring
  static constexpr int KV_BYTES = BN * D * 2;  // K or V
  static constexpr int Q_BYTES = BT * D * 2;   // a Q or dO tile
  static constexpr int ROW_BYTES = BT * 4;     // a q tile's LSE or D
  static constexpr int STAGE_TX = 2 * Q_BYTES + 2 * ROW_BYTES;
  static constexpr int DS_BYTES = BN * BT * 2;  // dS^T in bf16
  static constexpr int DQ_COLS = D / NWG;       // dQ columns a warpgroup
  static constexpr int NC = DQ_COLS < 64 ? DQ_COLS : 64;  // a product's
  // shared memory, tiles 1024-byte aligned: K, V, the Q and dO stages,
  // dS^T (fused only), the LSE and D stages, then the mbarriers (K/V, one
  // a stage)
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_O = OFF_Q + STAGES * Q_BYTES;
  static constexpr int OFF_S = OFF_O + STAGES * Q_BYTES;
  __host__ __device__ static constexpr int off_lse(bool with_dq) {
    return OFF_S + (with_dq ? DS_BYTES : 0);
  }
  __host__ __device__ static constexpr int off_dcor(bool with_dq) {
    return off_lse(with_dq) + STAGES * ROW_BYTES;
  }
  __host__ __device__ static constexpr int off_bar(bool with_dq) {
    return off_dcor(with_dq) + STAGES * ROW_BYTES;
  }
  // + 1024 for aligning the dynamic shared memory's base
  __host__ __device__ static constexpr int smem_bytes(bool with_dq) {
    return off_bar(with_dq) + 8 * (1 + STAGES) + 1024;
  }
};

// TMA maps: boxes of Q, dO (64 rows) and K, V (BN rows), 64 columns of D
// each; the LSE and D rows of a q tile
struct KvMaps {
  CUtensorMap q, k, v, o, lse, dcor;
};

// p[0] += x, p[1] += y in device memory, p 8-byte aligned (one vector
// red.global.add: the result is not read)
__device__ __forceinline__ void atomic_add2(float* p, float x, float y) {
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
}

// One thread: the loads of q tile `qt` into ring stage `stage`.
template <int D, bool WITH_DQ>
__device__ __forceinline__ void load_stage(unsigned char* smem,
                                           const KvMaps& m, int stage,
                                           int qt, int bh, int b, int h,
                                           int Tq) {
  typedef KvCfg<D> C;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(smem + C::off_bar(WITH_DQ)) + 1 + stage;
  unsigned char* sq = smem + C::OFF_Q + stage * C::Q_BYTES;
  unsigned char* so = smem + C::OFF_O + stage * C::Q_BYTES;
  mbar_expect_tx(full, C::STAGE_TX);
#pragma unroll
  for (int half = 0; half < D / 64; ++half) {
    tma_load_4d(sq + half * BT * 128, &m.q, full, half * 64, h, qt * BT, b);
    tma_load_4d(so + half * BT * 128, &m.o, full, half * 64, h, qt * BT, b);
  }
  const int row = bh * Tq + qt * BT;
  tma_load_1d(smem + C::off_lse(WITH_DQ) + stage * C::ROW_BYTES, &m.lse,
              full, row);
  tma_load_1d(smem + C::off_dcor(WITH_DQ) + stage * C::ROW_BYTES, &m.dcor,
              full, row);
}

template <int D, bool WITH_DQ>
__global__ void __launch_bounds__(KvCfg<D>::THREADS, 1)
flash_bwd_kv_kernel(const __grid_constant__ KvMaps maps,
                    float* __restrict__ dq, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int H, int Tq, int Tk, int causal,
                    float scale_log2, float scale) {
  typedef KvCfg<D> C;
  constexpr int STAGES = C::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  const uint32_t sK = smem_u32(smem);
  const uint32_t sV = sK + C::OFF_V;
  const uint32_t sQ = sK + C::OFF_Q;
  const uint32_t sO = sK + C::OFF_O;
  const uint32_t sS = sK + C::OFF_S;
  const float* sL =
      reinterpret_cast<const float*>(smem + C::off_lse(WITH_DQ));
  const float* sD =
      reinterpret_cast<const float*>(smem + C::off_dcor(WITH_DQ));
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + C::off_bar(WITH_DQ));

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * C::BN;
  const int wg = threadIdx.x / 128;
  const int warp = (threadIdx.x / 32) % 4;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int q_offset = Tk - Tq;
  const int n_qt = (Tq + BT - 1) / BT;
  // q tiles before start_q see none of these keys (attention.py:272-280;
  // the max(0, .) is the clamp that keeps tq < tk off a phantom tile)
  const int start_q = causal ? max(0, k0 - q_offset) / BT : 0;
  const int n_it = n_qt - start_q;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 1 + STAGES; ++i) mbar_init(&bar[i], 1);
    mbar_init_fence();
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(&bar[0], 2 * C::KV_BYTES);
#pragma unroll
    for (int half = 0; half < D / 64; ++half) {
      tma_load_4d(smem + half * C::BN * 128, &maps.k, &bar[0], half * 64, h,
                  k0, b);
      tma_load_4d(smem + C::OFF_V + half * C::BN * 128, &maps.v, &bar[0],
                  half * 64, h, k0, b);
    }
    for (int s = 0; s < STAGES - 1 && s < n_it; ++s) {
      load_stage<D, WITH_DQ>(smem, maps, s, start_q + s, bh, b, h, Tq);
    }
  }

  // this warpgroup's 64 keys start at kw0; this thread's two keys are
  // kw0 + warp * 16 + g (+ 8), rows of the S^T accumulator
  const int kw0 = k0 + wg * 64;
  const int key0 = kw0 + warp * 16 + g;
  const uint32_t kA = sK + wg * 64 * 128;  // this warpgroup's K rows
  const uint32_t vA = sV + wg * 64 * 128;
  float acc_dk[D / 2], acc_dv[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_dk[i] = acc_dv[i] = 0.f;
  mbar_wait(&bar[0], 0);
  __syncwarp();

  for (int it = 0; it < n_it; ++it) {
    const int qt = start_q + it;
    const int stage = it % STAGES;
    // every warpgroup is done with the stage refilled here (it waited for
    // its products at the end of the last q tile)
    __syncthreads();
    if (threadIdx.x == 0 && it + STAGES - 1 < n_it) {
      load_stage<D, WITH_DQ>(smem, maps, (it + STAGES - 1) % STAGES,
                             qt + STAGES - 1, bh, b, h, Tq);
    }
    mbar_wait(&bar[1 + stage], (it / STAGES) & 1);
    __syncwarp();
    const uint32_t tQ = sQ + stage * C::Q_BYTES;
    const uint32_t tO = sO + stage * C::Q_BYTES;

    // S^T = K Q^T and dP^T = V dO^T, [64 keys, 64 queries] each: A and B
    // K-major, k-steps of 16 along D (32 bytes in a swizzled row; a new
    // 64-column half every 4)
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ka = (kk / 4) * C::BN * 128 + (kk % 4) * 32;
      const uint32_t qb = (kk / 4) * BT * 128 + (kk % 4) * 32;
      Wgmma<64>::ss<0, 0>(s, desc_sw128(kA + ka, 16, 1024),
                          desc_sw128(tQ + qb, 16, 1024), kk > 0);
    }
    wgmma_commit();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t ka = (kk / 4) * C::BN * 128 + (kk % 4) * 32;
      const uint32_t qb = (kk / 4) * BT * 128 + (kk % 4) * 32;
      Wgmma<64>::ss<0, 0>(dp, desc_sw128(vA + ka, 16, 1024),
                          desc_sw128(tO + qb, 16, 1024), kk > 0);
    }
    wgmma_commit();

    // P^T (log2 domain) while dP^T is computed; LSE and D per column
    const float* lse = sL + stage * BT;
    const float* dcor = sD + stage * BT;
    const bool masked = (causal && q_offset + qt * BT < kw0 + 63) ||
                        (qt * BT + BT > Tq) || (kw0 + 64 > Tk);
    wgmma_wait<1>();
    fence_regs<32>(s);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tg * 2 + (e & 1);
        float x = score_scaled(s[4 * j + e], scale_log2);
        if (masked) {
          const int key = key0 + (e >> 1) * 8;
          const int qi = qt * BT + col;
          if (qi >= Tq || key >= Tk || (causal && q_offset + qi < key)) {
            x = -INFINITY;
          }
        }
        s[4 * j + e] = score_p(x, lse[col]);
      }
    }
    wgmma_wait<0>();
    fence_regs<32>(dp);
    // dS^T = P^T * (dP^T - D); both re-packed in bf16 as A fragments, one
    // k16 slice (16 queries) each
    uint32_t pa[BT / 16][4], da[BT / 16][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tg * 2 + (e & 1);
        dp[4 * j + e] = score_ds(s[4 * j + e], dp[4 * j + e], dcor[col]);
      }
    }
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      c_to_a(pa[kk], &s[8 * kk], &s[8 * kk + 4]);
      c_to_a(da[kk], &dp[8 * kk], &dp[8 * kk + 4]);
    }

    // dV += P^T dO and dK += dS^T Q, [64 keys, D]: B = dO, Q MN-major,
    // k-steps of 16 queries (16 rows, 2048 bytes); the second 64-column
    // half of D at BT * 128 bytes
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      Wgmma<D>::template rs<1>(acc_dv, pa[kk],
                               desc_sw128(tO + kk * 2048, BT * 128, 1024), 1);
    }
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      Wgmma<D>::template rs<1>(acc_dk, da[kk],
                               desc_sw128(tQ + kk * 2048, BT * 128, 1024), 1);
    }
    wgmma_commit();

    if constexpr (WITH_DQ) {
      // this thread's rows of dS^T (the bf16 values dK takes) into the
      // [BN keys, 64 queries] tile, 128-byte swizzled: row r's 16-byte
      // chunk j at j ^ (r % 8), and r % 8 == g
      unsigned char* rowp =
          smem + C::OFF_S + (wg * 64 + warp * 16 + g) * 128 + 4 * tg;
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        const int c0 = ((2 * kk) ^ g) << 4;
        const int c1 = ((2 * kk + 1) ^ g) << 4;
        *reinterpret_cast<uint32_t*>(rowp + c0) = da[kk][0];
        *reinterpret_cast<uint32_t*>(rowp + 8 * 128 + c0) = da[kk][1];
        *reinterpret_cast<uint32_t*>(rowp + c1) = da[kk][2];
        *reinterpret_cast<uint32_t*>(rowp + 8 * 128 + c1) = da[kk][3];
      }
      fence_proxy_async();
      __syncthreads();  // every warpgroup's rows of dS^T are in place

      // dQ[64 queries, this warpgroup's columns] = scale * dS K over the
      // BN keys: A = dS^T MN-major, B = K MN-major, k-steps of 16 keys
      const int qrow = qt * BT + warp * 16 + g;
#pragma unroll
      for (int c = 0; c < C::DQ_COLS; c += C::NC) {
        const int col0 = wg * C::DQ_COLS + c;
        const uint32_t kB = sK + (col0 / 64) * C::BN * 128 + (col0 % 64) * 2;
        float acc[C::NC / 2];
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < C::BN / 16; ++kk) {
          Wgmma<C::NC>::template ss<1, 1>(
              acc, desc_sw128(sS + kk * 2048, 1024, 1024),
              desc_sw128(kB + kk * 2048, C::BN * 128, 1024), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<C::NC / 2>(acc);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int row = qrow + r * 8;
          if (row >= Tq) continue;
          float* out =
              dq + (((long long)b * Tq + row) * H + h) * D + col0 + tg * 2;
#pragma unroll
          for (int j = 0; j < C::NC / 8; ++j) {
            atomic_add2(out + j * 8, acc[4 * j + 2 * r] * scale,
                        acc[4 * j + 2 * r + 1] * scale);
          }
        }
      }
    }
    wgmma_wait<0>();
    fence_regs<D / 2>(acc_dk);
    fence_regs<D / 2>(acc_dv);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = key0 + r * 8;
    if (key >= Tk) continue;
    const long long at = (((long long)b * Tk + key) * H + h) * D + tg * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + j * 8) =
          __floats2bfloat162_rn(acc_dk[4 * j + 2 * r] * scale,
                                acc_dk[4 * j + 2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + j * 8) =
          __floats2bfloat162_rn(acc_dv[4 * j + 2 * r],
                                acc_dv[4 * j + 2 * r + 1]);
    }
  }
}

template <typename Kernel>
cudaError_t opt_in(Kernel kernel, int bytes, int device, bool* done) {
  // the shared-memory opt-in is per device; set it on first use only
  if (done[device]) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) done[device] = true;
  return err;
}

template <int D>
cudaError_t launch_dq(int device, const bf16* q, const bf16* k,
                      const bf16* v, const bf16* dout, const float* lse,
                      const float* dcor, bf16* dq, int B, int H, int Tq,
                      int Tk, const Strides& st, int causal,
                      float scale_log2, float scale, cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  const int bytes = Layout<D>::dq_bytes;
  cudaError_t err = opt_in(flash_bwd_dq_kernel<D>, bytes, device, done);
  if (err != cudaSuccess) return err;
  dim3 grid((Tq + BT - 1) / BT, B * H);
  flash_bwd_dq_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, dcor, dq, H, Tq, Tk, st, causal, scale_log2,
      scale);
  return cudaGetLastError();
}

// The dK/dV main loop; dq is null for the two-pass instance. Returns a
// CUDA error, or TMAP_ERROR + the driver's error if a map was refused.
template <int D, bool WITH_DQ>
int launch_kv(int device, const bf16* q, const bf16* k, const bf16* v,
              const bf16* dout, const float* lse, const float* dcor,
              float* dq, bf16* dk, bf16* dv, int B, int H, int Tq, int Tk,
              const Strides& st, int causal, float scale_log2, float scale,
              cudaStream_t stream) {
  typedef KvCfg<D> C;
  static bool done[MAX_DEVICES] = {};
  constexpr int bytes = C::smem_bytes(WITH_DQ);
  cudaError_t err =
      opt_in(flash_bwd_kv_kernel<D, WITH_DQ>, bytes, device, done);
  if (err != cudaSuccess) return static_cast<int>(err);
  KvMaps m;
  int bad = encode_bthd(&m.q, q, B, Tq, H, D, st.qb, st.qt, st.qh, BT);
  if (!bad) bad = encode_bthd(&m.o, dout, B, Tq, H, D, st.ob, st.ot, st.oh,
                              BT);
  if (!bad) bad = encode_bthd(&m.k, k, B, Tk, H, D, st.kb, st.kt, st.kh,
                              C::BN);
  if (!bad) bad = encode_bthd(&m.v, v, B, Tk, H, D, st.vb, st.vt, st.vh,
                              C::BN);
  const long long rows = (long long)B * H * Tq;
  if (!bad) bad = encode_f32_1d(&m.lse, lse, rows, BT);
  if (!bad) bad = encode_f32_1d(&m.dcor, dcor, rows, BT);
  if (bad) return bad;
  dim3 grid((Tk + C::BN - 1) / C::BN, B * H);
  flash_bwd_kv_kernel<D, WITH_DQ><<<grid, C::THREADS, bytes, stream>>>(
      m, dq, dk, dv, H, Tq, Tk, causal, scale_log2, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, dO [B, Tq, H, D] and k, v [B, Tk, H, D] bf16 with unit stride on D and
// the given (batch, time, head) strides in elements; lse (natural log) and
// dcor = rowsum(dO * O) [B*H, Tq] fp32; dq [B, Tq, H, D] contiguous bf16,
// on CUDA device `device`. scale_log2 = sm_scale * log2(e). Returns the
// CUDA error of the launch (0 = launched).
extern "C" int flash_bwd_dq_bf16(
    int device, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dcor, void* dq, int B,
    int H, int Tq, int Tk, int D, long long qsb, long long qst,
    long long qsh, long long ksb, long long kst, long long ksh,
    long long vsb, long long vst, long long vsh, long long osb,
    long long ost, long long osh, int causal, float scale_log2, float scale,
    void* stream) {
  if (device < 0 || device >= MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const Strides st{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                   osb, ost, osh};
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(dcor);
  bf16* out = static_cast<bf16*>(dq);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return launch_dq<64>(device, qp, kp, vp, op, lp, dp, out, B, H, Tq, Tk,
                         st, causal, scale_log2, scale, s);
  }
  if (D == 128) {
    return launch_dq<128>(device, qp, kp, vp, op, lp, dp, out, B, H, Tq, Tk,
                          st, causal, scale_log2, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

namespace {

template <bool WITH_DQ>
int launch_kv_bf16(int device, const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* dcor,
                   void* dq, void* dk, void* dv, int B, int H, int Tq,
                   int Tk, int D, const Strides& st, int causal,
                   float scale_log2, float scale, void* stream) {
  if (device < 0 || device >= MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const bf16* qp = static_cast<const bf16*>(q);
  const bf16* kp = static_cast<const bf16*>(k);
  const bf16* vp = static_cast<const bf16*>(v);
  const bf16* op = static_cast<const bf16*>(dout);
  const float* lp = static_cast<const float*>(lse);
  const float* dp = static_cast<const float*>(dcor);
  float* dqp = static_cast<float*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return launch_kv<64, WITH_DQ>(device, qp, kp, vp, op, lp, dp, dqp, dkp,
                                  dvp, B, H, Tq, Tk, st, causal, scale_log2,
                                  scale, s);
  }
  if (D == 128) {
    return launch_kv<128, WITH_DQ>(device, qp, kp, vp, op, lp, dp, dqp, dkp,
                                   dvp, B, H, Tq, Tk, st, causal, scale_log2,
                                   scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// As flash_bwd_dq_bf16, with lse and dcor 16-byte aligned; dk, dv
// [B, Tk, H, D] contiguous bf16. The dK/dV main loop without its dQ stage.
// Returns the CUDA error of the launch, or 10000 + the driver's error if
// a TMA map of the inputs was refused.
extern "C" int flash_bwd_dkv_bf16(
    int device, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dcor, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int D, long long qsb,
    long long qst, long long qsh, long long ksb, long long kst,
    long long ksh, long long vsb, long long vst, long long vsh,
    long long osb, long long ost, long long osh, int causal,
    float scale_log2, float scale, void* stream) {
  const Strides st{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                   osb, ost, osh};
  return launch_kv_bf16<false>(device, q, k, v, dout, lse, dcor, nullptr, dk,
                               dv, B, H, Tq, Tk, D, st, causal, scale_log2,
                               scale, stream);
}

// As flash_bwd_dkv_bf16, plus dq [B, Tq, H, D] contiguous fp32, zero-filled
// by the caller: the kernel adds scale * dS K into it (atomics), dk and dv
// it writes. The single-pass backward: the same main loop with its dQ
// stage.
extern "C" int flash_bwd_fused_bf16(
    int device, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dcor, void* dq,
    void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
    long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, long long osb, long long ost, long long osh, int causal,
    float scale_log2, float scale, void* stream) {
  const Strides st{qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                   osb, ost, osh};
  return launch_kv_bf16<true>(device, q, k, v, dout, lse, dcor, dq, dk, dv,
                              B, H, Tq, Tk, D, st, causal, scale_log2, scale,
                              stream);
}

// The dK/dV main loop's keys per CTA at head_dim D (0 if D is not taken).
extern "C" int flash_bwd_kv_keys(int D) {
  return D == 64 ? KvCfg<64>::BN : D == 128 ? KvCfg<128>::BN : 0;
}

// Its dynamic shared memory per CTA in bytes, without (0) or with (1) the
// dQ stage (0 if D is not taken).
extern "C" int flash_bwd_kv_smem(int D, int with_dq) {
  if (D == 64) return KvCfg<64>::smem_bytes(with_dq != 0);
  if (D == 128) return KvCfg<128>::smem_bytes(with_dq != 0);
  return 0;
}
