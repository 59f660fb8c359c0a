// Flash-attention backward for Hopper (sm_90a), bf16 in, fp32 accumulation:
// the two kernels of the two-pass FlashAttention-2 backward, and the
// single-pass (fused) one below them.
//
// Replaces ray_tpu/ops/attention.py:_flash_bwd_dq_kernel and
// _flash_bwd_dkv_kernel (launched by _flash_bwd_pallas). Both recompute
// P = exp2(S * scale * log2(e) - LSE * log2(e)) from the forward's saved
// natural-log LSE and read D = rowsum(dO * O) (computed outside, fp32):
//   dq:  dQ = scale * sum_kv dS K,            dS = P * (dO V^T - D)
//   dkv: dV = sum_q P^T dO,  dK = scale * sum_q dS^T Q
// without writing P or dS to device memory.
//
// What bounds them on an H100: at GPT-2 small's training shape
// ([8, 1024, 12, 64], causal) dq does 19.4 GFLOP (S, dP and dS K over the
// 50.4 M visible (query, key) pairs) against 63.7 MB, dkv 25.8 GFLOP
// (S^T, dP^T, P^T dO and dS^T Q) against 75.5 MB: ~300-340 FLOP per byte,
// at the card's ridge, so the tensor cores and the memory bound them
// about equally (~20-26 us). A simple kernel fights latency, so both keep
// the design of flash_fwd.cu:
//   * 4 warps per CTA, each owning 16 rows of a 64-row tile, mma.sync
//     m16n8k16 bf16 products with fp32 accumulators in registers; the C
//     fragments of a score tile are re-packed in registers as the A
//     fragments of the next product (P, dS: c_to_a), so no score tile
//     touches shared memory;
//   * dq: one CTA per (batch*head, 64 query rows). Q and dO are staged
//     once and held as A fragments; K/V tiles of 64 keys are
//     double-buffered with cp.async up to the causal diagonal; K is read
//     a second time, transposed by ldmatrix.trans, as the B operand of
//     dS K;
//   * dkv: one CTA per (batch*head, 64 keys). K and V stay in shared
//     memory as the A operands of S^T = K Q^T and dP^T = V dO^T; Q and dO
//     tiles (and their LSE and D) stream in from the first q tile that
//     sees the key tile (the JAX kernel's start_q), double-buffered with
//     cp.async, and are read again through ldmatrix.trans as the B
//     operands of P^T dO and dS^T Q; dK and dV accumulate in registers;
//   * causal with q_offset = Tk - Tq (queries aligned to the end of the kv
//     sequence), so tq < tk is taken; only tiles that straddle the
//     diagonal or a ragged end pay for the mask. Any Tq, Tk: rows past
//     the end are zero-filled and masked, and never written.
//
// A third kernel, fused, replaces ray_tpu/ops/attention.py:
// _flash_bwd_fused_kernel (the single-pass backward, opt-in there with
// RAY_TPU_FLASH_FUSED_BWD=1; here `flash_attention(..., fused_bwd=True)`):
// for each kv tile it computes dK, dV AND that tile's contributions to
// dQ, forming S once per (q tile, kv tile) pair: 5 products where dq +
// dkv take 7. Its plain version is the same as the two kernels'
// (ops/attention.py:_flash_bwd_reference, which computes dQ, dK, dV
// from O and the LSE). The TPU kernel keeps dQ as an output revisited by
// a grid that runs in order; CTAs here run in parallel, so:
//   * fused: one CTA per (batch*head, 64 keys), the dkv kernel's loop over
//     q tiles; after dK += dS^T Q each warp stores its 16 rows of dS^T
//     (bf16, the A fragments dK used) into a shared tile, and after a
//     barrier each warp reads 16 query rows of dS back through
//     ldmatrix.trans and multiplies them by the resident K tile
//     (ldmatrix.trans again), 64 columns of D at a time so head_dim 128
//     holds 32 extra accumulators, not 64; the partial dQ [64, D] is
//     added to an fp32 [B, Tq, H, D] buffer the caller zero-filled, with
//     float2 atomicAdd (sm_90 and up). Its cast to bf16 happens
//     outside, as in JAX (attention.py:464). Atomics add in a different
//     order each run, so dQ's last bits vary from run to run.
// What bounds it: at the Llama training shape ([4, 2048, 12, 64], causal)
// 10 * D flops per visible (query, key) pair, 64.4 GFLOP (65 us at the
// bf16 peak) against ~0.10 GB (q, k, v, dO read, dK, dV written in bf16,
// dQ in fp32; 30 us): operations, and the atomics' L2 traffic (each kv
// tile adds a [64, D] fp32 partial per q tile it sees: ~0.4 GB of
// read-modify-write at that shape) is the cost of not running in order.
#include "common.cuh"

using namespace port;

namespace {

constexpr int BT = 64;        // rows of a q tile and of a kv tile
constexpr int THREADS = 128;  // 4 warps x 16 rows

struct Strides {  // (batch, time, head) strides in elements
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh, ob, ot, oh;
};

template <int D>
struct Layout {
  static constexpr int LD = D + 8;  // bf16 row stride of a staged tile
  static constexpr int TILE = BT * LD;
  // dq: Q, dO, 2 x K, 2 x V; dkv: K, V, 2 x Q, 2 x dO, then LSE and D;
  // fused: dkv's, then the dS^T tile [64 keys, 64 queries]
  static constexpr int dq_bytes = 6 * TILE * 2;
  static constexpr int dkv_bytes = 6 * TILE * 2 + 2 * BT * 4;
  static constexpr int fused_bytes = dkv_bytes + BT * (BT + 8) * 2;
};

constexpr int LDS = BT + 8;  // bf16 row stride of the staged dS^T tile

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
  float lse2[2], dc[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    lse2[r] = row < Tq ? lse[(long long)bh * Tq + row] * LOG2E : 0.f;
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
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + j * 8 + tg * 2 + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          if (key >= Tk || (causal && key > qpos)) x = -INFINITY;
        }
        const float p = exp2f(x - lse2[e >> 1]);
        s[j][e] = p * (dp[j][e] - dc[e >> 1]);
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

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ dcor, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int H, int Tq, int Tk,
                     Strides st, int causal, float scale_log2, float scale) {
  typedef Layout<D> L;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + L::TILE;
  bf16* sQ = sV + L::TILE;      // 2 buffers
  bf16* sO = sQ + 2 * L::TILE;  // 2 buffers (dO)
  float* sL = reinterpret_cast<float*>(sO + 2 * L::TILE);  // LSE, log2
  float* sD = sL + BT;                                      // D

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int q_offset = Tk - Tq;

  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  const bf16* ob = dout + b * st.ob + h * st.oh;

  const int n_qt = (Tq + BT - 1) / BT;
  // q tiles before start_q see none of these keys (attention.py:272-280;
  // the max(0, .) is the clamp that keeps tq < tk off a phantom tile)
  const int start_q = causal ? max(0, k0 - q_offset) / BT : 0;

  load_tile<D>(sK, kb, st.kt, k0, Tk);
  load_tile<D>(sV, vb, st.vt, k0, Tk);
  if (start_q < n_qt) {
    load_tile<D>(sQ, qb, st.qt, start_q * BT, Tq);
    load_tile<D>(sO, ob, st.ot, start_q * BT, Tq);
  }
  cp_async_commit();

  // this thread's two keys within the kv tile: r0 and r0 + 8
  const int r0 = warp * 16 + g;
  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  for (int qt = start_q; qt < n_qt; ++qt) {
    const int buf = (qt - start_q) & 1;
    if (qt + 1 < n_qt) {
      const int nq = (qt + 1) * BT;
      load_tile<D>(sQ + (buf ^ 1) * L::TILE, qb, st.qt, nq, Tq);
      load_tile<D>(sO + (buf ^ 1) * L::TILE, ob, st.ot, nq, Tq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    {
      const int i = threadIdx.x & (BT - 1);
      const int row = qt * BT + i;
      const long long at = (long long)bh * Tq + row;
      if (threadIdx.x < BT) {
        sL[i] = row < Tq ? lse[at] * LOG2E : 0.f;
      } else {
        sD[i] = row < Tq ? dcor[at] : 0.f;
      }
    }
    __syncthreads();
    const bf16* tQ = sQ + buf * L::TILE;
    const bf16* tO = sO + buf * L::TILE;

    // S^T = K Q^T and dP^T = V dO^T, [16 keys, 64 queries]
    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t ka[4], va[4];
      a_frag<D>(ka, sK, r0, kd, tg);
      a_frag<D>(va, sV, r0, kd, tg);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const bf16* qrow = tQ + (j * 8 + g) * LD + kd * 16 + tg * 2;
        const bf16* orow = tO + (j * 8 + g) * LD + kd * 16 + tg * 2;
        mma16816(s[j], ka, *reinterpret_cast<const uint32_t*>(qrow),
                 *reinterpret_cast<const uint32_t*>(qrow + 8));
        mma16816(dp[j], va, *reinterpret_cast<const uint32_t*>(orow),
                 *reinterpret_cast<const uint32_t*>(orow + 8));
      }
    }

    // P^T and dS^T = P^T * (dP^T - D), LSE and D per column (query)
    const bool masked = (causal && q_offset + qt * BT < k0 + BT - 1) ||
                        (qt * BT + BT > Tq) || (k0 + BT > Tk);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tg * 2 + (e & 1);
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + r0 + (e >> 1) * 8;
          const int qi = qt * BT + col;
          if (qi >= Tq || key >= Tk || (causal && q_offset + qi < key)) {
            x = -INFINITY;
          }
        }
        const float p = exp2f(x - sL[col]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sD[col]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, both [16 keys, D]
    uint32_t pa[BT / 16][4], da[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
      c_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
    }
    mma_a_tile<D>(acc_dv, pa, tO, lane);
    mma_a_tile<D>(acc_dk, da, tQ, lane);
    __syncthreads();  // this buffer (and sL, sD) is refilled next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + r * 8;
    if (key >= Tk) continue;
    const long long at = (((long long)b * Tk + key) * H + h) * D + tg * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + j * 8) =
          __floats2bfloat162_rn(acc_dk[j][2 * r] * scale,
                                acc_dk[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + j * 8) =
          __floats2bfloat162_rn(acc_dv[j][2 * r], acc_dv[j][2 * r + 1]);
    }
  }
}

// The A fragments (rows m0 + [0, 16), k columns kk*16 + [0, 16)) of a
// product operand held transposed in shared memory, t[k][m] with row
// stride LDS: the four 8x8 matrices (k 0-7, m 0-7), (k 0-7, m 8-15),
// (k 8-15, m 0-7), (k 8-15, m 8-15) transposed by ldmatrix.trans.
__device__ __forceinline__ void a_frag_trans(uint32_t* a, const bf16* t,
                                             int m0, int kk, int lane) {
  ldmatrix_x4_trans(a, t + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * LDS
                           + m0 + ((lane >> 3) & 1) * 8);
}

// p[0] += x, p[1] += y in device memory, p 8-byte aligned.
__device__ __forceinline__ void atomic_add2(float* p, float x, float y) {
#if CUDART_VERSION >= 12010
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
#else
  atomicAdd(p, x);
  atomicAdd(p + 1, y);
#endif
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_fused_kernel(const bf16* __restrict__ q,
                       const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ dout,
                       const float* __restrict__ lse,
                       const float* __restrict__ dcor,
                       float* __restrict__ dq, bf16* __restrict__ dk,
                       bf16* __restrict__ dv, int H, int Tq, int Tk,
                       Strides st, int causal, float scale_log2,
                       float scale) {
  typedef Layout<D> L;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sK = reinterpret_cast<bf16*>(smem);
  bf16* sV = sK + L::TILE;
  bf16* sQ = sV + L::TILE;      // 2 buffers
  bf16* sO = sQ + 2 * L::TILE;  // 2 buffers (dO)
  float* sL = reinterpret_cast<float*>(sO + 2 * L::TILE);  // LSE, log2
  float* sD = sL + BT;                                      // D
  bf16* sS = reinterpret_cast<bf16*>(sD + BT);  // dS^T [64 keys][LDS]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int k0 = blockIdx.x * BT;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int q_offset = Tk - Tq;

  const bf16* qb = q + b * st.qb + h * st.qh;
  const bf16* kb = k + b * st.kb + h * st.kh;
  const bf16* vb = v + b * st.vb + h * st.vh;
  const bf16* ob = dout + b * st.ob + h * st.oh;

  const int n_qt = (Tq + BT - 1) / BT;
  // the JAX kernel's start_q with its clamp at 0 (attention.py:356-362)
  const int start_q = causal ? max(0, k0 - q_offset) / BT : 0;

  load_tile<D>(sK, kb, st.kt, k0, Tk);
  load_tile<D>(sV, vb, st.vt, k0, Tk);
  if (start_q < n_qt) {
    load_tile<D>(sQ, qb, st.qt, start_q * BT, Tq);
    load_tile<D>(sO, ob, st.ot, start_q * BT, Tq);
  }
  cp_async_commit();

  // this thread's two keys within the kv tile: r0 and r0 + 8
  const int r0 = warp * 16 + g;
  float acc_dk[D / 8][4], acc_dv[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_dk[j][e] = acc_dv[j][e] = 0.f;
  }

  for (int qt = start_q; qt < n_qt; ++qt) {
    const int buf = (qt - start_q) & 1;
    if (qt + 1 < n_qt) {
      const int nq = (qt + 1) * BT;
      load_tile<D>(sQ + (buf ^ 1) * L::TILE, qb, st.qt, nq, Tq);
      load_tile<D>(sO + (buf ^ 1) * L::TILE, ob, st.ot, nq, Tq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    {
      const int i = threadIdx.x & (BT - 1);
      const int row = qt * BT + i;
      const long long at = (long long)bh * Tq + row;
      if (threadIdx.x < BT) {
        sL[i] = row < Tq ? lse[at] * LOG2E : 0.f;
      } else {
        sD[i] = row < Tq ? dcor[at] : 0.f;
      }
    }
    __syncthreads();
    const bf16* tQ = sQ + buf * L::TILE;
    const bf16* tO = sO + buf * L::TILE;

    // S^T = K Q^T and dP^T = V dO^T, [16 keys, 64 queries]
    float s[BT / 8][4], dp[BT / 8][4];
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
    }
#pragma unroll
    for (int kd = 0; kd < D / 16; ++kd) {
      uint32_t ka[4], va[4];
      a_frag<D>(ka, sK, r0, kd, tg);
      a_frag<D>(va, sV, r0, kd, tg);
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const bf16* qrow = tQ + (j * 8 + g) * LD + kd * 16 + tg * 2;
        const bf16* orow = tO + (j * 8 + g) * LD + kd * 16 + tg * 2;
        mma16816(s[j], ka, *reinterpret_cast<const uint32_t*>(qrow),
                 *reinterpret_cast<const uint32_t*>(qrow + 8));
        mma16816(dp[j], va, *reinterpret_cast<const uint32_t*>(orow),
                 *reinterpret_cast<const uint32_t*>(orow + 8));
      }
    }

    // P^T and dS^T = P^T * (dP^T - D), LSE and D per column (query)
    const bool masked = (causal && q_offset + qt * BT < k0 + BT - 1) ||
                        (qt * BT + BT > Tq) || (k0 + BT > Tk);
#pragma unroll
    for (int j = 0; j < BT / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = j * 8 + tg * 2 + (e & 1);
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + r0 + (e >> 1) * 8;
          const int qi = qt * BT + col;
          if (qi >= Tq || key >= Tk || (causal && q_offset + qi < key)) {
            x = -INFINITY;
          }
        }
        const float p = exp2f(x - sL[col]);
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - sD[col]);
      }
    }

    // dV += P^T dO and dK += dS^T Q, both [16 keys, D]; this warp's 16
    // rows of dS^T, rounded to bf16 as dK takes them, go to sS
    uint32_t pa[BT / 16][4], da[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      c_to_a(pa[kk], s[2 * kk], s[2 * kk + 1]);
      c_to_a(da[kk], dp[2 * kk], dp[2 * kk + 1]);
      bf16* row = sS + r0 * LDS + kk * 16 + tg * 2;
      *reinterpret_cast<uint32_t*>(row) = da[kk][0];
      *reinterpret_cast<uint32_t*>(row + 8 * LDS) = da[kk][1];
      *reinterpret_cast<uint32_t*>(row + 8) = da[kk][2];
      *reinterpret_cast<uint32_t*>(row + 8 * LDS + 8) = da[kk][3];
    }
    mma_a_tile<D>(acc_dv, pa, tO, lane);
    mma_a_tile<D>(acc_dk, da, tQ, lane);
    __syncthreads();  // every warp's rows of dS^T are in sS

    // dQ[16 queries, D] += scale * dS K for this warp's 16 query rows, 64
    // columns at a time, added to device memory with atomics
    uint32_t dsa[BT / 16][4];
#pragma unroll
    for (int kk = 0; kk < BT / 16; ++kk) {
      a_frag_trans(dsa[kk], sS, warp * 16, kk, lane);
    }
    const int qrow = qt * BT + warp * 16 + g;
#pragma unroll
    for (int c = 0; c < D; c += 64) {
      float acc[8][4];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
      }
      mma_a_tile<D, 64>(acc, dsa, sK + c, lane);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = qrow + r * 8;
        if (row >= Tq) continue;
        float* out = dq + (((long long)b * Tq + row) * H + h) * D + c + tg * 2;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          atomic_add2(out + j * 8, acc[j][2 * r] * scale,
                      acc[j][2 * r + 1] * scale);
        }
      }
    }
    __syncthreads();  // this buffer, sL, sD and sS are refilled next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = k0 + r0 + r * 8;
    if (key >= Tk) continue;
    const long long at = (((long long)b * Tk + key) * H + h) * D + tg * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dk + at + j * 8) =
          __floats2bfloat162_rn(acc_dk[j][2 * r] * scale,
                                acc_dk[j][2 * r + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dv + at + j * 8) =
          __floats2bfloat162_rn(acc_dv[j][2 * r], acc_dv[j][2 * r + 1]);
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

template <int D>
cudaError_t launch_dkv(int device, const bf16* q, const bf16* k,
                       const bf16* v, const bf16* dout, const float* lse,
                       const float* dcor, bf16* dk, bf16* dv, int B, int H,
                       int Tq, int Tk, const Strides& st, int causal,
                       float scale_log2, float scale, cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  const int bytes = Layout<D>::dkv_bytes;
  cudaError_t err = opt_in(flash_bwd_dkv_kernel<D>, bytes, device, done);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + BT - 1) / BT, B * H);
  flash_bwd_dkv_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, dcor, dk, dv, H, Tq, Tk, st, causal, scale_log2,
      scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_fused(int device, const bf16* q, const bf16* k,
                         const bf16* v, const bf16* dout, const float* lse,
                         const float* dcor, float* dq, bf16* dk, bf16* dv,
                         int B, int H, int Tq, int Tk, const Strides& st,
                         int causal, float scale_log2, float scale,
                         cudaStream_t stream) {
  static bool done[MAX_DEVICES] = {};
  const int bytes = Layout<D>::fused_bytes;
  cudaError_t err = opt_in(flash_bwd_fused_kernel<D>, bytes, device, done);
  if (err != cudaSuccess) return err;
  dim3 grid((Tk + BT - 1) / BT, B * H);
  flash_bwd_fused_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, dout, lse, dcor, dq, dk, dv, H, Tq, Tk, st, causal,
      scale_log2, scale);
  return cudaGetLastError();
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

// As flash_bwd_dq_bf16; dk, dv [B, Tk, H, D] contiguous bf16.
extern "C" int flash_bwd_dkv_bf16(
    int device, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dcor, void* dk,
    void* dv, int B, int H, int Tq, int Tk, int D, long long qsb,
    long long qst, long long qsh, long long ksb, long long kst,
    long long ksh, long long vsb, long long vst, long long vsh,
    long long osb, long long ost, long long osh, int causal,
    float scale_log2, float scale, void* stream) {
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
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return launch_dkv<64>(device, qp, kp, vp, op, lp, dp, dkp, dvp, B, H,
                          Tq, Tk, st, causal, scale_log2, scale, s);
  }
  if (D == 128) {
    return launch_dkv<128>(device, qp, kp, vp, op, lp, dp, dkp, dvp, B, H,
                           Tq, Tk, st, causal, scale_log2, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// As flash_bwd_dkv_bf16, plus dq [B, Tq, H, D] contiguous fp32, zero-filled
// by the caller: the kernel adds scale * dS K into it (atomics), dk and dv
// it writes. The single-pass backward (`flash_bwd_fused_kernel`).
extern "C" int flash_bwd_fused_bf16(
    int device, const void* q, const void* k, const void* v,
    const void* dout, const void* lse, const void* dcor, void* dq,
    void* dk, void* dv, int B, int H, int Tq, int Tk, int D,
    long long qsb, long long qst, long long qsh, long long ksb,
    long long kst, long long ksh, long long vsb, long long vst,
    long long vsh, long long osb, long long ost, long long osh, int causal,
    float scale_log2, float scale, void* stream) {
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
  float* dqp = static_cast<float*>(dq);
  bf16* dkp = static_cast<bf16*>(dk);
  bf16* dvp = static_cast<bf16*>(dv);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) {
    return launch_fused<64>(device, qp, kp, vp, op, lp, dp, dqp, dkp, dvp,
                            B, H, Tq, Tk, st, causal, scale_log2, scale, s);
  }
  if (D == 128) {
    return launch_fused<128>(device, qp, kp, vp, op, lp, dp, dqp, dkp, dvp,
                             B, H, Tq, Tk, st, causal, scale_log2, scale, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
