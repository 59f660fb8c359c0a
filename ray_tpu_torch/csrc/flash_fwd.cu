// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulation.
//
// Replaces ray_tpu/ops/attention.py:_flash_fwd_kernel (launched by
// _flash_fwd_pallas): O = softmax(scale * Q K^T [causal]) V and the
// natural-log row logsumexp, without materialising the [Tq, Tk] scores in
// device memory.
//
// What bounds it on an H100: at GPT-2 shapes ([4, 512, 12, 64], causal) it
// does 1.6 GFLOP against 12.6 MB of Q/K/V/O, ~130 FLOP per byte, below the
// card's ~295 FLOP/byte ridge: the bound is the bytes (3.8 us at
// 3.35 TB/s), and what a simple kernel really fights is latency, so the
// design keeps every operand either in registers or one cp.async ahead:
//   * one CTA of 4 warps per (batch*head, 64-row q tile); each warp owns
//     16 query rows. S = Q K^T and O += P V are mma.sync m16n8k16 bf16
//     products with fp32 accumulators held in registers, so the score tile
//     and the O accumulator never touch shared memory: the C fragment of S
//     is re-packed in registers as the A fragment of P (FlashAttention-2);
//   * Q is staged once; K/V tiles of 64 keys are double-buffered in shared
//     memory with cp.async (tile k+1 loads while tile k computes), rows
//     padded by 16 bytes so the fragment loads are bank-conflict free; V
//     fragments come through ldmatrix.trans;
//   * online softmax in the log2 domain (scale*log2(e) folded into S, exp2
//     only); each thread holds two rows' running max and a partial row sum
//     that the quad reduces once at the end;
//   * causal with q_offset = Tk - Tq (queries aligned to the end of the kv
//     sequence): kv tiles wholly above the diagonal are never loaded, and
//     only tiles that straddle the diagonal or the ragged end of Tk pay for
//     the mask. Any Tq, Tk: rows and keys past the end are zero-filled
//     (cp.async with a zero source size) and masked.
#include "common.cuh"

using namespace port;

namespace {

constexpr int BQ = 64;        // query rows per CTA
constexpr int BK = 64;        // keys per kv tile
constexpr int THREADS = 128;  // 4 warps x 16 query rows

template <int D>
struct Layout {
  static constexpr int LD = D + 8;  // bf16 row stride of Q/K/V tiles
  static constexpr int TILE = BK * LD;
  static constexpr int bytes = (BQ * LD + 4 * TILE) * 2;  // Q, 2xK, 2xV
};

// rows x D bf16 (row r at base + (row0 + r) * stride) into a padded shared
// tile with cp.async; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* base,
                                          long long stride, int row0,
                                          int valid, int rows) {
  constexpr int PER_ROW = D / 8;
  for (int i = threadIdx.x; i < rows * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW;
    const int c = (i % PER_ROW) * 8;
    const bool ok = row0 + r < valid;
    const bf16* src = ok ? base + (long long)(row0 + r) * stride + c : base;
    cp_async16(dst + r * Layout<D>::LD + c, src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int H, int Tq, int Tk,
                 long long qsb, long long qst, long long qsh, long long ksb,
                 long long kst, long long ksh, long long vsb, long long vst,
                 long long vsh, int causal, float scale_log2) {
  typedef Layout<D> L;
  constexpr int LD = L::LD;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);
  bf16* sK = sQ + BQ * LD;        // 2 buffers
  bf16* sV = sK + 2 * L::TILE;    // 2 buffers

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // fragment row group
  const int tg = lane & 3;   // thread in group
  const int q_offset = Tk - Tq;

  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  int n_tiles = (Tk + BK - 1) / BK;
  int n_full = n_tiles;  // tiles that need no causal mask
  if (causal) {
    const int last_q = q_offset + min(q0 + BQ, Tq) - 1;
    n_tiles = min(n_tiles, last_q / BK + 1);
    n_full = (q_offset + q0 + 1) / BK;
  }

  load_rows<D>(sQ, qb, qst, q0, Tq, BQ);
  load_rows<D>(sK, kb, kst, 0, Tk, BK);
  load_rows<D>(sV, vb, vst, 0, Tk, BK);
  cp_async_commit();

  // this thread's two rows within the q tile: r0 and r0 + 8
  const int r0 = warp * 16 + g;
  const int qpos0 = q_offset + q0 + r0;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};  // partial: this thread's columns only
  float acc_o[D / 8][4];
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc_o[j][0] = acc_o[j][1] = acc_o[j][2] = acc_o[j][3] = 0.f;
  }
  uint32_t qf[D / 16][4];

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int buf = kt & 1;
    if (kt + 1 < n_tiles) {
      load_rows<D>(sK + (buf ^ 1) * L::TILE, kb, kst, (kt + 1) * BK, Tk, BK);
      load_rows<D>(sV + (buf ^ 1) * L::TILE, vb, vst, (kt + 1) * BK, Tk, BK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (kt == 0) {
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const bf16* base = sQ + r0 * LD + kd * 16 + tg * 2;
        qf[kd][0] = *reinterpret_cast<const uint32_t*>(base);
        qf[kd][1] = *reinterpret_cast<const uint32_t*>(base + 8 * LD);
        qf[kd][2] = *reinterpret_cast<const uint32_t*>(base + 8);
        qf[kd][3] = *reinterpret_cast<const uint32_t*>(base + 8 * LD + 8);
      }
    }
    const bf16* tK = sK + buf * L::TILE;
    const bf16* tV = sV + buf * L::TILE;
    const int k0 = kt * BK;

    // S[16 rows, 64 keys] = Q K^T, 8 column tiles of 8 keys
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const bf16* krow = tK + (j * 8 + g) * LD + tg * 2;
#pragma unroll
      for (int kd = 0; kd < D / 16; ++kd) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(krow + kd * 16);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + kd * 16 + 8);
        mma16816(s[j], qf[kd], b0, b1);
      }
    }

    // online softmax, log2 domain
    const bool masked = (causal && kt >= n_full) || (k0 + BK > Tk);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (masked) {
          const int key = k0 + j * 8 + tg * 2 + (e & 1);
          const int qpos = qpos0 + (e >> 1) * 8;
          if (key >= Tk || (causal && key > qpos)) x = -INFINITY;
        }
        s[j][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      const float m_new = fmaxf(m[r], mx[r]);
      // a row with nothing visible yet keeps p = 0 instead of exp2(nan)
      m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = m_new;
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(s[j][e] - m_use[e >> 1]);
        s[j][e] = p;
        l[e >> 1] += p;
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc_o[j][0] *= alpha[0];
      acc_o[j][1] *= alpha[0];
      acc_o[j][2] *= alpha[1];
      acc_o[j][3] *= alpha[1];
    }

    // O[16 rows, D] += P V: S's C fragments are P's A fragments
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t pa[4];
      c_to_a(pa, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int j = 0; j < D / 8; j += 2) {
        // four 8x8 transposed tiles: keys kk*16 + [0,8) and [8,16) at
        // columns j*8 (lanes 0-15) and (j+1)*8 (lanes 16-31)
        const bf16* addr =
            tV + (kk * 16 + (lane & 15)) * LD + (j + (lane >> 4)) * 8;
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, addr);
        mma16816(acc_o[j], pa, bv[0], bv[1]);
        mma16816(acc_o[j + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // this buffer is refilled two tiles from now
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + r * 8;
    if (row >= Tq) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
    bf16* out = o + (((long long)b * Tq + row) * H + h) * D + tg * 2;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(out + j * 8) =
          __floats2bfloat162_rn(acc_o[j][2 * r] * inv,
                                acc_o[j][2 * r + 1] * inv);
    }
    if (tg == 0) lse[(long long)bh * Tq + row] = (m[r] + log2f(l[r])) * LN2;
  }
}

template <int D>
cudaError_t launch(int device, const bf16* q, const bf16* k, const bf16* v,
                   bf16* o, float* lse, int B, int H, int Tq, int Tk,
                   long long qsb, long long qst, long long qsh,
                   long long ksb, long long kst, long long ksh,
                   long long vsb, long long vst, long long vsh, int causal,
                   float scale_log2, cudaStream_t stream) {
  // the shared-memory opt-in is per device; set it on first use only
  static bool smem_set[MAX_DEVICES] = {};
  const int bytes = Layout<D>::bytes;
  if (!smem_set[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    smem_set[device] = true;
  }
  dim3 grid((Tq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, THREADS, bytes, stream>>>(
      q, k, v, o, lse, H, Tq, Tk, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
      vsh, causal, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// q [B, Tq, H, D], k/v [B, Tk, H, D] bf16 with unit stride on D and the
// given (batch, time, head) strides in elements; o [B, Tq, H, D]
// contiguous bf16; lse [B*H, Tq] fp32, on CUDA device `device`. Returns
// the CUDA error of the launch (0 = launched).
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
