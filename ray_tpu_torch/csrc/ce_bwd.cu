// Fused linear + cross-entropy backward for Hopper (sm_90a), bf16 in, fp32
// accumulation and output: two kernels over one templated body.
//
// Replaces ray_tpu/ops/fused_ce.py:_ce_dx_kernel and _ce_dw_kernel
// (launched by _ce_bwd_pallas). With P = exp(x W^T - LSE) recomputed
// blockwise from the forward's row logsumexp (vocab columns at or past
// `vocab` are padding, P = 0 there):
//   ce_dx: dx_unscaled [N, d] = P W
//   ce_dw: dW_unscaled [V, d] = P^T xg,   xg = x * g rounded to bf16
// without writing the [N, V] probabilities to device memory. The one-hot
// terms (-W[targets], -xg scattered to the target rows) and the upstream
// scaling stay outside, as in the JAX package.
//
// What bounds them on an H100: at GPT-2 small's training shape (N = 8192,
// d = 768, V = 50304, 50257 live) each does 2 * 2 N vocab d = 1.265 TFLOP
// (the logits again, then the product with P) against ~100-250 MB: the
// tensor cores (1.28 ms at 989 TFLOP/s), not memory. Design:
//   * a CTA of 8 warps owns a 32-row tile of its "resident" operand (x for
//     ce_dx, W for ce_dw), kept whole in shared memory, and walks every
//     128-row tile of the "streamed" operand (W for ce_dx, x for ce_dw).
//     The tile is 32 rows, not 64, because the CTA's whole [rows, d] fp32
//     accumulator lives in registers across the walk: 32 x 768 fp32 is 96
//     registers a thread, where 64 rows would take three quarters of the
//     SM's register file. d is a template argument, so the accumulator
//     is indexed by compile-time chunk numbers and never spills to local
//     memory;
//   * for each streamed tile: S = R C^T over d in 64-wide chunks
//     (mma.sync m16n8k16, ldmatrix operands, chunks double-buffered with
//     cp.async), then P = exp2(S log2(e) - LSE log2(e)) masked, written to
//     shared memory as bf16 (one 32 x 128 tile), then acc += P E with E
//     (W for ce_dx, xg for ce_dw) streamed again in 64-wide chunks through
//     the same cp.async ring and read through ldmatrix.trans;
//   * padding: streamed W rows at or past `vocab` (ce_dx) and resident W
//     rows at or past `vocab` (ce_dw) are never read, only zero-filled, so
//     whatever the padding holds leaves dx unchanged and the padded dW rows
//     zero; ce_dw writes those rows without touching x.
// At N = 8192 ce_dx runs 256 CTAs and ce_dw 1572, one CTA per SM (the
// accumulator's registers), so neither needs a split to fill 132 SMs.
#include "common.cuh"

using namespace port;

namespace {

constexpr int BR = 32;        // resident rows per CTA
constexpr int BC = 128;       // streamed rows per tile
constexpr int KC = 64;        // d chunk of a staged streamed tile
constexpr int THREADS = 256;  // 8 warps: 2 row halves x 4 column quarters
constexpr int LDC = KC + 8;   // bf16 row stride of a streamed chunk
constexpr int CHUNK = BC * LDC;
constexpr int LDP = BC + 8;   // bf16 row stride of the P tile

__host__ __device__ constexpr int smem_bytes(int d) {
  return (BR * (d + 8) + 2 * CHUNK + BR * LDP) * 2 + BC * 4;
}

// DW false (ce_dx): resident x [n_res = N rows], streamed W [V rows] as
// both S operand and product operand, LSE per resident row, live streamed
// rows < vocab. DW true (ce_dw): resident W [n_res = V rows], live rows
// < vocab; streamed x (S operand) and xg (product operand) [n_str = N
// rows], LSE per streamed row.
template <int D, bool DW>
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_kernel(const bf16* __restrict__ res, const bf16* __restrict__ sop,
              const bf16* __restrict__ pop, const float* __restrict__ lse,
              float* __restrict__ out, int n_res, int n_str, int vocab) {
  constexpr int LDR = D + 8;
  constexpr int NC = D / KC;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sR = reinterpret_cast<bf16*>(smem);
  bf16* sC = sR + BR * LDR;  // 2 chunks
  bf16* sP = sC + 2 * CHUNK;
  float* sL = reinterpret_cast<float*>(sP + BR * LDP);  // DW: LSE, log2

  const int r0 = blockIdx.x * BR;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int rw = warp & 1;   // 16-row half of the resident tile
  const int cw = warp >> 1;  // column quarter (32 of a streamed tile in
                             // S, 16 of a d chunk in the product)
  const int res_live = DW ? min(vocab, n_res) : n_res;
  const int str_live = DW ? n_str : vocab;
  const int n_tiles = r0 < res_live ? (str_live + BC - 1) / BC : 0;
  const int total = n_tiles * 2 * NC;

  for (int i = threadIdx.x; i < BR * (D / 8); i += THREADS) {
    const int r = i / (D / 8);
    const int c = (i % (D / 8)) * 8;
    const bool ok = r0 + r < res_live;
    const bf16* src = ok ? res + (long long)(r0 + r) * D + c : res;
    cp_async16(sR + r * LDR + c, src, ok);
  }
  // step st of the walk: tile st / (2 NC); its first NC steps are chunks
  // of the S operand, the next NC chunks of the product operand
  auto load_chunk = [&](int st) {
    const int tile = st / (2 * NC);
    const int rem = st % (2 * NC);
    const bf16* src = rem < NC ? sop : pop;
    const int kd0 = (rem % NC) * KC;
    bf16* dst = sC + (st & 1) * CHUNK;
    for (int i = threadIdx.x; i < BC * (KC / 8); i += THREADS) {
      const int r = i / (KC / 8);
      const int c = (i % (KC / 8)) * 8;
      const int row = tile * BC + r;
      const bool ok = row < str_live;
      cp_async16(dst + r * LDC + c,
                 ok ? src + (long long)row * D + kd0 + c : src, ok);
    }
  };
  if (total > 0) load_chunk(0);
  cp_async_commit();

  float lse_r[2] = {0.f, 0.f};  // ce_dx: this thread's two rows' LSE
  if (!DW) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = r0 + rw * 16 + g + 8 * r;
      lse_r[r] = row < n_res ? lse[row] * LOG2E : 0.f;
    }
  }
  float acc[NC][2][4];
#pragma unroll
  for (int ch = 0; ch < NC; ++ch) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ch][0][e] = acc[ch][1][e] = 0.f;
  }
  // ldmatrix row addresses: A rows (lane & 15), k half (lane >> 4); B
  // streamed rows (lane & 7) of n-tile pair half (lane >> 4), k half
  // ((lane >> 3) & 1); transposed B rows (lane & 15), n-tile (lane >> 4)
  const bf16* aR = sR + (rw * 16 + (lane & 15)) * LDR + (lane >> 4) * 8;
  const bf16* aP = sP + (rw * 16 + (lane & 15)) * LDP + (lane >> 4) * 8;
  const int b_off = (cw * 32 + (lane & 7) + ((lane >> 4) << 3)) * LDC +
                    ((lane >> 3) & 1) * 8;
  const int bt_off = (lane & 15) * LDC + (cw * 2 + (lane >> 4)) * 8;

  int step = 0;
  // prefetch the next chunk, wait for this one, and make it visible
  auto advance = [&]() {
    if (step + 1 < total) {
      load_chunk(step + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };

  for (int t = 0; t < n_tiles; ++t) {
    const int c0 = t * BC;
    if (DW && threadIdx.x < BC) {
      const int row = c0 + threadIdx.x;
      sL[threadIdx.x] = row < n_str ? lse[row] * LOG2E : 0.f;
    }
    // S[16 rows, 32 streamed] of this warp, over all of d
    float s[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      advance();
      const bf16* tC = sC + (step & 1) * CHUNK + b_off;
#pragma unroll
      for (int ks = 0; ks < KC; ks += 16) {
        uint32_t a[4];
        ldmatrix_x4(a, aR + ch * KC + ks);
#pragma unroll
        for (int j = 0; j < 4; j += 2) {
          uint32_t b[4];  // b0, b1 of n-tile j, then of n-tile j + 1
          ldmatrix_x4(b, tC + j * 8 * LDC + ks);
          mma16816(s[j], a, b[0], b[1]);
          mma16816(s[j + 1], a, b[2], b[3]);
        }
      }
      __syncthreads();  // this chunk buffer is refilled next step
      ++step;
    }
    // P, masked, into shared memory as bf16
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rw * 16 + g + 8 * h;
        const int col = cw * 32 + j * 8 + tg * 2;
        float p[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float z = s[j][2 * h + e] * LOG2E;
          bool ok;
          float l2;
          if (DW) {
            ok = r0 + row < res_live && c0 + col + e < n_str;
            l2 = sL[col + e];
          } else {
            ok = c0 + col + e < vocab;
            l2 = lse_r[h];
          }
          p[e] = ok ? exp2f(z - l2) : 0.f;
        }
        *reinterpret_cast<__nv_bfloat162*>(sP + row * LDP + col) =
            __floats2bfloat162_rn(p[0], p[1]);
      }
    }
    // acc[16 rows, 16 of each d chunk] += P E
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
      advance();  // also orders the P stores before the reads below
      const bf16* tE = sC + (step & 1) * CHUNK + bt_off;
#pragma unroll
      for (int kk = 0; kk < BC / 16; ++kk) {
        uint32_t a[4], b[4];
        ldmatrix_x4(a, aP + kk * 16);
        ldmatrix_x4_trans(b, tE + kk * 16 * LDC);
        mma16816(acc[ch][0], a, b[0], b[1]);
        mma16816(acc[ch][1], a, b[2], b[3]);
      }
      __syncthreads();
      ++step;
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = r0 + rw * 16 + g + 8 * h;
    if (row >= n_res) continue;
    float* o = out + (long long)row * D + cw * 16 + tg * 2;
#pragma unroll
    for (int ch = 0; ch < NC; ++ch) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        *reinterpret_cast<float2*>(o + ch * KC + nt * 8) =
            make_float2(acc[ch][nt][2 * h], acc[ch][nt][2 * h + 1]);
      }
    }
  }
}

template <int D, bool DW>
cudaError_t launch(int device, const bf16* res, const bf16* sop,
                   const bf16* pop, const float* lse, float* out, int n_res,
                   int n_str, int vocab, cudaStream_t stream) {
  // the shared-memory opt-in is per device; set it on first use only
  static bool done[MAX_DEVICES] = {};
  constexpr int bytes = smem_bytes(D);
  if (!done[device]) {
    const cudaError_t err = cudaFuncSetAttribute(
        ce_bwd_kernel<D, DW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return err;
    done[device] = true;
  }
  ce_bwd_kernel<D, DW><<<(n_res + BR - 1) / BR, THREADS, bytes, stream>>>(
      res, sop, pop, lse, out, n_res, n_str, vocab);
  return cudaGetLastError();
}

template <bool DW>
int dispatch(int device, const void* res, const void* sop, const void* pop,
             const void* lse, void* out, int n_res, int n_str, int D,
             int vocab, void* stream) {
  if (device < 0 || device >= MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  const bf16* r = static_cast<const bf16*>(res);
  const bf16* c = static_cast<const bf16*>(sop);
  const bf16* e = static_cast<const bf16*>(pop);
  const float* l = static_cast<const float*>(lse);
  float* o = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (D) {
    case 128:
      err = launch<128, DW>(device, r, c, e, l, o, n_res, n_str, vocab, s);
      break;
    case 256:
      err = launch<256, DW>(device, r, c, e, l, o, n_res, n_str, vocab, s);
      break;
    case 512:
      err = launch<512, DW>(device, r, c, e, l, o, n_res, n_str, vocab, s);
      break;
    case 768:
      err = launch<768, DW>(device, r, c, e, l, o, n_res, n_str, vocab, s);
      break;
    case 1024:
      err = launch<1024, DW>(device, r, c, e, l, o, n_res, n_str, vocab, s);
      break;
  }
  return static_cast<int>(err);
}

}  // namespace

// Whether ce_dx / ce_dw take rows of width D on CUDA device `device`: D
// one of the widths compiled here (128, 256, 512, 768 and 1024: the
// accumulator is sized at compile time) and the resident tile, the chunk
// ring and the P tile within the device's opt-in shared memory per block.
// Returns 1 or 0, or minus the CUDA error of the query.
extern "C" int ce_bwd_takes(int device, int D) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const bool compiled =
      D == 128 || D == 256 || D == 512 || D == 768 || D == 1024;
  return compiled && smem_bytes(D) <= limit;
}

// x [N, D] and w [V, D] contiguous bf16 (rows of w at or past `vocab` are
// padding and never read), lse [N] fp32 (natural log); dx [N, D] fp32
// receives P w. On CUDA device `device`; the caller has checked D with
// ce_bwd_takes. Returns the CUDA error of the launch (0 = launched).
extern "C" int ce_dx_bf16(int device, const void* x, const void* w,
                          const void* lse, void* dx, int N, int D, int V,
                          int vocab, void* stream) {
  return dispatch<false>(device, x, w, w, lse, dx, N, V, D, vocab, stream);
}

// As ce_dx_bf16, with xg [N, D] bf16; dw [V, D] fp32 receives P^T xg, its
// rows at or past `vocab` zero.
extern "C" int ce_dw_bf16(int device, const void* x, const void* w,
                          const void* xg, const void* lse, void* dw, int N,
                          int D, int V, int vocab, void* stream) {
  return dispatch<true>(device, w, x, xg, lse, dw, V, N, D, vocab, stream);
}
