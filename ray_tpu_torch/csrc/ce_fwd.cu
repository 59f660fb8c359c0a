// Fused linear + cross-entropy forward for Hopper (sm_90a), bf16 in.
//
// Replaces ray_tpu/ops/fused_ce.py:_ce_fwd_kernel (launched by
// _ce_fwd_pallas): per-row loss = logsumexp(x W^T) - (x W^T)[target] and
// the row logsumexp, without writing the [N, V] logits to device memory.
//
// What bounds it on an H100: at GPT-2 small's LM head (N = 2048, d = 768,
// V = 50304) it does 2*N*V*d = 158 GFLOP against ~80 MB of x and W, about
// 2000 FLOP per byte: it is bound by the tensor cores (0.16 ms at
// 989 TFLOP/s), not by memory (reading W once takes ~23 us). Design:
//   * a CTA of 8 warps owns a 64-row tile of x, kept whole in shared
//     memory (64 x d bf16), and walks a contiguous range of 256-wide vocab
//     tiles; W is streamed in 256 x 64 chunks, double-buffered with
//     cp.async so the next chunk loads while this one is multiplied;
//   * the logit tile is computed inside the kernel with mma.sync m16n8k16
//     bf16 products, operands fetched with ldmatrix (rows padded by 16
//     bytes: no bank conflicts) and fp32 accumulators in registers: each
//     warp owns 32 rows x 64 vocab columns, so every W fragment feeds two
//     products; the logits never leave registers;
//   * each warp folds its columns into a running (max, sum-exp,
//     target-logit) per row in fp32, log2 domain (exp2 only); columns
//     >= vocab_size (the padding of W) and rows past N are masked, so any
//     N and any V are taken;
//   * one CTA per row tile would leave most SMs idle at N = 2048 (32 CTAs
//     on 132 SMs), so the vocab is split across `splits` CTAs per row
//     tile; each warp writes its partial (max, sum, target) per row and a
//     second, tiny kernel merges them into loss and LSE.
#include "common.cuh"

using namespace port;

namespace {

constexpr int BN = 64;        // rows of x per CTA
constexpr int BV = 256;       // vocab rows of W per tile
constexpr int KC = 64;        // d chunk of a staged W tile
constexpr int THREADS = 256;  // 8 warps: 2 row halves x 4 column quarters
constexpr int LDW = KC + 8;   // bf16 row stride of a W chunk
constexpr int WCHUNK = BV * LDW;

__host__ __device__ inline int ldx(int d) { return d + 8; }

__host__ __device__ inline int smem_bytes(int d) {
  return (BN * ldx(d) + 2 * WCHUNK) * 2;
}

// W rows [v0, v0 + BV) x columns [kd0, kd0 + kc) into a padded chunk;
// rows at or past V are zero-filled.
__device__ __forceinline__ void load_w_chunk(bf16* dst, const bf16* w,
                                             int v0, int kd0, int kc, int D,
                                             int V) {
  const int vecs = kc / 8;
  for (int i = threadIdx.x; i < BV * vecs; i += THREADS) {
    const int r = i / vecs;
    const int c = (i % vecs) * 8;
    const bool ok = v0 + r < V;
    const bf16* src = ok ? w + (long long)(v0 + r) * D + kd0 + c : w;
    cp_async16(dst + r * LDW + c, src, ok);
  }
}

__global__ void __launch_bounds__(THREADS)
ce_fwd_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
              const long long* __restrict__ targets,
              float* __restrict__ part, int N, int D, int V, int vocab,
              int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int LDX = ldx(D);
  bf16* sX = reinterpret_cast<bf16*>(smem);
  bf16* sW = sX + BN * LDX;  // 2 chunks

  const int n0 = blockIdx.x * BN;
  const int split = blockIdx.y;
  const int n_vt = (V + BV - 1) / BV;
  const int t_begin = split * tiles_per_split;
  const int t_end = min(n_vt, t_begin + tiles_per_split);
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tg = lane & 3;
  const int rw = warp & 1;   // 32-row half of the x tile
  const int cw = warp >> 1;  // 64-column quarter of the vocab tile
  const int n_chunks = (D + KC - 1) / KC;
  const int n_iter = max(0, t_end - t_begin) * n_chunks;

  const int vecs = D / 8;
  for (int i = threadIdx.x; i < BN * vecs; i += THREADS) {
    const int r = i / vecs;
    const int c = (i % vecs) * 8;
    const bool ok = n0 + r < N;
    const bf16* src = ok ? x + (long long)(n0 + r) * D + c : x;
    cp_async16(sX + r * LDX + c, src, ok);
  }
  if (n_iter > 0) load_w_chunk(sW, w, t_begin * BV, 0, min(KC, D), D, V);
  cp_async_commit();

  // this thread's rows: rw*32 + mt*16 + g + 8*h for m-tile mt, half h
  long long tgt[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int row = n0 + rw * 32 + (r >> 1) * 16 + g + 8 * (r & 1);
    tgt[r] = row < N ? targets[row] : -1;
  }
  float m[4], l[4], tl[4];  // l: partial over this thread's columns
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = tl[r] = 0.f;
  }
  float s[2][8][4];
  // ldmatrix row addresses: A rows (lane & 15), k half (lane >> 4); B
  // vocab rows (lane & 7) of n-tile pair half (lane >> 4), k half
  // ((lane >> 3) & 1)
  const bf16* aX = sX + (rw * 32 + (lane & 15)) * LDX + (lane >> 4) * 8;
  const int b_off = (cw * 64 + (lane & 7) + ((lane >> 4) << 3)) * LDW +
                    ((lane >> 3) & 1) * 8;

  for (int it = 0; it < n_iter; ++it) {
    const int buf = it & 1;
    const int tile = t_begin + it / n_chunks;
    const int ch = it % n_chunks;
    if (it + 1 < n_iter) {
      const int nt = t_begin + (it + 1) / n_chunks;
      const int nk = ((it + 1) % n_chunks) * KC;
      load_w_chunk(sW + (buf ^ 1) * WCHUNK, w, nt * BV, nk,
                   min(KC, D - nk), D, V);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (ch == 0) {
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          s[mt][j][0] = s[mt][j][1] = s[mt][j][2] = s[mt][j][3] = 0.f;
        }
      }
    }
    const bf16* tW = sW + buf * WCHUNK + b_off;
    const int kc = min(KC, D - ch * KC);
    for (int ks = 0; ks < kc; ks += 16) {
      uint32_t a[2][4];
      ldmatrix_x4(a[0], aX + ch * KC + ks);
      ldmatrix_x4(a[1], aX + 16 * LDX + ch * KC + ks);
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        uint32_t b[4];  // b0, b1 of n-tile j, then of n-tile j + 1
        ldmatrix_x4(b, tW + j * 8 * LDW + ks);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma16816(s[mt][j], a[mt], b[0], b[1]);
          mma16816(s[mt][j + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if (ch == n_chunks - 1) {
      const int c0 = tile * BV + cw * 64 + tg * 2;
      float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 2 + (e >> 1);
            const int col = c0 + j * 8 + (e & 1);
            const float z = s[mt][j][e];
            if (col == tgt[r]) tl[r] = z;
            const float z2 = col < vocab ? z * LOG2E : -INFINITY;
            s[mt][j][e] = z2;
            mx[r] = fmaxf(mx[r], z2);
          }
        }
      }
      float m_use[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;
        l[r] *= exp2f(m[r] - m_use[r]);
        m[r] = m_new;
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = mt * 2 + (e >> 1);
            l[r] += exp2f(s[mt][j][e] - m_use[r]);
          }
        }
      }
    }
    __syncthreads();  // this chunk buffer is refilled next iteration
  }

  // partial p = split * 4 + column quarter; part is [3][P][N]: m, l,
  // target logit
  const int P = gridDim.y * 4;
  const int p = split * 4 + cw;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], 1);
    tl[r] += __shfl_xor_sync(0xffffffffu, tl[r], 2);
    const int row = n0 + rw * 32 + (r >> 1) * 16 + g + 8 * (r & 1);
    if (tg == 0 && row < N) {
      part[(long long)p * N + row] = m[r];
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
// multiple of 16 (16-byte loads, 16-wide products) and the x tile plus two
// W chunks within the device's opt-in shared memory per block. Returns 1
// or 0, or minus the CUDA error of the query.
extern "C" int ce_fwd_takes(int device, int D) {
  int limit = 0;
  const cudaError_t err = cudaDeviceGetAttribute(
      &limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  return D > 0 && D % 16 == 0 && smem_bytes(D) <= limit;
}

// x [N, D] and w [V, D] contiguous bf16 (rows of w at or past `vocab` are
// padding and masked), targets [N] int64; loss, lse [N] fp32; part is
// fp32 scratch of 3 * 4 * splits * N floats. On CUDA device `device`; the
// caller has checked D with ce_fwd_takes. Returns the CUDA error of the
// launches (0 = launched).
extern "C" int ce_fwd_bf16(int device, const void* x, const void* w,
                           const void* targets, void* loss, void* lse,
                           void* part, int N, int D, int V, int vocab,
                           int splits, void* stream) {
  // the shared-memory opt-in is per device; raised only when d needs more
  static int smem_set[MAX_DEVICES] = {};
  if (device < 0 || device >= MAX_DEVICES) {
    return static_cast<int>(cudaErrorInvalidDevice);
  }
  DeviceGuard guard(device);
  if (guard.err != cudaSuccess) return static_cast<int>(guard.err);
  cudaError_t err;
  const int bytes = smem_bytes(D);
  if (bytes > smem_set[device]) {
    err = cudaFuncSetAttribute(
        ce_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[device] = bytes;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int n_vt = (V + BV - 1) / BV;
  const int tiles_per_split = (n_vt + splits - 1) / splits;
  dim3 grid((N + BN - 1) / BN, splits);
  ce_fwd_kernel<<<grid, THREADS, bytes, s>>>(
      static_cast<const bf16*>(x), static_cast<const bf16*>(w),
      static_cast<const long long*>(targets), static_cast<float*>(part), N,
      D, V, vocab, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ce_combine_kernel<<<(N + 255) / 256, 256, 0, s>>>(
      static_cast<const float*>(part), static_cast<float*>(loss),
      static_cast<float*>(lse), N, 4 * splits);
  return static_cast<int>(cudaGetLastError());
}
