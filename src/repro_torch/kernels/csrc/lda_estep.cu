// CUDA kernels of the LDA E-step (IVI, Algorithm 1) for Hopper (sm_90a).
//
// Three kernels carry one IVI update:
//   K1 fixed_point_kernel      the whole gamma fixed point of a mini-batch
//   K2 token_pi_kernel         token-aligned responsibilities pi
//   K3 segment_scatter_kernel  S = sum cnt * pi into (V, K) at the token ids
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/build.py). Every entry point launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().
// All arithmetic is fp32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr float kEps = 1e-30f;   // fp32-safe normaliser epsilon
constexpr int kWarp = 32;
constexpr int kMaxKPerLane = 8;  // K <= 256 in the fixed point

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits (each step is a + b on
  // one lane and b + a on its partner)
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// psi(x) for x > 0: the same series as the TPU kernel's _digamma
// (repro/kernels/lda_estep.py:63): eight recurrence steps, then the
// asymptotic expansion.
__device__ __forceinline__ float digamma_series(float x) {
  float shift = 0.f;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    shift += 1.f / x;
    x += 1.f;
  }
  const float inv = 1.f / x;
  const float inv2 = inv * inv;
  const float series =
      logf(x) - 0.5f * inv -
      inv2 * (1.f / 12.f - inv2 * (1.f / 120.f - inv2 / 252.f));
  return series - shift;
}

// exp(E[ln theta]) of one document row held across a warp: lane owns
// topics lane, lane + 32, ...; entries past K are zero.
template <int KPL>
__device__ __forceinline__ void exp_elog_theta(const float (&g)[KPL],
                                               float (&et)[KPL], int K,
                                               int lane) {
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < KPL; ++j) s += g[j];
  s = warp_sum(s);
  const float psi_s = digamma_series(s);
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + j * kWarp;
    et[j] = k < K ? expf(digamma_series(fmaxf(g[j], 1e-10f)) - psi_s) : 0.f;
  }
}

// ---------------------------------------------------------------------------
// K1: the gamma fixed point.
//
// Replaces _fixed_point_kernel (repro/kernels/lda_estep.py:99). The TPU
// kernel streamed a dense count matrix C (B, V) through the MXU; here the
// same function is computed from the token layout, since the padded C is
// 99.9% zeros at the Arxiv shape: per sweep 4*B*L*K operations instead of
// 4*B*V*K.
//
// One block owns one tile of block_b documents and runs every sweep of
// that tile; the tile stops once the mean |d gamma| over its real rows and
// topics is <= tol, exactly the TPU kernel's per-tile rule. One warp owns
// one document row at a time (rows warp, warp + nwarps, ...); the row's
// gamma, E[theta] and accumulator live in registers, gamma between sweeps
// in the gamma output (the block's own rows, L1/L2 resident).
//
// Bound: operations (4*K per live token per sweep, plus the digamma
// series); the bytes it must move are the token rows and the distinct Eφ
// rows, read once. What holds it back is occupancy: B / block_b blocks
// (8 at B = 1024 on 132 SMs) and a serial token loop per row. The token
// ids and counts are fetched 32 at a time with one coalesced load and
// broadcast by shuffle, so each token costs one Eφ row read (K floats,
// coalesced) and one warp reduction. Raising the block count (splitting a
// tile's rows across a cluster with one reduction per sweep) is later work
// (ROADMAP.md).
// ---------------------------------------------------------------------------
template <int KPL>
__global__ void __launch_bounds__(1024)
    fixed_point_kernel(const int32_t* __restrict__ ids,
                       const float* __restrict__ cnts,
                       const float* __restrict__ eb,
                       const float* __restrict__ gamma0,
                       float* __restrict__ gamma, float* __restrict__ et_out,
                       int32_t* __restrict__ iters, int B, int L, int K,
                       float alpha0, float tol, int max_sweeps, int block_b) {
  __shared__ float warp_delta[kWarp];
  __shared__ int done;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int nwarps = blockDim.x / kWarp;
  const int row0 = blockIdx.x * block_b;
  const int rows = min(block_b, B - row0);

  for (int r = warp; r < rows; r += nwarps) {
    const size_t off = static_cast<size_t>(row0 + r) * K;
    for (int k = lane; k < K; k += kWarp) gamma[off + k] = gamma0[off + k];
  }

  int sweeps = 0;
  while (sweeps < max_sweeps) {
    float dsum = 0.f;
    for (int r = warp; r < rows; r += nwarps) {
      const size_t b = static_cast<size_t>(row0 + r);
      float* g_row = gamma + b * K;
      float g[KPL], et[KPL], acc[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = lane + j * kWarp;
        g[j] = k < K ? g_row[k] : 0.f;
        acc[j] = 0.f;
      }
      exp_elog_theta<KPL>(g, et, K, lane);

      const int32_t* row_ids = ids + b * L;
      const float* row_cnts = cnts + b * L;
      for (int l0 = 0; l0 < L; l0 += kWarp) {
        const int mine = l0 + lane;
        const int32_t my_id = mine < L ? row_ids[mine] : 0;
        const float my_cnt = mine < L ? row_cnts[mine] : 0.f;
        const int n = min(kWarp, L - l0);
        for (int t = 0; t < n; ++t) {
          const float c = __shfl_sync(0xffffffffu, my_cnt, t);
          if (c == 0.f) continue;  // padding slot: contributes exactly 0
          const int32_t id = __shfl_sync(0xffffffffu, my_id, t);
          const float* e_row = eb + static_cast<size_t>(id) * K;
          float e[KPL];
          float part = 0.f;
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const int k = lane + j * kWarp;
            e[j] = k < K ? __ldg(e_row + k) : 0.f;
            part += et[j] * e[j];
          }
          const float ratio = c / (warp_sum(part) + kEps);
#pragma unroll
          for (int j = 0; j < KPL; ++j) acc[j] += ratio * e[j];
        }
      }
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = lane + j * kWarp;
        if (k < K) {
          const float g_new = alpha0 + et[j] * acc[j];
          dsum += fabsf(g_new - g[j]);
          g_row[k] = g_new;
        }
      }
    }
    dsum = warp_sum(dsum);
    if (lane == 0) warp_delta[warp] = dsum;
    __syncthreads();
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < nwarps; ++w) total += warp_delta[w];
      done = total / static_cast<float>(rows * K) <= tol;
    }
    ++sweeps;
    __syncthreads();
    if (done) break;
  }

  // E[theta] of the final gamma, as the TPU kernel's _finish
  for (int r = warp; r < rows; r += nwarps) {
    const size_t off = static_cast<size_t>(row0 + r) * K;
    float g[KPL], et[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int k = lane + j * kWarp;
      g[j] = k < K ? gamma[off + k] : 0.f;
    }
    exp_elog_theta<KPL>(g, et, K, lane);
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int k = lane + j * kWarp;
      if (k < K) et_out[off + k] = et[j];
    }
  }
  if (threadIdx.x == 0) iters[blockIdx.x] = sweeps;
}

// ---------------------------------------------------------------------------
// K2: token-aligned pi.
//
// Replaces _token_pi_kernel (repro/kernels/lda_estep.py:208).
// pi[b, l] = E[theta][b] * Eφ[id] / (sum_k E[theta][b] * Eφ[id] + 1e-30),
// zero where the count is 0, optionally rounded through bf16 before it is
// written (the memo wire; the scatter then sums the rounded value).
//
// Bound: bytes, dominated by the (B, L, K) fp32 pi it writes. One warp per
// token slot reads the Eφ row itself (no (B, L, K) gather is materialised
// in torch, unlike the TPU path) and writes its K outputs coalesced; slots
// with count 0 only write zeros.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
    token_pi_kernel(const int32_t* __restrict__ ids,
                    const float* __restrict__ cnts,
                    const float* __restrict__ eb,
                    const float* __restrict__ et, float* __restrict__ pi,
                    int64_t slots, int L, int K, int quantize) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t s = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                     threadIdx.x) / kWarp;
  if (s >= slots) return;
  float* out = pi + s * K;
  const float c = cnts[s];
  if (!(c > 0.f)) {
    for (int k = lane; k < K; k += kWarp) out[k] = 0.f;
    return;
  }
  const float* e_row = eb + static_cast<size_t>(ids[s]) * K;
  const float* t_row = et + (s / L) * K;
  float part = 0.f;
  for (int k = lane; k < K; k += kWarp) part += t_row[k] * __ldg(e_row + k);
  const float p = warp_sum(part) + kEps;
  for (int k = lane; k < K; k += kWarp) {
    float v = t_row[k] * __ldg(e_row + k) / p;
    if (quantize) v = __bfloat162float(__float2bfloat16_rn(v));
    out[k] = v;
  }
}

// ---------------------------------------------------------------------------
// K3: segment scatter.
//
// Replaces _segment_scatter_kernel (repro/kernels/lda_estep.py:227).
// S_new[v] = sum cnt * pi_new and S_old[v] = sum cnt * pi_old over the
// token rows whose id is v. The wrapper drops count-0 rows, sorts the rest
// stably by id and builds segment offsets; here one warp owns one id's
// segment and sums its rows in sorted order, so the result is bitwise
// deterministic (no fp32 atomics): resume bit-equality and the memo
// invariant need a fixed summation order. Rows of S no token maps to are
// zeroed by the wrapper.
//
// Bound: bytes: the live pi rows it reads (K floats each, coalesced) and
// the (V, K) outputs the wrapper zero-fills. The TPU's iota == ids selector
// matmul is replaced by the sort, so no (block_v, T) selector exists.
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
    segment_scatter_kernel(const int64_t* __restrict__ order,
                           const int64_t* __restrict__ seg_ids,
                           const int64_t* __restrict__ seg_off, int64_t nseg,
                           const float* __restrict__ cnts,
                           const float* __restrict__ pi_new,
                           const float* __restrict__ pi_old,
                           float* __restrict__ s_new,
                           float* __restrict__ s_old, int K) {
  const int lane = threadIdx.x & (kWarp - 1);
  const int64_t seg = (static_cast<int64_t>(blockIdx.x) * blockDim.x +
                       threadIdx.x) / kWarp;
  if (seg >= nseg) return;
  const int64_t lo = seg_off[seg], hi = seg_off[seg + 1];
  const size_t out = static_cast<size_t>(seg_ids[seg]) * K;
  for (int k = lane; k < K; k += kWarp) {
    float acc_new = 0.f, acc_old = 0.f;
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t row = order[i];
      const float c = cnts[row];
      acc_new += c * pi_new[row * K + k];
      if (pi_old != nullptr) acc_old += c * pi_old[row * K + k];
    }
    s_new[out + k] = acc_new;
    if (pi_old != nullptr) s_old[out + k] = acc_old;
  }
}

template <int KPL>
cudaError_t launch_fixed_point(const int32_t* ids, const float* cnts,
                               const float* eb, const float* gamma0,
                               float* gamma, float* et, int32_t* iters, int B,
                               int L, int K, float alpha0, float tol,
                               int max_sweeps, int block_b, int threads,
                               cudaStream_t stream) {
  const int nb = (B + block_b - 1) / block_b;
  fixed_point_kernel<KPL><<<nb, threads, 0, stream>>>(
      ids, cnts, eb, gamma0, gamma, et, iters, B, L, K, alpha0, tol,
      max_sweeps, block_b);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Highest K the fixed point takes (its per-lane register arrays).
int lda_fixed_point_max_k() { return kMaxKPerLane * kWarp; }

int lda_fixed_point(const int32_t* ids, const float* cnts, const float* eb,
                    const float* gamma0, float* gamma, float* et,
                    int32_t* iters, int B, int L, int K, float alpha0,
                    float tol, int max_sweeps, int block_b, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  const int threads = std::min(1024, kWarp * block_b);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kpl = (K + kWarp - 1) / kWarp;
#define LDA_FP_CASE(N)                                                       \
  case N:                                                                    \
    return launch_fixed_point<N>(ids, cnts, eb, gamma0, gamma, et, iters, B, \
                                 L, K, alpha0, tol, max_sweeps, block_b,     \
                                 threads, s);
  switch (kpl) {
    LDA_FP_CASE(1)
    LDA_FP_CASE(2)
    LDA_FP_CASE(3)
    LDA_FP_CASE(4)
    LDA_FP_CASE(5)
    LDA_FP_CASE(6)
    LDA_FP_CASE(7)
    LDA_FP_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef LDA_FP_CASE
}

int lda_token_pi(const int32_t* ids, const float* cnts, const float* eb,
                 const float* et, float* pi, int64_t slots, int L, int K,
                 int quantize, void* stream) {
  cudaGetLastError();
  constexpr int threads = 256;
  const int64_t blocks = (slots * kWarp + threads - 1) / threads;
  token_pi_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      ids, cnts, eb, et, pi, slots, L, K, quantize);
  return cudaGetLastError();
}

int lda_segment_scatter(const int64_t* order, const int64_t* seg_ids,
                        const int64_t* seg_off, int64_t nseg,
                        const float* cnts, const float* pi_new,
                        const float* pi_old, float* s_new, float* s_old,
                        int K, void* stream) {
  cudaGetLastError();
  constexpr int threads = 256;
  const int64_t blocks = (nseg * kWarp + threads - 1) / threads;
  if (blocks == 0) return cudaSuccess;
  segment_scatter_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      order, seg_ids, seg_off, nseg, cnts, pi_new, pi_old, s_new, s_old, K);
  return cudaGetLastError();
}

}  // extern "C"
