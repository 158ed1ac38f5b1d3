// CUDA kernels of the LDA E-step (IVI, Algorithm 1) for Hopper (sm_90a).
//
// Three kernels carry one IVI update on the padded (B, L) layout:
//   K1 fixed_point_kernel      the whole gamma fixed point of a mini-batch
//   K2 token_pi_kernel         token-aligned responsibilities pi
//   K3 segment_scatter_kernel  S = sum cnt * pi into (V, K) at the token ids
// and three on the flat CSR token stream (documents concatenated, one
// segment id per token):
//   K4 csr_fixed_point_kernel  the gamma fixed point, stopped batch-wide
//   K5 csr_token_pi_kernel     flat pi (T, K)
//   K3                         unchanged: flat rows are its native input
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/build.py). Every entry point launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().
// All arithmetic is fp32.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace cg = cooperative_groups;

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

// One sweep of one document row, held across a warp (lane owns topics
// lane, lane + 32, ...): E[theta] of the row's gamma, then for each live
// slot (count != 0) of the n slots at ids/cnts, in slot order,
//   acc += cnt / (sum_k E[theta] * Eφ[id] + 1e-30) * Eφ[id],
// then gamma = alpha0 + E[theta] * acc, written back to g_row, with the
// lane's |d gamma| added to dsum. The ids and counts are fetched 32 at a
// time with one coalesced load; a ballot skips the count-0 slots, and each
// live slot costs one Eφ row read (K floats, coalesced) and one warp
// reduction. Shared by K1 (a padded row, n = L) and K4 (a document's range
// of the flat stream).
template <int KPL>
__device__ __forceinline__ void row_sweep(float* g_row,
                                          const int32_t* __restrict__ ids,
                                          const float* __restrict__ cnts,
                                          int64_t n,
                                          const float* __restrict__ eb,
                                          int K, float alpha0, int lane,
                                          float& dsum) {
  float g[KPL], et[KPL], acc[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + j * kWarp;
    g[j] = k < K ? g_row[k] : 0.f;
    acc[j] = 0.f;
  }
  exp_elog_theta<KPL>(g, et, K, lane);

  for (int64_t l0 = 0; l0 < n; l0 += kWarp) {
    const int64_t mine = l0 + lane;
    const int32_t my_id = mine < n ? ids[mine] : 0;
    const float my_cnt = mine < n ? cnts[mine] : 0.f;
    // count-0 slots (padding) contribute exactly 0: skip them
    unsigned live = __ballot_sync(0xffffffffu, my_cnt != 0.f);
    while (live) {
      const int t = __ffs(live) - 1;
      live &= live - 1;
      const float c = __shfl_sync(0xffffffffu, my_cnt, t);
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

// E[theta] of a final gamma row (the TPU kernels' _finish), across a warp.
template <int KPL>
__device__ __forceinline__ void row_etheta(const float* g_row, float* et_row,
                                           int K, int lane) {
  float g[KPL], et[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + j * kWarp;
    g[j] = k < K ? g_row[k] : 0.f;
  }
  exp_elog_theta<KPL>(g, et, K, lane);
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + j * kWarp;
    if (k < K) et_row[k] = et[j];
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
// (8 at B = 1024 on 132 SMs) and a serial token loop per row (row_sweep).
// Raising the block count (splitting a tile's rows across a cluster with
// one reduction per sweep, as K4 spreads its rows over the whole grid) is
// later work (ROADMAP.md).
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
      row_sweep<KPL>(gamma + b * K, ids + b * L, cnts + b * L, L, eb, K,
                     alpha0, lane, dsum);
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
    row_etheta<KPL>(gamma + off, et_out + off, K, lane);
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
// pi of one live token slot across a warp: E[theta] row t_row times the
// token's Eφ row, normalised (shared by K2 and K5).
__device__ __forceinline__ void token_pi_row(float* out,
                                             const float* __restrict__ e_row,
                                             const float* __restrict__ t_row,
                                             int K, int lane, int quantize) {
  float part = 0.f;
  for (int k = lane; k < K; k += kWarp) part += t_row[k] * __ldg(e_row + k);
  const float p = warp_sum(part) + kEps;
  for (int k = lane; k < K; k += kWarp) {
    float v = t_row[k] * __ldg(e_row + k) / p;
    if (quantize) v = __bfloat162float(__float2bfloat16_rn(v));
    out[k] = v;
  }
}

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
  token_pi_row(out, eb + static_cast<size_t>(ids[s]) * K, et + (s / L) * K,
               K, lane, quantize);
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

// ---------------------------------------------------------------------------
// K4: the gamma fixed point over a flat CSR token stream.
//
// Replaces _csr_fixed_point_kernel (repro/kernels/lda_estep.py:433). The
// TPU kernel found each token's document through an iota == segments
// selector matmul on the MXU; here each document's tokens are a contiguous
// range [offsets[d], offsets[d + 1]) of the stream (the wrapper derives the
// offsets from the segment ids on the device), walked by one warp with the
// same row_sweep as K1.
//
// Stopping rule: the TPU kernel's, batch-wide. After each sweep the mean
// |d gamma| over all B rows (rows that own no token included) and K topics
// is compared with tol; the whole batch stops at <= tol or after
// max_sweeps. One cooperative launch runs every sweep: warp w of the grid
// owns documents w, w + W, ... (W warps in the grid, gamma between sweeps
// in the gamma output, only ever touched by its owner lane); each block
// writes its partial |d gamma| sum to its slot of `partials`, double
// buffered by sweep parity, the grid syncs, and every block sums all slots
// in the same lane-strided order and butterfly, so every block takes the
// same decision from the same bits. The grid is sized to be co-resident
// (at most the occupancy limit times the SM count); the wrapper refuses
// what cannot be launched that way.
//
// Bound: operations, as K1 (4*K per live token per sweep plus the digamma
// series). Every row of the batch is in flight at once (one warp each, 128
// blocks at B = 1024), so a sweep takes about the longest document's serial
// token walk plus one grid-wide sync.
// ---------------------------------------------------------------------------
constexpr int kCsrThreads = 256;
constexpr int kCsrWarps = kCsrThreads / kWarp;

template <int KPL>
__global__ void __launch_bounds__(kCsrThreads)
    csr_fixed_point_kernel(const int32_t* __restrict__ ids,
                           const float* __restrict__ cnts,
                           const int64_t* __restrict__ offsets,
                           const float* __restrict__ eb,
                           const float* __restrict__ gamma0,
                           float* __restrict__ gamma,
                           float* __restrict__ et_out,
                           float* __restrict__ partials,
                           int32_t* __restrict__ iters, int B, int K,
                           float alpha0, float tol, int max_sweeps) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float warp_delta[kCsrWarps];
  __shared__ int done;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kCsrWarps + warp;
  const int nblocks = gridDim.x;
  const int64_t stride = static_cast<int64_t>(nblocks) * kCsrWarps;

  for (int64_t d = first; d < B; d += stride) {
    const int64_t off = d * K;
    for (int k = lane; k < K; k += kWarp) gamma[off + k] = gamma0[off + k];
  }

  int sweeps = 0;
  while (sweeps < max_sweeps) {
    float dsum = 0.f;
    for (int64_t d = first; d < B; d += stride) {
      const int64_t lo = offsets[d];
      row_sweep<KPL>(gamma + d * K, ids + lo, cnts + lo, offsets[d + 1] - lo,
                     eb, K, alpha0, lane, dsum);
    }
    dsum = warp_sum(dsum);
    if (lane == 0) warp_delta[warp] = dsum;
    __syncthreads();
    float* slots = partials + (sweeps & 1) * nblocks;
    if (threadIdx.x == 0) {
      float total = 0.f;
      for (int w = 0; w < kCsrWarps; ++w) total += warp_delta[w];
      slots[blockIdx.x] = total;
      __threadfence();
    }
    grid.sync();
    if (warp == 0) {
      // every block reads every slot past its L1 (__ldcg) in one order
      float total = 0.f;
      for (int i = lane; i < nblocks; i += kWarp) total += __ldcg(slots + i);
      total = warp_sum(total);
      if (lane == 0) {
        done = total / static_cast<float>(static_cast<int64_t>(B) * K) <= tol;
      }
    }
    ++sweeps;
    __syncthreads();
    if (done) break;
  }

  for (int64_t d = first; d < B; d += stride) {
    row_etheta<KPL>(gamma + d * K, et_out + d * K, K, lane);
  }
  if (blockIdx.x == 0 && threadIdx.x == 0) iters[0] = sweeps;
}

// ---------------------------------------------------------------------------
// K5: flat-token pi.
//
// Replaces _csr_token_pi_kernel (repro/kernels/lda_estep.py:558).
// pi[t] = E[theta][seg[t]] * Eφ[id[t]] / (sum_k ... + 1e-30), zero where the
// count is 0, optionally rounded through bf16 before it is written. K2's
// body with the E[theta] row taken from the segment id instead of slot / L.
//
// Bound: bytes, dominated by the (T, K) fp32 pi it writes (slots with count
// 0 only write zeros).
// ---------------------------------------------------------------------------
__global__ void __launch_bounds__(256)
    csr_token_pi_kernel(const int32_t* __restrict__ ids,
                        const float* __restrict__ cnts,
                        const int32_t* __restrict__ segs,
                        const float* __restrict__ eb,
                        const float* __restrict__ et, float* __restrict__ pi,
                        int64_t slots, int K, int quantize) {
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
  token_pi_row(out, eb + static_cast<size_t>(ids[s]) * K,
               et + static_cast<size_t>(segs[s]) * K, K, lane, quantize);
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

// The co-resident grid of K4 for B documents: one warp per document, at
// most the occupancy limit times the SM count. Returns cudaSuccess and sets
// *blocks, or the error that forbids a cooperative launch.
template <int KPL>
cudaError_t csr_grid(int B, int* blocks) {
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, csr_fixed_point_kernel<KPL>, kCsrThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  const int want = (B + kCsrWarps - 1) / kCsrWarps;
  *blocks = std::max(1, std::min(want, per_sm * sms));
  return cudaSuccess;
}

template <int KPL>
cudaError_t launch_fixed_point_csr(const int32_t* ids, const float* cnts,
                                   const int64_t* offsets, const float* eb,
                                   const float* gamma0, float* gamma,
                                   float* et, float* partials,
                                   int32_t* iters, int B, int K, float alpha0,
                                   float tol, int max_sweeps, int blocks,
                                   cudaStream_t stream) {
  void* args[] = {&ids,   &cnts,  &offsets, &eb,   &gamma0,
                  &gamma, &et,    &partials, &iters, &B,
                  &K,     &alpha0, &tol,     &max_sweeps};
  return cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(&csr_fixed_point_kernel<KPL>),
      dim3(blocks), dim3(kCsrThreads), args, 0, stream);
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

// Blocks of K4's cooperative grid for B documents of K topics (the size of
// its `partials` scratch is twice this), or minus a CUDA error code.
int lda_fixed_point_csr_blocks(int B, int K) {
  cudaGetLastError();
  int blocks = 0;
  cudaError_t err = cudaErrorInvalidValue;
  const int kpl = (K + kWarp - 1) / kWarp;
#define LDA_CSR_GRID_CASE(N)            \
  case N:                               \
    err = csr_grid<N>(B, &blocks);      \
    break;
  switch (kpl) {
    LDA_CSR_GRID_CASE(1)
    LDA_CSR_GRID_CASE(2)
    LDA_CSR_GRID_CASE(3)
    LDA_CSR_GRID_CASE(4)
    LDA_CSR_GRID_CASE(5)
    LDA_CSR_GRID_CASE(6)
    LDA_CSR_GRID_CASE(7)
    LDA_CSR_GRID_CASE(8)
    default:
      break;
  }
#undef LDA_CSR_GRID_CASE
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

int lda_fixed_point_csr(const int32_t* ids, const float* cnts,
                        const int64_t* offsets, const float* eb,
                        const float* gamma0, float* gamma, float* et,
                        float* partials, int32_t* iters, int B, int K,
                        float alpha0, float tol, int max_sweeps, int blocks,
                        void* stream) {
  cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int kpl = (K + kWarp - 1) / kWarp;
#define LDA_CSR_CASE(N)                                                      \
  case N:                                                                    \
    return launch_fixed_point_csr<N>(ids, cnts, offsets, eb, gamma0, gamma,  \
                                     et, partials, iters, B, K, alpha0, tol, \
                                     max_sweeps, blocks, s);
  switch (kpl) {
    LDA_CSR_CASE(1)
    LDA_CSR_CASE(2)
    LDA_CSR_CASE(3)
    LDA_CSR_CASE(4)
    LDA_CSR_CASE(5)
    LDA_CSR_CASE(6)
    LDA_CSR_CASE(7)
    LDA_CSR_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef LDA_CSR_CASE
}

int lda_token_pi_csr(const int32_t* ids, const float* cnts,
                     const int32_t* segs, const float* eb, const float* et,
                     float* pi, int64_t slots, int K, int quantize,
                     void* stream) {
  cudaGetLastError();
  constexpr int threads = 256;
  const int64_t blocks = (slots * kWarp + threads - 1) / threads;
  csr_token_pi_kernel<<<static_cast<unsigned>(blocks), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      ids, cnts, segs, eb, et, pi, slots, K, quantize);
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
