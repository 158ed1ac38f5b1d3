// CUDA kernels of the LDA E-step (IVI, Algorithm 1) for Hopper (sm_90a).
//
// Two launches carry one IVI update on the padded (B, L) layout:
//   K1 fixed_point_kernel      the whole gamma fixed point of a mini-batch,
//                              ending with a finish pass that writes the
//                              token-aligned responsibilities pi (K2's
//                              function, fused)
//   K3 segment_scatter_kernel  S = sum cnt * pi into (V, K) at the token ids
// and two on the flat CSR token stream (documents concatenated, one
// segment id per token):
//   K4 fixed_point_kernel      K1's kernel over each document's range of
//                              the stream (sorted by segment on the
//                              device), as one tile: stopped batch-wide;
//                              its finish writes flat pi (K5's function)
//   K3                         unchanged: flat rows are its native input
// The standalone pi kernels stay behind memo_delta / memo_delta_csr:
//   K2 token_pi_kernel         token-aligned pi
//   K5 csr_token_pi_kernel     flat pi (T, K)
// and three of the pre-fusion baseline (one launch per sweep over a dense
// count matrix C (B, V), and the one-hot scatter it used):
//   K6 sweep_kernel            one dense fixed-point sweep
//   K7 sstats_kernel           expected topic-word counts from C
//   K8 onehot_partials_kernel  pi and per-B-tile (nb, Vp, K) partials,
//      onehot_reduce_kernel    summed over nb
//
// Any K: K1/K4 keep a row in registers up to 256 topics (KPL = 1 ... 8
// instances) and run fixed_point_wide_kernel above, with the row in
// shared memory; K3 runs over 256-column chunks; K6-K8 tile K by 128.
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
#include <map>
#include <mutex>
#include <tuple>
#include <utility>

namespace cg = cooperative_groups;

namespace {

constexpr float kEps = 1e-30f;   // fp32-safe normaliser epsilon
constexpr int kWarp = 32;
constexpr int kMaxKPerLane = 8;  // K <= 256 in the register instances

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
// Stopping rule: the TPU kernel's, per tile of block_b documents. A tile
// stops once the mean |d gamma| over its rows and K topics is <= tol, or
// after max_sweeps; iters holds one count per tile.
//
// One cooperative launch runs every sweep of every tile. Row d's slots are
// d*L ... d*L + L - 1 (the padded layout), or offsets[d] ... offsets[d +
// 1] - 1 of the flat stream sorted by segment when `offsets` is given
// (K4). They are
// split over W warps (fp_warps_per_doc: 4 at L = 163), warp p taking the
// row's slots p, p + W, p + 2W, ... (the padding at a row's end spreads
// over all W); W and the split depend on the shape alone, so the bits do
// not depend on the grid. Each warp sums its slots' cnt / (E[theta].Eφ[id]
// + 1e-30) * Eφ[id] into a K-vector, with the Eφ rows of up to 4 live
// tokens loaded before their reductions (no serial load -> reduce -> load
// chain); the W vectors are summed in shared memory in warp order, and the
// document's first warp writes gamma' = alpha0 + E[theta] * acc, its
// E[theta] (kept in the E[theta] output between sweeps, so after the last
// sweep it holds E[theta] of the final gamma) and the row's |d gamma| to
// the document's slot of `delta`, double-buffered by sweep parity. After a
// grid sync every block sums each running tile's slots in fixed 128-row
// chunks (one warp a chunk, lanes strided over its slots, one butterfly),
// then the tile's chunk sums in chunk order, so every block takes the same
// stop decision from the same bits; a stopped tile does no more sweeps,
// and the sweeps end when every tile has stopped. A 128-row tile is one
// chunk, summed as one warp summed the whole tile before the chunks
// existed, so K1's outputs are bit-identical to that design's. Documents
// loop over the co-resident grid (the wrapper refuses a grid that cannot
// be launched that way). No atomics.
//
// The sweeps and the finish take their counts and Eφ through separate
// pointers: repro's estep_stream_dtype = "bfloat16" streams Eφ (and, on
// the padded layout, the dense counts) rounded through bf16 into fp32
// arithmetic, so the wrapper passes the sweeps copies rounded through bf16
// (the same values a bf16 load widens to) and the finish the fp32 inputs.
//
// The finish (K2 and K5 fused, when `pi` is given): after the last sweep
// each document's W warps walk their slots again, in the sweeps' order,
// with the document's final E[theta] in registers (one load a warp), and
// write pi = E[theta] * Eφ[id] / (sum_k E[theta] * Eφ[id] + 1e-30) from
// the fp32 Eφ, rounded through bf16 with `quantize`: two tokens' rows in
// flight, each row kept in registers between its dot and its store (read
// once). The dot runs lane by lane over k = lane, lane + 32, ... < K,
// then the same butterfly, each step the same explicitly rounded
// intrinsic as K2's (pi_dot_step, pi_value), so pi has K2's and K5's
// bits. Slots with count <= 0 get zero rows, and on the flat stream so
// does every slot outside the document ranges (a grid-strided
// loop over order[0, offsets[0]) and order[offsets[B], T)). The finish
// runs after the sweeps and within their 64 registers a thread (no
// spills, the same co-resident grid), so gamma, E[theta] and the sweep
// counts have the same bits, and the sweeps the same speed, with and
// without it.
//
// Bound: operations (4*K per live token per sweep, plus the digamma series
// per row); the bytes it must move are the token rows and the distinct Eφ
// rows, read once, plus pi written once with the finish. At B = 1024,
// L = 163 about 4,096 warps are in flight: a sweep costs about a quarter
// of the longest row's serial walk plus one grid-wide sync.
//
// K4: the gamma fixed point over a flat CSR token stream.
//
// Replaces _csr_fixed_point_kernel (repro/kernels/lda_estep.py:433). The
// TPU kernel found each token's document through an iota == segments
// selector matmul on the MXU, so any token order gives the same gamma; here
// the wrapper sorts the slots by segment on the device (one stable sort of
// T keys: the segment where the count is not 0, else B; no host sync) and
// gathers the ids and counts in that order once, so each document's live
// tokens are one contiguous range and the sweeps read no `order`; only
// the finish reads it, to write each slot's pi row where the slot lies in
// the stream. K1's kernel runs with those ranges and the whole batch as
// one tile, so the stop is
// batch-wide as repro's: the mean |d gamma| over all B rows (rows that own
// no token included) and K topics. On a stream already grouped by segment
// (the packer's) the live part of the order is the identity, so the warps
// walk the same slots in the same order as without it. W =
// fp_warps_per_doc(ceil(T / B)) (4 at T = 131,072, B = 1,024). Bound:
// operations, as K1 (0.0459 ms for 60 sweeps on the Arxiv-shaped first
// batch). A single warp walking a document's tokens as a chain of
// dependent load -> reduce -> FMA steps took ~450 ns a token (4.19 ms cold
// on an H100); here W warps share a document, each with four tokens'
// loads in flight, and the stop sum after each grid sync is spread over
// the block's warps (B / 128 chunks) instead of one warp walking all B
// slots.
// ---------------------------------------------------------------------------
constexpr int kFpThreads = 256;
constexpr int kFpWarps = kFpThreads / kWarp;
constexpr int kStopChunk = 128;   // rows per partial sum of the stop test
constexpr unsigned kAllLanes = 0xffffffffu;

// Warps per document row of L slots: a power of two, about 48 slots each,
// at most the block's warps.
int fp_warps_per_doc(int L) {
  int w = 1;
  while (w < kFpWarps && w * 48 < L) w *= 2;
  return w;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The steps of pi = t * e / (sum_k t * e + 1e-30), each an explicitly
// rounded intrinsic, so no kernel's compilation contracts them another
// way: K2, K5, K8 and K1/K4's finish form the same bits.
__device__ __forceinline__ float pi_dot_step(float t, float e, float part) {
  return __fmaf_rn(t, e, part);
}
__device__ __forceinline__ float pi_value(float t, float e, float p,
                                          int quantize) {
  const float v = __fdiv_rn(__fmul_rn(t, e), p);
  return quantize ? round_bf16(v) : v;
}

// Warp p's share of one row's sweep: acc += ratio * Eφ[id] over the live
// slots p, p + W, ... of the n at ids/cnts, in slot order.
template <int KPL>
__device__ __forceinline__ void strided_partial(
    const int32_t* __restrict__ ids, const float* __restrict__ cnts, int n,
    int p, int W, const float* __restrict__ eb, int K,
    const float (&et)[KPL], float (&acc)[KPL], int lane) {
  constexpr int U = KPL <= 4 ? 4 : 2;   // tokens in flight per warp
  for (int i0 = p; i0 < n; i0 += W * kWarp) {
    const int i = i0 + W * lane;
    int32_t my_id = 0;
    float my_cnt = 0.f;
    if (i < n) {
      my_id = ids[i];
      my_cnt = cnts[i];
    }
    // count-0 slots (padding) contribute exactly 0: skip them
    unsigned live = __ballot_sync(kAllLanes, my_cnt != 0.f);
    while (live) {
      float c[U], part[U], e[U][KPL];
      bool has[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        has[u] = live != 0;   // warp-uniform
        const int t = has[u] ? __ffs(live) - 1 : 0;
        live &= live - 1;
        c[u] = __shfl_sync(kAllLanes, my_cnt, t);
        const int32_t id = __shfl_sync(kAllLanes, my_id, t);
        const float* e_row = eb + static_cast<size_t>(id) * K;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int k = lane + j * kWarp;
          e[u][j] = has[u] && k < K ? __ldg(e_row + k) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        part[u] = 0.f;
#pragma unroll
        for (int j = 0; j < KPL; ++j) part[u] += et[j] * e[u][j];
        part[u] = warp_sum(part[u]);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (has[u]) {
          const float ratio = c[u] / (part[u] + kEps);
#pragma unroll
          for (int j = 0; j < KPL; ++j) acc[j] += ratio * e[u][j];
        }
      }
    }
  }
}

// Warp p's share of one row's finish: pi of the slots p, p + W, ... of the
// n at ids/cnts, from the fp32 Eφ and the row's final E[theta] et, in slot
// order; slot i's row is written at pi + ord[i] * K (pi + i * K without
// ord), a zero row where the count is not > 0.
template <int KPL>
__device__ __forceinline__ void strided_pi(
    const int32_t* __restrict__ ids, const float* __restrict__ cnts,
    const int64_t* __restrict__ ord, int n, int p, int W,
    const float* __restrict__ eb, int K, const float (&et)[KPL],
    float* __restrict__ pi, int quantize, int lane) {
  // two tokens in flight: four (the sweep's) push the kernel past its 64
  // registers a thread, into spills
  constexpr int U = 2;
  for (int i0 = p; i0 < n; i0 += W * kWarp) {
    const int i = i0 + W * lane;
    int my_s = 0;   // the output row (the flat entry checks T < 2^31)
    int32_t my_id = 0;
    float my_cnt = 0.f;
    if (i < n) {
      my_s = ord != nullptr ? static_cast<int>(ord[i]) : i;
      my_id = ids[i];
      my_cnt = cnts[i];
    }
    const bool mine = my_cnt > 0.f;
    for (unsigned dead = __ballot_sync(kAllLanes, i < n && !mine); dead;
         dead &= dead - 1) {
      float* out = pi + static_cast<int64_t>(
                            __shfl_sync(kAllLanes, my_s, __ffs(dead) - 1)) * K;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = lane + j * kWarp;
        if (k < K) out[k] = 0.f;
      }
    }
    unsigned live = __ballot_sync(kAllLanes, mine);
    while (live) {
      float part[U], e[U][KPL];
      int s[U];
      bool has[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        has[u] = live != 0;   // warp-uniform
        const int t = has[u] ? __ffs(live) - 1 : 0;
        live &= live - 1;
        s[u] = __shfl_sync(kAllLanes, my_s, t);
        const int32_t id = __shfl_sync(kAllLanes, my_id, t);
        const float* e_row = eb + static_cast<size_t>(id) * K;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int k = lane + j * kWarp;
          e[u][j] = has[u] && k < K ? __ldg(e_row + k) : 0.f;
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        // token_pi_row's dot: lane sums over k = lane, lane + 32, ... < K,
        // the butterfly, then + 1e-30
        part[u] = 0.f;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          if (lane + j * kWarp < K) {
            part[u] = pi_dot_step(et[j], e[u][j], part[u]);
          }
        }
        part[u] = __fadd_rn(warp_sum(part[u]), kEps);
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (has[u]) {
          float* out = pi + static_cast<int64_t>(s[u]) * K;
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const int k = lane + j * kWarp;
            if (k < K) out[k] = pi_value(et[j], e[u][j], part[u], quantize);
          }
        }
      }
    }
  }
}

// Row d's slots: n of them at base (d*L and L on the padded layout, the
// range offsets[d] ... offsets[d + 1] of the sorted flat stream).
__device__ __forceinline__ void fp_row(const int64_t* __restrict__ offsets,
                                       int L, int64_t d, int64_t& base,
                                       int& n) {
  base = offsets != nullptr ? offsets[d] : d * L;
  n = offsets != nullptr ? static_cast<int>(offsets[d + 1] - base) : L;
}

// Stop-test chunks per tile of block_b rows.
__host__ __device__ __forceinline__ int fp_chunks_per_tile(int block_b) {
  return (block_b + kStopChunk - 1) / kStopChunk;
}

// The fixed point's arguments, as the host gathers them (the kernel takes
// each as a __restrict__ parameter). offsets: nullptr for the padded
// layout (row d is slots d*L ... d*L + L - 1), else B + 1 range starts
// into the flat stream sorted by segment: ids and cnts are then the
// stream's gathered in `order` (T slots; sorted position i is stream slot
// order[i]), and L only sets W. cnts, eb: the counts and Eφ the sweeps
// read (rounded through bf16 for the bf16 stream); cnts32, eb32: the fp32
// ones the finish reads (the same pointers for the fp32 stream). pi:
// nullptr for no finish.
struct FpArgs {
  const int32_t* ids;
  const float* cnts;
  const float* cnts32;
  const int64_t* offsets;
  const int64_t* order;
  const float* eb;
  const float* eb32;
  const float* gamma0;
  float* gamma;
  float* et_out;
  float* delta;
  int32_t* iters;
  float* pi;
  int64_t T;
  int B, L, K;
  float alpha0, tol;
  int max_sweeps, block_b, W, quantize;
};

template <int KPL>
__global__ void __launch_bounds__(kFpThreads, 4)
    fixed_point_kernel(const int32_t* __restrict__ ids,
                       const float* __restrict__ cnts,
                       const float* __restrict__ cnts32,
                       const int64_t* __restrict__ offsets,
                       const int64_t* __restrict__ order,
                       const float* __restrict__ eb,
                       const float* __restrict__ eb32,
                       const float* __restrict__ gamma0,
                       float* __restrict__ gamma, float* __restrict__ et_out,
                       float* __restrict__ delta, int32_t* __restrict__ iters,
                       float* __restrict__ pi, int64_t T, int B, int L, int K,
                       float alpha0, float tol, int max_sweeps, int block_b,
                       int W, int quantize) {
  constexpr int KP = KPL * kWarp;
  cg::grid_group grid = cg::this_grid();
  const int nb = (B + block_b - 1) / block_b;
  const int cpt = fp_chunks_per_tile(block_b);
  const int nchunks = nb * cpt;
  extern __shared__ float fp_smem[];
  float* part = fp_smem;                                   // [warps][KP]
  float* csum = part + kFpWarps * KP;                      // [nb * cpt]
  int* stop = reinterpret_cast<int*>(csum + nchunks);      // [nb]
  __shared__ int all_done;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int dpb = kFpWarps / W;       // documents per block per round
  const int grp = warp / W, p = warp % W;
  const int64_t per_round = static_cast<int64_t>(gridDim.x) * dpb;
  const int rounds = static_cast<int>((B + per_round - 1) / per_round);
  auto doc = [&](int r) {
    return (r * static_cast<int64_t>(gridDim.x) + blockIdx.x) * dpb + grp;
  };
  int64_t base = 0;   // row d's n slots are ids/cnts + base
  int n = 0;

  // stop[t]: the sweeps tile t ran once it stopped, 0 while it runs
  for (int t = threadIdx.x; t < nb; t += kFpThreads) stop[t] = 0;
  for (int r = 0; r < rounds; ++r) {
    const int64_t d = doc(r);
    if (d < B && p == 0) {
      float g[KPL], et[KPL];
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = lane + j * kWarp;
        g[j] = k < K ? gamma0[d * K + k] : 0.f;
      }
      exp_elog_theta<KPL>(g, et, K, lane);
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = lane + j * kWarp;
        if (k < K) {
          gamma[d * K + k] = g[j];
          et_out[d * K + k] = et[j];
        }
      }
    }
  }
  __syncthreads();

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    float* slots = delta + static_cast<size_t>(sweep & 1) * B;
    for (int r = 0; r < rounds; ++r) {
      const int64_t d = doc(r);
      const bool active = d < B && stop[d / block_b] == 0;
      float et[KPL], acc[KPL];
      if (active) {
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int k = lane + j * kWarp;
          et[j] = k < K ? et_out[d * K + k] : 0.f;
          acc[j] = 0.f;
        }
        fp_row(offsets, L, d, base, n);
        strided_partial<KPL>(ids + base, cnts + base, n, p, W, eb, K, et,
                             acc, lane);
#pragma unroll
        for (int j = 0; j < KPL; ++j) part[warp * KP + lane + j * kWarp] = acc[j];
      }
      __syncthreads();
      if (active && p == 0) {
        float g[KPL], et_new[KPL], dsum = 0.f;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int k = lane + j * kWarp;
          float v = part[warp * KP + lane + j * kWarp];
          for (int q = 1; q < W; ++q) v += part[(warp + q) * KP + lane + j * kWarp];
          g[j] = 0.f;
          if (k < K) {
            g[j] = alpha0 + et[j] * v;
            dsum += fabsf(g[j] - gamma[d * K + k]);
            gamma[d * K + k] = g[j];
          }
        }
        exp_elog_theta<KPL>(g, et_new, K, lane);
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int k = lane + j * kWarp;
          if (k < K) et_out[d * K + k] = et_new[j];
        }
        dsum = warp_sum(dsum);
        if (lane == 0) slots[d] = dsum;
      }
      __syncthreads();   // `part` is refilled by the next round
    }
    __threadfence();
    grid.sync();
    // every block decides every running tile, from the same slots in the
    // same order (read past its L1: other SMs wrote them): 128-row chunk
    // sums, one warp a chunk, then each tile's chunks in chunk order
    for (int c = warp; c < nchunks; c += kFpWarps) {
      const int t = c / cpt;
      if (stop[t] != 0) continue;
      const int lo = t * block_b + (c % cpt) * kStopChunk;
      const int hi = min(min(t * block_b + block_b, B), lo + kStopChunk);
      float s = 0.f;
      for (int i = lo + lane; i < hi; i += kWarp) s += __ldcg(slots + i);
      s = warp_sum(s);
      if (lane == 0) csum[c] = s;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nb; t += kFpThreads) {
      if (stop[t] != 0) continue;
      const int rows = min(block_b, B - t * block_b);
      const int nc = fp_chunks_per_tile(rows);
      float total = csum[t * cpt];
      for (int c = 1; c < nc; ++c) total += csum[t * cpt + c];
      if (total / static_cast<float>(static_cast<int64_t>(rows) * K) <= tol) {
        stop[t] = sweep + 1;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int all = 1;
      for (int t = 0; t < nb; ++t) all &= stop[t] != 0;
      all_done = all;
    }
    __syncthreads();
    if (all_done) break;
  }

  if (blockIdx.x == 0) {
    for (int t = threadIdx.x; t < nb; t += kFpThreads) {
      iters[t] = stop[t] != 0 ? stop[t] : max_sweeps;
    }
  }
  if (pi == nullptr) return;

  // the finish: each document's E[theta] row was last written by its first
  // warp, in this block, before the sweeps' last __syncthreads
  for (int r = 0; r < rounds; ++r) {
    const int64_t d = doc(r);
    if (d >= B) continue;
    float et[KPL];
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      const int k = lane + j * kWarp;
      et[j] = k < K ? et_out[d * K + k] : 0.f;
    }
    fp_row(offsets, L, d, base, n);
    const bool flat = offsets != nullptr;
    strided_pi<KPL>(ids + base, cnts32 + base,
                    flat ? order + base : nullptr, n, p, W, eb32, K, et,
                    flat ? pi : pi + base * K, quantize, lane);
  }
  if (offsets != nullptr) {
    // the flat slots no document range covers get zero rows
    const int64_t head = offsets[0], tail = offsets[B];
    const int64_t uncovered = head + (T - tail);
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kFpWarps + warp;
         i < uncovered; i += static_cast<int64_t>(gridDim.x) * kFpWarps) {
      float* out = pi + order[i < head ? i : tail + (i - head)] * K;
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        const int k = lane + j * kWarp;
        if (k < K) out[k] = 0.f;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K1/K4 for K > kNarrowK topics.
//
// The KPL instances above keep a row's E[theta] and accumulator in
// registers, KPL values a lane, which caps them at kNarrowK = 256 topics
// (at 64 registers a thread, KPL = 6-8 already spill a few bytes; they
// are kept as they were, for their bits). Above that, each warp
// holds its document's E[theta] and its accumulator in shared memory, K
// floats each (2 * 8 * K * 4 bytes a block: 64 KB at K = 1,000), and walks
// each live token's Eφ row twice, lane-strided over all K: first
// p = sum_k E[theta] * Eφ (then the butterfly), then acc += c / p * Eφ.
// The second read of the row comes from L1/L2. Everything else is the KPL
// kernel's: the documents, warps and slots, the stop test and its chunk
// sums, the co-resident grid, the finish's pi bits (the same explicitly
// rounded steps, in K2's order, so pi equals K2's at any K). A lane owns
// topics lane, lane + 32, ... of the shared rows, so no two lanes write
// one word; the rows are bank-conflict free.
//
// Bound: operations, as the KPL kernel; the limit is shared memory (the
// wrapper raises past the card's per-block maximum: K <= 3,631 at
// B = 1,024 on an H100).
// ---------------------------------------------------------------------------
constexpr int kNarrowK = kMaxKPerLane * kWarp;

// warp's share of one row's sweep, acc and et in shared memory
__device__ __forceinline__ void wide_partial(
    const int32_t* __restrict__ ids, const float* __restrict__ cnts, int n,
    int p, int W, const float* __restrict__ eb, int K,
    const float* __restrict__ et, float* __restrict__ acc, int lane) {
  for (int i0 = p; i0 < n; i0 += W * kWarp) {
    const int i = i0 + W * lane;
    int32_t my_id = 0;
    float my_cnt = 0.f;
    if (i < n) {
      my_id = ids[i];
      my_cnt = cnts[i];
    }
    unsigned live = __ballot_sync(kAllLanes, my_cnt != 0.f);
    while (live) {
      const int t = __ffs(live) - 1;
      live &= live - 1;
      const float c = __shfl_sync(kAllLanes, my_cnt, t);
      const float* e_row =
          eb + static_cast<size_t>(__shfl_sync(kAllLanes, my_id, t)) * K;
      float part = 0.f;
#pragma unroll 4
      for (int k = lane; k < K; k += kWarp) part += et[k] * __ldg(e_row + k);
      const float ratio = c / (warp_sum(part) + kEps);
#pragma unroll 4
      for (int k = lane; k < K; k += kWarp) acc[k] += ratio * __ldg(e_row + k);
    }
  }
}

// warp's share of one row's finish (strided_pi over shared E[theta])
__device__ __forceinline__ void wide_pi(
    const int32_t* __restrict__ ids, const float* __restrict__ cnts,
    const int64_t* __restrict__ ord, int n, int p, int W,
    const float* __restrict__ eb, int K, const float* __restrict__ et,
    float* __restrict__ pi, int quantize, int lane) {
  for (int i0 = p; i0 < n; i0 += W * kWarp) {
    const int i = i0 + W * lane;
    int my_s = 0;
    int32_t my_id = 0;
    float my_cnt = 0.f;
    if (i < n) {
      my_s = ord != nullptr ? static_cast<int>(ord[i]) : i;
      my_id = ids[i];
      my_cnt = cnts[i];
    }
    const bool mine = my_cnt > 0.f;
    for (unsigned dead = __ballot_sync(kAllLanes, i < n && !mine); dead;
         dead &= dead - 1) {
      float* out = pi + static_cast<int64_t>(
                            __shfl_sync(kAllLanes, my_s, __ffs(dead) - 1)) * K;
      for (int k = lane; k < K; k += kWarp) out[k] = 0.f;
    }
    for (unsigned live = __ballot_sync(kAllLanes, mine); live;
         live &= live - 1) {
      const int t = __ffs(live) - 1;
      float* out = pi + static_cast<int64_t>(__shfl_sync(kAllLanes, my_s, t)) * K;
      const float* e_row =
          eb + static_cast<size_t>(__shfl_sync(kAllLanes, my_id, t)) * K;
      float part = 0.f;
      for (int k = lane; k < K; k += kWarp) {
        part = pi_dot_step(et[k], __ldg(e_row + k), part);
      }
      part = __fadd_rn(warp_sum(part), kEps);
      for (int k = lane; k < K; k += kWarp) {
        out[k] = pi_value(et[k], __ldg(e_row + k), part, quantize);
      }
    }
  }
}

// E[theta] of row d from its gamma (written to gamma first): the sum over
// all K, then the digamma series per topic
__device__ __forceinline__ void wide_etheta(const float* g, float* et_row,
                                            int K, int lane) {
  float s = 0.f;
  for (int k = lane; k < K; k += kWarp) s += g[k];
  const float psi_s = digamma_series(warp_sum(s));
  for (int k = lane; k < K; k += kWarp) {
    et_row[k] = expf(digamma_series(fmaxf(g[k], 1e-10f)) - psi_s);
  }
}

__global__ void __launch_bounds__(kFpThreads, 4)
    fixed_point_wide_kernel(const int32_t* __restrict__ ids,
                            const float* __restrict__ cnts,
                            const float* __restrict__ cnts32,
                            const int64_t* __restrict__ offsets,
                            const int64_t* __restrict__ order,
                            const float* __restrict__ eb,
                            const float* __restrict__ eb32,
                            const float* __restrict__ gamma0,
                            float* __restrict__ gamma,
                            float* __restrict__ et_out,
                            float* __restrict__ delta,
                            int32_t* __restrict__ iters,
                            float* __restrict__ pi, int64_t T, int B, int L,
                            int K, float alpha0, float tol, int max_sweeps,
                            int block_b, int W, int quantize) {
  cg::grid_group grid = cg::this_grid();
  const int nb = (B + block_b - 1) / block_b;
  const int cpt = fp_chunks_per_tile(block_b);
  const int nchunks = nb * cpt;
  extern __shared__ float fp_smem[];
  float* part = fp_smem;                                   // [warps][K]
  float* ets = part + kFpWarps * K;                        // [warps][K]
  float* csum = ets + kFpWarps * K;                        // [nb * cpt]
  int* stop = reinterpret_cast<int*>(csum + nchunks);      // [nb]
  __shared__ int all_done;
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int dpb = kFpWarps / W;
  const int grp = warp / W, p = warp % W;
  const int64_t per_round = static_cast<int64_t>(gridDim.x) * dpb;
  const int rounds = static_cast<int>((B + per_round - 1) / per_round);
  auto doc = [&](int r) {
    return (r * static_cast<int64_t>(gridDim.x) + blockIdx.x) * dpb + grp;
  };
  float* acc = part + warp * K;   // this warp's rows
  float* et = ets + warp * K;
  int64_t base = 0;
  int n = 0;

  for (int t = threadIdx.x; t < nb; t += kFpThreads) stop[t] = 0;
  for (int r = 0; r < rounds; ++r) {
    const int64_t d = doc(r);
    if (d < B && p == 0) {
      for (int k = lane; k < K; k += kWarp) gamma[d * K + k] = gamma0[d * K + k];
      __syncwarp();
      wide_etheta(gamma + d * K, et_out + d * K, K, lane);
    }
  }
  __syncthreads();

  for (int sweep = 0; sweep < max_sweeps; ++sweep) {
    float* slots = delta + static_cast<size_t>(sweep & 1) * B;
    for (int r = 0; r < rounds; ++r) {
      const int64_t d = doc(r);
      const bool active = d < B && stop[d / block_b] == 0;
      if (active) {
        for (int k = lane; k < K; k += kWarp) {
          et[k] = et_out[d * K + k];
          acc[k] = 0.f;
        }
        __syncwarp();
        fp_row(offsets, L, d, base, n);
        wide_partial(ids + base, cnts + base, n, p, W, eb, K, et, acc, lane);
      }
      __syncthreads();
      if (active && p == 0) {
        float dsum = 0.f;
        for (int k = lane; k < K; k += kWarp) {
          float v = part[warp * K + k];
          for (int q = 1; q < W; ++q) v += part[(warp + q) * K + k];
          const float g = alpha0 + et[k] * v;
          dsum += fabsf(g - gamma[d * K + k]);
          gamma[d * K + k] = g;
        }
        __syncwarp();
        wide_etheta(gamma + d * K, et_out + d * K, K, lane);
        dsum = warp_sum(dsum);
        if (lane == 0) slots[d] = dsum;
      }
      __syncthreads();
    }
    __threadfence();
    grid.sync();
    for (int c = warp; c < nchunks; c += kFpWarps) {
      const int t = c / cpt;
      if (stop[t] != 0) continue;
      const int lo = t * block_b + (c % cpt) * kStopChunk;
      const int hi = min(min(t * block_b + block_b, B), lo + kStopChunk);
      float s = 0.f;
      for (int i = lo + lane; i < hi; i += kWarp) s += __ldcg(slots + i);
      s = warp_sum(s);
      if (lane == 0) csum[c] = s;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nb; t += kFpThreads) {
      if (stop[t] != 0) continue;
      const int rows = min(block_b, B - t * block_b);
      const int nc = fp_chunks_per_tile(rows);
      float total = csum[t * cpt];
      for (int c = 1; c < nc; ++c) total += csum[t * cpt + c];
      if (total / static_cast<float>(static_cast<int64_t>(rows) * K) <= tol) {
        stop[t] = sweep + 1;
      }
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      int all = 1;
      for (int t = 0; t < nb; ++t) all &= stop[t] != 0;
      all_done = all;
    }
    __syncthreads();
    if (all_done) break;
  }

  if (blockIdx.x == 0) {
    for (int t = threadIdx.x; t < nb; t += kFpThreads) {
      iters[t] = stop[t] != 0 ? stop[t] : max_sweeps;
    }
  }
  if (pi == nullptr) return;

  for (int r = 0; r < rounds; ++r) {
    const int64_t d = doc(r);
    if (d >= B) continue;
    for (int k = lane; k < K; k += kWarp) et[k] = et_out[d * K + k];
    __syncwarp();
    fp_row(offsets, L, d, base, n);
    const bool flat = offsets != nullptr;
    wide_pi(ids + base, cnts32 + base, flat ? order + base : nullptr, n, p,
            W, eb32, K, et, flat ? pi : pi + base * K, quantize, lane);
    __syncwarp();   // `et` is refilled by the next round
  }
  if (offsets != nullptr) {
    const int64_t head = offsets[0], tail = offsets[B];
    const int64_t uncovered = head + (T - tail);
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kFpWarps + warp;
         i < uncovered; i += static_cast<int64_t>(gridDim.x) * kFpWarps) {
      float* out = pi + order[i < head ? i : tail + (i - head)] * K;
      for (int k = lane; k < K; k += kWarp) out[k] = 0.f;
    }
  }
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
// with count 0 only write zeros. The IVI update forms the same pi in K1's
// finish (the same bits); this launch serves memo_delta.
// ---------------------------------------------------------------------------
// pi of one live token slot across a warp: E[theta] row t_row times the
// token's Eφ row, normalised (shared by K2, K5 and K8; pi_dot_step and
// pi_value keep its bits equal to K1/K4's finish).
__device__ __forceinline__ void token_pi_row(float* out,
                                             const float* __restrict__ e_row,
                                             const float* __restrict__ t_row,
                                             int K, int lane, int quantize) {
  float part = 0.f;
  for (int k = lane; k < K; k += kWarp) {
    part = pi_dot_step(t_row[k], __ldg(e_row + k), part);
  }
  const float p = __fadd_rn(warp_sum(part), kEps);
  for (int k = lane; k < K; k += kWarp) {
    out[k] = pi_value(t_row[k], __ldg(e_row + k), p, quantize);
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
// token rows whose id is v. The wrapper segments the rows with fixed-size
// device ops and no host sync: every row gets the key id (V where its
// count is 0), one stable sort of all N keys gives `order`, and a sorted
// search gives seg_off (V + 1): id v's rows are order[seg_off[v] ...
// seg_off[v + 1]), in row order, empty for an id no live row carries (and
// ids outside [0, V) fall outside every range, as the TPU's one-hot
// selects no row for them).
//
// The kernel covers all V ids and writes every output row once, zeros for
// an empty id, so the wrapper fills nothing. Each warp owns kScatterIds
// consecutive ids, whose rows are one contiguous run of `order`: it loads
// their offsets with one coalesced load, then walks the run as one stream,
// 32 order entries and counts at a time, and stores an id's sums when the
// stream passes its last row (the lane owns topics lane, lane + 32, ...
// in registers; each id's rows are summed from zero in row order). The pi
// rows of a batch of 32 are prefetched into L2 as soon as their order
// entries arrive, so the row-by-row loads that follow wait on L2, not on
// device memory: the kernel is bound by the latency of dependent loads
// (offsets -> order -> pi), and this pays device-memory latency about
// once per 32 rows. Eight ids a warp (about seven live rows at the Arxiv
// shape, half the ids owning none) keep many short streams in flight; a
// row at a time and 64 registers (4 blocks an SM) keep the body free of
// spills. A segment of more than kLongSegment rows (a frequent word in
// many documents: up to B rows of a padded batch) is left out of the
// stream and summed by the whole block afterwards: cut into kScatterWarps
// contiguous parts of ceil(n / 8) rows, one a warp, the parts added in
// warp order in shared memory. The cut depends on the length alone, so
// every launch gives the same bits, with no fp32 atomics: resume
// bit-equality and the memo invariant need a fixed summation order.
//
// Bound: bytes: the live pi rows it reads (K floats each, coalesced) and
// the 2 * V * K floats it writes once (0.0624 ms on the Arxiv-shaped
// padded batch: 118,318 live rows, V = 141,927, K = 100). The TPU's
// iota == ids selector matmul is replaced by the sort, so no (block_v, T)
// selector exists.
// ---------------------------------------------------------------------------
constexpr int kScatterThreads = 256;
constexpr int kScatterWarps = kScatterThreads / kWarp;
constexpr int kScatterIds = 8;   // consecutive ids a warp owns
constexpr int64_t kLongSegment = 32;

template <int KPL>
__device__ __forceinline__ void store_row(float* out, const float (&v)[KPL],
                                          int K, int lane) {
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + j * kWarp;
    if (k < K) out[k] = v[j];
  }
}

// Ask L2 for the K floats of a row (every 128-byte line they touch).
__device__ __forceinline__ void prefetch_row(const float* row, int K) {
  const char* p = reinterpret_cast<const char*>(row);
  const int bytes = K * static_cast<int>(sizeof(float));
  for (int o = 0; o < bytes; o += 128) {
    asm volatile("prefetch.global.L2 [%0];" ::"l"(p + o));
  }
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p + bytes - 1));
}

// Row i < n of the sorted rows starting at order + i0: its index and count
// into the lane's registers, and its K columns of pi (rows ld floats apart)
// asked of L2.
__device__ __forceinline__ void fetch_rows(
    const int64_t* __restrict__ order, const float* __restrict__ cnts,
    const float* __restrict__ pi_new, const float* __restrict__ pi_old,
    int64_t i0, int64_t n, int K, int64_t ld, int lane, int64_t& row,
    float& cnt) {
  row = 0;
  cnt = 0.f;
  if (i0 + lane < n) {
    row = order[i0 + lane];
    prefetch_row(pi_new + row * ld, K);
    if (pi_old != nullptr) prefetch_row(pi_old + row * ld, K);
    cnt = __ldg(cnts + row);
  }
}

// The K columns of pi_new and pi_old of one row (rows ld floats apart)
// into the lane's registers (zeros past K, and for pi_old when there is
// none).
template <int KPL>
__device__ __forceinline__ void load_pi_row(
    const float* __restrict__ pi_new, const float* __restrict__ pi_old,
    int64_t row, int K, int64_t ld, float (&en)[KPL], float (&eo)[KPL],
    int lane) {
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = lane + j * kWarp;
    en[j] = k < K ? __ldg(pi_new + row * ld + k) : 0.f;
    eo[j] = k < K && pi_old != nullptr ? __ldg(pi_old + row * ld + k) : 0.f;
  }
}

template <int KPL>
__device__ __forceinline__ void add_row(float c, const float (&en)[KPL],
                                        const float (&eo)[KPL],
                                        float (&acc_new)[KPL],
                                        float (&acc_old)[KPL]) {
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    acc_new[j] += c * en[j];
    acc_old[j] += c * eo[j];
  }
}

// K > 256: blockIdx.y picks a chunk of KP = 256 columns (the KPL = 8
// instance; gridDim.y = 1 below), each summed in the same row order, so
// every column has the bits a launch over it alone would give.
template <int KPL>
__global__ void __launch_bounds__(kScatterThreads, KPL <= 4 ? 4 : 2)
    segment_scatter_kernel(const int64_t* __restrict__ order,
                           const int64_t* __restrict__ seg_off, int V,
                           const float* __restrict__ cnts,
                           const float* __restrict__ pi_new,
                           const float* __restrict__ pi_old,
                           float* __restrict__ s_new,
                           float* __restrict__ s_old, int K_all) {
  constexpr int KP = KPL * kWarp;
  constexpr unsigned kAll = 0xffffffffu;
  // this block's columns [k0, k0 + K) of the K_all-wide rows
  const int64_t ld = K_all;
  const int k0 = blockIdx.y * KP;
  const int K = min(KP, K_all - k0);
  pi_new += k0;
  if (pi_old != nullptr) pi_old += k0;
  s_new += k0;
  if (s_old != nullptr) s_old += k0;
  __shared__ float part[2][kScatterWarps][KP];   // long segments: new, old
  __shared__ unsigned long_ids[kScatterWarps];   // per warp, bit t: id t
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const bool has_old = pi_old != nullptr;
  const int64_t block_v =
      static_cast<int64_t>(blockIdx.x) * kScatterWarps * kScatterIds;
  const int64_t v0 = block_v + warp * kScatterIds;
  const int nvalid = static_cast<int>(max(
      static_cast<int64_t>(0), min(static_cast<int64_t>(kScatterIds), V - v0)));
  // lane t < nvalid: the rows [lo, hi) of id v0 + t
  int64_t lo = 0, hi = 0;
  if (lane < nvalid) {
    lo = seg_off[v0 + lane];
    hi = seg_off[v0 + lane + 1];
  }
  const unsigned longs_all = __ballot_sync(kAll, hi - lo > kLongSegment);
  if (lane == 0) long_ids[warp] = longs_all;

  float acc_new[KPL], acc_old[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) acc_new[j] = acc_old[j] = 0.f;
  int t = 0;                                  // the id being summed
  int64_t t_hi = __shfl_sync(kAll, hi, 0);    // one past its last row
  // store id t's sums (zeros for an empty id) and move on to id t + 1
  auto flush = [&]() {
    store_row<KPL>(s_new + (v0 + t) * ld, acc_new, K, lane);
    if (has_old) store_row<KPL>(s_old + (v0 + t) * ld, acc_old, K, lane);
#pragma unroll
    for (int j = 0; j < KPL; ++j) acc_new[j] = acc_old[j] = 0.f;
    ++t;
    t_hi = __shfl_sync(kAll, hi, t & (kWarp - 1));
  };

  // the warp's run of rows, long segments left out: [pos, stop) up to the
  // next long segment, then on past it
  int64_t pos = __shfl_sync(kAll, lo, 0);
  unsigned longs = longs_all;
  while (true) {
    const int next = longs ? __ffs(longs) - 1 : nvalid;
    const int64_t stop = next < nvalid
                             ? __shfl_sync(kAll, lo, next)
                             : __shfl_sync(kAll, hi, max(nvalid - 1, 0));
    for (int64_t i0 = pos; i0 < stop; i0 += kWarp) {
      int64_t my_row;
      float my_cnt;
      fetch_rows(order, cnts, pi_new, pi_old, i0, stop, K, ld, lane, my_row,
                 my_cnt);
      const int m = static_cast<int>(min(static_cast<int64_t>(kWarp),
                                         stop - i0));
      for (int u = 0; u < m; ++u) {
        float en[KPL], eo[KPL];   // loads first: they fly while ids flush
        load_pi_row<KPL>(pi_new, pi_old, __shfl_sync(kAll, my_row, u), K, ld,
                         en, eo, lane);
        const float c = __shfl_sync(kAll, my_cnt, u);
        while (t_hi <= i0 + u) flush();   // ids that ended before this row
        add_row<KPL>(c, en, eo, acc_new, acc_old);
      }
    }
    if (next >= nvalid) break;
    while (t < next) flush();
    // id `next` is long: the block sums and stores it below
    t = next + 1;
    t_hi = __shfl_sync(kAll, hi, t & (kWarp - 1));
    pos = __shfl_sync(kAll, hi, next);
    longs &= longs - 1;
  }
  while (t < nvalid) flush();

  // the block's long segments, one after another, each over all its warps
  __syncthreads();
  for (int w = 0; w < kScatterWarps; ++w) {
    for (unsigned m = long_ids[w]; m != 0; m &= m - 1) {   // block-uniform
      const int64_t v = block_v + w * kScatterIds + (__ffs(m) - 1);
      const int64_t start = seg_off[v];
      const int64_t len = seg_off[v + 1] - start;
      const int64_t per = (len + kScatterWarps - 1) / kScatterWarps;
      const int64_t a = start + min(len, warp * per);
      const int64_t b = start + min(len, (warp + 1) * per);
#pragma unroll
      for (int j = 0; j < KPL; ++j) acc_new[j] = acc_old[j] = 0.f;
      for (int64_t i0 = a; i0 < b; i0 += kWarp) {
        int64_t my_row;
        float my_cnt;
        fetch_rows(order, cnts, pi_new, pi_old, i0, b, K, ld, lane, my_row,
                   my_cnt);
        const int n = static_cast<int>(min(static_cast<int64_t>(kWarp),
                                           b - i0));
        for (int u = 0; u < n; ++u) {
          float en[KPL], eo[KPL];
          load_pi_row<KPL>(pi_new, pi_old, __shfl_sync(kAll, my_row, u), K,
                           ld, en, eo, lane);
          add_row<KPL>(__shfl_sync(kAll, my_cnt, u), en, eo, acc_new,
                       acc_old);
        }
      }
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        part[0][warp][lane + j * kWarp] = acc_new[j];
        part[1][warp][lane + j * kWarp] = acc_old[j];
      }
      __syncthreads();
      if (warp < (has_old ? 2 : 1)) {   // warp 0 sums S_new, warp 1 S_old
        float sum[KPL];
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          sum[j] = part[warp][0][lane + j * kWarp];
          for (int q = 1; q < kScatterWarps; ++q) {
            sum[j] += part[warp][q][lane + j * kWarp];
          }
        }
        store_row<KPL>((warp == 0 ? s_new : s_old) + v * ld, sum, K, lane);
      }
      __syncthreads();   // `part` is refilled by the next long segment
    }
  }
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
// 0 only write zeros). The IVI update forms the same pi in K4's finish;
// this launch serves memo_delta_csr.
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

// ---------------------------------------------------------------------------
// K6 and K7: the dense per-sweep E-step (the pre-fusion baseline).
//
// Both form P = E[theta] * Eφ^T + 1e-30 and R = C / P tile by tile in
// shared memory and registers; the (B, V) arrays P and R never reach
// device memory. The dense count matrix C (B, V) is read exactly once per
// launch. All products are fp32 FMAs on the SIMT cores: TF32 tensor cores
// keep 10 mantissa bits, which the 2e-5 parity bars cannot absorb.
//
// K is register-blocked in tiles of kDenseK = 128 (shared-memory rows are
// zero beyond K, so padded topics add nothing). Above 128 topics the grid
// gains an axis over K tiles: each block still forms the whole
// denominator P over every K tile (loading the tiles in turn, in K order,
// so every block of a row forms the same P bits), then accumulates and
// writes its own tile's columns. At K <= 128 the kTiled = false instance
// runs: one tile known at compile time, the single-tile design's code and
// arithmetic. Rows are kDenseStride
// floats apart: a
// multiple of 4 (float4 loads) whose offset of 4 banks per row makes the
// lane-per-row float4 reads of the P phase conflict-free.
// ---------------------------------------------------------------------------
constexpr int kDenseK = 128;
constexpr int kDenseStride = kDenseK + 4;
constexpr int kDenseThreads = 256;     // 8 warps
constexpr int kSweepBM = 64;           // K6: B rows per block (8 per warp)
constexpr int kSweepBV = 32;           // K6: V columns per inner tile
constexpr int kSweepBlocks = 256;      // K6: blocks aimed for per launch
constexpr int kSstatsBV = 64;          // K7: V rows per block (8 per warp)
constexpr int kSstatsBB = 32;          // K7: B rows per inner tile

constexpr size_t kSweepSmem =
    (static_cast<size_t>(kSweepBM + kSweepBV) * kDenseStride +
     kSweepBM * (kSweepBV + 1)) * sizeof(float);
constexpr size_t kSstatsSmem =
    (static_cast<size_t>(kSstatsBV + kSstatsBB) * kDenseStride +
     kSstatsBB * (kSstatsBV + 1)) * sizeof(float);

// rows [r0, r0 + n) and columns [k0, k0 + 128) of a row-major (R, K)
// matrix into shared memory, with zeros past row R and past column K
__device__ __forceinline__ void load_dense_rows(float* dst,
                                                const float* __restrict__ src,
                                                int r0, int n, int R, int K,
                                                int k0) {
  for (int i = threadIdx.x; i < n * kDenseK; i += blockDim.x) {
    const int r = i / kDenseK, k = i % kDenseK;
    const int row = r0 + r;
    dst[r * kDenseStride + k] =
        (row < R && k0 + k < K) ? src[static_cast<size_t>(row) * K + k0 + k]
                                : 0.f;
  }
}

// the float4 steps of a K tile starting at k0: its columns rounded up to 4
__device__ __forceinline__ int dense_kq(int K, int k0) {
  return (min(kDenseK, K - k0) + 3) & ~3;
}

__device__ __forceinline__ float4 lds4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// K6: one dense sweep, gamma' = alpha0 + E[theta] * ((C / P) . Eφ).
//
// Replaces _sweep_kernel (repro/kernels/lda_estep.py:817). Grid (B / 64,
// splits, K tiles): block (x, y, z) owns 64 rows of B, the y-th contiguous
// range of V tiles and the z-th tile of 128 topics. It keeps those rows'
// E[theta] in shared memory, walks its V range 32 columns at a time (Eφ
// tile into shared memory; P over every K tile, R for 64 x 32 in
// registers, R to shared memory; acc += R . Eφ over its topics) and writes
// its (64, 128) partial sum to `part`. The split over V is what fills the
// card: at B = 1024 there are only 16 row tiles. The last block of a (row
// tile, K tile) to finish (an integer ticket, __threadfence before it)
// sums the partials in split order and writes gamma', so each output
// element is written by one block, with no fp32 atomics, and the result is
// the same bits on every launch. The block resets its ticket for the next
// launch.
//
// Bound: operations (4*B*V*K FMA-counted operations per sweep, two
// products); C is read once per K tile. The inner loops issue about one
// shared-memory wavefront per 2.7 FMA instructions, so they cannot reach
// the fp32 peak; a wgmma (3xTF32) design is later work.
template <bool kTiled>
__global__ void __launch_bounds__(kDenseThreads)
    sweep_kernel(const float* __restrict__ c, const float* __restrict__ et,
                 const float* __restrict__ eb, float* __restrict__ out,
                 float* __restrict__ part, int* __restrict__ tickets, int B,
                 int V, int K, float alpha0, int tiles_per_split) {
  extern __shared__ float4 smem4[];
  float* s_et = reinterpret_cast<float*>(smem4);         // [BM][stride]
  float* s_eb = s_et + kSweepBM * kDenseStride;          // [BV][stride]
  float* s_r = s_eb + kSweepBV * kDenseStride;           // [BM][BV + 1]
  __shared__ int is_last;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int row0 = blockIdx.x * kSweepBM;
  const int nsplit = gridDim.y;
  const int vtiles = (V + kSweepBV - 1) / kSweepBV;
  const int t_lo = blockIdx.y * tiles_per_split;
  const int t_hi = min(vtiles, t_lo + tiles_per_split);
  // this block's topics; one tile (the K <= 128 instance) at compile time
  const int nk = kTiled ? gridDim.z : 1;
  const int kc = kTiled ? blockIdx.z * kDenseK : 0;

  if (nk == 1) load_dense_rows(s_et, et, row0, kSweepBM, B, K, 0);
  float acc[8][4];   // rows warp * 8 + i, topics kc + lane + 32 * j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int t = t_lo; t < t_hi; ++t) {
    const int v0 = t * kSweepBV;
    // P for rows warp * 8 + i, column lane, over every K tile in order
    float p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = 0.f;
    for (int q = 0; q < nk; ++q) {
      __syncthreads();   // the last tile's reads of s_et, s_eb, s_r are done
      if (nk > 1) load_dense_rows(s_et, et, row0, kSweepBM, B, K, q * kDenseK);
      load_dense_rows(s_eb, eb, v0, kSweepBV, V, K, q * kDenseK);
      __syncthreads();
      const float* e_row = s_eb + lane * kDenseStride;
      const int kq = dense_kq(K, q * kDenseK);
      for (int k = 0; k < kq; k += 4) {
        const float4 e = lds4(e_row + k);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          p[i] = dot4(lds4(s_et + (warp * 8 + i) * kDenseStride + k), e, p[i]);
      }
    }
    if (nk > 1 && blockIdx.z != nk - 1) {   // back to this block's topics
      __syncthreads();
      load_dense_rows(s_et, et, row0, kSweepBM, B, K, kc);
      load_dense_rows(s_eb, eb, v0, kSweepBV, V, K, kc);
    }
    {
      const int v = v0 + lane;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int m = warp * 8 + i, row = row0 + m;
        const float cv =
            (row < B && v < V) ? c[static_cast<size_t>(row) * V + v] : 0.f;
        s_r[m * (kSweepBV + 1) + lane] = cv / (p[i] + kEps);
      }
    }
    __syncthreads();
    // acc += R . Eφ
    for (int vv = 0; vv < kSweepBV; ++vv) {
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) e[j] = s_eb[vv * kDenseStride + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float r = s_r[(warp * 8 + i) * (kSweepBV + 1) + vv];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(r, e[j], acc[i][j]);
      }
    }
  }
  if (nk > 1) {   // this block's E[theta] tile, whatever the V loop left
    __syncthreads();
    load_dense_rows(s_et, et, row0, kSweepBM, B, K, kc);
  }

  // this block's partial sum, then the (row tile, K tile)'s ticket
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = row0 + warp * 8 + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kc + lane + 32 * j;
      if (row < B && k < K) {
        part[(static_cast<size_t>(blockIdx.y) * B + row) * K + k] = acc[i][j];
      }
    }
  }
  __threadfence();
  __syncthreads();
  int* ticket = tickets + blockIdx.z * gridDim.x + blockIdx.x;
  if (tid == 0) is_last = atomicAdd(ticket, 1) == nsplit - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int m = warp * 8 + i, row = row0 + m;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kc + lane + 32 * j;
      if (row < B && k < K) {
        float s = 0.f;
        for (int q = 0; q < nsplit; ++q) {
          s += __ldcg(part + (static_cast<size_t>(q) * B + row) * K + k);
        }
        out[static_cast<size_t>(row) * K + k] =
            alpha0 + s_et[m * kDenseStride + lane + 32 * j] * s;
      }
    }
  }
  if (tid == 0) *ticket = 0;
}

// K7: expected topic-word counts S = Eφ * (R^T . E[theta]).
//
// Replaces _sstats_kernel (repro/kernels/lda_estep.py:870). Block (x, y)
// owns 64 rows of V, every B row and the z-th tile of 128 topics: it keeps
// its Eφ rows in shared memory, walks B 32 rows at a time (E[theta] tile
// into shared memory; P over every K tile, R for 32 x 64 in registers, R
// to shared memory; acc += R^T . E[theta] over its topics) and writes Eφ *
// acc. The output tile is owned by one block, summed in B order:
// deterministic, no atomics. V / 64 blocks (2,224 at the Arxiv vocabulary)
// fill the card without a split.
//
// Bound: operations, as K6.
template <bool kTiled>
__global__ void __launch_bounds__(kDenseThreads)
    sstats_kernel(const float* __restrict__ c, const float* __restrict__ et,
                  const float* __restrict__ eb, float* __restrict__ out,
                  int B, int V, int K) {
  extern __shared__ float4 smem4[];
  float* s_eb = reinterpret_cast<float*>(smem4);         // [BV][stride]
  float* s_et = s_eb + kSstatsBV * kDenseStride;         // [BB][stride]
  float* s_r = s_et + kSstatsBB * kDenseStride;          // [BB][BV + 1]
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int v0 = blockIdx.x * kSstatsBV;
  // this block's topics; one tile (the K <= 128 instance) at compile time
  const int nk = kTiled ? gridDim.y : 1;
  const int kc = kTiled ? blockIdx.y * kDenseK : 0;

  if (nk == 1) load_dense_rows(s_eb, eb, v0, kSstatsBV, V, K, 0);
  float acc[8][4];   // V rows warp * 8 + i, topics kc + lane + 32 * j
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // P phase: V column (warp & 1) * 32 + lane, B rows (warp >> 1) * 8 + i
  const int pv = (warp & 1) * kWarp + lane;
  const int pb = (warp >> 1) * 8;
  for (int b0 = 0; b0 < B; b0 += kSstatsBB) {
    float p[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = 0.f;
    for (int q = 0; q < nk; ++q) {
      __syncthreads();   // the last tile's reads of s_eb, s_et, s_r are done
      if (nk > 1) load_dense_rows(s_eb, eb, v0, kSstatsBV, V, K, q * kDenseK);
      load_dense_rows(s_et, et, b0, kSstatsBB, B, K, q * kDenseK);
      __syncthreads();
      const float* e_row = s_eb + pv * kDenseStride;
      const int kq = dense_kq(K, q * kDenseK);
      for (int k = 0; k < kq; k += 4) {
        const float4 e = lds4(e_row + k);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          p[i] = dot4(lds4(s_et + (pb + i) * kDenseStride + k), e, p[i]);
      }
    }
    if (nk > 1 && blockIdx.y != nk - 1) {   // back to this block's topics
      __syncthreads();
      load_dense_rows(s_eb, eb, v0, kSstatsBV, V, K, kc);
      load_dense_rows(s_et, et, b0, kSstatsBB, B, K, kc);
    }
    {
      const int v = v0 + pv;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int b = b0 + pb + i;
        const float cv =
            (b < B && v < V) ? c[static_cast<size_t>(b) * V + v] : 0.f;
        s_r[(pb + i) * (kSstatsBV + 1) + pv] = cv / (p[i] + kEps);
      }
    }
    __syncthreads();
    // acc += R^T . E[theta]
    for (int m = 0; m < kSstatsBB; ++m) {
      float t[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) t[j] = s_et[m * kDenseStride + lane + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float r = s_r[m * (kSstatsBV + 1) + warp * 8 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(r, t[j], acc[i][j]);
      }
    }
  }
  if (nk > 1) {   // this block's Eφ tile, whatever the B loop left
    __syncthreads();
    load_dense_rows(s_eb, eb, v0, kSstatsBV, V, K, kc);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int vl = warp * 8 + i, v = v0 + vl;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = kc + lane + 32 * j;
      if (v < V && k < K) {
        out[static_cast<size_t>(v) * K + k] =
            s_eb[vl * kDenseStride + lane + 32 * j] * acc[i][j];
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K8: the one-hot memo delta (the retired scatter, kept as a baseline).
//
// Replaces _memo_delta_onehot_kernel (repro/kernels/lda_estep.py:677). It
// keeps the baseline's structure, which is what BENCH_estep prices: grid
// (V tiles of 128, B tiles of block_b); block (j, i) writes its own
// (128, K) slice of the per-B-tile partials part[i] (nb, Vp, K), every row
// of it exactly once, zeros included; a second kernel sums the partials
// over nb in index order. The TPU's (128 x block_b*L) one-hot matmul is
// not carried over: block (j, i) compacts, in token order, the tile's
// slots whose id falls in V tile j into shared memory (1,024 slots per
// pass), forms pi for exactly those slots with K2's device function (so pi
// is written once over the grid and equals K2's bits), and warp w sums
// cnt * pi into its rows w, w + 32, w + 64, w + 96 in token order.
// Slots whose id lies outside [0, Vp) have their pi written by the j = 0
// blocks and are scattered nowhere, as the one-hot selects no row for them.
// Above 128 topics the grid gains an axis z over tiles of 128 topics:
// block (j, i, z) forms each slot's whole denominator (K2's sum, so the
// same bits in every block) and writes, reads and scatters only its own
// topics' pi columns.
//
// Bound: bytes. The function moves the (B, L, K) cubes (eb_tok, old pi in;
// pi out) and the (V, K) outputs; the partials add 2 * nb * Vp * K * 4
// bytes written and read again, the transient the segment-sum path (K2 +
// K3) removes.
// ---------------------------------------------------------------------------
constexpr int kOnehotBV = 128;
constexpr int kOnehotThreads = 1024;
constexpr int kOnehotRowsPerWarp = kOnehotBV / (kOnehotThreads / kWarp);

// pi of one live token slot, columns [k0, k1) only: token_pi_row's
// denominator over all K, the same steps, so the columns equal its bits.
__device__ __forceinline__ void token_pi_cols(float* out,
                                              const float* __restrict__ e_row,
                                              const float* __restrict__ t_row,
                                              int K, int k0, int k1, int lane,
                                              int quantize) {
  float part = 0.f;
  for (int k = lane; k < K; k += kWarp) {
    part = pi_dot_step(t_row[k], __ldg(e_row + k), part);
  }
  const float p = __fadd_rn(warp_sum(part), kEps);
  for (int k = k0 + lane; k < k1; k += kWarp) {
    out[k] = pi_value(t_row[k], __ldg(e_row + k), p, quantize);
  }
}

template <int KPL, bool kTiled>
__global__ void __launch_bounds__(kOnehotThreads)
    onehot_partials_kernel(const int32_t* __restrict__ ids,
                           const float* __restrict__ cnts,
                           const float* __restrict__ eb_tok,
                           const float* __restrict__ old_pi,
                           const float* __restrict__ et, float* pi,
                           float* __restrict__ part_new,
                           float* __restrict__ part_old, int L, int K,
                           int block_b, int vp, int quantize) {
  __shared__ int s_slot[kOnehotThreads];
  __shared__ int s_row[kOnehotThreads];
  __shared__ int s_warp_off[kWarp];
  __shared__ int s_n;
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  const int j = blockIdx.x;
  const int v_lo = j * kOnehotBV;
  const int64_t slot0 = static_cast<int64_t>(blockIdx.y) * block_b * L;
  const int nslots = block_b * L;
  const bool has_old = old_pi != nullptr;
  // this block's topics [kc, kc + kn); all K (<= 128) when not tiled
  const int kc = kTiled ? blockIdx.z * kDenseK : 0;
  const int kn = kTiled ? min(kDenseK, K - kc) : K;

  float acc_new[kOnehotRowsPerWarp][KPL], acc_old[kOnehotRowsPerWarp][KPL];
#pragma unroll
  for (int q = 0; q < kOnehotRowsPerWarp; ++q)
#pragma unroll
    for (int jj = 0; jj < KPL; ++jj) acc_new[q][jj] = acc_old[q][jj] = 0.f;

  for (int c0 = 0; c0 < nslots; c0 += kOnehotThreads) {
    // 1. this tile's slots, compacted in token order: local row, or -1 for
    //    a slot whose pi this block writes but scatters nowhere
    const int s = c0 + tid;
    int row = -2;
    if (s < nslots) {
      const int id = ids[slot0 + s];
      if (id >= v_lo && id < v_lo + kOnehotBV) {
        row = id - v_lo;
      } else if (j == 0 && (id < 0 || id >= vp)) {
        row = -1;
      }
    }
    const unsigned mine = __ballot_sync(0xffffffffu, row != -2);
    if (lane == 0) s_warp_off[warp] = __popc(mine);
    __syncthreads();
    if (warp == 0) {
      const int n = s_warp_off[lane];
      int incl = n;
#pragma unroll
      for (int o = 1; o < kWarp; o <<= 1) {
        const int up = __shfl_up_sync(0xffffffffu, incl, o);
        if (lane >= o) incl += up;
      }
      s_warp_off[lane] = incl - n;
      if (lane == kWarp - 1) s_n = incl;
    }
    __syncthreads();
    if (row != -2) {
      const int pos = s_warp_off[warp] + __popc(mine & ((1u << lane) - 1u));
      s_slot[pos] = s;
      s_row[pos] = row;
    }
    __syncthreads();
    const int n = s_n;

    // 2. pi of the compacted slots, one warp per slot
    for (int t = warp; t < n; t += kOnehotThreads / kWarp) {
      const int64_t g = slot0 + s_slot[t];
      float* out = pi + g * K;
      if (!(cnts[g] > 0.f)) {
        for (int k = kc + lane; k < kc + kn; k += kWarp) out[k] = 0.f;
      } else if (kTiled) {
        token_pi_cols(out, eb_tok + g * K, et + (g / L) * K, K, kc, kc + kn,
                      lane, quantize);
      } else {
        token_pi_row(out, eb_tok + g * K, et + (g / L) * K, K, lane,
                     quantize);
      }
    }
    __syncthreads();   // the block's pi writes are visible to all its warps

    // 3. cnt * pi into this warp's rows, in token order
    for (int t0 = 0; t0 < n; t0 += kWarp) {
      const int t = t0 + lane;
      const int r = t < n ? s_row[t] : -1;
      unsigned match =
          __ballot_sync(0xffffffffu, r >= 0 && (r & (kWarp - 1)) == warp);
      while (match) {
        const int src = __ffs(match) - 1;
        match &= match - 1;
        const int q = __shfl_sync(0xffffffffu, r, src) / kWarp;
        const int64_t g = slot0 + s_slot[t0 + src];
        const float cnt = cnts[g];
#pragma unroll
        for (int jj = 0; jj < KPL; ++jj) {
          const int k = kc + lane + jj * kWarp;
          if (k < kc + kn) {
            const float wn = cnt * pi[g * K + k];
            const float wo = has_old ? cnt * old_pi[g * K + k] : 0.f;
#pragma unroll
            for (int qq = 0; qq < kOnehotRowsPerWarp; ++qq) {
              if (qq == q) {
                acc_new[qq][jj] += wn;
                acc_old[qq][jj] += wo;
              }
            }
          }
        }
      }
    }
    __syncthreads();   // s_slot / s_row are refilled by the next pass
  }

  // 4. every row of this block's partial slice, written once
  const int64_t base = static_cast<int64_t>(blockIdx.y) * vp + v_lo;
#pragma unroll
  for (int q = 0; q < kOnehotRowsPerWarp; ++q) {
    const int64_t v = base + warp + q * kWarp;
#pragma unroll
    for (int jj = 0; jj < KPL; ++jj) {
      const int k = kc + lane + jj * kWarp;
      if (k < kc + kn) {
        part_new[v * K + k] = acc_new[q][jj];
        if (has_old) part_old[v * K + k] = acc_old[q][jj];
      }
    }
  }
}

// S[e] = sum over i of part[i][e] for the first V * K elements of each
// (Vp, K) partial, in index order i = 0, 1, ..., nb - 1.
__global__ void __launch_bounds__(256)
    onehot_reduce_kernel(const float* __restrict__ part,
                         float* __restrict__ out, int nb, int64_t n,
                         int64_t stride) {
  const int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (e >= n) return;
  float s = 0.f;
  for (int i = 0; i < nb; ++i) s += part[i * stride + e];
  out[e] = s;
}

// K1's dynamic shared memory for K topics: the warps' partial vectors
// (KPL * 32 floats each; for K > kNarrowK, the wide kernel's accumulator
// and E[theta], K floats each), the stop test's chunk sums and the tiles'
// stop counts.
size_t fp_smem_bytes(int K, int B, int block_b) {
  const size_t nb = (B + block_b - 1) / block_b;
  const size_t per_warp = K <= kNarrowK
                              ? static_cast<size_t>((K + kWarp - 1) / kWarp) * kWarp
                              : 2 * static_cast<size_t>(K);
  return static_cast<size_t>(kFpWarps) * per_warp * sizeof(float) +
         nb * fp_chunks_per_tile(block_b) * sizeof(float) +
         nb * sizeof(int);
}

// The co-resident capacity of a fixed-point kernel (blocks per SM times
// SMs) for a dynamic shared size, cached per kernel, device and size: the
// attribute call and the occupancy query run once for each, not on every
// update. A kernel's shared-memory limit only ever rises (to the largest
// size seen), so a cached smaller size still launches after a larger one.
cudaError_t fp_capacity(const void* kernel, size_t smem, int* capacity) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t>, int> cache;
  // the attribute as set, per kernel and device
  static std::map<std::pair<const void*, int>, size_t> limit;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find({kernel, dev, smem});
  if (hit != cache.end()) {
    *capacity = hit->second;
    return cudaSuccess;
  }
  err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err != cudaSuccess) return err;
  if (!coop) return cudaErrorNotSupported;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (smem > limit[{kernel, dev}]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    limit[{kernel, dev}] = smem;
  }
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kFpThreads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *capacity = cache[{kernel, dev, smem}] = per_sm * sms;
  return cudaSuccess;
}

// The fixed point's kernel for K topics: the KPL = ceil(K / 32) instance
// of 1 ... 8, or the wide kernel above kNarrowK.
const void* fp_kernel(int K) {
#define LDA_FP_CASE(N) \
  case N:              \
    return reinterpret_cast<const void*>(&fixed_point_kernel<N>);
  switch ((K + kWarp - 1) / kWarp) {
    LDA_FP_CASE(1)
    LDA_FP_CASE(2)
    LDA_FP_CASE(3)
    LDA_FP_CASE(4)
    LDA_FP_CASE(5)
    LDA_FP_CASE(6)
    LDA_FP_CASE(7)
    LDA_FP_CASE(8)
    default:
      return reinterpret_cast<const void*>(&fixed_point_wide_kernel);
  }
#undef LDA_FP_CASE
}

// The co-resident grid of K1 for B documents of L slots and K topics: W
// warps per document, at most the capacity. Returns cudaSuccess and sets
// *blocks, or the error that forbids a cooperative launch.
cudaError_t fp_grid(int B, int L, int K, int block_b, int* blocks) {
  if (K < 1) return cudaErrorInvalidValue;
  int capacity = 0;
  const cudaError_t err =
      fp_capacity(fp_kernel(K), fp_smem_bytes(K, B, block_b), &capacity);
  if (err != cudaSuccess) return err;
  const int dpb = kFpWarps / fp_warps_per_doc(L);
  *blocks = std::max(1, std::min((B + dpb - 1) / dpb, capacity));
  return cudaSuccess;
}

// K1 (offsets == nullptr) or K4 (L = ceil(T / B), block_b = B), on the
// kernel for a.K topics.
cudaError_t dispatch_fixed_point(FpArgs a, cudaStream_t stream) {
  a.W = fp_warps_per_doc(a.L);
  int blocks = 0;
  const cudaError_t err = fp_grid(a.B, a.L, a.K, a.block_b, &blocks);
  if (err != cudaSuccess) return err;
  void* args[] = {&a.ids,    &a.cnts,   &a.cnts32,     &a.offsets,
                  &a.order,  &a.eb,     &a.eb32,       &a.gamma0,
                  &a.gamma,  &a.et_out, &a.delta,      &a.iters,
                  &a.pi,     &a.T,      &a.B,          &a.L,
                  &a.K,      &a.alpha0, &a.tol,        &a.max_sweeps,
                  &a.block_b, &a.W,     &a.quantize};
  return cudaLaunchCooperativeKernel(fp_kernel(a.K), dim3(blocks),
                                     dim3(kFpThreads), args,
                                     fp_smem_bytes(a.K, a.B, a.block_b),
                                     stream);
}

// K6's V tiles per split for B rows and V columns: about kSweepBlocks
// blocks in all, at most one split per V tile. A function of the shape
// only, so the partial sums, and with them gamma's bits, do not depend on
// the card.
int sweep_tiles_per_split(int B, int V) {
  const int row_tiles = std::max(1, (B + kSweepBM - 1) / kSweepBM);
  const int vtiles = (V + kSweepBV - 1) / kSweepBV;
  const int want =
      std::max(1, std::min((kSweepBlocks + row_tiles - 1) / row_tiles, vtiles));
  return std::max(1, (vtiles + want - 1) / want);
}

// K6's splits: the V tiles cut into runs of sweep_tiles_per_split, none
// empty (at least one split, so a V of 0 still writes gamma' = alpha0).
int sweep_splits(int B, int V) {
  const int vtiles = (V + kSweepBV - 1) / kSweepBV;
  const int per = sweep_tiles_per_split(B, V);
  return std::max(1, (vtiles + per - 1) / per);
}

template <int KPL, bool kTiled>
cudaError_t launch_memo_delta_onehot(const int32_t* ids, const float* cnts,
                                     const float* eb_tok, const float* old_pi,
                                     const float* et, float* pi,
                                     float* part_new, float* part_old,
                                     float* s_new, float* s_old, int B, int L,
                                     int K, int V, int block_b, int vp,
                                     int quantize, cudaStream_t stream) {
  const dim3 grid(vp / kOnehotBV, B / block_b, (K + kDenseK - 1) / kDenseK);
  onehot_partials_kernel<KPL, kTiled><<<grid, kOnehotThreads, 0, stream>>>(
      ids, cnts, eb_tok, old_pi, et, pi, part_new, part_old, L, K, block_b,
      vp, quantize);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int nb = B / block_b;
  const int64_t n = static_cast<int64_t>(V) * K;
  const int64_t stride = static_cast<int64_t>(vp) * K;
  const unsigned blocks = static_cast<unsigned>((n + 255) / 256);
  onehot_reduce_kernel<<<blocks, 256, 0, stream>>>(part_new, s_new, nb, n,
                                                   stride);
  err = cudaGetLastError();
  if (err != cudaSuccess || old_pi == nullptr) return err;
  onehot_reduce_kernel<<<blocks, 256, 0, stream>>>(part_old, s_old, nb, n,
                                                   stride);
  return cudaGetLastError();
}

// K6 / K7 on the single-tile (K <= 128) or the K-tiled instance.
template <bool kTiled>
cudaError_t launch_sweep(dim3 grid, cudaStream_t stream, const float* c,
                         const float* et, const float* eb, float* out,
                         float* part, int* tickets, int B, int V, int K,
                         float alpha0, int tiles_per_split) {
  const cudaError_t err = cudaFuncSetAttribute(
      sweep_kernel<kTiled>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSweepSmem));
  if (err != cudaSuccess) return err;
  sweep_kernel<kTiled><<<grid, kDenseThreads, kSweepSmem, stream>>>(
      c, et, eb, out, part, tickets, B, V, K, alpha0, tiles_per_split);
  return cudaGetLastError();
}

template <bool kTiled>
cudaError_t launch_sstats(dim3 grid, cudaStream_t stream, const float* c,
                          const float* et, const float* eb, float* out,
                          int B, int V, int K) {
  const cudaError_t err = cudaFuncSetAttribute(
      sstats_kernel<kTiled>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSstatsSmem));
  if (err != cudaSuccess) return err;
  sstats_kernel<kTiled><<<grid, kDenseThreads, kSstatsSmem, stream>>>(
      c, et, eb, out, B, V, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory a block of K1/K4 takes for B documents
// and K topics in tiles of block_b (K4: block_b = B), and the card's
// per-block maximum (or minus a CUDA error code): the fixed point's only
// limit on K.
int lda_fixed_point_smem_bytes(int B, int K, int block_b) {
  if (B < 1 || K < 1 || block_b < 1) return 0;
  return static_cast<int>(std::min<size_t>(fp_smem_bytes(K, B, block_b),
                                           INT32_MAX));
}

int lda_max_smem_bytes() {
  int dev = 0, bytes = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        &bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return err == cudaSuccess ? bytes : -static_cast<int>(err);
}

// Blocks of K1's cooperative grid for B documents of L slots and K topics
// in tiles of block_b, or minus a CUDA error code (lda_fixed_point sizes
// its own grid the same way; this reports it). K4's grid is the one for
// L = ceil(T / B) and block_b = B.
int lda_fixed_point_blocks(int B, int L, int K, int block_b) {
  cudaGetLastError();
  if (B < 1 || L < 0 || block_b < 1) return -cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = fp_grid(B, L, K, block_b, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Warps per document of K1 and K4 for rows of L slots (K4: L = ceil(T / B)).
int lda_fixed_point_warps(int L) { return fp_warps_per_doc(L); }

// K1 over a padded (B, L) batch. cnts (B, L) and eb = Eφ (V, K): fp32;
// sweep_cnts and sweep_eb: what the sweeps read (the same pointers, or
// copies rounded through bf16 for repro's bf16 stream of the dense counts
// and Eφ). pi: nullptr, or the (B, L, K) output of the finish (from cnts
// and eb, rounded through bf16 with quantize). delta: 2 * B floats of
// scratch (the per-document |d gamma| slots).
int lda_fixed_point(const int32_t* ids, const float* cnts, const float* eb,
                    const float* sweep_cnts, const float* sweep_eb,
                    const float* gamma0, float* gamma, float* et,
                    float* delta, int32_t* iters, float* pi, int B, int L,
                    int K, float alpha0, float tol, int max_sweeps,
                    int block_b, int quantize, void* stream) {
  cudaGetLastError();  // clear a stale error so the return is this launch's
  FpArgs a{};
  a.ids = ids;
  a.cnts = sweep_cnts;
  a.cnts32 = cnts;
  a.eb = sweep_eb;
  a.eb32 = eb;
  a.gamma0 = gamma0;
  a.gamma = gamma;
  a.et_out = et;
  a.delta = delta;
  a.iters = iters;
  a.pi = pi;
  a.T = static_cast<int64_t>(B) * L;
  a.B = B;
  a.L = L;
  a.K = K;
  a.alpha0 = alpha0;
  a.tol = tol;
  a.max_sweeps = max_sweeps;
  a.block_b = block_b;
  a.quantize = quantize;
  return dispatch_fixed_point(a, static_cast<cudaStream_t>(stream));
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

// K4 over a T-slot stream (T < 2^31): order (T) lists the slots sorted by
// segment, ids and cnts are the stream's gathered in that order, and
// document d's tokens are sorted positions offsets[d] ... offsets[d + 1] -
// 1; the whole batch is one stopping tile, iters one count. eb / sweep_eb
// as lda_fixed_point (the counts stay fp32 on this layout, as in repro).
// pi: nullptr, or the flat (T, K) output of the finish, in stream order.
// delta: 2 * B floats of scratch.
int lda_fixed_point_csr(const int32_t* ids, const float* cnts,
                        const int64_t* offsets, const int64_t* order,
                        const float* eb, const float* sweep_eb,
                        const float* gamma0, float* gamma, float* et,
                        float* delta, int32_t* iters, float* pi, int B,
                        int64_t T, int K, float alpha0, float tol,
                        int max_sweeps, int quantize, void* stream) {
  cudaGetLastError();
  if (B < 1 || T < 0 || T >= (int64_t{1} << 31) || offsets == nullptr ||
      order == nullptr) {
    return cudaErrorInvalidValue;
  }
  FpArgs a{};
  a.ids = ids;
  a.cnts = cnts;
  a.cnts32 = cnts;
  a.offsets = offsets;
  a.order = order;
  a.eb = sweep_eb;
  a.eb32 = eb;
  a.gamma0 = gamma0;
  a.gamma = gamma;
  a.et_out = et;
  a.delta = delta;
  a.iters = iters;
  a.pi = pi;
  a.T = T;
  a.B = B;
  a.L = static_cast<int>(std::min<int64_t>((T + B - 1) / B, 1 << 30));
  a.K = K;
  a.alpha0 = alpha0;
  a.tol = tol;
  a.max_sweeps = max_sweeps;
  a.block_b = B;
  a.quantize = quantize;
  return dispatch_fixed_point(a, static_cast<cudaStream_t>(stream));
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

// K3 over all V ids: seg_off (V + 1) cuts `order`; writes every row of
// s_new (and of s_old when pi_old is given). Any K: above 256 topics the
// KPL = 8 instance runs over ceil(K / 256) column chunks (grid y).
int lda_segment_scatter(const int64_t* order, const int64_t* seg_off, int V,
                        const float* cnts, const float* pi_new,
                        const float* pi_old, float* s_new, float* s_old,
                        int K, void* stream) {
  cudaGetLastError();
  if (V < 0 || K < 1) return cudaErrorInvalidValue;
  if (V == 0) return cudaSuccess;
  constexpr int per_block = kScatterWarps * kScatterIds;
  const int kpl = std::min((K + kWarp - 1) / kWarp, kMaxKPerLane);
  const dim3 grid((V + per_block - 1) / per_block,
                  (K + kpl * kWarp - 1) / (kpl * kWarp));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDA_SCATTER_CASE(N)                                                  \
  case N:                                                                    \
    segment_scatter_kernel<N><<<grid, kScatterThreads, 0, s>>>(              \
        order, seg_off, V, cnts, pi_new, pi_old, s_new, s_old, K);           \
    break;
  switch (kpl) {
    LDA_SCATTER_CASE(1)
    LDA_SCATTER_CASE(2)
    LDA_SCATTER_CASE(3)
    LDA_SCATTER_CASE(4)
    LDA_SCATTER_CASE(5)
    LDA_SCATTER_CASE(6)
    LDA_SCATTER_CASE(7)
    LDA_SCATTER_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef LDA_SCATTER_CASE
  return cudaGetLastError();
}

// K tiles of the dense kernels K6, K7 and K8 (128 topics each): K6's
// tickets are one per (64-row tile, K tile).
int lda_dense_k_tiles(int K) { return (K + kDenseK - 1) / kDenseK; }

// K6's V splits for B rows and V columns: the first dimension of its
// `part` scratch (splits, B, K).
int lda_sweep_splits(int B, int V) { return sweep_splits(B, V); }

int lda_sweep(const float* c, const float* et, const float* eb, float* out,
              float* part, int* tickets, int B, int V, int K, float alpha0,
              int nsplit, void* stream) {
  cudaGetLastError();
  if (K < 1 || nsplit != sweep_splits(B, V)) return cudaErrorInvalidValue;
  if (B == 0) return cudaSuccess;
  const dim3 grid((B + kSweepBM - 1) / kSweepBM, nsplit,
                  (K + kDenseK - 1) / kDenseK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int per_split = sweep_tiles_per_split(B, V);
  return K > kDenseK
             ? launch_sweep<true>(grid, s, c, et, eb, out, part, tickets, B,
                                  V, K, alpha0, per_split)
             : launch_sweep<false>(grid, s, c, et, eb, out, part, tickets, B,
                                   V, K, alpha0, per_split);
}

int lda_sstats(const float* c, const float* et, const float* eb, float* out,
               int B, int V, int K, void* stream) {
  cudaGetLastError();
  if (K < 1) return cudaErrorInvalidValue;
  if (V == 0) return cudaSuccess;
  const dim3 blocks((V + kSstatsBV - 1) / kSstatsBV,
                    (K + kDenseK - 1) / kDenseK);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return K > kDenseK
             ? launch_sstats<true>(blocks, s, c, et, eb, out, B, V, K)
             : launch_sstats<false>(blocks, s, c, et, eb, out, B, V, K);
}

// K8's V tile: the partials' vocabulary axis is padded to a multiple of it.
int lda_onehot_block_v() { return kOnehotBV; }

int lda_memo_delta_onehot(const int32_t* ids, const float* cnts,
                          const float* eb_tok, const float* old_pi,
                          const float* et, float* pi, float* part_new,
                          float* part_old, float* s_new, float* s_old, int B,
                          int L, int K, int V, int block_b, int vp,
                          int quantize, void* stream) {
  cudaGetLastError();
  if (block_b < 1 || B % block_b != 0 || vp % kOnehotBV != 0 || vp < V ||
      K < 1) {
    return cudaErrorInvalidValue;
  }
  if (B == 0 || vp == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > kDenseK) {   // tiles of 128 topics over grid z
    return launch_memo_delta_onehot<kDenseK / kWarp, true>(
        ids, cnts, eb_tok, old_pi, et, pi, part_new, part_old, s_new, s_old,
        B, L, K, V, block_b, vp, quantize, s);
  }
#define LDA_ONEHOT_CASE(N)                                                  \
  case N:                                                                   \
    return launch_memo_delta_onehot<N, false>(                              \
        ids, cnts, eb_tok, old_pi, et, pi, part_new, part_old, s_new, s_old, \
        B, L, K, V, block_b, vp, quantize, s);
  switch ((K + kWarp - 1) / kWarp) {
    LDA_ONEHOT_CASE(1)
    LDA_ONEHOT_CASE(2)
    LDA_ONEHOT_CASE(3)
    LDA_ONEHOT_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef LDA_ONEHOT_CASE
}

}  // extern "C"
