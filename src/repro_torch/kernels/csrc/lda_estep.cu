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
// The standalone pi kernels stay behind memo_delta / memo_delta_csr, one
// body over runs of consecutive slots with 16-byte span stores:
//   K2 token_pi_kernel         token-aligned pi
//   K5 csr_token_pi_kernel     flat pi (T, K)
// and three of the pre-fusion baseline (one launch per sweep over a dense
// count matrix C (B, V), and the one-hot memo delta it used):
//   K6 dense_tc_kernel         one dense fixed-point sweep on the tensor
//                              cores
//   K7 dense_tc_kernel         expected topic-word counts from C, the same
//      (transposed)            body with the operands' roles swapped
//   K8 onehot_kernel           pi and the new/old masses in one segment
//                              pass, summed by B tile in the baseline's order
//
// Any K: K1/K4 keep a row in registers up to 256 topics (KPL = 1 ... 8
// instances) and run fixed_point_wide_kernel above, with the row in
// shared memory; K3 runs over 256-column chunks; K6 and K7 above 128
// topics make R in a first pass (r_pass_kernel) and tile the topics of
// their product pass by 128, and K8 tiles K by 128.
//
// Built by nvcc into a shared library with a plain C interface and loaded
// with ctypes (repro_torch/kernels/build.py). Every entry point launches on
// the caller's stream, allocates nothing, and returns cudaGetLastError().
// All arithmetic is fp32, but for K6's and K7's products (bf16 x 3 on
// wgmma, fp32 accumulators: see their note).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

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
// after max_sweeps; iters holds one count per tile. The tiles are cut
// within groups of `group` rows (FpTiles): D-IVI stacks its live workers'
// batches into one launch, one group a worker, so a tile never holds two
// workers' documents and its mean counts its own worker's rows only, as
// the TPU kernel under vmap stops each worker's tiles. group = B is one
// batch's tiles.
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
// without it. It keeps its scalar stores: K2's path (rows staged in shared
// memory, then 16-byte stores) needs registers the 64 do not leave (every
// instance spilled with it), and what fits (the rows asked of L2 as their
// ids arrive, streaming stores, 16-byte zero rows) measured within the
// finish's run-to-run spread on an H100.
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

// K2's and K5's stores of pi: streaming (evict-first), so the 67 MB of pi
// that K2 writes through the 50 MB L2 at the Arxiv shape pushes out less
// of the Eφ rows that its next loads hit there (about 1% faster than plain
// stores on an H100).
__device__ __forceinline__ void pi_store(float* p, float v) { __stcs(p, v); }
__device__ __forceinline__ void pi_store4(float4* p, float4 v) {
  __stcs(p, v);
}

// Floats from dst to its next 16-byte boundary (0 ... 3).
__device__ __forceinline__ int to_16b(const float* dst) {
  return static_cast<int>((0u - (reinterpret_cast<uintptr_t>(dst) >> 2)) & 3u);
}

// The warp's copy of `len` floats from src (a staging buffer in shared
// memory) to dst: scalars up to dst's first 16-byte boundary, whole 16-byte
// vectors (a lane a vector, so a warp's store covers 512 contiguous bytes;
// read from shared memory as one vector where src is aligned as dst is,
// else as four floats), then up to 3 scalars. A copy: no bit changes.
__device__ __forceinline__ void store_span(float* __restrict__ dst,
                                           const float* src, int len,
                                           int lane) {
  const int head = min(len, to_16b(dst));
  const int nv = (len - head) >> 2;
  const int tail = head + 4 * nv;
  if (lane < head) pi_store(dst + lane, src[lane]);
  if (lane < len - tail) pi_store(dst + tail + lane, src[tail + lane]);
  float4* dv = reinterpret_cast<float4*>(dst + head);
  const float* sv = src + head;
  if ((reinterpret_cast<uintptr_t>(sv) & 15u) == 0) {
    const float4* sv4 = reinterpret_cast<const float4*>(sv);
    for (int q = lane; q < nv; q += kWarp) pi_store4(dv + q, sv4[q]);
  } else {
    for (int q = lane; q < nv; q += kWarp) {
      pi_store4(dv + q, make_float4(sv[4 * q], sv[4 * q + 1], sv[4 * q + 2],
                                    sv[4 * q + 3]));
    }
  }
}

// Where to stage the floats bound for dst: at dst's offset from a 16-byte
// boundary past the 16-byte aligned `stage`.
__device__ __forceinline__ float* staged_like(float* stage, const float* dst) {
  return stage + ((reinterpret_cast<uintptr_t>(dst) >> 2) & 3u);
}

// The warp's `len` zeros at dst, as store_span stores them.
__device__ __forceinline__ void store_zeros(float* __restrict__ dst, int len,
                                            int lane) {
  const int head = min(len, to_16b(dst));
  const int nv = (len - head) >> 2;
  const int tail = head + 4 * nv;
  if (lane < head) pi_store(dst + lane, 0.f);
  if (lane < len - tail) pi_store(dst + tail + lane, 0.f);
  float4* dv = reinterpret_cast<float4*>(dst + head);
  for (int q = lane; q < nv; q += kWarp) {
    pi_store4(dv + q, make_float4(0.f, 0.f, 0.f, 0.f));
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

// The stop test's tiles: the B rows are B / group groups of `group` rows,
// each cut into tiles of block_b rows from its own first row, so tile t
// covers rows lo(t) ... lo(t) + rows(t) - 1 and no tile straddles two
// groups. At group = B these are one batch's tiles (t * block_b, and
// min(block_b, B - t * block_b) rows).
struct FpTiles {
  int group, block_b, per_group;
  __host__ __device__ FpTiles(int group_, int block_b_)
      : group(group_),
        block_b(block_b_),
        per_group((group_ + block_b_ - 1) / block_b_) {}
  __host__ __device__ int count(int B) const { return B / group * per_group; }
  // d < B < 2^31: 32-bit divisions, which keep the sweep loop's registers
  __device__ __forceinline__ int of(int d) const {
    const int g = d / group;
    return g * per_group + (d - g * group) / block_b;
  }
  __device__ __forceinline__ int lo(int t) const {
    return t / per_group * group + t % per_group * block_b;
  }
  __device__ __forceinline__ int rows(int t) const {
    return min(block_b, group - t % per_group * block_b);
  }
};

// The fixed point's arguments, as the host gathers them (the kernel takes
// each as a __restrict__ parameter). offsets: nullptr for the padded
// layout (row d is slots d*L ... d*L + L - 1), else B + 1 range starts
// into the flat stream sorted by segment: ids and cnts are then the
// stream's gathered in `order` (T slots; sorted position i is stream slot
// order[i]), and L only sets W. cnts, eb: the counts and Eφ the sweeps
// read (rounded through bf16 for the bf16 stream); cnts32, eb32: the fp32
// ones the finish reads (the same pointers for the fp32 stream). pi:
// nullptr for no finish. group: the rows of one stop-test group (B: one
// batch; K4 always B).
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
  int max_sweeps, block_b, group, W, quantize;
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
                       int group, int W, int quantize) {
  constexpr int KP = KPL * kWarp;
  cg::grid_group grid = cg::this_grid();
  const FpTiles tiles(group, block_b);
  const int nb = tiles.count(B);
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
      const bool active =
          d < B && stop[tiles.of(static_cast<int>(d))] == 0;
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
      const int lo = tiles.lo(t) + (c % cpt) * kStopChunk;
      const int hi = min(tiles.lo(t) + tiles.rows(t), lo + kStopChunk);
      float s = 0.f;
      for (int i = lo + lane; i < hi; i += kWarp) s += __ldcg(slots + i);
      s = warp_sum(s);
      if (lane == 0) csum[c] = s;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nb; t += kFpThreads) {
      if (stop[t] != 0) continue;
      const int rows = tiles.rows(t);
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
                            int block_b, int group, int W, int quantize) {
  cg::grid_group grid = cg::this_grid();
  const FpTiles tiles(group, block_b);
  const int nb = tiles.count(B);
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
      const bool active =
          d < B && stop[tiles.of(static_cast<int>(d))] == 0;
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
      const int lo = tiles.lo(t) + (c % cpt) * kStopChunk;
      const int hi = min(tiles.lo(t) + tiles.rows(t), lo + kStopChunk);
      float s = 0.f;
      for (int i = lo + lane; i < hi; i += kWarp) s += __ldcg(slots + i);
      s = warp_sum(s);
      if (lane == 0) csum[c] = s;
    }
    __syncthreads();
    for (int t = threadIdx.x; t < nb; t += kFpThreads) {
      if (stop[t] != 0) continue;
      const int rows = tiles.rows(t);
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
// K2 and K5: token-aligned pi, on the padded layout and on the flat stream.
//
// K2 replaces _token_pi_kernel (repro/kernels/lda_estep.py:208), K5
// _csr_token_pi_kernel (:558). Slot s's pi row is
//   E[theta][doc] * Eφ[id] / (sum_k E[theta][doc] * Eφ[id] + 1e-30)
// with doc = s / L (K2) or the slot's segment id (K5), a zero row where the
// count is not > 0, rounded through bf16 with `quantize` (the memo wire: the
// scatter then sums the rounded value). K1's and K4's finish forms the same
// pi with the same explicitly rounded steps (pi_dot_step, pi_value), so the
// bits are equal; these launches serve memo_delta and memo_delta_csr.
//
// Bound: bytes, the (slots, K) fp32 pi written once (66.8 MB at the Arxiv
// shape, 0.020 of the 0.028 ms bound), then the distinct Eφ rows, the
// tokens and E[theta]. The first port gave each slot a warp that loaded the
// count, then the id, then the Eφ and E[theta] rows twice (the dot, the
// values), then stored four scalar floats a lane over a row only 16-byte
// aligned: about 20 waves of short dependent chains, a third of the bound's
// rate. Timed in parts on an H100, its loads alone took 63% of its time, the dot and division 18%, the stores 19%.
//
// Here, up to 256 topics (KPL = ceil(K / 32) <= 8), a warp owns runs of 8
// consecutive slots (kPiRun), and the grid, what is co-resident, loops
// over the runs:
//   - a run's ids, counts and documents come in one load (a lane a slot),
//     the next run's while this one is computed, and its live Eφ rows are
//     asked of L2 at once;
//   - its slots go in groups of up to U (tokens in flight) whose live slots
//     share one document, and E[theta] is loaded into registers only when
//     the document changes: about once a run on the padded layout, once a
//     segment on the packer's flat stream (any order is right, only slower);
//   - a group's Eφ rows are loaded together, each dot reduced in the first
//     port's order (lane sums over k = lane, lane + 32, ..., each step
//     pi_dot_step, the butterfly, then + 1e-30), and the values (pi_value,
//     elementwise, so their layout touches no bit) and the zero rows written
//     to the warp's staging rows in shared memory;
//   - the group's rows are one contiguous span of pi on both layouts (m * K
//     floats), written by store_span as whole 16-byte vectors, 512
//     contiguous bytes a warp store, with a scalar head and tail where the
//     span is not 16-byte aligned (K % 4 != 0); the span is staged at its
//     destination's offset from a 16-byte boundary, so the vectors are read
//     from shared memory whole too.
// Above 256 topics (KPL = 0) a row is long enough to fill a warp, and a
// warp takes one slot, as the first port did, every slot of the batch
// launched at once: its Eφ row is copied into the warp's staging row by
// cp.async (every copy in flight, no register held), the dot is taken
// from there with E[theta] through L1, the values overwrite the row, and
// the row goes out as one span. On an H100 this is about 5% slower than
// the first port at K = 300 (whose rows stay in L1, with no shared memory
// beside it) and about 18% faster at 1,000; runs of slots, with their rows
// in registers or 4 rows staged in shared memory, were slower still at
// 300: too few rows in flight an SM at their occupancy.
// At the Arxiv shape K2 reaches about half the byte bound's rate on an
// H100 (0.056 ms against 0.028, from 0.080).
// ---------------------------------------------------------------------------
constexpr int kPiThreads = 256;

constexpr int kPiRun = 8;   // slots of a run with rows in registers

// Rows of a group (tokens in flight) at KPL topics a lane.
__host__ __device__ constexpr int pi_group(int kpl) {
  return kpl <= 4 ? 4 : 2;
}

// Floats of a warp's staging rows: `rows` rows of K and 3 to align them, a
// multiple of 4 (so the next warp's rows start 16-byte aligned).
__host__ __device__ inline int pi_stage_floats(int rows, int K) {
  return (rows * K + 6) / 4 * 4;
}

// Copy one float from global to shared memory without a register
// (cp.async, through L1); the copies complete at copy_async_wait.
__device__ __forceinline__ void copy_async_f32(float* smem,
                                               const float* gmem) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(a),
               "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// The wide body of K2 (segs == nullptr: doc = slot / L) and K5 (doc =
// segs[s]): a warp a slot.
__device__ __forceinline__ void pi_slot(
    const int32_t* __restrict__ ids, const float* __restrict__ cnts,
    const int32_t* __restrict__ segs, const float* __restrict__ eb,
    const float* __restrict__ et, float* __restrict__ pi, int64_t slots,
    int L, int K, int quantize) {
  extern __shared__ __align__(16) float pi_smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int64_t s =
      static_cast<int64_t>(blockIdx.x) * (blockDim.x / kWarp) + warp;
  if (s >= slots) return;
  float* dst = pi + s * K;
  if (!(cnts[s] > 0.f)) {
    store_zeros(dst, K, lane);
    return;
  }
  // the Eφ row copied into the staging row with every copy in flight,
  // then the dot and the values (in place) with E[theta] through L1; a
  // lane touches only its own topics until the span's store
  float* row = staged_like(pi_smem + warp * pi_stage_floats(1, K), dst);
  const float* e_row = eb + static_cast<size_t>(ids[s]) * K;
  for (int k = lane; k < K; k += kWarp) copy_async_f32(row + k, e_row + k);
  const float* t_row =
      et + static_cast<int64_t>(segs != nullptr ? segs[s] : s / L) * K;
  copy_async_wait();
  float part = 0.f;
#pragma unroll 4
  for (int k = lane; k < K; k += kWarp) {
    part = pi_dot_step(__ldg(t_row + k), row[k], part);
  }
  part = __fadd_rn(warp_sum(part), kEps);
#pragma unroll 4
  for (int k = lane; k < K; k += kWarp) {
    row[k] = pi_value(__ldg(t_row + k), row[k], part, quantize);
  }
  __syncwarp();
  store_span(dst, row, K, lane);
}

// The body of K2 and K5 up to kNarrowK topics, over runs of kPiRun slots.
template <int KPL>
__device__ __forceinline__ void pi_runs(
    const int32_t* __restrict__ ids, const float* __restrict__ cnts,
    const int32_t* __restrict__ segs, const float* __restrict__ eb,
    const float* __restrict__ et, float* __restrict__ pi, int64_t slots,
    int L, int K, int quantize) {
  constexpr int U = pi_group(KPL);
  constexpr int run = kPiRun;
  extern __shared__ __align__(16) float pi_smem[];
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int warps = blockDim.x / kWarp;
  float* stage = pi_smem + warp * pi_stage_floats(U, K);
  const int64_t runs = (slots + run - 1) / run;
  const int64_t step = static_cast<int64_t>(gridDim.x) * warps;
  // lane < run: the id, count and document of slot r * run + lane
  auto fetch = [&](int64_t r, int32_t& id, float& c, int& doc) {
    const int64_t s = r * run + lane;
    id = 0;
    c = 0.f;
    doc = 0;
    if (lane < run && s < slots) {
      id = ids[s];
      c = cnts[s];
      doc = segs != nullptr ? segs[s] : static_cast<int>(s / L);
    }
  };
  int64_t r = static_cast<int64_t>(blockIdx.x) * warps + warp;
  int32_t next_id;
  float next_c;
  int next_doc;
  fetch(r, next_id, next_c, next_doc);
  int cur = -1;   // the document whose E[theta] the warp holds
  float t[KPL];
#pragma unroll
  for (int j = 0; j < KPL; ++j) t[j] = 0.f;
  for (; r < runs; r += step) {
    const int32_t my_id = next_id;
    const float my_c = next_c;
    const int my_doc = next_doc;
    fetch(r + step, next_id, next_c, next_doc);
    const int64_t s0 = r * run;
    const int m =
        static_cast<int>(min(static_cast<int64_t>(run), slots - s0));
    const unsigned live = __ballot_sync(kAllLanes, lane < m && my_c > 0.f);
    if ((live >> lane) & 1u) {
      prefetch_row(eb + static_cast<size_t>(my_id) * K, K);
    }
    for (int i = 0; i < m;) {
      // the group: slots i ... i + g - 1, its live ones of one document
      int g = 0, gdoc = -1;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int d = __shfl_sync(kAllLanes, my_doc, (i + u) & (kWarp - 1));
        const bool in = g == u && i + u < m;
        const bool lv = in && ((live >> (i + u)) & 1u);
        if (in && (!lv || gdoc < 0 || d == gdoc)) {
          ++g;
          if (lv) gdoc = d;
        }
      }
      float* dst = pi + (s0 + i) * K;
      float* src = staged_like(stage, dst);
      if (gdoc >= 0 && gdoc != cur) {
        cur = gdoc;
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          const int k = lane + j * kWarp;
          t[j] = k < K ? et[static_cast<int64_t>(cur) * K + k] : 0.f;
        }
      }
      float e[U][KPL], part[U];
      bool has[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        has[u] = u < g && ((live >> (i + u)) & 1u);   // warp-uniform
        const int32_t id =
            __shfl_sync(kAllLanes, my_id, (i + u) & (kWarp - 1));
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
        if (has[u]) {
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            if (lane + j * kWarp < K) {
              part[u] = pi_dot_step(t[j], e[u][j], part[u]);
            }
          }
          part[u] = __fadd_rn(warp_sum(part[u]), kEps);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (u < g) {
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            const int k = lane + j * kWarp;
            if (k < K) {
              src[u * K + k] =
                  has[u] ? pi_value(t[j], e[u][j], part[u], quantize) : 0.f;
            }
          }
        }
      }
      __syncwarp();
      store_span(dst, src, g * K, lane);
      __syncwarp();   // the staging rows are refilled by the next group
      i += g;
    }
  }
}

// Blocks an SM the register budget is set for: 4 (64 registers a thread),
// 3 where KPL >= 5 rows in flight would spill at 64, and 8 for the wide
// body (KPL = 0), which keeps nothing across slots.
__host__ __device__ constexpr int pi_min_blocks(int kpl) {
  return kpl == 0 ? 8 : kpl >= 5 ? 3 : 4;
}

template <int KPL>
__global__ void __launch_bounds__(kPiThreads, pi_min_blocks(KPL))
    token_pi_kernel(const int32_t* __restrict__ ids,
                    const float* __restrict__ cnts,
                    const float* __restrict__ eb,
                    const float* __restrict__ et, float* __restrict__ pi,
                    int64_t slots, int L, int K, int quantize) {
  if constexpr (KPL == 0) {
    pi_slot(ids, cnts, nullptr, eb, et, pi, slots, L, K, quantize);
  } else {
    pi_runs<KPL>(ids, cnts, nullptr, eb, et, pi, slots, L, K, quantize);
  }
}

template <int KPL>
__global__ void __launch_bounds__(kPiThreads, pi_min_blocks(KPL))
    csr_token_pi_kernel(const int32_t* __restrict__ ids,
                        const float* __restrict__ cnts,
                        const int32_t* __restrict__ segs,
                        const float* __restrict__ eb,
                        const float* __restrict__ et, float* __restrict__ pi,
                        int64_t slots, int K, int quantize) {
  if constexpr (KPL == 0) {
    pi_slot(ids, cnts, segs, eb, et, pi, slots, 1, K, quantize);
  } else {
    pi_runs<KPL>(ids, cnts, segs, eb, et, pi, slots, 1, K, quantize);
  }
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
// row at a time keeps the body within 64 registers (4 blocks an SM), where
// the KPL = 4 instance spills 4 bytes (stores and loads) and no other
// spills (chip_smoke.py's build phase gates both). A segment of more than
// kLongSegment rows (a frequent word in many documents: up to B rows of a
// padded batch) is left out of the stream and summed by the whole block
// afterwards: cut into kScatterWarps contiguous parts of ceil(n / 8)
// rows, one a warp, the parts added in warp order in shared memory. The
// cut depends on the length alone, so every launch gives the same bits,
// with no fp32 atomics: resume bit-equality and the memo invariant need a
// fixed summation order.
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
// K6 and K7: the dense per-sweep E-step (the pre-fusion baseline), on the
// tensor cores.
//
// Replace _sweep_kernel (repro/kernels/lda_estep.py:817) and
// _sstats_kernel (:870). Both read the dense counts C (B, V) and form
//   R = C / (E[theta] . Eφ^T + 1e-30)
//   K6: gamma' = alpha0 + E[theta] * (R . Eφ)     one fixed-point sweep
//   K7: S = Eφ * (R^T . E[theta])                  expected topic-word counts
//
// Up to 128 topics one launch computes the whole function, which has flash
// attention's shape (dense_tc_kernel). K6: one block owns 128 rows of B
// (two consumer warpgroups of 64), whose E[theta] parts stay resident in
// shared memory, and walks a contiguous range of V tiles of 64 columns;
// for each tile it computes
//   S = E[theta] . Eφ_tile^T    wgmma, both operands in shared memory
//   R = C_tile / (S + 1e-30)    in registers, C loaded in S's layout
//   acc += R . Eφ_tile          wgmma, R as the register operand, Eφ
//                               MN-major in shared memory
// K7 is the same body with the roles of the two operands swapped (kT):
// a block owns 128 rows of V, whose Eφ parts stay resident, and walks
// every B tile of 64 rows in order:
//   S^T = Eφ . E[theta]_tile^T,  R^T = C^T / (S^T + 1e-30),
//   acc += R^T . E[theta]_tile
// with C read in S^T's layout: each load instruction reads 8 consecutive
// v of 4 rows of C, four 32-byte sectors used whole. The (B, V) arrays S
// and R never reach device memory.
//
// Above 128 topics the accumulator and the resident parts no longer fit
// (786 KB of parts at K = 1,000), and the output's topics are tiled over
// the grid in chunks of 128. Forming the denominator in every chunk's
// block would repeat the first product K / 128 times, so R goes through
// device memory once instead:
//   et_image_kernel   E[theta]'s three parts, once a call, as the
//                     shared-memory tiles the R pass copies
//   r_pass_kernel     R (B, V) in fp32 over every topic, in chunks of 64
//   dense_tc_kernel   with kR: acc += R . Eφ (K6) or R^T . E[theta] (K7)
//                     over one 128-topic chunk a block, R loaded and split
//                     in place of C, no first product
// The round trip costs writing and reading R once (2 * 4 * B * V bytes);
// the product blocks of one row tile run side by side and share R's
// reads in L2.
//
// Precision: bf16 x 3. Every fp32 operand x is split on the fly into
// x = hi + mid + lo (hi = bf16(x), mid = bf16(x - hi), lo = bf16(x - hi -
// mid): 24 bits of x), and each product sums the six part products down to
// 2^-16 of the leading term (hi.hi, hi.mid, mid.hi, hi.lo, mid.mid,
// lo.hi; the smallest first) in fp32 accumulators. The dropped terms are
// below 2^-23 relative, so both functions stay within the fp32 twins' 2e-5
// bars (about 1e-6 relative; tests/test_torch_legacy.py emulates the split
// in torch, both passes above 128 topics included). TF32 could serve as
// well (3 x TF32 costs the same), but wgmma takes TF32 operands K-major
// only, and the second product reduces over the streamed rows, so a
// row-major tile would need a transposed copy; bf16's B operand may be
// MN-major, and its register A operand has the accumulator's layout, so
// R goes from S's registers into the second product without shared
// memory. A single bf16 or TF32 pass (8 or 11 bits) misses the 2e-5 bars.
//
// The pipeline, per tile: the next tile's fp32 rows of the streamed
// operand are copied by cp.async into a staging tile and its counts loaded
// into registers while this tile's products run; the block converts the
// staged rows into the next stage's three 128-byte-swizzled bf16 part
// tiles (two stages) while the second product runs, and retires that
// product before the next tile touches S's registers (a wgmma group in
// flight across them would serialize every product). A zero count takes
// R = +0 without a division: C is almost all zeros, and a zero dividend
// sends the IEEE division to its slow path.
//
// Not K9's producer/consumer pipeline (a producer warp keeping TMA loads
// of the streamed operand and C in flight in an mbarrier ring); that
// design was not built or timed here, for three reasons of layout. The
// wgmma operands are bf16 parts that a TMA copy cannot make, so every
// streamed tile passes through the consumers' threads anyway, and TMA
// would only replace the cp.async of the raw fp32 tile, which already
// overlaps the products. C is read into S's accumulator registers, where
// R is formed and fed to the second product; a TMA tile of C would cost
// 32 KB of shared memory a stage (the block uses 225 KB of the SM's 227)
// and a second read of each count. And the consumers take up to 234
// registers a thread (59,904 of the SM's 65,536), so a producer warpgroup
// would have to take registers from them. The cost: the two warpgroups run in
// step, and the tensor cores idle while R and the parts are made.
//
// The epilogues. K6 splits V over blocks to fill the card (B = 1,024 has
// 8 row tiles): each block writes its (128, 128) partial sum to `part`,
// and the last block of a row tile (and topic chunk) to finish (an integer
// ticket) sums the partials in split order and writes gamma' = alpha0 +
// E[theta] * acc. A K7 block owns its 128 output rows, sums B in order and
// writes Eφ * acc from its accumulators. Either way two launches give the
// same bits, with no fp32 atomics.
//
// Bound: operations. The function is 4*B*V*K fp32 operations (two
// products of 2*B*V*K); the split does six bf16 products of each,
// 24*B*V*Kp tensor-core operations: 0.453 ms at B = 1,024, V = 142,336,
// K = 128 on the H100's 989 TFLOP/s, against 0.174 ms to read C (583 MB).
// A block (166-234 registers a thread, up to 225 KB of shared memory)
// fills its SM alone. K6's Eφ is read once per row tile (the row tiles of
// a V range run side by side, so mostly from L2); K7's 1,112 blocks at
// the Arxiv vocabulary run in 8.4 waves, each making its resident parts
// before its first tile. Above 128 topics the R pass does half the
// operations and the round trip adds 8*B*V bytes; K7's product blocks
// walk only B / 64 tiles each, so their pipeline fill shows.
// ---------------------------------------------------------------------------
constexpr int kDenseK = 128;   // K6/K7's topics in registers; K8's tile

namespace sweep_tc {

using namespace hopper;

constexpr int kBM = 128;        // resident rows per block: two warpgroups
constexpr int kBV = 64;         // streamed rows per tile
constexpr int kThreads = 256;
constexpr int kStages = 2;      // streamed tiles in shared memory
constexpr int kParts = 3;       // bf16 hi, mid, lo
constexpr int kBlocks = 132;    // blocks aimed for per launch (one an SM)
constexpr int kChunk = 64;      // the R pass's topics a step
// E[theta]'s image: one 128-row tile's parts of one 64-topic chunk
constexpr uint32_t kImage = kParts * kBM * 128;

// The six part products (part of the first operand or R, part of the
// second), smallest first.
__device__ __forceinline__ constexpr int pair_a(int p) {
  return p < 3 ? 2 - p : (p == 3 ? 1 : 0);
}
__device__ __forceinline__ constexpr int pair_b(int p) {
  return p < 3 ? p : (p == 4 ? 1 : 0);
}

// KC: chunks of 64 topics in registers (K <= 64 KC, or with kR one
// 64 KC-topic chunk of the output); kR: R given, no resident operand.
template <int KC, bool kR>
struct Cfg {
  static constexpr int kKp = 64 * KC;
  static constexpr uint32_t kResPart = kR ? 0 : KC * kBM * 128;   // bytes
  static constexpr uint32_t kStrPart = KC * kBV * 128;
  static constexpr uint32_t kStage = kParts * kStrPart;
  static constexpr uint32_t kRaw = kBV * kKp * 4;       // the fp32 tile
  static constexpr int kUnits = kBV * KC * 8 / kThreads;   // units a thread
  static constexpr int kSmem =
      kParts * kResPart + kStages * kStage + kRaw + 1024;
};

// The R pass's shared memory: two stages of E[theta]'s image and an Eφ
// tile's parts (64 rows, 64 topics), and the Eφ tile's fp32 staging.
struct RCfg {
  static constexpr uint32_t kEbPart = kBV * 128;
  static constexpr uint32_t kStage = kImage + kParts * kEbPart;
  static constexpr uint32_t kRaw = kBV * kChunk * 4;
  static constexpr int kUnits = kBV * 8 / kThreads;
  static constexpr int kSmem = kStages * kStage + kRaw + 1024;
};

// cp.async of `bytes` (<= size) from src into shared memory at dst, the
// rest of the size zero-filled (src is not read at 0 bytes)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__device__ __forceinline__ void split3(float x, float y, uint32_t (&w)[3]) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const float x1 = x - hf.x, y1 = y - hf.y;
  const __nv_bfloat162 m = __floats2bfloat162_rn(x1, y1);
  const float2 mf = __bfloat1622float2(m);
  w[0] = bf16x2_bits(h);
  w[1] = bf16x2_bits(m);
  w[2] = bf16x2_bits(__floats2bfloat162_rn(x1 - mf.x, y1 - mf.y));
}

// Columns c0 ... c0 + 7 of row r of an (R, K) fp32 matrix (zeros past R
// and K).
__device__ __forceinline__ void load_unit(const float* __restrict__ src,
                                          int r, int R, int K, int c0,
                                          float (&v)[8]) {
  const float* row = src + static_cast<size_t>(r) * K;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    v[i] = (r < R && c0 + i < K) ? __ldg(row + c0 + i) : 0.f;
  }
}

// The three parts of 8 columns, as 16 bytes each.
__device__ __forceinline__ void split_unit(const float (&v)[8],
                                           uint32_t (&w)[kParts][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t s[3];
    split3(v[2 * i], v[2 * i + 1], s);
#pragma unroll
    for (int q = 0; q < kParts; ++q) w[q][i] = s[q];
  }
}

// The three parts of those 8 columns into row r of the swizzled part tiles
// at base, base + part, base + 2 part (tiles of `rows` rows).
__device__ __forceinline__ void store_unit(uint32_t base, uint32_t part,
                                           int r, int c0, int rows,
                                           const float (&v)[8]) {
  uint32_t w[kParts][4];
  split_unit(v, w);
  const uint32_t off = sw128_offset(r, c0, rows);
#pragma unroll
  for (int q = 0; q < kParts; ++q) {
    asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                     base + q * part + off),
                 "r"(w[q][0]), "r"(w[q][1]), "r"(w[q][2]), "r"(w[q][3])
                 : "memory");
  }
}

// One body for K6 (kT = false) and K7 (kT = true). The resident operand
// `res` (K6: E[theta], B rows; K7: Eφ, V rows) in tiles of 128 rows, the
// streamed operand `str` (K6: Eφ; K7: E[theta]) in tiles of 64 rows, both
// (rows, K) fp32. c: the counts (B, V), or with kR R; row b of either is
// document b's, ldc floats apart. Grid: (resident tiles, splits) without
// kR, (topic chunks, resident tiles, splits) with it (a row tile's chunks
// side by side, sharing its R reads); K7 has one split.
template <int KC, bool kT, bool kR>
__global__ void __launch_bounds__(kThreads, 1)
    dense_tc_kernel(const float* __restrict__ c, int ldc,
                    const float* __restrict__ res,
                    const float* __restrict__ str, float* __restrict__ out,
                    float* __restrict__ part, int* __restrict__ tickets,
                    int B, int V, int K, float alpha0, int tiles_per_split) {
  using Cf = Cfg<KC, kR>;
  constexpr int kUnitsPerRow = 8 * KC;
  extern __shared__ uint8_t smem_raw[];
  __shared__ int is_last;
  // swizzled tiles start on 1024-byte boundaries
  const uint32_t s_res = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_str = s_res + kParts * Cf::kResPart;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int wg = warp / 4;
  const int n_res = kT ? V : B, n_str = kT ? B : V;
  const int kt = kR ? blockIdx.x : 0;            // this block's topic chunk
  const int rt = kR ? blockIdx.y : blockIdx.x;   // its resident tile
  const int sp = kR ? blockIdx.z : blockIdx.y;   // its split
  const int nsplit = kR ? gridDim.z : gridDim.y;
  const int kc = kt * Cf::kKp;
  const int row0 = rt * kBM;
  const int tiles = (n_str + kBV - 1) / kBV;
  const int t_lo = sp * tiles_per_split;
  const int t_hi = min(tiles, t_lo + tiles_per_split);

  if constexpr (!kR) {
    // the resident rows' three parts, once
    for (int u = tid; u < kBM * kUnitsPerRow; u += kThreads) {
      const int r = u / kUnitsPerRow, c0 = 8 * (u % kUnitsPerRow);
      float v[8];
      load_unit(res, row0 + r, n_res, K, c0, v);
      store_unit(s_res, Cf::kResPart, r, c0, kBM, v);
    }
  }
  // tile t's fp32 units (this thread's: 8 topics of a row each, from
  // topic kc) copied asynchronously into the fp32 staging tile (16 bytes
  // at a time where every row is 16-byte aligned), then the same units
  // from there into a stage's three parts: a thread converts only what it
  // copied, so a wait on its own copies suffices
  const uint32_t s_raw = s_str + kStages * Cf::kStage;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(str) % 16 == 0;
  auto load_str = [&](int t) {
#pragma unroll
    for (int i = 0; i < Cf::kUnits; ++i) {
      const int u = tid + kThreads * i;
      const int r = u / kUnitsPerRow, c0 = 8 * (u % kUnitsPerRow);
      const int row = t * kBV + r;
      const float* src =
          str + static_cast<size_t>(min(row, n_str - 1)) * K + kc;
      const uint32_t dst = s_raw + (r * Cf::kKp + c0) * 4;
      if (vec) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = c0 + 4 * h;
          const int n = row < n_str ? max(0, min(4, K - kc - cc)) : 0;
          cp_async16(dst + 16 * h, n > 0 ? src + cc : str, 4 * n);
        }
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const bool in = row < n_str && kc + c0 + q < K;
          cp_async4(dst + 4 * q, in ? src + c0 + q : str, in ? 4 : 0);
        }
      }
    }
  };
  auto store_str = [&](int stage) {
    cp_async_wait_all();
#pragma unroll
    for (int i = 0; i < Cf::kUnits; ++i) {
      const int u = tid + kThreads * i;
      const int r = u / kUnitsPerRow, c0 = 8 * (u % kUnitsPerRow);
      float v[8];
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%8];\n"
                   "ld.shared.v4.f32 {%4, %5, %6, %7}, [%8+16];\n"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]),
                     "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7])
                   : "r"(s_raw + (r * Cf::kKp + c0) * 4)
                   : "memory");
      store_unit(s_str + stage * Cf::kStage, Cf::kStrPart, r, c0, kBV, v);
    }
  };
  if (t_lo < t_hi) {
    load_str(t_lo);
    store_str(0);
  }
  fence_proxy_async();
  __syncthreads();

  // this thread's resident rows of S and acc (r_lo and r_lo + 8) and
  // streamed columns of S (col0 + 8 j + {0, 1})
  const int r_lo = row0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  // tile t's counts (or R) in S's layout (zeros past B and V)
  auto load_c = [&](int t, float (&cv)[kBV / 2]) {
#pragma unroll
    for (int j = 0; j < kBV / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + 8 * (e >> 1);
        const int col = t * kBV + 8 * j + col0 + (e & 1);
        const size_t at = kT ? static_cast<size_t>(col) * ldc + row
                             : static_cast<size_t>(row) * ldc + col;
        cv[4 * j + e] = (t < t_hi && row < n_res && col < n_str)
                            ? __ldg(c + at)
                            : 0.f;
      }
    }
  };
  float acc[Cf::kKp / 2];
#pragma unroll
  for (int i = 0; i < Cf::kKp / 2; ++i) acc[i] = 0.f;
  float cv[kBV / 2];
  load_c(t_lo, cv);

  for (int t = t_lo; t < t_hi; ++t) {
    const int st = (t - t_lo) % kStages;
    const uint32_t s_tile = s_str + st * Cf::kStage;
    // the next tile's counts and rows, in flight a whole tile ahead (C
    // streams from device memory, each count read once)
    float cv_next[kBV / 2];
    load_c(t + 1, cv_next);
    if (t + 1 < t_hi) load_str(t + 1);

    // R's register operand in three parts
    uint32_t ra[kParts][kBV / 16][4];
    if constexpr (kR) {
#pragma unroll
      for (int kk = 0; kk < kBV / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          uint32_t w[3];
          split3(cv[i], cv[i + 1], w);
#pragma unroll
          for (int q = 0; q < kParts; ++q) ra[q][kk][r] = w[q];
        }
      }
    } else {
      // S = res . tile^T: six part products over the topic steps
      float s[kBV / 2];
#pragma unroll
      for (int i = 0; i < kBV / 2; ++i) s[i] = 0.f;
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int p = 0; p < 6; ++p) {
#pragma unroll
        for (int kk = 0; kk < 4 * KC; ++kk) {
          const uint32_t off = (kk % 4) * 32;   // 16 topics of a row
          const uint64_t da = desc_sw128(
              s_res + pair_a(p) * Cf::kResPart + (kk / 4) * kBM * 128 +
                  wg * 64 * 128 + off,
              16, 1024);
          const uint64_t db = desc_sw128(
              s_tile + pair_b(p) * Cf::kStrPart + (kk / 4) * kBV * 128 + off,
              16, 1024);
          wgmma_ss<kBV>(s, da, db, p > 0 || kk > 0);
        }
      }
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      // R = C / (S + 1e-30), split into the register operand's three
      // parts. C is almost all zeros, and a zero dividend takes the
      // division's slow path: its quotient (+0, S + 1e-30 being
      // positive) is set directly.
#pragma unroll
      for (int kk = 0; kk < kBV / 16; ++kk) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 8 * kk + 2 * r;
          const float r0 = cv[i] != 0.f ? cv[i] / (s[i] + kEps) : 0.f;
          const float r1 = cv[i + 1] != 0.f ? cv[i + 1] / (s[i + 1] + kEps)
                                            : 0.f;
          uint32_t w[3];
          split3(r0, r1, w);
#pragma unroll
          for (int q = 0; q < kParts; ++q) ra[q][kk][r] = w[q];
        }
      }
    }
    // acc += R . tile: six part products over the tile's 64 rows
    fence_regs(acc);
#pragma unroll
    for (int q = 0; q < kParts; ++q) fence_regs(ra[q]);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 6; ++p) {
#pragma unroll
      for (int kk = 0; kk < kBV / 16; ++kk) {
        const uint64_t db = desc_sw128(
            s_tile + pair_b(p) * Cf::kStrPart + kk * 16 * 128, kBV * 128,
            1024);
        wgmma_rs<Cf::kKp>(acc, ra[pair_a(p)][kk], db);
      }
    }
    wgmma_commit();
    // the next tile's parts into the other stage (last read by tile t - 1,
    // whose products both warpgroups retired before the barrier that
    // ended it) while the product runs; the product is retired before the
    // next tile touches S's registers (a wgmma group in flight across
    // them would serialize every product)
    if (t + 1 < t_hi) store_str((st + 1) % kStages);
    fence_proxy_async();
    wgmma_wait_all();
    fence_regs(acc);
#pragma unroll
    for (int i = 0; i < kBV / 2; ++i) cv[i] = cv_next[i];
    __syncthreads();
  }

  if constexpr (kT) {
    // K7: the block owns these rows of S = Eφ * acc
#pragma unroll
    for (int j = 0; j < Cf::kKp / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + 8 * (e >> 1);
        const int col = kc + 8 * j + col0 + (e & 1);
        if (row < n_res && col < K) {
          const size_t at = static_cast<size_t>(row) * K + col;
          out[at] = __ldg(res + at) * acc[4 * j + e];
        }
      }
    }
  } else {
    // K6: this block's partial sum, then the row tile's (and topic
    // chunk's) ticket
#pragma unroll
    for (int j = 0; j < Cf::kKp / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + 8 * (e >> 1);
        const int col = kc + 8 * j + col0 + (e & 1);
        if (row < B && col < K) {
          part[(static_cast<size_t>(sp) * B + row) * K + col] =
              acc[4 * j + e];
        }
      }
    }
    __threadfence();
    __syncthreads();
    int* ticket = tickets + (kR ? rt * gridDim.x + kt : rt);
    if (tid == 0) is_last = atomicAdd(ticket, 1) == nsplit - 1;
    __syncthreads();
    if (!is_last) return;
    __threadfence();
    const int kn = min(Cf::kKp, K - kc);
    for (int i = tid; i < kBM * kn; i += kThreads) {
      const int row = row0 + i / kn, col = kc + i % kn;
      if (row >= B) break;
      float sum = 0.f;
      for (int q = 0; q < nsplit; ++q) {
        sum += __ldcg(part + (static_cast<size_t>(q) * B + row) * K + col);
      }
      out[static_cast<size_t>(row) * K + col] =
          alpha0 + __ldg(res + static_cast<size_t>(row) * K + col) * sum;
    }
    if (tid == 0) *ticket = 0;
  }
}

// Above 128 topics: E[theta]'s parts as the R pass's shared-memory tiles.
// Block (x, q) writes image x * nq + q: part p's swizzled (128, 64) tile
// of rows x * 128 ... and topics q * 64 ... at p * 16 KB (zeros past B
// and K).
__global__ void __launch_bounds__(kThreads)
    et_image_kernel(const float* __restrict__ et, uint8_t* __restrict__ img,
                    int B, int K) {
  uint8_t* dst =
      img + (static_cast<size_t>(blockIdx.x) * gridDim.y + blockIdx.y) *
                kImage;
  for (int u = threadIdx.x; u < kBM * 8; u += kThreads) {
    const int r = u / 8, c0 = 8 * (u % 8);
    float v[8];
    load_unit(et, blockIdx.x * kBM + r, B, K, blockIdx.y * kChunk + c0, v);
    uint32_t w[kParts][4];
    split_unit(v, w);
    const uint32_t off = sw128_offset(r, c0, kBM);
#pragma unroll
    for (int q = 0; q < kParts; ++q) {
      *reinterpret_cast<uint4*>(dst + q * kBM * 128 + off) =
          make_uint4(w[q][0], w[q][1], w[q][2], w[q][3]);
    }
  }
}

// Above 128 topics, the first pass: R = C / (E[theta] . Eφ^T + 1e-30)
// into r (ldr floats a row; every row of every 128-row tile and every
// column of every 64-column tile written, zeros past B and V). Block
// (x, y) owns rows x * 128 ... (two warpgroups of 64) and the y-th range
// of V tiles. For each tile it sums S over the topics in chunks of 64,
// each chunk's six part products smallest first: a step copies the
// chunk's E[theta] image (48 KB, made once a call) and stages the Eφ
// tile's chunk in fp32, both by cp.async a step ahead, and cuts the Eφ
// rows into parts while the step's products run, as the streamed operand
// of dense_tc_kernel. After the tile's last chunk, R is formed in S's
// registers (+0 without a division where C is 0, C loaded at the tile's
// first chunk) and stored.
__global__ void __launch_bounds__(kThreads, 1)
    r_pass_kernel(const float* __restrict__ c,
                  const uint8_t* __restrict__ img,
                  const float* __restrict__ eb, float* __restrict__ r,
                  int B, int V, int K, int ldr, int tiles_per_split) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_raw = base + kStages * RCfg::kStage;
  const int tid = threadIdx.x, warp = tid / kWarp, lane = tid % kWarp;
  const int wg = warp / 4;
  const int row0 = blockIdx.x * kBM;
  const int nq = (K + kChunk - 1) / kChunk;
  const int vtiles = (V + kBV - 1) / kBV;
  const int t_lo = blockIdx.y * tiles_per_split;
  const int t_hi = min(vtiles, t_lo + tiles_per_split);
  const int steps = max(0, t_hi - t_lo) * nq;
  const uint8_t* my_img = img + static_cast<size_t>(blockIdx.x) * nq * kImage;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(eb) % 16 == 0;
  // step s: V tile t_lo + s / nq, topic chunk s % nq
  auto load = [&](int s) {
    const int t = t_lo + s / nq, q = s % nq;
    const uint32_t stage = base + (s % kStages) * RCfg::kStage;
    const uint8_t* src = my_img + static_cast<size_t>(q) * kImage;
    for (int i = tid; i < static_cast<int>(kImage / 16); i += kThreads) {
      cp_async16(stage + 16 * i, src + 16 * i, 16);
    }
#pragma unroll
    for (int i = 0; i < RCfg::kUnits; ++i) {
      const int u = tid + kThreads * i;
      const int rr = u / 8, c0 = 8 * (u % 8), cq = q * kChunk + c0;
      const int row = t * kBV + rr;
      const float* srow = eb + static_cast<size_t>(min(row, V - 1)) * K;
      const uint32_t dst = s_raw + (rr * kChunk + c0) * 4;
      if (vec) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int cc = cq + 4 * h;
          const int n = row < V ? max(0, min(4, K - cc)) : 0;
          cp_async16(dst + 16 * h, n > 0 ? srow + cc : eb, 4 * n);
        }
      } else {
#pragma unroll
        for (int h = 0; h < 8; ++h) {
          const bool in = row < V && cq + h < K;
          cp_async4(dst + 4 * h, in ? srow + cq + h : eb, in ? 4 : 0);
        }
      }
    }
  };
  auto convert = [&](int s) {
    cp_async_wait_all();
    const uint32_t parts = base + (s % kStages) * RCfg::kStage + kImage;
#pragma unroll
    for (int i = 0; i < RCfg::kUnits; ++i) {
      const int u = tid + kThreads * i;
      const int rr = u / 8, c0 = 8 * (u % 8);
      float v[8];
      asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%8];\n"
                   "ld.shared.v4.f32 {%4, %5, %6, %7}, [%8+16];\n"
                   : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]),
                     "=f"(v[4]), "=f"(v[5]), "=f"(v[6]), "=f"(v[7])
                   : "r"(s_raw + (rr * kChunk + c0) * 4)
                   : "memory");
      store_unit(parts, RCfg::kEbPart, rr, c0, kBV, v);
    }
  };
  if (steps > 0) {
    load(0);
    convert(0);
  }
  fence_proxy_async();
  __syncthreads();

  const int r_lo = row0 + wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  float s[kBV / 2], cv[kBV / 2];
#pragma unroll
  for (int i = 0; i < kBV / 2; ++i) s[i] = cv[i] = 0.f;
  for (int step = 0; step < steps; ++step) {
    const int t = t_lo + step / nq, q = step % nq;
    const uint32_t stage = base + (step % kStages) * RCfg::kStage;
    if (step + 1 < steps) load(step + 1);
    if (q == 0) {   // the tile's counts, used after its last chunk
#pragma unroll
      for (int j = 0; j < kBV / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = r_lo + 8 * (e >> 1);
          const int col = t * kBV + 8 * j + col0 + (e & 1);
          cv[4 * j + e] =
              (row < B && col < V)
                  ? __ldg(c + static_cast<size_t>(row) * V + col)
                  : 0.f;
        }
      }
    }
    // S (+)= E[theta]_chunk . Eφ_chunk^T: six part products, 4 steps each
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int p = 0; p < 6; ++p) {
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t da = desc_sw128(
            stage + pair_a(p) * kBM * 128 + wg * 64 * 128 + kk * 32, 16,
            1024);
        const uint64_t db = desc_sw128(
            stage + kImage + pair_b(p) * RCfg::kEbPart + kk * 32, 16, 1024);
        wgmma_ss<kBV>(s, da, db, q > 0 || p > 0 || kk > 0);
      }
    }
    wgmma_commit();
    // the next step's Eφ parts into the other stage while the products run
    if (step + 1 < steps) convert(step + 1);
    fence_proxy_async();
    wgmma_wait_all();
    fence_regs(s);
    if (q == nq - 1) {
#pragma unroll
      for (int j = 0; j < kBV / 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int i = 4 * j + 2 * h;
          float2 x;
          x.x = cv[i] != 0.f ? cv[i] / (s[i] + kEps) : 0.f;
          x.y = cv[i + 1] != 0.f ? cv[i + 1] / (s[i + 1] + kEps) : 0.f;
          *reinterpret_cast<float2*>(
              r + static_cast<size_t>(r_lo + 8 * h) * ldr + t * kBV + 8 * j +
              col0) = x;
        }
      }
    }
    __syncthreads();
  }
}

}  // namespace sweep_tc

// ---------------------------------------------------------------------------
// K8: the one-hot memo delta (the retired scatter, kept as a baseline), as
// one segment pass.
//
// Replaces _memo_delta_onehot_kernel (repro/kernels/lda_estep.py:677):
// pi of every token slot from its gathered Eφ row, and S_new[v] = sum cnt *
// pi, S_old[v] = sum cnt * old_pi over the slots whose id is v, summed in
// the baseline's order: S[v] = ((0 + P_0) + P_1) + ... over the B tiles of
// block_b documents (tile_slots = block_b * L slots), P_i the sum over tile
// i's slots in token order, each term cnt * pi rounded before it is added
// (the baseline's FMUL then FADD). The TPU kept one (nb, Vp, K) partial a B
// tile because Pallas may not revisit an output block out of order; here
// the partials never exist. The preparation is K3's: one stable sort of
// the slots by id (count 0 keyed V), a sorted search for each id's range.
// Each warp owns kOnehotIds consecutive ids, whose slots are one
// contiguous run of the sorted order, and walks the run as one stream in
// sorted (token) order, storing an id's sums when the stream passes its
// last slot (zeros for an id with none): for every slot it forms pi with
// K2's steps (onehot_pi: the same dot, butterfly and division, so pi has
// K2's bits), writes it once and adds cnt * pi to a sub-sum that is added
// to the id's total whenever the walk enters another B tile (the tile
// index never decreases in token order), which is the baseline's sum
// with its zero partials left out (adding +0 changes no bit). Walking
// each id on its own instead would pay the chain of dependent loads
// (offsets -> order -> count -> row) once an id. A segment of more than
// kOnehotLong slots (a frequent word) is summed by the whole block, 8 B
// tiles a round: warp w finds tile t0 + w's slots by a 32-way search and
// sums them in token order, and the 8 sums are added to the total in tile
// order. Slots outside every segment (count 0, or an id outside [0, V))
// get their pi row in a grid-strided pass of the same launch: zeros where
// the count is not > 0, else pi, scattered nowhere. Above 128 topics
// gridDim.y covers tiles of 128 topics, each block forming every slot's
// whole dot over all K topics and writing its own columns.
//
// Bound: bytes. The function reads each slot's Eφ row and old pi and
// writes its pi ((B, L, K) each) and the two (V, K) sums once; the
// preparation adds the sort of B*L keys. The walk is bound by the latency
// of dependent loads, as K3's: the order entries and counts of 32 slots
// come in one load a lane, their rows are prefetched into L2, and two
// slots' rows are loaded before either is summed (124 registers a thread
// at K <= 128, two blocks an SM).
// ---------------------------------------------------------------------------
constexpr int kOnehotThreads = 256;
constexpr int kOnehotWarps = kOnehotThreads / kWarp;
constexpr int kOnehotIds = 8;           // consecutive ids a warp owns
constexpr int64_t kOnehotLong = 32;     // longer segments: the whole block

struct OnehotArgs {
  const int64_t* order;     // N slots, sorted by id (count 0 keyed V)
  const int64_t* seg_off;   // V + 1: id v's slots order[seg_off[v] ...]
  const float* cnts;        // N
  const float* eb_tok;      // N x K: each slot's Eφ row
  const float* old_pi;      // N x K, or nullptr
  const float* et;          // B x K
  float* pi;                // N x K
  float* s_new;             // V x K
  float* s_old;             // V x K, or nullptr
  int64_t N;
  int64_t tile_slots;       // block_b * L
  int V, L, K, quantize;
};

// Slot g's inputs over this block's columns kc + lane + 32 j < kc + kn,
// loaded together: its Eφ row, its document's E[theta] row and, with
// `old`, its old pi (zeros past the columns).
template <int KPL>
__device__ __forceinline__ void onehot_load(const OnehotArgs& a, int64_t g,
                                            int kc, int kn, int lane,
                                            bool old, float (&e)[KPL],
                                            float (&t)[KPL],
                                            float (&o)[KPL]) {
  const int K = a.K;
  const float* t_row =
      a.et + static_cast<size_t>(static_cast<uint32_t>(g) /
                                 static_cast<uint32_t>(a.L)) * K;
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = kc + lane + j * kWarp;
    const bool in = k < kc + kn;
    e[j] = in ? __ldg(a.eb_tok + g * K + k) : 0.f;
    t[j] = in ? __ldg(t_row + k) : 0.f;
    o[j] = in && old ? __ldg(a.old_pi + g * K + k) : 0.f;
  }
}

// Slot g's pi row over this block's columns, written and kept in pi:
// zeros where the count is not > 0, else K2's steps (token_pi_row's dot
// over all K topics, the butterfly, then the division).
template <int KPL, bool kTiled>
__device__ __forceinline__ void onehot_pi(const OnehotArgs& a, int64_t g,
                                          float c, int kc, int kn, int lane,
                                          const float (&e)[KPL],
                                          const float (&t)[KPL],
                                          float (&pi)[KPL]) {
#pragma unroll
  for (int j = 0; j < KPL; ++j) pi[j] = 0.f;
  if (c > 0.f) {
    float part = 0.f;
    if (kTiled) {   // the dot over every topic, not only this block's
      const int K = a.K;
      const float* t_row =
          a.et + static_cast<size_t>(static_cast<uint32_t>(g) /
                                     static_cast<uint32_t>(a.L)) * K;
      for (int k = lane; k < K; k += kWarp) {
        part = pi_dot_step(t_row[k], __ldg(a.eb_tok + g * K + k), part);
      }
    } else {
#pragma unroll
      for (int j = 0; j < KPL; ++j) {
        if (lane + j * kWarp < kn) part = pi_dot_step(t[j], e[j], part);
      }
    }
    const float p = __fadd_rn(warp_sum(part), kEps);
#pragma unroll
    for (int j = 0; j < KPL; ++j) {
      if (kc + lane + j * kWarp < kc + kn) {
        pi[j] = pi_value(t[j], e[j], p, a.quantize);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = kc + lane + j * kWarp;
    if (k < kc + kn) a.pi[g * a.K + k] = pi[j];
  }
}

template <int KPL>
__device__ __forceinline__ void add_into(float (&tot)[KPL],
                                         float (&sub)[KPL]) {
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    tot[j] = __fadd_rn(tot[j], sub[j]);
    sub[j] = 0.f;
  }
}

// Slot g (count c, inputs e, t, o) into the sums: its pi written, and cnt
// * pi, cnt * old pi added to the sub-sums (the baseline's rounding: the
// product, then the sum), which are first added to the totals when g lies
// past tile_end (one past the current B tile's last slot).
template <int KPL, bool kTiled>
__device__ __forceinline__ void onehot_add(
    const OnehotArgs& a, int64_t g, float c, int kc, int kn, int lane,
    const float (&e)[KPL], const float (&t)[KPL], const float (&o)[KPL],
    float (&tot_n)[KPL], float (&tot_o)[KPL], float (&sub_n)[KPL],
    float (&sub_o)[KPL], int64_t& tile_end) {
  if (g >= tile_end) {
    add_into<KPL>(tot_n, sub_n);
    add_into<KPL>(tot_o, sub_o);
    tile_end = (static_cast<uint32_t>(g) /
                    static_cast<uint32_t>(a.tile_slots) + 1) *
               a.tile_slots;
  }
  float pi[KPL];
  onehot_pi<KPL, kTiled>(a, g, c, kc, kn, lane, e, t, pi);
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    sub_n[j] = __fadd_rn(sub_n[j], __fmul_rn(c, pi[j]));
    sub_o[j] = __fadd_rn(sub_o[j], __fmul_rn(c, o[j]));
  }
}

// Sorted positions [lo, hi) in token order into the sums, two slots'
// loads in flight at a time; before(i) runs before position i is added
// (the stream of a warp's ids closes the ids that end there). Each warp's
// walk is a chain of dependent loads (order -> row -> pi), so the order
// entries and counts of 32 slots come in one load each, and their rows
// are prefetched into L2 as they arrive.
template <int KPL, bool kTiled, typename Before>
__device__ __forceinline__ void onehot_walk(
    const OnehotArgs& a, int64_t lo, int64_t hi, int kc, int kn, int lane,
    float (&tot_n)[KPL], float (&tot_o)[KPL], float (&sub_n)[KPL],
    float (&sub_o)[KPL], int64_t& tile_end, Before before) {
  const int K = a.K;
  const bool old = a.old_pi != nullptr;
  for (int64_t i0 = lo; i0 < hi; i0 += kWarp) {
    int64_t my_g = 0;
    float my_c = 0.f;
    if (i0 + lane < hi) {
      my_g = a.order[i0 + lane];
      my_c = a.cnts[my_g];
      prefetch_row(a.eb_tok + my_g * K, K);
      if (old) prefetch_row(a.old_pi + my_g * K + kc, kn);
    }
    const int m = static_cast<int>(min(static_cast<int64_t>(kWarp), hi - i0));
    for (int u = 0; u < m; u += 2) {
      const int u1 = min(u + 1, m - 1);
      const int64_t g0 = __shfl_sync(0xffffffffu, my_g, u);
      const int64_t g1 = __shfl_sync(0xffffffffu, my_g, u1);
      const float c0 = __shfl_sync(0xffffffffu, my_c, u);
      const float c1 = __shfl_sync(0xffffffffu, my_c, u1);
      float e0[KPL], t0[KPL], o0[KPL], e1[KPL], t1[KPL], o1[KPL];
      onehot_load<KPL>(a, g0, kc, kn, lane, old, e0, t0, o0);
      onehot_load<KPL>(a, g1, kc, kn, lane, old, e1, t1, o1);
      before(i0 + u);
      onehot_add<KPL, kTiled>(a, g0, c0, kc, kn, lane, e0, t0, o0, tot_n,
                              tot_o, sub_n, sub_o, tile_end);
      if (u1 > u) {
        before(i0 + u1);
        onehot_add<KPL, kTiled>(a, g1, c1, kc, kn, lane, e1, t1, o1, tot_n,
                                tot_o, sub_n, sub_o, tile_end);
      }
    }
  }
}

// The first sorted position in [lo, hi) whose slot is >= gmin (hi if
// none): slots ascend within a segment, so each step probes 32 evenly
// spaced positions, one a lane.
__device__ __forceinline__ int64_t first_slot_at_least(
    const int64_t* __restrict__ order, int64_t lo, int64_t hi, int64_t gmin,
    int lane) {
  while (hi - lo > kWarp) {
    const int64_t step = (hi - lo + kWarp - 1) / kWarp;
    const int64_t probe = lo + (lane + 1) * step - 1;
    const unsigned m =
        __ballot_sync(0xffffffffu, probe >= hi || order[probe] >= gmin);
    if (m == 0) return hi;
    const int64_t nlo = lo + (__ffs(m) - 1) * step;
    hi = min(hi, nlo + step);
    lo = nlo;
  }
  const unsigned m = __ballot_sync(0xffffffffu,
                                   lo + lane >= hi || order[lo + lane] >= gmin);
  return m ? lo + __ffs(m) - 1 : hi;
}

template <int KPL>
__device__ __forceinline__ void store_sums(float* out, const float (&v)[KPL],
                                           int kc, int kn, int lane) {
#pragma unroll
  for (int j = 0; j < KPL; ++j) {
    const int k = kc + lane + j * kWarp;
    if (k < kc + kn) out[k] = v[j];
  }
}

template <int KPL, bool kTiled>
__global__ void __launch_bounds__(kOnehotThreads, 2)
    onehot_kernel(const OnehotArgs a) {
  constexpr int KP = KPL * kWarp;
  __shared__ float part[2][kOnehotWarps][KP];   // long segments: new, old
  __shared__ int64_t cut[kOnehotWarps + 1];
  __shared__ unsigned long_ids[kOnehotWarps];   // per warp, bit t: id t
  const int lane = threadIdx.x & (kWarp - 1);
  const int warp = threadIdx.x / kWarp;
  const int K = a.K;
  // this block's topics [kc, kc + kn); all K (<= 128) when not tiled
  const int kc = kTiled ? blockIdx.y * kDenseK : 0;
  const int kn = kTiled ? min(kDenseK, K - kc) : K;
  float tot_n[KPL], tot_o[KPL], sub_n[KPL], sub_o[KPL];
  auto clear = [&]() {
#pragma unroll
    for (int j = 0; j < KPL; ++j) tot_n[j] = tot_o[j] = sub_n[j] = sub_o[j] = 0.f;
  };

  // 1. slots outside every segment, 32 a warp at a time: their pi rows
  //    only (zeros, without loading the row, where the count is not > 0)
  {
    const int64_t lo_end = a.seg_off[0], hi_start = a.seg_off[a.V];
    const int64_t n_out = lo_end + (a.N - hi_start);
    for (int64_t i0 = (static_cast<int64_t>(blockIdx.x) * kOnehotWarps +
                       warp) * kWarp;
         i0 < n_out;
         i0 += static_cast<int64_t>(gridDim.x) * kOnehotWarps * kWarp) {
      const int64_t i = i0 + lane;
      int64_t my_g = 0;
      float my_c = 0.f;
      if (i < n_out) {
        my_g = a.order[i < lo_end ? i : hi_start + (i - lo_end)];
        my_c = a.cnts[my_g];
      }
      const int m = static_cast<int>(
          min(static_cast<int64_t>(kWarp), n_out - i0));
      for (int u = 0; u < m; ++u) {
        const int64_t g = __shfl_sync(0xffffffffu, my_g, u);
        const float c = __shfl_sync(0xffffffffu, my_c, u);
        float e[KPL], t[KPL], o[KPL], pi[KPL];
        if (c > 0.f) onehot_load<KPL>(a, g, kc, kn, lane, false, e, t, o);
        onehot_pi<KPL, kTiled>(a, g, c, kc, kn, lane, e, t, pi);
      }
    }
  }

  // 2. the warp's ids, segments of at most kOnehotLong slots: their
  //    positions are one contiguous run of the order, walked as one
  //    stream (long segments left out), each id's sums stored when the
  //    stream passes its last position (zeros for an empty id)
  const int64_t block_v =
      static_cast<int64_t>(blockIdx.x) * kOnehotWarps * kOnehotIds;
  const int64_t v0 = block_v + warp * kOnehotIds;
  const int nvalid = static_cast<int>(max(
      static_cast<int64_t>(0),
      min(static_cast<int64_t>(kOnehotIds), a.V - v0)));
  int64_t lo = 0, hi = 0;   // lane t < nvalid: id v0 + t's positions
  if (lane < nvalid) {
    lo = a.seg_off[v0 + lane];
    hi = a.seg_off[v0 + lane + 1];
  }
  const unsigned longs_all =
      __ballot_sync(0xffffffffu, lane < nvalid && hi - lo > kOnehotLong);
  if (lane == 0) long_ids[warp] = longs_all;
  clear();
  int t = 0;                                        // the id being summed
  int64_t t_hi = __shfl_sync(0xffffffffu, hi, 0);   // one past its last
  int64_t tile_end = -1;
  // store id t's sums and move on to id t + 1
  auto flush = [&]() {
    add_into<KPL>(tot_n, sub_n);
    add_into<KPL>(tot_o, sub_o);
    store_sums<KPL>(a.s_new + (v0 + t) * K, tot_n, kc, kn, lane);
    if (a.s_old != nullptr) {
      store_sums<KPL>(a.s_old + (v0 + t) * K, tot_o, kc, kn, lane);
    }
    clear();
    tile_end = -1;
    ++t;
    t_hi = __shfl_sync(0xffffffffu, hi, t & (kWarp - 1));
  };
  // the warp's run up to the next long segment, then on past it
  int64_t pos = __shfl_sync(0xffffffffu, lo, 0);
  unsigned longs = longs_all;
  while (true) {
    const int next = longs ? __ffs(longs) - 1 : nvalid;
    const int64_t stop =
        next < nvalid ? __shfl_sync(0xffffffffu, lo, next)
                      : __shfl_sync(0xffffffffu, hi, max(nvalid - 1, 0));
    onehot_walk<KPL, kTiled>(a, pos, stop, kc, kn, lane, tot_n, tot_o, sub_n,
                             sub_o, tile_end, [&](int64_t i) {
                               while (t_hi <= i) flush();
                             });
    if (next >= nvalid) break;
    while (t < next) flush();
    // id `next` is long: the block sums and stores it below
    t = next + 1;
    t_hi = __shfl_sync(0xffffffffu, hi, t & (kWarp - 1));
    pos = __shfl_sync(0xffffffffu, hi, next);
    longs &= longs - 1;
  }
  while (t < nvalid) flush();

  // 3. the block's long segments, 8 B tiles a round over its warps
  __syncthreads();
  for (int w = 0; w < kOnehotWarps; ++w) {
    for (unsigned m = long_ids[w]; m != 0; m &= m - 1) {   // block-uniform
      const int64_t v = block_v + w * kOnehotIds + (__ffs(m) - 1);
      const int64_t start = a.seg_off[v], end = a.seg_off[v + 1];
      clear();
      int64_t next = start;
      while (next < end) {
        // the round's first tile: the next slot's
        const int64_t t0 = static_cast<uint32_t>(a.order[next]) /
                           static_cast<uint32_t>(a.tile_slots);
        const int64_t from = first_slot_at_least(
            a.order, next, end, (t0 + warp) * a.tile_slots, lane);
        if (lane == 0) cut[warp] = from;
        if (warp == kOnehotWarps - 1) {
          const int64_t to = first_slot_at_least(
              a.order, from, end, (t0 + kOnehotWarps) * a.tile_slots, lane);
          if (lane == 0) cut[kOnehotWarps] = to;
        }
        __syncthreads();
        float pn[KPL], po[KPL], none[KPL];
#pragma unroll
        for (int j = 0; j < KPL; ++j) pn[j] = po[j] = none[j] = 0.f;
        int64_t tile_end = (t0 + warp + 1) * a.tile_slots;   // one tile
        onehot_walk<KPL, kTiled>(a, cut[warp], cut[warp + 1], kc, kn, lane,
                                 none, none, pn, po, tile_end,
                                 [](int64_t) {});
#pragma unroll
        for (int j = 0; j < KPL; ++j) {
          part[0][warp][lane + j * kWarp] = pn[j];
          part[1][warp][lane + j * kWarp] = po[j];
        }
        __syncthreads();
        // warp 0 adds the round's S_new sums to its tot_n, warp 1 the S_old
        // sums to its own tot_n
        if (warp < 2) {
#pragma unroll
          for (int j = 0; j < KPL; ++j) {
            for (int q = 0; q < kOnehotWarps; ++q) {
              tot_n[j] = __fadd_rn(tot_n[j], part[warp][q][lane + j * kWarp]);
            }
          }
        }
        next = cut[kOnehotWarps];
        __syncthreads();   // `part` and `cut` are refilled next round
      }
      if (warp == 0) store_sums<KPL>(a.s_new + v * K, tot_n, kc, kn, lane);
      if (warp == 1 && a.s_old != nullptr) {
        store_sums<KPL>(a.s_old + v * K, tot_n, kc, kn, lane);
      }
    }
  }
}

// K1's dynamic shared memory for K topics: the warps' partial vectors
// (KPL * 32 floats each; for K > kNarrowK, the wide kernel's accumulator
// and E[theta], K floats each), the stop test's chunk sums and the tiles'
// stop counts.
size_t fp_smem_bytes(int K, int B, int block_b, int group) {
  const size_t nb = FpTiles(group, block_b).count(B);
  const size_t per_warp = K <= kNarrowK
                              ? static_cast<size_t>((K + kWarp - 1) / kWarp) * kWarp
                              : 2 * static_cast<size_t>(K);
  return static_cast<size_t>(kFpWarps) * per_warp * sizeof(float) +
         nb * fp_chunks_per_tile(block_b) * sizeof(float) +
         nb * sizeof(int);
}

// The co-resident capacity of a kernel (blocks per SM times SMs) for a
// block of `threads` and a dynamic shared size, cached per kernel, device,
// size and block: the attribute call and the occupancy query run once for
// each, not on every launch. A kernel's shared-memory limit only ever rises
// (to the largest size seen), so a cached smaller size still launches after
// a larger one. `cooperative`: refuse a card without cooperative launches
// (the fixed point's grid syncs).
cudaError_t resident_blocks(const void* kernel, int threads, size_t smem,
                            bool cooperative, int* capacity) {
  static std::mutex mu;
  static std::map<std::tuple<const void*, int, size_t, int>, int> cache;
  // the attribute as set, per kernel and device
  static std::map<std::pair<const void*, int>, size_t> limit;
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  const auto hit = cache.find({kernel, dev, smem, threads});
  if (hit != cache.end()) {
    *capacity = hit->second;
    return cudaSuccess;
  }
  if (cooperative) {
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
  }
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
                                                      threads, smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
  *capacity = cache[{kernel, dev, smem, threads}] = per_sm * sms;
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
cudaError_t fp_grid(int B, int L, int K, int block_b, int group,
                    int* blocks) {
  if (K < 1 || group < 1 || B % group != 0) return cudaErrorInvalidValue;
  int capacity = 0;
  const cudaError_t err =
      resident_blocks(fp_kernel(K), kFpThreads,
                      fp_smem_bytes(K, B, block_b, group), true, &capacity);
  if (err != cudaSuccess) return err;
  const int dpb = kFpWarps / fp_warps_per_doc(L);
  *blocks = std::max(1, std::min((B + dpb - 1) / dpb, capacity));
  return cudaSuccess;
}

// K1 (offsets == nullptr) or K4 (L = ceil(T / B), block_b = group = B),
// on the kernel for a.K topics.
cudaError_t dispatch_fixed_point(FpArgs a, cudaStream_t stream) {
  a.W = fp_warps_per_doc(a.L);
  int blocks = 0;
  const cudaError_t err =
      fp_grid(a.B, a.L, a.K, a.block_b, a.group, &blocks);
  if (err != cudaSuccess) return err;
  void* args[] = {&a.ids,    &a.cnts,   &a.cnts32,     &a.offsets,
                  &a.order,  &a.eb,     &a.eb32,       &a.gamma0,
                  &a.gamma,  &a.et_out, &a.delta,      &a.iters,
                  &a.pi,     &a.T,      &a.B,          &a.L,
                  &a.K,      &a.alpha0, &a.tol,        &a.max_sweeps,
                  &a.block_b, &a.group, &a.W,    &a.quantize};
  return cudaLaunchCooperativeKernel(
      fp_kernel(a.K), dim3(blocks), dim3(kFpThreads), args,
      fp_smem_bytes(a.K, a.B, a.block_b, a.group), stream);
}

// K6/K7's topic chunks for K topics: one up to 128 topics (the single-pass
// body), else chunks of 128 over the product pass's grid.
int dense_chunks(int K) {
  return K <= kDenseK ? 1 : (K + kDenseK - 1) / kDenseK;
}

// K6's V tiles per split for B rows, V columns and K topics: about one
// block an SM in all (row tiles x topic chunks x splits), rounded down so
// the one-block-an-SM launch stays within one wave, and at most one split
// per V tile. A function of the shape only, so the partial sums, and with
// them gamma's bits, do not depend on the card. The R pass splits its V
// tiles as one chunk's would be.
int sweep_tiles_per_split(int B, int V, int K) {
  const int row_tiles = std::max(1, (B + sweep_tc::kBM - 1) / sweep_tc::kBM);
  const int vtiles = (V + sweep_tc::kBV - 1) / sweep_tc::kBV;
  const int aim = sweep_tc::kBlocks / (row_tiles * dense_chunks(K));
  const int want = std::max(1, std::min(aim, vtiles));
  return std::max(1, (vtiles + want - 1) / want);
}

// K6's splits: the V tiles cut into runs of sweep_tiles_per_split, none
// empty (at least one split, so a V of 0 still writes gamma' = alpha0).
int sweep_splits(int B, int V, int K) {
  const int vtiles = (V + sweep_tc::kBV - 1) / sweep_tc::kBV;
  const int per = sweep_tiles_per_split(B, V, K);
  return std::max(1, (vtiles + per - 1) / per);
}

// K6/K7's scratch above 128 topics (none at K <= 128): R, rows B rounded
// up to 128 and ldr = V rounded up to 64 floats apart, then E[theta]'s
// images (one a 128-row tile and 64-topic chunk) from byte img_off.
struct DenseScratch {
  int64_t ldr, img_off, bytes;
};

DenseScratch dense_scratch(int B, int V, int K) {
  if (K <= kDenseK || B < 1) return {0, 0, 0};
  const int64_t tiles = (B + sweep_tc::kBM - 1) / sweep_tc::kBM;
  const int64_t ldr = (static_cast<int64_t>(V) + sweep_tc::kBV - 1) /
                      sweep_tc::kBV * sweep_tc::kBV;
  const int64_t r_bytes = tiles * sweep_tc::kBM * ldr * 4;
  const int64_t nq = (K + sweep_tc::kChunk - 1) / sweep_tc::kChunk;
  return {ldr, r_bytes, r_bytes + tiles * nq * sweep_tc::kImage};
}

template <int KPL, bool kTiled>
cudaError_t launch_onehot(const OnehotArgs& a, cudaStream_t stream) {
  constexpr int per_block = kOnehotWarps * kOnehotIds;
  const dim3 grid(std::max(1, (a.V + per_block - 1) / per_block),
                  kTiled ? (a.K + kDenseK - 1) / kDenseK : 1);
  onehot_kernel<KPL, kTiled><<<grid, kOnehotThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <int KC, bool kT, bool kR>
cudaError_t launch_dense_tc(dim3 grid, cudaStream_t stream, const float* c,
                            int ldc, const float* res, const float* str,
                            float* out, float* part, int* tickets, int B,
                            int V, int K, float alpha0, int tiles_per_split) {
  constexpr int smem = sweep_tc::Cfg<KC, kR>::kSmem;
  const cudaError_t err = cudaFuncSetAttribute(
      sweep_tc::dense_tc_kernel<KC, kT, kR>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  sweep_tc::dense_tc_kernel<KC, kT, kR>
      <<<grid, sweep_tc::kThreads, smem, stream>>>(
          c, ldc, res, str, out, part, tickets, B, V, K, alpha0,
          tiles_per_split);
  return cudaGetLastError();
}

// Above 128 topics, the first pass into the scratch: E[theta]'s images,
// then R (nothing to do at B = 0; the images only at V = 0).
cudaError_t launch_r_pass(cudaStream_t stream, const float* c,
                          const float* et, const float* eb, void* scratch,
                          int B, int V, int K) {
  const DenseScratch d = dense_scratch(B, V, K);
  const int tiles = (B + sweep_tc::kBM - 1) / sweep_tc::kBM;
  if (tiles == 0) return cudaSuccess;
  uint8_t* img = static_cast<uint8_t*>(scratch) + d.img_off;
  sweep_tc::et_image_kernel<<<
      dim3(tiles, (K + sweep_tc::kChunk - 1) / sweep_tc::kChunk),
      sweep_tc::kThreads, 0, stream>>>(et, img, B, K);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || V == 0) return err;
  constexpr int smem = sweep_tc::RCfg::kSmem;
  err = cudaFuncSetAttribute(sweep_tc::r_pass_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const int per = sweep_tiles_per_split(B, V, kDenseK);
  const int vtiles = (V + sweep_tc::kBV - 1) / sweep_tc::kBV;
  sweep_tc::r_pass_kernel<<<dim3(tiles, (vtiles + per - 1) / per),
                            sweep_tc::kThreads, smem, stream>>>(
      c, img, eb, static_cast<float*>(scratch), B, V, K,
      static_cast<int>(d.ldr), per);
  return cudaGetLastError();
}

// K2 (segs == nullptr) or K5 over `slots` slots at K topics: the KPL =
// ceil(K / 32) instance up to 256 topics, the wide body (KPL = 0) above; 8
// warps a block, or fewer where a warp's staging rows would not fit 8 to a
// block (K above ~7,000); the runs over as many blocks as are co-resident
// (at most one run a warp), the wide body a warp a slot.
template <int KPL>
cudaError_t launch_token_pi(const int32_t* ids, const float* cnts,
                            const int32_t* segs, const float* eb,
                            const float* et, float* pi, int64_t slots, int L,
                            int K, int quantize, cudaStream_t stream) {
  const void* kernel =
      segs == nullptr
          ? reinterpret_cast<const void*>(&token_pi_kernel<KPL>)
          : reinterpret_cast<const void*>(&csr_token_pi_kernel<KPL>);
  int dev = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&max_smem,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  const size_t per_warp =
      pi_stage_floats(KPL > 0 ? pi_group(KPL) : 1, K) * sizeof(float);
  const int warps = static_cast<int>(std::min<size_t>(
      kPiThreads / kWarp, static_cast<size_t>(max_smem) / per_warp));
  if (warps < 1) return cudaErrorInvalidValue;
  const size_t smem = warps * per_warp;
  // the wide body: a warp a slot, every slot at once; the runs: the
  // co-resident grid
  const int64_t items = KPL > 0 ? (slots + kPiRun - 1) / kPiRun : slots;
  int64_t blocks = (items + warps - 1) / warps;
  if (KPL > 0) {
    int capacity = 0;
    err = resident_blocks(kernel, warps * kWarp, smem, false, &capacity);
    if (err != cudaSuccess) return err;
    blocks = std::min<int64_t>(blocks, capacity);
  } else if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  if (blocks > INT32_MAX) return cudaErrorInvalidValue;
  const dim3 grid(static_cast<unsigned>(std::max<int64_t>(1, blocks)));
  if (segs == nullptr) {
    token_pi_kernel<KPL><<<grid, warps * kWarp, smem, stream>>>(
        ids, cnts, eb, et, pi, slots, L, K, quantize);
  } else {
    csr_token_pi_kernel<KPL><<<grid, warps * kWarp, smem, stream>>>(
        ids, cnts, segs, eb, et, pi, slots, K, quantize);
  }
  return cudaGetLastError();
}

cudaError_t dispatch_token_pi(const int32_t* ids, const float* cnts,
                              const int32_t* segs, const float* eb,
                              const float* et, float* pi, int64_t slots,
                              int L, int K, int quantize, void* stream) {
  if (K < 1 || slots < 0 || (segs == nullptr && L < 1)) {
    return cudaErrorInvalidValue;
  }
  if (slots == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define LDA_PI_CASE(N)                                                     \
  case N:                                                                  \
    return launch_token_pi<N>(ids, cnts, segs, eb, et, pi, slots, L, K,    \
                              quantize, s);
  switch (K <= kNarrowK ? (K + kWarp - 1) / kWarp : 0) {
    LDA_PI_CASE(1)
    LDA_PI_CASE(2)
    LDA_PI_CASE(3)
    LDA_PI_CASE(4)
    LDA_PI_CASE(5)
    LDA_PI_CASE(6)
    LDA_PI_CASE(7)
    LDA_PI_CASE(8)
    default:
      return launch_token_pi<0>(ids, cnts, segs, eb, et, pi, slots, L, K,
                                quantize, s);
  }
#undef LDA_PI_CASE
}

}  // namespace

extern "C" {

const char* lda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Bytes of dynamic shared memory a block of K1/K4 takes for B documents
// and K topics in tiles of block_b within groups of `group` rows (K4:
// block_b = group = B), and the card's per-block maximum (or minus a CUDA
// error code): the fixed point's only limit on K.
int lda_fixed_point_smem_bytes(int B, int K, int block_b, int group) {
  if (B < 1 || K < 1 || block_b < 1 || group < 1 || B % group != 0) return 0;
  return static_cast<int>(std::min<size_t>(
      fp_smem_bytes(K, B, block_b, group), INT32_MAX));
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
// in tiles of block_b within groups of `group` rows, or minus a CUDA error
// code (lda_fixed_point sizes its own grid the same way; this reports
// it). K4's grid is the one for L = ceil(T / B) and block_b = group = B.
int lda_fixed_point_blocks(int B, int L, int K, int block_b, int group) {
  cudaGetLastError();
  if (B < 1 || L < 0 || block_b < 1) return -cudaErrorInvalidValue;
  int blocks = 0;
  const cudaError_t err = fp_grid(B, L, K, block_b, group, &blocks);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Warps per document of K1 and K4 for rows of L slots (K4: L = ceil(T / B)).
int lda_fixed_point_warps(int L) { return fp_warps_per_doc(L); }

// K1 over a padded (B, L) batch. cnts (B, L) and eb = Eφ (V, K): fp32;
// sweep_cnts and sweep_eb: what the sweeps read (the same pointers, or
// copies rounded through bf16 for repro's bf16 stream of the dense counts
// and Eφ). pi: nullptr, or the (B, L, K) output of the finish (from cnts
// and eb, rounded through bf16 with quantize). delta: 2 * B floats of
// scratch (the per-document |d gamma| slots). group: the rows of one
// stop-test group, dividing B (B for one batch); iters holds
// B / group * ceil(group / block_b) counts, group by group.
int lda_fixed_point(const int32_t* ids, const float* cnts, const float* eb,
                    const float* sweep_cnts, const float* sweep_eb,
                    const float* gamma0, float* gamma, float* et,
                    float* delta, int32_t* iters, float* pi, int B, int L,
                    int K, float alpha0, float tol, int max_sweeps,
                    int block_b, int group, int quantize, void* stream) {
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
  a.group = group;
  a.quantize = quantize;
  return dispatch_fixed_point(a, static_cast<cudaStream_t>(stream));
}

// K2 over `slots` = B * L padded slots (rows of L; any K).
int lda_token_pi(const int32_t* ids, const float* cnts, const float* eb,
                 const float* et, float* pi, int64_t slots, int L, int K,
                 int quantize, void* stream) {
  cudaGetLastError();
  return dispatch_token_pi(ids, cnts, nullptr, eb, et, pi, slots, L, K,
                           quantize, stream);
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
  a.group = B;
  a.quantize = quantize;
  return dispatch_fixed_point(a, static_cast<cudaStream_t>(stream));
}

// K5 over a flat stream of `slots` slots, each slot's document its
// segment id (any order; any K).
int lda_token_pi_csr(const int32_t* ids, const float* cnts,
                     const int32_t* segs, const float* eb, const float* et,
                     float* pi, int64_t slots, int K, int quantize,
                     void* stream) {
  cudaGetLastError();
  if (segs == nullptr) return cudaErrorInvalidValue;
  return dispatch_token_pi(ids, cnts, segs, eb, et, pi, slots, 1, K,
                           quantize, stream);
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

// K6's V splits for B rows, V columns and K topics: the first dimension
// of its `part` scratch (splits, B, K).
int lda_sweep_splits(int B, int V, int K) { return sweep_splits(B, V, K); }

// K6's tickets for B rows and K topics: one per row tile (and per
// 128-topic chunk above 128 topics).
int lda_sweep_tickets(int B, int K) {
  return (B + sweep_tc::kBM - 1) / sweep_tc::kBM * dense_chunks(K);
}

// Bytes of the scratch K6 and K7 take for B rows, V columns and K topics:
// 0 up to 128 topics, R and E[theta]'s images above.
int64_t lda_dense_scratch_bytes(int B, int V, int K) {
  return dense_scratch(B, V, K).bytes;
}

// K6: gamma' (B, K) from c (B, V), et (B, K) and eb (V, K). part: nsplit
// (= lda_sweep_splits) x B x K floats; tickets: lda_sweep_tickets zeros
// (left zero); scratch: lda_dense_scratch_bytes (nullptr at K <= 128).
int lda_sweep(const float* c, const float* et, const float* eb, float* out,
              float* part, int* tickets, void* scratch, int B, int V, int K,
              float alpha0, int nsplit, void* stream) {
  cudaGetLastError();
  if (K < 1 || B < 0 || V < 0 || nsplit != sweep_splits(B, V, K) ||
      (dense_scratch(B, V, K).bytes > 0 && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (B == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int row_tiles = (B + sweep_tc::kBM - 1) / sweep_tc::kBM;
  const int per_split = sweep_tiles_per_split(B, V, K);
  if (K <= 64) {
    return launch_dense_tc<1, false, false>(
        dim3(row_tiles, nsplit), s, c, V, et, eb, out, part, tickets, B, V,
        K, alpha0, per_split);
  }
  if (K <= kDenseK) {
    return launch_dense_tc<2, false, false>(
        dim3(row_tiles, nsplit), s, c, V, et, eb, out, part, tickets, B, V,
        K, alpha0, per_split);
  }
  if (row_tiles > 65535 || nsplit > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = launch_r_pass(s, c, et, eb, scratch, B, V, K);
  if (err != cudaSuccess) return err;
  return launch_dense_tc<2, false, true>(
      dim3(dense_chunks(K), row_tiles, nsplit), s,
      static_cast<const float*>(scratch),
      static_cast<int>(dense_scratch(B, V, K).ldr), et, eb, out, part,
      tickets, B, V, K, alpha0, per_split);
}

// K7: S (V, K) from c (B, V), et (B, K) and eb (V, K); scratch as
// lda_sweep's.
int lda_sstats(const float* c, const float* et, const float* eb, float* out,
               void* scratch, int B, int V, int K, void* stream) {
  cudaGetLastError();
  if (K < 1 || B < 0 || V < 0 ||
      (dense_scratch(B, V, K).bytes > 0 && scratch == nullptr)) {
    return cudaErrorInvalidValue;
  }
  if (V == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int v_tiles = (V + sweep_tc::kBM - 1) / sweep_tc::kBM;
  // one split: every B tile, in order
  const int b_tiles = std::max(1, (B + sweep_tc::kBV - 1) / sweep_tc::kBV);
  if (K <= 64) {
    return launch_dense_tc<1, true, false>(
        dim3(v_tiles), s, c, V, eb, et, out, nullptr, nullptr, B, V, K, 0.f,
        b_tiles);
  }
  if (K <= kDenseK) {
    return launch_dense_tc<2, true, false>(
        dim3(v_tiles), s, c, V, eb, et, out, nullptr, nullptr, B, V, K, 0.f,
        b_tiles);
  }
  if (v_tiles > 65535) return cudaErrorInvalidValue;
  const cudaError_t err = launch_r_pass(s, c, et, eb, scratch, B, V, K);
  if (err != cudaSuccess) return err;
  return launch_dense_tc<2, true, true>(
      dim3(dense_chunks(K), v_tiles), s, static_cast<const float*>(scratch),
      static_cast<int>(dense_scratch(B, V, K).ldr), eb, et, out, nullptr,
      nullptr, B, V, K, 0.f, b_tiles);
}

// K8 over N = B * L token slots (N < 2^31) in tiles of tile_slots =
// block_b * L: order (N) and seg_off (V + 1) are K3's preparation of the
// flat ids and counts (scatter_segments); eb_tok (N, K) the slots' Eφ rows,
// old_pi (N, K) or nullptr, et (B, K). Writes pi (N, K) and every row of
// s_new (and of s_old when old_pi is given).
int lda_memo_delta_onehot(const int64_t* order, const int64_t* seg_off,
                          int V, int64_t N, const float* cnts,
                          const float* eb_tok, const float* old_pi,
                          const float* et, float* pi, float* s_new,
                          float* s_old, int L, int K, int64_t tile_slots,
                          int quantize, void* stream) {
  cudaGetLastError();
  if (V < 0 || N < 0 || N >= (int64_t{1} << 31) || L < 1 || K < 1 ||
      tile_slots < 1) {
    return cudaErrorInvalidValue;
  }
  if (N == 0 && V == 0) return cudaSuccess;
  OnehotArgs a{order, seg_off, cnts,  eb_tok, old_pi, et, pi,
               s_new, old_pi != nullptr ? s_old : nullptr,
               N,     tile_slots, V, L, K, quantize};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (K > kDenseK) return launch_onehot<kDenseK / kWarp, true>(a, s);
  switch ((K + kWarp - 1) / kWarp) {
    case 1:
      return launch_onehot<1, false>(a, s);
    case 2:
      return launch_onehot<2, false>(a, s);
    case 3:
      return launch_onehot<3, false>(a, s);
    default:
      return launch_onehot<4, false>(a, s);
  }
}

}  // extern "C"
