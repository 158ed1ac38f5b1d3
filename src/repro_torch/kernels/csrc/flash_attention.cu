// K9: flash attention for Hopper (sm_90a), on fp32 or bf16 inputs.
//
// Replaces _flash_kernel (repro/kernels/flash_attention.py:31): online-
// softmax attention over (BH, S, hd), causal or not, output in the inputs'
// dtype, and two functions of the LM template's chunked attention
// (repro/models/attention.py:119-122) that the TPU kernel lacks: a sliding
// window and an attention-logit softcap. The (S, S) score matrix never
// reaches device memory.
// The softcap: the scaled score x = s * scale becomes cap * tanh(x / cap)
// before the mask and the running max, by tanhf in both bodies (the bf16
// body takes it as cap log2(e) tanh(s (scale / cap)), in log2 units). Each
// body has an instance with the softcap and one without (kCap), so a call
// without it runs no tanhf and holds no register for it. The window is a
// run-time bound: no window is a window of INT_MAX.
// The masks: a (row, col) pair is kept iff col < kv_len, and when causal
// row >= col, and with a window W row - col < W (a window needs causal).
// A dropped score is -1e30, as in the TPU kernel. The row sum is clamped at
// 1e-30 before the division; a row that keeps no key at all (a padded row
// W or more past kv_len) is written as zeros.
// The skip rule: a block visits the key tiles from the one holding key
// max(0, q0 - W + 1) (q0 its first row; 0 without a window) to the causal
// limit (a tile runs when its first key is <= the query tile's last row,
// the TPU kernel's rule); the tiles outside every row's window are never
// loaded. A row can still meet whole tiles outside its own window first:
// their keys give p = exp(-1e30 - (-1e30)) = 1, and its first kept key
// wipes them (the correction exp(-1e30 - m) is 0). A causal row below
// kv_len keeps its diagonal key, so a kept key comes in every such row.
// Keys and values are read from head bh / rep, so grouped-query attention
// needs no repeated copy. Two bodies:
//
// bf16 (flash_tc_kernel): the tensor cores, FlashAttention-3's shape. One
// block owns one (head, 128-query tile): two consumer warpgroups of 64
// query rows each, and one producer warp. The producer loads the query
// tile once and keeps K and V tiles in flight by TMA (tensor maps encoded
// on the host, 128-byte swizzle) into a 2-stage ring in shared memory,
// signalled by mbarriers; the consumers release a stage once both have
// read it. S = Q.K^T is wgmma with both operands in shared memory and fp32
// accumulators; the scale, the masks and the online softmax run on the
// fp32 scores in registers. O += P.V is two register-A wgmmas, P_hi.V +
// P_lo.V with P_hi = bf16(P) and P_lo = bf16(P - P_hi): a single bf16 P is
// off the fp32-math twin by up to 2x the bf16 bar this kernel is held to
// (rtol 2^-7, atol 1e-3), the split keeps P to about 16 bits. The head
// width is padded to the template's (64, 128 or 256) by TMA's zero fill of
// the columns past hd; hd must be a multiple of 8 (TMA's 16-byte row
// pitch: the wrapper pads other widths). No atomics: the same bits on
// every launch.
// Bound: operations on the bf16 tensor cores. The function needs Q.K^T and
// P.V over the kept (query, key) pairs, 4 hd operations a pair: S(S+1)/2
// pairs a head when causal, 68.7 GFLOP at Qwen2.5-3B's widths (16 heads,
// hd = 128, S = 4096), 0.0695 ms at 989 TFLOP/s; with a window W, W(W+1)/2
// + (S - W) W pairs (23.4% of the causal ones at S = 32768, W = 4096). The
// split makes P.V twice the work: this design's floor is 1.5x the bound.
// Shared memory: the query tile (128 x D), 2 stages of K and V tiles
// (BK x D each; BK = 128 up to D = 128, 64 at D = 256): 160 KB at D = 128,
// 192 KB at D = 256, one block per SM.
//
// fp32 (flash_kernel): fp32 SIMT math. The fp32 bars (2e-5) rule out bf16
// and TF32 products. One block owns one (head, 64-query tile): it loads the
// tile's queries, scaled, into shared memory and walks the key/value tiles;
// each of the 8 warps owns 8 query rows, their running max, sum and
// accumulator (8 x hd) in registers. Bound: operations on the fp32 SIMT
// cores (1.03 ms at the widths above). Shared memory: Q, K and V tiles plus
// the 64 x BK probabilities, 117 KB at hd = 128 with 64-key tiles, the key
// tile cut to 32 above hd = 128 (141 KB at hd = 256).
//
// Built by nvcc into its own shared library with a plain C interface and
// loaded with ctypes (repro_torch/kernels/build.py). The tensor-map encoder
// (cuTensorMapEncodeTiled) is a driver function, fetched at run time through
// the runtime's driver entry point, so the library links no libcuda. The
// wgmma helpers are hopper_wgmma.cuh's, shared with K6.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "hopper_wgmma.cuh"

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                     // 8 warps
constexpr int kRows = 8;                          // query rows per warp
constexpr int kBQ = kRows * (kThreads / kWarp);   // 64 query rows per block
constexpr int kMaxDpl = 8;                        // hd <= 256
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// DPL: head dims per lane (hd <= 32 * DPL); BK: keys per tile.
template <int DPL, int BK>
struct Tile {
  static constexpr int kD = DPL * kWarp;     // hd padded to the lanes
  static constexpr int kStride = kD + 4;     // Q, K rows: float4-aligned
  static constexpr int kCols = BK / kWarp;   // score columns per lane
  static constexpr size_t kSmem =
      (static_cast<size_t>(kBQ + BK) * kStride +
       static_cast<size_t>(BK) * kD + static_cast<size_t>(kBQ) * BK) *
      sizeof(float);
};

template <int DPL, int BK, bool kCap>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, int BH,
                 int rep, int S, int hd, int kv_len, float scale,
                 int causal, int window, float softcap) {
  using Tl = Tile<DPL, BK>;
  extern __shared__ float4 smem4[];
  float* s_q = reinterpret_cast<float*>(smem4);   // [BQ][stride]
  float* s_k = s_q + kBQ * Tl::kStride;           // [BK][stride]
  float* s_v = s_k + BK * Tl::kStride;            // [BK][D]
  float* s_p = s_v + BK * Tl::kD;                 // [BQ][BK]
  const int tid = threadIdx.x, lane = tid & (kWarp - 1), warp = tid / kWarp;
  // the longest causal rows first: tile nqt - 1 of every head, then nqt - 2
  const int nqt = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x / BH);
  const int q0 = qt * kBQ;
  const size_t q_base = static_cast<size_t>(bh) * S * hd;
  const size_t kv_base = static_cast<size_t>(bh / rep) * S * hd;

  for (int i = tid; i < kBQ * Tl::kD; i += kThreads) {
    const int r = i / Tl::kD, d = i % Tl::kD;
    const int row = q0 + r;
    s_q[r * Tl::kStride + d] =
        (row < S && d < hd)
            ? q[q_base + static_cast<size_t>(row) * hd + d] * scale
            : 0.f;
  }

  float m[kRows], l[kRows], acc[kRows][DPL];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = 0.f;
  }

  const int kv_end = causal ? min(kv_len, q0 + kBQ) : kv_len;
  // the first tile that holds a key inside some row's window
  const int k_begin = max(0, q0 - window + 1) / BK * BK;
  for (int k0 = k_begin; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the last tile's reads of s_k, s_v, s_p are done
    for (int i = tid; i < BK * Tl::kD; i += kThreads) {
      const int c = i / Tl::kD, d = i % Tl::kD;
      const int key = k0 + c;
      const bool in = key < S && d < hd;
      const size_t at = kv_base + static_cast<size_t>(key) * hd + d;
      s_k[c * Tl::kStride + d] = in ? k[at] : 0.f;
      s_v[c * Tl::kD + d] = in ? v[at] : 0.f;
    }
    __syncthreads();

    // scores of rows warp * 8 + i against keys lane + 32 * cc
    float s[kRows][Tl::kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int cc = 0; cc < Tl::kCols; ++cc) s[i][cc] = 0.f;
    for (int d = 0; d < Tl::kD; d += 4) {
      float4 kf[Tl::kCols];
#pragma unroll
      for (int cc = 0; cc < Tl::kCols; ++cc) {
        kf[cc] = *reinterpret_cast<const float4*>(
            s_k + (lane + kWarp * cc) * Tl::kStride + d);
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qf = *reinterpret_cast<const float4*>(
            s_q + (warp * kRows + i) * Tl::kStride + d);
#pragma unroll
        for (int cc = 0; cc < Tl::kCols; ++cc) {
          float a = s[i][cc];
          a = fmaf(qf.x, kf[cc].x, a);
          a = fmaf(qf.y, kf[cc].y, a);
          a = fmaf(qf.z, kf[cc].z, a);
          s[i][cc] = fmaf(qf.w, kf[cc].w, a);
        }
      }
    }

    // online softmax, row by row
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + warp * kRows + i;
      float mx = kNegInf;
#pragma unroll
      for (int cc = 0; cc < Tl::kCols; ++cc) {
        const int col = k0 + lane + kWarp * cc;
        const bool keep = col < kv_len && (!causal || row >= col) &&
                          row - col < window;
        float x = s[i][cc];
        if (kCap) x = softcap * tanhf(x / softcap);
        s[i][cc] = keep ? x : kNegInf;
        mx = fmaxf(mx, s[i][cc]);
      }
      const float m_new = fmaxf(m[i], warp_max(mx));
      float psum = 0.f;
#pragma unroll
      for (int cc = 0; cc < Tl::kCols; ++cc) {
        const float p = expf(s[i][cc] - m_new);
        psum += p;
        s_p[(warp * kRows + i) * BK + lane + kWarp * cc] = p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) acc[i][dd] *= corr;
    }
    __syncwarp();

    // acc += P . V over this tile's keys
    for (int c = 0; c < BK; ++c) {
      float vf[DPL];
#pragma unroll
      for (int dd = 0; dd < DPL; ++dd) vf[dd] = s_v[c * Tl::kD + lane + kWarp * dd];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = s_p[(warp * kRows + i) * BK + c];
#pragma unroll
        for (int dd = 0; dd < DPL; ++dd) acc[i][dd] = fmaf(p, vf[dd], acc[i][dd]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + warp * kRows + i;
    if (row >= S) continue;
    // m stays at -1e30 only in a row that kept no key
    const float inv = m[i] > kNegInf ? 1.f / fmaxf(l[i], 1e-30f) : 0.f;
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane + kWarp * dd;
      if (d < hd) {
        out[q_base + static_cast<size_t>(row) * hd + d] = acc[i][dd] * inv;
      }
    }
  }
}

template <int DPL, bool kCap>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, int BH, int rep, int S, int hd,
                         int kv_len, float scale, int causal, int window,
                         float softcap, cudaStream_t stream) {
  constexpr int BK = DPL <= 4 ? 64 : 32;
  using Tl = Tile<DPL, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<DPL, BK, kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tl::kSmem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(BH) * ((S + kBQ - 1) / kBQ);
  flash_kernel<DPL, BK, kCap>
      <<<static_cast<unsigned>(blocks), kThreads, Tl::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), BH, rep, S, hd,
      kv_len, scale, causal, window, softcap);
  return cudaGetLastError();
}

cudaError_t dispatch_flash_f32(const void* q, const void* k, const void* v,
                               void* out, int BH, int rep, int S, int hd,
                               int kv_len, float scale, int causal,
                               int window, float softcap,
                               cudaStream_t stream) {
  const int dpl = (hd + kWarp - 1) / kWarp;
#define ATTN_CASE(N)                                                        \
  case N:                                                                   \
    return softcap > 0.f                                                    \
               ? launch_flash<N, true>(q, k, v, out, BH, rep, S, hd,        \
                                       kv_len, scale, causal, window,       \
                                       softcap, stream)                     \
               : launch_flash<N, false>(q, k, v, out, BH, rep, S, hd,       \
                                        kv_len, scale, causal, window,      \
                                        softcap, stream);
  switch (dpl) {
    ATTN_CASE(1)
    ATTN_CASE(2)
    ATTN_CASE(3)
    ATTN_CASE(4)
    ATTN_CASE(5)
    ATTN_CASE(6)
    ATTN_CASE(7)
    ATTN_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef ATTN_CASE
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores
// ---------------------------------------------------------------------------

namespace tc {

using namespace hopper;

constexpr int kBQ = 128;                     // query rows per block
constexpr int kConsumers = 2;                // warpgroups of 64 rows
constexpr int kProducerWarp = 4 * kConsumers;
constexpr int kThreads = 128 * kConsumers + kWarp;
constexpr int kStages = 2;
constexpr int kChunk = 64;                   // bf16 columns per 128-byte row
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;

// D: the head width padded to the template; BK: keys per tile.
template <int D>
struct Cfg {
  static constexpr int BK = D <= 128 ? 128 : 64;
  static constexpr int kChunks = D / kChunk;
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = BK * D * 2;   // one K or V tile
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// Wait until the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// One TMA box of a 3-D tensor map into shared memory, completing on bar.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

// P is handed to the P.V product in registers: a register-A operand has
// the accumulator's rows and columns (hopper_wgmma.cuh).
template <int D, bool kCap>
__global__ void __launch_bounds__(kThreads, 1)
    flash_tc_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    __nv_bfloat16* __restrict__ out, int BH, int rep, int S,
                    int hd, int kv_len, float scale, int causal, int window,
                    float softcap) {
  using C = Cfg<D>;
  constexpr int BK = C::BK;
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t q_full;
  __shared__ __align__(8) uint64_t k_full[kStages];
  __shared__ __align__(8) uint64_t v_full[kStages];
  __shared__ __align__(8) uint64_t empty[kStages];
  // swizzled tiles start on 1024-byte boundaries (the swizzle's period)
  const uint32_t s_q = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t s_kv = s_q + C::kQBytes;   // K stages, then V stages

  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  // the longest causal rows first: tile nqt - 1 of every head, then nqt - 2
  const int nqt = (S + kBQ - 1) / kBQ;
  const int bh = blockIdx.x % BH;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x / BH);
  const int q0 = qt * kBQ;
  const int kv_end = causal ? min(kv_len, q0 + kBQ) : kv_len;
  const int t_end = (kv_end + BK - 1) / BK;
  // the first tile that holds a key inside some row's window; the ring's
  // stages and parities count from it
  const int t_first = max(0, q0 - window + 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
#pragma unroll
    for (int st = 0; st < kStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&v_full[st], 1);
      mbar_init(&empty[st], 4 * kConsumers);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kProducerWarp) {
    if (lane == 0) {
      const int kvh = bh / rep;
      mbar_expect_tx(&q_full, C::kQBytes);
#pragma unroll
      for (int c = 0; c < C::kChunks; ++c) {
        tma_load_3d(s_q + c * kBQ * kRowBytes, &tm_q, &q_full, c * kChunk,
                    q0, bh);
      }
      for (int t = t_first; t < t_end; ++t) {
        const int st = (t - t_first) % kStages;
        const int round = (t - t_first) / kStages;
        if (round > 0) mbar_wait(&empty[st], (round - 1) & 1);
        const uint32_t s_k = s_kv + st * C::kTileBytes;
        const uint32_t s_v = s_kv + (kStages + st) * C::kTileBytes;
        mbar_expect_tx(&k_full[st], C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_3d(s_k + c * BK * kRowBytes, &tm_k, &k_full[st],
                      c * kChunk, t * BK, kvh);
        }
        mbar_expect_tx(&v_full[st], C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kChunks; ++c) {
          tma_load_3d(s_v + c * BK * kRowBytes, &tm_v, &v_full[st],
                      c * kChunk, t * BK, kvh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns query rows q0 + 64 wg .. q0 + 64 wg + 63
  const int wg = warp / 4;
  const int row0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4;   // and +8
  const int col0 = 2 * (lane % 4);
  const float scale2 = scale * kLog2e;   // scores in log2 units
  // softcapped: cap * tanh(s * scale / cap), then in log2 units
  const float cap_in = kCap ? scale / softcap : 0.f;
  const float cap_out = softcap * kLog2e;
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  mbar_wait(&q_full, 0);
  for (int t = t_first; t < t_end; ++t) {
    const int st = (t - t_first) % kStages;
    const uint32_t parity = ((t - t_first) / kStages) & 1;
    const uint32_t s_k = s_kv + st * C::kTileBytes;
    const uint32_t s_v = s_kv + (kStages + st) * C::kTileBytes;
    const int k0 = t * BK;

    // S = Q K^T (64 x BK per warpgroup), fp32
    float s[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    mbar_wait(&k_full[st], parity);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk % 4) * 32;   // 16 columns within a row
      const uint64_t da = desc_sw128(
          s_q + (kk / 4) * kBQ * kRowBytes + wg * 64 * kRowBytes + off, 16,
          1024);
      const uint64_t db =
          desc_sw128(s_k + (kk / 4) * BK * kRowBytes + off, 16, 1024);
      wgmma_ss<BK>(s, da, db, kk > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // the softcap, the masks and the running max (rows row0 and row0 + 8),
    // the kept scores in log2 units
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + 8 * (e >> 1);
        const int col = k0 + 8 * j + col0 + (e & 1);
        const bool keep = col < kv_len && (!causal || row >= col) &&
                          row - col < window;
        float x = s[4 * j + e] * scale2;
        if (kCap) x = cap_out * tanhf(s[4 * j + e] * cap_in);
        x = keep ? x : kNegInf;
        s[4 * j + e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
      mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
      corr[h] = exp2f(m[h] - mx[h]);
      m[h] = mx[h];
      l[h] *= corr[h];   // this thread's share of the row sum
    }

    // P = exp(S - m) in fp32, split into bf16 P_hi + P_lo, as A fragments
    uint32_t phi[BK / 16][4], plo[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int h = r & 1;
        const float p0 = exp2f(s[8 * kk + 2 * r] - m[h]);
        const float p1 = exp2f(s[8 * kk + 2 * r + 1] - m[h]);
        l[h] += p0 + p1;
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        phi[kk][r] = bf16x2_bits(hi);
        plo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
    }
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }

    // O += P_hi V + P_lo V
    mbar_wait(&v_full[st], parity);
    fence_regs(o);
    fence_regs(phi);
    fence_regs(plo);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      const uint64_t dv = desc_sw128(s_v + kk * 16 * kRowBytes,
                                     BK * kRowBytes, 1024);
      wgmma_rs<D>(o, phi[kk], dv);
      wgmma_rs<D>(o, plo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(o);
    if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with st
  }

  float inv[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    // m stays at -1e30 only in a row that kept no key
    inv[h] = m[h] > kNegInf ? 1.f / fmaxf(l[h], 1e-30f) : 0.f;
  }
  const size_t base = static_cast<size_t>(bh) * S;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = 8 * j + col0;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row < S && col < hd) {
        *reinterpret_cast<__nv_bfloat162*>(
            out + (base + row) * hd + col) =
            __floats2bfloat162_rn(o[4 * j + 2 * h] * inv[h],
                                  o[4 * j + 2 * h + 1] * inv[h]);
      }
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime.
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A (heads, S, hd) bf16 tensor as a 3-D tensor map: boxes of 64 columns
// by `rows` rows of one head, 128-byte swizzle, zeros past every edge.
cudaError_t make_map(CUtensorMap* map, const void* ptr, int heads, int S,
                     int hd, int rows) {
  EncodeTiled encode = encoder();
  if (encode == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(hd),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(hd) * 2,
                                 static_cast<cuuint64_t>(S) * hd * 2};
  const cuuint32_t box[3] = {kChunk, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

template <int D, bool kCap>
cudaError_t launch(const void* q, const void* k, const void* v, void* out,
                   int BH, int rep, int S, int hd, int kv_len, float scale,
                   int causal, int window, float softcap,
                   cudaStream_t stream) {
  using C = Cfg<D>;
  CUtensorMap mq, mk, mv;
  cudaError_t err = make_map(&mq, q, BH, S, hd, kBQ);
  if (err == cudaSuccess) err = make_map(&mk, k, BH / rep, S, hd, C::BK);
  if (err == cudaSuccess) err = make_map(&mv, v, BH / rep, S, hd, C::BK);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(flash_tc_kernel<D, kCap>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kSmem);
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(BH) * ((S + kBQ - 1) / kBQ);
  flash_tc_kernel<D, kCap><<<static_cast<unsigned>(blocks), kThreads, C::kSmem,
                       stream>>>(mq, mk, mv,
                                 static_cast<__nv_bfloat16*>(out), BH, rep,
                                 S, hd, kv_len, scale, causal, window,
                                 softcap);
  return cudaGetLastError();
}

}  // namespace tc

cudaError_t dispatch_flash_bf16(const void* q, const void* k, const void* v,
                                void* out, int BH, int rep, int S, int hd,
                                int kv_len, float scale, int causal,
                                int window, float softcap,
                                cudaStream_t stream) {
  // TMA: 16-byte row pitch and base addresses
  const uintptr_t addr = reinterpret_cast<uintptr_t>(q) |
                         reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v);
  if (hd % 8 != 0 || (addr & 15) != 0) return cudaErrorInvalidValue;
#define TC_CASE(D)                                                          \
  return softcap > 0.f                                                      \
             ? tc::launch<D, true>(q, k, v, out, BH, rep, S, hd, kv_len,    \
                                   scale, causal, window, softcap, stream)  \
             : tc::launch<D, false>(q, k, v, out, BH, rep, S, hd, kv_len,   \
                                    scale, causal, window, softcap, stream);
  if (hd <= 64) TC_CASE(64)
  if (hd <= 128) TC_CASE(128)
  if (hd <= 256) TC_CASE(256)
#undef TC_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Highest head dimension the kernels take (their register arrays).
int attn_max_head_dim() { return kMaxDpl * kWarp; }

// out = softmax(q k^T * scale, masked) v for BH query heads of S rows and
// hd dims; keys and values have BH / rep heads (head bh reads bh / rep).
// Keys at or past kv_len are masked; causal masks keys after the query;
// window > 0 (causal only) masks keys window or more before it (0: none);
// softcap > 0 caps the scaled scores at softcap * tanh(x / softcap) (0:
// none). dtype: 0 float32, 1 bfloat16 (q, k, v and out alike; hd a
// multiple of 8 and 16-byte aligned bases for bfloat16).
int attn_flash(const void* q, const void* k, const void* v, void* out,
               int BH, int rep, int S, int hd, int kv_len, float scale,
               int causal, int window, float softcap, int dtype,
               void* stream) {
  cudaGetLastError();
  if (rep < 1 || BH % rep != 0 || kv_len < 1 || kv_len > S || hd < 1 ||
      window < 0 || (window > 0 && !causal) || !(softcap >= 0.f)) {
    return cudaErrorInvalidValue;
  }
  if (BH == 0 || S == 0) return cudaSuccess;
  if (window == 0) window = INT_MAX;   // the kernels' bound: no window
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_flash_f32(q, k, v, out, BH, rep, S, hd, kv_len, scale,
                              causal, window, softcap, s);
  }
  if (dtype == 1) {
    return dispatch_flash_bf16(q, k, v, out, BH, rep, S, hd, kv_len, scale,
                               causal, window, softcap, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
