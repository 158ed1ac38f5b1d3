// K9: flash attention for Hopper (sm_90a), fp32 math on fp32 or bf16 inputs.
//
// Replaces _flash_kernel (repro/kernels/flash_attention.py:31): online-
// softmax attention over (BH, S, hd), causal or not, output in the inputs'
// dtype. The (S, S) score matrix never reaches device memory.
//
// One block owns one (head, 64-query tile): it loads the tile's queries,
// scaled, into shared memory as fp32 and walks the key/value tiles up to
// the causal limit (a tile runs when its first key is <= the tile's last
// query, the TPU kernel's skip rule) and up to kv_len. Each of the 8 warps
// owns 8 query rows; their running max, sum and accumulator (8 x hd) stay
// in registers, in fp32. Scores of keys at or past kv_len, and above the
// diagonal when causal, are -1e30, as in the TPU kernel; the sum is
// clamped at 1e-30 before the division. Keys and values are read from head
// bh / rep, so grouped-query attention needs no repeated copy.
//
// Bound: operations on the fp32 SIMT cores as written (2 products of
// S x S x hd per head, halved when causal); the bf16 tensor cores would
// bound it 15x lower, the later redesign (wgmma) this kernel waits for.
// Shared memory: fp32 Q, K and V tiles plus the 64 x BK probabilities,
// 117 KB at hd = 128 with 64-key tiles, so the key tile is cut to 32 above
// hd = 128 (141 KB at hd = 256, the cap); both above the 48 KB default,
// raised with cudaFuncSetAttribute.
//
// Built by nvcc into its own shared library with a plain C interface and
// loaded with ctypes (repro_torch/kernels/build.py).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;                     // 8 warps
constexpr int kRows = 8;                          // query rows per warp
constexpr int kBQ = kRows * (kThreads / kWarp);   // 64 query rows per block
constexpr int kMaxDpl = 8;                        // hd <= 256
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_out(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

template <typename T, int DPL, int BK>
__global__ void __launch_bounds__(kThreads)
    flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out, int BH,
                 int rep, int S, int hd, int kv_len, float scale,
                 int causal) {
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
            ? to_f32(q[q_base + static_cast<size_t>(row) * hd + d]) * scale
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
  for (int k0 = 0; k0 < kv_end; k0 += BK) {
    __syncthreads();   // the last tile's reads of s_k, s_v, s_p are done
    for (int i = tid; i < BK * Tl::kD; i += kThreads) {
      const int c = i / Tl::kD, d = i % Tl::kD;
      const int key = k0 + c;
      const bool in = key < S && d < hd;
      const size_t at = kv_base + static_cast<size_t>(key) * hd + d;
      s_k[c * Tl::kStride + d] = in ? to_f32(k[at]) : 0.f;
      s_v[c * Tl::kD + d] = in ? to_f32(v[at]) : 0.f;
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
        const bool keep = col < kv_len && (!causal || row >= col);
        s[i][cc] = keep ? s[i][cc] : kNegInf;
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
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < DPL; ++dd) {
      const int d = lane + kWarp * dd;
      if (d < hd) {
        store_out(out + q_base + static_cast<size_t>(row) * hd + d,
                  acc[i][dd] * inv);
      }
    }
  }
}

template <typename T, int DPL>
cudaError_t launch_flash(const void* q, const void* k, const void* v,
                         void* out, int BH, int rep, int S, int hd,
                         int kv_len, float scale, int causal,
                         cudaStream_t stream) {
  constexpr int BK = DPL <= 4 ? 64 : 32;
  using Tl = Tile<DPL, BK>;
  cudaError_t err = cudaFuncSetAttribute(
      flash_kernel<T, DPL, BK>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(Tl::kSmem));
  if (err != cudaSuccess) return err;
  const int64_t blocks = static_cast<int64_t>(BH) * ((S + kBQ - 1) / kBQ);
  flash_kernel<T, DPL, BK>
      <<<static_cast<unsigned>(blocks), kThreads, Tl::kSmem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), BH, rep, S, hd, kv_len,
      scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_flash(const void* q, const void* k, const void* v,
                           void* out, int BH, int rep, int S, int hd,
                           int kv_len, float scale, int causal,
                           cudaStream_t stream) {
  const int dpl = (hd + kWarp - 1) / kWarp;
#define ATTN_CASE(N)                                                        \
  case N:                                                                   \
    return launch_flash<T, N>(q, k, v, out, BH, rep, S, hd, kv_len, scale, \
                              causal, stream);
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

}  // namespace

extern "C" {

const char* attn_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// Highest head dimension the kernel takes (its per-lane register arrays).
int attn_max_head_dim() { return kMaxDpl * kWarp; }

// out = softmax(q k^T * scale, masked) v for BH query heads of S rows and
// hd dims; keys and values have BH / rep heads (head bh reads bh / rep).
// Keys at or past kv_len are masked; causal masks keys after the query.
// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike).
int attn_flash(const void* q, const void* k, const void* v, void* out,
               int BH, int rep, int S, int hd, int kv_len, float scale,
               int causal, int dtype, void* stream) {
  cudaGetLastError();
  if (rep < 1 || BH % rep != 0 || kv_len < 1 || kv_len > S || hd < 1) {
    return cudaErrorInvalidValue;
  }
  if (BH == 0 || S == 0) return cudaSuccess;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return dispatch_flash<float>(q, k, v, out, BH, rep, S, hd, kv_len, scale,
                                 causal, s);
  }
  if (dtype == 1) {
    return dispatch_flash<__nv_bfloat16>(q, k, v, out, BH, rep, S, hd, kv_len,
                                         scale, causal, s);
  }
  return cudaErrorInvalidValue;
}

}  // extern "C"
