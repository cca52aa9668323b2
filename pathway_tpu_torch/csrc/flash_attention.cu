// Forward flash attention over (B, T, H, hd) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel _flash_kernel of
// pathway_tpu/ops/attention_pallas.py (launched by _flash_bhtd, public
// flash_attention), which the dense prefill runs for T >= 256.
//
// What it computes.  For each (b, h) and query row t < T: the softmax over
// keys s < T (s <= t when causal) of (q_t . k_s) / sqrt(hd), times v, as
// the online (m, l, acc) recurrence in f32.  Masked scores are -1e30 AND
// their probabilities are zeroed (a row whose running max is still -1e30
// would otherwise weigh masked keys by exp(0) = 1).  The probabilities are
// rounded to v's dtype before the PV product; the denominator is the sum
// of the unrounded ones, clamped at 1e-20; the output is written in q's
// dtype.
//
// What bounds it on the H100.  Prefill attention does 4 * hd flops per
// (query, visible key) pair against 4 tensors of T * hd elements per head:
// at T = 1024, hd = 64 that is ~130 flops per byte, below the bf16 tensor
// cores' ~295 flop/byte, so the bound is memory bandwidth (a few
// microseconds).  This kernel computes on the CUDA cores in f32 (67
// TFLOP/s peak), where the same work is bound by operations.
//
// What the design does about it.  One thread block per (query tile of 64
// rows, head, batch row), heaviest (last, under the causal mask) tiles
// first; the block walks the key tiles of 64 that its rows can see -- key
// tiles wholly above the diagonal are never read, as the Pallas kernel's
// pl.when skips them.  q, k and v are read in place through their strides
// (no transpose to (B*H, T, D), no padding of T or hd to 128: rows and
// keys past T are never read or written), converted to f32 once into
// shared memory.  Each thread owns a 4 x 8 block of scores and a 4 x hd/8
// block of the output, so every shared-memory load feeds 8 FMAs; the row
// max and sum are reduced across the 8 threads of a row group with warp
// shuffles.  Not yet done: tensor-core (mma / wgmma) products, TMA
// staging and double buffering of the key tiles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NT = 128;      // threads: 16 row groups x 8 key/dim groups
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reductions over the 8 lanes of a row group (lanes differing in bits 0-2)
__device__ __forceinline__ float group_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 1));
  v = fmaxf(v, __shfl_xor_sync(FULL, v, 2));
  return fmaxf(v, __shfl_xor_sync(FULL, v, 4));
}
__device__ __forceinline__ float group_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  v += __shfl_xor_sync(FULL, v, 2);
  return v + __shfl_xor_sync(FULL, v, 4);
}

// Stage ROWS rows of hd elements (row t0 + r of one (b, h)) into shared
// memory as f32, either transposed (dst[d * ROWS + r]) or row-major
// (dst[r * HD + d]); rows at or past T are zero.  16-byte loads.
template <typename T, int HD, int ROWS, bool TRANSPOSE>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long st, int t0, int T_len) {
  constexpr int EPV = 16 / sizeof(T);  // elements per 16-byte load
  constexpr int VPR = HD / EPV;        // loads per row
  for (int i = threadIdx.x; i < ROWS * VPR; i += NT) {
    // transposed: consecutive threads take consecutive rows, so their
    // shared-memory stores fall in distinct banks
    const int r = TRANSPOSE ? i % ROWS : i / VPR;
    const int cv = TRANSPOSE ? i / ROWS : i % VPR;
    const int t = t0 + r;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (t < T_len)
      raw = *reinterpret_cast<const uint4*>(src + (long long)t * st + cv * EPV);
    const T* e = reinterpret_cast<const T*>(&raw);
    if (TRANSPOSE) {
#pragma unroll
      for (int j = 0; j < EPV; ++j) dst[(cv * EPV + j) * ROWS + r] = to_f32(e[j]);
    } else {
#pragma unroll
      for (int j = 0; j < EPV; j += 4)
        *reinterpret_cast<float4*>(&dst[r * HD + cv * EPV + j]) = make_float4(
            to_f32(e[j]), to_f32(e[j + 1]), to_f32(e[j + 2]), to_f32(e[j + 3]));
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int T_len, int H,
             long long q_sb, long long q_st, long long q_sh, long long k_sb,
             long long k_st, long long k_sh, long long v_sb, long long v_st,
             long long v_sh, int causal, float scale) {
  constexpr int DC = HD / 32;  // float4 column chunks of the output a thread owns
  extern __shared__ float4 smem4[];
  float* qT = reinterpret_cast<float*>(smem4);  // [HD][BQ]
  float* kT = qT + HD * BQ;                     // [HD][BK]
  float* vs = kT + HD * BK;                     // [BK][HD]
  float* pT = vs + BK * HD;                     // [BK][BQ]

  const int nq = (T_len + BQ - 1) / BQ;
  const int qt = nq - 1 - blockIdx.x;  // heaviest query tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const int tid = threadIdx.x;
  const int tx = tid & 7;   // keys 4tx..4tx+3 and 32+4tx..; dims 4tx+32c..
  const int ty = tid >> 3;  // rows 4ty..4ty+3

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + h * k_sh;
  const T* vb = v + b * v_sb + h * v_sh;

  stage<T, HD, BQ, true>(qT, qb, q_st, q0, T_len);

  float m[4], l[4], acc[4][DC * 4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DC * 4; ++j) acc[i][j] = 0.f;
  }

  const int nk_all = (T_len + BK - 1) / BK;
  // causal: key tiles starting past the block's last row are invisible
  const int nk = causal ? min(nk_all, (q0 + BQ - 1) / BK + 1) : nk_all;

  for (int kt = 0; kt < nk; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // the previous tile's kT / vs / pT are consumed
    stage<T, HD, BK, true>(kT, kb, k_st, k0, T_len);
    stage<T, HD, BK, false>(vs, vb, v_st, k0, T_len);
    __syncthreads();

    // scores: rows 4ty+i, keys key_of(j)
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(&qT[d * BQ + 4 * ty]);
      const float4 ka = *reinterpret_cast<const float4*>(&kT[d * BK + 4 * tx]);
      const float4 kc =
          *reinterpret_cast<const float4*>(&kT[d * BK + 32 + 4 * tx]);
      const float qv[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kv[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax over this tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + 4 * ty + i;
      bool valid[8];
      float mt = NEG;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int key = k0 + (j < 4 ? 4 * tx + j : 32 + 4 * tx + (j - 4));
        valid[j] = key < T_len && (!causal || key <= row);
        s[i][j] = valid[j] ? s[i][j] * scale : NEG;
        mt = fmaxf(mt, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mt));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = valid[j] ? expf(s[i][j] - m_new) : 0.f;
        psum += p;
        s[i][j] = to_f32(from_f32<T>(p));  // p in v's dtype for the PV product
      }
      l[i] = l[i] * corr + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DC * 4; ++j) acc[i][j] *= corr;
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int key = j < 4 ? 4 * tx + j : 32 + 4 * tx + (j - 4);
      *reinterpret_cast<float4*>(&pT[key * BQ + 4 * ty]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    }
    __syncthreads();

    // acc += P V over the tile's keys (keys past T carry p = 0 and v = 0)
    const int kmax = min(BK, T_len - k0);
    for (int key = 0; key < kmax; ++key) {
      const float4 pr = *reinterpret_cast<const float4*>(&pT[key * BQ + 4 * ty]);
      const float pv[4] = {pr.x, pr.y, pr.z, pr.w};
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float4 vv =
            *reinterpret_cast<const float4*>(&vs[key * HD + 32 * c + 4 * tx]);
        const float ve[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[i][c * 4 + e] = fmaf(pv[i], ve[e], acc[i][c * 4 + e]);
      }
    }
  }

  // out is (B, T, H, HD), contiguous
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + 4 * ty + i;
    if (row >= T_len) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    T* o = out + (((long long)b * T_len + row) * H + h) * HD;
#pragma unroll
    for (int c = 0; c < DC; ++c)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[32 * c + 4 * tx + e] = from_f32<T>(acc[i][c * 4 + e] * inv);
  }
}

template <typename T, int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int T_len, int H, const long long* st, int causal, float scale,
              cudaStream_t stream) {
  constexpr size_t smem = (size_t)(HD * BQ + HD * BK + BK * HD + BK * BQ) *
                          sizeof(float);
  static bool attr_set = false;  // once per instantiation
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    attr_set = true;
  }
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), T_len, H, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int T_len, int H, int hd, const long long* st, int causal,
           float scale, cudaStream_t stream) {
  switch (hd) {
    case 32:
      return launch_hd<T, 32>(q, k, v, out, B, T_len, H, st, causal, scale,
                              stream);
    case 64:
      return launch_hd<T, 64>(q, k, v, out, B, T_len, H, st, causal, scale,
                              stream);
    case 128:
      return launch_hd<T, 128>(q, k, v, out, B, T_len, H, st, causal, scale,
                               stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// Strides are in elements, (batch, token, head) for each of q, k, v; the
// head dim is contiguous.  dtype: 0 = float32, 1 = bfloat16.  Returns
// cudaGetLastError().
extern "C" int pw_flash_attention(const void* q, const void* k, const void* v,
                                  void* out, int B, int T_len, int H, int hd,
                                  long long q_sb, long long q_st,
                                  long long q_sh, long long k_sb,
                                  long long k_st, long long k_sh,
                                  long long v_sb, long long v_st,
                                  long long v_sh, int causal, int dtype,
                                  float scale, void* stream) {
  const long long st[9] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh,
                           v_sb, v_st, v_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(q, k, v, out, B, T_len, H, hd, st, causal, scale, s);
  return launch<__nv_bfloat16>(q, k, v, out, B, T_len, H, hd, st, causal,
                               scale, s);
}
