// Ragged paged attention and fused decode append+attend for Hopper (sm_90a).
//
// Replaces two Pallas TPU kernels of pathway_tpu/kvcache/paged_attention.py:
//   - _paged_kernel  (launched by _paged_ragged_fn, public paged_attention)
//   - _append_kernel (launched by _paged_append_fn, public paged_append_attend)
//
// What it computes.  Row b carries C consecutive query columns; column c
// attends to min(c0[b] + c, cl[b]) tokens of the row's context, addressed
// through block_tables[b] into pools laid out (num_blocks, BS, H, hd).
// Softmax is the online (m, l, acc) recurrence in f32.  The append form
// (C = 1) takes the incoming token's K/V as operands: the context's tail
// token (position cl[b]-1) is read from them instead of the pool, and the
// kernel writes exactly that one slot per (row, head) into each pool, at
// (slot_blocks[b], slot_offsets[b]) -- the scatter the unfused path runs
// before attention.
//
// What bounds it on the H100.  Decode and chunked prefill at serving
// batch sizes move every context token's K and V once per layer and do
// about 4*hd flops per (query column, token): a few flops per byte, far
// below the ~295 flop/byte where the tensor cores would be the limit.  The
// bound is device-memory bandwidth (3.35 TB/s): the bytes of K/V the
// rows' contexts span, plus q and the output.
//
// What the design does about it.  One thread block per (row, head, group
// of CG query columns), so the K/V of a row is read once per column
// group, not once per column, and tokens past the group's last attended
// position are never read.  K/V are staged through shared memory in tiles
// of 32 tokens (one token per lane when scoring), converted to f32 once;
// each tile is one round of 16-byte loads, issued while the previous
// tile is being computed.  Each warp owns CPW query columns and keeps
// their (m, l, acc) in registers.  The output is written straight into (B, C, H, hd): no
// transpose and no lane padding of hd to 128, which the TPU wrapper paid
// by copying both pools on every call.  Not yet done: tensor-core
// (wgmma) scoring and TMA staging, which matter once the batch is large.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TILE = 32;             // tokens per staged tile
constexpr int NWARPS = 4;
constexpr int CPW = 2;               // query columns per warp
constexpr int CG = NWARPS * CPW;     // query columns per thread block
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

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(FULL, v, o));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// grid (B, H, ceil(C / CG)); block NWARPS * 32 threads.
template <typename T, int HD, bool APPEND>
__global__ void __launch_bounds__(NWARPS * 32)
paged_attention_kernel(const T* __restrict__ q,       // (B, C, H, HD)
                       T* k_pool, T* v_pool,          // (NBLK, BS, H, HD)
                       const T* __restrict__ k_new,   // (B, H, HD), APPEND
                       const T* __restrict__ v_new,   // (B, H, HD), APPEND
                       T* __restrict__ out,           // (B, C, H, HD)
                       const int* __restrict__ block_tables,  // (B, NBT)
                       const int* __restrict__ c0s,   // (B,) column 0 ctx
                       const int* __restrict__ cls,   // (B,) row context
                       const int* __restrict__ slot_blocks,   // APPEND
                       const int* __restrict__ slot_offsets,  // APPEND
                       int C, int H, int BS, int NBT, float scale) {
  constexpr int DPL = HD / 32;  // head dims per lane
  __shared__ float q_s[CG][HD];
  __shared__ float k_s[TILE][HD + 1];  // +1: lanes read distinct rows
  __shared__ float v_s[TILE][HD];

  const int b = blockIdx.x, h = blockIdx.y;
  const int col_base = blockIdx.z * CG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c0s[b], ctx = cls[b];
  const int col_last = min(C, col_base + CG) - 1;
  const int ctx_group = min(c0 + col_last, ctx);  // tokens this block reads
  const int* table = block_tables + (size_t)b * NBT;

  for (int i = tid; i < CG * HD; i += NWARPS * 32) {
    const int c = i / HD, d = i % HD, col = col_base + c;
    q_s[c][d] =
        col < C ? to_f32(q[(((size_t)b * C + col) * H + h) * HD + d]) : 0.f;
  }

  float m[CPW], l[CPW], acc[CPW][DPL];
#pragma unroll
  for (int i = 0; i < CPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  // Tile loader: TPR threads per token row, each moving EPT contiguous
  // elements of K and of V with 16-byte loads after ONE block-table read,
  // so a tile costs one memory round trip; the next tile is fetched into
  // registers while the current one is computed from shared memory.
  constexpr int TPR = (NWARPS * 32) / TILE;
  constexpr int EPT = HD / TPR;
  constexpr int NV = EPT * sizeof(T) / 16;  // 16-byte loads per operand
  static_assert(EPT * sizeof(T) % 16 == 0, "whole 16-byte loads per thread");
  const int lrow = tid / TPR, lseg = tid % TPR;
  uint4 k_reg[NV], v_reg[NV];
  auto fetch = [&](int t0) {
    const int t = t0 + lrow;
    if (t < ctx_group) {
      const T *ks, *vs;
      if (APPEND && t == ctx - 1) {
        const size_t o = ((size_t)b * H + h) * HD + lseg * EPT;
        ks = k_new + o;
        vs = v_new + o;
      } else {
        const size_t o =
            (((size_t)table[t / BS] * BS + t % BS) * H + h) * HD + lseg * EPT;
        ks = k_pool + o;
        vs = v_pool + o;
      }
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        k_reg[i] = reinterpret_cast<const uint4*>(ks)[i];
        v_reg[i] = reinterpret_cast<const uint4*>(vs)[i];
      }
    } else {
#pragma unroll
      for (int i = 0; i < NV; ++i) k_reg[i] = v_reg[i] = make_uint4(0, 0, 0, 0);
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < ctx_group; t0 += TILE) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
    {
      const T* ke = reinterpret_cast<const T*>(k_reg);
      const T* ve = reinterpret_cast<const T*>(v_reg);
#pragma unroll
      for (int e = 0; e < EPT; ++e) {
        k_s[lrow][lseg * EPT + e] = to_f32(ke[e]);
        v_s[lrow][lseg * EPT + e] = to_f32(ve[e]);
      }
    }
    __syncthreads();
    if (t0 + TILE < ctx_group) fetch(t0 + TILE);
#pragma unroll
    for (int i = 0; i < CPW; ++i) {
      const int lc = warp + NWARPS * i, col = col_base + lc;
      if (col >= C) continue;  // warp-uniform
      const int cctx = min(c0 + col, ctx);
      const int t = t0 + lane;
      float s = -INFINITY;
      if (t < cctx) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < HD; ++d) dot = fmaf(q_s[lc][d], k_s[lane][d], dot);
        s = dot * scale;
      }
      const float m_tile = warp_max(s);
      if (m_tile == -INFINITY) continue;  // tile wholly past this column
      const float m_new = fmaxf(m[i], m_tile);
      const float p = t < cctx ? expf(s - m_new) : 0.f;
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + warp_sum(p);
#pragma unroll
      for (int j = 0; j < DPL; ++j) acc[i][j] *= corr;
      const int n_valid = min(TILE, cctx - t0);
      for (int r = 0; r < n_valid; ++r) {
        const float pr = __shfl_sync(FULL, p, r);
#pragma unroll
        for (int j = 0; j < DPL; ++j)
          acc[i][j] = fmaf(pr, v_s[r][lane + 32 * j], acc[i][j]);
      }
      m[i] = m_new;
    }
  }

#pragma unroll
  for (int i = 0; i < CPW; ++i) {
    const int col = col_base + warp + NWARPS * i;
    if (col >= C) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    T* o = out + (((size_t)b * C + col) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[lane + 32 * j] = from_f32<T>(acc[i][j] * inv);
  }

  if (APPEND) {
    // the append itself: one slot per (row, head) in each pool, after
    // every read of this block (the block never reads that slot: the tail
    // token came from k_new/v_new above)
    const size_t dst =
        (((size_t)slot_blocks[b] * BS + slot_offsets[b]) * H + h) * HD;
    const size_t src = ((size_t)b * H + h) * HD;
    for (int d = tid; d < HD; d += NWARPS * 32) {
      k_pool[dst + d] = k_new[src + d];
      v_pool[dst + d] = v_new[src + d];
    }
  }
}

template <typename T, bool APPEND>
int launch(const void* q, void* k_pool, void* v_pool, const void* k_new,
           const void* v_new, void* out, const void* block_tables,
           const void* c0, const void* cl, const void* slot_blocks,
           const void* slot_offsets, int B, int C, int H, int hd, int BS,
           int NBT, float scale, void* stream) {
  const dim3 grid(B, H, (C + CG - 1) / CG);
  const dim3 block(NWARPS * 32);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define PW_LAUNCH(HD)                                                       \
  paged_attention_kernel<T, HD, APPEND><<<grid, block, 0, s>>>(             \
      static_cast<const T*>(q), static_cast<T*>(k_pool),                    \
      static_cast<T*>(v_pool), static_cast<const T*>(k_new),                \
      static_cast<const T*>(v_new), static_cast<T*>(out),                   \
      static_cast<const int*>(block_tables), static_cast<const int*>(c0),   \
      static_cast<const int*>(cl), static_cast<const int*>(slot_blocks),    \
      static_cast<const int*>(slot_offsets), C, H, BS, NBT, scale)
  switch (hd) {
    case 32: PW_LAUNCH(32); break;
    case 64: PW_LAUNCH(64); break;
    case 128: PW_LAUNCH(128); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PW_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Returns cudaGetLastError().
extern "C" int pw_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, void* out,
                                  const void* block_tables, const void* c0,
                                  const void* cl, int B, int C, int H, int hd,
                                  int BS, int NBT, int dtype, float scale,
                                  void* stream) {
  void* kp = const_cast<void*>(k_pool);
  void* vp = const_cast<void*>(v_pool);
  if (dtype == 0)
    return launch<float, false>(q, kp, vp, nullptr, nullptr, out,
                                block_tables, c0, cl, nullptr, nullptr, B, C,
                                H, hd, BS, NBT, scale, stream);
  return launch<__nv_bfloat16, false>(q, kp, vp, nullptr, nullptr, out,
                                      block_tables, c0, cl, nullptr, nullptr,
                                      B, C, H, hd, BS, NBT, scale, stream);
}

// C = 1; c0 == cl (the consecutive form at one query column).
extern "C" int pw_paged_append_attend(const void* q, const void* k_new,
                                      const void* v_new, void* k_pool,
                                      void* v_pool, void* out,
                                      const void* block_tables, const void* cl,
                                      const void* slot_blocks,
                                      const void* slot_offsets, int B, int H,
                                      int hd, int BS, int NBT, int dtype,
                                      float scale, void* stream) {
  if (dtype == 0)
    return launch<float, true>(q, k_pool, v_pool, k_new, v_new, out,
                               block_tables, cl, cl, slot_blocks, slot_offsets,
                               B, 1, H, hd, BS, NBT, scale, stream);
  return launch<__nv_bfloat16, true>(q, k_pool, v_pool, k_new, v_new, out,
                                     block_tables, cl, cl, slot_blocks,
                                     slot_offsets, B, 1, H, hd, BS, NBT, scale,
                                     stream);
}
