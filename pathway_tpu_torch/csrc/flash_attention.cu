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
// at T = 1024, hd = 64, causal, 1.6 GFLOP over 6.3 MB -- 1.6 us at the
// bf16 tensor cores' 989 TFLOP/s, 1.9 us at 3.35 TB/s.  Both are far
// below what a launch of 192 short-lived blocks takes, so what limits a
// kernel here is latency: the copies it leaves exposed, the instructions
// between two tensor-core products, and how many SMs have work.  On the
// CUDA cores in f32 (67 TFLOP/s) the same work cannot go below ~24 us.
//
// bf16: tensor cores (flash_tc_kernel).  Each warp owns 16 query rows; a
// block is 4 row warps (64 rows), or 2 (32 rows) when 64-row tiles would
// leave SMs idle (fewer than 132 blocks: the T = 256 bucket is 48 blocks
// of 64 rows but 96 of 32), times 2 key groups.  Heaviest (last, under
// the causal mask) query tiles of every head launch first.
//  - Latency, not the product rate, bounds a call of this size: the
//    heaviest 64-row tile at T = 1024 walks 16 key tiles one after
//    another.  So the block's key tiles are dealt to 2 key groups of
//    warps (tiles j, j + 2, ...), each with its own copy ring and named
//    barrier, and the two (m, l, O) states are merged at the end by the
//    online softmax's own rule: half the chain.  (Splitting a tile's keys
//    across blocks, with a merge through device memory, was measured and
//    lost at H = 12, where SMs are already busy; 128-key tiles and 4 key
//    groups did not help either.)
//  - The Q tile is copied once by cp.async and held in registers as mma
//    A fragments (ldmatrix) for the whole key loop.
//  - K and V tiles of 64 keys stay bf16 in shared memory, rows padded by
//    16 bytes so that ldmatrix reads them without bank conflicts, in a
//    ring of 2 stages filled by 16-byte cp.async (one base address and
//    stride per thread): the next tile is in flight while this one is
//    computed, one barrier per tile.
//  - S = QK^T and O += PV are mma.sync.m16n8k16 bf16 products with f32
//    accumulators (K fragments by ldmatrix, V by ldmatrix.trans).
//  - The online softmax runs on the accumulator fragments: row max as a
//    tree and across the 4 lanes of a quad by shuffles, p = 2^(s * log2e /
//    sqrt(hd) - m) on the special-function unit (ex2.approx: p is rounded
//    to bf16 next), l sums the unrounded p, and p is packed to bf16 pairs
//    that are directly the A fragments of the PV product (no shared-memory
//    round trip).  Tiles that straddle T or the diagonal take a masked
//    instantiation of the step; the others carry no mask arithmetic; key
//    tiles wholly above the diagonal are never copied, and a warp skips
//    a tile none of its rows can see.
//  - q, k and v are read in place through their (batch, token, head)
//    strides, so the prefill's chunk(3) views of the fused QKV product go
//    in without a copy; rows past T are zero-filled by the copy and never
//    written.  The output goes through the warp's own rows of the Q tile
//    to 16-byte stores.
//  - mma.sync rather than wgmma: at 1.6 GFLOP the product rate is not what
//    bounds the call (above), and 16-row warp tiles keep the T = 256 grid
//    full, where wgmma's 64-row warpgroup tiles would not.
//
// f32: CUDA cores (flash_kernel).  The tensor cores take f32 only as
// TF32, whose 10-bit mantissa breaks the f32 tolerance (1e-4) and the f32
// token-identity checks against the dense einsum path, so f32 keeps the
// CUDA-core kernel: one block per 64-row query tile, each thread a 4 x 8
// score block and a 4 x hd/8 output block, tiles converted to f32 in
// shared memory.  f32 serves the checks; the main path runs bf16.
//
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8; printed by
// chip_smoke.py phase 1) and dynamic shared memory (from the tile sizes):
//   flash_tc_kernel<hd, row warps, key groups>
//     <32, 4, 2>   93 regs, 0 spills,  46,080 B    <32, 2, 2>   96, 0, 43,520
//     <64, 4, 2>  189 regs, 0 spills,  82,944 B    <64, 2, 2>  153, 0, 78,336
//     <128, 4, 2> 213 regs, 0 spills, 156,672 B    <128, 2, 2> 213, 0, 147,968
//   flash_kernel<float, hd>: <32> 95 regs, <64> 128, <128> 168; 0 spills;
//     (3 * 64 * hd + 64 * 64) * 4 B dynamic shared memory

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// devices a process may launch on: the per-device attribute opt-ins
constexpr int kMaxDevices = 64;

constexpr int BQ = 64;       // query rows per block
constexpr int BK = 64;       // keys per tile
constexpr int NT = 128;      // threads: 16 row groups x 8 key/dim groups
constexpr float NEG = -1e30f;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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
  // cudaFuncSetAttribute applies to the current device (the launch makes
  // the tensors' device current): opted in once per device
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const dim3 grid((T_len + BQ - 1) / BQ, H, B);
  flash_kernel<T, HD><<<grid, NT, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), T_len, H, st[0], st[1],
      st[2], st[3], st[4], st[5], st[6], st[7], st[8], causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_core(const void* q, const void* k, const void* v, void* out,
                int B, int T_len, int H, int hd, const long long* st,
                int causal, float scale, cudaStream_t stream) {
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

// ---- bf16 on the tensor cores --------------------------------------------

namespace tc {

constexpr int BK = 64;  // keys per tile

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte async copy global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two f32 -> one register of bf16 (round to nearest even), lo in bits 0-15
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// 2^x on the special-function unit (the accurate exp2f is a longer
// sequence; p is rounded to bf16 right after, so its ~2 ulp do not show)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barrier over the NT threads of one key group (ids 1, 2, ...)
__device__ __forceinline__ void group_sync(int id, int nt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nt));
}

// Copy ROWS rows of HD bf16, row r at src + r * st (r < n_rows; rows past
// it are zero-filled), into shared memory with row pitch HD + 8, by the NT
// threads t = 0 .. NT - 1.  Each thread moves one 16-byte column chunk of
// every (NT / chunks-per-row)-th row, so its addresses are one base and
// one stride.
template <int HD, int ROWS, int NT>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long st, int n_rows, int t) {
  constexpr int CPR = HD / 8, LD = HD + 8;
  constexpr int RS = NT / CPR;  // rows between one thread's chunks
  const int r = t / CPR, c = t % CPR;
  const __nv_bfloat16* g = src + r * st + c * 8;
  __nv_bfloat16* d = dst + r * LD + c * 8;
#pragma unroll
  for (int j = 0; j < (ROWS + RS - 1) / RS; ++j) {
    if (ROWS % RS == 0 || r + j * RS < ROWS) {
      const bool in = r + j * RS < n_rows;
      cp_async16(d + j * RS * LD, in ? g + j * RS * st : src, in ? 16 : 0);
    }
  }
}

// One key tile of one warp: S = Q K^T on the tensor cores, the online
// softmax on the accumulator fragments, O += P V.  MASK: the tile
// straddles T or the diagonal, so keys past T or past a row are masked.
template <int HD, bool MASK>
__device__ __forceinline__ void tile_step(
    const uint32_t (&qf)[HD / 16][4], const __nv_bfloat16* cK,
    const __nv_bfloat16* cV, float (&o)[HD / 8][4], float (&m)[2],
    float (&l)[2], int k0, int r0, int r1, int T_len, int causal,
    float scale_log2, int lane) {
  constexpr int LD = HD + 8, KS = HD / 16, NS = BK / 8, NO = HD / 8;
  const int tq = lane & 3;
  float s[NS][4];
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
    for (int nn = 0; nn < NS / 2; ++nn) {
      uint32_t kf[4];  // keys 16nn..16nn+15, dims 16ks..16ks+15
      ldsm_x4(kf, cK + (16 * nn + (lane & 7) + ((lane >> 4) << 3)) * LD +
                      16 * ks + ((lane >> 3) & 1) * 8);
      mma_bf16(s[2 * nn], qf[ks], kf[0], kf[1]);
      mma_bf16(s[2 * nn + 1], qf[ks], kf[2], kf[3]);
    }
  }
  // masked scores -1e30, the row max over the quad, in log2 units after
  // the scale: max(s) * scale = max(s * scale) for scale > 0
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * tq + (e & 1);
        const int row = e < 2 ? r0 : r1;
        if (key >= T_len || (causal && key > row)) s[j][e] = NEG;
      }
  }
  float mx[2], mn[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[NS];  // the lane's max of the row, as a tree
#pragma unroll
    for (int j = 0; j < NS; ++j) t[j] = fmaxf(s[j][2 * i], s[j][2 * i + 1]);
#pragma unroll
    for (int w = NS / 2; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    mx[i] = t[0];
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(FULL, mx[i], 2));
    mn[i] = fmaxf(m[i], mx[i] == NEG ? NEG : mx[i] * scale_log2);
    const float corr = fast_exp2(m[i] - mn[i]);
    m[i] = mn[i];
    l[i] *= corr;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * i] *= corr;
      o[n][2 * i + 1] *= corr;
    }
  }
  uint32_t pf[BK / 16][4];  // P as the A fragments of the PV product
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked p is exactly 0: 2^-inf, never 2^(-1e30 - m) with m = -1e30
      const float x = fmaf(s[j][e], scale_log2, -mn[e >> 1]);
      p[e] = fast_exp2(MASK && s[j][e] == NEG ? -INFINITY : x);
    }
    l[0] += p[0] + p[1];  // the unrounded p
    l[1] += p[2] + p[3];
    pf[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);      // row g
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);  // row g + 8
  }
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk) {
#pragma unroll
    for (int nn = 0; nn < NO / 2; ++nn) {
      uint32_t vf[4];  // keys 16kk..16kk+15, dims 16nn..16nn+15
      ldsm_x4_trans(vf, cV + (16 * kk + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                 LD +
                            16 * nn + (lane >> 4) * 8);
      mma_bf16(o[2 * nn], pf[kk], vf[0], vf[1]);
      mma_bf16(o[2 * nn + 1], pf[kk], vf[2], vf[3]);
    }
  }
}

// The online softmax state of one warp's 16 rows, lane by lane: m and l
// of its two rows (l: this lane's partial sum), then its O fragments;
// value i of a lane at th[32 * i].
template <int NO>
__device__ __forceinline__ void store_state(float* th, const float (&m)[2],
                                            const float (&l)[2],
                                            const float (&o)[NO][4]) {
  th[0] = m[0];
  th[32] = m[1];
  th[64] = l[0];
  th[96] = l[1];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) th[(4 + 4 * n + e) * 32] = o[n][e];
}

// Merge a stored state into (m, l, O): m the larger, each side scaled by
// 2^(its m - m).
template <int NO>
__device__ __forceinline__ void merge_state(float (&m)[2], float (&l)[2],
                                            float (&o)[NO][4],
                                            const float* th) {
  auto ld = [th](int i) { return th[32 * i]; };
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float mj = ld(i);
    const float mt = fmaxf(m[i], mj);
    const float c0 = fast_exp2(m[i] - mt), c1 = fast_exp2(mj - mt);
    m[i] = mt;
    l[i] = l[i] * c0 + ld(2 + i) * c1;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * i] = o[n][2 * i] * c0 + ld(4 + 4 * n + 2 * i) * c1;
      o[n][2 * i + 1] = o[n][2 * i + 1] * c0 + ld(5 + 4 * n + 2 * i) * c1;
    }
  }
}

// Block: NW row warps (16 query rows each) x KG key groups.  Key group j
// walks key tiles j, j + KG, ... of the block's visible range with its own
// 2-stage ring and named barrier; at the end the groups' (m, l, O) are
// merged through shared memory (the online softmax's own merge rule), so
// the longest chain of dependent tiles is 1/KG of the block's.
template <int HD, int NW, int KG>
__global__ void __launch_bounds__(32 * NW * KG)
flash_tc_kernel(const __nv_bfloat16* __restrict__ q,
                const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v,
                __nv_bfloat16* __restrict__ out, int T_len, int H, int B,
                long long q_sb, long long q_st, long long q_sh, long long k_sb,
                long long k_st, long long k_sh, long long v_sb, long long v_st,
                long long v_sh, int causal, float scale_log2) {
  constexpr int NTG = 32 * NW, BQ = 16 * NW, LD = HD + 8;
  constexpr int KS = HD / 16;    // k-steps of QK^T
  constexpr int NO = HD / 8;     // 8-wide column tiles of O
  constexpr int TILE = BK * LD;  // elements of one K (or V) tile
  extern __shared__ uint4 smem_u4[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_u4);  // [BQ][LD]
  __nv_bfloat16* ring = sQ + BQ * LD;  // [KG][2 stages][K, V][BK][LD]

  // grid: one block per (query tile, head, batch row), heaviest (last,
  // under the causal mask) query tiles of every head first
  const int nq = (T_len + BQ - 1) / BQ;
  const int hb = blockIdx.x % (H * B);
  const int q0 = (nq - 1 - blockIdx.x / (H * B)) * BQ;
  const int h = hb % H, b = hb / H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rw = warp % NW, grp = warp / NW;  // row warp, key group
  const int gt = threadIdx.x % NTG;           // thread within the group
  const int g = lane >> 2, tq = lane & 3;     // fragment row / column pair
  const int w0 = q0 + 16 * rw;                // the warp's first query row
  const int r0 = w0 + g, r1 = w0 + g + 8;     // the two rows this lane holds

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;

  const int nk_all = (T_len + BK - 1) / BK;
  // causal: key tiles starting past the block's last row are invisible
  const int nk = causal ? min(nk_all, (q0 + BQ - 1) / BK + 1) : nk_all;
  __nv_bfloat16* gring = ring + grp * 4 * TILE;  // this group's 2 stages

  // cp.async groups per thread: {Q share}, then one per K/V tile
  load_rows<HD, BQ, NTG * KG>(sQ, qb + q0 * q_st, q_st, T_len - q0,
                              threadIdx.x);
  cp_commit();
  if (grp < nk) {
    load_rows<HD, BK, NTG>(gring, kb + grp * BK * k_st, k_st,
                           T_len - grp * BK, gt);
    load_rows<HD, BK, NTG>(gring + TILE, vb + grp * BK * v_st, v_st,
                           T_len - grp * BK, gt);
  }
  cp_commit();
  cp_wait<1>();  // this thread's share of Q has landed
  __syncthreads();
  uint32_t qf[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
    ldsm_x4(qf[ks], sQ + (16 * rw + (lane & 15)) * LD + 16 * ks +
                        (lane >> 4) * 8);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this lane's partial sums

  for (int it = 0, kt = grp; kt < nk; ++it, kt += KG) {
    cp_wait<0>();               // this tile's K and V have landed ...
    group_sync(1 + grp, NTG);   // ... for the whole group, which is done
                                // with the previous tile's stage
    const int k0 = kt * BK;
    if (kt + KG < nk) {  // the group's next tile, in flight during this one
      __nv_bfloat16* nK = gring + ((it & 1) ^ 1) * 2 * TILE;
      const int k1 = k0 + KG * BK;
      load_rows<HD, BK, NTG>(nK, kb + k1 * k_st, k_st, T_len - k1, gt);
      load_rows<HD, BK, NTG>(nK + TILE, vb + k1 * v_st, v_st, T_len - k1,
                             gt);
    }
    cp_commit();
    const __nv_bfloat16* cK = gring + (it & 1) * 2 * TILE;
    // a warp whose rows all lie above this tile's first key skips it
    if (causal && k0 > w0 + 15) continue;
    if (k0 + BK > T_len || (causal && k0 + BK - 1 > w0))
      tile_step<HD, true>(qf, cK, cK + TILE, o, m, l, k0, r0, r1, T_len,
                          causal, scale_log2, lane);
    else
      tile_step<HD, false>(qf, cK, cK + TILE, o, m, l, k0, r0, r1, T_len,
                           causal, scale_log2, lane);
  }

  // merge the key groups into group 0: O = sum_j O_j 2^(m_j - m), likewise
  // l, with m the largest m_j; the ring is free once every group is done
  if (KG > 1) {
    constexpr int NV = 4 + NO * 4;  // floats of a lane's stored state
    float* xch = reinterpret_cast<float*>(ring);  // [KG-1][NW][NV][32]
    __syncthreads();
    if (grp > 0)
      store_state<NO>(xch + ((grp - 1) * NW + rw) * NV * 32 + lane, m, l, o);
    __syncthreads();
    if (grp > 0) return;
#pragma unroll
    for (int j = 1; j < KG; ++j)
      merge_state<NO>(m, l, o, xch + ((j - 1) * NW + rw) * NV * 32 + lane);
  }

  // epilogue: the quad's full row sums, then through the warp's own rows
  // of the Q tile (read only by this warp, before the loop) to 16-byte
  // stores
  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(FULL, l[i], 1);
    l[i] += __shfl_xor_sync(FULL, l[i], 2);
    inv[i] = 1.f / fmaxf(l[i], 1e-20f);
  }
  __nv_bfloat16* sO = sQ + 16 * rw * LD;
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(sO + g * LD + 8 * n + 2 * tq) =
        pack_bf16(o[n][0] * inv[0], o[n][1] * inv[0]);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * LD + 8 * n + 2 * tq) =
        pack_bf16(o[n][2] * inv[1], o[n][3] * inv[1]);
  }
  __syncwarp();
  // out is (B, T, H, HD), contiguous
#pragma unroll
  for (int i = lane; i < 16 * NO; i += 32) {
    const int r = i / NO, c = i % NO;
    const int row = w0 + r;
    if (row < T_len)
      *reinterpret_cast<uint4*>(out + (((long long)b * T_len + row) * H + h) *
                                          HD + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c * 8);
  }
}

template <int HD, int NW, int KG>
int launch_nw(const void* q, const void* k, const void* v, void* out, int B,
              int T_len, int H, const long long* st, int causal, float scale,
              cudaStream_t stream) {
  constexpr int BQ = 16 * NW, LD = HD + 8;
  constexpr size_t smem =
      (size_t)(BQ + KG * 4 * BK) * LD * sizeof(__nv_bfloat16);
  // cudaFuncSetAttribute applies to the current device (the launch makes
  // the tensors' device current): opted in once per device
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_tc_kernel<HD, NW, KG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const long long blocks = (long long)((T_len + BQ - 1) / BQ) * H * B;
  flash_tc_kernel<HD, NW, KG><<<(unsigned)blocks, 32 * NW * KG, smem,
                                 stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      T_len, H, B, st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7],
      st[8], causal, scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// 64-row blocks when they fill the card's 132 SMs, else 32-row blocks;
// two key groups either way
template <int HD>
int launch_hd(const void* q, const void* k, const void* v, void* out, int B,
              int T_len, int H, const long long* st, int causal, float scale,
              cudaStream_t stream) {
  const long long blocks64 = (long long)((T_len + 63) / 64) * H * B;
  if (blocks64 >= 132)
    return launch_nw<HD, 4, 2>(q, k, v, out, B, T_len, H, st, causal, scale,
                               stream);
  return launch_nw<HD, 2, 2>(q, k, v, out, B, T_len, H, st, causal, scale,
                             stream);
}

}  // namespace tc

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
  if (dtype == 0)  // f32: the CUDA-core kernel
    return launch_core<float>(q, k, v, out, B, T_len, H, hd, st, causal,
                              scale, s);
  switch (hd) {  // bf16: the tensor-core kernel
    case 32:
      return tc::launch_hd<32>(q, k, v, out, B, T_len, H, st, causal, scale,
                               s);
    case 64:
      return tc::launch_hd<64>(q, k, v, out, B, T_len, H, st, causal, scale,
                               s);
    case 128:
      return tc::launch_hd<128>(q, k, v, out, B, T_len, H, st, causal, scale,
                                s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
