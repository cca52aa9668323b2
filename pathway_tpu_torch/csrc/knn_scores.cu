// KNN scores for Hopper (sm_90a): out (Q, N) = queries (Q, d) . matrix (N, d)^T.
//
// Replaces the Pallas TPU kernel _scores_kernel of
// pathway_tpu/ops/knn_pallas.py (launched by pallas_scores, public
// knn_topk).  Inputs and accumulation stay float32, as the TPU kernel keeps
// them on purpose so scores match the host path (knn_pallas.py:45-46); the
// products are plain f32 FMAs.  No TF32, and no 3xTF32 split either: TF32
// keeps 10 mantissa bits, and the split's error is not f32's, while the
// index's top-k must equal the plain f32 scores' apart from exact ties.
// cos normalisation, the l2sq terms and top-k stay outside the kernel, as
// they stay outside the Pallas kernel.
//
// What bounds it on the H100.  A batch of Q queries against an N x d
// matrix does 2*Q*N*d flops over (Q + N) * d * 4 + Q * N * 4 bytes.  At
// Q = 64, N = 16384, d = 384 that is 805 MFLOP, 12.0 us at the 67 TFLOP/s
// of f32 FMA outside the tensor cores, against 7.5 us for the 25 MB
// matrix: bound by operations.  At Q = 1 (one query's latency) it is 12.6
// MFLOP against the same 25 MB: bound by bytes, 7.5 us.
//
// What the design does about it: two variants behind one wrapper, which
// picks by Q.
//
// Q >= 16 (pw_knn_scores_gemm): a register-blocked SIMT GEMM.  A block
// computes a 64-query x 128-row tile (N = 16384: 128 blocks, one wave on
// 132 SMs, each matrix row read once); its 256 threads each own 8 x 4
// outputs (rows ty + 8i, columns tx + 32j).  Slices of 32 along d of both
// operands are copied into shared memory by 16-byte cp.async (one row
// pointer and stride per thread) in a ring of 3 stages, so two slices are
// in flight while one is computed.  The tiles stay K-major (d contiguous,
// as in device memory), rows padded to 36 floats, and are read with
// 16-byte loads of 4 consecutive d: each query float read from shared
// memory feeds 4 FMAs, each matrix float 8, and the reads of a warp fall
// on distinct banks.  The FMAs go one d at a time across all 32 outputs,
// so that consecutive FMAs do not wait on each other; each output still
// sums d in order.
//
// Q < 16 (pw_knn_scores_gemv): a streaming GEMV.  The queries sit in
// shared memory (in chunks of 512 along d); each warp walks 4 matrix rows
// with coalesced 16-byte loads (4 independent rows in flight per lane),
// keeps Q x 4 dot products in registers and reduces them across the warp
// at the end.  A block of 8 warps takes 32 rows: 512 blocks at N = 16384,
// all resident at once on 132 SMs.
//
// Both take any d and ragged Q and N: the 16-byte path runs when d % 4 ==
// 0 and both operands start on 16-byte boundaries; otherwise the same
// loops copy and read single floats (the masked scalar path).  Elements
// past Q, N or d are zero-filled by the copies and never written.
//
// Registers and spills (nvcc -Xptxas -v, sm_90a, CUDA 12.8; printed by
// chip_smoke.py phase 1) and shared memory:
//   knn_gemm_kernel<16-byte path / scalar path>: 128 / 128 regs, 0 spills,
//     82,944 B dynamic shared memory (3 x (64 + 128) x 36 floats)
//   knn_gemv_kernel<queries, 16-byte path / scalar path>: <1> 48 / 32
//     regs (the scalar one spills 8 B), <4> 64 / 48, <15> 106 / 97; static
//     shared memory 2,048 / 8,192 / 30,720 B

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// devices a process may launch on: the per-device attribute opt-ins
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// async copies global -> shared; src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
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

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// ---- Q >= 16: register-blocked GEMM ---------------------------------------

namespace gemm {

constexpr int BM = 64, BN = 128, BK = 32, STAGES = 3, NT = 256;
constexpr int LDS = BK + 4;  // row pitch in floats: 8 consecutive rows
                             // read at one d fall on distinct banks
constexpr size_t SMEM = (size_t)STAGES * (BM + BN) * LDS * sizeof(float);

// Copy ROWS rows (r0 + r) x BK floats (k0 + c) of a row-major (n_rows, d)
// operand into dst[r * LDS + c]; zeros past n_rows or d.  16-byte path:
// thread t moves 4 floats at column 4 (t % 8) of rows t / 8 + 32 j, so
// its addresses are one row pointer plus j strides.
template <int ROWS, bool VEC>
__device__ __forceinline__ void load_slice(float* dst, const float* src,
                                           int n_rows, int d, int r0,
                                           int k0) {
  if (VEC) {
    constexpr int CPR = BK / 4, RS = NT / CPR;  // chunks a row; row step
    const int r = threadIdx.x / CPR, c = 4 * (threadIdx.x % CPR);
    const bool kin = k0 + c < d;  // d % 4 == 0
    const float* g = src + (size_t)(r0 + r) * d + k0 + c;
#pragma unroll
    for (int j = 0; j < ROWS / RS; ++j) {
      const bool in = kin && r0 + r + j * RS < n_rows;
      cp_async16(dst + (r + j * RS) * LDS + c,
                 in ? g + (size_t)j * RS * d : src, in ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < ROWS * BK; i += NT) {
      const int r = i / BK, c = i % BK;
      const bool in = r0 + r < n_rows && k0 + c < d;
      cp_async4(dst + r * LDS + c,
                in ? src + (size_t)(r0 + r) * d + k0 + c : src, in ? 4 : 0);
    }
  }
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
knn_gemm_kernel(const float* __restrict__ q, const float* __restrict__ m,
                float* __restrict__ out, int Q, int N, int d) {
  extern __shared__ float4 smem4[];
  float* sA = reinterpret_cast<float*>(smem4);  // [STAGES][BM][LDS]
  float* sB = sA + STAGES * BM * LDS;           // [STAGES][BN][LDS]
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  // a warp is 4 row groups x 8 column groups: its 16-byte shared reads
  // touch 4 (queries) and 8 (matrix rows) consecutive padded rows
  const int ty = (warp >> 2) * 4 + (lane >> 3);  // rows ty + 8i
  const int tx = (warp & 3) * 8 + (lane & 7);    // columns tx + 32j

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  const int ns = (d + BK - 1) / BK;
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < ns) {
      load_slice<BM, VEC>(sA + s * BM * LDS, q, Q, d, row0, s * BK);
      load_slice<BN, VEC>(sB + s * BN * LDS, m, N, d, col0, s * BK);
    }
    cp_commit();
  }
  for (int kt = 0; kt < ns; ++kt) {
    cp_wait<STAGES - 2>();  // slice kt has landed
    __syncthreads();        // ... for every thread; slice kt - 1 is consumed
    const int nx = kt + STAGES - 1;
    if (nx < ns) {
      load_slice<BM, VEC>(sA + (nx % STAGES) * BM * LDS, q, Q, d, row0,
                          nx * BK);
      load_slice<BN, VEC>(sB + (nx % STAGES) * BN * LDS, m, N, d, col0,
                          nx * BK);
    }
    cp_commit();
    const float* a = sA + (kt % STAGES) * BM * LDS;
    const float* bm = sB + (kt % STAGES) * BN * LDS;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 4) {
      float4 av[8], bv[4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        av[i] = *reinterpret_cast<const float4*>(a + (ty + 8 * i) * LDS + kk);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        bv[j] =
            *reinterpret_cast<const float4*>(bm + (tx + 32 * j) * LDS + kk);
      // one d at a time across all 32 outputs: consecutive FMAs are
      // independent, where an output's 4 FMAs in a row would wait on each
      // other (each output still sums d in order)
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = row0 + ty + 8 * i;
    if (r >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 32 * j;
      if (c < N) out[(size_t)r * N + c] = acc[i][j];
    }
  }
}

template <bool VEC>
int launch(const float* q, const float* m, float* out, int Q, int N, int d,
           cudaStream_t stream) {
  // cudaFuncSetAttribute applies to the current device (the launch makes
  // the tensors' device current): opted in once per device
  static bool attr_set[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || !attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        knn_gemm_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_set[dev] = true;
  }
  const dim3 grid((N + BN - 1) / BN, (Q + BM - 1) / BM);
  knn_gemm_kernel<VEC><<<grid, NT, SMEM, stream>>>(q, m, out, Q, N, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemm

// ---- Q < 16: streaming GEMV ------------------------------------------------

namespace gemv {

constexpr int NT = 256, RW = 4;     // threads; matrix rows per warp
constexpr int RB = (NT / 32) * RW;  // matrix rows per block
constexpr int DCH = 512;            // query floats staged per chunk of d

template <int QB, bool VEC>
__global__ void __launch_bounds__(NT)
knn_gemv_kernel(const float* __restrict__ q, const float* __restrict__ m,
                float* __restrict__ out, int Q, int N, int d) {
  __shared__ __align__(16) float sq[QB * DCH];  // [QB][DCH]
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n0 = blockIdx.x * RB + warp * RW;  // the warp's first row
  const float* mr[RW];
  bool live[RW];
#pragma unroll
  for (int r = 0; r < RW; ++r) {
    live[r] = n0 + r < N;
    mr[r] = m + (size_t)(live[r] ? n0 + r : 0) * d;
  }
  float acc[QB][RW];
#pragma unroll
  for (int qi = 0; qi < QB; ++qi)
#pragma unroll
    for (int r = 0; r < RW; ++r) acc[qi][r] = 0.f;

  for (int c0 = 0; c0 < d; c0 += DCH) {  // uniform across the block
    const int len = min(DCH, d - c0);
    __syncthreads();  // the previous chunk is consumed
    for (int i = threadIdx.x; i < Q * DCH; i += NT) {
      const int qi = i / DCH, c = i % DCH;
      sq[qi * DCH + c] = c < len ? q[(size_t)qi * d + c0 + c] : 0.f;
    }
    __syncthreads();
    if (VEC) {  // len % 4 == 0
#pragma unroll 2
      for (int c = 4 * lane; c < len; c += 128) {
        float4 mv[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r)
          mv[r] = live[r] ? __ldg(reinterpret_cast<const float4*>(
                                mr[r] + c0 + c))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) {
          if (qi >= Q) break;
          const float4 qv =
              *reinterpret_cast<const float4*>(sq + qi * DCH + c);
#pragma unroll
          for (int r = 0; r < RW; ++r) {
            acc[qi][r] = fmaf(qv.x, mv[r].x, acc[qi][r]);
            acc[qi][r] = fmaf(qv.y, mv[r].y, acc[qi][r]);
            acc[qi][r] = fmaf(qv.z, mv[r].z, acc[qi][r]);
            acc[qi][r] = fmaf(qv.w, mv[r].w, acc[qi][r]);
          }
        }
      }
    } else {
      for (int c = lane; c < len; c += 32) {
        float mv[RW];
#pragma unroll
        for (int r = 0; r < RW; ++r)
          mv[r] = live[r] ? __ldg(mr[r] + c0 + c) : 0.f;
#pragma unroll
        for (int qi = 0; qi < QB; ++qi) {
          if (qi >= Q) break;
          const float qv = sq[qi * DCH + c];
#pragma unroll
          for (int r = 0; r < RW; ++r)
            acc[qi][r] = fmaf(qv, mv[r], acc[qi][r]);
        }
      }
    }
  }

#pragma unroll
  for (int qi = 0; qi < QB; ++qi) {
    if (qi >= Q) break;
#pragma unroll
    for (int r = 0; r < RW; ++r) {
      float v = acc[qi][r];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == 0 && live[r]) out[(size_t)qi * N + n0 + r] = v;
    }
  }
}

template <int QB>
int launch(const float* q, const float* m, float* out, int Q, int N, int d,
           bool vec, cudaStream_t stream) {
  const dim3 grid((N + RB - 1) / RB);
  if (vec)
    knn_gemv_kernel<QB, true><<<grid, NT, 0, stream>>>(q, m, out, Q, N, d);
  else
    knn_gemv_kernel<QB, false><<<grid, NT, 0, stream>>>(q, m, out, Q, N, d);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace gemv

}  // namespace

// Q >= 16.  Returns cudaGetLastError().
extern "C" int pw_knn_scores_gemm(const void* q, const void* m, void* out,
                                  int Q, int N, int d, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* mf = static_cast<const float*>(m);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (d % 4 == 0 && aligned16(q) && aligned16(m))
    return gemm::launch<true>(qf, mf, of, Q, N, d, s);
  return gemm::launch<false>(qf, mf, of, Q, N, d, s);
}

// 1 <= Q < 16.  Returns cudaGetLastError().
extern "C" int pw_knn_scores_gemv(const void* q, const void* m, void* out,
                                  int Q, int N, int d, void* stream) {
  const float* qf = static_cast<const float*>(q);
  const float* mf = static_cast<const float*>(m);
  float* of = static_cast<float*>(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q < 1 || Q > 15) return static_cast<int>(cudaErrorInvalidValue);
  const bool vec = d % 4 == 0 && aligned16(m);
  if (Q == 1) return gemv::launch<1>(qf, mf, of, Q, N, d, vec, s);
  if (Q <= 4) return gemv::launch<4>(qf, mf, of, Q, N, d, vec, s);
  return gemv::launch<15>(qf, mf, of, Q, N, d, vec, s);
}
