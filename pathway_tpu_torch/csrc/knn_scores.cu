// KNN scores for Hopper (sm_90a): out (Q, N) = queries (Q, d) . matrix (N, d)^T.
//
// Replaces the Pallas TPU kernel _scores_kernel of
// pathway_tpu/ops/knn_pallas.py (launched by pallas_scores, public
// knn_topk).  Inputs and accumulation stay float32, as the TPU kernel keeps
// them on purpose so scores match the host path; the products are plain
// f32 FMAs, not TF32.  cos normalisation, the l2sq terms and top-k stay
// outside the kernel, as they stay outside the Pallas kernel.
//
// What bounds it on the H100.  A batch of Q queries against an N x d
// index does 2*Q*N*d flops over (Q + N) * d * 4 + Q * N * 4 bytes.  At
// the serving shapes (Q up to 64, d 384) that is at most ~32 flop/byte,
// while f32 FMA outside the tensor cores peaks at 67 TFLOP/s: below ~20
// flop/byte memory bounds it, above it the f32 FMA rate does.
//
// What the design does about it.  A classic shared-memory tiled GEMM:
// 64 x 64 output tiles, 16-deep slices of both operands staged in shared
// memory, 256 threads each accumulating a 4 x 4 sub-tile in registers,
// so each matrix row is read from device memory once per 64 queries.
// Ragged Q, N and d are masked at the tile edges (no host-side padding).
// Not yet done: double-buffered (cp.async/TMA) staging and vector loads.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64, BN = 64, BK = 16, THREADS = 256;

__global__ void __launch_bounds__(THREADS)
knn_scores_kernel(const float* __restrict__ q, const float* __restrict__ m,
                  float* __restrict__ out, int Q, int N, int d) {
  __shared__ float a_s[BK][BM + 4];
  __shared__ float b_s[BK][BN + 4];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * BM, col0 = blockIdx.x * BN;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += BK) {
#pragma unroll
    for (int i = 0; i < (BM * BK) / THREADS; ++i) {
      const int idx = threadIdx.x + THREADS * i;
      const int r = idx / BK, kk = idx % BK, gk = k0 + kk;
      const int gq = row0 + r, gn = col0 + r;
      a_s[kk][r] = (gq < Q && gk < d) ? q[(size_t)gq * d + gk] : 0.f;
      b_s[kk][r] = (gn < N && gk < d) ? m[(size_t)gn * d + gk] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = a_s[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = b_s[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= Q) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = col0 + tx + 16 * j;
      if (c < N) out[(size_t)r * N + c] = acc[i][j];
    }
  }
}

}  // namespace

// Returns cudaGetLastError().
extern "C" int pw_knn_scores(const void* q, const void* m, void* out, int Q,
                             int N, int d, void* stream) {
  const dim3 grid((N + BN - 1) / BN, (Q + BM - 1) / BM);
  knn_scores_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(m),
      static_cast<float*>(out), Q, N, d);
  return static_cast<int>(cudaGetLastError());
}
