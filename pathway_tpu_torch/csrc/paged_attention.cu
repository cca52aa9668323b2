// Ragged paged attention and fused decode append+attend for Hopper (sm_90a).
//
// What they compute.  Row b carries C consecutive query columns; column c
// attends to min(c0[b] + c, cl[b]) tokens of the row's context, addressed
// through block_tables[b] into pools laid out (num_blocks, BS, H, hd):
// token t of the row is pool row table[t / BS] * BS + t % BS.  Softmax is
// the online (m, l, acc) recurrence in f32; p is rounded to the pools'
// dtype before the PV product, l sums the unrounded p and is clamped at
// 1e-20.  The append form (C = 1) takes the incoming token's K/V as
// operands: the context's tail token (position cl[b] - 1) is read from them
// instead of the pool, and the kernel writes exactly that one slot per
// (row, head) into each pool, at (slot_blocks[b], slot_offsets[b]) -- the
// scatter the unfused path runs before attention.
//
// What bounds them on the H100.  Decode and chunked prefill at serving
// batch sizes move every context token's K and V once per layer and do
// 4 * hd flops per (query column, token): a few flops per byte, far below
// the ~295 flop/byte where the tensor cores would be the limit.  The bound
// is device-memory bandwidth: at the main path's heaviest calls ~5 MB, 1.5
// to 1.8 us at 3.35 TB/s.  What a kernel of this size is really held to is
// latency: the serial chain of tiles of the longest row (~600 tokens), the
// memory round trips on that chain, and how many SMs have work (B * H = 96
// (row, head) pairs against 132 SMs).
//
// Both kernels split every row's keys into splits of `split` tokens (the
// wrapper's RAGGED_SPLIT / APPEND_SPLIT), one thread block per (row,
// head, [column group,] split).  The number of splits comes from the
// table's width (NBT * BS), which the host knows; a split past its row's
// context exits at once, so the host never reads per-row contexts from the
// card.  A row with one split writes its output directly; otherwise each
// split writes its (m, l, O) partial to the wrapper's scratch, and the
// last split of the row to arrive (an atomic counter per row, which that
// block resets to 0) merges them by the online softmax's own rule (O = sum
// 2^(m_s - m) O_s, likewise l, m the largest m_s) and writes the output.
// So the merge is part of the one launch: no second kernel and no extra
// Python op.
//
// paged_tc_kernel: ragged, bf16, on the tensor cores.  Replaces
// _paged_kernel of pathway_tpu/kvcache/paged_attention.py (launched by
// _paged_ragged_fn, public paged_attention), which carries
// paged_mixed_step: C = 32 columns a row, most of them the padding columns
// of decode rows (computed like any other).
//  - One block holds all of a column group's 32 query columns (C <= 16:
//    16), so the row's K/V is read once per split, not once per 8 columns
//    as before.  Each warp owns 16 columns: their Q is copied once by
//    cp.async and held in registers as mma A fragments.
//  - K/V tiles of 64 tokens stay bf16 in shared memory, gathered through
//    the block table (whose split slice is read once into shared memory)
//    by 16-byte cp.async into rows padded by 16 bytes (ldmatrix without
//    bank conflicts), in a 2-stage ring per key group: the next tile is in
//    flight while this one is computed.
//  - S = QK^T and O += PV are mma.sync.m16n8k16 bf16 products with f32
//    accumulators, the online softmax on the accumulator fragments, as in
//    flash_attention.cu's bf16 kernel.  The per-column mask
//    is applied only on tiles that reach a column's bound; a warp skips a
//    tile none of its columns reaches.
//  - The chain: a split's 4 tiles are dealt to 2 key groups of warps
//    (merged in shared memory at the end), and splits of 256 tokens spread
//    a long row over blocks: the longest chain is 2 tiles plus the merge.
//  - mma.sync rather than wgmma: the product rate is not the limit, and
//    wgmma's 64-row warpgroup tiles would be half empty at C = 32.
// f32 stays on the CUDA cores (paged_f32_kernel: one block per 8 query
// columns walks the row's tokens in tiles staged as f32): the
// tensor cores take f32 only as TF32, whose 10-bit mantissa breaks the f32
// tolerance (1e-4) and the f32 token-identity checks against the dense
// einsum path.  f32 serves the checks; the main path runs bf16.
//
// append_kernel: decode append+attend, C = 1, f32 and bf16, CUDA cores.
// Replaces _append_kernel of pathway_tpu/kvcache/paged_attention.py
// (launched by _paged_append_fn, public paged_append_attend), which
// carries paged_decode_step and paged_chained_decode.  With one query
// column an mma tile would be 15/16 waste, so this is the byte-streaming
// design:
//  - Every warp works.  A token row is 16-byte chunks over hd * size / 16
//    lanes (8 lanes at hd 64 bf16: a warp reads 4 tokens a load); each lane
//    group reduces its dot product by shuffles (3 at hd 64 bf16) and keeps
//    its own (m, l, acc); the groups of a warp merge by shuffles, the
//    warps in shared memory, each by the online softmax's rule.
//  - 4 loads of K and of V per lane are in flight together, and the next
//    round's are issued before this round is computed.
//  - Splits of 128 tokens spread a long row over blocks (the chain above).
//  - The split that holds the tail reads it from k_new/v_new and writes the
//    one slot per (row, head) into each pool, after its own reads; no other
//    block reads that slot.  Rows whose slot is not their tail (a chain's
//    surplus steps, which write the null block) are left as they were:
//    their output is discarded by the engine.
//
// Registers, shared memory and spills of every instantiation: nvcc
// -Xptxas -v, printed by chip_smoke.py phase 1.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// devices a process may launch on: the per-device attribute opt-ins
constexpr int kMaxDevices = 64;

using bf16 = __nv_bfloat16;

// ---- tensor-core building blocks (the bf16 path) -------------------------
//
// Fragment layout (one warp, 16 query rows): lane = 4 * g + tq holds rows g
// and g + 8, columns 8 * n + 2 * tq and + 1 of each 8-wide accumulator tile
// n.  Scores and the running max m are in log2 units (scaled by scale *
// log2(e)); l is the lane's partial row sum, reduced over the quad at the
// end.  flash_attention.cu has the same blocks; each file keeps its own
// copy, because sharing them through a header changed flash's code
// generation (fewer registers, a spill at hd 32) and slowed it.

constexpr float NEG = -1e30f;  // masked score and the empty state's m
constexpr unsigned FULL = 0xffffffffu;
constexpr int KT = 64;  // keys per tile

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
// sequence; where p is rounded to bf16 right after, its ~2 ulp do not show)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// named barrier over the nt threads of one key group (ids 1, 2, ...)
__device__ __forceinline__ void group_sync(int id, int nt) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(nt));
}

// Q rows as the A fragments of S = Q K^T: rows 0..15 of sQ (row pitch LD)
template <int HD>
__device__ __forceinline__ void load_q_frags(uint32_t (&qf)[HD / 16][4],
                                             const bf16* sQ, int lane) {
  constexpr int LD = HD + 8;
#pragma unroll
  for (int ks = 0; ks < HD / 16; ++ks)
    ldsm_x4(qf[ks], sQ + (lane & 15) * LD + 16 * ks + (lane >> 4) * 8);
}

// One key tile of one warp: S = Q K^T on the tensor cores, the online
// softmax on the accumulator fragments, O += P V.  K and V are KT rows of
// HD bf16 with row pitch HD + 8 (16 bytes of padding: ldmatrix reads them
// without bank conflicts).  MASK: key k0 + i is visible to the lane's row
// g only below lim0 and to row g + 8 only below lim1; the other tiles
// carry no mask arithmetic.
template <int HD, bool MASK>
__device__ __forceinline__ void tile_step(
    const uint32_t (&qf)[HD / 16][4], const bf16* cK, const bf16* cV,
    float (&o)[HD / 8][4], float (&m)[2], float (&l)[2], int k0, int lim0,
    int lim1, float scale_log2, int lane) {
  constexpr int LD = HD + 8, KS = HD / 16, NS = KT / 8, NO = HD / 8;
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
  // masked scores NEG, the row max over the quad, in log2 units after
  // the scale: max(s) * scale = max(s * scale) for scale > 0
  if (MASK) {
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + 8 * j + 2 * tq + (e & 1);
        if (key >= (e < 2 ? lim0 : lim1)) s[j][e] = NEG;
      }
  }
  float mn[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float t[NS];  // the lane's max of the row, as a tree
#pragma unroll
    for (int j = 0; j < NS; ++j) t[j] = fmaxf(s[j][2 * i], s[j][2 * i + 1]);
#pragma unroll
    for (int w = NS / 2; w > 0; w /= 2)
#pragma unroll
      for (int j = 0; j < w; ++j) t[j] = fmaxf(t[j], t[j + w]);
    float mx = t[0];
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(FULL, mx, 2));
    mn[i] = fmaxf(m[i], mx == NEG ? NEG : mx * scale_log2);
    const float corr = fast_exp2(m[i] - mn[i]);
    m[i] = mn[i];
    l[i] *= corr;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      o[n][2 * i] *= corr;
      o[n][2 * i + 1] *= corr;
    }
  }
  uint32_t pf[KT / 16][4];  // P as the A fragments of the PV product
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      // a masked p is exactly 0: 2^-inf, never 2^(NEG - m) with m = NEG
      const float x = fmaf(s[j][e], scale_log2, -mn[e >> 1]);
      p[e] = fast_exp2(MASK && s[j][e] == NEG ? -INFINITY : x);
    }
    l[0] += p[0] + p[1];  // the unrounded p
    l[1] += p[2] + p[3];
    pf[j >> 1][(j & 1) * 2] = pack_bf16(p[0], p[1]);      // row g
    pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);  // row g + 8
  }
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
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

// The sum of a value over the 4 lanes of a quad (one fragment row).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}

// Epilogue of one warp's 16 rows w0 .. w0 + 15: O / l (l: the lanes'
// partial sums, clamped at 1e-20), written to rows < n_rows of out, a
// contiguous (B, n_rows, H, HD) bf16 tensor at (b, ., h), through sO (16
// rows of pitch HD + 8 that only this warp uses) to 16-byte stores.
template <int HD>
__device__ __forceinline__ void store_out(const float (&o)[HD / 8][4],
                                          const float (&l)[2], bf16* sO,
                                          bf16* out, int b, int h, int H,
                                          int w0, int n_rows, int lane) {
  constexpr int LD = HD + 8, NO = HD / 8;
  const int g = lane >> 2, tq = lane & 3;
  const float inv0 = 1.f / fmaxf(quad_sum(l[0]), 1e-20f);
  const float inv1 = 1.f / fmaxf(quad_sum(l[1]), 1e-20f);
#pragma unroll
  for (int n = 0; n < NO; ++n) {
    *reinterpret_cast<uint32_t*>(sO + g * LD + 8 * n + 2 * tq) =
        pack_bf16(o[n][0] * inv0, o[n][1] * inv0);
    *reinterpret_cast<uint32_t*>(sO + (g + 8) * LD + 8 * n + 2 * tq) =
        pack_bf16(o[n][2] * inv1, o[n][3] * inv1);
  }
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * NO; i += 32) {
    const int r = i / NO, c = i % NO, row = w0 + r;
    if (row < n_rows)
      *reinterpret_cast<uint4*>(out + (((long long)b * n_rows + row) * H + h) *
                                          HD + c * 8) =
          *reinterpret_cast<const uint4*>(sO + r * LD + c * 8);
  }
}

constexpr int KG = 2;        // key groups of a tensor-core block
constexpr int ROWS_TC = 32;  // query columns per partial record (ragged)
constexpr int AW = 4;        // warps of an append block
constexpr int AU = 4;        // token loads per lane in flight (append)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float x) {
  return __float2bfloat16(x);
}

// 2^x: on the special-function unit where p is rounded to bf16 next
template <bool FAST>
__device__ __forceinline__ float exp2_(float x) {
  return FAST ? fast_exp2(x) : exp2f(x);
}

// the N elements of one 16-byte load, as f32
template <typename T, int N>
__device__ __forceinline__ void unpack(const uint4& u, float (&f)[N]) {
  static_assert(N * sizeof(T) == 16, "one 16-byte load");
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < N; ++i) f[i] = to_f32(e[i]);
}

// The table entries a split [s0, s1) reads, table[s0 / BS ..], into shared
// memory (the caller synchronises before use).
__device__ __forceinline__ void load_table(int* tab, const int* row_table,
                                           int s0, int s1, int BS) {
  const int e0 = s0 / BS, n_e = (s1 - 1) / BS - e0 + 1;
  for (int i = threadIdx.x; i < n_e; i += blockDim.x)
    tab[i] = row_table[e0 + i];
}

// After a block has written its partial: true in the last of the n blocks
// of its group to arrive, which resets the group's counter for the next
// launch and may then read every partial of the group.
__device__ __forceinline__ bool last_arrival(int* counter, int n) {
  __shared__ int is_last;
  __threadfence();  // this thread's partial is visible device-wide ...
  __syncthreads();  // ... for every thread of the block
  if (threadIdx.x == 0) {
    is_last = atomicAdd(counter, 1) == n - 1;
    if (is_last) atomicExch(counter, 0);
  }
  __syncthreads();
  if (is_last) __threadfence();
  return is_last;
}

// Partial records: ROWS * (HD + 4) floats per split -- O (ROWS x HD,
// unnormalised), then m (log2 units) and l of each row.  Merges the n
// records at recs into rows r < rows of out (row r at out + r * row_stride).
template <typename T, int HD, int ROWS, bool FAST>
__device__ __forceinline__ void merge_partials(const float* recs, int n,
                                               int rows, T* out,
                                               size_t row_stride) {
  constexpr int REC = ROWS * (HD + 4), V = HD / 4;
  for (int i = threadIdx.x; i < rows * V; i += blockDim.x) {
    const int r = i / V, d = (i % V) * 4;
    float mx = NEG;
    for (int s = 0; s < n; ++s)
      mx = fmaxf(mx, __ldcg(recs + (size_t)s * REC + ROWS * HD + r));
    float den = 0.f, acc[4] = {0.f, 0.f, 0.f, 0.f};
    for (int s = 0; s < n; ++s) {
      const float* rec = recs + (size_t)s * REC;
      const float c = exp2_<FAST>(__ldcg(rec + ROWS * HD + r) - mx);
      den += c * __ldcg(rec + ROWS * HD + ROWS + r);
      const float4 o =
          __ldcg(reinterpret_cast<const float4*>(rec + r * HD + d));
      acc[0] += c * o.x;
      acc[1] += c * o.y;
      acc[2] += c * o.z;
      acc[3] += c * o.w;
    }
    const float inv = 1.f / fmaxf(den, 1e-20f);
    T* dst = out + r * row_stride + d;
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[e] = from_f32<T>(acc[e] * inv);
  }
}

// ---- ragged, bf16: tensor cores ------------------------------------------

// Copy the tile of KT tokens t0 .. t0 + KT - 1 of one (row, head) into
// shared memory (row pitch HD + 8), tokens at or past t_end zero-filled, by
// the NT threads t = 0 .. NT - 1 of a key group.  tab holds the row's
// table entries from index e0.
template <int HD, int NT>
__device__ __forceinline__ void load_kv_tile(bf16* dK, bf16* dV,
                                             const bf16* k_pool,
                                             const bf16* v_pool,
                                             const int* tab, int e0, int BS,
                                             int H, int h, int t0, int t_end,
                                             int t) {
  constexpr int CPR = HD / 8, LD = HD + 8, RS = NT / CPR;
  static_assert(KT % RS == 0, "whole passes over the tile");
  const int r = t / CPR, c = t % CPR;
  int tok = t0 + r, e = tok / BS, off = tok - e * BS;
#pragma unroll
  for (int j = 0; j < KT / RS; ++j) {
    const bool in = tok < t_end;
    const size_t src =
        in ? (((size_t)tab[e - e0] * BS + off) * H + h) * HD + c * 8 : 0;
    const int row = r + j * RS;
    cp_async16(dK + row * LD + c * 8, k_pool + src, in ? 16 : 0);
    cp_async16(dV + row * LD + c * 8, v_pool + src, in ? 16 : 0);
    tok += RS;
    for (off += RS; off >= BS; off -= BS) ++e;
  }
}

// grid (B * H, n_split, ceil(C / 32)); block 32 * NW * KG threads: NW
// column warps (16 query columns each) x KG key groups.
template <int HD, int NW>
__global__ void __launch_bounds__(32 * NW * KG)
paged_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k_pool,
                const bf16* __restrict__ v_pool, bf16* __restrict__ out,
                const int* __restrict__ block_tables,
                const int* __restrict__ c0s, const int* __restrict__ cls,
                float* __restrict__ part, int* __restrict__ counters, int C,
                int H, int BS, int NBT, int split, float scale_log2) {
  constexpr int NTG = 32 * NW, NTH = NTG * KG, BQ = 16 * NW, LD = HD + 8;
  constexpr int KS = HD / 16, NO = HD / 8, TILE = KT * LD;
  constexpr int REC = ROWS_TC * (HD + 4);
  static_assert(BQ <= ROWS_TC, "a column group fits one record");
  extern __shared__ uint4 smem_u4[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_u4);  // [BQ][LD]
  bf16* ring = sQ + BQ * LD;                    // [KG][2 stages][K, V][KT][LD]
  int* tab = reinterpret_cast<int*>(ring + KG * 4 * TILE);

  const int bh = blockIdx.x, sp = blockIdx.y, cb = blockIdx.z;
  const int b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rw = warp % NW, grp = warp / NW;  // column warp, key group
  const int gt = tid % NTG;                   // thread within the group
  const int g = lane >> 2, tq = lane & 3;     // fragment row / column pair
  const int col0 = cb * BQ;                   // the block's first column
  const int c0 = c0s[b], cl = cls[b];
  const int n_cols = min(C - col0, BQ);
  // tokens the block's last column attends to: the most any column reads
  const int ctx = min(c0 + col0 + n_cols - 1, cl);
  const int n_act = (ctx + split - 1) / split;  // splits with work
  if (sp >= n_act) return;
  const int s0 = sp * split, s1 = min(s0 + split, ctx);
  const int e0 = s0 / BS;
  load_table(tab, block_tables + (size_t)b * NBT, s0, s1, BS);

  {  // this column group's Q rows; columns past C are zero-filled
    constexpr int CPR = HD / 8;
    for (int i = tid; i < BQ * CPR; i += NTH) {
      const int r = i / CPR, c = i % CPR, col = col0 + r;
      const bool in = col < C;
      cp_async16(sQ + r * LD + c * 8,
                 q + (in ? (((size_t)b * C + col) * H + h) * HD + c * 8 : 0),
                 in ? 16 : 0);
    }
  }
  cp_commit();
  __syncthreads();  // the table slice is in shared memory
  // cp.async groups per thread: {Q share}, then one per K/V tile
  const int n_tiles = (s1 - s0 + KT - 1) / KT;
  bf16* gring = ring + grp * 4 * TILE;  // this group's 2 stages
  if (grp < n_tiles)
    load_kv_tile<HD, NTG>(gring, gring + TILE, k_pool, v_pool, tab, e0, BS, H,
                          h, s0 + grp * KT, s1, gt);
  cp_commit();
  cp_wait<1>();  // this thread's share of Q has landed
  __syncthreads();
  uint32_t qf[KS][4];
  load_q_frags<HD>(qf, sQ + 16 * rw * LD, lane);

  // keys visible to the lane's two columns, and to the warp's first / last
  const int w0 = col0 + 16 * rw;
  const int lim0 = min(c0 + w0 + g, cl), lim1 = min(c0 + w0 + g + 8, cl);
  const int lim_lo = min(c0 + w0, cl), lim_hi = min(c0 + w0 + 15, cl);

  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {NEG, NEG}, l[2] = {0.f, 0.f};  // l: this lane's partial sums

  for (int it = 0, j = grp; j < n_tiles; ++it, j += KG) {
    cp_wait<0>();              // this tile's K and V have landed ...
    group_sync(1 + grp, NTG);  // ... for the whole group, which is done
                               // with the previous tile's stage
    const int k0 = s0 + j * KT;
    if (j + KG < n_tiles) {  // the group's next tile, in flight during this
      bf16* nK = gring + ((it & 1) ^ 1) * 2 * TILE;
      load_kv_tile<HD, NTG>(nK, nK + TILE, k_pool, v_pool, tab, e0, BS, H, h,
                            k0 + KG * KT, s1, gt);
    }
    cp_commit();
    const bf16* cK = gring + (it & 1) * 2 * TILE;
    if (k0 >= lim_hi) continue;  // no column of this warp reaches the tile
    if (k0 + KT > lim_lo)
      tile_step<HD, true>(qf, cK, cK + TILE, o, m, l, k0, lim0, lim1,
                          scale_log2, lane);
    else
      tile_step<HD, false>(qf, cK, cK + TILE, o, m, l, k0, lim0, lim1,
                           scale_log2, lane);
  }

  // merge the key groups into group 0; the ring is free once every group
  // is done
  {
    constexpr int NV = 4 + NO * 4;  // floats of a lane's stored state
    float* xch = reinterpret_cast<float*>(ring);  // [KG-1][NW][NV][32]
    __syncthreads();
    if (grp > 0)
      store_state<NO>(xch + ((grp - 1) * NW + rw) * NV * 32 + lane, m, l, o);
    __syncthreads();
    if (grp == 0)
#pragma unroll
      for (int j = 1; j < KG; ++j)
        merge_state<NO>(m, l, o, xch + ((j - 1) * NW + rw) * NV * 32 + lane);
  }

  if (n_act == 1) {  // the row's only split: straight to the output
    if (grp == 0)
      store_out<HD>(o, l, sQ + 16 * rw * LD, out, b, h, H, w0, C, lane);
    return;
  }
  float* recs = part + (size_t)(bh * gridDim.z + cb) * gridDim.y * REC;
  if (grp == 0) {
    float* rec = recs + (size_t)sp * REC;
    const int r0 = 16 * rw + g;
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      *reinterpret_cast<float2*>(rec + r0 * HD + 8 * n + 2 * tq) =
          make_float2(o[n][0], o[n][1]);
      *reinterpret_cast<float2*>(rec + (r0 + 8) * HD + 8 * n + 2 * tq) =
          make_float2(o[n][2], o[n][3]);
    }
    const float l0 = quad_sum(l[0]), l1 = quad_sum(l[1]);
    if (tq == 0) {
      rec[ROWS_TC * HD + r0] = m[0];
      rec[ROWS_TC * HD + r0 + 8] = m[1];
      rec[ROWS_TC * HD + ROWS_TC + r0] = l0;
      rec[ROWS_TC * HD + ROWS_TC + r0 + 8] = l1;
    }
  }
  if (!last_arrival(counters + bh * gridDim.z + cb, n_act)) return;
  merge_partials<bf16, HD, ROWS_TC, true>(
      recs, n_act, n_cols, out + (((size_t)b * C + col0) * H + h) * HD,
      (size_t)H * HD);
}

template <int HD, int NW>
int launch_tc(const void* q, const void* k_pool, const void* v_pool,
              void* out, const void* block_tables, const void* c0,
              const void* cl, void* scratch, void* counters, int B, int C,
              int H, int BS, int NBT, int split, int n_split, float scale,
              cudaStream_t stream) {
  constexpr int LD = HD + 8;
  const size_t smem = (size_t)(16 * NW + KG * 4 * KT) * LD * sizeof(bf16) +
                      (size_t)((split - 1) / BS + 2) * sizeof(int);
  // cudaFuncSetAttribute applies to the current device (the launch makes
  // the tensors' device current): the bytes opted in, per device
  static size_t attr_bytes[kMaxDevices] = {};
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev >= kMaxDevices || smem > attr_bytes[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_tc_kernel<HD, NW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev < kMaxDevices) attr_bytes[dev] = smem;
  }
  const dim3 grid(B * H, n_split, (C + ROWS_TC - 1) / ROWS_TC);
  paged_tc_kernel<HD, NW><<<grid, 32 * NW * KG, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k_pool),
      static_cast<const bf16*>(v_pool), static_cast<bf16*>(out),
      static_cast<const int*>(block_tables), static_cast<const int*>(c0),
      static_cast<const int*>(cl), static_cast<float*>(scratch),
      static_cast<int*>(counters), C, H, BS, NBT, split,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// ---- ragged, f32: CUDA cores ---------------------------------------------

constexpr int F_TILE = 32;                 // tokens per staged tile
constexpr int F_NWARPS = 4;
constexpr int F_CPW = 2;                   // query columns per warp
constexpr int F_CG = F_NWARPS * F_CPW;     // query columns per thread block

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

// grid (B, H, ceil(C / F_CG)); block F_NWARPS * 32 threads.  One block per
// (row, head, 8 query columns) walks the row's tokens in tiles of 32 staged
// through shared memory, one token per lane when scoring.
template <int HD>
__global__ void __launch_bounds__(F_NWARPS * 32)
paged_f32_kernel(const float* __restrict__ q,           // (B, C, H, HD)
                 const float* __restrict__ k_pool,      // (NBLK, BS, H, HD)
                 const float* __restrict__ v_pool,
                 float* __restrict__ out,               // (B, C, H, HD)
                 const int* __restrict__ block_tables,  // (B, NBT)
                 const int* __restrict__ c0s,           // (B,) column 0 ctx
                 const int* __restrict__ cls,           // (B,) row context
                 int C, int H, int BS, int NBT, float scale) {
  constexpr int DPL = HD / 32;  // head dims per lane
  __shared__ float q_s[F_CG][HD];
  __shared__ float k_s[F_TILE][HD + 1];  // +1: lanes read distinct rows
  __shared__ float v_s[F_TILE][HD];

  const int b = blockIdx.x, h = blockIdx.y;
  const int col_base = blockIdx.z * F_CG;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c0 = c0s[b], ctx = cls[b];
  const int col_last = min(C, col_base + F_CG) - 1;
  const int ctx_group = min(c0 + col_last, ctx);  // tokens this block reads
  const int* table = block_tables + (size_t)b * NBT;

  for (int i = tid; i < F_CG * HD; i += F_NWARPS * 32) {
    const int c = i / HD, d = i % HD, col = col_base + c;
    q_s[c][d] = col < C ? q[(((size_t)b * C + col) * H + h) * HD + d] : 0.f;
  }

  float m[F_CPW], l[F_CPW], acc[F_CPW][DPL];
#pragma unroll
  for (int i = 0; i < F_CPW; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPL; ++j) acc[i][j] = 0.f;
  }

  // Tile loader: TPR threads per token row, each moving EPT contiguous
  // elements of K and of V with 16-byte loads after one block-table read;
  // the next tile is fetched into registers while this one is computed.
  constexpr int TPR = (F_NWARPS * 32) / F_TILE;
  constexpr int EPT = HD / TPR;
  constexpr int NV = EPT / 4;  // 16-byte loads per operand
  const int lrow = tid / TPR, lseg = tid % TPR;
  float4 k_reg[NV], v_reg[NV];
  auto fetch = [&](int t0) {
    const int t = t0 + lrow;
#pragma unroll
    for (int i = 0; i < NV; ++i)
      k_reg[i] = v_reg[i] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < ctx_group) {
      const size_t o =
          (((size_t)table[t / BS] * BS + t % BS) * H + h) * HD + lseg * EPT;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        k_reg[i] = reinterpret_cast<const float4*>(k_pool + o)[i];
        v_reg[i] = reinterpret_cast<const float4*>(v_pool + o)[i];
      }
    }
  };

  fetch(0);
  for (int t0 = 0; t0 < ctx_group; t0 += F_TILE) {
    __syncthreads();  // the previous tile is consumed (and q_s is staged)
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      float* kd = &k_s[lrow][lseg * EPT + 4 * i];
      float* vd = &v_s[lrow][lseg * EPT + 4 * i];
      kd[0] = k_reg[i].x, kd[1] = k_reg[i].y, kd[2] = k_reg[i].z;
      kd[3] = k_reg[i].w;
      vd[0] = v_reg[i].x, vd[1] = v_reg[i].y, vd[2] = v_reg[i].z;
      vd[3] = v_reg[i].w;
    }
    __syncthreads();
    if (t0 + F_TILE < ctx_group) fetch(t0 + F_TILE);
#pragma unroll
    for (int i = 0; i < F_CPW; ++i) {
      const int lc = warp + F_NWARPS * i, col = col_base + lc;
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
      const int n_valid = min(F_TILE, cctx - t0);
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
  for (int i = 0; i < F_CPW; ++i) {
    const int col = col_base + warp + F_NWARPS * i;
    if (col >= C) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-20f);
    float* o = out + (((size_t)b * C + col) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < DPL; ++j) o[lane + 32 * j] = acc[i][j] * inv;
  }
}

template <int HD>
int launch_f32(const void* q, const void* k_pool, const void* v_pool,
               void* out, const void* block_tables, const void* c0,
               const void* cl, int B, int C, int H, int BS, int NBT,
               float scale, cudaStream_t stream) {
  const dim3 grid(B, H, (C + F_CG - 1) / F_CG);
  paged_f32_kernel<HD><<<grid, F_NWARPS * 32, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k_pool),
      static_cast<const float*>(v_pool), static_cast<float*>(out),
      static_cast<const int*>(block_tables), static_cast<const int*>(c0),
      static_cast<const int*>(cl), C, H, BS, NBT, scale);
  return static_cast<int>(cudaGetLastError());
}

// ---- append + attend, C = 1: CUDA cores ----------------------------------

// grid (B * H, n_split); block AW * 32 threads.
template <typename T, int HD>
__global__ void __launch_bounds__(AW * 32)
append_kernel(const T* __restrict__ q,      // (B, 1, H, HD)
              const T* __restrict__ k_new,  // (B, H, HD)
              const T* __restrict__ v_new,  // (B, H, HD)
              T* k_pool, T* v_pool,         // (NBLK, BS, H, HD)
              T* __restrict__ out,          // (B, 1, H, HD)
              const int* __restrict__ block_tables,  // (B, NBT)
              const int* __restrict__ cls,           // (B,) row context
              const int* __restrict__ slot_blocks,   // (B,)
              const int* __restrict__ slot_offsets,  // (B,)
              float* __restrict__ part, int* __restrict__ counters, int H,
              int BS, int NBT, int split, float scale_log2) {
  constexpr int EPL = 16 / sizeof(T);    // elements of one 16-byte load
  constexpr int LPT = HD / EPL;          // lanes per token row
  constexpr int TPW = 32 / LPT;          // tokens per warp and load
  constexpr int STEP = AW * TPW;         // tokens per load of the block
  constexpr int ROUND = STEP * AU;       // tokens of one round of loads
  constexpr bool FAST = sizeof(T) == 2;  // p is rounded to bf16 next
  constexpr int REC = HD + 4;
  static_assert(LPT <= 32 && HD <= AW * 32, "a token row fits a warp");
  extern __shared__ int tab[];  // the split's table entries
  __shared__ float w_m[AW], w_l[AW], w_o[AW][HD];

  const int bh = blockIdx.x, sp = blockIdx.y, b = bh / H, h = bh % H;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cl = cls[b];
  const int n_act = (cl + split - 1) / split;  // splits with work
  if (sp >= n_act) return;
  const int s0 = sp * split, s1 = min(s0 + split, cl);
  const int e0 = s0 / BS;
  load_table(tab, block_tables + (size_t)b * NBT, s0, s1, BS);

  const int sub = lane % LPT;                // the lane's chunk of a row
  const int slot = warp * TPW + lane / LPT;  // the lane group's token
  const size_t hoff = (size_t)h * HD + sub * EPL;
  const T* kn = k_new + (size_t)b * H * HD + hoff;
  const T* vn = v_new + (size_t)b * H * HD + hoff;
  float qv[EPL];
  unpack<T>(*reinterpret_cast<const uint4*>(q + (size_t)b * H * HD + hoff),
            qv);
  __syncthreads();  // the table slice is in shared memory

  // K and V chunks of the lane group's tokens r0 + u * STEP + slot
  auto fetch = [&](uint4 (&kr)[AU], uint4 (&vr)[AU], int r0) {
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      const int t = r0 + u * STEP + slot;
      kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
      if (t < s1) {
        const T *ks = kn, *vs = vn;  // the tail from k_new / v_new
        if (t != cl - 1) {
          const int e = t / BS;
          const size_t row =
              ((size_t)tab[e - e0] * BS + (t - e * BS)) * H * HD + hoff;
          ks = k_pool + row;
          vs = v_pool + row;
        }
        kr[u] = *reinterpret_cast<const uint4*>(ks);
        vr[u] = *reinterpret_cast<const uint4*>(vs);
      }
    }
  };

  float m = NEG, l = 0.f, acc[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) acc[e] = 0.f;
  uint4 kc[AU], vc[AU], kx[AU], vx[AU];
  fetch(kc, vc, s0);
  for (int r0 = s0; r0 < s1; r0 += ROUND) {
    if (r0 + ROUND < s1) fetch(kx, vx, r0 + ROUND);  // the next round
    float s[AU];
    float mx = m;
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      float kf[EPL];
      unpack<T>(kc[u], kf);
      float d = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) d = fmaf(qv[e], kf[e], d);
#pragma unroll
      for (int o = LPT / 2; o > 0; o >>= 1) d += __shfl_xor_sync(FULL, d, o);
      s[u] = r0 + u * STEP + slot < s1 ? d * scale_log2 : NEG;
      mx = fmaxf(mx, s[u]);
    }
    const float corr = exp2_<FAST>(m - mx);
    l *= corr;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[e] *= corr;
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      const float p = s[u] == NEG ? 0.f : exp2_<FAST>(s[u] - mx);
      l += p;  // the unrounded p
      const float pr = to_f32(from_f32<T>(p));
      float vf[EPL];
      unpack<T>(vc[u], vf);
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[e] = fmaf(pr, vf[e], acc[e]);
    }
    m = mx;
#pragma unroll
    for (int u = 0; u < AU; ++u) {
      kc[u] = kx[u];
      vc[u] = vx[u];
    }
  }

  // the warp's lane groups merge by shuffles, then the warps in shared
  // memory, each by the online softmax's rule
#pragma unroll
  for (int o = LPT; o < 32; o <<= 1) {
    const float mo = __shfl_xor_sync(FULL, m, o);
    const float lo = __shfl_xor_sync(FULL, l, o);
    const float mt = fmaxf(m, mo);
    const float ca = exp2_<FAST>(m - mt), cb = exp2_<FAST>(mo - mt);
    l = l * ca + lo * cb;
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      acc[e] = acc[e] * ca + __shfl_xor_sync(FULL, acc[e], o) * cb;
    m = mt;
  }
  if (lane < LPT) {
#pragma unroll
    for (int e = 0; e < EPL; ++e) w_o[warp][sub * EPL + e] = acc[e];
    if (lane == 0) {
      w_m[warp] = m;
      w_l[warp] = l;
    }
  }
  __syncthreads();
  float val = 0.f, mt = NEG, den = 0.f;
  if (tid < HD) {
#pragma unroll
    for (int w = 0; w < AW; ++w) mt = fmaxf(mt, w_m[w]);
#pragma unroll
    for (int w = 0; w < AW; ++w) {
      const float c = exp2_<FAST>(w_m[w] - mt);
      den += c * w_l[w];
      val += c * w_o[w][tid];
    }
  }

  if (sp == n_act - 1) {
    // the append itself: this split holds the tail, which it read from
    // k_new / v_new above; one slot per (row, head) in each pool, after
    // every read of this block
    const size_t dst =
        (((size_t)slot_blocks[b] * BS + slot_offsets[b]) * H + h) * HD;
    const size_t src = (size_t)bh * HD;
    for (int d = tid; d < HD; d += AW * 32) {
      k_pool[dst + d] = k_new[src + d];
      v_pool[dst + d] = v_new[src + d];
    }
  }
  if (n_act == 1) {  // the row's only split: straight to the output
    if (tid < HD)
      out[(size_t)bh * HD + tid] = from_f32<T>(val / fmaxf(den, 1e-20f));
    return;
  }
  float* recs = part + (size_t)bh * gridDim.y * REC;
  if (tid < HD) {
    float* rec = recs + (size_t)sp * REC;
    rec[tid] = val;
    if (tid == 0) {
      rec[HD] = mt;
      rec[HD + 1] = den;
    }
  }
  if (!last_arrival(counters + bh, n_act)) return;
  merge_partials<T, HD, 1, FAST>(recs, n_act, 1, out + (size_t)bh * HD, HD);
}

template <typename T, int HD>
int launch_append(const void* q, const void* k_new, const void* v_new,
                  void* k_pool, void* v_pool, void* out,
                  const void* block_tables, const void* cl,
                  const void* slot_blocks, const void* slot_offsets,
                  void* scratch, void* counters, int B, int H, int BS,
                  int NBT, int split, int n_split, float scale,
                  cudaStream_t stream) {
  const size_t smem = (size_t)((split - 1) / BS + 2) * sizeof(int);
  const dim3 grid(B * H, n_split);
  append_kernel<T, HD><<<grid, AW * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(k_pool),
      static_cast<T*>(v_pool), static_cast<T*>(out),
      static_cast<const int*>(block_tables), static_cast<const int*>(cl),
      static_cast<const int*>(slot_blocks),
      static_cast<const int*>(slot_offsets), static_cast<float*>(scratch),
      static_cast<int*>(counters), H, BS, NBT, split,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int append_hd(int hd, const void* q, const void* k_new, const void* v_new,
              void* k_pool, void* v_pool, void* out, const void* block_tables,
              const void* cl, const void* slot_blocks,
              const void* slot_offsets, void* scratch, void* counters, int B,
              int H, int BS, int NBT, int split, int n_split, float scale,
              cudaStream_t stream) {
#define PW_APPEND(HD)                                                        \
  launch_append<T, HD>(q, k_new, v_new, k_pool, v_pool, out, block_tables,  \
                       cl, slot_blocks, slot_offsets, scratch, counters, B, \
                       H, BS, NBT, split, n_split, scale, stream)
  switch (hd) {
    case 32: return PW_APPEND(32);
    case 64: return PW_APPEND(64);
    case 128: return PW_APPEND(128);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PW_APPEND
}

// every row's context fits the splits, which cover whole key tiles
bool bad_split(int split, int n_split, int BS, int NBT, int tile) {
  return split <= 0 || split % tile != 0 || BS <= 0 ||
         (long long)split * n_split < (long long)NBT * BS;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  scratch: B * H * ceil(C / 32) *
// n_split partial records of 32 * (hd + 4) floats; counters: B * H *
// ceil(C / 32) ints, 0 before the first launch (each launch leaves them
// 0).  f32 uses neither.  Returns cudaGetLastError().
extern "C" int pw_paged_attention(const void* q, const void* k_pool,
                                  const void* v_pool, void* out,
                                  const void* block_tables, const void* c0,
                                  const void* cl, void* scratch,
                                  void* counters, int B, int C, int H, int hd,
                                  int BS, int NBT, int split, int n_split,
                                  int dtype, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
#define PW_F32(HD)                                                         \
  launch_f32<HD>(q, k_pool, v_pool, out, block_tables, c0, cl, B, C, H, BS, \
                 NBT, scale, s)
    switch (hd) {
      case 32: return PW_F32(32);
      case 64: return PW_F32(64);
      case 128: return PW_F32(128);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
#undef PW_F32
  }
  if (bad_split(split, n_split, BS, NBT, KT))
    return static_cast<int>(cudaErrorInvalidValue);
#define PW_TC(HD, NW)                                                        \
  launch_tc<HD, NW>(q, k_pool, v_pool, out, block_tables, c0, cl, scratch,  \
                    counters, B, C, H, BS, NBT, split, n_split, scale, s)
  switch (hd) {
    case 32: return C <= 16 ? PW_TC(32, 1) : PW_TC(32, 2);
    case 64: return C <= 16 ? PW_TC(64, 1) : PW_TC(64, 2);
    case 128: return C <= 16 ? PW_TC(128, 1) : PW_TC(128, 2);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PW_TC
}

// C = 1; the context of the one column is cl.  scratch: B * H * n_split
// records of hd + 4 floats; counters: B * H ints, 0 before the first launch
// (each launch leaves them 0).
extern "C" int pw_paged_append_attend(
    const void* q, const void* k_new, const void* v_new, void* k_pool,
    void* v_pool, void* out, const void* block_tables, const void* cl,
    const void* slot_blocks, const void* slot_offsets, void* scratch,
    void* counters, int B, int H, int hd, int BS, int NBT, int split,
    int n_split, int dtype, float scale, void* stream) {
  if (bad_split(split, n_split, BS, NBT, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return append_hd<float>(hd, q, k_new, v_new, k_pool, v_pool, out,
                            block_tables, cl, slot_blocks, slot_offsets,
                            scratch, counters, B, H, BS, NBT, split, n_split,
                            scale, s);
  return append_hd<bf16>(hd, q, k_new, v_new, k_pool, v_pool, out,
                         block_tables, cl, slot_blocks, slot_offsets, scratch,
                         counters, B, H, BS, NBT, split, n_split, scale, s);
}
