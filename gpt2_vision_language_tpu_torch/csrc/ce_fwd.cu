// Fused LM-head + cross-entropy forward for Hopper (sm_90a).
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/fused_ce.py
// _ce_fwd_kernel (launcher _ce_fwd_pallas). Same function: for each row n,
// lse[n] = logsumexp_v(x[n] . w[v]) and nll[n] = lse[n] - x[n] . w[t[n]], with
// the logits kept in fp32 and never written to device memory.
//
// What bounds it on the H100: at N=8192, D=768, V=50304 the product is
// 633 GFLOP while x and w are 12.6 MB and 77 MB, so it is compute-bound; the
// tensor cores are the only way to keep it near the plain matmul's time, and
// the point of fusing is the 1.6 GB of fp32 logits (written and read back)
// that the plain version moves.
//
// What the design does about it: a block owns 64 rows and a contiguous range
// of 128-wide vocab tiles. For each vocab tile it computes the 64 x 128 logits
// on the tensor cores (nvcuda::wmma, bf16 16x16x16, fp32 accumulators), with x
// and w streamed through shared memory in 64-deep chunks, then folds the tile
// into a running max and sum-exp per row and picks the gold logit when the
// row's target falls inside the tile. The vocab is split over several blocks
// so that a small N still fills the 132 SMs; a second small kernel merges the
// per-split (max, sum, gold) triples. Blocks of one split run side by side and
// read the same w tiles, which then come from L2. A ragged last vocab tile and
// a ragged last row tile are masked. Simple first: no cp.async, wgmma or TMA.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int BM = 64;           // rows per block
constexpr int BN = 128;          // vocab columns per tile
constexpr int BK = 64;           // depth of one shared-memory chunk
constexpr int THREADS = 128;     // 4 warps as 2 (rows) x 2 (columns), 32 x 64 each
constexpr int LDK = BK + 8;      // bf16 pitch of the x / w chunks
constexpr int LDS = BN + 4;      // fp32 pitch of the logits tile
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Smem {
  __nv_bfloat16 x[BM * LDK];
  __nv_bfloat16 w[BN * LDK];
  float s[BM * LDS];
};

// rows [row0, row0 + ROWS) x columns [k0, k0 + BK) of a (rows, D) matrix; out of range is zero
template <int ROWS>
__device__ __forceinline__ void load_chunk(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                           int row0, int nrows, int k0, int D, int tid) {
  constexpr int VEC = 8;  // 16-byte loads; D % 8 == 0
  constexpr int PER_ROW = BK / VEC;
  for (int i = tid; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int row = row0 + r, col = k0 + c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < nrows && col < D)
      val = *reinterpret_cast<const uint4*>(src + (long long)row * D + col);
    *reinterpret_cast<uint4*>(dst + r * LDK + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
ce_fwd_partial_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                      const int* __restrict__ targets, float* __restrict__ part_m,
                      float* __restrict__ part_l, float* __restrict__ part_g,
                      int N, int D, int V, int tiles_per_split) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.x * BM;
  const int split = blockIdx.y;
  const int n_vt = (V + BN - 1) / BN;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(n_vt, vt0 + tiles_per_split);

  // two threads per row: row r, columns half * 64 ... of each tile
  const int r = tid >> 1, half = tid & 1;
  const int row = row0 + r;
  const int tgt = row < N ? targets[row] : -1;
  float m_i = -1e30f;  // running max, log2 domain
  float l_i = 0.f;     // running sum of 2^(s * log2e - m_i)
  float g_i = 0.f;     // gold logit, natural units

  for (int vt = vt0; vt < vt1; ++vt) {
    const int v0 = vt * BN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int k0 = 0; k0 < D; k0 += BK) {
      __syncthreads();  // the previous chunk (and logits tile) is consumed
      load_chunk<BM>(sm.x, x, row0, N, k0, D, tid);
      load_chunk<BN>(sm.w, w, v0, V, k0, D, tid);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> af[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(af[i], &sm.x[(wm * 32 + i * 16) * LDK + kk * 16], LDK);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> bf;
          wmma::load_matrix_sync(bf, &sm.w[(wn * 64 + j * 16) * LDK + kk * 16], LDK);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], af[i], bf, acc[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(&sm.s[(wm * 32 + i * 16) * LDS + wn * 64 + j * 16], acc[i][j],
                                LDS, wmma::mem_row_major);
    __syncthreads();

    const float* srow = &sm.s[r * LDS + half * (BN / 2)];
    const int c0 = v0 + half * (BN / 2);
    float mx = -INFINITY;
#pragma unroll 8
    for (int c = 0; c < BN / 2; ++c) {
      const float val = srow[c];
      if (c0 + c == tgt) g_i += val;
      if (c0 + c < V) mx = fmaxf(mx, val * LOG2E);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    float sum = 0.f;
#pragma unroll 8
    for (int c = 0; c < BN / 2; ++c)
      if (c0 + c < V) sum += exp2f(srow[c] * LOG2E - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * exp2f(m_i - m_new) + sum;
    m_i = m_new;
  }

  const float g = g_i + __shfl_xor_sync(0xffffffffu, g_i, 1);
  if (half == 0 && row < N) {
    const long long idx = (long long)split * N + row;
    part_m[idx] = m_i;
    part_l[idx] = l_i;
    part_g[idx] = g;
  }
}

__global__ void ce_fwd_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_g, float* __restrict__ nll,
                                      float* __restrict__ lse, int N, int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = -1e30f;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_m[(long long)s * N + row]);
  float l = 0.f, g = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long idx = (long long)s * N + row;
    l += part_l[idx] * exp2f(part_m[idx] - m);
    g += part_g[idx];
  }
  const float out = (m + log2f(l)) * LN2;
  lse[row] = out;
  nll[row] = out - g;
}

}  // namespace

// x: (N, D) bf16, w: (V, D) bf16, targets: (N,) int32, all contiguous, D % 8 == 0,
// base pointers 16-byte aligned. nll, lse: (N,) fp32. part: scratch of
// 3 * max_split * N fp32. A target outside [0, V) gets gold 0 (nll = lse).
// Returns the CUDA error code of the launches (0 on success).
extern "C" int gpt2vl_ce_fwd(const void* x, const void* w, const void* targets, void* nll,
                             void* lse, void* part, int N, int D, int V, int max_split,
                             void* stream) {
  if (N <= 0 || D <= 0 || V <= 0 || D % 8 != 0 || max_split <= 0)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(ce_fwd_partial_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_vt = (V + BN - 1) / BN;
  const int want = max_split < n_vt ? max_split : n_vt;
  const int tiles_per_split = (n_vt + want - 1) / want;
  const int nsplit = (n_vt + tiles_per_split - 1) / tiles_per_split;  // no empty split
  float* pm = (float*)part;
  float* pl = pm + (long long)max_split * N;
  float* pg = pl + (long long)max_split * N;
  const dim3 grid((N + BM - 1) / BM, nsplit);
  ce_fwd_partial_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const int*)targets, pm, pl, pg, N, D,
      V, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      pm, pl, pg, (float*)nll, (float*)lse, N, nsplit);
  return (int)cudaGetLastError();
}

// Rows per block and vocab columns per tile, for the wrapper's split count.
extern "C" int gpt2vl_ce_fwd_block_rows() { return BM; }
extern "C" int gpt2vl_ce_fwd_tile_cols() { return BN; }
