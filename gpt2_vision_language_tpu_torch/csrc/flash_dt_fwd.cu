// Flash-attention forward in the "dt" layout for Hopper (sm_90a): q, k, v and o
// are (H, hs, B*T) bf16, the sequence contiguous and one slab of T positions per
// batch row; q arrives pre-scaled by 1/sqrt(hs).
//
// Replaces the TPU kernel tools/ab_dt_flash.py _fwd_dt_kernel (launcher
// flash_fwd_dt_b). Same function: O = softmax(q^T k) v per (h, b) slab with an
// optional causal mask (query i sees keys <= i, no offset), plus the per-query
// logsumexp, which comes back as one fp32 row (H, B*Tq): the TPU kernel's eight
// replicated sublane rows were a register-tile workaround. Aligned shapes only,
// Tq % 64 == Tk % 64 == 0, as the prototype it replaces.
//
// What bounds it on the H100: the same work as flash_fwd.cu, 12.9 GFLOP against
// 50 MB at B=8, T=1024, H=12, hs=64 causal, near the ridge of the bf16 tensor
// cores and HBM. The layout changes only how a tile reaches shared memory: a
// (hs, 64) slab whose 64 rows are each 128 contiguous bytes of the sequence,
// where flash_fwd.cu reads 64 rows of 128 contiguous bytes of the head. Both are
// full 128-byte lines, so the question the A/B tool is left with on this card is
// coalescing along the sequence against along the head, not tile density.
//
// What the design does about it: the structure of flash_fwd.cu with every
// operand transposed. One block per (b, h, 64-query tile), four warps of 16
// queries each; K and V stream through shared memory in 64-key tiles stored as
// they lie in memory, [d][position]. The tensor-core fragments (nvcuda::wmma,
// bf16 16x16x16, fp32 accumulators) read them transposed: S = Q^T K takes Q^T as
// a column-major A operand and K as a row-major B operand, O += P V^T takes V^T
// as a column-major B operand (the TPU kernel's S = K^T Q, acc = V P with the
// roles of rows and columns exchanged). The softmax state lives in registers,
// two lanes per query. The output tile is transposed through shared memory so
// that the store writes whole 128-byte rows of the sequence. Simple first: no
// cp.async, wgmma or TMA yet.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HS = 64;             // head size the kernel is built for
constexpr int BM = 64;             // queries per block
constexpr int BN = 64;             // keys per K/V tile
constexpr int WARPS = BM / 16;     // one warp per 16 queries
constexpr int THREADS = WARPS * 32;
constexpr int LDT = 64 + 8;        // bf16 row pitch of a [d][position] tile
constexpr int LDP = BN + 8;        // bf16 row pitch of a warp's P tile
constexpr int LDS = (BN > HS ? BN : HS) + 4;  // fp32 pitch of a warp's scratch
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

using bf16 = __nv_bfloat16;

struct Smem {
  bf16 q[HS * LDT];  // [d][query]; the output tile after the loop
  bf16 k[HS * LDT];  // [d][key]
  bf16 v[HS * LDT];  // [d][key]
  bf16 p[WARPS][16 * LDP];
  float s[WARPS][16 * LDS];
};

// positions [pos0, pos0 + 64) of the HS rows of one head: src points at row 0,
// position 0 of the slab, `row` is the row stride (B*T)
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row, int pos0,
                                          int tid) {
  constexpr int VEC = 8;  // 16-byte loads
  constexpr int PER_ROW = 64 / VEC;
  for (int i = tid; i < HS * PER_ROW; i += THREADS) {
    const int d = i / PER_ROW, c = (i % PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(dst + d * LDT + c) =
        *reinterpret_cast<const uint4*>(src + d * row + pos0 + c);
  }
}

__global__ void __launch_bounds__(THREADS)
flash_dt_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int B, int Tq, int Tk, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int m0 = qt * BM;
  const long long qrow = (long long)B * Tq, krow = (long long)B * Tk;
  const bf16* qb = q + (long long)h * HS * qrow + (long long)b * Tq;
  const bf16* kb = k + (long long)h * HS * krow + (long long)b * Tk;
  const bf16* vb = v + (long long)h * HS * krow + (long long)b * Tk;

  load_tile(sm.q, qb, qrow, m0, tid);

  const int n_all = Tk / BN;
  const int n_tiles = causal ? min(n_all, m0 / BN + 1) : n_all;

  // two lanes per query: query r of this warp, columns half * (width / 2) ...
  const int r = lane >> 1, half = lane & 1;
  const int qpos = m0 + warp * 16 + r;
  float m_i = -1e30f;  // running max, log2 domain
  float l_i = 0.f;     // running sum of 2^(s - m_i)
  float acc[HS / 2];
#pragma unroll
  for (int d = 0; d < HS / 2; ++d) acc[d] = 0.f;

  __syncthreads();
  // Q^T (16 queries x 16 d) is the [d][query] tile read column-major
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> qf[HS / 16];
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], &sm.q[kk * 16 * LDT + warp * 16], LDT);

  float* scratch = sm.s[warp];
  bf16* ptile = sm.p[warp];

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile (and, once, with sm.q)
    load_tile(sm.k, kb, krow, n0, tid);
    load_tile(sm.v, vb, krow, n0, tid);
    __syncthreads();

    // S (16 queries x 64 keys) = Q_w^T K
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> kf;
        wmma::load_matrix_sync(kf, &sm.k[kk * 16 * LDT + n * 16], LDT);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(&scratch[n * 16], sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's half row (q is pre-scaled: only log2(e) here)
    const float* srow = &scratch[r * LDS + half * (BN / 2)];
    const int c0 = n0 + half * (BN / 2);
    float x[BN / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) {
      const bool ok = !causal || c0 + c <= qpos;
      x[c] = ok ? srow[c] * LOG2E : -INFINITY;
      mx = fmaxf(mx, x[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float corr = exp2f(m_i - m_new);
    float sum = 0.f;
    bf16* prow = &ptile[r * LDP + half * (BN / 2)];
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) {
      const float pc = exp2f(x[c] - m_new);
      prow[c] = __float2bfloat16(pc);
      sum += pc;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l_i = l_i * corr + sum;
    m_i = m_new;
    __syncwarp();  // P written and the scores read before the scratch is reused

    // PV (16 queries x 64 d) = P V^T; V^T (keys x d) is the [d][key] tile read column-major
#pragma unroll
    for (int n = 0; n < HS / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> vf;
        wmma::load_matrix_sync(pf, &ptile[kk * 16], LDP);
        wmma::load_matrix_sync(vf, &sm.v[n * 16 * LDT + kk * 16], LDT);
        wmma::mma_sync(of, pf, vf, of);
      }
      wmma::store_matrix_sync(&scratch[n * 16], of, LDS, wmma::mem_row_major);
    }
    __syncwarp();
    const float* pv = &scratch[r * LDS + half * (HS / 2)];
#pragma unroll
    for (int d = 0; d < HS / 2; ++d) acc[d] = acc[d] * corr + pv[d];
    __syncwarp();
  }

  // the output tile goes through sm.q as [d][query] (free since the first tile's
  // barrier), then out in whole rows of 64 positions
  const float inv = 1.f / l_i;
  const int col = warp * 16 + r;
#pragma unroll
  for (int d = 0; d < HS / 2; ++d)
    sm.q[(half * (HS / 2) + d) * LDT + col] = __float2bfloat16(acc[d] * inv);
  if (half == 0)
    lse[(long long)h * qrow + (long long)b * Tq + qpos] = (m_i + log2f(l_i)) * LN2;
  __syncthreads();
  bf16* ob = o + (long long)h * HS * qrow + (long long)b * Tq + m0;
  for (int i = tid; i < HS * 8; i += THREADS) {
    const int d = i / 8, c = (i % 8) * 8;
    *reinterpret_cast<uint4*>(ob + d * qrow + c) =
        *reinterpret_cast<const uint4*>(&sm.q[d * LDT + c]);
  }
}

}  // namespace

// q, o: contiguous (H, hs, B*Tq) bf16; k, v: contiguous (H, hs, B*Tk) bf16; lse:
// contiguous (H, B*Tq) fp32. Tq and Tk multiples of 64, base pointers 16-byte
// aligned (checked by the Python wrapper). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int gpt2vl_flash_dt_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Tq, int Tk, int H, int hs, int causal,
                                   void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Tq % BM || Tk % BN || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_dt_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(Tq / BM, H, B);
  flash_dt_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, (float*)lse, B, Tq, Tk, causal);
  return (int)cudaGetLastError();
}
