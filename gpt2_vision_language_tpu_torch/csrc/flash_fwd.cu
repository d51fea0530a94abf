// Flash-attention forward for Hopper (sm_90a): bf16 q/k/v, fp32 online softmax.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _fwd_dt_kernel (launcher _fwd_dt). Same function: O = softmax(q k^T / sqrt(hs)) v
// with an optional causal mask, plus the per-row logsumexp. Unlike the TPU
// kernel it reads q/k/v in their (B, T, H, hs) layout through strides, so the
// three strided views of the fused QKV projection go in without a copy; the
// TPU's (H, hs, B*T) layout existed only for its lane tiling.
//
// What bounds it on the H100: at B=8, T=1024, H=12, hs=64 causal the forward
// is 12.9 GFLOP against 50 MB of q/k/v/o, about 260 FLOP per byte, so it sits
// near the ridge of the bf16 tensor cores and HBM. K and V of one head are
// 256 KB at T=1024, more than a block's 227 KB of shared memory, so the TPU
// kernel's "K/V resident" design does not carry over.
//
// What the design does about it: one block per (b, h, 64-row q tile), four
// warps of 16 rows each. K and V stream through shared memory in 64-key
// tiles; the scores of a tile never leave the SM. Products run on the tensor
// cores through nvcuda::wmma (bf16 16x16x16, fp32 accumulators). A causal
// block stops at its diagonal tile and the blocks with the most tiles are
// scheduled first. The softmax state (running max, running sum, the output
// accumulator) lives in registers, two lanes per query row; the wmma
// accumulators pass through a per-warp shared scratch because their register
// layout is opaque. A ragged tail of T is masked (keys) and not stored
// (queries). Simple first: no cp.async, wgmma or TMA yet.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HS = 64;             // head size the kernel is built for
constexpr int BM = 64;             // query rows per block
constexpr int BN = 64;             // keys per K/V tile
constexpr int WARPS = BM / 16;     // one warp per 16 query rows
constexpr int THREADS = WARPS * 32;
constexpr int LDH = HS + 8;        // bf16 row pitch of the Q/K/V tiles
constexpr int LDP = BN + 8;        // bf16 row pitch of a warp's P tile
constexpr int LDS = (BN > HS ? BN : HS) + 4;  // fp32 pitch of a warp's scratch
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct Smem {
  __nv_bfloat16 q[BM * LDH];
  __nv_bfloat16 k[BN * LDH];
  __nv_bfloat16 v[BN * LDH];
  __nv_bfloat16 p[WARPS][16 * LDP];
  float s[WARPS][16 * LDS];
};

// rows [row0, row0 + ROWS) of one head into a (ROWS, LDH) tile; rows >= T are zero
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int row0, int T, int tid) {
  constexpr int VEC = 8;  // 16-byte loads
  constexpr int PER_ROW = HS / VEC;
  for (int i = tid; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < T) val = *reinterpret_cast<const uint4*>(src + (long long)t * st + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                 float* __restrict__ lse, int T, int H,
                 long long qsb, long long qst, long long qsh,
                 long long ksb, long long kst, long long ksh,
                 long long vsb, long long vst, long long vsh,
                 int causal, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int qt = gridDim.x - 1 - blockIdx.x;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int m0 = qt * BM;
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  load_tile<BM>(sm.q, qb, qst, m0, T, tid);

  const int n_all = (T + BN - 1) / BN;
  const int n_tiles = causal ? min(n_all, (m0 + BM - 1) / BN + 1) : n_all;

  // two lanes per query row: row r of this warp, columns half * (width / 2) ...
  const int r = lane >> 1, half = lane & 1;
  const int qpos = m0 + warp * 16 + r;
  float m_i = -1e30f;  // running max, log2 domain
  float l_i = 0.f;     // running sum of 2^(s - m_i)
  float acc[HS / 2];
#pragma unroll
  for (int d = 0; d < HS / 2; ++d) acc[d] = 0.f;

  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> qf[HS / 16];
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk)
    wmma::load_matrix_sync(qf[kk], &sm.q[warp * 16 * LDH + kk * 16], LDH);

  float* scratch = sm.s[warp];
  __nv_bfloat16* ptile = sm.p[warp];

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BN;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile<BN>(sm.k, kb, kst, n0, T, tid);
    load_tile<BN>(sm.v, vb, vst, n0, T, tid);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows
#pragma unroll
    for (int n = 0; n < BN / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, &sm.k[n * 16 * LDH + kk * 16], LDH);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(&scratch[n * 16], sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax over this lane's half row
    const float* srow = &scratch[r * LDS + half * (BN / 2)];
    const int c0 = n0 + half * (BN / 2);
    float x[BN / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) {
      const int kpos = c0 + c;
      const bool ok = kpos < T && (!causal || kpos <= qpos);
      x[c] = ok ? srow[c] * scale_log2 : -INFINITY;
      mx = fmaxf(mx, x[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m_i, mx);
    const float corr = exp2f(m_i - m_new);
    float sum = 0.f;
    __nv_bfloat16* prow = &ptile[r * LDP + half * (BN / 2)];
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

    // PV = P (16 x BN) V (BN x HS) into the scratch
#pragma unroll
    for (int n = 0; n < HS / 16; ++n) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::fill_fragment(of, 0.f);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> pf;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> vf;
        wmma::load_matrix_sync(pf, &ptile[kk * 16], LDP);
        wmma::load_matrix_sync(vf, &sm.v[kk * 16 * LDH + n * 16], LDH);
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

  if (qpos < T) {
    const float inv = 1.f / l_i;
    __nv_bfloat16* orow = o + (((long long)b * T + qpos) * H + h) * HS + half * (HS / 2);
#pragma unroll
    for (int d = 0; d < HS / 2; d += 8) {
      __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) tmp[e] = __float2bfloat16(acc[d + e] * inv);
      *reinterpret_cast<uint4*>(orow + d) = *reinterpret_cast<const uint4*>(tmp);
    }
    if (half == 0) lse[((long long)b * H + h) * T + qpos] = (m_i + log2f(l_i)) * LN2;
  }
}

}  // namespace

// o: contiguous (B, T, H, hs) bf16; lse: contiguous (B, H, T) fp32.
// q/k/v: (B, T, H, hs) bf16 with unit stride on hs; strides in elements, each a
// multiple of 8, base pointers 16-byte aligned (checked by the Python wrapper).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int gpt2vl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int T, int H, int hs,
                                long long qsb, long long qst, long long qsh,
                                long long ksb, long long kst, long long ksh,
                                long long vsb, long long vst, long long vsh,
                                int causal, void* stream) {
  if (hs != HS || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BM - 1) / BM, H, B);
  const float scale_log2 = LOG2E / sqrtf((float)HS);
  flash_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, T, H, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
      causal, scale_log2);
  return (int)cudaGetLastError();
}
