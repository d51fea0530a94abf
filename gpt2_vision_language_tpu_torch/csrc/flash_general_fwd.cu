// General flash-attention forward for Hopper (sm_90a): Tq != Tk, ragged lengths
// on both sides, right-aligned causal or non-causal; bf16 q/k/v, fp32 online
// softmax, o + lse.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _fwd_kernel_grid (launcher _fwd, stream_kv=True): the forward that streams
// K/V one tile at a time and carries the softmax state across the sweep. Same
// function: O = softmax(q k^T / sqrt(hs) + mask) v and the per-row logsumexp,
// where under the causal mask query i sits at position i + (Tk - Tq) and sees
// the keys at or before it. The TPU kernel walks a (B*H, nq, nk) grid in order
// and carries max / sum / accumulator in scratch memory from one grid step to
// the next; blocks on the H100 run in no order, so here one block owns a
// (b, h, 64-query tile) and the key sweep is a loop inside it.
//
// What bounds it on the H100: at B=1, T=16384, H=12, hs=64 causal it is
// 2 * 12 * 16384^2 * 64 = 412 GFLOP against 101 MB of q/k/v/o, about 4,000
// FLOP per byte: the tensor cores, not HBM, bound it by far. Every query tile
// re-reads its K/V prefix, which stays in the 50 MB L2 (K and V of one head are
// 4 MB at T=16384).
//
// What the design does about it: four warps of 16 query rows each; K and V
// stream through shared memory in 64-key tiles, the scores of a tile never
// leave the SM. Products run on the tensor cores through nvcuda::wmma (bf16
// 16x16x16, fp32 accumulate); the softmax state lives in registers, two lanes
// per query row, and the wmma accumulators pass through a per-warp shared
// scratch because their register layout is opaque. A causal block stops at
// the last key tile any of its rows sees, min((q_off + m0 + 63) / 64 + 1,
// ceil(Tk / 64)), and the blocks with the most tiles are scheduled first (the
// highest query tiles, whatever q_off is). Because q_off need not be a
// multiple of 64, a row can have no visible key in a tile its block visits:
// its scores there are -inf, its running max does not move, and exp2(-inf) = 0
// adds nothing. Keys >= Tk are masked, query rows >= Tq are loaded as zero and
// not stored. All offsets are 64-bit. Simple first: synchronous loads, no
// cp.async, wgmma or TMA yet.

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

// rows [row0, row0 + ROWS) of one head into a (ROWS, LDH) tile; rows >= len are zero
template <int ROWS>
__device__ __forceinline__ void load_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          long long st, int row0, int len, int tid) {
  constexpr int VEC = 8;  // 16-byte loads
  constexpr int PER_ROW = HS / VEC;
  for (int i = tid; i < ROWS * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < len) val = *reinterpret_cast<const uint4*>(src + (long long)t * st + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_general_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                         const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                         float* __restrict__ lse, int Tq, int Tk, int H,
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
  const int q_off = Tk - Tq;  // query i sits at key position i + q_off
  const __nv_bfloat16* qb = q + b * qsb + h * qsh;
  const __nv_bfloat16* kb = k + b * ksb + h * ksh;
  const __nv_bfloat16* vb = v + b * vsb + h * vsh;

  load_tile<BM>(sm.q, qb, qst, m0, Tq, tid);

  const int n_all = (Tk + BN - 1) / BN;
  const int n_tiles = causal ? min(n_all, (q_off + m0 + BM - 1) / BN + 1) : n_all;

  // two lanes per query row: row r of this warp, columns half * (width / 2) ...
  const int r = lane >> 1, half = lane & 1;
  const int qrow = m0 + warp * 16 + r;  // row of q, o and lse
  const int qpos = qrow + q_off;        // its position among the keys
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
    load_tile<BN>(sm.k, kb, kst, n0, Tk, tid);
    load_tile<BN>(sm.v, vb, vst, n0, Tk, tid);
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

    // online softmax over this lane's half row; a row with no visible key in
    // this tile keeps its max (m_i starts finite, so m_i - m_new is never
    // -inf - -inf) and adds exp2(-inf) = 0
    const float* srow = &scratch[r * LDS + half * (BN / 2)];
    const int c0 = n0 + half * (BN / 2);
    float x[BN / 2];
    float mx = -INFINITY;
#pragma unroll
    for (int c = 0; c < BN / 2; ++c) {
      const int kpos = c0 + c;
      const bool ok = kpos < Tk && (!causal || kpos <= qpos);
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

  if (qrow < Tq) {
    // every row of a right-aligned causal mask with Tq <= Tk sees key 0, so
    // l_i > 0; the guard keeps a fully masked row at o = 0 instead of NaN
    const float inv = l_i > 0.f ? 1.f / l_i : 0.f;
    __nv_bfloat16* orow = o + (((long long)b * Tq + qrow) * H + h) * HS + half * (HS / 2);
#pragma unroll
    for (int d = 0; d < HS / 2; d += 8) {
      __align__(16) __nv_bfloat16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) tmp[e] = __float2bfloat16(acc[d + e] * inv);
      *reinterpret_cast<uint4*>(orow + d) = *reinterpret_cast<const uint4*>(tmp);
    }
    if (half == 0) lse[((long long)b * H + h) * Tq + qrow] = (m_i + log2f(l_i)) * LN2;
  }
}

}  // namespace

// q: (B, Tq, H, hs), k/v: (B, Tk, H, hs), bf16 with unit stride on hs; strides
// in elements, each a multiple of 8, base pointers 16-byte aligned (checked by
// the Python wrapper, which also rejects causal with Tq > Tk). o: contiguous
// (B, Tq, H, hs) bf16; lse: contiguous (B, H, Tq) fp32.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int gpt2vl_flash_general_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int Tq, int Tk, int H, int hs,
                                        long long qsb, long long qst, long long qsh,
                                        long long ksb, long long kst, long long ksh,
                                        long long vsb, long long vst, long long vsh,
                                        int causal, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || (causal && Tq > Tk) || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_general_fwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + BM - 1) / BM, H, B);
  const float scale_log2 = LOG2E / sqrtf((float)HS);
  flash_general_fwd_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
      (__nv_bfloat16*)o, (float*)lse, Tq, Tk, H, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
      causal, scale_log2);
  return (int)cudaGetLastError();
}
