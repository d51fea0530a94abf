// One-pass flash-attention backward in the "dt" layout for Hopper (sm_90a): q,
// k, v, dO and dq, dk, dv are (H, hs, B*T) bf16, the sequence contiguous and one
// slab of T positions per batch row; q arrives pre-scaled by 1/sqrt(hs).
//
// Replaces the TPU kernel tools/ab_dt_flash.py _bwd_dt_kernel (launcher
// flash_bwd_dt_b). Same function: for every visited (query tile, key tile) pair
// once, with S = q^T k under the mask (query i sees keys <= i) and
// P = exp(S - lse),
//   dV += dO P,  dP = dO^T V,  dS = P * (dP - dcap),  dK += Q dS,  dQ += K dS^T,
// dq times dq_scale at the end. lse and dcap = rowsum(dO * O) are one fp32 row
// per query, (H, B*Tq). Aligned shapes only, Tq % 64 == Tk % 64 == 0.
//
// What bounds it on the H100: at B=8, T=1024, H=12, hs=64 causal it is
// 2.5 * 12.9 = 32 GFLOP against 88 MB of q/k/v/dO/dq/dk/dv: the tensor cores.
//
// What the design does about it: the TPU kernel runs one program per (h, b) with
// the whole head resident and dq summed in an fp32 VMEM scratch of all Tq
// positions; here that would be 96 programs for 132 SMs and a scratch larger
// than a block's shared memory. So, as flash_fused_bwd.cu, one block owns a
// (b, h, 64-key tile): K and V of the tile stay in shared memory as they lie in
// memory, [d][key], dK and dV in fp32 tensor-core accumulators, and the block
// loops over the query tiles from the diagonal one. Four warps of 16 keys each
// form S^T, P^T, dP^T and dS^T for their keys (nvcuda::wmma, bf16 16x16x16); the
// [d][position] tiles are read transposed where flash_fused_bwd.cu reads them
// straight: K_w and V_w as column-major A operands, Q^T and dO^T as row-major B
// operands, dO and Q for dV and dK as column-major B operands. For dQ the warps
// change roles: warp w forms the 16 queries 16w.. of dS K over all 64 keys and
// adds them into a zero-initialised fp32 (H, hs, B*Tq) buffer in global memory
// with 16-byte reductions along the sequence; a second kernel casts the buffer to
// bf16 times dq_scale. So dq is summed across the blocks of different key tiles
// in no fixed order and can differ in its last fp32 bits from run to run; dk and
// dv are deterministic. dK, dV and the dQ tile are stored column-major into the
// warp's scratch so that global memory sees runs along the sequence. Simple
// first: synchronous loads, no cp.async, wgmma or TMA yet.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HS = 64;           // head size the kernels are built for
constexpr int BT = 64;           // positions of a query tile and of a key tile
constexpr int WARPS = BT / 16;   // one warp per 16 positions
constexpr int THREADS = WARPS * 32;
constexpr int LDT = BT + 8;      // bf16 row pitch of a [d][position] tile
constexpr int LDP = BT + 8;      // bf16 row pitch of a warp's P / dS tile
constexpr int LDS = BT + 4;      // fp32 pitch of a warp's row-major scratch (16 x 64)
constexpr int LDC = 16 + 4;      // fp32 pitch of a warp's column-major scratch (64 x 16)
constexpr int SCRATCH = HS * LDC > 16 * LDS ? HS * LDC : 16 * LDS;
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Smem {
  bf16 q[HS * LDT];   // [d][query]
  bf16 k[HS * LDT];   // [d][key]
  bf16 v[HS * LDT];   // [d][key]
  bf16 dO[HS * LDT];  // [d][query]
  float lse2[BT];     // lse * log2(e) of the query tile
  float dcap[BT];     // the row term of the query tile
  bf16 p[WARPS][16 * LDP];  // P^T, then dS^T: 16 keys of a warp x 64 queries
  float s[WARPS][SCRATCH];
};

// positions [pos0, pos0 + 64) of the HS rows of one head: src points at row 0,
// position 0 of the slab, `row` is the row stride (B*T)
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long row, int pos0,
                                          int tid) {
  constexpr int VEC = 8;  // 16-byte loads
  constexpr int PER_ROW = BT / VEC;
  for (int i = tid; i < HS * PER_ROW; i += THREADS) {
    const int d = i / PER_ROW, c = (i % PER_ROW) * VEC;
    *reinterpret_cast<uint4*>(dst + d * LDT + c) =
        *reinterpret_cast<const uint4*>(src + d * row + pos0 + c);
  }
}

// 16 positions x 64 d fp32 accumulators (four fragments) of one warp -> out[d * row + pos],
// pos = 0..15 (32 contiguous bytes per d), through the warp's column-major scratch
__device__ __forceinline__ void store_cols(const FragC (&f)[HS / 16], float* scratch, bf16* out,
                                           long long row, int lane) {
#pragma unroll
  for (int n = 0; n < HS / 16; ++n)
    wmma::store_matrix_sync(&scratch[n * 16 * LDC], f[n], LDC, wmma::mem_col_major);
  __syncwarp();
#pragma unroll
  for (int it = 0; it < HS * 2 / 32; ++it) {
    const int idx = it * 32 + lane;
    const int d = idx >> 1, c = (idx & 1) * 8;
    const float* src = &scratch[d * LDC + c];
    __align__(16) bf16 tmp[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) tmp[e] = __float2bfloat16(src[e]);
    *reinterpret_cast<uint4*>(out + d * row + c) = *reinterpret_cast<const uint4*>(tmp);
  }
  __syncwarp();
}

// dst[0..3] += a, one 16-byte reduction in global memory (dst 16-byte aligned)
__device__ __forceinline__ void red_add4(float* dst, float4 a) {
  atomicAdd(reinterpret_cast<float4*>(dst), a);
}

__global__ void __launch_bounds__(THREADS)
flash_dt_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dO,
                    const float* __restrict__ lse, const float* __restrict__ dcap,
                    float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                    int B, int Tq, int Tk, int causal) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BT;  // key tile; low tiles have the most query tiles
  const int h = blockIdx.y, b = blockIdx.z;
  const long long qrow = (long long)B * Tq, krow = (long long)B * Tk;
  const long long qoff = (long long)h * HS * qrow + (long long)b * Tq;
  const long long koff = (long long)h * HS * krow + (long long)b * Tk;
  const bf16* qb = q + qoff;
  const bf16* dob = dO + qoff;
  float* dqb = dq_acc + qoff;
  const float* lseb = lse + (long long)h * qrow + (long long)b * Tq;
  const float* dcapb = dcap + (long long)h * qrow + (long long)b * Tq;

  load_tile(sm.k, k + koff, krow, n0, tid);
  load_tile(sm.v, v + koff, krow, n0, tid);

  FragC dkf[HS / 16], dvf[HS / 16];
#pragma unroll
  for (int n = 0; n < HS / 16; ++n) {
    wmma::fill_fragment(dkf[n], 0.f);
    wmma::fill_fragment(dvf[n], 0.f);
  }

  // two lanes per key of this warp in the S^T / dS^T steps (query columns half * 32 ...)
  const int r = lane >> 1, half = lane & 1;
  const int kpos = n0 + warp * 16 + r;
  float* scratch = sm.s[warp];
  bf16* ptile = sm.p[warp];
  const float* srow = &scratch[r * LDS + half * (BT / 2)];
  bf16* prow = &ptile[r * LDP + half * (BT / 2)];

  const int nq = Tq / BT;
  const int i0 = causal ? n0 / BT : 0;  // the first query tile that sees this key tile
  for (int i = i0; i < nq; ++i) {
    const int m0 = i * BT;
    __syncthreads();  // every warp is done with the previous query tile and its dS^T tiles
    load_tile(sm.q, qb, qrow, m0, tid);
    load_tile(sm.dO, dob, qrow, m0, tid);
    for (int j = tid; j < BT; j += THREADS) {
      sm.lse2[j] = lseb[m0 + j] * LOG2E;
      sm.dcap[j] = dcapb[m0 + j];
    }
    __syncthreads();

    // S^T (16 keys x 64 queries) = K_w^T Q
#pragma unroll
    for (int n = 0; n < BT / 16; ++n) {
      FragC sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
        FragAc kf;
        FragBr qf;
        wmma::load_matrix_sync(kf, &sm.k[kk * 16 * LDT + warp * 16], LDT);
        wmma::load_matrix_sync(qf, &sm.q[kk * 16 * LDT + n * 16], LDT);
        wmma::mma_sync(sf, kf, qf, sf);
      }
      wmma::store_matrix_sync(&scratch[n * 16], sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // P^T = exp(S^T - lse), masked by position; bf16 copy for the products
    float p[BT / 2];
#pragma unroll
    for (int c = 0; c < BT / 2; ++c) {
      const int qi = half * (BT / 2) + c;
      const bool ok = !causal || kpos <= m0 + qi;
      p[c] = ok ? exp2f(srow[c] * LOG2E - sm.lse2[qi]) : 0.f;
      prow[c] = __float2bfloat16(p[c]);
    }
    __syncwarp();

    // dV (16 keys x 64 d) += P^T dO^T; dO^T (queries x d) is the [d][query] tile column-major
#pragma unroll
    for (int n = 0; n < HS / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        FragA pf;
        FragBc of;
        wmma::load_matrix_sync(pf, &ptile[kk * 16], LDP);
        wmma::load_matrix_sync(of, &sm.dO[n * 16 * LDT + kk * 16], LDT);
        wmma::mma_sync(dvf[n], pf, of, dvf[n]);
      }
    }
    // dP^T (16 keys x 64 queries) = V_w^T dO
#pragma unroll
    for (int n = 0; n < BT / 16; ++n) {
      FragC df;
      wmma::fill_fragment(df, 0.f);
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
        FragAc vf;
        FragBr of;
        wmma::load_matrix_sync(vf, &sm.v[kk * 16 * LDT + warp * 16], LDT);
        wmma::load_matrix_sync(of, &sm.dO[kk * 16 * LDT + n * 16], LDT);
        wmma::mma_sync(df, vf, of, df);
      }
      wmma::store_matrix_sync(&scratch[n * 16], df, LDS, wmma::mem_row_major);
    }
    __syncwarp();  // dP stored, and P read by the dV products, before dS overwrites it

    // dS^T = P^T * (dP^T - dcap)
#pragma unroll
    for (int c = 0; c < BT / 2; ++c) {
      const int qi = half * (BT / 2) + c;
      prow[c] = __float2bfloat16(p[c] * (srow[c] - sm.dcap[qi]));
    }
    __syncwarp();

    // dK (16 keys x 64 d) += dS^T Q^T; Q^T (queries x d) is the [d][query] tile column-major
#pragma unroll
    for (int n = 0; n < HS / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        FragA sf;
        FragBc qf;
        wmma::load_matrix_sync(sf, &ptile[kk * 16], LDP);
        wmma::load_matrix_sync(qf, &sm.q[n * 16 * LDT + kk * 16], LDT);
        wmma::mma_sync(dkf[n], sf, qf, dkf[n]);
      }
    }

    // dQ of this pair: warp w takes queries 16w .. 16w + 15 over all 64 keys. dS
    // (16 queries x 16 keys of warp kk) is the transpose of a column block of that
    // warp's dS^T tile, read as a column-major A operand; K^T (keys x d) is the
    // [d][key] tile read as a column-major B operand.
    __syncthreads();  // every warp's dS^T tile is written
    FragC dqf[HS / 16];
#pragma unroll
    for (int n = 0; n < HS / 16; ++n) wmma::fill_fragment(dqf[n], 0.f);
#pragma unroll
    for (int kk = 0; kk < WARPS; ++kk) {
      FragAc sf;
      wmma::load_matrix_sync(sf, &sm.p[kk][warp * 16], LDP);
#pragma unroll
      for (int n = 0; n < HS / 16; ++n) {
        FragBc kf;
        wmma::load_matrix_sync(kf, &sm.k[n * 16 * LDT + kk * 16], LDT);
        wmma::mma_sync(dqf[n], sf, kf, dqf[n]);
      }
    }
    // column-major into the scratch, [d][16 queries], then four 16-byte
    // reductions per d along the sequence
#pragma unroll
    for (int n = 0; n < HS / 16; ++n)
      wmma::store_matrix_sync(&scratch[n * 16 * LDC], dqf[n], LDC, wmma::mem_col_major);
    __syncwarp();
    float* dst = dqb + m0 + warp * 16;
#pragma unroll
    for (int it = 0; it < HS * 4 / 32; ++it) {
      const int idx = it * 32 + lane;
      const int d = idx >> 2, c = (idx & 3) * 4;
      red_add4(dst + d * qrow + c, *reinterpret_cast<const float4*>(&scratch[d * LDC + c]));
    }
    __syncwarp();  // the scratch is read before the next pair's S^T lands in it
  }

  const long long out = koff + n0 + warp * 16;
  store_cols(dkf, scratch, dk + out, krow, lane);
  store_cols(dvf, scratch, dv + out, krow, lane);
}

// dq = bf16(dq_acc * scale), eight elements a thread
__global__ void flash_dt_dq_cast_kernel(const float* __restrict__ acc, bf16* __restrict__ dq,
                                        long long n8, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(acc)[2 * i];
  const float4 c = reinterpret_cast<const float4*>(acc)[2 * i + 1];
  __align__(16) bf16 tmp[8];
  tmp[0] = __float2bfloat16(a.x * scale);
  tmp[1] = __float2bfloat16(a.y * scale);
  tmp[2] = __float2bfloat16(a.z * scale);
  tmp[3] = __float2bfloat16(a.w * scale);
  tmp[4] = __float2bfloat16(c.x * scale);
  tmp[5] = __float2bfloat16(c.y * scale);
  tmp[6] = __float2bfloat16(c.z * scale);
  tmp[7] = __float2bfloat16(c.w * scale);
  reinterpret_cast<uint4*>(dq)[i] = *reinterpret_cast<const uint4*>(tmp);
}

}  // namespace

// q, dO, dq: contiguous (H, hs, B*Tq) bf16; k, v, dk, dv: contiguous
// (H, hs, B*Tk) bf16; lse, dcap: contiguous (H, B*Tq) fp32; dq_acc: contiguous
// (H, hs, B*Tq) fp32 scratch, zeroed here. Tq and Tk multiples of 64, base
// pointers 16-byte aligned (checked by the Python wrapper). Zeroes the scratch,
// launches the one-pass kernel and the cast on `stream`; returns the first CUDA
// error code (0 on success).
extern "C" int gpt2vl_flash_dt_bwd(const void* q, const void* k, const void* v, const void* dO,
                                   const void* lse, const void* dcap, void* dq_acc, void* dq,
                                   void* dk, void* dv, int B, int Tq, int Tk, int H, int hs,
                                   int causal, float dq_scale, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Tq % BT || Tk % BT || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_dt_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)H * HS * B * Tq;
  err = cudaMemsetAsync(dq_acc, 0, (size_t)n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;

  const dim3 grid(Tk / BT, H, B);
  flash_dt_bwd_kernel<<<grid, THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO, (const float*)lse,
      (const float*)dcap, (float*)dq_acc, (bf16*)dk, (bf16*)dv, B, Tq, Tk, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long n8 = n / 8;
  flash_dt_dq_cast_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      (const float*)dq_acc, (bf16*)dq, n8, dq_scale);
  return (int)cudaGetLastError();
}
