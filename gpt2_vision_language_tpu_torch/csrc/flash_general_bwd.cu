// General flash-attention backward for Hopper (sm_90a): the dq kernel and the
// D pre-kernel for Tq != Tk, ragged lengths on both sides, right-aligned causal
// or non-causal. Its dk/dv partner is flash_dkv_bwd.cu.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _dq_kernel_grid (step _dq_step), launched by _bwd with stream_kv=True. Same
// function: with P = exp(S - lse), S = q k^T / sqrt(hs) under the mask (query i
// at key position i + Tk - Tq), and D given by the caller,
//   dS = P * (dO V^T - D),  dQ = dS K / sqrt(hs).
// Like the TPU kernel it takes D as an input tensor (there `dcap`), so a caller
// that also has a cotangent of lse can pass D - dlse without a new kernel;
// gpt2vl_flash_rowdot below forms the plain D = rowsum(dO * O). Unlike the TPU
// kernel the scale is applied here (the forward applies it inside its kernel
// too), and q/k/v are read in their (B, T, H, hs) layout through strides. The
// TPU kernel walks a (B*H, nq, nk) grid in order and carries its accumulator
// in scratch memory across grid steps; blocks on the H100 run in no order, so
// the sweep is a loop inside the block that owns the query tile.
//
// What bounds it on the H100: at B=1, T=16384, H=12, hs=64 causal it does
// 3 * 2 * 12 * 16384^2 / 2 * 64 = 619 GFLOP (S, dP, dQ) against ~100 MB of
// q/k/v/dO/dq and the row statistics: the tensor cores bound it by far; the
// re-read tiles stay in L2.
//
// What the design does about it: one block per (b, h, 64-query tile) loops
// over the key tiles up to the last one its rows see and keeps dQ in fp32
// tensor-core accumulators (nvcuda::wmma, bf16 16x16x16): no atomics, and dq
// is deterministic. P and dS are rounded to bf16 before their products, as on
// the TPU. Four warps per block, 16 rows each; the elementwise step goes
// through a per-warp shared scratch. Blocks with the most tiles launch first
// (the highest query tiles, whatever q_off is). Padded rows: q, k, v and dO
// rows past their length are loaded as zero, and P is set to 0 by a select on
// the positions, never by exp of a padded lse; rows past the length are not
// stored. All offsets are 64-bit. Simple first: synchronous loads, no
// cp.async, wgmma or TMA yet.

#include <math.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr int HS = 64;           // head size the kernels are built for
constexpr int BT = 64;           // rows of a query tile and of a key tile
constexpr int WARPS = BT / 16;   // one warp per 16 rows
constexpr int THREADS = WARPS * 32;
constexpr int LDH = HS + 8;      // bf16 row pitch of the q/k/v/dO tiles
constexpr int LDP = BT + 8;      // bf16 row pitch of a warp's P / dS tile
constexpr int LDS = BT + 4;      // fp32 pitch of a warp's scratch (BT == HS)
constexpr float LOG2E = 1.4426950408889634f;

using bf16 = __nv_bfloat16;
using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Smem {
  bf16 q[BT * LDH];
  bf16 k[BT * LDH];
  bf16 v[BT * LDH];
  bf16 dO[BT * LDH];
  float lse2[BT];  // lse * log2(e) of the query tile
  float dd[BT];    // D of the query tile
  bf16 p[WARPS][16 * LDP];
  float s[WARPS][16 * LDS];
};

// rows [row0, row0 + BT) of one head into a (BT, LDH) tile; rows >= len are zero
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src, long long st, int row0,
                                          int len, int tid) {
  constexpr int VEC = 8;  // 16-byte loads
  constexpr int PER_ROW = HS / VEC;
  for (int i = tid; i < BT * PER_ROW; i += THREADS) {
    const int r = i / PER_ROW, c = (i % PER_ROW) * VEC;
    const int t = row0 + r;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (t < len) val = *reinterpret_cast<const uint4*>(src + (long long)t * st + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = val;
  }
}

// lse * log2(e) and D of query rows [m0, m0 + BT); rows >= Tq read as zero
// (their P is zeroed by position, not through these values)
__device__ __forceinline__ void load_row_stats(Smem& sm, const float* lse, const float* dd,
                                               int m0, int Tq, int tid) {
  for (int j = tid; j < BT; j += THREADS) {
    const int t = m0 + j;
    sm.lse2[j] = t < Tq ? lse[t] * LOG2E : 0.f;
    sm.dd[j] = t < Tq ? dd[t] : 0.f;
  }
}

// 16 x 64 fp32 accumulators (four fragments) of one warp -> one row per lane
// pair at `out` (a row of a contiguous (B, T, H, HS) bf16 tensor), times `mul`;
// `store` is false for rows past the length
__device__ __forceinline__ void store_rows(const FragC (&f)[HS / 16], float* scratch, bf16* out,
                                           bool store, int lane, float mul) {
#pragma unroll
  for (int n = 0; n < HS / 16; ++n)
    wmma::store_matrix_sync(&scratch[n * 16], f[n], LDS, wmma::mem_row_major);
  __syncwarp();
  const int r = lane >> 1, half = lane & 1;
  if (store) {
    const float* src = &scratch[r * LDS + half * (HS / 2)];
    bf16* dst = out + half * (HS / 2);
#pragma unroll
    for (int d = 0; d < HS / 2; d += 8) {
      __align__(16) bf16 tmp[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) tmp[e] = __float2bfloat16(src[d + e] * mul);
      *reinterpret_cast<uint4*>(dst + d) = *reinterpret_cast<const uint4*>(tmp);
    }
  }
  __syncwarp();
}

// D[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d]; eight lanes per row
__global__ void flash_rowdot_kernel(const bf16* __restrict__ dO, const bf16* __restrict__ o,
                                    float* __restrict__ dd, int B, int T, int H) {
  const long long rows = (long long)B * T * H;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx >> 3;
  const int part = (int)(idx & 7);
  float sum = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(dO + row * HS + part * 8);
    const uint4 c = *reinterpret_cast<const uint4*>(o + row * HS + part * 8);
    const bf16* pa = reinterpret_cast<const bf16*>(&a);
    const bf16* pc = reinterpret_cast<const bf16*>(&c);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += __bfloat162float(pa[e]) * __bfloat162float(pc[e]);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (row < rows && part == 0) {
    const int h = (int)(row % H);
    const long long bt = row / H;
    const int t = (int)(bt % T), b = (int)(bt / T);
    dd[((long long)b * H + h) * T + t] = sum;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_general_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ dd,
                        bf16* __restrict__ dq, int Tq, int Tk, int H,
                        long long qsb, long long qst, long long qsh,
                        long long ksb, long long kst, long long ksh,
                        long long vsb, long long vst, long long vsh,
                        int causal, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int m0 = (gridDim.x - 1 - blockIdx.x) * BT;  // longest causal rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_off = Tk - Tq;
  const long long ost = (long long)H * HS;
  const bf16* kb = k + b * ksb + h * ksh;
  const bf16* vb = v + b * vsb + h * vsh;

  load_tile(sm.q, q + b * qsb + h * qsh, qst, m0, Tq, tid);
  load_tile(sm.dO, dO + (long long)b * Tq * ost + h * HS, ost, m0, Tq, tid);
  load_row_stats(sm, lse + ((long long)b * H + h) * Tq, dd + ((long long)b * H + h) * Tq, m0,
                 Tq, tid);
  __syncthreads();

  FragA qf[HS / 16], of[HS / 16];
#pragma unroll
  for (int kk = 0; kk < HS / 16; ++kk) {
    wmma::load_matrix_sync(qf[kk], &sm.q[warp * 16 * LDH + kk * 16], LDH);
    wmma::load_matrix_sync(of[kk], &sm.dO[warp * 16 * LDH + kk * 16], LDH);
  }
  FragC dqf[HS / 16];
#pragma unroll
  for (int n = 0; n < HS / 16; ++n) wmma::fill_fragment(dqf[n], 0.f);

  // two lanes per query row: row r of this warp, key columns half * 32 ...
  const int r = lane >> 1, half = lane & 1;
  const int qrow = m0 + warp * 16 + r;
  const int qpos = qrow + q_off;
  const float lse2_r = sm.lse2[warp * 16 + r];
  const float d_r = sm.dd[warp * 16 + r];
  float* scratch = sm.s[warp];
  bf16* ptile = sm.p[warp];
  const float* srow = &scratch[r * LDS + half * (BT / 2)];
  bf16* prow = &ptile[r * LDP + half * (BT / 2)];

  const int n_all = (Tk + BT - 1) / BT;
  const int n_tiles = causal ? min(n_all, (q_off + m0 + BT - 1) / BT + 1) : n_all;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * BT;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile(sm.k, kb, kst, n0, Tk, tid);
    load_tile(sm.v, vb, vst, n0, Tk, tid);
    __syncthreads();

    // S = Q_w K^T (16 queries x 64 keys)
#pragma unroll
    for (int n = 0; n < BT / 16; ++n) {
      FragC sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
        FragBc kf;
        wmma::load_matrix_sync(kf, &sm.k[n * 16 * LDH + kk * 16], LDH);
        wmma::mma_sync(sf, qf[kk], kf, sf);
      }
      wmma::store_matrix_sync(&scratch[n * 16], sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    float p[BT / 2];
#pragma unroll
    for (int c = 0; c < BT / 2; ++c) {
      const int kpos = n0 + half * (BT / 2) + c;
      const bool ok = qrow < Tq && kpos < Tk && (!causal || kpos <= qpos);
      p[c] = ok ? exp2f(srow[c] * scale_log2 - lse2_r) : 0.f;
    }
    __syncwarp();  // scores read before dP overwrites the scratch

    // dP = dO_w V^T
#pragma unroll
    for (int n = 0; n < BT / 16; ++n) {
      FragC df;
      wmma::fill_fragment(df, 0.f);
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
        FragBc vf;
        wmma::load_matrix_sync(vf, &sm.v[n * 16 * LDH + kk * 16], LDH);
        wmma::mma_sync(df, of[kk], vf, df);
      }
      wmma::store_matrix_sync(&scratch[n * 16], df, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // dS = P * (dP - D), bf16
#pragma unroll
    for (int c = 0; c < BT / 2; ++c) prow[c] = __float2bfloat16(p[c] * (srow[c] - d_r));
    __syncwarp();

    // dQ += dS K
#pragma unroll
    for (int n = 0; n < HS / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        FragA sf;
        FragBr kf;
        wmma::load_matrix_sync(sf, &ptile[kk * 16], LDP);
        wmma::load_matrix_sync(kf, &sm.k[kk * 16 * LDH + n * 16], LDH);
        wmma::mma_sync(dqf[n], sf, kf, dqf[n]);
      }
    }
  }

  store_rows(dqf, scratch, dq + (((long long)b * Tq + qrow) * H + h) * HS, qrow < Tq, lane,
             scale);
}

bool bad_shape(int B, int Tq, int Tk, int H, int hs, int causal) {
  return hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || (causal && Tq > Tk) ||
         B > 65535 || H > 65535;
}

}  // namespace

// D = rowsum(dO * O): dO, o contiguous (B, T, H, hs) bf16 -> dd contiguous
// (B, H, T) fp32. Returns the CUDA error code of the launch (0 on success).
extern "C" int gpt2vl_flash_rowdot(const void* dO, const void* o, void* dd, int B, int T, int H,
                                   int hs, void* stream) {
  if (hs != HS || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)B * T * H * 8;
  flash_rowdot_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)dO, (const bf16*)o, (float*)dd, B, T, H);
  return (int)cudaGetLastError();
}

// q: (B, Tq, H, hs), k/v: (B, Tk, H, hs), bf16 with unit stride on hs; strides
// in elements, each a multiple of 8, base pointers 16-byte aligned. dO, dq:
// contiguous (B, Tq, H, hs) bf16. lse, dd: contiguous (B, H, Tq) fp32, lse from
// the forward, dd = D from the caller. All checked by the Python wrapper.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int gpt2vl_flash_general_dq(const void* q, const void* k, const void* v,
                                       const void* dO, const void* lse, const void* dd, void* dq,
                                       int B, int Tq, int Tk, int H, int hs,
                                       long long qsb, long long qst, long long qsh,
                                       long long ksb, long long kst, long long ksh,
                                       long long vsb, long long vst, long long vsh,
                                       int causal, void* stream) {
  if (bad_shape(B, Tq, Tk, H, hs, causal)) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_general_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)HS);
  const dim3 grid((Tq + BT - 1) / BT, H, B);
  flash_general_dq_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO, (const float*)lse,
      (const float*)dd, (bf16*)dq, Tq, Tk, H, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
      causal, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}
