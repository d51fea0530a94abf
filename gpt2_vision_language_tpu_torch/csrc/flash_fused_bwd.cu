// One-pass flash-attention backward for Hopper (sm_90a): dq, dk and dv from one
// walk over the tile pairs, with the row term given by the caller. The backward
// of flash_attention_with_lse, one (query chunk, key chunk) pair of ring
// attention per launch: Tq != Tk, ragged lengths on both sides, right-aligned
// causal or non-causal.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _bwd_kernel_fused (launcher _bwd, stream_kv=False). Same function: for every
// visited (query tile, key tile) pair once, with S = q k^T / sqrt(hs) under the
// mask (query i at key position i + Tk - Tq) and P = exp(S - lse),
//   dV += P^T dO,  dP = dO V^T,  dS = P * (dP - dcap),
//   dK += dS^T Q / sqrt(hs),  dQ += dS K / sqrt(hs):
// five products and one exp per pair, where the split dq and dk/dv kernels
// (flash_general_bwd.cu) recompute S, P and dP and pay seven and two. dcap is
// an input, (B, H, Tq) fp32: D = rowsum(dO * O) for plain attention, D - dlse
// when the logsumexp carries a cotangent too (a chunk's lse feeds the merge of
// ring attention), exactly as the TPU kernel takes it. The scale is applied
// here, once to dk at its store and once to dq at its cast, because the
// forward applies it inside its kernel.
//
// What bounds it on the H100: a ring hop at Tq = Tk = 4096, H = 12, hs = 64
// without a mask is 5 * 2 * 12 * 4096^2 * 64 = 129 GFLOP against 50 MB of
// q/k/v/dO/dq/dk/dv: the tensor cores bound it by far.
//
// What the design does about it: the TPU kernel runs one program per (b, h),
// with everything of that head resident and dq summed over the key tiles in an
// fp32 scratch of all Tq rows. Here that scratch would be 1 MB at Tq = 4096 (a
// block has 227 KB) and B*H = 12 programs would leave 120 of 132 SMs idle. So
// one block owns a (b, h, 64-key tile): K and V of the tile stay in shared
// memory, dK and dV in fp32 tensor-core accumulators, and the block loops over
// the query tiles from the first one that sees it, max(0, (n0 - q_off) / 64).
// Four warps of 16 key rows each form S^T, P^T, dP^T and dS^T for their rows
// (nvcuda::wmma, bf16 16x16x16; the elementwise step goes through a per-warp
// shared scratch, P and dS rounded to bf16 before their products as on the
// TPU). For dQ the warps change roles: once every warp's dS^T tile is in
// shared memory, warp w forms the 16 query rows 16w.. of dS K over all 64 keys
// and adds them into a zero-initialised fp32 (B, Tq, H, hs) buffer in global
// memory with vector reductions (16 bytes each); a second kernel casts the
// buffer to bf16 times the scale. Blocks of different key tiles add into the
// same rows in no fixed order, so dq can differ in the last fp32 bits from
// run to run; dk and dv are deterministic. Padded rows: q, k, v and dO rows
// past their length are loaded as zero, and P is set to 0 by a select on the
// positions, never by exp of a padded lse, so no inf * 0 can reach dk/dv; rows
// past the length are neither stored nor added. All offsets are 64-bit.
// Simple first: synchronous loads, no cp.async, wgmma or TMA yet.

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
using FragAc = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragBr = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBc = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

struct Smem {
  bf16 q[BT * LDH];
  bf16 k[BT * LDH];
  bf16 v[BT * LDH];
  bf16 dO[BT * LDH];
  float lse2[BT];  // lse * log2(e) of the query tile
  float dcap[BT];  // the row term of the query tile
  bf16 p[WARPS][16 * LDP];   // P^T, then dS^T: 16 keys of a warp x 64 queries
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

// dst[0..3] += a, one 16-byte reduction in global memory (dst 16-byte aligned)
__device__ __forceinline__ void red_add4(float* dst, float4 a) {
  atomicAdd(reinterpret_cast<float4*>(dst), a);
}

__global__ void __launch_bounds__(THREADS)
flash_fused_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dO,
                       const float* __restrict__ lse, const float* __restrict__ dcap,
                       float* __restrict__ dq_acc, bf16* __restrict__ dk, bf16* __restrict__ dv,
                       int Tq, int Tk, int H,
                       long long qsb, long long qst, long long qsh,
                       long long ksb, long long kst, long long ksh,
                       long long vsb, long long vst, long long vsh,
                       int causal, float scale, float scale_log2) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n0 = blockIdx.x * BT;  // key tile; low tiles have the most query tiles
  const int h = blockIdx.y, b = blockIdx.z;
  const int q_off = Tk - Tq;  // query i sits at key position i + q_off
  const long long ost = (long long)H * HS;  // row stride of dO, dq_acc, dk, dv
  const bf16* qb = q + b * qsb + h * qsh;
  const bf16* dob = dO + (long long)b * Tq * ost + h * HS;
  float* dqb = dq_acc + (long long)b * Tq * ost + h * HS;
  const float* lseb = lse + ((long long)b * H + h) * Tq;
  const float* dcapb = dcap + ((long long)b * H + h) * Tq;

  load_tile(sm.k, k + b * ksb + h * ksh, kst, n0, Tk, tid);
  load_tile(sm.v, v + b * vsb + h * vsh, vst, n0, Tk, tid);

  FragC dkf[HS / 16], dvf[HS / 16];
#pragma unroll
  for (int n = 0; n < HS / 16; ++n) {
    wmma::fill_fragment(dkf[n], 0.f);
    wmma::fill_fragment(dvf[n], 0.f);
  }

  // two lanes per row of this warp: a key row in the S^T / dS^T steps (query
  // columns half * 32 ...), a query row in the dQ step (hs columns half * 32 ...)
  const int r = lane >> 1, half = lane & 1;
  const int kpos = n0 + warp * 16 + r;
  float* scratch = sm.s[warp];
  bf16* ptile = sm.p[warp];
  const float* srow = &scratch[r * LDS + half * (BT / 2)];
  bf16* prow = &ptile[r * LDP + half * (BT / 2)];

  const int nq = (Tq + BT - 1) / BT;
  // the first query tile with a row at or after this key tile's first key
  const int i0 = causal ? max(0, (n0 - q_off) / BT) : 0;
  for (int i = i0; i < nq; ++i) {
    const int m0 = i * BT;
    __syncthreads();  // every warp is done with the previous query tile and its dS^T tiles
    load_tile(sm.q, qb, qst, m0, Tq, tid);
    load_tile(sm.dO, dob, ost, m0, Tq, tid);
    for (int j = tid; j < BT; j += THREADS) {
      // rows >= Tq read as zero: their P is zeroed by position, not through these
      const int t = m0 + j;
      sm.lse2[j] = t < Tq ? lseb[t] * LOG2E : 0.f;
      sm.dcap[j] = t < Tq ? dcapb[t] : 0.f;
    }
    __syncthreads();

    // S^T (16 keys x 64 queries) = K_w Q^T
#pragma unroll
    for (int n = 0; n < BT / 16; ++n) {
      FragC sf;
      wmma::fill_fragment(sf, 0.f);
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
        FragA kf;
        FragBc qf;
        wmma::load_matrix_sync(kf, &sm.k[warp * 16 * LDH + kk * 16], LDH);
        wmma::load_matrix_sync(qf, &sm.q[n * 16 * LDH + kk * 16], LDH);
        wmma::mma_sync(sf, kf, qf, sf);
      }
      wmma::store_matrix_sync(&scratch[n * 16], sf, LDS, wmma::mem_row_major);
    }
    __syncwarp();

    // P^T = exp(S^T * scale - lse), masked by position; bf16 copy for the products
    float p[BT / 2];
#pragma unroll
    for (int c = 0; c < BT / 2; ++c) {
      const int qi = half * (BT / 2) + c;
      const int qrow = m0 + qi;
      const bool ok = qrow < Tq && kpos < Tk && (!causal || kpos <= qrow + q_off);
      p[c] = ok ? exp2f(srow[c] * scale_log2 - sm.lse2[qi]) : 0.f;
      prow[c] = __float2bfloat16(p[c]);
    }
    __syncwarp();

    // dV += P^T dO
#pragma unroll
    for (int n = 0; n < HS / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        FragA pf;
        FragBr of;
        wmma::load_matrix_sync(pf, &ptile[kk * 16], LDP);
        wmma::load_matrix_sync(of, &sm.dO[kk * 16 * LDH + n * 16], LDH);
        wmma::mma_sync(dvf[n], pf, of, dvf[n]);
      }
    }
    // dP^T (16 keys x 64 queries) = V_w dO^T
#pragma unroll
    for (int n = 0; n < BT / 16; ++n) {
      FragC df;
      wmma::fill_fragment(df, 0.f);
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk) {
        FragA vf;
        FragBc of;
        wmma::load_matrix_sync(vf, &sm.v[warp * 16 * LDH + kk * 16], LDH);
        wmma::load_matrix_sync(of, &sm.dO[n * 16 * LDH + kk * 16], LDH);
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

    // dK += dS^T Q
#pragma unroll
    for (int n = 0; n < HS / 16; ++n) {
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        FragA sf;
        FragBr qf;
        wmma::load_matrix_sync(sf, &ptile[kk * 16], LDP);
        wmma::load_matrix_sync(qf, &sm.q[kk * 16 * LDH + n * 16], LDH);
        wmma::mma_sync(dkf[n], sf, qf, dkf[n]);
      }
    }

    // dQ of this pair: warp w takes query rows 16w .. 16w + 15 over all 64 keys.
    // dS (16 queries x 16 keys of warp kk) is the transpose of a column block of
    // that warp's dS^T tile, read as a column-major A operand.
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
        FragBr kf;
        wmma::load_matrix_sync(kf, &sm.k[kk * 16 * LDH + n * 16], LDH);
        wmma::mma_sync(dqf[n], sf, kf, dqf[n]);
      }
    }
#pragma unroll
    for (int n = 0; n < HS / 16; ++n)
      wmma::store_matrix_sync(&scratch[n * 16], dqf[n], LDS, wmma::mem_row_major);
    __syncwarp();
    const int qrow = m0 + warp * 16 + r;
    if (qrow < Tq) {
      float* dst = dqb + (long long)qrow * ost + half * (HS / 2);
#pragma unroll
      for (int d = 0; d < HS / 2; d += 4)
        red_add4(dst + d, *reinterpret_cast<const float4*>(&srow[d]));
    }
    __syncwarp();  // the scratch is read before the next pair's S^T lands in it
  }

  // a key tile past every query's reach (non-causal never; causal only when
  // i0 >= nq) stores the zeros it was filled with
  const long long out = (((long long)b * Tk + kpos) * H + h) * HS;
  store_rows(dkf, scratch, dk + out, kpos < Tk, lane, scale);
  store_rows(dvf, scratch, dv + out, kpos < Tk, lane, 1.f);
}

// dq = bf16(dq_acc * scale), eight elements a thread
__global__ void flash_fused_dq_cast_kernel(const float* __restrict__ acc, bf16* __restrict__ dq,
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

// q: (B, Tq, H, hs), k/v: (B, Tk, H, hs), bf16 with unit stride on hs; strides
// in elements, each a multiple of 8, base pointers 16-byte aligned. dO, dq:
// contiguous (B, Tq, H, hs) bf16; dk, dv: contiguous (B, Tk, H, hs) bf16. lse,
// dcap: contiguous (B, H, Tq) fp32, lse from the forward, dcap = D - dlse from
// the caller. dq_acc: contiguous (B, Tq, H, hs) fp32 scratch, zeroed here. All
// checked by the Python wrapper. Zeroes the scratch, launches the one-pass
// kernel and the cast on `stream`; returns the first CUDA error code (0 on
// success).
extern "C" int gpt2vl_flash_fused_bwd(const void* q, const void* k, const void* v,
                                      const void* dO, const void* lse, const void* dcap,
                                      void* dq_acc, void* dq, void* dk, void* dv,
                                      int B, int Tq, int Tk, int H, int hs,
                                      long long qsb, long long qst, long long qsh,
                                      long long ksb, long long kst, long long ksh,
                                      long long vsb, long long vst, long long vsh,
                                      int causal, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || (causal && Tq > Tk) || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int smem = (int)sizeof(Smem);
  cudaError_t err = cudaFuncSetAttribute(flash_fused_bwd_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long n = (long long)B * Tq * H * HS;
  err = cudaMemsetAsync(dq_acc, 0, (size_t)n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;

  const float scale = 1.f / sqrtf((float)HS);
  const dim3 grid((Tk + BT - 1) / BT, H, B);
  flash_fused_bwd_kernel<<<grid, THREADS, smem, st>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO, (const float*)lse,
      (const float*)dcap, (float*)dq_acc, (bf16*)dk, (bf16*)dv, Tq, Tk, H, qsb, qst, qsh, ksb,
      kst, ksh, vsb, vst, vsh, causal, scale, scale * LOG2E);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long n8 = n / 8;
  flash_fused_dq_cast_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      (const float*)dq_acc, (bf16*)dq, n8, scale);
  return (int)cudaGetLastError();
}
