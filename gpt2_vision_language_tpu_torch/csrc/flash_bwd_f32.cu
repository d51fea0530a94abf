// Self-attention flash backward on fp32 operands for Hopper (sm_90a): dq, dk,
// dv from the saved lse, Tq == Tk = T, causal or not, T ragged; fp32
// q/k/v/o/dO, true fp32 products (FFMAs on the CUDA cores, no TF32).
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _bwd_dt_kernel (launcher _bwd_dt) where it runs on fp32 operands: its
// products take the operands' precision, its outputs q.dtype. Same function as
// flash_bwd.cu, the bf16 kernel: with S = q k^T / sqrt(hs) (causal-masked),
// P = exp(S - lse) and D = rowsum(dO * O),
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = dS K / sqrt(hs),  dK = dS^T Q / sqrt(hs).
// D comes from the small kernel at the top of this file (fp32 dO and O; the
// bf16 kernel's D pre-kernel reads bf16). q/k/v are read in their
// (B, T, H, hs) layout through strides, so the strided views of the fused QKV
// projection go in without a copy; o and dO are contiguous.
//
// What bounds it on the H100: the tensor cores take fp32 only as TF32, which
// keeps 10 bits of mantissa; the JAX kernel's fp32 products keep 23. So every
// product is an FFMA on the CUDA cores, 67 TFLOP/s at most (NVIDIA's data
// sheet, SXM, 700 W). At the training shape (B=8, T=1024, H=12, hs=64,
// causal) the five products of the visible pairs are 2 * 5 * B * H * T(T+1)/2
// * hs = 32.2 GFLOP, 0.48 ms, against 0.06 ms for the 201 MB of q/k/v/o/dO/
// dq/dk/dv: operations bound it. The kernel runs seven products a visible
// pair (below), so 0.67 ms is its own ceiling. What keeps an FFMA kernel off
// that rate is the share of instruction slots spent on shared-memory reads, and
// latency (of those reads and of the tile copies) that no other warp or
// independent FFMA hides.
//
// What the design does about it (flash_f32.cuh holds the pieces): one grid
// of two kinds of block of 128 threads (4 warps), every product from
// outer-product register tiles of 32 values a thread, as in an SGEMM.
//   - A dk/dv block owns 64 keys of one (b, h), a warp 16 of them; K^T / sqrt(hs)
//     and V^T are resident (d-major, transposed once). It sweeps the 64-row
//     query tiles from the diagonal on: q, dO, lse and D in two slots, tile
//     i + 1 copied by cp.async while tile i is computed on. S and dP are 4
//     rows x 8 keys a thread (per 4 channels 4 float4 of q or dO rows and 8
//     float4 of K^T or V^T for 128 FFMAs); P and dS go, 16 rows at a time,
//     into the warp's 16 columns of a shared [row][key] tile, read back by the
//     same warp for dV += P^T dO and dK += dS^T q, 4 keys x 8 channels a
//     thread (per row 1 float4 of P and 2 of dO or q for 32 FFMAs).
//   - A dq block owns 64 queries, a warp 16; q^T / sqrt(hs), dO^T, lse and D
//     are resident. It sweeps the key tiles up to the diagonal, K and V in
//     two slots by cp.async. S and dP are 8 rows x 4 keys a thread (the
//     forward's product at half its keys); dS goes, 16 keys at a time, into
//     the warp's dS^T quarter, read back for dQ += dS K, 8 rows x 4 channels
//     a thread.
//   - Seven products per visited pair where a one-pass block does five, but
//     no atomics: dq, dk and dv are summed in a fixed order and are bit-equal
//     from run to run. S is summed in the forward kernel's order in both
//     blocks, so P here is the forward's P.
//   - Occupancy: shared memory sets it, at 110 KB for a dk/dv block (two slots
//     of q and dO, resident K^T and V^T): two blocks, 8 warps, an SM
//     (__launch_bounds__(128, 2)). Four 32-value tiles (S, dP, dK, dV) are
//     live in a dk/dv thread (215 registers by ptxas, no spills), so 16
//     warps would need both half the shared memory and 128 registers: the
//     dk/dv block would lose its second slot or its 8 x 4 tiles. Each thread
//     hides latency with its own 32 independent accumulators instead.
// Kept from the previous design: the causal tile skip; in each (b, h) the
// dk/dv blocks first, key tile 0 (the longest causal sweep) leading, then
// the dq blocks, the last query tile leading; P = 0 on padded rows; zero-
// filled rows past T; 64-bit offsets.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_f32.cuh"

namespace {

using namespace f32;

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;      // resident blocks an SM (shared memory allows two)
constexpr int ROWDOT_THREADS = 256;

// a dk/dv block: K^T, V^T resident; a query tile of q, dO, lse, D in two
// slots; P and dS of 16 query rows
struct SmemDkv {
  float kt[HS][TILE];  // K^T / sqrt(hs): [channel][key]
  float vt[HS][TILE];  // V^T: [channel][key]
  Tile q[2];
  Tile dO[2];
  float lse[2][TILE];
  float dd[2][TILE];
  float p[16][LDT];    // P: [row][key]
  float ds[16][LDT];   // dS: [row][key]
};

// a dq block: q^T, dO^T, lse, D resident; a key tile of K and V in two slots;
// per warp dS^T of 16 keys
struct SmemDq {
  float qt[HS][TILE];  // q^T / sqrt(hs): [channel][row]
  float dOt[HS][TILE]; // dO^T: [channel][row]
  float lse[TILE];
  float dd[TILE];
  Tile k[2];
  Tile v[2];
  Quarter<16> dst[WARPS];  // per warp: dS^T of 16 keys
};

constexpr int SMEM = sizeof(SmemDkv) > sizeof(SmemDq) ? (int)sizeof(SmemDkv) : (int)sizeof(SmemDq);

struct Strides {
  long long sb, st, sh;
};

// q and dO rows q0 .. q0 + 63 of (b, h) and their lse and D into slot `slot`
// of a dk/dv block, asynchronously; zeros past T
__device__ __forceinline__ void load_query_tile(SmemDkv& s, int slot, const float* qb,
                                                long long qst, const float* dob, long long dost,
                                                const float* lse_bh, const float* dd_bh, int q0,
                                                int T, int tid) {
  load_tile_async<THREADS>(s.q[slot], qb, qst, q0, T, tid);
  load_tile_async<THREADS>(s.dO[slot], dob, dost, q0, T, tid);
  const int r = tid & (TILE - 1), t = q0 + r;
  if (tid < TILE)
    cp_async4(&s.lse[slot][r], lse_bh + (t < T ? t : 0), t < T ? 4 : 0);
  else
    cp_async4(&s.dd[slot][r], dd_bh + (t < T ? t : 0), t < T ? 4 : 0);
}

// rows row0 + r of a (B, T, H, hs) contiguous output, 8 channels a thread
// (4g .. 4g + 3, 32 + 4g .. 32 + 4g + 3) times scale, for the 4 rows
// key0 + kk of the tile
__device__ __forceinline__ void store_keys(float* __restrict__ out, const float (&acc)[4][8],
                                           float scale, int b, int h, int H, int row0, int T,
                                           int g) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int t = row0 + kk;
    if (t < T) {
      float* dst = out + (((long long)b * T + t) * H + h) * HS;
      *reinterpret_cast<float4*>(dst + 4 * g) =
          make_float4(acc[kk][0] * scale, acc[kk][1] * scale, acc[kk][2] * scale,
                      acc[kk][3] * scale);
      *reinterpret_cast<float4*>(dst + 32 + 4 * g) =
          make_float4(acc[kk][4] * scale, acc[kk][5] * scale, acc[kk][6] * scale,
                      acc[kk][7] * scale);
    }
  }
}

// D = rowsum(dO * O) over contiguous (B, T, H, hs) fp32: 16 threads a row, one
// float4 each, D written (B, H, T)
__global__ void __launch_bounds__(ROWDOT_THREADS)
rowdot_f32_kernel(const float* __restrict__ dO, const float* __restrict__ o,
                  float* __restrict__ dd, int T, int H, long long rows) {
  const long long r = (long long)blockIdx.x * (ROWDOT_THREADS / 16) + (threadIdx.x >> 4);
  const int c4 = threadIdx.x & 15;
  float acc = 0.f;
  if (r < rows) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(dO + r * HS) + c4);
    const float4 b = __ldg(reinterpret_cast<const float4*>(o + r * HS) + c4);
    acc = a.x * b.x;
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (c4 == 0 && r < rows) {
    const long long h = r % H, t = (r / H) % T, b = r / ((long long)H * T);
    dd[(b * H + h) * T + t] = acc;
  }
}

// Block x of (h, b): x < nt is the dk/dv block of key tile x, x >= nt the dq
// block of query tile 2 nt - 1 - x.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int T, int H, Strides qs, Strides ks, Strides vs, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int nt = (T + TILE - 1) / TILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const float* qb = q + (long long)b * qs.sb + (long long)h * qs.sh;
  const float* kb = k + (long long)b * ks.sb + (long long)h * ks.sh;
  const float* vb = v + (long long)b * vs.sb + (long long)h * vs.sh;
  const float* dob = dO + ((long long)b * T * H + h) * HS;  // contiguous (B, T, H, hs)
  const long long dost = (long long)H * HS;
  const float scale = 0.125f;  // 1 / sqrt(64), exact

  if ((int)blockIdx.x < nt) {
    // dk/dv block: keys k0 .. k0 + 63, query tiles from the diagonal on
    SmemDkv& s = *reinterpret_cast<SmemDkv*>(smem_raw);
    const int kt = blockIdx.x, k0 = kt * TILE;
    const int rg = lane & 15, kg = lane >> 4;  // S, dP: rows rg + 16 i, keys 16 warp + 8 kg + j
    // dK, dV: keys 16 warp + 4 kq + kk, channels by g; a quarter-warp spans
    // 4 kq x 2 g, so its reads of dO and q rows ask for two addresses
    const int kq = (lane & 7) >> 1, g = 2 * (lane >> 3) + (lane & 1);
    const int it0 = causal ? kt : 0;
    load_query_tile(s, 0, qb, qs.st, dob, dost, lse + bh * T, dd + bh * T, it0 * TILE, T, tid);
    cp_async_commit();
    load_transposed<THREADS, TILE>(&s.kt[0][0], kb, ks.st, k0, T, scale, tid);
    load_transposed<THREADS, TILE>(&s.vt[0][0], vb, vs.st, k0, T, 1.f, tid);
    float acc_k[4][8], acc_v[4][8];
    zero(acc_k);
    zero(acc_v);
    for (int it = it0; it < nt; ++it) {
      const int slot = (it - it0) & 1, q0 = it * TILE;
      cp_async_wait_all();
      __syncthreads();  // tile it is in; every warp is done with tile it - 1's slot
      if (it + 1 < nt)
        load_query_tile(s, slot ^ 1, qb, qs.st, dob, dost, lse + bh * T, dd + bh * T, q0 + TILE, T,
                        tid);
      cp_async_commit();

      float sc[4][8], dp[4][8];
      zero(sc);
      zero(dp);
      keys_by_rows(sc, s.q[slot], &s.kt[0][16 * warp + 8 * kg], rg);
      keys_by_rows(dp, s.dO[slot], &s.vt[0][16 * warp + 8 * kg], rg);
      // P = exp(S - lse) where visible, else 0; dS = P (dP - D)
      const bool edge = (causal && it == kt) || q0 + TILE > T || k0 + TILE > T;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = rg + 16 * i, qq = q0 + r;
        const float l = s.lse[slot][r], dr = s.dd[slot][r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int kk = k0 + 16 * warp + 8 * kg + j;
          const bool masked = edge && (qq >= T || kk >= T || (causal && kk > qq));
          const float p = masked ? 0.f : expf(sc[i][j] - l);
          sc[i][j] = p;
          dp[i][j] = p * (dp[i][j] - dr);
        }
      }
      // dV += P^T dO, dK += dS^T q, 16 query rows at a time through the
      // warp's columns of P and dS
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        float* prow = &s.p[rg][16 * warp + 8 * kg];
        float* drow = &s.ds[rg][16 * warp + 8 * kg];
        *reinterpret_cast<float4*>(prow) = make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
        *reinterpret_cast<float4*>(prow + 4) =
            make_float4(sc[i][4], sc[i][5], sc[i][6], sc[i][7]);
        *reinterpret_cast<float4*>(drow) = make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
        *reinterpret_cast<float4*>(drow + 4) =
            make_float4(dp[i][4], dp[i][5], dp[i][6], dp[i][7]);
        __syncwarp();
        acc_rows(acc_v, s.p, 16 * warp + 4 * kq, s.dO[slot], 16 * i, g);
        acc_rows(acc_k, s.ds, 16 * warp + 4 * kq, s.q[slot], 16 * i, g);
        __syncwarp();
      }
    }
    cp_async_wait_all();
    store_keys(dk, acc_k, scale, b, h, H, k0 + 16 * warp + 4 * kq, T, g);
    store_keys(dv, acc_v, 1.f, b, h, H, k0 + 16 * warp + 4 * kq, T, g);
  } else {
    // dq block: queries q0 .. q0 + 63, key tiles up to the diagonal
    SmemDq& s = *reinterpret_cast<SmemDq*>(smem_raw);
    const int qt = 2 * nt - 1 - (int)blockIdx.x, q0 = qt * TILE;
    const int hf = lane >> 4, tc = lane & 15;  // rows 16 warp + 8 hf + i, keys tc + 16 j
    const int r0 = 16 * warp + 8 * hf;
    load_tile_async<THREADS>(s.k[0], kb, ks.st, 0, T, tid);
    load_tile_async<THREADS>(s.v[0], vb, vs.st, 0, T, tid);
    cp_async_commit();
    load_transposed<THREADS, TILE>(&s.qt[0][0], qb, qs.st, q0, T, scale, tid);
    load_transposed<THREADS, TILE>(&s.dOt[0][0], dob, dost, q0, T, 1.f, tid);
    if (tid < TILE) {
      const int t = q0 + tid;
      s.lse[tid] = t < T ? lse[bh * T + t] : 0.f;
      s.dd[tid] = t < T ? dd[bh * T + t] : 0.f;
    }
    float acc_q[8][4];
    zero(acc_q);
    const int n_kv = causal ? qt + 1 : nt;
    for (int j = 0; j < n_kv; ++j) {
      const int slot = j & 1, k0 = j * TILE;
      cp_async_wait_all();
      __syncthreads();  // tile j is in; every warp is done with tile j - 1's slot
      if (j + 1 < n_kv) {
        load_tile_async<THREADS>(s.k[slot ^ 1], kb, ks.st, k0 + TILE, T, tid);
        load_tile_async<THREADS>(s.v[slot ^ 1], vb, vs.st, k0 + TILE, T, tid);
      }
      cp_async_commit();

      float sc[8][4], dp[8][4];
      zero(sc);
      zero(dp);
      rows_by_keys<TILE, 4, 16>(sc, &s.qt[0][r0], s.k[slot], tc);
      rows_by_keys<TILE, 4, 16>(dp, &s.dOt[0][r0], s.v[slot], tc);
      const bool edge = (causal && j == qt) || q0 + TILE > T || k0 + TILE > T;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int qq = q0 + r0 + i;
        const float l = s.lse[r0 + i], dr = s.dd[r0 + i];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int kk = k0 + tc + 16 * c;
          const bool masked = edge && (qq >= T || kk >= T || (causal && kk > qq));
          const float p = masked ? 0.f : expf(sc[i][c] - l);
          dp[i][c] = p * (dp[i][c] - dr);
        }
      }
      // dQ += dS K, 16 keys at a time through the warp's dS^T
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        store_quarter_t(s.dst[warp], dp, c, tc, 8 * hf);
        __syncwarp();
        acc_keys(acc_q, s.dst[warp], s.k[slot], QK * c, 8 * hf, 4 * tc);
        __syncwarp();
      }
    }
    cp_async_wait_all();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = q0 + r0 + i;
      if (t < T)
        *reinterpret_cast<float4*>(dq + (((long long)b * T + t) * H + h) * HS + 4 * tc) =
            make_float4(acc_q[i][0] * scale, acc_q[i][1] * scale, acc_q[i][2] * scale,
                        acc_q[i][3] * scale);
    }
  }
}

// more than 48 KB of dynamic shared memory and the largest carveout: set
// once per device
cudaError_t configure() {
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!((configured >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(flash_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_bwd_f32_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured |= 1ull << dev;
  }
  return cudaSuccess;
}

}  // namespace

// dq, dk, dv: contiguous (B, T, H, hs) fp32; dd: (B, H, T) fp32 scratch that
// receives D; lse: contiguous (B, H, T) fp32 from the forward; o, dO:
// contiguous (B, T, H, hs) fp32. q/k/v: (B, T, H, hs) fp32 with unit stride on
// hs; strides in elements, each a multiple of 4, base pointers 16-byte aligned
// (checked by the Python wrapper). Two launches on `stream`, D then the
// backward. Returns the CUDA error code (0 on success).
extern "C" int gpt2vl_flash_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                    const void* dO, const void* lse, void* dd, void* dq,
                                    void* dk, void* dv, int B, int T, int H, int hs,
                                    long long qsb, long long qst, long long qsh,
                                    long long ksb, long long kst, long long ksh,
                                    long long vsb, long long vst, long long vsh,
                                    int causal, void* stream) {
  if (hs != HS || B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  const long long rows = (long long)B * T * H;
  const long long row_blocks = (rows + ROWDOT_THREADS / 16 - 1) / (ROWDOT_THREADS / 16);
  if (row_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rowdot_f32_kernel<<<(unsigned)row_blocks, ROWDOT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)dO, (const float*)o, (float*)dd, T, H, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = (T + TILE - 1) / TILE;
  flash_bwd_f32_kernel<<<dim3(2 * nt, H, B), THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO,
      (const float*)lse, (const float*)dd, (float*)dq, (float*)dk, (float*)dv, T, H,
      Strides{qsb, qst, qsh}, Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh}, causal);
  return (int)cudaGetLastError();
}

// Warps of the backward kernel resident on one SM, from the occupancy
// calculator (its registers, shared memory and launch bounds); 0 on an error.
extern "C" int gpt2vl_flash_bwd_f32_warps_per_sm() {
  int blocks = 0;
  if (configure() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_bwd_f32_kernel, THREADS,
                                                    SMEM) != cudaSuccess)
    return 0;
  return blocks * WARPS;
}
