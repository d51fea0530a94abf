// Self-attention flash forward on fp32 operands for Hopper (sm_90a): Tq == Tk
// = T, causal or not, T ragged; fp32 q/k/v, true fp32 products (FFMAs on the
// CUDA cores, no TF32), fp32 online softmax, o + lse.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _fwd_dt_kernel (launcher _fwd_dt) where it runs on fp32 operands: its
// products take the operands' precision, its output q.dtype. Same function as
// flash_fwd.cu, the bf16 kernel: O = softmax(q k^T / sqrt(hs)) v with an
// optional causal mask, and the per-row natural-log logsumexp in fp32, written
// as that kernel writes it ((B, H, T), contiguous). It reads q/k/v in their
// (B, T, H, hs) layout through strides, so the strided views of the fused QKV
// projection go in without a copy.
//
// What bounds it on the H100: the tensor cores take fp32 only as TF32, which
// keeps 10 bits of mantissa; the JAX kernel's fp32 products keep 23. So every
// product is an FFMA on the CUDA cores, 67 TFLOP/s at most (NVIDIA's data
// sheet, SXM, 700 W): at the HellaSwag shape (B=32, T=1024, H=12, hs=64,
// causal) 2 * B * H * T(T+1) * hs = 51.6 GFLOP, 0.77 ms, against 0.12 ms for
// its 403 MB of q/k/v/o. Operations bound it. An FFMA kernel nears that
// rate only if the shared-memory reads that feed the FFMAs fit the SM's
// shared-memory bandwidth (a 16-byte read of a warp takes four 128-byte
// wavefronts, one per quarter-warp, whatever it broadcasts), and if enough
// independent FFMAs hide the latency of those reads and of the tile copies.
//
// What the design does about it (flash_f32.cuh holds the pieces):
//   - outer-product register tiles, as in an SGEMM: a block of 128 threads
//     (4 warps) owns 128 query rows, a warp 32, a thread 8 rows x 8 keys of
//     S and 8 rows x 8 channels of O. S = q k^T reads, per 4 channels, 8
//     float4 of K rows and 8 float4 of q^T (q stored d-major and scaled by
//     1 / sqrt(hs) once, when the block starts) for 256 FFMAs; O += P V
//     reads, per key, 2 float4 of P^T and 2 of V for 64 FFMAs: 16 FFMAs a
//     read, a quarter of a wavefront an FFMA, where the previous design read
//     eight float4 for every 64 FFMAs.
//   - asynchronous, double-buffered K/V: tile j + 1 is copied by cp.async
//     into the other slot while tile j is computed on; one barrier a tile.
//   - P goes through a per-warp quarter of shared memory (P^T of 16 keys,
//     written transposed from registers) and is read back by the same warp,
//     so only __syncwarp orders it.
//   - occupancy: 109 KB of shared memory and up to 255 registers a thread
//     (__launch_bounds__(128, 2)): two blocks, 8 warps, an SM. 16 warps
//     would cap a thread at 128 registers, which holds 8 x 4 tiles and not
//     8 x 8: built so (256 threads, 16 warps, 128 registers, no spills) the
//     kernel read 1.595-1.653 ms at B=32, T=1024 and 3.62 ms at B=1,
//     T=8192 on an H100 80GB HBM3 at 700 W, against 1.547-1.560 and 3.14
//     for this one: the wider tile halves the reads and wins.
// Kept from the previous design: the causal tile skip (a warp whose 32 rows
// all precede a tile's first key skips it; a tile past the last row of the
// block is never visited), the query tiles in order of longest causal sweep
// first, the finite -1e30 running max, zero-filled K/V rows past T, masks on
// every tile that the causal diagonal or the end of the sequence crosses
// (with 128 rows a block and 64 keys a tile, two tiles span the diagonal),
// 64-bit offsets.

#include <cuda_runtime.h>
#include <math.h>

#include "flash_f32.cuh"

namespace {

using namespace f32;

constexpr int WR = 32;         // query rows a warp
constexpr int WARPS = 4;
constexpr int BQ = WR * WARPS; // query rows a block
constexpr int BK = TILE;       // keys a tile
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;  // resident blocks an SM (shared memory allows two)

struct Smem {
  float qt[HS][BQ];        // q^T / sqrt(hs): [channel][row]
  Tile k[2];               // K tiles, two slots
  Tile v[2];               // V tiles, two slots
  Quarter<WR> pt[WARPS];   // per warp: P^T of 16 keys
};

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int T, int H, long long qsb, long long qst, long long qsh, long long ksb,
                     long long kst, long long ksh, long long vsb, long long vst, long long vsh,
                     int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, kg = lane & 7;  // rows WR warp + 8 rg + i; keys kg + 8 j; channels 4 kg
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int hh = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const float* kb = k + (long long)b * ksb + (long long)hh * ksh;
  const float* vb = v + (long long)b * vsb + (long long)hh * vsh;
  const int q_end = min(q0 + BQ, T);
  const int n_kv = causal ? (q_end - 1) / BK + 1 : (T + BK - 1) / BK;

  load_tile_async<THREADS>(s.k[0], kb, kst, 0, T, tid);
  load_tile_async<THREADS>(s.v[0], vb, vst, 0, T, tid);
  cp_async_commit();
  load_transposed<THREADS, BQ>(&s.qt[0][0], q + (long long)b * qsb + (long long)hh * qsh, qst,
                               q0, T, 0.125f, tid);

  const int wrow = q0 + WR * warp;  // the warp's first row
  const int r0 = WR * warp + 8 * rg;  // the thread's first row in the block
  float m[8], l[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
  }
  zero(acc);

  for (int j = 0; j < n_kv; ++j) {
    const int slot = j & 1, k0 = j * BK;
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's slot
    if (j + 1 < n_kv) {
      load_tile_async<THREADS>(s.k[slot ^ 1], kb, kst, k0 + BK, T, tid);
      load_tile_async<THREADS>(s.v[slot ^ 1], vb, vst, k0 + BK, T, tid);
    }
    cp_async_commit();
    // the warp's rows are all past T, or all before this tile's first key
    if (wrow >= T || (causal && wrow + WR - 1 < k0)) continue;

    // S = (q / sqrt(hs)) k^T for rows r0 + i, keys k0 + kg + 8 c
    float sc[8][8];
    zero(sc);
    rows_by_keys<BQ, 8, 8>(sc, &s.qt[0][r0], s.k[slot], kg);
    if ((causal && k0 + BK - 1 > wrow) || k0 + BK > T) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int kk = k0 + kg + 8 * c;
          if (kk >= T || (causal && kk > q0 + r0 + i)) sc[i][c] = -INFINITY;
        }
    }

    // online softmax; the row max over the 8 lanes of a quarter-warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = NEG_BIG;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, sc[i][c]);
#pragma unroll
      for (int off = 4; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        sc[i][c] = expf(sc[i][c] - m_new);
        sum += sc[i][c];
      }
      l[i] = l[i] * corr + sum;  // this thread's share of the row sum
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= corr;
    }

    // O += P V, a quarter (16 keys: columns 2c and 2c + 1) at a time through
    // the warp's P^T
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      store_quarter_t(s.pt[warp], sc, 2 * c, kg, 8 * rg);
      store_quarter_t(s.pt[warp], sc, 2 * c + 1, kg + 8, 8 * rg);
      __syncwarp();
      acc_keys(acc, s.pt[warp], s.v[slot], QK * c, 8 * rg, 4 * kg);
      __syncwarp();
    }
  }
  cp_async_wait_all();

  // the row sums over the 8 lanes of a row; o = acc / l, lse = m + log l
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int off = 4; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int qq = q0 + r0 + i;
    if (qq < T) {
      float* dst = o + (((long long)b * T + qq) * H + hh) * HS;
      *reinterpret_cast<float4*>(dst + 4 * kg) =
          make_float4(acc[i][0] / l[i], acc[i][1] / l[i], acc[i][2] / l[i], acc[i][3] / l[i]);
      *reinterpret_cast<float4*>(dst + 32 + 4 * kg) =
          make_float4(acc[i][4] / l[i], acc[i][5] / l[i], acc[i][6] / l[i], acc[i][7] / l[i]);
      if (kg == 0) lse[((long long)b * H + hh) * T + qq] = m[i] + logf(l[i]);
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
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)sizeof(Smem));
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured |= 1ull << dev;
  }
  return cudaSuccess;
}

}  // namespace

// o: contiguous (B, T, H, hs) fp32; lse: contiguous (B, H, T) fp32.
// q/k/v: (B, T, H, hs) fp32 with unit stride on hs; strides in elements, each a
// multiple of 4, base pointers 16-byte aligned (checked by the Python wrapper).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int gpt2vl_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int T, int H, int hs,
                                    long long qsb, long long qst, long long qsh,
                                    long long ksb, long long kst, long long ksh,
                                    long long vsb, long long vst, long long vsh,
                                    int causal, void* stream) {
  if (hs != HS || B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<<<grid, THREADS, sizeof(Smem), (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, T, H, qsb, qst,
      qsh, ksb, kst, ksh, vsb, vst, vsh, causal);
  return (int)cudaGetLastError();
}

// Warps of this kernel resident on one SM, from the occupancy calculator
// (its registers, shared memory and launch bounds); 0 on an error.
extern "C" int gpt2vl_flash_fwd_f32_warps_per_sm() {
  int blocks = 0;
  if (configure() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, flash_fwd_f32_kernel, THREADS,
                                                    sizeof(Smem)) != cudaSuccess)
    return 0;
  return blocks * WARPS;
}
