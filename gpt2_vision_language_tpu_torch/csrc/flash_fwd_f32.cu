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
// What the design does about it (flash_f32.cuh holds the pieces and the
// block, forward_block, which this kernel instances at Tq == Tk):
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

#include "flash_f32.cuh"

namespace {

using namespace f32;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int T, int H, long long qsb, long long qst, long long qsh, long long ksb,
                     long long kst, long long ksh, long long vsb, long long vst, long long vsh,
                     int causal) {
  forward_block<Case::SELF>(q, k, v, o, lse, T, T, H, qsb, qst, qsh, ksb, kst, ksh, vsb, vst, vsh,
                            causal);
}

unsigned long long configured = 0;  // a bit per device: the kernel's attributes are set

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
  cudaError_t err = configure_once(flash_fwd_f32_kernel, (int)sizeof(FwdSmem), configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + FWD_BQ - 1) / FWD_BQ, H, B);
  flash_fwd_f32_kernel<<<grid, THREADS, sizeof(FwdSmem), (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, T, H, qsb, qst,
      qsh, ksb, kst, ksh, vsb, vst, vsh, causal);
  return (int)cudaGetLastError();
}

// Warps of this kernel resident on one SM, from the occupancy calculator
// (its registers, shared memory and launch bounds); 0 on an error.
extern "C" int gpt2vl_flash_fwd_f32_warps_per_sm() {
  return warps_per_sm(flash_fwd_f32_kernel, (int)sizeof(FwdSmem), configured);
}
