// Flash-attention forward in the "dt" layout on fp32 operands for Hopper
// (sm_90a): q, k, v and o are (H, hs, B*T) fp32, the sequence contiguous and
// one slab of T positions per batch row; q arrives pre-scaled by 1/sqrt(hs);
// true fp32 products (FFMAs on the CUDA cores, no TF32), fp32 online softmax.
//
// Replaces the TPU kernel tools/ab_dt_flash.py _fwd_dt_kernel (launcher
// flash_fwd_dt_b) where it runs on fp32 operands, as the JAX tool's own
// --check runs it: its products take the operands' precision and o takes
// q's dtype. Same function as flash_dt_fwd.cu, the bf16 kernel: O =
// softmax(q^T k) v per (h, b) slab with an optional causal mask (query i
// sees keys <= i, no offset, also when Tq != Tk), and the per-query
// natural-log logsumexp as one fp32 row (H, B*Tq). Aligned shapes only,
// Tq % 64 == Tk % 64 == 0, as the bf16 kernel.
//
// What bounds it on the H100: the tensor cores take fp32 only as TF32 (10
// bits of mantissa against the JAX kernel's 23), so every product is an FFMA
// on the CUDA cores, 67 TFLOP/s at most (NVIDIA's data sheet, SXM, 700 W): at
// the A/B tool's shape (B=8, T=1024, H=12, hs=64, causal) 12.9 GFLOP, 0.19
// ms, against 0.03 ms for its 101 MB of q/k/v/o. Operations bound it, as
// they bound the fp32 self-attention forward (flash_fwd_f32.cu), whose
// function this is in another layout.
//
// What the design does about it: it is that kernel's forward block,
// instanced with Case::DT (flash_f32.cuh), so it keeps its 8 x 8
// outer-product register tiles, 128 query rows a block, the causal tile skip
// and the longest sweep first, two blocks an SM. The layout changes the
// loads and the stores only:
//   - q^T, the resident tile, arrives d-major: a straight 16-byte copy;
//   - the K and V tiles that the block sweeps are wanted [key][channel], the
//     transpose of what the layout holds, so each element is copied by its
//     own 4-byte cp.async into its transposed place, still asynchronously
//     into the other slot while a tile is computed on (a warp reads 32
//     contiguous bytes of four channels and writes 32 distinct banks);
//   - o leaves by channel, two 16-byte stores of a thread's 8 consecutive
//     positions; lse as one row a head.
// A block holds 128 query rows and T need only be a multiple of 64, so a
// sequence's last block may cover 64 rows past T: those rows load as zeros,
// sweep the keys of their own slab only, and are not written. A row past Tk
// (Tq > Tk, causal) sees every key; the sweep stops at Tk.

#include <cuda_runtime.h>

#include "flash_f32.cuh"

namespace {

using namespace f32;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_dt_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int Tq, int Tk, int H, long long nq,
                        long long nk, int causal) {
  // dt strides: a slab of T positions a sequence, B*T the channel stride
  forward_block<Case::DT>(q, k, v, o, lse, Tq, Tk, H, Tq, nq, HS * nq, Tk, nk, HS * nk, Tk, nk,
                          HS * nk, causal);
}

unsigned long long configured = 0;  // a bit per device: the kernel's attributes are set

}  // namespace

// q, o: contiguous (H, hs, B*Tq) fp32; k, v: contiguous (H, hs, B*Tk) fp32;
// lse: contiguous (H, B*Tq) fp32. Tq and Tk multiples of 64, base pointers
// 16-byte aligned (checked by the Python wrapper). Returns the CUDA error
// code of the launch (0 on success).
extern "C" int gpt2vl_flash_dt_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       void* lse, int B, int Tq, int Tk, int H, int hs,
                                       int causal, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Tq % TILE || Tk % TILE ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure_once(flash_dt_fwd_f32_kernel, (int)sizeof(FwdSmem), configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + FWD_BQ - 1) / FWD_BQ, H, B);
  flash_dt_fwd_f32_kernel<<<grid, THREADS, sizeof(FwdSmem), (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, Tq, Tk, H,
      (long long)B * Tq, (long long)B * Tk, causal);
  return (int)cudaGetLastError();
}

// Warps of this kernel resident on one SM, from the occupancy calculator;
// 0 on an error.
extern "C" int gpt2vl_flash_dt_fwd_f32_warps_per_sm() {
  return warps_per_sm(flash_dt_fwd_f32_kernel, (int)sizeof(FwdSmem), configured);
}
