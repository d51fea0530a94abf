// Flash-attention backward in the "dt" layout on fp32 operands for Hopper
// (sm_90a): q, k, v, dO and dq, dk, dv are (H, hs, B*T) fp32, the sequence
// contiguous and one slab of T positions per batch row; q arrives pre-scaled
// by 1/sqrt(hs); true fp32 products (FFMAs on the CUDA cores, no TF32).
//
// Replaces the TPU kernel tools/ab_dt_flash.py _bwd_dt_kernel (launcher
// flash_bwd_dt_b) where it runs on fp32 operands, as the JAX tool's own
// --check-bwd runs it: dq, dk and dv take the operands' dtypes. Same function
// as flash_dt_bwd.cu, the bf16 kernel: with S = q^T k under the mask (query
// i sees keys <= i, no offset, also when Tq != Tk) and P = exp(S - lse),
//   dV = dO P^T,  dS = P * (dO^T V - dcap),  dK = Q dS,  dQ = K dS^T * dq_scale,
// lse and dcap = rowsum(dO * O) one fp32 row per query, (H, B*Tq). dcap
// comes from the caller, as D - dlse comes to the general fp32 backward, so
// there is no D kernel. Aligned shapes only, Tq % 64 == Tk % 64 == 0.
//
// What bounds it on the H100: every product is an FFMA on the CUDA cores (the
// tensor cores take fp32 only as TF32), 67 TFLOP/s at most (NVIDIA's data
// sheet, SXM, 700 W): at the A/B tool's shape (B=8, T=1024, H=12, hs=64,
// causal) the five products of the visible pairs are 32.2 GFLOP, 0.48 ms,
// against 0.06 ms for the 201 MB of q/k/v/dO/dq/dk/dv: operations bound it.
// The grid runs seven products a visible pair, as the fp32 self-attention
// backward (flash_bwd_f32.cu) does, so 0.67 ms is its own ceiling.
//
// What the design does about it: that kernel's grid, instanced with Case::DT
// (flash_f32.cuh): the 64-key dk/dv blocks (key tile 0 first) and the
// 64-query dq blocks (the last query tile first) in one launch, 8 x 4
// outer-product register tiles, two blocks an SM, no atomics (dq, dk and dv
// each summed in one block in a fixed order: bit-equal from run to run, as
// the TPU kernel's are). The layout changes the loads and the stores only:
//   - the resident tiles (K^T and V^T of a dk/dv block, q^T and dO^T of a dq
//     block) arrive d-major: straight 16-byte copies, nothing scaled;
//   - the swept tiles (q and dO in a dk/dv block, K and V in a dq block) are
//     wanted [position][channel], so each element is copied by its own 4-byte
//     cp.async into its transposed place, asynchronously into the other slot;
//   - dq, dk and dv leave by channel, 16-byte stores of four consecutive
//     positions; dk takes no scale (q is pre-scaled), dq the runtime dq_scale.
// Without an offset, a dk/dv block of a key past Tq (Tq < Tk) sweeps nothing
// and writes zeros, and a dq block of a query past Tk (Tq > Tk) sweeps every
// key tile unmasked.

#include <cuda_runtime.h>

#include "flash_f32.cuh"

namespace {

using namespace f32;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_dt_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ dcap,
                        float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                        int Tq, int Tk, int H, Strides qs, Strides ks, int causal,
                        float dq_scale) {
  backward_grid<Case::DT>(BwdArgs{q, k, v, dO, lse, dcap, dq, dk, dv, qs, ks, ks}, Tq, Tk, H,
                          causal, dq_scale);
}

unsigned long long configured = 0;  // a bit per device: the kernel's attributes are set

}  // namespace

// q, dO, dq: contiguous (H, hs, B*Tq) fp32; k, v, dk, dv: contiguous
// (H, hs, B*Tk) fp32; lse, dcap: contiguous (H, B*Tq) fp32. Tq and Tk
// multiples of 64, base pointers 16-byte aligned (checked by the Python
// wrapper). One launch on `stream`; returns the CUDA error code of the
// launch (0 on success).
extern "C" int gpt2vl_flash_dt_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* dO, const void* lse, const void* dcap,
                                       void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                                       int H, int hs, int causal, float dq_scale, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Tq % TILE || Tk % TILE ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure_once(flash_dt_bwd_f32_kernel, BWD_SMEM, configured);
  if (err != cudaSuccess) return (int)err;
  // dt strides: a slab of T positions a sequence, B*T the channel stride
  const long long nq = (long long)B * Tq, nk = (long long)B * Tk;
  const unsigned blocks = (unsigned)(Tk / TILE + Tq / TILE);
  flash_dt_bwd_f32_kernel<<<dim3(blocks, H, B), THREADS, BWD_SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO, (const float*)lse,
      (const float*)dcap, (float*)dq, (float*)dk, (float*)dv, Tq, Tk, H,
      Strides{Tq, nq, HS * nq}, Strides{Tk, nk, HS * nk}, causal, dq_scale);
  return (int)cudaGetLastError();
}

// Warps of this kernel resident on one SM, from the occupancy calculator;
// 0 on an error.
extern "C" int gpt2vl_flash_dt_bwd_f32_warps_per_sm() {
  return warps_per_sm(flash_dt_bwd_f32_kernel, BWD_SMEM, configured);
}
