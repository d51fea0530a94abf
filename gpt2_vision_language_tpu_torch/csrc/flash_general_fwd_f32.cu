// General flash forward on fp32 operands for Hopper (sm_90a): a query length
// Tq and a key length Tk, either ragged, a right-aligned causal mask (query i
// sees the keys j <= i + Tk - Tq) or none; fp32 q/k/v, true fp32 products
// (FFMAs on the CUDA cores, no TF32), fp32 online softmax, o + lse.
//
// Replaces two TPU kernels of gpt2_vision_language_tpu/ops/flash_attention.py
// where they run on fp32 operands (their products take the operands'
// precision, their output q.dtype, :294): _fwd_kernel_grid (:221, the K/V
// streamed by the grid; pallas_call :301) and _fwd_kernel (:197, K/V held in
// VMEM; pallas_call :323, the forward of flash_attention_with_lse). Both give
// o and the natural-log lse of the same masked softmax; VMEM residency has no
// counterpart on the card (a head's K/V at Tk = 16384 is 8 MB against 227 KB
// of shared memory), so this one kernel serves both, behind two wrappers
// with their own launch counters (ops/flash_attention.py
// flash_general_forward_f32, flash_lse_forward_f32). The bf16 kernels of the
// same functions are flash_general_fwd.cu and flash_lse_fwd.cu.
//
// It is the forward block of the fp32 self-attention kernel
// (flash_fwd_f32.cu), instanced with Case::GENERAL (flash_f32.cuh): 8 x 8
// outer-product register tiles, 128 query rows a block (32 a warp), K/V tiles
// of 64 keys copied by cp.async into two slots, the causal tile skip and the
// longest sweep first, both shifted by the offset Tk - Tq; K/V rows at or
// past Tk and q rows at or past Tq zero-filled. One block per 128-query tile,
// head and batch row; it sweeps the key tiles from 0 to the last that its
// last row sees. Bound and what holds it as in flash_fwd_f32.cu: 67 TFLOP/s
// of FFMAs at most (NVIDIA's data sheet, SXM, 700 W), and the shared-memory
// reads that feed them.

#include <cuda_runtime.h>

#include "flash_f32.cuh"

namespace {

using namespace f32;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_general_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, float* __restrict__ o,
                             float* __restrict__ lse, int Tq, int Tk, int H, long long qsb,
                             long long qst, long long qsh, long long ksb, long long kst,
                             long long ksh, long long vsb, long long vst, long long vsh,
                             int causal) {
  forward_block<Case::GENERAL>(q, k, v, o, lse, Tq, Tk, H, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
                               vsh, causal);
}

unsigned long long configured = 0;  // a bit per device: the kernel's attributes are set

}  // namespace

// o: contiguous (B, Tq, H, hs) fp32; lse: contiguous (B, H, Tq) fp32.
// q: (B, Tq, H, hs), k/v: (B, Tk, H, hs), fp32 with unit stride on hs;
// strides in elements, each a multiple of 4, base pointers 16-byte aligned
// (checked by the Python wrapper). causal needs Tq <= Tk. Returns the CUDA
// error code of the launch (0 on success).
extern "C" int gpt2vl_flash_general_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                            void* lse, int B, int Tq, int Tk, int H, int hs,
                                            long long qsb, long long qst, long long qsh,
                                            long long ksb, long long kst, long long ksh,
                                            long long vsb, long long vst, long long vsh,
                                            int causal, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      (causal && Tq > Tk))
    return (int)cudaErrorInvalidValue;
  cudaError_t err =
      configure_once(flash_general_fwd_f32_kernel, (int)sizeof(FwdSmem), configured);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((Tq + FWD_BQ - 1) / FWD_BQ, H, B);
  flash_general_fwd_f32_kernel<<<grid, THREADS, sizeof(FwdSmem), (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, Tq, Tk, H, qsb,
      qst, qsh, ksb, kst, ksh, vsb, vst, vsh, causal);
  return (int)cudaGetLastError();
}

// Warps of this kernel resident on one SM, from the occupancy calculator;
// 0 on an error.
extern "C" int gpt2vl_flash_general_fwd_f32_warps_per_sm() {
  return warps_per_sm(flash_general_fwd_f32_kernel, (int)sizeof(FwdSmem), configured);
}
