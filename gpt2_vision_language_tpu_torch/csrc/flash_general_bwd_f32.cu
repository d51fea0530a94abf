// General flash backward on fp32 operands for Hopper (sm_90a): dq, dk, dv
// from the saved lse and a row term given as an input, a query length Tq and
// a key length Tk, either ragged, a right-aligned causal mask (query i sees
// the keys j <= i + Tk - Tq) or none; fp32 q/k/v/dO, true fp32 products
// (FFMAs on the CUDA cores, no TF32).
//
// Replaces three TPU kernels of gpt2_vision_language_tpu/ops/flash_attention.py
// where they run on fp32 operands (their outputs take q.dtype, :607, :636-637,
// :670-672): _dq_kernel_grid (:369, pallas_call :593) and _dkv_kernel_grid
// (:509, pallas_call :618), which _bwd runs on D = rowsum(dO * O), and
// _bwd_kernel_fused (:396, pallas_call :650), which it runs on
// dcap = D - dlse when the logsumexp carries a cotangent (:576-580; the
// backward of flash_attention_with_lse, once a ring chunk pair). All three
// compute, with S = q k^T / sqrt(hs) masked, P = exp(S - lse) and the row
// term c,
//   dV = P^T dO,  dS = P * (dO V^T - c),  dQ = dS K / sqrt(hs),  dK = dS^T Q / sqrt(hs),
// so one kernel serves them, behind two wrappers with their own launch
// counters (ops/flash_attention.py flash_general_backward_f32, K3a and K3b
// in one launch; flash_fused_backward_f32, K3c). D comes from the fp32 D
// kernel of flash_bwd_f32.cu (gpt2vl_flash_rowdot_f32).
//
// It is the grid of the fp32 self-attention backward (flash_bwd_f32.cu),
// instanced with Case::GENERAL (flash_f32.cuh): the 64-key dk/dv blocks
// (key tile 0 first) and then the 64-query dq blocks (the last query tile
// first), 8 x 4 outer-product register tiles, swept tiles copied by
// cp.async into two slots. A dk/dv block sweeps the query tiles from the
// first whose rows see one of its keys (row k0 - (Tk - Tq) under the mask);
// a dq block sweeps the key tiles up to the last its last row sees. Query
// rows at or past Tq come in as zeros with lse and the row term 0 and are
// masked (P = 0), so they add nothing to dk or dv; nothing is read past the
// end of lse or the row term. No atomics: dq, dk and dv are each summed in
// one block in a fixed order and are bit-equal from run to run (the bf16 K3c
// sums dq by reductions in global memory, flash_fused_bwd.cu). Bound and
// what holds it as in flash_bwd_f32.cu.

#include <cuda_runtime.h>

#include "flash_f32.cuh"

namespace {

using namespace f32;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_general_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dO,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             float* __restrict__ dq, float* __restrict__ dk,
                             float* __restrict__ dv, int Tq, int Tk, int H, Strides qs,
                             Strides ks, Strides vs, int causal) {
  backward_grid<Case::GENERAL>(BwdArgs{q, k, v, dO, lse, dd, dq, dk, dv, qs, ks, vs}, Tq, Tk, H,
                               causal);
}

unsigned long long configured = 0;  // a bit per device: the kernel's attributes are set

}  // namespace

// dq: contiguous (B, Tq, H, hs) fp32, dk, dv: contiguous (B, Tk, H, hs)
// fp32; lse (from the forward) and dd (the row term: D, or D - dlse):
// contiguous (B, H, Tq) fp32; dO: contiguous (B, Tq, H, hs) fp32. q:
// (B, Tq, H, hs), k/v: (B, Tk, H, hs), fp32 with unit stride on hs; strides
// in elements, each a multiple of 4, base pointers 16-byte aligned (checked
// by the Python wrapper). causal needs Tq <= Tk. One launch on `stream`.
// Returns the CUDA error code (0 on success).
extern "C" int gpt2vl_flash_general_bwd_f32(const void* q, const void* k, const void* v,
                                            const void* dO, const void* lse, const void* dd,
                                            void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                                            int H, int hs, long long qsb, long long qst,
                                            long long qsh, long long ksb, long long kst,
                                            long long ksh, long long vsb, long long vst,
                                            long long vsh, int causal, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      (causal && Tq > Tk))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure_once(flash_general_bwd_f32_kernel, BWD_SMEM, configured);
  if (err != cudaSuccess) return (int)err;
  const long long blocks = (long long)(Tk + TILE - 1) / TILE + (Tq + TILE - 1) / TILE;
  flash_general_bwd_f32_kernel<<<dim3((unsigned)blocks, H, B), THREADS, BWD_SMEM,
                                 (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO, (const float*)lse,
      (const float*)dd, (float*)dq, (float*)dk, (float*)dv, Tq, Tk, H, Strides{qsb, qst, qsh},
      Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh}, causal);
  return (int)cudaGetLastError();
}

// Warps of this kernel resident on one SM, from the occupancy calculator;
// 0 on an error.
extern "C" int gpt2vl_flash_general_bwd_f32_warps_per_sm() {
  return warps_per_sm(flash_general_bwd_f32_kernel, BWD_SMEM, configured);
}
