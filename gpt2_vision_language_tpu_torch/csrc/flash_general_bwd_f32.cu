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
// What bounds it on the H100: fp32 products are FFMAs on the CUDA cores (the
// tensor cores take fp32 only as TF32), 67 TFLOP/s at most; at B=1, T=16384,
// H=12, hs=64 causal the five products of the visible pairs are 15.4 ms of
// FFMAs against 0.3 ms for the bytes of the operands and gradients:
// operations bound it. The parent design, the fp32 self-attention backward's
// grid of dk/dv and dq blocks (flash_bwd_f32.cu), ran seven products a pair,
// S and dP twice; this one runs the five of the TPU's one-pass kernel.
//
// The design (flash_f32.cuh, pair_grid and pair_block, instanced here with
// Case::GENERAL): a persistent grid of 128-thread blocks, one per resident
// slot (two an SM), each walking work items of 64 keys of one (b, h). An item
// keeps K / sqrt(hs) and V resident and sweeps the query tiles that see its
// keys (causal: from row k0 - (Tk - Tq) on); per pair S and P in one half of
// the block, dP and dS in the other, then dV in the first half and dK in the
// second, 8 x 8 outer-product register tiles, and dS K, this pair's part of
// dq, by the whole block, added into dq in global memory in a fixed order of
// key tiles kept by a flag per query tile (no atomics: dq, dk and dv are
// bit-equal from run to run). Query rows at or past Tq come in as zeros with
// lse and the row term 0 and are masked (P = 0), so they add nothing; nothing
// is read past the end of lse or the row term.
//
// The flags, one per (b, h, query tile), are each launch's own, and the grid
// goes out cooperatively (flash_f32.cuh launch_pair_grid).

#include <cuda_runtime.h>

#include "flash_f32.cuh"

namespace {

using namespace f32;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_general_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ dO,
                             const float* __restrict__ lse, const float* __restrict__ dd,
                             float* __restrict__ dq, float* __restrict__ dk,
                             float* __restrict__ dv, int Tq, int Tk, int H, int BH, Strides qs,
                             Strides ks, Strides vs, int causal, unsigned int* flags,
                             int rounds) {
  pair_grid<Case::GENERAL>(BwdArgs{q, k, v, dO, lse, dd, dq, dk, dv, qs, ks, vs}, Tq, Tk, H, BH,
                           causal, flags, rounds);
}

unsigned long long configured = 0;  // a bit per device: the kernel's attributes are set
int slots_of_device[64];            // per device: the blocks resident at once, 0 until counted

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
  int n_slots = 0;
  const cudaError_t err = resident_slots(flash_general_bwd_f32_kernel, PAIR_SMEM, configured,
                                         slots_of_device, &n_slots);
  if (err != cudaSuccess) return (int)err;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v,
              *fdO = (const float*)dO, *flse = (const float*)lse, *fdd = (const float*)dd;
  float *fdq = (float*)dq, *fdk = (float*)dk, *fdv = (float*)dv;
  int BH = B * H, rounds = 0;
  unsigned int* flags = nullptr;
  Strides qs{qsb, qst, qsh}, ks{ksb, kst, ksh}, vs{vsb, vst, vsh};
  void* args[] = {&fq, &fk, &fv, &fdO, &flse, &fdd, &fdq, &fdk, &fdv, &Tq, &Tk, &H,
                  &BH, &qs, &ks, &vs, &causal, &flags, &rounds};
  return (int)launch_pair_grid(flash_general_bwd_f32_kernel, n_slots, Tq, Tk, BH, causal, flags,
                               rounds, args, (cudaStream_t)stream);
}

// Warps of this kernel resident on one SM, from the occupancy calculator;
// 0 on an error.
extern "C" int gpt2vl_flash_general_bwd_f32_warps_per_sm() {
  return warps_per_sm(flash_general_bwd_f32_kernel, PAIR_SMEM, configured);
}
