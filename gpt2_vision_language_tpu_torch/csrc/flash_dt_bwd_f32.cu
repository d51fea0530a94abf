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
// The parent design, the fp32 self-attention backward's grid of dk/dv and dq
// blocks, ran seven products a visible pair (S and dP twice); this one runs
// the TPU kernel's five.
//
// The design: the one-pass block of the general fp32 backward
// (flash_general_bwd_f32.cu), instanced with Case::DT (flash_f32.cuh
// pair_grid, pair_block): a persistent grid of 128-thread blocks, one per
// resident slot (two an SM), launched cooperatively, each walking work items
// of 64 keys of one (b, h). An item keeps K and V resident and sweeps the
// query tiles that see its keys (causal: from query tile kt on); per pair S
// and P in one half of the block, dP and dS in the other, then dV and dK,
// 8 x 8 outer-product register tiles, and dS K times dq_scale, this pair's
// part of dq, by the whole block, added into dq in global memory in a fixed
// order of key tiles kept by a flag per query tile (no atomics: dq, dk and
// dv are bit-equal from run to run, as the TPU kernel's are). The layout
// changes the loads, the stores and the index work only:
//   - K and V (once an item) and the swept q and dO (each pair) are wanted
//     [position][channel] and arrive d-major, so each element is copied by
//     its own 4-byte cp.async into its transposed place, a warp reading 32
//     contiguous bytes of each of four channels; the next query tile's copy
//     runs under the pair's dQ product;
//   - a thread's part of dQ is 8 consecutive positions of 4 channels, so the
//     sum so far comes in and the new sum goes out in 16-byte runs of one
//     channel; dk and dv leave the same way, dk unscaled (q is pre-scaled);
//   - the mask has no offset (query i sees keys j <= i) at any Tq and Tk: a
//     key tile past Tq sweeps nothing and writes dk = dv = 0, a query tile
//     past Tk takes parts from every key tile.

#include <cuda_runtime.h>

#include "flash_f32.cuh"

namespace {

using namespace f32;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_dt_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ dcap,
                        float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                        int Tq, int Tk, int H, int BH, Strides qs, Strides ks, int causal,
                        unsigned int* flags, int rounds, float dq_scale) {
  pair_grid<Case::DT>(BwdArgs{q, k, v, dO, lse, dcap, dq, dk, dv, qs, ks, ks}, Tq, Tk, H, BH,
                      causal, flags, rounds, dq_scale);
}

unsigned long long configured = 0;  // a bit per device: the kernel's attributes are set
int slots_of_device[64];            // per device: the blocks resident at once, 0 until counted

}  // namespace

// q, dO, dq: contiguous (H, hs, B*Tq) fp32; k, v, dk, dv: contiguous
// (H, hs, B*Tk) fp32; lse, dcap: contiguous (H, B*Tq) fp32. Tq and Tk
// multiples of 64, base pointers 16-byte aligned (checked by the Python
// wrapper). One launch on `stream`; returns the CUDA error code (0 on
// success).
extern "C" int gpt2vl_flash_dt_bwd_f32(const void* q, const void* k, const void* v,
                                       const void* dO, const void* lse, const void* dcap,
                                       void* dq, void* dk, void* dv, int B, int Tq, int Tk,
                                       int H, int hs, int causal, float dq_scale, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Tq % TILE || Tk % TILE ||
      B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  int n_slots = 0;
  const cudaError_t err =
      resident_slots(flash_dt_bwd_f32_kernel, PAIR_SMEM, configured, slots_of_device, &n_slots);
  if (err != cudaSuccess) return (int)err;
  // dt strides: a slab of T positions a sequence, B*T the channel stride
  const long long nq = (long long)B * Tq, nk = (long long)B * Tk;
  const float *fq = (const float*)q, *fk = (const float*)k, *fv = (const float*)v,
              *fdO = (const float*)dO, *flse = (const float*)lse, *fdcap = (const float*)dcap;
  float *fdq = (float*)dq, *fdk = (float*)dk, *fdv = (float*)dv;
  int BH = B * H, rounds = 0;
  unsigned int* flags = nullptr;
  Strides qs{Tq, nq, HS * nq}, ks{Tk, nk, HS * nk};
  void* args[] = {&fq, &fk, &fv, &fdO, &flse, &fdcap, &fdq, &fdk, &fdv, &Tq,
                  &Tk, &H, &BH, &qs, &ks, &causal, &flags, &rounds, &dq_scale};
  return (int)launch_pair_grid(flash_dt_bwd_f32_kernel, n_slots, Tq, Tk, BH, causal, flags,
                               rounds, args, (cudaStream_t)stream);
}

// Warps of this kernel resident on one SM, from the occupancy calculator;
// 0 on an error.
extern "C" int gpt2vl_flash_dt_bwd_f32_warps_per_sm() {
  return warps_per_sm(flash_dt_bwd_f32_kernel, PAIR_SMEM, configured);
}
