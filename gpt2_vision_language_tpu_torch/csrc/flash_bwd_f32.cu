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
// What the design does about it (flash_f32.cuh holds the pieces and the
// blocks, dkv_block and dq_block, which this kernel instances at Tq == Tk
// and is their only user; the general and dt-layout fp32 backwards run the
// one-pass block): one grid of two kinds of block of 128 threads (4 warps), every
// product from outer-product register tiles of 32 values a thread, as in an
// SGEMM.
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

#include "flash_f32.cuh"

namespace {

using namespace f32;

constexpr int ROWDOT_THREADS = 256;

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

// D over B * T * H rows on `stream`
cudaError_t rowdot(const void* dO, const void* o, void* dd, int B, int T, int H, void* stream) {
  const long long rows = (long long)B * T * H;
  const long long row_blocks = (rows + ROWDOT_THREADS / 16 - 1) / (ROWDOT_THREADS / 16);
  if (row_blocks > 0x7fffffffLL) return cudaErrorInvalidValue;
  rowdot_f32_kernel<<<(unsigned)row_blocks, ROWDOT_THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)dO, (const float*)o, (float*)dd, T, H, rows);
  return cudaGetLastError();
}

// Block x of (h, b): x < nt is the dk/dv block of key tile x, x >= nt the dq
// block of query tile 2 nt - 1 - x.
__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     float* __restrict__ dq, float* __restrict__ dk, float* __restrict__ dv,
                     int T, int H, Strides qs, Strides ks, Strides vs, int causal) {
  backward_grid<Case::SELF>(BwdArgs{q, k, v, dO, lse, dd, dq, dk, dv, qs, ks, vs}, T, H, causal);
}

unsigned long long configured = 0;  // a bit per device: the kernel's attributes are set

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
  cudaError_t err = configure_once(flash_bwd_f32_kernel, BWD_SMEM, configured);
  if (err != cudaSuccess) return (int)err;
  err = rowdot(dO, o, dd, B, T, H, stream);
  if (err != cudaSuccess) return (int)err;
  const int nt = (T + TILE - 1) / TILE;
  flash_bwd_f32_kernel<<<dim3(2 * nt, H, B), THREADS, BWD_SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO,
      (const float*)lse, (const float*)dd, (float*)dq, (float*)dk, (float*)dv, T, H,
      Strides{qsb, qst, qsh}, Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh}, causal);
  return (int)cudaGetLastError();
}

// Warps of the backward kernel resident on one SM, from the occupancy
// calculator (its registers, shared memory and launch bounds); 0 on an error.
extern "C" int gpt2vl_flash_bwd_f32_warps_per_sm() {
  return warps_per_sm(flash_bwd_f32_kernel, BWD_SMEM, configured);
}

// D = rowsum(dO * O): dO, o contiguous (B, T, H, hs) fp32 -> dd contiguous
// (B, H, T) fp32; the row term of the general fp32 backward
// (flash_general_bwd_f32.cu), which takes it, or D - dlse, as an input.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int gpt2vl_flash_rowdot_f32(const void* dO, const void* o, void* dd, int B, int T,
                                       int H, int hs, void* stream) {
  if (hs != HS || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  return (int)rowdot(dO, o, dd, B, T, H, stream);
}
