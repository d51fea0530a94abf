// One-pass flash-attention backward for Hopper (sm_90a): dq, dk and dv from one
// walk over the tile pairs, with the row term given by the caller. The backward
// of flash_attention_with_lse, one (query chunk, key chunk) pair of ring
// attention per launch: Tq != Tk, ragged lengths on both sides, right-aligned
// causal or non-causal.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _bwd_kernel_fused (launcher _bwd, stream_kv=False). Same function: for every
// visited (query tile, key tile) pair once, with S = q k^T / sqrt(hs) under the
// mask (query i at key position i + Tk - Tq) and P = exp(S - lse),
//   dV += P^T dO,  dP = dO V^T,  dS = P * (dP - dcap),
//   dK += dS^T Q / sqrt(hs),  dQ += dS K / sqrt(hs):
// five products and one exp per pair, where the split dq and dk/dv kernels
// (flash_general_bwd.cu, flash_dkv_bwd.cu) recompute S, P and dP and pay seven
// and two. dcap is an input, (B, H, Tq) fp32: D = rowsum(dO * O) for plain
// attention, D - dlse when the logsumexp carries a cotangent too (a chunk's lse
// feeds the merge of ring attention), exactly as the TPU kernel takes it. The scale is applied
// here, once to dk at its store and once to dq at its cast, because the
// forward applies it inside its kernel.
//
// What bounds it on the H100: a ring hop at Tq = Tk = 4096, H = 12, hs = 64
// without a mask is 5 * 2 * 12 * 4096^2 * 64 = 129 GFLOP against 50 MB of
// q/k/v/dO/dq/dk/dv: the tensor cores bound it by far (0.130 ms at 989
// TFLOP/s).
//
// What the design does about it: the key-major backward of flash_bwd_sm90.cuh
// with its dQ half (DQ = true): the TPU kernel runs one program per (b, h),
// with everything of that head resident and dq summed over the key tiles in an
// fp32 scratch of all Tq rows. Here that scratch would be 1 MB at Tq = 4096 (a
// block has 227 KB), so one block owns a (b, h, 128-key tile), dK and dV stay
// in wgmma accumulators, and dQ is added once per block and query tile with
// 16-byte reductions into a zeroed fp32 buffer (half the reductions of 64-key
// blocks); the dS^T tile is double-buffered, so one barrier of the two
// consumers a pair suffices. A second kernel here casts the buffer to bf16
// times the scale. dq can differ in the last fp32 bits from run to run; dk and
// dv are deterministic.

#include "flash_bwd_sm90.cuh"

namespace {

using namespace flash_bwd_sm90;

constexpr int STAGES = 2;  // slots of the Q / dO ring

__global__ void __launch_bounds__(THREADS, 1)
flash_fused_bwd_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv,
                       const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                       const float* __restrict__ dcap, float* __restrict__ dq_acc,
                       bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int H,
                       int causal, float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  backward_block<true, STAGES>(&mq, &mk, &mv, &mdo, lse, dcap, dq_acc, dk, dv, Tq, Tk, H, causal,
                               scale, scale_log2, blockIdx.x, blockIdx.y, blockIdx.z, smem_raw);
}

// dq = bf16(dq_acc * scale), eight elements a thread
__global__ void flash_fused_dq_cast_kernel(const float* __restrict__ acc, bf16* __restrict__ dq,
                                           long long n8, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(acc)[2 * i];
  const float4 c = reinterpret_cast<const float4*>(acc)[2 * i + 1];
  uint4 out;
  out.x = pack_bf16(a.x * scale, a.y * scale);
  out.y = pack_bf16(a.z * scale, a.w * scale);
  out.z = pack_bf16(c.x * scale, c.y * scale);
  out.w = pack_bf16(c.z * scale, c.w * scale);
  reinterpret_cast<uint4*>(dq)[i] = out;
}

}  // namespace

// Arguments as flash_bwd_sm90::launch, with dq: contiguous (B, Tq, H, hs) bf16
// and dq_acc: contiguous (B, Tq, H, hs) fp32 scratch, zeroed here. Zeroes the
// scratch, launches the one-pass kernel and the cast on `stream`; returns the
// first CUDA error code (0 on success).
extern "C" int gpt2vl_flash_fused_bwd(const void* q, const void* k, const void* v,
                                      const void* dO, const void* lse, const void* dcap,
                                      void* dq_acc, void* dq, void* dk, void* dv,
                                      int B, int Tq, int Tk, int H, int hs,
                                      long long qsb, long long qst, long long qsh,
                                      long long ksb, long long kst, long long ksh,
                                      long long vsb, long long vst, long long vsh,
                                      int causal, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const long long n = (long long)B * Tq * H * HS;
  cudaError_t err = cudaMemsetAsync(dq_acc, 0, (size_t)n * sizeof(float), st);
  if (err != cudaSuccess) return (int)err;
  const int rc = flash_bwd_sm90::launch<true, STAGES>(
      flash_fused_bwd_kernel, q, k, v, dO, lse, dcap, dq_acc, dk, dv, B, Tq, Tk, H, hs, qsb,
      qst, qsh, ksb, kst, ksh, vsb, vst, vsh, causal, st);
  if (rc != 0) return rc;

  const long long n8 = n / 8;
  const float scale = 1.f / sqrtf((float)HS);
  flash_fused_dq_cast_kernel<<<(unsigned)((n8 + 255) / 256), 256, 0, st>>>(
      (const float*)dq_acc, (bf16*)dq, n8, scale);
  return (int)cudaGetLastError();
}
