// The D pre-kernel of the general flash-attention backward for Hopper
// (sm_90a): D = rowsum(dO * O) per query row, the row term that the dq kernel
// (flash_dq_bwd.cu) and the dk/dv kernel (flash_dkv_bwd.cu) take as an input,
// as the TPU kernels _dq_kernel_grid and _dkv_kernel_grid take `dcap`.
//
// Replaces no TPU kernel: gpt2_vision_language_tpu/ops/flash_attention.py _bwd
// leaves it to XLA (:573). A caller whose logsumexp also carries a cotangent
// passes D - dlse to the backward kernels instead.
//
// What bounds it on the H100: it reads dO and O once and writes one fp32 per
// row, about 2 bytes a FLOP: HBM bounds it (0.015 ms at B=1, T=16384, H=12).
// Eight lanes a row, each with one 16-byte load of each operand, then three
// shuffles.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int HS = 64;  // head size the kernel is built for

using bf16 = __nv_bfloat16;

// D[b, h, t] = sum_d dO[b, t, h, d] * O[b, t, h, d]; eight lanes per row
__global__ void flash_rowdot_kernel(const bf16* __restrict__ dO, const bf16* __restrict__ o,
                                    float* __restrict__ dd, int B, int T, int H) {
  const long long rows = (long long)B * T * H;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long row = idx >> 3;
  const int part = (int)(idx & 7);
  float sum = 0.f;
  if (row < rows) {
    const uint4 a = *reinterpret_cast<const uint4*>(dO + row * HS + part * 8);
    const uint4 c = *reinterpret_cast<const uint4*>(o + row * HS + part * 8);
    const bf16* pa = reinterpret_cast<const bf16*>(&a);
    const bf16* pc = reinterpret_cast<const bf16*>(&c);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum += __bfloat162float(pa[e]) * __bfloat162float(pc[e]);
  }
  sum += __shfl_xor_sync(0xffffffffu, sum, 4);
  sum += __shfl_xor_sync(0xffffffffu, sum, 2);
  sum += __shfl_xor_sync(0xffffffffu, sum, 1);
  if (row < rows && part == 0) {
    const int h = (int)(row % H);
    const long long bt = row / H;
    const int t = (int)(bt % T), b = (int)(bt / T);
    dd[((long long)b * H + h) * T + t] = sum;
  }
}

}  // namespace

// D = rowsum(dO * O): dO, o contiguous (B, T, H, hs) bf16 -> dd contiguous
// (B, H, T) fp32. Returns the CUDA error code of the launch (0 on success).
extern "C" int gpt2vl_flash_rowdot(const void* dO, const void* o, void* dd, int B, int T, int H,
                                   int hs, void* stream) {
  if (hs != HS || B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long lanes = (long long)B * T * H * 8;
  flash_rowdot_kernel<<<(unsigned)((lanes + 255) / 256), 256, 0, (cudaStream_t)stream>>>(
      (const bf16*)dO, (const bf16*)o, (float*)dd, B, T, H);
  return (int)cudaGetLastError();
}
