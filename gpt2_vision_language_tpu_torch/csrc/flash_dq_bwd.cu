// General flash-attention dq backward for Hopper (sm_90a): dq for Tq != Tk,
// ragged lengths on both sides, right-aligned causal or non-causal, with the
// row term D given by the caller. Its dk/dv partner is flash_dkv_bwd.cu, the
// D pre-kernel flash_general_bwd.cu.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _dq_kernel_grid (step _dq_step), launched by _bwd with stream_kv=True. Same
// function: with P = exp(S - lse), S = q k^T / sqrt(hs) under the mask (query
// i at key position i + Tk - Tq) and D an input (there `dcap`),
//   dS = P * (dO V^T - D),  dQ = dS K / sqrt(hs).
// D is rowsum(dO * O) from gpt2vl_flash_rowdot, or D - dlse from a caller
// whose logsumexp carries a cotangent. The TPU kernel walks a (B*H, nq, nk)
// grid in order and carries dQ in scratch memory across the key steps; blocks
// on the H100 run in no order, so the key sweep is a loop inside the block
// that owns the query tile.
//
// What bounds it on the H100: at B=1, T=16384, H=12, hs=64 causal it does
// 3 * 2 * 12 * 16384^2 / 2 * 64 = 619 GFLOP (S, dP, dQ) against about 100 MB
// of q/k/v/dO/dq and the row statistics: the tensor cores bound it by far
// (0.625 ms at 989 TFLOP/s). The K and V tiles a block streams are re-read by
// every query tile above them and stay in the 50 MB L2 (4 MB a head).
//
// What the design does about it: the query-major dq block of
// flash_dq_sm90.cuh, shared with the dq half of the self-attention backward
// (flash_bwd.cu): one block owns a (b, h, 128-query tile), a producer warp
// loads Q and dO once and streams K and V by TMA through a ring of three
// slots, and two consumer warpgroups of 64 query rows form S and dP with
// wgmma from shared memory and keep dQ in an fp32 accumulator, dS in
// registers as its A operand; no atomics and a fixed key order, so dq is
// deterministic. Blocks walk (query tile, head) with the heads folded under
// the query tile, so the longest causal tiles of every head launch first. On
// an H100 (700 W) at B=1, T=16384, H=12 causal it takes 2.10 ms against 6.79
// for the wmma kernel it replaces (whose dq it matches bit for bit); 64-key
// tiles take 2.34, two ring slots 2.19, four 2.08.

#include "flash_dq_sm90.cuh"

namespace {

using namespace flash_dq_sm90;

constexpr int STAGES = 3;  // slots of the K/V ring

__global__ void __launch_bounds__(THREADS, 1)
flash_general_dq_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                        const float* __restrict__ dd, bf16* __restrict__ dq, int Tq, int Tk,
                        int H, int causal, float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nq = (Tq + BM - 1) / BM;
  // the highest query tiles first, the heads folded under the query tile
  dq_block<STAGES>(&mq, &mk, &mv, &mdo, lse, dd, dq, Tq, Tk, H, causal, scale, scale_log2,
                   nq - 1 - (int)blockIdx.x / H, (int)blockIdx.x % H, (int)blockIdx.z,
                   smem_raw);
}

}  // namespace

// q: (B, Tq, H, hs), k/v: (B, Tk, H, hs), bf16 with unit stride on hs; strides
// in elements, each a multiple of 8, base pointers 16-byte aligned (TMA needs
// the same). dO, dq: contiguous (B, Tq, H, hs) bf16. lse, dd: contiguous
// (B, H, Tq) fp32, lse from the forward, dd = D from the caller. All checked
// by the Python wrapper. Returns the CUDA error code of the launch (0 on
// success).
extern "C" int gpt2vl_flash_general_dq(const void* q, const void* k, const void* v,
                                       const void* dO, const void* lse, const void* dd, void* dq,
                                       int B, int Tq, int Tk, int H, int hs,
                                       long long qsb, long long qst, long long qsh,
                                       long long ksb, long long kst, long long ksh,
                                       long long vsb, long long vst, long long vsh,
                                       int causal, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || (causal && Tq > Tk) || B > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  const long long ost = (long long)H * HS;  // row stride of dO
  if (!hopper_host::map_bthd(&mq, q, B, Tq, H, qsb, qst, qsh, BM) ||
      !hopper_host::map_bthd(&mk, k, B, Tk, H, ksb, kst, ksh, BN) ||
      !hopper_host::map_bthd(&mv, v, B, Tk, H, vsb, vst, vsh, BN) ||
      !hopper_host::map_bthd(&mdo, dO, B, Tq, H, Tq * ost, ost, HS, BM))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes<STAGES>();
  const cudaError_t err = hopper_host::set_smem_once(flash_general_dq_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)HS);
  const int nq = (Tq + BM - 1) / BM;
  const dim3 grid(nq * H, 1, B);
  flash_general_dq_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)dd, (bf16*)dq, Tq, Tk, H, causal, scale,
      scale * LOG2E);
  return (int)cudaGetLastError();
}
