// General flash-attention dk/dv backward for Hopper (sm_90a): dk and dv for
// Tq != Tk, ragged lengths on both sides, right-aligned causal or non-causal,
// with the row term D given by the caller. Its dq partner and the D
// pre-kernel are in flash_general_bwd.cu.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _dkv_kernel_grid (step _dkv_step), launched by _bwd with stream_kv=True.
// Same function: with P = exp(S - lse), S = q k^T / sqrt(hs) under the mask
// (query i at key position i + Tk - Tq) and D an input,
//   dV = P^T dO,  dS = P * (dO V^T - D),  dK = dS^T Q / sqrt(hs).
// D is rowsum(dO * O) from gpt2vl_flash_rowdot, or D - dlse from a caller
// whose logsumexp carries a cotangent. P and dS are rounded to bf16 before
// their products, as on the TPU; P is 0 on padded rows by a select on the
// positions. The TPU kernel walks a (B*H, nk, nq) grid in order and carries
// dK and dV in scratch memory across the query steps; blocks on the H100 run
// in no order, so the query sweep is a loop inside the block that owns the
// key tile.
//
// What bounds it on the H100: at B=1, T=16384, H=12, hs=64 causal it does
// 4 * 2 * 12 * 16384^2 / 2 * 64 = 825 GFLOP (S, dP, dV, dK) against about
// 100 MB of q/k/v/dO/dk/dv and the row statistics: the tensor cores bound it
// by far (0.834 ms at 989 TFLOP/s). The Q and dO tiles a block streams are
// re-read by every key tile below them and stay in the 50 MB L2 (4 MB a head).
//
// What the design does about it: the key-major backward of flash_bwd_sm90.cuh
// without its dQ half (DQ = false), shared with the one-pass backward of the
// ring (flash_fused_bwd.cu). One block owns a (b, h, 128-key tile) and loops
// over the 64-row query tiles from the first one that sees it, the lowest key
// tiles (the longest causal sweeps) first; a producer streams Q and dO by TMA
// through a ring of three slots with the lse * log2 e and D rows beside them;
// two consumer warpgroups of 64 keys each form S^T and dP^T with wgmma from
// shared memory and keep P^T and dS^T in registers as the A operands of dV +=
// P^T dO and dK += dS^T Q, whose fp32 accumulators never leave registers until
// the store. With no dQ there is no dS^T tile in shared memory, no barrier
// between the consumers and no reductions: each consumer is independent
// apart from the ring, and dk and dv are deterministic. Making the two
// consumers take turns to issue their products, as the forward's do, changed
// its time by less than 1% on an H100, so they do not.

#include "flash_bwd_sm90.cuh"

namespace {

using namespace flash_bwd_sm90;

constexpr int STAGES = 3;  // slots of the Q / dO ring

__global__ void __launch_bounds__(THREADS, 1)
flash_general_dkv_kernel(const __grid_constant__ CUtensorMap mq,
                         const __grid_constant__ CUtensorMap mk,
                         const __grid_constant__ CUtensorMap mv,
                         const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                         const float* __restrict__ dd, float* __restrict__ unused,
                         bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int H,
                         int causal, float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  backward_block<false, STAGES>(&mq, &mk, &mv, &mdo, lse, dd, unused, dk, dv, Tq, Tk, H, causal,
                                scale, scale_log2, blockIdx.x, blockIdx.y, blockIdx.z, smem_raw);
}

}  // namespace

// q: (B, Tq, H, hs), k/v: (B, Tk, H, hs), bf16 with unit stride on hs; strides
// in elements, each a multiple of 8, base pointers 16-byte aligned. dO:
// contiguous (B, Tq, H, hs) bf16; dk, dv: contiguous (B, Tk, H, hs) bf16. lse,
// dd: contiguous (B, H, Tq) fp32, lse from the forward, dd = D from the
// caller. All checked by the Python wrapper. Returns the CUDA error code of
// the launch (0 on success).
extern "C" int gpt2vl_flash_general_dkv(const void* q, const void* k, const void* v,
                                        const void* dO, const void* lse, const void* dd,
                                        void* dk, void* dv,
                                        int B, int Tq, int Tk, int H, int hs,
                                        long long qsb, long long qst, long long qsh,
                                        long long ksb, long long kst, long long ksh,
                                        long long vsb, long long vst, long long vsh,
                                        int causal, void* stream) {
  return flash_bwd_sm90::launch<false, STAGES>(
      flash_general_dkv_kernel, q, k, v, dO, lse, dd, nullptr, dk, dv, B, Tq, Tk, H, hs, qsb,
      qst, qsh, ksb, kst, ksh, vsb, vst, vsh, causal, (cudaStream_t)stream);
}
