// Flash-attention forward with logsumexp for Hopper (sm_90a): the forward of
// flash_attention_with_lse, one (query chunk, key chunk) pair of ring
// attention per launch. Tq != Tk, ragged lengths on both sides, right-aligned
// causal or non-causal; bf16 q/k/v, fp32 online softmax, o + lse.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _fwd_kernel (launcher _fwd, stream_kv=False): the forward that holds K and V
// of one (b, h) whole in fast memory and sweeps them with a loop inside the
// kernel. Same function: O = softmax(q k^T / sqrt(hs) + mask) v and the per-row
// logsumexp (natural log) of the scaled, masked scores, where under the causal
// mask query i sits at position i + (Tk - Tq) and sees the keys at or before
// it. The lse leaves the kernel to be merged with other chunks' (logaddexp)
// and carries a gradient, so it is formed in fp32 from the running max and sum.
//
// What bounds it on the H100: a ring hop at Tq = Tk = 4096, H = 12, hs = 64
// without a mask is 2 * 2 * 12 * 4096^2 * 64 = 51.5 GFLOP against 25 MB of
// q/k/v/o, about 2,000 FLOP per byte: the tensor cores bound it (0.052 ms at
// 989 TFLOP/s), not HBM. K and V of one head at 4096 keys are 1 MB, far over a
// block's 227 KB of shared memory, so "K/V whole in fast memory" becomes the
// 50 MB L2: the query tiles of one head all stream the same 1 MB of K/V.
//
// What the design does about it: the forward main loop of flash_fwd_sm90.cuh
// (TMA into an mbarrier ring, wgmma into registers, the online softmax and P
// in registers, consumers taking turns on the tensor cores), shared with the
// general forward (flash_general_fwd.cu), in a configuration of its own for
// the ring's chunk pair, B=1, Tq=Tk=4096, H=12. Three consumer warpgroups of
// 64 query rows (192-row blocks, 160 registers a consumer thread by
// setmaxnreg) keep three softmaxes in flight beside the tensor cores where two
// kept two; each K/V tile in shared memory feeds 192 query rows instead of
// 128: on an H100 it takes 14% less time on the unmasked pair and 12% less on
// the causal one than two consumers in the same block order. The grid is 22
// query tiles by 12 heads, 264 blocks, two waves at one block an SM. The
// heads are folded under the query tile in the block order, so on the causal
// diagonal pair the longest tiles of all twelve heads start in the first
// wave and the short ones fill the tail.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_fwd_sm90;

constexpr int CONSUMERS = 3;  // consumer warpgroups, 64 query rows each
constexpr int STAGES = 3;     // slots of the K/V ring
constexpr bool HEADS_INNER = true;

__global__ void __launch_bounds__(Config<CONSUMERS, STAGES>::THREADS, 1)
flash_lse_fwd_kernel(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                     float* __restrict__ lse, int Tq, int Tk, int H, int causal,
                     float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  forward_block<CONSUMERS, STAGES, HEADS_INNER>(&mq, &mk, &mv, o, lse, Tq, Tk, H, causal,
                                                scale_log2, smem_raw);
}

}  // namespace

// Arguments as flash_fwd_sm90::launch. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int gpt2vl_flash_lse_fwd(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int Tq, int Tk, int H, int hs,
                                    long long qsb, long long qst, long long qsh,
                                    long long ksb, long long kst, long long ksh,
                                    long long vsb, long long vst, long long vsh,
                                    int causal, void* stream) {
  return flash_fwd_sm90::launch<CONSUMERS, STAGES, HEADS_INNER>(
      flash_lse_fwd_kernel, q, k, v, o, lse, B, Tq, Tk, H, hs, qsb, qst, qsh, ksb, kst, ksh,
      vsb, vst, vsh, causal, stream);
}
