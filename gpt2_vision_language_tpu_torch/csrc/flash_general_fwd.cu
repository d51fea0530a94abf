// General flash-attention forward for Hopper (sm_90a): Tq != Tk, ragged lengths
// on both sides, right-aligned causal or non-causal; bf16 q/k/v, fp32 online
// softmax, o + lse.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _fwd_kernel_grid (launcher _fwd, stream_kv=True): the forward that streams
// K/V one tile at a time and carries the softmax state across the sweep. Same
// function: O = softmax(q k^T / sqrt(hs) + mask) v and the per-row logsumexp,
// where under the causal mask query i sits at position i + (Tk - Tq) and sees
// the keys at or before it. The TPU kernel walks a (B*H, nq, nk) grid in order
// and carries max / sum / accumulator in scratch memory from one grid step to
// the next; blocks on the H100 run in no order, so here one block owns a
// (b, h, 128-query tile) and the key sweep is a loop inside it.
//
// What bounds it on the H100: at B=1, T=16384, H=12, hs=64 causal it is
// 2 * 2 * 12 * 16384^2 / 2 * 64 = 412 GFLOP against 101 MB of q/k/v/o, about
// 4,000 FLOP per byte: the tensor cores, not HBM, bound it by far (0.417 ms at
// 989 TFLOP/s). Every query tile re-reads its K/V prefix, which stays in the
// 50 MB L2 (K and V of one head are 4 MB at T=16384).
//
// What the design does about it: the forward main loop of flash_fwd_sm90.cuh
// (TMA into an mbarrier ring, wgmma into registers, the online softmax and P
// in registers, consumers taking turns on the tensor cores), here with two
// consumer warpgroups of 64 query rows (128-row blocks) and a ring of three
// K/V slots. At T=16384 the grid is 128 query tiles by 12 heads, 11.6 waves
// at one block an SM, so the order of the heads leaves no tail to speak of:
// blocks walk (query tile, head, batch) as (blockIdx.x, y, z), the highest
// query tiles (the longest causal rows) first.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_fwd_sm90;

constexpr int CONSUMERS = 2;  // consumer warpgroups, 64 query rows each
constexpr int STAGES = 3;     // slots of the K/V ring
constexpr bool HEADS_INNER = false;

__global__ void __launch_bounds__(Config<CONSUMERS, STAGES>::THREADS, 1)
flash_general_fwd_kernel(const __grid_constant__ CUtensorMap mq,
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
extern "C" int gpt2vl_flash_general_fwd(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int B, int Tq, int Tk, int H, int hs,
                                        long long qsb, long long qst, long long qsh,
                                        long long ksb, long long kst, long long ksh,
                                        long long vsb, long long vst, long long vsh,
                                        int causal, void* stream) {
  return flash_fwd_sm90::launch<CONSUMERS, STAGES, HEADS_INNER>(
      flash_general_fwd_kernel, q, k, v, o, lse, B, Tq, Tk, H, hs, qsb, qst, qsh, ksb, kst, ksh,
      vsb, vst, vsh, causal, stream);
}
