// Self-attention flash forward for Hopper (sm_90a): Tq == Tk = T, causal or
// not, T ragged; bf16 q/k/v, fp32 online softmax, o + lse.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _fwd_dt_kernel (launcher _fwd_dt). Same function: O = softmax(q k^T /
// sqrt(hs)) v with an optional causal mask, plus the per-row natural-log
// logsumexp in fp32, which the self-attention backward (flash_bwd.cu) reads.
// Unlike the TPU kernel it reads q/k/v in their (B, T, H, hs) layout through
// strides, so the three strided views of the fused QKV projection go in
// without a copy; the TPU's (H, hs, B*T) layout existed only for its lane
// tiling.
//
// What bounds it on the H100: at B=8, T=1024, H=12, hs=64 causal the forward
// is 12.9 GFLOP against 50 MB of q/k/v/o, about 260 FLOP per byte, so it sits
// near the ridge of the bf16 tensor cores and HBM (0.015 ms by bytes). K and
// V of one head are 256 KB at T=1024, more than a block's 227 KB of shared
// memory, so the TPU kernel's "K/V resident" design does not carry over: key
// tiles stream, and the query tiles of one head re-read them from L2.
//
// What the design does about it: the forward main loop of flash_fwd_sm90.cuh
// (TMA into an mbarrier ring, wgmma into registers, the online softmax and P
// in registers, consumers taking turns on the tensor cores), the one the
// general forward (flash_general_fwd.cu) and the lse forward
// (flash_lse_fwd.cu) run, here with Tq = Tk = T. The shape it serves is short
// sequences in many blocks: B=8, T=1024 is 8 query tiles of 128 rows by 12
// heads by 8 sequences, 768 blocks of 4.5 causal key tiles on average, and
// the fine-tune's B=128, T=65 is 1,536 blocks of one tile. Two consumer
// warpgroups of 64 rows and a ring of three K/V slots; the heads are folded
// under the query tile in the block order, so in each sequence the longest
// causal tiles of every head start first and the one-tile blocks of the
// diagonal follow. On an H100 (700 W) at B=8, T=1024 this takes 0.0610 ms
// against 0.0655 in K2b's block order (heads outer), 0.0686 and 0.0703 with
// three consumers (heads inner, outer) and 0.2142 for the wmma kernel it
// replaces; three consumers win only at B=2, T=4096 (0.1433 against 0.1510).

#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_fwd_sm90;

constexpr int CONSUMERS = 2;  // consumer warpgroups, 64 query rows each
constexpr int STAGES = 3;     // slots of the K/V ring
constexpr bool HEADS_INNER = true;

__global__ void __launch_bounds__(Config<CONSUMERS, STAGES>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                 float* __restrict__ lse, int Tq, int Tk, int H, int causal, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  forward_block<CONSUMERS, STAGES, HEADS_INNER>(&mq, &mk, &mv, o, lse, Tq, Tk, H, causal,
                                                scale_log2, smem_raw);
}

}  // namespace

// o: contiguous (B, T, H, hs) bf16; lse: contiguous (B, H, T) fp32.
// q/k/v: (B, T, H, hs) bf16 with unit stride on hs; strides in elements, each a
// multiple of 8, base pointers 16-byte aligned (checked by the Python wrapper).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int gpt2vl_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse,
                                int B, int T, int H, int hs,
                                long long qsb, long long qst, long long qsh,
                                long long ksb, long long kst, long long ksh,
                                long long vsb, long long vst, long long vsh,
                                int causal, void* stream) {
  return flash_fwd_sm90::launch<CONSUMERS, STAGES, HEADS_INNER>(
      flash_fwd_kernel, q, k, v, o, lse, B, T, T, H, hs, qsb, qst, qsh, ksb, kst, ksh, vsb, vst,
      vsh, causal, stream);
}
