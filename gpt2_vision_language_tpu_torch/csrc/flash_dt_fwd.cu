// Flash-attention forward in the "dt" layout for Hopper (sm_90a): q, k, v and o
// are (H, hs, B*T) bf16, the sequence contiguous and one slab of T positions per
// batch row; q arrives pre-scaled by 1/sqrt(hs).
//
// Replaces the TPU kernel tools/ab_dt_flash.py _fwd_dt_kernel (launcher
// flash_fwd_dt_b). Same function: O = softmax(q^T k) v per (h, b) slab with an
// optional causal mask (query i sees keys <= i, no offset, also when Tq !=
// Tk), plus the per-query logsumexp, which comes back as one fp32 row (H,
// B*Tq): the TPU kernel's eight replicated sublane rows were a register-tile
// workaround. Aligned shapes only, Tq % 64 == Tk % 64 == 0, as the prototype
// it replaces.
//
// What bounds it on the H100: the same work as flash_fwd.cu, 12.9 GFLOP against
// 50 MB at B=8, T=1024, H=12, hs=64 causal, near the ridge of the bf16 tensor
// cores and HBM (0.015 ms by bytes). The layout changes only how a tile reaches
// shared memory: 64 rows of 128 contiguous bytes of the sequence, one row a
// channel, where flash_fwd.cu reads 64 rows of 128 contiguous bytes of the
// head, one row a position. Both are full 128-byte lines, so the question the
// A/B tool is left with on this card is coalescing along the sequence against
// along the head, not tile density.
//
// What the design does about it: the forward main loop of flash_fwd_sm90.cuh,
// the one the self-attention forward (flash_fwd.cu) runs, in its dt layout
// (Layout::DT): TMA boxes of 64 positions by 64 channels over the tensor seen
// as (T, B, 64, H), so a sequence's last tile is zero-filled past T and never
// reads the next sequence; S = Q K^T with Q and K read MN-major, P V with V
// read K-major; o transposed through shared memory into stores of whole
// 128-byte rows of the sequence. The softmax scale is 1 (q is pre-scaled),
// so the exponent is s * log2 e. Two consumer warpgroups of 64 query rows,
// three K/V ring slots, the heads folded under the query tile: K1-fwd's
// configuration.

#include "flash_fwd_sm90.cuh"

namespace {

using namespace flash_fwd_sm90;

constexpr int CONSUMERS = 2;  // consumer warpgroups, 64 query rows each
constexpr int STAGES = 3;     // slots of the K/V ring
constexpr bool HEADS_INNER = true;

__global__ void __launch_bounds__(Config<CONSUMERS, STAGES>::THREADS, 1)
flash_dt_fwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv, bf16* __restrict__ o,
                    float* __restrict__ lse, int Tq, int Tk, int H, int causal,
                    float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  forward_block<CONSUMERS, STAGES, HEADS_INNER, Layout::DT>(&mq, &mk, &mv, o, lse, Tq, Tk, H,
                                                            causal, scale_log2, smem_raw);
}

}  // namespace

// q, o: contiguous (H, hs, B*Tq) bf16; k, v: contiguous (H, hs, B*Tk) bf16; lse:
// contiguous (H, B*Tq) fp32. Tq and Tk multiples of 64, base pointers 16-byte
// aligned (checked by the Python wrapper). Returns the CUDA error code of the
// launch (0 on success).
extern "C" int gpt2vl_flash_dt_fwd(const void* q, const void* k, const void* v, void* o,
                                   void* lse, int B, int Tq, int Tk, int H, int hs, int causal,
                                   void* stream) {
  using Cfg = Config<CONSUMERS, STAGES>;
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Tq % 64 || Tk % 64 || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!hopper_host::map_dt(&mq, q, B, Tq, H) || !hopper_host::map_dt(&mk, k, B, Tk, H) ||
      !hopper_host::map_dt(&mv, v, B, Tk, H))
    return (int)cudaErrorInvalidValue;
  // + the alignment of the base
  const int smem = (int)sizeof(Smem<CONSUMERS, STAGES>) + 1024;
  const cudaError_t err = hopper_host::set_smem_once(flash_dt_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Tq + Cfg::BM - 1) / Cfg::BM;
  flash_dt_fwd_kernel<<<dim3(nq * H, 1, B), Cfg::THREADS, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, Tq, Tk, H, causal, LOG2E);
  return (int)cudaGetLastError();
}
