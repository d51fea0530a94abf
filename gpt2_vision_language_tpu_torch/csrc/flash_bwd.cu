// Self-attention flash backward for Hopper (sm_90a): dq, dk, dv from the saved
// lse, Tq == Tk = T, causal or not, T ragged.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _bwd_dt_kernel (launcher _bwd_dt). Same function: with P = exp(S - lse),
// S = q k^T / sqrt(hs) (causal-masked), and D = rowsum(dO * O),
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = dS K / sqrt(hs),  dK = dS^T Q / sqrt(hs).
// Unlike the TPU kernel, the scale is applied here (the forward applies it
// inside its kernel too), and q/k/v are read in their (B, T, H, hs) layout
// through strides, so the strided views of the fused QKV projection go in
// without a copy. P and dS are rounded to bf16 before their products, as on
// the TPU.
//
// What bounds it on the H100: at B=8, T=1024, H=12, hs=64 causal the backward
// is 32 GFLOP of useful work (five products of the visible pairs) against
// about 100 MB of q/k/v/o/dO/dq/dk/dv, over 300 FLOP per byte: the tensor
// cores, not HBM, bound it (0.033 ms at 989 TFLOP/s). The TPU kernel runs one
// program per (h, b) and keeps a (hs, T) fp32 dq accumulator resident: 256 KB
// at T=1024, more than a block's 227 KB of shared memory, and B*H = 96
// programs would not fill 132 SMs.
//
// What the design does about it: one launch of two kinds of block, each an
// instantiation of a shared Hopper block (TMA into an mbarrier ring, wgmma,
// setmaxnreg; hopper.cuh). A dk/dv block is the key-major block of
// flash_bwd_sm90.cuh without its dQ half, as the general dk/dv kernel
// (flash_dkv_bwd.cu) runs it: it owns 128 keys of one (b, h) and sweeps the
// 64-row query tiles from the diagonal on, dK and dV in wgmma accumulators.
// A dq block is the query-major block of flash_dq_sm90.cuh, as the general dq
// kernel (flash_dq_bwd.cu) runs it: it owns 128 queries and sweeps the
// 128-key tiles up to the diagonal, dQ in a wgmma accumulator. Both recompute
// S and dP from the saved lse and read D, which the D pre-kernel of
// flash_general_bwd.cu forms first in the same call (gpt2vl_flash_rowdot).
// Seven products per visited pair where a one-pass block does five, but no
// atomics and no zeroed fp32 buffer: dq, dk and dv are summed in a fixed
// order and are bit-equal from run to run, as the TPU kernel's are. The two
// halves read the same inputs and write disjoint outputs, so one grid holds
// both: in each sequence the heads are folded under the tile, and the dk/dv
// block of key tile i comes just before the dq block of query tile nt - 1 - i,
// so the longest causal sweeps of both kinds start first and the shortest
// fill the tail of the grid. The shared-memory attribute is set once per
// (device, kernel).

#include "flash_bwd_sm90.cuh"
#include "flash_dq_sm90.cuh"

// The D pre-kernel's entry point (flash_general_bwd.cu).
extern "C" int gpt2vl_flash_rowdot(const void* dO, const void* o, void* dd, int B, int T, int H,
                                   int hs, void* stream);

namespace {

using bf16 = __nv_bfloat16;

constexpr int DKV_STAGES = 3;  // slots of a dk/dv block's Q / dO ring, as the general kernel
constexpr int DQ_STAGES = 3;   // slots of a dq block's K / V ring, as the general kernel
constexpr int TILE = 128;      // keys of a dk/dv block, queries of a dq block
constexpr int THREADS = 384;   // both blocks: two consumer warpgroups and a producer
constexpr int SMEM = flash_bwd_sm90::smem_bytes<false, DKV_STAGES>() >
                             flash_dq_sm90::smem_bytes<DQ_STAGES>()
                         ? flash_bwd_sm90::smem_bytes<false, DKV_STAGES>()
                         : flash_dq_sm90::smem_bytes<DQ_STAGES>();
constexpr float LOG2E = 1.4426950408889634f;
static_assert(flash_bwd_sm90::BK == TILE && flash_dq_sm90::BM == TILE &&
                  flash_dq_sm90::BN == TILE,
              "a dk/dv block and a dq block cover the same 128 positions");
static_assert(flash_bwd_sm90::THREADS == THREADS && flash_dq_sm90::THREADS == THREADS,
              "both blocks run in one grid");

// Block x of batch z: in each sequence the heads are folded under the tile,
// and pair i of tiles is the dk/dv block of key tile i, then the dq block of
// query tile nt - 1 - i. mq_kv / mdo_kv have boxes of 64 rows (a dk/dv
// block's query tile), mq_q / mdo_q boxes of 128 (a dq block's); mk, mv boxes
// of 128.
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_kernel(const __grid_constant__ CUtensorMap mq_kv,
                 const __grid_constant__ CUtensorMap mdo_kv,
                 const __grid_constant__ CUtensorMap mq_q,
                 const __grid_constant__ CUtensorMap mdo_q,
                 const __grid_constant__ CUtensorMap mk, const __grid_constant__ CUtensorMap mv,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 bf16* __restrict__ dq, bf16* __restrict__ dk, bf16* __restrict__ dv, int T,
                 int H, int causal, float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nt = (T + TILE - 1) / TILE;
  const int slot = (int)blockIdx.x / H, h = (int)blockIdx.x % H, b = (int)blockIdx.z;
  const int i = slot / 2;
  if (slot % 2 == 0)
    flash_bwd_sm90::backward_block<false, DKV_STAGES>(&mq_kv, &mk, &mv, &mdo_kv, lse, dd,
                                                      nullptr, dk, dv, T, T, H, causal, scale,
                                                      scale_log2, i, h, b, smem_raw);
  else
    flash_dq_sm90::dq_block<DQ_STAGES>(&mq_q, &mk, &mv, &mdo_q, lse, dd, dq, T, T, H, causal,
                                       scale, scale_log2, nt - 1 - i, h, b, smem_raw);
}

}  // namespace

// q/k/v: (B, T, H, hs) bf16 with unit stride on hs; strides in elements, each a
// multiple of 8, base pointers 16-byte aligned. o, dO, dq, dk, dv: contiguous
// (B, T, H, hs) bf16. lse: contiguous (B, H, T) fp32 from the forward. dd:
// (B, H, T) fp32 scratch for D. All checked by the Python wrapper. Launches
// the D pre-kernel and the backward kernel on `stream`; returns the first
// CUDA error code (0 on success).
extern "C" int gpt2vl_flash_bwd(const void* q, const void* k, const void* v, const void* o,
                                const void* dO, const void* lse, void* dd, void* dq, void* dk,
                                void* dv, int B, int T, int H, int hs,
                                long long qsb, long long qst, long long qsh,
                                long long ksb, long long kst, long long ksh,
                                long long vsb, long long vst, long long vsh,
                                int causal, void* stream) {
  if (hs != flash_bwd_sm90::HS || B <= 0 || T <= 0 || H <= 0 || B > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq_kv, mdo_kv, mq_q, mdo_q, mk, mv;
  const long long ost = (long long)H * hs;  // row stride of dO
  if (!hopper_host::map_bthd(&mq_kv, q, B, T, H, qsb, qst, qsh, flash_bwd_sm90::BQ) ||
      !hopper_host::map_bthd(&mdo_kv, dO, B, T, H, T * ost, ost, hs, flash_bwd_sm90::BQ) ||
      !hopper_host::map_bthd(&mq_q, q, B, T, H, qsb, qst, qsh, TILE) ||
      !hopper_host::map_bthd(&mdo_q, dO, B, T, H, T * ost, ost, hs, TILE) ||
      !hopper_host::map_bthd(&mk, k, B, T, H, ksb, kst, ksh, TILE) ||
      !hopper_host::map_bthd(&mv, v, B, T, H, vsb, vst, vsh, TILE))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = hopper_host::set_smem_once(flash_bwd_kernel, SMEM);
  if (err != cudaSuccess) return (int)err;

  const int rc = gpt2vl_flash_rowdot(dO, o, dd, B, T, H, hs, stream);
  if (rc != 0) return rc;

  const float scale = 1.f / sqrtf((float)hs);
  const int nt = (T + TILE - 1) / TILE;
  flash_bwd_kernel<<<dim3(2 * nt * H, 1, B), THREADS, SMEM, (cudaStream_t)stream>>>(
      mq_kv, mdo_kv, mq_q, mdo_q, mk, mv, (const float*)lse, (const float*)dd, (bf16*)dq,
      (bf16*)dk, (bf16*)dv, T, H, causal, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}
