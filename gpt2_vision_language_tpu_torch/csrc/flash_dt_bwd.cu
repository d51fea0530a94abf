// Flash-attention backward in the "dt" layout for Hopper (sm_90a): q, k, v, dO
// and dq, dk, dv are (H, hs, B*T) bf16, the sequence contiguous and one slab of
// T positions per batch row; q arrives pre-scaled by 1/sqrt(hs).
//
// Replaces the TPU kernel tools/ab_dt_flash.py _bwd_dt_kernel (launcher
// flash_bwd_dt_b). Same function: with S = q^T k under the mask (query i sees
// keys <= i, no offset, also when Tq != Tk) and P = exp(S - lse),
//   dV = dO P^T,  dS = P * (dO^T V - dcap),  dK = Q dS,  dQ = K dS^T * dq_scale.
// lse and dcap = rowsum(dO * O) are one fp32 row per query, (H, B*Tq). P and
// dS are rounded to bf16 before their products, as on the TPU. Aligned shapes
// only, Tq % 64 == Tk % 64 == 0.
//
// What bounds it on the H100: the work of the self-attention backward
// (flash_bwd.cu), 32 GFLOP of five products at B=8, T=1024, H=12, hs=64
// causal against 88 MB of q/k/v/dO/dq/dk/dv: the tensor cores. The TPU kernel
// runs one program per (h, b) with the whole head resident and sums dq in an
// fp32 VMEM scratch of all Tq positions; here that would be 96 programs for
// 132 SMs and a scratch larger than a block's shared memory.
//
// What the design does about it: the self-attention backward's grid in the dt
// layout, as flash_dt_fwd.cu is the forward main loop in it. One launch holds
// two kinds of block, instantiations of the shared Hopper blocks with
// Layout::DT (TMA boxes of 64 positions by 64 channels through map_dt, an
// mbarrier ring, wgmma, setmaxnreg; hopper.cuh): the key-major dk/dv block of
// flash_bwd_sm90.cuh without its dQ half, which owns 128 keys and sweeps the
// 64-row query tiles from the diagonal on, and the query-major dq block of
// flash_dq_sm90.cuh, which owns 128 queries and sweeps the 128-key tiles up to
// the diagonal. Every shared-memory tile is the transpose of its bthd
// counterpart, so each shared-memory operand flips its major; the register A
// operands do not. dcap comes in, so there is no D pre-kernel. dq, dk and dv
// leave transposed through shared memory into whole 128-byte rows of the
// sequence, each summed in a fixed order by one block: no atomics, no fp32
// buffer, and all three are bit-equal from run to run, as the TPU kernel's
// are. In each sequence the heads are folded under the tile, and the dk/dv
// block of key tile i comes just before the dq block of query tile nq - 1 - i
// (the self-attention backward's order), so the longest causal sweeps of both
// kinds start first; with Tq != Tk the kind with fewer tiles leaves empty
// slots, which return at once. The softmax scale is 1 (q is pre-scaled), so
// the exponent is s * log2 e; dk takes no scale and dq takes dq_scale. The
// shared-memory attribute is set once per (device, kernel).

#include "flash_bwd_sm90.cuh"
#include "flash_dq_sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::Layout;

constexpr int DKV_STAGES = 3;  // slots of a dk/dv block's Q / dO ring, as the self-attention backward
constexpr int DQ_STAGES = 3;   // slots of a dq block's K / V ring, as the self-attention backward
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
// query tile nq - 1 - i. All four maps are map_dt (boxes of 64 positions).
__global__ void __launch_bounds__(THREADS, 1)
flash_dt_bwd_kernel(const __grid_constant__ CUtensorMap mq, const __grid_constant__ CUtensorMap mk,
                    const __grid_constant__ CUtensorMap mv,
                    const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                    const float* __restrict__ dcap, bf16* __restrict__ dq,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int Tq, int Tk, int H,
                    int causal, float dq_scale) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const int nq = (Tq + TILE - 1) / TILE, nk = (Tk + TILE - 1) / TILE;
  const int slot = (int)blockIdx.x / H, h = (int)blockIdx.x % H, b = (int)blockIdx.z;
  const int i = slot / 2;
  if (slot % 2 == 0) {
    if (i < nk)
      flash_bwd_sm90::backward_block<false, DKV_STAGES, Layout::DT>(
          &mq, &mk, &mv, &mdo, lse, dcap, nullptr, dk, dv, Tq, Tk, H, causal, 1.f, LOG2E, i, h,
          b, smem_raw);
  } else if (i < nq) {
    flash_dq_sm90::dq_block<DQ_STAGES, Layout::DT>(&mq, &mk, &mv, &mdo, lse, dcap, dq, Tq, Tk,
                                                   H, causal, dq_scale, LOG2E, nq - 1 - i, h, b,
                                                   smem_raw);
  }
}

}  // namespace

// q, dO, dq: contiguous (H, hs, B*Tq) bf16; k, v, dk, dv: contiguous
// (H, hs, B*Tk) bf16; lse, dcap: contiguous (H, B*Tq) fp32. Tq and Tk
// multiples of 64, base pointers 16-byte aligned (checked by the Python
// wrapper). Launches the backward kernel on `stream`; returns the CUDA error
// code of the launch (0 on success).
extern "C" int gpt2vl_flash_dt_bwd(const void* q, const void* k, const void* v, const void* dO,
                                   const void* lse, const void* dcap, void* dq, void* dk,
                                   void* dv, int B, int Tq, int Tk, int H, int hs, int causal,
                                   float dq_scale, void* stream) {
  if (hs != flash_bwd_sm90::HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Tq % 64 ||
      Tk % 64 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  if (!hopper_host::map_dt(&mq, q, B, Tq, H) || !hopper_host::map_dt(&mk, k, B, Tk, H) ||
      !hopper_host::map_dt(&mv, v, B, Tk, H) || !hopper_host::map_dt(&mdo, dO, B, Tq, H))
    return (int)cudaErrorInvalidValue;
  const cudaError_t err = hopper_host::set_smem_once(flash_dt_bwd_kernel, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Tq + TILE - 1) / TILE, nk = (Tk + TILE - 1) / TILE;
  const int pairs = nq > nk ? nq : nk;
  flash_dt_bwd_kernel<<<dim3(2 * pairs * H, 1, B), THREADS, SMEM, (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)dcap, (bf16*)dq, (bf16*)dk, (bf16*)dv,
      Tq, Tk, H, causal, dq_scale);
  return (int)cudaGetLastError();
}
