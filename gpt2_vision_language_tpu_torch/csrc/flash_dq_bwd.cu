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
// whose logsumexp carries a cotangent. dS is rounded to bf16 before its
// product, as on the TPU; P is 0 on masked and padded positions by a select
// on the positions, never by exp of a padded lse. The scale is applied here,
// to dq at its store (the forward applies it inside its kernel too). The TPU
// kernel walks a (B*H, nq, nk) grid in order and carries dQ in scratch memory
// across the key steps; blocks on the H100 run in no order, so the key sweep
// is a loop inside the block that owns the query tile.
//
// What bounds it on the H100: at B=1, T=16384, H=12, hs=64 causal it does
// 3 * 2 * 12 * 16384^2 / 2 * 64 = 619 GFLOP (S, dP, dQ) against about 100 MB
// of q/k/v/dO/dq and the row statistics: the tensor cores bound it by far
// (0.625 ms at 989 TFLOP/s). The K and V tiles a block streams are re-read by
// every query tile above them and stay in the 50 MB L2 (4 MB a head).
//
// What the design does about it: the query-major mirror of the key-major
// backward of flash_bwd_sm90.cuh, on the building blocks of hopper.cuh. One
// block owns a (b, h, 128-query tile) and is three warpgroups. The producer
// warp loads the Q and dO tiles once by TMA (4-D tensor maps over the strided
// views, 128-byte swizzle, rows past the lengths zero-filled); its 32 lanes
// copy the tile's lse (times log2 e) and D rows beside them (a (B, H, Tq) row
// has no 16-byte alignment for a bulk copy); then it streams K and V in
// 128-key tiles through a ring of STAGES slots, up to the last key tile the
// block's last row sees. Each of the two consumer warpgroups owns 64 query
// rows and keeps their dQ in an fp32 wgmma accumulator. Per key tile it forms
// S = Q K^T and dP = dO V^T (wgmma m64n128k16, both operands from shared
// memory), then P and dS in registers; dS packed to bf16 is the register A
// operand of dQ += dS K (wgmma m64n64k16), which reads the K tile MN-major
// through the transpose bit, as the forward reads V. The products of
// consecutive tiles overlap: tile j's dQ product is issued before tile
// j + 1's S and dP, so the tensor cores run them back to back while the
// consumer waits once a tile; the dS fragments stay live until that wait.
// The position mask costs compares only on the tiles that cross the
// consumer's diagonal or a length, and a consumer skips the key tiles past
// its own diagonal (it only releases their slot). Blocks walk (query tile,
// head) with the heads folded under the query tile, so the longest causal
// tiles of every head launch first. dq leaves through the consumer's rows of
// the Q tile in shared memory as 16-byte stores of whole rows. No atomics
// and a fixed key order: dq is deterministic. All offsets are 64-bit. On an
// H100 (700 W) at B=1, T=16384, H=12 causal it takes 2.10 ms against 6.79 for
// the wmma kernel it replaces (whose dq it matches bit for bit); 64-key tiles
// take 2.34, two ring slots 2.19, four 2.08.

#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int HS = 64;         // head size the kernel is built for
constexpr int BN = 128;        // keys per K/V tile (S and dP are m64n128 products)
constexpr int CONSUMERS = 2;   // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * CONSUMERS;  // query rows per block
constexpr int STAGES = 3;      // slots of the K/V ring
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr uint32_t ROWS_BYTES = 2 * BM * HS * 2;  // the Q and dO tiles
constexpr uint32_t KV_BYTES = 2 * BN * HS * 2;    // one K and one V tile
constexpr float LOG2E = 1.4426950408889634f;

struct __align__(1024) Smem {
  bf16 q[BM * HS];  // 64 rows a consumer; later its dq tile
  bf16 dO[BM * HS];
  bf16 k[STAGES][BN * HS];
  bf16 v[STAGES][BN * HS];
  float lse2[BM];  // lse * log2(e) of the query tile
  float dd[BM];    // D of the query tile
  uint64_t rows_full;
  uint64_t full[STAGES], empty[STAGES];
};

__global__ void __launch_bounds__(THREADS, 1)
flash_general_dq_kernel(const __grid_constant__ CUtensorMap mq,
                        const __grid_constant__ CUtensorMap mk,
                        const __grid_constant__ CUtensorMap mv,
                        const __grid_constant__ CUtensorMap mdo, const float* __restrict__ lse,
                        const float* __restrict__ dd, bf16* __restrict__ dq, int Tq, int Tk,
                        int H, int causal, float scale, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~uintptr_t(1023));

  const int tid = threadIdx.x, wg = tid / 128;
  const int nq = (Tq + BM - 1) / BM;
  const int qt = nq - 1 - (int)blockIdx.x / H;  // the highest query tiles first
  const int h = (int)blockIdx.x % H, b = (int)blockIdx.z;
  const int m0 = qt * BM;
  const int q_off = Tk - Tq;  // query i sits at key position i + q_off
  const int n_all = (Tk + BN - 1) / BN;
  const int n_tiles = causal ? min(n_all, (q_off + m0 + BM - 1) / BN + 1) : n_all;

  if (tid == 0) {
    mbar_init(&sm.rows_full, 32);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: the first warp; lane 0 issues every copy
    setmaxnreg_dec<24>();
    if (tid < CONSUMERS * 128 + 32) {
      const int lane = tid % 32;
      const float* lseb = lse + ((long long)b * H + h) * Tq;
      const float* ddb = dd + ((long long)b * H + h) * Tq;
      // rows >= Tq read as zero: their P is zeroed by position, not through these
      for (int j = lane; j < BM; j += 32) {
        const int t = m0 + j;
        sm.lse2[j] = t < Tq ? lseb[t] * LOG2E : 0.f;
        sm.dd[j] = t < Tq ? ddb[t] : 0.f;
      }
      if (lane == 0) {
        tma_prefetch_map(&mk);
        tma_prefetch_map(&mv);
        mbar_expect_tx(&sm.rows_full, ROWS_BYTES);
        tma_load_4d(sm.q, &mq, &sm.rows_full, 0, h, m0, b);
        tma_load_4d(sm.dO, &mdo, &sm.rows_full, 0, h, m0, b);
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % STAGES, ph = (j / STAGES) & 1;
          mbar_wait(&sm.empty[s], ph ^ 1);
          mbar_expect_tx(&sm.full[s], KV_BYTES);
          tma_load_4d(sm.k[s], &mk, &sm.full[s], 0, h, j * BN, b);
          tma_load_4d(sm.v[s], &mv, &sm.full[s], 0, h, j * BN, b);
        }
      } else {
        mbar_arrive(&sm.rows_full);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int wm0 = m0 + wg * 64;                 // this consumer's first query row
    const int lrow = warp * 16 + lane / 4;        // its rows in the tile: lrow, lrow + 8
    const int row0 = wm0 + lrow;
    const int col_l = 2 * (lane % 4);             // first column in an n8 block
    bf16* qs = sm.q + wg * 64 * HS;
    const uint64_t dqs = desc_sw128(qs), dos = desc_sw128(sm.dO + wg * 64 * HS);
    // the key tiles this consumer's rows see; the rest of the block's it skips
    const int n_mine = causal ? min(n_tiles, (q_off + wm0 + 63) / BN + 1) : n_tiles;

    float dqa[32], sc[BN / 2], dp[BN / 2];
    uint32_t sa[BN / 16][4];  // dS of the last tile, bf16 A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) dqa[i] = 0.f;

    auto issue_sdp = [&](int j) {  // S and dP of tile j into sc and dp
      const int s = j % STAGES;
      mbar_wait(&sm.full[s], (j / STAGES) & 1);
      reg_fence(sc);
      reg_fence(dp);
      wg_fence();
      const uint64_t dk = desc_sw128(sm.k[s]), dv = desc_sw128(sm.v[s]);
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk)
        mma_m64n128_ss(sc, desc_add(dqs, 32 * kk), desc_add(dk, 32 * kk), kk);
#pragma unroll
      for (int kk = 0; kk < HS / 16; ++kk)
        mma_m64n128_ss(dp, desc_add(dos, 32 * kk), desc_add(dv, 32 * kk), kk);
      wg_commit();
    };
    auto issue_dq = [&](int j) {  // dqa += dS K of tile j, K read MN-major
      reg_fence(dqa);
      wg_fence();
      const uint64_t dk = desc_sw128(sm.k[j % STAGES]);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        mma_m64n64_rs_tb(dqa, sa[kk], desc_add(dk, 2048 * kk), 1);
      wg_commit();
    };

    mbar_wait(&sm.rows_full, 0);
    float lse2[2], d_r[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lse2[r] = sm.lse2[wg * 64 + lrow + 8 * r];
      d_r[r] = sm.dd[wg * 64 + lrow + 8 * r];
    }

    issue_sdp(0);
    for (int j = 0; j < n_mine; ++j) {
      wg_wait<0>();  // S and dP of tile j are in, and tile j - 1's dQ product
      reg_fence(sc);
      reg_fence(dp);
      reg_fence(dqa);
      reg_fence(sa);
      if (j > 0 && t == 0) mbar_arrive(&sm.empty[(j - 1) % STAGES]);

      // P = 2^(S * scale_log2 - lse2), zero by position where the tile crosses
      // the diagonal or a length; dS = P (dP - D)
      const int n0 = j * BN;
      const bool masked =
          n0 + BN > Tk || wm0 + 64 > Tq || (causal && n0 + BN - 1 > wm0 + q_off);
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        float p = ex2(fmaf(sc[i], scale_log2, -lse2[r]));
        if (masked) {
          const int kpos = n0 + 8 * (i / 4) + col_l + (i & 1);
          const int qrow = row0 + 8 * r;
          p = (qrow < Tq && kpos < Tk && (!causal || kpos <= qrow + q_off)) ? p : 0.f;
        }
        sc[i] = p * (dp[i] - d_r[r]);
      }
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          sa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);

      issue_dq(j);
      if (j + 1 < n_mine) issue_sdp(j + 1);
    }
    wg_wait<0>();
    reg_fence(dqa);
    reg_fence(sa);
    if (t == 0) mbar_arrive(&sm.empty[(n_mine - 1) % STAGES]);
    // the block's key tiles past this consumer's diagonal: release their slots
    for (int j = n_mine; j < n_tiles; ++j) {
      const int s = j % STAGES;
      mbar_wait(&sm.full[s], (j / STAGES) & 1);
      if (t == 0) mbar_arrive(&sm.empty[s]);
    }

    // dq * scale through this consumer's rows of the Q tile (sw128 rows), then
    // 16-byte stores of whole rows; rows >= Tq are not stored
    unsigned char* ob = reinterpret_cast<unsigned char*>(qs);
#pragma unroll
    for (int j = 0; j < HS / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = lrow + 8 * r;
        *reinterpret_cast<uint32_t*>(ob + row * 128 + ((j ^ (row % 8)) * 16) + col_l * 2) =
            pack_bf16(dqa[4 * j + 2 * r] * scale, dqa[4 * j + 2 * r + 1] * scale);
      }
    named_sync(1 + wg, 128);
    for (int c = t; c < 64 * (HS / 8); c += 128) {
      const int row = c / (HS / 8), chunk = c % (HS / 8);
      const int qrow = wm0 + row;
      if (qrow < Tq)
        *reinterpret_cast<uint4*>(dq + (((long long)b * Tq + qrow) * H + h) * HS + chunk * 8) =
            *reinterpret_cast<const uint4*>(ob + row * 128 + ((chunk ^ (row % 8)) * 16));
    }
  }
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
  const int smem = (int)sizeof(Smem) + 1024;  // + the alignment of the base
  cudaError_t err = cudaFuncSetAttribute(flash_general_dq_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)HS);
  const int nq = (Tq + BM - 1) / BM;
  const dim3 grid(nq * H, 1, B);
  flash_general_dq_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, mdo, (const float*)lse, (const float*)dd, (bf16*)dq, Tq, Tk, H, causal, scale,
      scale * LOG2E);
  return (int)cudaGetLastError();
}
