// The query-major flash-attention dq backward for Hopper (sm_90a), shared by
// the general dq backward (flash_dq_bwd.cu, K3a), the dq half of the
// self-attention backward (flash_bwd.cu, K1-bwd) and the dq half of the A/B
// tool's dt-layout backward (flash_dt_bwd.cu, P2). Each source instantiates it
// in its own __global__ entry point and picks the block order (which query
// tile, head and sequence a block owns). Tq != Tk, ragged lengths on both
// sides, right-aligned causal or non-causal, the row term D an input.
//
// Function: with P = exp(S - lse), S = q k^T / sqrt(hs) under the mask
// (query i at key position i + Tk - Tq),
//   dS = P * (dO V^T - D),  dQ = dS K / sqrt(hs).
// dS is rounded to bf16 before its product, as on the TPU; P is 0 on masked
// and padded positions by a select on the positions, never by exp of a
// padded lse. The scale is applied here, to dq at its store (the forward
// applies it inside its kernel too).
//
// The design (hopper.cuh holds the building blocks): the query-major mirror
// of the key-major backward of flash_bwd_sm90.cuh. One block owns a (b, h,
// 128-query tile) and is three warpgroups. The producer warp loads the Q and
// dO tiles once by TMA (4-D tensor maps over the strided views, 128-byte
// swizzle, rows past the lengths zero-filled); its 32 lanes copy the tile's
// lse (times log2 e) and D rows beside them (a (B, H, Tq) row has no 16-byte
// alignment for a bulk copy); then it streams K and V in 128-key tiles
// through a ring of STAGES slots, up to the last key tile the block's last
// row sees. Each of the two consumer warpgroups owns 64 query rows and keeps
// their dQ in an fp32 wgmma accumulator. Per key tile it forms S = Q K^T and
// dP = dO V^T (wgmma m64n128k16, both operands from shared memory), then P
// and dS in registers; dS packed to bf16 is the register A operand of dQ +=
// dS K (wgmma m64n64k16), which reads the K tile MN-major through the
// transpose bit, as the forward reads V. The products of consecutive tiles
// overlap: tile j's dQ product is issued before tile j + 1's S and dP, so the
// tensor cores run them back to back while the consumer waits once a tile;
// the dS fragments stay live until that wait. The position mask costs
// compares only on the tiles that cross the consumer's diagonal or a length,
// and a consumer skips the key tiles past its own diagonal (it only releases
// their slot). dq leaves through the consumer's rows of the Q tile in shared
// memory as 16-byte stores of whole rows. No atomics and a fixed key order:
// dq is deterministic. All offsets are 64-bit.
//
// The dt layout (Layout::DT, P2): every tensor (H, 64, B*T), the stats (H,
// B*Tq), the causal mask without offset. The tiles in shared memory are the
// transposes of the bthd ones, so S = Q K^T and dP = dO V^T read all four
// MN-major (K's and V's two 64-key boxes one descriptor, LBO 8 KB, as the
// forward main loop's dt S), dQ += dS K reads K K-major; dq leaves transposed
// through the consumer's Q box into whole 128-byte rows of the sequence.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace flash_dq_sm90 {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int HS = 64;         // head size the kernels are built for
constexpr int BN = 128;        // keys per K/V tile (S and dP are m64n128 products)
constexpr int CONSUMERS = 2;   // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * CONSUMERS;  // query rows per block
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr uint32_t ROWS_BYTES = 2 * BM * HS * 2;  // the Q and dO tiles
constexpr uint32_t KV_BYTES = 2 * BN * HS * 2;    // one K and one V tile
constexpr float LOG2E = 1.4426950408889634f;

template <int STAGES>
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

// dynamic shared memory of one block: Smem and the alignment of the base
template <int STAGES>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<STAGES>) + 1024;
}

// The work of one block: query tile qt of head h of batch b. q: (B, Tq, H,
// hs) and k/v: (B, Tk, H, hs) through the maps (boxes of BM query rows and BN
// key rows), dO through its map (boxes of BM rows); lse, dd (B, H, Tq) fp32;
// dq contiguous (B, Tq, H, hs) bf16. L picks the operand layout: in the dt
// layout every tensor is (H, hs, B*T) through map_dt (boxes of 64 positions),
// lse and dd are (H, B*Tq), and the batch count is gridDim.z.
template <int STAGES, Layout L = Layout::BTHD>
__device__ __forceinline__ void dq_block(const CUtensorMap* mq, const CUtensorMap* mk,
                                         const CUtensorMap* mv, const CUtensorMap* mdo,
                                         const float* __restrict__ lse,
                                         const float* __restrict__ dd, bf16* __restrict__ dq,
                                         int Tq, int Tk, int H, int causal, float scale,
                                         float scale_log2, int qt, int h, int b,
                                         unsigned char* smem_raw) {
  constexpr bool DT = L == Layout::DT;
  Smem<STAGES>& sm = *reinterpret_cast<Smem<STAGES>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, wg = tid / 128;
  const int m0 = qt * BM;
  const int q_off = DT ? 0 : Tk - Tq;  // query i sits at key position i + q_off
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
      // a query's stats: (B, H, Tq) rows, or (H, B*Tq) in the dt layout
      const long long srow = DT ? ((long long)h * gridDim.z + b) * Tq : ((long long)b * H + h) * Tq;
      const float* lseb = lse + srow;
      const float* ddb = dd + srow;
      // rows >= Tq read as zero: their P is zeroed by position, not through these
      for (int j = lane; j < BM; j += 32) {
        const int t = m0 + j;
        sm.lse2[j] = t < Tq ? lseb[t] * LOG2E : 0.f;
        sm.dd[j] = t < Tq ? ddb[t] : 0.f;
      }
      if (lane == 0) {
        tma_prefetch_map(mk);
        tma_prefetch_map(mv);
        mbar_expect_tx(&sm.rows_full, ROWS_BYTES);
        if constexpr (DT) {
          // two boxes of 64 positions, [channel][position]: box c is consumer c's
          for (int c = 0; c < CONSUMERS; ++c) {
            tma_load_4d(sm.q + c * 64 * HS, mq, &sm.rows_full, m0 + 64 * c, b, 0, h);
            tma_load_4d(sm.dO + c * 64 * HS, mdo, &sm.rows_full, m0 + 64 * c, b, 0, h);
          }
        } else {
          tma_load_4d(sm.q, mq, &sm.rows_full, 0, h, m0, b);
          tma_load_4d(sm.dO, mdo, &sm.rows_full, 0, h, m0, b);
        }
        for (int j = 0; j < n_tiles; ++j) {
          const int s = j % STAGES, ph = (j / STAGES) & 1;
          mbar_wait(&sm.empty[s], ph ^ 1);
          mbar_expect_tx(&sm.full[s], KV_BYTES);
          if constexpr (DT) {
            tma_load_4d(sm.k[s], mk, &sm.full[s], j * BN, b, 0, h);
            tma_load_4d(sm.k[s] + 64 * HS, mk, &sm.full[s], j * BN + 64, b, 0, h);
            tma_load_4d(sm.v[s], mv, &sm.full[s], j * BN, b, 0, h);
            tma_load_4d(sm.v[s] + 64 * HS, mv, &sm.full[s], j * BN + 64, b, 0, h);
          } else {
            tma_load_4d(sm.k[s], mk, &sm.full[s], 0, h, j * BN, b);
            tma_load_4d(sm.v[s], mv, &sm.full[s], 0, h, j * BN, b);
          }
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
      if constexpr (DT) {
        // all four tiles MN-major (the channels are the rows); K's and V's
        // two boxes one descriptor each, LBO 8 KB
        const uint64_t dk = desc_sw128_lbo(sm.k[s], 64 * HS * 2);
        const uint64_t dv = desc_sw128_lbo(sm.v[s], 64 * HS * 2);
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk)
          mma_m64n128_ss_tt(sc, desc_add(dqs, 2048 * kk), desc_add(dk, 2048 * kk), kk);
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk)
          mma_m64n128_ss_tt(dp, desc_add(dos, 2048 * kk), desc_add(dv, 2048 * kk), kk);
      } else {
        const uint64_t dk = desc_sw128(sm.k[s]), dv = desc_sw128(sm.v[s]);
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk)
          mma_m64n128_ss(sc, desc_add(dqs, 32 * kk), desc_add(dk, 32 * kk), kk);
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk)
          mma_m64n128_ss(dp, desc_add(dos, 32 * kk), desc_add(dv, 32 * kk), kk);
      }
      wg_commit();
    };
    auto issue_dq = [&](int j) {  // dqa += dS K of tile j, K read MN-major
      reg_fence(dqa);
      wg_fence();
      const uint64_t dk = desc_sw128(sm.k[j % STAGES]);
      if constexpr (DT) {
        // K read K-major (the keys are the contiguous axis): 32 bytes a k16
        // step, the second box for keys 64 on
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          mma_m64n64_rs(dqa, sa[kk], desc_add(dk, (kk / 4) * 64 * HS * 2 + (kk % 4) * 32), 1);
      } else {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          mma_m64n64_rs_tb(dqa, sa[kk], desc_add(dk, 2048 * kk), 1);
      }
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

    unsigned char* ob = reinterpret_cast<unsigned char*>(qs);
    if constexpr (DT) {
      // dq^T * scale through this consumer's Q box ([channel][position],
      // sw128), then 16-byte stores of whole rows of its 64 positions; the box
      // lies wholly below Tq or wholly past it (Tq is a multiple of 64)
#pragma unroll
      for (int j = 0; j < HS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 8 * j + col_l + (e & 1), row = lrow + 8 * (e >> 1);
          *reinterpret_cast<bf16*>(ob + d * 128 + (((row / 8) ^ (d % 8)) * 16) + (row % 8) * 2) =
              __float2bfloat16(dqa[4 * j + e] * scale);
        }
      named_sync(1 + wg, 128);
      if (wm0 < Tq) {
        const long long n_all_q = (long long)gridDim.z * Tq;  // B * Tq
        bf16* dqg = dq + (long long)h * HS * n_all_q + (long long)b * Tq + wm0;
        for (int c = t; c < HS * 8; c += 128) {
          const int d = c / 8, chunk = c % 8;
          *reinterpret_cast<uint4*>(dqg + d * n_all_q + chunk * 8) =
              *reinterpret_cast<const uint4*>(ob + d * 128 + ((chunk ^ (d % 8)) * 16));
        }
      }
      return;
    }
    // dq * scale through this consumer's rows of the Q tile (sw128 rows), then
    // 16-byte stores of whole rows; rows >= Tq are not stored
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

}  // namespace flash_dq_sm90
