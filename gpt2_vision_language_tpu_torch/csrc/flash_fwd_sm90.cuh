// The flash-attention forward main loop for Hopper (sm_90a), shared by the
// general forward (flash_general_fwd.cu, K2b), the lse forward of the ring
// (flash_lse_fwd.cu, K2a), the self-attention forward (flash_fwd.cu, K1-fwd,
// Tq = Tk) and the dt-layout forward of the A/B tool (flash_dt_fwd.cu, P1).
// Each source instantiates it as its own __global__ entry point with its own
// tile configuration (consumer warpgroups, ring slots, block order, operand
// layout); all compute the same function: Tq != Tk, ragged lengths on both
// sides, right-aligned causal or non-causal; bf16 q/k/v, fp32 online
// softmax, o and the per-row natural-log logsumexp in fp32.
//
// O = softmax(q k^T / sqrt(hs) + mask) v, where under the causal mask query i
// sits at key position i + (Tk - Tq) and sees the keys at or before it; lse =
// log sum_j exp(s_ij) over the visible keys, formed from the running max and
// sum (the ring weights every chunk's o by exp(lse_c - logaddexp lse)).
//
// The design (hopper.cuh holds the building blocks): a block is CONSUMERS + 1
// warpgroups and owns a (b, h, 64 * CONSUMERS query rows) tile. The last
// warpgroup is the producer: one thread loads the Q tile once and then K and V
// in 128-key tiles by TMA (4-D tensor maps over the strided (B, T, H, 64)
// views, 128-byte swizzle, rows past Tq and Tk zero-filled) into a ring of
// STAGES slots, with a full and an empty mbarrier per slot and per operand, so
// S of a tile can start while its V is still in flight. Each consumer owns 64
// query rows (setmaxnreg moves the producer's registers to them). It forms
// S = Q K^T with wgmma m64n128k16 from shared memory into registers, runs the
// online softmax there (a row lives in one quad of threads: max and sum by two
// shuffles; the max starts at a finite -1e30, so a row with no visible key in
// a tile keeps its max and adds exp2(-inf) = 0), packs P to bf16 straight
// into the A fragments of P V (wgmma m64n64k16, A from registers, V read
// MN-major through the transpose bit) and rescales the fp32 output
// accumulator, which never leaves registers. Within a consumer the products
// are pipelined: tile j's S is issued before tile j - 1's P V, and tile j's
// softmax runs while that P V is on the tensor cores; the exponentials are
// one FFMA and one ex2.approx each. The position mask costs compares only on
// the tiles that cross the consumer's diagonal or the Tk edge; zero-filled
// keys past Tk score 0 and are masked there by position. The consumers take
// turns to issue their products (a ring of named barriers), so one's softmax
// runs while another's products do. A causal block stops at the last key
// tile its last row sees. The output goes through the consumer's rows of the
// Q tile in shared memory to 16-byte stores; rows >= Tq are not stored. All
// offsets are 64-bit.
//
// The dt layout (Layout::DT, P1): q, k, v and o are (H, 64, B*T), the
// sequence contiguous, q pre-scaled, lse (H, B*Tq), and the causal mask has
// no offset (query i sees keys <= i). TMA reads a 4-D map over (T, B, 64, H)
// in boxes of 64 positions by 64 channels, [channel][position], zero past T
// inside each sequence; a 128-row Q tile or 128-key K or V tile is two
// boxes, 8 KB apart. The same registers come out of other reads of them: S =
// Q K^T reads Q and K both MN-major (m64n128k16 with both transpose bits, K's
// two boxes one descriptor with LBO 8 KB), and P V reads the V boxes K-major
// (the keys are the contiguous axis; no transpose bit), 32 bytes a k16 step
// and the second box for keys 64 on. o is transposed through the consumer's
// Q box ([channel][position], sw128) so that each store writes whole
// 128-byte rows of the sequence.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace flash_fwd_sm90 {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int HS = 64;   // head size the kernels are built for
constexpr int BN = 128;  // keys per K/V tile
constexpr uint32_t TILE_BYTES = BN * HS * 2;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int CONSUMERS, int STAGES>
struct Config {
  static constexpr int BM = 64 * CONSUMERS;  // query rows per block
  static constexpr int THREADS = (CONSUMERS + 1) * 128;
  // setmaxnreg: the producer keeps 24 registers a thread, the consumers share
  // the rest of the SM's 65,536 (a multiple of 8, at most 240)
  static constexpr int SPARE = ((65536 / 128 - 24) / CONSUMERS) / 8 * 8;
  static constexpr int CONSUMER_REGS = SPARE < 240 ? SPARE : 240;
  static_assert(CONSUMERS >= 2 && CONSUMERS <= 3, "two or three consumer warpgroups");
};

template <int CONSUMERS, int STAGES>
struct __align__(1024) Smem {
  bf16 q[CONSUMERS * 64 * HS];  // 64 rows a consumer; later its output tile
  bf16 k[STAGES][BN * HS];
  bf16 v[STAGES][BN * HS];
  uint64_t q_full;
  uint64_t k_full[STAGES], k_empty[STAGES], v_full[STAGES], v_empty[STAGES];
};

// The work of one block. HEADS_INNER picks the block order: false walks
// (query tile, head, batch) as (blockIdx.x, y, z), true folds the heads into
// blockIdx.x under the query tile, so the longest causal tiles of every head
// launch first. Either way the highest query tiles (the longest causal rows)
// come first. L picks the operand layout.
template <int CONSUMERS, int STAGES, bool HEADS_INNER, Layout L = Layout::BTHD>
__device__ __forceinline__ void forward_block(const CUtensorMap* mq, const CUtensorMap* mk,
                                              const CUtensorMap* mv, bf16* __restrict__ o,
                                              float* __restrict__ lse, int Tq, int Tk, int H,
                                              int causal, float scale_log2,
                                              unsigned char* smem_raw) {
  using Cfg = Config<CONSUMERS, STAGES>;
  constexpr int BM = Cfg::BM;
  constexpr uint32_t Q_BYTES = BM * HS * 2;
  constexpr int TURN0 = 1 + CONSUMERS;  // named barriers: 1.. the epilogues, then the turns
  Smem<CONSUMERS, STAGES>& sm = *reinterpret_cast<Smem<CONSUMERS, STAGES>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, wg = tid / 128;
  const int nq = (Tq + BM - 1) / BM;
  const int bx = (int)blockIdx.x;
  const int qt = nq - 1 - (HEADS_INNER ? bx / H : bx);
  const int h = HEADS_INNER ? bx % H : (int)blockIdx.y, b = (int)blockIdx.z;
  const int m0 = qt * BM;
  constexpr bool DT = L == Layout::DT;
  const int q_off = DT ? 0 : Tk - Tq;  // query i sits at key position i + q_off
  const int n_all = (Tk + BN - 1) / BN;
  const int n_tiles = causal ? min(n_all, (q_off + m0 + BM - 1) / BN + 1) : n_all;

  if (tid == 0) {
    mbar_init(&sm.q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], CONSUMERS);
      mbar_init(&sm.v_empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (tid == CONSUMERS * 128) {
      tma_prefetch_map(mq);
      tma_prefetch_map(mk);
      tma_prefetch_map(mv);
      mbar_expect_tx(&sm.q_full, Q_BYTES);
      if constexpr (DT) {
        for (int c = 0; c < CONSUMERS; ++c)
          tma_load_4d(sm.q + c * 64 * HS, mq, &sm.q_full, m0 + 64 * c, b, 0, h);
      } else {
        tma_load_4d(sm.q, mq, &sm.q_full, 0, h, m0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % STAGES, ph = (j / STAGES) & 1;
        mbar_wait(&sm.k_empty[s], ph ^ 1);
        mbar_expect_tx(&sm.k_full[s], TILE_BYTES);
        if constexpr (DT) {
          tma_load_4d(sm.k[s], mk, &sm.k_full[s], j * BN, b, 0, h);
          tma_load_4d(sm.k[s] + 64 * HS, mk, &sm.k_full[s], j * BN + 64, b, 0, h);
        } else {
          tma_load_4d(sm.k[s], mk, &sm.k_full[s], 0, h, j * BN, b);
        }
        mbar_wait(&sm.v_empty[s], ph ^ 1);
        mbar_expect_tx(&sm.v_full[s], TILE_BYTES);
        if constexpr (DT) {
          tma_load_4d(sm.v[s], mv, &sm.v_full[s], j * BN, b, 0, h);
          tma_load_4d(sm.v[s] + 64 * HS, mv, &sm.v_full[s], j * BN + 64, b, 0, h);
        } else {
          tma_load_4d(sm.v[s], mv, &sm.v_full[s], 0, h, j * BN, b);
        }
      }
    }
  } else {
    setmaxnreg_inc<Cfg::CONSUMER_REGS>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int wm0 = m0 + wg * 64;                 // this consumer's first query row
    const int row0 = wm0 + warp * 16 + lane / 4;  // its rows: row0 and row0 + 8
    const int pos0 = row0 + q_off;                // their key positions
    const int col_l = 2 * (lane % 4);             // this thread's first column in an n8 block
    bf16* qs = sm.q + wg * 64 * HS;
    const uint64_t dq = desc_sw128(qs);

    float m_i[2] = {-1e30f, -1e30f};  // running max, log2 domain
    float l_i[2] = {0.f, 0.f};        // this thread's part of the running sum
    float corr[2];                    // 2^(old max - new max) of the last tile
    float acc[32], sc[64];
    uint32_t pa[BN / 16][4];          // P of the last tile, bf16 A fragments
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    // online softmax of tile j's raw scores in place: the position mask where
    // the tile crosses this consumer's diagonal or the Tk edge, the running
    // max and sum, then p = 2^(s * scale_log2 - max)
    auto softmax = [&](int j) {
      const int n0 = j * BN;
      const bool masked = n0 + BN > Tk || (causal && n0 + BN - 1 > wm0 + q_off);
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        if (masked) {
          const int kpos = n0 + 8 * (i / 4) + col_l + (i & 1);
          const int qpos = pos0 + 8 * ((i >> 1) & 1);
          sc[i] = (kpos < Tk && (!causal || kpos <= qpos)) ? sc[i] : -INFINITY;
        }
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r] * scale_log2);
        corr[r] = ex2(m_i[r] - m_new);
        m_i[r] = m_new;
        l_i[r] *= corr[r];
      }
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int r = (i >> 1) & 1;
        sc[i] = ex2(fmaf(sc[i], scale_log2, -m_i[r]));
        l_i[r] += sc[i];
      }
    };
    auto issue_s = [&](int j) {  // S of tile j into sc
      const int s = j % STAGES;
      mbar_wait(&sm.k_full[s], (j / STAGES) & 1);
      reg_fence(sc);
      wg_fence();
      if constexpr (DT) {
        // Q and K MN-major (the channels are the rows), K's two boxes 8 KB apart
        const uint64_t dk = desc_sw128_lbo(sm.k[s], 64 * HS * 2);
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk)
          mma_m64n128_ss_tt(sc, desc_add(dq, 2048 * kk), desc_add(dk, 2048 * kk), kk);
      } else {
        const uint64_t dk = desc_sw128(sm.k[s]);
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk)
          mma_m64n128_ss(sc, desc_add(dq, 32 * kk), desc_add(dk, 32 * kk), kk);
      }
      wg_commit();
    };
    auto issue_pv = [&](int j) {  // acc += P V of tile j
      const int s = j % STAGES;
      mbar_wait(&sm.v_full[s], (j / STAGES) & 1);
      reg_fence(acc);
      wg_fence();
      const uint64_t dv = desc_sw128(sm.v[s]);
      if constexpr (DT) {
        // V K-major (the keys are the contiguous axis): 32 bytes a k16 step,
        // the second box for keys 64 on
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          mma_m64n64_rs(acc, pa[kk], desc_add(dv, (kk / 4) * 64 * HS * 2 + (kk % 4) * 32), 1);
      } else {
#pragma unroll
        for (int kk = 0; kk < BN / 16; ++kk)
          mma_m64n64_rs_tb(acc, pa[kk], desc_add(dv, 2048 * kk), 1);
      }
      wg_commit();
    };
    auto pack = [&]() {
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) pa[kk][e] = pack_bf16(sc[8 * kk + 2 * e], sc[8 * kk + 2 * e + 1]);
    };

    // the consumers take turns to issue their products, in a ring of named
    // barriers (TURN0 + consumer, each between two warpgroups): one's softmax
    // runs while another's products do. The last consumer lets consumer 0 go
    // first; each turn ends by handing over to the next consumer, except the
    // last consumer's last turn, which nobody waits for.
    const int n_turns = n_tiles + 1;
    int turn = 0;
    auto my_turn = [&]() { named_sync(TURN0 + wg, 2 * 128); };
    auto hand_over = [&]() {
      if (!(wg == CONSUMERS - 1 && turn == n_turns - 1))
        named_arrive(TURN0 + (wg + 1) % CONSUMERS, 2 * 128);
      ++turn;
    };
    if (wg == CONSUMERS - 1) named_arrive(TURN0, 2 * 128);

    mbar_wait(&sm.q_full, 0);
    my_turn();
    issue_s(0);
    hand_over();
    wg_wait<0>();
    reg_fence(sc);
    if (t == 0) mbar_arrive(&sm.k_empty[0]);
    softmax(0);
    pack();
    // tile j's scores run on the tensor cores beside tile j - 1's P V, and
    // tile j's softmax beside that P V
    for (int j = 1; j < n_tiles; ++j) {
      my_turn();
      issue_s(j);
      issue_pv(j - 1);
      hand_over();
      wg_wait<1>();  // S of tile j is in
      reg_fence(sc);
      if (t == 0) mbar_arrive(&sm.k_empty[j % STAGES]);
      softmax(j);
      reg_fence(sc);
      wg_wait<0>();  // P V of tile j - 1 is in
      reg_fence(acc);
      reg_fence(pa);
      if (t == 0) mbar_arrive(&sm.v_empty[(j - 1) % STAGES]);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] *= corr[(i >> 1) & 1];
      pack();
    }
    my_turn();
    issue_pv(n_tiles - 1);
    hand_over();
    wg_wait<0>();
    reg_fence(acc);
    reg_fence(pa);
    if (t == 0) mbar_arrive(&sm.v_empty[(n_tiles - 1) % STAGES]);

    // every row of a right-aligned causal mask with Tq <= Tk, and every row
    // of the dt layout's, sees key 0, so l > 0; the guard keeps a fully
    // masked row at o = 0 instead of NaN
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
      inv[r] = l_i[r] > 0.f ? 1.f / l_i[r] : 0.f;
    }
    unsigned char* ob = reinterpret_cast<unsigned char*>(qs);
    if constexpr (DT) {
      // o^T through this consumer's Q box ([channel][position], sw128 rows),
      // then 16-byte stores of whole rows of its 64 positions; the box lies
      // wholly below Tq or wholly past it (Tq is a multiple of 64)
#pragma unroll
      for (int j = 0; j < HS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 8 * j + col_l + (e & 1), row = warp * 16 + lane / 4 + 8 * (e >> 1);
          *reinterpret_cast<bf16*>(ob + d * 128 + (((row / 8) ^ (d % 8)) * 16) + (row % 8) * 2) =
              __float2bfloat16(acc[4 * j + e] * inv[e >> 1]);
        }
      named_sync(1 + wg, 128);
      const long long n_all_q = (long long)gridDim.z * Tq;  // B * Tq
      if (wm0 < Tq) {
        bf16* og = o + (long long)h * HS * n_all_q + (long long)b * Tq + wm0;
        for (int c = t; c < HS * 8; c += 128) {
          const int d = c / 8, chunk = c % 8;
          *reinterpret_cast<uint4*>(og + d * n_all_q + chunk * 8) =
              *reinterpret_cast<const uint4*>(ob + d * 128 + ((chunk ^ (d % 8)) * 16));
        }
      }
      if (lane % 4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int qrow = row0 + 8 * r;
          if (qrow < Tq)
            lse[(long long)h * n_all_q + (long long)b * Tq + qrow] =
                (m_i[r] + log2f(l_i[r])) * LN2;
        }
      }
      return;
    }
    // o through this consumer's rows of the Q tile (sw128 rows), then 16-byte
    // stores of whole rows
#pragma unroll
    for (int j = 0; j < HS / 8; ++j)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = warp * 16 + lane / 4 + 8 * r;
        *reinterpret_cast<uint32_t*>(ob + row * 128 + ((j ^ (row % 8)) * 16) + col_l * 2) =
            pack_bf16(acc[4 * j + 2 * r] * inv[r], acc[4 * j + 2 * r + 1] * inv[r]);
      }
    named_sync(1 + wg, 128);
    for (int c = t; c < 64 * (HS / 8); c += 128) {
      const int row = c / (HS / 8), chunk = c % (HS / 8);
      const int qrow = wm0 + row;
      if (qrow < Tq)
        *reinterpret_cast<uint4*>(o + (((long long)b * Tq + qrow) * H + h) * HS + chunk * 8) =
            *reinterpret_cast<const uint4*>(ob + row * 128 + ((chunk ^ (row % 8)) * 16));
    }
    if (lane % 4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int qrow = row0 + 8 * r;
        if (qrow < Tq) lse[((long long)b * H + h) * Tq + qrow] = (m_i[r] + log2f(l_i[r])) * LN2;
      }
    }
  }
}

// The kernel signature the entry points share.
using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap, bf16*, float*,
                        int, int, int, int, float);

// Checks the arguments, encodes the tensor maps, launches `kernel` (an
// instantiation of forward_block with the same CONSUMERS, STAGES and
// HEADS_INNER) on `stream`. q: (B, Tq, H, hs), k/v: (B, Tk, H, hs), bf16 with
// unit stride on hs; strides in elements, each a multiple of 8, base pointers
// 16-byte aligned (checked by the Python wrapper, which also rejects causal
// with Tq > Tk; TMA needs the same). o: contiguous (B, Tq, H, hs) bf16; lse:
// contiguous (B, H, Tq) fp32. Returns the CUDA error code of the launch.
template <int CONSUMERS, int STAGES, bool HEADS_INNER>
inline int launch(Kernel kernel, const void* q, const void* k, const void* v, void* o, void* lse,
                  int B, int Tq, int Tk, int H, int hs, long long qsb, long long qst,
                  long long qsh, long long ksb, long long kst, long long ksh, long long vsb,
                  long long vst, long long vsh, int causal, void* stream) {
  using Cfg = Config<CONSUMERS, STAGES>;
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || (causal && Tq > Tk) || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!hopper_host::map_bthd(&mq, q, B, Tq, H, qsb, qst, qsh, Cfg::BM) ||
      !hopper_host::map_bthd(&mk, k, B, Tk, H, ksb, kst, ksh, BN) ||
      !hopper_host::map_bthd(&mv, v, B, Tk, H, vsb, vst, vsh, BN))
    return (int)cudaErrorInvalidValue;
  // + the alignment of the base
  const int smem = (int)sizeof(Smem<CONSUMERS, STAGES>) + 1024;
  const cudaError_t err = hopper_host::set_smem_once(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (Tq + Cfg::BM - 1) / Cfg::BM;
  const dim3 grid = HEADS_INNER ? dim3(nq * H, 1, B) : dim3(nq, H, B);
  const float scale_log2 = LOG2E / sqrtf((float)HS);
  kernel<<<grid, Cfg::THREADS, smem, (cudaStream_t)stream>>>(
      mq, mk, mv, (bf16*)o, (float*)lse, Tq, Tk, H, causal, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace flash_fwd_sm90
