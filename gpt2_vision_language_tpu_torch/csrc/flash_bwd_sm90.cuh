// The key-major flash-attention backward for Hopper (sm_90a), shared by the
// one-pass backward of the ring (flash_fused_bwd.cu, K3c: dq, dk and dv), the
// general dk/dv backward (flash_dkv_bwd.cu, K3b: dk and dv alone), the dk/dv
// half of the self-attention backward (flash_bwd.cu, K1-bwd) and the dk/dv
// half of the A/B tool's dt-layout backward (flash_dt_bwd.cu, P2). Each source
// instantiates it in its own __global__ entry point and picks the block order
// (which key tile, head and sequence a block owns); a compile-time switch
// (DQ) adds the dQ half. Tq != Tk, ragged lengths on both sides,
// right-aligned causal or non-causal.
//
// Function: for every visited (query tile, key tile) pair once, with S = q k^T
// / sqrt(hs) under the mask (query i at key position i + Tk - Tq) and P =
// exp(S - lse),
//   dV += P^T dO,  dP = dO V^T,  dS = P * (dP - dcap),
//   dK += dS^T Q / sqrt(hs)  [and with DQ: dQ += dS K / sqrt(hs)].
// dcap is an input, (B, H, Tq) fp32: D = rowsum(dO * O) for plain attention,
// D - dlse when the logsumexp carries a cotangent too. P and dS are rounded to
// bf16 before their products, as on the TPU. The scale is applied here, once
// to dk at its store (and to dq at its cast), because the forward applies it
// inside its kernel.
//
// The design (hopper.cuh holds the building blocks): one block owns a (b, h,
// 128-key tile) and loops over the 64-row query tiles from the first one that
// sees it, max(0, (n0 - q_off) / 64). A block is three warpgroups. The
// producer loads K and V of the tile once and streams Q and dO tiles by TMA
// (4-D tensor maps over the strided views, 128-byte swizzle, rows past the
// lengths zero-filled) through a ring of STAGES slots; its 32 lanes copy the
// tile's lse (times log2 e) and dcap rows beside them (a (B, H, Tq) row has no
// 16-byte alignment for a bulk copy). Each of the two consumers owns 64 keys
// and keeps dK and dV in fp32 wgmma accumulators. Per pair it forms S^T =
// K Q^T and dP^T = V dO^T (wgmma m64n64k16, both operands from shared
// memory), then P^T and dS^T in registers, which are the register A operands
// of dV += P^T dO and dK += dS^T Q (dO and Q read MN-major through the
// transpose bit). The position mask costs compares only on pairs that cross
// the diagonal or a length; P is 0 there by a select, never by exp of a
// padded lse, so no inf * 0 reaches dk/dv. The register A fragments are kept
// live until the wait that completes their products. dk and dv are summed in
// a fixed order: they are deterministic.
//
// With DQ, each consumer also writes its dS^T once to a swizzled shared tile
// (double-buffered); after a barrier of the two, consumer c forms
// hs columns 32c .. 32c + 31 of dS K over all 128 keys (dS read MN-major from
// that tile, K MN-major) and adds it with 16-byte reductions
// (red.global.add.v4.f32) straight from registers into a zeroed fp32 (B, Tq,
// H, hs) buffer, which a second kernel of the caller casts to bf16. Blocks of
// different key tiles add into the same rows in no fixed order, so dq can
// differ in the last fp32 bits from run to run. Without DQ the two consumers
// share nothing but the ring.
//
// The dt layout (Layout::DT, P2, without DQ): q, k, v, dO, dk and dv are
// (H, 64, B*T), the sequence contiguous, lse and dcap (H, B*Tq), and the
// causal mask has no offset (query i sees keys <= i). Every tile in shared
// memory is the transpose of its bthd counterpart, [channel][position] (TMA
// boxes of 64 positions by 64 channels, map_dt; a 128-key tile is two boxes,
// box c consumer c's keys), so each shared-memory operand flips its major:
// S^T and dP^T read K_c, Q, V_c and dO MN-major (both transpose bits), dV
// and dK read dO and Q K-major; the register A operands do not change. dk
// and dv leave transposed through the consumer's K and V boxes into whole
// 128-byte rows of the sequence.
//
// Causal blocks of low key tiles have the most query tiles; the entry points
// give them the lowest block indices. All offsets are 64-bit.

#pragma once

#include <math.h>

#include "hopper.cuh"

namespace flash_bwd_sm90 {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int HS = 64;        // head size the kernels are built for
constexpr int BK = 128;       // keys per block, 64 per consumer
constexpr int BQ = 64;        // rows of a query tile
constexpr int CONSUMERS = 2;  // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr uint32_t KV_BYTES = 2 * BK * HS * 2;
constexpr uint32_t QDO_BYTES = 2 * BQ * HS * 2;
constexpr float LOG2E = 1.4426950408889634f;

template <bool DQ, int STAGES>
struct __align__(1024) Smem {
  bf16 k[BK * HS];
  bf16 v[BK * HS];
  bf16 q[STAGES][BQ * HS];
  bf16 dO[STAGES][BQ * HS];
  // dS^T, [key][query], both consumers' rows, double-buffered: the dQ half's.
  // Without DQ one tile stays unused: allocated only with DQ, after the
  // barriers, the tiles gave K3c other code, about 4% slower on an H100.
  bf16 ds[DQ ? 2 : 1][BK * BQ];
  float lse2[STAGES][BQ];
  float dcap[STAGES][BQ];
  uint64_t kv_full;
  uint64_t full[STAGES], empty[STAGES];
};

// dynamic shared memory of one block: Smem and the alignment of the base
template <bool DQ, int STAGES>
constexpr int smem_bytes() {
  return (int)sizeof(Smem<DQ, STAGES>) + 1024;
}

// dst[0..3] += a, one 16-byte reduction in global memory (dst 16-byte aligned)
__device__ __forceinline__ void red_add4(float* dst, float a0, float a1, float a2, float a3) {
  asm volatile("red.global.add.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(dst), "f"(a0), "f"(a1),
               "f"(a2), "f"(a3)
               : "memory");
}

// The work of one block: key tile kt of head h of batch b. dq_acc is read
// only with DQ. L picks the operand layout; the dt layout (L = DT, no dQ
// half) takes the batch count from gridDim.z.
template <bool DQ, int STAGES, Layout L = Layout::BTHD>
__device__ __forceinline__ void backward_block(const CUtensorMap* mq, const CUtensorMap* mk,
                                               const CUtensorMap* mv, const CUtensorMap* mdo,
                                               const float* __restrict__ lse,
                                               const float* __restrict__ dcap,
                                               float* __restrict__ dq_acc,
                                               bf16* __restrict__ dk, bf16* __restrict__ dv,
                                               int Tq, int Tk, int H, int causal, float scale,
                                               float scale_log2, int kt, int h, int b,
                                               unsigned char* smem_raw) {
  constexpr bool DT = L == Layout::DT;
  static_assert(!(DT && DQ), "the dt layout has no dQ half");
  Smem<DQ, STAGES>& sm = *reinterpret_cast<Smem<DQ, STAGES>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));

  const int tid = threadIdx.x, wg = tid / 128;
  const int n0 = kt * BK;
  const int q_off = DT ? 0 : Tk - Tq;  // query i sits at key position i + q_off
  const int nq = (Tq + BQ - 1) / BQ;
  // the first query tile with a row at or after this key tile's first key
  const int i0 = causal ? max(0, (n0 - q_off) / BQ) : 0;

  if (tid == 0) {
    mbar_init(&sm.kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 32);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: the first warp keeps the ring full
    setmaxnreg_dec<24>();
    if (tid < CONSUMERS * 128 + 32) {
      const int lane = tid % 32;
      // a query's stats: (B, H, Tq) rows, or (H, B*Tq) in the dt layout
      const long long srow = DT ? ((long long)h * gridDim.z + b) * Tq : ((long long)b * H + h) * Tq;
      const float* lseb = lse + srow;
      const float* dcapb = dcap + srow;
      if (lane == 0) {
        tma_prefetch_map(mq);
        tma_prefetch_map(mdo);
        mbar_expect_tx(&sm.kv_full, KV_BYTES);
        if constexpr (DT) {
          // two boxes of 64 keys, [channel][key]: box c is consumer c's
          tma_load_4d(sm.k, mk, &sm.kv_full, n0, b, 0, h);
          tma_load_4d(sm.k + 64 * HS, mk, &sm.kv_full, n0 + 64, b, 0, h);
          tma_load_4d(sm.v, mv, &sm.kv_full, n0, b, 0, h);
          tma_load_4d(sm.v + 64 * HS, mv, &sm.kv_full, n0 + 64, b, 0, h);
        } else {
          tma_load_4d(sm.k, mk, &sm.kv_full, 0, h, n0, b);
          tma_load_4d(sm.v, mv, &sm.kv_full, 0, h, n0, b);
        }
      }
      for (int i = i0; i < nq; ++i) {
        const int it = i - i0, s = it % STAGES, ph = (it / STAGES) & 1;
        const int m0 = i * BQ;
        mbar_wait(&sm.empty[s], ph ^ 1);
        // rows >= Tq read as zero: their P is zeroed by position, not through these
        for (int j = lane; j < BQ; j += 32) {
          const int t = m0 + j;
          sm.lse2[s][j] = t < Tq ? lseb[t] * LOG2E : 0.f;
          sm.dcap[s][j] = t < Tq ? dcapb[t] : 0.f;
        }
        if (lane == 0) {
          mbar_expect_tx(&sm.full[s], QDO_BYTES);
          if constexpr (DT) {
            tma_load_4d(sm.q[s], mq, &sm.full[s], m0, b, 0, h);
            tma_load_4d(sm.dO[s], mdo, &sm.full[s], m0, b, 0, h);
          } else {
            tma_load_4d(sm.q[s], mq, &sm.full[s], 0, h, m0, b);
            tma_load_4d(sm.dO[s], mdo, &sm.full[s], 0, h, m0, b);
          }
        } else {
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int kw0 = n0 + wg * 64;                   // this consumer's first key
    const int krow0 = kw0 + warp * 16 + lane / 4;   // its rows: krow0 and krow0 + 8
    const int col_l = 2 * (lane % 4);               // first column in an n8 block
    const uint64_t dkw = desc_sw128(sm.k + wg * 64 * HS);
    const uint64_t dvw = desc_sw128(sm.v + wg * 64 * HS);
    const uint64_t dkn = desc_add(desc_sw128(sm.k), 64 * wg);  // K, hs columns 32 wg .. (DQ)
    float* dqb = dq_acc + (long long)b * Tq * H * HS + h * HS + 32 * wg;  // (DQ)

    float dka[32], dva[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) dka[i] = dva[i] = 0.f;

    mbar_wait(&sm.kv_full, 0);
    for (int i = i0; i < nq; ++i) {
      const int it = i - i0, s = it % STAGES, ph = (it / STAGES) & 1;
      const int m0 = i * BQ;
      const uint64_t dqs = desc_sw128(sm.q[s]), dos = desc_sw128(sm.dO[s]);
      float st[32], dpt[32];
      mbar_wait(&sm.full[s], ph);
      reg_fence(st);
      reg_fence(dpt);
      wg_fence();
      // S^T (64 keys x 64 queries) = K_c Q^T, dP^T = V_c dO^T; in the dt
      // layout all four tiles are read MN-major (the channels are the rows)
      if constexpr (DT) {
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk)
          mma_m64n64_ss_tt(st, desc_add(dkw, 2048 * kk), desc_add(dqs, 2048 * kk), kk);
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk)
          mma_m64n64_ss_tt(dpt, desc_add(dvw, 2048 * kk), desc_add(dos, 2048 * kk), kk);
      } else {
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk)
          mma_m64n64_ss(st, desc_add(dkw, 32 * kk), desc_add(dqs, 32 * kk), kk);
#pragma unroll
        for (int kk = 0; kk < HS / 16; ++kk)
          mma_m64n64_ss(dpt, desc_add(dvw, 32 * kk), desc_add(dos, 32 * kk), kk);
      }
      wg_commit();
      wg_wait<0>();
      reg_fence(st);
      reg_fence(dpt);

      // P^T = exp(S^T * scale - lse), masked by position; dS^T = P^T (dP^T - dcap)
      const bool masked = m0 + BQ > Tq || kw0 + 64 > Tk || (causal && kw0 + 63 > m0 + q_off);
      const float* lse2 = sm.lse2[s];
      const float* dcs = sm.dcap[s];
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int qi = 8 * (e / 4) + col_l + (e & 1);
        float p = ex2(fmaf(st[e], scale_log2, -lse2[qi]));
        if (masked) {
          const int kpos = krow0 + 8 * ((e >> 1) & 1), qrow = m0 + qi;
          p = (qrow < Tq && kpos < Tk && (!causal || kpos <= qrow + q_off)) ? p : 0.f;
        }
        st[e] = p;
        dpt[e] = p * (dpt[e] - dcs[qi]);
      }
      uint32_t pa[BQ / 16][4], sa[BQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          pa[kk][e] = pack_bf16(st[8 * kk + 2 * e], st[8 * kk + 2 * e + 1]);
          sa[kk][e] = pack_bf16(dpt[8 * kk + 2 * e], dpt[8 * kk + 2 * e + 1]);
        }

      // dV += P^T dO, dK += dS^T Q; in the dt layout dO and Q are read
      // K-major (the queries are the contiguous axis), 32 bytes a k16 step
      reg_fence(dva);
      reg_fence(dka);
      wg_fence();
      if constexpr (DT) {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) mma_m64n64_rs(dva, pa[kk], desc_add(dos, 32 * kk), 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk) mma_m64n64_rs(dka, sa[kk], desc_add(dqs, 32 * kk), 1);
      } else {
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          mma_m64n64_rs_tb(dva, pa[kk], desc_add(dos, 2048 * kk), 1);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
          mma_m64n64_rs_tb(dka, sa[kk], desc_add(dqs, 2048 * kk), 1);
      }
      wg_commit();

      if constexpr (!DQ) {
        wg_wait<0>();
        reg_fence(dva);
        reg_fence(dka);
        reg_fence(pa);
        reg_fence(sa);
        if (t == 0) mbar_arrive(&sm.empty[s]);
      } else {
        // dS^T of this consumer's 64 keys into its rows of the shared tile
        bf16* ds = sm.ds[it & 1];
        unsigned char* dsb = reinterpret_cast<unsigned char*>(ds);
#pragma unroll
        for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = wg * 64 + warp * 16 + lane / 4 + 8 * (e & 1);
            const int chunk = 2 * kk + (e >> 1);
            *reinterpret_cast<uint32_t*>(dsb + row * 128 + ((chunk ^ (row % 8)) * 16) + col_l * 2) =
                sa[kk][e];
          }
        fence_proxy_async();
        named_sync(1, CONSUMERS * 128);  // both consumers' dS^T rows are written

        // dQ (64 queries x hs columns 32 wg ..) = dS K over all 128 keys
        float dqa[16];
        reg_fence(dqa);
        wg_fence();
        const uint64_t dds = desc_sw128(ds);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma_m64n32_ss_tt(dqa, desc_add(dds, 2048 * kk), desc_add(dkn, 2048 * kk), kk);
        wg_commit();
        wg_wait<0>();
        reg_fence(dqa);
        reg_fence(dva);
        reg_fence(dka);
        reg_fence(pa);
        reg_fence(sa);
        if (t == 0) mbar_arrive(&sm.empty[s]);

        // quad neighbours swap halves so each thread holds four consecutive
        // columns of one row: even lanes row r, odd lanes row r + 8
        const bool even = (lane & 1) == 0;
        const int qrow = m0 + warp * 16 + lane / 4 + (even ? 0 : 8);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float s0 = even ? dqa[4 * j + 2] : dqa[4 * j];
          const float s1 = even ? dqa[4 * j + 3] : dqa[4 * j + 1];
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          if (qrow < Tq) {
            const int col = 8 * j + (even ? col_l : col_l - 2);
            float* dst = dqb + (long long)qrow * H * HS + col;
            if (even)
              red_add4(dst, dqa[4 * j], dqa[4 * j + 1], r0, r1);
            else
              red_add4(dst, r0, r1, dqa[4 * j + 2], dqa[4 * j + 3]);
          }
        }
      }
    }

    // a key tile past every query's reach (non-causal never; causal only when
    // i0 >= nq) stores the zeros it was filled with
    if constexpr (DT) {
      // dk^T and dv^T through this consumer's K and V boxes ([channel][key],
      // sw128; only it reads them, and its products are done), then 16-byte
      // stores of whole rows of its 64 keys; the box lies wholly below Tk
      // or wholly past it (Tk is a multiple of 64)
      unsigned char* kb = reinterpret_cast<unsigned char*>(sm.k + wg * 64 * HS);
      unsigned char* vb = reinterpret_cast<unsigned char*>(sm.v + wg * 64 * HS);
#pragma unroll
      for (int j = 0; j < HS / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int d = 8 * j + col_l + (e & 1), row = warp * 16 + lane / 4 + 8 * (e >> 1);
          const int at = d * 128 + (((row / 8) ^ (d % 8)) * 16) + (row % 8) * 2;
          *reinterpret_cast<bf16*>(kb + at) = __float2bfloat16(dka[4 * j + e] * scale);
          *reinterpret_cast<bf16*>(vb + at) = __float2bfloat16(dva[4 * j + e]);
        }
      named_sync(1 + wg, 128);
      if (kw0 < Tk) {
        const long long n_all_k = (long long)gridDim.z * Tk;  // B * Tk
        const long long out = (long long)h * HS * n_all_k + (long long)b * Tk + kw0;
        for (int c = t; c < HS * 8; c += 128) {
          const int d = c / 8, chunk = c % 8;
          const int at = d * 128 + ((chunk ^ (d % 8)) * 16);
          *reinterpret_cast<uint4*>(dk + out + d * n_all_k + chunk * 8) =
              *reinterpret_cast<const uint4*>(kb + at);
          *reinterpret_cast<uint4*>(dv + out + d * n_all_k + chunk * 8) =
              *reinterpret_cast<const uint4*>(vb + at);
        }
      }
      return;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int kpos = krow0 + 8 * r;
      if (kpos >= Tk) continue;
      const long long out = (((long long)b * Tk + kpos) * H + h) * HS;
#pragma unroll
      for (int j = 0; j < HS / 8; ++j) {
        const int col = 8 * j + col_l;
        *reinterpret_cast<uint32_t*>(dk + out + col) =
            pack_bf16(dka[4 * j + 2 * r] * scale, dka[4 * j + 2 * r + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + out + col) =
            pack_bf16(dva[4 * j + 2 * r], dva[4 * j + 2 * r + 1]);
      }
    }
  }
}

// The kernel signature both entry points share.
using Kernel = void (*)(const CUtensorMap, const CUtensorMap, const CUtensorMap,
                        const CUtensorMap, const float*, const float*, float*, bf16*, bf16*, int,
                        int, int, int, float, float);

// Checks the arguments, encodes the tensor maps and launches `kernel` (an
// instantiation of backward_block with the same DQ and STAGES, key tile
// blockIdx.x of head blockIdx.y of batch blockIdx.z) on `stream`.
// q: (B, Tq, H, hs), k/v: (B, Tk, H, hs), bf16 with unit stride on hs; strides
// in elements, each a multiple of 8, base pointers 16-byte aligned (TMA needs
// the same). dO: contiguous (B, Tq, H, hs) bf16; dk, dv: contiguous (B, Tk, H,
// hs) bf16. lse, dcap: contiguous (B, H, Tq) fp32. dq_acc: with DQ a zeroed
// contiguous (B, Tq, H, hs) fp32 buffer, else unused. All checked by the
// Python wrapper. Returns the CUDA error code of the launch.
template <bool DQ, int STAGES>
inline int launch(Kernel kernel, const void* q, const void* k, const void* v, const void* dO,
                  const void* lse, const void* dcap, void* dq_acc, void* dk, void* dv, int B,
                  int Tq, int Tk, int H, int hs, long long qsb, long long qst, long long qsh,
                  long long ksb, long long kst, long long ksh, long long vsb, long long vst,
                  long long vsh, int causal, cudaStream_t stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || (causal && Tq > Tk) || B > 65535 ||
      H > 65535)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv, mdo;
  const long long ost = (long long)H * HS;  // row stride of dO
  if (!hopper_host::map_bthd(&mq, q, B, Tq, H, qsb, qst, qsh, BQ) ||
      !hopper_host::map_bthd(&mk, k, B, Tk, H, ksb, kst, ksh, BK) ||
      !hopper_host::map_bthd(&mv, v, B, Tk, H, vsb, vst, vsh, BK) ||
      !hopper_host::map_bthd(&mdo, dO, B, Tq, H, Tq * ost, ost, HS, BQ))
    return (int)cudaErrorInvalidValue;
  const int smem = smem_bytes<DQ, STAGES>();
  const cudaError_t err = hopper_host::set_smem_once(kernel, smem);
  if (err != cudaSuccess) return (int)err;
  const float scale = 1.f / sqrtf((float)HS);
  const dim3 grid((Tk + BK - 1) / BK, H, B);
  kernel<<<grid, THREADS, smem, stream>>>(mq, mk, mv, mdo, (const float*)lse,
                                          (const float*)dcap, (float*)dq_acc, (bf16*)dk,
                                          (bf16*)dv, Tq, Tk, H, causal, scale, scale * LOG2E);
  return (int)cudaGetLastError();
}

}  // namespace flash_bwd_sm90
