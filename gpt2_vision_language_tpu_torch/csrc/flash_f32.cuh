// Building blocks of the attention kernels on fp32 operands: every product
// an fp32 FFMA on the CUDA cores, from register tiles that a thread sums as
// outer products, fed from shared memory by 16-byte reads. The blocks at the
// end of this file (the forward block, the dk/dv block and the dq block, and
// the one-pass block) are written once and instanced by the compile-time
// Case:
//   - SELF by the self-attention kernels (flash_fwd_f32.cu: the forward
//     block; flash_bwd_f32.cu: the dk/dv and dq blocks, their only user; Tq
//     == Tk = T): the general case at Tq == Tk with the offset a compile-time
//     0, keeping the self kernels' arithmetic and none of the general case's
//     index work;
//   - GENERAL by the general ones (flash_general_fwd_f32.cu and
//     flash_lse_fwd_f32.cu: the forward block, the second over parts of the
//     key range; flash_general_bwd_f32.cu: the one-pass block; a query length
//     Tq and a key length Tk, causal masks right-aligned);
//   - DT by the A/B tool's dt-layout kernels (flash_dt_fwd_f32.cu: the
//     forward block over parts of the key range; flash_dt_bwd_f32.cu: the
//     one-pass block): q, k, v, o and
//     the gradients (H, hs, B*T), the sequence contiguous, Tq and Tk
//     multiples of 64 and either the larger, a causal mask without offset
//     (query i sees the keys j <= i), q pre-scaled by 1 / sqrt(hs), lse and
//     the row term (H, B*Tq), dq scaled by a runtime dq_scale. Only the
//     loads, the stores and the index work differ: the products, the tiles
//     and the sweeps are the other cases'.
//
// Tiles in shared memory, hs = 64:
//   - a swept tile (the K and V tiles that a forward or dq block sweeps, the
//     q and dO tiles that a dk/dv block sweeps): 64 positions x 64 channels,
//     [position][channel], rows padded to LDT = 68 floats, copied from global
//     memory with cp.async (rows at or past the length of the swept tensor
//     -- Tk for K/V, Tq for q/dO -- zero-filled) into one of two slots while
//     the other slot is being computed on. From the (B, T, H, hs) tensors of
//     SELF and GENERAL a copy is 16 bytes, four channels of one position;
//     from the dt layout it is 4 bytes, one element put in its transposed
//     place, since a 16-byte run there holds four positions of one channel;
//   - a resident tile (q^T and dO^T of a forward or dq block, K^T and V^T of
//     a dk/dv block): d-major, [channel][position], transposed once when the
//     block starts; in the dt layout it arrives d-major and is a straight
//     copy;
//   - per-warp staging of P^T or dS^T ([key][row], rows of the warp's 32 or
//     16 query rows padded by 4 floats) or of P and dS ([row][key], padded to
//     LDT), written from registers and read back by the same warp
//     (__syncwarp only).
// A 16-byte read or write of a warp is served a quarter-warp (8 lanes) at a
// time. The padding puts the 8 rows that a quarter-warp reads or writes at
// one offset on eight distinct 16-byte bank groups, so none conflicts. A
// read whose quarter-warps each ask for at most two addresses costs about
// half the SM cycles of one whose quarter-warps ask for four or eight
// (tools/ffma_probe.py). A thread tile of R x C reads, per channel or key,
// R / 4 float4 of one operand and C / 4 of the other; the lanes of a quarter
// share one of the two, so one of them is always the costly kind, and only a
// larger tile (more FFMAs per read) lowers the shared-memory cycles per FFMA.
//
// The thread tiles, outer products summed in registers:
//   - rows_by_keys (forward, dq): S = X Y^T for a thread's 8 rows and NC
//     keys (8 in the forward, 4 in the dq block) from a resident X^T and a
//     swept Y: per 4 channels, NC float4 of Y rows and 8 float4 of X^T for
//     32 NC FFMAs;
//   - acc_keys (forward, dq): O += P Y for the same 8 rows and NE channels
//     (8 or 4): per key, 2 float4 of P^T and NE / 4 of Y for 8 NE FFMAs;
//   - keys_by_rows (dk/dv block): S = X Y^T for 4 rows x 8 keys from the
//     swept X and the resident Y^T;
//   - acc_rows (dk/dv block): dV += P^T dO for 4 keys x 8 channels: per row,
//     1 float4 of P and 2 of dO for 32 FFMAs (the dO reads by two addresses
//     a quarter-warp, the P read by four).
// Every sum runs in a fixed order, so the kernels are bit-equal run to run.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace f32 {

constexpr int HS = 64;           // head size
constexpr int TILE = 64;         // positions of a swept tile
constexpr int LDT = HS + 4;      // row stride of a swept tile and of P / dS, in floats
constexpr int QK = 16;           // keys of a warp's P^T / dS^T quarter
constexpr float NEG_BIG = -1e30f;  // finite start of the running max

// the three instances of the blocks (see the top of this file)
enum class Case { SELF, GENERAL, DT };

typedef float Tile[TILE][LDT];
// a warp's P^T or dS^T quarter, [key][row] for the warp's R rows, padded
template <int R>
using Quarter = float[QK][R + 4];

__device__ __forceinline__ float comp(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// ---- cp.async ----------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory, asynchronously; bytes == 0 writes zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4 bytes (an lse or D value: rows of (B, H, T) are not 16-byte aligned for
// every T); bytes == 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread has started has landed in shared memory
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// every copy this thread has started has landed but those of its last
// committed group
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---- loads -------------------------------------------------------------------

// rows row0 .. row0 + 63 of one (sequence, head) (base: its row 0, st: the
// position stride) into a swept tile, asynchronously; rows at or past T are
// zeros (a masked key's V must not carry NaN)
template <int NT>
__device__ __forceinline__ void load_tile_async(Tile& dst, const float* __restrict__ base,
                                                long long st, int row0, int T, int tid) {
#pragma unroll
  for (int i = 0; i < TILE * (HS / 4) / NT; ++i) {
    const int f = tid + i * NT, r = f >> 4, c = f & 15, t = row0 + r;
    const float* src = base + (long long)(t < T ? t : 0) * st + 4 * c;
    cp_async16(&dst[r][4 * c], src, t < T ? 16 : 0);
  }
}

// ROWS rows from row0 into a resident d-major tile dst[d * ROWS + row], times
// scale (1 / sqrt(hs) = 0.125 or 1: exact), zeros past T; synchronous, once a
// block. Lanes take consecutive rows, so each store writes 32 consecutive
// floats.
template <int NT, int ROWS>
__device__ __forceinline__ void load_transposed(float* __restrict__ dst,
                                                const float* __restrict__ base, long long st,
                                                int row0, int T, float scale, int tid) {
#pragma unroll 4
  for (int i = 0; i < ROWS * (HS / 4) / NT; ++i) {
    const int f = tid + i * NT, r = f % ROWS, c = f / ROWS, t = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) v = __ldg(reinterpret_cast<const float4*>(base + (long long)t * st) + c);
    dst[(4 * c + 0) * ROWS + r] = v.x * scale;
    dst[(4 * c + 1) * ROWS + r] = v.y * scale;
    dst[(4 * c + 2) * ROWS + r] = v.z * scale;
    dst[(4 * c + 3) * ROWS + r] = v.w * scale;
  }
}

// rows row0 .. row0 + 63 of one (sequence, head) slab of a dt-layout tensor
// (base: its position 0 of channel 0, cs: the channel stride; positions
// contiguous) into a swept tile [position][channel], asynchronously, one
// element a copy: each element goes to its transposed place, which no
// 16-byte copy can do. The slab's length T is a multiple of 64, so the tile
// lies wholly before T or wholly past it (then zeros). NT = 128 threads: copy
// i of a thread takes position 8 (i % 8) + lane % 8 and channel 4 warp +
// 16 (i / 8) + (lane / 8) % 4, so a warp reads 32 contiguous bytes of each of
// four channels and writes 32 distinct banks (rows padded to LDT = 68).
template <int NT>
__device__ __forceinline__ void load_tile_dt_async(Tile& dst, const float* __restrict__ base,
                                                   long long cs, int row0, int T, int tid) {
  static_assert(NT == 128, "the copy pattern is laid out for four warps");
  const int lr = tid & 7, lc = (tid >> 3) & 3, c0 = 4 * (tid >> 5) + lc;
  const int bytes = row0 < T ? 4 : 0;
  const float* src = base + (long long)c0 * cs + (row0 < T ? row0 : 0) + lr;
#pragma unroll
  for (int i = 0; i < TILE * HS / NT; ++i) {
    const int r = 8 * (i & 7) + lr, c = c0 + 16 * (i >> 3);
    cp_async4(&dst[r][c], src + (long long)(16 * (i >> 3)) * cs + 8 * (i & 7), bytes);
  }
}

// ROWS positions from row0 of a dt-layout slab (base, cs as above) into a
// resident d-major tile dst[d * ROWS + row]: the layout is the tile's, so a
// straight copy, 16 bytes (four positions) a load; zeros past T (T % 4 == 0);
// synchronous, once a block. q arrives pre-scaled, so nothing is scaled.
template <int NT, int ROWS>
__device__ __forceinline__ void load_resident_dt(float* __restrict__ dst,
                                                 const float* __restrict__ base, long long cs,
                                                 int row0, int T, int tid) {
#pragma unroll 4
  for (int i = 0; i < ROWS * (HS / 4) / NT; ++i) {
    const int f = tid + i * NT, r = 4 * (f % (ROWS / 4)), c = f / (ROWS / 4), t = row0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) v = __ldg(reinterpret_cast<const float4*>(base + (long long)c * cs + t));
    *reinterpret_cast<float4*>(dst + c * ROWS + r) = v;
  }
}

// ---- products of the query-major blocks (forward, dq) --------------------------

// acc[i][j] += sum_d xt[d * LD + i] * y[k0 + KS j][d] for the thread's 8 rows
// (xt points at them in a resident d-major tile of row stride LD) and NC keys
// of the swept tile y. The sum over d runs 0 .. 63 in order.
template <int LD, int NC, int KS>
__device__ __forceinline__ void rows_by_keys(float (&acc)[8][NC], const float* xt, const Tile& y,
                                             int k0) {
#pragma unroll 2
  for (int d4 = 0; d4 < HS / 4; ++d4) {
    float4 yf[NC];
#pragma unroll
    for (int j = 0; j < NC; ++j)
      yf[j] = *reinterpret_cast<const float4*>(&y[k0 + KS * j][4 * d4]);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(xt + (4 * d4 + dd) * LD);
      const float4 b = *reinterpret_cast<const float4*>(xt + (4 * d4 + dd) * LD + 4);
      const float xr[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < NC; ++j) acc[i][j] = fmaf(xr[i], comp(yf[j], dd), acc[i][j]);
    }
  }
}

// column j of the thread's 8 x NC tile into a warp's quarter as P^T (or
// dS^T): pt[kl][r0 .. r0 + 7], kl the column's key within the quarter
template <int LDQ, int NC>
__device__ __forceinline__ void store_quarter_t(float (*pt)[LDQ], const float (&v)[8][NC], int j,
                                                int kl, int r0) {
  *reinterpret_cast<float4*>(&pt[kl][r0]) = make_float4(v[0][j], v[1][j], v[2][j], v[3][j]);
  *reinterpret_cast<float4*>(&pt[kl][r0 + 4]) = make_float4(v[4][j], v[5][j], v[6][j], v[7][j]);
}

// acc[i][e] += sum_{c < 16} pt[c][r0 + i] * y[key0 + c][channel e], c in
// order; the thread's channels are c0 .. c0 + 3 (e < 4) and, with NE = 8,
// 32 + c0 .. 32 + c0 + 3
template <int LDQ, int NE>
__device__ __forceinline__ void acc_keys(float (&acc)[8][NE], const float (*pt)[LDQ],
                                         const Tile& y, int key0, int r0, int c0) {
#pragma unroll 4
  for (int c = 0; c < QK; ++c) {
    const float4 a = *reinterpret_cast<const float4*>(&pt[c][r0]);
    const float4 b = *reinterpret_cast<const float4*>(&pt[c][r0 + 4]);
    const float4 w0 = *reinterpret_cast<const float4*>(&y[key0 + c][c0]);
    float yr[NE];
    yr[0] = w0.x, yr[1] = w0.y, yr[2] = w0.z, yr[3] = w0.w;
    if (NE == 8) {
      const float4 w1 = *reinterpret_cast<const float4*>(&y[key0 + c][32 + c0]);
      yr[NE - 4] = w1.x, yr[NE - 3] = w1.y, yr[NE - 2] = w1.z, yr[NE - 1] = w1.w;
    }
    const float pr[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < NE; ++e) acc[i][e] = fmaf(pr[i], yr[e], acc[i][e]);
  }
}

// ---- products of the key-major block (dk/dv) -----------------------------------

// acc[i][j] += sum_d x[rg + 16 i][d] * yt[d * TILE + j]: x is a swept tile,
// yt points at the thread's 8 keys of a resident d-major tile. The sum over d
// runs 0 .. 63 in order, as in rows_by_keys.
__device__ __forceinline__ void keys_by_rows(float (&acc)[4][8], const Tile& x, const float* yt,
                                             int rg) {
#pragma unroll 2
  for (int d4 = 0; d4 < HS / 4; ++d4) {
    float4 xf[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) xf[i] = *reinterpret_cast<const float4*>(&x[rg + 16 * i][4 * d4]);
#pragma unroll
    for (int dd = 0; dd < 4; ++dd) {
      const float4 a = *reinterpret_cast<const float4*>(yt + (4 * d4 + dd) * TILE);
      const float4 b = *reinterpret_cast<const float4*>(yt + (4 * d4 + dd) * TILE + 4);
      const float yr[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(comp(xf[i], dd), yr[j], acc[i][j]);
    }
  }
}

// acc[kk][e] += sum_{r < 16} p[r][key0 + kk] * y[row0 + r][channel e], r in
// order; the thread's channels are 4g .. 4g + 3 (e < 4) and 32 + 4g .. (e >= 4)
__device__ __forceinline__ void acc_rows(float (&acc)[4][8], const float (*p)[LDT], int key0,
                                         const Tile& y, int row0, int g) {
#pragma unroll 4
  for (int r = 0; r < 16; ++r) {
    const float4 a = *reinterpret_cast<const float4*>(&p[r][key0]);
    const float4 w0 = *reinterpret_cast<const float4*>(&y[row0 + r][4 * g]);
    const float4 w1 = *reinterpret_cast<const float4*>(&y[row0 + r][32 + 4 * g]);
    const float pr[4] = {a.x, a.y, a.z, a.w};
    const float yr[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[kk][e] = fmaf(pr[kk], yr[e], acc[kk][e]);
  }
}

template <int R, int C>
__device__ __forceinline__ void zero(float (&a)[R][C]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < C; ++j) a[i][j] = 0.f;
}


// ---- the blocks ----------------------------------------------------------------
//
// Every block is 128 threads (4 warps) and keeps two blocks an SM
// (__launch_bounds__(THREADS, MIN_BLOCKS) on each kernel): shared memory
// allows two. q, o and dO are (B, Tq, H, hs), k, v, dk, dv (B, Tk, H, hs);
// q/k/v are read through their strides (the views of the fused QKV
// projection, the ring's chunk views), o, dO, dq, dk, dv are contiguous; lse
// and the row term (D, or D - dlse) are (B, H, Tq). With Case::SELF, Tk is
// Tq and the causal offset is 0 at compile time; with Case::GENERAL a causal
// query i sees the keys j <= i + Tk - Tq (right-aligned, Tq <= Tk), the rule
// of the JAX kernels. With Case::DT every tensor is (H, hs, B*T) and
// contiguous, and the stride arguments say so: sb = T (a sequence's slab),
// st = B*T (the channel stride, where the other cases have the position
// stride), sh = hs*B*T; o and dq take q's strides, dk and dv k's; lse and the
// row term are (H, B*Tq), row (b, h) at h*st + b*sb of q's strides. Its
// causal mask has no offset (j <= i) at any Tq and Tk, so a query past Tk
// sees every key and a key past Tq is seen by no query (dk = dv = 0).

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int MIN_BLOCKS = 2;  // resident blocks an SM (shared memory allows two)

// a swept tile of case C, copied asynchronously: st is the position stride
// of a (B, T, H, hs) tensor, or the channel stride of a dt-layout one
template <Case C>
__device__ __forceinline__ void load_swept(Tile& dst, const float* __restrict__ base, long long st,
                                           int row0, int T, int tid) {
  if constexpr (C == Case::DT)
    load_tile_dt_async<THREADS>(dst, base, st, row0, T, tid);
  else
    load_tile_async<THREADS>(dst, base, st, row0, T, tid);
}

// a resident tile of case C, ROWS positions from row0 (st as in load_swept;
// the dt case scales nothing)
template <Case C, int ROWS>
__device__ __forceinline__ void load_resident(float* __restrict__ dst,
                                              const float* __restrict__ base, long long st,
                                              int row0, int T, float scale, int tid) {
  if constexpr (C == Case::DT)
    load_resident_dt<THREADS, ROWS>(dst, base, st, row0, T, tid);
  else
    load_transposed<THREADS, ROWS>(dst, base, st, row0, T, scale, tid);
}

// the forward block's query rows: 32 a warp, 128 a block
constexpr int FWD_WR = 32;
constexpr int FWD_BQ = FWD_WR * WARPS;

struct FwdSmem {
  float qt[HS][FWD_BQ];       // q^T / sqrt(hs): [channel][row]
  Tile k[2];                  // K tiles, two slots
  Tile v[2];                  // V tiles, two slots
  Quarter<FWD_WR> pt[WARPS];  // per warp: P^T of 16 keys
};

// A split forward (SPLIT: K2a's kernel, flash_lse_fwd_f32.cu, Case::GENERAL;
// P1's, flash_dt_fwd_f32.cu, Case::DT) cuts each query tile's visible key
// tiles into parts of at most `chunk` tiles, `parts` work items a query tile
// (those past its visible tiles empty), so that a grid too small for the
// card fills whole waves of its resident slots. Item i of a one-dimensional
// grid is part i / BH % parts of query tile ntq - 1 - i / BH / parts of
// (b, h) = i % BH: the longest query tiles first (under either causal mask a
// later query tile sees at least the key tiles of an earlier one), (b, h)
// fastest. A query tile of one part writes its o and lse; the others leave
// their unnormalised o, running max and running sum in the workspace at item
// i, and a second kernel merges them in part order.
struct FwdSplit {
  int BH, parts, chunk;
  float* ws_o;   // (items, FWD_BQ, HS), DT (items, HS, FWD_BQ) as o is laid out: a
                 // part's o before the division by its row sum
  float* ws_ml;  // (items, 2, FWD_BQ): a part's running max, then its row sum
};

// The key tiles that query tile qt (of FWD_BQ rows) sees: from 0 to the last
// one its last row sees. The split forward's merge counts its parts from it.
template <Case C>
__device__ __forceinline__ int visible_key_tiles(int qt, int Tq, int Tk, int causal) {
  const int off = C == Case::GENERAL ? Tk - Tq : 0;
  const int q_end = min(qt * FWD_BQ + FWD_BQ, Tq);
  // causal: Tq <= Tk, so the last row's last key q_end - 1 + off < Tk; in the
  // dt case a row past Tk sees every key, and the sweep stops at Tk
  return C == Case::DT ? (causal ? min((q_end - 1) / TILE + 1, (Tk + TILE - 1) / TILE)
                                 : (Tk + TILE - 1) / TILE)
         : causal      ? (q_end - 1 + off) / TILE + 1
                       : (Tk + TILE - 1) / TILE;
}

// Query tile qt of (hh, b) in blockIdx order: the tile with the longest
// causal sweep (the last) first. Keys in tiles of 64 from 0 to the last one
// the block's last row sees (SPLIT: those of one part); o = softmax(q k^T /
// sqrt(hs)) v and the natural-log logsumexp of each row. A warp skips a tile
// that none of its rows sees; a tile that the diagonal or the end of the
// keys crosses is masked element by element.
template <Case C, bool SPLIT = false>
__device__ __forceinline__ void forward_block(const float* __restrict__ q,
                                              const float* __restrict__ k,
                                              const float* __restrict__ v, float* __restrict__ o,
                                              float* __restrict__ lse, int Tq, int Tk_, int H,
                                              long long qsb, long long qst, long long qsh,
                                              long long ksb, long long kst, long long ksh,
                                              long long vsb, long long vst, long long vsh,
                                              int causal, const FwdSplit& sp = FwdSplit{}) {
  static_assert(!SPLIT || C != Case::SELF, "the split forward is the general and dt cases'");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem_raw);
  const int Tk = C == Case::SELF ? Tq : Tk_;
  const int off = C == Case::GENERAL ? Tk - Tq : 0;  // a causal row i sees keys <= i + off
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int rg = lane >> 3, kg = lane & 7;  // rows FWD_WR warp + 8 rg + i; keys kg + 8 j; channels 4 kg
  int qt, hh, b, part = 0;
  if constexpr (SPLIT) {
    const int bh = blockIdx.x % sp.BH, j = blockIdx.x / sp.BH;
    qt = (Tq + FWD_BQ - 1) / FWD_BQ - 1 - j / sp.parts;
    part = j % sp.parts;
    hh = bh % H;
    b = bh / H;
  } else {
    qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
    hh = blockIdx.y;
    b = blockIdx.z;
  }
  const int q0 = qt * FWD_BQ;
  const float* kb = k + (long long)b * ksb + (long long)hh * ksh;
  const float* vb = v + (long long)b * vsb + (long long)hh * vsh;
  const int n_kv = visible_key_tiles<C>(qt, Tq, Tk, causal);
  int j0 = 0, j1 = n_kv;  // the key tiles of this block's sweep
  if constexpr (SPLIT) {
    j0 = part * sp.chunk;
    j1 = min(n_kv, j0 + sp.chunk);
    if (j0 >= j1) return;  // an empty part: the query tile has fewer
  }

  load_swept<C>(s.k[j0 & 1], kb, kst, j0 * TILE, Tk, tid);
  load_swept<C>(s.v[j0 & 1], vb, vst, j0 * TILE, Tk, tid);
  cp_async_commit();
  // q^T / sqrt(hs); in the dt case q arrives pre-scaled
  load_resident<C, FWD_BQ>(&s.qt[0][0], q + (long long)b * qsb + (long long)hh * qsh, qst, q0, Tq,
                           C == Case::DT ? 1.f : 0.125f, tid);

  const int wrow = q0 + FWD_WR * warp;  // the warp's first row
  const int r0 = FWD_WR * warp + 8 * rg;  // the thread's first row in the block
  float m[8], l[8], acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
  }
  zero(acc);

  for (int j = j0; j < j1; ++j) {
    const int slot = j & 1, k0 = j * TILE;
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's slot
    if (j + 1 < j1) {
      load_swept<C>(s.k[slot ^ 1], kb, kst, k0 + TILE, Tk, tid);
      load_swept<C>(s.v[slot ^ 1], vb, vst, k0 + TILE, Tk, tid);
    }
    cp_async_commit();
    // the warp's rows are all past Tq, or all before this tile's first key
    if (wrow >= Tq || (causal && wrow + FWD_WR - 1 + off < k0)) continue;

    // S = (q / sqrt(hs)) k^T for rows r0 + i, keys k0 + kg + 8 c
    float sc[8][8];
    zero(sc);
    rows_by_keys<FWD_BQ, 8, 8>(sc, &s.qt[0][r0], s.k[slot], kg);
    if ((causal && k0 + TILE - 1 > wrow + off) || k0 + TILE > Tk) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const int kk = k0 + kg + 8 * c;
          if (kk >= Tk || (causal && kk > q0 + r0 + i + off)) sc[i][c] = -INFINITY;
        }
    }

    // online softmax; the row max over the 8 lanes of a quarter-warp
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float mx = NEG_BIG;
#pragma unroll
      for (int c = 0; c < 8; ++c) mx = fmaxf(mx, sc[i][c]);
#pragma unroll
      for (int sh = 4; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        sc[i][c] = expf(sc[i][c] - m_new);
        sum += sc[i][c];
      }
      l[i] = l[i] * corr + sum;  // this thread's share of the row sum
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= corr;
    }

    // O += P V, a quarter (16 keys: columns 2c and 2c + 1) at a time through
    // the warp's P^T
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      store_quarter_t(s.pt[warp], sc, 2 * c, kg, 8 * rg);
      store_quarter_t(s.pt[warp], sc, 2 * c + 1, kg + 8, 8 * rg);
      __syncwarp();
      acc_keys(acc, s.pt[warp], s.v[slot], QK * c, 8 * rg, 4 * kg);
      __syncwarp();
    }
  }
  cp_async_wait_all();

  if constexpr (C == Case::DT) {
    // the row sums over the 8 lanes of a row; o = acc / l, by channel: the
    // thread's 8 rows are 8 consecutive positions, all before Tq or all
    // past it (Tq % 64 == 0), two 16-byte stores a channel; lse = m + log l
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int sh = 4; sh > 0; sh >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], sh);
    const int qq = q0 + r0;
    bool several = false;  // one of several parts (SPLIT)
    if constexpr (SPLIT) several = (n_kv + sp.chunk - 1) / sp.chunk > 1;
    if (qq < Tq && several) {
      // acc, m and l into the workspace at this item, by channel as o is
      // stored: [channel][row], then [m | l][row], 16-byte runs of positions
      float* wo = sp.ws_o + (long long)blockIdx.x * HS * FWD_BQ + r0;
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        float* dst = wo + (4 * kg + (e < 4 ? e : 28 + e)) * FWD_BQ;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[4][e], acc[5][e], acc[6][e], acc[7][e]);
      }
      if (kg == 0) {
        float* wml = sp.ws_ml + (long long)blockIdx.x * 2 * FWD_BQ + r0;
        *reinterpret_cast<float4*>(wml) = make_float4(m[0], m[1], m[2], m[3]);
        *reinterpret_cast<float4*>(wml + 4) = make_float4(m[4], m[5], m[6], m[7]);
        *reinterpret_cast<float4*>(wml + FWD_BQ) = make_float4(l[0], l[1], l[2], l[3]);
        *reinterpret_cast<float4*>(wml + FWD_BQ + 4) = make_float4(l[4], l[5], l[6], l[7]);
      }
    } else if (qq < Tq) {
      float* ob = o + (long long)b * qsb + (long long)hh * qsh + qq;
#pragma unroll
      for (int e = 0; e < 8; ++e) {  // channel 4 kg + e, and 32 + 4 kg + e - 4
        float* dst = ob + (long long)(4 * kg + (e < 4 ? e : 28 + e)) * qst;
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[0][e] / l[0], acc[1][e] / l[1], acc[2][e] / l[2], acc[3][e] / l[3]);
        *reinterpret_cast<float4*>(dst + 4) =
            make_float4(acc[4][e] / l[4], acc[5][e] / l[5], acc[6][e] / l[6], acc[7][e] / l[7]);
      }
      if (kg == 0) {
        float* lb = lse + (long long)hh * qst + (long long)b * qsb + qq;
#pragma unroll
        for (int i = 0; i < 8; ++i) lb[i] = m[i] + logf(l[i]);
      }
    }
  } else {
    if constexpr (SPLIT) {
      if ((n_kv + sp.chunk - 1) / sp.chunk > 1) {
        // one of several parts: its row sums over the 8 lanes of a row; acc,
        // m and l into the workspace at this item
        float* wo = sp.ws_o + (long long)blockIdx.x * FWD_BQ * HS;
        float* wml = sp.ws_ml + (long long)blockIdx.x * 2 * FWD_BQ;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int sh = 4; sh > 0; sh >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], sh);
          float* dst = wo + (r0 + i) * HS;
          *reinterpret_cast<float4*>(dst + 4 * kg) =
              make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *reinterpret_cast<float4*>(dst + 32 + 4 * kg) =
              make_float4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
          if (kg == 0) {
            wml[r0 + i] = m[i];
            wml[FWD_BQ + r0 + i] = l[i];
          }
        }
        return;
      }
    }
    // the row sums over the 8 lanes of a row; o = acc / l, lse = m + log l
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int sh = 4; sh > 0; sh >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], sh);
      const int qq = q0 + r0 + i;
      if (qq < Tq) {
        float* dst = o + (((long long)b * Tq + qq) * H + hh) * HS;
        *reinterpret_cast<float4*>(dst + 4 * kg) =
            make_float4(acc[i][0] / l[i], acc[i][1] / l[i], acc[i][2] / l[i], acc[i][3] / l[i]);
        *reinterpret_cast<float4*>(dst + 32 + 4 * kg) =
            make_float4(acc[i][4] / l[i], acc[i][5] / l[i], acc[i][6] / l[i], acc[i][7] / l[i]);
        if (kg == 0) lse[((long long)b * H + hh) * Tq + qq] = m[i] + logf(l[i]);
      }
    }
  }
}

// a dk/dv block: K^T, V^T resident; a query tile of q, dO, lse, D in two
// slots; P and dS of 16 query rows
struct DkvSmem {
  float kt[HS][TILE];  // K^T / sqrt(hs): [channel][key]
  float vt[HS][TILE];  // V^T: [channel][key]
  Tile q[2];
  Tile dO[2];
  float lse[2][TILE];
  float dd[2][TILE];
  float p[16][LDT];    // P: [row][key]
  float ds[16][LDT];   // dS: [row][key]
};

// a dq block: q^T, dO^T, lse, D resident; a key tile of K and V in two slots;
// per warp dS^T of 16 keys
struct DqSmem {
  float qt[HS][TILE];  // q^T / sqrt(hs): [channel][row]
  float dOt[HS][TILE]; // dO^T: [channel][row]
  float lse[TILE];
  float dd[TILE];
  Tile k[2];
  Tile v[2];
  Quarter<16> dst[WARPS];  // per warp: dS^T of 16 keys
};

constexpr int BWD_SMEM =
    sizeof(DkvSmem) > sizeof(DqSmem) ? (int)sizeof(DkvSmem) : (int)sizeof(DqSmem);

struct Strides {
  long long sb, st, sh;
};

// the operands of a backward block
struct BwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* dO;
  const float* lse;
  const float* dd;  // the row term: D = rowsum(dO * O), or D - dlse
  float* dq;
  float* dk;
  float* dv;
  Strides qs, ks, vs;
};

// q and dO rows q0 .. q0 + 63 of (b, h) and their lse and row term into slot
// `slot` of a dk/dv block, asynchronously; zeros at or past Tq (P = 0 there,
// and nothing is read past the end of lse or D)
template <Case C>
__device__ __forceinline__ void load_query_tile(DkvSmem& s, int slot, const float* qb,
                                                long long qst, const float* dob, long long dost,
                                                const float* lse_bh, const float* dd_bh, int q0,
                                                int Tq, int tid) {
  load_swept<C>(s.q[slot], qb, qst, q0, Tq, tid);
  load_swept<C>(s.dO[slot], dob, dost, q0, Tq, tid);
  const int r = tid & (TILE - 1), t = q0 + r;
  if (tid < TILE)
    cp_async4(&s.lse[slot][r], lse_bh + (t < Tq ? t : 0), t < Tq ? 4 : 0);
  else
    cp_async4(&s.dd[slot][r], dd_bh + (t < Tq ? t : 0), t < Tq ? 4 : 0);
}

// rows row0 + kk of a (B, T, H, hs) contiguous output, 8 channels a thread
// (4g .. 4g + 3, 32 + 4g .. 32 + 4g + 3) times scale, for the 4 rows
// key0 + kk of the tile
__device__ __forceinline__ void store_keys(float* __restrict__ out, const float (&acc)[4][8],
                                           float scale, int b, int h, int H, int row0, int T,
                                           int g) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int t = row0 + kk;
    if (t < T) {
      float* dst = out + (((long long)b * T + t) * H + h) * HS;
      *reinterpret_cast<float4*>(dst + 4 * g) =
          make_float4(acc[kk][0] * scale, acc[kk][1] * scale, acc[kk][2] * scale,
                      acc[kk][3] * scale);
      *reinterpret_cast<float4*>(dst + 32 + 4 * g) =
          make_float4(acc[kk][4] * scale, acc[kk][5] * scale, acc[kk][6] * scale,
                      acc[kk][7] * scale);
    }
  }
}

// dk, dv of key tile kt of (h, b) (SELF): keys k0 .. k0 + 63, the query
// tiles from the first that sees one of them (causal: the row k0) on
template <Case C>
__device__ __forceinline__ void dkv_block(const BwdArgs& a, int kt, int Tq, int H, int causal) {
  static_assert(C == Case::SELF, "the dk/dv block serves the self-attention backward");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DkvSmem& s = *reinterpret_cast<DkvSmem*>(smem_raw);
  const int Tk = Tq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int ntq = (Tq + TILE - 1) / TILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const float* qb = a.q + (long long)b * a.qs.sb + (long long)h * a.qs.sh;
  const float* kb = a.k + (long long)b * a.ks.sb + (long long)h * a.ks.sh;
  const float* vb = a.v + (long long)b * a.vs.sb + (long long)h * a.vs.sh;
  // dO: contiguous (B, Tq, H, hs)
  const float* dob = a.dO + ((long long)b * Tq * H + h) * HS;
  const long long dost = (long long)H * HS;
  // 1 / sqrt(64), exact: K^T's and dK's
  const float scale = 0.125f;
  const int k0 = kt * TILE;
  const int rg = lane & 15, kg = lane >> 4;  // S, dP: rows rg + 16 i, keys 16 warp + 8 kg + j
  // dK, dV: keys 16 warp + 4 kq + kk, channels by g; a quarter-warp spans
  // 4 kq x 2 g, so its reads of dO and q rows ask for two addresses
  const int kq = (lane & 7) >> 1, g = 2 * (lane >> 3) + (lane & 1);
  // causal: the first row that sees key k0 is k0
  const int it0 = !causal ? 0 : kt;
  load_query_tile<C>(s, 0, qb, a.qs.st, dob, dost, a.lse + bh * Tq, a.dd + bh * Tq, it0 * TILE,
                     Tq, tid);
  cp_async_commit();
  load_resident<C, TILE>(&s.kt[0][0], kb, a.ks.st, k0, Tk, scale, tid);
  load_resident<C, TILE>(&s.vt[0][0], vb, a.vs.st, k0, Tk, 1.f, tid);
  float acc_k[4][8], acc_v[4][8];
  zero(acc_k);
  zero(acc_v);
  for (int it = it0; it < ntq; ++it) {
    const int slot = (it - it0) & 1, q0 = it * TILE;
    cp_async_wait_all();
    __syncthreads();  // tile it is in; every warp is done with tile it - 1's slot
    if (it + 1 < ntq)
      load_query_tile<C>(s, slot ^ 1, qb, a.qs.st, dob, dost, a.lse + bh * Tq, a.dd + bh * Tq,
                         q0 + TILE, Tq, tid);
    cp_async_commit();

    float sc[4][8], dp[4][8];
    zero(sc);
    zero(dp);
    keys_by_rows(sc, s.q[slot], &s.kt[0][16 * warp + 8 * kg], rg);
    keys_by_rows(dp, s.dO[slot], &s.vt[0][16 * warp + 8 * kg], rg);
    // P = exp(S - lse) where visible, else 0; dS = P (dP - D); without an
    // offset the diagonal crosses the tile it == kt only
    const bool diag = it == kt;
    const bool edge = (causal && diag) || q0 + TILE > Tq || k0 + TILE > Tk;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = rg + 16 * i, qq = q0 + r;
      const float l = s.lse[slot][r], dr = s.dd[slot][r];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kk = k0 + 16 * warp + 8 * kg + j;
        const bool masked = edge && (qq >= Tq || kk >= Tk || (causal && kk > qq));
        const float p = masked ? 0.f : expf(sc[i][j] - l);
        sc[i][j] = p;
        dp[i][j] = p * (dp[i][j] - dr);
      }
    }
    // dV += P^T dO, dK += dS^T q, 16 query rows at a time through the
    // warp's columns of P and dS
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* prow = &s.p[rg][16 * warp + 8 * kg];
      float* drow = &s.ds[rg][16 * warp + 8 * kg];
      *reinterpret_cast<float4*>(prow) = make_float4(sc[i][0], sc[i][1], sc[i][2], sc[i][3]);
      *reinterpret_cast<float4*>(prow + 4) =
          make_float4(sc[i][4], sc[i][5], sc[i][6], sc[i][7]);
      *reinterpret_cast<float4*>(drow) = make_float4(dp[i][0], dp[i][1], dp[i][2], dp[i][3]);
      *reinterpret_cast<float4*>(drow + 4) =
          make_float4(dp[i][4], dp[i][5], dp[i][6], dp[i][7]);
      __syncwarp();
      acc_rows(acc_v, s.p, 16 * warp + 4 * kq, s.dO[slot], 16 * i, g);
      acc_rows(acc_k, s.ds, 16 * warp + 4 * kq, s.q[slot], 16 * i, g);
      __syncwarp();
    }
  }
  cp_async_wait_all();
  store_keys(a.dk, acc_k, scale, b, h, H, k0 + 16 * warp + 4 * kq, Tk, g);
  store_keys(a.dv, acc_v, 1.f, b, h, H, k0 + 16 * warp + 4 * kq, Tk, g);
}

// dq of query tile qt of (h, b) (SELF): queries q0 .. q0 + 63, the key tiles
// up to the last one its last row sees; dq is scaled by 1 / sqrt(hs)
template <Case C>
__device__ __forceinline__ void dq_block(const BwdArgs& a, int qt, int Tq, int H, int causal) {
  static_assert(C == Case::SELF, "the dq block serves the self-attention backward");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  DqSmem& s = *reinterpret_cast<DqSmem*>(smem_raw);
  const int Tk = Tq;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const float* qb = a.q + (long long)b * a.qs.sb + (long long)h * a.qs.sh;
  const float* kb = a.k + (long long)b * a.ks.sb + (long long)h * a.ks.sh;
  const float* vb = a.v + (long long)b * a.vs.sb + (long long)h * a.vs.sh;
  // dO as in dkv_block
  const float* dob = a.dO + ((long long)b * Tq * H + h) * HS;
  const long long dost = (long long)H * HS;
  // 1 / sqrt(64), exact: q^T's and dQ's
  const float scale = 0.125f;
  const int q0 = qt * TILE;
  const int hf = lane >> 4, tc = lane & 15;  // rows 16 warp + 8 hf + i, keys tc + 16 j
  const int r0 = 16 * warp + 8 * hf;
  load_swept<C>(s.k[0], kb, a.ks.st, 0, Tk, tid);
  load_swept<C>(s.v[0], vb, a.vs.st, 0, Tk, tid);
  cp_async_commit();
  load_resident<C, TILE>(&s.qt[0][0], qb, a.qs.st, q0, Tq, scale, tid);
  load_resident<C, TILE>(&s.dOt[0][0], dob, dost, q0, Tq, 1.f, tid);
  if (tid < TILE) {
    const int t = q0 + tid;
    s.lse[tid] = t < Tq ? a.lse[bh * Tq + t] : 0.f;
    s.dd[tid] = t < Tq ? a.dd[bh * Tq + t] : 0.f;
  }
  float acc_q[8][4];
  zero(acc_q);
  const int n_kv = !causal ? (Tk + TILE - 1) / TILE : qt + 1;
  for (int j = 0; j < n_kv; ++j) {
    const int slot = j & 1, k0 = j * TILE;
    cp_async_wait_all();
    __syncthreads();  // tile j is in; every warp is done with tile j - 1's slot
    if (j + 1 < n_kv) {
      load_swept<C>(s.k[slot ^ 1], kb, a.ks.st, k0 + TILE, Tk, tid);
      load_swept<C>(s.v[slot ^ 1], vb, a.vs.st, k0 + TILE, Tk, tid);
    }
    cp_async_commit();

    float sc[8][4], dp[8][4];
    zero(sc);
    zero(dp);
    rows_by_keys<TILE, 4, 16>(sc, &s.qt[0][r0], s.k[slot], tc);
    rows_by_keys<TILE, 4, 16>(dp, &s.dOt[0][r0], s.v[slot], tc);
    const bool diag = j == qt;
    const bool edge = (causal && diag) || q0 + TILE > Tq || k0 + TILE > Tk;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int qq = q0 + r0 + i;
      const float l = s.lse[r0 + i], dr = s.dd[r0 + i];
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kk = k0 + tc + 16 * c;
        const bool masked = edge && (qq >= Tq || kk >= Tk || (causal && kk > qq));
        const float p = masked ? 0.f : expf(sc[i][c] - l);
        dp[i][c] = p * (dp[i][c] - dr);
      }
    }
    // dQ += dS K, 16 keys at a time through the warp's dS^T
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      store_quarter_t(s.dst[warp], dp, c, tc, 8 * hf);
      __syncwarp();
      acc_keys(acc_q, s.dst[warp], s.k[slot], QK * c, 8 * hf, 4 * tc);
      __syncwarp();
    }
  }
  cp_async_wait_all();
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int t = q0 + r0 + i;
    if (t < Tq)
      *reinterpret_cast<float4*>(a.dq + (((long long)b * Tq + t) * H + h) * HS + 4 * tc) =
          make_float4(acc_q[i][0] * scale, acc_q[i][1] * scale, acc_q[i][2] * scale,
                      acc_q[i][3] * scale);
  }
}

// The backward grid of (h, b), Tq == Tk = T (SELF): block x < nt is the dk/dv
// block of key tile x (tile 0, the longest causal sweep, first), x >= nt the
// dq block of query tile nt - 1 - (x - nt) (the last, the longest, first).
template <Case C>
__device__ __forceinline__ void backward_grid(const BwdArgs& a, int T, int H, int causal) {
  const int nt = (T + TILE - 1) / TILE;
  if ((int)blockIdx.x < nt)
    dkv_block<C>(a, blockIdx.x, T, H, causal);
  else
    dq_block<C>(a, nt - 1 - ((int)blockIdx.x - nt), T, H, causal);
}

// ---- the one-pass block (Case::GENERAL, Case::DT) ------------------------------
//
// One pass over each visible (query tile, key tile) pair, five products, as
// the TPU's _bwd_kernel_fused (and its transposed mirror, the A/B tool's
// _bwd_dt_kernel): a block owns 64 keys of one (b, h), K / sqrt(hs) (DT: K,
// q being pre-scaled) and V resident as [key][channel] tiles, and sweeps the
// 64-row query tiles, q, dO, lse and the row term in one slot by cp.async
// (the next tile's copy runs under dQ and the add into dq). In the dt layout
// every one of these tiles arrives d-major, so each is copied by the 4-byte
// transposing cp.async (load_tile_dt_async), K and V once an item, q and dO
// each pair. Its 4 warps work in two halves of 64 threads, a half's thread
// on 8 x 8 values:
//   - half 0: S = q K^T / sqrt(hs) (rows rg + 8 ii, keys 8 kg + jj), then
//     P = exp(S - lse), masked, into the shared P tile; half 1: dP = dO V^T
//     on the same places, then (P in) dS = P (dP - c) into the shared dS tile;
//   - half 0: dV += P^T dO, half 1: dK += dS^T q, keys 8 a + kk, channels
//     4 b + e and 32 + 4 b + e, summed over the item's query rows in sweep
//     order (the halves' accumulators are one register array);
//   - all 4 warps: the pair's part of dQ, dS K / sqrt(hs) (DT: dS K times
//     dq_scale), rows rq + 8 ii (DT: 8 rq + ii, 8 consecutive positions, so
//     that dq's reads and writes are 16 bytes of one channel), channels
//     4 cq + e, added into dq in global memory.
// Shared reads: a quarter-warp reads one row of one operand (one address)
// and 8 consecutive rows, or 8 consecutive float4 of one row, of the other:
// no bank conflicts (rows padded to LDT), and per 4 channels or rows 8 + 8
// float4 for 256 FFMAs (dQ 8 + 4 for 128).
//
// dq without atomics, in a fixed order. Each query tile's parts are added in
// a fixed order of key tiles: the first stores, the others load, add and
// store. A flag per (b, h, query tile), zeroed before each launch, counts
// the parts added so far. The block
// whose turn it is spins on ld.acquire.gpu (thread 0, before a block
// barrier) and copies the tile's sum so far through L2 (cp.async.cg:
// another SM wrote it) into the free P tile while it computes its part;
// after the next block barrier, which orders the block's stores before it,
// thread 0 publishes count + 1 with __threadfence and st.release.gpu. Only
// that block writes the flag, so no read-modify-write is needed. Deadlock:
// the grid is persistent, one block per resident slot (the occupancy
// calculator sizes it), launched cooperatively, so that either every block
// is resident at once or the launch fails; a block walks its work items
// (b, h, key tile) in a fixed order, and an item waits only on
//   - causal, or unmasked with ntq != ntk tiles (the list): items earlier
//     in one list, key tiles in descending order, (b, h) fastest, dealt in
//     rounds of one item a block (every other round from the last block
//     down, so that a block's short item of one round meets a long one in
//     the next). Each block walks its items in list order, so the first
//     unfinished item of the list always runs. A query tile sums its parts
//     from the last key tile that sees it down to key tile 0: under the mask
//     a sweep from each key tile's first visible query tile reaches query
//     tile i from key tile j after i - j steps, so the next key tile's part
//     arrives one step ahead and nothing waits;
//   - unmasked with ntq == ntk and a (b, h)'s key tiles no more than the
//     blocks (the rounds): whole (b, h) at a time, each of its key tiles on
//     its own block; key tile j sweeps the query tiles from j on, wrapping
//     round, and query tile i sums from key tile i down, wrapping round: the
//     part of the key tile before in the order arrives one step ahead. All
//     of a round's items run at once, and each wait is on the step before.
// The DT mask has no offset: key tile j is seen by query tiles j on (none
// when j >= ntq, Tq < Tk: that item sweeps nothing and writes dk = dv = 0),
// and query tile i by key tiles 0 .. min(i, ntk - 1) (every key tile when i
// >= ntk, Tq > Tk). So the list sweeps key tile j from query tile j on and
// query tile i sums from key tile min(i, ntk - 1) down: key tile j reaches
// query tile i after i - j steps, the key tile before it in the order (j + 1,
// earlier in the list) one step ahead, as under the right-aligned mask; the
// list's and the rounds' arguments hold unchanged.
// A wait past WAIT_LIMIT_NS traps (the launch fails) rather than hanging the
// card.

constexpr long long WAIT_LIMIT_NS = 20000000000ll;  // 20 s

struct PairSmem {
  Tile k;      // K / sqrt(hs) (DT: K): [key][channel]
  Tile v;      // V: [key][channel]
  Tile q;      // the swept query tile: [row][channel]
  Tile dO;     // its dO rows
  Tile p;      // P: [row][key]
  Tile ds;     // dS: [row][key]
  float lse[TILE];
  float dd[TILE];  // the row term
};

constexpr int PAIR_SMEM = (int)sizeof(PairSmem);

__device__ __forceinline__ unsigned int ld_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release(unsigned int* p, unsigned int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// spin until the flag reads `want`
__device__ __forceinline__ void wait_flag(const unsigned int* f, unsigned int want) {
  if (ld_acquire(f) == want) return;
  const unsigned long long t0 = global_ns();
  while (ld_acquire(f) != want) {
    __nanosleep(64);
    if (global_ns() - t0 > (unsigned long long)WAIT_LIMIT_NS) __trap();
  }
}

// t[ii][jj] += sum_d a[rg + 8 ii][d] * b[8 kg + jj][d], both [position][channel]
// tiles; the sum over d runs 0 .. 63 in order
__device__ __forceinline__ void rows_by_rows(float (&t)[8][8], const Tile& a, const Tile& b,
                                             int rg, int kg) {
#pragma unroll 2
  for (int d4 = 0; d4 < HS / 4; ++d4) {
    float4 bf[8];
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) bf[jj] = *reinterpret_cast<const float4*>(&b[8 * kg + jj][4 * d4]);
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const float4 af = *reinterpret_cast<const float4*>(&a[rg + 8 * ii][4 * d4]);
#pragma unroll
      for (int dd = 0; dd < 4; ++dd)
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) t[ii][jj] = fmaf(comp(af, dd), comp(bf[jj], dd), t[ii][jj]);
    }
  }
}

// the thread's 8 x 8 values (rows rg + 8 ii, keys 8 kg + jj) into a [row][key] tile
__device__ __forceinline__ void store_rows(Tile& dst, const float (&t)[8][8], int rg, int kg) {
#pragma unroll
  for (int ii = 0; ii < 8; ++ii) {
    float* row = &dst[rg + 8 * ii][8 * kg];
    *reinterpret_cast<float4*>(row) = make_float4(t[ii][0], t[ii][1], t[ii][2], t[ii][3]);
    *reinterpret_cast<float4*>(row + 4) = make_float4(t[ii][4], t[ii][5], t[ii][6], t[ii][7]);
  }
}

// acc[kk][e] += sum_r x[r][8 a + kk] * y[r][channel e], r = 0 .. 63 in order;
// the thread's channels are 4 b .. 4 b + 3 (e < 4) and 32 + 4 b .. (e >= 4)
__device__ __forceinline__ void keys_by_channels(float (&acc)[8][8], const Tile& x, const Tile& y,
                                                 int a, int b) {
#pragma unroll 4
  for (int r = 0; r < TILE; ++r) {
    const float4 x0 = *reinterpret_cast<const float4*>(&x[r][8 * a]);
    const float4 x1 = *reinterpret_cast<const float4*>(&x[r][8 * a + 4]);
    const float4 y0 = *reinterpret_cast<const float4*>(&y[r][4 * b]);
    const float4 y1 = *reinterpret_cast<const float4*>(&y[r][32 + 4 * b]);
    const float xr[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    const float yr[8] = {y0.x, y0.y, y0.z, y0.w, y1.x, y1.y, y1.z, y1.w};
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[kk][e] = fmaf(xr[kk], yr[e], acc[kk][e]);
  }
}

// acc[ii][e] += sum_j x[RA rq + RB ii][j] * y[j][4 cq + e], j = 0 .. 63 in
// order: x a [row][key] tile, y a [key][channel] tile; rows rq + 8 ii (RA = 1,
// RB = 8) or 8 rq + ii (RA = 8, RB = 1)
template <int RA, int RB>
__device__ __forceinline__ void rows_by_channels(float (&acc)[8][4], const Tile& x, const Tile& y,
                                                 int rq, int cq) {
#pragma unroll 2
  for (int j4 = 0; j4 < TILE / 4; ++j4) {
    float4 yf[4];
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) yf[jj] = *reinterpret_cast<const float4*>(&y[4 * j4 + jj][4 * cq]);
#pragma unroll
    for (int ii = 0; ii < 8; ++ii) {
      const float4 xf = *reinterpret_cast<const float4*>(&x[RA * rq + RB * ii][4 * j4]);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[ii][e] = fmaf(comp(xf, jj), comp(yf[jj], e), acc[ii][e]);
    }
  }
}

// rows row0 .. row0 + 63 of a (B, T, H, hs) tensor (base: row 0 of one
// (b, h), st: the position stride) into a [position][channel] tile times
// scale, zeros at or past T; synchronous
__device__ __forceinline__ void load_rows(Tile& dst, const float* __restrict__ base, long long st,
                                          int row0, int T, float scale, int tid) {
#pragma unroll
  for (int i = 0; i < TILE * (HS / 4) / THREADS; ++i) {
    const int f = tid + i * THREADS, r = f >> 4, c = f & 15, t = row0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) x = __ldg(reinterpret_cast<const float4*>(base + (long long)t * st) + c);
    *reinterpret_cast<float4*>(&dst[r][4 * c]) =
        make_float4(x.x * scale, x.y * scale, x.z * scale, x.w * scale);
  }
}

// q and dO rows q0 .. q0 + 63 and their lse and row term into the block's
// slot, asynchronously; zeros at or past Tq
template <Case C>
__device__ __forceinline__ void load_pair_query_tile(PairSmem& s, const float* qb, long long qst,
                                                     const float* dob, long long dost,
                                                     const float* lse_bh, const float* dd_bh,
                                                     int q0, int Tq, int tid) {
  load_swept<C>(s.q, qb, qst, q0, Tq, tid);
  load_swept<C>(s.dO, dob, dost, q0, Tq, tid);
  const int r = tid & (TILE - 1), t = q0 + r;
  if (tid < TILE)
    cp_async4(&s.lse[r], lse_bh + (t < Tq ? t : 0), t < Tq ? 4 : 0);
  else
    cp_async4(&s.dd[r], dd_bh + (t < Tq ? t : 0), t < Tq ? 4 : 0);
}

// rows row0 + kk (kk < 8) of a (B, T, H, hs) contiguous output, channels
// 4 b .. 4 b + 3 and 32 + 4 b .., times scale
__device__ __forceinline__ void store_keys8(float* __restrict__ out, const float (&acc)[8][8],
                                            float scale, int b, int h, int H, int row0, int T,
                                            int g) {
#pragma unroll
  for (int kk = 0; kk < 8; ++kk) {
    const int t = row0 + kk;
    if (t < T) {
      float* dst = out + (((long long)b * T + t) * H + h) * HS;
      *reinterpret_cast<float4*>(dst + 4 * g) =
          make_float4(acc[kk][0] * scale, acc[kk][1] * scale, acc[kk][2] * scale,
                      acc[kk][3] * scale);
      *reinterpret_cast<float4*>(dst + 32 + 4 * g) =
          make_float4(acc[kk][4] * scale, acc[kk][5] * scale, acc[kk][6] * scale,
                      acc[kk][7] * scale);
    }
  }
}

// keys row0 .. row0 + 7 of a dt-layout output (ob: its (b, h) slab, cs: the
// channel stride): two 16-byte stores of four positions for each of the
// thread's 8 channels (4 g .. 4 g + 3, 32 + 4 g .. 32 + 4 g + 3)
__device__ __forceinline__ void store_keys8_dt(float* __restrict__ ob, const float (&acc)[8][8],
                                               long long cs, int row0, int g) {
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    float* dst = ob + (long long)(4 * g + (e < 4 ? e : 28 + e)) * cs + row0;
    *reinterpret_cast<float4*>(dst) = make_float4(acc[0][e], acc[1][e], acc[2][e], acc[3][e]);
    *reinterpret_cast<float4*>(dst + 4) = make_float4(acc[4][e], acc[5][e], acc[6][e], acc[7][e]);
  }
}

// One work item: dk and dv of key tile kt of (b, h), and its parts of dq.
// flags: the (b, h)'s ntq flags; rounds: the wrapping sweep of the rounds
// (see above), else the list's; dq_scale: the dt case's scale of dq (the
// general case's 1 / sqrt(hs) rides on its resident K).
template <Case C>
__device__ __forceinline__ void pair_block(const BwdArgs& a, int b, int h, int kt, int Tq, int Tk,
                                           int H, int causal, unsigned int* flags, bool rounds,
                                           float dq_scale) {
  static_assert(C != Case::SELF, "the one-pass block is instanced for the general and dt cases");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  PairSmem& s = *reinterpret_cast<PairSmem*>(smem_raw);
  const int off = C == Case::GENERAL ? Tk - Tq : 0;  // a causal row i sees the keys <= i + off
  const int tid = threadIdx.x, half = tid >> 6, t64 = tid & 63;
  const int ntq = (Tq + TILE - 1) / TILE, ntk = (Tk + TILE - 1) / TILE;
  const long long bh = (long long)b * H + h;
  const float* qb = a.q + (long long)b * a.qs.sb + (long long)h * a.qs.sh;
  const float* kb = a.k + (long long)b * a.ks.sb + (long long)h * a.ks.sh;
  const float* vb = a.v + (long long)b * a.vs.sb + (long long)h * a.vs.sh;
  // dO: contiguous (B, Tq, H, hs), or q's dt layout; lse and the row term:
  // row bh * Tq of (B, H, Tq), or h * st + b * sb of (H, B*Tq)
  const float* dob = C == Case::DT ? a.dO + (long long)b * a.qs.sb + (long long)h * a.qs.sh
                                   : a.dO + ((long long)b * Tq * H + h) * HS;
  const long long dost = C == Case::DT ? a.qs.st : (long long)H * HS;
  const long long row0 =
      C == Case::DT ? (long long)h * a.qs.st + (long long)b * a.qs.sb : bh * Tq;
  const int k0 = kt * TILE;
  const int rg = t64 & 7, kg = t64 >> 3;   // S, dP, P, dS: rows rg + 8 ii, keys 8 kg + jj
  const int ka = t64 >> 3, cb = t64 & 7;   // dK, dV: keys 8 ka + kk, channels by cb
  const int rq = tid >> 4, cq = tid & 15;  // dQ: rows rq + 8 ii (DT: 8 rq + ii), channels 4 cq + e
  // the sweep: the rounds' from query tile kt on, wrapping round; else from
  // the first query tile that sees one of the keys (causal: row k0 - off; DT:
  // query tile kt, past the last when no query sees the keys)
  const int it0 = rounds   ? kt
                  : causal ? (C == Case::DT ? kt : max(k0 - off, 0) / TILE)
                           : 0;
  const int n = rounds ? ntq : ntq - it0;

  load_pair_query_tile<C>(s, qb, a.qs.st, dob, dost, a.lse + row0, a.dd + row0, it0 * TILE, Tq,
                          tid);
  if constexpr (C == Case::DT) {  // K and V arrive d-major: transposing copies
    load_swept<C>(s.k, kb, a.ks.st, k0, Tk, tid);
    load_swept<C>(s.v, vb, a.vs.st, k0, Tk, tid);
  }
  cp_async_commit();
  if constexpr (C == Case::GENERAL) {
    load_rows(s.k, kb, a.ks.st, k0, Tk, 0.125f, tid);  // 1 / sqrt(64), exact
    load_rows(s.v, vb, a.vs.st, k0, Tk, 1.f, tid);
  }
  float acc[8][8];  // half 0: dV, half 1: dK
  zero(acc);
  unsigned int* pending = nullptr;  // the flag to publish, and its value
  unsigned int pending_val = 0;
  for (int st = 0; st < n; ++st) {
    const int it = rounds ? (it0 + st) % ntq : it0 + st, q0 = it * TILE;
    // this part's place in its query tile's order
    const int rank = rounds ? st
                     : (causal ? (C == Case::DT ? min(it, ntk - 1)
                                                : (min(q0 + TILE, Tq) - 1 + off) / TILE)
                               : ntk - 1) -
                           kt;
    cp_async_wait_all();
    __syncthreads();  // the tile is in; every thread's part of the last dq tile is out
    if (tid == 0 && pending) {  // publish it (the barrier orders the block's stores first)
      __threadfence();
      st_release(pending, pending_val);
    }

    float t[8][8];
    zero(t);
    rows_by_rows(t, *(half ? &s.dO : &s.q), *(half ? &s.v : &s.k), rg, kg);
    const bool diag = k0 + TILE - 1 > q0 + off;
    const bool edge = (causal && diag) || q0 + TILE > Tq || k0 + TILE > Tk;
    if (half == 0) {
      // P = exp(S - lse) where visible, else 0
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int r = rg + 8 * ii, qq = q0 + r;
        const float l = s.lse[r];
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) {
          const int kk = k0 + 8 * kg + jj;
          const bool masked = edge && (qq >= Tq || kk >= Tk || (causal && kk > qq + off));
          t[ii][jj] = masked ? 0.f : expf(t[ii][jj] - l);
        }
      }
      store_rows(s.p, t, rg, kg);
    }
    __syncthreads();  // P is in
    if (half == 1) {
      // dS = P (dP - c)
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int r = rg + 8 * ii;
        const float dr = s.dd[r];
        const float4 p0 = *reinterpret_cast<const float4*>(&s.p[r][8 * kg]);
        const float4 p1 = *reinterpret_cast<const float4*>(&s.p[r][8 * kg + 4]);
        const float pr[8] = {p0.x, p0.y, p0.z, p0.w, p1.x, p1.y, p1.z, p1.w};
#pragma unroll
        for (int jj = 0; jj < 8; ++jj) t[ii][jj] = pr[jj] * (t[ii][jj] - dr);
      }
      store_rows(s.ds, t, rg, kg);
      asm volatile("bar.sync 1, 64;\n" ::: "memory");  // half 1's dS is in
    }
    // dV += P^T dO (half 0), dK += dS^T q (half 1)
    keys_by_channels(acc, *(half ? &s.ds : &s.p), *(half ? &s.q : &s.dO), ka, cb);
    unsigned int* flag = flags + it;
    if (tid == 0 && rank > 0) wait_flag(flag, (unsigned int)rank);
    __syncthreads();  // dS is in; q, dO and P are read; dq's earlier parts are out
    // the thread's values of the dq tile so far into the free P tile, through
    // L2 (another SM wrote them), under dQ's product: 8 rows x 4 channels
    // (DT: 8 positions, two 16-byte runs a channel, 16 bytes of the thread
    // every 16 THREADS bytes of the tile)
    float* dqb = C == Case::DT
                     ? a.dq + (long long)b * a.qs.sb + (long long)h * a.qs.sh + q0 + 8 * rq
                     : a.dq + (((long long)b * Tq + q0) * H + h) * HS + 4 * cq;
    if (rank > 0) {
      if constexpr (C == Case::DT) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          cp_async16(&s.p[0][0] + 4 * (tid + THREADS * j),
                     dqb + (long long)(4 * cq + (j >> 1)) * a.qs.st + 4 * (j & 1), 16);
      } else {
#pragma unroll
        for (int ii = 0; ii < 8; ++ii) {
          const int r = rq + 8 * ii;
          cp_async16(&s.p[r][4 * cq], dqb + (long long)(q0 + r < Tq ? r : 0) * H * HS,
                     q0 + r < Tq ? 16 : 0);
        }
      }
    }
    cp_async_commit();
    if (st + 1 < n) {
      const int nq0 = (rounds ? (it0 + st + 1) % ntq : it0 + st + 1) * TILE;
      load_pair_query_tile<C>(s, qb, a.qs.st, dob, dost, a.lse + row0, a.dd + row0, nq0, Tq,
                              tid);
    }
    cp_async_commit();

    // this pair's part of dQ = dS K / sqrt(hs) (DT: dS K times dq_scale, the
    // part scaled before it is added), into dq in the tile's order
    float pq[8][4];
    zero(pq);
    rows_by_channels<C == Case::DT ? 8 : 1, C == Case::DT ? 1 : 8>(pq, s.ds, s.k, rq, cq);
    cp_async_wait_all_but_last();  // the dq tile is in (the next query tile may not be)
    if constexpr (C == Case::DT) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int e = j >> 1, i0 = 4 * (j & 1);
        float4 v = make_float4(pq[i0][e] * dq_scale, pq[i0 + 1][e] * dq_scale,
                               pq[i0 + 2][e] * dq_scale, pq[i0 + 3][e] * dq_scale);
        if (rank > 0) {
          const float4 o = *reinterpret_cast<const float4*>(&s.p[0][0] + 4 * (tid + THREADS * j));
          v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
        }
        __stcg(reinterpret_cast<float4*>(dqb + (long long)(4 * cq + e) * a.qs.st + i0), v);
      }
    } else {
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int r = rq + 8 * ii;
        if (q0 + r < Tq) {
          float4 v = make_float4(pq[ii][0], pq[ii][1], pq[ii][2], pq[ii][3]);
          if (rank > 0) {
            const float4 o = *reinterpret_cast<const float4*>(&s.p[r][4 * cq]);
            v = make_float4(o.x + v.x, o.y + v.y, o.z + v.z, o.w + v.w);
          }
          __stcg(reinterpret_cast<float4*>(dqb + (long long)r * H * HS), v);
        }
      }
    }
    pending = flag;
    pending_val = (unsigned int)(rank + 1);
  }
  cp_async_wait_all();
  __syncthreads();  // every thread's part of the last dq tile is out; the tiles are free
  if (tid == 0 && pending) {
    __threadfence();
    st_release(pending, pending_val);
  }
  if constexpr (C == Case::DT) {  // dk takes no scale: q is pre-scaled
    const long long kvo = (long long)b * a.ks.sb + (long long)h * a.ks.sh;
    store_keys8_dt((half ? a.dk : a.dv) + kvo, acc, a.ks.st, k0 + 8 * ka, cb);
  } else {
    if (half)
      store_keys8(a.dk, acc, 0.125f, b, h, H, k0 + 8 * ka, Tk, cb);
    else
      store_keys8(a.dv, acc, 1.f, b, h, H, k0 + 8 * ka, Tk, cb);
  }
}

// The persistent grid of the one-pass block: block x walks its work items
// (see above). BH = B * H; flags: B * H * ntq of them; rounds: the (b, h)
// of a round (0: the list); dq_scale as in pair_block.
template <Case C>
__device__ __forceinline__ void pair_grid(const BwdArgs& a, int Tq, int Tk, int H, int BH,
                                          int causal, unsigned int* flags, int rounds,
                                          float dq_scale = 1.f) {
  const int ntq = (Tq + TILE - 1) / TILE, ntk = (Tk + TILE - 1) / TILE;
  const int x = blockIdx.x;
  for (long long r = 0;; ++r) {
    long long bh, kt;
    if (rounds) {
      bh = x / ntk + r * rounds;
      kt = x % ntk;
    } else {
      // round r of the list, blocks in turn, every other round from the
      // last block down: a block's short item of one round is paired with a
      // long one in the next
      const long long base = r * gridDim.x, w = base + (r & 1 ? gridDim.x - 1 - x : x);
      if (base >= (long long)ntk * BH) return;
      if (w >= (long long)ntk * BH) continue;
      bh = w % BH;
      kt = ntk - 1 - w / BH;
    }
    if (bh >= BH) return;
    pair_block<C>(a, (int)(bh / H), (int)(bh % H), (int)kt, Tq, Tk, H, causal,
                  flags + bh * ntq, rounds != 0, dq_scale);
  }
}

// more than 48 KB of dynamic shared memory and the largest carveout for
// `kernel`: set once per device (`configured` holds a bit per device)
template <typename Kernel>
cudaError_t configure_once(Kernel kernel, int smem, unsigned long long& configured) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64) return cudaErrorInvalidDevice;
  if (!((configured >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    configured |= 1ull << dev;
  }
  return cudaSuccess;
}

// the blocks of `kernel` that the current device keeps resident at once (SMs
// times blocks an SM, from the occupancy calculator), counted once per device
// into slots_of_device
template <typename Kernel>
cudaError_t resident_slots(Kernel kernel, int smem, unsigned long long& configured,
                           int (&slots_of_device)[64], int* out) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = configure_once(kernel, smem, configured);
  if (err != cudaSuccess) return err;
  if (slots_of_device[dev] == 0) {
    int sms = 0, blocks = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    if (sms * blocks == 0) return cudaErrorLaunchOutOfResources;
    slots_of_device[dev] = sms * blocks;
  }
  *out = slots_of_device[dev];
  return cudaSuccess;
}

// One launch of a one-pass grid (pair_grid) on `stream`: unmasked with as
// many query tiles as key tiles, a (b, h)'s key tiles fitting the slots,
// whole (b, h) in rounds; else the list, dealt in rounds of equal size (the
// fewest that the slots allow). The flags, one per (b, h, query tile), are
// this launch's own: taken from the device's stream-ordered pool, zeroed and
// given back on the stream, so launches on any streams never share them.
// `args` are the kernel's arguments, among them &flags and &rounds, which
// this fills in. The grid goes out cooperatively: the runtime refuses a grid
// whose blocks cannot all be resident at once (a smaller share of the SMs
// under MPS, say), and the launch then fails instead of waiting forever.
template <typename Kernel>
cudaError_t launch_pair_grid(Kernel kernel, int n_slots, int Tq, int Tk, long long bh, int causal,
                             unsigned int*& flags, int& rounds, void** args,
                             cudaStream_t stream) {
  const long long ntq = (Tq + TILE - 1) / TILE, ntk = (Tk + TILE - 1) / TILE;
  rounds = !causal && ntq == ntk && ntk <= n_slots
               ? (int)(n_slots / ntk < bh ? n_slots / ntk : bh)
               : 0;
  const long long items = ntk * bh, list_rounds = (items + n_slots - 1) / n_slots;
  const unsigned grid = (unsigned)(rounds ? rounds * ntk : (items + list_rounds - 1) / list_rounds);
  const size_t flag_bytes = (size_t)(bh * ntq) * sizeof(unsigned int);
  flags = nullptr;
  cudaError_t err = cudaMallocAsync((void**)&flags, flag_bytes, stream);
  if (err != cudaSuccess) return err;
  err = cudaMemsetAsync(flags, 0, flag_bytes, stream);
  if (err == cudaSuccess)
    err = cudaLaunchCooperativeKernel((const void*)kernel, dim3(grid), dim3(THREADS), args,
                                      PAIR_SMEM, stream);
  const cudaError_t freed = cudaFreeAsync(flags, stream);
  return err != cudaSuccess ? err : freed;
}

// warps of `kernel` resident on one SM, from the occupancy calculator (its
// registers, shared memory and launch bounds); 0 on an error
template <typename Kernel>
int warps_per_sm(Kernel kernel, int smem, unsigned long long& configured) {
  int blocks = 0;
  if (configure_once(kernel, smem, configured) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, THREADS, smem) !=
          cudaSuccess)
    return 0;
  return blocks * WARPS;
}

}  // namespace f32
