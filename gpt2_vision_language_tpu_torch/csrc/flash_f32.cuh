// Building blocks of the self-attention kernels on fp32 operands
// (flash_fwd_f32.cu, flash_bwd_f32.cu): every product an fp32 FFMA on the
// CUDA cores, from register tiles that a thread sums as outer products, fed
// from shared memory by 16-byte reads.
//
// Tiles in shared memory, hs = 64:
//   - a swept tile (the K and V tiles that a forward or dq block sweeps, the
//     q and dO tiles that a dk/dv block sweeps): 64 positions x 64 channels,
//     [position][channel], rows padded to LDT = 68 floats, copied from global
//     memory with cp.async (16 bytes a copy, rows at or past T zero-filled)
//     into one of two slots while the other slot is being computed on;
//   - a resident tile (q^T and dO^T of a forward or dq block, K^T and V^T of
//     a dk/dv block): d-major, [channel][position], transposed once when the
//     block starts;
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
#include <stdint.h>

namespace f32 {

constexpr int HS = 64;           // head size
constexpr int TILE = 64;         // positions of a swept tile
constexpr int LDT = HS + 4;      // row stride of a swept tile and of P / dS, in floats
constexpr int QK = 16;           // keys of a warp's P^T / dS^T quarter
constexpr float NEG_BIG = -1e30f;  // finite start of the running max

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

}  // namespace f32
