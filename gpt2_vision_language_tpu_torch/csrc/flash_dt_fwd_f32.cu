// Flash-attention forward in the "dt" layout on fp32 operands for Hopper
// (sm_90a): q, k, v and o are (H, hs, B*T) fp32, the sequence contiguous and
// one slab of T positions per batch row; q arrives pre-scaled by 1/sqrt(hs);
// true fp32 products (FFMAs on the CUDA cores, no TF32), fp32 online softmax.
//
// Replaces the TPU kernel tools/ab_dt_flash.py _fwd_dt_kernel (launcher
// flash_fwd_dt_b) where it runs on fp32 operands, as the JAX tool's own
// --check runs it: its products take the operands' precision and o takes
// q's dtype. Same function as flash_dt_fwd.cu, the bf16 kernel: O =
// softmax(q^T k) v per (h, b) slab with an optional causal mask (query i
// sees keys <= i, no offset, also when Tq != Tk), and the per-query
// natural-log logsumexp as one fp32 row (H, B*Tq). Aligned shapes only,
// Tq % 64 == Tk % 64 == 0, as the bf16 kernel.
//
// What bounds it on the H100: the tensor cores take fp32 only as TF32 (10
// bits of mantissa against the JAX kernel's 23), so every product is an FFMA
// on the CUDA cores, 67 TFLOP/s at most (NVIDIA's data sheet, SXM, 700 W): at
// the A/B tool's shape (B=8, T=1024, H=12, hs=64, causal) 12.9 GFLOP, 0.19
// ms, against 0.03 ms for its 101 MB of q/k/v/o. Operations bound it, as
// they bound the fp32 self-attention forward (flash_fwd_f32.cu), whose
// function this is in another layout.
//
// What the design does about it: it is that kernel's forward block,
// instanced with Case::DT (flash_f32.cuh), so it keeps its 8 x 8
// outer-product register tiles, 128 query rows a block, the causal tile skip
// and two blocks an SM. The grid is what the card's waves want: a block a
// 128-row query tile, in (tile, h, b) order, is longest-first only inside
// each (b, h), and at the tool's shape its 768 sweeps of 2-16 key tiles keep
// the 264 resident slots about 73% busy (a list schedule). So the grid is
// one-dimensional, the longest query tiles first and (b, h) fastest, and
// where that still leaves the waves short each query tile's visible key
// tiles are cut into parts (the forward block's SPLIT, as K2a's fp32 kernel,
// flash_lse_fwd_f32.cu, cuts the right-aligned case): the wrapper picks the
// part count of least cost, the list schedule's makespan over the resident
// slots plus what the workspace and the merge add (tools/ab_dt_flash.py
// dt_f32_parts, fitted to forced counts on the card). A query tile of one part writes
// o and lse directly; the parts of the others leave their unnormalised o,
// running max m and row sum l in a workspace laid out as o is, by channel
// ((items, 64, 128) and (items, 2, 128) fp32, which the wrapper allocates),
// and a second kernel merges them in part order,
//   M = max_p m_p,  L = sum_p l_p exp(m_p - M),
//   o = sum_p o_p exp(m_p - M) / L,  lse = M + log L,
// reading and writing 16-byte runs of positions, so o and lse are bit-equal
// from run to run. The layout changes the loads and the stores only:
//   - q^T, the resident tile, arrives d-major: a straight 16-byte copy;
//   - the K and V tiles that the block sweeps are wanted [key][channel], the
//     transpose of what the layout holds, so each element is copied by its
//     own 4-byte cp.async into its transposed place, still asynchronously
//     into the other slot while a tile is computed on (a warp reads 32
//     contiguous bytes of four channels and writes 32 distinct banks);
//   - o leaves by channel, two 16-byte stores of a thread's 8 consecutive
//     positions; lse as one row a head.
// A block holds 128 query rows and T need only be a multiple of 64, so a
// sequence's last block may cover 64 rows past T: those rows load as zeros,
// sweep the keys of their own slab only, and are neither written nor merged.
// A row past Tk (Tq > Tk, causal) sees every key; the sweep stops at Tk. The
// mask has no offset, so the last query tile sees the most key tiles:
// ceil(Tk / 64) without the mask, min(Tq, Tk) / 64 under it.

#include <cuda_runtime.h>

#include "flash_f32.cuh"

namespace {

using namespace f32;

constexpr int MERGE_THREADS = 256;  // a thread: 4 positions of one channel

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_dt_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ o,
                        float* __restrict__ lse, int Tq, int Tk, int H, long long nq,
                        long long nk, int causal, FwdSplit sp) {
  // dt strides: a slab of T positions a sequence, B*T the channel stride
  forward_block<Case::DT, true>(q, k, v, o, lse, Tq, Tk, H, Tq, nq, HS * nq, Tk, nk, HS * nk,
                                Tk, nk, HS * nk, causal, sp);
}

// Thread (b, h), channel c, positions t .. t + 3 of the merge: the parts of a
// query tile of several, in part order; query tiles of one part were written
// whole. Consecutive threads take consecutive positions of one channel.
__global__ void __launch_bounds__(MERGE_THREADS)
flash_dt_merge_f32_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                          float* __restrict__ o, float* __restrict__ lse, int B, int Tq, int Tk,
                          int H, int causal, int parts, int chunk) {
  const long long g = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
  const int groups = Tq / 4;
  const long long row = g / groups;  // (b, h) * HS + c
  if (row >= (long long)B * H * HS) return;
  const int t = (int)(g % groups) * 4, c = (int)(row % HS), bh = (int)(row / HS);
  const int qt = t / FWD_BQ, r = t % FWD_BQ, ntq = (Tq + FWD_BQ - 1) / FWD_BQ;
  const int np = (visible_key_tiles<Case::DT>(qt, Tq, Tk, causal) + chunk - 1) / chunk;
  if (np == 1) return;
  const int BH = B * H;
  // item of part p: ((ntq - 1 - qt) parts + p) BH + bh
  const long long item0 = (long long)(ntq - 1 - qt) * parts * BH + bh;
  float4 mx = make_float4(NEG_BIG, NEG_BIG, NEG_BIG, NEG_BIG);
  for (int p = 0; p < np; ++p) {
    const float4 m =
        *reinterpret_cast<const float4*>(ws_ml + (item0 + (long long)p * BH) * 2 * FWD_BQ + r);
    mx = make_float4(fmaxf(mx.x, m.x), fmaxf(mx.y, m.y), fmaxf(mx.z, m.z), fmaxf(mx.w, m.w));
  }
  float4 l = make_float4(0.f, 0.f, 0.f, 0.f), acc = l;
  for (int p = 0; p < np; ++p) {
    const long long item = item0 + (long long)p * BH;
    const float* ml = ws_ml + item * 2 * FWD_BQ + r;
    const float4 m = *reinterpret_cast<const float4*>(ml);
    const float4 s = *reinterpret_cast<const float4*>(ml + FWD_BQ);
    const float4 x = *reinterpret_cast<const float4*>(ws_o + (item * HS + c) * FWD_BQ + r);
    const float4 w = make_float4(expf(m.x - mx.x), expf(m.y - mx.y), expf(m.z - mx.z),
                                 expf(m.w - mx.w));
    l = make_float4(fmaf(s.x, w.x, l.x), fmaf(s.y, w.y, l.y), fmaf(s.z, w.z, l.z),
                    fmaf(s.w, w.w, l.w));
    acc = make_float4(fmaf(x.x, w.x, acc.x), fmaf(x.y, w.y, acc.y), fmaf(x.z, w.z, acc.z),
                      fmaf(x.w, w.w, acc.w));
  }
  const int b = bh / H, hh = bh % H;
  const long long nq = (long long)B * Tq, pos = (long long)b * Tq + t;
  *reinterpret_cast<float4*>(o + ((long long)hh * HS + c) * nq + pos) =
      make_float4(acc.x / l.x, acc.y / l.y, acc.z / l.z, acc.w / l.w);
  if (c == 0)
    *reinterpret_cast<float4*>(lse + hh * nq + pos) =
        make_float4(mx.x + logf(l.x), mx.y + logf(l.y), mx.z + logf(l.z), mx.w + logf(l.w));
}

unsigned long long configured = 0;  // a bit per device: the kernel's attributes are set
int slots_of_device[64];            // per device: the blocks resident at once, 0 until counted

}  // namespace

// q, o: contiguous (H, hs, B*Tq) fp32; k, v: contiguous (H, hs, B*Tk) fp32;
// lse: contiguous (H, B*Tq) fp32. Tq and Tk multiples of 64, base pointers
// 16-byte aligned (checked by the Python wrapper). parts: the work items a
// query tile of 128 rows (1: the unsplit sweep, no workspace, no merge); ws:
// with parts > 1, a 16-byte aligned fp32 workspace of
// B * H * ceil(Tq / 128) * parts * 128 * (hs + 2) floats. One or two launches
// on `stream`; returns the CUDA error code (0 on success).
extern "C" int gpt2vl_flash_dt_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                       void* lse, void* ws, int B, int Tq, int Tk, int H, int hs,
                                       int causal, int parts, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || Tq % TILE || Tk % TILE ||
      B > 65535 || H > 65535 || parts < 1 || (parts > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure_once(flash_dt_fwd_f32_kernel, (int)sizeof(FwdSmem), configured);
  if (err != cudaSuccess) return (int)err;
  const long long ntq = (Tq + FWD_BQ - 1) / FWD_BQ, bh = (long long)B * H;
  const long long items = ntq * parts * bh, threads = bh * HS * (Tq / 4);
  if (items > 0x7fffffffll || threads / MERGE_THREADS > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  // the most key tiles a query tile sees (the last one's): parts of at most
  // chunk tiles
  const int max_vis = causal && Tq < Tk ? Tq / TILE : Tk / TILE;
  const int chunk = (max_vis + parts - 1) / parts;
  float* wo = (float*)ws;
  FwdSplit sp{(int)bh, parts, chunk, wo, wo ? wo + items * HS * FWD_BQ : nullptr};
  const cudaStream_t s = (cudaStream_t)stream;
  flash_dt_fwd_f32_kernel<<<dim3((unsigned)items), THREADS, sizeof(FwdSmem), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, Tq, Tk, H,
      (long long)B * Tq, (long long)B * Tk, causal, sp);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  flash_dt_merge_f32_kernel<<<(unsigned)((threads + MERGE_THREADS - 1) / MERGE_THREADS),
                              MERGE_THREADS, 0, s>>>(sp.ws_o, sp.ws_ml, (float*)o, (float*)lse,
                                                     B, Tq, Tk, H, causal, parts, chunk);
  return (int)cudaGetLastError();
}

// The blocks of the kernel that the current device keeps resident at once
// (SMs times blocks an SM, from the occupancy calculator): the slots the
// wrapper balances the parts over. 0 on an error.
extern "C" int gpt2vl_flash_dt_fwd_f32_slots() {
  int n = 0;
  return resident_slots(flash_dt_fwd_f32_kernel, (int)sizeof(FwdSmem), configured,
                        slots_of_device, &n) == cudaSuccess ? n : 0;
}

// Warps of this kernel resident on one SM, from the occupancy calculator;
// 0 on an error.
extern "C" int gpt2vl_flash_dt_fwd_f32_warps_per_sm() {
  return warps_per_sm(flash_dt_fwd_f32_kernel, (int)sizeof(FwdSmem), configured);
}
