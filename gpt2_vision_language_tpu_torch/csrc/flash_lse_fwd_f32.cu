// Flash forward with logsumexp on fp32 operands for Hopper (sm_90a), split
// over the key range: a query length Tq and a key length Tk, either ragged, a
// right-aligned causal mask (query i sees the keys j <= i + Tk - Tq) or none;
// fp32 q/k/v, true fp32 products (FFMAs on the CUDA cores, no TF32), fp32
// online softmax, o + the natural-log lse.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _fwd_kernel (:197, K/V held in VMEM; pallas_call :323, the forward of
// flash_attention_with_lse) where it runs on fp32 operands (its products take
// the operands' precision, its output q.dtype, :294). Its caller is the ring:
// one call a chunk pair (ops/ring_attention.py), at B=1, Tq = Tk = 4096, H=12
// on the 124M ring of 4. The bf16 kernel of the same function is
// flash_lse_fwd.cu; K2b's fp32 kernel, flash_general_fwd_f32.cu, computes the
// same function whole, a block a query tile.
//
// What bounds it on the H100: 67 TFLOP/s of FFMAs at most (NVIDIA's data
// sheet, SXM, 700 W); at the ring's pair the two products of the visible
// pairs are 51.5 GFLOP unmasked (0.77 ms), 25.8 causal, against 0.02 ms for
// the bytes: operations bound it. The forward block (flash_f32.cuh) reaches
// 55% of that where its grid fills the card (K2b fp32 at T=16384: 1536
// blocks), but a block a 128-row query tile gives the pair 384 blocks for
// 2 x 132 resident slots, 1.45 waves: the busiest slots run two whole
// sweeps of 64 key tiles where the mean is 93 tile-steps, and the causal
// pair's longest sweep (64) is longer than its mean a slot (46.5). Either
// way the work balance is capped near 73%.
//
// What the design does about it: each query tile's visible key tiles are cut
// into `parts` parts of at most `chunk` tiles (the wrapper picks the fewest
// parts whose list schedule over the resident slots keeps them 90% busy,
// ops/flash_attention.py lse_f32_parts), one work item each, so no item is
// wholly masked and the items fill whole waves; the grid is one-dimensional,
// the longest query tiles first and (b, h) fastest. An item is the forward
// block's sweep over its part (flash_f32.cuh forward_block, SPLIT): a query
// tile of one part writes its o and lse as the unsplit kernel does; the
// parts of the others leave their unnormalised o, running max m and row sum l
// in a workspace of (items, 128, 64 + 2) fp32 that the wrapper allocates,
// and a second kernel merges them in part order,
//   M = max_p m_p,  L = sum_p l_p exp(m_p - M),
//   o = sum_p o_p exp(m_p - M) / L,  lse = M + log L,
// so o and lse are bit-equal from run to run. A part's rows that see none of
// its keys keep m = -1e30 and l = 0 and weigh 0; part 0 holds key 0, which
// every row sees.

#include <cuda_runtime.h>

#include "flash_f32.cuh"

namespace {

using namespace f32;

constexpr int MERGE_THREADS = 256;  // 16 rows of 16 float4 a block

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
flash_lse_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int Tq, int Tk, int H, long long qsb,
                         long long qst, long long qsh, long long ksb, long long kst,
                         long long ksh, long long vsb, long long vst, long long vsh, int causal,
                         FwdSplit sp) {
  forward_block<Case::GENERAL, true>(q, k, v, o, lse, Tq, Tk, H, qsb, qst, qsh, ksb, kst, ksh,
                                     vsb, vst, vsh, causal, sp);
}

// Thread (row t of (b, h), 4 channels c4) of the merge: the parts of a query
// tile of several, in part order; query tiles of one part were written whole
__global__ void __launch_bounds__(MERGE_THREADS)
flash_lse_merge_f32_kernel(const float* __restrict__ ws_o, const float* __restrict__ ws_ml,
                           float* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int H,
                           int causal, int BH, int parts, int chunk) {
  const long long g = (long long)blockIdx.x * MERGE_THREADS + threadIdx.x;
  const long long row = g >> 4;
  const int c4 = (int)(g & 15);
  if (row >= (long long)BH * Tq) return;
  const int bh = (int)(row / Tq), t = (int)(row % Tq);
  const int qt = t / FWD_BQ, r = t % FWD_BQ, ntq = (Tq + FWD_BQ - 1) / FWD_BQ;
  const int np = (visible_key_tiles<Case::GENERAL>(qt, Tq, Tk, causal) + chunk - 1) / chunk;
  if (np == 1) return;
  // item of part p: ((ntq - 1 - qt) parts + p) BH + bh
  const long long item0 = (long long)(ntq - 1 - qt) * parts * BH + bh;
  float mx = NEG_BIG;
  for (int p = 0; p < np; ++p)
    mx = fmaxf(mx, ws_ml[(item0 + (long long)p * BH) * 2 * FWD_BQ + r]);
  float l = 0.f;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int p = 0; p < np; ++p) {
    const long long item = item0 + (long long)p * BH;
    const float w = expf(ws_ml[item * 2 * FWD_BQ + r] - mx);
    l = fmaf(ws_ml[item * 2 * FWD_BQ + FWD_BQ + r], w, l);
    const float4 x = reinterpret_cast<const float4*>(ws_o + (item * FWD_BQ + r) * HS)[c4];
    acc = make_float4(fmaf(x.x, w, acc.x), fmaf(x.y, w, acc.y), fmaf(x.z, w, acc.z),
                      fmaf(x.w, w, acc.w));
  }
  const int b = bh / H, hh = bh % H;
  reinterpret_cast<float4*>(o + (((long long)b * Tq + t) * H + hh) * HS)[c4] =
      make_float4(acc.x / l, acc.y / l, acc.z / l, acc.w / l);
  if (c4 == 0) lse[(long long)bh * Tq + t] = mx + logf(l);
}

unsigned long long configured = 0;  // a bit per device: the kernel's attributes are set
int slots_of_device[64];            // per device: the blocks resident at once, 0 until counted

}  // namespace

// o: contiguous (B, Tq, H, hs) fp32; lse: contiguous (B, H, Tq) fp32. q:
// (B, Tq, H, hs), k/v: (B, Tk, H, hs), fp32 with unit stride on hs; strides
// in elements, each a multiple of 4, base pointers 16-byte aligned (checked
// by the Python wrapper). causal needs Tq <= Tk. parts: the work items a
// query tile of 128 rows (1: the unsplit sweep, no workspace, no merge);
// ws: with parts > 1, a 16-byte aligned fp32 workspace of
// B * H * ceil(Tq / 128) * parts * 128 * (hs + 2) floats. One or two launches
// on `stream`; returns the CUDA error code (0 on success).
extern "C" int gpt2vl_flash_lse_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                        void* lse, void* ws, int B, int Tq, int Tk, int H,
                                        int hs, long long qsb, long long qst, long long qsh,
                                        long long ksb, long long kst, long long ksh,
                                        long long vsb, long long vst, long long vsh, int causal,
                                        int parts, void* stream) {
  if (hs != HS || B <= 0 || Tq <= 0 || Tk <= 0 || H <= 0 || B > 65535 || H > 65535 ||
      (causal && Tq > Tk) || parts < 1 || (parts > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = configure_once(flash_lse_fwd_f32_kernel, (int)sizeof(FwdSmem), configured);
  if (err != cudaSuccess) return (int)err;
  const long long ntq = (Tq + FWD_BQ - 1) / FWD_BQ, bh = (long long)B * H;
  const long long items = ntq * parts * bh;
  if (items > 0x7fffffffll || bh * Tq * 16 / MERGE_THREADS > 0x7fffffffll)
    return (int)cudaErrorInvalidValue;
  // the last query row sees every key (the mask is right-aligned), so the
  // last query tile's parts are the longest: parts of at most chunk tiles
  const int max_vis = (Tk + TILE - 1) / TILE;
  const int chunk = (max_vis + parts - 1) / parts;
  float* wo = (float*)ws;
  FwdSplit sp{(int)bh, parts, chunk, wo, wo ? wo + items * FWD_BQ * HS : nullptr};
  const cudaStream_t s = (cudaStream_t)stream;
  flash_lse_fwd_f32_kernel<<<dim3((unsigned)items), THREADS, sizeof(FwdSmem), s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, Tq, Tk, H, qsb,
      qst, qsh, ksb, kst, ksh, vsb, vst, vsh, causal, sp);
  err = cudaGetLastError();
  if (err != cudaSuccess || parts == 1) return (int)err;
  const long long threads = bh * Tq * 16;
  flash_lse_merge_f32_kernel<<<(unsigned)((threads + MERGE_THREADS - 1) / MERGE_THREADS),
                               MERGE_THREADS, 0, s>>>(sp.ws_o, sp.ws_ml, (float*)o, (float*)lse,
                                                      Tq, Tk, H, causal, (int)bh, parts, chunk);
  return (int)cudaGetLastError();
}

// The blocks of the split kernel that the current device keeps resident at
// once (SMs times blocks an SM, from the occupancy calculator): the slots the
// wrapper balances the parts over. 0 on an error.
extern "C" int gpt2vl_flash_lse_fwd_f32_slots() {
  int n = 0;
  return resident_slots(flash_lse_fwd_f32_kernel, (int)sizeof(FwdSmem), configured,
                        slots_of_device, &n) == cudaSuccess ? n : 0;
}

// Warps of the split kernel resident on one SM, from the occupancy
// calculator; 0 on an error.
extern "C" int gpt2vl_flash_lse_fwd_f32_warps_per_sm() {
  return warps_per_sm(flash_lse_fwd_f32_kernel, (int)sizeof(FwdSmem), configured);
}
