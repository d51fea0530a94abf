// Logits gradient of the fused LM-head + cross-entropy for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's backward of fused_linear_ce is XLA
// (gpt2_vision_language_tpu/ops/fused_ce.py _make._bwd), which recomputes each
// chunk's logits, forms p = (softmax - onehot) * g and casts it once to the
// compute dtype before the dx and dw products. On the H100 that recompute in
// plain PyTorch writes and reads fp32 logits several times over. This kernel
// computes, for one chunk of rows, the bf16 logits gradient
//   P[n, v] = bf16(exp(x[n] . w[v] - lse[n]) * g[n] - [v == t[n]] * g[n])
// with the logits kept in fp32 registers and never written to memory, lse
// being the forward kernel's (ce_fwd.cu). bf16 x (N, D) and w (V, D),
// contiguous; N and D ragged (D % 8 == 0, the 16-byte row stride TMA needs),
// V % 8 == 0 (P's rows start on 16 bytes, as the products that read it want).
//
// What bounds it on the H100: at N=2048, D=768, V=50304 (a chunk of 124M's
// training micro-batch) the product is 158 GFLOP, 0.160 ms at 989 TFLOP/s,
// while x, w and the bf16 P are 3 MB, 77 MB and 206 MB, 0.085 ms at
// 3.35 TB/s: the tensor cores bound it.
//
// What the design does about it: K4's main loop (ce_fwd.cu: the same tiles,
// warpgroups and turn-taking of the consumers) with P as its epilogue. A
// block owns 128 rows and a contiguous range of 256-column vocab tiles;
// after the D/64 chunks of a tile each consumer warpgroup turns its 64 x 256
// fp32 accumulator into P in registers (one FFMA and one ex2.approx an
// element, the scaling by g, the one-hot subtracted where the row's target
// falls in the tile), casts once to bf16, writes it to its own tile in
// shared memory (four 64 x 64 boxes in TMA's 128-byte swizzle, so a warp's
// writes meet no bank twice) and hands it to TMA, which stores it while the
// consumer goes on to the next tile; TMA leaves out rows >= N and columns
// >= V. The consumers take turns on the tensor cores, so a long epilogue
// stalls both: storing P from registers instead (a 4-byte pair of columns a
// thread, 8 rows a warp instruction) read 0.350 ms at N=2048, D=768,
// V=50304 on an H100, against 0.267 ms for this design. The ring has three
// 48 KB slots (K4 four) beside the two 32 KB tiles of P. Every
// output tile is written by one block and nothing is summed across blocks:
// no merge, no atomics, and P is the same from run to run. The wrapper
// (ops/fused_ce.py) sizes the vocab splits by K4's split_count so that the
// blocks fill whole waves of the 132 SMs.
//
// Why P goes through device memory: the dx and dw products stay cuBLAS
// products, as the JAX package leaves them to XLA. Fusing dx here would need
// a 128 x D fp32 accumulator beside the logits tile (384 registers a thread
// at D = 768); fusing dw a reduction of (V x D) across the row tiles. Writing
// P in bf16 costs 206 MB a chunk of 2048 rows, about 0.06 ms at 3.35 TB/s,
// beside about 0.5 ms for the chunk's three products.

#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BM = 128;        // rows per block, 64 per consumer
constexpr int BN = 256;        // vocab columns per tile
constexpr int BK = 64;         // depth of one chunk: 128 bytes of a row
constexpr int STAGES = 3;      // ring slots of 48 KB
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr uint32_t STEP_BYTES = (BM + BN) * BK * 2;  // one chunk of x and of w
constexpr float LOG2E = 1.4426950408889634f;

constexpr int PBOX = 64;       // a TMA box of P: 64 rows by 64 columns (128 bytes)

struct __align__(1024) Smem {
  bf16 x[STAGES][BM * BK];
  bf16 w[STAGES][BN * BK];
  bf16 p[CONSUMERS][BN / PBOX][PBOX * PBOX];  // each consumer's tile of P, four boxes
  uint64_t full[STAGES], empty[STAGES];
};
constexpr int SMEM = (int)sizeof(Smem) + 1024;  // + the alignment of the base
static_assert(SMEM <= 232448, "more shared memory than a block can have");

// Rows [blockIdx.x * BM, + BM) against vocab tiles [blockIdx.y *
// tiles_per_split, + tiles_per_split) of width BN; writes P of those rows and
// columns through the map mp.
__global__ void __launch_bounds__(THREADS, 1)
ce_bwd_kernel(const __grid_constant__ CUtensorMap mx, const __grid_constant__ CUtensorMap mw,
              const __grid_constant__ CUtensorMap mp, const int* __restrict__ targets,
              const float* __restrict__ lse, const float* __restrict__ g, int N, int D, int V,
              int tiles_per_split) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>((reinterpret_cast<uintptr_t>(smem_raw) + 1023) &
                                      ~uintptr_t(1023));

  const int tid = threadIdx.x, wg = tid / 128;
  const int row0 = (int)blockIdx.x * BM, split = (int)blockIdx.y;
  const int n_vt = (V + BN - 1) / BN;
  const int vt0 = split * tiles_per_split;
  const int vt1 = min(n_vt, vt0 + tiles_per_split);
  const int nk = (D + BK - 1) / BK;
  const int n_steps = (vt1 - vt0) * nk;  // (tile, chunk) steps through the ring

  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], CONSUMERS);
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (wg == CONSUMERS) {
    // producer: one thread keeps the ring full
    setmaxnreg_dec<24>();
    if (tid == CONSUMERS * 128) {
      tma_prefetch_map(&mx);
      tma_prefetch_map(&mw);
      for (int it = 0; it < n_steps; ++it) {
        const int s = it % STAGES, ph = (it / STAGES) & 1;
        const int vt = vt0 + it / nk, c = it % nk;
        mbar_wait(&sm.empty[s], ph ^ 1);
        mbar_expect_tx(&sm.full[s], STEP_BYTES);
        tma_load_2d(sm.x[s], &mx, &sm.full[s], c * BK, row0);
        tma_load_2d(sm.w[s], &mw, &sm.full[s], c * BK, vt * BN);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int t = tid % 128, warp = t / 32, lane = t % 32;
    const int col_l = 2 * (lane % 4);  // first column in an n8 block
    const int rowa = row0 + wg * 64 + warp * 16 + lane / 4;  // its rows: rowa and rowa + 8
    // byte offset of its first row in a box of P; the 16-byte chunk c of box
    // row rl sits at chunk c ^ (rl % 8), and rl % 8 = lane / 4 for both rows
    const int prow = (warp * 16 + lane / 4) * 128 + 4 * (lane % 4);
    int tgt[2];
    float lz[2], gr[2];  // lse in log2 units, and the row's cotangent
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rowa + 8 * r;
      const bool in = row < N;
      tgt[r] = in ? targets[row] : -1;
      lz[r] = in ? lse[row] * LOG2E : 0.f;
      gr[r] = in ? g[row] : 0.f;
    }

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    // the consumers take turns to issue each chunk's products, as in
    // ce_fwd.cu: a ring of named barriers 1 and 2, consumer 1 lets consumer
    // 0 go first, and every turn hands over but the last turn of consumer 1
    if (wg == 1) named_arrive(1, 2 * 128);
    int it = 0;
    for (int vt = vt0; vt < vt1; ++vt) {
      for (int c = 0; c < nk; ++c, ++it) {
        const int s = it % STAGES;
        mbar_wait(&sm.full[s], (it / STAGES) & 1);
        reg_fence(acc);
        wg_fence();
        const uint64_t da = desc_sw128(sm.x[s] + wg * 64 * BK);
        const uint64_t db = desc_sw128(sm.w[s]);
        named_sync(1 + wg, 2 * 128);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          mma_m64n256_ss(acc, desc_add(da, 32 * kk), desc_add(db, 32 * kk), c > 0 || kk > 0);
        wg_commit();
        if (!(wg == 1 && it == n_steps - 1)) named_arrive(2 - wg, 2 * 128);
        if (c > 0) {
          wg_wait<1>();  // the previous chunk's products are done: release its slot
          reg_fence(acc);
          if (t == 0) mbar_arrive(&sm.empty[(it - 1) % STAGES]);
        }
      }
      wg_wait<0>();
      reg_fence(acc);
      if (t == 0) mbar_arrive(&sm.empty[(it - 1) % STAGES]);

      // P of the tile: exp(s - lse) g, less g at the target's column
      const int v0 = vt * BN;
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        acc[i] = ex2(fmaf(acc[i], LOG2E, -lz[r])) * gr[r];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (tgt[r] >= v0 && tgt[r] < v0 + BN) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            if (((i >> 1) & 1) == r && v0 + 8 * (i / 4) + col_l + (i & 1) == tgt[r])
              acc[i] -= gr[r];
        }
      }
      // the previous tile's store has read the consumer's tile of P
      if (t == 0) bulk_wait_read<0>();
      named_sync(3 + wg, 128);
      unsigned char* pt = reinterpret_cast<unsigned char*>(sm.p[wg]);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int r = 0; r < 2; ++r)
          *reinterpret_cast<uint32_t*>(pt + (j / 8) * PBOX * PBOX * 2 + prow + r * 8 * 128 +
                                       (((j % 8) ^ (lane / 4)) * 16)) =
              pack_bf16(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
      fence_proxy_async();
      named_sync(3 + wg, 128);
      if (t == 0) {
#pragma unroll
        for (int b = 0; b < BN / PBOX; ++b)
          tma_store_2d(&mp, sm.p[wg][b], v0 + b * PBOX, row0 + wg * 64);
        bulk_commit();
      }
    }
    if (t == 0) bulk_wait<0>();
  }
}

}  // namespace

// x: (N, D) bf16, w: (V, D) bf16, targets: (N,) int32, lse and g: (N,) fp32,
// all contiguous, D % 8 == 0, V % 8 == 0, x and w 16-byte aligned. p: (N, V)
// bf16, contiguous. A target outside [0, V) subtracts nothing. At most
// max_split vocab splits. Encodes the maps and launches on `stream`; returns
// the first CUDA error code (0 on success).
extern "C" int gpt2vl_ce_bwd(const void* x, const void* w, const void* targets, const void* lse,
                             const void* g, void* p, int N, int D, int V, int max_split,
                             void* stream) {
  if (N <= 0 || D <= 0 || V <= 0 || D % 8 != 0 || V % 8 != 0 || max_split <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw, mp;
  if (!hopper_host::map_2d(&mx, x, N, D, BM) || !hopper_host::map_2d(&mw, w, V, D, BN) ||
      !hopper_host::map_2d(&mp, p, N, V, PBOX))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = hopper_host::set_smem_once(ce_bwd_kernel, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_vt = (V + BN - 1) / BN;
  const int want = max_split < n_vt ? max_split : n_vt;
  const int tiles_per_split = (n_vt + want - 1) / want;
  const int nsplit = (n_vt + tiles_per_split - 1) / tiles_per_split;  // no empty split
  ce_bwd_kernel<<<dim3((N + BM - 1) / BM, nsplit), THREADS, SMEM, (cudaStream_t)stream>>>(
      mx, mw, mp, (const int*)targets, (const float*)lse, (const float*)g, N, D, V,
      tiles_per_split);
  return (int)cudaGetLastError();
}
