// Fused LM-head + cross-entropy forward for Hopper (sm_90a).
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/fused_ce.py
// _ce_fwd_kernel (launcher _ce_fwd_pallas). Same function: for each row n,
// lse[n] = logsumexp_v(x[n] . w[v]) over all V rows of w and nll[n] = lse[n] -
// x[n] . w[t[n]], with the logits kept in fp32 and never written to device
// memory. bf16 x (N, D) and w (V, D), contiguous; N, V and D ragged (D % 8 ==
// 0, the 16-byte row stride TMA needs).
//
// What bounds it on the H100: at N=8192, D=768, V=50304 the product is
// 633 GFLOP while x and w are 12.6 MB and 77 MB, so the tensor cores bound it
// (0.640 ms at 989 TFLOP/s); the 412 M exponentials of the epilogue are about
// 0.03 ms on the special-function units. The plain version writes and reads
// back 1.6 GB of fp32 logits.
//
// What the design does about it: a wgmma GEMM main loop with the row
// statistics as its epilogue (hopper.cuh holds the building blocks). A block
// owns 128 rows and a contiguous range of BN-column vocab tiles (the vocab
// split) and is three warpgroups. The producer thread streams 64-deep chunks
// of w (and of x) by TMA (2-D tensor maps, 128-byte swizzle; rows and columns
// past the matrices zero-filled) through a ring of STAGES slots with a full
// and an empty mbarrier each. Each of the two consumer warpgroups owns 64
// rows: both operands are K-major in memory (rows of D), so each chunk is
// four wgmma m64nBNk16 with A (x) and B (w) from shared memory and no
// transpose bit, one chunk's products kept in flight while the next one's
// slot is awaited. After the D/64 chunks of a tile the consumer folds its
// fp32 accumulator into a running (max, sum of exp, gold logit) per row in
// registers: the gold logit where the row's target falls in the tile (before
// the mask: a target past V reads a zero-filled 0, so its gold is 0), columns
// >= V masked to -inf on the last tile only, the max over a row's quad of
// threads by two shuffles, each exponential one FFMA and one ex2.approx. The
// ring holds each chunk's x and w tiles, 48 KB a slot, so the epilogue of a
// tile overlaps the next tile's loads, and the consumers take turns to issue
// each chunk's products (as the flash forward's consumers do), so one's
// epilogue overlaps the other's products: 0.6-1.0% less time on an H100. A
// second small kernel merges the per-split triples in split order, so the
// result is the same from run to run. BN = 256 (an m64n256 accumulator is 128
// registers of a consumer's 240) and x streamed beside w, read again from L2
// for every vocab tile: with the block's x resident instead (192 KB at
// D = 768, 128-wide tiles and two slots beside it) it ran 1.8 times as long on
// an H100. The splits are chosen by the wrapper (ops/fused_ce.py split_count)
// so that one wave of blocks covers the card where it can.

#include <math.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace hopper;

constexpr int BM = 128;        // rows per block, 64 per consumer
constexpr int BN = 256;        // vocab columns per tile
constexpr int BK = 64;         // depth of one chunk: 128 bytes of a row
constexpr int STAGES = 4;      // ring slots of 48 KB
constexpr int CONSUMERS = 2;   // consumer warpgroups
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr uint32_t STEP_BYTES = (BM + BN) * BK * 2;  // one chunk of x and of w
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

struct __align__(1024) Smem {
  bf16 x[STAGES][BM * BK];
  bf16 w[STAGES][BN * BK];
  uint64_t full[STAGES], empty[STAGES];
};
constexpr int SMEM = (int)sizeof(Smem) + 1024;  // + the alignment of the base
static_assert(SMEM <= 232448, "more shared memory than a block can have");

// Rows [blockIdx.x * BM, + BM) against vocab tiles [split * tiles_per_split,
// + tiles_per_split) of width BN; writes the split's (max in log2 units, sum
// of 2^(s log2 e - max), gold logit) of each row to part_m/l/g[split * N + row].
__global__ void __launch_bounds__(THREADS, 1)
ce_fwd_partial_kernel(const __grid_constant__ CUtensorMap mx,
                      const __grid_constant__ CUtensorMap mw, const int* __restrict__ targets,
                      float* __restrict__ part_m, float* __restrict__ part_l,
                      float* __restrict__ part_g, int N, int D, int V, int tiles_per_split) {
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
    int tgt[2];
    float m_i[2] = {-1e30f, -1e30f};  // running max, log2 units
    float l_i[2] = {0.f, 0.f};        // this thread's part of the running sum
    float g_i[2] = {0.f, 0.f};        // gold logit, natural units
#pragma unroll
    for (int r = 0; r < 2; ++r) tgt[r] = rowa + 8 * r < N ? targets[rowa + 8 * r] : -1;

    float acc[BN / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) acc[i] = 0.f;

    // the consumers take turns to issue each chunk's products, in a ring of
    // named barriers 1 and 2 (each between the two), so that one's epilogue
    // runs beside the other's products: consumer 1 lets consumer 0 go first,
    // and every turn hands over but the last turn of consumer 1, which nobody
    // waits for
    if (wg == 1) named_arrive(1, 2 * 128);
    int it = 0;
    for (int vt = vt0; vt < vt1; ++vt) {
      // the tile's logits: D/64 chunks, one chunk's products in flight while
      // the next chunk's slot is awaited
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

      // the row statistics of the tile
      const int v0 = vt * BN;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (tgt[r] >= v0 && tgt[r] < v0 + BN) {
#pragma unroll
          for (int i = 0; i < BN / 2; ++i)
            if (((i >> 1) & 1) == r && v0 + 8 * (i / 4) + col_l + (i & 1) == tgt[r])
              g_i[r] += acc[i];
        }
      }
      const bool ragged = v0 + BN > V;  // the last tile only
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        if (ragged && v0 + 8 * (i / 4) + col_l + (i & 1) >= V) acc[i] = -INFINITY;
        mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], acc[i]);
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m_i[r], mx[r] * LOG2E);
        l_i[r] *= ex2(m_i[r] - m_new);
        m_i[r] = m_new;
      }
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) {
        const int r = (i >> 1) & 1;
        l_i[r] += ex2(fmaf(acc[i], LOG2E, -m_i[r]));
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 1);
      l_i[r] += __shfl_xor_sync(0xffffffffu, l_i[r], 2);
      g_i[r] += __shfl_xor_sync(0xffffffffu, g_i[r], 1);
      g_i[r] += __shfl_xor_sync(0xffffffffu, g_i[r], 2);
      const int row = rowa + 8 * r;
      if (lane % 4 == 0 && row < N) {
        const long long idx = (long long)split * N + row;
        part_m[idx] = m_i[r];
        part_l[idx] = l_i[r];
        part_g[idx] = g_i[r];
      }
    }
  }
}

// the per-split triples of each row merged in split order
__global__ void ce_fwd_combine_kernel(const float* __restrict__ part_m,
                                      const float* __restrict__ part_l,
                                      const float* __restrict__ part_g, float* __restrict__ nll,
                                      float* __restrict__ lse, int N, int nsplit) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= N) return;
  float m = -1e30f;
  for (int s = 0; s < nsplit; ++s) m = fmaxf(m, part_m[(long long)s * N + row]);
  float l = 0.f, g = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const long long idx = (long long)s * N + row;
    l += part_l[idx] * exp2f(part_m[idx] - m);
    g += part_g[idx];
  }
  const float out = (m + log2f(l)) * LN2;
  lse[row] = out;
  nll[row] = out - g;
}

}  // namespace

// x: (N, D) bf16, w: (V, D) bf16, targets: (N,) int32, all contiguous, D % 8 == 0,
// base pointers 16-byte aligned. nll, lse: (N,) fp32. part: scratch of
// 3 * max_split * N fp32. A target outside [0, V) gets gold 0 (nll = lse).
// Encodes the maps, launches the kernel and the merge on `stream`; returns
// the first CUDA error code (0 on success).
extern "C" int gpt2vl_ce_fwd(const void* x, const void* w, const void* targets, void* nll,
                             void* lse, void* part, int N, int D, int V, int max_split,
                             void* stream) {
  if (N <= 0 || D <= 0 || V <= 0 || D % 8 != 0 || max_split <= 0)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mx, mw;
  if (!hopper_host::map_2d(&mx, x, N, D, BM) || !hopper_host::map_2d(&mw, w, V, D, BN))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = hopper_host::set_smem_once(ce_fwd_partial_kernel, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_vt = (V + BN - 1) / BN;
  const int want = max_split < n_vt ? max_split : n_vt;
  const int tiles_per_split = (n_vt + want - 1) / want;
  const int nsplit = (n_vt + tiles_per_split - 1) / tiles_per_split;  // no empty split
  float* pm = (float*)part;
  float* pl = pm + (long long)max_split * N;
  float* pg = pl + (long long)max_split * N;
  cudaStream_t st = (cudaStream_t)stream;
  ce_fwd_partial_kernel<<<dim3((N + BM - 1) / BM, nsplit), THREADS, SMEM, st>>>(
      mx, mw, (const int*)targets, pm, pl, pg, N, D, V, tiles_per_split);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ce_fwd_combine_kernel<<<(N + 255) / 256, 256, 0, st>>>(pm, pl, pg, (float*)nll, (float*)lse,
                                                          N, nsplit);
  return (int)cudaGetLastError();
}

// Rows per block and vocab columns per tile, for the wrapper's split count.
extern "C" int gpt2vl_ce_fwd_block_rows() { return BM; }
extern "C" int gpt2vl_ce_fwd_tile_cols() { return BN; }
