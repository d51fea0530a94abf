// Self-attention flash backward on fp32 operands for Hopper (sm_90a): dq, dk,
// dv from the saved lse, Tq == Tk = T, causal or not, T ragged; fp32
// q/k/v/o/dO, true fp32 products (FMAs on the CUDA cores, no TF32).
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _bwd_dt_kernel (launcher _bwd_dt) where it runs on fp32 operands: its
// products take the operands' precision, its outputs q.dtype. Same function as
// flash_bwd.cu, the bf16 kernel: with S = q k^T / sqrt(hs) (causal-masked),
// P = exp(S - lse) and D = rowsum(dO * O),
//   dV = P^T dO,  dS = P * (dO V^T - D),  dQ = dS K / sqrt(hs),  dK = dS^T Q / sqrt(hs).
// D comes from the small kernel at the top of this file (fp32 dO and O; the
// bf16 kernel's D pre-kernel reads bf16). q/k/v are read in their
// (B, T, H, hs) layout through strides, so the strided views of the fused QKV
// projection go in without a copy; o and dO are contiguous.
//
// What bounds it on the H100: the tensor cores take fp32 only as TF32, which
// keeps 10 bits of mantissa; the JAX kernel's fp32 products keep 23. So every
// product is an FFMA on the CUDA cores, 67 TFLOP/s at most (NVIDIA's data
// sheet, SXM, 700 W). At the training shape (B=8, T=1024, H=12, hs=64,
// causal) the five products of the visible pairs are 2 * 5 * B * H * T(T+1)/2
// * hs = 32.2 GFLOP, 0.48 ms, against 0.06 ms for the 201 MB of q/k/v/o/dO/
// dq/dk/dv: operations bound it, and the shared-memory reads that feed the
// FFMAs come next.
//
// What the design does about it (a simple kernel, right first; the layout of
// flash_fwd_f32.cu): one grid of two kinds of block of 256 threads, 16 x 16,
// each thread a 4 x 4 register tile. A dk/dv block owns 64 keys of one
// (b, h), keeps their K and V in shared memory and sweeps the 64-row query
// tiles from the diagonal on: S and dP as 4 x 4 register tiles from float4
// reads of q/k and dO/v rows, P and dS stored transposed (keys x rows) in
// shared memory, then dV += P^T dO and dK += dS^T Q into two 4 x 4 register
// tiles of (key, channel). A dq block owns 64 queries, keeps q and dO and
// sweeps the key tiles up to the diagonal: S, dP, dS as above, dS through
// shared memory, dQ += dS K into a 4 x 4 register tile. Seven products per
// visited pair where a one-pass block does five, but no atomics: dq, dk and dv
// are summed in a fixed order and are bit-equal from run to run, as the bf16
// kernel's are. Rows are padded to 68 floats against bank conflicts; causal
// tiles past the diagonal are skipped; in each (b, h) the dk/dv blocks come
// first, key tile 0 (the longest causal sweep) leading, then the dq blocks,
// the last query tile leading. Six tiles of 64 x 68 fp32 are 104 KB of shared
// memory: the kernel's limit is raised once per device.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HS = 64;        // head size the kernel is built for
constexpr int TILE = 64;      // query rows of a tile == keys of a tile (the diagonal is one tile)
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx keys / channels
constexpr int LD = HS + 4;    // row stride of the shared tiles, in floats

// a dk/dv block: K, V resident; a query tile of q and dO; P^T and dS^T
struct SmemDkv {
  float k[TILE][LD];
  float v[TILE][LD];
  float q[TILE][LD];
  float dO[TILE][LD];
  float pt[TILE][LD];   // P^T: [key][row]
  float dst[TILE][LD];  // dS^T: [key][row]
  float lse[TILE];
  float dd[TILE];
};

// a dq block: q, dO resident; a key tile of K and V; dS
struct SmemDq {
  float q[TILE][LD];
  float dO[TILE][LD];
  float k[TILE][LD];
  float v[TILE][LD];
  float ds[TILE][LD];  // dS: [row][key]
  float lse[TILE];
  float dd[TILE];
};

constexpr int SMEM = sizeof(SmemDkv) > sizeof(SmemDq) ? (int)sizeof(SmemDkv) : (int)sizeof(SmemDq);

struct Strides {
  long long sb, st, sh;
};

// rows row0 .. row0 + 63 of one (sequence, head) of a (B, T, H, hs) tensor
// into dst; rows at or past T are zeros
__device__ __forceinline__ void load_tile(float (*dst)[LD], const float* __restrict__ src,
                                          Strides s, int b, int h, int row0, int T, int tid) {
  const float* base = src + (long long)b * s.sb + (long long)h * s.sh;
#pragma unroll
  for (int i = 0; i < (TILE * HS / 4) / THREADS; ++i) {
    const int f = tid + i * THREADS;
    const int r = f >> 4, c4 = f & 15;
    const int t = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) val = __ldg(reinterpret_cast<const float4*>(base + (long long)t * s.st) + c4);
    *reinterpret_cast<float4*>(&dst[r][c4 * 4]) = val;
  }
}

// lse and D of rows row0 .. row0 + 63 of one (b, h); zeros past T
__device__ __forceinline__ void load_stats(float* lse_s, float* dd_s, const float* __restrict__ lse,
                                           const float* __restrict__ dd, long long bh, int row0,
                                           int T, int tid) {
  if (tid < TILE) {
    const int t = row0 + tid;
    lse_s[tid] = t < T ? lse[bh * T + t] : 0.f;
    dd_s[tid] = t < T ? dd[bh * T + t] : 0.f;
  }
}

// S = q k^T and dP = dO v^T for rows ty + 16 i, keys tx + 16 c
__device__ __forceinline__ void s_and_dp(const float (*q)[LD], const float (*k)[LD],
                                         const float (*dO)[LD], const float (*v)[LD],
                                         float sc[4][4], float dp[4][4], int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4; ++c) sc[i][c] = dp[i][c] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HS; d += 4) {
    float4 qa[4], kb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(&q[ty + 16 * i][d]);
#pragma unroll
    for (int c = 0; c < 4; ++c) kb[c] = *reinterpret_cast<const float4*>(&k[tx + 16 * c][d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sc[i][c] = fmaf(qa[i].x, kb[c].x, sc[i][c]);
        sc[i][c] = fmaf(qa[i].y, kb[c].y, sc[i][c]);
        sc[i][c] = fmaf(qa[i].z, kb[c].z, sc[i][c]);
        sc[i][c] = fmaf(qa[i].w, kb[c].w, sc[i][c]);
      }
#pragma unroll
    for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(&dO[ty + 16 * i][d]);
#pragma unroll
    for (int c = 0; c < 4; ++c) kb[c] = *reinterpret_cast<const float4*>(&v[tx + 16 * c][d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        dp[i][c] = fmaf(qa[i].x, kb[c].x, dp[i][c]);
        dp[i][c] = fmaf(qa[i].y, kb[c].y, dp[i][c]);
        dp[i][c] = fmaf(qa[i].z, kb[c].z, dp[i][c]);
        dp[i][c] = fmaf(qa[i].w, kb[c].w, dp[i][c]);
      }
  }
}

// P = exp(S / sqrt(hs) - lse) where visible, else 0, and dS = P (dP - D), in
// place of sc and dp
__device__ __forceinline__ void p_and_ds(float sc[4][4], float dp[4][4], const float* lse_s,
                                         const float* dd_s, int q0, int k0, int T, int causal,
                                         int tx, int ty) {
  const float scale = 0.125f;  // 1 / sqrt(64), exact
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qq = q0 + ty + 16 * i;
    const float l = lse_s[ty + 16 * i], dr = dd_s[ty + 16 * i];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int kk = k0 + tx + 16 * c;
      const bool masked = qq >= T || kk >= T || (causal && kk > qq);
      const float p = masked ? 0.f : expf(sc[i][c] * scale - l);
      sc[i][c] = p;
      dp[i][c] = p * (dp[i][c] - dr);
    }
  }
}

// acc[i][e] += sum_r a[ty + 16 i][r] * b[r][4 tx + e] over r < 64: the rows of
// a are keys (P^T, dS^T) or queries (dS), the rows of b the positions summed
__device__ __forceinline__ void acc_product(float acc[4][4], const float (*a)[LD],
                                            const float (*b)[LD], int tx, int ty) {
#pragma unroll 4
  for (int r = 0; r < TILE; r += 4) {
    float4 pa[4], vb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(&a[ty + 16 * i][r]);
#pragma unroll
    for (int j = 0; j < 4; ++j) vb[j] = *reinterpret_cast<const float4*>(&b[r + j][tx * 4]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i][0] = fmaf(pa[i].x, vb[0].x, acc[i][0]);
      acc[i][1] = fmaf(pa[i].x, vb[0].y, acc[i][1]);
      acc[i][2] = fmaf(pa[i].x, vb[0].z, acc[i][2]);
      acc[i][3] = fmaf(pa[i].x, vb[0].w, acc[i][3]);
      acc[i][0] = fmaf(pa[i].y, vb[1].x, acc[i][0]);
      acc[i][1] = fmaf(pa[i].y, vb[1].y, acc[i][1]);
      acc[i][2] = fmaf(pa[i].y, vb[1].z, acc[i][2]);
      acc[i][3] = fmaf(pa[i].y, vb[1].w, acc[i][3]);
      acc[i][0] = fmaf(pa[i].z, vb[2].x, acc[i][0]);
      acc[i][1] = fmaf(pa[i].z, vb[2].y, acc[i][1]);
      acc[i][2] = fmaf(pa[i].z, vb[2].z, acc[i][2]);
      acc[i][3] = fmaf(pa[i].z, vb[2].w, acc[i][3]);
      acc[i][0] = fmaf(pa[i].w, vb[3].x, acc[i][0]);
      acc[i][1] = fmaf(pa[i].w, vb[3].y, acc[i][1]);
      acc[i][2] = fmaf(pa[i].w, vb[3].z, acc[i][2]);
      acc[i][3] = fmaf(pa[i].w, vb[3].w, acc[i][3]);
    }
  }
}

// rows ty + 16 i of a 64-row tile starting at row0, channels 4 tx .. 4 tx + 3,
// times scale, into a contiguous (B, T, H, hs) output
__device__ __forceinline__ void store_tile(float* __restrict__ out, const float acc[4][4],
                                           float scale, int b, int h, int H, int row0, int T,
                                           int tx, int ty) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = row0 + ty + 16 * i;
    if (t < T)
      *reinterpret_cast<float4*>(out + (((long long)b * T + t) * H + h) * HS + tx * 4) =
          make_float4(acc[i][0] * scale, acc[i][1] * scale, acc[i][2] * scale,
                      acc[i][3] * scale);
  }
}

__device__ __forceinline__ void zero(float acc[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
}

// D = rowsum(dO * O) over contiguous (B, T, H, hs) fp32: 16 threads a row, one
// float4 each, D written (B, H, T)
__global__ void __launch_bounds__(THREADS)
rowdot_f32_kernel(const float* __restrict__ dO, const float* __restrict__ o,
                  float* __restrict__ dd, int T, int H, long long rows) {
  const long long r = (long long)blockIdx.x * (THREADS / 16) + (threadIdx.x >> 4);
  const int c4 = threadIdx.x & 15;
  float acc = 0.f;
  if (r < rows) {
    const float4 a = __ldg(reinterpret_cast<const float4*>(dO + r * HS) + c4);
    const float4 b = __ldg(reinterpret_cast<const float4*>(o + r * HS) + c4);
    acc = a.x * b.x;
    acc = fmaf(a.y, b.y, acc);
    acc = fmaf(a.z, b.z, acc);
    acc = fmaf(a.w, b.w, acc);
  }
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (c4 == 0 && r < rows) {
    const long long h = r % H, t = (r / H) % T, b = r / ((long long)H * T);
    dd[(b * H + h) * T + t] = acc;
  }
}

// Block x of (h, b): x < nt is the dk/dv block of key tile x, x >= nt the dq
// block of query tile 2 nt - 1 - x.
__global__ void __launch_bounds__(THREADS)
flash_bwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dO, const float* __restrict__ lse,
                     const float* __restrict__ dd, float* __restrict__ dq,
                     float* __restrict__ dk, float* __restrict__ dv, int T, int H, Strides qs,
                     Strides ks, Strides vs, int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nt = (T + TILE - 1) / TILE;
  const int h = blockIdx.y, b = blockIdx.z;
  const long long bh = (long long)b * H + h;
  const Strides os = {(long long)T * H * HS, (long long)H * HS, HS};  // dO, contiguous
  const float scale = 0.125f;
  float sc[4][4], dp[4][4];

  if ((int)blockIdx.x < nt) {
    // dk/dv block: keys kt * 64 .. + 63, query tiles from the diagonal on
    SmemDkv& s = *reinterpret_cast<SmemDkv*>(smem_raw);
    const int kt = blockIdx.x, k0 = kt * TILE;
    load_tile(s.k, k, ks, b, h, k0, T, tid);
    load_tile(s.v, v, vs, b, h, k0, T, tid);
    float acc_k[4][4], acc_v[4][4];
    zero(acc_k);
    zero(acc_v);
    for (int it = causal ? kt : 0; it < nt; ++it) {
      const int q0 = it * TILE;
      __syncthreads();  // the last tile's products are done with q, dO, P^T and dS^T
      load_tile(s.q, q, qs, b, h, q0, T, tid);
      load_tile(s.dO, dO, os, b, h, q0, T, tid);
      load_stats(s.lse, s.dd, lse, dd, bh, q0, T, tid);
      __syncthreads();
      s_and_dp(s.q, s.k, s.dO, s.v, sc, dp, tx, ty);
      p_and_ds(sc, dp, s.lse, s.dd, q0, k0, T, causal, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s.pt[tx + 16 * c][ty + 16 * i] = sc[i][c];
          s.dst[tx + 16 * c][ty + 16 * i] = dp[i][c];
        }
      __syncthreads();
      acc_product(acc_v, s.pt, s.dO, tx, ty);   // dV += P^T dO
      acc_product(acc_k, s.dst, s.q, tx, ty);   // dK += dS^T Q
    }
    store_tile(dk, acc_k, scale, b, h, H, k0, T, tx, ty);
    store_tile(dv, acc_v, 1.f, b, h, H, k0, T, tx, ty);
  } else {
    // dq block: queries qt * 64 .. + 63, key tiles up to the diagonal
    SmemDq& s = *reinterpret_cast<SmemDq*>(smem_raw);
    const int qt = 2 * nt - 1 - (int)blockIdx.x, q0 = qt * TILE;
    load_tile(s.q, q, qs, b, h, q0, T, tid);
    load_tile(s.dO, dO, os, b, h, q0, T, tid);
    load_stats(s.lse, s.dd, lse, dd, bh, q0, T, tid);
    float acc_q[4][4];
    zero(acc_q);
    const int n_kv = causal ? qt + 1 : nt;
    for (int j = 0; j < n_kv; ++j) {
      const int k0 = j * TILE;
      __syncthreads();  // the last tile's dS K is done with k and dS
      load_tile(s.k, k, ks, b, h, k0, T, tid);
      load_tile(s.v, v, vs, b, h, k0, T, tid);
      __syncthreads();
      s_and_dp(s.q, s.k, s.dO, s.v, sc, dp, tx, ty);
      p_and_ds(sc, dp, s.lse, s.dd, q0, k0, T, causal, tx, ty);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) s.ds[ty + 16 * i][tx + 16 * c] = dp[i][c];
      __syncthreads();
      acc_product(acc_q, s.ds, s.k, tx, ty);  // dQ += dS K
    }
    store_tile(dq, acc_q, scale, b, h, H, q0, T, tx, ty);
  }
}

}  // namespace

// dq, dk, dv: contiguous (B, T, H, hs) fp32; dd: (B, H, T) fp32 scratch that
// receives D; lse: contiguous (B, H, T) fp32 from the forward; o, dO:
// contiguous (B, T, H, hs) fp32. q/k/v: (B, T, H, hs) fp32 with unit stride on
// hs; strides in elements, each a multiple of 4, base pointers 16-byte aligned
// (checked by the Python wrapper). Two launches on `stream`, D then the
// backward. Returns the CUDA error code (0 on success).
extern "C" int gpt2vl_flash_bwd_f32(const void* q, const void* k, const void* v, const void* o,
                                    const void* dO, const void* lse, void* dd, void* dq,
                                    void* dk, void* dv, int B, int T, int H, int hs,
                                    long long qsb, long long qst, long long qsh,
                                    long long ksb, long long kst, long long ksh,
                                    long long vsb, long long vst, long long vsh,
                                    int causal, void* stream) {
  if (hs != HS || B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  // more than 48 KB of dynamic shared memory: raise the kernel's limit, once
  // per device
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!((configured >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(flash_bwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM);
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << dev;
  }
  const long long rows = (long long)B * T * H;
  const long long row_blocks = (rows + THREADS / 16 - 1) / (THREADS / 16);
  if (row_blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rowdot_f32_kernel<<<(unsigned)row_blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)dO, (const float*)o, (float*)dd, T, H, rows);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int nt = (T + TILE - 1) / TILE;
  flash_bwd_f32_kernel<<<dim3(2 * nt, H, B), THREADS, SMEM, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dO,
      (const float*)lse, (const float*)dd, (float*)dq, (float*)dk, (float*)dv, T, H,
      Strides{qsb, qst, qsh}, Strides{ksb, kst, ksh}, Strides{vsb, vst, vsh}, causal);
  return (int)cudaGetLastError();
}
