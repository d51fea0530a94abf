// Self-attention flash forward on fp32 operands for Hopper (sm_90a): Tq == Tk
// = T, causal or not, T ragged; fp32 q/k/v, true fp32 products (FMAs on the
// CUDA cores, no TF32), fp32 online softmax, o + lse.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/flash_attention.py
// _fwd_dt_kernel (launcher _fwd_dt) where it runs on fp32 operands: its
// products take the operands' precision, its output q.dtype. Same function as
// flash_fwd.cu, the bf16 kernel: O = softmax(q k^T / sqrt(hs)) v with an
// optional causal mask, and the per-row natural-log logsumexp in fp32, written
// as that kernel writes it ((B, H, T), contiguous). It reads q/k/v in their
// (B, T, H, hs) layout through strides, so the strided views of the fused QKV
// projection go in without a copy.
//
// What bounds it on the H100: the tensor cores take fp32 only as TF32, which
// keeps 10 bits of mantissa; the JAX kernel's fp32 products keep 23. So every
// product is an FFMA on the CUDA cores, 67 TFLOP/s at most (NVIDIA's data
// sheet, SXM, 700 W): at the HellaSwag shape (B=32, T=1024, H=12, hs=64,
// causal) 2 * B * H * T(T+1) * hs = 51.6 GFLOP, 0.77 ms, against 0.12 ms for
// its 403 MB of q/k/v/o. Operations bound it, and the shared-memory reads
// that feed the FFMAs come next.
//
// What the design does about it (a simple kernel, right first): one block of
// 256 threads per (64-query tile, head, sequence); K/V tiles of 64 keys
// staged in shared memory, each thread a 4 x 4 register tile of S (rows
// ty + 16 i, keys tx + 16 j) from float4 reads of q and k rows (16 bytes a
// read, 64 FFMAs per eight reads), the online softmax in registers with the
// row max by shuffles over the 16 threads of a row, P through shared memory
// into a 4 x 4 register tile of O (rows ty + 16 i, channels 4 tx .. 4 tx + 3).
// Rows are padded to 68 floats, so the eight float4 reads of a quarter warp
// down a column group hit eight different bank groups. Causal tiles past the
// diagonal are skipped, and the query tiles run longest first.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int HS = 64;        // head size the kernel is built for
constexpr int BQ = 64;        // query rows a block
constexpr int BK = 64;        // keys a tile (== BQ: the causal diagonal is one tile)
constexpr int THREADS = 256;  // 16 x 16: ty picks rows, tx keys / channels
constexpr int LD = HS + 4;    // row stride of the shared tiles, in floats
constexpr float NEG_BIG = -1e30f;  // finite start of the running max

struct Smem {
  float q[BQ][LD];
  float k[BK][LD];
  float v[BK][LD];
  float p[BQ][LD];
};

// rows row0 .. row0 + 63 of one (sequence, head) of a (B, T, H, hs) tensor
// into dst; rows at or past T are zeros (a masked key's V must not carry NaN)
__device__ __forceinline__ void load_tile(float (*dst)[LD], const float* __restrict__ src,
                                          long long sb, long long st, long long sh, int b, int h,
                                          int row0, int T, int tid) {
  const float* base = src + (long long)b * sb + (long long)h * sh;
#pragma unroll
  for (int i = 0; i < (BQ * HS / 4) / THREADS; ++i) {
    const int f = tid + i * THREADS;
    const int r = f >> 4, c4 = f & 15;
    const int t = row0 + r;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t < T) val = __ldg(reinterpret_cast<const float4*>(base + (long long)t * st) + c4);
    *reinterpret_cast<float4*>(&dst[r][c4 * 4]) = val;
  }
}

__global__ void __launch_bounds__(THREADS)
flash_fwd_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, float* __restrict__ lse,
                     int T, int H, long long qsb, long long qst, long long qsh, long long ksb,
                     long long kst, long long ksh, long long vsb, long long vst, long long vsh,
                     int causal) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int qt = gridDim.x - 1 - blockIdx.x;  // the longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const float scale = 0.125f;  // 1 / sqrt(64), exact

  load_tile(s.q, q, qsb, qst, qsh, b, h, q0, T, tid);

  float m[4], l[4], acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_BIG;
    l[i] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
  }

  const int n_kv = causal ? qt + 1 : (T + BK - 1) / BK;
  for (int j = 0; j < n_kv; ++j) {
    const int k0 = j * BK;
    __syncthreads();  // the last tile's P V is done with k, v and p
    load_tile(s.k, k, ksb, kst, ksh, b, h, k0, T, tid);
    load_tile(s.v, v, vsb, vst, vsh, b, h, k0, T, tid);
    __syncthreads();

    // S = q k^T for rows ty + 16 i, keys tx + 16 c
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
#pragma unroll
    for (int d = 0; d < HS; d += 4) {
      float4 qa[4], kb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = *reinterpret_cast<const float4*>(&s.q[ty + 16 * i][d]);
#pragma unroll
      for (int c = 0; c < 4; ++c) kb[c] = *reinterpret_cast<const float4*>(&s.k[tx + 16 * c][d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          sc[i][c] = fmaf(qa[i].x, kb[c].x, sc[i][c]);
          sc[i][c] = fmaf(qa[i].y, kb[c].y, sc[i][c]);
          sc[i][c] = fmaf(qa[i].z, kb[c].z, sc[i][c]);
          sc[i][c] = fmaf(qa[i].w, kb[c].w, sc[i][c]);
        }
    }

    // scale, mask, online softmax; P into shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qq = q0 + ty + 16 * i;
      float mx = NEG_BIG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kk = k0 + tx + 16 * c;
        const bool masked = kk >= T || (causal && kk > qq);
        sc[i][c] = masked ? -INFINITY : sc[i][c] * scale;
        mx = fmaxf(mx, sc[i][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float corr = expf(m[i] - m_new);
      m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sc[i][c] - m_new);
        sum += p;
        s.p[ty + 16 * i][tx + 16 * c] = p;
      }
      l[i] = l[i] * corr + sum;  // this thread's share of the row sum
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] *= corr;
    }
    __syncthreads();

    // O += P V for rows ty + 16 i, channels 4 tx .. 4 tx + 3
#pragma unroll 4
    for (int c = 0; c < BK; c += 4) {
      float4 pa[4], vb[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = *reinterpret_cast<const float4*>(&s.p[ty + 16 * i][c]);
#pragma unroll
      for (int r = 0; r < 4; ++r) vb[r] = *reinterpret_cast<const float4*>(&s.v[c + r][tx * 4]);
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

  // the row sums over the 16 threads of a row; o = acc / l, lse = m + log l
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) l[i] += __shfl_xor_sync(0xffffffffu, l[i], off);
    const int qq = q0 + ty + 16 * i;
    if (qq < T) {
      const float4 out = make_float4(acc[i][0] / l[i], acc[i][1] / l[i], acc[i][2] / l[i],
                                     acc[i][3] / l[i]);
      *reinterpret_cast<float4*>(o + (((long long)b * T + qq) * H + h) * HS + tx * 4) = out;
      if (tx == 0) lse[((long long)b * H + h) * T + qq] = m[i] + logf(l[i]);
    }
  }
}

}  // namespace

// o: contiguous (B, T, H, hs) fp32; lse: contiguous (B, H, T) fp32.
// q/k/v: (B, T, H, hs) fp32 with unit stride on hs; strides in elements, each a
// multiple of 4, base pointers 16-byte aligned (checked by the Python wrapper).
// Returns the CUDA error code of the launch (0 on success).
extern "C" int gpt2vl_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                    void* lse, int B, int T, int H, int hs,
                                    long long qsb, long long qst, long long qsh,
                                    long long ksb, long long kst, long long ksh,
                                    long long vsb, long long vst, long long vsh,
                                    int causal, void* stream) {
  if (hs != HS || B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535)
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(Smem);
  // more than 48 KB of dynamic shared memory: raise the kernel's limit, once
  // per device
  static unsigned long long configured = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!((configured >> dev) & 1ull)) {
    err = cudaFuncSetAttribute(flash_fwd_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1ull << dev;
  }
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  flash_fwd_f32_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, (float*)lse, T, H, qsb, qst,
      qsh, ksb, kst, ksh, vsb, vst, vsh, causal);
  return (int)cudaGetLastError();
}
