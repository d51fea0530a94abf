// AdamW update for Hopper (sm_90a): every fp32 leaf of a model in one launch.
//
// Replaces the TPU kernel gpt2_vision_language_tpu/ops/fused_adamw.py
// _adamw_kernel (launcher fused_adamw_leaf). Same arithmetic, in place on
// fp32 p, m and v: g *= clip_scale; m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g^2;
// p *= 1 - lr wd (when wd != 0); p -= lr (m / bc1) / (sqrt(v / bc2) + eps).
// The seven scalars [lr, beta1, beta2, eps, clip_scale, bc1, bc2] are read
// from device memory, as the TPU kernel reads them from SMEM, so a clip scale
// computed on the device needs no host read.
//
// What bounds it on the H100: 4 reads and 3 writes of 4 bytes per parameter
// and a few FLOPs, so HBM bandwidth (GPT-2 124M: 124M x 28 B = 3.5 GB per
// update, about 1.0 ms at 3.35 TB/s).
//
// What the design does about it: the TPU kernel takes one leaf per launch at
// sizes that are multiples of 128; GPT-2 124M has 148 leaves, many of them
// 768-float biases, which would be 148 tiny launches here. So one launch
// walks a device table of leaves (p, g, m, v, numel, wd). Each leaf is cut
// into chunks of CHUNK elements; a block finds the leaf of a chunk by binary
// search over the leaves' first-chunk indices and updates it with float4
// loads and stores (a scalar loop for a ragged tail or a misaligned leaf),
// blocks striding over all chunks. Any leaf size is taken.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 4096;  // elements per chunk (a multiple of 4)
constexpr int THREADS = 256;
constexpr int MAX_BLOCKS = 132 * 16;

struct Leaf {
  float* p;
  const float* g;
  float* m;
  float* v;
  long long n;       // elements
  long long chunk0;  // index of the leaf's first chunk
  float wd;
  int pad;
};
static_assert(sizeof(Leaf) == 56 && offsetof(Leaf, wd) == 48, "Leaf layout is shared with Python");

struct Scalars {
  float lr, b1, b2, eps, clip, bc1, bc2, wd;
};

__device__ __forceinline__ void adamw1(float& p, float g, float& m, float& v, const Scalars& s) {
  g = g * s.clip;
  m = s.b1 * m + (1.f - s.b1) * g;
  v = s.b2 * v + (1.f - s.b2) * g * g;
  const float mhat = m / s.bc1;
  const float vhat = v / s.bc2;
  if (s.wd != 0.f) p = p * (1.f - s.lr * s.wd);
  p = p - s.lr * mhat / (sqrtf(vhat) + s.eps);
}

__global__ void __launch_bounds__(THREADS)
adamw_kernel(const Leaf* __restrict__ leaves, int n_leaves, long long n_chunks,
             const float* __restrict__ scal) {
  Scalars s{scal[0], scal[1], scal[2], scal[3], scal[4], scal[5], scal[6], 0.f};
  for (long long c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    int lo = 0, hi = n_leaves - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (leaves[mid].chunk0 <= c) lo = mid; else hi = mid - 1;
    }
    const Leaf L = leaves[lo];
    s.wd = L.wd;
    const long long begin = (c - L.chunk0) * CHUNK;
    const long long end = min(begin + CHUNK, L.n);
    const bool aligned =
        ((uintptr_t)L.p | (uintptr_t)L.g | (uintptr_t)L.m | (uintptr_t)L.v) % 16 == 0;
    long long i = begin;
    if (aligned) {
      const long long vec_end = begin + ((end - begin) / 4) * 4;
      for (long long j = begin + 4 * threadIdx.x; j < vec_end; j += 4 * THREADS) {
        float4 p = *reinterpret_cast<const float4*>(L.p + j);
        const float4 g = *reinterpret_cast<const float4*>(L.g + j);
        float4 m = *reinterpret_cast<const float4*>(L.m + j);
        float4 v = *reinterpret_cast<const float4*>(L.v + j);
        adamw1(p.x, g.x, m.x, v.x, s);
        adamw1(p.y, g.y, m.y, v.y, s);
        adamw1(p.z, g.z, m.z, v.z, s);
        adamw1(p.w, g.w, m.w, v.w, s);
        *reinterpret_cast<float4*>(L.p + j) = p;
        *reinterpret_cast<float4*>(L.m + j) = m;
        *reinterpret_cast<float4*>(L.v + j) = v;
      }
      i = vec_end;
    }
    for (long long j = i + threadIdx.x; j < end; j += THREADS) {
      float p = L.p[j], m = L.m[j], v = L.v[j];
      adamw1(p, L.g[j], m, v, s);
      L.p[j] = p;
      L.m[j] = m;
      L.v[j] = v;
    }
  }
}

}  // namespace

// leaves: device array of n_leaves Leaf records (layout above), sorted by
// chunk0, covering chunks [0, n_chunks). scal: device fp32
// [lr, beta1, beta2, eps, clip_scale, bc1, bc2]. Returns the CUDA error code
// of the launch (0 on success).
extern "C" int gpt2vl_adamw(const void* leaves, int n_leaves, long long n_chunks,
                            const void* scal, void* stream) {
  if (n_leaves <= 0 || n_chunks <= 0) return (int)cudaErrorInvalidValue;
  const long long blocks = n_chunks < MAX_BLOCKS ? n_chunks : MAX_BLOCKS;
  adamw_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const Leaf*)leaves, n_leaves, n_chunks, (const float*)scal);
  return (int)cudaGetLastError();
}

extern "C" int gpt2vl_adamw_chunk() { return CHUNK; }
