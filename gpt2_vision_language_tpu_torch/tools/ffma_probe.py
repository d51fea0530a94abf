"""What bounds an fp32 FFMA kernel on this card: the cost of a 16-byte shared
memory read by the addresses a quarter-warp asks for, and the fp32 rate that
cuBLAS reaches without TF32.

The fp32 self-attention pair (csrc/flash_fwd_f32.cu, csrc/flash_bwd_f32.cu)
feeds every FFMA from shared memory. Its thread tiles are chosen by two
readings that this tool takes on the card:

  - ``lds128_clocks``: SM clocks per warp-wide 16-byte read (LDS.128) from a
    kernel that does nothing else, for lanes that ask, per quarter-warp (8
    lanes), for one address, for two, for four, or for eight (the same eight
    in every quarter, or 32 addresses over the warp). A tile that reads one
    operand by broadcast and the other by distinct rows pays the two costs
    once each per pair of reads.
  - ``sgemm_tflops``: torch.mm of two (8192, 8192) fp32 matrices with TF32
    off, a yardstick of the FFMA rate a tuned kernel reaches; the bound of
    the pair counts the data sheet's 67 TFLOP/s.

Usage (on the card): python -m gpt2_vision_language_tpu_torch.tools.ffma_probe
Prints one JSON line with the card's name. Without a CUDA device it exits
with an error.
"""

from __future__ import annotations

import json
import subprocess
import sys

# one block of 1024 threads reads 16 float4 a loop step from an index that
# `pattern` sets per lane; rows of 17 float4 (68 floats) as in the kernels'
# padded tiles
LDS_SRC = r"""
#include <cstdio>
#include <cuda_runtime.h>
__global__ void lds(float* out, int pattern, int iters) {
  __shared__ float4 s[1024];
  for (int i = threadIdx.x; i < 1024; i += blockDim.x) s[i] = make_float4(i, i + 1, i + 2, i + 3);
  __syncthreads();
  const int lane = threadIdx.x & 31, q = lane >> 3;
  int idx = 0;                                                 // 0: one address a warp
  if (pattern == 1) idx = 2 * q;                               // one a quarter
  if (pattern == 2) idx = 2 * (2 * (q & 1) + ((lane >> 2) & 1));  // two a quarter
  if (pattern == 3) idx = 17 * (4 * (q >> 1) + (lane & 3));    // four rows a quarter
  if (pattern == 4) idx = 17 * (lane & 7);                     // eight rows, the same in each quarter
  if (pattern == 5) idx = lane;                                // 32 addresses
  idx += (threadIdx.x >> 5) * 32;
  float a0 = 0, a1 = 0, a2 = 0, a3 = 0;
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float4 v = s[(idx + j * 136 + (it & 1) * 4) & 1023];
      a0 += v.x; a1 += v.y; a2 += v.z; a3 += v.w;
    }
  }
  out[blockIdx.x * blockDim.x + threadIdx.x] = a0 + a1 + a2 + a3;
}
int main() {
  int sms = 0, khz = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, 0);
  cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, 0);
  float* out = nullptr;
  if (cudaMalloc(&out, (size_t)sms * 2 * 1024 * sizeof(float)) != cudaSuccess) return 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  const int iters = 4096, threads = 1024, blocks = sms * 2;
  const char* names[] = {"1_a_warp", "1_a_quarter", "2_a_quarter", "4_a_quarter",
                         "8_a_quarter_same_in_each", "32_a_warp"};
  printf("{");
  for (int p = 0; p < 6; ++p) {
    lds<<<blocks, threads>>>(out, p, 16);
    cudaEventRecord(a);
    lds<<<blocks, threads>>>(out, p, iters);
    cudaEventRecord(b);
    if (cudaEventSynchronize(b) != cudaSuccess) return 1;
    float ms = 0.f;
    cudaEventElapsedTime(&ms, a, b);
    const double reads = (double)blocks * threads / 32 * iters * 16;
    const double clocks = (double)ms * 1e-3 * khz * 1e3 * sms / reads;
    printf("%s\"%s\": %.4f", p ? ", " : "", names[p], clocks);
  }
  printf("}\n");
  return cudaGetLastError() == cudaSuccess ? 0 : 1;
}
"""


def lds_clocks(workdir) -> dict:
    """{addresses a quarter-warp asks for: SM clocks per warp LDS.128}, from
    LDS_SRC built with nvcc into ``workdir`` and run."""
    from gpt2_vision_language_tpu_torch import _build

    workdir.mkdir(parents=True, exist_ok=True)
    src, exe = workdir / "lds_probe.cu", workdir / "lds_probe"
    src.write_text(LDS_SRC)
    subprocess.run([_build.find_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-o", str(exe), str(src)], check=True, capture_output=True, timeout=300)
    run = subprocess.run([str(exe)], check=True, capture_output=True, text=True, timeout=300)
    return json.loads(run.stdout)


def sgemm_tflops(torch, n=8192, iters=5) -> float:
    """fp32 TFLOP/s of torch.mm on (n, n) operands with TF32 off, from CUDA
    events over ``iters`` products after a warm-up."""
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator("cuda").manual_seed(0)
    a = torch.randn(n, n, device="cuda", generator=g)
    b = torch.randn(n, n, device="cuda", generator=g)
    torch.mm(a, b)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        torch.mm(a, b)
    end.record()
    torch.cuda.synchronize()
    return 2 * n**3 * iters / (start.elapsed_time(end) * 1e-3) / 1e12


def main(argv=None) -> dict:
    import torch

    from gpt2_vision_language_tpu_torch import _build

    if not torch.cuda.is_available():
        raise SystemExit("ffma_probe: no CUDA device (the readings are the card's)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    out = {"lds128_clocks": lds_clocks(_build.BUILD_DIR.parent / "ffma_probe"),
           "sgemm_tflops": sgemm_tflops(torch), "card": smi.stdout.strip()}
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
