"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process, all
started together, and the objects are linked into one shared library with
a plain C interface (no PyTorch headers, so the build takes seconds). The
library lands in ``build/kernels/`` at the repository root,
named by a hash of the sources, the shared headers (``csrc/*.cuh``) and
the flags, so an edited kernel is rebuilt
and an unchanged one is loaded as it is. A missing ``nvcc`` or a failed
build raises with the compiler's output; nothing falls back.

Pointers and the stream cross into C as ``c_void_p`` (a plain int would be
cut to 32 bits); each entry point returns the CUDA error code of its
launch, which the wrappers in ``ops/`` turn into an exception.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# entry point -> argument types (all return int: a cudaError_t)
SIGNATURES = {
    "gpt2vl_flash_fwd": [_P] * 5 + [_I] * 4 + [_L] * 9 + [_I, _P],
    "gpt2vl_flash_fwd_f32": [_P] * 5 + [_I] * 4 + [_L] * 9 + [_I, _P],
    "gpt2vl_ce_fwd": [_P] * 6 + [_I] * 4 + [_P],
    "gpt2vl_ce_fwd_block_rows": [],
    "gpt2vl_ce_fwd_tile_cols": [],
    "gpt2vl_flash_bwd": [_P] * 10 + [_I] * 4 + [_L] * 9 + [_I, _P],
    "gpt2vl_flash_general_fwd": [_P] * 5 + [_I] * 5 + [_L] * 9 + [_I, _P],
    "gpt2vl_flash_rowdot": [_P] * 3 + [_I] * 4 + [_P],
    "gpt2vl_flash_general_dq": [_P] * 7 + [_I] * 5 + [_L] * 9 + [_I, _P],
    "gpt2vl_flash_general_dkv": [_P] * 8 + [_I] * 5 + [_L] * 9 + [_I, _P],
    "gpt2vl_flash_lse_fwd": [_P] * 5 + [_I] * 5 + [_L] * 9 + [_I, _P],
    "gpt2vl_flash_fused_bwd": [_P] * 10 + [_I] * 5 + [_L] * 9 + [_I, _P],
    "gpt2vl_flash_dt_fwd": [_P] * 5 + [_I] * 6 + [_P],
    "gpt2vl_flash_dt_bwd": [_P] * 9 + [_I] * 6 + [_F, _P],
    "gpt2vl_adamw": [_P, _I, _L, _P, _P],
    "gpt2vl_adamw_chunk": [],
}


def find_nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the CUDA kernels cannot be built"
    )


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> list[Path]:
    return sorted(CSRC.glob("*.cuh"))


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libgpt2vl_kernels_{h.hexdigest()[:16]}.so"


def build() -> tuple[Path, float]:
    """Compile the kernels unless the library for these sources exists.
    Returns (library path, seconds spent compiling; 0.0 when cached). The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``<name>.log``."""
    so = library_path()
    if so.exists():
        return so, 0.0
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{so.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources()]
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    # one compiler per source, all running at once; then one link
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
                    for src, o in zip(sources(), objs))
    ]
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    link = [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
            "-o", str(tmp), *map(str, objs)]
    if all(rc == 0 for _, _, rc in logs):
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, proc.stdout + proc.stderr, proc.returncode))
    seconds = time.perf_counter() - t0
    for o in objs:
        o.unlink(missing_ok=True)
    report = "".join(f"$ {' '.join(cmd)}\n{out}" for cmd, out, _ in logs)
    failed = [(cmd, rc) for cmd, _, rc in logs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {failed[0][1]}): {' '.join(failed[0][0])}\n{report}"
        )
    so.with_suffix(".log").write_text(report)
    os.replace(tmp, so)
    return so, seconds


@functools.lru_cache(maxsize=None)
def load() -> ctypes.CDLL:
    """The kernel library, built if needed, with every entry point typed."""
    so, _ = build()
    lib = ctypes.CDLL(str(so))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check(err: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
