"""Build and load the port's CUDA kernels.

Each ``tpu3d_torch/csrc/<name>.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface, at first use, and loaded with
``ctypes``. Each kernel names its own ``nvcc`` flags beside its C
signature. The library's file name carries a hash of its source and flags,
so an edited source is rebuilt and a stale library is never loaded.
Libraries go to ``build/kernels/`` at the root of the checkout (listed in
``.gitignore``). ``build_all`` starts one ``nvcc`` per source at once.

Every C entry returns ``cudaGetLastError()`` after its launches; ``check``
raises if that is not 0. ``LAUNCHES`` counts, per kernel, the calls that
launched it; only the wrappers add to it, at the launch.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]
# rounds every product and sum one by one, as the plain PyTorch version
# does: the kernels held to it bit for bit (one rounding difference moves an
# FPS pick or a neighbour) take it; fused_sa, held to a tolerance, contracts
# its multiply-adds
EXACT = ["-fmad=false"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
# each kernel library's entry point: (symbol, argtypes, extra nvcc flags)
KERNELS = {
    "fps3nn": ("tpu3d_fps3nn", [P, I, I, I, P, P, P, P], EXACT),
    "nearest_k": ("tpu3d_nearest_k", [P, P, I, I, I, I, F, P, P, P], EXACT),
    "three_interpolate": ("tpu3d_three_interpolate",
                          [P, P, P, I, I, I, I, P, P], EXACT),
    "fps": ("tpu3d_fps", [P, I, I, I, P, P], EXACT),
    "fused_sa": ("tpu3d_fused_sa",
                 [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P], []),
}

LAUNCHES = {name: 0 for name in KERNELS}
_loaded: dict[str, ctypes._CFuncPtr] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the card")


def _flags(name: str) -> list[str]:
    return [*NVCC_FLAGS, *KERNELS[name][2]]


def _lib_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(_flags(name)).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:12]}.so"


def _start(name: str, verbose: bool) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all at once. Returns the compiler output of each build
    (``verbose`` adds ptxas's registers, shared memory and spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {name: _start(name, verbose) for name in KERNELS
            if not _lib_path(name).exists()}
    logs, failed = {}, []
    for name, (proc, tmp, out) in jobs.items():
        logs[name], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}:\n{logs[name]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def kernel(name: str):
    """The ctypes entry point of kernel ``name``, built at first use."""
    fn = _loaded.get(name)
    if fn is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        symbol, argtypes, _ = KERNELS[name]
        fn = getattr(ctypes.CDLL(str(path)), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream (appended as the last
    argument), count the launch, and raise if the C entry reports an
    error."""
    fn = kernel(name)
    err = fn(*args, torch.cuda.current_stream().cuda_stream)
    LAUNCHES[name] += 1
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError_t {err}")


def check_cuda_tensor(t: torch.Tensor, name: str, dtype: torch.dtype,
                      ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of this dtype and
    rank: what every kernel takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
