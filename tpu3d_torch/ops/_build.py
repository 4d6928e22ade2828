"""Build and load the port's CUDA kernels.

Each ``tpu3d_torch/csrc/<source>.cu`` is compiled by ``nvcc`` into its own
shared library with a plain C interface, at first use, and loaded with
``ctypes``; a source may hold the entry points of several kernels (the
eval and the training forward of ``fused_sa``, each in its gather and its
slab form; the routed backward of both forms in ``fused_sa_bwd``; the
BatchNorm chain's training passes in ``fused_sa_bn``; FPS+3NN and the
long-row FPS alone in ``fps3nn``; each bf16 form in its f32
form's source, ``fused_sa`` including ``fused_sa_bf16.cuh``, but the
routed backward's, ``fused_sa_bwd_bf16``, which shares ``fused_sa_bwd.cuh``
with ``fused_sa_bwd``). Each source names its own ``nvcc``
flags. The library's file name carries a hash of its source, the
shared headers (``csrc/*.cuh``) and its flags, so an edited source is
rebuilt and a stale library is never loaded. Libraries go to
``build/kernels/`` at the root of the checkout (listed in ``.gitignore``).
``build_all`` starts one ``nvcc`` per source at once.

Every C entry first asks whether an error is already pending on its stream
(``csrc/launch_check.cuh``): a fault of an earlier asynchronous launch is
sticky, and ``cudaGetLastError()`` after this entry's own launch would
return it too. Such an error comes back as ``PENDING`` + its code, and
``launch`` raises it as pending before this launch, naming the port's last
kernel launched before it; otherwise the entry returns
``cudaGetLastError()`` after its launches, and ``launch`` raises if that is
not 0. ``LAUNCHES`` counts, per kernel, the calls that launched it; only the
wrappers add to it, at the launch. Several counters may share one C entry
where it replaces several TPU kernels (``fused_sa_slab`` and
``fused_sa_slab_bn``; the BatchNorm chain's statistics passes 1 and 2).
``BF16_LAUNCHES`` counts the bf16 forms (``BF16_KERNELS``: the eval
contract's and the training contract's, kernel 9's seven training passes
among them, beside their f32 forms in ``fused_sa_bn``) the same way, apart
from the f32 kernels.
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
# FPS pick or a neighbour) take it; fused_sa and its backward, held to a
# tolerance, contract their multiply-adds
EXACT = ["-fmad=false"]

P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float
L = ctypes.c_longlong
# each kernel's C entry point: (source in csrc/, symbol, argtypes)
KERNELS = {
    "fps3nn": ("fps3nn", "tpu3d_fps3nn", [P, I, I, I, I, I, I, P, P, P, P]),
    "fps_long": ("fps3nn", "tpu3d_fps_long", [P, I, I, I, I, I, I, P, P]),
    "three_nn": ("three_nn", "tpu3d_three_nn",
                 [P, P, P, I, I, I, P, P, P, P]),
    "nearest_k": ("nearest_k", "tpu3d_nearest_k",
                  [P, P, P, P, I, I, I, I, F, P, P, P, P]),
    "three_interpolate": ("three_interpolate", "tpu3d_three_interpolate",
                          [P, P, P, I, I, I, I, P, P]),
    "three_interpolate_bwd": ("three_interpolate_bwd",
                              "tpu3d_three_interpolate_bwd",
                              [P, P, P, P, I, I, I, I, P, P, P, L, P]),
    "fps": ("fps", "tpu3d_fps", [P, I, I, I, P, P]),
    "fused_sa": ("fused_sa", "tpu3d_fused_sa",
                 [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P]),
    "fused_sa_train": ("fused_sa", "tpu3d_fused_sa_train",
                       [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P, P,
                        P]),
    "fused_sa_bwd": ("fused_sa_bwd", "tpu3d_fused_sa_bwd",
                     [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I, P,
                      P, P, P, P, P, P, L, P]),
    "fused_sa_slab": ("fused_sa", "tpu3d_fused_sa_slab",
                      [P, P, P, P, I, I, I, I, I, I, I, P, P]),
    "fused_sa_slab_bn": ("fused_sa", "tpu3d_fused_sa_slab",
                         [P, P, P, P, I, I, I, I, I, I, I, P, P]),
    "fused_sa_slab_train": ("fused_sa", "tpu3d_fused_sa_slab_train",
                            [P, P, P, P, I, I, I, I, I, I, I, P, P, P, P]),
    "fused_sa_slab_bwd": ("fused_sa_bwd", "tpu3d_fused_sa_slab_bwd",
                          [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P, P,
                           P, P]),
    # the BatchNorm chain's training: three statistics passes (the last two
    # on one C entry, each counted apart), the final reduction, two backward
    # waves and the elementwise pass
    "fused_sa_bn_stats0": ("fused_sa_bn", "tpu3d_fused_sa_bn_stats0",
                           [P, L, I, P, P, P]),
    **{f"fused_sa_bn_stats{d}": ("fused_sa_bn", "tpu3d_fused_sa_bn_layer",
                                 [P, P, P, P, L, I, I, P, P, P, P])
       for d in (1, 2)},
    "fused_sa_bn_final": ("fused_sa_bn", "tpu3d_fused_sa_bn_final",
                          [P, P, P, L, I, I, P, P, P, P]),
    "fused_sa_bn_wave1": ("fused_sa_bn", "tpu3d_fused_sa_bn_wave1",
                          [P, P, P, P, P, P, L, I, I, I, I, P, P, P, P, P,
                           P]),
    "fused_sa_bn_wave2": ("fused_sa_bn", "tpu3d_fused_sa_bn_wave2",
                          [P, P, P, P, P, L, I, I, I, P, P, P, P, P, P]),
    "fused_sa_bn_apply": ("fused_sa_bn", "tpu3d_fused_sa_bn_apply",
                          [P, P, P, L, I, P]),
    # no TPU kernel: the grouping gather's backward in a fixed order
    "group_points_bwd": ("group_points_bwd", "tpu3d_group_points_bwd",
                         [P, P, I, I, I, I, I, P, P, L, P]),
}
# the bf16 forms under the accelerator's numerics contracts (precision.py),
# eval and training, beside their f32 kernels in the same libraries (the
# routed backward's bf16 form in a library of its own, built in parallel);
# counted apart, in BF16_LAUNCHES
BF16_KERNELS = {
    "three_interpolate_bf16": ("three_interpolate",
                               "tpu3d_three_interpolate_bf16",
                               [P, P, P, I, I, I, I, I, P, P]),
    "fused_sa_bf16": ("fused_sa", "tpu3d_fused_sa_bf16",
                      [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P]),
    "fused_sa_slab_bf16": ("fused_sa", "tpu3d_fused_sa_slab_bf16",
                           [P, P, P, P, P, I, I, I, I, I, I, P, P]),
    "fused_sa_slab_bn_bf16": ("fused_sa", "tpu3d_fused_sa_slab_bn_bf16",
                              [P, P, P, P, I, I, I, I, I, I, P, P]),
    # the training contract's forms: kernels 6 and 8 (forward and routed
    # backward), kernel 7, and the gather's fixed-order backward
    "fused_sa_train_bf16": ("fused_sa", "tpu3d_fused_sa_train_bf16",
                            [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P, P,
                             P, P]),
    "fused_sa_slab_train_bf16": ("fused_sa", "tpu3d_fused_sa_slab_train_bf16",
                                 [P, P, P, P, P, I, I, I, I, I, I, P, P, P,
                                  P]),
    "fused_sa_bwd_bf16": ("fused_sa_bwd_bf16", "tpu3d_fused_sa_bwd_bf16",
                          [P, P, P, P, P, P, P, P, P, I, I, I, I, I, I, I, I,
                           P, P, P, P, P, P, P, L, P]),
    "fused_sa_slab_bwd_bf16": ("fused_sa_bwd_bf16",
                               "tpu3d_fused_sa_slab_bwd_bf16",
                               [P, P, P, P, P, P, P, I, I, I, I, I, I, I, P,
                                P, P, P, P]),
    "three_interpolate_bwd_bf16": ("three_interpolate_bwd",
                                   "tpu3d_three_interpolate_bwd_bf16",
                                   [P, P, P, I, I, I, I, P, P, L, P]),
    "group_points_bwd_bf16": ("group_points_bwd",
                              "tpu3d_group_points_bwd_bf16",
                              [P, P, I, I, I, I, I, I, P, P, L, P]),
    # kernel 9's training form on bf16 slabs: the seven passes of the f32
    # form (the statistics passes 1 and 2 on one C entry), the same
    # arguments but apply's, which writes d_x0 into a bf16 slab of its own
    **{f"{name}_bf16": (source, f"{symbol}_bf16", argtypes)
       for name, (source, symbol, argtypes) in KERNELS.items()
       if name.startswith("fused_sa_bn_") and name != "fused_sa_bn_apply"},
    "fused_sa_bn_apply_bf16": ("fused_sa_bn", "tpu3d_fused_sa_bn_apply_bf16",
                               [P, P, P, L, I, P, P]),
}
# C entries that run part of a counted kernel's launch, called before it
# (not counted): (source, symbol, argtypes)
PARTS = {
    "fused_sa_bwd_plan": ("fused_sa_bwd", "tpu3d_fused_sa_bwd_plan",
                          [P, P, I, I, I, I, I, I, I, I, P, P, P]),
}
# extra nvcc flags of each source
SOURCE_FLAGS = {"fps3nn": EXACT, "nearest_k": EXACT, "three_nn": EXACT,
                "three_interpolate": EXACT, "three_interpolate_bwd": EXACT,
                "fps": EXACT, "fused_sa": [], "fused_sa_bwd": [],
                "fused_sa_bwd_bf16": [], "fused_sa_bn": [],
                "group_points_bwd": EXACT}
SOURCES = sorted(SOURCE_FLAGS)

# added to the code of an error that a C entry found pending before its
# launch (tpu3d::kPending)
PENDING = 1 << 16

LAUNCHES = {name: 0 for name in KERNELS}
BF16_LAUNCHES = {name: 0 for name in BF16_KERNELS}
_last_launch: str | None = None  # the port's last kernel launched
_loaded: dict[str, ctypes._CFuncPtr] = {}
_libs: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for counts in (LAUNCHES, BF16_LAUNCHES):
        for name in counts:
            counts[name] = 0


def _entry(name: str):
    """(source, symbol, argtypes) of a counted kernel, a bf16 form or a
    part."""
    return KERNELS.get(name) or BF16_KERNELS.get(name) or PARTS[name]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the "
                       "CUDA toolkit's nvcc on the machine with the card")


def _flags(source: str) -> list[str]:
    return [*NVCC_FLAGS, *SOURCE_FLAGS[source]]


def _lib_path(source: str) -> Path:
    h = hashlib.sha256((CSRC / f"{source}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(source)).encode())
    return BUILD_DIR / f"{source}-{h.hexdigest()[:12]}.so"


def _start(source: str, verbose: bool) -> tuple[subprocess.Popen, Path, Path]:
    out = _lib_path(source)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(source), *(["-Xptxas", "-v"] if verbose else []),
           "-o", str(tmp), str(CSRC / f"{source}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build_all(verbose: bool = False) -> dict[str, str]:
    """Compile every kernel library that is not built yet, one ``nvcc`` per
    source, all at once. Returns the compiler output of each build, by
    source (``verbose`` adds ptxas's registers, shared memory and
    spills)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {src: _start(src, verbose) for src in SOURCES
            if not _lib_path(src).exists()}
    logs, failed = {}, []
    for src, (proc, tmp, out) in jobs.items():
        logs[src], _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src}:\n{logs[src]}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built at first use."""
    lib = _libs.get(source)
    if lib is None:
        path = _lib_path(source)
        if not path.exists():
            build_all()
        lib = _libs[source] = ctypes.CDLL(str(path))
    return lib


def kernel(name: str):
    """The ctypes entry point of kernel ``name`` (or of a part, ``PARTS``),
    built at first use."""
    fn = _loaded.get(name)
    if fn is None:
        source, symbol, argtypes = _entry(name)
        fn = getattr(library(source), symbol)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _loaded[name] = fn
    return fn


def error_name(name: str, err: int) -> str:
    """The CUDA name of error code ``err``, from kernel ``name``'s
    library."""
    fn = library(_entry(name)[0]).tpu3d_error_name
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_char_p
    return fn(err).decode()


def current_stream() -> int:
    """The raw handle of the current CUDA stream. torch.cuda.current_stream()
    builds a Stream object first, several times the host time of the raw
    handle, and a small kernel's whole call is host-bound (PERF.md)."""
    return torch._C._cuda_getCurrentRawStream(torch.cuda.current_device())


def launch(name: str, *args) -> None:
    """Launch kernel ``name`` on the current stream (appended as the last
    argument), count the launch, and raise if the C entry reports an error:
    one that was pending before it, which an earlier launch left (not
    counted: this kernel did not run), or one of its own launch."""
    global _last_launch
    err = _call(name, args)
    (LAUNCHES if name in LAUNCHES else BF16_LAUNCHES)[name] += 1
    _last_launch = name
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"{error_name(name, err)} ({err})")


def launch_part(name: str, *args) -> None:
    """Run ``PARTS`` entry ``name``, the first calls of a counted kernel's
    launch, on the current stream; raise as ``launch`` does, count
    nothing."""
    err = _call(name, args)
    if err != 0:
        raise RuntimeError(f"CUDA kernel part {name} failed to launch: "
                           f"{error_name(name, err)} ({err})")


def _call(name: str, args) -> int:
    """Call entry ``name`` with the current stream appended -> its error
    code; raise one that was pending before it."""
    err = kernel(name)(*args, current_stream())
    if err >= PENDING:
        err -= PENDING
        raise RuntimeError(
            f"CUDA error {error_name(name, err)} ({err}) was pending before "
            f"the launch of {name}: earlier work on the card left it; the "
            f"port's last kernel launched before it was {_last_launch}")
    return err


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
