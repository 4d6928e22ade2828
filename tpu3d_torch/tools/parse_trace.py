"""Summarize a torch.profiler Chrome trace: device time per op, grouped
(counterpart of ``tpu3d/tools/parse_xplane.py``).

Reads the newest Chrome trace (``*.json``, ``*.json.gz``) under the given
directory, or the file itself: the ``profile/trace.json`` that the
training CLI writes with ``--profile``, or any ``export_chrome_trace``
file. It takes the device's events (kernels, memcpy and memset), sums
their durations per name, and prints the top ops by device time and a
rollup by bucket: each of the port's hand-written kernels by its
``csrc/`` source, cuBLAS / CUTLASS GEMMs, sorts, gather / scatter /
index, reductions, elementwise, copies and memsets, NCCL; anything else
under its own base name.

    python -m tpu3d_torch.tools.parse_trace TRACE_DIR_OR_FILE [--top 30]
        [--like NAME] [--steps 1]

A kernel's name in the trace is its demangled C++ name (``void
(anonymous namespace)::gather_kernel<float4, 2>(...)``) or the mangled
one; either way it is read down to the ``__global__`` function's own name,
and a port kernel is one of those defined in ``csrc/`` (outside torch's
``at::``), so that torch's ``vectorized_gather_kernel`` is not taken for
the port's ``gather_kernel``.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import re
from collections import defaultdict
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def port_kernel_sources() -> dict[str, str]:
    """``__global__`` function name -> its ``csrc/`` source, over the
    port's CUDA sources and shared headers."""
    out = {}
    for src in sorted(CSRC.glob("*.cu*")):
        for name in re.findall(
                r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\)?\s*)?"
                r"(\w+)\s*\(", src.read_text()):
            out[name] = f"csrc/{src.name}"
    return out


def _mangled_names(name: str) -> list[str]:
    """The nested names of an Itanium-mangled symbol: ``_ZN2at6native3fooE``
    -> ["at", "native", "foo"]."""
    i = 3 if name.startswith("_ZN") else 2
    out = []
    while i < len(name) and name[i].isdigit():
        j = i
        while j < len(name) and name[j].isdigit():
            j += 1
        n = int(name[i:j])
        out.append(name[j:j + n])
        i = j + n
    return out


def kernel_base(name: str) -> tuple[str, bool]:
    """(the function's own name, whether it is torch's: in ``at::`` or
    ``c10::``) of a trace's kernel name, demangled or mangled."""
    if name.startswith("_Z"):
        parts = _mangled_names(name)
        if not parts:
            return name, False
        return parts[-1], any(p in ("at", "c10") for p in parts[:-1])
    head = name.replace("(anonymous namespace)::", "").split("(")[0]
    head = re.sub(r"<.*", "", head).strip()
    base = head.split()[-1] if head else name
    torch_own = "at::" in base or "c10::" in base
    return base.rsplit("::", 1)[-1], torch_own


def find_trace(root: str) -> str:
    """``root`` if it is a file, else the newest Chrome trace under it."""
    if os.path.isfile(root):
        return root
    cands = [p for pat in ("*.json", "*.json.gz") for p in glob.glob(
        os.path.join(root, "**", pat), recursive=True)]
    if not cands:
        raise FileNotFoundError(f"no Chrome trace (*.json) under {root}")
    return max(cands, key=os.path.getmtime)


def load_device_ops(path: str) -> list[tuple[str, str, float, int]]:
    """The trace's device events summed per name -> [(category, name,
    total us, count)]."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    agg = defaultdict(lambda: [0.0, 0])
    for ev in events:
        cat = ev.get("cat", "")
        if ev.get("ph") != "X" or cat not in DEVICE_CATS:
            continue
        agg[(cat, ev["name"])][0] += float(ev.get("dur", 0.0))
        agg[(cat, ev["name"])][1] += 1
    return [(cat, name, us, n) for (cat, name), (us, n) in agg.items()]


_BUCKETS = [
    ("NCCL", re.compile(r"nccl", re.I)),
    ("GEMM (cuBLAS / CUTLASS)",
     re.compile(r"gemm|gemv|cutlass|cublas|xmma|splitKreduce", re.I)),
    ("sort", re.compile(r"sort", re.I)),
    ("gather / scatter / index",
     re.compile(r"gather|scatter|index", re.I)),
    ("reduction", re.compile(r"reduce|scan|norm_kernel", re.I)),
    ("elementwise", re.compile(r"elementwise", re.I)),
    ("copy / memset", re.compile(r"copy|memcpy|memset", re.I)),
]


def bucket(name: str, cat: str = "kernel",
           sources: dict[str, str] | None = None) -> str:
    """The rollup group of one device op: ``port <csrc/file>`` for the
    port's kernels, one of ``_BUCKETS`` by name, ``copy / memset`` for
    memcpy and memset events, else the kernel's base name."""
    if cat != "kernel":
        return "copy / memset"
    sources = port_kernel_sources() if sources is None else sources
    base, torch_own = kernel_base(name)
    if not torch_own and base in sources:
        return f"port {sources[base]}"
    for label, pat in _BUCKETS:
        if pat.search(name):
            return label
    return base


def port_kernel_counts(ops, sources: dict[str, str] | None = None) -> dict:
    """Launches of each port kernel in ``load_device_ops``'s list, by its
    ``__global__`` name."""
    sources = port_kernel_sources() if sources is None else sources
    counts = defaultdict(int)
    for cat, name, _, n in ops:
        base, torch_own = kernel_base(name)
        if cat == "kernel" and not torch_own and base in sources:
            counts[base] += n
    return dict(counts)


def main(argv=None) -> dict | None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trace_dir")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--like", default=None,
                    help="only ops whose name contains this substring")
    ap.add_argument("--steps", type=int, default=1,
                    help="number of profiled steps (divides totals)")
    args = ap.parse_args(argv)

    path = find_trace(args.trace_dir)
    print(f"# {path}")
    ops = load_device_ops(path)
    if not ops:
        print("no device events (kernels, memcpy, memset) in the trace")
        return None
    if args.like:
        ops = [o for o in ops if args.like in o[1]]
    total_ms = sum(o[2] for o in ops) / 1e3 / args.steps
    print(f"total device time: {total_ms:.2f} ms/step over {args.steps} "
          f"steps")

    print(f"\n## top {args.top} ops by self time")
    top = sorted(ops, key=lambda o: -o[2])[: args.top]
    for cat, name, us, cnt in top:
        ms = us / 1e3 / args.steps
        print(f"{ms:8.3f} ms  x{cnt:<4d} {name[:110]}")

    print("\n## grouped")
    sources = port_kernel_sources()
    groups = defaultdict(float)
    for cat, name, us, _ in ops:
        groups[bucket(name, cat, sources)] += us / 1e3 / args.steps
    ranked = sorted(groups.items(), key=lambda kv: -kv[1])[:20]
    for name, ms in ranked:
        print(f"{ms:8.3f} ms  {name}")
    return {"path": path, "total_ms": total_ms,
            "top": [(name, us / 1e3 / args.steps, cnt)
                    for _, name, us, cnt in top],
            "groups": dict(ranked),
            "port_counts": port_kernel_counts(ops, sources)}


if __name__ == "__main__":
    main()
