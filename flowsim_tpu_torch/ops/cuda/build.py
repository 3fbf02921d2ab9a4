"""Build and load the CUDA kernels of the port.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for ``sm_90a``
into ``build/flowsim_tpu_torch/lib<name>-<hash>.so`` (under the current
working directory, or ``$FLOWSIM_TORCH_BUILD_DIR``) and loaded with
``ctypes`` — a plain C interface, no PyTorch headers, so a build takes
seconds.  The hash covers the source, the headers beside it and the flags:
a changed source rebuilds, an unchanged one is reused.  A failed build
raises; nothing falls back to a plain PyTorch version.

``--fmad=false``: nvcc contracts ``a*b+c`` into a fused multiply-add by
default, the plain PyTorch versions do not.  With contraction off a kernel
and its plain version agree to a few ulp, so Newton iteration counts cannot
flip on contraction alone.  Turning it back on is left to a performance pass.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

SOURCES = ("pcr_kernel", "fused_newton", "tiled_pcr", "fused_network", "fused_network_table")
# a library built from another library's source with extra flags: the
# network kernel's builds for networks with table branches, compiled beside
# its trapezoid builds by a second nvcc
VARIANTS = {"fused_network_table": ("fused_network", ("-DFLOWSIM_NETWORK_TABLE=1",))}

_libs: dict[str, ctypes.CDLL] = {}
# per source: {"seconds": build time (0 when reused), "ptxas": [per-kernel
# register/spill records], "path": the .so}
build_info: dict[str, dict] = {}


def build_dir() -> str:
    return os.environ.get("FLOWSIM_TORCH_BUILD_DIR") or os.path.join(
        os.getcwd(), "build", "flowsim_tpu_torch")


def find_nvcc() -> str:
    for cand in (os.environ.get("NVCC"), shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (looked at $NVCC, PATH and /usr/local/cuda/bin): the "
        "CUDA kernels of flowsim_tpu_torch are compiled at first use and "
        "need the CUDA toolkit")


def _source_and_flags(name: str) -> tuple[str, tuple]:
    """The ``.cu`` file a library is built from, and its extra nvcc flags."""
    source, extra = VARIANTS.get(name, (name, ()))
    return os.path.join(CSRC, source + ".cu"), extra


def _source_hash(name: str) -> str:
    source, extra = _source_and_flags(name)
    h = hashlib.sha256(" ".join(NVCC_FLAGS + extra).encode())
    for fn in sorted(os.listdir(CSRC)):
        if fn == os.path.basename(source) or fn.endswith(".cuh"):
            with open(os.path.join(CSRC, fn), "rb") as f:
                h.update(fn.encode())
                h.update(f.read())
    return h.hexdigest()[:16]


def parse_ptxas(log: str) -> list[dict]:
    """Per-kernel registers / spills / static shared memory from the
    ``-Xptxas -v`` log.  A device function that is not inlined has function
    properties of its own; they go under the kernel's ``device_functions``."""
    out = []
    cur = target = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            cur = target = dict(kernel=m.group(1))
            out.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            name = m.group(1)
            target = cur if name == cur["kernel"] else cur.setdefault("device_functions", {}).setdefault(name, {})
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            target.update(stack_bytes=int(m.group(1)), spill_store_bytes=int(m.group(2)),
                          spill_load_bytes=int(m.group(3)))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
            m2 = re.search(r"(\d+) bytes smem", line)
            cur["static_smem_bytes"] = int(m2.group(1)) if m2 else 0
    return out


def start_build(name: str):
    """Start ``nvcc`` for one source unless its library is already built.
    Returns ``(process or None, so_path, log_path, t0)`` for
    :func:`finish_build`; starting all sources before finishing any builds
    them in parallel."""
    out_dir = build_dir()
    os.makedirs(out_dir, exist_ok=True)
    so = os.path.join(out_dir, f"lib{name}-{_source_hash(name)}.so")
    log = so[:-3] + ".log"
    if os.path.exists(so) and os.path.exists(log):
        return None, so, log, time.perf_counter()
    tmp = so + f".tmp{os.getpid()}"
    source, extra = _source_and_flags(name)
    cmd = [find_nvcc(), *NVCC_FLAGS, *extra, "-I", CSRC, "-o", tmp, source]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so, log, time.perf_counter()


def finish_build(name: str, started) -> ctypes.CDLL:
    proc, so, log, t0 = started
    seconds = 0.0
    if proc is not None:
        text, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu (exit {proc.returncode}):\n{text}")
        with open(log, "w") as f:
            f.write(text)
        os.replace(so + f".tmp{os.getpid()}", so)
    with open(log) as f:
        ptxas = parse_ptxas(f.read())
    lib = ctypes.CDLL(so)
    _libs[name] = lib
    build_info[name] = dict(seconds=seconds, ptxas=ptxas, path=so)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _libs.get(name)
    if lib is None:
        lib = finish_build(name, start_build(name))
    return lib


def build_all() -> dict[str, dict]:
    """Build every kernel source in parallel (one nvcc each, all started
    together) and load them; returns :data:`build_info`."""
    started = {n: start_build(n) for n in SOURCES if n not in _libs}
    for n, st in started.items():
        finish_build(n, st)
    return build_info
