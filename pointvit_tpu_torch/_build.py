"""Build and load the port's CUDA kernels: ``nvcc`` → shared library → ``ctypes``.

At first use every ``csrc/*.cu`` source compiles, all of them in parallel,
into its own shared library with a plain C interface. The libraries go to
``build/pointvit_tpu_torch/<key>/`` at the root of the checkout, where
``<key>`` hashes the sources and the flags: an edited source rebuilds, an
unchanged one loads. A missing ``nvcc`` or a failed build raises; nothing
falls back.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.

``python -m pointvit_tpu_torch._build`` prints ptxas's report for every
kernel (registers, spills, wgmma warnings): :func:`ptxas_report`.
"""

from __future__ import annotations

import ctypes
import hashlib
import re
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = [
    "LaunchCounter", "build_kernels", "check", "kernel", "launch_counts", "ptxas_report",
    "require", "reset_launch_counts", "stream_ptr",
]

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG.parent / "build" / "pointvit_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

PTR = ctypes.c_void_p
INT = ctypes.c_int
FLOAT = ctypes.c_float

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_counters: dict[str, "LaunchCounter"] = {}


class LaunchCounter:
    """Plain count of the launches one wrapper makes (incremented only where
    the wrapper launches its kernel, never on the plain path)."""

    def __init__(self, name: str) -> None:
        self.name = name
        self.count = 0
        _counters[name] = self

    def add(self) -> None:
        self.count += 1


def launch_counts() -> dict[str, int]:
    return {name: c.count for name, c in _counters.items()}


def reset_launch_counts() -> None:
    for c in _counters.values():
        c.count = 0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _key() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def _build_all() -> dict[str, ctypes.CDLL]:
    out_dir = BUILD_ROOT / _key()
    out_dir.mkdir(parents=True, exist_ok=True)
    todo = [s for s in _sources() if not (out_dir / f"lib{s.stem}.so").exists()]
    if todo:
        nvcc = _nvcc()
        procs = []
        for src in todo:
            tmp = out_dir / f"lib{src.stem}.so.{os.getpid()}.tmp"
            cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)]
            procs.append((src, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )))
        errors = []
        for src, tmp, proc in procs:
            log, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"{src.name}:\n{log}")
                continue
            os.replace(tmp, out_dir / f"lib{src.stem}.so")
        if errors:
            raise RuntimeError("nvcc failed:\n" + "\n".join(errors))
    return {s.stem: ctypes.CDLL(str(out_dir / f"lib{s.stem}.so")) for s in _sources()}


def ptxas_report() -> str:
    """Compile every source once more with ``-Xptxas -v``, all in parallel,
    into ``build/pointvit_tpu_torch/ptxas``, and return, per kernel, the
    registers and spill bytes ptxas reports and the codes of its
    performance notes (C75xx: wgmma serialised or fences injected)."""
    nvcc = _nvcc()
    out_dir = BUILD_ROOT / "ptxas"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = [(src, subprocess.Popen(
        [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-I", str(CSRC), "-o", str(out_dir / f"lib{src.stem}.so"),
         str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for src in _sources()]
    lines = []
    for src, proc in procs:
        log, _ = proc.communicate()
        notes = sorted(set(re.findall(r"\((C75\d\d)\)", log)))
        for fn, body in re.findall(r"Function properties for (\S+)\n(.*?Used \d+ registers)", log, re.S):
            # the mangled name's length-prefixed part that ends in "kernel"
            parts = [fn[m.end():m.end() + int(m.group())] for m in re.finditer(r"\d+", fn)]
            name = next((p for p in parts if p.endswith("kernel")), fn)
            regs = re.search(r"Used (\d+) registers", body).group(1)
            spill = re.search(r"(\d+) bytes spill stores", body)
            lines.append(f"{src.name} {name}: {regs} registers, "
                         f"{spill.group(1) if spill else '?'} bytes spilled")
        if notes:
            lines.append(f"{src.name}: ptxas notes {', '.join(notes)}")
    return "\n".join(lines)


def build_kernels() -> float:
    """Build (or load) every kernel library; returns the seconds it took."""
    t0 = time.perf_counter()
    with _lock:
        if not _libs:
            _libs.update(_build_all())
    return time.perf_counter() - t0


def kernel(lib: str, symbol: str, argtypes) -> ctypes._CFuncPtr:
    """The C entry point ``symbol`` of ``csrc/<lib>.cu``, with its signature
    declared (every pointer and the stream as ``c_void_p``); looked up once,
    since a short kernel's launch is bound by the host's time per call."""
    fn = _fns.get((lib, symbol))
    if fn is None:
        build_kernels()
        fn = getattr(_libs[lib], symbol)
        fn.argtypes = list(argtypes)
        fn.restype = INT
        _fns[(lib, symbol)] = fn
    return fn


def check(err: int, lib: str, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err:
        es = _libs[lib].pv_error_string
        es.argtypes, es.restype = [INT], ctypes.c_char_p
        raise RuntimeError(f"{what}: CUDA error {err} ({es(err).decode()})")


def stream_ptr(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, dtype, ndim: int, device=None) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA tensor of
    ``dtype`` and rank ``ndim`` (on ``device`` if given) whose data starts on
    a 16-byte boundary."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got device {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected rank {ndim}, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.data_ptr() % 16:
        raise ValueError(f"{name}: data must start on a 16-byte boundary")


if __name__ == "__main__":
    print(ptxas_report())
