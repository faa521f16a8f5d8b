"""Build and load the port's CUDA kernels: ``nvcc`` → shared library → ``ctypes``.

At first use every ``csrc/*.cu`` source compiles, all of them in parallel,
into its own shared library with a plain C interface. The libraries go to
``build/pointvit_tpu_torch/<key>/`` at the root of the checkout, where
``<key>`` hashes the sources and the flags: an edited source rebuilds, an
unchanged one loads. A missing ``nvcc`` or a failed build raises; nothing
falls back.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception.

A launch is a ``ctypes`` call on raw device pointers, which a trace by
``torch.export`` (fake tensors, no data) cannot make. So each kernel
wrapper is also a functional custom op of ``torch.library``
(:func:`kernel_op`, namespace ``pointvit_tpu_torch``): it allocates its
outputs, its fake implementation gives their shapes and dtypes, and its
implementation is the wrapper's eager call (the kernel, counted, on CUDA
tensors; the plain version on CPU tensors). Eager calls launch straight
away: a wrapper takes its op only while ``torch.export`` traces
(:func:`exporting`), on any device, so that an exported program holds the
op wherever the eager forward would launch the kernel (or on the CPU run
its plain version). Registering an op builds nothing.

An exported program carries the weights its kernels launch with, made once
at export (:func:`bake`): while :func:`baking` is in force, each module that
keeps launch-ready weights (a block's cast and transposed matrices, a
quantized layer's int8 weight and scales) records them as it makes them;
:func:`bake` then registers them as the module's buffers, in place of the
raw parameters they come from, which leave the module, and the module's
forward takes them from :func:`baked_weights`.

``python -m pointvit_tpu_torch._build`` prints ptxas's report for every
kernel (registers, spills, wgmma warnings): :func:`ptxas_report`.
"""

from __future__ import annotations

import contextlib
import contextvars
import ctypes
import hashlib
import re
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

from pointvit_tpu_torch.utils.profiling import Counter

__all__ = [
    "LaunchCounter", "NAMESPACE", "bake", "baked_weights", "baking", "build_kernels", "check",
    "exporting", "is_baking", "kernel", "kernel_op", "launch_counts", "ptxas_report",
    "record_baked", "require", "reset_launch_counts", "stream_ptr",
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
DOUBLE = ctypes.c_double

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[tuple[str, str], ctypes._CFuncPtr] = {}
_launches: dict[str, "LaunchCounter"] = {}

NAMESPACE = "pointvit_tpu_torch"  # of the kernels' custom ops: torch.ops.pointvit_tpu_torch.<name>


class LaunchCounter(Counter):
    """The count of the launches one wrapper makes: the profiling registry's
    counter ``kernel.<name>``, which counts always (incremented only where
    the wrapper launches its kernel, never on the plain path)."""

    __slots__ = ()

    def __init__(self, name: str) -> None:
        super().__init__(f"kernel.{name}")
        _launches[name] = self


def launch_counts() -> dict[str, int]:
    """Each wrapper's launches: wrapper name → count."""
    return {name: c.count for name, c in _launches.items()}


def reset_launch_counts() -> None:
    for c in _launches.values():
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


def _kernel_name(mangled: str) -> str:
    """The length-prefixed part of a mangled name that ends in "kernel",
    with a template instance's arguments (element type, integers)."""
    for m in re.finditer(r"\d+", mangled):
        digits = m.group()
        for k in range(len(digits)):  # "_GLOBAL__N_1" runs into the length
            n = int(digits[k:])
            name = mangled[m.end():m.end() + n]
            if n and name.endswith("kernel") and name.isidentifier():
                targs = re.match(r"I(.*?)EE", mangled[m.end() + n:])
                if not targs:
                    return name
                args = ["bf16" if a.endswith("bfloat16") else "f32" if a == "f" else a[2:]
                        for a in re.findall(r"\d+__nv_bfloat16|Li\d+|^f", targs.group(1))]
                return f"{name}<{', '.join(args)}>"
    return mangled


def ptxas_report() -> str:
    """Compile every source once more with ``-Xptxas -v``, all in parallel,
    into ``build/pointvit_tpu_torch/ptxas``, and return, per kernel (and
    template instance), the registers, spill bytes and stack bytes ptxas
    reports and the codes of its performance notes (C75xx: wgmma
    serialised or fences injected)."""
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
            name = _kernel_name(fn)
            regs = re.search(r"Used (\d+) registers", body).group(1)
            spill = re.search(r"(\d+) bytes spill stores", body)
            stack = re.search(r"(\d+) bytes stack frame", body)
            lines.append(f"{src.name} {name}: {regs} registers, "
                         f"{spill.group(1) if spill else '?'} bytes spilled, "
                         f"{stack.group(1) if stack else '?'} bytes of stack")
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


def exporting() -> bool:
    """Whether ``torch.export`` is tracing: the wrappers then call their
    custom ops instead of launching (or running their plain versions)."""
    return torch.compiler.is_exporting()


_BAKING: contextvars.ContextVar[dict | None] = contextvars.ContextVar("pointvit_baking",
                                                                    default=None)
_BAKED = "_baked_names"  # a baked module's attribute: the names of its baked buffers


@contextlib.contextmanager
def baking():
    """Inside, :func:`record_baked` collects the launch weights each module
    makes; yields the dict module → weights."""
    made: dict = {}
    token = _BAKING.set(made)
    try:
        yield made
    finally:
        _BAKING.reset(token)


def record_baked(module: torch.nn.Module, weights) -> None:
    """Hand ``weights`` (a tuple of tensors) that ``module`` made for its
    launches to the :func:`baking` in force, if any."""
    made = _BAKING.get()
    if made is not None:
        made[module] = tuple(weights)


def is_baking() -> bool:
    return _BAKING.get() is not None


def baked_weights(module: torch.nn.Module):
    """The weights :func:`bake` gave ``module`` (its buffers), or None."""
    names = getattr(module, _BAKED, None)
    return None if names is None else tuple(getattr(module, n) for n in names)


def bake(module: torch.nn.Module, weights, raw) -> None:
    """Make ``weights`` ``module``'s launch weights for good: buffers
    ``baked_<i>``, which an exported program stores, while each parameter in
    ``raw`` (the ones the weights are made from, which the forward no longer
    reads) leaves the module (the attribute is then None), so that the
    program holds no second copy. In place: bake a copy of a model
    (``export.py``)."""
    for i, t in enumerate(weights):
        module.register_buffer(f"baked_{i}", t.detach())
    setattr(module, _BAKED, tuple(f"baked_{i}" for i in range(len(weights))))
    for owner, name in raw:
        del owner._parameters[name]
        setattr(owner, name, None)


def kernel_op(name: str, fake):
    """Register the decorated function, whose annotations give the schema,
    as the functional custom op ``pointvit_tpu_torch::<name>`` with the fake
    implementation ``fake`` (same arguments, outputs of the right shape and
    dtype). Returns the op; the function must allocate every output (an op
    returns no view of its inputs)."""
    def register(impl):
        op = torch.library.custom_op(f"{NAMESPACE}::{name}", impl, mutates_args=())
        op.register_fake(fake)
        return op
    return register


def stream_ptr(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def require(t, name: str, dtype, ndim: int, device=None) -> None:
    """Raise unless ``t`` is what a kernel takes: a contiguous CUDA tensor of
    ``dtype`` and rank ``ndim`` (on ``device`` if given) whose data starts on
    a 16-byte boundary (checked when the kernel runs, not while a trace
    makes its op)."""
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
    if not exporting() and t.data_ptr() % 16:  # a traced (fake) tensor has no data
        raise ValueError(f"{name}: data must start on a 16-byte boundary")


if __name__ == "__main__":
    print(ptxas_report())
