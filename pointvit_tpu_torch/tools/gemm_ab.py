"""This tree's bf16 GEMM (``csrc/gemm.cu``) against another copy of it, an
earlier commit's, product by product at the shapes of ``chip_smoke.py``'s
GEMM phase (the serial-adapter, APF and ViT blocks, the APF group encoder,
the P3 stage) on seeded random inputs, timed in turns (other, this, this,
other) on one card::

    git show <rev>:pointvit_tpu_torch/csrc/gemm.cu > build/gemm_other.cu
    python -m pointvit_tpu_torch.tools.gemm_ab build/gemm_other.cu

Both copies are built with the port's nvcc flags and this tree's headers.
The other copy's ``pv_gemm`` has no ``instance`` argument (it picked its
instance itself, as before ``ops/gemm_kernel.py::gemm_instance``); this
tree's launches the instance that ``gemm_instance`` picks. Prints one line
per product: both times, this tree's instance and the ratio.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

# (chain, name, M, K, N, act, residual dtype or None, res_div, res_scale,
#  out dtype or None, pre output, group, bias); dtypes by name
S, A, E, V, Q = 302592, 50176, 802816, 131328, 2097152
PRODUCTS = [
    ("serial", "qkv", S, 768, 2304, "none", None, 1, 1.0, "bf16", False, 0, True),
    ("serial", "proj", S, 768, 768, "none", "bf16", 1, 1.0, "f32", True, 0, True),
    ("serial", "dn", S, 768, 64, "gelu", None, 1, 1.0, "bf16", False, 0, True),
    ("serial", "up", S, 64, 768, "none", "f32", 1, 1.0, "bf16", False, 0, True),
    ("serial", "fc1", S, 768, 3072, "gelu", None, 1, 1.0, "bf16", False, 0, True),
    ("serial", "fc2", S, 3072, 768, "none", "bf16", 1, 1.0, "f32", True, 0, True),
    ("APF", "qkv", A, 768, 2304, "none", None, 1, 1.0, "bf16", False, 0, True),
    ("APF", "proj", A, 768, 768, "none", "bf16", 1, 1.0, "bf16", False, 0, True),
    ("APF", "fc1", A, 768, 3072, "gelu", None, 1, 1.0, "bf16", False, 0, True),
    ("APF", "dn", A, 768, 64, "relu", None, 1, 1.0, "bf16", False, 0, True),
    ("APF", "up", A, 64, 768, "none", "bf16", 1, 2.0, "f32", False, 0, True),
    ("APF", "fc2", A, 3072, 768, "none", "f32", 1, 1.0, "bf16", False, 0, True),
    ("encoder", "first_0", E, 8, 256, "relu", None, 1, 1.0, "bf16", False, 0, True),
    ("encoder", "first_1", E, 256, 512, "relu", None, 1, 1.0, "bf16", False, 0, True),
    ("encoder", "first_2", E, 512, 768, "none", None, 1, 1.0, "bf16", False, 16, True),
    ("encoder", "second_0_global", A, 768, 384, "none", None, 1, 1.0, "f32", False, 0, True),
    ("encoder", "second_0_local", E, 768, 384, "relu", "f32", 16, 1.0, "bf16", False, 0, False),
    ("encoder", "second_1", E, 384, 768, "none", None, 1, 1.0, None, False, 16, True),
    ("ViT", "qkv", V, 384, 1152, "none", None, 1, 1.0, "bf16", False, 0, True),
    ("ViT", "proj", V, 384, 384, "none", "bf16", 1, 1.0, "bf16", False, 0, True),
    ("ViT", "fc1", V, 384, 1536, "gelu", None, 1, 1.0, "bf16", False, 0, True),
    ("ViT", "fc2", V, 1536, 384, "none", "bf16", 1, 1.0, "bf16", False, 0, True),
    ("P3", "x.W01", Q, 8, 256, "relu", None, 1, 1.0, "bf16", False, 16, True),
    ("P3", "g.W2g", 131072, 256, 512, "none", None, 1, 1.0, "f32", False, 0, True),
    ("P3", "h.W2l", Q, 256, 512, "relu", "f32", 16, 1.0, "bf16", False, 0, False),
    ("P3", "h2.W3", Q, 512, 256, "relu", None, 1, 1.0, None, False, 16, True),
]
ACTS = {"none": 0, "relu": 1, "gelu": 2}


def build(sources: dict[str, Path], out_dir: Path) -> dict[str, ctypes.CDLL]:
    """Each source into its own shared library, all in parallel."""
    from pointvit_tpu_torch import _build

    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _build._nvcc()
    procs = {k: subprocess.Popen([nvcc, *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
                                  str(out_dir / f"lib{k}.so"), str(v)]) for k, v in sources.items()}
    for k, p in procs.items():
        if p.wait():
            sys.exit(f"nvcc failed on {sources[k]}")
    return {k: ctypes.CDLL(str(out_dir / f"lib{k}.so")) for k in sources}


def cuda_ms(torch, fn, iters: int = 20) -> float:
    fn()
    torch.cuda.synchronize()
    t0, t1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(iters):
        fn()
    t1.record()
    torch.cuda.synchronize()
    return t0.elapsed_time(t1) / iters


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("other", type=Path, help="the other copy of csrc/gemm.cu")
    args = ap.parse_args()
    import torch

    from pointvit_tpu_torch import _build
    from pointvit_tpu_torch.ops.gemm_kernel import INSTANCES, gemm_instance

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    libs = build({"other": args.other, "this": _build.CSRC / "gemm.cu"},
                 _build.BUILD_ROOT / "gemm_ab")
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    head = [P, P, P, P, I, I, F, P, I, P, P, I, I, I, I, I]
    libs["other"].pv_gemm.argtypes = head + [P]
    libs["this"].pv_gemm.argtypes = head + [I, P]
    dev = torch.device("cuda")
    dtypes = {"bf16": torch.bfloat16, "f32": torch.float32, None: None}
    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape, dt=torch.bfloat16, sc=1.0: (torch.randn(*shape, generator=gen) * sc).to(dev, dt)  # noqa: E731
    stream = torch.cuda.current_stream().cuda_stream
    for chain, name, M, K, N, act, rdt, rdiv, rsc, odt, pre, group, has_bias in PRODUCTS:
        rdt, odt = dtypes[rdt], dtypes[odt]
        a, w = rand(M, K), rand(N, K, sc=K**-0.5)
        bias = rand(N) if has_bias else None
        res = rand(M // rdiv, N, dt=rdt) if rdt is not None else None
        out = torch.empty(M, N, device=dev, dtype=odt) if odt is not None else None
        prb = torch.empty(M, N, device=dev, dtype=torch.bfloat16) if pre else None
        gmax = torch.empty(M // group, N, device=dev, dtype=torch.bfloat16) if group else None
        ptr = lambda t: t.data_ptr() if t is not None else None  # noqa: E731
        common = (ptr(a), ptr(w), ptr(bias), ptr(res), rdiv, int(rdt == torch.float32), rsc, ptr(out),
                  int(odt == torch.float32), ptr(prb), ptr(gmax), group, M, N, K, ACTS[act])
        inst = gemm_instance(M, N, K, act=act, res=res, group=group, pre_out=prb)
        run = {"other": lambda: libs["other"].pv_gemm(*common, stream),
               "this": lambda: libs["this"].pv_gemm(*common, INSTANCES[inst], stream)}
        if run["other"]() or run["this"]():
            sys.exit(f"{chain} {name}: a launch failed")
        t = {"other": [], "this": []}
        for who in ("other", "this", "this", "other"):
            t[who].append(cuda_ms(torch, run[who]))
        to, tt = sum(t["other"]) / 2, sum(t["this"]) / 2
        print(f"{chain} {name} ({M}, {K}) -> {N}: other {to:.4f} ms (runs {t['other'][0]:.4f}, "
              f"{t['other'][1]:.4f}), this [{inst}] {tt:.4f} ms (runs {t['this'][0]:.4f}, "
              f"{t['this'][1]:.4f}), ratio {tt / to:.3f}", flush=True)
        del a, w, bias, res, out, prb, gmax
        torch.cuda.empty_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
