"""The ping-pong GEMM instance's design choices, measured: variants of this
tree's ``csrc/gemm.cu`` made by text substitution, built side by side and
timed at the ViT block's products (M = 131,328: qkv, proj, fc1 with and
without its GELU, fc2) with the ping-pong instance, beside this tree's
two-block 128 x 128 and persistent 128 x 256 instances, two rounds on one
card::

    python -m pointvit_tpu_torch.tools.gemm_variants

Variants: four ring stages instead of five; no ``setmaxnreg``; the GELU's
erf replaced by a branch-free one (two polynomials, both evaluated, one
selected; within about 1 ulp of erf); the GELU not inlined; a
``__nanosleep`` every eight GELU values. Each line gives every product's
time and its largest difference from this tree's 128 x 128 output,
relative to the largest output.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

from pointvit_tpu_torch.tools.gemm_ab import build, cuda_ms

GELU = "__device__ __forceinline__ float gelu(float v) { return 0.5f * v * (1.f + erff(v * 0.7071067811865475f)); }"
ERF_NOBRANCH = """__device__ __forceinline__ float erf_nobranch(float a) {
  const float t = fabsf(a), s = t * t;
  float p = 7.854105206e-05f;
  p = fmaf(p, s, -8.010274032e-04f);
  p = fmaf(p, s, 5.188337993e-03f);
  p = fmaf(p, s, -2.685381845e-02f);
  p = fmaf(p, s, 1.128358543e-01f);
  p = fmaf(p, s, -3.761262596e-01f);
  p = fmaf(p, s, 1.283791661e-01f);
  const float below = fmaf(t, p, t);
  const float u = fminf(t, 4.f);
  float r = 1.599820962e-06f;
  r = fmaf(r, u, -4.529813305e-05f);
  r = fmaf(r, u, 5.902035628e-04f);
  r = fmaf(r, u, -4.727690015e-03f);
  r = fmaf(r, u, 2.632752806e-02f);
  r = fmaf(r, u, -1.099097431e-01f);
  r = fmaf(r, u, 3.679865599e-01f);
  r = fmaf(r, u, -1.130119681e+00f);
  r = fmaf(r, u, 2.910281182e-04f);
  const float above = 1.f - expf(fmaf(-u, u, r));
  return copysignf(t < 1.f ? below : above, a);
}
__device__ __forceinline__ float gelu(float v) { return 0.5f * v * (1.f + erf_nobranch(v * 0.7071067811865475f)); }"""
PP_GELU = "        acc[0][i] = gelu(acc[0][i]);\n        acc[1][i] = gelu(acc[1][i]);"
VARIANTS = {
    "four stages": [("kPPStages = 5;", "kPPStages = 4;")],
    "no setmaxnreg": [('    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\\n" ::: "memory");\n', ""),
                      ('  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\\n" ::: "memory");\n', "")],
    "branch-free erf": [(GELU, ERF_NOBRANCH)],
    "GELU not inlined": [("__device__ __forceinline__ float gelu(", "__device__ __noinline__ float gelu(")],
    "nanosleep": [(PP_GELU, PP_GELU + "\n        if ((i & 7) == 7) __nanosleep(40);")],
}
# name -> (K, N, act, residual)
SHAPES = {"qkv": (384, 1152, 0, False), "proj": (384, 384, 0, True), "fc1": (384, 1536, 2, False),
          "fc1 no GELU": (384, 1536, 0, False), "fc2": (1536, 384, 0, True)}
M = 131328


def main() -> None:
    import torch

    from pointvit_tpu_torch import _build
    from pointvit_tpu_torch.ops.gemm_kernel import INSTANCES

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    source = (_build.CSRC / "gemm.cu").read_text()
    out_dir = _build.BUILD_ROOT / "gemm_variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"this": _build.CSRC / "gemm.cu"}
    for i, (name, subs) in enumerate(VARIANTS.items()):
        text = source
        for old, new in subs:
            if old not in text:
                sys.exit(f"variant {name!r}: its text is not in csrc/gemm.cu")
            text = text.replace(old, new)
        sources[name] = out_dir / f"variant{i}.cu"
        sources[name].write_text(text)
    libs = build({f"v{i}": path for i, path in enumerate(sources.values())}, out_dir)
    libs = dict(zip(sources, libs.values()))
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    for lib in libs.values():
        lib.pv_gemm.argtypes = [P, P, P, P, I, I, F, P, I, P, P, I, I, I, I, I, I, P]
    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(0)
    rand = lambda *shape, sc=1.0: (torch.randn(*shape, generator=gen) * sc).to(dev, torch.bfloat16)  # noqa: E731
    data = {k: (rand(M, K), rand(N, K, sc=K**-0.5), rand(N), rand(M, N) if res else None,
                torch.empty(M, N, device=dev, dtype=torch.bfloat16))
            for k, (K, N, act, res) in SHAPES.items()}
    stream = torch.cuda.current_stream().cuda_stream

    def call(lib, k, inst):
        a, w, b, res, out = data[k]
        K, N, act, _ = SHAPES[k]
        err = lib.pv_gemm(a.data_ptr(), w.data_ptr(), b.data_ptr(), res.data_ptr() if res is not None else None,
                          1, 0, 1.0, out.data_ptr(), 0, None, None, 0, M, N, K, act, INSTANCES[inst], stream)
        if err:
            sys.exit(f"{k}: launch failed ({err})")

    ref = {}
    for k in SHAPES:
        call(libs["this"], k, "128x128")
        torch.cuda.synchronize()
        ref[k] = data[k][4].float().clone()
    for rnd in range(2):
        for name, lib in libs.items():
            cells = []
            for k in SHAPES:
                t = cuda_ms(torch, lambda: call(lib, k, "pingpong"))
                d = ((data[k][4].float() - ref[k]).abs().max() / ref[k].abs().max()).item()
                cells.append(f"{k} {t:.4f} (d {d:.2g})")
            print(f"round {rnd} ping-pong, {name}: " + ", ".join(cells), flush=True)
        for inst in ("128x128", "128x256"):
            print(f"round {rnd} {inst}, this: " + ", ".join(
                f"{k} {cuda_ms(torch, lambda: call(libs['this'], k, inst)):.4f}" for k in SHAPES), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
