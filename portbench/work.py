"""Operations and bytes of each stage, worked out from a configuration's
shapes, and the card's published peaks.

The counts are the algorithm's work at these shapes, whatever kernel runs
it: a product of (m, k) by (k, n) is 2·m·k·n operations; attention's two
products are 2·S²·E each; each input byte is read once and each output
byte written once (activations in the compute dtype, bf16 here; weights
once a request in it). Elementwise work (norms, activations, softmax) is
not counted, so the shares below are shares of the products' bound. Each
family's totals (``forward_flops``, ``blocks_work``) sit beside its plain
reference, in ``reference/<family>.py``.

Peaks of one H100 SXM (NVIDIA's data sheet, dense, at 700 W): 989 TFLOP/s
bf16, 67 TFLOP/s f32 outside the tensor cores, 3.35 TB/s of HBM. FPS
counts 10 operations a point and step (three differences, three squares,
two adds, a min and a compare) at 33.5 TFLOP/s: without FMA each is one
instruction, half the f32 rate that counts an FMA as two.
"""

from __future__ import annotations

__all__ = ["PEAK_BF16", "PEAK_F32", "HBM_BPS", "FPS_OPS_PER_S", "bound_s", "fps_bound_s",
           "mm", "head_flops", "apf_block_flops", "vit_block_flops", "p3_stage_flops",
           "encoder_flops", "BF16"]

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM_BPS = 3.35e12
FPS_OPS_PER_S = 33.5e12
BF16 = 2


def bound_s(flops: float, nbytes: float, peak: float = PEAK_BF16) -> float:
    """The least time: operations at ``peak`` or bytes at HBM's rate,
    whichever is longer."""
    return max(flops / peak, nbytes / HBM_BPS)


def fps_bound_s(clouds: int, points: int, samples: int) -> float:
    return 10.0 * clouds * points * samples / FPS_OPS_PER_S


def mm(m: int, k: int, n: int) -> int:
    return 2 * m * k * n


def _attention_block(S: int, E: int) -> int:
    """qkv, the two attention products, proj, and the 4E MLP."""
    return mm(S, E, 3 * E) + 2 * mm(S, E, S) + mm(S, E, E) + 2 * mm(S, E, 4 * E)


def apf_block_flops(S: int, E: int, bottleneck: int) -> int:
    """One APF block on one cloud's S tokens: an attention block and the
    adapter's two products."""
    return _attention_block(S, E) + 2 * mm(S, E, bottleneck)


def vit_block_flops(S: int, E: int) -> int:
    return _attention_block(S, E)


def p3_stage_flops(S: int, k: int, C: int = 6, dim: int = 256) -> int:
    """One P3 stage on one cloud: S groups of k rows of C inputs through
    conv1 (C→dim→dim) and conv2 (2·dim→2·dim→dim)."""
    R = S * k
    return mm(R, C, dim) + mm(R, dim, dim) + mm(R, 2 * dim, 2 * dim) + mm(R, 2 * dim, dim)


def encoder_flops(G: int, K: int, C2: int, E: int, H: int) -> int:
    """APF's group encoder on one cloud: G groups of K rows of C2 inputs."""
    R = G * K
    return (mm(R, C2, 256) + mm(R, 256, 512) + mm(R, 512, E) + mm(G, E, H) + mm(R, E, H)
            + mm(R, H, E))


def head_flops(widths) -> int:
    """A classifier head of products through ``widths`` on one cloud."""
    return sum(mm(1, a, b) for a, b in zip(widths, widths[1:]))
