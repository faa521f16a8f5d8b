"""The port's CUDA kernels against their plain versions, on a CUDA card.

Every test here needs the card and skips without one. On a machine with a
card and no JAX, run them without the JAX package's conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The shapes mix the main paths' (APF slim2: B=256, N=1024, G=196, K=16,
E=768, 12 heads; Pix4Point vit_small: N=2048, S=512+1, K=16, E=384, 6
heads; the renderer's vit_b_16: S=196+1, E=768, 12 heads, bottleneck 64;
quantized APF slim2: int8 products of M = 196·B token rows and 16·196·B
grouped points) with ragged ones that exercise the kernels' edge masks.
bf16 tolerances are relative to the largest reference value: kernel and
plain version round at the same points and differ only in f32 summation
order, which moves a bf16 rounding by one step here and there.
"""

import pytest
import torch

from pointvit_tpu_torch import _build
from pointvit_tpu_torch.ops import (
    attention_kernel,
    block_kernel,
    encoder_kernel,
    fps_kernel,
    knn_kernel,
    p3_kernel,
    quant_kernel,
    serial_block_kernel,
    vit_block_kernel,
)
from pointvit_tpu_torch.ops.gemm_kernel import gemm, reference_gemm

pytestmark = pytest.mark.cuda

BF16_REL_TOL = 2.0**-6


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def _rand(gen, *shape, dev, dtype=torch.bfloat16, scale=1.0):
    return (torch.randn(*shape, generator=gen) * scale).to(dev, dtype)


def _assert_rel(got, want, tol=BF16_REL_TOL):
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max() / want.float().abs().max()
    assert err <= tol, f"max|d| / max|ref| = {err.item():.3g} > {tol:.3g}"


@pytest.mark.parametrize("M,K,N", [(300, 8, 256), (1000, 64, 64), (4096, 768, 2304), (520, 3072, 96)])
@pytest.mark.parametrize("epilogue", ["none", "relu", "gelu", "res_bf16", "res_f32x2"])
def test_gemm_epilogues(dev, M, K, N, epilogue):
    gen = torch.Generator().manual_seed(M + K + N)
    a = _rand(gen, M, K, dev=dev)
    w = _rand(gen, N, K, dev=dev, scale=K**-0.5)
    bias = _rand(gen, N, dev=dev)
    kw = {"act": epilogue} if epilogue in ("relu", "gelu") else {}
    if epilogue == "res_bf16":
        kw = dict(res=_rand(gen, M, N, dev=dev))
    elif epilogue == "res_f32x2":
        kw = dict(res=_rand(gen, M, N, dev=dev, dtype=torch.float32), res_scale=2.0,
                  out_dtype=torch.float32)
    got, _ = gemm(a, w, bias, **kw)
    want, _ = reference_gemm(a, w, bias, **kw)
    assert got.dtype == want.dtype
    _assert_rel(got, want)


@pytest.mark.parametrize("M,K,N", [(300, 64, 768), (4096, 768, 768), (520, 3072, 96)])
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_gemm_second_output_before_the_residual(dev, M, K, N, out_dtype):
    gen = torch.Generator().manual_seed(M + K + N + 1)
    a = _rand(gen, M, K, dev=dev)
    w = _rand(gen, N, K, dev=dev, scale=K**-0.5)
    bias = _rand(gen, N, dev=dev)
    res = _rand(gen, M, N, dev=dev, dtype=torch.float32, scale=4.0)
    pre = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
    got, _ = gemm(a, w, bias, res=res, out_dtype=out_dtype, pre_out=pre)
    want_pre = torch.empty_like(pre)
    want, _ = reference_gemm(a, w, bias, res=res, out_dtype=out_dtype, pre_out=want_pre)
    _assert_rel(pre, want_pre)
    _assert_rel(got, want)
    plain, _ = gemm(a, w, bias, res=res, out_dtype=out_dtype)
    assert torch.equal(got, plain)  # the second output changes nothing of the first


def test_gemm_group_max_and_row_residual(dev):
    gen = torch.Generator().manual_seed(1)
    M, K, N, G = 1024, 512, 768, 16
    a, w, bias = _rand(gen, M, K, dev=dev), _rand(gen, N, K, dev=dev, scale=K**-0.5), _rand(gen, N, dev=dev)
    out, gmax = gemm(a, w, bias, group=G)
    want_out, want_gmax = reference_gemm(a, w, bias, group=G)
    _assert_rel(out, want_out)
    _assert_rel(gmax, want_gmax)
    res = _rand(gen, M // G, N, dev=dev, dtype=torch.float32)
    got, _ = gemm(a, w, res=res, res_div=G, act="relu")
    want, _ = reference_gemm(a, w, res=res, res_div=G, act="relu")
    _assert_rel(got, want)


def test_gemm_refuses_what_it_does_not_take(dev):
    a = torch.zeros(64, 12, device=dev, dtype=torch.bfloat16)
    w = torch.zeros(32, 12, device=dev, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="K % 8"):
        gemm(a, w)
    with pytest.raises(ValueError, match="bfloat16"):
        gemm(a[:, :8].float().contiguous(), w[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        gemm(torch.zeros(16, 64, device=dev, dtype=torch.bfloat16).t(), torch.zeros(8, 16, device=dev,
             dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="group"):
        gemm(torch.zeros(96, 8, device=dev, dtype=torch.bfloat16), w[:, :8].contiguous(), group=48)


# The wgmma GEMM's edges: M off its 128-row tile (985 = 5 * 197), N of the
# 64-wide instance and off every tile width, K of one zero-filled 64-deep
# step (8) and exactly one (64).
@pytest.mark.parametrize("M,K,N", [(985, 768, 64), (985, 64, 96), (985, 8, 768), (197, 64, 2304),
                                   (985, 3072, 768)])
@pytest.mark.parametrize("epilogue", ["gelu", "res_f32_pre", "res_bf16x2_f32"])
def test_gemm_off_the_tiles(dev, M, K, N, epilogue):
    gen = torch.Generator().manual_seed(7 * M + K + N)
    a, w, bias = _rand(gen, M, K, dev=dev), _rand(gen, N, K, dev=dev, scale=K**-0.5), _rand(gen, N, dev=dev)
    pre = want_pre = None
    if epilogue == "gelu":
        kw = dict(act="gelu")
    elif epilogue == "res_f32_pre":  # pre_out beside an f32 out, as the serial block's proj
        kw = dict(res=_rand(gen, M, N, dev=dev, dtype=torch.float32), out_dtype=torch.float32)
        pre = torch.empty(M, N, dtype=torch.bfloat16, device=dev)
        want_pre = torch.empty_like(pre)
    else:  # the APF adapter's up-projection: bf16 residual twice, f32 out
        kw = dict(res=_rand(gen, M, N, dev=dev), res_scale=2.0, out_dtype=torch.float32)
    got, _ = gemm(a, w, bias, pre_out=pre, **kw)
    want, _ = reference_gemm(a, w, bias, pre_out=want_pre, **kw)
    assert got.dtype == want.dtype and got.shape == (M, N)
    _assert_rel(got, want, 2.0**-7 if got.dtype == torch.bfloat16 else 2.0**-12)
    if pre is not None:
        _assert_rel(pre, want_pre, 2.0**-7)


# The ping-pong instance (one producer and two consumer warpgroups taking
# output tiles in turn) at the same edges, forced, with bit-equal repeats.
@pytest.mark.parametrize("M,K,N", [(985, 768, 64), (985, 64, 96), (985, 8, 768), (197, 64, 2304),
                                   (985, 3072, 768)])
@pytest.mark.parametrize("epilogue", ["gelu", "res_f32_pre", "res_bf16x2_f32"])
def test_gemm_pingpong_off_the_tiles(dev, M, K, N, epilogue):
    gen = torch.Generator().manual_seed(7 * M + K + N)
    a, w, bias = _rand(gen, M, K, dev=dev), _rand(gen, N, K, dev=dev, scale=K**-0.5), _rand(gen, N, dev=dev)
    pres = want_pre = None
    if epilogue == "gelu":
        kw = dict(act="gelu")
    elif epilogue == "res_f32_pre":
        kw = dict(res=_rand(gen, M, N, dev=dev, dtype=torch.float32), out_dtype=torch.float32)
        pres = [torch.empty(M, N, dtype=torch.bfloat16, device=dev) for _ in range(2)]
        want_pre = torch.empty_like(pres[0])
    else:
        kw = dict(res=_rand(gen, M, N, dev=dev), res_scale=2.0, out_dtype=torch.float32)
    _build.reset_launch_counts()
    got, _ = gemm(a, w, bias, pre_out=pres and pres[0], instance="pingpong", **kw)
    again, _ = gemm(a, w, bias, pre_out=pres and pres[1], instance="pingpong", **kw)
    assert _build.launch_counts()["gemm_pingpong"] == 2
    want, _ = reference_gemm(a, w, bias, pre_out=want_pre, **kw)
    _assert_rel(got, want, 2.0**-7 if got.dtype == torch.bfloat16 else 2.0**-12)
    assert torch.equal(got, again)
    if pres is not None:
        _assert_rel(pres[0], want_pre, 2.0**-7)
        assert torch.equal(pres[0], pres[1])


@pytest.mark.parametrize("N,K,epilogue", [(1152, 384, "none"), (384, 384, "res_bf16"), (1536, 384, "gelu"),
                                          (384, 1536, "res_bf16")])
def test_gemm_pingpong_alternates_over_many_tiles(dev, N, K, epilogue):
    """The ViT block's products at M = 16 * 513: many more tiles than SMs,
    so both consumers take turns on every block; the same bits as the
    two-block 128 x 128 instance's up to summation order, bit-equal repeats."""
    gen = torch.Generator().manual_seed(N + K)
    M = 16 * 513
    a, w, bias = _rand(gen, M, K, dev=dev), _rand(gen, N, K, dev=dev, scale=K**-0.5), _rand(gen, N, dev=dev)
    kw = {"none": {}, "gelu": dict(act="gelu"), "res_bf16": dict(res=_rand(gen, M, N, dev=dev))}[epilogue]
    got, _ = gemm(a, w, bias, instance="pingpong", **kw)
    assert torch.equal(got, gemm(a, w, bias, instance="pingpong", **kw)[0])
    _assert_rel(got, reference_gemm(a, w, bias, **kw)[0], 2.0**-7)
    _assert_rel(got, gemm(a, w, bias, instance="128x128", **kw)[0], 2.0**-7)


def test_gemm_refuses_an_instance_that_cannot_take_the_product(dev):
    a, w = torch.zeros(256, 64, device=dev, dtype=torch.bfloat16), torch.zeros(100, 64, device=dev,
                                                                               dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="N % 8"):
        gemm(a, w, instance="pingpong")
    with pytest.raises(ValueError, match="group max"):
        gemm(a, w[:96].contiguous(), instance="pingpong", group=16)
    with pytest.raises(ValueError, match="unknown instance"):
        gemm(a, w[:96].contiguous(), instance="256x256")


@pytest.mark.parametrize("G", [16, 32])
@pytest.mark.parametrize("with_out", [True, False])
def test_gemm_group_max_across_warps(dev, G, with_out):
    """Groups of 16 rows reduce within one warp, of 32 across two."""
    gen = torch.Generator().manual_seed(G + with_out)
    M, K, N = 96 * G, 256, 384
    a, w, bias = _rand(gen, M, K, dev=dev), _rand(gen, N, K, dev=dev, scale=K**-0.5), _rand(gen, N, dev=dev)
    kw = dict(act="relu", group=G, out_dtype=torch.bfloat16 if with_out else None)
    out, gmax = gemm(a, w, bias, **kw)
    want_out, want_gmax = reference_gemm(a, w, bias, **kw)
    _assert_rel(gmax, want_gmax, 2.0**-7)
    assert (out is None) == (not with_out)
    if with_out:
        _assert_rel(out, want_out, 2.0**-7)


def test_gemm_row_residual_in_f32(dev):
    """res_div 16 with an f32 residual: the encoder's loc.Wl' + g row."""
    gen = torch.Generator().manual_seed(16)
    M, K, N = 16 * 197, 384, 768
    a, w = _rand(gen, M, K, dev=dev), _rand(gen, N, K, dev=dev, scale=K**-0.5)
    res = _rand(gen, M // 16, N, dev=dev, dtype=torch.float32, scale=2.0)
    got, _ = gemm(a, w, res=res, res_div=16, act="relu")
    want, _ = reference_gemm(a, w, res=res, res_div=16, act="relu")
    _assert_rel(got, want, 2.0**-7)


@pytest.mark.parametrize("N,K,pre", [(64, 768, True), (768, 768, True), (768, 768, False),
                                     (2304, 3072, False)])
def test_gemm_repeats_bit_for_bit(dev, N, K, pre):
    """No split-K, no atomics: two runs of each instance give the same bits
    (with pre_out: the 64- and 128-wide two-block tiles; without: the
    persistent 128 x 256 tile, with an f32 residual at K = 3072)."""
    gen = torch.Generator().manual_seed(N + K)
    M = 4 * 197
    a, w, bias = _rand(gen, M, K, dev=dev), _rand(gen, N, K, dev=dev, scale=K**-0.5), _rand(gen, N, dev=dev)
    res = _rand(gen, M, N, dev=dev, dtype=torch.float32) if pre or K >= 2048 else None
    pres = [torch.empty(M, N, dtype=torch.bfloat16, device=dev) if pre else None for _ in range(2)]
    out1, _ = gemm(a, w, bias, res=res, out_dtype=torch.float32, pre_out=pres[0])
    out2, _ = gemm(a, w, bias, res=res, out_dtype=torch.float32, pre_out=pres[1])
    torch.cuda.synchronize()
    assert torch.equal(out1, out2) and (not pre or torch.equal(pres[0], pres[1]))


@pytest.mark.parametrize("B,S", [(3, S) for S in (1, 16, 65, 196, 197, 416, 513, 576, 577, 768,
                                                  1000, 1024, 1025, 1600, 2048)] + [(1, 197)])
def test_attention_and_layernorm(dev, B, S):
    gen = torch.Generator().manual_seed(S)
    qkv = _rand(gen, B, S, 3 * 768, dev=dev, scale=2.0)
    _assert_rel(block_kernel.attention(qkv, 12), block_kernel.reference_attention(qkv, 12))
    x = _rand(gen, B * S, 768, dev=dev, scale=3.0)
    g, b = _rand(gen, 768, dev=dev), _rand(gen, 768, dev=dev)
    _assert_rel(block_kernel.layer_norm(x, g, b), block_kernel.reference_layer_norm(x, g, b))


def test_attention_refuses_other_head_dims(dev):
    """Head dims past 256, the limit of csrc/attention_any.cu, raise; every
    head dim up to it is served (test_attention_any_*)."""
    with pytest.raises(ValueError, match="head_dim up to 256"):
        block_kernel.attention(torch.zeros(1, 16, 3 * 320, device=dev, dtype=torch.bfloat16), 1)
    with pytest.raises(ValueError, match="head_dim up to 256"):
        attention_kernel.mha_qkv(torch.zeros(1, 16, 3 * 320, device=dev, dtype=torch.float32), 1)
    # 1024 is the blocks' gate; the attention kernel itself serves longer sequences.
    assert block_kernel.attention_max_seq(64) == 1024
    qkv = _rand(torch.Generator().manual_seed(11), 1, 1025, 3 * 768, dev=dev, scale=2.0)
    _assert_rel(block_kernel.attention(qkv, 12), block_kernel.reference_attention(qkv, 12))


@pytest.mark.parametrize("S", [1, 16, 63, 64, 65, 196, 197, 416, 417, 448, 513, 577, 768, 1000,
                               1024, 1025, 1536, 2048])
def test_attention_backward_matches_its_plain_version_and_repeats_bit_for_bit(dev, S):
    gen = torch.Generator().manual_seed(100 + S)
    qkv = _rand(gen, 3, S, 3 * 768, dev=dev, scale=2.0)
    g = _rand(gen, 3, S, 768, dev=dev)
    got = attention_kernel.mha_qkv_bwd(qkv, g, 12)
    want = attention_kernel.reference_mha_qkv_bwd(qkv, g, 12)
    for i in range(3):  # dq, dk, dv each against its own scale
        part = want[..., i * 768 : (i + 1) * 768]
        # At S = 1 the softmax of one key has no gradient: dq and dk are zero
        # in the plain version, and the kernel's f32 rounding of P = 1 and
        # dP - delta = 0 is held against the scale of the whole gradient.
        scale = (part if part.any() else want).float().abs().max()
        err = (got[..., i * 768 : (i + 1) * 768].float() - part.float()).abs().max() / scale
        assert err <= BF16_REL_TOL, f"part {i}: max|d| / max|ref| = {err.item():.3g}"
    assert torch.equal(got, attention_kernel.mha_qkv_bwd(qkv, g, 12))


def test_attention_backward_refuses_other_head_dims_and_long_sequences(dev):
    with pytest.raises(ValueError, match="head_dim up to 256"):
        attention_kernel.mha_qkv_bwd(torch.zeros(1, 16, 3 * 320, device=dev, dtype=torch.bfloat16),
                                     torch.zeros(1, 16, 320, device=dev, dtype=torch.bfloat16), 1)
    # Long sequences are served: S = 1025, past the JAX package's Pallas gate,
    # runs the kernel and matches the plain version.
    gen = torch.Generator().manual_seed(1025)
    qkv = _rand(gen, 1, 1025, 3 * 768, dev=dev, scale=2.0)
    g = _rand(gen, 1, 1025, 768, dev=dev)
    _build.reset_launch_counts()
    got = attention_kernel.mha_qkv_bwd(qkv, g, 12)
    assert _build.launch_counts()["mha_qkv_bwd"] == 1
    want = attention_kernel.reference_mha_qkv_bwd(qkv, g, 12)
    for i in range(3):
        _assert_rel(got[..., i * 768 : (i + 1) * 768], want[..., i * 768 : (i + 1) * 768])


def test_attention_function_runs_both_kernels(dev):
    gen = torch.Generator().manual_seed(5)
    qkv = _rand(gen, 4, 196, 3 * 768, dev=dev).requires_grad_()
    g = _rand(gen, 4, 196, 768, dev=dev)
    _build.reset_launch_counts()
    out = attention_kernel.fused_mha_qkv(qkv, 12)
    out.backward(g)
    counts = _build.launch_counts()
    assert counts["mha_qkv"] == 1 and counts["mha_qkv_bwd"] == 1 and counts["attention"] == 0
    _assert_rel(out, attention_kernel.reference_mha_qkv(qkv.detach(), 12))
    _assert_rel(qkv.grad, attention_kernel.reference_mha_qkv_bwd(qkv.detach(), g, 12))


@pytest.mark.parametrize("B,N,S,same", [
    (1, 1024, 196, False), (5, 1024, 196, False), (256, 1024, 196, False), (256, 2048, 512, False),
    (8, 4096, 1536, False), (3, 200, 9, False),
    (1, 1024, 196, True),  # one cloud of identical points: every step is a tie
])
def test_fps_selects_like_the_plain_version(dev, B, N, S, same):
    gen = torch.Generator().manual_seed(2)
    xyz = torch.randn(B, N, 3, generator=gen).to(dev)
    lo, src = N * 500 // 1024, N * 400 // 1024
    xyz[:, lo:lo + 10] = xyz[:, src:src + 1]  # exact duplicates: ties to the lowest index
    if same:
        xyz[:] = xyz[:, :1]
    start = torch.randint(0, N, (B,), generator=gen, dtype=torch.int32).to(dev)
    _build.reset_launch_counts()
    got = fps_kernel.fps(xyz, S, start)
    assert _build.launch_counts()["fps"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, fps_kernel.reference_fps(xyz, S, start))
    assert torch.equal(got, fps_kernel.fps(xyz, S, start))


@pytest.mark.parametrize("N", [64, 65, 200, 2048, 2049, 4096, 4097, 8192])
def test_fps_at_every_block_size_selects_like_the_plain_version(dev, N):
    """The register kernel at each block size the launch shape picks (64
    threads up to 64 points, 128 up to 2,048, then 256 and 512 threads of 9
    to 16 points), on both sides of each switch, and the 512-thread
    shared-memory kernel, which takes clouds above the register kernel's,
    called at the same N."""
    from pointvit_tpu_torch._build import INT, PTR, check, kernel, stream_ptr

    gen = torch.Generator().manual_seed(N)
    xyz = torch.randn(6, N, 3, generator=gen).to(dev)
    xyz[:, N // 2:N // 2 + 10] = xyz[:, N // 4:N // 4 + 1]  # exact duplicates: ties to the lowest index
    start = torch.randint(0, N, (6,), generator=gen, dtype=torch.int32).to(dev)
    S = min(N, 64)
    want = fps_kernel.reference_fps(xyz, S, start)
    got = fps_kernel.fps(xyz, S, start)
    shared = torch.empty_like(got)
    fn = kernel("fps", "pv_fps", [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR])
    check(fn(xyz.data_ptr(), start.data_ptr(), shared.data_ptr(), None, 6, N, S, 512, 0, stream_ptr(xyz.device)),
          "fps", "pv_fps")
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.equal(shared, want)


def test_fps_limits_agree_with_the_kernel(dev):
    """The wrapper's limits are the kernel's, and a launch shape that the
    kernel does not build (512 threads of one point) is refused."""
    from pointvit_tpu_torch._build import INT, PTR, kernel, stream_ptr

    assert kernel("fps", "pv_fps_smem_max_points", [])() == fps_kernel.SMEM_MAX_POINTS
    assert kernel("fps", "pv_fps_max_per_thread", [])() == fps_kernel.MAX_PER_THREAD
    xyz = torch.zeros(1, 100, 3, device=dev)
    start = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty(1, 4, dtype=torch.int32, device=dev)
    fn = kernel("fps", "pv_fps", [PTR, PTR, PTR, PTR, INT, INT, INT, INT, INT, PTR])
    assert fn(xyz.data_ptr(), start.data_ptr(), out.data_ptr(), None, 1, 100, 4, 512, 1, stream_ptr(xyz.device))


@pytest.mark.parametrize("B,N,S,C", [(256, 1024, 196, 3), (4, 2048, 512, 7), (3, 200, 9, 1)])
def test_knn_selects_and_gathers_like_the_plain_version(dev, B, N, S, C):
    gen = torch.Generator().manual_seed(N)
    pts = torch.randn(B, N, 3, generator=gen).to(dev)
    pts[:, N // 2 : N // 2 + 4] = pts[:, :1]  # duplicates of centre 0
    ctr = pts[:, :S].contiguous()
    feats = torch.randn(B, N, C, generator=gen).to(dev)
    idx, grouped = knn_kernel.knn_group(pts, ctr, feats, 16)
    want_idx, want_grouped = knn_kernel.reference_knn_group(pts, ctr, feats, 16)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx)
    assert torch.equal(grouped, want_grouped)


@pytest.mark.parametrize("instance", ["list", "rows"])
@pytest.mark.parametrize("k", [1, 16, 32, 64, 100])
@pytest.mark.parametrize("N", [128, 2048])
@pytest.mark.parametrize("cloud", ["random", "identical", "near ties", "tiny"])
def test_knn_instances_select_and_gather_like_the_plain_version(dev, instance, k, N, cloud):
    """Both kNN instances at every k the presets use and beyond the list
    instance's 64 (the rows instance only there); a cloud of identical
    points orders its keys by the index bits alone, one of near-duplicates
    (1e-6 apart) puts many keys in T's distance bucket, and a cloud scaled
    to 1e-21 gives distances below f32's normal range, where the list
    instance's distance bound must still admit every key below T. Each
    instance counts its own launches."""
    if instance == "list" and k > knn_kernel.LIST_MAX_K:
        with pytest.raises(ValueError):
            knn_kernel.knn_group(torch.zeros(1, N, 3, device=dev), torch.zeros(1, 1, 3, device=dev),
                                 torch.zeros(1, N, 1, device=dev), k, instance)
        return
    B, S, C = 3, 77, 5
    gen = torch.Generator().manual_seed(N + k)
    pts = torch.randn(B, N, 3, generator=gen)
    if cloud == "identical":
        pts[:] = pts[:, :1]
    elif cloud == "near ties":
        pts = pts[:, :1] + 1e-6 * pts
    scale = 1e-21 if cloud == "tiny" else 1.0
    pts = (scale * pts).to(dev)
    ctr = (pts[:, :S] + 0.01 * scale * torch.randn(B, S, 3, generator=gen).to(dev)).contiguous()
    feats = torch.randn(B, N, C, generator=gen).to(dev)
    _build.reset_launch_counts()
    idx, grouped = knn_kernel.knn_group(pts, ctr, feats, k, instance)
    counts = _build.launch_counts()
    assert counts["knn" if instance == "list" else "knn_rows"] == 1
    assert counts["knn_rows" if instance == "list" else "knn"] == 0
    want_idx, want_grouped = knn_kernel.reference_knn_group(pts, ctr, feats, k)
    torch.cuda.synchronize()
    assert torch.equal(idx, want_idx)
    assert torch.equal(grouped, want_grouped)
    assert knn_kernel.knn_instance(k) == ("list" if k <= knn_kernel.LIST_MAX_K else "rows")


def test_encoder_and_block_chains_and_their_launch_counts(dev):
    from pointvit_tpu_torch.nn.pointnet import GroupFeatureEncoder
    from pointvit_tpu_torch.nn.vit import APFBlock

    gen = torch.Generator().manual_seed(3)
    enc = GroupFeatureEncoder(6, 768, 384)
    blk = APFBlock(768, 12)
    with torch.no_grad():
        for p in list(enc.parameters()) + list(blk.parameters()):
            p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[-1] ** -0.5 if p.dim() == 2 else 0.2))
        blk.adapter.scale.fill_(1.3)
        for m in (enc.first_bn0, enc.first_bn1, enc.second_bn0):
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
    enc, blk = enc.to(dev), blk.to(dev)
    groups = _rand(gen, 6272, 16, 6, dev=dev)
    w = encoder_kernel.fold_encoder_params(enc)
    _build.reset_launch_counts()
    tokens = encoder_kernel.fused_group_encoder(groups, w)
    _assert_rel(tokens, encoder_kernel.reference_folded_encoder(groups, w))
    x = tokens.reshape(32, 196, 768)
    wb = block_kernel.apf_block_weights(blk)
    _assert_rel(block_kernel.fused_apf_block(x, wb, 12), block_kernel.reference_apf_block(x, wb, 12))
    counts = _build.launch_counts()
    assert counts["group_encoder"] == 1 and counts["apf_block"] == 1 and counts["group_encoder_chain"] == 0
    # the encoder: its stack, one GEMM (g.Wg' + c2) and its head; the block six GEMMs
    assert counts["group_stack"] == 1 and counts["group_head"] == 1
    assert counts["gemm"] == 1 + 6 and counts["layernorm"] == 3 and counts["attention"] == 1


def test_apf_above_the_fused_gate_serves_through_the_attention_kernel(dev):
    """APF with npoint 1100 (S above the blocks' gate of 1024) serves on the
    card through the unfused block and the attention kernel, and agrees with
    the plain path."""
    import numpy as np

    from pointvit_tpu_torch.models import AdaptPointFormer, apf_preset_config

    cfg = apf_preset_config("slim2", npoint=1100)
    model = AdaptPointFormer(**cfg)
    gen = torch.Generator().manual_seed(12)
    with torch.no_grad():
        for blk in model.blocks:
            blk.adapter.up_proj.weight.copy_(torch.randn(blk.adapter.up_proj.weight.shape, generator=gen) * 0.05)
    plain = AdaptPointFormer(**cfg, implementation="torch")
    plain.load_state_dict(model.state_dict())
    pts = torch.from_numpy(np.random.default_rng(12).standard_normal((2, 2048, 3)).astype(np.float32))
    model, plain = model.to(dev).eval(), plain.to(dev).eval()
    with torch.inference_mode():
        _build.reset_launch_counts()
        got = model(pts.to(dev))
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        want = plain(pts.to(dev))
    assert counts["mha_qkv"] == cfg["depth"] and counts["apf_block"] == 0 and counts["attention"] == 0
    assert torch.isfinite(got).all()
    _assert_rel(got, want, tol=0.05)


def test_apf_train_step_launches_the_training_kernels(dev):
    from pointvit_tpu_torch.models import AdaptPointFormer, apf_trainable_mask
    from pointvit_tpu_torch.train.trainer import set_trainable

    cfg = dict(num_classes=15, embedding_dim=128, npoint=64, nsample=16, depth=2, num_heads=2,
               encoder_second_width=64, dtype=torch.bfloat16)
    torch.manual_seed(0)
    model = AdaptPointFormer(**cfg).to(dev)
    plain = AdaptPointFormer(**cfg, implementation="torch").to(dev)
    plain.load_state_dict(model.state_dict())
    for m in (model, plain):
        set_trainable(m, apf_trainable_mask(m))
    pts = torch.randn(8, 512, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    grads = []
    for m in (model, plain):
        _build.reset_launch_counts()
        logits = m(pts, train=True, generator=torch.Generator(device=dev).manual_seed(2))
        logits.float().logsumexp(-1).mean().backward()
        counts = _build.launch_counts()
        grads.append(m.point_encoder.first_0.weight.grad)
        launched = {k for k in ("fps", "knn", "mha_qkv", "mha_qkv_bwd") if counts[k] > 0}
        assert launched == ({"fps", "knn", "mha_qkv", "mha_qkv_bwd"} if m is model else set())
    err = (grads[0] - grads[1]).norm() / grads[1].norm()
    assert err <= 0.05, f"encoder gradient relative L2 error {err.item():.3g}"


def test_pix4point_train_step_launches_the_training_kernels_and_leaves_the_fused_ones(dev):
    """A bf16 Pix4Point training step (vit_small widths, 2 blocks, 8 clouds
    of 2048 points) on the kernel path against the plain path and an f32
    plain run: FPS starts drawn from a CUDA generator, the attention forward
    and backward kernels launched, the fused P3 stage and blocks not
    (training runs them unfused, as JAX does). The loss is held within
    BF16_REL_TOL (both paths round the logits to bf16), all gradients
    together no further from f32 than 1.5x the plain path's, and the P3
    stage's first weight gradient within chip_smoke.py's 0.5 of the plain
    path's. The APF card test's 0.05 does not hold here: on an H100 80GB
    HBM3 both bf16 paths' gradients lay 0.56-0.58 (relative L2) from the
    f32 run's and that P3 gradient 0.30 from each other, the bf16 noise of
    a step on 8 clouds, not the kernels' (their ratio to f32 1.02)."""
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.ops.group import p3_group
    from pointvit_tpu_torch.train import cross_entropy_loss

    cfg = dict(pretrained_model="vit_small_patch16_384", num_classes=15, k_neighbors=16,
               embed_dim=384, depth=2)
    torch.manual_seed(0)
    model = build_model(cfg).to(dev)
    plain = build_model(cfg, implementation="torch").to(dev)
    ref = build_model({**cfg, "bf16": False}, implementation="torch").to(dev)
    plain.load_state_dict(model.state_dict())
    ref.load_state_dict(model.state_dict())
    pts = torch.randn(8, 2048, 3, generator=torch.Generator().manual_seed(1)).to(dev)
    lbl = torch.randint(0, 15, (8,), generator=torch.Generator().manual_seed(2)).to(dev)
    start = torch.randint(0, 2048, (8,), generator=torch.Generator(device=dev).manual_seed(3), device=dev)
    centers = model.model.patch_embed(pts, pts, train=True,
                                      generator=torch.Generator(device=dev).manual_seed(3))[0]
    assert torch.equal(centers, p3_group(pts, pts, 512, 16, start=start)[0])
    assert not torch.equal(centers, p3_group(pts, pts, 512, 16)[0])
    losses, grads = [], []
    for m in (model, plain, ref):
        _build.reset_launch_counts()
        logits = m(pts, train=True, generator=torch.Generator(device=dev).manual_seed(4))
        loss = cross_entropy_loss(logits, lbl).mean()
        loss.backward()
        counts = _build.launch_counts()
        losses.append(loss.item())
        grads.append(torch.cat([p.grad.float().flatten() for p in m.parameters()]))
        launched = {k for k, v in counts.items() if v > 0}
        want = {"fps", "knn", "mha_qkv", "mha_qkv_bwd"} if m is model else set()
        assert launched == want or m is ref, counts
    first = [dict(m.named_parameters())["model.patch_embed.s0_conv1_0.weight"].grad.float()
             for m in (model, plain)]
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    errs = dict(loss=abs(losses[0] - losses[1]) / abs(losses[1]), p3_first=rel(*first),
                kernel_f32=rel(grads[0], grads[2]), plain_f32=rel(grads[1], grads[2]))
    assert errs["loss"] <= BF16_REL_TOL and errs["p3_first"] <= 0.5, errs
    assert errs["kernel_f32"] <= 1.5 * errs["plain_f32"], errs


@pytest.mark.parametrize("B,S,E,shared", [(2, 513, 384, False), (3, 513, 384, True), (4, 33, 128, False)])
def test_pos_layernorm_matches_its_plain_version(dev, B, S, E, shared):
    gen = torch.Generator().manual_seed(S + E)
    x = _rand(gen, B * S, E, dev=dev, scale=3.0)
    pos = _rand(gen, S if shared else B * S, E, dev=dev)
    g, b = _rand(gen, E, dev=dev), _rand(gen, E, dev=dev)
    xp, y = block_kernel.pos_layer_norm(x, pos, g, b)
    want_xp, want_y = block_kernel.reference_pos_layer_norm(x, pos, g, b)
    torch.cuda.synchronize()
    assert torch.equal(xp, want_xp)  # one bf16 rounding of the exact sum on both sides
    _assert_rel(y, want_y)


def _p3_stage(gen, dev):
    from pointvit_tpu_torch.nn.pointnet import P3Embed

    p3 = P3Embed(k=16)
    with torch.no_grad():
        for name, t in list(p3.named_parameters()) + list(p3.named_buffers()):
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * (t.shape[-1] ** -0.5 if t.dim() == 2 else 0.2))
    return p3.to(dev)


def test_p3_embed_chain_matches_its_plain_version(dev):
    gen = torch.Generator().manual_seed(7)
    w = p3_kernel.fold_p3_stage_params(_p3_stage(gen, dev))
    x = _rand(gen, 4 * 512, 16, 6, dev=dev)
    _build.reset_launch_counts()
    got = p3_kernel.fused_p3_embed(x, w)
    counts = _build.launch_counts()
    assert got.shape == (4 * 512, 256) and got.dtype == torch.bfloat16
    assert counts["p3_embed"] == 1 and counts["p3_embed_chain"] == 0
    assert counts["group_stack"] == 1 and counts["gemm"] == 1 and counts["group_head"] == 1
    _assert_rel(got, p3_kernel.reference_folded_p3(x, w))



# -- the group-MLP kernels (csrc/group_mlp.cu): each encoder or P3 call is a
#    stack launch, one GEMM (g.Wg' + c2) and a head launch

def _apf_encoder_weights(gen, dev, E=768, H=384):
    from pointvit_tpu_torch.nn.pointnet import GroupFeatureEncoder

    enc = GroupFeatureEncoder(6, E, H)
    with torch.no_grad():
        for p in enc.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[-1] ** -0.5 if p.dim() == 2 else 0.2))
        for m in (enc.first_bn0, enc.first_bn1, enc.second_bn0):
            m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=gen))
    return encoder_kernel.fold_encoder_params(enc.to(dev))


def _launched_twice(run):
    """run()'s result, checked bit-equal to a second run, and the launch
    counts of the first."""
    _build.reset_launch_counts()
    got = run()
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    again = run()
    torch.cuda.synchronize()
    assert torch.equal(got, again), "two launches differ"
    return got, counts


@pytest.mark.parametrize("M", [6272, 6272 + 3])
@pytest.mark.parametrize("K", [8, 16, 32])
def test_group_encoder_kernels_match_their_plain_version_and_the_chain(dev, M, K):
    """APF slim2's widths (E 768, H 384); M + 3 groups end in a part tile."""
    gen = torch.Generator().manual_seed(M + K)
    w = _apf_encoder_weights(gen, dev)
    x = _rand(gen, M, K, 6, dev=dev)
    got, counts = _launched_twice(lambda: encoder_kernel.fused_group_encoder(x, w))
    assert got.shape == (M, 768) and got.dtype == torch.bfloat16
    assert (counts["group_encoder"], counts["group_stack"], counts["gemm"], counts["group_head"],
            counts["group_encoder_chain"]) == (1, 1, 1, 1, 0), counts
    _assert_rel(got, encoder_kernel.reference_folded_encoder(x, w))
    _assert_rel(got, encoder_kernel.launch_chain(x, w))


@pytest.mark.parametrize("M", [2048, 1])
@pytest.mark.parametrize("K", [8, 16, 32])
def test_p3_kernels_match_their_plain_version_and_the_chain(dev, M, K):
    """Pix4Point's widths (D 256, H 512)."""
    gen = torch.Generator().manual_seed(M + K + 1)
    w = p3_kernel.fold_p3_stage_params(_p3_stage(gen, dev))
    x = _rand(gen, M, K, 6, dev=dev)
    got, counts = _launched_twice(lambda: p3_kernel.fused_p3_embed(x, w))
    assert got.shape == (M, 256) and got.dtype == torch.bfloat16
    assert (counts["p3_embed"], counts["group_stack"], counts["gemm"], counts["group_head"],
            counts["p3_embed_chain"]) == (1, 1, 1, 1, 0), counts
    _assert_rel(got, p3_kernel.reference_folded_p3(x, w))
    _assert_rel(got, p3_kernel.launch_chain(x, w))


@pytest.mark.parametrize("K", [8, 16, 32])
def test_p3_stack_max_is_the_max_of_the_h_its_head_recomputes(dev, K):
    """P3's stack writes only g = max_K h; its head recomputes h from x. g
    must be the max of exactly the bits of h that the head reads."""
    import torch.nn.functional as F

    from pointvit_tpu_torch.ops import group_mlp_kernel as gm

    gen = torch.Generator().manual_seed(70 + K)
    w01, c01, _, w2l, _, w3, c3 = p3_kernel.fold_p3_stage_params(_p3_stage(gen, dev))
    M = 2048 + 5
    x = _rand(gen, M * K, 6, dev=dev)
    w01k = F.pad(w01.t().to(torch.bfloat16), (0, 2)).contiguous()
    bf = lambda t: t.to(torch.bfloat16).contiguous()  # noqa: E731
    _, g = gm.group_stack(x, [(w01k, bf(c01))], K, store_last=False)
    h = torch.empty(M * K, 256, dtype=torch.bfloat16, device=dev)
    xg = _rand(gen, M, 512, dev=dev, dtype=torch.float32)
    gm.group_head(x, xg, bf(w2l.t()), bf(w3.t()), bf(c3), K, prologue=(w01k, bf(c01)), h_out=h)
    torch.cuda.synchronize()
    assert torch.equal(g, h.reshape(M, K, 256).amax(dim=1))
    _assert_rel(h, reference_gemm(F.pad(x, (0, 2)), w01k, bf(c01), act="relu")[0])


def test_group_mlp_off_their_plan_take_the_chain(dev):
    """bf16 shapes outside the kernels' gate run the GEMM chain under its own
    counter: APF with H 768 (h2 of a tile beside a ring does not fit), P3
    with H 1024."""
    gen = torch.Generator().manual_seed(80)
    w = _apf_encoder_weights(gen, dev, H=768)
    x = _rand(gen, 512, 16, 6, dev=dev)
    assert not encoder_kernel.takes_group_mlp(x, w)
    got, counts = _launched_twice(lambda: encoder_kernel.fused_group_encoder(x, w))
    assert (counts["group_encoder_chain"], counts["group_encoder"], counts["group_stack"], counts["gemm"]) == (
        1, 0, 0, 6), counts
    _assert_rel(got, encoder_kernel.reference_folded_encoder(x, w))
    shapes = [(6, 256), (256,), (256, 1024), (256, 1024), (1024,), (1024, 256), (256,)]
    wp = tuple(torch.randn(s, generator=gen).to(dev) * (s[0] ** -0.5 if len(s) == 2 else 0.2) for s in shapes)
    xp = _rand(gen, 512, 16, 6, dev=dev)
    assert not p3_kernel.takes_group_mlp(xp, wp)
    got, counts = _launched_twice(lambda: p3_kernel.fused_p3_embed(xp, wp))
    assert (counts["p3_embed_chain"], counts["p3_embed"], counts["group_head"], counts["gemm"]) == (1, 0, 0, 4), counts
    _assert_rel(got, p3_kernel.reference_folded_p3(xp, wp))


def test_group_mlp_encoders_keep_f32_on_the_gemm_chain(dev):
    gen = torch.Generator().manual_seed(81)
    w = _apf_encoder_weights(gen, dev)
    x = _rand(gen, 512, 16, 6, dev=dev, dtype=torch.float32)
    got, counts = _launched_twice(lambda: encoder_kernel.fused_group_encoder(x, w))
    assert (counts["group_encoder_chain"], counts["gemm_f32"], counts["group_stack"], counts["gemm"]) == (
        1, 6, 0, 0), counts
    _assert_rel(got, encoder_kernel.reference_folded_encoder(x, w), F32_REL_TOL)
    wp = p3_kernel.fold_p3_stage_params(_p3_stage(gen, dev))
    xp = _rand(gen, 512, 16, 6, dev=dev, dtype=torch.float32)
    got, counts = _launched_twice(lambda: p3_kernel.fused_p3_embed(xp, wp))
    assert (counts["p3_embed_chain"], counts["gemm_f32"], counts["group_head"]) == (1, 4, 0), counts
    _assert_rel(got, p3_kernel.reference_folded_p3(xp, wp), F32_REL_TOL)


def test_group_mlp_kernels_refuse_what_they_do_not_take(dev):
    from pointvit_tpu_torch.ops import group_mlp_kernel as gm

    z = lambda *s, dt=torch.bfloat16: torch.zeros(*s, device=dev, dtype=dt)  # noqa: E731
    x, w0, b0 = z(96, 6), z(256, 8), z(256)
    with pytest.raises(ValueError, match="groups of"):
        gm.group_stack(x, [(w0, b0)], 12, store_last=False)
    with pytest.raises(ValueError, match="whole groups"):
        gm.group_stack(z(90, 6), [(w0, b0)], 8, store_last=False)
    with pytest.raises(ValueError, match="multiples of 64"):
        gm.group_stack(x, [(z(200, 8), z(200))], 8, store_last=False)
    with pytest.raises(ValueError, match="depth 8 or 16"):
        gm.group_stack(x, [(z(256, 4), b0)], 8, store_last=False)
    with pytest.raises(ValueError, match="3 layers"):
        gm.group_stack(x, [(w0, b0)], 8, store_last=True)
    with pytest.raises(ValueError, match="bfloat16"):
        gm.group_stack(x.float(), [(w0, b0)], 8, store_last=False)
    with pytest.raises(ValueError, match="shared-memory plan"):
        gm.group_head(z(96, 768), z(12, 1024, dt=torch.float32), z(1024, 768), z(768, 1024), z(768), 8)
    with pytest.raises(ValueError, match="prologue"):
        gm.group_head(z(96, 768), z(12, 384, dt=torch.float32), z(384, 768), z(768, 384), z(768), 8,
                      h_out=z(96, 256))

def _vit_weights(gen, E, dev):
    from pointvit_tpu_torch.nn.vit import ViTBlock

    blk = ViTBlock(E, E // 64)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[-1] ** -0.5 if p.dim() == 2 else 0.2))
        blk.norm1.weight.add_(1.0)
        blk.norm2.weight.add_(1.0)
    return vit_block_kernel.vit_block_weights(blk.to(dev), torch.bfloat16)


@pytest.mark.parametrize("pos_kind", ["per_cloud", "shared", "none"])
def test_vit_block_chain_matches_its_plain_version(dev, pos_kind):
    gen = torch.Generator().manual_seed(11)
    B, S, E = 3, 513, 384
    w = _vit_weights(gen, E, dev)
    x = _rand(gen, B, S, E, dev=dev)
    pos = {"per_cloud": _rand(gen, B, S, E, dev=dev, scale=0.5),
           "shared": _rand(gen, 1, S, E, dev=dev, scale=0.5), "none": None}[pos_kind]
    _build.reset_launch_counts()
    got = vit_block_kernel.fused_vit_block(x, w, 6, pos)
    counts = _build.launch_counts()
    # at width 384 proj and LN2 are one launch (proj_layernorm)
    assert counts["vit_block"] == 1 and counts["gemm"] == 3 and counts["attention"] == 1
    assert counts["proj_layernorm"] == 1
    assert counts["pos_layernorm"] == (pos is not None) and counts["layernorm"] == (pos is None)
    _assert_rel(got, vit_block_kernel.reference_vit_block(x, w, 6, pos))


def test_vit_block_refuses_what_the_kernels_do_not_take(dev):
    gen = torch.Generator().manual_seed(12)
    w = _vit_weights(gen, 384, dev)
    with pytest.raises(ValueError, match="head_dim 64"):  # head dim 32
        vit_block_kernel.fused_vit_block(_rand(gen, 1, 64, 384, dev=dev), w, 12)
    with pytest.raises(ValueError, match="S ≤ 1024"):  # past the JAX gate too
        vit_block_kernel.fused_vit_block(_rand(gen, 1, 1025, 384, dev=dev), w, 6)
    x = _rand(gen, 1, 1024, 384, dev=dev)  # the JAX gate's longest: the key-tiled attention
    _assert_rel(vit_block_kernel.fused_vit_block(x, w, 6), vit_block_kernel.reference_vit_block(x, w, 6))
    with pytest.raises(ValueError, match="bf16"):  # f32 is taken, f16 is not
        vit_block_kernel.fused_vit_block(_rand(gen, 1, 64, 384, dev=dev, dtype=torch.float16), w, 6)


def _unfused_above_the_gate(dev, make, E, seed, **kw):
    """A block at S = 1100, above the blocks' gate, on the kernel path and
    the plain path from the same weights: the kernel path must take the
    unfused forward with the attention kernel launched as mha_qkv."""
    gen = torch.Generator().manual_seed(seed)
    blk = make(None)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[-1] ** -0.5 if p.dim() == 2 else 0.2))
    plain = make("torch")
    plain.load_state_dict(blk.state_dict())
    blk, plain = blk.to(dev).eval(), plain.to(dev).eval()
    x = _rand(gen, 2, 1100, E, dev=dev)
    kw = {k: v(gen) for k, v in kw.items()}
    with torch.inference_mode():
        _build.reset_launch_counts()
        got = blk(x, **kw)
        torch.cuda.synchronize()
        counts = _build.launch_counts()
        want = plain(x, **kw)
    fused = ("vit_block", "serial_block", "attention", "gemm", "layernorm", "pos_layernorm")
    assert counts["mha_qkv"] == 1 and not any(counts[k] for k in fused), counts
    assert got.dtype == torch.bfloat16 and torch.isfinite(got).all()
    _assert_rel(got, want, tol=0.05)


def test_vit_block_above_the_gate_serves_unfused(dev):
    from pointvit_tpu_torch.nn.vit import ViTBlock

    make = lambda impl: ViTBlock(384, 6, dtype=torch.bfloat16, implementation=impl)
    _unfused_above_the_gate(dev, make, 384, 21, pos=lambda gen: _rand(gen, 1, 1100, 384, dev=dev, scale=0.5))


def test_serial_block_above_the_gate_serves_unfused(dev):
    from pointvit_tpu_torch.nn.vit import SerialAdapterBlock

    make = lambda impl: SerialAdapterBlock(768, 12, 64, dtype=torch.bfloat16, implementation=impl)
    _unfused_above_the_gate(dev, make, 768, 22)


def test_pix4point_serves_through_its_kernels(dev):
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.serve import InferenceSession

    cfg = dict(pretrained_model="vit_small_patch16_384", num_classes=15, k_neighbors=16,
               embed_dim=384, depth=2)
    torch.manual_seed(0)
    model = build_model(cfg)
    plain = build_model(cfg, implementation="torch")
    plain.load_state_dict(model.state_dict())
    pts = torch.randn(8, 2048, 3, generator=torch.Generator().manual_seed(1)).numpy()
    _build.reset_launch_counts()
    got = InferenceSession(model, buckets=(8,)).predict_logits(pts)
    counts = _build.launch_counts()
    want = InferenceSession(plain, buckets=(8,)).predict_logits(pts)
    for name in ("fps", "knn", "p3_embed", "group_stack", "group_head", "vit_block", "gemm", "proj_layernorm",
                 "pos_layernorm", "attention"):
        assert counts[name] > 0, name
    err = abs(got - want).max() / abs(want).max()
    assert err <= 0.05 and (got.argmax(-1) == want.argmax(-1)).mean() >= 0.75, err


def _serial_weights(gen, E, bottleneck, dev):
    from pointvit_tpu_torch.nn.vit import SerialAdapterBlock

    blk = SerialAdapterBlock(E, E // 64, bottleneck)
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[-1] ** -0.5 if p.dim() == 2 else 0.2))
        blk.ln_1.weight.add_(1.0)
        blk.ln_2.weight.add_(1.0)
    return serial_block_kernel.serial_block_weights(blk.to(dev), torch.bfloat16)


@pytest.mark.parametrize("B,S,E", [(8, 197, 768), (3, 50, 1024), (2, 65, 128)])
def test_serial_block_chain_matches_its_plain_version(dev, B, S, E):
    gen = torch.Generator().manual_seed(13 + S)
    w = _serial_weights(gen, E, 64, dev)
    x = _rand(gen, B, S, E, dev=dev)
    _build.reset_launch_counts()
    got = serial_block_kernel.fused_serial_block(x, w, E // 64)
    counts = _build.launch_counts()
    assert counts["serial_block"] == 1 and counts["gemm"] == 8 and counts["attention"] == 1
    assert counts["layernorm"] == 2
    _assert_rel(got, serial_block_kernel.reference_serial_block(x, w, E // 64))


def test_serial_block_refuses_what_the_kernels_do_not_take(dev):
    gen = torch.Generator().manual_seed(14)
    w = _serial_weights(gen, 768, 64, dev)
    with pytest.raises(ValueError, match="head_dim 64"):  # head dim 32
        serial_block_kernel.fused_serial_block(_rand(gen, 1, 64, 768, dev=dev), w, 24)
    with pytest.raises(ValueError, match="S ≤ 1024"):
        serial_block_kernel.fused_serial_block(_rand(gen, 1, 1025, 768, dev=dev), w, 12)
    with pytest.raises(ValueError, match="bf16"):  # f32 is taken, f16 is not
        serial_block_kernel.fused_serial_block(_rand(gen, 1, 64, 768, dev=dev, dtype=torch.float16),
                                               w, 12)


def test_renderer_serves_through_its_kernels(dev, monkeypatch):
    from pointvit_tpu_torch.models import build_model, renderer
    from pointvit_tpu_torch.serve import InferenceSession

    monkeypatch.setitem(renderer.TORCHVISION_VIT_PRESETS, "vit_b_16_depth2",
                        dict(patch_size=16, embed_dim=768, depth=2, num_heads=12))
    cfg = dict(num_classes=15, vit_name="vit_b_16_depth2", adapter_dim=64, num_views=6,
               img_size=224, dropout_rate=0.1, diff_renderer=True, view_transform_hidden=256)
    torch.manual_seed(0)
    model = build_model(cfg)
    plain = build_model(cfg, implementation="torch")
    with torch.no_grad():  # live adapters: their up projections start at zero
        for name, p in model.named_parameters():
            if "up_proj" in name:
                p.copy_(torch.randn(p.shape) * 0.1)
    plain.load_state_dict(model.state_dict())
    pts = torch.randn(4, 2048, 3, generator=torch.Generator().manual_seed(1))
    pts = (pts / pts.norm(dim=-1).amax(dim=1)[:, None, None]).numpy()
    _build.reset_launch_counts()
    got = InferenceSession(model, buckets=(4,)).predict_logits(pts)
    counts = _build.launch_counts()
    want = InferenceSession(plain, buckets=(4,)).predict_logits(pts)
    assert counts["serial_block"] == 2 and counts["attention"] == 2 and counts["gemm"] == 1 + 2 * 8
    err = abs(got - want).max() / abs(want).max()
    assert err <= 0.05 and (got.argmax(-1) == want.argmax(-1)).mean() >= 0.75, err


def test_renderer_train_step_launches_the_training_kernels_and_trains_the_view_network(dev, monkeypatch):
    """A bf16 renderer training step (vit_b_16 widths, 2 blocks, 6 learned
    views of 224², 4 clouds of 2048 points, every weight live) on the
    kernel path against the plain path and an f32 plain run: the attention
    forward and backward kernels launch (the images carry a gradient into
    block 0), the fused serial block, the patchify's GEMM kernel (it has no
    backward) and the LayerNorm kernel do not; every gradient of the view
    network but the three biases before its train-mode BatchNorms is nonzero
    and finite, so the loss reaches the camera angles through the blocks,
    the patchify and the splat. Loss and gradients are held to the
    Pix4Point card test's bounds: the loss within BF16_REL_TOL, the view
    network's first weight gradient within 0.5 (relative L2) of the plain
    path's, all gradients together no further from f32 than 1.5x the plain
    path's."""
    from pointvit_tpu_torch.models import build_model, renderer, renderer_trainable_mask
    from pointvit_tpu_torch.train import cross_entropy_loss, set_trainable

    monkeypatch.setitem(renderer.TORCHVISION_VIT_PRESETS, "vit_b_16_depth2",
                        dict(patch_size=16, embed_dim=768, depth=2, num_heads=12))
    cfg = dict(num_classes=15, vit_name="vit_b_16_depth2", adapter_dim=64, num_views=6,
               img_size=224, dropout_rate=0.1, diff_renderer=True, view_transform_hidden=256)
    gen = torch.Generator().manual_seed(0)
    model = build_model(cfg)
    with torch.no_grad():  # zero-init view heads and up projections would hide the gradient
        for name, p in model.named_parameters():
            if p.dim() == 2:
                p.copy_(torch.randn(p.shape, generator=gen) * p.shape[1] ** -0.5)
            elif name.endswith("weight"):
                p.copy_(1.0 + 0.2 * torch.randn(p.shape, generator=gen))
            else:
                p.copy_(0.1 * torch.randn(p.shape, generator=gen))
    plain = build_model(cfg, implementation="torch")
    ref = build_model({**cfg, "bf16": False}, implementation="torch")
    for m in (plain, ref):
        m.load_state_dict(model.state_dict())
    pts = torch.randn(4, 2048, 3, generator=torch.Generator().manual_seed(1))
    pts = (pts / pts.norm(dim=-1).amax(dim=1)[:, None, None]).to(dev)
    lbl = torch.randint(0, 15, (4,), generator=torch.Generator().manual_seed(2)).to(dev)
    losses, grads, vtn = [], [], None
    for m in (model, plain, ref):
        m.to(dev)
        set_trainable(m, renderer_trainable_mask(m))
        _build.reset_launch_counts()
        logits = m(pts, train=True, generator=torch.Generator(device=dev).manual_seed(4))
        loss = cross_entropy_loss(logits, lbl).mean()
        loss.backward()
        counts = _build.launch_counts()
        losses.append(loss.item())
        grads.append({n: p.grad.float() for n, p in m.named_parameters() if p.requires_grad})
        launched = {k for k, v in counts.items() if v > 0}
        if m is model:
            assert counts["mha_qkv"] == 2 and counts["mha_qkv_bwd"] == 2, counts
            assert launched == {"mha_qkv", "mha_qkv_bwd"}, counts
            vtn = {n: g for n, g in grads[0].items() if n.startswith("view_transform_net.")}
        elif m is plain:
            assert not launched, counts
    pre_bn = {f"view_transform_net.enc{i}.bias" for i in range(3)}
    assert len(vtn) == 20 and pre_bn <= set(vtn)
    for n, g in vtn.items():
        assert torch.isfinite(g).all() and (n in pre_bn or g.abs().max() > 0), n
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    flat = lambda g: torch.cat([g[n].flatten() for n in sorted(g) if n not in pre_bn])  # noqa: E731
    first = "view_transform_net.enc0.weight"
    errs = dict(loss=abs(losses[0] - losses[1]) / abs(losses[1]),
                vtn_first=rel(grads[0][first], grads[1][first]),
                kernel_f32=rel(flat(grads[0]), flat(grads[2])),
                plain_f32=rel(flat(grads[1]), flat(grads[2])))
    assert errs["loss"] <= BF16_REL_TOL and errs["vtn_first"] <= 0.5, errs
    assert errs["kernel_f32"] <= 1.5 * errs["plain_f32"], errs


def test_render_gradients_stay_f32_under_tf32(dev):
    """The differentiable render's products run in full f32 in the backward
    too: with TF32 switched on, its output and its gradients with respect to
    the points and both angles equal their values with TF32 off, bit for
    bit."""
    from pointvit_tpu_torch.ops.render import render_diff_views

    gen = torch.Generator().manual_seed(5)
    pts = torch.randn(12, 2048, 3, generator=gen)
    pts = (pts / pts.norm(dim=-1).amax(dim=1)[:, None, None]).to(dev)
    az = (torch.rand(12, generator=gen) * 6.0 - 3.0).to(dev)
    el = (torch.rand(12, generator=gen) * 2.0 - 1.0).to(dev)
    cot = torch.randn(12, 224, 224, generator=gen).to(dev)

    def run(tf32):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            leaves = [t.clone().requires_grad_() for t in (pts, az, el)]
            out = render_diff_views(*leaves, 224)
            out.backward(cot)
            torch.cuda.synchronize()
            return [out.detach()] + [t.grad for t in leaves]
        finally:
            torch.backends.cuda.matmul.allow_tf32 = False

    for got, want in zip(run(True), run(False)):
        assert torch.equal(got, want) and want.abs().max() > 0


def _quant_operands(gen, M, K, N, dtype, dev):
    x = torch.randn(M, K, generator=gen) * 2.0
    x[0], x[1], x[2] = 0.0, 1e-12, 1e6  # zero, tiny and huge rows
    w = torch.randn(N, K, generator=gen) * K**-0.5
    wq, sw = quant_kernel.quantize_weight(w.to(dev))
    return x.to(dev, dtype), wq, sw, torch.randn(N, generator=gen).to(dev)


@pytest.mark.parametrize("M,K,N", [(196, 768, 2304), (980, 768, 768), (8192, 3072, 768),
                                   (6272 * 16, 256, 512), (100, 48, 40),
                                   # off every tile size (128 rows, 128 columns, 128-byte K steps)
                                   (333, 208, 200), (129, 3072, 130), (3, 144, 8),
                                   # the eight int8 layers of quantized APF slim2 at a small M
                                   (300, 256, 512), (300, 512, 768), (300, 768, 384),
                                   (300, 384, 768), (300, 768, 2304), (300, 768, 768),
                                   (300, 768, 3072), (300, 3072, 768)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("with_bias", [True, False])
def test_quant_dense_is_bit_equal_to_its_plain_version(dev, M, K, N, dtype, with_bias):
    gen = torch.Generator().manual_seed(M + K + N)
    x, wq, sw, bias = _quant_operands(gen, M, K, N, dtype, dev)
    bias = bias if with_bias else None
    _build.reset_launch_counts()
    got = quant_kernel.quant_dense(x, wq, sw, bias)
    assert _build.launch_counts()["quant_dense"] == 1 and got.dtype == dtype
    want = quant_kernel.reference_quant_dense(x, wq, sw, bias)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16 if dtype == torch.bfloat16 else torch.int32),
                       want.view(torch.int16 if dtype == torch.bfloat16 else torch.int32))
    assert torch.equal(quant_kernel.quant_dense(x, wq, sw, bias, torch.float32),
                       quant_kernel.reference_quant_dense(x, wq, sw, bias, torch.float32))


def test_quant_dense_takes_more_row_tiles_than_a_grid_dimension(dev):
    # 65538 tiles of 128 rows: past the 65535 of a grid's second dimension.
    M = 65537 * 128 + 3
    gen = torch.Generator().manual_seed(65537)
    x = torch.randn(M, 16, generator=gen).to(dev, torch.bfloat16)
    wq, sw = quant_kernel.quantize_weight(torch.randn(8, 16, generator=gen).to(dev))
    got = quant_kernel.quant_dense(x, wq, sw)
    want = quant_kernel.reference_quant_dense(x, wq, sw)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), want.view(torch.int16))


def test_quantized_weights_on_the_card_equal_the_cpus(dev):
    w = torch.randn(2304, 768, generator=torch.Generator().manual_seed(3)) * 0.03
    w[5] = 0.0
    wq, sw = quant_kernel.quantize_weight(w.to(dev))
    cq, cs = quant_kernel.quantize_weight(w)
    assert torch.equal(wq.cpu(), cq) and torch.equal(sw.cpu().view(torch.int32), cs.view(torch.int32))
    x = torch.randn(512, 768, generator=torch.Generator().manual_seed(4))
    xq, sx = quant_kernel.quantize_rows(x.to(dev))
    cxq, csx = quant_kernel.quantize_rows(x)
    assert torch.equal(xq.cpu(), cxq) and torch.equal(sx.cpu().view(torch.int32), csx.view(torch.int32))


def test_quant_dense_refuses_what_it_does_not_take(dev):
    gen = torch.Generator().manual_seed(5)
    x, wq, sw, bias = _quant_operands(gen, 64, 96, 32, torch.bfloat16, dev)
    with pytest.raises(ValueError, match="CUDA"):
        quant_kernel.quant_dense(x, wq.cpu(), sw, bias)
    with pytest.raises(ValueError, match="bf16 or f32"):
        quant_kernel.quant_dense(x.half(), wq, sw, bias)
    with pytest.raises(ValueError, match="int8"):
        quant_kernel.quant_dense(x, wq.float(), sw, bias)
    with pytest.raises(ValueError, match="wq"):
        quant_kernel.quant_dense(x, wq[:, :64].contiguous(), sw, bias)


def test_quantized_block_runs_the_quant_and_attention_kernels(dev):
    from pointvit_tpu_torch.nn.vit import APFBlock

    gen = torch.Generator().manual_seed(6)
    blk = APFBlock(768, 12, dtype=torch.bfloat16, quantized=True)
    plain = APFBlock(768, 12, dtype=torch.bfloat16, quantized=True, implementation="torch")
    with torch.no_grad():
        for p in blk.parameters():
            p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[-1] ** -0.5 if p.dim() == 2 else 0.2))
    plain.load_state_dict(blk.state_dict())
    blk, plain = blk.to(dev).eval(), plain.to(dev).eval()
    x = _rand(gen, 4, 196, 768, dev=dev)
    with torch.inference_mode():
        _build.reset_launch_counts()
        got = blk(x)
        counts = _build.launch_counts()
        want = plain(x)
    assert counts["quant_dense"] == 4 and counts["mha_qkv"] == 1
    assert counts["apf_block"] == 0 and counts["gemm"] == 0
    _assert_rel(got, want)


def test_apf_group_above_2048_points_takes_the_exact_topk(dev):
    from pointvit_tpu_torch.ops.group import apf_group

    pts = torch.randn(4, 4096, 3, generator=torch.Generator().manual_seed(7)).to(dev)
    _build.reset_launch_counts()
    neigh, center = apf_group(pts, pts, 196, 16)
    counts = _build.launch_counts()
    assert counts["fps"] == 1 and counts["knn"] == 0
    assert neigh.shape == (4, 196, 16, 6) and center.shape == (4, 196, 3)
    plain, _ = apf_group(pts, pts, 196, 16, implementation="torch")
    torch.cuda.synchronize()
    assert torch.equal(neigh, plain)


@pytest.mark.parametrize("N", [16384, 20000])
def test_fps_above_shared_memory_selects_like_the_plain_version(dev, N):
    gen = torch.Generator().manual_seed(N)
    xyz = torch.randn(3, N, 3, generator=gen).to(dev)
    xyz[:, 900:910] = xyz[:, 800:801]  # exact duplicates: ties to the lowest index
    start = torch.randint(0, N, (3,), generator=gen, dtype=torch.int32).to(dev)
    _build.reset_launch_counts()
    got = fps_kernel.fps(xyz, 512, start)
    assert _build.launch_counts()["fps"] == 1
    torch.cuda.synchronize()
    assert torch.equal(got, fps_kernel.reference_fps(xyz, 512, start))


@pytest.mark.parametrize("K", [6, 40, 100])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quant_dense_at_any_k_is_bit_equal_to_its_plain_version(dev, K, dtype):
    gen = torch.Generator().manual_seed(K)
    x, wq, sw, bias = _quant_operands(gen, 300, K, 72, dtype, dev)
    got = quant_kernel.quant_dense(x, wq, sw, bias)
    want = quant_kernel.reference_quant_dense(x, wq, sw, bias)
    torch.cuda.synchronize()
    view = torch.int16 if dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(view), want.view(view))


def _attn_weights(gen, E, dev, dtype=torch.float32):
    return (_rand(gen, E, 3 * E, dev=dev, dtype=dtype, scale=E**-0.5),
            _rand(gen, 3 * E, dev=dev, dtype=dtype, scale=0.2),
            _rand(gen, E, E, dev=dev, dtype=dtype, scale=E**-0.5),
            _rand(gen, E, dev=dev, dtype=dtype, scale=0.2))


@pytest.mark.parametrize("B,S,E", [(4, 196, 768), (6, 197, 768), (2, 513, 384), (2, 736, 768), (3, 37, 128)])
def test_attn_block_matches_its_plain_version_forward_and_backward(dev, B, S, E):
    gen = torch.Generator().manual_seed(S + E)
    H = E // 64
    x = _rand(gen, B, S, E, dev=dev, scale=2.0)
    w = _attn_weights(gen, E, dev)
    g = _rand(gen, B, S, E, dev=dev)
    grads = []
    for impl in (None, "torch"):
        args = [t.clone().requires_grad_() for t in (x, *w)]
        _build.reset_launch_counts()
        out = attention_kernel.fused_attention_block(*args, H, implementation=impl)
        out.backward(g)
        counts = _build.launch_counts()
        assert (counts["attn_block"], counts["gemm"], counts["mha_qkv_bwd"]) == (
            (1, 1, 1) if impl is None else (0, 0, 0))
        grads.append((out.detach(), *(a.grad for a in args)))
    for got, want in zip(*grads):
        assert got.dtype == want.dtype
        _assert_rel(got, want)


def test_attn_block_keeps_qkv_out_of_device_memory_and_refuses_what_it_does_not_take(dev):
    gen = torch.Generator().manual_seed(9)
    B, S, E = 64, 196, 768
    x = _rand(gen, B, S, E, dev=dev)
    w = _attn_weights(gen, E, dev, torch.bfloat16)
    attention_kernel.attn_block(x, *w, 12)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out, o = attention_kernel.attn_block(x, *w, 12)
    torch.cuda.synchronize()
    # o, out and the two launch-ready weight copies; a (B, S, 3E) qkv would add 3·B·S·E·2 bytes
    assert torch.cuda.max_memory_allocated() - before < 3 * B * S * E * 2
    assert attention_kernel.attn_block_max_seq(64) == 736
    with pytest.raises(ValueError, match="S ≤ 736"):
        attention_kernel.attn_block(_rand(gen, 1, 737, E, dev=dev), *w, 12)
    with pytest.raises(ValueError, match="head_dim 64"):
        attention_kernel.attn_block(x, *w, 24)
    with pytest.raises(ValueError, match="bf16"):
        attention_kernel.attn_block(x.float(), *w, 12)


def test_fused_mha_runs_both_attention_kernels(dev):
    gen = torch.Generator().manual_seed(10)
    q, k, v = (_rand(gen, 3, 577, 6, 64, dev=dev, scale=2.0) for _ in range(3))
    g = _rand(gen, 3, 577, 6, 64, dev=dev)
    results = []
    for impl in (None, "torch"):
        args = [t.clone().requires_grad_() for t in (q, k, v)]
        _build.reset_launch_counts()
        out = attention_kernel.fused_mha(*args, implementation=impl)
        out.backward(g)
        counts = _build.launch_counts()
        assert (counts["mha_qkv"], counts["mha_qkv_bwd"]) == ((1, 1) if impl is None else (0, 0))
        results.append((out.detach(), *(a.grad for a in args)))
    for got, want in zip(*results):
        _assert_rel(got, want)


# ---- f32 models and head dims other than 64: csrc/attention_any.cu, the
# f32 GEMM instance, the LayerNorms in f32; P3Embed off its kernel's shapes;
# the blocks' cached launch weights.

F32_REL_TOL = 2.0**-12  # kernel and plain version differ in f32 summation order only


# The key and query tiles' edges (S = 1, 63, 64, 65, 513 against 64-row
# blocks and 64-, 32- or 16-row tiles), ragged and padded head dims (D = 1,
# 7 and 100 pad to 8 or 16, 128 and 256; 256 takes two column chunks in
# the keys launch), and the copy widths they imply (bf16 at odd D copies
# element by element).
@pytest.mark.parametrize("D,S", [(8, 196), (16, 33), (32, 513), (64, 197), (100, 65), (128, 197),
                                 (256, 40)] + [(D, S) for D in (1, 7, 100, 256) for S in (1, 63, 64, 65, 513)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_any_matches_its_plain_version_and_repeats_bit_for_bit(dev, D, S, dtype):
    heads = max(1, 256 // D)
    gen = torch.Generator().manual_seed(D * 1000 + S)
    qkv = _rand(gen, 3, S, 3 * heads * D, dev=dev, dtype=dtype, scale=2.0)
    g = _rand(gen, 3, S, heads * D, dev=dev, dtype=dtype)
    _check_attention_any(qkv, g, heads, 0 if block_kernel.wgmma_attention(dtype, D) else 2)


def _check_attention_any(qkv, g, heads, launches):
    """Forward and backward twice: ``launches`` of each any-head-dim kernel;
    out, dq, dk and dv each within its tolerance of the plain version's
    (f32 2^-12, bf16 2^-6 of its own max|ref|), two runs bit-equal."""
    dtype = qkv.dtype
    _build.reset_launch_counts()
    out, out2 = (attention_kernel.mha_qkv(qkv, heads) for _ in range(2))
    dqkv, dqkv2 = (attention_kernel.mha_qkv_bwd(qkv, g, heads) for _ in range(2))
    counts = _build.launch_counts()
    assert counts["attention_any"] == launches and counts["attention_any_bwd"] == launches, counts
    tol = BF16_REL_TOL if dtype == torch.bfloat16 else F32_REL_TOL
    assert out.dtype == dqkv.dtype == dtype
    _assert_rel(out, attention_kernel.reference_mha_qkv(qkv, heads), tol)
    want = attention_kernel.reference_mha_qkv_bwd(qkv, g, heads)
    E = g.shape[-1]
    for i in range(3):  # dq, dk, dv each against its own scale
        part = want[..., i * E:(i + 1) * E]
        # At S = 1 the softmax of one key has no gradient: dq and dk are zero
        # in the plain version, and the kernel's f32 rounding of dP - delta is
        # held against the scale of the whole gradient.
        scale = (part if part.any() else want).float().abs().max()
        err = (dqkv[..., i * E:(i + 1) * E].float() - part.float()).abs().max() / scale
        assert err <= tol, f"part {i}: max|d| / max|ref| = {err.item():.3g} > {tol:.3g}"
    assert torch.equal(out, out2) and torch.equal(dqkv, dqkv2)


@pytest.mark.parametrize("B,heads,D", [(65535, 1, 8), (1, 65535, 1)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_attention_any_at_the_grid_limits(dev, B, heads, D, dtype):
    """The grid is (S / 64, H, B): 65,535 clouds or heads are taken, one more
    is refused by the wrappers before any launch."""
    gen = torch.Generator().manual_seed(B + heads)
    qkv = _rand(gen, B, 5, 3 * heads * D, dev=dev, dtype=dtype, scale=2.0)
    g = _rand(gen, B, 5, heads * D, dev=dev, dtype=dtype)
    _check_attention_any(qkv, g, heads, 2)
    if B > 1:
        big, gbig = torch.zeros(B + 1, 1, 3 * D, device=dev, dtype=dtype), torch.zeros(B + 1, 1, D, device=dev,
                                                                                         dtype=dtype)
    else:
        big = torch.zeros(1, 1, 3 * (heads + 1) * D, device=dev, dtype=dtype)
        gbig = torch.zeros(1, 1, (heads + 1) * D, device=dev, dtype=dtype)
    h = heads + (B == 1)
    _build.reset_launch_counts()
    with pytest.raises(ValueError, match="at most 65535 clouds and 65535 heads"):
        attention_kernel.mha_qkv(big, h)
    with pytest.raises(ValueError, match="at most 65535 clouds and 65535 heads"):
        attention_kernel.mha_qkv_bwd(big, gbig, h)
    assert _build.launch_counts()["attention_any"] == 0


def test_attention_any_at_the_f32_pix4point_block0_shape(dev):
    """The f32 Pix4Point's block-0 attention, (32, 513, 3 x 384) with 6 heads
    of 64: the any-head-dim kernels (not the bf16 wgmma ones) take it, within
    2^-12 in both directions."""
    gen = torch.Generator().manual_seed(513)
    qkv = _rand(gen, 32, 513, 3 * 384, dev=dev, dtype=torch.float32, scale=2.0)
    g = _rand(gen, 32, 513, 384, dev=dev, dtype=torch.float32)
    assert not block_kernel.wgmma_attention(torch.float32, 64)
    _check_attention_any(qkv, g, 6, 2)


def _f32_case(gen, M, K, N, epilogue, dev):
    """Operands and keyword arguments of one f32 GEMM case."""
    f32 = torch.float32
    a, w = _rand(gen, M, K, dev=dev, dtype=f32), _rand(gen, N, K, dev=dev, dtype=f32, scale=K**-0.5)
    bias = _rand(gen, N, dev=dev, dtype=f32)
    kw = {"gelu": dict(act="gelu", out_dtype=f32),
          "res_pre": dict(res=_rand(gen, M, N, dev=dev, dtype=f32), out_dtype=f32),
          "res_x2_relu": dict(res=_rand(gen, M, N, dev=dev, dtype=f32), res_scale=2.0, act="relu",
                              out_dtype=f32),
          "row_res": dict(res=_rand(gen, M // 16, N, dev=dev, dtype=f32), res_div=16, act="relu",
                          out_dtype=f32),
          "max_per_2": dict(act="relu", group=2, out_dtype=f32),
          "max_per_32": dict(group=32, out_dtype=None),
          "max_per_128": dict(act="gelu", group=128, out_dtype=f32)}[epilogue]
    return a, w, bias, kw


# The shapes of test_gemm_off_the_tiles; M cut to a multiple of the group
# where the epilogue takes one.
@pytest.mark.parametrize("M,K,N", [(985, 768, 64), (985, 64, 96), (985, 8, 768), (197, 64, 2304),
                                   (985, 3072, 768)])
@pytest.mark.parametrize("epilogue", ["gelu", "res_pre", "res_x2_relu", "row_res", "max_per_2",
                                      "max_per_32"])
def test_gemm_f32_off_the_tiles(dev, M, K, N, epilogue):
    if epilogue in ("row_res", "max_per_32"):
        M -= M % 32
    elif epilogue == "max_per_2":
        M -= M % 2
    _check_f32(dev, M, K, N, epilogue)


def _check_f32(dev, M, K, N, epilogue, instance=None):
    """One f32 GEMM case, launched twice: each output within F32_REL_TOL of
    the plain version's, the two runs bit-equal."""
    gen = torch.Generator().manual_seed(11 * M + K + N)
    a, w, bias, kw = _f32_case(gen, M, K, N, epilogue, dev)
    pre = [torch.empty(M, N, device=dev) for _ in range(3)] if epilogue == "res_pre" else [None] * 3
    _build.reset_launch_counts()
    got = gemm(a, w, bias, pre_out=pre[0], instance=instance, **kw)
    again = gemm(a, w, bias, pre_out=pre[1], instance=instance, **kw)
    counts = _build.launch_counts()
    assert counts["gemm_f32"] == 2 and counts["gemm"] == 0
    want = reference_gemm(a, w, bias, pre_out=pre[2], **kw)
    for g, g2, ref in zip((*got, pre[0]), (*again, pre[1]), (*want, pre[2])):
        assert (g is None) == (ref is None)
        if g is not None:
            assert g.dtype == torch.float32 and g.shape == ref.shape
            _assert_rel(g, ref, F32_REL_TOL)
            assert torch.equal(g, g2)


# K = 4 (one mostly zero TMA box), one row, the group max over 128 rows, and
# the f32 Pix4Point's fc1.
@pytest.mark.parametrize("M,K,N,epilogue", [
    (985, 4, 96, "gelu"), (985, 4, 64, "res_pre"), (1024, 4, 768, "max_per_32"),
    (1, 384, 1536, "gelu"), (1, 64, 64, "res_x2_relu"), (1, 8, 96, "res_pre"),
    (1024, 384, 96, "max_per_128"), (1024, 64, 64, "max_per_128"), (16416, 384, 1536, "gelu"),
])
def test_gemm_f32_at_more_shapes(dev, M, K, N, epilogue):
    _check_f32(dev, M, K, N, epilogue)


@pytest.mark.parametrize("instance", ["128x64", "128x128"])
@pytest.mark.parametrize("M,K,N,epilogue", [(985, 64, 64, "res_pre"), (985, 384, 96, "gelu"),
                                            (2048, 64, 64, "max_per_32"), (985, 8, 200, "row_res")])
def test_gemm_f32_each_instance_on_the_same_product(dev, M, K, N, epilogue, instance):
    if epilogue in ("row_res", "max_per_32"):
        M -= M % 32
    _check_f32(dev, M, K, N, epilogue, instance)


@pytest.mark.parametrize("M,K,N", [(985, 3072, 768), (16416, 384, 1536), (300, 8, 256)])
def test_gemm_f32_keeps_f32_accuracy(dev, M, K, N):
    """3xTF32 against the exact product (f64): within 2^-14 of max|ref|
    (2.2e-5 measured at K = 3072 on an H100), where one TF32 product alone
    errs by 3.5e-4 to 1.1e-3 (tools/gemm_f32_ab's 1xTF32 variant)."""
    gen = torch.Generator().manual_seed(M + K)
    a = _rand(gen, M, K, dev=dev, dtype=torch.float32)
    w = _rand(gen, N, K, dev=dev, dtype=torch.float32, scale=K**-0.5)
    got, _ = gemm(a, w, out_dtype=torch.float32)
    _assert_rel(got, a.double() @ w.double().t(), 2.0**-14)


def test_layer_norms_in_f32(dev):
    gen = torch.Generator().manual_seed(32)
    x = _rand(gen, 2 * 513, 384, dev=dev, dtype=torch.float32, scale=3.0)
    pos = _rand(gen, 513, 384, dev=dev, dtype=torch.float32)
    g, b = _rand(gen, 384, dev=dev, dtype=torch.float32), _rand(gen, 384, dev=dev, dtype=torch.float32)
    _assert_rel(block_kernel.layer_norm(x, g, b), block_kernel.reference_layer_norm(x, g, b), F32_REL_TOL)
    for got, want in zip(block_kernel.pos_layer_norm(x, pos, g, b),
                         block_kernel.reference_pos_layer_norm(x, pos, g, b)):
        assert got.dtype == torch.float32
        _assert_rel(got, want, F32_REL_TOL)


def _serve_both(dev, cfg, pts, buckets):
    """Logits of a seeded model on the kernel path and the plain path, and
    the kernel path's launch counts."""
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.serve import InferenceSession

    torch.manual_seed(0)
    model = build_model(cfg)
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():  # live BN statistics and adapters
        for name, t in model.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif name.endswith("up_proj.weight"):
                t.copy_(0.05 * torch.randn(t.shape, generator=gen))
    plain = build_model(cfg, implementation="torch")
    plain.load_state_dict(model.state_dict())
    _build.reset_launch_counts()
    got = InferenceSession(model, buckets=buckets).predict_logits(pts)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    want = InferenceSession(plain, buckets=buckets).predict_logits(pts)
    return got, want, counts


APF_F32 = dict(num_classes=15, in_channels=3, embedding_dim=768, npoint=196, nsample=16, depth=2,
               num_heads=12, encoder_second_width=384, bf16=False)
P4P_F32 = dict(pretrained_model="vit_small_patch16_384", num_classes=15, k_neighbors=16,
               embed_dim=384, depth=2, bf16=False)


@pytest.mark.parametrize("cfg,points,kernels", [
    (APF_F32, 1024, ("group_encoder_chain", "apf_block", "layernorm")),
    (P4P_F32, 2048, ("p3_embed_chain", "vit_block", "pos_layernorm", "layernorm")),
])
def test_f32_models_serve_through_the_kernels(dev, cfg, points, kernels):
    """f32 served logits within 1 % of the largest, argmax equal: the f32
    GEMM, the f32 LayerNorms and the any-head-dim attention (head dim 64 in
    f32) launch; the bf16 GEMM and attention never."""
    import numpy as np

    pts = np.random.default_rng(2).standard_normal((8, points, 3)).astype(np.float32)
    got, want, counts = _serve_both(dev, cfg, pts, (8,))
    for name in (*kernels, "gemm_f32", "attention_any"):
        assert counts[name] > 0, (name, counts)
    assert counts["gemm"] == 0 and counts["attention"] == 0, counts
    assert counts["group_stack"] == 0 and counts["group_head"] == 0, counts
    assert np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 0.01 and (got.argmax(-1) == want.argmax(-1)).all(), err


def test_head_dim_16_model_serves_and_trains_through_the_any_head_dim_kernels(dev):
    """The train_step_bench small config (E 64, 4 heads of 16, f32): serving
    takes the unfused blocks with attention_any; a training step launches
    the any-head-dim forward and backward, and its gradients agree with the
    plain path's."""
    import numpy as np

    from pointvit_tpu_torch.models import AdaptPointFormer, apf_trainable_mask
    from pointvit_tpu_torch.train.trainer import set_trainable

    cfg = dict(APF_F32, embedding_dim=64, npoint=32, nsample=32, num_heads=4, encoder_second_width=64)
    pts = np.random.default_rng(3).standard_normal((8, 256, 3)).astype(np.float32)
    got, want, counts = _serve_both(dev, cfg, pts, (8,))
    assert counts["attention_any"] == 2 and counts["apf_block"] == 0 and counts["gemm_f32"] > 0, counts
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 0.01 and (got.argmax(-1) == want.argmax(-1)).all(), err

    kw = dict(num_classes=15, embedding_dim=64, npoint=32, nsample=32, depth=2, num_heads=4,
              encoder_second_width=64, dtype=torch.float32)
    torch.manual_seed(0)
    model = AdaptPointFormer(**kw).to(dev)
    plain = AdaptPointFormer(**kw, implementation="torch").to(dev)
    plain.load_state_dict(model.state_dict())
    x = torch.from_numpy(pts).to(dev)
    grads = []
    for m in (model, plain):
        set_trainable(m, apf_trainable_mask(m))
        _build.reset_launch_counts()
        logits = m(x, train=True, generator=torch.Generator(device=dev).manual_seed(2))
        logits.logsumexp(-1).mean().backward()
        counts = _build.launch_counts()
        grads.append(torch.cat([p.grad.flatten() for p in m.parameters() if p.grad is not None]))
        n = 2 if m is model else 0
        assert counts["attention_any"] == n and counts["attention_any_bwd"] == n, counts
    err = (grads[0] - grads[1]).norm() / grads[1].norm()
    assert err <= 1e-4, f"gradient relative L2 error {err.item():.3g}"


@pytest.mark.parametrize("cfg,points,kernels", [
    (dict(APF_F32, bf16=True, nsample=24, embedding_dim=384, num_heads=6),
     1024, ("group_encoder", "group_stack", "group_head")),
    (dict(APF_F32, bf16=True, nsample=24, embedding_dim=384, num_heads=6, encoder_second_width=768),
     1024, ("group_encoder_chain",)),
    (dict(P4P_F32, bf16=True, k_neighbors=24), 2048, ("p3_embed", "group_stack", "group_head")),
])
def test_groups_of_24_serve_through_the_kernels(dev, cfg, points, kernels):
    """Groups of 24 (APF nsample 24: ``k24``, ``slim_k24``, ``stack``;
    Pix4Point ``k_neighbors=24``) serve on the card: padded with copies of
    their first row to 32, they take the group-MLP kernels where the widths
    fit them (H = 384; P3's H = 512), else the GEMM chain (``slim_k24``'s H
    = 768); logits held against the plain path as Pix4Point's are."""
    import numpy as np

    pts = np.random.default_rng(24).standard_normal((8, points, 3)).astype(np.float32)
    got, want, counts = _serve_both(dev, cfg, pts, (8,))
    for name in (*kernels, "fps", "knn"):
        assert counts[name] > 0, (name, counts)
    assert got.shape == (8, 15) and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 0.05 and (got.argmax(-1) == want.argmax(-1)).mean() >= 0.75, err


@pytest.mark.parametrize("K,plan", [(3, True), (24, True), (40, True), (100, False), (130, False)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_groups_of_any_size_take_a_padded_route(dev, K, plan, dtype):
    """The encoder and the P3 stage at group sizes off their kernels'
    (K 3, 24, 40 padded for the group-MLP kernels in bf16 and to 4, 32, 64
    for the chain in f32; 100 to 128 for the chain; 130, above a tile: the
    chain's products without their group max, which follows them) against
    their plain versions on the unpadded groups."""
    gen = torch.Generator().manual_seed(K)
    cases = [(encoder_kernel, _apf_encoder_weights(gen, dev), encoder_kernel.reference_folded_encoder, 48),
             (p3_kernel, p3_kernel.fold_p3_stage_params(_p3_stage(gen, dev)), p3_kernel.reference_folded_p3, 64)]
    for mod, w, ref, M in cases:
        x = _rand(gen, M, K, 6, dev=dev, dtype=dtype)
        fused = mod.fused_group_encoder if mod is encoder_kernel else mod.fused_p3_embed
        _build.reset_launch_counts()
        got = fused(x, w)
        counts = _build.launch_counts()
        takes_plan = plan and dtype == torch.bfloat16
        assert counts["group_stack"] == int(takes_plan), (mod.__name__, counts)
        _assert_rel(got, ref(x, w), BF16_REL_TOL if dtype == torch.bfloat16 else F32_REL_TOL)


@pytest.mark.parametrize("clouds,points", [(1, 1000), (8, 1004)])
def test_pix4point_serves_clouds_off_the_p3_kernel_shapes(dev, clouds, points):
    """S = 250 and 251 tokens: B·S % 16 != 0, so P3Embed runs stage_unfused
    on the card, as the JAX module does; no p3_embed launch."""
    import numpy as np

    cfg = dict(P4P_F32, bf16=True)
    pts = np.random.default_rng(points).standard_normal((clouds, points, 3)).astype(np.float32)
    got, want, counts = _serve_both(dev, cfg, pts, (clouds,))
    assert counts["p3_embed"] == 0 and counts["vit_block"] > 0 and counts["fps"] > 0, counts
    assert got.shape == (clouds, 15) and np.isfinite(got).all()
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= 0.05, err


def test_block_launch_weights_are_kept_and_refreshed_after_an_in_place_update(dev):
    from pointvit_tpu_torch.nn.vit import APFBlock, SerialAdapterBlock, ViTBlock

    gen = torch.Generator().manual_seed(40)
    for blk, E, H in ((ViTBlock(384, 6, dtype=torch.bfloat16), 384, 6), (APFBlock(768, 12, dtype=torch.bfloat16), 768, 12),
                      (SerialAdapterBlock(768, 12, dtype=torch.bfloat16), 768, 12)):
        with torch.no_grad():
            for p in blk.parameters():
                p.copy_(torch.randn(p.shape, generator=gen) * (p.shape[-1] ** -0.5 if p.dim() == 2 else 0.2))
        blk = blk.to(dev).eval()
        x = _rand(gen, 2, 197, E, dev=dev)
        with torch.inference_mode():
            first = blk(x)
            kept = blk._launch._value
            assert blk(x).equal(first) and blk._launch._value is kept
        with torch.no_grad():
            blk.norm2.weight.mul_(2.0) if hasattr(blk, "norm2") else blk.ln_2.weight.mul_(2.0)
        with torch.inference_mode():
            second = blk(x)
        assert blk._launch._value is not kept and not second.equal(first)
        plain = type(blk)(E, H, dtype=torch.bfloat16, implementation="torch").to(dev).eval()
        plain.load_state_dict(blk.state_dict())
        with torch.inference_mode():
            _assert_rel(second, plain(x))


@pytest.mark.parametrize("M,K", [(985, 384), (16 * 513, 384), (300, 1536)])
def test_proj_layer_norm_matches_its_plain_version_and_repeats_bit_for_bit(dev, M, K):
    """The ViT block's proj + residual + LN2 as one launch (width 384): x1
    within one bf16 step, LN2(x1) within BF16_REL_TOL of the plain version
    (its statistics summed in another order), two runs bit-equal."""
    gen = torch.Generator().manual_seed(M + K)
    a, w = _rand(gen, M, K, dev=dev), _rand(gen, 384, K, dev=dev, scale=K**-0.5)
    bias, res = _rand(gen, 384, dev=dev), _rand(gen, M, 384, dev=dev, scale=2.0)
    g, b = _rand(gen, 384, dev=dev, scale=0.5), _rand(gen, 384, dev=dev)
    _build.reset_launch_counts()
    x1, y = vit_block_kernel.proj_layer_norm(a, w, bias, res, g, b)
    x1b, yb = vit_block_kernel.proj_layer_norm(a, w, bias, res, g, b)
    assert _build.launch_counts()["proj_layernorm"] == 2
    want_x1, want_y = vit_block_kernel.reference_proj_layer_norm(a, w, bias, res, g, b)
    _assert_rel(x1, want_x1, 2.0**-7)
    _assert_rel(y, want_y)
    _assert_rel(y, block_kernel.layer_norm(x1, g, b))
    assert torch.equal(x1, x1b) and torch.equal(y, yb)
    with pytest.raises(ValueError, match="w must be"):
        vit_block_kernel.proj_layer_norm(a, w[:256].contiguous(), bias, res, g, b)


_IO_APF = {"num_classes": 15, "in_channels": 3, "embedding_dim": 768, "npoint": 64, "nsample": 16, "depth": 2,
           "num_heads": 12, "encoder_second_width": 384, "bf16": True}


def _io_model(seed):
    from pointvit_tpu_torch.models import build_model

    gen = torch.Generator().manual_seed(seed)
    model = build_model(_IO_APF)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * (t.shape[-1] ** -0.5 if t.dim() == 2 else 0.2))
    return model


@pytest.mark.parametrize("batch", [1, 8, 32])
def test_an_export_on_the_card_runs_the_kernels(dev, batch):
    """A slim2-width APF exported on the card: serving the artifact launches
    the FPS, kNN, group-MLP and block kernels, bit-equal to the live model
    (the same kernels on the same inputs), at every batch of one
    batch-polymorphic program."""
    import numpy as np

    from pointvit_tpu_torch.export import export_forward, load_forward

    model = _io_model(0).to(dev).eval()
    clouds = np.random.default_rng(batch).standard_normal((batch, 1024, 3)).astype(np.float32)
    fn = load_forward(export_forward(model, clouds))
    assert fn.meta["batch"] is None and fn.device == dev
    _build.reset_launch_counts()
    got = fn(clouds)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    for name in ("fps", "knn", "group_encoder", "group_stack", "group_head", "apf_block", "gemm", "layernorm",
                 "attention"):
        assert counts[name] > 0, name
    with torch.inference_mode():
        want = model(torch.from_numpy(clouds).to(dev)).float()
    assert torch.equal(got, want)


def test_a_msgpack_checkpoint_serves_on_the_card_bit_equal_to_the_bridge(dev, tmp_path):
    """A JAX-format checkpoint (the port's writer) served on the card by
    from_checkpoint equals, bit for bit, a session over a model loaded with
    load_flax_variables from its EMA trees."""
    import numpy as np

    from pointvit_tpu_torch.convert import load_flax_variables, state_dict_to_flax
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.serve import InferenceSession
    from pointvit_tpu_torch.train.checkpoint import save_checkpoint

    tree = state_dict_to_flax(_io_model(1))
    rng = np.random.default_rng(2)
    noisy = lambda t: {k: noisy(v) if isinstance(v, dict) else  # noqa: E731
                       (v * (1 + 0.02 * rng.standard_normal(v.shape))).astype(np.float32) for k, v in t.items()}
    ema = {"params": noisy(tree["params"]), "batch_stats": noisy(tree["batch_stats"])}
    path = save_checkpoint(str(tmp_path), "apf.msgpack", epoch=0, accuracy=0.0, model_config=_IO_APF,
                           dataset_config={}, state={**tree, "ema_params": ema["params"],
                                                     "ema_batch_stats": ema["batch_stats"], "step": 1})
    clouds = np.random.default_rng(3).standard_normal((5, 1024, 3)).astype(np.float32)
    got = InferenceSession.from_checkpoint(path, device=dev).predict_logits(clouds)
    want = InferenceSession(load_flax_variables(build_model(_IO_APF), ema), device=dev).predict_logits(clouds)
    np.testing.assert_array_equal(got, want)
    raw = InferenceSession.from_checkpoint(path, device=dev, use_ema=False).predict_logits(clouds)
    np.testing.assert_array_equal(
        raw, InferenceSession(load_flax_variables(build_model(_IO_APF), tree), device=dev).predict_logits(clouds))


def test_a_reference_apf_checkpoint_serves_on_the_card_within_the_serving_gate(dev, tmp_path):
    """train_apf.py's reference-exact APF (in_channels 4, nsample 32, encoder
    second width 2E: its encoder off the group-MLP gate, on the GEMM chain)
    at depth 2, as a reference ``torch.save`` file: served by
    ``Classifier.for_family(reference_checkpoint=)`` on the card within the
    serving gate of the plain path loaded from the same file (max|dlogit|
    within 5 % of max|logit|, argmax equal where the top two differ by more
    than 2^-6 of it), nothing missing, the chain and the blocks launched."""
    import numpy as np

    from pointvit_tpu_torch.inference import Classifier
    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.pretrained import load_reference_apf_checkpoint
    from pointvit_tpu_torch.pretrained.reference_ckpt import reference_state_dict

    cfg = dict(num_classes=15, in_channels=4, embedding_dim=768, npoint=196, nsample=32, depth=2, bf16=True)
    source = build_model(cfg, "apf")
    gen = torch.Generator().manual_seed(7)
    with torch.no_grad():
        for name, t in source.state_dict().items():
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif t.is_floating_point():
                t.copy_(torch.randn(t.shape, generator=gen) * (t.shape[-1] ** -0.5 if t.dim() == 2 else 0.2))
    path = str(tmp_path / "apf_reference.pth")
    torch.save({"model_state_dict": reference_state_dict(source, "apf")}, path)
    clf = Classifier.for_family("apf", cfg, reference_checkpoint=path, batch_size=32, device=dev)
    plain = build_model(cfg, "apf", implementation="torch")
    assert load_reference_apf_checkpoint(plain, path)[1] == []
    rng = np.random.default_rng(8)
    pts = rng.standard_normal((32, 1024, 3)).astype(np.float32)
    clouds = np.concatenate([pts, pts[..., 2:] - pts[..., 2:].min(1, keepdims=True)], -1)
    _build.reset_launch_counts()
    got = clf.logits(clouds)
    torch.cuda.synchronize()
    counts = _build.launch_counts()
    want = Classifier(plain, batch_size=32, device=dev).logits(clouds)
    for name in ("fps", "knn", "group_encoder_chain", "apf_block", "gemm", "attention"):
        assert counts.get(name, 0) > 0, (name, counts)
    scale = np.abs(want).max()
    assert np.isfinite(got).all() and np.abs(got - want).max() <= 0.05 * scale
    top2 = np.sort(want, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2.0**-6 * scale
    assert (got.argmax(-1) == want.argmax(-1))[decided].all()


def test_the_moe_pix4point_trunk_serves_and_trains_through_the_kernels(dev):
    """The MoE trunk (vit_small widths, 4 blocks, every second an MoE block
    of 4 experts, top-2, bf16) serves 8 clouds of 2048 points on the kernel
    path within 0.05 of max|logit| of the plain path, the dense blocks on
    their kernels and the MoE blocks' attention on the attention kernel; a
    training step launches the attention forward and backward and gives
    every router a nonzero gradient, no further from an f32 run than 1.5x
    the plain path's (the bf16 noise of the Pix4Point step test above)."""
    import numpy as np

    from pointvit_tpu_torch.models import build_model
    from pointvit_tpu_torch.nn.moe import collect_moe_aux_loss
    from pointvit_tpu_torch.train import cross_entropy_loss

    cfg = dict(P4P_F32, bf16=True, depth=4, moe_experts=4, moe_every=2)
    pts = np.random.default_rng(3).standard_normal((8, 2048, 3)).astype(np.float32)
    got, want, counts = _serve_both(dev, cfg, pts, (8,))
    for name in ("fps", "knn", "p3_embed", "vit_block", "mha_qkv"):
        assert counts[name] > 0, counts
    assert np.abs(got - want).max() <= 0.05 * np.abs(want).max()

    torch.manual_seed(0)
    model = build_model(cfg).to(dev)
    plain = build_model(cfg, implementation="torch").to(dev)
    ref = build_model({**cfg, "bf16": False}, implementation="torch").to(dev)
    plain.load_state_dict(model.state_dict())
    ref.load_state_dict(model.state_dict())
    x = torch.from_numpy(pts).to(dev)
    lbl = torch.arange(8, device=dev) % 15
    grads = []
    for m in (model, plain, ref):
        _build.reset_launch_counts()
        logits = m(x, train=True, generator=torch.Generator(device=dev).manual_seed(4))
        (cross_entropy_loss(logits, lbl).mean() + 0.01 * collect_moe_aux_loss(m)).backward()
        if m is model:
            c = _build.launch_counts()
            assert c["mha_qkv"] > 0 and c["mha_qkv_bwd"] > 0 and c["vit_block"] == 0, c
        for i in (1, 3):
            assert m.model.blocks[i].mlp.gate.grad.abs().max() > 0
        grads.append(torch.cat([p.grad.float().flatten() for p in m.parameters()]))
    rel = lambda a, b: ((a - b).norm() / b.norm()).item()  # noqa: E731
    assert rel(grads[0], grads[2]) <= 1.5 * rel(grads[1], grads[2])


def test_a_world1_fsdp_step_through_the_kernels_matches_a_step_without(dev, tmp_path):
    """A one-rank NCCL group: an APF step (E 128, 2 heads of 64, 2 blocks,
    bf16) under ``Trainer(fsdp=True)`` against ``Trainer()`` from the same
    seed and batch: the training kernels launch, and the weights after the
    step agree within 1e-6 relative (both run torch's multi-tensor AdamW; at
    one rank FSDP's collectives are copies)."""
    import os

    import numpy as np
    import torch.distributed as dist

    from pointvit_tpu_torch.models import AdaptPointFormer, apf_trainable_mask
    from pointvit_tpu_torch.parallel import make_mesh
    from pointvit_tpu_torch.train import Trainer, build_optimizer, constant_schedule

    cfg = dict(num_classes=15, in_channels=3, embedding_dim=128, npoint=64, nsample=16, depth=2,
               num_heads=2, encoder_second_width=128, dtype=torch.bfloat16)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp_path, "store"), 1),
                            rank=0, world_size=1)
    try:
        torch.manual_seed(0)
        base = AdaptPointFormer(**cfg)
        pts = torch.from_numpy(np.random.default_rng(5).standard_normal((16, 512, 3)).astype(
            np.float32)).to(dev)
        lbl = torch.arange(16, device=dev) % 15
        states = []
        for kw in ({}, {"mesh": make_mesh(), "fsdp": True}):
            model = AdaptPointFormer(**cfg)
            model.load_state_dict(base.state_dict())
            opt = build_optimizer(model, constant_schedule(1e-3), weight_decay=0.05,
                                  trainable_mask=apf_trainable_mask(model), grad_clip=1.0)
            tr = Trainer(model, train_dataset=None, test_dataset=None, optimizer=opt, batch_size=16,
                         epochs=1, output_dir=str(tmp_path), device=dev, train_loader=[],
                         test_loader=[], save_config_snapshot=False, **kw)
            _build.reset_launch_counts()
            tr.train_step(pts, lbl)
            torch.cuda.synchronize()
            c = _build.launch_counts()
            assert c["fps"] > 0 and c["mha_qkv"] > 0 and c["mha_qkv_bwd"] > 0, c
            states.append({k: (v.full_tensor() if hasattr(v, "full_tensor") else v).detach().clone()
                           for k, v in model.state_dict().items()})
        for k, want in states[0].items():
            if want.is_floating_point():
                err = (states[1][k] - want).abs().max() / want.abs().max().clamp_min(1e-30)
                assert err <= 1e-6, (k, err.item())
    finally:
        dist.destroy_process_group()
