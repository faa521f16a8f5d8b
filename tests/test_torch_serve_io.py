"""The rest of serving, on the CPU: ``Classifier`` against the JAX
package's on one JAX-format checkpoint, the ``MicroBatcher`` (concurrent
submits, shapes mixed in one tick, an error kept to its own group, late
callers failed by ``close``), and ``torch.export`` (the kernels' custom ops,
each fake implementation checked against the op on CPU inputs; round trips
at batch 1, 3 and 8; a fixed batch; the file and ``from_exported``; the
artifact against the JAX package's own exported artifact of the same
weights; the live model's caches untouched by an export). The export CLI
runs in ``tests/test_torch_serve_http.py``, whose server CLI serves its
artifact.

Small sizes: APF depth 2, E 32, npoint 16, nsample 8, 64 points, f32; the
JAX side under ``jax.default_matmul_precision("highest")`` and held within
1e-4 of the largest logit. An exported program runs the same plain
versions as the live model on the CPU, so their logits are held equal.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pointvit_tpu.export import export_forward as jexport_forward
from pointvit_tpu.export import load_forward as jload_forward
from pointvit_tpu.inference import Classifier as JClassifier
from pointvit_tpu.models import factory as jfactory
from pointvit_tpu_torch import _build
from pointvit_tpu_torch.convert import state_dict_to_flax
from pointvit_tpu_torch.export import export_forward, load_exported, load_forward, save_exported
from pointvit_tpu_torch.inference import Classifier
from pointvit_tpu_torch.models import Pix4Point, build_model
from pointvit_tpu_torch.nn.pointnet import GroupFeatureEncoder, P3Embed
from pointvit_tpu_torch.nn.quant import QuantLinear, quantize_weight
from pointvit_tpu_torch.nn.vit import APFBlock, SerialAdapterBlock, ViTBlock
from pointvit_tpu_torch.ops import block_kernel, encoder_kernel, p3_kernel
from pointvit_tpu_torch.ops.serial_block_kernel import serial_block_weights
from pointvit_tpu_torch.ops.vit_block_kernel import vit_block_weights
from pointvit_tpu_torch.serve import InferenceSession, MicroBatcher
from pointvit_tpu_torch.train.checkpoint import save_checkpoint

LOGIT_REL_TOL = 1e-4
N_POINTS = 64
APF_CONFIG = {"num_classes": 15, "in_channels": 3, "embedding_dim": 32, "npoint": 16, "nsample": 8,
              "depth": 2, "num_heads": 1, "encoder_second_width": 64, "bf16": False}


def _clouds(seed, n, points=N_POINTS):
    return np.random.default_rng(seed).standard_normal((n, points, 3)).astype(np.float32)


def _randomize(model, seed):
    """Random weights everywhere (variances positive): zero-init adapters
    and unit statistics would hide a fault."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, t in list(model.named_parameters()) + list(model.named_buffers()):
            if name.endswith("running_var"):
                t.copy_(0.5 + torch.rand(t.shape, generator=gen))
            elif t.is_floating_point():
                t.copy_(0.3 * torch.randn(t.shape, generator=gen))
    return model.eval()


@pytest.fixture(scope="module")
def apf(tmp_path_factory):
    """A random APF and a JAX-format checkpoint of it (written by the port:
    raw weights, EMA weights = raw + noise, a sidecar)."""
    model = _randomize(build_model(APF_CONFIG), 0)
    tree = state_dict_to_flax(model)
    rng = np.random.default_rng(1)
    noisy = lambda t: jax.tree.map(lambda a: (a + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), t)  # noqa: E731
    state = {"params": tree["params"], "batch_stats": tree["batch_stats"], "opt_state": {}, "step": 1,
             "ema_params": noisy(tree["params"]), "ema_batch_stats": tree["batch_stats"]}
    path = save_checkpoint(str(tmp_path_factory.mktemp("ckpt")), "apf.msgpack", epoch=0, accuracy=0.0,
                           state=state, model_config=APF_CONFIG, dataset_config={})
    return model, path


# ---------------------------------------------------------------- Classifier


def test_classifier_matches_the_jax_classifier_on_a_checkpoint(apf):
    _, path = apf
    clouds = _clouds(2, 5)
    with jax.default_matmul_precision("highest"):
        jclf = JClassifier.for_family("apf", APF_CONFIG, checkpoint=path, batch_size=4, bf16=False,
                                      example_points=N_POINTS)
        want = jclf.logits(clouds)
    clf = Classifier.for_family("apf", APF_CONFIG, checkpoint=path, batch_size=4, bf16=False, device="cpu")
    got = clf.logits(clouds)
    assert got.shape == want.shape == (5, 15)
    assert np.abs(got - want).max() <= LOGIT_REL_TOL * np.abs(want).max()
    np.testing.assert_array_equal(clf.predict(clouds), got.argmax(-1))
    np.testing.assert_allclose(clf.predict_proba(clouds).sum(-1), 1.0, rtol=1e-6)
    raw = Classifier.for_family("apf", APF_CONFIG, checkpoint=path, batch_size=4, bf16=False, device="cpu",
                                use_ema=False)
    assert np.abs(raw.logits(clouds) - got).max() > 100 * LOGIT_REL_TOL * np.abs(want).max()
    with pytest.raises(FileNotFoundError):  # a reference checkpoint is read (tests/test_torch_reference_ckpt.py)
        Classifier.for_family("apf", APF_CONFIG, reference_checkpoint="absent.pt", device="cpu")


# ------------------------------------------------------------- MicroBatcher


@pytest.fixture(scope="module")
def session(apf):
    return InferenceSession(apf[0], buckets=(4, 8), device="cpu")


def test_microbatcher_concurrent_submits_equal_predict_logits(session):
    clouds = _clouds(3, 9)
    want = session.predict_logits(clouds)
    results = [None] * len(clouds)
    with MicroBatcher(session, max_batch=4, max_delay_ms=20) as mb:
        threads = [threading.Thread(target=lambda i=i: results.__setitem__(i, mb.submit(clouds[i])))
                   for i in range(len(clouds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    for i in range(len(clouds)):
        np.testing.assert_allclose(results[i], want[i], rtol=1e-5, atol=1e-6)


def test_microbatcher_groups_a_tick_by_shape_and_keeps_an_error_to_its_group(session):
    """Clouds of 64 and 48 points (and one of 8 points, fewer than the
    model's 16 centres) in one tick: each shape is its own call, and only
    the callers of the failing shape get its error."""
    rng = np.random.default_rng(4)
    clouds = [rng.standard_normal((n, 3)).astype(np.float32) for n in (64, 48, 64, 8, 48)]
    results = [None] * len(clouds)

    def worker(i):
        try:
            results[i] = mb.submit(clouds[i])
        except Exception as e:  # the failing group's callers
            results[i] = e

    with MicroBatcher(session, max_batch=8, max_delay_ms=200) as mb:
        threads = [threading.Thread(target=worker, args=(i,)) for i in range(len(clouds))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
    assert isinstance(results[3], ValueError)
    for i, cloud in enumerate(clouds):
        if i != 3:
            np.testing.assert_allclose(results[i], session.predict_logits(cloud[None])[0], rtol=1e-5, atol=1e-6)


def test_microbatcher_close_fails_late_callers(session):
    mb = MicroBatcher(session)
    done, slot = threading.Event(), [None, None]
    real_join = mb._thread.join

    def join_then_a_late_submit(timeout=None):
        # a submit that passed the closed check enqueues after the loop exits
        real_join(timeout)
        mb._queue.put((_clouds(5, 1)[0], done, slot))

    mb._thread.join = join_then_a_late_submit
    mb.close()
    assert done.is_set() and isinstance(slot[1], RuntimeError)
    with pytest.raises(RuntimeError, match="closed"):
        mb.submit(_clouds(5, 1)[0])


# ---------------------------------------------------- the kernels' custom ops


def _op_cases():
    """(op name, CPU arguments) for every custom op of the kernels."""
    g = torch.Generator().manual_seed(0)
    r = lambda *s: torch.randn(*s, generator=g)  # noqa: E731
    pts = r(2, 64, 3)
    qkv, g3 = r(2, 5, 24), r(2, 5, 8)
    apf_block = APFBlock(8, 2)
    enc = GroupFeatureEncoder(6, 16, 16)
    p3 = P3Embed(3, k=8)
    vit = ViTBlock(64, 1)
    serial = SerialAdapterBlock(64, 1, 8)
    with torch.no_grad():  # live BatchNorm statistics
        for m in (enc, p3):
            for name, b in m.named_buffers():
                if name.endswith("running_var"):
                    b.copy_(0.5 + torch.rand(b.shape, generator=g))
    wq, sw = quantize_weight(r(6, 8))
    return [
        ("fps", (pts, 8, torch.zeros(2, dtype=torch.int32))),
        ("knn_group", (pts, pts[:, :8].contiguous(), r(2, 64, 5), 4, "list")),
        ("gemm", (r(16, 8), r(12, 8), r(12), "relu", r(16, 12), 2.0, 1, torch.float32, 4, True, None)),
        ("gemm", (r(16, 8).bfloat16(), r(12, 8).bfloat16(), None, "gelu", r(4, 12), 1.0, 4, None, 8, False,
                  None)),
        ("group_stack", (r(32, 6), [r(16, 8), r(16), r(16, 16), r(16), r(8, 16), r(8)], 8, True)),
        ("group_stack", (r(32, 6), [r(16, 8), r(16)], 8, False)),
        ("group_head", (r(32, 8), r(4, 16), r(16, 8), r(8, 16), r(8), 8, [])),
        ("group_head", (r(32, 6), r(4, 16), r(16, 16), r(8, 16), r(8), 8, [r(16, 8), r(16)])),
        ("bn_stats", (r(10, 16),)),
        ("bn_relu", (r(10, 16), r(2, 16).double().abs() * 10, 10.0, r(16), r(16), 1e-5)),
        ("bn_relu_bwd_stats", (r(10, 16), r(10, 16), r(6, 16))),
        ("bn_relu_bwd", (r(10, 16), r(10, 16), r(6, 16), r(2, 16).double(), 10.0)),
        ("layer_norm", (r(10, 16), r(16), r(16))),
        ("pos_layer_norm", (r(10, 16), r(5, 16), r(16), r(16))),
        ("attention", (qkv, 2)),
        ("mha_qkv", (qkv, 2)),
        ("mha_qkv_bwd", (qkv, g3, 2)),
        ("attn_block", (g3, r(8, 24), r(24), r(8, 8), r(8), 2)),
        ("proj_layer_norm", (r(10, 8), r(16, 8), r(16), r(10, 16), r(16), r(16))),
        ("quant_dense", (r(3, 4, 8), wq, sw, r(6), torch.float32)),
        ("apf_block", (g3, list(block_kernel.apf_block_weights(apf_block)), 2, [])),
        ("group_encoder", (r(4, 8, 6), list(encoder_kernel.fold_encoder_params(enc)))),
        ("p3_embed", (r(4, 8, 6), list(p3_kernel.fold_p3_stage_params(p3)))),
        ("vit_block", (r(2, 5, 64), list(vit_block_weights(vit, torch.float32)), 1, r(2, 5, 64))),
        ("serial_block", (r(2, 5, 64), list(serial_block_weights(serial, torch.float32)), 1)),
    ]


def test_every_kernel_op_has_a_case():
    registered = {n for n in dir(torch.ops.pointvit_tpu_torch) if hasattr(getattr(torch.ops.pointvit_tpu_torch, n),
                                                                         "default")}
    assert registered == {name for name, _ in _op_cases()}


@pytest.mark.parametrize("case", range(len(_op_cases())), ids=[f"{n}{i}" for i, (n, _) in enumerate(_op_cases())])
def test_kernel_op_fake_matches_its_cpu_call(case):
    """The fake implementation gives the outputs' shapes, dtypes and strides
    of the op's CPU call (the plain version), and the schema holds."""
    name, args = _op_cases()[case]
    op = getattr(torch.ops.pointvit_tpu_torch, name).default
    torch.library.opcheck(op, args, test_utils=("test_schema", "test_autograd_registration", "test_faketensor"))
    _build.reset_launch_counts()
    op(*args)
    assert not any(_build.launch_counts().values())  # a CPU call runs the plain version


# ------------------------------------------------------------------ export


@pytest.fixture(scope="module")
def exported(apf):
    model, _ = apf
    return load_forward(export_forward(model, _clouds(0, 1)))


@pytest.mark.parametrize("batch", [1, 3, 8])
def test_export_round_trip_equals_the_live_model(apf, exported, batch):
    model, _ = apf
    clouds = _clouds(6, batch)
    with torch.no_grad():
        want = model(torch.from_numpy(clouds)).float().numpy()
    got = exported(clouds)
    assert exported.meta["batch"] is None and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


def test_export_of_a_fixed_batch_rejects_other_sizes(apf):
    model, _ = apf
    fn = load_forward(export_forward(model, _clouds(0, 4), batch_polymorphic=False))
    assert fn.meta["batch"] == 4
    assert fn(_clouds(1, 4)).shape == (4, 15)
    with pytest.raises(Exception):
        fn(_clouds(1, 3))


def test_export_file_round_trip_and_from_exported(apf, tmp_path):
    model, _ = apf
    path = str(tmp_path / "apf.pt2")
    save_exported(path, export_forward(model, _clouds(0, 1)))
    clouds = _clouds(7, 5)
    with torch.no_grad():
        want = model(torch.from_numpy(clouds)).numpy()
    np.testing.assert_array_equal(load_exported(path)(clouds).numpy(), want)
    sess = InferenceSession.from_exported(path, buckets=(4, 8))
    assert sess.model is None and sess.device == torch.device("cpu") and sess.points == N_POINTS
    np.testing.assert_array_equal(sess.predict_logits(clouds),
                                  InferenceSession(model, buckets=(4, 8), device="cpu").predict_logits(clouds))
    with pytest.raises(ValueError, match="points"):
        sess.check_cloud_shape((48, 3))


def test_export_matches_the_jax_exported_artifact(apf):
    """The same weights through the JAX package's StableHLO export and the
    port's torch.export, within 1e-4 of the largest logit."""
    model, _ = apf
    clouds = _clouds(8, 3)
    tree = state_dict_to_flax(model)
    jmodel = jfactory.build_model(APF_CONFIG, family="apf")
    with jax.default_matmul_precision("highest"):
        jfn = jload_forward(jexport_forward(jmodel, tree, jnp.asarray(clouds)))
        want = np.asarray(jfn(clouds))
    got = load_forward(export_forward(model, clouds))(clouds).numpy()
    assert np.abs(got - want).max() <= LOGIT_REL_TOL * np.abs(want).max()


@pytest.mark.parametrize("which", ["quantized_apf", "pix4point"])
def test_an_export_leaves_the_live_caches_and_logits_as_they_were(which):
    """A quantized layer keeps its int8 weight, a ViT block its launch
    weights: the program bakes its own (from a copy of the model), and each
    live cache keeps the same tensors."""
    if which == "quantized_apf":
        model = _randomize(build_model({**APF_CONFIG, "quantized": True}), 2)
        points = N_POINTS
        cache = lambda: [t for m in model.modules() if isinstance(m, QuantLinear)  # noqa: E731
                         for t in m._quantized[1:]]
    else:
        model = _randomize(Pix4Point(num_classes=10, embed_dim=128, depth=2, num_heads=2, k_neighbors=8), 2)
        points = 128
        cache = lambda: [t for b in model.model.blocks for t in b._launch._value]  # noqa: E731
    clouds = torch.from_numpy(_clouds(9, 3, points))
    with torch.no_grad():
        before = model(clouds)
    kept = cache()
    assert all(v is not None for v in kept)
    fn = load_forward(export_forward(model, clouds))
    assert all(a is b for a, b in zip(cache(), kept))
    with torch.no_grad():
        np.testing.assert_array_equal(model(clouds).numpy(), before.numpy())
    np.testing.assert_array_equal(fn(clouds).numpy(), before.float().numpy())


# A model of each kind whose blocks take their fused chains at depth 2 (head
# dim 64) or whose layers are int8: the artifact holds their launch weights.
BAKED_CASES = {
    "apf": lambda: (_randomize(build_model({**APF_CONFIG, "embedding_dim": 64, "bf16": True}), 3),
                    N_POINTS),
    "quantized_apf": lambda: (_randomize(build_model({**APF_CONFIG, "quantized": True}), 4), N_POINTS),
    "pix4point": lambda: (_randomize(Pix4Point(num_classes=10, embed_dim=128, depth=2, num_heads=2,
                                               k_neighbors=8), 5), 128),
}


def _baked_modules(model):
    """The modules an export bakes: fused blocks and int8 layers."""
    return [m for m in model.modules()
            if isinstance(m, (APFBlock, ViTBlock, SerialAdapterBlock, QuantLinear))]


@pytest.mark.parametrize("which", sorted(BAKED_CASES))
def test_an_artifact_holds_its_launch_weights_in_place_of_the_raw_ones(which):
    """The program's buffers are the launch weights the live model makes
    (the blocks' cast and transposed arrays, the int8 weights and scales),
    the parameters they come from are gone, the artifact is no larger
    than its weights, and its logits are bit-equal to the live model's at
    batches 1, 3 and 8 on the CPU's plain path."""
    from pointvit_tpu_torch.export import baked_copy

    model, points = BAKED_CASES[which]()
    clouds = torch.from_numpy(_clouds(10, 2, points))
    baked = baked_copy(model, clouds)
    live_mods, baked_mods = _baked_modules(model), _baked_modules(baked)
    assert live_mods and len(live_mods) == len(baked_mods)
    with torch.no_grad():
        model(clouds)  # the live caches
    n_baked = 0
    for live, mod in zip(live_mods, baked_mods):
        if isinstance(live, QuantLinear):
            want = live.quantized_weight()
            assert mod.weight is None
            assert (mod.bias is None) == (live.bias is None)  # the bias stays
        else:
            want = live._launch._value
            if isinstance(live, APFBlock) and not live.quantized:  # kept on the card only
                want = block_kernel.apf_launch_weights(block_kernel.apf_block_weights(live),
                                                       live.dtype, clouds.device)
            if want is None:  # a block off its fused chain (a quantized APF block) bakes nothing
                assert not hasattr(mod, "baked_0")
                continue
            assert not list(mod.parameters())
        got = [getattr(mod, f"baked_{i}") for i in range(len(want))]
        for g, w in zip(got, want):
            assert g.dtype == w.dtype and g.shape == w.shape
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        n_baked += 1
    assert n_baked and all(p.numel() for p in model.parameters())  # the live model keeps its own
    blob = export_forward(model, clouds)
    fn = load_forward(blob)
    weights = sum(t.numel() * t.element_size() for t in (*baked.parameters(), *baked.buffers()))
    assert len(blob) < weights + (1 << 20)
    for batch in (1, 3, 8):
        x = torch.from_numpy(_clouds(11 + batch, batch, points))
        with torch.no_grad():
            want = model(x).float()
        np.testing.assert_array_equal(fn(x).numpy(), want.numpy())
