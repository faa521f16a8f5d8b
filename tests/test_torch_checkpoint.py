"""Checkpoints across the two packages, on the CPU: the port's reader of
flax's msgpack format against ``flax.serialization.msgpack_restore`` (a JAX
``TrainState`` with optax AdamW state and EMA trees, a bfloat16 leaf, a
numpy scalar, a chunked array), its writer's bytes restored by flax, the
weight bridge's inverse (``state_dict_to_flax``) against each family's JAX
``init`` tree, and ``InferenceSession.from_checkpoint`` on a JAX checkpoint
of each family against the JAX session's logits, with and without the EMA
weights; a port ``Trainer``'s ``.pt`` checkpoint serves its EMA; deferred
writes (the writer thread's order, the trainer's snapshot, the wait, a
failed write raised at the next wait, the same bytes as a synchronous save).

Small sizes: APF depth 2, E 32, npoint 16, nsample 8, 64 points; Pix4Point
and the renderer at the sizes of their parity tests (E 128, two blocks of
head dim 64, 128 points); f32. Logits are held within 1e-4 of the largest
(the two sides differ in summation order only), the JAX side under
``jax.default_matmul_precision("highest")``.
"""

import json
import os
import threading

import flax.serialization as flax_ser
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pointvit_tpu.models import factory as jfactory
from pointvit_tpu.models import renderer as jrenderer
from pointvit_tpu.serve import InferenceSession as JSession
from pointvit_tpu.train import TrainState
from pointvit_tpu.train import checkpoint as jcheckpoint
from pointvit_tpu_torch.convert import load_flax_variables, state_dict_to_flax
from pointvit_tpu_torch.models import build_model, renderer
from pointvit_tpu_torch.serve import InferenceSession
from pointvit_tpu_torch.train import Trainer, build_optimizer, constant_schedule, wait_for_pending_writes
from pointvit_tpu_torch.train import flax_msgpack
from pointvit_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint, save_checkpoint_deferred

LOGIT_REL_TOL = 1e-4
TINY_VIT = dict(patch_size=8, embed_dim=128, depth=2, num_heads=2)
# (family, model_config, points a cloud)
FAMILIES = {
    "apf": ({"num_classes": 15, "in_channels": 3, "embedding_dim": 32, "npoint": 16, "nsample": 8,
             "depth": 2, "num_heads": 1, "encoder_second_width": 64, "bf16": False}, 64),
    "pix4point": ({"num_classes": 10, "pretrained_model": "vit_small_patch16_384", "embed_dim": 128,
                   "depth": 2, "num_heads": 2, "k_neighbors": 8, "bf16": False}, 128),
    "renderer": ({"num_classes": 15, "vit_name": "vit_tiny_test", "adapter_dim": 16, "num_views": 2,
                  "img_size": 32, "view_transform_hidden": 16, "diff_renderer": True, "dropout_rate": 0.0,
                  "bf16": False}, 128),
}


@pytest.fixture(scope="module", autouse=True)
def tiny_vit_preset():
    with pytest.MonkeyPatch.context() as mp:
        for table in (jrenderer.TORCHVISION_VIT_PRESETS, renderer.TORCHVISION_VIT_PRESETS):
            mp.setitem(table, "vit_tiny_test", TINY_VIT)
        yield


def _clouds(seed, n, points):
    """Clouds scaled into the unit sphere (the renderer's input range)."""
    pts = np.random.default_rng(seed).standard_normal((n, points, 3)).astype(np.float32)
    return pts / np.linalg.norm(pts, axis=-1).max(axis=1)[:, None, None]


def _live(tree, rng):
    """Random values for every leaf (variances positive, scales near 1): the
    zero-init adapters, cls tokens and heads would hide a fault."""
    for k, v in tree.items():
        if isinstance(v, dict):
            _live(v, rng)
        elif k == "var":
            tree[k] = (0.5 + rng.random(v.shape)).astype(np.float32)
        elif k == "scale":
            tree[k] = (1 + 0.2 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            fan_in = int(np.prod(v.shape[:-1])) if k == "kernel" else 100
            tree[k] = (rng.standard_normal(v.shape) * fan_in**-0.5).astype(np.float32)


def _noisy(tree, rng, scale=0.05):
    return jax.tree.map(lambda a: (a + scale * rng.standard_normal(a.shape)).astype(np.float32), tree)


def _jax_checkpoint(tmp, family, seed=0):
    """A JAX trainer checkpoint (``save_checkpoint(..., async_write=False)``)
    of a random-weight model with AdamW state after one update and EMA trees
    that differ from the raw ones. Returns (path, the raw variable tree)."""
    cfg, points = FAMILIES[family]
    jmodel = jfactory.build_model(cfg, family=family)
    variables = jax.jit(jmodel.init)(jax.random.PRNGKey(seed), jnp.zeros((1, points, 3)))
    variables = {k: jax.tree.map(lambda a: np.array(a, np.float32), variables[k])
                 for k in ("params", "batch_stats")}
    rng = np.random.default_rng(seed)
    _live(variables, rng)
    tx = optax.adamw(1e-3, weight_decay=0.05)

    @jax.jit
    def make(variables, ema_params, grads):
        state = TrainState.create(apply_fn=jmodel.apply, params=variables["params"], tx=tx,
                                  batch_stats=variables["batch_stats"], ema_params=ema_params,
                                  ema_batch_stats=jax.tree.map(lambda a: a * 1.1, variables["batch_stats"]))
        return state.apply_gradients(grads=grads)

    state = make(variables, _noisy(variables["params"], rng),
                 _noisy(jax.tree.map(np.zeros_like, variables["params"]), rng))
    path = jcheckpoint.save_checkpoint(str(tmp), f"{family}.msgpack", epoch=3, state=state, accuracy=0.5,
                                       model_config=cfg, dataset_config={"name": "synthetic"},
                                       async_write=False)
    return path, variables


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """``jax_checkpoint(family)`` → (path, raw variable tree, JAX sessions
    from the checkpoint by ``use_ema``), made once per family; the two
    sessions share one compiled forward."""
    made = {}

    def get(family):
        if family not in made:
            path, variables = _jax_checkpoint(tmp_path_factory.mktemp(family), family)
            sessions = {True: JSession.from_checkpoint(path, buckets=(4,)),
                        False: JSession.from_checkpoint(path, buckets=(4,), use_ema=False)}
            sessions[False]._forward = sessions[True]._forward  # same model and shapes: one compile
            made[family] = path, variables, sessions
        return made[family]

    return get


def _assert_trees_equal(got, want, path=""):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}/{k}")
    elif torch.is_tensor(got):  # a bfloat16 leaf
        assert got.dtype == torch.bfloat16 and str(np.asarray(want).dtype) == "bfloat16", path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(), np.asarray(want).view(np.int16))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert type(got) is type(want) and got.dtype == want.dtype and got.shape == want.shape, path
        np.testing.assert_array_equal(got, want)
    else:
        assert type(got) is type(want) and got == want, path


# ---------------------------------------------------------------- msgpack


def test_reads_a_jax_train_state_checkpoint_leaf_for_leaf(jax_checkpoint):
    path, _, _ = jax_checkpoint("apf")
    with open(path, "rb") as f:
        want = flax_ser.msgpack_restore(f.read())
    got = load_checkpoint(path)
    assert got.pop("meta")["model_config"] == FAMILIES["apf"][0]
    _assert_trees_equal(got, want)
    # optax's AdamW state as flax's to_state_dict writes it: tuples keyed "0", "1", …
    adam = got["opt_state"]["0"]
    assert sorted(adam) == ["count", "mu", "nu"] and int(adam["count"]) == 1
    assert sorted(got) == ["accuracy", "batch_stats", "ema_batch_stats", "ema_params", "epoch", "opt_state",
                           "params", "step"]


def test_reads_bfloat16_scalars_and_chunked_arrays(monkeypatch):
    rng = np.random.default_rng(1)
    tree = {"bf16": np.asarray(jnp.asarray(rng.standard_normal((3, 5)), jnp.bfloat16)),
            "scalar": np.float32(2.5), "int_scalar": np.int64(-7), "flag": True, "none": None,
            "nested": {"big": rng.standard_normal((40, 3)).astype(np.float32),
                       "big_bf16": np.asarray(jnp.asarray(rng.standard_normal(100), jnp.bfloat16))},
            "ints": [1, -1, 300, -300, 70000, 2**40], "text": "é"}
    monkeypatch.setattr(flax_ser, "MAX_CHUNK_SIZE", 64)  # the two "big" leaves are written in chunks
    blob = flax_ser.msgpack_serialize(tree)
    assert blob.count(b"__msgpack_chunked_array__") == 2
    _assert_trees_equal(flax_msgpack.loads(blob), flax_ser.msgpack_restore(blob))


@pytest.mark.parametrize("chunk", [2**30, 96])
def test_the_writer_restores_in_flax_to_the_same_tree(jax_checkpoint, monkeypatch, chunk):
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", chunk)
    path, _, _ = jax_checkpoint("apf")
    tree = load_checkpoint(path)
    del tree["meta"]
    tree["bf16"] = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    blob = flax_msgpack.dumps(tree)
    assert (b"__msgpack_chunked_array__" in blob) == (chunk < 2**30)
    back = flax_ser.msgpack_restore(blob)
    _assert_trees_equal(tree, back)


def test_save_checkpoint_writes_either_format_and_waits_for_nothing(tmp_path):
    wait_for_pending_writes()  # nothing queued: returns at once
    weights = {"params": {"w": np.arange(4, dtype=np.float32)}}
    path = save_checkpoint(str(tmp_path), "x.msgpack", epoch=1, accuracy=0.25, state=weights,
                           model_config={"a": 1}, dataset_config={})
    with open(path, "rb") as f:
        restored = flax_ser.msgpack_restore(f.read())
    assert restored["epoch"] == 1 and restored["accuracy"] == 0.25
    np.testing.assert_array_equal(restored["params"]["w"], weights["params"]["w"])
    pt = save_checkpoint(str(tmp_path), "x.pt", epoch=2, accuracy=0.5, state={"model": {"w": torch.ones(2)}},
                         model_config={"a": 1}, dataset_config={})
    got = load_checkpoint(pt)
    assert got["epoch"] == 2 and torch.equal(got["model"]["w"], torch.ones(2))
    assert got["meta"]["model_config"] == {"a": 1}


# ------------------------------------------------------- the bridge's inverse


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_state_dict_to_flax_inverts_the_bridge_and_matches_the_jax_init_tree(family, jax_checkpoint):
    """flax → torch → flax bit for bit, on the JAX model's own init tree
    (random values): the same keys, shapes and dtypes."""
    _, variables, _ = jax_checkpoint(family)
    model = load_flax_variables(build_model(FAMILIES[family][0], family=family), variables)
    back = state_dict_to_flax(model)
    want, got = jax.tree_util.tree_flatten_with_path(variables)[0], jax.tree_util.tree_flatten_with_path(back)[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, p
        np.testing.assert_array_equal(g, w, err_msg=jax.tree_util.keystr(p))


# ------------------------------------------------------- from_checkpoint


@pytest.mark.parametrize("use_ema", [True, False], ids=["ema", "raw"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_from_checkpoint_serves_a_jax_checkpoint_as_jax_does(family, use_ema, jax_checkpoint):
    path, _, jsessions = jax_checkpoint(family)
    clouds = _clouds(7, 3, FAMILIES[family][1])
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jsessions[use_ema].predict_logits(clouds))
    sess = InferenceSession.from_checkpoint(path, buckets=(4,), use_ema=use_ema, device="cpu")
    got = sess.predict_logits(clouds)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= LOGIT_REL_TOL * np.abs(want).max()
    other = InferenceSession.from_checkpoint(path, buckets=(4,), use_ema=not use_ema, device="cpu")
    assert np.abs(other.predict_logits(clouds) - got).max() > 100 * LOGIT_REL_TOL * np.abs(want).max()


def test_from_checkpoint_without_a_sidecar_raises(jax_checkpoint, tmp_path):
    path, _, _ = jax_checkpoint("apf")
    lonely = tmp_path / "lonely.msgpack"
    lonely.write_bytes(open(path, "rb").read())
    with pytest.raises(FileNotFoundError, match="model_config"):
        InferenceSession.from_checkpoint(str(lonely), device="cpu")
    sess = InferenceSession.from_checkpoint(str(lonely), model_config=FAMILIES["apf"][0], device="cpu")
    assert sess.predict(_clouds(0, 2, 64)).shape == (2,)
    with pytest.raises(AttributeError, match="get_group"):  # a mesh needs a data group
        InferenceSession.from_checkpoint(path, device="cpu", mesh=object())


def test_a_port_trainer_checkpoint_serves_its_ema_by_default(tmp_path):
    cfg = {**FAMILIES["apf"][0], "depth": 1}
    torch.manual_seed(0)
    model = build_model(cfg)
    data = [(c, i % 3) for i, c in enumerate(_clouds(2, 8, 64))]
    opt = build_optimizer(model, constant_schedule(1e-2), weight_decay=0.0)
    tr = Trainer(model, train_dataset=data, test_dataset=data[:4], optimizer=opt, batch_size=4, epochs=1,
                 output_dir=str(tmp_path), model_config=cfg, device="cpu", ema_decay=0.5,
                 save_interval=1, save_config_snapshot=False)
    tr.train()
    path = str(tmp_path / "model_epoch_1.pt")
    assert os.path.exists(path) and json.load(open(path + ".json"))["model_config"] == cfg
    raw = load_checkpoint(path)
    clouds = _clouds(3, 3, 64)
    ema_model = build_model(cfg)
    ema_model.load_state_dict({**raw["model"], **raw["ema"]})
    with torch.no_grad():
        want_ema = ema_model.eval()(torch.from_numpy(clouds)).numpy()
    got = InferenceSession.from_checkpoint(path, buckets=(4,), device="cpu").predict_logits(clouds)
    np.testing.assert_array_equal(got, want_ema)
    raw_sess = InferenceSession.from_checkpoint(path, buckets=(4,), use_ema=False, device="cpu")
    plain = build_model(cfg)
    plain.load_state_dict(raw["model"])
    with torch.no_grad():
        np.testing.assert_array_equal(raw_sess.predict_logits(clouds), plain.eval()(torch.from_numpy(clouds)).numpy())
    assert not np.array_equal(got, raw_sess.predict_logits(clouds))


# --------------------------------------------------------- deferred writes


def _hold_writer():
    """Queue a job that blocks the writer thread until the returned event is
    set: whatever is queued after it waits its turn."""
    from pointvit_tpu_torch.train import checkpoint

    release = threading.Event()
    checkpoint._submit(lambda: release.wait(30))
    return release


def test_deferred_writes_land_in_submission_order_and_wait_blocks(tmp_path):
    """A deferred save, then an async one to the same file name, both behind
    a held writer: the later one lands last, and nothing is on disk until
    the writer gets to it."""
    out = str(tmp_path)
    release = _hold_writer()
    kw = dict(epoch=0, accuracy=0.0, model_config={}, dataset_config={})
    first = save_checkpoint_deferred(out, "m.pt", fetch=lambda: {"w": torch.zeros(3)}, **kw)
    second = save_checkpoint(out, "m.pt", state={"w": torch.ones(3)}, async_write=True, **kw)
    assert first == second and not os.path.exists(first)
    release.set()
    wait_for_pending_writes()
    assert torch.equal(load_checkpoint(first)["w"], torch.ones(3))


def test_a_failed_write_raises_at_the_next_wait_only(tmp_path):
    def broken():
        raise OSError("disk full")

    kw = dict(epoch=0, accuracy=0.0, model_config={}, dataset_config={})
    save_checkpoint_deferred(str(tmp_path), "a.pt", fetch=broken, **kw)
    ok = save_checkpoint_deferred(str(tmp_path), "b.pt", fetch=lambda: {"w": torch.ones(1)}, **kw)
    with pytest.raises(RuntimeError, match="1 checkpoint write") as info:
        wait_for_pending_writes()
    assert isinstance(info.value.__cause__, OSError)
    assert os.path.exists(ok)  # the queue goes on after a failure
    wait_for_pending_writes()  # reported once


def _ckpt_trainer(tmp_path):
    cfg = {**FAMILIES["apf"][0], "depth": 1}
    torch.manual_seed(0)
    model = build_model(cfg)
    frozen = {n for n, _ in model.named_parameters() if n.startswith("point_encoder")}
    data = [(c, i % 3) for i, c in enumerate(_clouds(2, 8, 64))]
    opt = build_optimizer(model, constant_schedule(1e-2), weight_decay=0.0,
                          trainable_mask=[n for n, _ in model.named_parameters() if n not in frozen])
    return Trainer(model, train_dataset=data, test_dataset=data[:4], optimizer=opt, batch_size=4,
                   epochs=1, output_dir=str(tmp_path), model_config=cfg, device="cpu",
                   ema_decay=0.5, save_config_snapshot=False, prefetch=0)


def test_a_deferred_checkpoint_holds_the_state_of_its_step_and_the_synchronous_bytes(tmp_path):
    """The writer is held while the trainer saves and then takes another
    step: the file holds the state at the save, not the one after, and its
    bytes equal a synchronous save of that state. Frozen parameters come
    from one host copy, made at the first save."""
    from pointvit_tpu_torch.train.trainer import _map_tensors

    pts, lbl = torch.from_numpy(_clouds(4, 4, 64)), torch.tensor([0, 1, 2, 0])
    tr = _ckpt_trainer(tmp_path)
    tr.train_step(pts, lbl)
    at_save = {k: v.clone() for k, v in tr.model.state_dict().items()}
    sync = save_checkpoint(str(tmp_path), "sync.pt", epoch=0, accuracy=0.5,
                           state=_map_tensors(tr._checkpoint_state(), lambda t: t.to("cpu")),
                           model_config=tr.model_config, dataset_config=tr.dataset_config)
    cached = {k: v[1] for k, v in tr._frozen_host.items()}
    assert cached
    release = _hold_writer()
    path = tr._save_checkpoint("model_epoch_1.pt", 0, 0.5)
    tr.train_step(pts, lbl)  # updates the parameters, the moments and the EMA in place
    assert any(not torch.equal(v, at_save[k]) for k, v in tr.model.state_dict().items())
    assert not os.path.exists(path)
    release.set()
    tr._save_checkpoint("model_epoch_2.pt", 1, 0.5)
    assert all(tr._frozen_host[k][1] is t for k, t in cached.items())  # not copied again
    wait_for_pending_writes()
    saved = load_checkpoint(path)["model"]
    for k, v in at_save.items():
        assert torch.equal(saved[k], v), k
    with open(path, "rb") as f, open(sync, "rb") as g:
        assert f.read() == g.read()
