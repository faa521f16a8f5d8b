"""Port parity for data, tensor and FSDP parallelism, the mesh helpers and
serving with a mesh, on the CPU over gloo ranks.

One spawn of 4 ranks (``tests/torch_dist_cases.py::suite_parallel``) runs
JAX's tiny APF (``test_multichip.py:20-34``: in_channels 4, E 32, depth 2,
4 heads; 16 clouds of 64 points, label smoothing 0.3, dropout and
drop-path as built, FPS from the shared generator) for one step in four
layouts: one process (the step the port's other tests hold against JAX),
DP over 4 ranks (DDP), DP × TP over 2 × 2 (the tensor-parallel plan, plain
path) and FSDP over 2 (FSDP2 with the JAX plan). Each is held to the
one-process step as JAX holds its mesh step to one device
(``test_multichip.py:54-76``): loss within 1e-5 relative, the head's output
weights within rtol 1e-4 (atol 1e-6); and each applied gradient within 1e-4
relative L2 (a gradient that is exactly zero in exact arithmetic is
rounding noise on both sides, held to 1e-5 of the global norm). A parameter
whose gradient is noise moves by ±lr under Adam whatever its size, so the
other weights are not compared after the update.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from pointvit_tpu.models.renderer import PointCloudRendererClassifier as JRenderer
from pointvit_tpu.ops.pallas_attention import _mha_qkv_pallas
from pointvit_tpu.parallel import batch_shard_map as jbatch_shard_map
from pointvit_tpu.parallel import fsdp_shardings as jfsdp_shardings
from pointvit_tpu.parallel import per_device_bytes as jper_device_bytes
from pointvit_tpu.parallel import replicated_bytes as jreplicated_bytes
from pointvit_tpu.parallel import transformer_tp_shardings as jtp_shardings
from pointvit_tpu_torch.models import AdaptPointFormer
from pointvit_tpu_torch.models.renderer import PointCloudRendererClassifier
from pointvit_tpu_torch.parallel import fsdp_shardings, per_device_bytes, replicated_bytes
from pointvit_tpu_torch.parallel.fsdp import LeafSharding
from pointvit_tpu_torch.serve import InferenceSession
import torch_dist_cases
from torch_dist_cases import APF_CFG


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    wd = str(tmp_path_factory.mktemp("parallel_ranks"))
    torch.manual_seed(0)
    model = AdaptPointFormer(**APF_CFG)
    with torch.no_grad():  # live adapters: up_proj starts at zero
        for n, p in model.named_parameters():
            if "up_proj" in n:
                p.copy_(0.1 * torch.randn_like(p))
    rng = np.random.default_rng(0)
    torch.save(dict(apf_state=model.state_dict(),
                    points=rng.standard_normal((16, 64, 4)).astype(np.float32),
                    labels=(np.arange(16) % 15).astype(np.int64),
                    qkv=rng.standard_normal((4, 10, 96)).astype(np.float32),
                    bn_state=torch.nn.BatchNorm1d(24).state_dict(),
                    bn_x=torch.from_numpy((1.5 * rng.standard_normal((8, 5, 24)) + 0.5).astype(np.float32)),
                    bn_w=torch.from_numpy(rng.standard_normal((8, 5, 24)).astype(np.float32))),
               os.path.join(wd, "inputs.pt"))
    torch_dist_cases.spawn("parallel", wd, 4, timeout=300)
    return lambda name, r=0: torch.load(os.path.join(wd, f"{name}_{r}.pt"), weights_only=False)


def _rel_l2(a, b):
    return float(np.linalg.norm(np.asarray(a) - np.asarray(b)) / np.linalg.norm(np.asarray(b)))


@pytest.mark.parametrize("layout,reference", [("dp", "single"), ("dptp", "single_tp"),
                                              ("fsdp", "single")])
def test_a_mesh_step_equals_the_one_process_step(layout, reference, ranks):
    one, got = ranks(reference), ranks(layout)
    assert torch.allclose(got["loss"], one["loss"], rtol=1e-5, atol=0)
    k = "head.out.weight"
    np.testing.assert_allclose(got["state"][k], one["state"][k], rtol=1e-4, atol=1e-6)
    assert set(got["grads"]) == set(one["grads"])
    total = np.sqrt(sum(float((g ** 2).sum()) for g in one["grads"].values()))
    for n, g in one["grads"].items():
        if float(g.norm()) <= 1e-6 * total:
            assert float(got["grads"][n].norm()) <= 1e-5 * total, n
            continue
        assert _rel_l2(got["grads"][n], g) <= 1e-4, n
    for n, t in one["state"].items():  # global BatchNorm statistics
        if n.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got["state"][n], t, rtol=1e-5, atol=1e-6, err_msg=n)


def test_every_rank_of_a_layout_holds_the_same_model(ranks):
    for layout, n in (("dp", 4), ("dptp", 4), ("fsdp", 2)):
        first = ranks(layout, 0)
        for r in range(1, n):
            other = ranks(layout, r)
            for k, t in first["state"].items():
                assert torch.equal(other["state"][k], t), (layout, r, k)


def test_fsdp_shards_by_the_jax_plan_and_keeps_its_ema(ranks):
    got = ranks("fsdp")
    model = AdaptPointFormer(**APF_CFG)
    plan = fsdp_shardings(model, 2)
    trainable = {n for n in got["grads"]}
    assert set(got["sharded"]) == {n for n, s in plan.items() if s.dim is not None}
    assert got["sharded"] and set(got["sharded"]) < trainable | set(plan)
    one = ranks("single")
    k = "head.out.weight"
    np.testing.assert_allclose(got["ema"][k], one["ema"][k], rtol=1e-4, atol=1e-6)


def test_fsdp_plan_sizes_the_vit_l16_trunk_as_jax_does():
    """The JAX memory claim (``test_fsdp.py:133``) on the same trunk, on
    ``meta`` tensors: the port's plan gives one rank of 8 the JAX plan's
    bytes, under a quarter of the replicated ones."""
    kw = dict(num_classes=15, vit_name="vit_l_16", num_views=5, adapter_dim=64,
              view_transform_hidden=64)
    jparams = jax.eval_shape(lambda: JRenderer(**kw).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((1, 128, 3))))["params"]
    mesh = Mesh(np.asarray(jax.devices()[:8]), ("data",))
    want = jper_device_bytes(jparams, jfsdp_shardings(jparams, mesh))
    with torch.device("meta"):
        model = PointCloudRendererClassifier(**kw)
    plan = fsdp_shardings(model, 8)
    assert per_device_bytes(model, plan) == want
    assert replicated_bytes(model) == jreplicated_bytes(jparams)
    assert per_device_bytes(model, plan) < replicated_bytes(model) / 4
    assert all(isinstance(s, LeafSharding) for s in plan.values())


def test_an_fsdp_checkpoint_resumes_and_serves_on_one_rank(ranks):
    got = ranks("fsdp")
    for k, t in got["state"].items():
        assert torch.equal(got["resumed"][k], t), k
    for k, t in got["ema"].items():
        assert torch.equal(got["resumed_ema"][k], t), k
    assert torch.equal(got["n1"], got["n2"])  # the resumed run takes the same next step
    for k, t in got["after1"].items():
        assert torch.equal(got["after2"][k], t), k
        assert torch.equal(got["after_eval"][k], t), k  # the EMA swapped in and back out
    sess = InferenceSession.from_checkpoint(got["path"], model=AdaptPointFormer(**APF_CFG),
                                            buckets=(4,), device="cpu")
    model = AdaptPointFormer(**APF_CFG).eval()
    model.load_state_dict({**got["state"], **got["ema"]})
    clouds = np.random.default_rng(3).standard_normal((3, 64, 4)).astype(np.float32)
    with torch.no_grad():
        want = model(torch.from_numpy(clouds)).numpy()
    np.testing.assert_array_equal(sess.predict_logits(clouds), want)


def test_fsdp_adamw_runs_multi_tensor_groups_and_saves_the_one_process_layout(ranks):
    """Under FSDP each AdamW group holds DTensors only or plain tensors only
    (torch's multi-tensor path takes no mix), with foreach left to torch;
    the checkpoint's optimizer state loads into an optimizer without a mesh,
    every moment where the FSDP trainer had it."""
    from pointvit_tpu_torch.models import apf_trainable_mask
    from pointvit_tpu_torch.train import build_optimizer, constant_schedule
    from pointvit_tpu_torch.train.checkpoint import load_checkpoint

    got = ranks("fsdp")
    kinds = [set(g[:-1]) for g in got["groups"]]
    assert all(len(k) == 1 for k in kinds) and {True} in kinds and {False} in kinds
    assert all(g[-1] is None for g in got["groups"])
    model = AdaptPointFormer(**APF_CFG)
    opt = build_optimizer(model, constant_schedule(1e-3), weight_decay=1e-2,
                          trainable_mask=apf_trainable_mask(model))
    assert len(opt.optimizer.param_groups) < len(got["groups"])  # one group of each kind
    opt.load_state_dict(load_checkpoint(got["path"], map_location="cpu")["optimizer"])
    own = dict(model.named_parameters())
    assert set(got["moments"]) == {n for n, p in own.items() if p in opt.optimizer.state}
    for n, t in got["moments"].items():
        assert torch.equal(opt.optimizer.state[own[n]]["exp_avg"], t), n


def test_tensor_parallel_plan_matches_the_jax_markers_and_refuses_the_kernels(ranks):
    block = ranks("dptp_block")
    assert "tensor-parallel" in block["raised"] and "implementation='torch'" in block["raised"]
    torch.testing.assert_close(block["got"], block["want"], rtol=1e-5, atol=1e-5)
    from pointvit_tpu.nn.vit import ViTBlock as JBlock

    params = jax.eval_shape(lambda: JBlock(2).init(jax.random.PRNGKey(0),
                                                    jnp.zeros((1, 10, 128))))["params"]
    mesh = Mesh(np.asarray(jax.devices()[:2]).reshape(1, 2), ("data", "model"))
    flat = jax.tree_util.tree_flatten_with_path(jtp_shardings(params, mesh))[0]
    want = set()
    for path, sh in flat:
        keys = [p.key for p in path]
        if keys[-1] == "kernel" and any(sh.spec):
            want.add(f"{'.'.join(keys[:-1])}:{'Colwise' if sh.spec[1] else 'Rowwise'}Parallel")
    assert set(block["plan"]) == want
    assert int(ranks("dptp")["local_rows"]) == 3 * APF_CFG["embedding_dim"] // 2  # 2 of 4 heads


def test_batch_norm_relu_over_the_global_batch_equals_one_process(ranks):
    """``batch_norm_relu`` in training under ``global_batch`` on 2 gloo ranks
    (each half of 8 × 5 rows of width 24, loss Σ y·w) against one process
    over all of them: each rank's output and x gradient are its rows of the
    one process's, its γ and β gradients summed over the ranks (the step's
    gradient sync) are the one process's, and every rank's running
    statistics moved once, by the global batch's statistics."""
    one = ranks("bn_single")
    got = [ranks("bn", r) for r in range(2)]
    for r, g in enumerate(got):
        rows = slice(4 * r, 4 * r + 4)
        torch.testing.assert_close(g["y"], one["y"][rows], rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(g["dx"], one["dx"][rows], rtol=1e-5, atol=1e-6)
        for k in ("mean", "var"):
            torch.testing.assert_close(g[k], one[k], rtol=1e-6, atol=1e-7)
    for k in ("dgamma", "dbeta"):
        torch.testing.assert_close(got[0][k] + got[1][k], one[k], rtol=1e-5, atol=1e-5)
        assert not torch.allclose(got[0][k], one[k])  # each rank holds its own rows' part


def test_serving_with_a_mesh_rounds_the_buckets_and_matches_one_device(ranks):
    for r in range(2):
        got = ranks("serve", r)
        assert got["buckets"].tolist() == [4, 8]
        assert torch.equal(got["logits"], got["single"])


def test_a_session_given_a_one_rank_mesh_serves_as_without(tmp_path):
    class OneRank:  # a mesh's interface as the session reads it: a data group of one
        mesh = np.zeros((1,))

        def get_group(self, name):
            assert name == "data"
            return None

    model = AdaptPointFormer(**APF_CFG)
    clouds = np.random.default_rng(1).standard_normal((3, 64, 4)).astype(np.float32)
    with_mesh = InferenceSession(model, buckets=(3,), device="cpu", mesh=OneRank())
    assert with_mesh.buckets == (3,)
    np.testing.assert_array_equal(with_mesh.predict_logits(clouds),
                                  InferenceSession(model, buckets=(3,), device="cpu").predict_logits(clouds))


def test_batch_shard_map_matches_the_jax_kernel_under_shard_map(ranks):
    got = ranks("shard_map")
    rng = np.random.default_rng(0)
    rng.standard_normal((16, 64, 4))  # the fixture's clouds, drawn first
    qkv = rng.standard_normal((4, 10, 96)).astype(np.float32)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("data",))
    fn = jbatch_shard_map(lambda x: _mha_qkv_pallas(x, 4, interpret=True), mesh)
    want = np.asarray(jax.jit(fn)(jnp.asarray(qkv)))
    np.testing.assert_allclose(got["out"].numpy(), want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got["out"], got["direct"])


def test_the_mesh_helpers_shard_and_replicate(ranks):
    for r in range(4):
        got = ranks("helpers", r)
        assert got["multihost"] == [1, 2, 2]
        assert got["rows"].tolist() == list(range(2 * r, 2 * r + 2))
        assert got["replicated"].tolist() == [0.0, 1.0]
        assert got["hybrid"] == [2, 2]
